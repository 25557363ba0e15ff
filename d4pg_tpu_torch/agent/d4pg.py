"""D4PG algorithm core (counterpart of ``d4pg_tpu/agent/d4pg.py``).

:func:`train_step` is the single-critic categorical step of the reference
(``agent/d4pg.py:train_step``): target forward, softmax of the target head,
the fused projection + cross-entropy kernel (or the projection kernel and a
torch CE), the PER-weighted critic loss, the critic Adam step, the actor's
−E[Q] loss against the UPDATED critic, the actor Adam step, and the Polyak
update of both targets. PyTorch runs it eagerly and updates the state in
place; the JAX version is a pure function of an immutable state.

:func:`gather_batches` and :func:`fused_train_scan` are the megastep's
inner loop (``runtime/megastep.py``): K batches gathered from the device
ring in one op per field, then K train steps as a Python loop (the JAX
package's ``lax.scan``).
"""

from __future__ import annotations

import copy
from typing import Mapping

import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.agent.state import D4PGConfig, TrainState, check_supported
from d4pg_tpu_torch.models import Actor, Critic
from d4pg_tpu_torch.ops import (
    CategoricalSupport,
    ce_and_overlap,
    expected_value,
    fused_categorical_loss,
    gaussian_noise_init,
    gaussian_noise_sample,
    make_support,
    ou_noise_init,
    ou_noise_reset,
    ou_noise_sample,
    polyak_update,
    project,
)
from d4pg_tpu_torch.ops.cuda_fused_step import fused_categorical_loss_descent


def support_of(config: D4PGConfig) -> CategoricalSupport:
    return make_support(config.dist.v_min, config.dist.v_max, config.dist.num_atoms)


def build_networks(
    config: D4PGConfig, generator: torch.Generator | None = None
) -> tuple[Actor, Critic]:
    """Actor and critic on the CPU, initialised from ``generator`` if given."""
    check_supported(config)
    actor = Actor(
        config.obs_dim, config.action_dim, tuple(config.hidden_sizes), generator=generator
    )
    critic = Critic(
        config.obs_dim,
        config.action_dim,
        config.dist,
        tuple(config.hidden_sizes),
        generator=generator,
    )
    return actor, critic


def make_optimizers(config: D4PGConfig, actor: Actor, critic: Critic):
    """Adam with the reference's betas; eps=1e-8 is optax.adam's default, so
    the update is the same as ``optax.adam(lr, b1, b2)``."""
    betas = (config.adam_b1, config.adam_b2)
    return (
        torch.optim.Adam(actor.parameters(), lr=config.lr_actor, betas=betas, eps=1e-8),
        torch.optim.Adam(critic.parameters(), lr=config.lr_critic, betas=betas, eps=1e-8),
    )


def create_train_state(
    config: D4PGConfig, seed: int | torch.Generator = 0, device=None
) -> TrainState:
    """Initialise the networks (on the CPU, from ``seed``), move them to
    ``device`` (default: the CUDA card) and hard-copy the targets."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    actor, critic = build_networks(config, gen)
    actor, critic = actor.to(dev), critic.to(dev)
    target_actor = copy.deepcopy(actor).requires_grad_(False)
    target_critic = copy.deepcopy(critic).requires_grad_(False)
    actor_opt, critic_opt = make_optimizers(config, actor, critic)
    return TrainState(actor, critic, target_actor, target_critic, actor_opt, critic_opt)


@torch.no_grad()
def act_deterministic(config: D4PGConfig, actor: Actor, obs: torch.Tensor) -> torch.Tensor:
    """Greedy policy for evaluation."""
    return actor(obs)


@torch.no_grad()
def act(
    config: D4PGConfig,
    actor: Actor,
    obs: torch.Tensor,
    generator: torch.Generator,
    noise_scale: float = 1.0,
) -> torch.Tensor:
    """Tanh actor + scaled Gaussian noise, clipped to [−1, 1]."""
    a = actor(obs)
    noise = gaussian_noise_sample(
        gaussian_noise_init(config.noise_epsilon, device=a.device),
        generator,
        a.shape,
        sigma=config.noise_sigma,
    )
    return (a + noise_scale * noise).clamp(-1.0, 1.0)


def make_noise(config: D4PGConfig, batch: tuple = (), device=None):
    """The noise process of ``config.noise_kind`` as (init, sample, reset)
    over an explicit state batched by ``batch`` (e.g. ``(num_envs,)``):

      - ``init() -> state``
      - ``sample(state, generator, shape) -> (noise, state)``
      - ``reset(state) -> state`` (per episode)
    """
    eps_shape = batch + (1,) if batch else ()
    if config.noise_kind == "gaussian":

        def init():
            return gaussian_noise_init(config.noise_epsilon, eps_shape, device)

        def sample(state, generator, shape):
            return gaussian_noise_sample(state, generator, shape, sigma=config.noise_sigma), state

        def reset(state):
            return state  # ε-decay is the trainer's noise_scale schedule

    elif config.noise_kind == "ou":

        def init():
            return ou_noise_init(
                config.action_dim, epsilon=config.noise_epsilon, batch=batch, device=device
            )

        def sample(state, generator, shape):
            x, state = ou_noise_sample(
                state, generator, theta=config.ou_theta, mu=config.ou_mu, sigma=config.ou_sigma
            )
            return x.expand(shape), state

        def reset(state):
            return ou_noise_reset(state, decay=0.0)

    else:
        raise ValueError(f"unknown noise kind: {config.noise_kind}")
    return init, sample, reset


def exploration_mixture(
    config: D4PGConfig, generator: torch.Generator, a: torch.Tensor
) -> torch.Tensor:
    """With probability ``random_eps`` replace the WHOLE action vector by a
    uniform draw from the box; identity when ``random_eps`` is 0."""
    if not config.random_eps:
        return a
    u = torch.rand(a.shape, generator=generator, device=a.device) * 2.0 - 1.0
    take = torch.rand(a.shape[:-1] + (1,), generator=generator, device=a.device)
    return torch.where(take < config.random_eps, u, a)


def noisy_explore(config: D4PGConfig, noise_sample, a, generator, nstate, scale):
    """Collection action: additive noise + clip, then the ε-uniform mixture."""
    n, nstate = noise_sample(nstate, generator, a.shape)
    a = (a + scale * n).clamp(-1.0, 1.0)
    return exploration_mixture(config, generator, a), nstate


def _loss_terms(config, support, pred, target_probs, batch, descent):
    """Per-sample (ce, overlap) under the configured projection backend,
    plus the next step's raw leaf indices when ``descent`` is given."""
    if descent is not None:
        leaves, next_prefixes, chunk_offsets = descent
        return fused_categorical_loss_descent(
            support, pred, target_probs, batch["reward"], batch["discount"],
            next_prefixes, leaves, chunk_offsets,
        )
    if config.projection_backend == "fused":
        ce, ov = fused_categorical_loss(
            support, pred, target_probs, batch["reward"], batch["discount"]
        )
    else:
        ce, ov = ce_and_overlap(
            project(support, target_probs, batch["reward"], batch["discount"]), pred
        )
    return ce, ov, None


def train_step(
    config: D4PGConfig, state: TrainState, batch: Mapping[str, torch.Tensor],
    descent=None,
):
    """One full D4PG SGD step, in place on ``state``.

    Args:
      batch: obs [B,O], action [B,A], reward [B], next_obs [B,O],
        discount [B] (= γ^m·(1−terminal)), and optionally weights [B]
        (PER importance weights; absent → ones). All on the state's device.
      descent: ``(leaves [L], next_prefixes [B], chunk_offsets)``, the
        fused-descent seam: the step's loss kernel (B4) also descends the
        device PER tree for the NEXT step's prefixes. ``chunk_offsets``
        ([num_chunks(L)] float32, the leaf mass before each 1024-leaf
        chunk) are those kernel B3 returned for ``leaves`` this dispatch
        (its plain version's on the CPU). Requires
        ``projection_backend="fused"``.

    Returns:
      (state, metrics dict of 0-d tensors, priorities [B]) — the metrics and
      priorities stay on the device; reading them synchronises. With
      ``descent``, a fourth element: next_idx [B] int32, the raw leaf
      indices before the fill clamp.
    """
    if descent is not None and config.projection_backend != "fused":
        raise ValueError(
            "descent= (the fused-descent tier) requires projection_backend="
            f"'fused', got {config.projection_backend!r}"
        )
    support = support_of(config)
    weights = batch.get("weights")

    # ---- target: softmax(Z_target(s', μ_target(s'))) ----
    with torch.no_grad():
        next_action = state.target_actor(batch["next_obs"])
        target_probs = torch.softmax(
            state.target_critic(batch["next_obs"], next_action), dim=-1
        )

    # ---- critic ----
    pred = state.critic(batch["obs"], batch["action"])
    ce, overlap, next_idx = _loss_terms(config, support, pred, target_probs, batch, descent)
    critic_loss = (ce if weights is None else weights * ce).mean()
    priorities = (overlap if config.priority_kind == "overlap" else ce).detach()
    state.critic_opt.zero_grad(set_to_none=True)
    critic_loss.backward()
    state.critic_opt.step()

    # ---- actor: maximise E[Q(s, μ(s))] against the UPDATED critic ----
    a = state.actor(batch["obs"])
    q_mean = expected_value(
        support, torch.softmax(state.critic(batch["obs"], a), dim=-1)
    ).mean()
    actor_loss = -q_mean
    if config.action_l2:
        actor_loss = actor_loss + config.action_l2 * a.square().mean()
    state.actor_opt.zero_grad(set_to_none=True)
    # inputs= keeps the critic's .grad untouched by the actor loss
    actor_loss.backward(inputs=list(state.actor.parameters()))
    state.actor_opt.step()

    # ---- Polyak target updates (in place) ----
    polyak_update(state.target_actor, state.actor, config.tau)
    polyak_update(state.target_critic, state.critic, config.tau)
    state.step += 1

    q_mean = q_mean.detach()
    metrics = {
        "critic_loss": critic_loss.detach(),
        "actor_loss": actor_loss.detach(),
        "priority_mean": priorities.mean(),
        "q_mean": q_mean,
        "q_support_frac": (q_mean - config.dist.v_min)
        / (config.dist.v_max - config.dist.v_min),
    }
    if descent is not None:
        return state, metrics, priorities, next_idx
    return state, metrics, priorities


BATCH_FIELDS = ("obs", "action", "reward", "next_obs", "discount")


def gather_batches(store, idx: torch.Tensor) -> dict:
    """[K, B] batches from a columnar store (the device ring) in ONE gather
    per field. No ``weights`` key: the uniform megastep trains without one
    (IS weights identically 1) and the PER megastep adds its own."""
    flat = idx.reshape(-1).long()
    return {
        k: getattr(store, k).index_select(0, flat).reshape(
            idx.shape + getattr(store, k).shape[1:]
        )
        for k in BATCH_FIELDS
    }


def fused_train_scan(config: D4PGConfig, state: TrainState, batches: dict):
    """``train_step`` over pre-gathered [K, B] batches, a Python loop over K
    (the JAX ``lax.scan``), in place on ``state``. Returns (state, metrics
    dict of [K] tensors, priorities [K, B])."""
    k = batches["reward"].shape[0]
    step_metrics, priorities = [], []
    for t in range(k):
        _, m, pri = train_step(config, state, {key: v[t] for key, v in batches.items()})
        step_metrics.append(m)
        priorities.append(pri)
    metrics = {key: torch.stack([m[key] for m in step_metrics]) for key in step_metrics[0]}
    return state, metrics, torch.stack(priorities)
