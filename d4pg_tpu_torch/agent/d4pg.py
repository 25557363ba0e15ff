"""D4PG algorithm core (counterpart of ``d4pg_tpu/agent/d4pg.py``).

:func:`train_step` is the reference's step (``agent/d4pg.py:train_step``):
target forward, the critic loss of the configured head, the critic Adam
step, the actor's −E[Q] loss against the UPDATED critic, the actor Adam
step, and the Polyak update of both targets. The heads' losses:

- categorical: softmax of the target head, the fused projection +
  cross-entropy kernel (or the projection kernel and a torch CE), PER
  priority the CE (or the overlap);
- scalar: the TD(n) target ``r + d·Q'``, a weighted squared loss,
  priority ``|td|``;
- mixture of Gaussians: the Gauss-Hermite cross-entropy of ``ops/mog.py``,
  priority ``|y_mean − E[Z_online]|``.

PyTorch runs it eagerly and updates the state in place; the JAX version
is a pure function of an immutable state.

With stacked critics (``twin_critic``, ``critic_ensemble``) the critic is
a :class:`~d4pg_tpu_torch.models.StackedCritic` of E members: the target
is the clipped-min (twin) or random-subset-min (REDQ) member's whole
distribution, every member regresses it (one fused-loss launch over the
E×B rows, the JAX package's vmap), the loss is the members' sum and the
priorities their mean. The member is chosen by :func:`_critic_value`, the
head's E[Z], so the stacks take every head. Under ``compute_dtype="bfloat16"`` the networks
compute in bfloat16 on float32 master weights. With pixels (``pixel_shape``)
both networks conv-encode the flattened frames, and the step first shifts
``obs`` and ``next_obs`` by DrQ's random ±``augment_pad`` offsets
(``ops/augment.py``), drawn from ``TrainState.augment_gen``.

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
from d4pg_tpu_torch.agent.state import (
    D4PGConfig,
    TrainState,
    check_supported,
    head_of,
    stack_of,
    stacked_critics,
)
from d4pg_tpu_torch.models import Actor, Critic, StackedCritic
from d4pg_tpu_torch.models.critic import mixture_gaussian_mean
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
from d4pg_tpu_torch.ops.augment import draw_offsets, random_shift
from d4pg_tpu_torch.ops.cuda_fused_step import fused_categorical_loss_descent
from d4pg_tpu_torch.ops.mog import mog_bellman_targets, mog_cross_entropy


def support_of(config: D4PGConfig) -> CategoricalSupport:
    return make_support(config.dist.v_min, config.dist.v_max, config.dist.num_atoms)


def compute_dtype_of(config: D4PGConfig) -> torch.dtype:
    return torch.bfloat16 if config.compute_dtype == "bfloat16" else torch.float32


def _member_generators(generator: torch.Generator, n: int) -> list:
    """``n`` generators seeded from draws of ``generator``, one per stacked
    critic: the JAX package's ``jax.random.split(k_critic, n)``."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator, dtype=torch.int64)
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def build_networks(
    config: D4PGConfig, generator: torch.Generator | None = None
) -> tuple[Actor, Critic | StackedCritic]:
    """Actor and critic on the CPU, initialised from ``generator`` if given
    (the actor first, then the critic; a stack of E critics from E
    generators drawn from it)."""
    check_supported(config)
    dtype = compute_dtype_of(config)
    pixels = dict(pixel_shape=tuple(config.pixel_shape) if config.pixel_shape else None,
                  encoder_embed_dim=config.encoder_embed_dim)
    actor = Actor(
        config.obs_dim, config.action_dim, tuple(config.hidden_sizes), generator=generator,
        compute_dtype=dtype, **pixels,
    )

    def critic(gen):
        return Critic(
            config.obs_dim, config.action_dim, config.dist, tuple(config.hidden_sizes),
            generator=gen, compute_dtype=dtype, **pixels,
        )

    n_stack = stacked_critics(config)
    if not n_stack:
        return actor, critic(generator)
    gens = _member_generators(generator, n_stack) if generator is not None else [None] * n_stack
    return actor, StackedCritic([critic(g) for g in gens])


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
    ``device`` (default: the CUDA card) and hard-copy the targets. With a
    REDQ ensemble the state also gets the device generator of its target
    subsets, seeded from a draw of the same seed stream, and with pixels
    (and ``augment_pad`` > 0) the device generator of the DrQ shift
    offsets, seeded from the next draw."""
    dev = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(int(seed))
    actor, critic = build_networks(config, gen)
    actor, critic = actor.to(dev), critic.to(dev)
    target_actor = copy.deepcopy(actor).requires_grad_(False)
    target_critic = copy.deepcopy(critic).requires_grad_(False)
    actor_opt, critic_opt = make_optimizers(config, actor, critic)
    subset_gen = None
    if config.critic_ensemble:
        subset_seed = int(torch.randint(0, 2**62, (1,), generator=gen, dtype=torch.int64))
        subset_gen = torch.Generator(dev).manual_seed(subset_seed)
    augment_gen = None
    if shifts(config):
        augment_seed = int(torch.randint(0, 2**62, (1,), generator=gen, dtype=torch.int64))
        augment_gen = torch.Generator(dev).manual_seed(augment_seed)
    return TrainState(actor, critic, target_actor, target_critic, actor_opt, critic_opt,
                      stack=stack_of(config), subset_gen=subset_gen, head=head_of(config),
                      augment_gen=augment_gen)


def shifts(config: D4PGConfig) -> bool:
    """Whether the train step applies the DrQ random shift."""
    return bool(config.pixel_shape) and config.augment_pad > 0


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


def _critic_terms(config, support, pred, target_head, batch, descent):
    """Per-sample (loss, priority, next_idx) of the configured head, [B] or
    [E, B] for a stacked ``pred``; ``target_head`` [B, H] is detached.
    ``next_idx`` is the fused descent's (categorical only), else None."""
    kind = config.dist.kind
    reward, discount = batch["reward"], batch["discount"]
    if kind == "categorical":
        target_probs = torch.softmax(target_head, dim=-1)
        ce, ov, next_idx = _loss_terms(config, support, pred, target_probs, batch, descent)
        return ce, (ov if config.priority_kind == "overlap" else ce), next_idx
    if kind == "scalar":
        # plain DDPG: the TD(n) target
        td = pred[..., 0] - (reward + discount * target_head[..., 0])
        return td.square(), td.abs(), None
    if kind == "mixture_gaussian":
        m = config.dist.num_mixtures
        y_nodes, node_w = mog_bellman_targets(
            target_head, reward, discount, m, config.dist.quadrature_points
        )
        # a scalar TD magnitude for the priorities: the CE of a continuous
        # density can be negative, which scrambles |.|-based rankings
        y_mean = reward + discount * mixture_gaussian_mean(target_head, m)
        ce = mog_cross_entropy(pred, y_nodes, node_w, m)
        return ce, (y_mean - mixture_gaussian_mean(pred, m)).abs(), None
    raise ValueError(kind)


def draw_subset(config: D4PGConfig, state: TrainState) -> torch.Tensor:
    """REDQ's target subset for one grad step: M = ``ensemble_min_targets``
    distinct members of E, uniformly, as int64 indices on the state's
    device (the JAX ``jax.random.permutation(k, E)[:M]``). Drawn as the
    first M of the argsort of E uniforms from ``state.subset_gen``: no host
    synchronisation, so it runs under the sync guard."""
    gen = state.subset_gen
    u = torch.rand(config.critic_ensemble, generator=gen, device=gen.device)
    return u.argsort()[: config.ensemble_min_targets]


def _critic_value(config: D4PGConfig, support, head: torch.Tensor) -> torch.Tensor:
    """E[Z] of a critic head [..., H] under the configured head kind → [...]."""
    kind = config.dist.kind
    if kind == "categorical":
        return expected_value(support, torch.softmax(head, dim=-1))
    if kind == "scalar":
        return head[..., 0]
    if kind == "mixture_gaussian":
        return mixture_gaussian_mean(head, config.dist.num_mixtures)
    raise ValueError(kind)


def _target_head(config, support, state, next_obs, subset):
    """The target critic's head [B, H] that the Bellman backup uses: the
    single critic's; under twin critics, per sample, the head of the
    target critic with the smaller E[Z] (member 0 on ties); under REDQ,
    per sample, the head of the smallest-E[Z] member of ``subset`` (the
    first on ties). The whole head of the chosen member, never an
    elementwise min."""
    next_action = state.target_actor(next_obs)
    heads = state.target_critic(next_obs, next_action)        # [B, H] or [E, B, H]
    if not (config.twin_critic or config.critic_ensemble):
        return heads
    vals = _critic_value(config, support, heads)               # [E, B]
    if config.twin_critic:
        return torch.where((vals[0] <= vals[1])[:, None], heads[0], heads[1])
    sub_vals = vals.index_select(0, subset)                     # [M, B]
    sub_heads = heads.index_select(0, subset)                   # [M, B, A]
    which = sub_vals.argmin(dim=0)                              # [B]
    return sub_heads.gather(0, which[None, :, None].expand(1, *heads.shape[1:]))[0]


def train_step(
    config: D4PGConfig, state: TrainState, batch: Mapping[str, torch.Tensor],
    descent=None, subset: torch.Tensor | None = None, shift=None,
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
        (its plain version's on the CPU). Requires the categorical head
        and ``projection_backend="fused"``. Under stacked critics the one
        launch descends once for all members.
      subset: REDQ only: the [M] member indices of this step's target
        subset (int64, on the state's device), in place of the draw from
        ``state.subset_gen`` (which then does not advance). The tests feed
        the subset that the JAX package drew.

    Returns:
      (state, metrics dict of 0-d tensors, priorities [B]) — the metrics and
      priorities stay on the device; reading them synchronises. With
      ``descent``, a fourth element: next_idx [B] int32, the raw leaf
      indices before the fill clamp.
    """
    if descent is not None and not (
        config.dist.kind == "categorical" and config.projection_backend == "fused"
    ):
        raise ValueError(
            "descent= (the fused-descent tier) requires the categorical head "
            f"with projection_backend='fused' (got kind={config.dist.kind!r}, "
            f"backend={config.projection_backend!r})"
        )
    n_stack = stacked_critics(config)
    if config.critic_ensemble and subset is None:
        subset = draw_subset(config, state)
    support = support_of(config)
    weights = batch.get("weights")
    if shifts(config):
        # DrQ: obs and next_obs each shifted by their own draw, before the
        # target forward (the JAX step's two keys split from state.key)
        if shift is None:
            b, pad = batch["obs"].shape[0], config.augment_pad
            shift = (draw_offsets(b, pad, state.augment_gen),
                     draw_offsets(b, pad, state.augment_gen))
        shape = tuple(config.pixel_shape)
        batch = dict(batch, obs=random_shift(batch["obs"], shift[0], shape),
                     next_obs=random_shift(batch["next_obs"], shift[1], shape))

    # ---- target: Z_target(s', μ_target(s')) ----
    # Under bfloat16 each target layer casts its float32 Polyak master to
    # bfloat16 as it runs, the values of the JAX step's bf16 copy of the
    # target params.
    with torch.no_grad():
        target_head = _target_head(config, support, state, batch["next_obs"], subset)

    # ---- critic: every stacked member regresses the same target ----
    pred = state.critic(batch["obs"], batch["action"])           # [B, H] or [E, B, H]
    loss, per_sample, next_idx = _critic_terms(
        config, support, pred, target_head, batch, descent
    )
    weighted = loss if weights is None else weights * loss
    if n_stack:
        # the members' losses summed (their gradients are independent),
        # the priorities their mean
        critic_loss = weighted.mean(dim=-1).sum()
        priorities = per_sample.mean(dim=0).detach()
    else:
        critic_loss = weighted.mean()
        priorities = per_sample.detach()
    state.critic_opt.zero_grad(set_to_none=True)
    critic_loss.backward()
    state.critic_opt.step()

    # ---- actor: maximise E[Q(s, μ(s))] against the UPDATED critic ----
    # (critic 0 under twin critics; the mean over members AND batch under
    # REDQ)
    a = state.actor(batch["obs"])
    head = state.critic(batch["obs"], a, member=0) if config.twin_critic else state.critic(
        batch["obs"], a
    )
    q_mean = _critic_value(config, support, head).mean()
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
    critic_loss = critic_loss.detach()
    metrics = {
        # per critic: comparable with a single-critic run
        "critic_loss": critic_loss / n_stack if n_stack else critic_loss,
        "actor_loss": actor_loss.detach(),
        "priority_mean": priorities.mean(),
        "q_mean": q_mean,
    }
    if config.dist.kind == "categorical":
        # the scalar and MoG heads are unbounded: no support to fill
        metrics["q_support_frac"] = (q_mean - config.dist.v_min) / (
            config.dist.v_max - config.dist.v_min
        )
    if descent is not None:
        return state, metrics, priorities, next_idx
    return state, metrics, priorities


BATCH_FIELDS = ("obs", "action", "reward", "next_obs", "discount")


def gather_batches(store, idx: torch.Tensor, decode: bool = True) -> dict:
    """[K, B] batches from a columnar store (the device ring) in ONE gather
    per field. No ``weights`` key: the uniform megastep trains without one
    (IS weights identically 1) and the PER megastep adds its own. A field
    stored as bfloat16 (the on-device ring's observations under
    ``ring_dtype="bfloat16"``) or as uint8 (a pixel ring's) is decoded to
    float32 (:func:`decode_obs`); with ``decode=False`` it stays as stored,
    and :func:`fused_train_scan` decodes one step's rows at a time (a
    pixel ring's [K, B] float32 block would be 4x the bytes: 19 GB at
    K = 2048, B = 256 of 48x48x2 frames)."""
    flat = idx.reshape(-1).long()
    out = {
        k: getattr(store, k).index_select(0, flat).reshape(
            idx.shape + getattr(store, k).shape[1:])
        for k in BATCH_FIELDS
    }
    return {k: decode_obs(v) for k, v in out.items()} if decode else out


def encode_obs(x: torch.Tensor) -> torch.Tensor:
    """Pixel observations in [0, 1] as stored bytes: ``clip(rint(x·255),
    0, 255)`` in float32 (``torch.round`` rounds half to even, as
    ``np.rint`` and ``jnp.round`` do), then uint8."""
    return (x.float() * 255.0).round().clamp(0.0, 255.0).to(torch.uint8)


def decode_obs(x: torch.Tensor) -> torch.Tensor:
    """A stored observation block back to float32: uint8 bytes divided by
    255 (a true division, as the JAX decode and the host gather do;
    ``x · (1/255)`` differs in the last bit), bfloat16 widened, float32 as
    it is. The divisor is a 0-d tensor on ``x``'s device: ATen's CUDA
    kernels divide by a Python scalar through its float32 reciprocal."""
    if x.dtype == torch.uint8:
        return x.float() / torch.full((), 255.0, device=x.device)
    return x.float()


def fused_train_scan(config: D4PGConfig, state: TrainState, batches: dict):
    """``train_step`` over pre-gathered [K, B] batches, a Python loop over K
    (the JAX ``lax.scan``), in place on ``state``; fields still in their
    stored dtype are decoded a step at a time (:func:`decode_obs`).
    Returns (state, metrics dict of [K] tensors, priorities [K, B])."""
    k = batches["reward"].shape[0]
    step_metrics, priorities = [], []
    for t in range(k):
        batch = {key: decode_obs(v[t]) for key, v in batches.items()}
        _, m, pri = train_step(config, state, batch)
        step_metrics.append(m)
        priorities.append(pri)
    metrics = {key: torch.stack([m[key] for m in step_metrics]) for key in step_metrics[0]}
    return state, metrics, torch.stack(priorities)
