"""The port's ``train_step`` against the JAX package's, on the CPU.

Both start from ONE JAX ``create_train_state`` carried across with
``d4pg_tpu_torch.weights.load_jax_params`` and take the same numpy
batches, PER importance weights included. The JAX side runs its Pallas
kernels in interpret mode (``pallas_fused`` for the port's ``fused`` rung,
``pallas`` for ``projection``); the port runs their plain PyTorch versions.

Tolerances, with their reasons:

- step-1 gradients, loss, priorities: rtol 1e-4 / atol 1e-6. Same float32
  math, summed in another order. JAX's gradient is read back from optax's
  first moment (mu = (1 − b1)·g after one step from zero).
- values read after the first Adam step (actor loss, q_mean): Adam's first
  update is −lr·g/(|g| + eps), nearly −lr·sign(g), so a near-zero gradient
  coordinate whose sign differs between the two sums moves its weight by up
  to 2·lr. q_mean, on a 300-wide support, is held to 1e-3 absolute.
- params and targets after ten chained steps: atol 10·lr (= 1e-3), the most
  ten such sign flips can move one weight; the median difference is held
  far tighter (≤ lr/10).
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.agent import jit_train_step
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state, train_step
from d4pg_tpu_torch.weights import load_jax_params

LR = 1e-4
HIDDEN = (32, 32, 32)
B = 32
PAIRS = {"fused": "pallas_fused", "projection": "pallas"}


def _configs(priority_kind, backend):
    common = dict(obs_dim=3, action_dim=1, hidden_sizes=HIDDEN, tau=0.05, n_step=3,
                  lr_actor=LR, lr_critic=LR, priority_kind=priority_kind)
    jcfg = JConfig(dist=JDist(v_min=-300.0, v_max=0.0), projection_backend=PAIRS[backend], **common)
    tcfg = D4PGConfig(dist=DistConfig(v_min=-300.0, v_max=0.0), projection_backend=backend, **common)
    return jcfg, tcfg


def _batch(rng, weights=True):
    b = {
        "obs": rng.normal(size=(B, 3)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(B, 1)).astype(np.float32),
        "reward": rng.uniform(-16, 0, size=B).astype(np.float32),
        "next_obs": rng.normal(size=(B, 3)).astype(np.float32),
        "discount": np.where(rng.uniform(size=B) < 0.2, 0.0, 0.99**3).astype(np.float32),
    }
    b["reward"][1] = -400.0  # target clips at v_min
    if weights:
        b["weights"] = rng.uniform(0.2, 1.0, size=B).astype(np.float32)
    return b


def _pair(priority_kind, backend, seed=0):
    jcfg, tcfg = _configs(priority_kind, backend)
    jst = j_create(jcfg, jax.random.PRNGKey(seed))
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, jax.device_get(jst.actor_params), jax.device_get(jst.critic_params))
    return jcfg, tcfg, jst, tst


def _torch_tree(module, tree):
    """(torch tensor, matching JAX leaf) for every parameter, kernels
    transposed to the torch layout."""
    layers = tree["params"]
    out = []
    for name, prm in module.named_parameters():
        layer, kind = name.split(".")
        leaf = np.asarray(layers[layer]["kernel" if kind == "weight" else "bias"])
        out.append((name, prm, leaf.T if kind == "weight" else leaf))
    return out


def _step(jstep, tcfg, jst, tst, batch):
    jst, jm, jpri = jstep(jst, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    _, tm, tpri = train_step(tcfg, tst, {k: torch.from_numpy(v) for k, v in batch.items()})
    return jst, jm, np.asarray(jpri), tm, tpri.numpy()


@pytest.mark.parametrize("backend", ["fused", "projection"])
@pytest.mark.parametrize("priority_kind", ["ce", "overlap"])
def test_first_step_gradients_metrics_priorities(priority_kind, backend):
    jcfg, tcfg, jst, tst = _pair(priority_kind, backend)
    batch = _batch(np.random.default_rng(1))
    jst1, jm, jpri, tm, tpri = _step(jit_train_step(jcfg, donate=False), tcfg, jst, tst, batch)

    b1 = jcfg.adam_b1
    for module, opt_state in ((tst.critic, jst1.critic_opt_state), (tst.actor, jst1.actor_opt_state)):
        mu = opt_state[0].mu
        for name, prm, leaf in _torch_tree(module, mu):
            np.testing.assert_allclose(
                prm.grad.numpy(), leaf / (1 - b1), rtol=1e-4, atol=1e-6, err_msg=name
            )

    np.testing.assert_allclose(tpri, jpri, rtol=1e-4, atol=1e-6)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("q_mean", "actor_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(float(tm["q_support_frac"]), float(jm["q_support_frac"]), atol=1e-6)
    assert set(tm) == set(jm)
    assert tst.step == int(jst1.step) == 1


@pytest.mark.parametrize("backend", ["fused", "projection"])
@pytest.mark.parametrize("priority_kind", ["ce", "overlap"])
def test_ten_chained_steps_params_and_targets(priority_kind, backend):
    jcfg, tcfg, jst, tst = _pair(priority_kind, backend, seed=3)
    rng = np.random.default_rng(4)
    jstep = jit_train_step(jcfg, donate=False)
    for _ in range(10):
        jst, jm, jpri, tm, tpri = _step(jstep, tcfg, jst, tst, _batch(rng))
    pairs = [
        (tst.actor, jst.actor_params), (tst.critic, jst.critic_params),
        (tst.target_actor, jst.target_actor_params), (tst.target_critic, jst.target_critic_params),
    ]
    for module, tree in pairs:
        for name, prm, leaf in _torch_tree(module, tree):
            diff = np.abs(prm.detach().numpy() - leaf)
            assert diff.max() <= 10 * LR, (name, diff.max())
            assert np.median(diff) <= LR / 10, (name, np.median(diff))
    np.testing.assert_allclose(tpri, jpri, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(float(tm["critic_loss"]), float(jm["critic_loss"]), rtol=1e-3)


def test_uniform_batch_without_weights_matches():
    """No ``weights`` key (uniform replay): the loss is the plain mean."""
    jcfg, tcfg, jst, tst = _pair("ce", "fused", seed=5)
    batch = _batch(np.random.default_rng(6), weights=False)
    _, jm, jpri, tm, tpri = _step(jit_train_step(jcfg, donate=False), tcfg, jst, tst, batch)
    np.testing.assert_allclose(float(tm["critic_loss"]), float(jm["critic_loss"]), rtol=1e-4)
    np.testing.assert_allclose(tpri, jpri, rtol=1e-4, atol=1e-6)


def test_one_adam_step_matches_optax():
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=(5, 4)).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    prm = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([prm], lr=LR, betas=(0.9, 0.999), eps=1e-8)
    jopt = optax.adam(LR, b1=0.9, b2=0.999)
    jp = jax.numpy.asarray(p0)
    js = jopt.init(jp)
    for g in grads:
        prm.grad = torch.from_numpy(g)
        opt.step()
        upd, js = jopt.update(jax.numpy.asarray(g), js)
        jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(prm.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-9)


def test_train_state_targets_start_as_copies_and_only_polyak_moves_them():
    tcfg = D4PGConfig(hidden_sizes=(16, 16), tau=0.5)
    st = create_train_state(tcfg, seed=0, device="cpu")
    for a, b in zip(st.actor.parameters(), st.target_actor.parameters()):
        assert torch.equal(a, b) and not b.requires_grad
    before = [p.clone() for p in st.target_critic.parameters()]
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(0)).items()}
    train_step(tcfg, st, batch)
    for b0, t, o in zip(before, st.target_critic.parameters(), st.critic.parameters()):
        # θ' ← θ' + τ(θ − θ'), against the UPDATED online params
        torch.testing.assert_close(t, b0 + 0.5 * (o.detach() - b0))


@pytest.mark.parametrize(
    "change",
    [dict(dist=DistConfig(kind="mixture_gaussian"), pixel_shape=(8, 8, 1)),
     dict(twin_critic=True, dist=DistConfig(kind="scalar"), pixel_shape=(8, 8, 1)),
     dict(critic_ensemble=3, pixel_shape=(8, 8, 1)),
     dict(pixel_shape=(8, 8, 1)), dict(dist=DistConfig(kind="scalar"), pixel_shape=(8, 8, 1))],
)
def test_unported_agent_options_raise(change):
    """Pixels were the last agent option the port refused; they are
    ported now (ROADMAP A10 (c)), so each of these configurations builds
    under its head and stack and takes one finite step with the DrQ shift
    (``tests/test_torch_pixels.py`` holds the step against the JAX
    package). A ``pixel_shape`` that does not multiply out to ``obs_dim``
    is the one refusal left, a ``ValueError``."""
    cfg = dataclasses.replace(D4PGConfig(hidden_sizes=(8,), obs_dim=64), **change)
    st = create_train_state(cfg, device="cpu")
    assert st.augment_gen is not None
    rng = np.random.default_rng(0)
    batch = {
        "obs": torch.from_numpy(rng.uniform(size=(4, 64)).astype(np.float32)),
        "action": torch.zeros(4, 1), "reward": torch.ones(4),
        "next_obs": torch.from_numpy(rng.uniform(size=(4, 64)).astype(np.float32)),
        "discount": torch.full((4,), 0.9),
    }
    _, metrics, pri = train_step(cfg, st, batch)
    assert pri.shape == (4,) and all(torch.isfinite(v) for v in metrics.values())
    with pytest.raises(ValueError, match="H\\*W\\*C == obs_dim"):
        create_train_state(dataclasses.replace(cfg, obs_dim=63), device="cpu")


def test_act_adds_scaled_clipped_noise_and_act_deterministic_is_greedy():
    from d4pg_tpu_torch.agent import act, act_deterministic

    tcfg = D4PGConfig(hidden_sizes=(16,), noise_epsilon=0.3)
    st = create_train_state(tcfg, seed=0, device="cpu")
    obs = torch.from_numpy(np.random.default_rng(0).normal(size=(4096, 3)).astype(np.float32))
    greedy = act_deterministic(tcfg, st.actor, obs)
    torch.testing.assert_close(greedy, st.actor(obs).detach())
    torch.testing.assert_close(act(tcfg, st.actor, obs, torch.Generator(), noise_scale=0.0), greedy)
    noisy = act(tcfg, st.actor, obs, torch.Generator().manual_seed(1), noise_scale=2.0)
    assert noisy.abs().max() <= 1.0
    # ε·σ·scale = 0.3·1·2 = 0.6 standard deviation before clipping
    assert 0.5 < float((noisy - greedy).std()) < 0.65
