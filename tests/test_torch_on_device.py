"""The port's on-device loop (``d4pg_tpu_torch/runtime/on_device.py``)
against the JAX package's, on the CPU.

- ``_append`` writes the same rows, priorities, ``pos`` and ``size`` as
  the JAX one, and a ring that is not a multiple of num_envs·segment_len
  is refused with the JAX message.
- The PER draw (``cumsum`` + left-side ``searchsorted``, clamped to the
  filled rows), the β-annealed IS weights and the ordered write-back
  against the JAX iterate's arithmetic (written out below, as the JAX
  package keeps it inline), fed the same uniform numbers, drawn from a JAX
  key.
- One warmup and one train iteration of each package's loop at a small
  width, uniform and PER, from one JAX ``create_train_state`` and the same
  env states, with the JAX rollout's exploration noise and train draws
  (computed here from the JAX carry's key) fed to the port: ring rows,
  priorities, parameters and metrics. The JAX side runs its fused Pallas
  loss in interpret mode; the port runs its kernels' plain versions.

Tolerances: ring rows atol 1e-5 and rtol 1e-5 (an actor forward and a
Pendulum step on each side, n-step sums of rewards up to ~20); IS weights
rtol 1e-5 (a power of float32 ratios); priorities rtol 1e-3 and parameters atol 10·lr, median lr/10
(``test_torch_megastep``'s, after the step's loss, whose sign flips drift);
metrics rtol 1e-3. The draws and the rows a draw selects are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.envs.pendulum import Pendulum as JPendulum
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.ops.noise import gaussian_noise_init as j_noise_init
from d4pg_tpu.runtime import on_device as jod
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state
from d4pg_tpu_torch.agent.d4pg import make_noise
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.envs import EnvState, Pendulum
from d4pg_tpu_torch.runtime import on_device as od
from d4pg_tpu_torch.weights import load_jax_params

N_ENVS, SEG, CAP, K, B, LR = 2, 8, 64, 3, 4, 1e-4
HIDDEN = (16, 16)


def _configs():
    common = dict(obs_dim=3, action_dim=1, hidden_sizes=HIDDEN, tau=0.05, n_step=3,
                  lr_actor=LR, lr_critic=LR)
    jcfg = JConfig(dist=JDist(num_atoms=11, v_min=-50.0, v_max=0.0),
                   projection_backend="pallas_fused", **common)
    tcfg = D4PGConfig(dist=DistConfig(num_atoms=11, v_min=-50.0, v_max=0.0),
                      projection_backend="fused", **common)
    return jcfg, tcfg


def _batch(n, seed):
    r = np.random.default_rng(seed)
    return {
        "obs": r.normal(size=(n, 3)).astype(np.float32),
        "action": r.uniform(-1, 1, (n, 1)).astype(np.float32),
        "reward": r.normal(size=n).astype(np.float32),
        "next_obs": r.normal(size=(n, 3)).astype(np.float32),
        "discount": np.full(n, 0.97, np.float32),
    }


# ------------------------------------------------------------------ ring
def test_append_matches_the_reference():
    alpha = 0.6
    jr = jod.device_replay_init(CAP, 3, 1)._replace(max_priority=jnp.float32(2.5))
    tr = od.device_replay_init(CAP, 3, 1, "cpu")
    tr.max_priority = torch.tensor(2.5)
    for i in range(5):  # 5 blocks of 16 into 64 rows: wraps once
        b = _batch(16, i)
        jr = jod._append(jr, {k: jnp.asarray(v) for k, v in b.items()}, 16, alpha)
        od._append(tr, {k: torch.from_numpy(v) for k, v in b.items()}, 16, alpha)
        assert (tr.pos, tr.size) == (int(jr.pos), int(jr.size))
    for k in ("obs", "action", "reward", "next_obs", "discount", "priority"):
        np.testing.assert_array_equal(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)), err_msg=k)
    assert tr.pos == 16 and tr.size == CAP
    np.testing.assert_allclose(tr.priority.numpy(), 2.5**alpha, rtol=1e-6)


def test_capacity_must_be_a_multiple_of_the_segment_block():
    jcfg, tcfg = _configs()
    msg = "replay_capacity (100) must be a multiple of num_envs*segment_len (16)"
    with pytest.raises(ValueError, match=msg.replace("(", r"\(").replace(")", r"\)").replace("*", r"\*")):
        jod.make_on_device_trainer(jcfg, JPendulum(), num_envs=N_ENVS, segment_len=SEG,
                                   replay_capacity=100)
    with pytest.raises(ValueError) as e:
        od.make_on_device_trainer(tcfg, Pendulum(), num_envs=N_ENVS, segment_len=SEG,
                                  replay_capacity=100, device="cpu")
    assert str(e.value) == msg


# the uint8 and bf16 rings are ported (A10 (c)) and so is the mesh (A7 (c),
# tests/test_torch_on_device_mesh.py): what a mesh still refuses is a share
# its dp lanes cannot split evenly, in the JAX package's words
@pytest.mark.parametrize("kw,item", [(dict(dp=3), "num_envs"),
                                     (dict(dp=2, obs_uint8=True, batch_size=3), "batch_size"),
                                     (dict(dp=2, obs_bf16=True, replay_capacity=36),
                                      "replay_capacity")],
                         ids=["mesh", "uint8", "bf16"])
def test_unported_rings_are_refused_naming_the_roadmap_item(kw, item):
    from d4pg_tpu.parallel import make_mesh as j_make_mesh
    from d4pg_tpu_torch.parallel.mesh import make_mesh

    jcfg, tcfg = _configs()
    kw = dict(dict(num_envs=N_ENVS, segment_len=SEG, replay_capacity=CAP), **kw)
    dp = kw.pop("dp")
    with pytest.raises(ValueError, match=item) as je:
        jod.make_on_device_trainer(jcfg, JPendulum(), mesh=j_make_mesh(dp=dp),
                                   **{k: v for k, v in kw.items() if k != "obs_uint8"})
    with pytest.raises(ValueError, match=item) as e:
        od.make_on_device_trainer(tcfg, Pendulum(), device="cpu",
                                  mesh=make_mesh(dp, device="cpu", num_processes=1,
                                                 process_index=0), **kw)
    assert str(e.value) == str(je.value)


def test_obs_norm_is_refused_with_the_reference_message():
    @dataclasses.dataclass(frozen=True)
    class WithObsNorm(TrainConfig):
        obs_norm: bool = True

    with pytest.raises(ValueError, match="obs_norm is a host data-boundary feature; "
                                         "the on-device path does not support it"):
        od.OnDeviceRun(WithObsNorm(), device="cpu")


# ------------------------------------------------------------------- PER
def _jax_per(cfg, prio, size, u01, step):
    """The JAX iterate's PER arithmetic (``runtime/on_device.py:268-310``)."""
    cums = jnp.cumsum(prio)
    total = cums[-1]
    idx = jnp.clip(jnp.searchsorted(cums, u01 * total), 0, size - 1)
    p = prio[idx] / total
    frac = jnp.clip(jnp.float32(step) / max(cfg.per_beta_steps, 1), 0.0, 1.0)
    beta = cfg.per_beta0 + frac * (1.0 - cfg.per_beta0)
    w = (p * size) ** (-beta)
    min_p = jnp.min(jnp.where(prio > 0, prio, jnp.inf)) / total
    return idx, w / ((min_p * size) ** (-beta))


def _jax_write_back(cfg, prio, max_priority, idx, new_pri):
    pa = (jnp.abs(new_pri) + cfg.per_eps) ** cfg.per_alpha
    prio = jax.lax.fori_loop(0, idx.shape[0], lambda k, pr: pr.at[idx[k]].set(pa[k]), prio)
    return prio, jnp.maximum(max_priority, jnp.max(jnp.abs(new_pri) + cfg.per_eps))


@pytest.mark.parametrize("step", [0, 40_000, 500_000])
def test_per_draw_and_weights_match_the_reference(step):
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(step)
    size = 200
    prio = np.zeros(256, np.float32)
    prio[:size] = rng.uniform(0.0, 2.0, size) ** 0.6
    prio[rng.integers(0, size, 20)] = 0.0  # zero-mass rows are never drawn
    u01 = np.array(jax.random.uniform(jax.random.PRNGKey(step), (8, 32)))
    jidx, jw = _jax_per(jcfg, jnp.asarray(prio), size, jnp.asarray(u01), step)
    idx, w = od.per_draw(tcfg, torch.from_numpy(prio), size, torch.from_numpy(u01), step)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5)
    assert (prio[idx.numpy()] > 0).all() and idx.max() < size
    assert idx.dtype == torch.int64 and w.max() <= 1.0 + 1e-6


def test_per_write_back_is_ordered_like_the_reference():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(1)
    prio = rng.uniform(0.1, 1.0, 64).astype(np.float32)
    idx = rng.integers(0, 24, (6, 8))  # duplicates within and across steps
    idx[5, :2] = [30, 31]
    new_pri = rng.normal(0, 3.0, (6, 8)).astype(np.float32)
    jp, jmax = _jax_write_back(jcfg, jnp.asarray(prio), jnp.float32(1.0), jnp.asarray(idx),
                               jnp.asarray(new_pri))
    ring = od.device_replay_init(64, 3, 1, "cpu")
    ring.priority.copy_(torch.from_numpy(prio))
    od.per_write_back(tcfg, ring, torch.from_numpy(idx), torch.from_numpy(new_pri))
    got, want = ring.priority.numpy(), np.asarray(jp)
    pa = (np.abs(new_pri) + tcfg.per_eps) ** tcfg.per_alpha
    for slot in range(64):
        steps = np.flatnonzero((idx == slot).any(axis=1))
        if not len(steps):  # not drawn: untouched
            assert got[slot] == prio[slot]
            continue
        last = steps[-1]  # the latest step wins; within it, any of its writes
        written = pa[last][idx[last] == slot]
        assert np.isclose(written, got[slot], rtol=1e-6).any(), slot
        if len(written) == 1:
            np.testing.assert_allclose(got[slot], want[slot], rtol=1e-6)
    np.testing.assert_allclose(float(ring.max_priority), float(jmax), rtol=1e-6)


# --------------------------------------------------------------- iterate
def _segment_noise(k_roll, cfg):
    """The exploration noise the JAX segment collector draws from
    ``k_roll``: per env ``split(k_roll, N)[i]``, then the rollout's step
    keys and each step's action key (``envs/rollouts.py``)."""
    base = j_noise_init(cfg.noise_epsilon)

    def env_noise(k):
        key, _ = jax.random.split(k)
        act = jax.vmap(lambda s: jax.random.split(s)[0])(jax.random.split(key, SEG))
        return jax.vmap(lambda a: base.epsilon * cfg.noise_sigma * jax.random.normal(a, (1,)))(act)

    return np.asarray(jax.vmap(env_noise)(jax.random.split(k_roll, N_ENVS)))  # [N, T, A]


def _fed_noise(blocks):
    """Noise functions that hand out ``blocks`` ([N, T, A] each) step by step."""
    steps = [torch.tensor(b[:, t]) for b in blocks for t in range(b.shape[1])]
    init, _, reset = make_noise(D4PGConfig(), (N_ENVS,))

    def sample(state, generator, shape):
        return steps.pop(0), state

    return init, sample, reset


@pytest.fixture(scope="module", params=[False, True], ids=["uniform", "per"])
def iterate_pair(request):
    prioritized = request.param
    jcfg, tcfg = _configs()
    jcfg = dataclasses.replace(jcfg, prioritized=prioritized)
    env = JPendulum()
    init_fn, warmup_fn, iterate_fn = jod.make_on_device_trainer(
        jcfg, env, num_envs=N_ENVS, segment_len=SEG, replay_capacity=CAP,
        batch_size=B, train_steps_per_iter=K)
    jst = j_create(jcfg, jax.random.PRNGKey(1))
    carry = init_fn(jst, jax.random.PRNGKey(2))
    init_params = [jax.device_get(p) for p in (jst.actor_params, jst.critic_params)]
    env_states, obs = carry[1], carry[2]
    _, k_roll_w = jax.random.split(carry[5])
    carry = warmup_fn(carry, 3.0)
    _, k_roll_i, k_train = jax.random.split(carry[5], 3)
    if prioritized:
        draws = np.array(jax.random.uniform(k_train, (K, B)))
    else:
        # the iterate draws after its own segment landed in the ring
        size = carry[4].size + N_ENVS * SEG
        draws = np.array(jax.random.randint(k_train, (K, B), 0, size))
    carry, jm = iterate_fn(carry, 1.0)
    noise = [_segment_noise(k_roll_w, jcfg), _segment_noise(k_roll_i, jcfg)]

    t_init, t_warm, t_iter = od.make_on_device_trainer(
        tcfg, Pendulum(), num_envs=N_ENVS, segment_len=SEG, replay_capacity=CAP,
        batch_size=B, train_steps_per_iter=K, prioritized=prioritized, device="cpu",
        noise_fns=_fed_noise(noise))
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, *init_params)
    tc = t_init(tst, 0)._replace(
        env_states=EnvState(torch.tensor(np.asarray(env_states.physics)),
                            torch.tensor(np.asarray(env_states.t))),
        obs=torch.tensor(np.asarray(obs)))
    tc = t_warm(tc, 3.0)
    tc, tm = t_iter(tc, 1.0, draws=torch.from_numpy(draws))
    return carry, {k: float(v) for k, v in jm.items()}, tc, {k: float(v) for k, v in tm.items()}


def test_iterate_fills_the_same_ring(iterate_pair):
    jc, _, tc, _ = iterate_pair
    jr, tr = jc[4], tc.replay
    assert (tr.size, tr.pos) == (int(jr.size), int(jr.pos)) == (2 * N_ENVS * SEG,) * 2
    for k in ("obs", "action", "reward", "next_obs", "discount"):
        np.testing.assert_allclose(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tc.obs.numpy(), np.asarray(jc[2]), atol=1e-5)
    np.testing.assert_array_equal(tc.env_states.t.numpy(), np.asarray(jc[1].t))


def test_iterate_trains_to_the_same_state(iterate_pair):
    jc, jm, tc, tm = iterate_pair
    jst, tst = jc[0], tc.state
    assert tst.step == int(jst.step) == K
    pairs = [(tst.actor, jst.actor_params), (tst.critic, jst.critic_params),
             (tst.target_actor, jst.target_actor_params),
             (tst.target_critic, jst.target_critic_params)]
    for module, tree in pairs:
        layers = tree["params"]
        for name, prm in module.named_parameters():
            layer, kind = name.split(".")
            leaf = np.asarray(layers[layer]["kernel" if kind == "weight" else "bias"])
            diff = np.abs(prm.detach().numpy() - (leaf.T if kind == "weight" else leaf))
            assert diff.max() <= 10 * LR and np.median(diff) <= LR / 10, name
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tc.replay.priority.numpy(), np.asarray(jc[4].priority), rtol=1e-3)
    np.testing.assert_allclose(float(tc.replay.max_priority), float(jc[4].max_priority), rtol=1e-3)
    if jc[0].step and float(jc[4].max_priority) != 1.0:  # PER: priorities moved
        assert float(tc.replay.max_priority) > 1.0
