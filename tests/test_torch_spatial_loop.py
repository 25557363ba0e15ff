"""The on-device loop and the CLI on the port's 3D envs, against the JAX
package's, on the CPU (``tests/test_torch_spatial_envs.py`` holds the
envs themselves).

- One warmup and one PER train iteration of each package's on-device loop
  on Humanoid at hidden 32,32 with 4 envs, from one JAX
  ``create_train_state`` and the same env states, the JAX rollout's
  exploration noise and train draws fed to the port (as
  ``tests/test_torch_on_device.py`` does for Pendulum): ring rows,
  priorities, parameters and metrics.
- The CLI: ``--device cpu --on-device --env humanoid`` with a checkpoint
  and a ``--resume``, and one host-placement run on ``--env ant``.

Tolerances: ``tests/test_torch_on_device.py``'s (ring rows atol and rtol
1e-5, parameters atol 10·lr and median lr/10, metrics rtol 1e-3,
priorities rtol 1e-3), but for the observations in the ring and the
carry: they hold v after eight control steps of 10 contact substeps each,
atol 1e-4 (measured: up to 2.7e-5; action, reward and discount within
3e-6).
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.envs import locomotion as jl
from d4pg_tpu_torch.envs import EnvState, Humanoid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


N_ENVS, SEG, CAP, K, B, LR = 4, 4, 64, 3, 8, 1e-4
HIDDEN = (32, 32)
OBS_ATOL = 1e-4   # ring and carry observations (see the docstring)


def _configs():
    from d4pg_tpu.agent import D4PGConfig as JConfig
    from d4pg_tpu.models.critic import DistConfig as JDist
    from d4pg_tpu_torch.agent import D4PGConfig, DistConfig

    common = dict(obs_dim=45, action_dim=17, hidden_sizes=HIDDEN, tau=0.05, n_step=3,
                  lr_actor=LR, lr_critic=LR, prioritized=True)
    jcfg = JConfig(dist=JDist(num_atoms=51, v_min=0.0, v_max=1500.0),
                   projection_backend="pallas_fused", **common)
    common.pop("prioritized")
    tcfg = D4PGConfig(dist=DistConfig(num_atoms=51, v_min=0.0, v_max=1500.0),
                      projection_backend="fused", **common)
    return jcfg, tcfg


def _segment_noise(k_roll, cfg):
    """The exploration noise the JAX segment collector draws from
    ``k_roll`` ([N, T, A]; ``tests/test_torch_on_device.py``'s, 17 dims)."""
    from d4pg_tpu.ops.noise import gaussian_noise_init as j_noise_init

    base = j_noise_init(cfg.noise_epsilon)

    def env_noise(k):
        key, _ = jax.random.split(k)
        act = jax.vmap(lambda s: jax.random.split(s)[0])(jax.random.split(key, SEG))
        return jax.vmap(lambda a: base.epsilon * cfg.noise_sigma * jax.random.normal(a, (17,)))(act)

    return np.asarray(jax.vmap(env_noise)(jax.random.split(k_roll, N_ENVS)))


def _fed_noise(blocks):
    from d4pg_tpu_torch.agent import D4PGConfig
    from d4pg_tpu_torch.agent.d4pg import make_noise

    steps = [torch.tensor(b[:, t]) for b in blocks for t in range(b.shape[1])]
    init, _, reset = make_noise(D4PGConfig(), (N_ENVS,))

    def sample(state, generator, shape):
        return steps.pop(0), state

    return init, sample, reset


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's engine on the CPU runs small batched products: one
    thread each. Under xdist, MKL's eight threads a worker spin against
    the other workers' (tests/test_torch_spatial_envs.py's drop: 4 s on
    one thread, 113 s in the suite on eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def humanoid_iterate():
    """One warmup and one PER train iteration of each package's on-device
    loop on Humanoid at hidden 32,32 with 4 envs, from one JAX
    ``create_train_state`` and the same env states, the JAX noise and
    draws fed to the port."""
    from d4pg_tpu.agent import create_train_state as j_create
    from d4pg_tpu.runtime import on_device as jod
    from d4pg_tpu_torch.agent import create_train_state
    from d4pg_tpu_torch.runtime import on_device as od
    from d4pg_tpu_torch.weights import load_jax_params

    jcfg, tcfg = _configs()
    init_fn, warmup_fn, iterate_fn = jod.make_on_device_trainer(
        jcfg, jl.Humanoid(), num_envs=N_ENVS, segment_len=SEG, replay_capacity=CAP,
        batch_size=B, train_steps_per_iter=K)
    jst = j_create(jcfg, jax.random.PRNGKey(1))
    carry = init_fn(jst, jax.random.PRNGKey(2))
    init_params = [jax.device_get(p) for p in (jst.actor_params, jst.critic_params)]
    env_states, obs = carry[1], carry[2]
    _, k_roll_w = jax.random.split(carry[5])
    carry = warmup_fn(carry, 1.0)
    _, k_roll_i, k_train = jax.random.split(carry[5], 3)
    draws = np.array(jax.random.uniform(k_train, (K, B)))
    carry, jm = iterate_fn(carry, 1.0)
    noise = [_segment_noise(k_roll_w, jcfg), _segment_noise(k_roll_i, jcfg)]

    t_init, t_warm, t_iter = od.make_on_device_trainer(
        tcfg, Humanoid(), num_envs=N_ENVS, segment_len=SEG, replay_capacity=CAP,
        batch_size=B, train_steps_per_iter=K, prioritized=True, device="cpu",
        noise_fns=_fed_noise(noise))
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, *init_params)
    physics = np.concatenate([np.asarray(p) for p in env_states.physics], -1)
    tc = t_init(tst, 0)._replace(
        env_states=EnvState(torch.tensor(physics), torch.tensor(np.asarray(env_states.t))),
        obs=torch.tensor(np.asarray(obs)))
    tc = t_warm(tc, 1.0)
    tc, tm = t_iter(tc, 1.0, draws=torch.from_numpy(draws))
    return carry, {k: float(v) for k, v in jm.items()}, tc, {k: float(v) for k, v in tm.items()}


def test_on_device_iterate_fills_the_same_ring(humanoid_iterate):
    jc, _, tc, _ = humanoid_iterate
    jr, tr = jc[4], tc.replay
    assert (tr.size, tr.pos) == (int(jr.size), int(jr.pos)) == (2 * N_ENVS * SEG,) * 2
    for k in ("obs", "action", "reward", "next_obs", "discount"):
        atol = OBS_ATOL if k.endswith("obs") else 1e-5
        np.testing.assert_allclose(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)),
                                   atol=atol, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tc.obs.numpy(), np.asarray(jc[2]), atol=OBS_ATOL, rtol=1e-5)
    np.testing.assert_array_equal(tc.env_states.t.numpy(), np.asarray(jc[1].t))
    assert tr.obs.shape[1] == 45 and tr.action.shape[1] == 17


def test_on_device_iterate_trains_to_the_same_state(humanoid_iterate):
    jc, jm, tc, tm = humanoid_iterate
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
    assert float(tc.replay.max_priority) > 1.0


# ------------------------------------------------------------------- CLI
SMALL = ["--device", "cpu", "--hidden-sizes", "16,16", "--num-envs", "2", "--rmsize", "4096",
         "--eval-episodes", "1", "--max-steps", "20"]


def _run(args, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env.setdefault("OMP_NUM_THREADS", "2")
    return subprocess.run([sys.executable, "-m", "d4pg_tpu_torch.train", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


def _metrics(log_dir):
    return [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]


def test_cli_on_device_humanoid_checkpoint_then_resume(tmp_path):
    from tools.d4pglint.schema_check import check_metrics_jsonl

    args = SMALL + ["--on-device", "--env", "humanoid", "--bsize", "16", "--warmup", "64",
                    "--eval-interval", "64", "--checkpoint-interval", "64",
                    "--log-dir", str(tmp_path)]
    first = _run(args + ["--total-steps", "64"])
    assert first.returncode == 0, first.stdout[-2000:] + first.stderr[-2000:]
    second = _run(args + ["--total-steps", "64", "--resume"])
    assert second.returncode == 0, second.stdout[-2000:] + second.stderr[-2000:]
    assert "[checkpoint] resumed from step 64" in second.stdout
    rows = _metrics(tmp_path)
    # 2 envs x 32 steps = 64 env steps and 64 grad steps an iteration; the
    # resumed leg re-warms an empty ring, env_steps continue from the meta
    assert [r["step"] for r in rows] == [64, 128]
    assert [r["replay_size"] for r in rows] == [128, 128]
    assert [r["env_steps"] for r in rows] == [128, 256]
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert check_metrics_jsonl(str(tmp_path / "metrics.jsonl")) == []
    assert os.path.exists(tmp_path / "checkpoints" / "manifest_128.json")


def test_cli_host_placement_ant(tmp_path):
    out = _run(SMALL + ["--env", "ant", "--bsize", "8", "--warmup", "64", "--total-steps", "16",
                        "--eval-interval", "8", "--log-dir", str(tmp_path)])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rows = _metrics(tmp_path)
    assert [r["step"] for r in rows] == [8, 16]
    assert all(math.isfinite(v) for r in rows for v in r.values())
    assert rows[-1]["replay_size"] >= 64 and "eval_return_mean" in rows[-1]
