"""The port's host actor pool, pool writer, pool collector and pool trainer
against the JAX package's, on the CPU.

Tolerances, with their reasons:

- the two pools, fed the same seeds and actions: every output
  ``array_equal`` (the same gymnasium env in the same worker protocol);
- the port's ``BatchedNStepWriter`` against the JAX one on one seeded
  stream with terminations, truncations, an ``active`` mask and a
  ``drop_actor``: the buffer contents ``array_equal``, float32 and uint8;
- the trainers on ``Pendulum-v1`` with ``num_envs`` 2 from ONE JAX state
  (carried across with ``d4pg_tpu_torch.weights.load_jax_params``): 20 pool
  steps at noise scale 0 write replay rows within 1e-5 (the two actor
  forwards round float32 apart and the env integrates their actions; both
  ways land well inside 1e-5 over 15-step episodes); one ``train_step``
  on the same indices within ``test_torch_agent``'s step tolerance (rtol
  1e-4, atol 1e-6 on the loss and priorities; the rows differ by up to
  1e-5, which moves the float32 loss by far less); the greedy eval pool's
  returns within 1e-4 relative.

Supervision (port only, a SIGKILL'd worker): its row masked on that step,
its window dropped whole (every stored row is one that per-actor
``NStepWriter`` s, reset at the drop, write from the same steps), the
restart and rejoin, quarantine after ``pool_max_worker_failures``
consecutive failures, orphaned workers exiting when the parent dies, and
no worker alive after ``close()``. The lean-import probe: the adapters and
the pool load no torch and no torch env, in this interpreter and in a
spawned child. The trainer's async collection, HER on a host goal env
(one env and the pool) and the JAX refusal of ``--async-collect`` on a
torch env. A ``pixel_pendulum`` learner fed by ``pixel_pendulum_host``
workers (``actor_env``): its uint8 rows equal those per-actor writers
write from the steps its collector's ``on_step`` saw. The per-row OU
noise reset renews the done rows only. The pools use ``fork`` except where ``spawn`` is the point.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from d4pg_tpu.agent.state import D4PGConfig as JD4PGConfig
from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.replay.nstep_writer import BatchedNStepWriter as JBatchedNStepWriter
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplayBuffer
from d4pg_tpu.runtime.actor_pool import HostActorPool as JHostActorPool
from d4pg_tpu_torch.agent import D4PGConfig, train_step
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.replay import ReplayBuffer
from d4pg_tpu_torch.replay.nstep_writer import BatchedNStepWriter, NStepWriter
from d4pg_tpu_torch.runtime.actor_pool import TRAIN_MAIN_PROBE, HostActorPool, probe_child
from d4pg_tpu_torch.runtime.collect import HostActing, PoolCollector
from d4pg_tpu_torch.runtime.trainer import Trainer
from d4pg_tpu_torch.weights import load_jax_params

gym = pytest.importorskip("gymnasium")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = "Pendulum-v1"
GOAL_ENV = "toy_goal_env:ToyGoal-v0"
FIELDS = ("obs", "action", "reward", "next_obs", "discount")


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    # a zombie child counts as gone
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except OSError:
        return False


# ------------------------------------------------------------------ pools
@pytest.mark.parametrize("cmd,name", [("step", ENV), ("step_goal", GOAL_ENV)])
def test_pools_step_as_the_reference_pool(cmd, name):
    ours = HostActorPool(name, 2, max_episode_steps=10, seed=5, start_method="fork")
    ref = JHostActorPool(name, 2, max_episode_steps=10, seed=5, start_method="fork")
    try:
        np.testing.assert_array_equal(ours.reset_all(seed=5), ref.reset_all(seed=5))
        rng = np.random.default_rng(0)
        dim = 1 if name == ENV else 2
        for _ in range(25):
            a = rng.uniform(-1, 1, (2, dim)).astype(np.float32)
            mine, theirs = getattr(ours, cmd)(a), getattr(ref, cmd)(a)
            assert len(mine) == len(theirs) == (9 if cmd == "step_goal" else 7)
            for x, y in zip(mine[:7], theirs[:7]):
                np.testing.assert_array_equal(x, y)
            for views, ref_views in zip(mine[7:], theirs[7:]):  # goal views
                for v, w in zip(views, ref_views):
                    for p, q in zip(v, w):
                        np.testing.assert_array_equal(p, q)
            np.testing.assert_array_equal(ours.stepped_mask, ref.stepped_mask)
            assert ours.take_dropped() == ref.take_dropped() == []
    finally:
        ours.close()
        ref.close()


@pytest.mark.parametrize("obs_dtype", [np.float32, np.uint8], ids=["float32", "uint8"])
def test_batched_writer_writes_the_references_rows(obs_dtype):
    N, n, T, obs_dim = 3, 3, 60, 5
    rng = np.random.default_rng(7)
    ours = ReplayBuffer(512, obs_dim, 2, obs_dtype=obs_dtype)
    ref = JReplayBuffer(512, obs_dim, 2, obs_dtype=obs_dtype,
                        obs_scale=255.0 if obs_dtype == np.uint8 else None)
    w_ours, w_ref = BatchedNStepWriter(ours, N, n, 0.97), JBatchedNStepWriter(ref, N, n, 0.97)
    obs = rng.uniform(0, 1, (N, obs_dim)).astype(np.float32)
    for t in range(T):
        a = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
        r = rng.normal(size=N).astype(np.float32)
        obs2 = rng.uniform(0, 1, (N, obs_dim)).astype(np.float32)
        term, trunc = rng.uniform(size=N) < 0.06, rng.uniform(size=N) < 0.06
        active = None
        if t % 9 == 4:
            active = rng.uniform(size=N) < 0.6
        if t == 30:
            w_ours.drop_actor(1)
            w_ref.drop_actor(1)
        assert w_ours.add_batch(obs, a, r, obs2, term, trunc, active) == \
            w_ref.add_batch(obs, a, r, obs2, term, trunc, active)
        obs = obs2
    assert len(ours) == len(ref) > 100
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)


# ------------------------------------------------------------ supervision
def _recorded_collector(max_failures=3):
    """A PoolCollector over 2 Pendulum workers with a tiny CPU actor, what
    each pool step saw recorded by its ``on_step`` hook."""
    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(8,))
    pool = HostActorPool(ENV, 2, max_episode_steps=12, seed=1, start_method="fork",
                         max_worker_failures=max_failures)
    buf = ReplayBuffer(4096, 3, 1)
    coll = PoolCollector(cfg, pool, HostActing(cfg, 2, torch.device("cpu"),
                                               torch.Generator().manual_seed(0)),
                         writer=BatchedNStepWriter(buf, 2, 3, 0.99))
    log = []
    coll.on_step = lambda s: log.append({
        "obs": s["obs"].copy(), "a": s["actions"].copy(),
        "out": [s[k].copy() for k in ("next_obs", "rewards", "terminated", "truncated")],
        "stepped": s["stepped"].copy(), "dropped": list(s["dropped"])})
    coll.reset(seed=1)
    return coll, pool, buf, log, Actor(3, 1, (8,), generator=torch.Generator().manual_seed(0))


def _rows(buf):
    cols = [np.asarray(getattr(buf, f)[: len(buf)], np.float64).reshape(len(buf), -1)
            for f in FIELDS]
    rows = np.concatenate(cols, axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _per_actor_rows(log, n_actors, n, gamma, capacity, obs_dim, **storage):
    """The rows per-actor ``NStepWriter`` s, reset at each drop, write from
    the pool steps in ``log`` (the ``_recorded_collector`` records)."""
    ref = ReplayBuffer(capacity, obs_dim, 1, **storage)
    writers = [NStepWriter(ref, n, gamma) for _ in range(n_actors)]
    for s in log:
        obs2, r, term, trunc = s["out"][:4]
        for i in s["dropped"]:
            writers[i].reset()
        for i in range(n_actors):
            if s["stepped"][i]:
                writers[i].add(s["obs"][i], s["a"][i], r[i], obs2[i], bool(term[i]),
                               bool(trunc[i]))
    return ref


def test_a_sigkilled_worker_is_masked_dropped_whole_and_rejoins():
    coll, pool, buf, log, actor = _recorded_collector()
    try:
        for _ in range(6):
            coll.step(actor, 1.0)
        os.kill(pool.pids[1], signal.SIGKILL)
        coll.step(actor, 1.0)
        # step on until it has rejoined, and 20 steps more
        deadline = time.monotonic() + 60
        while (not log[-1]["stepped"].all() or len(log) < 27) and time.monotonic() < deadline:
            time.sleep(0.02)  # let the 50 ms backoff expire
            coll.step(actor, 1.0)
        kill = log[6]
        assert not kill["stepped"][1] and kill["stepped"][0] and kill["dropped"] == [1]
        assert pool.failures_total == pool.restarts_total == 1
        assert log[-1]["stepped"].all()  # it rejoined
        assert [e["event"] for e in pool.events] == ["worker_failed", "worker_restart"]
        # no torn row: the buffer holds exactly what per-actor n-step
        # writers, reset at the drop, write from the steps that happened
        ref = _per_actor_rows(log, 2, 3, 0.99, 4096, 3)
        assert len(buf) == len(ref) > 30
        np.testing.assert_array_equal(_rows(buf), _rows(ref))
    finally:
        pool.close()


def test_consecutive_failures_quarantine_a_worker():
    coll, pool, buf, log, actor = _recorded_collector(max_failures=2)
    try:
        os.kill(pool.pids[0], signal.SIGKILL)
        coll.step(actor, 1.0)
        deadline = time.monotonic() + 30
        while pool.restarts_total == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
            coll.step(actor, 1.0)
        os.kill(pool.pids[0], signal.SIGKILL)  # before it ever steps again
        for _ in range(10):
            time.sleep(0.02)
            coll.step(actor, 1.0)
        assert pool.num_quarantined() == 1 and pool.failures_total == 2
        assert pool.events[-1]["event"] == "worker_quarantine"
        assert not log[-1]["stepped"][0] and log[-1]["stepped"][1]
    finally:
        pool.close()


def test_close_and_orphaned_parents_leave_no_worker_alive():
    pool = HostActorPool(ENV, 2, max_episode_steps=10, seed=0, start_method="fork")
    pool.reset_all(seed=0)
    pids = pool.pids
    pool.close()
    assert not any(_alive(p) for p in pids)
    # a parent killed with os._exit: the workers notice and exit
    probe = (
        "import os\n"
        "from d4pg_tpu_torch.runtime.actor_pool import HostActorPool\n"
        "pool = HostActorPool('Pendulum-v1', 2, max_episode_steps=20, seed=0, start_method='fork')\n"
        "pool.reset_all(seed=0)\n"
        "print(' '.join(str(p.pid) for p in pool._procs), flush=True)\n"
        "os._exit(0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    pids = [int(x) for x in out.stdout.split()]
    assert len(pids) == 2
    deadline = time.monotonic() + 30  # a worker polls its parent once a second
    while time.monotonic() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.25)
    leaked = [p for p in pids if _alive(p)]
    for p in leaked:
        os.kill(p, signal.SIGKILL)
    assert not leaked, f"orphaned pool workers leaked: {leaked}"


def test_adapters_and_pool_import_no_torch_here_or_in_a_spawned_child():
    probe = (
        "import sys\n"
        "import d4pg_tpu_torch.envs.gym_adapter, d4pg_tpu_torch.runtime.actor_pool\n"
        "from d4pg_tpu_torch.runtime.actor_pool import probe_child\n"
        "heavy = [m for m in sys.modules if m.split('.')[0] == 'torch' or "
        "(m.startswith('d4pg_tpu_torch.envs.') and m != 'd4pg_tpu_torch.envs.gym_adapter')]\n"
        "print(heavy)\n"
        "print(probe_child('spawn')['modules'])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=180, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "[]"], out.stdout
    # a worker spawned under `python -m d4pg_tpu_torch.train` re-imports it first
    out = subprocess.run([sys.executable, "-c", TRAIN_MAIN_PROBE], capture_output=True,
                         text=True, timeout=180, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1])["modules"] == []
    # and a forked child of a process that has torch reports what it inherited
    assert "torch" in probe_child("fork")["modules"]


# --------------------------------------------------------------- trainers
def _cfg(tmp_path, **kw):
    base = dict(env=ENV, num_envs=2, total_steps=8, warmup_steps=30, batch_size=16,
                replay_capacity=2_000, eval_interval=4, eval_episodes=1, max_episode_steps=20,
                checkpoint_interval=100_000, log_dir=str(tmp_path), pool_start_method="fork",
                agent=D4PGConfig(hidden_sizes=(16, 16)))
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("num_envs", [2, 1], ids=["pool_of_2", "single_env_pool_of_1"])
def test_async_collection_trains_and_joins(num_envs, tmp_path):
    t = Trainer(_cfg(tmp_path, num_envs=num_envs, async_collect=True, publish_interval=2),
                device="cpu")
    try:
        assert t.has_pool and t.pool.num_actors == num_envs
        out = t.train()
        assert t._collector is None and t._actor_pub is not None
        assert t._actor_pub.version >= 4  # one at the start, one each 2 grad steps
        assert t.env_steps >= 30 + 8  # the learner never outran warmup + ratio x steps
        assert all(np.isfinite(v) for v in out.values())
        t.train(total_steps=4)  # a second leg restarts the collector
        assert t.grad_steps == 12 and t._collector is None
    finally:
        t.close()


def test_a_pixel_learner_trains_on_its_host_twins_pool(tmp_path):
    """``actor_env``: a ``pixel_pendulum`` learner fed by a pool of
    ``pixel_pendulum_host`` workers (the JAX fleet's pairing). Its pool and
    eval pool run the twin, and its uint8 replay holds exactly the rows
    that per-actor n-step writers write from the steps its collector saw."""
    cfg = TrainConfig(env="pixel_pendulum", num_envs=2, batch_size=8, warmup_steps=40,
                      replay_capacity=1024, max_episode_steps=12, eval_episodes=2,
                      total_steps=4, eval_interval=4, seed=3, tree_backend="numpy",
                      pool_start_method="fork", checkpoint_interval=10**6,
                      agent=D4PGConfig(hidden_sizes=(16, 16)), log_dir=str(tmp_path))
    t = Trainer(cfg, device="cpu", actor_env="pixel_pendulum_host")
    log = []
    t.collector.on_step = lambda s: log.append({
        "obs": s["obs"].copy(), "a": s["actions"].copy(),
        "out": [s[k].copy() for k in ("next_obs", "rewards", "terminated", "truncated")],
        "stepped": s["stepped"].copy(), "dropped": list(s["dropped"])})
    try:
        assert t.host_env and t.pool.env_id == "pixel_pendulum_host"
        assert t.config.agent.pixel_shape == (48, 48, 2) and t.buffer.obs.dtype == np.uint8
        out = t.train()
        assert np.isfinite(out["critic_loss"]) and np.isfinite(out["eval_return_mean"])
        assert t._eval_pool.env_id == "pixel_pendulum_host"
    finally:
        t.close()
    a = t.config.agent
    ref = _per_actor_rows(log, 2, a.n_step, a.gamma, 1024, a.obs_dim, obs_dtype=np.uint8)
    assert len(t.buffer) == len(ref) >= 40
    np.testing.assert_array_equal(_rows(t.buffer), _rows(ref))


def test_an_actor_env_must_have_the_presets_dims(tmp_path):
    with pytest.raises(ValueError, match="actor_env 'pixel_pendulum_host' has"):
        Trainer(_cfg(tmp_path, env="pendulum"), device="cpu", actor_env="pixel_pendulum_host")


def test_ou_noise_resets_only_the_done_rows():
    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(8,), noise_kind="ou")
    acting = HostActing(cfg, 3, torch.device("cpu"), torch.Generator().manual_seed(0))
    actor = Actor(3, 1, (8,), generator=torch.Generator().manual_seed(0))
    for _ in range(4):
        acting.explore(actor, np.zeros((3, 3), np.float32), 1.0)
    x, eps = acting.noise.x.clone(), acting.noise.epsilon.clone()
    assert (x != 0).all()
    acting.reset_noise(np.array([True, False, True]))
    np.testing.assert_array_equal(acting.noise.x[[0, 2]].numpy(), 0.0)
    np.testing.assert_array_equal(acting.noise.x[1].numpy(), x[1].numpy())
    np.testing.assert_array_equal(acting.noise.epsilon.numpy(), eps.numpy())


def test_async_collect_on_a_torch_env_is_refused_with_the_jax_message(tmp_path):
    with pytest.raises(ValueError) as e:
        Trainer(_cfg(tmp_path, env="pendulum", async_collect=True), device="cpu")
    assert str(e.value) == (
        "async_collect needs the host actor pool (a gymnasium env id); "
        "pure-JAX envs collect on-device in the learner stream")


@pytest.mark.parametrize("kw", [dict(num_envs=1), dict(num_envs=2), dict(num_envs=2, async_collect=True)],
                         ids=["single_env", "pool", "pool_async"])
def test_her_on_a_host_goal_env_trains(kw, tmp_path):
    t = Trainer(_cfg(tmp_path, env=GOAL_ENV, her=True, her_k=2, n_step=1, warmup_steps=60,
                     eval_episodes=2, **kw), device="cpu")
    try:
        assert t.has_pool == (kw["num_envs"] > 1 or kw.get("async_collect", False))
        out = t.train()
        # relabeled copies: more rows than env steps
        assert len(t.buffer) > t.env_steps >= 60
        assert np.isfinite(out["critic_loss"]) and 0.0 <= out["success_rate"] <= 1.0
    finally:
        t.close()


def test_pool_trainer_matches_the_jax_trainer(tmp_path):
    from d4pg_tpu.runtime.trainer import Trainer as JTrainer

    common = dict(env=ENV, num_envs=2, batch_size=8, replay_capacity=512, warmup_steps=0,
                  eval_episodes=2, max_episode_steps=15, seed=3, pool_start_method="fork",
                  checkpoint_interval=10**6, prioritized=False)
    jt = JTrainer(JTrainConfig(**common, log_dir=str(tmp_path / "jax"),
                               agent=JD4PGConfig(hidden_sizes=(16, 16))))
    tt = Trainer(TrainConfig(**common, log_dir=str(tmp_path / "port"),
                             agent=D4PGConfig(hidden_sizes=(16, 16))), device="cpu")
    try:
        js = jt.state
        load_jax_params(tt.state, js.actor_params, js.critic_params, js.target_actor_params,
                        js.target_critic_params)
        jt._pool_collect_steps(40, noise_scale=0.0)
        tt._pool_collect_steps(40, noise_scale=0.0)
        assert tt.env_steps == jt.env_steps == 40
        n = len(jt.buffer)
        assert len(tt.buffer) == n >= 30
        for f in FIELDS:
            np.testing.assert_allclose(getattr(tt.buffer, f)[:n], getattr(jt.buffer, f)[:n],
                                       rtol=0, atol=1e-5, err_msg=f)
        # the greedy eval pool (seed + 977 777) from the same weights
        je, te = jt._pool_eval(), tt._pool_eval(tt.state.actor)
        np.testing.assert_allclose(te["eval_return_mean"], je["eval_return_mean"], rtol=1e-4)
        np.testing.assert_allclose(te["eval_return_std"], je["eval_return_std"], rtol=1e-4,
                                   atol=1e-3)
        # one train_step on the same indices, each side its own rows
        idx = np.random.default_rng(0).integers(0, n, 8)
        jbatch = {f: np.asarray(getattr(jt.buffer, f)[idx]) for f in FIELDS}
        tbatch = {f: torch.from_numpy(np.asarray(getattr(tt.buffer, f)[idx])) for f in FIELDS}
        _, jm, jpri = jt._train_step(jt.state, jbatch)
        _, tm, tpri = train_step(tt.config.agent, tt.state, tbatch)
        np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(tm["critic_loss"]), float(jm["critic_loss"]),
                                   rtol=1e-4, atol=1e-6)
    finally:
        jt.close()
        tt.close()
