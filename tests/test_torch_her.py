"""Hindsight relabeling of the port against the JAX package, on the CPU.

- the port's ``NStepWriter`` and ``HindsightWriter`` fed one fixed
  trajectory, with the same numpy seed on both sides, write rows
  byte-equal to the JAX writers' (k_future 4, n-step 1 and 3, terminated
  and truncated ends);
- the live-prefix cut of a rollout;
- ``Trainer(pointmass_goal, her=True)`` on the host and device
  placements: finite metrics rows and a replay size equal to what the
  writer accounting predicts (every live step written once as it was and
  ``her_k`` times relabeled);
- one HER episode at ``random_eps > 0`` replaces whole action vectors;
- ``--her`` with ``--on-device`` writes the same rows as without it (the
  JAX on-device loop never reads the flag);
- the host goal-env and actor-pool refusals naming ROADMAP A5 (d);
- the new paths (HER, both heads) raise with no card unless the CPU is
  asked for.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.replay.her import HindsightWriter as JHindsightWriter
from d4pg_tpu.replay.nstep_writer import NStepWriter as JNStepWriter
from d4pg_tpu.replay.source import validate_train_config
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplayBuffer
from d4pg_tpu_torch.agent import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer
from d4pg_tpu_torch.replay.her import HindsightWriter
from d4pg_tpu_torch.replay.nstep_writer import NStepWriter
from d4pg_tpu_torch.runtime.trainer import Trainer, live_prefix

T = 12
OBS, GOAL, ACT = 4, 2, 2
FIELDS = ("obs", "action", "reward", "next_obs", "discount")


def _trajectory(seed: int = 0):
    """T steps of a goal env: observations, achieved and desired goals, with
    achieved goals that revisit one another so relabels hit success."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T + 1, OBS)).astype(np.float32)
    ag = np.round(rng.uniform(-1, 1, size=(T + 1, GOAL)), 1).astype(np.float32)
    ag[7] = ag[4]
    dg = rng.uniform(-1, 1, size=GOAL).astype(np.float32)
    act = rng.uniform(-1, 1, size=(T, ACT)).astype(np.float32)
    rew = -np.ones(T, np.float32)
    return obs, ag, dg, act, rew


def _reward(ag, dg):
    return 0.0 if float(np.linalg.norm(ag - dg)) < 0.05 else -1.0


def _feed(writer_cls, nstep_cls, buffer, n, end, seed):
    obs, ag, dg, act, rew = _trajectory()
    terminated = end == "terminated"
    if writer_cls is None:  # the n-step writer alone, on flat observations
        w = nstep_cls(buffer, n, 0.99)
        for t in range(T):
            last = t == T - 1
            w.add(np.concatenate([obs[t], dg]), act[t], rew[t], np.concatenate([obs[t + 1], dg]),
                  terminated=terminated and last, truncated=last and not terminated)
        return T
    her = writer_cls(writer_factory=lambda: nstep_cls(buffer, n, 0.99), compute_reward=_reward,
                     k_future=4, rng=np.random.default_rng(seed))
    for t in range(T):
        her.add(obs[t], ag[t], dg, act[t], rew[t], obs[t + 1], ag[t + 1],
                terminated=terminated and t == T - 1)
    return her.end_episode(truncated=not terminated)


@pytest.mark.parametrize("end", ["terminated", "truncated"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("writer", ["nstep", "hindsight"])
def test_writers_write_the_references_rows_byte_for_byte(writer, n, end):
    jbuf = JReplayBuffer(256, OBS + GOAL, ACT)
    tbuf = ReplayBuffer(256, OBS + GOAL, ACT)
    her = writer == "hindsight"
    jn = _feed(JHindsightWriter if her else None, JNStepWriter, jbuf, n, end, seed=7)
    tn = _feed(HindsightWriter if her else None, NStepWriter, tbuf, n, end, seed=7)
    assert jn == tn == (T * 5 if her else T)
    # every raw step leaves the n-step window exactly once
    assert len(tbuf) == len(jbuf) == tn
    for f in FIELDS:
        a, b = getattr(tbuf, f)[: len(tbuf)], getattr(jbuf, f)[: len(jbuf)]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    if her:
        assert (tbuf.discount[: len(tbuf)] == 0.0).sum() > 1  # relabels that reached their goal


def test_one_row_adds_get_the_max_priority():
    buf = PrioritizedReplayBuffer(64, 3, 1)
    row = (np.zeros(3, np.float32), np.zeros(1, np.float32), -1.0, np.ones(3, np.float32), 0.99)
    first = buf.add(*row)
    buf.update_priorities(buf.sample(4, np.random.default_rng(0))["indices"],
                          np.full(4, 9.0, np.float32))
    second = buf.add(*row)
    assert first.tolist() == [0] and second.tolist() == [1] and buf.total_added == 2
    p = buf._sum.get(np.array([1]))
    assert np.isclose(p[0], buf._max_priority ** buf.alpha) and buf._max_priority > 1.0


@pytest.mark.parametrize(
    "term,trunc,want",
    [([0, 0, 1, 0, 0], [0, 0, 0, 0, 1], (3, True)),
     ([0, 0, 0, 0, 0], [0, 0, 0, 0, 1], (5, False)),
     ([0, 0, 0, 1, 1], [0, 1, 0, 0, 1], (2, False)),
     ([1, 0, 0, 0, 0], [0, 0, 0, 0, 0], (1, True)),
     ([0, 0, 0, 0, 0], [0, 0, 0, 0, 0], (5, False))],
    ids=["terminated", "truncated", "truncated_first", "first_step", "no_flag"],
)
def test_live_prefix_cuts_at_the_first_flag(term, trunc, want):
    assert live_prefix(np.array(term, np.float32), np.array(trunc, np.float32)) == want


def _her_cfg(tmp_path, **kw):
    return TrainConfig(env="pointmass_goal", her=True, n_step=1, num_envs=2, batch_size=8,
                       warmup_steps=100, total_steps=8, eval_interval=4, eval_episodes=2,
                       replay_capacity=4096, log_dir=str(tmp_path),
                       agent=D4PGConfig(hidden_sizes=(8,)), **kw)


@pytest.mark.parametrize(
    "placement", [dict(), dict(replay_placement="device", steps_per_dispatch=4,
                               fused_descent=True)],
    ids=["host", "device_fused_descent"],
)
def test_her_trainer_runs_and_writes_what_the_writer_accounting_predicts(placement, tmp_path):
    t = Trainer(_her_cfg(tmp_path, **placement), device="cpu")
    row = t.train()
    t.close()
    assert t.grad_steps == 8 and t.her_episodes >= 2
    assert all(np.isfinite(v) for v in row.values())
    assert 0.0 <= row["success_rate"] <= 1.0
    # each live step once as it was and her_k times relabeled (n-step 1)
    assert len(t.buffer) == t.env_steps * (1 + t.config.her_k)
    if placement:
        assert int(t._ring.size) == len(t.buffer)
    rows = t.buffer.obs[: len(t.buffer)]
    assert np.isfinite(rows).all() and rows.shape[1] == 6


def test_a_her_episode_at_random_eps_replaces_whole_action_vectors(tmp_path):
    cfg = _her_cfg(tmp_path)
    cfg = dataclasses.replace(cfg, agent=dataclasses.replace(cfg.agent, random_eps=0.5))
    t = Trainer(cfg, device="cpu")
    t.close()
    traj = t._her_rollout(scale=0.0)  # no Gaussian noise: kept actions are greedy
    flat = np.concatenate([traj["observation"], traj["desired_goal"]], axis=1)
    with torch.no_grad():
        greedy = t.state.actor(torch.from_numpy(flat)).numpy()
    same = np.isclose(traj["action"], greedy, rtol=0, atol=1e-6)
    assert (same.all(axis=1) | ~same.any(axis=1)).all()  # whole vectors, never one coordinate
    replaced = int((~same.all(axis=1)).sum())
    assert 5 < replaced < 45, replaced  # Binomial(50, 0.5)
    assert len(traj["action"]) == t.env.max_episode_steps


def test_her_on_device_writes_the_same_rows_as_without_it(tmp_path):
    """The JAX CLI validates --her --on-device with no gap and its on-device
    loop never reads ``config.her``: the port's ignores it too."""
    from d4pg_tpu_torch.runtime.on_device import OnDeviceRun

    assert validate_train_config(JTrainConfig(env="pointmass_goal", her=True),
                                 on_device=True, is_jax_env=True).ok
    rings = []
    for her in (False, True):
        cfg = TrainConfig(env="pointmass_goal", her=her, n_step=1, num_envs=2, batch_size=8,
                          warmup_steps=64, total_steps=64, eval_interval=64, eval_episodes=1,
                          replay_capacity=1024, log_dir=str(tmp_path / str(her)),
                          agent=D4PGConfig(hidden_sizes=(8,)))
        run = OnDeviceRun(cfg, device="cpu")
        run.run()
        rings.append(run.carry.replay)
    a, b = rings
    assert int(a.size) == int(b.size) > 0
    for f in ("obs", "action", "reward", "next_obs", "discount", "priority"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_host_goal_env_and_pool_refusals_name_a5d(tmp_path):
    t = Trainer(dataclasses.replace(_her_cfg(tmp_path), her=False), device="cpu")
    t.close()
    t.env = types.SimpleNamespace(is_goal_env=True, compute_reward=lambda ag, dg: -1.0)
    for num_envs, what in ((4, "actor pool's goal views"), (1, "host goal env")):
        t.config = dataclasses.replace(t.config, her=True, num_envs=num_envs)
        with pytest.raises(NotImplementedError, match=r"ROADMAP A5 \(d\)") as e:
            t._setup_her()
        assert what in str(e.value)
    with pytest.raises(ValueError, match="--her needs a goal env, got pendulum"):
        Trainer(dataclasses.replace(_her_cfg(tmp_path), env="pendulum"), device="cpu")


@pytest.mark.parametrize(
    "flags",
    [["--env", "pointmass_goal", "--her", "--n-step", "1"],
     ["--critic-head", "mixture_gaussian"], ["--critic-head", "scalar"],
     ["--on-device", "--critic-head", "mixture_gaussian"]],
    ids=["her", "mog", "scalar", "mog_on_device"],
)
def test_new_paths_raise_without_a_card_unless_asked_for_the_cpu(flags, tmp_path):
    from d4pg_tpu_torch.train import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(flags + ["--hidden-sizes", "8", "--log-dir", str(tmp_path)])
    assert not (tmp_path / "metrics.jsonl").exists()
