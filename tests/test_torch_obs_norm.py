"""Observation normalization (``--obs-norm``) of the port against the JAX
package's, on the CPU.

- ``RunningObsNorm`` fed the same seeded batches: its float64 count, mean
  and M2 ``array_equal`` to the JAX one's (the same Chan/Welford merge in
  the same order), ``normalize`` and the state dicts equal, and either
  side loads the other's state;
- the trainers on ``Pendulum-v1`` with ``num_envs`` 2 and ``obs_norm``
  from ONE JAX state: after 20 pool steps at noise scale 0 the statistics
  count exactly the env steps (folded once per observed step, never per
  sampled batch) and agree within 1e-6 (the rows they fold agree within
  1e-5, ``tests/test_torch_actor_pool.py``; the mean of such rows within
  1e-6);
- sampled batches are normalized on the host with the same statistics,
  the raw rows stay in replay, and sampling folds nothing;
- ``obs_norm`` in the trainer meta, the resume checks both ways with the
  JAX messages, and ``best_obs_norm.json`` beside ``best_actor.npz``;
- the refusals, with the JAX messages: the device and hybrid placements
  (``obs_norm_host_sampling``), a torch env and a pixel env
  (``obs_norm_flat_envs_only``), and ``--on-device``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from d4pg_tpu.agent.state import D4PGConfig as JD4PGConfig
from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.ops.obs_norm import RunningObsNorm as JRunningObsNorm
from d4pg_tpu_torch.agent import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig, check_on_device
from d4pg_tpu_torch.ops.obs_norm import RunningObsNorm
from d4pg_tpu_torch.runtime.trainer import Trainer
from d4pg_tpu_torch.weights import load_jax_params

gym = pytest.importorskip("gymnasium")

ENV = "Pendulum-v1"


def test_running_stats_and_normalize_equal_the_references():
    rng = np.random.default_rng(0)
    ours, ref = RunningObsNorm(4), JRunningObsNorm(4)
    for n in (1, 7, 64, 3, 200):
        x = (rng.normal(size=(n, 4)) * [1.0, 10.0, 0.01, 100.0] + [0, 5, -1, 30]).astype(np.float32)
        ours.update(x)
        ref.update(x)
        assert ours.count == ref.count
        np.testing.assert_array_equal(ours.mean, ref.mean)
        np.testing.assert_array_equal(ours._m2, ref._m2)
        np.testing.assert_array_equal(ours.std, ref.std)
        probe = (rng.normal(size=(16, 4)) * 50).astype(np.float32)
        np.testing.assert_array_equal(ours.normalize(probe), ref.normalize(probe))
    ours.update(np.zeros((0, 4)))  # an empty batch folds nothing
    assert ours.state_dict() == ref.state_dict()
    for src, dst in ((ours, JRunningObsNorm(4)), (ref, RunningObsNorm(4))):
        dst.load_state_dict(json.loads(json.dumps(src.state_dict())))
        np.testing.assert_array_equal(dst.normalize(probe), ours.normalize(probe))


def _common(**kw):
    base = dict(env=ENV, num_envs=2, batch_size=8, replay_capacity=512, warmup_steps=0,
                eval_episodes=1, max_episode_steps=15, seed=3, pool_start_method="fork",
                checkpoint_interval=10**6, obs_norm=True)
    base.update(kw)
    return base


def test_trainer_statistics_fold_per_step_as_the_jax_trainers(tmp_path):
    from d4pg_tpu.runtime.trainer import Trainer as JTrainer

    jt = JTrainer(JTrainConfig(**_common(), log_dir=str(tmp_path / "jax"),
                               agent=JD4PGConfig(hidden_sizes=(16, 16))))
    tt = Trainer(TrainConfig(**_common(), log_dir=str(tmp_path / "port"),
                             agent=D4PGConfig(hidden_sizes=(16, 16))), device="cpu")
    try:
        js = jt.state
        load_jax_params(tt.state, js.actor_params, js.critic_params, js.target_actor_params,
                        js.target_critic_params)
        jt._pool_collect_steps(40, noise_scale=0.0)
        tt._pool_collect_steps(40, noise_scale=0.0)
        assert tt.obs_norm.count == tt.env_steps == jt.obs_norm.count == 40
        np.testing.assert_allclose(tt.obs_norm.mean, jt.obs_norm.mean, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt.obs_norm.std, jt.obs_norm.std, rtol=0, atol=1e-6)
        # sampling normalizes with those statistics and folds nothing
        _, batch, _ = tt._sample_staged(1)
        raw = tt.buffer.obs[: len(tt.buffer)]
        assert tt.obs_norm.count == 40
        stats_mean = tt.obs_norm.mean.copy()
        assert np.abs(batch["obs"].numpy()).max() <= 5.0
        assert not np.allclose(raw.mean(0), 0.0, atol=1e-3)  # replay keeps raw rows
        np.testing.assert_array_equal(tt.obs_norm.mean, stats_mean)
        rows = {tuple(np.round(tt.obs_norm.normalize(r), 5)) for r in raw}
        for r in batch["obs"].numpy():
            assert tuple(np.round(r, 5)) in rows
    finally:
        jt.close()
        tt.close()


def test_checkpoint_meta_resume_checks_and_best_stats(tmp_path):
    cfg = TrainConfig(**_common(total_steps=4, eval_interval=4, warmup_steps=16,
                                concurrent_eval=False),
                      log_dir=str(tmp_path), agent=D4PGConfig(hidden_sizes=(8,)))
    t = Trainer(cfg, device="cpu")
    try:
        t.train()
        state = t.obs_norm.state_dict()
        assert state["count"] == t.env_steps
    finally:
        t.close()
    with open(tmp_path / "checkpoints" / "trainer_meta.json") as f:
        assert json.load(f)["obs_norm"] == state
    best = tmp_path / "checkpoints" / "best_obs_norm.json"
    assert best.exists() and (tmp_path / "checkpoints" / "best_actor.npz").exists()
    resumed = Trainer(dataclasses.replace(cfg, resume=True), device="cpu")
    try:
        assert resumed.obs_norm.state_dict() == state
    finally:
        resumed.close()
    with pytest.raises(ValueError, match="checkpoint was trained WITH --obs-norm; resuming "
                                         "without it would feed the nets un-normalized inputs"):
        Trainer(dataclasses.replace(cfg, resume=True, obs_norm=False), device="cpu")
    plain = tmp_path / "plain"
    t = Trainer(dataclasses.replace(cfg, obs_norm=False, log_dir=str(plain)), device="cpu")
    try:
        t.train()
    finally:
        t.close()
    with pytest.raises(ValueError, match="--obs-norm resume: checkpoint has no saved "
                                         "normalizer statistics"):
        Trainer(dataclasses.replace(cfg, resume=True, log_dir=str(plain)), device="cpu")


@pytest.mark.parametrize(
    "kw,code",
    [(dict(replay_placement="device"), "obs_norm_host_sampling"),
     (dict(replay_placement="hybrid"), "obs_norm_host_sampling"),
     (dict(env="pendulum"), "obs_norm_flat_envs_only"),
     (dict(env="pixel_pendulum"), "obs_norm_flat_envs_only")],
    ids=["device", "hybrid", "torch_env", "pixel_env"],
)
def test_obs_norm_refusals_carry_the_jax_messages(kw, code, tmp_path):
    from d4pg_tpu.replay.source import validate_train_config

    cfg = TrainConfig(obs_norm=True, log_dir=str(tmp_path), env=kw.pop("env", ENV), **kw)
    with pytest.raises(ValueError) as ours:
        Trainer(cfg, device="cpu")
    jcfg = JTrainConfig(obs_norm=True, env=cfg.env, replay_placement=cfg.replay_placement)
    with pytest.raises(ValueError) as ref:
        validate_train_config(jcfg, is_jax_env=cfg.env in ("pendulum", "pixel_pendulum"))
    assert str(ours.value).startswith(code + ": ")
    assert str(ours.value)[len(code) + 2:] in str(ref.value)


def test_on_device_obs_norm_is_refused_with_the_jax_message():
    with pytest.raises(ValueError, match="on_device_obs_norm: --obs-norm is a host data-boundary "
                                         "feature; the on-device path keeps observations inside jit"):
        check_on_device(TrainConfig(env="pendulum", obs_norm=True))


def test_cli_with_obs_norm_on_a_host_env_writes_the_stats(tmp_path):
    from d4pg_tpu_torch.train import main

    out = main(["--device", "cpu", "--env", ENV, "--num-envs", "2", "--obs-norm",
                "--pool-start-method", "fork", "--hidden-sizes", "8", "--bsize", "8",
                "--warmup", "32", "--rmsize", "1024", "--total-steps", "4", "--eval-interval", "4",
                "--eval-episodes", "1", "--max-steps", "20", "--log-dir", str(tmp_path)])
    assert np.isfinite(out["critic_loss"])
    with open(tmp_path / "checkpoints" / "trainer_meta.json") as f:
        meta = json.load(f)
    assert meta["obs_norm"]["count"] == meta["env_steps"]
    assert os.path.exists(tmp_path / "checkpoints" / "best_obs_norm.json")
