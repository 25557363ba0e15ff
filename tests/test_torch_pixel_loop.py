"""The pixel path through the port's loops (ROADMAP A10 (c)) on the CPU:
the ``pixel_pendulum`` preset against the JAX one, the uint8 host replay
through the native gather in both obs modes against the JAX buffer, the
two host wires against each other, the uint8 ring of ``--on-device``,
the refusals the JAX package makes (device and hybrid placements with
pixels, the uint8 wire on a flat env), and short CLI runs of the host
placement on both wires and of ``--on-device``.

Everything compared here is exact: the same seeded draws, bytes and
float32 divisions on both sides (``array_equal`` / ``torch.equal``).
The CLI runs check rc 0, finite metrics rows and the buffer's dtype; they
run the full 48x48x2 frames at narrow MLPs and a 4096-row replay.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.config import apply_env_preset as j_apply_env_preset
from d4pg_tpu.replay.per import PrioritizedReplayBuffer as JPER
from d4pg_tpu.replay.source import validate_train_config
from d4pg_tpu_torch.agent import D4PGConfig
from d4pg_tpu_torch.config import (
    TrainConfig,
    apply_env_preset,
    check_placement,
    check_wire_dtypes,
)
from d4pg_tpu_torch.replay import PrioritizedReplayBuffer, Transition
from d4pg_tpu_torch.replay import native
from d4pg_tpu_torch.runtime import on_device as od
from d4pg_tpu_torch.runtime.trainer import Trainer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS = 48 * 48 * 2
SMALL = ["--device", "cpu", "--env", "pixel_pendulum", "--hidden-sizes", "16,16",
         "--num-envs", "2", "--bsize", "8", "--warmup", "64", "--rmsize", "4096",
         "--eval-episodes", "1", "--max-steps", "50"]


def _has_gxx() -> bool:
    try:
        native.load_library()
        return True
    except (OSError, RuntimeError):
        return False


needs_gxx = pytest.mark.skipif(not _has_gxx(), reason="the native tree needs g++")


# -------------------------------------------------------------- preset
@pytest.mark.parametrize("rmsize", [None, 5000], ids=["preset_cap", "explicit"])
def test_pixel_preset_matches_the_reference(rmsize):
    """obs_dim, pixel_shape, support, episode limit and the 100 000-row cap
    (an explicit --rmsize wins), as the JAX preset resolves them."""
    ours = apply_env_preset(TrainConfig(env="pixel_pendulum", replay_capacity=rmsize))
    ref = j_apply_env_preset(JTrainConfig(env="pixel_pendulum", replay_capacity=rmsize))
    assert ours.agent.pixel_shape == tuple(ref.agent.pixel_shape) == (48, 48, 2)
    assert ours.agent.obs_dim == ref.agent.obs_dim == OBS
    assert ours.replay_capacity == ref.replay_capacity == (rmsize or 100_000)
    assert ours.max_episode_steps == ref.max_episode_steps == 200
    assert (ours.agent.dist.v_min, ours.agent.dist.v_max) == (-300.0, 0.0)
    assert ours.agent.encoder_embed_dim == ref.agent.encoder_embed_dim == 50
    assert ours.agent.augment_pad == ref.agent.augment_pad == 4


@pytest.mark.parametrize("placement", ["device", "hybrid"])
def test_pixels_on_device_and_hybrid_placements_are_refused_as_the_reference(placement):
    cfg = apply_env_preset(TrainConfig(env="pixel_pendulum", replay_placement=placement))
    jcfg = j_apply_env_preset(JTrainConfig(env="pixel_pendulum", replay_placement=placement))
    with pytest.raises(ValueError, match="pixel") as jerr:
        validate_train_config(jcfg, is_jax_env=True)
    with pytest.raises(ValueError, match="device_ring_f32_only") as err:
        check_placement(cfg)
    # the JAX gap's message, after its code, then the ROADMAP item
    assert str(err.value).startswith(f"device_ring_f32_only: {jerr.value} (")
    assert "ROADMAP A10 (c)" in str(err.value)


def test_uint8_wire_on_a_flat_env_is_refused_as_the_reference():
    jcfg = j_apply_env_preset(JTrainConfig(env="pendulum", transfer_dtype="uint8"))
    with pytest.raises(ValueError, match="requires a pixel env") as jerr:
        validate_train_config(jcfg, is_jax_env=True)
    with pytest.raises(ValueError, match="uint8_wire_requires_pixel") as err:
        check_wire_dtypes(apply_env_preset(TrainConfig(env="pendulum", transfer_dtype="uint8")))
    assert str(err.value) == f"uint8_wire_requires_pixel: {jerr.value}"
    # and accepted on the pixel env
    check_wire_dtypes(apply_env_preset(TrainConfig(env="pixel_pendulum", transfer_dtype="uint8")))


# ------------------------------------------------------ native gather
def _filled(cls, rng, decode, backend, **kw):
    buf = cls(512, OBS, 1, obs_dtype=np.uint8, decode_on_sample=decode,
              tree_backend=backend, **kw)
    for _ in range(4):
        n = 96
        buf.add_batch(Transition(
            (rng.integers(0, 256, (n, OBS)) / 255.0).astype(np.float32),
            rng.uniform(-1, 1, (n, 1)).astype(np.float32), rng.normal(size=n).astype(np.float32),
            (rng.integers(0, 256, (n, OBS)) / 255.0).astype(np.float32),
            np.full(n, 0.97, np.float32)))
    buf.update_priorities(np.arange(0, 384, 3), rng.uniform(0.1, 3.0, 128))
    return buf


@needs_gxx
@pytest.mark.parametrize("decode", [True, False], ids=["u8_decode", "u8_raw"])
def test_sample_block_uint8_modes_match_numpy_and_the_reference(decode):
    """``sample_block`` on the native tree (OBS_U8_DECODE, or OBS_U8_RAW for
    the uint8 wire) equals the NumPy backend's and the JAX native
    buffer's, field for field, from the same adds and seed."""
    out = {}
    for name, cls, backend in (("native", PrioritizedReplayBuffer, "native"),
                               ("numpy", PrioritizedReplayBuffer, "numpy"),
                               ("jax", JPER, "native")):
        buf = _filled(cls, np.random.default_rng(0), decode, backend)
        if name == "native":
            mode = buf._native_obs_mode()
            assert mode == (native.OBS_U8_DECODE if decode else native.OBS_U8_RAW)
        out[name] = buf.sample_block(16, 4, np.random.default_rng(1), step=50)
    for name in ("numpy", "jax"):
        for k in ("obs", "next_obs", "action", "reward", "discount", "weights"):
            a, b = out["native"][k], out[name][k]
            assert a.dtype == b.dtype and a.shape == b.shape, (name, k)
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {k}")
        np.testing.assert_array_equal(out["native"]["indices"].idx, out[name]["indices"].idx)
    want = np.uint8 if not decode else np.float32
    assert out["native"]["obs"].dtype == want and out["native"]["obs"].shape == (4, 16, OBS)


# ------------------------------------------------------------- trainer
def _trainer(tmp_path, wire, **kw):
    cfg = TrainConfig(env="pixel_pendulum", num_envs=2, batch_size=8, warmup_steps=64,
                      replay_capacity=1024, max_episode_steps=50, eval_episodes=1,
                      tree_backend="numpy", transfer_dtype=wire, seed=3,
                      agent=D4PGConfig(hidden_sizes=(16, 16)), log_dir=str(tmp_path / wire), **kw)
    return Trainer(cfg, device="cpu")


def test_the_two_wires_carry_the_same_batch(tmp_path):
    """Same seed, same rows: the uint8 wire stages the stored bytes, and
    its decode on the device (/255, the dispatch's first op) equals the
    float32 wire's batch bit for bit; the buffer stores uint8 on both."""
    from d4pg_tpu_torch.agent.d4pg import decode_obs

    staged = {}
    for wire in ("float32", "uint8"):
        t = _trainer(tmp_path, wire)
        t.warmup()
        assert t.buffer.obs.dtype == np.uint8 and t.buffer.next_obs.dtype == np.uint8
        _, batch, _ = t._sample_staged(1)
        staged[wire] = batch
        t.close()
    f32, u8 = staged["float32"], staged["uint8"]
    assert u8["obs"].dtype == torch.uint8 and f32["obs"].dtype == torch.float32
    for k in ("obs", "next_obs"):
        assert torch.equal(decode_obs(u8[k]), f32[k])
    for k in ("action", "reward", "discount", "weights"):
        assert torch.equal(u8[k], f32[k])


@pytest.mark.parametrize("wire", ["float32", "uint8"])
def test_host_trainer_steps_on_both_wires(wire, tmp_path):
    t = _trainer(tmp_path, wire, total_steps=4, eval_interval=4, steps_per_dispatch=2)
    row = t.train()
    t.close()
    assert t.grad_steps == 4 and all(math.isfinite(row[k]) for k in
                                     ("critic_loss", "actor_loss", "q_mean", "eval_return_mean"))
    assert t.state.augment_gen is not None


# ----------------------------------------------------------- on-device
def test_on_device_ring_stores_uint8_and_decodes_at_the_gather(tmp_path):
    """The pixel ring is uint8 (whatever --ring-dtype says, as in the JAX
    package's ``run_on_device``); a row equals the env's frame encoded,
    and the gather gives it back /255 in float32."""
    from d4pg_tpu_torch.agent.d4pg import encode_obs, gather_batches

    cfg = TrainConfig(env="pixel_pendulum", num_envs=2, batch_size=8, warmup_steps=64,
                      replay_capacity=4096, max_episode_steps=50, eval_episodes=1,
                      total_steps=64, eval_interval=64, ring_dtype="bfloat16",
                      agent=D4PGConfig(hidden_sizes=(16, 16)), log_dir=str(tmp_path))
    run = od.OnDeviceRun(cfg, device="cpu")
    ring = run.carry.replay
    assert ring.obs.dtype == ring.next_obs.dtype == torch.uint8
    obs0 = run.carry.obs.clone()
    run.carry = run.warmup_fn(run.carry, 3.0)
    assert ring.size == 64
    # the first segment's first step of env 0 is the reset frame
    assert torch.equal(ring.obs[0], encode_obs(obs0[0]))
    got = gather_batches(ring, torch.tensor([[0, 5]]))
    assert got["obs"].dtype == torch.float32
    assert torch.equal(got["obs"][0, 1], ring.obs[5].float() / 255.0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        od.make_on_device_trainer(run.config.agent, run.env, num_envs=2, replay_capacity=4096,
                                  device="cpu", obs_uint8=True, obs_bf16=True)
    row = run.run()
    assert run.grad_steps == 64 and math.isfinite(row["critic_loss"])


# ----------------------------------------------------------------- CLI
def _run(args, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "d4pg_tpu_torch.train", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize(
    "extra,steps",
    [(["--steps-per-dispatch", "4"], 8),
     (["--steps-per-dispatch", "4", "--transfer-dtype", "uint8"], 8),
     (["--on-device"], 64)],
    ids=["host_f32_wire", "host_uint8_wire", "on_device"],
)
def test_cli_pixel_runs(extra, steps, tmp_path):
    out = _run(SMALL + ["--total-steps", str(steps), "--eval-interval", str(steps),
                        "--log-dir", str(tmp_path), *extra])
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [steps]
    assert all(math.isfinite(v) for v in rows[-1].values())
    if "--on-device" not in extra:  # the on-device loop keeps checkpoints_best/
        with np.load(tmp_path / "checkpoints" / "best_actor.npz") as z:
            # PixelEncoder_0's Conv_0 bias, then its HWIO kernel, lead the leaves
            assert z["leaf_0000"].shape == (32,) and z["leaf_0001"].shape == (3, 3, 2, 32)
    # the run's champion exports as a pixel bundle
    exp = _run(["--env", "pixel_pendulum", "--hidden-sizes", "16,16", "--log-dir",
                str(tmp_path), "--export-bundle", str(tmp_path / "bundle")])
    assert exp.returncode == 0, exp.stderr[-2000:]
    with open(tmp_path / "bundle" / "bundle.json") as f:
        assert json.load(f)["agent"]["pixel_shape"] == [48, 48, 2]

