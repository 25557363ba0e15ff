"""The port's host K > 1 dispatch and ``hybrid`` placement against the JAX
package, on the CPU.

Both sides start from ONE JAX ``create_train_state`` (carried across with
``d4pg_tpu_torch.weights.load_jax_params``) and the same replay rows. The
JAX side runs its fused Pallas loss in interpret mode; the port runs its
kernels' plain versions. The JAX package draws the [K, B] blocks
(``sample_block_indices`` / ``sample_block`` of its NumPy-backend PER) and
the port trains on those same blocks.

Tolerances, with their reasons (``test_torch_megastep``'s):

- params and targets after 2 dispatches of K = 3 (hybrid) or one of K = 4
  (host): atol 10·lr and median lr/10, ``test_torch_agent``'s ten-step
  tolerances (a near-zero gradient coordinate may take the other sign and
  move its weight by 2·lr);
- metrics and the [K, B] priorities: rtol 1e-3 (the step's loss agrees to
  rtol 1e-4 per step, with sign-flip drift over up to 2·K steps);
- index streams and ring rows: exact.
"""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.agent.d4pg import fused_train_scan as j_fused_train_scan
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.replay.device_ring import DeviceRingSync as JRingSync
from d4pg_tpu.replay.device_ring import device_ring_init as j_ring_init
from d4pg_tpu.replay.per import PrioritizedReplayBuffer as JPER
from d4pg_tpu.replay.per import SampledIndices as JSampled
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu.runtime import megastep as jmega
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state
from d4pg_tpu_torch.agent.d4pg import fused_train_scan
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.replay import PrioritizedReplayBuffer, Transition
from d4pg_tpu_torch.replay.device_ring import DeviceRingSync, device_ring_init
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.runtime.trainer import Trainer
from d4pg_tpu_torch.train import build_parser, config_from_args
from d4pg_tpu_torch.weights import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP, B, SIZE, LR = 64, 4, 48, 1e-4
HIDDEN = (16, 16)
FIELDS = ("obs", "action", "reward", "next_obs", "discount")


def _rows(n, seed):
    r = np.random.default_rng(seed)
    return (
        r.normal(size=(n, 3)).astype(np.float32),
        r.uniform(-1, 1, (n, 1)).astype(np.float32),
        r.uniform(-1, 0, n).astype(np.float32),
        r.normal(size=(n, 3)).astype(np.float32),
        np.where(r.uniform(size=n) < 0.1, 0.0, 0.99**3).astype(np.float32),
    )


def _configs():
    common = dict(obs_dim=3, action_dim=1, hidden_sizes=HIDDEN, tau=0.05, n_step=3,
                  lr_actor=LR, lr_critic=LR)
    jcfg = JConfig(dist=JDist(num_atoms=11, v_min=-5.0, v_max=5.0),
                   projection_backend="pallas_fused", **common)
    tcfg = D4PGConfig(dist=DistConfig(num_atoms=11, v_min=-5.0, v_max=5.0),
                      projection_backend="fused", **common)
    return jcfg, tcfg


def _jax_per():
    """The JAX package's host PER (NumPy trees), filled and re-prioritised."""
    buf = JPER(CAP, 3, 1, tree_backend="numpy")
    buf.add_batch(JTransition(*_rows(SIZE, 5)))
    buf.update_priorities(np.arange(SIZE), np.random.default_rng(6).uniform(0.1, 3.0, SIZE))
    return buf


def _port_state(tcfg, jst):
    st = create_train_state(tcfg, device="cpu")
    load_jax_params(st, jax.device_get(jst.actor_params), jax.device_get(jst.critic_params))
    return st


def _assert_state_close(tst, jst):
    pairs = [
        (tst.actor, jst.actor_params), (tst.critic, jst.critic_params),
        (tst.target_actor, jst.target_actor_params),
        (tst.target_critic, jst.target_critic_params),
    ]
    for module, tree in pairs:
        layers = tree["params"]
        for name, prm in module.named_parameters():
            layer, kind = name.split(".")
            leaf = np.asarray(layers[layer]["kernel" if kind == "weight" else "bias"])
            diff = np.abs(prm.detach().numpy() - (leaf.T if kind == "weight" else leaf))
            assert diff.max() <= 10 * LR, (name, diff.max())
            assert np.median(diff) <= LR / 10, (name, np.median(diff))


def _assert_metrics_close(tm, jm):
    for k in ("critic_loss", "priority_mean", "q_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)


# ------------------------------------------------------------------ bodies
def test_hybrid_body_matches_the_reference():
    """Two hybrid dispatches of K = 3 on the JAX package's own [K, B]
    indices and IS weights, with its priorities written back between."""
    k, dispatches = 3, 2
    jcfg, tcfg = _configs()
    jbuf = _jax_per()
    jring = JRingSync(jbuf, chunk_cap=16).flush(j_ring_init(CAP, 3, 1))
    buf = PrioritizedReplayBuffer(CAP, 3, 1, tree_backend="numpy")
    buf.add_batch(Transition(*_rows(SIZE, 5)))
    ring = device_ring_init(CAP, 3, 1, "cpu")
    DeviceRingSync(buf, chunk_cap=16).flush(ring)
    np.testing.assert_array_equal(ring.obs.numpy(), np.asarray(jring.obs))
    jst = j_create(jcfg, jax.random.PRNGKey(1))
    tst = _port_state(tcfg, jst)
    mega = jmega.make_megastep_hybrid(jcfg)
    rng = np.random.default_rng(3)
    for d in range(dispatches):
        idx, w, gen = jbuf.sample_block_indices(B, k, rng, step=d * k)
        assert idx.shape == w.shape == (k, B)
        jst, jm, jpri = mega(jst, jring, jnp.asarray(idx.astype(np.int32)), jnp.asarray(w))
        tm, tpri = megastep.megastep_hybrid_body(
            tcfg, tst, ring, torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(w))
        assert tpri.shape == (k, B)
        np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri), rtol=1e-3)
        _assert_metrics_close(tm, jm)
        jbuf.update_priorities(JSampled(idx, gen), np.asarray(jpri))
    assert tst.step == int(jst.step) == k * dispatches
    _assert_state_close(tst, jst)


def test_host_k_block_through_fused_train_scan_matches_the_reference():
    """One host dispatch of K = 4: the JAX PER's ``sample_block`` [K, B]
    block through both packages' ``fused_train_scan``."""
    k = 4
    jcfg, tcfg = _configs()
    blk = _jax_per().sample_block(B, k, np.random.default_rng(9), step=0)
    batches = {key: np.array(blk[key]) for key in (*FIELDS, "weights")}
    jst = j_create(jcfg, jax.random.PRNGKey(1))
    tst = _port_state(tcfg, jst)
    jst, jm, jpri = jax.jit(lambda s, b: j_fused_train_scan(jcfg, s, b))(
        jst, {key: jnp.asarray(v) for key, v in batches.items()})
    _, tm, tpri = fused_train_scan(tcfg, tst, {key: torch.from_numpy(v) for key, v in batches.items()})
    assert tpri.shape == (k, B) and tm["critic_loss"].shape == (k,)
    np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri), rtol=1e-3)
    for key in ("critic_loss", "priority_mean", "q_mean"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), rtol=1e-3, err_msg=key)
    assert tst.step == int(jst.step) == k
    _assert_state_close(tst, jst)


# ----------------------------------------------------------------- trainer
def _trainer(tmp_path, placement, backend, **kw):
    cfg = TrainConfig(num_envs=2, batch_size=8, warmup_steps=64, total_steps=8,
                      eval_interval=8, eval_episodes=1, replay_capacity=512,
                      log_dir=str(tmp_path / placement), agent=D4PGConfig(hidden_sizes=(16, 16)),
                      replay_placement=placement, steps_per_dispatch=4,
                      tree_backend=backend, **kw)
    return Trainer(cfg, device="cpu")


def _spy_blocks(t, log):
    """Record the [K, B] index block of each draw the trainer makes."""
    name = "sample_block" if t.config.replay_placement == "host" else "sample_block_indices"
    fn = getattr(t.buffer, name)

    def spy(*a, **kw):
        out = fn(*a, **kw)
        log.append((out["indices"].idx if name == "sample_block" else out[0]).copy())
        return out

    setattr(t.buffer, name, spy)


def test_host_and_hybrid_trainers_draw_the_same_index_stream(tmp_path):
    """The reference's contract: flipping ``replay_placement`` between
    ``host`` and ``hybrid`` moves no seeded run's index sequence (here
    also across tree backends). The same draws then train the same state."""
    host = _trainer(tmp_path, "host", "native")
    hyb = _trainer(tmp_path, "hybrid", "numpy")
    assert (host.buffer.tree_backend, hyb.buffer.tree_backend) == ("native", "numpy")
    assert hyb._dev_per is None and hyb._ring_sync.tree_hook is None
    logs = ([], [])
    for t, log in zip((host, hyb), logs):
        _spy_blocks(t, log)
        t.warmup()
        for _ in range(2):
            t._dispatch_once()
    for a, b in zip(*logs):
        assert a.shape == (4, 8)
        np.testing.assert_array_equal(a, b)
    assert len(logs[0]) == len(logs[1]) == 2
    # hybrid: the ring mirrors the host buffer after the dispatch's flush
    n = len(hyb.buffer)
    assert int(hyb._ring.size) == n
    for key in FIELDS:
        np.testing.assert_array_equal(getattr(hyb._ring, key).numpy()[:n], getattr(hyb.buffer, key)[:n])
    # gathered from the ring or from the host rows, the steps are the same
    for a, b in zip(host.state.critic.parameters(), hyb.state.critic.parameters()):
        assert torch.equal(a, b)
    # the second dispatch wrote the first one's priorities back
    assert host.buffer._max_priority == hyb.buffer._max_priority > 1.0
    for t in (host, hyb):
        t.close()


def _cli(log_dir, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "d4pg_tpu_torch.train", *HYBRID_ARGS, "--log-dir", log_dir, *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


HYBRID_ARGS = [
    "--device", "cpu", "--replay-placement", "hybrid", "--p-replay",
    "--steps-per-dispatch", "4", "--tree-backend", "native", "--hidden-sizes", "16,16",
    "--num-envs", "2", "--bsize", "8", "--warmup", "64", "--rmsize", "4096",
    "--total-steps", "16", "--eval-interval", "8", "--eval-episodes", "1",
    "--checkpoint-interval", "8", "--snapshot-replay",
]


def test_cli_hybrid_checkpoint_then_resume(tmp_path):
    log_dir = str(tmp_path)
    first = _cli(log_dir)
    assert first.returncode == 0, first.stdout[-2000:] + first.stderr[-2000:]
    ckpt = tmp_path / "checkpoints"
    assert not (ckpt / "device_per.npz").exists()  # the host tree holds the priorities
    with np.load(ckpt / "replay.npz") as z:
        assert "tree_priorities" in z.files and int(z["size"]) == 64
        saved_obs = z["obs"].copy()
    second = _cli(log_dir, "--resume")
    assert second.returncode == 0, second.stdout[-2000:] + second.stderr[-2000:]
    assert "[checkpoint] resumed from step 16" in second.stdout
    assert "restored replay snapshot: 64 transitions" in second.stdout
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [8, 16, 24, 32]
    for r in rows:
        for k in ("critic_loss", "q_mean", "priority_mean", "stage_megastep_dispatch_s",
                  "stage_h2d_stage_s", "stage_priority_writeback_s"):
            assert math.isfinite(r[k]), (k, r[k])
    assert rows[-1]["replay_size"] == 64  # resumed with its replay, no warmup repaid
    # a resumed hybrid trainer mirrors the restored rows into the ring at
    # setup, before its first gather
    cfg = config_from_args(build_parser().parse_args(
        [a for a in HYBRID_ARGS if a not in ("--device", "cpu")] + ["--log-dir", log_dir, "--resume"]))
    t = Trainer(cfg, device="cpu")
    try:
        n = len(t.buffer)
        assert n == 64 and int(t._ring.size) == n and t._ring_sync.pending() == 0
        np.testing.assert_array_equal(t._ring.obs.numpy()[:n], saved_obs)
        for key in FIELDS:
            np.testing.assert_array_equal(getattr(t._ring, key).numpy()[:n], getattr(t.buffer, key)[:n])
    finally:
        t.close()


@pytest.mark.parametrize("tree_backend", ["native", "numpy"])
def test_cli_host_k4_runs_on_each_tree_backend(tree_backend, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "d4pg_tpu_torch.train", "--device", "cpu",
         "--steps-per-dispatch", "4", "--tree-backend", tree_backend,
         "--hidden-sizes", "16,16", "--num-envs", "2", "--bsize", "8", "--warmup", "64",
         "--rmsize", "4096", "--total-steps", "16", "--eval-interval", "8",
         "--eval-episodes", "1", "--log-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert f"tree_backend='{tree_backend}'" in out.stdout
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [8, 16]
    for r in rows:
        for k in ("critic_loss", "q_mean", "priority_mean", "stage_sample_s",
                  "stage_train_dispatch_s", "stage_priority_writeback_s"):
            assert math.isfinite(r[k]), (k, r[k])
        # one sample, one train dispatch per dispatch of 4 grad steps
        assert r["stage_train_dispatch_calls"] == r["step"] / 4
