"""The port's device ring, megastep bodies and device-placement trainer
against the JAX package, on the CPU.

Both sides start from ONE JAX ``create_train_state`` (carried across with
``d4pg_tpu_torch.weights.load_jax_params``), the same host rows mirrored
into each package's device ring, and the JAX package's own draws: the
uniform indices, or the PER prefixes, that its jitted megastep computes
from its key are fed to the port's bodies. The JAX side runs its fused
Pallas loss in interpret mode and the XLA descent; the port runs its
kernels' plain versions.

Tolerances, with their reasons:

- ring rows, the fill count, index draws: exact (copies and the same
  descent on the same tree);
- the tree after a dispatch: the leaves written hold (|td| + ε)^α of each
  side's priorities, which differ as the step's loss does (the
  ``test_torch_agent`` step tolerance, rtol 1e-4 after up to 2·K steps of
  sign-flip drift: rtol 1e-3 here); leaves not drawn keep their value;
- params and targets after 2 dispatches of K = 3 steps: atol 10·lr and
  median lr/10, ``test_torch_agent``'s ten-step tolerances.
"""

import dataclasses
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
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.replay.device_ring import DeviceRingSync as JRingSync
from d4pg_tpu.replay.device_ring import device_ring_init as j_ring_init
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplay
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu.runtime import megastep as jmega
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.replay import ReplayBuffer, Transition
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_ring import DeviceRingSync, device_ring_init
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.weights import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP, K, B, SIZE, LR = 64, 3, 4, 48, 1e-4
HIDDEN = (16, 16)
DISPATCHES = 2


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


def _port_side(tcfg, jparams, prioritized=True):
    buf = ReplayBuffer(CAP, 3, 1)
    buf.add_batch(Transition(*_rows(SIZE, 5)))
    ring = device_ring_init(CAP, 3, 1, "cpu")
    sync = DeviceRingSync(buf, chunk_cap=16)
    per = dper.DevicePerSync(CAP, tcfg.per_alpha, device="cpu") if prioritized else None
    if per is not None:
        sync.tree_hook = per.on_chunk
    sync.flush(ring)
    st = create_train_state(tcfg, device="cpu")
    load_jax_params(st, *jparams)
    return st, ring, per


def _j_setup(jcfg, prioritized=True):
    buf = JReplay(CAP, 3, 1)
    buf.add_batch(JTransition(*_rows(SIZE, 5)))
    ring = j_ring_init(CAP, 3, 1)
    sync = JRingSync(buf, chunk_cap=16)
    per = jdper.DevicePerSync(CAP, jcfg.per_alpha) if prioritized else None
    if per is not None:
        sync.tree_hook = per.on_chunk
    ring = sync.flush(ring)
    return j_create(jcfg, jax.random.PRNGKey(1)), ring, per


def _params(st):
    return (jax.device_get(st.actor_params), jax.device_get(st.critic_params))


@pytest.fixture(scope="module")
def j_per_run():
    """The JAX device-PER megastep (XLA descent) over DISPATCHES
    dispatches: the prefixes it drew, the tree after each, its final state."""
    jcfg, _ = _configs()
    st, ring, per = _j_setup(jcfg)
    init = _params(st)
    mega = jmega.make_megastep_device_per(jcfg, K, B, tree_backend="xla")
    key = jax.random.PRNGKey(7)
    tree = per.tree
    prefixes, trees, idx = [], [], []
    for _ in range(DISPATCHES):
        lane = tree.sums[0]
        k_lane = jax.random.fold_in(jax.random.split(key)[1], jnp.int32(0))
        prefixes.append(jdper.host_prefixes(k_lane, K, B, float(lane[1])))
        idx.append(np.asarray(jdper.lane_draw(lane, k_lane, K, B, ring.size)[0]))
        st, tree, key, metrics = mega(st, ring, tree, key)
        trees.append((np.asarray(tree.sums[0]), float(tree.max_priority)))
    return init, prefixes, idx, trees, st, {k: float(v) for k, v in metrics.items()}


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


# ------------------------------------------------------------------ ring
def test_ring_sync_mirrors_wraps_and_ships_no_pads():
    buf = ReplayBuffer(CAP, 3, 1)
    ring = device_ring_init(CAP, 3, 1, "cpu")
    sync = DeviceRingSync(buf, chunk_cap=16)
    seeded = []
    sync.tree_hook = lambda slots: seeded.append(slots.clone())

    def check():
        n = len(buf)
        assert int(ring.size) == n and sync.pending() == 0
        for k in ("obs", "action", "reward", "next_obs", "discount"):
            np.testing.assert_array_equal(getattr(ring, k).numpy()[:n], getattr(buf, k)[:n])
        # rows never written stay zero: a partial chunk lands nothing else
        assert float(ring.obs[n:].abs().sum()) == 0.0

    buf.add_batch(Transition(*_rows(21, 0)))  # one full chunk + a partial one
    assert sync.pending() == 21
    sync.flush(ring)
    check()
    assert [len(s) for s in seeded] == [16, 5] and sync.chunks_ingested == 2
    assert torch.cat(seeded).tolist() == list(range(21))
    sync.flush(ring)  # nothing pending: nothing shipped
    assert sync.chunks_ingested == 2
    buf.add_batch(Transition(*_rows(50, 1)))  # wraps the ring
    sync.flush(ring)
    check()
    assert torch.cat(seeded[2:]).tolist() == [(21 + i) % CAP for i in range(50)]
    buf.add_batch(Transition(*_rows(3 * CAP, 2)))  # more than the ring: one resync
    seeded.clear()
    sync.flush(ring)
    check()
    assert sorted(torch.cat(seeded).tolist()) == list(range(CAP))


def test_ring_sync_seeds_the_tree_like_the_reference():
    jcfg, tcfg = _configs()
    _, jring, jper = _j_setup(jcfg)
    _, ring, per = _port_side(tcfg, _params(j_create(jcfg, jax.random.PRNGKey(1))))
    np.testing.assert_array_equal(per.tree.sums.numpy(), np.asarray(jper.tree.sums[0]))
    np.testing.assert_array_equal(ring.obs.numpy(), np.asarray(jring.obs))
    assert int(ring.size) == int(jring.size) == SIZE


# ------------------------------------------------------------- megasteps
def test_uniform_megastep_matches_the_reference():
    jcfg, tcfg = _configs()
    jst, jring, _ = _j_setup(jcfg, prioritized=False)
    tst, ring, _ = _port_side(tcfg, _params(jst), prioritized=False)
    mega = jmega.make_megastep_uniform(jcfg, K, B)
    key = jax.random.PRNGKey(7)
    for _ in range(DISPATCHES):
        idx = np.asarray(jmega.draw_uniform_indices(jax.random.split(key)[1], K, B, jring.size))
        jst, key, jm = mega(jst, jring, key)
        tm = megastep.megastep_uniform_body(tcfg, K, B, tst, ring, None, idx=torch.tensor(idx))
    assert tst.step == int(jst.step) == K * DISPATCHES
    _assert_state_close(tst, jst)
    np.testing.assert_allclose(float(tm["critic_loss"]), float(jm["critic_loss"]), rtol=1e-3)
    # the port's own draw is uniform over the filled rows, on the device
    g = torch.Generator().manual_seed(0)
    draws = megastep.draw_uniform_indices(g, 50, 40, ring.size)
    assert draws.min() >= 0 and draws.max() == SIZE - 1 and len(draws.unique()) == SIZE


@pytest.mark.parametrize("tier", ["kernel", "fused"])
def test_device_per_megastep_matches_the_reference(tier, j_per_run):
    """Both port tiers against the JAX separate-kernels megastep: the fused
    tier draws the same indices (one B3 call, then B4 per step) and so
    must land on the same trajectory."""
    init, prefixes, j_idx, j_trees, jst, jm = j_per_run
    _, tcfg = _configs()
    tst, ring, per = _port_side(tcfg, init)
    body = {"kernel": megastep.megastep_device_per_body,
            "fused": megastep.megastep_device_per_fused_body}[tier]
    for pre, want_idx, (j_sums, j_mp) in zip(prefixes, j_idx, j_trees):
        idx, _, _ = dper.lane_draw(per.tree.sums, torch.tensor(pre), ring.size)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        before = per.tree.sums.clone()
        tm = body(tcfg, K, B, tst, ring, per.tree, None, prefixes=torch.tensor(pre))
        sums = per.tree.sums.numpy()
        half = CAP
        touched = np.zeros(2 * CAP, bool)
        touched[half + want_idx.reshape(-1)] = True
        # leaves not drawn this dispatch are not written
        np.testing.assert_array_equal(sums[half:][~touched[half:]], before.numpy()[half:][~touched[half:]])
        np.testing.assert_allclose(sums, j_sums, rtol=1e-3)
        assert float(per.tree.max_priority) == pytest.approx(j_mp, rel=1e-3)
    assert float(per.tree.max_priority) > 1.0
    _assert_state_close(tst, jst)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), jm[k], rtol=1e-3, err_msg=k)


def test_fused_descent_tier_equals_the_separate_tier():
    """The fused tier (one B3 call, then B4 per step) is torch.equal to the
    separate tier (one B3 call over the block, B1f per step) on the CPU:
    same draws, same losses, same gradients, same write-back."""
    jcfg, tcfg = _configs()
    init = _params(j_create(jcfg, jax.random.PRNGKey(1)))
    sides = [_port_side(tcfg, init) for _ in range(2)]
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    for _ in range(DISPATCHES):
        (s0, r0, p0), (s1, r1, p1) = sides
        m0 = megastep.megastep_device_per_body(tcfg, K, B, s0, r0, p0.tree, gens[0])
        m1 = megastep.megastep_device_per_fused_body(tcfg, K, B, s1, r1, p1.tree, gens[1])
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
    (s0, _, p0), (s1, _, p1) = sides
    assert torch.equal(p0.tree.sums, p1.tree.sums)
    assert torch.equal(p0.tree.max_priority, p1.tree.max_priority)
    for a, b in zip(s0.critic.parameters(), s1.critic.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(s0.target_actor.parameters(), s1.target_actor.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="projection_backend"):
        megastep.megastep_device_per_fused_body(
            dataclasses.replace(tcfg, projection_backend="projection"),
            K, B, s1, sides[1][1], p1.tree, gens[1],
        )


# --------------------------------------------------------------- trainer
def _trainer(tmp_path, **kw):
    from d4pg_tpu_torch.runtime.trainer import Trainer

    agent = D4PGConfig(hidden_sizes=(16, 16))
    cfg = TrainConfig(num_envs=2, batch_size=8, warmup_steps=64, total_steps=10,
                      eval_interval=8, eval_episodes=1, replay_capacity=512,
                      log_dir=str(tmp_path), agent=agent, replay_placement="device",
                      steps_per_dispatch=4, **kw)
    return Trainer(cfg, device="cpu")


@pytest.mark.parametrize("tier", ["fused", "kernel", "uniform"])
def test_device_placement_trainer_runs_whole_dispatches(tier, tmp_path):
    kw = {"fused": dict(fused_descent=True), "kernel": {}, "uniform": dict(prioritized=False)}[tier]
    t = _trainer(tmp_path, debug_guards=True, **kw)
    row = t.train()
    t.close()
    assert t.grad_steps == 12  # 10 rounded up to whole dispatches of 4
    stages = t.timers.scalars()
    assert stages["stage_megastep_dispatch_calls"] == 3
    assert stages["stage_ingest_chunk_calls"] == 3 and stages["stage_train_dispatch_calls"] == 0
    assert int(t._ring.size) == len(t.buffer) == t.env_steps
    for k in ("critic_loss", "q_mean", "priority_mean", "eval_return_mean"):
        assert math.isfinite(row[k]), (k, row[k])
    if tier == "uniform":
        assert t._dev_per is None
    else:
        assert float(t._dev_per.tree.max_priority) > 1.0
        half = t._dev_per.tree.sums.shape[0] // 2
        filled = t._dev_per.tree.sums[half:half + len(t.buffer)]
        assert bool((filled > 0).all()) and float(t._dev_per.tree.sums[half + len(t.buffer):].sum()) == 0


def test_cli_device_placement_fused_descent_smoke(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-m", "d4pg_tpu_torch.train", "--device", "cpu",
         "--replay-placement", "device", "--p-replay", "--steps-per-dispatch", "4",
         "--fused-descent", "--hidden-sizes", "16,16", "--num-envs", "2", "--bsize", "8",
         "--warmup", "64", "--rmsize", "4096", "--total-steps", "16",
         "--eval-interval", "8", "--eval-episodes", "1", "--log-dir", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [8, 16]
    for r in rows:
        for k in ("critic_loss", "q_mean", "priority_mean", "grad_steps_per_sec",
                  "stage_megastep_dispatch_s", "stage_ingest_chunk_s"):
            assert math.isfinite(r[k]), (k, r[k])


@pytest.mark.parametrize(
    "kw,err,match",
    [
        (dict(fused_descent=True, replay_placement="host"), ValueError, "replay_placement='device'"),
        (dict(fused_descent=True, prioritized=False), ValueError, "prioritized"),
        (dict(fused_descent=True, agent=D4PGConfig(projection_backend="projection")),
         ValueError, "projection_backend='fused'"),
        (dict(replay_placement="hybrid", prioritized=False), ValueError,
         "replay_placement=hybrid is the PER mode"),
        (dict(replay_placement="hybrid", fused_descent=True), ValueError,
         "replay_placement='device'"),
        (dict(replay_placement="nowhere"), ValueError, "replay_placement must be one of"),
        (dict(replay_placement="device", steps_per_dispatch=0), ValueError, ">= 1"),
    ],
)
def test_placement_options_are_checked_like_the_reference(kw, err, match):
    from d4pg_tpu_torch.config import check_placement

    if kw.get("fused_descent") and "replay_placement" not in kw:
        kw = dict(kw, replay_placement="device")
    with pytest.raises(err, match=match):
        check_placement(TrainConfig(**kw))
