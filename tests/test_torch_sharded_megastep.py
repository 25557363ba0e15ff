"""The port's sharded megasteps (``--dp`` on the device placement) against
the JAX package's single-device oracles, and against themselves across
process topologies, on the CPU.

The JAX side is ``make_megastep_uniform_oracle`` /
``make_megastep_device_per_oracle``: the per-shard body under
``vmap(axis_name="dp")`` over the striped ring lanes. Its lane draws
(``fold_in(split(key)[1], lane)``) are computed here with the JAX
package's own key splits and fed to the port through ``idx=`` /
``prefixes=``. Both sides start from one JAX ``create_train_state``.

Tolerances, with their reasons:

- ring lanes, index draws: exact (copies; the same descent on the same
  leaves);
- params and targets after 3 dispatches of K = 3 steps: atol 10·lr and
  median lr/10 (``test_torch_agent``'s ten-step tolerances: Adam's
  near-sign first updates);
- the subtrees: rtol 1e-3, the leaves written hold (|td| + ε)^α of each
  side's priorities (``test_torch_megastep``'s tree tolerance);
  ``max_priority`` rel 1e-3, the metrics rtol 1e-3.

Across topologies (2 gloo processes with one lane each against 1 process
with 2 lanes) everything is ``torch.equal``: the only cross-lane
arithmetic is the fixed-order mean and exact min/max.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.replay.device_ring import striped_lanes as j_striped_lanes
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplay
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu.runtime import megastep as jmega
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state
from d4pg_tpu_torch.parallel.mesh import make_mesh
from d4pg_tpu_torch.replay import ReplayBuffer, Transition
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_ring import (
    FIELDS,
    ShardedDeviceRingSync,
    lane_rings_init,
    striped_perm,
)
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.tools import dp_ranks
from d4pg_tpu_torch.weights import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP, K, B, SIZE, LR, D = 64, 3, 8, 48, 1e-4, 2
DISPATCHES = 3
RANKS_TIMEOUT_S = 120


def _configs():
    common = dict(obs_dim=3, action_dim=1, hidden_sizes=(16, 16), tau=0.05, n_step=3,
                  lr_actor=LR, lr_critic=LR)
    jcfg = JConfig(dist=JDist(num_atoms=11, v_min=-5.0, v_max=5.0),
                   projection_backend="pallas_fused", **common)
    tcfg = D4PGConfig(dist=DistConfig(num_atoms=11, v_min=-5.0, v_max=5.0),
                      projection_backend="fused", **common)
    return jcfg, tcfg


def _rows():
    r = np.random.default_rng(5)
    return (r.normal(size=(SIZE, 3)).astype(np.float32),
            r.uniform(-1, 1, (SIZE, 1)).astype(np.float32),
            r.uniform(-1, 0, SIZE).astype(np.float32),
            r.normal(size=(SIZE, 3)).astype(np.float32),
            np.where(r.uniform(size=SIZE) < 0.1, 0.0, 0.99**3).astype(np.float32))


def _sides(prioritized):
    """(JAX state, JAX ring lanes, JAX tree | None) and the port's
    (state, lane rings, DevicePerSync | None) on the same rows."""
    jcfg, tcfg = _configs()
    jbuf = JReplay(CAP, 3, 1)
    jbuf.add_batch(JTransition(*_rows()))
    jst = j_create(jcfg, jax.random.PRNGKey(1))
    jtree = None
    if prioritized:
        pa = np.zeros(CAP, np.float32)
        pa[:SIZE] = 1.0  # every ingested row seeded at max_priority**α = 1
        jtree = jdper.tree_from_priorities(pa, CAP, n_shards=D)
    mesh = make_mesh(D, device="cpu", num_processes=1, process_index=0)
    buf = ReplayBuffer(CAP, 3, 1)
    buf.add_batch(Transition(*_rows()))
    rings = lane_rings_init(CAP, 3, 1, mesh)
    sync = ShardedDeviceRingSync(buf, mesh, chunk_cap=16)
    per = None
    if prioritized:
        per = dper.DevicePerSync(CAP, tcfg.per_alpha, mesh=mesh)
        sync.tree_hook = per.on_lane_chunk
    sync.flush(rings)
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, jax.device_get(jst.actor_params), jax.device_get(jst.critic_params))
    return (jcfg, jst, j_striped_lanes(jbuf, D), jtree), (tcfg, tst, rings, per)


def _assert_state_close(tst, jst):
    for module, tree in ((tst.actor, jst.actor_params), (tst.critic, jst.critic_params),
                         (tst.target_actor, jst.target_actor_params),
                         (tst.target_critic, jst.target_critic_params)):
        layers = jax.device_get(tree)["params"]
        for name, prm in module.named_parameters():
            layer, kind = name.split(".")
            leaf = np.asarray(layers[layer]["kernel" if kind == "weight" else "bias"])
            diff = np.abs(prm.detach().numpy() - (leaf.T if kind == "weight" else leaf))
            assert diff.max() <= 10 * LR, (name, diff.max())
            assert np.median(diff) <= LR / 10, (name, np.median(diff))


def test_lanes_mirror_the_reference_lanes():
    (_, _, jlanes, jtree), (_, _, rings, per) = _sides(prioritized=True)
    for d, ring in enumerate(rings):
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(ring, k).numpy(), np.asarray(getattr(jlanes, k))[d])
        assert int(ring.size) == int(jlanes.size) == SIZE
        np.testing.assert_array_equal(per.trees[d].sums.numpy(), np.asarray(jtree.sums)[d])


def test_sharded_uniform_megastep_matches_the_reference_oracle():
    (jcfg, jst, jlanes, _), (tcfg, tst, rings, _) = _sides(prioritized=False)
    jrun = jmega.make_megastep_uniform_oracle(jcfg, K, B, D)
    run = megastep.make_megastep_uniform_oracle(tcfg, K, B, D, device="cpu")
    key = jax.random.PRNGKey(7)
    local_n = SIZE // D
    for _ in range(DISPATCHES):
        k_idx = jax.random.split(key)[1]
        idx = [torch.tensor(np.asarray(jax.random.randint(
            jax.random.fold_in(k_idx, d), (K, B // D), 0, local_n))) for d in range(D)]
        jst, key, jm = jrun(jst, jlanes, key)
        tm = run(tst, rings, None, None, idx=idx)
    assert tst.step == int(jst.step) == K * DISPATCHES
    assert run.sync.calls == 3 * K * DISPATCHES  # critic, actor, metrics a step
    _assert_state_close(tst, jst)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)


def test_sharded_device_per_megastep_matches_the_reference_oracle():
    (jcfg, jst, jlanes, jtree), (tcfg, tst, rings, per) = _sides(prioritized=True)
    jrun = jmega.make_megastep_device_per_oracle(jcfg, K, B, D, tree_backend="xla")
    run = megastep.make_megastep_device_per_oracle(tcfg, K, B, D, device="cpu")
    key = jax.random.PRNGKey(11)
    for _ in range(DISPATCHES):
        k_draw = jax.random.split(key)[1]
        prefixes, want_idx = [], []
        for d in range(D):
            lane_key = jax.random.fold_in(k_draw, d)
            sums = jtree.sums[d]
            prefixes.append(torch.tensor(jdper.host_prefixes(lane_key, K, B // D, float(sums[1]))))
            fill = (SIZE - d + D - 1) // D
            want_idx.append(np.asarray(jdper.lane_draw(sums, lane_key, K, B // D, fill)[0]))
        for d in range(D):
            fill = megastep._lane_fill(rings[d], d, D)
            idx, _, _ = dper.lane_draw(per.trees[d].sums, prefixes[d], fill)
            np.testing.assert_array_equal(idx.numpy(), want_idx[d])
        jst, jtree, key, jm = jrun(jst, jlanes, jtree, key)
        tm = run(tst, rings, per.trees, None, prefixes=prefixes)
        for d in range(D):
            np.testing.assert_allclose(per.trees[d].sums.numpy(), np.asarray(jtree.sums)[d],
                                       rtol=1e-3)
            assert float(per.trees[d].max_priority) == pytest.approx(
                float(jtree.max_priority), rel=1e-3)
    assert float(per.trees[0].max_priority) > 1.0
    assert torch.equal(per.trees[0].max_priority, per.trees[1].max_priority)
    _assert_state_close(tst, jst)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)


def _program_run(tcfg, tst, rings, trees):
    """The trainer's sharded ``megastep`` program over ``rings`` (and
    ``trees``), its body given the fed lane draws as inputs: ``run(draws)
    -> metrics``, the host step advanced outside, as the trainer does."""
    mesh = make_mesh(D, device="cpu", num_processes=1, process_index=0)
    prog = megastep.sharded_megastep_program(tcfg, K, B, mesh, tst, rings, trees,
                                             megastep.lane_generators(0, mesh))
    if trees is None:
        prog.program.body = lambda *idx: megastep.sharded_megastep_uniform_body(
            tcfg, K, B // D, mesh, prog.sync, tst, rings, None, idx=list(idx))
    else:
        prog.program.body = lambda beta, *pre: megastep.sharded_megastep_device_per_body(
            tcfg, K, B // D, mesh, prog.sync, tst, rings, trees, None, prefixes=list(pre),
            beta=beta)

    def run(draws):
        step = tst.step
        beta = () if trees is None else (dper.beta_tensor(step, tcfg.per_beta0,
                                                          tcfg.per_beta_steps, "cpu"),)
        out = prog(*beta, *draws)
        tst.step = step + K
        return out

    run.program = prog
    return run


def test_sharded_megastep_programs_match_the_reference_oracle():
    """Both tiers through the trainer's compiled ``megastep`` program, the
    JAX lane draws fed in: the oracles' tolerances above, the combines
    counted outside the body (3 a grad step) and one specialization."""
    (jcfg, jst, jlanes, _), (tcfg, tst, rings, _) = _sides(prioritized=False)
    jrun = jmega.make_megastep_uniform_oracle(jcfg, K, B, D)
    run = _program_run(tcfg, tst, rings, None)
    key = jax.random.PRNGKey(7)
    for _ in range(DISPATCHES):
        k_idx = jax.random.split(key)[1]
        idx = [torch.tensor(np.asarray(jax.random.randint(
            jax.random.fold_in(k_idx, d), (K, B // D), 0, SIZE // D))) for d in range(D)]
        jst, key, jm = jrun(jst, jlanes, key)
        tm = run(idx)
    assert tst.step == int(jst.step) == K * DISPATCHES
    assert run.program.sync.calls == 3 * K * DISPATCHES
    assert run.program._cache_size() == 1
    _assert_state_close(tst, jst)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)

    (jcfg, jst, jlanes, jtree), (tcfg, tst, rings, per) = _sides(prioritized=True)
    jrun = jmega.make_megastep_device_per_oracle(jcfg, K, B, D, tree_backend="xla")
    run = _program_run(tcfg, tst, rings, per.trees)
    key = jax.random.PRNGKey(11)
    for _ in range(DISPATCHES):
        k_draw = jax.random.split(key)[1]
        prefixes = [torch.tensor(jdper.host_prefixes(jax.random.fold_in(k_draw, d), K, B // D,
                                                     float(jtree.sums[d][1]))) for d in range(D)]
        jst, jtree, key, jm = jrun(jst, jlanes, jtree, key)
        tm = run(prefixes)
        for d in range(D):
            np.testing.assert_allclose(per.trees[d].sums.numpy(), np.asarray(jtree.sums)[d],
                                       rtol=1e-3)
            assert float(per.trees[d].max_priority) == pytest.approx(
                float(jtree.max_priority), rel=1e-3)
    _assert_state_close(tst, jst)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-3, err_msg=k)


def test_importance_weights_of_one_lane_are_the_single_device_formula():
    g = torch.Generator().manual_seed(0)
    p, total = torch.rand(3, 4, generator=g) + 0.1, torch.tensor(7.5)
    n, ratio = torch.tensor(40, dtype=torch.int32), torch.tensor(0.004)
    assert torch.equal(dper.importance_weights(p, total, ratio, n, 0.4),
                       dper.importance_weights(p, total, ratio, n, 0.4, n_shards=1))
    jw = jdper.importance_weights(p.numpy(), total.numpy(), ratio.numpy(), np.int32(40), 2,
                                  np.float32(0.4))
    np.testing.assert_allclose(dper.importance_weights(p, total, ratio, n, 0.4, n_shards=2),
                               np.asarray(jw), rtol=1e-6)


# ------------------------------------------------------- across topologies
RANK_KW = dict(capacity=CAP, rounds=[40, 20, 30], k=K, batch=16, seed=0)


def _rank_cfg():
    return _configs()[1]


def test_two_gloo_processes_equal_one_process_with_two_lanes():
    """Ingest and a dispatch, three times (the last round wraps the ring):
    the train state, each lane's ring rows and subtree and max_priority
    are torch.equal between the topologies."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' setting: the same CPU kernels
    try:
        one = dp_ranks.run_lanes(make_mesh(D, device="cpu", num_processes=1, process_index=0),
                                 _rank_cfg(), **RANK_KW)
    finally:
        torch.set_num_threads(threads)
    ranks = dp_ranks.spawn_ranks(2, D, "cpu", timeout_s=RANKS_TIMEOUT_S, agent_cfg=_rank_cfg(),
                                 **RANK_KW)
    assert [r["lanes"] for r in ranks] == [[0], [1]]
    assert dp_ranks.compare(one, ranks) == dict(
        state=True, step=True, rings=True, subtrees=True, max_priority=True)
    assert one["step"] == 3 * K and float(one["max_priority"][0]) > 1.0
    # the last round wrapped the 64-row ring: every lane full
    assert all(int(r["size"]) == CAP for r in one["rings"])


def _cli(args, log_dir):
    return [sys.executable, "-m", "d4pg_tpu_torch.train", *args, "--log-dir", str(log_dir)]


CLI_ARGS = ["--device", "cpu", "--replay-placement", "device", "--p-replay",
            "--steps-per-dispatch", "4", "--dp", "2", "--hidden-sizes", "16,16",
            "--num-envs", "2", "--bsize", "8", "--warmup", "64", "--rmsize", "4096",
            "--total-steps", "16", "--eval-interval", "8", "--eval-episodes", "1",
            "--checkpoint-interval", "8", "--snapshot-replay"]


def test_two_process_checkpoint_restores_in_one_process(tmp_path):
    """Two CLI processes (one lane each) write the checkpoint (process 0
    only; process 1's metrics under worker1/); one process with two lanes
    restores it to the same sidecar and replay snapshot bytes."""
    from d4pg_tpu_torch.runtime.trainer import Trainer
    from d4pg_tpu_torch.train import build_parser, config_from_args

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = dp_ranks.free_port()
    run = tmp_path / "run"
    procs = [subprocess.Popen(
        _cli(CLI_ARGS + ["--num-processes", "2", "--process-id", str(i),
                         "--coordinator", f"127.0.0.1:{port}"], run),
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=RANKS_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    assert "[distributed]" in outs[0] and "'backend': 'gloo'" in outs[0]
    steps = sorted(x for x in os.listdir(run / "checkpoints") if x.isdigit())
    assert steps == ["16", "8"]
    assert not any(x.isdigit() for x in os.listdir(run / "worker1" / "checkpoints"))
    rows = [json.loads(line) for line in open(run / "worker1" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [8, 16] and all(np.isfinite(r["critic_loss"]) for r in rows)

    with np.load(run / "checkpoints" / "device_per.npz") as z:
        pa, mp = z["priorities_alpha"], float(z["max_priority"])
    with np.load(run / "checkpoints" / "replay.npz") as z:
        snap = {k: z[k] for k in z.files}
    # both processes' rows, in global slot order: 64 + 64 warmup rows
    assert int(snap["size"]) == 128 and (pa[:128] > 0).all() and (pa[128:] == 0).all()
    cfg = config_from_args(build_parser().parse_args(CLI_ARGS + ["--log-dir", str(run),
                                                                 "--resume"]))
    t = Trainer(cfg, device="cpu")
    try:
        got_pa, got_mp = t._dev_per.snapshot_host()
        np.testing.assert_array_equal(got_pa, pa)
        assert got_mp == mp
        t.buffer.snapshot(str(tmp_path / "again.npz"))
        with np.load(tmp_path / "again.npz") as z:
            for k in snap:
                np.testing.assert_array_equal(z[k], snap[k], err_msg=k)
        perm = striped_perm(4096, D)
        for d, ring in enumerate(t._ring):
            np.testing.assert_array_equal(ring.obs.numpy()[:64], t.buffer.obs[perm[d]][:64])
        assert t.grad_steps == 16
    finally:
        t.close()
