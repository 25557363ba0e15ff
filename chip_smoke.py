#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``d4pg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports nothing of JAX or of ``d4pg_tpu``. Phases, each printing one
JSON line:

1. ``env``: torch/CUDA versions, the card (``nvidia-smi``), and the nvcc
   build of every ``d4pg_tpu_torch/csrc/*.cu`` (one process each, all at
   once) with its seconds.
2. ``kernel``: each hand-written kernel against its plain PyTorch version
   on the card, at B=256 and a ragged B=200 with A=51 atoms, on the
   Pendulum support [-300, 0] and on [-10, 10], with terminal rows and
   rows whose targets clip at v_min and v_max; kernels B1f, B1b and B2
   also at every geometry B in {1, 7, 200, 256} x A in {2, 51, 101, 1024}
   (rows that do not fill a block, atoms that do not fill a warp, several
   atoms a lane), B1b's dq and B2's m ``torch.equal`` across two calls;
   then, at the learner's shape (B=256, A=51, Pendulum), the kernel's
   device time (100 launches in a CUDA graph, CUDA events around its
   replays), its eager per-call time (median over 100 calls), the same two
   for the plain version, the kernel's bound, and ``floor_ms``: the device
   time of one one-launch PyTorch op (``zero_()`` of a one-element tensor)
   in the same harness, the part of a kernel's time that is launch. B2 is
   also timed alone at A = 1024 (its plain version's [B, A, A] weight is
   1 GiB there).
3. ``tree_kernel``: kernel B3 (the PER prefix descent) against its plain
   version (``cumsum`` + ``searchsorted``): exactly, at L = 64 to 2^21 + 5000
   (single-chunk trees at 64, 1000 and 1024; past 2^20 a lane of pass 1's
   offsets takes its chunk sums in several pieces) and n = 2048 and 256
   draws, on integer leaves (every summation order
   exact) with zero-mass runs, a zero tail and prefixes on the cumsum
   boundaries, B4's indices too at L = 2^20, and B3's stored chunk offsets
   ``torch.equal`` to the plain ones; idx and offsets bit-equal across two
   back-to-back calls and across replays of a CUDA graph of three calls
   (L = 1024 and 2^20); on the main path's real-valued
   leaves at L = 2^20 (n = 2048 and 256 stratified draws, as the megastep
   makes them) every index must be a valid answer under a float64 cumsum
   within the tolerance stated in ``csrc/per_tree.cuh``, the offsets within
   that tolerance of a float64 sum, and the draws that differ from the
   plain version are counted. Kernel B4 (loss + next descent) at
   B in {1, 7, 200, 256} x A in {51, 101}, both supports, terminal and
   clipping rows: its ce/ov ``torch.equal`` to B1f's and its indices to
   B3's. Then the same timings as phase 2 for both, plus, for B3, the
   library call (``torch.searchsorted(torch.cumsum(...))``).
4. ``step_parity``: one full-width ``train_step`` on the card (through the
   kernels) against the same step on the CPU (plain versions).
5. ``slice``: the learner end to end, ``Trainer`` on cuda at the full
   default width (3x256 MLPs, 51 atoms, B=256, 16 envs x 32-step
   segments, n-step 3, PER): warmup 1000 env steps, then grad steps and
   an eval, once with ``projection="fused"`` (the default: forward and
   backward kernels) and once with ``projection="projection"`` (the
   projection-only kernel). Launch counters are zeroed right before each
   run and read right after; every kernel of a run's path must have
   launched exactly once per grad step.
6. ``device_slice``: the device-resident learner (``replay_placement=
   "device"``, K = 8 grad steps per megastep dispatch) at the same width
   with a 1M-row device ring and 2^20-leaf device tree: PER with the
   fused descent (B3 once and B4 K times a dispatch), PER with separate
   kernels (B3 once, B1f K times) and uniform replay. Exact launch counts
   per run, finite metrics, ``max_priority`` off its 1.0 seed, and every
   dispatch after the first under ``torch.cuda.set_sync_debug_mode(
   "error")`` (``debug_guards``): a host synchronisation inside a
   steady-state dispatch fails the run. After each run, a few more
   dispatches give the wall and device time of a grad step and the
   device's idle share (``steady_state``; device time from a
   ``torch.profiler`` trace).
7. ``resume``: checkpoint and resume of the device learner at the same
   width (fused descent, K = 8, ``debug_guards``, ``snapshot_replay``):
   leg 1 trains 200 grad steps with ``checkpoint_interval=100`` (saves at
   104 and 200); a new ``Trainer(resume=True)`` on its log dir must hold
   every parameter, target, Adam moment and step, the ring rows, the
   ring size and the tree's sums and max priority ``torch.equal`` to leg
   1's live objects. One megastep dispatch of each trainer from the same
   generator state must then give bit-equal parameters and tree (checked
   first on two deep copies of leg 1's state: whether the card itself
   repeats the dispatch bit for bit; if it does not, the trainers are held
   at 1e-6). The resumed trainer trains 200 more grad steps with exact
   launch counts, skipping the warmup; a third trainer is preempted from a
   thread at grad step >= 16 and must leave a committed step whose
   manifest verifies. The line carries the save and restore seconds and
   the sizes of ``state.pt``, ``replay.npz`` and ``device_per.npz``, and
   under ``full_ring`` the same for a full 1M-row ring (seeded rows and
   priorities), whose restore must be ``torch.equal`` too.

Then the ``kernels`` line (all five kernels; each one's ``launches`` from
the run of its ``main_path``, with ``launches_by_path`` for every run;
B3's ``max_abs_err`` is the largest index distance to its plain version,
B4's the largest ce/ov error), the card's name and power limit as
``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; with no CUDA device, or alone in a
directory without the package, it exits 2 before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_OPS_PER_S = 67e12       # H100 SXM float32 peak outside the tensor cores

# Kernel vs plain version on the card: both sum the same float32 terms per
# output, in another order (the plain projection is a batched matmul), so
# results agree to a few float32 ulps of values up to ~10.
ATOL, RTOL = 2e-5, 1e-5

# B1f, B1b and B2 against their plain versions at these (B, A); B4 at the
# A of GEOMETRY_ATOMS_B4, L = 2^20.
GEOMETRY_BATCHES = (1, 7, 200, 256)
GEOMETRY_ATOMS = (2, 51, 101, 1024)
GEOMETRY_ATOMS_B4 = (51, 101)

GRAD_STEPS = 1000            # fused run
GRAD_STEPS_PROJECTION = 200  # projection-only run
DEVICE_STEPS = {"fused_descent": 1000, "separate": 200, "uniform": 200}
RESUME_STEPS = 200           # each leg of the resume phase
RESUME_INTERVAL = 100        # its checkpoint interval (saves at 104 and 200)
PREEMPT_AT = 16              # grad steps before the third trainer is preempted
K = 8                        # grad steps per megastep dispatch
TREE_L = 2**20               # device tree leaves at the 1M-row replay
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def launch_counters():
    """Every kernel wrapper's launch counter dict."""
    from d4pg_tpu_torch.ops import cuda_fused_step, cuda_projection, cuda_tree

    return (cuda_projection.LAUNCHES, cuda_tree.LAUNCHES, cuda_fused_step.LAUNCHES)


def reset_counts() -> None:
    for counter in launch_counters():
        for k in counter:
            counter[k] = 0


def read_counts() -> dict:
    return {k: v for counter in launch_counters() for k, v in counter.items()}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, n: int = 100, warmup: int = 10) -> float:
    """Median of ``n`` per-call CUDA-event times of ``fn`` run eagerly, in
    ms. At these sizes the card waits on the host's enqueue, so this is the
    cost of one call as the learner pays it, not the device's time."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, n: int = 100, replays: int = 11) -> float:
    """Device time of one ``fn`` call, in ms: ``n`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events; the median
    replay over ``n``. The graph takes the host out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def floor_ms() -> float:
    """Device time of one one-launch PyTorch op, ``zero_()`` of a
    one-element CUDA tensor, in the harness of :func:`device_ms`: the part
    of a small kernel's time that is launch, not work."""
    import torch

    one = torch.empty(1, device="cuda")
    return device_ms(one.zero_)


def make_inputs(B: int, A: int, support, gen, device):
    """Logits, target probabilities, rewards and discounts with terminal
    rows (d=0) and rows whose targets clip at v_min and at v_max."""
    import torch

    span = support.v_max - support.v_min
    q = 2.0 * torch.randn((B, A), generator=gen, device=device)
    p = torch.softmax(2.0 * torch.randn((B, A), generator=gen, device=device), dim=-1)
    r = support.v_min + span * torch.rand((B,), generator=gen, device=device) * 0.2
    d = torch.full((B,), 0.99**3, device=device)
    d[0::7] = 0.0                                # terminal rows
    r[1::7] = support.v_min - 0.5 * span         # clip at v_min
    r[2::7] = support.v_max + 0.5 * span         # clip at v_max
    r[3::7] = support.v_min + 0.3 * span         # terminal inside the support
    d[3::7] = 0.0
    g_ce = torch.rand((B,), generator=gen, device=device) + 0.5
    g_ov = torch.rand((B,), generator=gen, device=device) - 0.5
    return q, p, r.contiguous(), d.contiguous(), g_ce, g_ov


def kernel_phase(cp, make_support, floor: float):
    """Kernel vs plain on every case; timings at the learner's shape."""
    import torch

    device = torch.device("cuda")
    gen = torch.Generator(device).manual_seed(SEED)
    A = 51
    supports = {"pendulum": make_support(-300.0, 0.0, A), "sym10": make_support(-10.0, 10.0, A)}
    err = {"c51_project": 0.0, "c51_fused_loss_fwd": 0.0, "c51_fused_loss_bwd": 0.0}

    def compare(name, got, want, case):
        for g, w in zip(got, want):
            torch.cuda.synchronize()
            check(bool(torch.isfinite(g).all()), f"{name} {case}: non-finite output")
            e = float((g - w).abs().max())
            err[name] = max(err[name], e)
            check(
                torch.allclose(g, w, atol=ATOL, rtol=RTOL),
                f"{name} {case}: max |kernel - plain| = {e:.3e} over tolerance",
            )

    for B in (256, 200):
        for sname, support in supports.items():
            case = f"B={B} A={A} support={sname}"
            q, p, r, d, g_ce, g_ov = make_inputs(B, A, support, gen, device)
            m = cp.project(support, p, r, d)
            torch.cuda.synchronize()
            compare("c51_project", [m], [cp.project_plain(support, p, r, d)], case)
            ce, ov = cp.fused_loss_fwd(support, q, p, r, d)
            torch.cuda.synchronize()
            compare("c51_fused_loss_fwd", [ce, ov], list(cp.fused_loss_plain(support, q, p, r, d)), case)
            dq = cp.fused_loss_bwd(support, q, p, r, d, g_ce, g_ov)
            torch.cuda.synchronize()
            compare(
                "c51_fused_loss_bwd", [dq],
                [cp.fused_loss_bwd_plain(support, q, p, r, d, g_ce, g_ov)], case,
            )
            emit({"phase": "kernel", "case": case, "max_abs_err": dict(err), "ok": True})

    # The warp-per-row geometry of B1f, B1b and B2: a block of R rows that
    # B does not fill, atoms that do not fill a warp, 1 to 32 atoms a lane.
    # B1b's and B2's cases over tolerance are gathered and raised after the
    # sweep, so that every A's line prints; two calls must give the same dq
    # and the same m bit for bit (m is formed with no atomics).
    b1b_over, b2_over = [], []
    for A_g in GEOMETRY_ATOMS:
        b1b_err, over = 0.0, []
        b2_err, b2_cases = 0.0, []
        for sname, (lo, hi) in (("pendulum", (-300.0, 0.0)), ("sym10", (-10.0, 10.0))):
            support = make_support(lo, hi, A_g)
            for B in GEOMETRY_BATCHES:
                case = f"B1f geometry B={B} A={A_g} support={sname}"
                q, p, r, d, g_ce, g_ov = make_inputs(B, A_g, support, gen, device)
                ce, ov = cp.fused_loss_fwd(support, q, p, r, d)
                torch.cuda.synchronize()
                compare("c51_fused_loss_fwd", [ce, ov], list(cp.fused_loss_plain(support, q, p, r, d)), case)
                case = f"B1b geometry B={B} A={A_g} support={sname}"
                dq = cp.fused_loss_bwd(support, q, p, r, d, g_ce, g_ov)
                dq2 = cp.fused_loss_bwd(support, q, p, r, d, g_ce, g_ov)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(dq).all()), f"{case}: non-finite output")
                check(torch.equal(dq, dq2), f"{case}: two calls give different dq")
                want = cp.fused_loss_bwd_plain(support, q, p, r, d, g_ce, g_ov)
                e = float((dq - want).abs().max())
                b1b_err = max(b1b_err, e)
                if not torch.allclose(dq, want, atol=ATOL, rtol=RTOL):
                    over.append({"case": case, "max_abs_err": e})
                case = f"B2 geometry B={B} A={A_g} support={sname}"
                m = cp.project(support, p, r, d)
                m2 = cp.project(support, p, r, d)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(m).all()), f"{case}: non-finite output")
                check(torch.equal(m, m2), f"{case}: two calls give different m")
                want = cp.project_plain(support, p, r, d)
                e = float((m - want).abs().max())
                b2_err = max(b2_err, e)
                if not torch.allclose(m, want, atol=ATOL, rtol=RTOL):
                    b2_cases.append({"case": case, "max_abs_err": e})
        emit({"phase": "kernel", "case": f"B1f geometry A={A_g} B={list(GEOMETRY_BATCHES)}",
              "max_abs_err": err["c51_fused_loss_fwd"], "ok": True})
        err["c51_fused_loss_bwd"] = max(err["c51_fused_loss_bwd"], b1b_err)
        emit({"phase": "kernel", "case": f"B1b geometry A={A_g} B={list(GEOMETRY_BATCHES)}",
              "max_abs_err": b1b_err, "bit_equal_across_calls": True, "over_tolerance": over,
              "ok": not over})
        b1b_over += over
        err["c51_project"] = max(err["c51_project"], b2_err)
        emit({"phase": "kernel", "case": f"B2 geometry A={A_g} B={list(GEOMETRY_BATCHES)}",
              "max_abs_err": b2_err, "bit_equal_across_calls": True, "over_tolerance": b2_cases,
              "ok": not b2_cases})
        b2_over += b2_cases
    check(not b1b_over, f"c51_fused_loss_bwd: {len(b1b_over)} geometry cases over tolerance: {b1b_over}")
    check(not b2_over, f"c51_project: {len(b2_over)} geometry cases over tolerance: {b2_over}")

    # Timing at the learner's shape.
    B, support = 256, supports["pendulum"]
    q, p, r, d, g_ce, g_ov = make_inputs(B, A, support, gen, device)
    f4 = 4
    # Float ops the function needs per row, not those of the hat-sum the
    # kernels run (A² terms): Φ sends each source atom to at most two
    # destination atoms, ~8 ops to place it (z_j, r + d·z_j, clip, scale)
    # and ~8 to split it onto its neighbours.
    phi = 16 * A
    work = {
        # name: (bytes in + out, float ops, kernel fn, plain fn)
        "c51_project": (
            f4 * (B * A + 2 * B) + f4 * B * A, B * phi,
            lambda: cp.project(support, p, r, d),
            lambda: cp.project_plain(support, p, r, d),
        ),
        "c51_fused_loss_fwd": (
            f4 * (2 * B * A + 2 * B) + f4 * 2 * B, B * (phi + 10 * A),
            lambda: cp.fused_loss_fwd(support, q, p, r, d),
            lambda: cp.fused_loss_plain(support, q, p, r, d),
        ),
        "c51_fused_loss_bwd": (
            f4 * (2 * B * A + 4 * B) + f4 * B * A, B * (phi + 14 * A),
            lambda: cp.fused_loss_bwd(support, q, p, r, d, g_ce, g_ov),
            lambda: cp.fused_loss_bwd_plain(support, q, p, r, d, g_ce, g_ov),
        ),
    }
    timing = {}
    for name, (nbytes, ops, kfn, pfn) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        timing[name] = {
            "ms": device_ms(kfn),
            "plain_ms": device_ms(pfn),
            "call_ms": call_ms(kfn),
            "plain_call_ms": call_ms(pfn),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "floor_ms": floor,
            "bytes": nbytes,
            "ops": ops,
        }
        emit({"phase": "kernel_time", "name": name, "B": B, "A": A, **timing[name]})

    # B2 alone at the widest support, where the push's O(A) work a row
    # replaces the gather's O(A^2); its plain version's [B, A, A] weight is
    # 1 GiB there (and a graph of 100 calls would hold it 100 times).
    A_w = GEOMETRY_ATOMS[-1]
    support_w = make_support(-300.0, 0.0, A_w)
    _, p_w, r_w, d_w, _, _ = make_inputs(B, A_w, support_w, gen, device)
    nbytes, ops = f4 * (B * A_w + 2 * B) + f4 * B * A_w, B * 16 * A_w
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S

    def wide():
        return cp.project(support_w, p_w, r_w, d_w)

    wide_t = {
        "ms": device_ms(wide), "call_ms": call_ms(wide), "plain_ms": None,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "floor_ms": floor, "bytes": nbytes, "ops": ops,
    }
    emit({"phase": "kernel_time", "name": "c51_project", "B": B, "A": A_w, **wide_t})
    timing["c51_project"]["at_A1024"] = wide_t
    return err, timing


def step_parity(cfg_cls, create_train_state, train_step):
    """One full-width train step on the card (kernels) vs on the CPU
    (plain versions), from the same initial weights and batch."""
    import numpy as np
    import torch

    from d4pg_tpu_torch.models.critic import DistConfig

    agent = cfg_cls(dist=DistConfig(v_min=-300.0, v_max=0.0), n_step=3)
    rng = np.random.default_rng(SEED)
    B = 256
    batch = {
        "obs": rng.normal(size=(B, 3)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(B, 1)).astype(np.float32),
        "reward": rng.uniform(-16, 0, size=B).astype(np.float32),
        "next_obs": rng.normal(size=(B, 3)).astype(np.float32),
        "discount": np.where(rng.uniform(size=B) < 0.1, 0.0, 0.99**3).astype(np.float32),
        "weights": rng.uniform(0.2, 1.0, size=B).astype(np.float32),
    }
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(agent, SEED, dev)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, metrics, pri = train_step(agent, state, tb)
        out[dev] = ({k: float(v) for k, v in metrics.items()}, pri.cpu().numpy())
    (mc, pc), (mh, ph) = out["cuda"], out["cpu"]
    check(all(np.isfinite(v) for v in mc.values()), f"non-finite metrics {mc}")
    check(pc.shape == (B,), f"priorities shape {pc.shape}")
    # Loss and priorities come before any update: float32-tight. q_mean and
    # actor_loss come after one Adam step, where a near-zero gradient
    # coordinate may take the other sign on the other device and move its
    # weight by 2·lr: held to 1e-3 of the 300-wide support.
    pri_err = float(np.abs(pc - ph).max())
    check(np.allclose(pc, ph, rtol=1e-4, atol=1e-4), f"priorities differ by {pri_err:.3e}")
    check(abs(mc["critic_loss"] - mh["critic_loss"]) <= 1e-4 * abs(mh["critic_loss"]) + 1e-5,
          f"critic_loss {mc['critic_loss']} vs {mh['critic_loss']}")
    check(abs(mc["q_mean"] - mh["q_mean"]) <= 0.3, f"q_mean {mc['q_mean']} vs {mh['q_mean']}")
    emit({"phase": "step_parity", "cuda": mc, "cpu": mh, "priority_max_abs_err": pri_err, "ok": True})


def slice_run(Trainer, TrainConfig, projection: str, grad_steps: int, card: str, log_dir: str):
    import dataclasses

    import torch

    from d4pg_tpu_torch.agent.state import D4PGConfig

    cfg = TrainConfig(
        env="pendulum",
        total_steps=grad_steps,
        warmup_steps=1000,
        eval_interval=grad_steps,
        eval_episodes=10,
        log_dir=log_dir,
        seed=SEED,
        agent=dataclasses.replace(D4PGConfig(), projection_backend=projection),
    )
    trainer = Trainer(cfg, device="cuda")
    try:
        reset_counts()
        t0 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        trainer.close()
    a = trainer.config.agent
    for k in ("critic_loss", "q_mean", "actor_loss", "eval_return_mean"):
        check(k in row and row[k] == row[k] and abs(row[k]) != float("inf"), f"{k} not finite: {row.get(k)}")
    expect = (
        {"fused_fwd": grad_steps, "fused_bwd": grad_steps, "project": 0}
        if projection == "fused"
        else {"fused_fwd": 0, "fused_bwd": 0, "project": grad_steps}
    )
    expect.update(tree_count=0, fused_step=0)
    check(launches == expect, f"launch counts {launches}, expected {expect}")
    emit({
        "phase": "slice",
        "projection": projection,
        "card": card,
        "width": {"hidden": list(a.hidden_sizes), "atoms": a.dist.num_atoms,
                  "batch": trainer.config.batch_size, "num_envs": trainer.config.num_envs,
                  "n_step": a.n_step, "prioritized": trainer.config.prioritized},
        "grad_steps": grad_steps,
        "env_steps": trainer.env_steps,
        "wall_s_incl_warmup_and_eval": wall,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "env_steps_per_sec": row["env_steps_per_sec"],
        "critic_loss": row["critic_loss"],
        "q_mean": row["q_mean"],
        "eval_return_mean": row["eval_return_mean"],
        "launches": launches,
        "stages": trainer.timers.scalars(),
        "ok": True,
    })
    return launches


def valid_under_f64(leaves, prefixes, idx, chain: int):
    """Per draw: is ``idx`` a valid count for ``prefix`` under the float64
    cumsum of the same leaves, within chain·2^-24·total either side?"""
    import torch

    cs64 = torch.cumsum(leaves.double(), 0)
    tol = chain * 2.0**-24 * float(cs64[-1])
    i = idx.reshape(-1).long()
    pre = prefixes.reshape(-1).double()
    lo = torch.where(i > 0, cs64[(i - 1).clamp_min(0)], torch.zeros_like(pre))
    hi = cs64[i]
    return (lo - tol <= pre) & ((pre < hi + tol) | (i == leaves.numel() - 1))


def integer_leaves(L: int, gen, device):
    """Leaves in {0, 1, 2, 3} with a zero-mass run and a zero tail past a
    60 % fill, as past the ring's fill. Every partial sum is an integer
    below 3·0.6·L < 2^24 for L < 2^23, so every summation order is exact
    in float32."""
    import torch

    leaves = torch.randint(0, 4, (L,), generator=gen, device=device).float()
    leaves[L // 3: L // 3 + L // 10] = 0.0   # a zero-mass run
    leaves[int(0.6 * L):] = 0.0              # zero tail
    return leaves


def exact_prefixes(leaves, n: int, gen):
    """``n`` prefixes over ``leaves``: on cumsum boundaries, half a unit
    below them, uniform over the mass, and 0, the total and just below."""
    import torch

    cs = torch.cumsum(leaves, 0)
    total = cs[-1:]
    third = (n - 3) // 3
    pick = torch.randint(0, leaves.numel(), (third,), generator=gen, device=leaves.device)
    rest = n - 3 - 2 * third
    return torch.cat([
        cs[pick], cs[pick] - 0.5, torch.rand(rest, generator=gen, device=leaves.device) * total,
        torch.zeros(1, device=leaves.device), total, total - 0.25,
    ]).contiguous()


def leaves_needed(idx, chunk: int) -> int:
    """Leaves a count must read given the chunk offsets: in every chunk a draw
    lands in, those from the chunk's start to the furthest draw's index."""
    import torch

    i = idx.reshape(-1).long()
    c = i // chunk
    far = torch.zeros(int(c.max()) + 1, dtype=torch.long, device=i.device)
    far.scatter_reduce_(0, c, i % chunk + 1, reduce="amax")
    return int(far.sum())


def main_path_leaves(gen, device):
    """A 2^20-leaf tree's leaves as the megastep meets them: (|td| + eps)^0.6
    priorities over the first 600k rows, zero mass past the fill."""
    import torch

    leaves = torch.zeros(TREE_L, device=device)
    fill = 600_000
    td = torch.rand(fill, generator=gen, device=device) * 3.0 + 0.05
    leaves[:fill] = td.pow(0.6)
    return leaves


def b3_repeatable(cuda_tree, leaves, prefixes, case: str) -> None:
    """Two back-to-back B3 calls (no synchronisation between them), and two
    replays of a CUDA graph that holds three calls, all give bit-equal
    indices and offsets: pass 1's ticket counter resets itself."""
    import torch

    first = cuda_tree.find_prefix(leaves, prefixes)
    second = cuda_tree.find_prefix(leaves, prefixes)
    torch.cuda.synchronize()

    def same(got, what):
        check(torch.equal(got[0], first[0]) and torch.equal(got[1], first[1]),
              f"{case}: {what} differ from the first call's idx or offsets")

    same(second, "back-to-back calls")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [cuda_tree.find_prefix(leaves, prefixes) for _ in range(3)]
    for replay in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for out in outs:
            same(out, f"graph replay {replay}")
    emit({"phase": "tree_kernel", "case": f"{case} repeated", "bit_equal_back_to_back": True,
          "bit_equal_graph_replays": True, "ok": True})


def tree_kernel_phase(cp, cuda_tree, cfs, dper, make_support, floor: float):
    """Kernels B3 and B4 against their plain versions and each other;
    timings at the main path's shapes."""
    import torch

    device = torch.device("cuda")
    gen = torch.Generator(device).manual_seed(SEED + 10)
    chunk = cuda_tree.CHUNK
    err = {"per_tree_find_prefix": 0, "c51_fused_step": 0.0}
    mismatch = {}

    # (a) integer-valued leaves: every summation order is exact, so the
    # kernel must EQUAL the plain version, boundary prefixes included; at
    # L = 2^20 this checks the multi-chunk-per-lane offsets and the binary
    # search over 1024 chunks, at the megastep's n = K·B and B draws.
    A = 51
    supports = {"pendulum": make_support(-300.0, 0.0, A), "sym10": make_support(-10.0, 10.0, A)}
    # L = 64, 1000 and 1024 are single-chunk trees: pass 1 has one block,
    # which is its own last block. Past 2^20 leaves (1024 chunks) a lane of
    # pass 1's store_offsets holds more than one piece of chunk sums and
    # reloads them; at 2^21 + 5000 its pieces are also ragged and unaligned.
    # TREE_L comes last: B4 below runs on its leaves.
    for L in (64, 1000, 1024, 4096, 2 * TREE_L, 2 * TREE_L + 5000, TREE_L):
        leaves = integer_leaves(L, gen, device)
        for n in (K * 256, 256):
            pre = exact_prefixes(leaves, n, gen)
            idx, offsets = cuda_tree.find_prefix(leaves, pre)
            torch.cuda.synchronize()
            want = cuda_tree.find_prefix_plain(leaves, pre)
            check(offsets.shape == (-(-L // chunk),), f"B3 L={L}: offsets shape {tuple(offsets.shape)}")
            check(torch.equal(idx, want),
                  f"B3 L={L} n={n}: {int((idx != want).sum())} draws differ from plain")
            check(torch.equal(offsets, cuda_tree.chunk_offsets_plain(leaves)),
                  f"B3 L={L} n={n}: stored chunk offsets differ from plain")
            emit({"phase": "tree_kernel", "case": f"B3 L={L} n={n} integer leaves",
                  "chunks": offsets.numel(), "exact": True, "ok": True})
        if L == 1024:
            b3_repeatable(cuda_tree, leaves, pre, f"B3 L={L} n={n} integer leaves")
    # B4's count at L = 2^20, B = 256, on the same exact leaves.
    q, p, r, d, _, _ = make_inputs(256, A, supports["pendulum"], gen, device)
    _, _, idx = cfs.fused_step_fwd(supports["pendulum"], q, p, r, d, pre, leaves, offsets)
    torch.cuda.synchronize()
    check(torch.equal(idx, cuda_tree.find_prefix_plain(leaves, pre)),
          "B4 L=2^20 B=256 integer leaves: idx differs from plain")
    emit({"phase": "tree_kernel", "case": "B4 L=2^20 B=256 integer leaves", "exact": True, "ok": True})

    # (b) L = 2^20 at the megastep's draws: valid under float64, mismatches counted.
    leaves = main_path_leaves(gen, device)
    total = leaves.sum()
    chain = cuda_tree.chain_length(TREE_L)
    tol = chain * 2.0**-24 * float(leaves.double().sum())
    chunk64 = torch.nn.functional.pad(leaves.double(), (0, -TREE_L % chunk)).reshape(-1, chunk).sum(1)
    exact_offsets = torch.cumsum(chunk64, 0) - chunk64
    main_pre = {}
    for k_, b_ in ((K, 256), (1, 256)):
        u = torch.rand((k_, b_), generator=gen, device=device)
        pre = dper.stratified_prefixes(u, k_, b_, total)
        main_pre[k_ * b_] = pre
        idx, offsets = cuda_tree.find_prefix(leaves, pre)
        torch.cuda.synchronize()
        off_err = float((offsets.double() - exact_offsets).abs().max())
        check(off_err <= tol, f"B3 L=2^20: stored offsets off a float64 sum by {off_err:.3e} > {tol:.3e}")
        plain = cuda_tree.find_prefix_plain(leaves, pre)
        ok = valid_under_f64(leaves, pre, idx, chain)
        check(bool(ok.all()), f"B3 L=2^20 n={pre.numel()}: {int((~ok).sum())} invalid draws")
        n_diff = int((idx != plain).sum())
        mismatch[f"B3 n={pre.numel()}"] = n_diff
        err["per_tree_find_prefix"] = max(err["per_tree_find_prefix"],
                                          int((idx.long() - plain.long()).abs().max()))
        if k_ == K:
            b3_repeatable(cuda_tree, leaves, pre, f"B3 L=2^20 n={pre.numel()}")
        emit({"phase": "tree_kernel", "case": f"B3 L=2^20 n={pre.numel()}", "chain": chain,
              "tolerance_of_total": chain * 2.0**-24, "offsets_max_abs_err_vs_f64": off_err,
              "draws_differing_from_plain": n_diff,
              "max_index_distance": err["per_tree_find_prefix"], "ok": True})

    # (c) B4 = B1f (ce, ov) + B3 (idx), bit for bit; and against the plain
    # version, at every geometry of GEOMETRY_BATCHES x GEOMETRY_ATOMS_B4.
    cases = [(B, A_g, sname, make_support(lo, hi, A_g))
             for A_g in GEOMETRY_ATOMS_B4 for B in GEOMETRY_BATCHES
             for sname, (lo, hi) in (("pendulum", (-300.0, 0.0)), ("sym10", (-10.0, 10.0)))]
    for B, A_g, sname, support in cases:
        q, p, r, d, _, _ = make_inputs(B, A_g, support, gen, device)
        pre = dper.stratified_prefixes(
            torch.rand((1, B), generator=gen, device=device), 1, B, total).reshape(B)
        idx3, offsets = cuda_tree.find_prefix(leaves, pre)
        ce, ov, idx = cfs.fused_step_fwd(support, q, p, r, d, pre, leaves, offsets)
        ce1, ov1 = cp.fused_loss_fwd(support, q, p, r, d)
        torch.cuda.synchronize()
        case = f"B4 B={B} A={A_g} support={sname}"
        check(torch.equal(ce, ce1) and torch.equal(ov, ov1), f"{case}: ce/ov differ from B1f")
        check(torch.equal(idx, idx3), f"{case}: idx differs from B3")
        pce, pov, pidx = cfs.fused_step_plain(support, q, p, r, d, pre, leaves)
        for g, w in ((ce, pce), (ov, pov)):
            check(torch.allclose(g, w, atol=ATOL, rtol=RTOL), f"{case}: loss off the plain version")
            err["c51_fused_step"] = max(err["c51_fused_step"], float((g - w).abs().max()))
        check(bool(valid_under_f64(leaves, pre, idx, chain).all()), f"{case}: invalid draws")
        mismatch[case] = int((idx != pidx).sum())
        emit({"phase": "tree_kernel", "case": case, "equal_to_b1f_and_b3": True,
              "draws_differing_from_plain": mismatch[case],
              "max_abs_err": err["c51_fused_step"], "ok": True})

    # (d) timings at the main path's shapes.
    f4 = 4
    B, support = 256, supports["pendulum"]
    q, p, r, d, _, _ = make_inputs(B, A, support, gen, device)
    pre_b = main_pre[256].reshape(B)
    idx_b, offsets_b = cuda_tree.find_prefix(leaves, pre_b)
    nchunks = offsets_b.numel()
    phi = 16 * A

    def walk_ops(idx):
        # per draw: ~10 compares to find its chunk, then a scan add and a
        # compare per leaf from the chunk's start to the index
        i = idx.reshape(-1).long()
        return int((2 * (i % chunk + 1) + 10).sum())

    timing = {}
    for n, pre in sorted(main_pre.items()):
        name = f"per_tree_find_prefix n={n}"
        idx_n, _ = cuda_tree.find_prefix(leaves, pre)
        # leaves once (the offsets need them all), prefixes in, indices and
        # chunk offsets out
        nbytes = f4 * TREE_L + f4 * n + f4 * n + f4 * nchunks
        ops = TREE_L + walk_ops(idx_n)
        timing[name] = {
            "fn": lambda pre=pre: cuda_tree.find_prefix(leaves, pre),
            "plain": lambda pre=pre: cuda_tree.find_prefix_plain(leaves, pre),
            "library": lambda pre=pre: torch.searchsorted(
                torch.cumsum(leaves, 0), pre.reshape(-1), right=True).clamp_max(TREE_L - 1),
            "bytes": nbytes, "ops": ops,
        }
    needed = leaves_needed(idx_b, chunk)
    timing["c51_fused_step"] = {
        "fn": lambda: cfs.fused_step_fwd(support, q, p, r, d, pre_b, leaves, offsets_b),
        "plain": lambda: cfs.fused_step_plain(support, q, p, r, d, pre_b, leaves),
        "library": None,
        # B1f's bytes, the prefixes, the chunk offsets once, the leaves this
        # run's draws need (leaves_needed), the indices out
        "bytes": f4 * (2 * B * A + 2 * B) + f4 * 2 * B + f4 * B + f4 * nchunks
        + f4 * needed + f4 * B,
        "ops": B * (phi + 10 * A) + walk_ops(idx_b),
        "leaves_needed": needed,
    }
    out = {}
    for name, t in timing.items():
        t_bytes, t_ops = t["bytes"] / HBM_BYTES_PER_S, t["ops"] / F32_OPS_PER_S
        out[name] = {
            "ms": device_ms(t["fn"]),
            "plain_ms": device_ms(t["plain"]),
            "library_ms": device_ms(t["library"]) if t["library"] else None,
            "call_ms": call_ms(t["fn"]),
            "plain_call_ms": call_ms(t["plain"]),
            "library_call_ms": call_ms(t["library"]) if t["library"] else None,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "floor_ms": floor,
            "bytes": t["bytes"], "ops": t["ops"],
        }
        if "leaves_needed" in t:
            out[name]["leaves_needed"] = t["leaves_needed"]
        emit({"phase": "kernel_time", "name": name, "L": TREE_L, **out[name]})
    return err, mismatch, out


def check_sync_guard() -> None:
    """The guard the device slice relies on must bite on this torch: a
    .item() under set_sync_debug_mode("error") raises."""
    import torch

    from d4pg_tpu_torch.runtime.trainer import _sync_debug_error

    x = torch.ones(2, device="cuda")
    try:
        with _sync_debug_error():
            x.sum().item()
    except RuntimeError:
        return
    raise RuntimeError("chip_smoke: set_sync_debug_mode('error') did not raise on .item()")


def device_busy(trainer, dispatches: int = 4) -> dict:
    """Where a steady-state dispatch's time goes: the wall time a grad step
    takes (host clock over ``dispatches`` megasteps ending in a
    synchronize, no profiler attached), the device time a grad step takes
    (the CUDA kernel and copy events of a ``torch.profiler`` trace of as
    many more dispatches; one stream, so they do not overlap), and the
    device's idle share, 1 - device / wall. None where the trace holds no
    device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(dispatches):
        trainer._megastep_dispatch_once()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (dispatches * K)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(dispatches):
            trainer._megastep_dispatch_once()
        torch.cuda.synchronize()
    device_us = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    device_ms = device_us / 1e3 / (dispatches * K) if device_us else None
    return {
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
    }


def device_slice_run(Trainer, TrainConfig, tier: str, card: str, log_dir: str):
    """The device-resident learner at full width, one tier; exact launch
    counts for N grad steps in N/K dispatches."""
    import torch

    n = DEVICE_STEPS[tier]
    kw = {
        "fused_descent": dict(prioritized=True, fused_descent=True),
        "separate": dict(prioritized=True),
        "uniform": dict(prioritized=False),
    }[tier]
    cfg = TrainConfig(
        env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n, eval_episodes=10,
        log_dir=log_dir, seed=SEED, replay_placement="device", steps_per_dispatch=K,
        debug_guards=True, **kw,
    )
    trainer = Trainer(cfg, device="cuda")
    try:
        reset_counts()
        t0 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        stages = trainer.timers.scalars()
        dispatched = trainer._dispatches
        busy = device_busy(trainer)  # after the counts: these dispatches are extra
    finally:
        trainer.close()
    for k in ("critic_loss", "q_mean", "actor_loss", "priority_mean", "eval_return_mean"):
        check(k in row and row[k] == row[k] and abs(row[k]) != float("inf"), f"{tier}: {k} not finite: {row.get(k)}")
    dispatches = n // K
    expect = {
        "fused_descent": dict(fused_fwd=0, fused_bwd=n, project=0, tree_count=dispatches, fused_step=n),
        "separate": dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=dispatches, fused_step=0),
        "uniform": dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0),
    }[tier]
    check(launches == expect, f"{tier}: launch counts {launches}, expected {expect}")
    check(dispatched == dispatches and trainer.grad_steps == n,
          f"{tier}: {dispatched} dispatches for {trainer.grad_steps} grad steps")
    max_priority = None
    if trainer._dev_per is not None:
        max_priority = float(trainer._dev_per.tree.max_priority)
        check(max_priority > 1.0, f"{tier}: max_priority {max_priority} did not move off 1.0")
    a = trainer.config.agent
    emit({
        "phase": "device_slice",
        "tier": tier,
        "card": card,
        "width": {"hidden": list(a.hidden_sizes), "atoms": a.dist.num_atoms,
                  "batch": trainer.config.batch_size, "num_envs": trainer.config.num_envs,
                  "n_step": a.n_step, "prioritized": trainer.config.prioritized,
                  "replay_capacity": trainer.config.replay_capacity,
                  "tree_leaves": TREE_L if trainer._dev_per is not None else None,
                  "steps_per_dispatch": K},
        "grad_steps": n,
        "dispatches": dispatches,
        "sync_guard": "set_sync_debug_mode('error') on every dispatch after the first",
        "env_steps": trainer.env_steps,
        "wall_s_incl_warmup_and_eval": wall,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "env_steps_per_sec": row["env_steps_per_sec"],
        "critic_loss": row["critic_loss"],
        "q_mean": row["q_mean"],
        "priority_mean": row["priority_mean"],
        "eval_return_mean": row["eval_return_mean"],
        "max_priority": max_priority,
        "launches": launches,
        "stages": stages,
        "steady_state": busy,
        "ok": True,
    })
    return launches


def state_tensors(state):
    """(name, tensor) for every tensor a checkpoint holds: the four
    networks and both optimizers' per-parameter state."""
    from d4pg_tpu_torch.runtime.checkpoint import NETWORKS, OPTIMIZERS

    for name in NETWORKS:
        for k, v in getattr(state, name).state_dict().items():
            yield f"{name}.{k}", v
    for name in OPTIMIZERS:
        opt = getattr(state, name)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in sorted(opt.state[p].items()):
                yield f"{name}.{i}.{k}", v


def learner_of(trainer):
    """The tensors one megastep dispatch reads and writes: (state, ring,
    tree), the megastep's own arguments."""
    return trainer.state, trainer._ring, trainer._dev_per.tree


def learner_tensors(state, ring, tree):
    """``state_tensors`` plus the ring rows over [0, size), the ring size
    and the tree."""
    yield from state_tensors(state)
    n = int(ring.size)
    for k in ("obs", "action", "reward", "next_obs", "discount"):
        yield f"ring.{k}", getattr(ring, k)[:n]
    yield "ring.size", ring.size
    yield "tree.sums", tree.sums
    yield "tree.max_priority", tree.max_priority


def compare_learners(a, b) -> dict:
    """Every tensor of learner ``a`` against ``b`` (each a
    :func:`learner_of` tuple): the names that differ (or sit on
    another device), the largest absolute difference and the tensor that
    holds it, and how many tensors were compared."""
    import torch

    ta, tb = dict(learner_tensors(*a)), dict(learner_tensors(*b))
    check(ta.keys() == tb.keys(), f"tensor sets differ: {sorted(ta.keys() ^ tb.keys())}")
    differ, worst, worst_name = [], 0.0, None
    for k, x in ta.items():
        y = tb[k]
        if x.device != y.device or x.shape != y.shape or x.dtype != y.dtype:
            differ.append(f"{k} (device/shape/dtype)")
            continue
        if not torch.equal(x, y):
            differ.append(k)
            d = float((x.double() - y.double()).abs().max())
            if d > worst:
                worst, worst_name = d, k
    return {"differ": differ, "max_abs_diff": worst, "worst": worst_name, "compared": len(ta)}


def full_ring_save_restore(Trainer, cfg) -> dict:
    """The save and the restore a long run pays: a full ring (every row
    seeded from numpy), its tree re-rooted at seeded priorities, saved with
    its snapshots, then restored by a new ``Trainer(resume=True)``, whose
    first flush ships the whole ring again. The restore must be
    ``torch.equal`` to the saved learner."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from d4pg_tpu_torch.replay import Transition

    saver = Trainer(cfg, device="cuda")
    a, cap = saver.config.agent, saver.config.replay_capacity
    rng = np.random.default_rng(SEED)
    rows = lambda *shape: rng.standard_normal((cap, *shape), dtype=np.float32)  # noqa: E731
    saver.buffer.add_batch(Transition(obs=rows(a.obs_dim), action=rows(a.action_dim),
                                      reward=rows(), next_obs=rows(a.obs_dim),
                                      discount=rng.random(cap, dtype=np.float32)))
    saver._ring_sync.flush(saver._ring)
    saver._dev_per.restore_host(rng.random(cap, dtype=np.float32) + 0.01, 1.01)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    saver._save_checkpoint()
    save_s = time.perf_counter() - t0
    ck = os.path.join(cfg.log_dir, "checkpoints")
    sizes = {f: os.path.getsize(os.path.join(ck, f)) for f in ("replay.npz", "device_per.npz")}
    saver.close()
    t0 = time.perf_counter()
    restorer = Trainer(dataclasses.replace(cfg, resume=True), device="cuda")
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    stages = restorer.timers.scalars()
    restorer.close()
    same = compare_learners(learner_of(saver), learner_of(restorer))
    check(not same["differ"], f"resume: the full ring's restore differs: {same}")
    check(int(restorer._ring.size) == cap, f"resume: full ring restored {int(restorer._ring.size)} rows")
    return {"rows": cap, "torch_equal": True, "tensors_compared": same["compared"],
            "save_s": save_s, "restore_s": stages["stage_checkpoint_restore_s"],
            "restore_ring_flush_s": stages["stage_ingest_chunk_s"],
            "trainer_construct_with_restore_s": construct_s, "bytes": sizes}


def resume_phase(Trainer, TrainConfig, card: str, log_dir: str):
    """Checkpoint, resume and preemption of the device learner at full
    width; returns the resumed leg's launch counts."""
    import copy
    import dataclasses
    import os
    import threading

    import torch

    cfg = TrainConfig(
        env="pendulum", total_steps=RESUME_STEPS, warmup_steps=1000, eval_interval=RESUME_STEPS,
        eval_episodes=2, log_dir=f"{log_dir}/resume", seed=SEED, replay_placement="device",
        steps_per_dispatch=K, prioritized=True, fused_descent=True, debug_guards=True,
        checkpoint_interval=RESUME_INTERVAL, snapshot_replay=True,
    )
    # Leg 1: two saves, at the crossings 96 -> 104 and 192 -> 200.
    leg1 = Trainer(cfg, device="cuda")
    try:
        leg1.train()
        torch.cuda.synchronize()
    finally:
        leg1.close()
    saved = leg1.ckpt.all_steps()
    want = sorted({d for d in range(K, RESUME_STEPS + 1, K)
                   if d // RESUME_INTERVAL > (d - K) // RESUME_INTERVAL} | {RESUME_STEPS})
    check(saved == want, f"resume: leg 1 saved steps {saved}, expected {want}")
    stages1 = leg1.timers.scalars()
    ck = os.path.join(cfg.log_dir, "checkpoints")
    sizes = {
        "state.pt": os.path.getsize(os.path.join(ck, str(RESUME_STEPS), "state.pt")),
        "replay.npz": os.path.getsize(os.path.join(ck, "replay.npz")),
        "device_per.npz": os.path.getsize(os.path.join(ck, "device_per.npz")),
    }

    # Restore onto the card, held against leg 1's live objects.
    t0 = time.perf_counter()
    leg2 = Trainer(dataclasses.replace(cfg, resume=True), device="cuda")
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    stages2 = leg2.timers.scalars()
    restored = compare_learners(learner_of(leg1), learner_of(leg2))
    check(not restored["differ"], f"resume: restored tensors differ from leg 1's: {restored}")
    restored_at = leg2.grad_steps
    check(restored_at == RESUME_STEPS and leg2.state.step == leg1.state.step,
          f"resume: grad_steps {leg2.grad_steps}, state.step {leg2.state.step}")
    check(leg2.env_steps == leg1.env_steps, f"resume: env_steps {leg2.env_steps} != {leg1.env_steps}")
    check(leg2._ckpt_fallbacks == 0, f"resume: {leg2._ckpt_fallbacks} checkpoint fallbacks")
    check(leg2._replay_restored and leg2._effective_warmup() == 0, "resume: replay not restored")

    # Is one dispatch bit-reproducible on this card? Twice from deep copies
    # of leg 1's state, from the same generator state.
    gen_state = leg1._megastep_gen.get_state()
    copies = []
    for _ in range(2):
        c = copy.deepcopy(learner_of(leg1))
        g = torch.Generator(device="cuda")
        g.set_state(gen_state)
        leg1._megastep(*c, g)
        copies.append(c)
    torch.cuda.synchronize()
    repeat = compare_learners(*copies)
    card_repeats = not repeat["differ"]

    # One dispatch on each trainer, no collection between: the same bits
    # (or, on a card that does not repeat itself, within 1e-6).
    leg2._megastep_gen.set_state(gen_state)
    for t in (leg1, leg2):
        t._megastep_dispatch_once()
        t.grad_steps += K  # what train() counts for a dispatch
    torch.cuda.synchronize()
    across = compare_learners(learner_of(leg1), learner_of(leg2))
    if card_repeats:
        check(not across["differ"], f"resume: one dispatch after the restore is not bit-equal: {across}")
    else:
        check(across["max_abs_diff"] <= 1e-6,
              f"resume: one dispatch after the restore differs by more than 1e-6: {across}")

    # The resumed trainer trains on: exact launches, no warmup.
    env0 = leg2.env_steps
    try:
        reset_counts()
        row = leg2.train(total_steps=RESUME_STEPS)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        leg2.close()
    dispatches = RESUME_STEPS // K
    expect = dict(fused_fwd=0, fused_bwd=RESUME_STEPS, project=0, tree_count=dispatches,
                  fused_step=RESUME_STEPS)
    check(launches == expect, f"resume: launch counts {launches}, expected {expect}")
    for k in ("critic_loss", "q_mean", "actor_loss", "priority_mean", "eval_return_mean"):
        check(k in row and row[k] == row[k] and abs(row[k]) != float("inf"),
              f"resume: {k} not finite: {row.get(k)}")
    collected = leg2.env_steps - env0
    check(collected < cfg.warmup_steps, f"resume: {collected} env steps collected: the warmup ran")

    # Preemption armed from a thread once grad_steps >= PREEMPT_AT.
    cfg3 = dataclasses.replace(cfg, log_dir=f"{log_dir}/preempt", total_steps=100_000,
                               eval_interval=100_000, checkpoint_interval=100_000)
    leg3 = Trainer(cfg3, device="cuda")

    def arm():
        while leg3.grad_steps < PREEMPT_AT:
            time.sleep(0.001)
        leg3.request_preemption()

    arming = threading.Thread(target=arm, daemon=True)
    arming.start()
    try:
        leg3.train()
    finally:
        leg3.close()
    arming.join(timeout=60)
    check(not arming.is_alive(), "resume: the preemption thread did not finish")
    g3 = leg3.grad_steps
    verdict = leg3.ckpt.verify_step(g3)
    check(leg3.preempted and g3 >= PREEMPT_AT and leg3.ckpt.latest_step() == g3,
          f"resume: preempted={leg3.preempted} at {g3}, latest step {leg3.ckpt.latest_step()}")
    check(verdict[0], f"resume: the preemption step's manifest does not verify: {verdict}")
    full = full_ring_save_restore(Trainer, dataclasses.replace(cfg, log_dir=f"{log_dir}/full"))

    a = cfg.agent
    emit({
        "phase": "resume",
        "card": card,
        "width": {"hidden": list(leg1.config.agent.hidden_sizes), "atoms": a.dist.num_atoms,
                  "batch": cfg.batch_size, "num_envs": cfg.num_envs,
                  "n_step": leg1.config.agent.n_step,
                  "replay_capacity": leg1.config.replay_capacity,
                  "tree_leaves": leg1._dev_per.tree.sums.shape[0] // 2,
                  "steps_per_dispatch": K, "tier": "fused_descent"},
        "saved_steps": saved,
        "restore": {"torch_equal": True, "tensors_compared": restored["compared"],
                    "grad_steps": restored_at, "env_steps": leg1.env_steps,
                    "checkpoint_fallbacks": leg2._ckpt_fallbacks},
        "card_repeats_one_dispatch": card_repeats,
        "card_repeat_check": repeat,
        "one_dispatch": {"bit_equal": not across["differ"], "held_at": 0.0 if card_repeats else 1e-6,
                         **across},
        "continue": {"grad_steps": RESUME_STEPS, "launches": launches,
                     "env_steps_collected": collected, "warmup_steps": cfg.warmup_steps,
                     "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
                     "eval_return_mean": row["eval_return_mean"]},
        "preempt": {"grad_step": g3, "preempted": True, "manifest_verified": True},
        "save_s_per_checkpoint": stages1["stage_checkpoint_save_s"]
        / stages1["stage_checkpoint_save_calls"],
        "restore_s": stages2["stage_checkpoint_restore_s"],
        "restore_ring_flush_s": stages2["stage_ingest_chunk_s"],
        "restore_ring_rows": int(leg1._ring.size),
        "trainer_construct_with_restore_s": construct_s,
        "bytes": sizes,
        "full_ring": full,
        "ok": True,
    })
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        from d4pg_tpu_torch.agent import create_train_state, train_step
        from d4pg_tpu_torch.agent.state import D4PGConfig
        from d4pg_tpu_torch.config import TrainConfig
        from d4pg_tpu_torch.ops import _build, cuda_fused_step, cuda_tree
        from d4pg_tpu_torch.ops import cuda_projection as cp
        from d4pg_tpu_torch.ops.categorical import make_support
        from d4pg_tpu_torch.replay import device_per as dper
        from d4pg_tpu_torch.runtime.trainer import Trainer
    except ImportError as e:
        print(f"chip_smoke: the d4pg_tpu_torch package is not here ({e})", file=sys.stderr)
        return 2

    card = nvidia_smi()
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    _build.build_all(sources)
    for name in sources:
        _build.load(name)
    build_s = time.perf_counter() - t0
    emit({
        "phase": "env",
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": card,
        "build_s": build_s,
        "sources": sources,
        # registers, shared memory and spills of every kernel
        "ptxas": {n: [ln.strip() for ln in log.splitlines() if "ptxas info" in ln or "spill" in ln]
                  for n, log in _build.build_logs.items()},
    })

    floor = floor_ms()
    emit({"phase": "floor", "op": "zero_() of a one-element CUDA tensor", "floor_ms": floor})
    err, timing = kernel_phase(cp, make_support, floor)
    tree_err, mismatch, tree_timing = tree_kernel_phase(
        cp, cuda_tree, cuda_fused_step, dper, make_support, floor)
    step_parity(D4PGConfig, create_train_state, train_step)
    check_sync_guard()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths["host_fused"] = slice_run(Trainer, TrainConfig, "fused", GRAD_STEPS, card, f"{tmp}/fused")
        paths["host_projection"] = slice_run(
            Trainer, TrainConfig, "projection", GRAD_STEPS_PROJECTION, card, f"{tmp}/projection")
        for tier in DEVICE_STEPS:
            paths[f"device_{tier}"] = device_slice_run(Trainer, TrainConfig, tier, card, f"{tmp}/{tier}")
        paths["device_resumed"] = resume_phase(Trainer, TrainConfig, card, tmp)

    def per_path(counter):
        return {path: counts[counter] for path, counts in paths.items()}

    b3 = tree_timing[f"per_tree_find_prefix n={K * 256}"]
    b4 = tree_timing["c51_fused_step"]
    rows = [
        # name, source, replaces, launch counter, main path it is read on, error, timing
        ("c51_fused_loss_fwd", "projection.cu", "d4pg_tpu/ops/pallas_projection.py:163",
         "fused_fwd", "host_fused", err["c51_fused_loss_fwd"], timing["c51_fused_loss_fwd"]),
        ("c51_fused_loss_bwd", "projection.cu", "d4pg_tpu/ops/pallas_projection.py:172",
         "fused_bwd", "host_fused", err["c51_fused_loss_bwd"], timing["c51_fused_loss_bwd"]),
        ("c51_project", "projection.cu", "d4pg_tpu/ops/pallas_projection.py:77",
         "project", "host_projection", err["c51_project"], timing["c51_project"]),
        ("per_tree_find_prefix", "per_tree.cu", "d4pg_tpu/ops/pallas_tree.py:80",
         "tree_count", "device_fused_descent", tree_err["per_tree_find_prefix"], b3),
        ("c51_fused_step", "fused_step.cu", "d4pg_tpu/ops/pallas_fused_step.py:53",
         "fused_step", "device_fused_descent", tree_err["c51_fused_step"], b4),
    ]
    kernels = []
    for name, source, replaces, counter, path, error, t in rows:
        entry = {
            "name": name, "route": "cuda", "source": f"d4pg_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": paths[path][counter], "main_path": path,
            "launches_by_path": per_path(counter), "max_abs_err": error,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "floor_ms": t["floor_ms"], "ok": True,
        }
        if "at_A1024" in t:  # B2 alone at B = 256, A = 1024
            entry["at_A1024"] = {k: t["at_A1024"][k] for k in ("ms", "bound_ms", "bound_by")}
        tag = {"tree_count": "B3", "fused_step": "B4"}.get(counter)
        if tag:  # draws whose index differs from the plain version's
            entry["index_mismatches_vs_plain"] = {
                case: n for case, n in mismatch.items() if case.startswith(tag)}
        kernels.append(entry)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
