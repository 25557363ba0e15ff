#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``d4pg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports nothing of JAX or of ``d4pg_tpu``. Phases, each printing one
JSON line:

1. ``env``: torch/CUDA versions, the card (``nvidia-smi``), and the nvcc
   build of every ``d4pg_tpu_torch/csrc/*.cu`` with its seconds.
2. ``kernel``: each hand-written kernel against its plain PyTorch version
   on the card, at B=256 and a ragged B=200 with A=51 atoms, on the
   Pendulum support [-300, 0] and on [-10, 10], with terminal rows and
   rows whose targets clip at v_min and v_max; then, at the learner's
   shape (B=256, A=51, Pendulum), the kernel's device time (100 launches
   in a CUDA graph, CUDA events around its replays), its eager per-call
   time (median over 100 calls), the same two for the plain version, and
   the kernel's bound.
3. ``step_parity``: one full-width ``train_step`` on the card (through the
   kernels) against the same step on the CPU (plain versions).
4. ``slice``: the learner end to end, ``Trainer`` on cuda at the full
   default width (3x256 MLPs, 51 atoms, B=256, 16 envs x 32-step
   segments, n-step 3, PER): warmup 1000 env steps, then grad steps and
   an eval, once with ``projection="fused"`` (the default: forward and
   backward kernels) and once with ``projection="projection"`` (the
   projection-only kernel). Launch counters are zeroed right before each
   run and read right after; every kernel of a run's path must have
   launched exactly once per grad step.

Then the ``kernels`` line, the card's name and power limit as
``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; with no CUDA device it exits 2 before
printing any result.
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

# Kernel vs plain version on the card: both sum 51 float32 terms per
# output, in another order (the plain projection is a batched matmul), so
# results agree to a few float32 ulps of values up to ~10.
ATOL, RTOL = 2e-5, 1e-5

GRAD_STEPS = 1000            # fused run
GRAD_STEPS_PROJECTION = 200  # projection-only run
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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


def kernel_phase(cp, make_support):
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
            "bytes": nbytes,
            "ops": ops,
        }
        emit({"phase": "kernel_time", "name": name, "B": B, "A": A, **timing[name]})
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


def slice_run(cp, Trainer, TrainConfig, projection: str, grad_steps: int, card: str, log_dir: str):
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
        cp.reset_launch_counts()
        t0 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cp.LAUNCHES)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        from d4pg_tpu_torch.agent import create_train_state, train_step
        from d4pg_tpu_torch.agent.state import D4PGConfig
        from d4pg_tpu_torch.config import TrainConfig
        from d4pg_tpu_torch.ops import _build
        from d4pg_tpu_torch.ops import cuda_projection as cp
        from d4pg_tpu_torch.ops.categorical import make_support
        from d4pg_tpu_torch.runtime.trainer import Trainer
    except ImportError as e:
        print(f"chip_smoke: the d4pg_tpu_torch package is not here ({e})", file=sys.stderr)
        return 2

    card = nvidia_smi()
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
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
        "ptxas": {n: [ln for ln in log.splitlines() if "ptxas info" in ln]
                  for n, log in _build.build_logs.items()},
    })

    err, timing = kernel_phase(cp, make_support)
    step_parity(D4PGConfig, create_train_state, train_step)
    with tempfile.TemporaryDirectory() as tmp:
        fused = slice_run(cp, Trainer, TrainConfig, "fused", GRAD_STEPS, card, f"{tmp}/fused")
        proj = slice_run(cp, Trainer, TrainConfig, "projection", GRAD_STEPS_PROJECTION, card,
                         f"{tmp}/projection")

    source = "d4pg_tpu_torch/csrc/projection.cu"
    rows = [
        ("c51_fused_loss_fwd", "d4pg_tpu/ops/pallas_projection.py:163", fused["fused_fwd"]),
        ("c51_fused_loss_bwd", "d4pg_tpu/ops/pallas_projection.py:172", fused["fused_bwd"]),
        ("c51_project", "d4pg_tpu/ops/pallas_projection.py:77", proj["project"]),
    ]
    emit({"kernels": [
        {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err[name],
            "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"], "bound_by": timing[name]["bound_by"],
            "library_ms": None, "ok": True,
        }
        for name, replaces, launches in rows
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
