#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``d4pg_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc.
It imports nothing of JAX or of ``d4pg_tpu``. Phases, each printing one
JSON line (with ``at_s``, the seconds since the script started):

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
5. ``native_tree``: a host check on the card's machine. The port's native
   tree backend (``csrc/sumtree.cpp``, built by this machine's g++)
   against its NumPy backend at 2^20 leaves: after the same 1M adds and
   [K, B] priority write-backs, ``sample_block`` must give ``array_equal``
   idx, gen, IS weights and rows at K = 1 and K = 8 (B = 256). Also the
   host time (median of 21 calls) of an 8 x 256 ``sample_block`` and of
   its write-back on each backend.
6. ``slice``: the learner end to end, ``Trainer`` on cuda at the full
   default width (3x256 MLPs, 51 atoms, B=256, 16 envs x 32-step
   segments, n-step 3, PER on NumPy trees, K = 1): warmup 1000 env steps,
   then grad steps and an eval, once with ``projection="fused"`` (the
   default: forward and backward kernels) and once with
   ``projection="projection"`` (the projection-only kernel). Launch
   counters are zeroed right before each run and read right after; every
   kernel of a run's path must have launched exactly once per grad step.
   The line carries ``stage_ms_per_step``: the host-clock ms a grad step
   of ``sample``, ``h2d_stage``, ``priority_writeback`` and the dispatch.
7. ``host_block``: the host placement at the same width with K = 8 grad
   steps per dispatch on the native tree (one ``sample_block`` C call and
   one [8, 256] copy to the card a dispatch, ``fused_train_scan``, the
   [8, 256] priorities written back one dispatch later): 1000 grad steps
   after the 1000-env-step warmup. Exact launch counts (B1f and B1b once a
   grad step, B2, B3 and B4 never), finite metrics, ``max_priority`` off
   its 1.0 seed, the backend in use, ``stage_ms_per_step`` and
   ``steady_state`` as in ``device_slice``.
8. ``device_slice``: the device-resident learner (``replay_placement=
   "device"``, K = 8 grad steps per megastep dispatch) at the same width
   with a 1M-row device ring and 2^20-leaf device tree: PER with the
   fused descent (B3 once and B4 K times a dispatch), PER with separate
   kernels (B3 once, B1f K times) and uniform replay. Exact launch counts
   per run, finite metrics, ``max_priority`` off its 1.0 seed, and every
   dispatch after the first under ``torch.cuda.set_sync_debug_mode(
   "error")`` (``debug_guards``): a host synchronisation inside a
   steady-state dispatch fails the run. After each run, a few more
   dispatches give the wall and device time of a grad step and the
   device's idle share (``steady_state``; device time: the union of the
   kernel, copy and memset intervals of a ``torch.profiler`` trace).
9. ``hybrid_slice``: ``replay_placement="hybrid"`` at the same width, K =
   8, on the native tree with ``debug_guards``: a 1M-row device ring and a
   2^20-leaf host tree; each dispatch copies only the [8, 256] indices and
   IS weights to the card and gathers the rows from the ring. 1000 grad
   steps with the checks of ``host_block``, every dispatch after the first
   under ``torch.cuda.set_sync_debug_mode("error")``, and the ring's fill
   equal to the host buffer's.
10. ``resume``: checkpoint and resume of the device learner at the same
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
11. ``host_async`` (twice, both with ``debug_guards``: K = 1 on NumPy
   trees right after the ``slice`` runs, and K = 8 on the native tree
   right after ``host_block``): the host placement at the same width with ``prefetch``
   (each dispatch's batch sampled and its copy started, on a copy stream
   of its own, right after the previous dispatch) and
   ``async_priority_writeback`` (the flusher thread), 1000 grad steps.
   Exact launch counts (B1f and B1b once a grad step, B2, B3, B4 never),
   exactly one applied write-back per dispatch, the flusher's thread
   stopped and its queue gone after ``train()``, ``max_priority`` off
   1.0, finite metrics and every dispatch after the first under
   ``set_sync_debug_mode("error")`` while the flusher waits on its
   copy-done event in its own thread (the ``sync_guard`` line, before the
   learner phases, shows that ``.item()`` raises under the guard and
   ``Event.synchronize()``, the flusher's wait, does not).
   ``stage_ms_per_step`` and ``steady_state``
   (measured with the prefetch and the flusher running) beside the
   synchronous runs.
12. ``prefetch_first_step``: two trainers from one seed, prefetch on and
   off, one grad step each: the step's metrics and every tensor of the
   learner state ``torch.equal``.
13. ``device_ingest_prefetch_pair``: the fused-descent device learner of
   ``device_slice``, 200 grad steps with ``ingest_prefetch`` on and off
   from one seed: exact launch counts, ``stage_ingest_stage_calls`` equal
   to the dispatches on the first, the chunks ``stage()`` staged (0 in
   this synchronous loop: collection and the flush run before each
   dispatch), and the final params, Adam moments, ring and tree
   ``torch.equal``.
14. ``ingest_stage``: ``DeviceRingSync.stage`` driven directly on a 1M-row
   ring with the device tree hooked, against a twin that flushes with no
   stage: a chunk staged while a fused-descent megastep is in flight,
   then a chunk staged and every staged slot overwritten across the wrap
   before the flush; ring and tree ``torch.equal`` to the twin's after
   each flush, and the staged host-to-device copies, in a
   ``torch.profiler`` trace, on a stream no megastep kernel runs on (how
   many overlapped a kernel is recorded, not gated).
15. ``hybrid_async``: ``hybrid_slice`` (K = 8, native, ``debug_guards``)
   with ``async_priority_writeback`` and ``prefetch=True`` passed: the
   ``prefetch_ignored`` line printed, then the checks of ``host_async``.
16. ``profile``: host K = 8, native, ``prefetch``, the flusher and
   ``profile_dir``, 80 grad steps: the trace of grad steps [16, 64) must
   hold the ranges ``host/sample``, ``host/h2d_stage``,
   ``host/train_dispatch``, ``host/prefetch`` and
   ``host/priority_writeback`` and one B1f and one B1b launch a grad step;
   the window's host ms a grad step per range and device ms a grad step
   per kernel name.
17. ``planar_step_parity``: one HalfCheetah control step (20 substeps of
   the planar engine) for 128 seeded states, most in ground contact, on the
   card against the same step on the CPU: q, q̇, obs and reward within the
   stated tolerances, terminated and truncated equal; the card's wall ms of
   one control step for the 128 envs and the kernels one step launches.
18. ``on_device_pendulum``: ``OnDeviceRun`` (``train --on-device``) at the
   default width (3x256, 51 atoms, B = 256, 16 envs x 32 steps, so K = 512
   grad steps a train iteration, n-step 3, PER): one warmup segment, 2
   train iterations, the second under ``set_sync_debug_mode("error")``;
   B1f and B1b exactly K x 2 launches, B2, B3 and B4 none, finite metrics,
   the ring's fill equal to the rows appended, ``max_priority`` off 1.0.
   Then one segment alone and one more train iteration under the guard and
   a device-only ``torch.profiler`` trace: wall ms, device busy ms (the
   union of kernel, copy and memset intervals) and idle share.
19. ``on_device_halfcheetah``: the same at the README's HalfCheetah
   command (128 envs, n-step 5, support [-100, 1500], a 2^20-row ring,
   PER, default widths; K = 4096): one warmup segment, ONE train
   iteration and one eval episode of 250 steps, not 1000 (the depth
   cuts), the same checks and measurements.
20. ``stacked_kernel`` (right after ``tree_kernel``): B1f and B1b over E
   stacked critics in one launch, logits [E, B, A] against the members'
   shared target [B, A], at E in {2, 10} x B in {1, 7, 256, 2048} x A in
   {51, 101}, both supports, terminal and clipping rows: each within
   ATOL/RTOL of its plain version and ``torch.equal`` to E single-member
   launches; B4 at E in {2, 10} x B in {256, 2048}, L = 2^20: ce/ov
   ``torch.equal`` to stacked B1f, idx to B3 (one descent for all
   members). At E = 10, B = 2048, A = 51 each kernel's device time, its
   plain version's, E separate launches' and its bound at E x B rows
   (the ``stacked`` entry of its ``kernels`` line).
21. ``stacked_step_parity`` (after ``step_parity``): one full-width
   ``train_step`` on the card against the CPU for twin critics, a REDQ
   ensemble (E = 10, M = 2, one subset fed to both) and bfloat16 compute,
   each at its stated tolerance, one B1f and one B1b launch a step.
22. ``on_device_hopper_twin``: the twin arm of
   ``runs/hopper_ondevice_tpu_r3/NOTES.md`` (``--env hopper --on-device
   --num-envs 64 --twin-critic``, n-step 3, PER, [0, 500]; K = 2048), one
   warmup segment, ONE train iteration and one eval episode, with
   ``on_device_halfcheetah``'s checks and measurements.
23. ``large_batch``: the large-batch recipe of ``docs/data_plane.md``
   (device placement, PER, fused descent, ``--compute-dtype bfloat16
   --steps-per-dispatch 32 --batch-scale 8 --ingest-prefetch``: B = 2048,
   K = 4) with a REDQ ensemble (E = 10, M = 2), a 1M-row ring: 200 grad
   steps after the scaled warmup (8000 env steps), every dispatch after
   the first under the sync guard; exactly one B4 and one B1b launch a
   grad step, no B1f, B3 once a dispatch; finite metrics, ``max_priority``
   off 1.0, ``steady_state``.
24. ``bf16_wire``: one ``on_device_pendulum`` train iteration with
   ``compute_dtype`` and ``ring_dtype`` bfloat16 (the ring's observations
   stored as bf16), then 200 host K = 1 grad steps with
   ``transfer_dtype="bfloat16"`` (the staged observations bf16 on the
   wire); exact launches and finite metrics on both.

22a. ``spatial_step_parity`` (twice, Humanoid and Ant, after
   ``on_device_hopper_twin``): one control step of the 3D engine (10 or 20
   substeps) for 64 seeded states, most in ground contact, on the card
   against the same step on the CPU: q, v, obs and reward within the
   stated tolerances, the root quaternions unit within 1e-6, terminated
   and truncated equal; the rows in contact, the card's wall ms of one
   control step for the 64 envs, the kernels one step launches (and a
   substep's share) and their device ms; every hand-kernel counter 0.
22b. ``on_device_humanoid``: the README's on-device Humanoid recipe
   (``--env humanoid --on-device --num-envs 64 --rmsize 524288 --n-step 3
   --v-min 0 --v-max 1500 --noise-decay-steps 2000000
   --noise-scale-final 0.1``; K = 2048) at the default widths, one warmup
   segment, ONE train iteration and one eval episode of 250 steps (not
   1000), with ``on_device_halfcheetah``'s checks and measurements.

25. ``heads_step_parity`` (after ``stacked_step_parity``): one full-width
   ``train_step`` with the scalar head and the MoG head (M = 5) on the card
   against the CPU, single and REDQ (E = 10, M = 2, one subset fed to
   both): priorities and critic loss at step_parity's tolerances (their
   max abs errors printed), no kernel launched on either device.
26. ``heads_device`` (twice: ``mixture_gaussian`` and ``scalar``): the
   device-PER learner without the fused descent (K = 8, 1M-row ring,
   2^20-leaf tree, ``debug_guards``) at full width on Pendulum, 200 grad
   steps: B3 exactly once a dispatch (25), B1f, B1b, B2 and B4 never, the
   support [-300, 0], finite metrics, ``max_priority`` off 1.0, grad
   steps/s and ``steady_state`` as in ``device_slice``.
27. ``her_pointmass``: ``--env pointmass_goal --her --n-step 1`` on the
   device placement with PER and the fused descent (K = 8, 1M-row ring,
   ``debug_guards``), full width: whole HER episodes for the warmup, then
   200 grad steps: B4 and B1b exactly 200, B3 25, B1f and B2 0; the rows
   in replay and in the ring equal to the writer accounting's prediction
   (live env steps x (1 + her_k)); finite metrics and ``success_rate``;
   the wall ms of five more single HER episodes.

28. ``serve``: the serving stack on the card. The host_fused run's
   champion exported by ``python -m d4pg_tpu_torch.train --export-bundle``
   (its leaves ``torch.equal`` to the run's actor) and a seeded
   HalfCheetah-width bundle (obs 17, action 6) with non-identity bounds
   and obs-norm stats, both resident in one ``PolicyServer`` at the full
   3x256 width, ``max_batch`` 64 (buckets 1 to 64) and ``debug_guards``
   (every batch after warmup under ``set_sync_debug_mode("error")``; at
   drain, every parameter still the tensor the graphs captured): 7 CUDA
   graph captures per policy; 256 seeded observations per policy over the
   socket against the port's CPU forward within SERVE_TOL; a hot reload of
   the default policy under 4 pipelined clients (every reply the old or
   the new forward, every one after the swap the new, captures unchanged,
   no parameter rebound, one params reload); replays equal to batches;
   per bucket the forward's device time (100 in one CUDA graph), its
   captured graph replayed back to back and the eager call. Then the CLI
   as users run it (``python -m d4pg_tpu_torch.serve --port 0``, no
   guards, its own process): one request against the CPU forward, the
   closed-loop load at (connections, window) = (1, 1), (4, 16), (16, 16)
   from this process (requests/s, client p50/p95/p99, mean rows per
   batch, each stage's ms a batch over the profile, both processes' CPU,
   no shed, ``batched_over_single``), SIGTERM, its "drained" line and
   exit 0. The saturated profile twice more, on the CLI under
   ``--debug-guards`` and on the in-process guarded server, parts the
   guard's cost from that of sharing the server's process. No hand
   kernel launched (the ``serve`` entry of every ``launches_by_path``).

29. ``pixel_step_parity``: the pixel path (ROADMAP A10 (c)) at the
   ``pixel_pendulum`` preset's full width (48x48x2 frames, the 4x32 conv
   encoder with embedding 50, 3x256, 51 atoms, B = 256) on the card
   against the CPU from the same weights, batch and DrQ shift offsets:
   one encoder forward, one ``train_step`` (losses, priorities, every
   updated parameter; B1f and B1b once on the card), the render of 64
   states and the uint8 encode and decode, each error beside its stated
   tolerance; the card's eager call ms of the encoder and of a step.
30. ``host_pixel``: the ``Trainer`` on ``--env pixel_pendulum`` (host
   placement, the uint8 replay at 100 000 rows, PER on the native tree,
   K = 4, 200 grad steps under the sync guard), one line per wire:
   ``float32`` (``OBS_U8_DECODE``) and ``uint8`` (``OBS_U8_RAW``, one byte
   an observation element on the wire): grad and env steps/s,
   ``steady_state``, the bytes a dispatch copies, the buffer's dtype, B1f
   = B1b = 200 (``host_pixel_float32`` / ``host_pixel_uint8`` in every
   ``launches_by_path``). Then ``on_device_pixel_pendulum`` (phase 18's
   harness): ``--on-device`` with the uint8 ring at 99 840 rows, K = 512,
   B1f = B1b = K. The ``serve`` line also serves a seeded pixel bundle
   (its graphs capture the conv encoder) against CPU actions.

Then the ``kernels`` line (all five kernels; each one's ``launches`` from
the run of its ``main_path``, with ``launches_by_path`` for every run;
B3's ``max_abs_err`` is the largest index distance to its plain version,
B4's the largest ce/ov error), the card's name and power limit as
``nvidia-smi`` gives them, and last ``{"ok": true, "device": {...}}``. Any
failure raises and exits non-zero; with no CUDA device, or alone in a
directory without the package, it exits 2 before printing any result.
"""

from __future__ import annotations

import contextlib
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
HOST_BLOCK_STEPS = 1000      # host K = 8 and hybrid runs
ASYNC_STEPS = 1000           # host_async and hybrid_async runs
INGEST_PAIR_STEPS = 200      # each run of the ingest_prefetch pair
PROFILE_STEPS = 80           # the profile phase's run (trace of [16, 64))
RESUME_STEPS = 200           # each leg of the resume phase
RESUME_INTERVAL = 100        # its checkpoint interval (saves at 104 and 200)
PREEMPT_AT = 16              # grad steps before the third trainer is preempted
K = 8                        # grad steps per megastep dispatch
TREE_L = 2**20               # device tree leaves at the 1M-row replay
SEED = 0
START = time.perf_counter()  # the script's start, for each phase line's ``at_s``


def emit(obj) -> None:
    """Print one JSON line; a phase's line also carries ``at_s``, the
    seconds since the script started, so a run's time splits by phase."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - START}
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


def step_batch(rng, B: int) -> dict:
    """A Pendulum-shaped batch of B rows for the step parity phases, with
    ~10 % terminal rows and PER importance weights."""
    import numpy as np

    return {
        "obs": rng.normal(size=(B, 3)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(B, 1)).astype(np.float32),
        "reward": rng.uniform(-16, 0, size=B).astype(np.float32),
        "next_obs": rng.normal(size=(B, 3)).astype(np.float32),
        "discount": np.where(rng.uniform(size=B) < 0.1, 0.0, 0.99**3).astype(np.float32),
        "weights": rng.uniform(0.2, 1.0, size=B).astype(np.float32),
    }


def step_parity(cfg_cls, create_train_state, train_step):
    """One full-width train step on the card (kernels) vs on the CPU
    (plain versions), from the same initial weights and batch."""
    import numpy as np
    import torch

    from d4pg_tpu_torch.models.critic import DistConfig

    agent = cfg_cls(dist=DistConfig(v_min=-300.0, v_max=0.0), n_step=3)
    B = 256
    batch = step_batch(np.random.default_rng(SEED), B)
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


def slice_run(Trainer, TrainConfig, projection: str, grad_steps: int, card: str, log_dir: str,
              keep: dict | None = None):
    """One host K = 1 learner run; ``keep`` (when given) receives the
    final actor's ``state_dict`` on the CPU, the champion its one eval
    saved to ``checkpoints/best_actor.npz``."""
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
        tree_backend="numpy",  # K = 1 on NumPy trees: the host baseline
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
    if keep is not None:
        keep.update({k: v.detach().cpu().clone() for k, v in trainer.state.actor.state_dict().items()})
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
        "tree_backend": trainer.buffer.tree_backend,
        "stage_ms_per_step": stage_ms_per_step(trainer.timers.scalars(), grad_steps),
        "stages": trainer.timers.scalars(),
        "ok": True,
    })
    return launches


def stage_ms_per_step(stages: dict, grad_steps: int) -> dict:
    """Host-clock ms a grad step of each data-plane and dispatch stage."""
    names = ("sample", "h2d_stage", "priority_writeback", "train_dispatch",
             "megastep_dispatch", "ingest_chunk", "ingest_stage")
    return {name: stages[f"stage_{name}_s"] * 1e3 / grad_steps for name in names}


def native_tree_phase(repeats: int = 21):
    """The port's native tree backend, built by this machine's g++, against
    its NumPy backend at the 1M-row replay's 2^20 leaves: after the same
    adds and priority write-backs, ``sample_block`` must give equal idx,
    gen, IS weights and rows at K = 1 and 8 (B = 256). Then, on this host,
    the median of ``repeats`` calls of each backend's ``sample_block``
    (K = 8) and of its write-back of that block."""
    import numpy as np

    from d4pg_tpu_torch.replay import PrioritizedReplayBuffer, Transition

    rows, B = TREE_L, 256
    rng = np.random.default_rng(SEED)
    data = Transition(
        rng.normal(size=(rows, 3)).astype(np.float32),
        rng.uniform(-1, 1, (rows, 1)).astype(np.float32),
        rng.uniform(-16, 0, rows).astype(np.float32),
        rng.normal(size=(rows, 3)).astype(np.float32),
        np.where(rng.uniform(size=rows) < 0.005, 0.0, 0.99**3).astype(np.float32),
    )
    bufs = {b: PrioritizedReplayBuffer(rows, 3, 1, tree_backend=b) for b in ("native", "numpy")}
    check(bufs["native"].tree_backend == "native", "the native tree backend did not load")
    t = {}
    for name, buf in bufs.items():
        t0 = time.perf_counter()
        buf.add_batch(data)
        t[f"{name}_add_1M_s"] = time.perf_counter() - t0
    # write-backs as the learner makes them: a [K, B] block of fresh draws,
    # its priorities from a seeded gamma
    for r in range(4):
        pri = np.random.default_rng(200 + r).gamma(2.0, size=(K, B))
        for buf in bufs.values():
            blk = buf.sample_block(B, K, np.random.default_rng(100 + r), step=r)
            buf.update_priorities(blk["indices"], pri)
    equal = {}
    for k in (1, K):
        got = {}
        for name, buf in bufs.items():
            blk = buf.sample_block(B, k, np.random.default_rng(7 + k), step=500)
            got[name] = {"idx": blk["indices"].idx, "gen": blk["indices"].gen,
                         **{f: blk[f] for f in ("weights", "obs", "action", "reward",
                                                "next_obs", "discount")}}
        equal[f"K{k}"] = {f: bool(np.array_equal(got["native"][f], got["numpy"][f]))
                          for f in got["native"]}
        check(all(equal[f"K{k}"].values()), f"native_tree: K={k} differs from NumPy: {equal[f'K{k}']}")
    check(bufs["native"]._max_priority == bufs["numpy"]._max_priority > 1.0,
          "native_tree: max_priority differs or did not move")
    for name, buf in bufs.items():
        draw, write = [], []
        rng = np.random.default_rng(300)
        for r in range(repeats):
            t0 = time.perf_counter()
            blk = buf.sample_block(B, K, rng, step=600 + r)
            t1 = time.perf_counter()
            buf.update_priorities(blk["indices"], rng.gamma(2.0, size=(K, B)))
            t2 = time.perf_counter()
            draw.append(t1 - t0)
            write.append(t2 - t1)
        t[f"{name}_sample_block_K{K}_ms"] = statistics.median(draw) * 1e3
        t[f"{name}_writeback_K{K}_ms"] = statistics.median(write) * 1e3
    emit({"phase": "native_tree", "leaves": TREE_L, "batch": B, "array_equal": equal,
          "host_ms_median_of": repeats, "host_times": t, "ok": True})


def host_data_plane_run(Trainer, TrainConfig, placement: str, card: str, log_dir: str):
    """The host data plane at full width, K = 8, on the native tree:
    ``host`` (one ``sample_block`` C call and one [K, B] H2D a dispatch,
    ``fused_train_scan``) or ``hybrid`` (the host tree's [K, B] indices and
    weights to the device, rows gathered from the 1M-row device ring, every
    dispatch after the first under ``set_sync_debug_mode("error")``). Exact
    launch counts, the backend in use, stage counters and steady state."""
    import dataclasses

    import torch

    from d4pg_tpu_torch.agent.state import D4PGConfig

    n = HOST_BLOCK_STEPS
    cfg = TrainConfig(
        env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n, eval_episodes=10,
        log_dir=log_dir, seed=SEED, replay_placement=placement, steps_per_dispatch=K,
        prioritized=True, tree_backend="native", debug_guards=placement == "hybrid",
        agent=dataclasses.replace(D4PGConfig(), projection_backend="fused"),
    )
    trainer = Trainer(cfg, device="cuda")
    try:
        check(trainer.buffer.tree_backend == "native", f"{placement}: tree backend "
              f"{trainer.buffer.tree_backend}, not native")
        reset_counts()
        t0 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        stages = trainer.timers.scalars()
        busy = device_busy(trainer)  # after the counts: these dispatches are extra
    finally:
        trainer.close()
    for k in ("critic_loss", "q_mean", "actor_loss", "priority_mean", "eval_return_mean"):
        check(k in row and row[k] == row[k] and abs(row[k]) != float("inf"),
              f"{placement}: {k} not finite: {row.get(k)}")
    expect = dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0)
    check(launches == expect, f"{placement}: launch counts {launches}, expected {expect}")
    dispatch_stage = "megastep_dispatch" if placement == "hybrid" else "train_dispatch"
    check(stages[f"stage_{dispatch_stage}_calls"] == n // K and trainer.grad_steps == n,
          f"{placement}: {stages[f'stage_{dispatch_stage}_calls']} dispatches for "
          f"{trainer.grad_steps} grad steps")
    max_priority = trainer.buffer._max_priority
    check(max_priority > 1.0, f"{placement}: max_priority {max_priority} did not move off 1.0")
    if placement == "hybrid":
        size = len(trainer.buffer)
        check(int(trainer._ring.size) == size, f"hybrid: ring holds {int(trainer._ring.size)} "
              f"rows, the host buffer {size}")
    a = trainer.config.agent
    emit({
        "phase": "host_block" if placement == "host" else "hybrid_slice",
        "placement": placement,
        "card": card,
        "width": {"hidden": list(a.hidden_sizes), "atoms": a.dist.num_atoms,
                  "batch": trainer.config.batch_size, "num_envs": trainer.config.num_envs,
                  "n_step": a.n_step, "prioritized": True,
                  "replay_capacity": trainer.config.replay_capacity,
                  "host_tree_leaves": TREE_L, "steps_per_dispatch": K,
                  "projection": a.projection_backend},
        "tree_backend": trainer.buffer.tree_backend,
        "grad_steps": n,
        "dispatches": n // K,
        "sync_guard": ("set_sync_debug_mode('error') on every dispatch after the first"
                       if placement == "hybrid" else None),
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
        "stage_ms_per_step": stage_ms_per_step(stages, n),
        "stages": stages,
        "steady_state": busy,
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
    """The guard the steady-state dispatches run under must bite on this
    torch: a .item() under set_sync_debug_mode("error") raises. The
    write-back thread waits with ``Event.synchronize()`` while the loop
    thread may be inside the guard (the mode is process-wide), so that
    wait must not raise."""
    import torch

    from d4pg_tpu_torch.runtime.trainer import _sync_debug_error

    def raises(fn) -> bool:
        try:
            with _sync_debug_error():
                fn()
        except RuntimeError:
            return True
        return False

    x = torch.ones(2, device="cuda")
    done = torch.cuda.Event()
    done.record()
    seen = {"item": raises(lambda: x.sum().item()),
            "event_synchronize": raises(done.synchronize)}
    check(seen["item"], "set_sync_debug_mode('error') did not raise on .item()")
    check(not seen["event_synchronize"],
          "set_sync_debug_mode('error') raised on Event.synchronize()")
    emit({"phase": "sync_guard", "raises": seen, "ok": True})


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device work in a Chrome trace


def union_ms(spans) -> float:
    """Length of the union of (start, end) intervals, in the trace's us, as ms."""
    total, reach = 0.0, None
    for s0, s1 in sorted(spans):
        if reach is None or s0 > reach:
            total += s1 - s0
            reach = s1
        elif s1 > reach:
            total += s1 - reach
            reach = s1
    return total / 1e3


def device_busy(trainer, dispatches: int = 4) -> dict:
    """Where a steady-state dispatch's time goes: the wall time a grad step
    takes (host clock over ``dispatches`` dispatches of K steps on the
    trainer's placement, ending in a synchronize, no profiler attached), the
    device time a grad step takes (the union of the kernel, copy and memset
    intervals of a ``torch.profiler`` trace of as many more dispatches: the
    batch copies run on a copy stream of their own and may overlap the
    kernels), and the device's idle share, 1 - device / wall. None where
    the trace holds no device event. Also each category's sum a step, and
    ``device_events_sum_ms_per_step``: every CUDA-side profiler event
    summed, the measure of PRs 4-7, which since the ``host/<name>`` ranges
    also counts their GPU-side projections (``gpu_user_annotation``). The
    trainer's ``prefetch`` and write-back thread run as in ``train()``."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    k = trainer.config.steps_per_dispatch

    def run():
        for i in range(dispatches):
            trainer._dispatch_once(prefetch_next=i + 1 < dispatches)

    with trainer._async_writeback():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (dispatches * k)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    steps = dispatches * k
    events_us = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    with tempfile.TemporaryDirectory() as tmp:
        events = trace_events(prof, f"{tmp}/busy.json")
    by_cat, annotations = {}, {}
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS or cat == "gpu_user_annotation":
            by_cat[cat] = by_cat.get(cat, 0.0) + e.get("dur", 0) / 1e3 / steps
        if cat == "gpu_user_annotation":
            annotations[e["name"]] = annotations.get(e["name"], 0.0) + e.get("dur", 0) / 1e3 / steps
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    device_ms = union_ms(device) / steps if device else None
    return {
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
        "device_ms_per_step_by_category": by_cat,
        "device_events_sum_ms_per_step": events_us / 1e3 / steps,
        "gpu_user_annotation_ms_per_step": dict(sorted(annotations.items(), key=lambda kv: -kv[1])[:6]),
    }


FINITE_KEYS = ("critic_loss", "q_mean", "actor_loss", "priority_mean", "eval_return_mean")


def device_learner_run(Trainer, cfg, label: str, expect: dict, steady: bool = True):
    """``Trainer(cfg)`` on the card, launch counters zeroed right before
    ``train()`` and read right after: the launches must equal ``expect``,
    the run must take one dispatch per K grad steps and end with finite
    metrics, and a device PER tree's ``max_priority`` must have moved off
    its 1.0 seed. With ``steady``, a few more dispatches then give
    ``device_busy``. Returns (trainer, metrics row, launches, wall s,
    steady state or None, stage timers)."""
    import torch

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
        busy = device_busy(trainer) if steady else None  # after the counts: extra dispatches
    finally:
        trainer.close()
    n, k = cfg.total_steps, trainer.config.steps_per_dispatch
    check(launches == expect, f"{label}: launch counts {launches}, expected {expect}")
    check(dispatched == n // k and trainer.grad_steps == n,
          f"{label}: {dispatched} dispatches for {trainer.grad_steps} grad steps")
    for key in FINITE_KEYS:
        check(key in row and row[key] == row[key] and abs(row[key]) != float("inf"),
              f"{label}: {key} not finite: {row.get(key)}")
    if trainer._dev_per is not None:
        max_priority = float(trainer._dev_per.tree.max_priority)
        check(max_priority > 1.0, f"{label}: max_priority {max_priority} did not move off 1.0")
    return trainer, row, launches, wall, busy, stages


def device_slice_run(Trainer, TrainConfig, tier: str, card: str, log_dir: str):
    """The device-resident learner at full width, one tier; exact launch
    counts for N grad steps in N/K dispatches."""
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
    dispatches = n // K
    expect = {
        "fused_descent": dict(fused_fwd=0, fused_bwd=n, project=0, tree_count=dispatches, fused_step=n),
        "separate": dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=dispatches, fused_step=0),
        "uniform": dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0),
    }[tier]
    trainer, row, launches, wall, busy, stages = device_learner_run(Trainer, cfg, tier, expect)
    max_priority = None
    if trainer._dev_per is not None:
        max_priority = float(trainer._dev_per.tree.max_priority)
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


def guard_counter(trainer) -> list:
    """Count the dispatches that run under ``set_sync_debug_mode("error")``:
    wraps the trainer's ``_dispatch_guard`` and records each call that
    returns the real guard."""
    import contextlib

    guarded = []
    orig = trainer._dispatch_guard

    def counting():
        cm = orig()
        if not isinstance(cm, contextlib.nullcontext):
            guarded.append(1)
        return cm

    trainer._dispatch_guard = counting
    return guarded


def async_run(Trainer, TrainConfig, phase: str, placement: str, k: int, backend: str,
              card: str, log_dir: str):
    """The asynchronous host data plane at full width: ``prefetch`` and
    ``async_priority_writeback`` on the host placement (``host_async``) or
    the hybrid one (``hybrid_async``, where ``prefetch`` is declared
    ignored), with ``debug_guards``. Exact launch counts, one applied
    write-back per dispatch, the flusher stopped and its queue gone after
    ``train()``, and every dispatch after the first under the sync guard
    while the flusher thread waits in its own thread."""
    import contextlib
    import dataclasses
    import io

    import torch

    from d4pg_tpu_torch.agent.state import D4PGConfig

    n = ASYNC_STEPS
    cfg = TrainConfig(
        env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n, eval_episodes=10,
        log_dir=log_dir, seed=SEED, replay_placement=placement, steps_per_dispatch=k,
        prioritized=True, tree_backend=backend, debug_guards=True, prefetch=True,
        async_priority_writeback=True,
        agent=dataclasses.replace(D4PGConfig(), projection_backend="fused"),
    )
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        trainer = Trainer(cfg, device="cuda")
    print(said.getvalue(), end="", flush=True)
    declared = "--prefetch double-buffers the host batch upload" in said.getvalue()
    check(declared == (placement != "host"), f"{phase}: prefetch_ignored line printed: {declared}")
    check(trainer.config.prefetch == (placement == "host"), f"{phase}: prefetch {trainer.config.prefetch}")
    guarded = guard_counter(trainer)
    try:
        check(trainer.buffer.tree_backend == backend, f"{phase}: tree backend {trainer.buffer.tree_backend}")
        reset_counts()
        t0 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        stages = trainer.timers.scalars()
        applied = trainer.writebacks_applied
        flusher = {"writebacks_applied": applied,
                   "thread_stopped": trainer._wb_thread is None,
                   "queue_gone": trainer._wb_queue is None,
                   "idle": trainer._wb_idle.is_set(),
                   "lagged_pending": trainer._pending is not None}
        n_guarded = len(guarded)
        busy = device_busy(trainer)  # after the counts: these dispatches are extra
    finally:
        trainer.close()
    dispatches = n // k
    for key in ("critic_loss", "q_mean", "actor_loss", "priority_mean", "eval_return_mean"):
        check(key in row and row[key] == row[key] and abs(row[key]) != float("inf"),
              f"{phase}: {key} not finite: {row.get(key)}")
    expect = dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0)
    check(launches == expect, f"{phase}: launch counts {launches}, expected {expect}")
    check(trainer.grad_steps == n, f"{phase}: {trainer.grad_steps} grad steps")
    check(applied == dispatches and flusher["thread_stopped"] and flusher["queue_gone"]
          and flusher["idle"] and not flusher["lagged_pending"],
          f"{phase}: flusher {flusher} for {dispatches} dispatches")
    check(n_guarded == dispatches - 1,
          f"{phase}: {n_guarded} of {dispatches} dispatches under the sync guard")
    max_priority = trainer.buffer._max_priority
    check(max_priority > 1.0, f"{phase}: max_priority {max_priority} did not move off 1.0")
    a = trainer.config.agent
    emit({
        "phase": phase,
        "placement": placement,
        "card": card,
        "width": {"hidden": list(a.hidden_sizes), "atoms": a.dist.num_atoms,
                  "batch": trainer.config.batch_size, "num_envs": trainer.config.num_envs,
                  "n_step": a.n_step, "prioritized": True,
                  "replay_capacity": trainer.config.replay_capacity, "steps_per_dispatch": k},
        "tree_backend": backend,
        "prefetch": trainer.config.prefetch,
        "prefetch_ignored_declared": declared,
        "grad_steps": n,
        "dispatches": dispatches,
        "sync_guard_dispatches": n_guarded,
        "flusher": flusher,
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
        "stage_ms_per_step": stage_ms_per_step(stages, n),
        "stages": stages,
        "steady_state": busy,
        "ok": True,
    })
    return launches


def prefetch_first_step(Trainer, TrainConfig, card: str, log_dir: str) -> None:
    """Two trainers from one seed, prefetch on and off, one dispatch each:
    the first step's metrics and every tensor of the learner state must be
    ``torch.equal`` (the reference's ``test_prefetch.py`` first-dispatch
    check, exact on the card)."""
    import torch

    rows, states = [], []
    for prefetch in (False, True):
        cfg = TrainConfig(env="pendulum", total_steps=1, warmup_steps=1000, eval_interval=1,
                          eval_episodes=1, log_dir=f"{log_dir}/first_{prefetch}", seed=SEED,
                          tree_backend="numpy", prefetch=prefetch)
        trainer = Trainer(cfg, device="cuda")
        try:
            rows.append(trainer.train())
            torch.cuda.synchronize()
            states.append(dict(state_tensors(trainer.state)))
        finally:
            trainer.close()
    keys = ("critic_loss", "actor_loss", "priority_mean", "q_mean")
    check(all(rows[0][key] == rows[1][key] for key in keys),
          f"prefetch_first_step: metrics differ: {[{key: r[key] for key in keys} for r in rows]}")
    check(states[0].keys() == states[1].keys(), "prefetch_first_step: state tensor sets differ")
    differ = [name for name, x in states[0].items() if not torch.equal(x, states[1][name])]
    check(not differ, f"prefetch_first_step: state tensors differ: {differ}")
    emit({"phase": "prefetch_first_step", "card": card, "torch_equal": True,
          "tensors_compared": len(states[0]), "critic_loss": rows[0]["critic_loss"], "ok": True})


def ingest_prefetch_pair(Trainer, TrainConfig, card: str, log_dir: str) -> dict:
    """The fused-descent device learner, ``ingest_prefetch`` on and off,
    same seed, INGEST_PAIR_STEPS grad steps each: the final learners
    (params, Adam moments, ring, tree) must be ``torch.equal``. Returns each
    run's launch counts by path name."""
    import torch

    n, out, learners, staged = INGEST_PAIR_STEPS, {}, {}, {}
    info = {}
    for on in (True, False):
        cfg = TrainConfig(env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n,
                          eval_episodes=2, log_dir=f"{log_dir}/ingest_{on}", seed=SEED,
                          replay_placement="device", steps_per_dispatch=K, prioritized=True,
                          fused_descent=True, debug_guards=True, ingest_prefetch=on)
        trainer = Trainer(cfg, device="cuda")
        chunks = []
        stage = trainer._ring_sync.stage

        def counting_stage(ring, stage=stage, chunks=chunks):
            got = stage(ring)
            chunks.append(got)
            return got

        trainer._ring_sync.stage = counting_stage
        try:
            reset_counts()
            row = trainer.train()
            torch.cuda.synchronize()
            launches = read_counts()
        finally:
            trainer.close()
        stages = trainer.timers.scalars()
        dispatches = n // K
        expect = dict(fused_fwd=0, fused_bwd=n, project=0, tree_count=dispatches, fused_step=n)
        check(launches == expect, f"ingest_prefetch={on}: launch counts {launches}, expected {expect}")
        check(stages["stage_ingest_stage_calls"] == (dispatches if on else 0),
              f"ingest_prefetch={on}: {stages['stage_ingest_stage_calls']} ingest_stage calls")
        for key in ("critic_loss", "q_mean", "priority_mean"):
            check(row[key] == row[key] and abs(row[key]) != float("inf"),
                  f"ingest_prefetch={on}: {key} not finite")
        name = f"device_ingest_prefetch_{'on' if on else 'off'}"
        out[name] = launches
        learners[on] = learner_of(trainer)
        staged[on] = sum(chunks)
        info[name] = {"grad_steps_per_sec": row["grad_steps_per_sec"],
                      "stage_ingest_stage_calls": stages["stage_ingest_stage_calls"],
                      "stage_ms_per_step": stage_ms_per_step(stages, n),
                      "chunks_staged": staged[on], "chunks_ingested": trainer._ring_sync.chunks_ingested,
                      "launches": launches}
    same = compare_learners(learners[True], learners[False])
    check(not same["differ"], f"ingest_prefetch pair: final learners differ: {same}")
    emit({"phase": "device_ingest_prefetch_pair", "card": card, "grad_steps": n,
          "torch_equal": True, "tensors_compared": same["compared"], "runs": info,
          "chunks_staged_predicted": 0, "ok": True})
    return out


def trace_events(prof, path: str) -> list:
    """The events of a finished ``torch.profiler`` session, via its Chrome
    trace (which carries each device event's stream)."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def ingest_stage_phase(card: str, log_dir: str) -> None:
    """``DeviceRingSync.stage`` driven directly on a 1M-row ring with the
    device tree hooked, against a twin that flushes with no stage, from the
    same host adds. Round 1: a fused-descent megastep dispatch is in flight
    on the ring (with a tree of its own) while a chunk is staged; more rows
    arrive; both flush. Round 2: a chunk is staged, then enough rows to
    wrap the ring overwrite every staged slot before the flush. After each
    round the ring's fields and the tree must be ``torch.equal`` to the
    twin's, and round 1's profiler trace must put the staged chunk's
    host-to-device copies on a stream the megastep's kernels do not use."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from d4pg_tpu_torch.agent import create_train_state
    from d4pg_tpu_torch.config import TrainConfig, apply_env_preset
    from d4pg_tpu_torch.replay import ReplayBuffer, Transition
    from d4pg_tpu_torch.replay.device_per import DevicePerSync
    from d4pg_tpu_torch.replay.device_ring import DeviceRingSync, device_ring_init
    from d4pg_tpu_torch.runtime import megastep

    agent = apply_env_preset(TrainConfig()).agent
    cap = apply_env_preset(TrainConfig()).replay_capacity
    rng = np.random.default_rng(SEED + 20)

    def rows(n):
        return Transition(rng.normal(size=(n, 3)).astype(np.float32),
                          rng.uniform(-1, 1, (n, 1)).astype(np.float32),
                          rng.uniform(-16, 0, n).astype(np.float32),
                          rng.normal(size=(n, 3)).astype(np.float32),
                          np.full(n, 0.99**3, np.float32))

    sides = []
    for _ in range(2):  # [staged, twin]
        buf = ReplayBuffer(cap, 3, 1)
        sync = DeviceRingSync(buf)
        dps = DevicePerSync(cap, agent.per_alpha, device="cuda")
        sync.tree_hook = dps.on_chunk
        sides.append((buf, sync, device_ring_init(cap, 3, 1, "cuda"), dps))

    def add(n):
        t = rows(n)
        for buf, *_ in sides:
            buf.add_batch(t)

    def flush_both():
        for _, sync, ring, _ in sides:
            sync.flush(ring)

    def compare(what):
        (_, _, ra, da), (_, _, rb, db) = sides
        torch.cuda.synchronize()
        differ = [k for k in ("obs", "action", "reward", "next_obs", "discount", "size")
                  if not torch.equal(getattr(ra, k), getattr(rb, k))]
        differ += [k for k in ("sums", "max_priority")
                   if not torch.equal(getattr(da.tree, k), getattr(db.tree, k))]
        check(not differ, f"ingest_stage {what}: staged and plain mirrors differ in {differ}")

    add(cap - 2000)
    flush_both()
    buf_a, sync_a, ring_a, dps_a = sides[0]
    state = create_train_state(agent, SEED, "cuda")
    step = megastep.make_megastep_device_per_fused(agent, K, 256)
    tree_c = copy.deepcopy(dps_a.tree)  # the in-flight dispatch's own tree
    gen = torch.Generator("cuda").manual_seed(SEED)
    step(state, ring_a, tree_c, gen)  # builds and loads the kernels
    torch.cuda.synchronize()

    # Round 1: 4000 rows (wrapping at slot 1M) staged under a dispatch.
    add(4000)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, ring_a, tree_c, gen)
        t0 = time.perf_counter()
        staged = sync_a.stage(ring_a)
        stage_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    check(staged and sync_a._staged is not None, "ingest_stage: nothing staged")
    events = trace_events(prof, f"{log_dir}/ingest_stage.json")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    h2d = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    kernel_streams = sorted({e["args"]["stream"] for e in kernels})
    copy_streams = sorted({e["args"]["stream"] for e in h2d})
    # the staged chunk is six copies (five fields and the slots); any copy
    # on a kernel stream is the dispatch's own
    staged_copies = [e for e in h2d if e["args"]["stream"] not in kernel_streams]
    check(kernels and len(staged_copies) >= 6,
          f"ingest_stage: {len(kernels)} kernels on streams {kernel_streams}; HtoD copies on "
          f"streams {copy_streams}, {len(staged_copies)} of them off the kernels' streams")
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in kernels]
    overlapped = sum(any(s < c1 and c0 < e for s, e in spans)
                     for c0, c1 in ((c["ts"], c["ts"] + c["dur"]) for c in staged_copies))
    add(1500)
    flush_both()
    compare("round 1")

    # Round 2: stage 3000 rows, then wrap the ring over every staged slot.
    add(3000)
    check(sync_a.stage(ring_a), "ingest_stage: round 2 staged nothing")
    add(cap - 1000)
    flush_both()
    compare("round 2 (overwrites across the wrap)")
    emit({"phase": "ingest_stage", "card": card, "ring_rows": cap,
          "tree_leaves": dps_a.tree.sums.shape[0] // 2, "torch_equal": True,
          "h2d_copies_traced": len(h2d), "staged_copies": len(staged_copies),
          "copy_streams": copy_streams,
          "kernel_streams": kernel_streams, "copies_overlapping_a_kernel": overlapped,
          "stage_host_ms": stage_s * 1e3, "chunks_ingested": sync_a.chunks_ingested,
          "twin_chunks_ingested": sides[1][1].chunks_ingested, "ok": True})


PROFILE_RANGES = ("host/sample", "host/h2d_stage", "host/train_dispatch", "host/prefetch",
                  "host/priority_writeback")


def profile_phase(Trainer, TrainConfig, card: str, log_dir: str) -> None:
    """Host K = 8 on the native tree with ``prefetch``, the write-back
    thread and ``profile_dir``: the trace of grad steps [16, 64) must exist
    and hold the five ``host/*`` ranges and B1f's and B1b's launches. Prints
    the window's host ms a grad step per range and device ms a grad step
    per kernel name."""
    import collections
    import dataclasses
    import glob
    import os

    from d4pg_tpu_torch.agent.state import D4PGConfig

    trace_dir = f"{log_dir}/trace"
    cfg = TrainConfig(
        env="pendulum", total_steps=PROFILE_STEPS, warmup_steps=1000, eval_interval=PROFILE_STEPS,
        eval_episodes=2, log_dir=f"{log_dir}/profile", seed=SEED, steps_per_dispatch=K,
        prioritized=True, tree_backend="native", prefetch=True, async_priority_writeback=True,
        profile_dir=trace_dir, agent=dataclasses.replace(D4PGConfig(), projection_backend="fused"),
    )
    trainer = Trainer(cfg, device="cuda")
    try:
        trainer.train()
    finally:
        trainer.close()
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    check(len(files) == 1, f"profile: {len(files)} trace files in {trace_dir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    # the trace runs from the first dispatch boundary at or past grad step
    # 10 to the first at or past max(60, 10 + K): [16, 64) at K = 8
    window = -(-max(60, 10 + K) // K) * K - -(-10 // K) * K
    host = collections.defaultdict(float)
    threads = collections.defaultdict(set)
    for e in events:
        if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("host/"):
            host[e["name"]] += e.get("dur", 0) / 1e3 / window
            threads[e["name"]].add(e.get("tid"))
    device = collections.defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            device[e["name"]] += e.get("dur", 0) / 1e3 / window
    # The loop thread's window: the span of its host/* ranges, the part
    # inside them (nested ranges counted once) and the rest; and the union
    # of the device's work over the same window.
    loop_tid = next(iter(threads["host/train_dispatch"])) if threads["host/train_dispatch"] else None
    loop = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("tid") == loop_tid
            and str(e.get("name", "")).startswith("host/")]
    span = (max(t1 for _, t1 in loop) - min(t0 for t0, _ in loop)) / 1e3 if loop else 0.0
    busy = union_ms([(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS])
    loop_thread = {"span_ms_per_step": span / window,
                   "in_host_ranges_ms_per_step": union_ms(loop) / window,
                   "outside_host_ranges_ms_per_step": (span - union_ms(loop)) / window,
                   "device_busy_ms_per_step": busy / window,
                   "device_idle_share": 1.0 - busy / span if span else None}
    missing = [r for r in PROFILE_RANGES if r not in host]
    check(not missing, f"profile: ranges {missing} not in the trace")
    b1f = sum(v for k, v in device.items() if "fused_loss_fwd_kernel" in k)
    b1b = sum(v for k, v in device.items() if "fused_loss_bwd_kernel" in k)
    check(b1f > 0 and b1b > 0, f"profile: B1f {b1f} / B1b {b1b} device ms in the trace")
    launches = {name: sum(1 for e in events if e.get("cat") == "kernel" and name in e.get("name", ""))
                for name in ("fused_loss_fwd_kernel", "fused_loss_bwd_kernel")}
    check(all(v == window for v in launches.values()),
          f"profile: kernel launches {launches} in a window of {window} grad steps")
    top = dict(sorted(device.items(), key=lambda kv: -kv[1])[:12])
    emit({"phase": "profile", "card": card, "trace_bytes": os.path.getsize(files[0]),
          "window_grad_steps": window, "launches_in_window": launches,
          "host_ms_per_step": dict(host),
          "threads_per_range": {k: len(v) for k, v in threads.items()},
          "loop_thread": loop_thread,
          "device_ms_per_step_total": sum(device.values()),
          "device_ms_per_step_by_name": top, "ok": True})


PLANAR_ENVS = 128             # planar_step_parity's HalfCheetah batch
PLANAR_SETTLE = 10            # CPU control steps before the compared one
PLANAR_TIMED = 20             # timed control steps on the card
# planar_step_parity's tolerances, tests/test_torch_locomotion.py's: 20
# substeps of stiff penalty contacts amplify the ulp differences of the
# card's and the CPU's cos, sin, sums and LU solve
PLANAR_Q_ATOL, PLANAR_QD_ATOL, PLANAR_R_ATOL = 1e-5, 5e-4, 1e-4
# the eval episode's length in on_device_halfcheetah and on_device_humanoid:
# a depth cut of the envs' 1000 steps (the evals took 70-73 % of those
# phases, PERF.md section 5); their training rolls 64-128 steps an env,
# which no limit of 250 truncates
ON_DEVICE_EVAL_STEPS = 250
# train iterations a phase; pendulum_bf16 is bf16_wire's on-device leg
ON_DEVICE_ITERS = {"pendulum": 2, "halfcheetah": 1, "hopper_twin": 1, "pendulum_bf16": 1,
                   "humanoid": 1, "pixel_pendulum": 1}


def planar_step_parity(card: str) -> dict:
    """One HalfCheetah control step (20 substeps) of 128 seeded states on
    the card against the same step on the CPU. The states come from a
    seeded reset and ``PLANAR_SETTLE`` CPU steps under seeded random
    actions, so most rows touch the ground. Also the card's wall ms of one
    control step for the 128 envs (median of ``PLANAR_TIMED`` synchronized
    steps) and the kernels one step launches (a ``torch.profiler`` trace)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from d4pg_tpu_torch.envs import EnvState, HalfCheetah
    from d4pg_tpu_torch.envs import planar

    env = HalfCheetah()
    gen = torch.Generator().manual_seed(SEED)
    state, _ = env.reset(PLANAR_ENVS, gen)
    for _ in range(PLANAR_SETTLE):
        a = 2.0 * torch.rand((PLANAR_ENVS, env.action_dim), generator=gen) - 1.0
        state = env.step(state, a)[0]
    action = 2.4 * torch.rand((PLANAR_ENVS, env.action_dim), generator=gen) - 1.2
    q = state.physics[:, :env.nq]
    pen = env.model.con_radius - planar.contact_points(env.model, q)[..., 1].numpy()
    contact_rows = int((pen > 0).any(axis=1).sum())
    cpu = env.step(state, action)
    dev_state = EnvState(state.physics.cuda(), state.t.cuda())
    card_out = env.step(dev_state, action.cuda())
    nq = env.nq
    err = {
        "q": (card_out[0].physics[:, :nq].cpu() - cpu[0].physics[:, :nq]).abs().max().item(),
        "qd": (card_out[0].physics[:, nq:].cpu() - cpu[0].physics[:, nq:]).abs().max().item(),
        "obs": (card_out[1].cpu() - cpu[1]).abs().max().item(),
        "reward": (card_out[2].cpu() - cpu[2]).abs().max().item(),
    }
    flags_equal = all(torch.equal(c.cpu(), h) for c, h in zip(card_out[3:], cpu[3:]))
    times = []
    for i in range(PLANAR_TIMED + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_state = env.step(dev_state, action.cuda())[0]
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        env.step(dev_state, action.cuda())
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        kernels = sum(1 for e in trace_events(prof, f"{tmp}/step.json") if e.get("cat") == "kernel")
    check(err["q"] <= PLANAR_Q_ATOL and err["qd"] <= PLANAR_QD_ATOL and err["obs"] <= PLANAR_QD_ATOL
          and err["reward"] <= PLANAR_R_ATOL and flags_equal,
          f"planar_step_parity: card vs CPU {err}, flags equal {flags_equal}")
    out = {"phase": "planar_step_parity", "card": card, "envs": PLANAR_ENVS,
           "substeps": env.n_substeps, "contact_rows": contact_rows,
           "max_abs_err": err, "tolerance": {"q": PLANAR_Q_ATOL, "qd_and_obs": PLANAR_QD_ATOL,
                                             "reward": PLANAR_R_ATOL},
           "terminated_truncated_equal": flags_equal,
           "control_step_wall_ms_median": statistics.median(times),
           "control_step_wall_ms_min": min(times),
           "kernels_per_control_step": kernels, "ok": True}
    emit(out)
    return out


SPATIAL_ENVS = 64              # spatial_step_parity's batch (the Humanoid recipe's envs)
SPATIAL_SETTLE = 15           # CPU control steps before the compared one
SPATIAL_TIMED = 20            # timed control steps on the card
# spatial_step_parity's tolerances: tests/test_torch_spatial_envs.py's for
# v, obs and reward (10 or 20 substeps of stiff penalty contacts, where
# each float32 engine lies ~1e-3 from a float64 run on a deep contact
# row); q atol 5e-5, not the test's 1e-5, because on Ant's contact rows
# each float32 engine lies up to 7.9e-6 from a float64 run
# (tests/test_torch_spatial.py), and the card's sin, cos, sums and LU
# solve are another float32 engine (1.46e-05 measured on the H100)
SPATIAL_Q_ATOL, SPATIAL_V_ATOL, SPATIAL_R_ATOL = 5e-5, 5e-3, 1e-3
SPATIAL_QUAT_ATOL = 1e-6      # |root quaternion| - 1 after the step


def spatial_step_parity(card: str, env_name: str) -> dict:
    """One Humanoid or Ant control step (10 or 20 substeps of the 3D
    engine) of 64 seeded states on the card against the same step on the
    CPU. The states come from a seeded reset and ``SPATIAL_SETTLE`` CPU
    steps under seeded random actions (rows that terminate are reset, as
    the rollout resets them), so most rows touch the ground. q, v, obs and
    reward within the stated tolerances, the root quaternions unit,
    terminated and truncated equal (and the rows whose state blows up the
    same on both); the rows in contact at the start and at any substep of
    the step; the card's wall ms of one control step for the 64 envs
    (median of ``SPATIAL_TIMED`` synchronized steps), the kernels one step
    launches and their device ms (a ``torch.profiler`` trace). No hand
    kernel launches in this phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from d4pg_tpu_torch.envs import EnvState, make_env
    from d4pg_tpu_torch.envs import spatial

    reset_counts()
    env = make_env(env_name)
    gen = torch.Generator().manual_seed(SEED)
    state, obs = env.reset(SPATIAL_ENVS, gen)
    for _ in range(SPATIAL_SETTLE):
        a = 2.0 * torch.rand((SPATIAL_ENVS, env.action_dim), generator=gen) - 1.0
        state, obs, _, term, trunc = env.step(state, a)
        state, obs = env.reset_where(state, obs, torch.maximum(term, trunc), gen)
    action = 2.4 * torch.rand((SPATIAL_ENVS, env.action_dim), generator=gen) - 1.2
    # rows in ground contact at the start, and at any substep of the step
    radius = torch.as_tensor(env.model.con_radius, dtype=torch.float32)
    q, v = state.physics[:, :env.nq], state.physics[:, env.nq:]
    ctrl = action.clamp(-1.0, 1.0) * torch.as_tensor(env.model.ctrl_hi, dtype=torch.float32)
    touched = []
    for _ in range(env.n_substeps):
        touched.append(((radius - spatial.contact_points(env.model, q)[..., 2]) > 0).any(-1))
        q, v = spatial.step_physics(env.model, q, v, ctrl, 1, env.substep_dt)
    contact_rows = int(touched[0].sum())
    contact_rows_in_step = int(torch.stack(touched).any(0).sum())
    cpu = env.step(state, action)
    dev_state = EnvState(state.physics.cuda(), state.t.cuda())
    card_out = env.step(dev_state, action.cuda())
    nq = env.nq
    # a row whose state blows up (a non-finite value or |v| >= 1e4, the
    # envs' guard; it happens in the JAX package too) must blow up on both
    # devices, where the guard terminates it with reward 0; the others are
    # compared
    def sane(physics):
        return torch.isfinite(physics).all(-1) & (physics[:, nq:].abs().amax(-1) < 1e4)

    finite = sane(cpu[0].physics)
    same_blowups = torch.equal(sane(card_out[0].physics.cpu()), finite)
    card_phys = card_out[0].physics.cpu()[finite]
    cpu_phys = cpu[0].physics[finite]
    err = {
        "q": (card_phys[:, :nq] - cpu_phys[:, :nq]).abs().max().item(),
        "v": (card_phys[:, nq:] - cpu_phys[:, nq:]).abs().max().item(),
        "obs": (card_out[1].cpu()[finite] - cpu[1][finite]).abs().max().item(),
        "reward": (card_out[2].cpu() - cpu[2]).abs().max().item(),
    }
    quat_err = (torch.linalg.vector_norm(card_phys[:, 3:7], dim=-1) - 1.0).abs().max().item()
    flags_equal = same_blowups and all(
        torch.equal(c.cpu(), h) for c, h in zip(card_out[3:], cpu[3:]))
    times = []
    for i in range(SPATIAL_TIMED + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_state = env.step(dev_state, action.cuda())[0]
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        env.step(dev_state, action.cuda())
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        step_k = [e for e in trace_events(prof, f"{tmp}/step.json") if e.get("cat") == "kernel"]
    launches = read_counts()
    phase = f"spatial_step_parity_{env_name}"
    check(err["q"] <= SPATIAL_Q_ATOL and err["v"] <= SPATIAL_V_ATOL and err["obs"] <= SPATIAL_V_ATOL
          and err["reward"] <= SPATIAL_R_ATOL and quat_err <= SPATIAL_QUAT_ATOL and flags_equal,
          f"{phase}: card vs CPU {err}, quaternion norm error {quat_err}, flags equal {flags_equal}")
    check(not any(launches.values()), f"{phase}: hand kernels launched {launches}")
    out = {"phase": "spatial_step_parity", "env": env_name, "card": card, "envs": SPATIAL_ENVS,
           "nq": env.nq, "nv": env.nv, "substeps": env.n_substeps, "contact_rows": contact_rows,
           "contact_rows_in_step": contact_rows_in_step, "terminated_rows": int(cpu[3].sum()),
           "nonfinite_rows": int((~finite).sum()), "max_abs_err": err,
           "quat_norm_max_abs_err": quat_err,
           "tolerance": {"q": SPATIAL_Q_ATOL, "v_and_obs": SPATIAL_V_ATOL,
                         "reward": SPATIAL_R_ATOL, "quat_norm": SPATIAL_QUAT_ATOL},
           "terminated_truncated_equal": flags_equal,
           "control_step_wall_ms_median": statistics.median(times),
           "control_step_wall_ms_min": min(times),
           "kernels_per_control_step": len(step_k),
           "kernels_per_substep": len(step_k) / env.n_substeps,
           # the kernels of one control step run one after another on one
           # stream: their summed durations are its device time
           "control_step_device_ms": sum(e["dur"] for e in step_k) / 1e3,
           "launches": launches, "ok": True}
    emit(out)
    return out


def on_device_config(TrainConfig, env_name: str, log_dir: str):
    """The on-device phases' configurations. Pendulum: the default width
    (3x256, 51 atoms, B = 256, 16 envs x 32 steps: K = 512), n-step 3, PER,
    one warmup segment, 2 train iterations. HalfCheetah: the README's
    command (128 envs, n-step 5, support [-100, 1500], a 2^20-row ring,
    PER, default widths: K = 4096), one warmup segment, one train
    iteration, one eval episode of ON_DEVICE_EVAL_STEPS (250) steps.
    Hopper twin: the twin arm of
    ``runs/hopper_ondevice_tpu_r3/NOTES.md`` (64 envs, n-step 3, PER,
    [0, 500], ``twin_critic``: K = 2048), one warmup segment, one train
    iteration, one eval episode. Pendulum bf16 (``bf16_wire``'s on-device
    leg): Pendulum's configuration with ``compute_dtype`` and
    ``ring_dtype`` bfloat16, one train iteration. Humanoid: the README's
    on-device recipe (``runs/humanoid_ondevice_v1500/NOTES.md``: 64 envs, a
    2^19-row ring, n-step 3, PER, [0, 1500], noise 1.0 -> 0.1 over 2M env
    steps; K = 2048), one warmup segment, one train iteration, one eval
    episode of ON_DEVICE_EVAL_STEPS (250) steps, not the env's 1000.
    Pixel pendulum: the preset's
    width (48x48x2 frames through the conv encoder, 3x256, B = 256) with
    the uint8 ring at the preset's 100 000 rows, rounded down to a multiple
    of 16 envs x 32 steps as the JAX ``run_on_device`` rounds (99 840
    rows, 0.92 GB of obs and next_obs), n-step 3, PER: K = 512, one warmup segment, one
    train iteration, one eval of 10 episodes. Depth is the only cut."""
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.models.critic import DistConfig

    if env_name in ("pendulum", "pendulum_bf16"):
        k = 16 * 32
        bf16 = env_name == "pendulum_bf16"
        return TrainConfig(env="pendulum", num_envs=16, n_step=3, warmup_steps=k,
                           total_steps=ON_DEVICE_ITERS[env_name] * k,
                           eval_interval=ON_DEVICE_ITERS[env_name] * k, eval_episodes=10,
                           log_dir=log_dir, seed=SEED, debug_guards=True,
                           ring_dtype="bfloat16" if bf16 else "auto",
                           agent=D4PGConfig(compute_dtype="bfloat16" if bf16 else "float32"))
    if env_name == "pixel_pendulum":
        k = 16 * 32
        return TrainConfig(env="pixel_pendulum", num_envs=16, n_step=3, warmup_steps=k,
                           total_steps=ON_DEVICE_ITERS[env_name] * k,
                           eval_interval=ON_DEVICE_ITERS[env_name] * k, eval_episodes=10,
                           log_dir=log_dir, seed=SEED, debug_guards=True)
    if env_name == "hopper_twin":
        # runs/hopper_ondevice_tpu_r3/NOTES.md's twin arm: 64 envs, PER,
        # C51 over the preset's [0, 500], n-step 3, noise 1.0 -> 0.15 over
        # 2M env steps, lr 1e-4, tau 1e-3, --twin-critic; K = 2048
        k = 64 * 32
        return TrainConfig(env="hopper", num_envs=64, n_step=3,
                           total_steps=ON_DEVICE_ITERS[env_name] * k,
                           eval_interval=ON_DEVICE_ITERS[env_name] * k, eval_episodes=1,
                           agent=D4PGConfig(twin_critic=True, noise_decay_steps=2_000_000,
                                            noise_scale_final=0.15),
                           log_dir=log_dir, seed=SEED, debug_guards=True)
    if env_name == "humanoid":
        k = 64 * 32
        return TrainConfig(env="humanoid", num_envs=64, n_step=3, replay_capacity=524_288,
                           max_episode_steps=ON_DEVICE_EVAL_STEPS,
                           total_steps=ON_DEVICE_ITERS[env_name] * k,
                           eval_interval=ON_DEVICE_ITERS[env_name] * k, eval_episodes=1,
                           agent=D4PGConfig(dist=DistConfig(v_min=0.0, v_max=1500.0),
                                            noise_decay_steps=2_000_000, noise_scale_final=0.1),
                           log_dir=log_dir, seed=SEED, debug_guards=True)
    k = 128 * 32
    return TrainConfig(env="halfcheetah", num_envs=128, n_step=5, replay_capacity=1_048_576,
                       max_episode_steps=ON_DEVICE_EVAL_STEPS,
                       total_steps=ON_DEVICE_ITERS["halfcheetah"] * k,
                       eval_interval=ON_DEVICE_ITERS["halfcheetah"] * k, eval_episodes=1,
                       agent=D4PGConfig(dist=DistConfig(v_min=-100.0, v_max=1500.0)),
                       log_dir=log_dir, seed=SEED, debug_guards=True)


def on_device_phase(TrainConfig, env_name: str, card: str, log_dir: str) -> dict:
    """``OnDeviceRun`` (what ``train --on-device`` runs) at full width on
    the card: exact launch counts (B1f and B1b K times a train iteration,
    B2, B3 and B4 never), finite metrics, the ring's fill equal to the rows
    appended, and every train iteration after the first under
    ``set_sync_debug_mode("error")``. Then, past the counts, one segment
    alone and one more train iteration (under the guard and a
    ``torch.profiler`` trace of the device only): their wall ms, and the
    iteration's device busy ms (the union of kernel, copy and memset
    intervals) and idle share."""
    import math
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from d4pg_tpu_torch.runtime.on_device import OnDeviceRun
    from d4pg_tpu_torch.runtime.trainer import _sync_debug_error

    phase = f"on_device_{env_name}"
    iters = ON_DEVICE_ITERS[env_name]
    run = OnDeviceRun(on_device_config(TrainConfig, env_name, log_dir), device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    row = run.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    k = run.K
    expect = dict(fused_fwd=k * iters, fused_bwd=k * iters, project=0, tree_count=0, fused_step=0)
    check(launches == expect, f"{phase}: launch counts {launches}, expected {expect}")
    check(run.iterations == iters and run.grad_steps == k * iters,
          f"{phase}: {run.iterations} iterations, {run.grad_steps} grad steps")
    check(run.guarded_iterations == iters - 1,
          f"{phase}: {run.guarded_iterations} of {iters} iterations under the sync guard")
    filled = min(run.rows_appended, run.capacity)
    check(run.carry.replay.size == filled == row["replay_size"],
          f"{phase}: ring size {run.carry.replay.size}, row {row['replay_size']}, appended {filled}")
    check(all(isinstance(v, float) and math.isfinite(v) for v in row.values()
              if not isinstance(v, int)), f"{phase}: metrics not finite: {row}")
    max_priority = float(run.carry.replay.max_priority)
    check(max_priority > 1.0, f"{phase}: max_priority {max_priority} did not move off 1.0")

    scale = run._noise_scale()
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    run.carry = run.warmup_fn(run.carry, scale)
    torch.cuda.synchronize()
    segment_ms = (time.perf_counter() - s0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        i0 = time.perf_counter()
        with _sync_debug_error():
            run.carry, _ = run.iterate_fn(run.carry, scale)
        torch.cuda.synchronize()
        iteration_ms = (time.perf_counter() - i0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        events = trace_events(prof, f"{tmp}/iteration.json")
    device = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS]
    busy = union_ms(device)
    b1f_traced = sum(1 for e in events if e.get("cat") == "kernel"
                     and "fused_loss_fwd_kernel" in e.get("name", ""))
    a = run.config.agent
    ring_dtype = (torch.uint8 if a.pixel_shape else
                  torch.bfloat16 if run.config.ring_dtype == "bfloat16" else torch.float32)
    check(run.carry.replay.obs.dtype == run.carry.replay.next_obs.dtype == ring_dtype,
          f"{phase}: ring obs dtype {run.carry.replay.obs.dtype}, expected {ring_dtype}")
    out = {
        "phase": phase, "card": card,
        "width": {"hidden": list(a.hidden_sizes), "atoms": a.dist.num_atoms,
                  "twin_critic": a.twin_critic, "compute_dtype": a.compute_dtype,
                  "ring_obs_dtype": str(ring_dtype),
                  "ring_obs_bytes": run.carry.replay.obs.nbytes + run.carry.replay.next_obs.nbytes,
                  "pixel_shape": list(a.pixel_shape) if a.pixel_shape else None,
                  "support": [a.dist.v_min, a.dist.v_max], "batch": run.config.batch_size,
                  "num_envs": run.config.num_envs, "segment_len": 32, "n_step": a.n_step,
                  "prioritized": run.config.prioritized, "replay_capacity": run.capacity,
                  "grad_steps_per_iteration": k, "eval_episodes": run.config.eval_episodes,
                  "max_episode_steps": run.config.max_episode_steps},
        "train_iterations": iters, "grad_steps": run.grad_steps,
        "sync_guard": f"set_sync_debug_mode('error') on {run.guarded_iterations} of {iters} "
                      "train iterations (all after the first) and on the traced one",
        "rows_appended": run.rows_appended, "replay_size": row["replay_size"],
        "wall_s_incl_warmup_and_eval": wall,
        # host seconds of the run's warmup segments and evals (an eval
        # reads back, so its time is the device's too)
        "warmup_s": run.warmup_s, "eval_s": run.eval_s,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "env_steps_per_sec": row["env_steps_per_sec"],
        "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
        "priority_mean": row["priority_mean"], "eval_return_mean": row["eval_return_mean"],
        "train_reward_per_episode_boundary": row["train_reward_per_episode_boundary"],
        "max_priority": max_priority, "launches": launches,
        "steady_state": {"segment_wall_ms": segment_ms,
                         "iteration_wall_ms_traced": iteration_ms,
                         "iteration_device_busy_ms": busy,
                         "iteration_device_idle_share": 1.0 - busy / iteration_ms,
                         "device_events": len(device), "b1f_launches_in_trace": b1f_traced,
                         "trace_complete": b1f_traced == k},
        "ok": True,
    }
    emit(out)
    return launches


# ----------------------------------------------------------- stacked critics
STACKED_E = (2, 10)                  # twin, and the REDQ paper's ensemble
STACKED_B = (1, 7, 256, 2048)        # ragged rows and the large-batch recipe's B
STACKED_A = (51, 101)
STACKED_B4_B = (256, 2048)
LARGE_BATCH_STEPS = 200              # grad steps of the large_batch phase
WIRE_STEPS = 200                     # host K = 1 grad steps of bf16_wire
# The card's bf16 products against the CPU's: both accumulate in float32
# and round once to bf16 (8 significant bits), so a product or a bias add
# lands at most one bf16 ulp (2^-7 of its value) apart when the two float32
# sums straddle a rounding boundary; two roundings a layer over the
# critic's four layers at full width: 8 ulps of the layer's scale.
BF16_REL_FULL = 8 * 2.0**-7


def stacked_inputs(E: int, B: int, A: int, support, gen, device):
    """``make_inputs``'s target rows (terminal and clipping rows) with
    stacked logits q [E, B, A] and cotangents g_ce, g_ov [E, B]."""
    import torch

    _, p, r, d, _, _ = make_inputs(B, A, support, gen, device)
    q = 2.0 * torch.randn((E, B, A), generator=gen, device=device)
    g_ce = torch.rand((E, B), generator=gen, device=device) + 0.5
    g_ov = torch.rand((E, B), generator=gen, device=device) - 0.5
    return q, p, r, d, g_ce, g_ov


def stacked_kernel_phase(cp, cuda_tree, cfs, dper, make_support, floor: float):
    """B1f, B1b and B4 over E stacked members in one launch: each against
    its plain version and ``torch.equal`` to E single-member launches (B4:
    ce/ov to stacked B1f, idx to B3); then, at E = 10, B = 2048, A = 51,
    the stacked launch's device time, its plain version's, E separate
    launches' and the bound at E x B rows."""
    import torch

    device = torch.device("cuda")
    gen = torch.Generator(device).manual_seed(SEED + 20)
    err = {"c51_fused_loss_fwd": 0.0, "c51_fused_loss_bwd": 0.0, "c51_fused_step": 0.0}
    over = []
    for A in STACKED_A:
        for sname, (lo, hi) in (("pendulum", (-300.0, 0.0)), ("sym10", (-10.0, 10.0))):
            support = make_support(lo, hi, A)
            for E in STACKED_E:
                for B in STACKED_B:
                    case = f"E={E} B={B} A={A} support={sname}"
                    q, p, r, d, g_ce, g_ov = stacked_inputs(E, B, A, support, gen, device)
                    ce, ov = cp.fused_loss_fwd(support, q, p, r, d)
                    dq = cp.fused_loss_bwd(support, q, p, r, d, g_ce, g_ov)
                    singles = [cp.fused_loss_fwd(support, q[e], p, r, d) for e in range(E)]
                    dq1 = [cp.fused_loss_bwd(support, q[e], p, r, d, g_ce[e], g_ov[e])
                           for e in range(E)]
                    torch.cuda.synchronize()
                    check(ce.shape == (E, B) and dq.shape == (E, B, A), f"{case}: shapes")
                    check(torch.equal(ce, torch.stack([s[0] for s in singles]))
                          and torch.equal(ov, torch.stack([s[1] for s in singles])),
                          f"B1f {case}: stacked launch differs from {E} single launches")
                    check(torch.equal(dq, torch.stack(dq1)),
                          f"B1b {case}: stacked launch differs from {E} single launches")
                    pce, pov = cp.fused_loss_plain(support, q, p, r, d)
                    pdq = cp.fused_loss_bwd_plain(support, q, p, r, d, g_ce, g_ov)
                    for name, got, want in (("c51_fused_loss_fwd", ce, pce),
                                            ("c51_fused_loss_fwd", ov, pov),
                                            ("c51_fused_loss_bwd", dq, pdq)):
                        check(bool(torch.isfinite(got).all()), f"{name} {case}: non-finite")
                        e = float((got - want).abs().max())
                        err[name] = max(err[name], e)
                        if not torch.allclose(got, want, atol=ATOL, rtol=RTOL):
                            over.append({"kernel": name, "case": case, "max_abs_err": e})
            emit({"phase": "stacked_kernel", "case": f"B1f B1b A={A} support={sname} "
                  f"E={list(STACKED_E)} B={list(STACKED_B)}",
                  "equal_to_single_launches": True,
                  "max_abs_err": {k: err[k] for k in ("c51_fused_loss_fwd", "c51_fused_loss_bwd")},
                  "ok": not over})
    check(not over, f"stacked B1f/B1b: {len(over)} cases over tolerance: {over}")

    A, support = 51, make_support(-300.0, 0.0, 51)
    leaves = main_path_leaves(gen, device)
    total = leaves.sum()
    chain = cuda_tree.chain_length(TREE_L)
    b4_inputs = {}
    for E in STACKED_E:
        for B in STACKED_B4_B:
            case = f"B4 E={E} B={B} A={A} L=2^20"
            q, p, r, d, _, _ = stacked_inputs(E, B, A, support, gen, device)
            pre = dper.stratified_prefixes(
                torch.rand((1, B), generator=gen, device=device), 1, B, total).reshape(B)
            idx3, offsets = cuda_tree.find_prefix(leaves, pre)
            ce, ov, idx = cfs.fused_step_fwd(support, q, p, r, d, pre, leaves, offsets)
            ce1, ov1 = cp.fused_loss_fwd(support, q, p, r, d)
            torch.cuda.synchronize()
            check(ce.shape == (E, B) and idx.shape == (B,), f"{case}: shapes")
            check(torch.equal(ce, ce1) and torch.equal(ov, ov1), f"{case}: ce/ov differ from stacked B1f")
            check(torch.equal(idx, idx3), f"{case}: idx differs from B3")
            check(bool(valid_under_f64(leaves, pre, idx, chain).all()), f"{case}: invalid draws")
            pce, pov, _ = cfs.fused_step_plain(support, q, p, r, d, pre, leaves)
            for g, w in ((ce, pce), (ov, pov)):
                check(torch.allclose(g, w, atol=ATOL, rtol=RTOL), f"{case}: loss off the plain version")
                err["c51_fused_step"] = max(err["c51_fused_step"], float((g - w).abs().max()))
            emit({"phase": "stacked_kernel", "case": case, "equal_to_b1f_and_b3": True,
                  "max_abs_err": err["c51_fused_step"], "ok": True})
            b4_inputs[(E, B)] = (q, p, r, d, pre, offsets, idx)

    # timings at the large-batch recipe's shape: E = 10, B = 2048, A = 51
    E, B = STACKED_E[-1], STACKED_B4_B[-1]
    q, p, r, d, pre, offsets, idx = b4_inputs[(E, B)]
    g_ce = torch.rand((E, B), generator=gen, device=device) + 0.5
    g_ov = torch.rand((E, B), generator=gen, device=device) - 0.5
    f4, phi, n = 4, 16 * A, E * B
    needed = leaves_needed(idx, cuda_tree.CHUNK)
    walk = int((2 * (idx.long() % cuda_tree.CHUNK + 1) + 10).sum())
    loss_bytes = f4 * (n * A + B * A + 2 * B) + f4 * 2 * n  # q, shared p, r, d in; ce, ov out
    work = {
        "c51_fused_loss_fwd": (
            loss_bytes, n * (phi + 10 * A),
            lambda: cp.fused_loss_fwd(support, q, p, r, d),
            lambda: [cp.fused_loss_fwd(support, q[e], p, r, d) for e in range(E)],
            lambda: cp.fused_loss_plain(support, q, p, r, d)),
        "c51_fused_loss_bwd": (
            f4 * (n * A + B * A + 2 * B + 2 * n) + f4 * n * A, n * (phi + 14 * A),
            lambda: cp.fused_loss_bwd(support, q, p, r, d, g_ce, g_ov),
            lambda: [cp.fused_loss_bwd(support, q[e], p, r, d, g_ce[e], g_ov[e]) for e in range(E)],
            lambda: cp.fused_loss_bwd_plain(support, q, p, r, d, g_ce, g_ov)),
        "c51_fused_step": (
            loss_bytes + f4 * B + f4 * offsets.numel() + f4 * needed + f4 * B,
            n * (phi + 10 * A) + walk,
            lambda: cfs.fused_step_fwd(support, q, p, r, d, pre, leaves, offsets),
            lambda: [cfs.fused_step_fwd(support, q[e], p, r, d, pre, leaves, offsets)
                     for e in range(E)],
            lambda: cfs.fused_step_plain(support, q, p, r, d, pre, leaves)),
    }
    timing = {}
    for name, (nbytes, ops, kfn, sep, pfn) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        timing[name] = {
            "E": E, "B": B, "A": A,
            "ms": device_ms(kfn),
            "separate_ms": device_ms(sep, n=20),
            "plain_ms": device_ms(pfn, n=20),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "floor_ms": floor, "bytes": nbytes, "ops": ops,
        }
        emit({"phase": "kernel_time", "name": name, "stacked": True, **timing[name]})
    return err, timing


def stacked_step_parity(cfg_cls, create_train_state, train_step):
    """One full-width ``train_step`` on the card (kernels) against the CPU
    (plain versions), from the same initial weights, batch and REDQ subset:
    twin critics, a REDQ ensemble (E = 10, M = 2) and bfloat16 compute."""
    import dataclasses

    import numpy as np
    import torch

    from d4pg_tpu_torch.models.critic import DistConfig

    base = cfg_cls(dist=DistConfig(v_min=-300.0, v_max=0.0), n_step=3)
    arms = {
        "twin": dict(twin_critic=True),
        "redq_e10_m2": dict(critic_ensemble=10, ensemble_min_targets=2),
        "bf16": dict(compute_dtype="bfloat16"),
    }
    B = 256
    batch = step_batch(np.random.default_rng(SEED + 1), B)
    subset = torch.tensor([7, 2])  # the step's REDQ subset, fed to both devices
    for arm, kw in arms.items():
        agent = dataclasses.replace(base, **kw)
        out = {}
        for dev in ("cuda", "cpu"):
            state = create_train_state(agent, SEED, dev)
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            reset_counts()
            _, metrics, pri = train_step(agent, state, tb,
                                         subset=subset.to(dev) if agent.critic_ensemble else None)
            launches = read_counts()
            out[dev] = ({k: float(v) for k, v in metrics.items()}, pri.cpu().numpy(), launches)
        (mc, pc, lc), (mh, ph, lh) = out["cuda"], out["cpu"]
        check(all(np.isfinite(v) for v in mc.values()), f"{arm}: non-finite metrics {mc}")
        check(pc.shape == (B,), f"{arm}: priorities shape {pc.shape}")
        check(lc["fused_fwd"] == 1 and lc["fused_bwd"] == 1 and sum(lh.values()) == 0,
              f"{arm}: launches {lc} on the card, {lh} on the CPU")
        # float32: step_parity's tolerances; bf16: BF16_REL_FULL relative
        # (the loss and priorities), and q_mean read after one Adam step
        rel = BF16_REL_FULL if arm == "bf16" else 1e-4
        pri_err = float(np.abs(pc - ph).max())
        check(np.allclose(pc, ph, rtol=rel, atol=1e-4), f"{arm}: priorities differ by {pri_err:.3e}")
        check(abs(mc["critic_loss"] - mh["critic_loss"]) <= rel * abs(mh["critic_loss"]) + 1e-5,
              f"{arm}: critic_loss {mc['critic_loss']} vs {mh['critic_loss']}")
        check(abs(mc["q_mean"] - mh["q_mean"]) <= 0.3, f"{arm}: q_mean {mc['q_mean']} vs {mh['q_mean']}")
        emit({"phase": "stacked_step_parity", "arm": arm, "cuda": mc, "cpu": mh,
              "priority_max_abs_err": pri_err, "priority_rtol": rel, "launches_cuda": lc,
              "subset": subset.tolist() if agent.critic_ensemble else None, "ok": True})


def large_batch_phase(Trainer, TrainConfig, card: str, log_dir: str):
    """The large-batch recipe of ``docs/data_plane.md`` (device-PER
    learner, fused descent, ``--compute-dtype bfloat16 --steps-per-dispatch
    32 --batch-scale 8 --ingest-prefetch``: B = 2048, K = 4) with a REDQ
    ensemble (E = 10, M = 2) on top, at full width with a 1M-row ring:
    200 grad steps after the scaled warmup, every dispatch after the first
    under the sync guard, exact launches (B4 and B1b once a grad step, B1f
    never, B3 once a dispatch), finite metrics, ``max_priority`` off 1.0,
    then the steady state."""
    import torch

    from d4pg_tpu_torch.agent.state import D4PGConfig

    n = LARGE_BATCH_STEPS
    cfg = TrainConfig(
        env="pendulum", prioritized=True, replay_placement="device", fused_descent=True,
        ingest_prefetch=True, steps_per_dispatch=32, batch_scale=8, total_steps=n,
        eval_interval=n, eval_episodes=10, log_dir=log_dir, seed=SEED, debug_guards=True,
        agent=D4PGConfig(compute_dtype="bfloat16", critic_ensemble=10, ensemble_min_targets=2),
    )
    trainer = Trainer(cfg, device="cuda")
    c = trainer.config
    check((c.batch_size, c.steps_per_dispatch, c.warmup_steps) == (2048, 4, 8000),
          f"large_batch: the scaled recipe is B={c.batch_size}, K={c.steps_per_dispatch}, "
          f"warmup={c.warmup_steps}")
    try:
        reset_counts()
        t0 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        dispatched = trainer._dispatches
        busy = device_busy(trainer)
    finally:
        trainer.close()
    k = c.steps_per_dispatch
    expect = dict(fused_fwd=0, fused_bwd=n, project=0, tree_count=n // k, fused_step=n)
    check(launches == expect, f"large_batch: launch counts {launches}, expected {expect}")
    check(dispatched == n // k and trainer.grad_steps == n,
          f"large_batch: {dispatched} dispatches for {trainer.grad_steps} grad steps")
    for key in ("critic_loss", "q_mean", "actor_loss", "priority_mean", "eval_return_mean"):
        check(key in row and row[key] == row[key] and abs(row[key]) != float("inf"),
              f"large_batch: {key} not finite: {row.get(key)}")
    max_priority = float(trainer._dev_per.tree.max_priority)
    check(max_priority > 1.0, f"large_batch: max_priority {max_priority} did not move off 1.0")
    a = c.agent
    emit({
        "phase": "large_batch", "card": card,
        "width": {"hidden": list(a.hidden_sizes), "atoms": a.dist.num_atoms, "batch": c.batch_size,
                  "critic_ensemble": a.critic_ensemble,
                  "ensemble_min_targets": a.ensemble_min_targets,
                  "compute_dtype": a.compute_dtype, "batch_scale": c.batch_scale,
                  "lr_critic": a.lr_critic, "per_beta_steps": a.per_beta_steps,
                  "warmup_steps": c.warmup_steps, "replay_capacity": c.replay_capacity,
                  "tree_leaves": TREE_L, "steps_per_dispatch": k, "num_envs": c.num_envs},
        "grad_steps": n, "dispatches": n // k,
        "sync_guard": "set_sync_debug_mode('error') on every dispatch after the first",
        "wall_s_incl_warmup_and_eval": wall,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
        "priority_mean": row["priority_mean"], "eval_return_mean": row["eval_return_mean"],
        "max_priority": max_priority, "launches": launches,
        "launches_per_grad_step": {key: v / n for key, v in launches.items()},
        "steady_state": busy, "ok": True,
    })
    return launches


def wire_host_run(Trainer, TrainConfig, card: str, log_dir: str):
    """``bf16_wire``'s host leg: 200 K = 1 grad steps at full width with
    ``transfer_dtype="bfloat16"`` (the observations copied to the card as
    bfloat16, cast back to float32 there), under the sync guard after the
    first dispatch: B1f and B1b once a grad step, finite metrics."""
    import torch

    from d4pg_tpu_torch.runtime import trainer as trainer_mod

    n = WIRE_STEPS
    cfg = TrainConfig(env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n,
                      eval_episodes=10, log_dir=log_dir, seed=SEED, tree_backend="numpy",
                      transfer_dtype="bfloat16", debug_guards=True)
    trainer = Trainer(cfg, device="cuda")
    try:
        trainer.warmup()
        _, staged, ready = trainer._sample_staged(1)
        wire = {k: str(v.dtype) for k, v in staged.items()}
        trainer._h2d.consume(staged, ready)
        check(all(staged[k].dtype == torch.bfloat16 for k in trainer_mod.WIRE_FIELDS)
              and staged["reward"].dtype == torch.float32, f"bf16_wire: staged dtypes {wire}")
        reset_counts()
        t0 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        trainer.close()
    expect = dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0)
    check(launches == expect, f"bf16_wire host: launch counts {launches}, expected {expect}")
    for key in ("critic_loss", "q_mean", "actor_loss", "eval_return_mean"):
        check(row[key] == row[key] and abs(row[key]) != float("inf"),
              f"bf16_wire host: {key} not finite: {row.get(key)}")
    emit({"phase": "bf16_wire", "leg": "host_k1_transfer_bf16", "card": card,
          "staged_dtypes": wire, "grad_steps": n, "wall_s_incl_warmup_and_eval": wall,
          "grad_steps_per_sec": row["grad_steps_per_sec"], "critic_loss": row["critic_loss"],
          "q_mean": row["q_mean"], "eval_return_mean": row["eval_return_mean"],
          "launches": launches,
          "stage_ms_per_step": stage_ms_per_step(trainer.timers.scalars(), n), "ok": True})
    return launches

HEAD_STEPS = 200                     # grad steps of each heads_device run
HER_STEPS = 200                      # grad steps of her_pointmass
HER_EPISODES_TIMED = 5               # extra HER episodes timed after the run


def heads_step_parity(cfg_cls, create_train_state, train_step):
    """One full-width ``train_step`` with the scalar and the MoG head (M =
    5) on the card against the same step on the CPU, single and REDQ (E =
    10, M = 2, one subset fed to both), float32, on the Pendulum support:
    step_parity's tolerances, and no kernel launched (these heads have
    none: the JAX package computes their losses in XLA)."""
    import dataclasses

    import numpy as np
    import torch

    from d4pg_tpu_torch.models.critic import DistConfig

    B = 256
    batch = step_batch(np.random.default_rng(SEED + 2), B)
    subset = torch.tensor([4, 9])
    for kind in ("scalar", "mixture_gaussian"):
        for arm, kw in (("single", {}), ("redq_e10_m2", dict(critic_ensemble=10,
                                                              ensemble_min_targets=2))):
            agent = cfg_cls(dist=DistConfig(kind=kind, v_min=-300.0, v_max=0.0), n_step=3)
            agent = dataclasses.replace(agent, **kw)
            out = {}
            for dev in ("cuda", "cpu"):
                state = create_train_state(agent, SEED, dev)
                tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
                reset_counts()
                _, metrics, pri = train_step(agent, state, tb,
                                             subset=subset.to(dev) if kw else None)
                launches = read_counts()
                out[dev] = ({k: float(v) for k, v in metrics.items()}, pri.cpu().numpy(), launches)
            (mc, pc, lc), (mh, ph, lh) = out["cuda"], out["cpu"]
            name = f"{kind}/{arm}"
            check(all(np.isfinite(v) for v in mc.values()), f"{name}: non-finite metrics {mc}")
            check(pc.shape == (B,), f"{name}: priorities shape {pc.shape}")
            check(sum(lc.values()) == 0 and sum(lh.values()) == 0,
                  f"{name}: launches {lc} on the card, {lh} on the CPU")
            pri_err = float(np.abs(pc - ph).max())
            loss_err = abs(mc["critic_loss"] - mh["critic_loss"])
            check(np.allclose(pc, ph, rtol=1e-4, atol=1e-4), f"{name}: priorities differ by {pri_err:.3e}")
            check(loss_err <= 1e-4 * abs(mh["critic_loss"]) + 1e-5,
                  f"{name}: critic_loss {mc['critic_loss']} vs {mh['critic_loss']}")
            check(abs(mc["q_mean"] - mh["q_mean"]) <= 0.3, f"{name}: q_mean {mc['q_mean']} vs {mh['q_mean']}")
            emit({"phase": "heads_step_parity", "head": kind, "arm": arm, "cuda": mc, "cpu": mh,
                  "priority_max_abs_err": pri_err, "critic_loss_abs_err": loss_err,
                  "launches_cuda": lc, "subset": subset.tolist() if kw else None, "ok": True})


def heads_device_run(Trainer, TrainConfig, head: str, card: str, log_dir: str):
    """The device-PER learner (K = 8, no fused descent, a 1M-row ring and a
    2^20-leaf tree, ``debug_guards``) with the scalar or the MoG head at
    full width on Pendulum: 200 grad steps after the 1000-env-step warmup.
    B3 exactly once a dispatch (the PER draw), B1f, B1b, B2 and B4 never;
    finite metrics, ``max_priority`` off 1.0, then ``steady_state``."""
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.config import cli_support
    from d4pg_tpu_torch.models.critic import DistConfig

    n = HEAD_STEPS
    # the support `--env pendulum --critic-head <head>` resolves (the JAX
    # trainer keeps a non-categorical head's support as given)
    v_min, v_max = cli_support("pendulum", None, None)
    cfg = TrainConfig(
        env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n, eval_episodes=10,
        log_dir=log_dir, seed=SEED, replay_placement="device", steps_per_dispatch=K,
        prioritized=True, debug_guards=True,
        agent=D4PGConfig(dist=DistConfig(kind=head, num_mixtures=5, v_min=v_min, v_max=v_max)),
    )
    expect = dict(fused_fwd=0, fused_bwd=0, project=0, tree_count=n // K, fused_step=0)
    trainer, row, launches, wall, busy, _ = device_learner_run(
        Trainer, cfg, f"heads_device {head}", expect)
    dist = trainer.config.agent.dist
    check((dist.v_min, dist.v_max) == (-300.0, 0.0), f"{head}: support {dist}")
    check("q_support_frac" not in row, f"heads_device {head}: q_support_frac logged")
    a = trainer.config.agent
    emit({
        "phase": "heads_device", "head": head, "card": card,
        "width": {"hidden": list(a.hidden_sizes), "head_dim": dist.head_dim,
                  "num_mixtures": dist.num_mixtures if head == "mixture_gaussian" else None,
                  "support": [dist.v_min, dist.v_max], "batch": trainer.config.batch_size,
                  "num_envs": trainer.config.num_envs, "n_step": a.n_step,
                  "replay_capacity": trainer.config.replay_capacity, "tree_leaves": TREE_L,
                  "steps_per_dispatch": K},
        "grad_steps": n, "dispatches": n // K,
        "sync_guard": "set_sync_debug_mode('error') on every dispatch after the first",
        "wall_s_incl_warmup_and_eval": wall,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
        "priority_mean": row["priority_mean"], "eval_return_mean": row["eval_return_mean"],
        "max_priority": float(trainer._dev_per.tree.max_priority), "launches": launches,
        "steady_state": busy, "ok": True,
    })
    return launches


def her_pointmass_phase(Trainer, TrainConfig, card: str, log_dir: str):
    """HER through the trainer: the README's recipe (``--env
    pointmass_goal --her --n-step 1``) on the device placement with PER and
    the fused descent (K = 8, a 1M-row ring, ``debug_guards``), full width:
    the warmup's whole episodes at noise 3.0, then 200 grad steps. B4 and
    B1b exactly once a grad step, B3 once a dispatch, B1f and B2 never; the
    replay holding exactly the rows the writer accounting predicts (each
    live step once as it was and her_k times relabeled) and the ring the
    same count; finite metrics and ``success_rate``; then the wall ms of
    single HER episodes (the 50-step loop of one env on the card, its
    trajectory fetched once)."""
    import statistics as stats

    import torch

    n = HER_STEPS
    cfg = TrainConfig(
        env="pointmass_goal", her=True, n_step=1, total_steps=n, warmup_steps=1000,
        eval_interval=n, eval_episodes=10, log_dir=log_dir, seed=SEED,
        replay_placement="device", prioritized=True, fused_descent=True,
        steps_per_dispatch=K, debug_guards=True,
    )
    expect = dict(fused_fwd=0, fused_bwd=n, project=0, tree_count=n // K, fused_step=n)
    trainer, row, launches, wall, _, _ = device_learner_run(
        Trainer, cfg, "her_pointmass", expect, steady=False)
    rows_written, ring_rows = len(trainer.buffer), int(trainer._ring.size)
    env_steps, episodes = trainer.env_steps, trainer.her_episodes
    predicted = env_steps * (1 + cfg.her_k)
    check(rows_written == predicted and ring_rows == rows_written,
          f"her_pointmass: {rows_written} rows in replay and {ring_rows} in the ring, "
          f"{predicted} predicted")
    check(row.get("success_rate") is not None and 0.0 <= row["success_rate"] <= 1.0,
          f"her_pointmass: success_rate {row.get('success_rate')}")
    episode_ms = []
    for _ in range(HER_EPISODES_TIMED):  # after the counts: extra episodes
        torch.cuda.synchronize()
        e0 = time.perf_counter()
        trainer._her_collect_episode()
        episode_ms.append((time.perf_counter() - e0) * 1e3)
    a = trainer.config.agent
    emit({
        "phase": "her_pointmass", "card": card,
        "width": {"hidden": list(a.hidden_sizes), "atoms": a.dist.num_atoms,
                  "support": [a.dist.v_min, a.dist.v_max], "batch": trainer.config.batch_size,
                  "n_step": a.n_step, "her_k": cfg.her_k,
                  "replay_capacity": trainer.config.replay_capacity, "steps_per_dispatch": K},
        "grad_steps": n, "dispatches": n // K, "her_episodes": episodes, "env_steps": env_steps,
        "rows_written": rows_written, "rows_predicted": predicted, "ring_rows": ring_rows,
        "wall_s_incl_warmup_and_eval": wall, "grad_steps_per_sec": row["grad_steps_per_sec"],
        "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
        "eval_return_mean": row["eval_return_mean"], "success_rate": row["success_rate"],
        "her_episode_wall_ms": {"median": stats.median(episode_ms), "all": episode_ms},
        "launches": launches, "ok": True,
    })
    return launches


SERVE_MAX_BATCH = 64                 # the serve CLI's default: buckets 1, 2, 4, ..., 64
SERVE_CHECK_ROWS = 256               # card_vs_cpu observations per policy
SERVE_LOAD_S = 4.0                   # each closed-loop profile
SERVE_PROFILES = ((1, 1), (4, 16), (16, 16))   # (connections, requests in flight each)
SERVE_RELOAD_CLIENTS = 4             # pipelined clients through the hot reload
# Card against the CPU, float32 with TF32 off (resolve_device): cuBLAS and
# the CPU's GEMM sum the same float32 products in other orders, a few ulps
# of each hidden unit, carried through three 256-wide layers and a tanh
# (slope <= 1) and mapped onto bounds at most 3 wide: within 1e-5.
SERVE_TOL = 1e-5


def cpu_actions(bundle, obs, params=None):
    """The port's CPU forward of a bundle (normalize, actor, clip, affine)
    through a CPU batcher, for ``obs`` [N, obs_dim]."""
    import numpy as np

    from d4pg_tpu_torch.serve import DynamicBatcher

    b = DynamicBatcher(bundle.config, params if params is not None else bundle.actor_params,
                       max_batch=SERVE_MAX_BATCH, queue_limit=max(len(obs), SERVE_MAX_BATCH),
                       action_low=bundle.action_low, action_high=bundle.action_high,
                       obs_norm_stats=bundle.obs_norm, device="cpu")
    b.start()
    try:
        futs = [b.submit(o) for o in obs]
        return np.stack([f.result(120) for f in futs])
    finally:
        b.stop()


def process_cpu_s(pid: int) -> float:
    """User plus system CPU seconds of process ``pid`` so far (Linux)."""
    import os

    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def closed_loop(port: int, conns: int, window: int, obs, duration_s: float,
                server_pid: int | None = None) -> dict:
    """``conns`` pipelined connections, each keeping ``window`` requests in
    flight, every completion sending the next (the JAX ``bench.py
    bench_serve`` closed loop): requests/s, sheds and client-measured
    latency percentiles; from the server's healthz before and after, the
    mean rows a batch and each stage's mean ms a batch over this profile
    alone; and the CPU seconds a second of this process (the clients) and
    of the server's, when it runs in another process."""
    import threading

    import numpy as np

    from d4pg_tpu_torch.serve import PolicyClient
    from d4pg_tpu_torch.serve.client import ConnectionClosed

    lats, counts = [], {"done": 0, "shed": 0}
    lock, stop = threading.Lock(), threading.Event()
    idle = threading.Semaphore(0)  # released once per drained chain
    clients = [PolicyClient("127.0.0.1", port, timeout=60) for _ in range(conns)]

    def send_next(c):
        t0 = time.perf_counter()
        fut = c.act_async(obs)

        def done(f, t0=t0):
            exc = f.exception()
            with lock:
                if exc is None:
                    counts["done"] += 1
                    lats.append(time.perf_counter() - t0)
                else:
                    counts["shed"] += 1
            if stop.is_set() or isinstance(exc, ConnectionClosed):
                idle.release()
            else:
                send_next(c)

        fut.add_done_callback(done)

    def health():
        with PolicyClient("127.0.0.1", port, timeout=60) as c:
            h = c.healthz()
        return h["batches_total"], h["replies_ok"], h["stage_ms"]

    h0 = health()
    try:
        cpu0 = (time.process_time(), server_pid and process_cpu_s(server_pid))
        t_start = time.perf_counter()
        for c in clients:
            for _ in range(window):
                send_next(c)
        time.sleep(duration_s)
        stop.set()
        for _ in range(conns * window):
            check(idle.acquire(timeout=60), f"serve load ({conns}, {window}): a chain never drained")
        dt = time.perf_counter() - t_start
        cpu1 = (time.process_time(), server_pid and process_cpu_s(server_pid))
    finally:
        for c in clients:
            c.close()
    h1 = health()
    batches = h1[0] - h0[0]
    # healthz gives each stage's mean ms a call over the server's life, and
    # every stage runs once a batch: this profile's own mean is the
    # difference of the totals over the difference of the batches
    stage_ms = {k: (v * h1[0] - h0[2].get(k, 0.0) * h0[0]) / max(batches, 1)
                for k, v in h1[2].items()}
    p50, p95, p99 = (float(v) * 1e3 for v in np.percentile(np.asarray(lats), (50, 95, 99)))
    return {"conns": conns, "window": window, "requests_per_s": counts["done"] / dt,
            "completed": counts["done"], "shed": counts["shed"],
            "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
            "mean_rows_per_batch": (h1[1] - h0[1]) / max(batches, 1), "stage_ms": stage_ms,
            "client_process_cpu_s_per_s": (cpu1[0] - cpu0[0]) / dt,
            "server_process_cpu_s_per_s": (cpu1[1] - cpu0[1]) / dt if server_pid else None}


def graph_replay_ms(graph, n: int = 100) -> float:
    """ms per replay of one captured graph, ``n`` replays back to back
    between CUDA events (the device time, plus any gap the host's
    launches leave)."""
    import torch

    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@contextlib.contextmanager
def serve_process(bundle_dir: str, *flags: str):
    """``python -m d4pg_tpu_torch.serve --bundle DIR --port 0 [flags]`` as a
    subprocess on the card. Yields its port, pid, listening line and
    seconds to that line; on leaving the block, SIGTERM: it must print its
    "drained" line and exit 0 (both added to the yielded dict)."""
    import queue
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "d4pg_tpu_torch.serve", "--bundle", bundle_dir,
                             "--port", "0", *flags], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        first = lines.get(timeout=300)
        check(first.startswith("[serve] listening on "), f"serve cli: first line {first!r}")
        info = {"flags": list(flags), "listening": first.strip(),
                "startup_s": time.perf_counter() - t0,
                "port": int(first.split()[3].rsplit(":", 1)[1]), "pid": proc.pid}
        yield info
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=30)
        rest = []
        while not lines.empty():
            rest.append(lines.get())
        drained = [ln.strip() for ln in rest if ln.startswith("[serve] drained:")]
        check(rc == 0 and drained, f"serve cli {flags}: exit {rc}, output {rest[-10:]}")
        info.update(exit_code=rc, drained=drained[0])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)


def serve_phase(card: str, run_dir: str, tmp: str, run_actor: dict) -> dict:
    """Serving on the card: the host_fused run exported through the CLI's
    ``--export-bundle`` (the default policy, Pendulum at 3x256) and a
    seeded HalfCheetah-width bundle with non-identity bounds and obs-norm
    stats ("cheetah"), both resident in one ``PolicyServer`` with
    ``max_batch`` 64 and ``debug_guards`` (every batch after warmup under
    set_sync_debug_mode("error"); at drain, no parameter rebound after
    capture). The checks of the ``serve`` line: 7 captures per policy and
    no parameter rebound by a hot reload under 4 pipelined clients;
    replays == batches; the card against the port's CPU forward on 256
    observations per policy over the socket; the replay times per bucket;
    the CLI subprocess without guards, which takes the closed-loop load;
    the saturated profile also under guards, in the CLI and in this
    process; no hand kernel launched."""
    import collections
    import os
    import threading

    import numpy as np
    import torch

    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.models.actor import Actor
    from d4pg_tpu_torch.serve import PolicyClient, PolicyServer, export_bundle, load_bundle

    reset_counts()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 12)
    default_dir, cheetah_dir = f"{tmp}/bundle_default", f"{tmp}/bundle_cheetah"

    # export: the CLI, on this machine, from the run's best_actor.npz
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "d4pg_tpu_torch.train", "--log-dir", run_dir,
                          "--export-bundle", default_dir], capture_output=True, text=True,
                         timeout=300)
    export_s = time.perf_counter() - t0
    check(out.returncode == 0, f"serve: --export-bundle exited {out.returncode}: {out.stderr[-2000:]}")
    default = load_bundle(default_dir)
    export_source = default.meta.get("source")
    check(default.actor_params.keys() == run_actor.keys()
          and all(torch.equal(default.actor_params[k], run_actor[k]) for k in run_actor),
          "serve: the exported bundle's leaves are not the run's actor")
    ccfg = D4PGConfig(obs_dim=17, action_dim=6)
    cheetah_actor = Actor(17, 6, ccfg.hidden_sizes,
                          generator=torch.Generator().manual_seed(SEED + 17))
    stats = {"count": 1000.0, "mean": rng.normal(size=17).tolist(),
             "m2": (1000.0 * rng.uniform(0.25, 4.0, 17)).tolist()}
    export_bundle(cheetah_dir, ccfg, cheetah_actor, action_low=-1.0 - rng.uniform(0, 1, 6),
                  action_high=1.0 + rng.uniform(0, 1, 6), obs_norm_state=stats,
                  meta={"source": "chip_smoke seeded"})
    cheetah = load_bundle(cheetah_dir)
    # a seeded pixel_pendulum bundle at the preset's width: 48x48x2 frames
    # through the conv encoder, 3x256; its graphs capture the encoder
    pixel_dir = f"{tmp}/bundle_pixel"
    pcfg = D4PGConfig(obs_dim=PIXEL_OBS, action_dim=1, pixel_shape=PIXEL_SHAPE)
    pixel_actor = Actor(PIXEL_OBS, 1, pcfg.hidden_sizes, pixel_shape=PIXEL_SHAPE,
                        generator=torch.Generator().manual_seed(SEED + 48))
    export_bundle(pixel_dir, pcfg, pixel_actor, meta={"source": "chip_smoke seeded"})
    pixel = load_bundle(pixel_dir)

    srv = PolicyServer(default, policies={"cheetah": cheetah, "pixel": pixel}, port=0,
                       max_batch=SERVE_MAX_BATCH,
                       watch_bundle=True, poll_interval_s=3600.0, debug_guards=True,
                       device="cuda")
    t0 = time.perf_counter()
    srv.start()
    start_s = time.perf_counter() - t0
    batchers = srv.policies
    drained = False
    try:
        captures = {pid: b.compile_count for pid, b in batchers.items()}
        check(all(c == len(b.buckets) == 7 for c, b in zip(captures.values(), batchers.values())),
              f"serve: captures {captures}, expected 7 per policy")

        # card_vs_cpu over the socket: v1 ACT for the default, ACT2 for
        # cheetah and a handful of frames for pixel
        card_vs_cpu = {}
        for pid, bundle in (("default", default), ("cheetah", cheetah), ("pixel", pixel)):
            if pid == "pixel":
                obs = pixel_frames(rng, PIXEL_SERVE_ROWS)
            else:
                obs = (rng.normal(size=(SERVE_CHECK_ROWS, bundle.obs_dim)) * 2).astype(np.float32)
            with PolicyClient("127.0.0.1", srv.port, timeout=60) as c:
                futs = [c.act_async(o, policy_id=None if pid == "default" else pid) for o in obs]
                got = np.stack([f.result(60) for f in futs])
            err = float(np.abs(got - cpu_actions(bundle, obs)).max())
            check(err <= SERVE_TOL, f"serve card_vs_cpu {pid}: max_abs_err {err}")
            card_vs_cpu[pid] = {"rows": len(obs), "max_abs_err": err, "tolerance": SERVE_TOL}

        # hot_reload: re-export the default policy with other params while 4
        # pipelined clients keep traffic going, then check_reload()
        new_actor = Actor(3, 1, default.config.hidden_sizes,
                          generator=torch.Generator().manual_seed(SEED + 29))
        new_params = new_actor.state_dict()
        obs_r = rng.normal(size=(SERVE_RELOAD_CLIENTS, 3)).astype(np.float32)
        ref_old, ref_new = cpu_actions(default, obs_r), cpu_actions(default, obs_r, new_params)
        swapped, stop = threading.Event(), threading.Event()
        records = [[] for _ in range(SERVE_RELOAD_CLIENTS)]
        errors = []

        def traffic(i):
            try:
                with PolicyClient("127.0.0.1", srv.port, timeout=60) as c:
                    inflight = collections.deque()
                    while not stop.is_set():
                        while len(inflight) < 4:
                            inflight.append((swapped.is_set(), c.act_async(obs_r[i])))
                        after, f = inflight.popleft()
                        records[i].append((after, f.result(60)))
                    for after, f in inflight:
                        records[i].append((after, f.result(60)))
            except Exception as e:  # reported by the check below
                errors.append(repr(e))

        threads = [threading.Thread(target=traffic, args=(i,)) for i in range(SERVE_RELOAD_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        export_bundle(default_dir, default.config, new_actor, meta={"source": "chip_smoke reload"})
        bumped = time.time() + 2
        os.utime(os.path.join(default_dir, "bundle.json"), (bumped, bumped))
        t0 = time.perf_counter()
        reloaded = srv.check_reload()
        reload_ms = (time.perf_counter() - t0) * 1e3
        swapped.set()
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(timeout=120)
        check(reloaded and not errors and not any(t.is_alive() for t in threads),
              f"serve hot_reload: reloaded={reloaded}, errors {errors[:3]}")
        tally = {"old": 0, "new": 0, "after_swap": 0}
        for i, recs in enumerate(records):
            for after, a in recs:
                is_new = float(np.abs(a - ref_new[i]).max()) <= SERVE_TOL
                is_old = float(np.abs(a - ref_old[i]).max()) <= SERVE_TOL
                check(is_new or is_old, f"serve hot_reload: reply {a} is neither forward")
                check(is_new or not after, f"serve hot_reload: reply {a} after the swap is old")
                tally["new" if is_new else "old"] += 1
                tally["after_swap"] += after
        check(tally["old"] and tally["after_swap"],
              f"serve hot_reload: no traffic on one side of the swap {tally}")
        recaptures = {pid: b.compile_count for pid, b in batchers.items()}
        rebound = {pid: b.rebound_params() for pid, b in batchers.items()}
        check(recaptures == captures and not any(rebound.values()),
              f"serve hot_reload: captures {captures} -> {recaptures}, rebound {rebound}")
        check(srv.stats.params_reloads == 1
              and batchers["cheetah"].stats.params_reloads == 0
              and batchers["pixel"].stats.params_reloads == 0,
              f"serve hot_reload: params_reloads {srv.stats.params_reloads}")
        default = load_bundle(default_dir)

        # the saturated profile on this guarded server, clients in its
        # process: one of the three setups the saturated rate is compared in
        obs_l = rng.normal(size=3).astype(np.float32)
        in_process = closed_loop(srv.port, *SERVE_PROFILES[-1], obs_l, SERVE_LOAD_S)
        for pid, b in batchers.items():
            b.check_alive()  # no batch raised under the sync guard
    finally:
        srv.drain()  # debug_guards: raises if a parameter was rebound
        drained = True
    check(drained and torch.cuda.get_sync_debug_mode() == 0, "serve: sync debug mode left on")
    replays = {pid: {"replays": b.replays, "batches_total": b.stats.batches_total}
               for pid, b in batchers.items()}
    check(all(r["replays"] == r["batches_total"] > 0 for r in replays.values()),
          f"serve: replays {replays}")

    # replay_ms: each bucket's forward, 100 in one CUDA graph (its device
    # time), its own captured graph replayed back to back, and the eager
    # forward's call time
    replay_ms = {}
    with torch.no_grad():
        for pid, b in batchers.items():
            replay_ms[pid] = {
                size: {"device_ms": device_ms(lambda p=prog: b._body(p.static_in)),
                       "replay_back_to_back_ms": graph_replay_ms(prog.graph),
                       "eager_call_ms": call_ms(lambda p=prog: b._body(p.static_in))}
                for size, prog in b._programs.items()}

    # cli and load: the serve CLI as users run it (no guards, its own
    # process), one request against the CPU forward, then every
    # closed-loop profile from this process
    obs_c = rng.normal(size=3).astype(np.float32)
    load = []
    with serve_process(default_dir) as cli:
        with PolicyClient("127.0.0.1", cli["port"], timeout=60) as c:
            action = c.act(obs_c)
        cli["max_abs_err"] = float(np.abs(action - cpu_actions(default, obs_c[None])[0]).max())
        check(cli["max_abs_err"] <= SERVE_TOL, f"serve cli: action {action} off the CPU forward")
        for conns, window in SERVE_PROFILES:
            load.append(closed_loop(cli["port"], conns, window, obs_l, SERVE_LOAD_S,
                                    server_pid=cli["pid"]))
    # the saturated profile once more on the CLI under --debug-guards: with
    # the in-process run above, it parts the guard's cost from the cost of
    # sharing the server's process with the clients
    with serve_process(default_dir, "--debug-guards") as guarded_cli:
        cli_guarded = closed_loop(guarded_cli["port"], *SERVE_PROFILES[-1], obs_l, SERVE_LOAD_S,
                                  server_pid=guarded_cli["pid"])
    saturated_by_setup = {"cli": load[-1], "cli_debug_guards": cli_guarded,
                          "in_process_debug_guards": in_process}
    for setup, row in [*(("cli", r) for r in load), *saturated_by_setup.items()]:
        check(row["shed"] == 0, f"serve load {setup} {row['conns'], row['window']}: "
                                f"{row['shed']} sheds")
    launches = read_counts()
    check(all(v == 0 for v in launches.values()), f"serve: hand kernels launched {launches}")
    single, saturated = load[0]["requests_per_s"], load[-1]["requests_per_s"]
    emit({
        "phase": "serve", "card": card,
        "policies": {pid: {"obs_dim": b.config.obs_dim, "action_dim": b.config.action_dim,
                           "hidden": list(b.config.hidden_sizes), "buckets": list(b.buckets),
                           "pixel_shape": list(b.config.pixel_shape) if b.config.pixel_shape
                           else None}
                     for pid, b in batchers.items()},
        "export": {"source": export_source, "leaves_torch_equal_to_run": True,
                   "cli_s": export_s},
        "start_s": start_s, "captures": captures, "replays": replays,
        "card_vs_cpu": card_vs_cpu,
        "hot_reload": {"reloaded": reloaded, "check_reload_ms": reload_ms, "replies": tally,
                       "captures_after": recaptures, "rebound_params": rebound,
                       "params_reloads": srv.stats.params_reloads},
        "sync_guard": {"debug_guards": True, "batches_under_guard":
                       sum(r["batches_total"] for r in replays.values()), "raised": 0},
        "load": load, "batched_over_single": saturated / single,
        "stage_ms": load[-1]["stage_ms"],
        "saturated_by_setup": saturated_by_setup,
        "replay_ms": replay_ms, "cli": cli, "cli_debug_guards": guarded_cli,
        "kernel_launches": launches,
        "phase_s": time.perf_counter() - t_phase, "ok": True,
    })
    return launches


# ------------------------------------------------------------------ pixels
PIXEL_SHAPE = (48, 48, 2)            # the pixel_pendulum preset's frames
PIXEL_OBS = 48 * 48 * 2
# grad steps of each host_pixel leg: at K = 4 one collection (16 envs x 32
# steps, budgeted one env step a grad step) falls in every 512, so the leg
# has a collection and an env-steps rate
PIXEL_STEPS = 512
PIXEL_K = 4                          # host_pixel's grad steps a dispatch
PIXEL_RENDER_STATES = 64
# pixel_step_parity's tolerances, tests/test_torch_pixels.py's: the
# encoder's float32 products summed in another order (1e-5 on its tanh
# output), the render's float32 distance an ulp apart (1e-5); the step's
# loss and priorities as step_parity's; every parameter after one Adam
# step within 2 lr + 1e-6 (Adam's first step moves a coordinate by at most
# lr, and a gradient within float32 noise of 0, a dead ReLU's, may take
# the other sign on the other device)
PIXEL_ENC_ATOL = 1e-5
PIXEL_RENDER_ATOL = 1e-5
PIXEL_SERVE_ROWS = 16                # the pixel policy's card_vs_cpu requests


def pixel_frames(rng, n: int):
    """n flattened 48x48x2 frames of quantized [0, 1] values."""
    import numpy as np

    return (rng.integers(0, 256, size=(n, PIXEL_OBS)) / 255.0).astype(np.float32)


def pixel_step_parity(cfg_cls, create_train_state, train_step, card: str) -> None:
    """The pixel path at the preset's full width (48x48x2 frames, the 4x32
    conv encoder with embedding 50, 3x256 MLPs, 51 atoms, B = 256) on the
    card against the CPU, from the same weights (one seed), the same seeded
    batch and the same DrQ shift offsets: one encoder forward, one
    ``train_step`` (critic and actor loss, priorities, every updated
    parameter of the four networks; B1f and B1b once each on the card), the
    render of 64 seeded states, and the uint8 encode and decode
    (``torch.equal``). Also the card's eager call time of the encoder
    forward and of one train step (CUDA events, median)."""
    import numpy as np
    import torch

    from d4pg_tpu_torch.agent.d4pg import decode_obs, encode_obs
    from d4pg_tpu_torch.envs.pixel_pendulum import render_arm
    from d4pg_tpu_torch.models.critic import DistConfig
    from d4pg_tpu_torch.ops.augment import draw_offsets

    agent = cfg_cls(obs_dim=PIXEL_OBS, pixel_shape=PIXEL_SHAPE, n_step=3,
                    dist=DistConfig(v_min=-300.0, v_max=0.0))
    B = 256
    rng = np.random.default_rng(SEED + 14)
    batch = step_batch(rng, B)
    batch["obs"], batch["next_obs"] = pixel_frames(rng, B), pixel_frames(rng, B)
    gen = torch.Generator().manual_seed(SEED + 14)
    shift = (draw_offsets(B, agent.augment_pad, gen), draw_offsets(B, agent.augment_pad, gen))
    out = {}
    for dev in ("cuda", "cpu"):
        state = create_train_state(agent, SEED, dev)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with torch.no_grad():
            emb = state.actor.PixelEncoder_0(tb["obs"]).cpu()
        reset_counts()
        _, metrics, pri = train_step(agent, state, tb, shift=tuple(o.to(dev) for o in shift))
        launches = read_counts()
        params = {f"{net}.{name}": p.detach().cpu() for net in
                  ("actor", "critic", "target_actor", "target_critic")
                  for name, p in getattr(state, net).named_parameters()}
        out[dev] = dict(emb=emb, metrics={k: float(v) for k, v in metrics.items()},
                        pri=pri.cpu().numpy(), params=params, launches=launches, state=state,
                        batch=tb)
    c, h = out["cuda"], out["cpu"]
    enc_err = float((c["emb"] - h["emb"]).abs().max())
    check(enc_err <= PIXEL_ENC_ATOL, f"pixel_step_parity: encoder max_abs_err {enc_err}")
    check(all(np.isfinite(v) for v in c["metrics"].values()), f"non-finite {c['metrics']}")
    pri_err = float(np.abs(c["pri"] - h["pri"]).max())
    check(np.allclose(c["pri"], h["pri"], rtol=1e-4, atol=1e-4),
          f"pixel_step_parity: priorities differ by {pri_err:.3e}")
    mc, mh = c["metrics"], h["metrics"]
    loss_err = abs(mc["critic_loss"] - mh["critic_loss"])
    check(loss_err <= 1e-4 * abs(mh["critic_loss"]) + 1e-5,
          f"pixel_step_parity: critic_loss {mc['critic_loss']} vs {mh['critic_loss']}")
    check(abs(mc["q_mean"] - mh["q_mean"]) <= 0.3, f"q_mean {mc['q_mean']} vs {mh['q_mean']}")
    param_tol = 2 * agent.lr_critic + 1e-6
    param_err = {k: float((c["params"][k] - h["params"][k]).abs().max()) for k in h["params"]}
    worst = max(param_err, key=param_err.get)
    check(param_err[worst] <= param_tol,
          f"pixel_step_parity: {worst} differs by {param_err[worst]} > {param_tol}")
    expect = dict(fused_fwd=1, fused_bwd=1, project=0, tree_count=0, fused_step=0)
    check(c["launches"] == expect, f"pixel_step_parity: launches {c['launches']}")

    theta = torch.from_numpy(rng.uniform(-4, 4, PIXEL_RENDER_STATES).astype(np.float32))
    render_err = float((render_arm(theta.cuda(), 48).cpu() - render_arm(theta, 48)).abs().max())
    check(render_err <= PIXEL_RENDER_ATOL, f"pixel_step_parity: render max_abs_err {render_err}")
    edges = torch.from_numpy(pixel_frames(rng, 64))
    edges[:, ::3] = (torch.randint(0, 255, edges[:, ::3].shape, generator=gen) + 0.5) / 255.0
    u8 = encode_obs(edges.cuda())
    encode_equal = torch.equal(u8.cpu(), encode_obs(edges))
    decode_equal = torch.equal(decode_obs(u8).cpu(), decode_obs(u8.cpu()))
    check(encode_equal and decode_equal,
          f"pixel_step_parity: uint8 encode equal {encode_equal}, decode equal {decode_equal}")

    st, tb = c["state"], c["batch"]
    with torch.no_grad():
        encoder_ms = call_ms(lambda: st.actor.PixelEncoder_0(tb["obs"]), n=50)
    step_ms = call_ms(lambda: train_step(agent, st, tb), n=20, warmup=3)
    emit({"phase": "pixel_step_parity", "card": card,
          "width": {"pixel_shape": list(PIXEL_SHAPE), "convs": "4 x 3x3x32, stride 2 then 1",
                    "embed": agent.encoder_embed_dim, "hidden": list(agent.hidden_sizes),
                    "atoms": agent.dist.num_atoms, "batch": B, "augment_pad": agent.augment_pad},
          "encoder_max_abs_err": enc_err, "encoder_tolerance": PIXEL_ENC_ATOL,
          "priority_max_abs_err": pri_err, "critic_loss_abs_err": loss_err,
          "cuda": mc, "cpu": mh,
          "param_max_abs_err": param_err[worst], "param_worst": worst,
          "param_tolerance": param_tol,
          "render_max_abs_err": render_err, "render_tolerance": PIXEL_RENDER_ATOL,
          "render_states": PIXEL_RENDER_STATES,
          "uint8_encode_torch_equal": encode_equal, "uint8_decode_torch_equal": decode_equal,
          "launches": c["launches"],
          "encoder_forward_call_ms": encoder_ms, "train_step_call_ms": step_ms, "ok": True})


def host_pixel_run(Trainer, TrainConfig, wire: str, card: str, log_dir: str) -> dict:
    """``host_pixel``: the ``Trainer`` on ``--env pixel_pendulum`` at the
    preset's full width (48x48x2 frames, the conv encoder, 3x256, B = 256,
    the uint8 replay at the preset's 100 000 rows, 16 envs x 32 steps),
    host placement, PER on the native tree, K = 4, 200 grad steps under
    the sync guard after the first dispatch, on one wire: ``float32``
    (``OBS_U8_DECODE``: the gather decodes the bytes on the host) or
    ``uint8`` (``OBS_U8_RAW``: the bytes cross, the card divides them by
    255). B1f and B1b once a grad step, the rest 0; the buffer uint8; the
    bytes one dispatch copies to the card, the staged dtypes; the
    ``steady_state`` wall and device ms a step and the idle share."""
    import numpy as np
    import torch

    from d4pg_tpu_torch.replay import native

    n = PIXEL_STEPS
    cfg = TrainConfig(env="pixel_pendulum", total_steps=n, eval_interval=n, eval_episodes=10,
                      log_dir=log_dir, seed=SEED, tree_backend="native",
                      steps_per_dispatch=PIXEL_K, transfer_dtype=wire, debug_guards=True)
    expect = dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0)
    label = f"host_pixel {wire}"
    trainer, row, launches, wall, busy, stages = device_learner_run(Trainer, cfg, label, expect)
    buf = trainer.buffer
    mode = {native.OBS_F32: "OBS_F32", native.OBS_U8_DECODE: "OBS_U8_DECODE",
            native.OBS_U8_RAW: "OBS_U8_RAW"}[buf._native_obs_mode()]
    _, staged, ready = trainer._sample_staged(PIXEL_K)
    trainer._h2d.consume(staged, ready)
    torch.cuda.synchronize()
    shipped = {k: v.numel() * v.element_size() for k, v in staged.items()}
    obs_bytes = staged["obs"].element_size()
    want_bytes = 1 if wire == "uint8" else 4
    check(buf.obs.dtype == np.uint8 and buf.next_obs.dtype == np.uint8 and buf.tree_backend == "native",
          f"{label}: buffer obs {buf.obs.dtype}, backend {buf.tree_backend}")
    check(obs_bytes == want_bytes and staged["obs"].shape == (PIXEL_K, 256, PIXEL_OBS),
          f"{label}: staged obs {staged['obs'].dtype} {tuple(staged['obs'].shape)}")
    check(mode == ("OBS_U8_RAW" if wire == "uint8" else "OBS_U8_DECODE"), f"{label}: {mode}")
    emit({"phase": "host_pixel", "leg": wire, "card": card,
          "width": {"pixel_shape": list(PIXEL_SHAPE), "hidden": list(cfg.agent.hidden_sizes),
                    "batch": trainer.config.batch_size, "num_envs": trainer.config.num_envs,
                    "replay_capacity": buf.capacity, "steps_per_dispatch": PIXEL_K},
          "buffer_obs_dtype": str(buf.obs.dtype), "native_obs_mode": mode,
          "replay_obs_bytes": int(buf.obs.nbytes + buf.next_obs.nbytes),
          "staged_dtypes": {k: str(v.dtype) for k, v in staged.items()},
          "obs_bytes_per_element_on_the_wire": obs_bytes,
          "bytes_per_dispatch": sum(shipped.values()), "bytes_per_dispatch_by_field": shipped,
          "grad_steps": n, "env_steps": trainer.env_steps,
          "wall_s_incl_warmup_and_eval": wall,
          "grad_steps_per_sec": row["grad_steps_per_sec"],
          "env_steps_per_sec": row["env_steps_per_sec"],
          "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
          "eval_return_mean": row["eval_return_mean"], "launches": launches,
          "stage_ms_per_step": stage_ms_per_step(stages, n), "steady_state": busy, "ok": True})
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
    stacked_err, stacked_timing = stacked_kernel_phase(
        cp, cuda_tree, cuda_fused_step, dper, make_support, floor)
    step_parity(D4PGConfig, create_train_state, train_step)
    stacked_step_parity(D4PGConfig, create_train_state, train_step)
    heads_step_parity(D4PGConfig, create_train_state, train_step)
    pixel_step_parity(D4PGConfig, create_train_state, train_step, card)
    check_sync_guard()
    native_tree_phase()
    paths = {}
    run_actor = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths["host_fused"] = slice_run(Trainer, TrainConfig, "fused", GRAD_STEPS, card,
                                        f"{tmp}/fused", keep=run_actor)
        paths["host_projection"] = slice_run(
            Trainer, TrainConfig, "projection", GRAD_STEPS_PROJECTION, card, f"{tmp}/projection")
        paths["host_async_k1"] = async_run(
            Trainer, TrainConfig, "host_async", "host", 1, "numpy", card, f"{tmp}/async1")
        paths["host_block"] = host_data_plane_run(Trainer, TrainConfig, "host", card, f"{tmp}/block")
        paths["host_async_k8"] = async_run(
            Trainer, TrainConfig, "host_async", "host", K, "native", card, f"{tmp}/async8")
        prefetch_first_step(Trainer, TrainConfig, card, tmp)
        for tier in DEVICE_STEPS:
            paths[f"device_{tier}"] = device_slice_run(Trainer, TrainConfig, tier, card, f"{tmp}/{tier}")
        paths.update(ingest_prefetch_pair(Trainer, TrainConfig, card, tmp))
        ingest_stage_phase(card, tmp)
        paths["hybrid_slice"] = host_data_plane_run(Trainer, TrainConfig, "hybrid", card, f"{tmp}/hybrid")
        paths["hybrid_async"] = async_run(
            Trainer, TrainConfig, "hybrid_async", "hybrid", K, "native", card, f"{tmp}/hybrid_async")
        paths["device_resumed"] = resume_phase(Trainer, TrainConfig, card, tmp)
        profile_phase(Trainer, TrainConfig, card, tmp)
        planar_step_parity(card)
        for env_name in ("pendulum", "halfcheetah", "hopper_twin"):
            paths[f"on_device_{env_name}"] = on_device_phase(
                TrainConfig, env_name, card, f"{tmp}/on_device_{env_name}")
        for env_name in ("humanoid", "ant"):
            spatial_step_parity(card, env_name)
        paths["on_device_humanoid"] = on_device_phase(
            TrainConfig, "humanoid", card, f"{tmp}/on_device_humanoid")
        paths["large_batch"] = large_batch_phase(Trainer, TrainConfig, card, f"{tmp}/large_batch")
        # bf16_wire: the bf16 ring on the device, then the bf16 host wire
        paths["on_device_pendulum_bf16"] = on_device_phase(
            TrainConfig, "pendulum_bf16", card, f"{tmp}/on_device_pendulum_bf16")
        paths["host_transfer_bf16"] = wire_host_run(Trainer, TrainConfig, card, f"{tmp}/wire")
        for head in ("mixture_gaussian", "scalar"):
            paths[f"heads_device_{head}"] = heads_device_run(
                Trainer, TrainConfig, head, card, f"{tmp}/heads_{head}")
        paths["her_pointmass"] = her_pointmass_phase(Trainer, TrainConfig, card, f"{tmp}/her")
        for wire in ("float32", "uint8"):
            paths[f"host_pixel_{wire}"] = host_pixel_run(
                Trainer, TrainConfig, wire, card, f"{tmp}/pixel_{wire}")
        paths["on_device_pixel_pendulum"] = on_device_phase(
            TrainConfig, "pixel_pendulum", card, f"{tmp}/on_device_pixel_pendulum")
        paths["serve"] = serve_phase(card, f"{tmp}/fused", tmp, run_actor)

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
        if name in stacked_timing:  # E = 10 members over B = 2048 rows, one launch
            entry["stacked"] = dict(stacked_timing[name], max_abs_err=stacked_err[name])
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
