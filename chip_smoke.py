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
   [8, 256] priorities written back one dispatch later): 512 grad steps
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
   IS weights to the card and gathers the rows from the ring. 512 grad
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
   ``async_priority_writeback`` (the flusher thread), 512 grad steps.
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
   iteration and one eval episode of 100 steps, not 1000 (the depth
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
   warmup segment, ONE train iteration and one eval episode of at most
   100 steps, with ``on_device_halfcheetah``'s checks and measurements.
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
   segment, ONE train iteration and one eval episode of 100 steps (not
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
   K = 4, 512 grad steps under the guards), one line per wire:
   ``float32`` (``OBS_U8_DECODE``) and ``uint8`` (``OBS_U8_RAW``, one byte
   an observation element on the wire): grad and env steps/s,
   ``steady_state``, the bytes a dispatch copies, the buffer's dtype, B1f
   = B1b = 512 (``host_pixel_float32`` / ``host_pixel_uint8`` in every
   ``launches_by_path``). Then ``on_device_pixel_pendulum`` (phase 18's
   harness): ``--on-device`` with the uint8 ring at 99 840 rows, K = 512,
   B1f = B1b = K. The ``serve`` line also serves a seeded pixel bundle
   (its graphs capture the conv encoder) against CPU actions.
31. ``host_pool_pixel`` (after ``on_device_pixel_pendulum``): the host
   actor pool (ROADMAP A5 (d)) of 16 ``pixel_pendulum_host`` workers
   started with ``spawn`` feeding the pixel learner at full width (the
   uint8 PER buffer at 100 000 rows on the native tree, K = 4,
   ``debug_guards``), each leg a ``Trainer`` built with
   ``actor_env="pixel_pendulum_host"`` that makes and drives its own pool:
   leg 1 (the warmup, 256 grad steps, synchronous collection acting on
   the CPU copy that ``actor_device=auto`` picks, one worker SIGKILLed) and
   leg 2 (256 more, the collector thread acting on the card against
   publications every 10 grad steps), each ending with a greedy eval of
   10 episodes through its eval pool. B1f = B1b = 512; each leg's rows
   against the rows its pool steps give (count, and 64 sampled rows field
   by field); the kill's masked row, dropped window and one restart; no
   worker alive after ``close()``; torch-free spawned children (under
   this script and under the train CLI); an OU noise reset on the acting
   stream while the default stream is busy; each leg's rates and
   pool-step ms (act and pipe round trip).

32. Data parallelism (ROADMAP A7 (a)), after ``host_pool_pixel``, each
   line with its grad steps/s, one grad step's combine ms (gather plus
   fixed-order sum, CUDA events), the backend and the card:
   ``dp_lanes``: the ``Trainer`` with ``--replay-placement device
   --p-replay --dp 2`` in one process, both lanes on ``cuda:0``, 200 grad
   steps under the sync guard; B3 = 50 (twice a dispatch), B1f = B1b =
   400, B2 = B4 = 0; each lane's B3 on its 2^19-leaf subtree against the
   plain version. ``dp_ranks``: two ranks spawned over gloo on ``cuda:0``,
   one lane each, driving the sharded device-PER megastep on one seeded
   stream dealt by the striped layout (``d4pg_tpu_torch/tools/
   dp_ranks.py``), 4 dispatches interleaved with ingest: state, ring rows,
   subtrees and max priority ``torch.equal`` to one process with two
   lanes (the train CLI as two processes runs in ``host_kill_relaunch``,
   item 37). ``dp_host``: ``--dp 2`` and
   ``--dp-hogwild`` on the host placement, K = 8, 200 grad steps each,
   B1f = B1b = 400.

33. The guards and fault injection (ROADMAP A11 (b), (e1)). Since they
   landed, every ``debug_guards`` dispatch after the first on the card
   runs under the zero-transfer budget ``no_transfers`` (its operands
   checked once on entry, none on the host, beside the sync guard), and
   the ``debug_guards`` trainers' PER and pool slots under a staging
   ledger.
   ``guards_device`` (after the device slices): the fused-descent device
   placement, K = 8, 64 grad steps, 7 of its 8 dispatches counted under
   ``no_transfers``, B3 = 8, B4 = B1b = 64; a megastep handed the ring's
   fill count as a 0-d CPU tensor raises ``TransferGuardError``, and the
   batcher's flip forced onto a slot whose H2D copy is still queued raises
   ``StagingReuseError`` on the card. ``guards_chaos_pool`` (after
   ``host_pool_pixel``): its pool of 16 spawned workers at the same width
   under ``debug_guards``, the flusher and the chaos plan
   ``GUARDS_POOL_PLAN`` with the lock witness armed: every grad step
   taken, failures and restarts, ``chaos_injections`` in the rows, the
   ledger and the witness clean, then a resume leg that falls back one
   checkpoint. ``serve_guards_chaos`` (after ``serve``): the serve CLI on
   the default 3x256 bundle under ``--debug-guards --chaos
   SERVE_CHAOS_PLAN``: a live client answered throughout, the attackers
   evicted or shed, the drain's identity, ledger and witness clean.

34. The collection fleet (ROADMAP A11 (e2)), after ``guards_chaos_pool``.
   ``fleet_pixel``: a fleet-only ``Trainer`` (``num_envs=0``,
   ``fleet_listen=0``) at the ``pixel_pendulum`` preset's full width
   (host placement, the uint8 PER replay on the native tree, K = 4, the
   uint8 wire, ``debug_guards``, the lock witness and flow ledger armed),
   its bundle published every ``FLEET_PUBLISH`` grad steps with
   ``fleet_max_gen_lag=1``, fed by two ``python -m
   d4pg_tpu_torch.fleet.actor --env pixel_pendulum_host`` processes on
   the u8 wire, each started through ``FLEET_ACTOR_WRAPPER`` (which
   reports any import of torch and the frames' send-to-ack times). The
   main leg (128 grad steps): B1f = B1b = 128; both actors hot-swapped
   to generation >= 2 (the second polls every 2 s, so its windows go
   stale: counted by both sides, never written); rows in replay =
   windows ingested = windows acked; each actor's ``fleet-actor`` and the
   ingest's ``fleet-ingest`` identity balanced at the drain; no torch in
   either actor; a sampled block's uint8 rows decoded on the card
   ``torch.equal`` to the host's decode. The chaos leg (32 grad steps):
   the learner under ``partition@7``, one actor under
   ``pixel_truncate@4;reconnect_flap@2``; the torn frame a protocol
   error with nothing of it in replay, the books still balanced.
   ``fleet_device``: the fused-descent device learner (K = 8, 1M-row
   ring, ``debug_guards``) fed by an in-process ``FleetLink`` sender of
   seeded windows on the f32 wire: B3 = 8, B4 = B1b = 64; the ring's rows
   ``torch.equal`` to the host buffer's; fresh rows' tree leaves at
   ``max_priority**alpha`` before their first draw, at the warmup and
   after training. Each line prints grad steps/s, windows ingested/s,
   the actors' env steps/s, the send-to-ack p50 and p99 and its seconds.
   ``launches_by_path`` gains ``fleet_pixel`` and ``fleet_device``.

35. The flywheel (ROADMAP A11 (e3)), after ``fleet_device``:
   ``flywheel_pixel``, a fleet-only ``Trainer`` at the ``pixel_pendulum``
   preset's full width (as ``fleet_pixel``'s) fed only by mirrored serving
   traffic: ``python -m d4pg_tpu_torch.serve`` on the card serves its
   published bundle (hot reload, ``--max-batch 8``) with ``--mirror-
   fraction 1.0``, ``--mirror-ingest`` the learner's ingest,
   ``--mirror-spool``, ``--debug-guards`` and ``--chaos mirror_drop@3``,
   while two ``python -m d4pg_tpu_torch.flywheel.sim_client --env
   pixel_pendulum_host --noise-sigma 0.3 --max-steps 25`` processes (each
   through ``FLYWHEEL_CLIENT_WRAPPER``, which reports any import of torch
   and times the ACT→FEEDBACK pairs) play through it; 64 grad steps after
   256 windows. Then a feedback client of 4 episodes after the learner
   closed (its windows spooled in f32, dropped at the link), a fixed-seed
   v1 evaluator and the drain. B1f = B1b = 64, the rest 0 (0 in the
   server); every ingested window from the mirror; the ``fleet-ingest``,
   ``serve-stats`` and ``mirror-tap`` verdicts ok; one chaos drop; the
   tap's identity exact; every spooled frame within ``MAX_PAYLOAD`` and
   with its log-prob column; the gate over the final generation's windows
   passes the served bundle, refuses a planted candidate whose effective
   sample size it computes in (0, 3] below its min_ess of 4, and refuses a
   constant 40 sigma beyond every executed action (every weight 0; one 3
   sigma beyond is reported); the tap's frame split of a 64-window f32
   burst (C-6).
   ``launches_by_path`` gains ``flywheel_pixel``.

36. The replicated front end (ROADMAP A11 (e4)), after
   ``serve_guards_chaos``: ``router_serve``, two serve CLI replicas on
   the card (``serve``'s default 3x256 bundle, a copy each) behind three
   router CLI processes in turn. The rollout router (``--canary-bundle``,
   ``--chaos canary_corrupt@2``): the (16, 16) closed loop through it and
   directly against one replica, a canary promoted and the next rolled
   back, each attested by every replica's healthz and its replies held to
   the CPU forward. The autoscaling router (``--autoscale``, 2..3): a third
   card replica spawned under load, admitted, answering, drained rc 0 at
   the router's drain, no orphan. The kill router (``--chaos
   replica_kill@40``): the survivor answers all 400 requests, the identity
   exact in healthz and in the flow verdict, the killed process gone. The
   replicas' own launch counts are 0; ``launches_by_path`` gains
   ``router_serve``.

37. Recovery across processes and league training (ROADMAP A11 (f),
   (e5)), after ``dp_ranks``, both at the pendulum preset's default width
   with the 1M-row replay. ``host_kill_relaunch``: the relaunching
   supervisor ``d4pg_tpu_torch/tools/multihost_smoke.py`` on ``cuda:0``,
   the train CLI as two gloo processes on the device placement; process
   1 SIGKILLed by ``host_kill@4:1`` after the checkpoint at 16, the
   survivor reaped by SIGKILL, no manifest past 16; both relaunched with
   ``--resume``: resumed from 16 with the replay snapshot and the
   device-PER sidecar, equal model metrics, each rank B1f = B1b = 16,
   B3 = 2, B4 = 0. ``league_device``: ``python -m d4pg_tpu_torch.league``
   over three fused-descent device learners (``--snapshot-replay
   --debug-guards``), the controller SIGKILLed from outside once its
   journal shows the first generation's clone observed, and its rerun
   resuming the journal: a torn fork
   and the clone's fallback, a perturbed clone attested under its own
   variant id and promoted or rolled back, no quarantine, the
   ``league-tenure`` identity on every row, no orphan; every learner
   tenure that exited 0 or 75 printed its launch line (a trained one
   B1b = B4 = 8 x B3 > 0, B1f = 0). ``launches_by_path`` gains
   ``host_kill_relaunch`` and ``league_device``.

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
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

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

# grad steps of the learner phases (multiples of K = 8)
GRAD_STEPS = 512             # fused run
GRAD_STEPS_PROJECTION = 200  # projection-only run
DEVICE_STEPS = {"fused_descent": 512, "separate": 200, "uniform": 200}
HOST_BLOCK_STEPS = 512       # host K = 8 and hybrid runs
ASYNC_STEPS = 512            # host_async and hybrid_async runs
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
    seconds since the script started, so a run's time splits by phase.
    One write a line: two phases may run side by side."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - START}
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


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
    for L in (64, 1000, 1024, 4096, TREE_L // 2, 2 * TREE_L, 2 * TREE_L + 5000, TREE_L):
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

    from d4pg_tpu_torch.analysis.transfer import sync_debug_error

    def raises(fn) -> bool:
        try:
            with sync_debug_error():
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


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device work, by the trace's category


class DeviceEvent(NamedTuple):
    start: float   # us
    end: float     # us
    name: str
    cat: str       # a DEVICE_CATS entry or ``gpu_user_annotation``
    stream: int    # the CUDA stream


def device_events(prof) -> list:
    """The device events of a finished ``torch.profiler`` session, read from
    its kineto results: the Chrome trace's ``kernel``, ``gpu_memcpy``,
    ``gpu_memset`` and ``gpu_user_annotation`` events (the last a
    ``record_function`` range's projection on the device) with their stream,
    without writing and parsing the JSON, which for one on-device iteration
    is hundreds of MB (473 MB and ~20 s for Humanoid's on the H100; the same
    374 048 events and union within 0.01 %, PERF.md section 6). A kineto
    event carries no category in the card's torch (2.11), so it is told as
    the trace tells it: the annotation flag, then CUPTI's ``Memcpy ...`` and
    ``Memset ...`` names, the rest kernels."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        name = e.name()
        cat = ("gpu_user_annotation" if e.is_user_annotation() else
               "gpu_memcpy" if name.startswith("Memcpy ") else
               "gpu_memset" if name.startswith("Memset ") else "kernel")
        out.append(DeviceEvent(e.start_ns() / 1e3, e.end_ns() / 1e3, name, cat,
                               e.device_resource_id()))
    return out


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
    events = device_events(prof)
    by_cat, annotations = {}, {}
    for e in events:
        by_cat[e.cat] = by_cat.get(e.cat, 0.0) + (e.end - e.start) / 1e3 / steps
        if e.cat == "gpu_user_annotation":
            annotations[e.name] = annotations.get(e.name, 0.0) + (e.end - e.start) / 1e3 / steps
    device = [(e.start, e.end) for e in events if e.cat in DEVICE_CATS]
    device_ms = union_ms(device) / steps if device else None
    return {
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "device_idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
        "device_ms_per_step_by_category": by_cat,
        "device_events_sum_ms_per_step": sum(by_cat.values()),
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
        state, ring, tree = c
        leg1._megastep(state, ring, [tree], g)
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

    def counting(*operands):
        cm = orig(*operands)
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
    events = device_events(prof)
    kernels = [e for e in events if e.cat == "kernel"]
    h2d = [e for e in events if e.cat == "gpu_memcpy" and "HtoD" in e.name]
    kernel_streams = sorted({e.stream for e in kernels})
    copy_streams = sorted({e.stream for e in h2d})
    # the staged chunk is six copies (five fields and the slots); any copy
    # on a kernel stream is the dispatch's own
    staged_copies = [e for e in h2d if e.stream not in kernel_streams]
    check(kernels and len(staged_copies) >= 6,
          f"ingest_stage: {len(kernels)} kernels on streams {kernel_streams}; HtoD copies on "
          f"streams {copy_streams}, {len(staged_copies)} of them off the kernels' streams")
    overlapped = sum(any(k.start < c.end and c.start < k.end for k in kernels)
                     for c in staged_copies)
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
    # the file ``profile_dir`` gives a user is a Chrome trace: it is read as
    # that JSON (every in-script session reads :func:`device_events`)
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
# the eval episode's length in on_device_halfcheetah, on_device_humanoid
# and (since the fleet phases came) on_device_hopper_twin: a depth cut of
# the envs' 1000 steps (the evals took 70-73 % of those phases, PERF.md
# section 5; cut again from 250 when the fleet phases came, the script
# having passed 840 s); their training rolls 64-128 steps an env, which
# no limit of 100 truncates
ON_DEVICE_EVAL_STEPS = 100
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
    kernels = sum(1 for e in device_events(prof) if e.cat == "kernel")
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
    step_k = [e for e in device_events(prof) if e.cat == "kernel"]
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
           "control_step_device_ms": sum(e.end - e.start for e in step_k) / 1e3,
           "launches": launches, "ok": True}
    emit(out)
    return out


def on_device_config(TrainConfig, env_name: str, log_dir: str):
    """The on-device phases' configurations. Pendulum: the default width
    (3x256, 51 atoms, B = 256, 16 envs x 32 steps: K = 512), n-step 3, PER,
    one warmup segment, 2 train iterations. HalfCheetah: the README's
    command (128 envs, n-step 5, support [-100, 1500], a 2^20-row ring,
    PER, default widths: K = 4096), one warmup segment, one train
    iteration, one eval episode of ON_DEVICE_EVAL_STEPS (100) steps.
    Hopper twin: the twin arm of
    ``runs/hopper_ondevice_tpu_r3/NOTES.md`` (64 envs, n-step 3, PER,
    [0, 500], ``twin_critic``: K = 2048), one warmup segment, one train
    iteration, one eval episode of at most ON_DEVICE_EVAL_STEPS steps.
    Pendulum bf16 (``bf16_wire``'s on-device
    leg): Pendulum's configuration with ``compute_dtype`` and
    ``ring_dtype`` bfloat16, one train iteration. Humanoid: the README's
    on-device recipe (``runs/humanoid_ondevice_v1500/NOTES.md``: 64 envs, a
    2^19-row ring, n-step 3, PER, [0, 1500], noise 1.0 -> 0.1 over 2M env
    steps; K = 2048), one warmup segment, one train iteration, one eval
    episode of ON_DEVICE_EVAL_STEPS (100) steps, not the env's 1000.
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
                           max_episode_steps=ON_DEVICE_EVAL_STEPS,
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
    intervals, read by :func:`device_events`) and idle share."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile

    from d4pg_tpu_torch.runtime.on_device import OnDeviceRun
    from d4pg_tpu_torch.analysis.transfer import sync_debug_error

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
        with sync_debug_error():
            run.carry, _ = run.iterate_fn(run.carry, scale)
        torch.cuda.synchronize()
        iteration_ms = (time.perf_counter() - i0) * 1e3
    device = [e for e in device_events(prof) if e.cat in DEVICE_CATS]
    busy = union_ms((e.start, e.end) for e in device)
    b1f_traced = sum(1 for e in device if "fused_loss_fwd_kernel" in e.name)
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
    from d4pg_tpu_torch.config import apply_batch_scale

    n = LARGE_BATCH_STEPS
    # the CLI's --batch-scale 8: scaled where the CLI scales it, before the
    # Trainer, which takes the config as given
    cfg = apply_batch_scale(TrainConfig(
        env="pendulum", prioritized=True, replay_placement="device", fused_descent=True,
        ingest_prefetch=True, steps_per_dispatch=32, batch_scale=8, total_steps=n,
        eval_interval=n, eval_episodes=10, log_dir=log_dir, seed=SEED, debug_guards=True,
        agent=D4PGConfig(compute_dtype="bfloat16", critic_ensemble=10, ensemble_min_targets=2),
    ))
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
SERVE_LOAD_S = 2.0                   # each closed-loop profile (4 s until the fleet phases came)
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
                server_pid: int | None = None, server_stats: bool = True) -> dict:
    """``conns`` pipelined connections, each keeping ``window`` requests in
    flight, every completion sending the next (the JAX ``bench.py
    bench_serve`` closed loop): requests/s, sheds and client-measured
    latency percentiles; from the server's healthz before and after, the
    mean rows a batch and each stage's mean ms a batch over this profile
    alone (not for a router, ``server_stats=False``: it batches nothing);
    and the CPU seconds a second of this process (the clients) and of the
    server's, when it runs in another process."""
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
        if not server_stats:
            return 0, 0, {}
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
    out = {"conns": conns, "window": window, "requests_per_s": counts["done"] / dt,
           "completed": counts["done"], "shed": counts["shed"],
           "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
           "client_process_cpu_s_per_s": (cpu1[0] - cpu0[0]) / dt,
           "server_process_cpu_s_per_s": (cpu1[1] - cpu0[1]) / dt if server_pid else None}
    if server_stats:
        out.update(mean_rows_per_batch=(h1[1] - h0[1]) / max(batches, 1), stage_ms=stage_ms)
    return out


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
def serve_process(bundle_dir: str, *flags: str, preexec_fn=None):
    """``python -m d4pg_tpu_torch.serve --bundle DIR --port 0 [flags]`` as a
    subprocess on the card. Yields its port, pid, listening line and
    seconds to that line; on leaving the block, SIGTERM: it must print its
    "drained" line and exit 0 (both added to the yielded dict, with every
    line it printed after the first, ``output``)."""
    import queue
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "d4pg_tpu_torch.serve", "--bundle", bundle_dir,
                             "--port", "0", *flags], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, preexec_fn=preexec_fn)
    lines: queue.Queue = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        first = lines.get(timeout=300)
        check(first.startswith("[serve] listening on "), f"serve cli: first line {first!r}")
        info = {"flags": list(flags), "listening": first.strip(),
                "startup_s": time.perf_counter() - t0,
                "port": int(first.split()[3].rsplit(":", 1)[1]), "pid": proc.pid}
        try:
            yield info
        except BaseException:
            # the server's own account of what went wrong, before it dies
            proc.kill()
            proc.wait(timeout=60)
            reader.join(timeout=30)
            while not lines.empty():
                print(f"[serve cli {' '.join(flags)}] {lines.get().rstrip()}", file=sys.stderr)
            raise
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        reader.join(timeout=30)
        rest = []
        while not lines.empty():
            rest.append(lines.get())
        drained = [ln.strip() for ln in rest if ln.startswith("[serve] drained:")]
        check(rc == 0 and drained, f"serve cli {flags}: exit {rc}, output {rest[-10:]}")
        info.update(exit_code=rc, drained=drained[0], output=[ln.rstrip() for ln in rest])
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
    host placement, PER on the native tree, K = 4, ``PIXEL_STEPS`` grad
    steps under the guards after the first dispatch, on one wire: ``float32``
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
    check(row["env_steps_per_sec"] > 0,
          f"{label}: no collection in the timed window ({n} grad steps, env steps/s "
          f"{row['env_steps_per_sec']})")
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

POOL_ENVS = 16                       # host_pool_pixel's workers
POOL_LEG_STEPS = 256                 # grad steps of each of its two legs
POOL_KILL_AT = 4                     # leg 1's pool step, after the warmup, whose worker is dead
POOL_KILLED = 3                      # the worker it kills
POOL_SAMPLED_ROWS = 64               # stored rows held against the steps the workers returned
POOL_RETURN_RTOL = 1e-6              # a stored n-step return (float32) against its float64 sum


def _quantized(frame) -> bytes:
    """The bytes a uint8 replay stores for a [0, 1] frame: rint(frame·255)."""
    import numpy as np

    return np.clip(np.rint(np.asarray(frame, np.float32) * 255.0), 0, 255).astype(np.uint8).tobytes()


class PoolRecord:
    """What a pool-fed ``Trainer``'s collector saw, one pool step at a time
    (its ``on_step`` hook), and the replay rows those steps must give,
    derived here apart from the writer: each stepped row's (obs, action,
    reward) joins its actor's window; a full window of n emits its front
    with next_obs the step's (pre-reset) next observation; an episode end
    flushes the window with the same next_obs, discount 0 on termination,
    else γ^m; a dropped window emits nothing. ``kill_at``: the SIGKILL of
    worker ``POOL_KILLED`` goes out after pool step ``kill_at - 1``, so
    step ``kill_at`` finds it dead."""

    def __init__(self, trainer):
        agent = trainer.config.agent
        self.trainer, self.n, self.gamma = trainer, agent.n_step, agent.gamma
        self.windows = [[] for _ in range(trainer.config.num_envs)]
        self.rows: dict = {}  # (obs bytes, next_obs bytes) -> [(action, return, discount)]
        self.emitted = 0
        self.steps: list = []
        self.kill_at = None
        trainer.collector.on_step = self

    def __call__(self, s) -> None:
        import os
        import signal

        import numpy as np

        for i in s["dropped"]:
            self.windows[i] = []
        for i in np.flatnonzero(s["stepped"]):
            w = self.windows[i]
            w.append((_quantized(s["obs"][i]), s["actions"][i].copy(), float(s["rewards"][i])))
            nxt, term = _quantized(s["next_obs"][i]), bool(s["terminated"][i])
            if len(w) == self.n:
                self._emit(w, nxt, term)
            if term or s["truncated"][i]:
                while w:
                    self._emit(w, nxt, term)
        self.steps.append({"stepped": s["stepped"].copy(), "dropped": list(s["dropped"]),
                           "grad_steps": self.trainer.grad_steps})
        if self.kill_at is not None and len(self.steps) == self.kill_at - 1:
            os.kill(self.trainer.pool.pids[POOL_KILLED], signal.SIGKILL)

    def _emit(self, w: list, next_obs: bytes, terminal: bool) -> None:
        ret = 0.0
        for k, (_, _, r) in enumerate(w):
            ret += self.gamma ** k * r
        discount = 0.0 if terminal else self.gamma ** len(w)
        obs, action, _ = w.pop(0)
        self.rows.setdefault((obs, next_obs), []).append((action, ret, discount))
        self.emitted += 1

    def stored_rows_agree(self, buf, rng) -> bool:
        """Whether ``POOL_SAMPLED_ROWS`` rows drawn from ``buf`` each equal a
        row these steps give: obs and next_obs byte for byte, the action
        exactly, the discount as float32, the return within
        ``POOL_RETURN_RTOL``."""
        import numpy as np

        def agrees(r, action, ret, discount):
            return (np.array_equal(buf.action[r], action)
                    and abs(float(buf.reward[r]) - ret) <= POOL_RETURN_RTOL * max(1.0, abs(ret))
                    and buf.discount[r] == np.float32(discount))

        return all(
            any(agrees(r, *row) for row in
                self.rows.get((buf.obs[r].tobytes(), buf.next_obs[r].tobytes()), ()))
            for r in rng.integers(0, len(buf), POOL_SAMPLED_ROWS))


def host_pool_leg(Trainer, TrainConfig, leg: int, log_dir: str, **changes) -> dict:
    """One leg of ``host_pool_pixel``: a ``Trainer`` for the ``pixel_pendulum``
    preset whose pool of ``POOL_ENVS`` workers runs ``pixel_pendulum_host``
    (``actor_env``), its warmup and ``POOL_LEG_STEPS`` grad steps, ending
    with a greedy eval of 10 episodes through its eval pool. Leg 1 SIGKILLs
    a worker at its ``POOL_KILL_AT``-th pool step after the warmup. Returns
    the leg's numbers and what its checks read."""
    import numpy as np
    import torch

    cfg = TrainConfig(env="pixel_pendulum", total_steps=POOL_LEG_STEPS,
                      eval_interval=10 * POOL_LEG_STEPS, eval_episodes=10, log_dir=log_dir,
                      seed=SEED, tree_backend="native", steps_per_dispatch=PIXEL_K,
                      debug_guards=True, num_envs=POOL_ENVS, **changes)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda", actor_env="pixel_pendulum_host")
    pool = trainer.pool
    setup_s = time.perf_counter() - t0
    record = PoolRecord(trainer)
    pids = list(pool.pids)
    try:
        if leg == 1:
            trainer.warmup()
            record.kill_at = len(record.steps) + POOL_KILL_AT
        t1 = time.perf_counter()
        row = trainer.train(POOL_LEG_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        times = list(trainer.collector.step_times)  # leg 1's include the warmup's
        pids += pool.pids + trainer._eval_pool.pids
    finally:
        trainer.close()
    buf = trainer.buffer
    during = sum(int(s["stepped"].sum()) for s in record.steps
                 if 0 < s["grad_steps"] < POOL_LEG_STEPS)
    out = {
        "leg": leg, "actor_device": trainer.collector.acting.device.type,
        "collect": "async" if cfg.async_collect else "sync",
        "publish_interval": trainer.config.publish_interval,
        "trainer_setup_s": setup_s, "grad_steps": POOL_LEG_STEPS,
        "env_steps": trainer.env_steps, "env_steps_while_training": during,
        "wall_s_incl_eval": wall,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "env_steps_per_sec": row["env_steps_per_sec"],
        "critic_loss": row["critic_loss"], "actor_loss": row["actor_loss"],
        "eval_return_mean": row["eval_return_mean"],
        "eval_return_std": row["eval_return_std"],
        "pool_step_ms": {
            "median": 1e3 * statistics.median(a + p for a, p in times),
            "act_median": 1e3 * statistics.median(a for a, _ in times),
            "pipe_round_trip_median": 1e3 * statistics.median(p for _, p in times),
            "pool_steps": len(times)},
        "rows": {"inserted": int(buf.total_added), "predicted": record.emitted,
                 "sampled": POOL_SAMPLED_ROWS,
                 "sampled_agree": record.stored_rows_agree(buf, np.random.default_rng(SEED + leg))},
        "width": {"pixel_shape": list(trainer.config.agent.pixel_shape),
                  "hidden": list(trainer.config.agent.hidden_sizes),
                  "batch": trainer.config.batch_size, "n_step": trainer.config.agent.n_step,
                  "replay_capacity": buf.capacity, "buffer_obs_dtype": str(buf.obs.dtype),
                  "tree_backend": buf.tree_backend, "steps_per_dispatch": PIXEL_K},
        "restarts_total": pool.restarts_total, "failures_total": pool.failures_total,
        "events": [e["event"] for e in pool.events],
        "pids": [p for p in pids if p is not None],
    }
    if record.kill_at is not None:
        kill = record.steps[record.kill_at - 1]
        out["sigkill"] = {"worker": POOL_KILLED, "at_pool_step": record.kill_at,
                          "row_masked": not bool(kill["stepped"][POOL_KILLED]),
                          "dropped": kill["dropped"]}
    return out


def ou_reset_on_card() -> dict:
    """``HostActing``'s per-row OU noise reset on the card while the default
    stream (the learner's) is still busy: the done rows must read the reset
    state (x = 0) and the others keep theirs. The fresh state is made on
    the acting stream, so no row reads a tensor that the busy stream has
    yet to write."""
    import numpy as np
    import torch

    from d4pg_tpu_torch.agent import D4PGConfig
    from d4pg_tpu_torch.models.actor import Actor
    from d4pg_tpu_torch.runtime.collect import HostActing

    dev = torch.device("cuda")
    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(8,), noise_kind="ou")
    acting = HostActing(cfg, POOL_ENVS, dev, torch.Generator(dev).manual_seed(SEED))
    actor = Actor(3, 1, (8,), generator=torch.Generator().manual_seed(SEED)).to(dev)
    for _ in range(4):
        acting.explore(actor, np.zeros((POOL_ENVS, 3), np.float32), 1.0, wait_caller=True)
    # a reset of no row loads the reset's kernels (a first load waits on the device)
    acting.reset_noise(np.zeros(POOL_ENVS, bool))
    before = acting.noise.x.cpu().numpy()
    done = np.arange(POOL_ENVS) % 2 == 0
    a = torch.randn(8192, 8192, device=dev) * 1e-2
    b = torch.empty_like(a)
    torch.matmul(a, a, out=b)  # cuBLAS and the allocator set up before the clock
    torch.cuda.synchronize()
    default = torch.cuda.current_stream(dev)
    for _ in range(32):  # some 0.5 s of float32 matmuls on the default stream
        torch.matmul(a, a, out=b)
    busy_before = not default.query()
    acting.reset_noise(done)
    acting.stream.synchronize()
    busy_after = not default.query()
    after = acting.noise.x.cpu().numpy()
    torch.cuda.synchronize()
    ok = bool((before != 0).all() and (after[done] == 0).all()
              and np.array_equal(after[~done], before[~done]))
    check(ok, f"ou_reset_on_card: x before {before.ravel()}, after {after.ravel()}")
    return {"rows": POOL_ENVS, "reset_rows": int(done.sum()),
            "default_stream_busy_before_reset": busy_before,
            "default_stream_busy_after_reset": busy_after, "ok": ok}


def host_pool_pixel_phase(Trainer, TrainConfig, card: str, log_dir: str) -> dict:
    """``host_pool_pixel``: the host actor pool (ROADMAP A5 (d)) of 16
    ``pixel_pendulum_host`` workers started with ``spawn``, feeding the
    learner at the ``pixel_pendulum`` preset's full width (48x48x2 frames,
    the conv encoder, 3x256, B = 256, n-step 3, the 100 000-row uint8 PER
    buffer on the native tree, K = 4, ``debug_guards``): each leg is a
    ``Trainer`` built with ``actor_env="pixel_pendulum_host"``, so its own
    pool, writer, collector, warmup, budgeted collection, collector thread,
    publications, dispatches and eval pool run (:func:`host_pool_leg`).
    Leg 1: the 1000 env-step warmup at noise 3.0, then 256 grad steps with
    synchronous collection acting where ``actor_device="auto"`` puts it on
    the card (the CPU), one worker SIGKILLed at its 4th pool step. Leg 2:
    256 more with the collector thread acting on the card
    (``actor_device=default``) against publications every 10 grad steps.
    Checks: B1f = B1b = grad steps, the rest 0; finite losses and eval
    returns; each leg's rows inserted equal to the rows its pool steps give
    (:class:`PoolRecord`), and 64 sampled rows equal to such rows (the
    uint8 bytes of obs and next_obs, the action, return and discount);
    env steps collected between leg 2's first and last grad step; the
    killed worker's row masked on that step, its window dropped, one
    restart; no worker alive after ``close()``; a spawned probe child's
    modules hold no torch; an OU noise reset on the acting stream while the
    default stream is busy (:func:`ou_reset_on_card`). Prints each leg's grad and env steps/s, the pool
    step's wall ms (median, act and pipe round trip) and the spawned
    child's start seconds."""
    import os

    import numpy as np

    from d4pg_tpu_torch.runtime.actor_pool import TRAIN_MAIN_PROBE, probe_child

    child = probe_child("spawn")
    check(child["modules"] == [], f"host_pool_pixel: a spawned child loaded {child['modules']}")
    # a worker spawned under `python -m d4pg_tpu_torch.train` re-imports that module first
    run = subprocess.run([sys.executable, "-c", TRAIN_MAIN_PROBE], capture_output=True,
                         text=True, timeout=300, check=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    train_child = json.loads(run.stdout.strip().splitlines()[-1])
    check(train_child["modules"] == [],
          f"host_pool_pixel: a child spawned under the train CLI loaded {train_child['modules']}")
    ou_reset = ou_reset_on_card()
    reset_counts()
    legs = [host_pool_leg(Trainer, TrainConfig, 1, f"{log_dir}/leg1"),
            host_pool_leg(Trainer, TrainConfig, 2, f"{log_dir}/leg2", actor_device="default",
                          async_collect=True, publish_interval=10)]
    launches = read_counts()
    deadline = time.monotonic() + 15
    alive = [p for leg in legs for p in leg.pop("pids")]
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if _pid_alive(p)]
        time.sleep(0.1)
    n = 2 * POOL_LEG_STEPS
    expect = dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0)
    check(launches == expect, f"host_pool_pixel: launches {launches}, expected {expect}")
    for leg in legs:
        name = f"host_pool_pixel leg {leg['leg']}"
        for key in ("critic_loss", "actor_loss", "eval_return_mean"):
            check(np.isfinite(leg[key]), f"{name}: {key} {leg[key]}")
        rows = leg["rows"]
        check(rows["inserted"] == rows["predicted"],
              f"{name}: {rows['inserted']} rows inserted, its pool steps give {rows['predicted']}")
        width = leg["width"]
        check(width["buffer_obs_dtype"] == "uint8" and rows["sampled_agree"],
              f"{name}: sampled rows are not rows of the workers' steps ({width})")
        check(width["pixel_shape"] == list(PIXEL_SHAPE) and width["hidden"] == [256] * 3
              and width["batch"] == 256 and width["replay_capacity"] == 100_000,
              f"{name}: not the pixel_pendulum preset's full width: {width}")
    one, two = legs
    check(one["actor_device"] == "cpu" and two["actor_device"] == "cuda",
          f"host_pool_pixel: acting on {one['actor_device']} and {two['actor_device']}")
    check(two["env_steps_while_training"] > 0,
          f"host_pool_pixel: leg 2 collected nothing while it trained: {two}")
    kill = one["sigkill"]
    check(kill["row_masked"] and kill["dropped"] == [POOL_KILLED]
          and one["restarts_total"] == 1 and one["failures_total"] == 1,
          f"host_pool_pixel: after the SIGKILL: {kill}, restarts {one['restarts_total']}, "
          f"failures {one['failures_total']}, events {one['events']}")
    check(not alive, f"host_pool_pixel: workers alive after close(): {alive}")
    out = {"phase": "host_pool_pixel", "card": card,
           "pool": {"actor_env": "pixel_pendulum_host", "workers": POOL_ENVS,
                    "start_method": "spawn"},
           "spawned_child": child, "spawned_child_under_train_cli": train_child,
           "legs": legs, "ou_reset_on_card": ou_reset, "workers_alive_after_close": alive,
           "launches": launches, "ok": True}
    emit(out)
    return launches


# ------------------------------------------------------------- guards and chaos
GUARDS_POOL_STEPS = 64               # guards_chaos_pool's first leg: checkpoints at 32 and 64
GUARDS_RESUME_STEPS = 16             # its resume leg
# the JAX acceptance gate's plan (tests/test_chaos.py) and a truncation of
# the newest committed checkpoint (the 2nd save), so the resume must fall back
GUARDS_POOL_PLAN = "seed=3;env_raise@5#0;worker_kill@9#1;wb_stall@1:0.2;ckpt_truncate@2"
GUARDS_DEVICE_STEPS = 64             # guards_device: 8 dispatches of K = 8
FLIP_SLEEP_CYCLES = 1_000_000_000    # ~0.5 s of torch.cuda._sleep ahead of the forced flip
# sock_reset and the three connection attacks. The zero-window attacker
# gets up to 30 s: the server's loopback send buffer (1 MiB on the card's
# machine, up to 4 MiB here) absorbs its unread HEALTHZ replies before the
# write-progress clock can start (the JAX soak gives it 8 s against a 2 s
# stall bound). fd_exhaust hoards at the 40th accept, not the 5th: at the
# 5th, the zero-window attacker's own connection (dialled at the 3rd) can
# still be waiting in the backlog, is shed, and never floods. It holds the
# table 2 s, not 150 ms: one pass of the loop over the attacker's HEALTHZ
# flood can outlast 150 ms, and the release then runs before any accept.
# Any descriptor closed inside the hold (a churn close, an eviction, the
# attackers' own sockets) used to leave a hole the next accept took, so no
# accept met EMFILE (C-7); the hoard now retakes every such hole before
# each accept (netio/attack.py, FrameLoop.add_pre_accept)
SERVE_CHAOS_PLAN = "sock_reset@5;slowloris@2:4;zero_window@3:30000;fd_exhaust@40:2000"
SERVE_CHAOS_MIN_S = 2.0              # the attack window: at least this long,
SERVE_CHAOS_MAX_S = 30.0             # at most this long, until every attacker is dealt with
SERVE_CHAOS_BIN_S = 0.5              # the live client must be answered in every bin
SERVE_CHAOS_NOFILE = 4096            # the server's soft fd limit (fd_exhaust hoards to it)
SERVE_CHAOS_HELD = 64                # churn connections kept open through the attacks
SERVE_CHAOS_BURST = 8                # the first churn round's connections


def guards_chaos_pool_phase(Trainer, TrainConfig, card: str, log_dir: str) -> dict:
    """``guards_chaos_pool``: the pool of ``host_pool_pixel`` (16 spawned
    ``pixel_pendulum_host`` workers feeding the ``pixel_pendulum`` preset's
    full width, K = 4, the native uint8 PER buffer) under ``debug_guards``,
    the flusher thread (``async_priority_writeback``) and the chaos plan
    ``GUARDS_POOL_PLAN``, with the lock witness armed first: worker 0's env
    raises at its 5th step, worker 1 is SIGKILLed at the pool's 9th, the
    flusher stalls 0.2 s at its first wake, and the second checkpoint (of
    64 grad steps saved at 32 and 64) is truncated after its manifest.
    Checks: every budgeted grad step taken, the critic loss finite, at
    least 2 worker failures and 1 restart, ``chaos_injections`` in the
    metrics rows (2 in the final row: worker_kill and wb_stall; the final
    save's ckpt_truncate fires after it, 3 in all; the env faults fire
    inside the workers), the ledger with 0 trips and 0 holds after
    ``close()``, the witness with 0 contradictions against the port's
    committed graph, B1f = B1b = grad steps; then a ``resume`` leg whose
    verified restore falls back one step (``checkpoint_fallbacks`` 1, from
    64 to 32) and takes 16 more grad steps."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from d4pg_tpu_torch.analysis import lockwitness

    lockwitness.reset()
    lockwitness.enable()
    try:
        cfg = TrainConfig(env="pixel_pendulum", total_steps=GUARDS_POOL_STEPS,
                          eval_interval=GUARDS_POOL_STEPS, eval_episodes=1, log_dir=log_dir,
                          seed=SEED, tree_backend="native", steps_per_dispatch=PIXEL_K,
                          num_envs=POOL_ENVS, debug_guards=True, async_priority_writeback=True,
                          checkpoint_interval=GUARDS_POOL_STEPS // 2, chaos=GUARDS_POOL_PLAN)
        t0 = time.perf_counter()
        trainer = Trainer(cfg, device="cuda", actor_env="pixel_pendulum_host")
        setup_s = time.perf_counter() - t0
        pids = list(trainer.pool.pids)
        try:
            reset_counts()
            t1 = time.perf_counter()
            row = trainer.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = read_counts()
            pids += trainer.pool.pids
        finally:
            trainer.close()
        pool = trainer.pool
        ledger = trainer._ledger.stats()
        witness = lockwitness.check_against_committed(where="guards_chaos_pool")
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        steps = trainer.ckpt.all_steps()
        # the resume leg: the newest step is torn, the verified restore
        # falls back to the older one and the run goes on from there
        t2 = time.perf_counter()
        resumed = Trainer(dataclasses.replace(cfg, resume=True, chaos=None),
                          device="cuda", actor_env="pixel_pendulum_host")
        pids += resumed.pool.pids
        try:
            restored_at, fallbacks = resumed.grad_steps, resumed._ckpt_fallbacks
            reset_counts()
            row2 = resumed.train(GUARDS_RESUME_STEPS)
            torch.cuda.synchronize()
            launches_resumed = read_counts()
        finally:
            resumed.close()
        resume_s = time.perf_counter() - t2
        resumed_ledger = resumed._ledger.stats()
        witness_resumed = lockwitness.check_against_committed(where="guards_chaos_pool resume")
    finally:
        lockwitness.reset()
    deadline = time.monotonic() + 15
    alive = [p for p in pids if p is not None]
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if _pid_alive(p)]
        time.sleep(0.1)
    n = GUARDS_POOL_STEPS
    check(trainer.grad_steps == n and np.isfinite(row["critic_loss"]),
          f"guards_chaos_pool: {trainer.grad_steps} grad steps, critic loss {row['critic_loss']}")
    check(pool.failures_total >= 2 and pool.restarts_total >= 1,
          f"guards_chaos_pool: failures {pool.failures_total}, restarts {pool.restarts_total}, "
          f"events {[e['event'] for e in pool.events]}")
    injections = trainer._chaos.injections_total
    # the last row is logged at the final eval, before the final save's
    # ckpt_truncate fires: it counts worker_kill and wb_stall
    check(injections == 3 and any(r.get("chaos_injections") == 2 for r in rows),
          f"guards_chaos_pool: {injections} injections, rows {[r.get('chaos_injections') for r in rows]}")
    check(ledger["trips"] == 0 and ledger["active_holds"] == 0 and ledger["writes"] > 0,
          f"guards_chaos_pool: ledger {ledger}")
    check(witness is not None and witness["contradictions"] == 0,
          f"guards_chaos_pool: lock witness {witness}")
    expect = dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0)
    check(launches == expect, f"guards_chaos_pool: launches {launches}, expected {expect}")
    check(steps == [n // 2, n], f"guards_chaos_pool: committed steps {steps}")
    check(fallbacks == 1 and restored_at == n // 2 and row2.get("checkpoint_fallbacks") == 1.0
          and resumed.grad_steps == n // 2 + GUARDS_RESUME_STEPS
          and np.isfinite(row2["critic_loss"]),
          f"guards_chaos_pool resume: restored at {restored_at}, {fallbacks} fallbacks, "
          f"grad steps {resumed.grad_steps}, row {row2}")
    m = GUARDS_RESUME_STEPS
    expect2 = dict(fused_fwd=m, fused_bwd=m, project=0, tree_count=0, fused_step=0)
    check(launches_resumed == expect2,
          f"guards_chaos_pool resume: launches {launches_resumed}, expected {expect2}")
    check(resumed_ledger["trips"] == 0 and resumed_ledger["active_holds"] == 0,
          f"guards_chaos_pool resume: ledger {resumed_ledger}")
    check(not alive, f"guards_chaos_pool: workers alive after close(): {alive}")
    emit({"phase": "guards_chaos_pool", "card": card, "plan": GUARDS_POOL_PLAN,
          "pool": {"actor_env": "pixel_pendulum_host", "workers": POOL_ENVS,
                   "start_method": "spawn", "failures_total": pool.failures_total,
                   "restarts_total": pool.restarts_total,
                   "events": [e["event"] for e in pool.events]},
          "grad_steps": n, "trainer_setup_s": setup_s, "wall_s_incl_warmup_and_eval": wall,
          "grad_steps_per_sec": row["grad_steps_per_sec"], "critic_loss": row["critic_loss"],
          "chaos_injections": injections, "chaos_injections_in_rows":
              sorted({r["chaos_injections"] for r in rows if "chaos_injections" in r}),
          "ledger": ledger, "lock_witness": witness, "checkpoint_steps": steps,
          "launches": launches,
          "resume": {"restored_at": restored_at, "checkpoint_fallbacks": fallbacks,
                     "grad_steps": resumed.grad_steps, "critic_loss": row2["critic_loss"],
                     "wall_s_incl_setup": resume_s, "ledger": resumed_ledger,
                     "lock_witness": witness_resumed, "launches": launches_resumed},
          "workers_alive_after_close": alive, "ok": True})
    return launches


# --------------------------------------------------------- the collection fleet
FLEET_PIXEL_STEPS = 128              # fleet_pixel's grad steps (32 dispatches of K = 4)
FLEET_PIXEL_WARMUP = 512             # its warmup, in ingested windows
FLEET_PUBLISH = 16                   # grad steps between bundle publications
FLEET_ACTOR_ENVS = 4                 # envs in each actor process
FLEET_POLLS = (0.1, 2.0)             # the two actors' bundle polls, s: the second lags
FLEET_CHAOS_STEPS = 32               # the chaos leg's grad steps
FLEET_CHAOS_WARMUP = 256
FLEET_LEARNER_CHAOS = "partition@7"
FLEET_ACTOR_CHAOS = "pixel_truncate@4;reconnect_flap@2"
FLEET_DEVICE_STEPS = 64              # fleet_device: 8 megastep dispatches of K = 8
FLEET_DEVICE_FRAME = 256             # windows in each of the in-process sender's frames
FLEET_DEVICE_FRAMES = 16             # frames it sends while the learner trains
FLEET_DEADLINE_S = 60.0              # any wait of a fleet phase gives up after this

# An actor process as users start it (``python -m d4pg_tpu_torch.fleet.actor``),
# run through this wrapper: a meta-path finder records every attempt to import
# torch, and the frames' send-to-ack times are taken around FleetLink's send
# and the actor's ack callback (acks come back in send order on a connection;
# a disconnect clears the frames in flight). At exit it prints one JSON line.
FLEET_ACTOR_WRAPPER = r"""
import json, sys, time
from collections import deque

class TorchWatch:
    seen = []
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "torch":
            self.seen.append(name)
        return None

sys.meta_path.insert(0, TorchWatch())
from d4pg_tpu_torch.fleet import actor as A

sent, lat = deque(), []
send = A.FleetLink.send_windows
ack = A.FleetActor._on_ack

def send_windows(self, tag, cols, truncate=False):
    sent.append(time.perf_counter())
    return send(self, tag, cols, truncate)

def on_ack(self, kind, n):
    if kind == "dropped":
        sent.clear()
    elif sent:
        lat.append(time.perf_counter() - sent.popleft())
    ack(self, kind, n)

A.FleetLink.send_windows = send_windows
A.FleetActor._on_ack = on_ack
t0 = time.perf_counter()
rc = A.main(sys.argv[1:])
lat.sort()
q = lambda p: 1e3 * lat[min(len(lat) - 1, int(p * len(lat)))] if lat else None
print("[fleet-wrapper] " + json.dumps({
    "rc": rc, "wall_s": time.perf_counter() - t0,
    "torch_imports": TorchWatch.seen,
    "torch_modules": sorted(m for m in sys.modules if m.split(".")[0] == "torch"),
    "acks_timed": len(lat), "send_to_ack_ms_p50": q(0.5), "send_to_ack_ms_p99": q(0.99)}),
    flush=True)
sys.exit(rc)
"""


class _FleetActorProc:
    """One actor process (through :data:`FLEET_ACTOR_WRAPPER`) with its
    output gathered by a thread."""

    def __init__(self, port: int, bundle: str, seed: int, poll_s: float, chaos=None):
        import os
        import threading

        args = ["--connect", f"127.0.0.1:{port}", "--bundle", bundle,
                "--env", "pixel_pendulum_host", "--num-envs", str(FLEET_ACTOR_ENVS),
                "--seed", str(seed), "--batch-windows", "16", "--poll-interval", str(poll_s),
                "--stats-interval", "1000", "--debug-guards"]
        if chaos:
            args += ["--chaos", chaos]
        root = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen([sys.executable, "-c", FLEET_ACTOR_WRAPPER, *args],
                                     cwd=root, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     env=dict(os.environ, PYTHONPATH=root))
        self.lines: list = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def generations(self) -> list:
        import re

        return [int(m.group(1)) for line in list(self.lines)
                for m in [re.search(r"hot-swapped bundle generation=(\d+)", line)] if m]

    def stop(self) -> dict:
        """SIGTERM, the drain, the exit; returns what the process reported."""
        import ast
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=FLEET_DEADLINE_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self._reader.join(10)
        out = {"rc": rc, "generations": self.generations(),
               "chaos_injected": [ln for ln in self.lines if ln.startswith("[chaos] inject")]}
        for line in self.lines:
            if line.startswith("[fleet-actor] drained: "):
                out["stats"] = ast.literal_eval(line.split(": ", 1)[1])
            elif line.startswith("[fleet-wrapper] "):
                out["wrapper"] = json.loads(line.split(" ", 1)[1])
            elif line.startswith("[flow-verdict] "):
                out["verdict"] = json.loads(line.split(" ", 1)[1])
        check("stats" in out and "wrapper" in out and "verdict" in out,
              f"fleet actor: no drain report (rc {rc}): {self.lines[-20:]}")
        return out


def _fleet_wait(pred, what: str, timeout: float = FLEET_DEADLINE_S) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        check(time.monotonic() < deadline, f"fleet: timed out waiting for {what}")
        time.sleep(0.02)


def fleet_pixel_leg(Trainer, TrainConfig, leg: str, log_dir: str, steps: int, warmup: int,
                    learner_chaos=None, actor_chaos=None) -> dict:
    """One ``fleet_pixel`` leg: the fleet-only pixel learner on the card
    (host placement, PER on the native tree, the uint8 replay at its
    100 000 rows, K = 4, the uint8 wire, ``debug_guards``), its bundle
    published every ``FLEET_PUBLISH`` grad steps, fed by two actor
    processes; after ``train()``, both actors hot-swapped to generation
    >= 2 are SIGTERMed and drained, then the learner closes (its ingest
    checks the ``fleet-ingest`` identity). Returns the leg's record."""
    import os

    import numpy as np
    import torch

    from d4pg_tpu_torch.agent.d4pg import decode_obs
    from d4pg_tpu_torch.analysis import flowledger

    cfg = TrainConfig(env="pixel_pendulum", num_envs=0, fleet_listen=0, fleet_host="127.0.0.1",
                      fleet_bundle=os.path.join(log_dir, "bundle"),
                      fleet_publish_interval=FLEET_PUBLISH, fleet_max_gen_lag=1,
                      total_steps=steps, warmup_steps=warmup, eval_interval=steps,
                      eval_episodes=1, log_dir=log_dir, seed=SEED, tree_backend="native",
                      steps_per_dispatch=PIXEL_K, transfer_dtype="uint8", debug_guards=True,
                      chaos=learner_chaos)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    actors = []
    try:
        port = trainer._fleet.port
        actors = [_FleetActorProc(port, cfg.fleet_bundle, seed=i + 1, poll_s=FLEET_POLLS[i],
                                  chaos=actor_chaos if i == 0 else None) for i in range(2)]
        t_actors = time.perf_counter()
        reset_counts()
        t1 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        launches = read_counts()
        # one sampled block: its uint8 rows decoded on the card against the
        # host's decode of the same rows
        indices, staged, ready = trainer._sample_staged(PIXEL_K)
        trainer._h2d.consume(staged, ready)
        idx = np.asarray(indices.idx).reshape(-1)
        card_obs = decode_obs(staged["obs"]).reshape(len(idx), -1).cpu()
        host = trainer.buffer.obs[idx].astype(np.float32) / np.float32(255.0)
        decode_equal = bool(torch.equal(card_obs, torch.from_numpy(host)))
        trainer._release_staging_holds(1)  # the block is read
        _fleet_wait(lambda: all(max(a.generations() or [0]) >= 2 for a in actors),
                    "both actors to hot-swap to generation 2")
        t_stop = time.perf_counter()
        reports = [a.stop() for a in actors]
        acked = sum(r["stats"]["windows_acked"] for r in reports)
        _fleet_wait(lambda: trainer._fleet.counters()["windows_ingested"] == acked,
                    "the acked windows to land")
        counters = trainer._fleet.counters()
        rows_in_replay = len(trainer.buffer)
    finally:
        for a in actors:
            if a.proc.poll() is None:
                a.proc.kill()
                a.proc.wait()
        trainer.close()  # the ingest drains and checks its identity
    leg_s = time.perf_counter() - t0
    ledger = trainer._ledger.stats()
    n = steps
    expect = dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0)
    name = f"fleet_pixel {leg}"
    check(trainer.grad_steps == n and np.isfinite(row["critic_loss"]),
          f"{name}: {trainer.grad_steps} grad steps, critic loss {row.get('critic_loss')}")
    check(launches == expect, f"{name}: launches {launches}, expected {expect}")
    check(decode_equal, f"{name}: the card's decode of a sampled block is not the host's")
    check(rows_in_replay == counters["windows_ingested"] == acked,
          f"{name}: {rows_in_replay} rows in replay, {counters['windows_ingested']} ingested, "
          f"{acked} acked")
    stale = sum(r["stats"]["windows_stale"] for r in reports)
    check(stale == counters["windows_dropped_stale_gen"],
          f"{name}: actors counted {stale} stale, the ingest dropped "
          f"{counters['windows_dropped_stale_gen']}")
    for i, r in enumerate(reports):
        check(r["rc"] == 0 and r["verdict"]["family"] == "fleet-actor" and r["verdict"]["ok"],
              f"{name}: actor {i} exit {r['rc']}, verdict {r.get('verdict')}")
        check(max(r["generations"]) >= 2, f"{name}: actor {i} swapped to {r['generations']}")
        check(not r["wrapper"]["torch_imports"] and not r["wrapper"]["torch_modules"],
              f"{name}: actor {i} loaded torch: {r['wrapper']}")
    check(ledger["trips"] == 0 and ledger["active_holds"] == 0 and ledger["writes"] > 0,
          f"{name}: ledger {ledger}")
    check(flowledger.enabled(), f"{name}: the flow ledger was not armed")
    return {
        "leg": leg, "grad_steps": n, "warmup_windows": warmup, "train_s": train_s,
        "seconds": leg_s, "grad_steps_per_sec": row["grad_steps_per_sec"],
        "critic_loss": row["critic_loss"], "eval_return_mean": row.get("eval_return_mean"),
        # from the actors' start to their SIGTERM (the drain's windows too)
        "windows_ingested_per_sec": counters["windows_ingested"] / (t_stop - t_actors),
        "ingest": counters, "rows_in_replay": rows_in_replay,
        "card_decode_torch_equal": decode_equal, "launches": launches, "ledger": ledger,
        "learner_chaos": learner_chaos,
        "chaos_injections": 0 if trainer._chaos is None else trainer._chaos.injections_total,
        "actors": [{"poll_s": FLEET_POLLS[i], "chaos": actor_chaos if i == 0 else None,
                    "env_steps_per_sec": r["stats"]["env_steps"] / r["wrapper"]["wall_s"],
                    "generations": r["generations"], "chaos_injected": r["chaos_injected"],
                    "stats": r["stats"], "verdict_ok": r["verdict"]["ok"],
                    "torch_modules": r["wrapper"]["torch_modules"],
                    "torch_imports": r["wrapper"]["torch_imports"],
                    "acks_timed": r["wrapper"]["acks_timed"],
                    "send_to_ack_ms_p50": r["wrapper"]["send_to_ack_ms_p50"],
                    "send_to_ack_ms_p99": r["wrapper"]["send_to_ack_ms_p99"]}
                   for i, r in enumerate(reports)],
    }


def fleet_pixel_phase(Trainer, TrainConfig, card: str, log_dir: str) -> dict:
    """``fleet_pixel``: the collection fleet (ROADMAP A11 (e2)) feeding the
    ``pixel_pendulum`` preset's full width (48x48x2 frames, the conv
    encoder, 3x256, B = 256, n-step 3) on the card: a fleet-only
    ``Trainer`` (``num_envs=0``, ``fleet_listen=0``, its bundle published
    every ``FLEET_PUBLISH`` grad steps, ``fleet_max_gen_lag=1``) fed by two
    ``python -m d4pg_tpu_torch.fleet.actor --env pixel_pendulum_host``
    processes on the u8 wire, with the lock witness and the flow ledger
    armed. Main leg: ``FLEET_PIXEL_STEPS`` grad steps after
    ``FLEET_PIXEL_WARMUP`` ingested windows; B1f = B1b = grad steps, the
    rest 0; both actors hot-swapped to generation >= 2 (the second polls
    slowly, so its windows go stale); the actors' stale count equal to
    the ingest's drops, and the rows in replay equal to the windows
    ingested and to the windows acked; the ``fleet-actor`` identity of
    each actor and the ``fleet-ingest`` one balanced at the drain; no
    torch in either actor; a sampled block's uint8 rows decoded on the
    card ``torch.equal`` to the host's decode. Chaos leg: the learner
    under ``FLEET_LEARNER_CHAOS``, one actor under ``FLEET_ACTOR_CHAOS``:
    the torn frame dies whole (a protocol error, nothing of it in
    replay), the partition and the flap reconnect, the books and the
    identities still balance, every grad step is taken."""
    from d4pg_tpu_torch.analysis import flowledger, lockwitness

    t0 = time.perf_counter()
    lockwitness.reset()
    lockwitness.enable()
    flowledger.enable()
    try:
        main = fleet_pixel_leg(Trainer, TrainConfig, "main", f"{log_dir}/main",
                               FLEET_PIXEL_STEPS, FLEET_PIXEL_WARMUP)
        chaos_leg = fleet_pixel_leg(Trainer, TrainConfig, "chaos", f"{log_dir}/chaos",
                                    FLEET_CHAOS_STEPS, FLEET_CHAOS_WARMUP,
                                    learner_chaos=FLEET_LEARNER_CHAOS,
                                    actor_chaos=FLEET_ACTOR_CHAOS)
        witness = lockwitness.check_against_committed(where="fleet_pixel")
    finally:
        lockwitness.reset()
        flowledger.reset()
    stale = main["ingest"]["windows_dropped_stale_gen"]
    check(stale > 0, f"fleet_pixel: no stale window was counted ({main['ingest']})")
    check(witness is not None and witness["contradictions"] == 0,
          f"fleet_pixel: lock witness {witness}")
    chaos_actor = chaos_leg["actors"][0]
    check(chaos_leg["chaos_injections"] == 1 and len(chaos_actor["chaos_injected"]) == 2,
          f"fleet_pixel chaos: learner injections {chaos_leg['chaos_injections']}, actor "
          f"{chaos_actor['chaos_injected']}")
    check(chaos_leg["ingest"]["protocol_errors"] >= 1
          and chaos_actor["stats"]["windows_dropped_reconnect"] > 0
          and chaos_actor["stats"]["reconnects"] >= 2,
          f"fleet_pixel chaos: the torn frame and the flap: {chaos_leg['ingest']}, "
          f"{chaos_actor['stats']}")
    out = {"phase": "fleet_pixel", "card": card,
           "width": {"pixel_shape": list(PIXEL_SHAPE), "hidden": [256] * 3, "batch": 256,
                     "replay_capacity": 100_000, "steps_per_dispatch": PIXEL_K,
                     "actor_env": "pixel_pendulum_host", "actors": 2,
                     "envs_per_actor": FLEET_ACTOR_ENVS, "publish_interval": FLEET_PUBLISH},
           "main": main, "chaos": chaos_leg, "lock_witness": witness,
           "seconds": time.perf_counter() - t0, "ok": True}
    emit(out)
    return main["launches"]


def fleet_device_phase(Trainer, TrainConfig, card: str, log_dir: str) -> dict:
    """``fleet_device``: a fleet-only learner on the device placement (the
    1M-row ring and 2^20-leaf tree, PER, K = 8, the fused descent,
    ``debug_guards``) at the default width on Pendulum's dims, fed by an
    in-process sender: the port's ``FleetLink`` in a thread with seeded
    synthetic windows on the f32 wire (harness code, not a feature). The
    warmup's 1024 windows land and are flushed first: their tree leaves
    sit at ``max_priority**alpha`` (1.0) before any draw. Then
    ``FLEET_DEVICE_STEPS`` grad steps while the sender streams
    ``FLEET_DEVICE_FRAMES`` more frames: B3 once a dispatch, B4 and B1b
    once a grad step, B1f and B2 none. After the sender stopped, the ring's
    rows are ``torch.equal`` to the host buffer's; then one more frame's
    fresh rows, flushed, sit at the moved ``max_priority**alpha`` before
    their first draw. Prints grad steps/s, windows ingested/s and the
    sender's send-to-ack median and p99."""
    import threading
    from collections import deque

    import numpy as np
    import torch

    from d4pg_tpu_torch.analysis import flowledger
    from d4pg_tpu_torch.fleet.actor import FleetLink

    t0 = time.perf_counter()
    flowledger.enable()
    cfg = TrainConfig(env="pendulum", num_envs=0, fleet_listen=0, fleet_host="127.0.0.1",
                      replay_placement="device", prioritized=True, steps_per_dispatch=K,
                      fused_descent=True, total_steps=FLEET_DEVICE_STEPS,
                      eval_interval=FLEET_DEVICE_STEPS, eval_episodes=1, log_dir=log_dir,
                      seed=SEED, debug_guards=True)
    rng = np.random.default_rng(SEED)
    sent, lat = deque(), []

    def on_ack(kind, n):
        if kind == "accepted" and sent:
            lat.append(time.perf_counter() - sent.popleft())

    def frame():
        n = FLEET_DEVICE_FRAME
        obs = rng.standard_normal((n, 3)).astype(np.float32)
        return (0, 0, False), {
            "obs": obs, "action": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
            "reward": rng.uniform(-16, 0, n).astype(np.float32),
            "next_obs": (obs + 0.1 * rng.standard_normal((n, 3))).astype(np.float32),
            "discount": np.where(rng.random(n) < 0.05, 0.0, 0.99**3).astype(np.float32)}

    def send(link, frames: int) -> None:
        for _ in range(frames):
            check(link.acquire_credit(FLEET_DEADLINE_S), "fleet_device: no credit")
            sent.append(time.perf_counter())
            link.send_windows(*frame())
            time.sleep(0.005)

    trainer = Trainer(cfg, device="cuda")
    link = None
    try:
        ingest = trainer._fleet
        link = FleetLink("127.0.0.1", ingest.port,
                         dict(actor_id="chip-smoke-sender", env="pendulum", obs_dim=3,
                              action_dim=1, n_step=trainer.config.n_step,
                              gamma=trainer.config.agent.gamma, generation=0,
                              caps=dict(obs_modes=["f32"])),
                         on_ack=on_ack)
        send(link, 1024 // FLEET_DEVICE_FRAME)
        _fleet_wait(lambda: ingest.counters()["windows_ingested"] == 1024, "the warmup windows")
        trainer._ring_sync.flush(trainer._ring)
        tree = trainer._dev_per.tree
        half = tree.sums.shape[0] // 2
        seeded = tree.sums[half:half + 1024]
        warm_leaves_ok = bool(torch.all(seeded == tree.max_priority ** trainer._dev_per.alpha))
        sender = threading.Thread(target=send, args=(link, FLEET_DEVICE_FRAMES), daemon=True)
        reset_counts()
        t1 = time.perf_counter()
        sender.start()
        row = trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        launches = read_counts()
        sender.join(FLEET_DEADLINE_S)
        total = 1024 + FLEET_DEVICE_FRAMES * FLEET_DEVICE_FRAME
        _fleet_wait(lambda: ingest.counters()["windows_ingested"] == total, "the sent windows")
        trainer._ring_sync.flush(trainer._ring)
        n = len(trainer.buffer)
        ring_equal = all(
            torch.equal(getattr(trainer._ring, k)[:n].cpu(),
                        torch.from_numpy(getattr(trainer.buffer, k)[:n]))
            for k in ("obs", "action", "reward", "next_obs", "discount"))
        # fresh rows: seeded at the moved max priority before their first draw
        send(link, 1)
        _fleet_wait(lambda: ingest.counters()["windows_ingested"] == total + FLEET_DEVICE_FRAME,
                    "the fresh frame")
        trainer._ring_sync.flush(trainer._ring)
        tree = trainer._dev_per.tree
        max_priority = float(tree.max_priority)
        fresh = tree.sums[half + total:half + total + FLEET_DEVICE_FRAME]
        fresh_leaves_ok = bool(torch.all(fresh == tree.max_priority ** trainer._dev_per.alpha))
        counters = ingest.counters()
    finally:
        if link is not None:
            link.close()
        trainer.close()
        flowledger.reset()
    lat.sort()
    n_steps = FLEET_DEVICE_STEPS
    expect = dict(fused_fwd=0, fused_bwd=n_steps, project=0, tree_count=n_steps // K,
                  fused_step=n_steps)
    check(trainer.grad_steps == n_steps and np.isfinite(row["critic_loss"]),
          f"fleet_device: {trainer.grad_steps} grad steps, critic loss {row.get('critic_loss')}")
    check(launches == expect, f"fleet_device: launches {launches}, expected {expect}")
    check(ring_equal, "fleet_device: the ring's rows are not the host buffer's")
    check(warm_leaves_ok and fresh_leaves_ok and max_priority > 1.0,
          f"fleet_device: fresh leaves at max priority: warmup {warm_leaves_ok}, after training "
          f"{fresh_leaves_ok} (max_priority {max_priority})")
    emit({"phase": "fleet_device", "card": card,
          "width": {"hidden": list(trainer.config.agent.hidden_sizes), "batch": 256,
                    "replay_capacity": trainer.buffer.capacity, "steps_per_dispatch": K,
                    "wire": "f32", "frame_windows": FLEET_DEVICE_FRAME},
          "grad_steps": n_steps, "train_s": train_s,
          "grad_steps_per_sec": row["grad_steps_per_sec"], "critic_loss": row["critic_loss"],
          "windows_ingested": counters["windows_ingested"],
          "windows_ingested_per_sec": FLEET_DEVICE_FRAMES * FLEET_DEVICE_FRAME / train_s,
          "send_to_ack_ms_p50": 1e3 * lat[len(lat) // 2],
          "send_to_ack_ms_p99": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
          "acks_timed": len(lat), "ring_rows_torch_equal": ring_equal,
          "fresh_leaves_at_max_priority": {"warmup": warm_leaves_ok, "after_training":
                                           fresh_leaves_ok, "max_priority": max_priority},
          "ingest": counters, "launches": launches,
          "seconds": time.perf_counter() - t0, "ok": True})
    return launches


# ------------------------------------------------------------------ flywheel
FLYWHEEL_STEPS = 64                  # flywheel_pixel's grad steps (16 dispatches of K = 4)
FLYWHEEL_WARMUP = 256                # its warmup, in ingested (mirrored) windows
FLYWHEEL_CLIENTS = 2                 # feedback clients while the learner trains
FLYWHEEL_SIGMA = 0.3                 # their exploration noise, and the gate's sigma
FLYWHEEL_MAX_STEPS = 25              # the feedback clients' and the evaluator's episode cap
FLYWHEEL_FINAL_EPISODES = 4          # the feedback client after training
FLYWHEEL_SERVE_CHAOS = "mirror_drop@3"
FLYWHEEL_BURST = 64                  # windows queued at once in the tap's frame-split check
# the planted gate candidates' distances from the executed actions, in
# sigmas. FAR: (40 * 0.3)^2 / (2 * 0.3^2) = 800 > 745 + the largest
# behaviour log-density term, so an importance weight there underflows to
# 0. NEAR: a finite weight. The planted candidate acts NEAR on
# FLYWHEEL_PLANTED_WINDOWS windows and FAR on the rest, so at most that
# many weights are finite and its effective sample size lies in (0, 3],
# below the gate's min_ess of 4, whatever the executed actions are
FLYWHEEL_PLANTED_FAR = 40.0
FLYWHEEL_PLANTED_NEAR = 3.0
FLYWHEEL_PLANTED_WINDOWS = 3

# A sim client as users start it (``python -m d4pg_tpu_torch.flywheel.sim_client``),
# run through this wrapper: the meta-path finder of FLEET_ACTOR_WRAPPER records
# every attempt to import torch; each ACT is timed, each FEEDBACK, and the pair
# from the ACT's send to the FEEDBACK's ack (the env step between them
# included); SIGTERM ends the episode loop (the client closes as on any exit).
# At exit it prints one JSON line.
FLYWHEEL_CLIENT_WRAPPER = r"""
import json, signal, sys, time

class TorchWatch:
    seen = []
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "torch":
            self.seen.append(name)
        return None

sys.meta_path.insert(0, TorchWatch())
from d4pg_tpu_torch.flywheel import sim_client as S
from d4pg_tpu_torch.serve.client import PolicyClient

acts, fbs, pairs, start = [], [], [], []
act, feedback = PolicyClient.act, PolicyClient.feedback

def timed_act(self, *a, **kw):
    t0 = time.perf_counter()
    out = act(self, *a, **kw)
    acts.append(time.perf_counter() - t0)
    start[:] = [t0]
    return out

def timed_feedback(self, *a, **kw):
    t0 = time.perf_counter()
    out = feedback(self, *a, **kw)
    t1 = time.perf_counter()
    fbs.append(t1 - t0)
    pairs.append(t1 - start[0])
    return out

def stop(signum, frame):
    raise KeyboardInterrupt

PolicyClient.act, PolicyClient.feedback = timed_act, timed_feedback
signal.signal(signal.SIGTERM, stop)
t0 = time.perf_counter()
try:
    rc = S.main(sys.argv[1:])
except KeyboardInterrupt:
    rc = "sigterm"
wall = time.perf_counter() - t0
q = lambda xs, p: 1e3 * sorted(xs)[min(len(xs) - 1, int(p * len(xs)))] if xs else None
print("[flywheel-wrapper] " + json.dumps({
    "rc": rc, "wall_s": wall, "steps": len(acts), "feedbacks": len(fbs),
    "torch_imports": TorchWatch.seen,
    "torch_modules": sorted(m for m in sys.modules if m.split(".")[0] == "torch"),
    "act_ms_p50": q(acts, 0.5), "act_ms_p99": q(acts, 0.99),
    "feedback_ms_p50": q(fbs, 0.5), "feedback_ms_p99": q(fbs, 0.99),
    "pairs": pairs}), flush=True)
sys.exit(0 if rc in (0, "sigterm") else rc)
"""


class _SimClientProc:
    """One sim client process (through :data:`FLYWHEEL_CLIENT_WRAPPER`) on
    ``pixel_pendulum_host``, its output gathered by a thread."""

    def __init__(self, port: int, seed: int, episodes: int, sigma: float = FLYWHEEL_SIGMA,
                 feedback: bool = True):
        import os
        import threading

        args = ["--connect", f"127.0.0.1:{port}", "--env", "pixel_pendulum_host",
                "--episodes", str(episodes), "--seed", str(seed), "--noise-sigma", str(sigma),
                "--max-steps", str(FLYWHEEL_MAX_STEPS)]
        if not feedback:
            args.append("--no-feedback")
        root = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen([sys.executable, "-c", FLYWHEEL_CLIENT_WRAPPER, *args],
                                     cwd=root, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     env=dict(os.environ, PYTHONPATH=root))
        self.lines: list = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    def finish(self, terminate: bool = False) -> dict:
        """SIGTERM (``terminate``) or the client's own end; returns what
        the process reported."""
        import signal

        if terminate and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=FLEET_DEADLINE_S)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            rc = self.proc.wait()
        self._reader.join(10)
        out = {"rc": rc, "ok_line": "SIM_CLIENT_OK" in self.lines,
               "episodes": sum(1 for ln in self.lines if ln.startswith("[sim-client] episode "))}
        for line in self.lines:
            if line.startswith("[flywheel-wrapper] "):
                out["wrapper"] = json.loads(line.split(" ", 1)[1])
        check(rc == 0 and "wrapper" in out,
              f"sim client: exit {rc}, no report: {self.lines[-20:]}")
        return out


def _flywheel_books(output: list) -> dict:
    """The serve CLI's drain lines of a mirrored run: the tap's books, the
    flow verdicts, the lock witness, the staging ledger, the launches and
    the chaos injections."""
    def after(prefix):
        return [ln.split(prefix, 1)[1] for ln in output if ln.startswith(prefix)]

    mirror = after("[serve] mirror: ")
    return {
        "mirror": ({k: int(v) for k, v in (kv.split("=") for kv in mirror[-1].split())}
                   if mirror else None),
        "verdicts": [json.loads(v) for v in after("[flow-verdict] ")],
        "witness": [ln for ln in output if ln.startswith("[lockwitness]")],
        "ledger": [json.loads(v) for v in after("[serve] staging ledger: ")],
        "launches": [json.loads(v) for v in after("[serve] kernel launches: ")],
        "chaos": [ln for ln in output if ln.startswith("[chaos] inject")],
    }


def _tap_identity_ok(c: dict) -> bool:
    return c["windows_built"] == (
        c["windows_acked"] + c["windows_stale"] + c["windows_shed"] + c["windows_dropped_chaos"]
        + c["windows_dropped_link"] + c["windows_dropped_full"] + c["pending"])


def tap_split_check(spool_dir: str) -> dict:
    """C-6 on this machine: the port's tap at pixel width with no ingest
    (f32 frames) handed ``FLYWHEEL_BURST`` windows while its sender is held
    (a burst of traffic), so its first batch is a full 32 windows: every
    frame fits ``MAX_PAYLOAD``, every window is spooled, the identity is
    exact. Host code, as in the JAX package."""
    import numpy as np

    from d4pg_tpu_torch.flywheel.spool import MirrorSpool, iter_payloads
    from d4pg_tpu_torch.flywheel.tap import MirrorTap
    from d4pg_tpu_torch.serve.protocol import MAX_PAYLOAD

    tap = MirrorTap(obs_dim=PIXEL_OBS, action_dim=1, n_step=3, gamma=0.99, fraction=1.0,
                    spool=MirrorSpool(spool_dir))
    rng = np.random.default_rng(SEED)
    with tap._cond:  # the sender waits on it: the windows queue, then go at once
        for step in range(FLYWHEEL_BURST):
            tap.on_request("burst", rng.random(PIXEL_OBS).astype(np.float32))
            tap.on_feedback("burst", {
                "policy_id": "default", "reward": float(rng.standard_normal()),
                "log_prob": -1.0, "terminated": False, "truncated": step == FLYWHEEL_BURST - 1,
                "action": rng.uniform(-1, 1, 1).astype(np.float32),
                "next_obs": rng.random(PIXEL_OBS).astype(np.float32)})
    tap.close()
    tap.check_alive()
    c = tap.counters()
    sizes = [len(p) for p in iter_payloads(spool_dir)]
    check(_tap_identity_ok(c) and c["pending"] == 0 and c["windows_dropped_link"] == FLYWHEEL_BURST
          and sizes and max(sizes) <= MAX_PAYLOAD and len(sizes) == c["spool_records"],
          f"flywheel_pixel: the tap's frame split: {c}, frame bytes {sizes}")
    return {"windows": FLYWHEEL_BURST, "frames": len(sizes), "max_frame_bytes": max(sizes),
            "max_payload": MAX_PAYLOAD, "counters": c}


def flywheel_pixel_phase(Trainer, TrainConfig, card: str, log_dir: str) -> dict:
    """``flywheel_pixel``: the flywheel (ROADMAP A11 (e3)) at the
    ``pixel_pendulum`` preset's full width (48x48x2 frames, the conv
    encoder, 3x256, B = 256, n-step 3, the host placement with PER on the
    native tree and the uint8 replay, K = 4, ``debug_guards``, the lock
    witness and the flow ledger armed). A fleet-only ``Trainer`` on the
    card (``num_envs=0``, ``fleet_listen=0``, its bundle published every
    ``FLEET_PUBLISH`` grad steps) has no actor and no env: it can finish
    only on mirrored windows. ``python -m d4pg_tpu_torch.serve`` serves
    its bundle on the card (hot reload every 0.2 s) with ``--mirror-
    fraction 1.0 --mirror-ingest`` (the learner's ingest, u8 frames)
    ``--mirror-spool``, ``--debug-guards`` and ``--chaos mirror_drop@3``;
    ``FLYWHEEL_CLIENTS`` ``python -m d4pg_tpu_torch.flywheel.sim_client
    --env pixel_pendulum_host --noise-sigma 0.3`` processes feed it while
    the learner takes ``FLYWHEEL_STEPS`` grad steps after
    ``FLYWHEEL_WARMUP`` windows. Then the learner closes (its ingest's
    ``fleet-ingest`` identity), the server reloads the final bundle, one
    more feedback client plays ``FLYWHEEL_FINAL_EPISODES`` episodes (its
    windows are spooled in f32 and counted ``windows_dropped_link``: the
    ingest is gone), a fixed-seed v1 evaluator (``--noise-sigma 0
    --no-feedback``) plays one, and the server drains. Checks: B1f = B1b =
    the grad steps, the rest 0, and 0 in the server; every ingested window
    from the mirror, the rows in replay the windows ingested, the tap's
    acked and stale windows the ingest's; the ``fleet-ingest``,
    ``serve-stats`` and ``mirror-tap`` verdicts ok; ``windows_dropped_chaos
    == 1``; the tap's identity exact; every spooled frame within
    ``MAX_PAYLOAD`` and decoded with its log-prob column; no torch in any
    client; the gate (``evaluate_is_gate``, sigma 0.3) over the final
    generation's windows passes the served bundle's ``NumpyPolicy``,
    refuses a planted candidate with finite weights on three windows only
    (``0 < ess < min_ess``: the gate's ESS comparison) and refuses a
    constant ``FLYWHEEL_PLANTED_FAR`` sigma beyond every executed action
    (every weight 0: the gate's underflow branch), both harness code, not
    a feature; a constant 3 sigma beyond is evaluated and reported, not
    checked (the executed actions are clipped to [-1, 1]); the tap's
    frame split (:func:`tap_split_check`). Prints grad steps/s, windows
    mirrored/s, client steps/s, and the p50 and p99 of an ACT→FEEDBACK
    pair."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    from d4pg_tpu_torch.analysis import flowledger, lockwitness
    from d4pg_tpu_torch.fleet import wire
    from d4pg_tpu_torch.fleet.policy import load_numpy_policy
    from d4pg_tpu_torch.flywheel.gate import evaluate_is_gate
    from d4pg_tpu_torch.flywheel.spool import iter_payloads, read_windows
    from d4pg_tpu_torch.serve import PolicyClient
    from d4pg_tpu_torch.serve.protocol import MAX_PAYLOAD

    t0 = time.perf_counter()
    spool_dir = os.path.join(log_dir, "spool")
    lockwitness.reset()
    lockwitness.enable()
    flowledger.enable()
    cfg = TrainConfig(env="pixel_pendulum", num_envs=0, fleet_listen=0, fleet_host="127.0.0.1",
                      fleet_bundle=os.path.join(log_dir, "bundle"),
                      fleet_publish_interval=FLEET_PUBLISH, fleet_max_gen_lag=1,
                      total_steps=FLYWHEEL_STEPS, warmup_steps=FLYWHEEL_WARMUP,
                      eval_interval=FLYWHEEL_STEPS, eval_episodes=1,
                      log_dir=os.path.join(log_dir, "run"), seed=SEED, tree_backend="native",
                      steps_per_dispatch=PIXEL_K, transfer_dtype="uint8", debug_guards=True)
    trainer = Trainer(cfg, device="cuda")
    clients, learner_out = [], None
    try:
        flags = ("--max-batch", "8", "--poll-interval", "0.2", "--debug-guards",
                 "--chaos", FLYWHEEL_SERVE_CHAOS, "--mirror-fraction", "1.0",
                 "--mirror-ingest", f"127.0.0.1:{trainer._fleet.port}",
                 "--mirror-spool", spool_dir)
        with serve_process(cfg.fleet_bundle, *flags) as cli:
            t_clients = time.perf_counter()
            clients = [_SimClientProc(cli["port"], seed=i + 1, episodes=1_000_000)
                       for i in range(FLYWHEEL_CLIENTS)]
            reset_counts()
            t1 = time.perf_counter()
            row = trainer.train()
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t1
            launches = read_counts()
            t_stop = time.perf_counter()
            reports = [c.finish(terminate=True) for c in clients]
            with PolicyClient("127.0.0.1", cli["port"], timeout=30) as pc:
                # the tap's last frames acked, then their rows landed
                _fleet_wait(lambda: (lambda m: m["pending"] == 0 and _tap_identity_ok(m))(
                    pc.healthz()["mirror"]), "the tap to flush")
                mirror_train = pc.healthz()["mirror"]
                _fleet_wait(lambda: trainer._fleet.counters()["windows_ingested"]
                            == mirror_train["windows_acked"], "the mirrored windows to land")
                counters = trainer._fleet.counters()
                rows_in_replay = len(trainer.buffer)
                learner_buf = io.StringIO()
                with contextlib.redirect_stdout(learner_buf):
                    trainer.close()  # the ingest drains and checks fleet-ingest
                learner_out = learner_buf.getvalue()
                print(learner_out, end="", flush=True)
                meta_path = os.path.join(cfg.fleet_bundle, "bundle.json")
                with open(meta_path) as f:
                    final_gen = int(json.load(f)["meta"]["generation"])
                final_mtime = os.stat(meta_path).st_mtime
                _fleet_wait(lambda: pc.healthz()["bundle_mtime"] == final_mtime,
                            "the server to reload the final bundle")
            final = _SimClientProc(cli["port"], seed=11,
                                   episodes=FLYWHEEL_FINAL_EPISODES).finish()
            evaluator = _SimClientProc(cli["port"], seed=3, episodes=1, sigma=0.0,
                                       feedback=False).finish()
        server_s = time.perf_counter() - t_clients
    finally:
        for c in clients:
            if c.proc.poll() is None:
                c.proc.kill()
                c.proc.wait()
        if learner_out is None:
            trainer.close()
        witness = lockwitness.check_against_committed(where="flywheel_pixel")
        lockwitness.reset()
        flowledger.reset()
    books = _flywheel_books(cli["output"])
    tap = books["mirror"]
    name = "flywheel_pixel"
    n = FLYWHEEL_STEPS
    expect = dict(fused_fwd=n, fused_bwd=n, project=0, tree_count=0, fused_step=0)
    none = {k: 0 for k in expect}
    check(trainer.grad_steps == n and np.isfinite(row["critic_loss"]),
          f"{name}: {trainer.grad_steps} grad steps, critic loss {row.get('critic_loss')}")
    check(launches == expect, f"{name}: launches {launches}, expected {expect}")
    check(books["launches"] == [none], f"{name}: the server's launches {books['launches']}")
    check(counters["windows_from_mirror"] == counters["windows_ingested"] > 0
          and counters["windows_from_actors"] == 0 and rows_in_replay == counters["windows_ingested"],
          f"{name}: ingest {counters}, {rows_in_replay} rows in replay")
    check(mirror_train["windows_stale"] == counters["windows_dropped_stale_gen"],
          f"{name}: the tap counted {mirror_train['windows_stale']} stale, the ingest "
          f"{counters['windows_dropped_stale_gen']}")
    fleet_verdicts = [json.loads(ln.split("[flow-verdict] ", 1)[1])
                      for ln in learner_out.splitlines() if ln.startswith("[flow-verdict] ")]
    families = {}
    for v in fleet_verdicts + books["verdicts"]:
        families.setdefault(v["family"], []).append(v["ok"])
    check(set(families) == {"fleet-ingest", "serve-stats", "mirror-tap"}
          and all(all(oks) for oks in families.values()), f"{name}: flow verdicts {families}")
    check(tap is not None and _tap_identity_ok(tap) and tap["pending"] == 0
          and tap["windows_dropped_chaos"] == 1 and len(books["chaos"]) == 1
          and tap["windows_acked"] == mirror_train["windows_acked"]
          and tap["windows_dropped_link"] > 0,
          f"{name}: the tap's books {tap}, chaos {books['chaos']}")
    check(len(books["witness"]) == 1 and " 0 contradictions" in books["witness"][0]
          and witness is not None and witness["contradictions"] == 0,
          f"{name}: lock witness server {books['witness']}, learner {witness}")
    check(len(books["ledger"]) == 1 and books["ledger"][0]["trips"] == 0
          and books["ledger"][0]["active_holds"] == 0, f"{name}: ledger {books['ledger']}")
    for r in reports + [final, evaluator]:
        check(not r["wrapper"]["torch_imports"] and not r["wrapper"]["torch_modules"],
              f"{name}: a sim client loaded torch: {r['wrapper']}")
    check(final["ok_line"] and evaluator["ok_line"]
          and final["episodes"] == FLYWHEEL_FINAL_EPISODES and evaluator["episodes"] == 1,
          f"{name}: final client {final}, evaluator {evaluator}")
    # the spool: every frame within MAX_PAYLOAD, each decoded with its column
    modes, sizes, per_mode = {}, [], {}
    for p in iter_payloads(spool_dir):
        gen, _sg, mode, _rel, cols = wire.decode_windows2(p, PIXEL_OBS, 1)
        check("logprob" in cols, f"{name}: a spooled frame without its log-prob column")
        modes[mode] = modes.get(mode, 0) + 1
        per_mode.setdefault(mode, []).append(len(cols["reward"]))
        sizes.append(len(p))
    spooled = tap["windows_built"] - tap["windows_dropped_chaos"] - tap["windows_dropped_full"]
    cols_all, n_all = read_windows(spool_dir, PIXEL_OBS, 1)
    check(len(sizes) == tap["spool_records"] and max(sizes) <= MAX_PAYLOAD and n_all == spooled
          and len(cols_all["logprob"]) == n_all,
          f"{name}: spool frames {len(sizes)} of {tap['spool_records']}, max bytes {max(sizes)}, "
          f"windows {n_all} of {spooled}")
    # the gate over the final generation's windows
    cols, n_gate = read_windows(spool_dir, PIXEL_OBS, 1, min_generation=final_gen)
    served_policy = load_numpy_policy(cfg.fleet_bundle)
    served = evaluate_is_gate(cols, served_policy, sigma=FLYWHEEL_SIGMA)

    class Constant:
        """A candidate acting a constant ``sigmas`` sigma beyond every
        executed action (harness code, not a feature)."""

        def __init__(self, sigmas: float):
            self.action = max(1.0, float(cols["action"].max())) + sigmas * FLYWHEEL_SIGMA

        def act(self, obs):
            return np.full((len(obs), 1), self.action, np.float32)

    class Planted:
        """A candidate acting ``FLYWHEEL_PLANTED_NEAR`` sigma above the
        executed action on the given windows (keyed by their observation)
        and the FAR constant on every other one (harness code, not a
        feature)."""

        def __init__(self, rows):
            self.near = {cols["obs"][i].tobytes(): float(cols["action"][i, 0])
                         + FLYWHEEL_PLANTED_NEAR * FLYWHEEL_SIGMA for i in rows}
            self.far = Constant(FLYWHEEL_PLANTED_FAR).action

        def act(self, obs):
            return np.array([[self.near.get(o.tobytes(), self.far)] for o in obs], np.float32)

    # the planted candidate: finite weights on FLYWHEEL_PLANTED_WINDOWS
    # windows whose observation no other window repeats (the first, the
    # middle and the last such), 0 on the rest: the gate computes the
    # effective sample size and refuses it against min_ess. The FAR
    # constant (every weight 0) is refused by the gate's underflow branch.
    # The constant 3 sigma beyond (the smallest far-off constant) is only
    # reported: the clients clip executed actions to [-1, 1], and a
    # constant beyond the clip weighs every window clipped there alike, so
    # its effective sample size depends on how many windows sit at the clip
    _, first, counts = np.unique(cols["obs"], axis=0, return_index=True, return_counts=True)
    unique = np.sort(first[counts == 1])
    rows = sorted({int(unique[0]), int(unique[len(unique) // 2]), int(unique[-1])})
    planted = evaluate_is_gate(cols, Planted(rows), sigma=FLYWHEEL_SIGMA)
    far = Constant(FLYWHEEL_PLANTED_FAR)
    far_verdict = evaluate_is_gate(cols, far, sigma=FLYWHEEL_SIGMA)
    near = Constant(FLYWHEEL_PLANTED_NEAR)
    near_verdict = evaluate_is_gate(cols, near, sigma=FLYWHEEL_SIGMA)
    clipped = float(np.mean(np.abs(cols["action"]) >= 1.0))
    check(n_gate >= FLYWHEEL_FINAL_EPISODES * FLYWHEEL_MAX_STEPS and served["passed"],
          f"{name}: the gate refused the served bundle over {n_gate} windows: {served}")
    check(len(rows) == FLYWHEEL_PLANTED_WINDOWS and not planted["passed"]
          and 0.0 < planted["ess"] < planted["min_ess"]
          and planted["reason"].startswith("effective sample size ")
          and f"< {planted['min_ess']:g}:" in planted["reason"],
          f"{name}: the gate did not refuse the planted candidate on ESS: {planted}")
    check(not far_verdict["passed"] and far_verdict["ess"] == 0.0
          and far_verdict["reason"].startswith("effective sample size 0.00:"),
          f"{name}: the gate did not refuse the far constant (all weights 0): {far_verdict}")
    split = tap_split_check(os.path.join(log_dir, "burst_spool"))
    pairs = sorted(p for r in reports for p in r["wrapper"]["pairs"])

    def q(p):
        return 1e3 * pairs[min(len(pairs) - 1, int(p * len(pairs)))] if pairs else None

    emit({"phase": name, "card": card,
          "width": {"pixel_shape": list(PIXEL_SHAPE), "hidden": [256] * 3, "batch": 256,
                    "replay_capacity": 100_000, "steps_per_dispatch": PIXEL_K,
                    "client_env": "pixel_pendulum_host", "clients": FLYWHEEL_CLIENTS,
                    "noise_sigma": FLYWHEEL_SIGMA, "max_steps": FLYWHEEL_MAX_STEPS,
                    "publish_interval": FLEET_PUBLISH, "serve_max_batch": 8},
          "grad_steps": n, "warmup_windows": FLYWHEEL_WARMUP, "train_s": train_s,
          "grad_steps_per_sec": row["grad_steps_per_sec"], "critic_loss": row["critic_loss"],
          "eval_return_mean": row.get("eval_return_mean"),
          # from the clients' start to their SIGTERM
          "windows_mirrored_per_sec": counters["windows_from_mirror"] / (t_stop - t_clients),
          "client_steps_per_sec": [r["wrapper"]["steps"] / r["wrapper"]["wall_s"]
                                   for r in reports],
          "act_feedback_pair_ms_p50": q(0.5), "act_feedback_pair_ms_p99": q(0.99),
          "pairs_timed": len(pairs),
          "clients": [{k: r["wrapper"][k] for k in ("steps", "wall_s", "act_ms_p50", "act_ms_p99",
                                                    "feedback_ms_p50", "feedback_ms_p99")}
                      for r in reports],
          "ingest": counters, "rows_in_replay": rows_in_replay, "tap_at_train_end": mirror_train,
          "tap": tap, "flow_verdicts": families, "server_chaos": books["chaos"],
          "server_lock_witness": books["witness"][0], "server_ledger": books["ledger"][0],
          "lock_witness": witness, "spool": {"frames_by_mode": modes, "max_frame_bytes": max(sizes),
                                             "max_windows_a_frame": {m: max(v) for m, v in
                                                                     per_mode.items()},
                                             "windows": n_all},
          "final_generation": final_gen, "gate_windows": n_gate,
          "gate_served": served, "gate_planted": dict(planted, windows_near=rows),
          "gate_constant_far": dict(far_verdict, action=far.action),
          "gate_constant_3_sigma": dict(near_verdict, action=near.action),
          "executed_actions_at_the_clip": clipped,
          "final_client": {"episodes": final["episodes"], **{
              k: final["wrapper"][k] for k in ("steps", "wall_s")}},
          "evaluator": {"episodes": evaluator["episodes"], "steps": evaluator["wrapper"]["steps"]},
          "tap_split": split, "launches": launches, "server_launches": books["launches"][0],
          "server_startup_s": cli["startup_s"], "server_s": server_s,
          "seconds": time.perf_counter() - t0, "ok": True})
    return launches


def forced_flip_on_card() -> dict:
    """The batcher's seeded fault on the card: a 3x256 Pendulum batcher
    under its guards with a staging ledger, its rotation pinned to slot 0
    (``_test_force_flip``) and its stream held by ~0.5 s of
    ``torch.cuda._sleep``, so the first batch's non-blocking H2D copy out
    of slot 0 has not run when the second batch is assembled into slot 0:
    that write must raise ``StagingReuseError`` (the race the two slots
    exist for, which only the card has), the slot's event still pending."""
    import numpy as np
    import torch

    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.analysis import StagingLedger, StagingReuseError
    from d4pg_tpu_torch.models.actor import Actor
    from d4pg_tpu_torch.serve.batcher import DynamicBatcher

    cfg = D4PGConfig(obs_dim=3, action_dim=1)
    actor = Actor(3, 1, cfg.hidden_sizes, generator=torch.Generator().manual_seed(SEED))
    led = StagingLedger("serve")
    b = DynamicBatcher(cfg, actor.state_dict(), max_batch=SERVE_MAX_BATCH, max_wait_us=0,
                       guard_sync=True, device="cuda", ledger=led)
    b.start()
    try:
        b.submit(np.zeros(3, np.float32)).result(timeout=60)  # a clean batch first
        clean = dict(led.stats())
        b._test_force_flip = 0
        with torch.cuda.stream(b._stream):
            torch.cuda._sleep(FLIP_SLEEP_CYCLES)
        first = b.submit(np.zeros(3, np.float32))
        time.sleep(0.05)  # the first batch assembled and enqueued behind the sleep
        event_pending = not b._programs[1].events[0].query()
        second = b.submit(np.ones(3, np.float32))
        exc = second.exception(timeout=60)
        first.result(timeout=60)
    finally:
        try:
            b.stop(timeout=30)
        except RuntimeError:
            pass  # the device thread died on the trip, as seeded
    ok = isinstance(exc, StagingReuseError) and event_pending and led.stats()["trips"] == 1
    check(ok and clean == {"writes": 1, "trips": 0, "active_holds": 0},
          f"forced flip: {exc!r}, event pending {event_pending}, ledger {led.stats()}, "
          f"after the clean batch {clean}")
    return {"raised": type(exc).__name__, "message": str(exc)[:160],
            "event_pending_at_the_write": event_pending, "ledger": led.stats(), "ok": ok}


def guards_device_phase(Trainer, TrainConfig, card: str, log_dir: str) -> dict:
    """``guards_device``: the device placement (``--p-replay
    --fused-descent``, K = 8, the 1M-row ring and 2^20-leaf tree at full
    width) under ``debug_guards``, 64 grad steps: every dispatch after the
    first runs under the zero-transfer budget ``no_transfers`` (counted
    here: the operand check and the sync guard), with exact B3/B4
    launches. Then two seeded faults that must raise on the card: one
    megastep handed the ring with its fill count as a 0-d CPU tensor
    (which PyTorch would pass to a CUDA op silently) raises
    ``TransferGuardError`` at the guard's entry, and the batcher's forced
    flip raises ``StagingReuseError`` (:func:`forced_flip_on_card`)."""
    import dataclasses

    import torch

    from d4pg_tpu_torch.analysis import TransferGuardError
    from d4pg_tpu_torch.runtime import trainer as trainer_mod

    n = GUARDS_DEVICE_STEPS
    cfg = TrainConfig(env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n,
                      eval_episodes=1, log_dir=log_dir, seed=SEED, replay_placement="device",
                      prioritized=True, fused_descent=True, steps_per_dispatch=K,
                      debug_guards=True)
    zero_budget = []
    real = trainer_mod.no_transfers

    def counting(*args, **kw):
        zero_budget.append(1)
        return real(*args, **kw)

    trainer_mod.no_transfers = counting
    try:
        trainer = Trainer(cfg, device="cuda")
        try:
            reset_counts()
            t0 = time.perf_counter()
            row = trainer.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            guarded = len(zero_budget)
            bad = dataclasses.replace(trainer._ring, size=trainer._ring.size.cpu())
            raised = None
            try:
                with trainer._dispatch_guard(trainer.state, bad, trainer._dev_per.trees):
                    trainer._megastep(trainer.state, bad, trainer._dev_per.trees,
                                      trainer._megastep_gen)
            except TransferGuardError as e:
                raised = str(e)
            torch.cuda.synchronize()
        finally:
            trainer.close()
    finally:
        trainer_mod.no_transfers = real
    dispatches = n // K
    expect = dict(fused_fwd=0, fused_bwd=n, project=0, tree_count=dispatches, fused_step=n)
    check(launches == expect, f"guards_device: launches {launches}, expected {expect}")
    check(guarded == dispatches - 1 and trainer._dispatches == dispatches,
          f"guards_device: {guarded} of {trainer._dispatches} dispatches under no_transfers")
    for key in FINITE_KEYS:
        check(key in row and row[key] == row[key] and abs(row[key]) != float("inf"),
              f"guards_device: {key} not finite: {row.get(key)}")
    check(raised is not None and "implicit host-to-device" in raised and "cpu int32[]" in raised,
          f"guards_device: the 0-d CPU operand did not raise the transfer guard: {raised}")
    flip = forced_flip_on_card()
    emit({"phase": "guards_device", "card": card, "grad_steps": n, "dispatches": dispatches,
          "dispatches_under_no_transfers": guarded,
          "sync_guard": "set_sync_debug_mode('error') on every dispatch after the first",
          "wall_s_incl_warmup_and_eval": wall, "grad_steps_per_sec": row["grad_steps_per_sec"],
          "critic_loss": row["critic_loss"], "launches": launches,
          "cpu_operand_fault": {"raised": "TransferGuardError", "message": raised[:200]},
          "forced_flip": flip, "ok": True})
    return launches


def serve_guards_chaos_phase(card: str, bundle_dir: str) -> dict:
    """``serve_guards_chaos``: the serve CLI on the card with the default
    3x256 bundle of ``serve_phase``, ``--debug-guards``, ``--chaos
    SERVE_CHAOS_PLAN`` and 0.5 s stall bounds (its soft fd limit set to
    ``SERVE_CHAOS_NOFILE``, the table fd_exhaust fills). A live client acts
    continuously throughout (its 5th frame is the one sock_reset resets;
    it reconnects), while fresh connections tick the accept sites: a
    first burst of ``SERVE_CHAOS_BURST``, then pairs, the last
    ``SERVE_CHAOS_HELD`` kept open (past that, each round closes two; the
    40th accept's hoard retakes every descriptor such a close frees before
    the next accept, so the accepts in its hold are shed: C-7),
    healthz read every ``SERVE_CHAOS_BIN_S``, until both attackers are
    evicted and a connection was shed (at least ``SERVE_CHAOS_MIN_S``, at
    most ``SERVE_CHAOS_MAX_S``). Checks: the live client answered in every
    bin; 4 injections in healthz; the slowloris attacker evicted on read
    stall, the zero-window one on write stall, a connection shed
    ``fd_exhausted``; at the drain (SIGTERM, rc 0) the ``serve-stats``
    identity balanced, the batcher ledger with 0 trips and no hold, and
    the lock witness with 0 contradictions. The launches are the server
    process's own counts, set to 0 after its start and printed at its
    drain; it runs no hand kernel (it serves through CUDA graphs)."""
    import collections
    import resource
    import threading

    import numpy as np

    from d4pg_tpu_torch.serve import PolicyClient

    def limit_fds():
        resource.setrlimit(resource.RLIMIT_NOFILE, (
            SERVE_CHAOS_NOFILE, resource.getrlimit(resource.RLIMIT_NOFILE)[1]))

    def attacked(h) -> bool:
        net = h.get("netio", {})
        return (net.get("evicted_read_stall", 0) >= 1 and net.get("evicted_write_stall", 0) >= 1
                and net.get("accept_shed", 0) >= 1)

    obs = np.zeros(3, np.float32)
    live = {"bins": collections.Counter(), "reconnects": 0, "errors": {}}
    churn = {"rounds": 0, "answered": 0, "failed": 0, "healthz_reads": 0}
    stop = threading.Event()
    flags = ("--debug-guards", "--chaos", SERVE_CHAOS_PLAN, "--io-read-stall-s", "0.5",
             "--io-write-stall-s", "0.5")
    with serve_process(bundle_dir, *flags, preexec_fn=limit_fds) as cli:
        port = cli["port"]
        t_start = time.monotonic()

        def live_client():
            while not stop.is_set():
                try:
                    with PolicyClient("127.0.0.1", port, timeout=30) as c:
                        while not stop.is_set():
                            c.act(obs)
                            live["bins"][int((time.monotonic() - t_start) / SERVE_CHAOS_BIN_S)] += 1
                except Exception as e:  # a reset, a shed or a fault: reconnect, note it
                    live["reconnects"] += 1
                    live["errors"][type(e).__name__] = str(e)[:160]

        thread = threading.Thread(target=live_client, name="live-client", daemon=True)
        thread.start()
        while live["reconnects"] == 0 and time.monotonic() - t_start < SERVE_CHAOS_MAX_S:
            time.sleep(0.005)  # the live client's 5th frame is reset first
        held, burst, health, t_health = collections.deque(), SERVE_CHAOS_BURST, {}, 0.0
        while True:
            now = time.monotonic() - t_start
            if now > SERVE_CHAOS_MAX_S or (now > SERVE_CHAOS_MIN_S and attacked(health)):
                break
            churn["rounds"] += 1
            pair = []
            try:
                for _ in range(burst):
                    pair.append(PolicyClient("127.0.0.1", port, timeout=30))
                for _ in range(3):
                    for c in pair:
                        c.act(obs)
                        churn["answered"] += 1
                if now - t_health > SERVE_CHAOS_BIN_S:
                    health, t_health = pair[0].healthz(), now
                    churn["healthz_reads"] += 1
            except (OSError, RuntimeError):
                churn["failed"] += 1
            held.extend(pair)
            while len(held) > SERVE_CHAOS_HELD:
                held.popleft().close()
            burst = 2
        window = time.monotonic() - t_start
        for c in held:
            c.close()
        stop.set()
        thread.join(timeout=60)
        with PolicyClient("127.0.0.1", port, timeout=30) as c:
            health = c.healthz()
    out = cli["output"]
    verdicts = [json.loads(ln.split("[flow-verdict] ", 1)[1]) for ln in out
                if ln.startswith("[flow-verdict] ")]
    witness = [ln for ln in out if ln.startswith("[lockwitness]")]
    ledger = [json.loads(ln.split("[serve] staging ledger: ", 1)[1]) for ln in out
              if ln.startswith("[serve] staging ledger: ")]
    counted = [json.loads(ln.split("[serve] kernel launches: ", 1)[1]) for ln in out
               if ln.startswith("[serve] kernel launches: ")]
    net = health["netio"]
    # the server's own account of each injection and eviction
    events = [ln for ln in out if ln.startswith(("[chaos]", "[netio]"))]
    bins = [live["bins"][k] for k in range(int(window / SERVE_CHAOS_BIN_S))]
    check(bins and min(bins) > 0, f"serve_guards_chaos: the live client went unanswered: {live}")
    check(health.get("chaos_injections") == 4, f"serve_guards_chaos: healthz {health}")
    check(attacked(health), f"serve_guards_chaos: attackers not evicted/shed in {window:.1f} s: "
                            f"{net}, churn {churn}, server events {events}")
    check(len(verdicts) == 1 and verdicts[0]["ok"], f"serve_guards_chaos: flow verdicts {verdicts}")
    check(len(witness) == 1 and " 0 contradictions" in witness[0],
          f"serve_guards_chaos: lock witness {witness}")
    check(len(ledger) == 1 and ledger[0]["trips"] == 0 and ledger[0]["active_holds"] == 0
          and ledger[0]["writes"] > 0, f"serve_guards_chaos: ledger {ledger}")
    none = {k: 0 for k in read_counts()}
    check(len(counted) == 1 and counted[0] == none,
          f"serve_guards_chaos: the server's launches {counted}, expected {none}")
    emit({"phase": "serve_guards_chaos", "card": card, "plan": SERVE_CHAOS_PLAN,
          "window_s": window, "live_client": {"answered_per_bin": bins,
                                              "reconnects": live["reconnects"],
                                              "errors": live["errors"]},
          "churn": churn, "chaos_injections": health["chaos_injections"],
          "netio": {k: net[k] for k in ("evicted_read_stall", "evicted_write_stall",
                                        "accept_shed", "conns_total", "frames_in")},
          "server_events": events, "flow_verdict": verdicts[0], "lock_witness": witness[0],
          "ledger": ledger[0], "launches": counted[0], "drained": cli["drained"],
          "startup_s": cli["startup_s"], "ok": True})
    return counted[0]


# ----------------------------------------------------- the replicated front end
ROUTER_PROFILE = (16, 16)             # the closed loop through the router and direct
ROUTER_CANARY_PLAN = "canary_corrupt@2"   # the second rollout's deploy is corrupted
ROUTER_KILL_PLAN = "replica_kill@40"      # the 40th dispatch's replica is SIGKILLed
ROUTER_KILL_REQUESTS = 400
ROUTER_CHECK_ROWS = 64               # observations held against the CPU forward a leg
ROUTER_LEG_S = 60.0                  # each rollout and the autoscaler leg: at most this long
ROUTER_FLAGS = ("--probe-interval", "0.2", "--readmit-after", "2")


def cli_start(argv, tag: str) -> dict:
    """A CLI as its own session leader (setsid), its output collected by a
    reader thread (not echoed); ``lines`` fills as it prints."""
    import threading

    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    cli = {"tag": tag, "proc": proc, "lines": [], "t0": time.perf_counter()}

    def read():
        for ln in proc.stdout:
            cli["lines"].append(ln.rstrip())

    threading.Thread(target=read, name=f"read-{tag}", daemon=True).start()
    return cli


def cli_wait(cli: dict, pred, timeout: float, what: str) -> str:
    """The first line ``pred`` accepts, waiting up to ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        for ln in list(cli["lines"]):
            if pred(ln):
                return ln
        check(cli["proc"].poll() is None and time.monotonic() < deadline,
              f"router_serve: {cli['tag']} never printed {what} (exit {cli['proc'].poll()}): "
              f"{cli['lines'][-12:]}")
        time.sleep(0.05)


def cli_port(cli: dict, timeout: float = 300.0) -> int:
    ln = cli_wait(cli, lambda x: "listening on " in x, timeout, "its port")
    cli.setdefault("startup_s", time.perf_counter() - cli["t0"])
    return int(ln.split("listening on ", 1)[1].split()[0].rsplit(":", 1)[1])


def cli_stop(cli: dict, timeout: float = 120.0) -> int:
    """SIGTERM, a bounded drain, then the group's SIGKILL (procs)."""
    from d4pg_tpu_torch.utils import procs

    rc = procs.drain_or_kill(cli["proc"], pgid=cli["proc"].pid, drain_timeout_s=timeout,
                             label=cli["tag"])
    time.sleep(0.2)  # the reader's last lines
    return rc


def replica_health(port: int) -> dict:
    from d4pg_tpu_torch.serve import protocol

    return protocol.probe_healthz("127.0.0.1", port, timeout_s=10.0)


def router_events(cli: dict) -> list:
    return [json.loads(ln.split("[router-event] ", 1)[1]) for ln in list(cli["lines"])
            if ln.startswith("[router-event] ")]


def router_serve_phase(card: str, bundle_dir: str, tmp: str) -> dict:
    """``router_serve``: the replicated front end on the card. Two serve
    CLI replicas (each on the card with its own copy of ``serve``'s
    default 3x256 bundle, its own ``--replica-id``, a 0.2 s bundle poll)
    and three router CLI processes in front of them, one leg each:

    - rollout (``--canary-bundle``, ``--chaos ROUTER_CANARY_PLAN``): the
      closed loop at ``ROUTER_PROFILE`` through the router, then directly
      against replica 0 (requests/s, client p50/p99, the router's and the
      replica's CPU-s/s); a new bundle in the canary dir is promoted,
      every replica attesting its dir's ``bundle_mtime`` and the replies
      equal to the new params' CPU forward; the next one, its deploy
      corrupted, is rolled back: the replicas attest the promoted bundle
      again and the replies equal its forward;
    - autoscaler (``--autoscale --autoscale-min 2 --autoscale-max 3``,
      ``--debug-guards``): under the closed loop it spawns a third replica
      on the card, which is admitted and answers; at the router's drain
      its pool drains that replica (rc 0) and no process of its group is
      left;
    - kill (``--chaos ROUTER_KILL_PLAN``, ``--debug-guards``): the 40th
      dispatch's replica is SIGKILLed after the send; every request is
      answered by the survivor; ``requests_total == replies_ok +
      replies_overloaded + replies_error`` exactly in healthz and in the
      ``router`` flow verdict at the drain; the killed process is gone.

    Every router drains with rc 0 and its ``[router] drained`` line; the
    guarded ones print balanced ``router``, ``router-gate`` and
    ``router-tenant`` verdicts and 0 lock-order contradictions; the
    surviving replica drains with rc 0. No hand kernel: the replicas serve
    through CUDA graphs and print their own launch counts (all 0) at
    their drain; the routers import no torch."""
    import os
    import shutil
    import signal
    import threading

    import numpy as np
    import torch

    from d4pg_tpu_torch.models.actor import Actor
    from d4pg_tpu_torch.serve import PolicyClient, export_bundle, load_bundle
    from d4pg_tpu_torch.serve.client import Overloaded
    from d4pg_tpu_torch.utils import procs

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    base = load_bundle(bundle_dir)
    dirs = [f"{tmp}/router_replica{i}" for i in range(2)]
    canary_dir = f"{tmp}/router_canary"
    os.makedirs(canary_dir)
    for d in dirs:
        shutil.copytree(bundle_dir, d)
    py = sys.executable
    replicas = [cli_start([py, "-m", "d4pg_tpu_torch.serve", "--bundle", d, "--port", "0",
                           "--replica-id", str(i), "--poll-interval", "0.2"], f"replica{i}")
                for i, d in enumerate(dirs)]
    routers, cli_lines = [], {}
    obs_check = (rng.normal(size=(ROUTER_CHECK_ROWS, 3)) * 2).astype(np.float32)
    obs_load = rng.normal(size=3).astype(np.float32)

    def start_router(tag, *flags):
        cli = cli_start([py, "-m", "d4pg_tpu_torch.serve.router", "--backends", backends,
                         "--backend-bundles", ",".join(dirs), "--port", "0", *ROUTER_FLAGS,
                         *flags], tag)
        routers.append(cli)
        port = cli_port(cli, 60)
        cli_wait(cli, lambda x: x.startswith("[router] admitted 2/2"), 60, "admitted 2/2")
        return cli, port

    def through(port, obs):
        with PolicyClient("127.0.0.1", port, timeout=60) as c:
            futs = [c.act_async(o) for o in obs]
            return np.stack([f.result(60) for f in futs])

    def traffic(port, stop, tally):
        """A pipelined client (window 8) until ``stop``: every reply is
        counted, ok or shed (a rollback re-ejects for a moment)."""
        with PolicyClient("127.0.0.1", port, timeout=60) as c:
            while not stop.is_set():
                for f in [c.act_async(obs_load) for _ in range(8)]:
                    try:
                        f.result(60)
                        tally["ok"] += 1
                    except Overloaded:
                        tally["overloaded"] += 1

    def attested():
        """Each replica's healthz ``bundle_mtime`` beside its dir's."""
        rows = []
        for i, (rep_port, d) in enumerate(zip(rep_ports, dirs)):
            h = replica_health(rep_port)
            on_disk = os.stat(os.path.join(d, "bundle.json")).st_mtime
            rows.append({"replica": i, "bundle_mtime": h["bundle_mtime"], "dir_mtime": on_disk,
                         "status": h["status"], "params_reloads": h["params_reloads"]})
        return rows

    def rollout(cli, port, seed, want):
        """Export a new bundle into the canary dir under traffic; wait for
        the terminal event ``want``; the rollout's events."""
        n0 = len(router_events(cli))
        new_actor = Actor(3, 1, base.config.hidden_sizes,
                          generator=torch.Generator().manual_seed(seed))
        export_bundle(canary_dir, base.config, new_actor,
                      action_low=base.action_low, action_high=base.action_high,
                      meta={"source": "chip_smoke router canary"})
        stop, tally = threading.Event(), {"ok": 0, "overloaded": 0}
        t = threading.Thread(target=traffic, args=(port, stop, tally), daemon=True)
        t.start()
        t0 = time.perf_counter()
        try:
            deadline = time.monotonic() + ROUTER_LEG_S
            while True:
                ev = router_events(cli)[n0:]
                kinds = [e["event"] for e in ev]
                if want in kinds:
                    break
                check(time.monotonic() < deadline and "canary_rollback_timeout" not in kinds,
                      f"router_serve: no {want} in {ROUTER_LEG_S} s: {kinds}")
                time.sleep(0.05)
            while True:  # the fleet settles: both admitted, the rollout idle
                with PolicyClient("127.0.0.1", port, timeout=60) as c:
                    h = c.healthz()
                if h["admitted"] == 2 and h["canary"]["state"] == "idle":
                    break
                check(time.monotonic() < deadline, f"router_serve: {want}: fleet never settled "
                                                   f"{h['replicas']}")
                time.sleep(0.05)
        finally:
            stop.set()
            t.join(timeout=60)
        took = time.perf_counter() - t0
        return new_actor.state_dict(), kinds, tally, took

    try:
        rep_ports = [cli_port(r) for r in replicas]
        rep_pids = [r["proc"].pid for r in replicas]
        backends = ",".join(f"127.0.0.1:{p}" for p in rep_ports)

        # ---- leg 1: load, canary promoted, canary rolled back
        a, a_port = start_router("router_rollout", "--canary-bundle", canary_dir,
                                 "--canary-fraction", "0.25", "--chaos", ROUTER_CANARY_PLAN)
        err_before = float(np.abs(through(a_port, obs_check) - cpu_actions(base, obs_check)).max())
        check(err_before <= SERVE_TOL, f"router_serve: replies off the CPU forward {err_before}")
        load = {"through_router": closed_loop(a_port, *ROUTER_PROFILE, obs_load, SERVE_LOAD_S,
                                              server_pid=a["proc"].pid, server_stats=False),
                "direct_replica0": closed_loop(rep_ports[0], *ROUTER_PROFILE, obs_load,
                                               SERVE_LOAD_S, server_pid=rep_pids[0])}
        for leg, row in load.items():
            check(row["shed"] == 0, f"router_serve load {leg}: {row['shed']} sheds")
        with PolicyClient("127.0.0.1", a_port, timeout=60) as c:
            h = c.healthz()
        per_replica_ok = [r["ok"] for r in h["replicas"]]
        check(min(per_replica_ok) > 0, f"router_serve: a replica served nothing {per_replica_ok}")

        promoted, kinds, tally_p, took_p = rollout(a, a_port, SEED + 31, "canary_promoted")
        att_p = attested()
        check(all(r["bundle_mtime"] == r["dir_mtime"] and r["status"] == "ok" for r in att_p),
              f"router_serve: promote not attested {att_p}")
        err_p = float(np.abs(through(a_port, obs_check)
                             - cpu_actions(base, obs_check, promoted)).max())
        check(err_p <= SERVE_TOL, f"router_serve: promoted replies off the new forward {err_p}")
        _, kinds_r, tally_r, took_r = rollout(a, a_port, SEED + 37, "canary_rolled_back")
        check("canary_rollback" in kinds_r, f"router_serve: rollback events {kinds_r}")
        att_r = attested()
        check(all(r["bundle_mtime"] == r["dir_mtime"] and r["status"] == "ok" for r in att_r),
              f"router_serve: rollback not attested {att_r}")
        err_r = float(np.abs(through(a_port, obs_check)
                             - cpu_actions(base, obs_check, promoted)).max())
        check(err_r <= SERVE_TOL, f"router_serve: rolled-back replies off the promoted "
                                  f"forward {err_r}")
        with PolicyClient("127.0.0.1", a_port, timeout=60) as c:
            ha = c.healthz()
        check(ha["canary_promotions"] == 1 and ha["canary_rollbacks"] == 1
              and ha["chaos_injections"] == 1,
              f"router_serve: promotions {ha['canary_promotions']}, rollbacks "
              f"{ha['canary_rollbacks']}, injections {ha['chaos_injections']}")
        check(ha["requests_total"] == ha["replies_ok"] + ha["replies_overloaded"]
              + ha["replies_error"], f"router_serve: rollout router identity {ha}")
        rollback = next(e for e in router_events(a) if e["event"] == "canary_rollback")
        check(cli_stop(a) == 0 and any(ln.startswith("[router] drained:") for ln in a["lines"]),
              f"router_serve: rollout router drain {a['lines'][-6:]}")

        # ---- leg 2: the autoscaler spawns a third replica on the card
        b, b_port = start_router(
            "router_autoscale", "--autoscale", "--autoscale-min", "2", "--autoscale-max", "3",
            "--autoscale-interval", "0.5", "--autoscale-samples", "2",
            "--autoscale-cooldown", "600", "--autoscale-workdir", f"{tmp}/router_autoscale",
            "--debug-guards")
        stop, tally_a = threading.Event(), {"ok": 0, "overloaded": 0}
        threads = [threading.Thread(target=traffic, args=(b_port, stop, tally_a), daemon=True)
                   for _ in range(ROUTER_PROFILE[0] // 4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        try:
            deadline = time.monotonic() + ROUTER_LEG_S
            while True:
                with PolicyClient("127.0.0.1", b_port, timeout=60) as c:
                    hb = c.healthz()
                third = [r for r in hb["replicas"] if r["index"] == 2]
                if third and third[0]["admitted"] and third[0]["ok"] > 0:
                    break
                check(time.monotonic() < deadline,
                      f"router_serve: no third replica admitted and answering: {hb['replicas']}, "
                      f"{b['lines'][-8:]}")
                time.sleep(0.2)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        scale_up_s = time.perf_counter() - t0
        third_row = dict(third[0])
        check(cli_stop(b) == 0, f"router_serve: autoscale router drain {b['lines'][-8:]}")
        out_b = b["lines"]
        spawned_drained = [ln for ln in out_b if ln.startswith("[autoscale-r1] [serve] drained")]
        scaler_line = [ln for ln in out_b if ln.startswith("[router] autoscaler: ")]
        check(spawned_drained and scaler_line and "'scale_ups': 1" in scaler_line[0],
              f"router_serve: the spawned replica's drain {out_b[-12:]}")
        check(not any("drained rc=" in ln for ln in out_b),
              f"router_serve: the spawned replica drained with an error {out_b[-12:]}")
        orphans = procs.reap_orphans([b["proc"].pid], label="router_autoscale")
        check(orphans == [], f"router_serve: orphans of the autoscale router {orphans}")

        # ---- leg 3: replica_kill mid-stream
        c_cli, c_port = start_router("router_kill", "--chaos", ROUTER_KILL_PLAN,
                                     "--debug-guards")
        answered = {"ok": 0, "overloaded": 0, "error": 0}
        with PolicyClient("127.0.0.1", c_port, timeout=60) as c:
            futs = []
            for i in range(ROUTER_KILL_REQUESTS):
                futs.append(c.act_async(obs_load))
                if len(futs) >= 8:
                    f = futs.pop(0)
                    try:
                        f.result(60)
                        answered["ok"] += 1
                    except Overloaded:
                        answered["overloaded"] += 1
                    except Exception:
                        answered["error"] += 1
            for f in futs:
                try:
                    f.result(60)
                    answered["ok"] += 1
                except Overloaded:
                    answered["overloaded"] += 1
                except Exception:
                    answered["error"] += 1
            deadline = time.monotonic() + 30
            while c.healthz()["admitted"] != 1:
                check(time.monotonic() < deadline, "router_serve: the killed replica never ejected")
                time.sleep(0.1)
            hc = c.healthz()
        killed = [i for i, r in enumerate(replicas) if r["proc"].poll() is not None]
        check(len(killed) == 1 and replicas[killed[0]]["proc"].returncode == -signal.SIGKILL,
              f"router_serve: killed replicas {killed}")
        check(not procs.pid_alive(rep_pids[killed[0]]), "router_serve: the killed replica lives")
        identity = hc["requests_total"] == (hc["replies_ok"] + hc["replies_overloaded"]
                                            + hc["replies_error"]) == ROUTER_KILL_REQUESTS
        check(identity and answered["ok"] == hc["replies_ok"] and hc["chaos_injections"] == 1,
              f"router_serve: kill leg identity {answered}, healthz {hc}")
        check(cli_stop(c_cli) == 0, f"router_serve: kill router drain {c_cli['lines'][-8:]}")
        survivor = replicas[1 - killed[0]]
        check(cli_stop(survivor) == 0, f"router_serve: survivor drain {survivor['lines'][-8:]}")
    finally:
        for cli in routers + replicas:
            if cli["proc"].poll() is None:
                procs.drain_or_kill(cli["proc"], pgid=cli["proc"].pid, sig=signal.SIGKILL,
                                    drain_timeout_s=10, label=cli["tag"])
        procs.reap_orphans([cli["proc"].pid for cli in routers + replicas], label="router_serve")
    for cli in routers + replicas:
        cli_lines[cli["tag"]] = cli["lines"]
    guarded = {}
    for cli in (b, c_cli):
        verdicts = [json.loads(ln.split("[flow-verdict] ", 1)[1]) for ln in cli["lines"]
                    if ln.startswith("[flow-verdict] ")]
        witness = [ln for ln in cli["lines"] if ln.startswith("[lockwitness]")]
        check(sorted(v["family"] for v in verdicts) == ["router", "router-gate", "router-tenant"]
              and all(v["ok"] for v in verdicts),
              f"router_serve: {cli['tag']} flow verdicts {verdicts}")
        check(len(witness) == 1 and " 0 contradictions" in witness[0],
              f"router_serve: {cli['tag']} lock witness {witness}")
        guarded[cli["tag"]] = {"verdicts": {v["family"]: v["counters"] for v in verdicts},
                               "lock_witness": witness[0]}
    launches = [json.loads(ln.split("[serve] kernel launches: ", 1)[1])
                for r in replicas for ln in r["lines"]
                if ln.startswith("[serve] kernel launches: ")]
    spawned = [json.loads(ln.split("[serve] kernel launches: ", 1)[1]) for ln in b["lines"]
               if "[serve] kernel launches: " in ln]
    none = {k: 0 for k in read_counts()}
    check(len(launches) == 1 and all(x == none for x in launches + spawned) and spawned,
          f"router_serve: replica launches {launches} {spawned}, expected {none}")
    drained = {cli["tag"]: next((ln for ln in cli["lines"]
                                 if ln.startswith(("[router] drained:", "[serve] drained:"))),
                                None)
               for cli in routers + replicas}
    emit({"phase": "router_serve", "card": card,
          "replicas": {"count": 2, "bundle": "serve's default 3x256 (Pendulum)",
                       "startup_s": [r["startup_s"] for r in replicas],
                       "killed": killed[0]},
          "load": load, "per_replica_ok": per_replica_ok,
          "router_over_direct": (load["through_router"]["requests_per_s"]
                                 / load["direct_replica0"]["requests_per_s"]),
          "router_cpu_s_per_s": load["through_router"]["server_process_cpu_s_per_s"],
          "replies_vs_cpu": {"before": err_before, "promoted": err_p, "rolled_back": err_r,
                             "rows": ROUTER_CHECK_ROWS, "tolerance": SERVE_TOL},
          "canary_promoted": {"events": kinds, "s": took_p, "traffic": tally_p,
                              "attested": att_p},
          "canary_rolled_back": {"events": kinds_r, "s": took_r, "traffic": tally_r,
                                 "reason": rollback["reason"], "attested": att_r},
          "autoscale": {"third_replica": third_row, "scale_up_to_answer_s": scale_up_s,
                        "traffic": tally_a, "spawned_drained": spawned_drained[0],
                        "autoscaler": scaler_line[0], "orphans": orphans},
          "replica_kill": {"plan": ROUTER_KILL_PLAN, "answered": answered,
                           "healthz": {k: hc[k] for k in ("requests_total", "replies_ok",
                                                          "replies_overloaded", "replies_error",
                                                          "retries", "ejections")}},
          "guarded_routers": guarded, "drained": drained, "launches": none,
          "phase_s": time.perf_counter() - t_phase, "ok": True})
    return none


# ------------------------------------------------------------ data parallelism
DP_LANES = 2                          # lanes (--dp) of every dp phase
DP_STEPS = 200                        # grad steps of dp_lanes and of each dp_host run
DP_RANK_ROUNDS = (4096, 1024, 1024, 1024)   # rows written before each dp_ranks dispatch
DP_EVAL_EPISODES = 2
COMBINE_REPS = 50                     # timed combines (one grad step's) per line
DP_TIMEOUT_S = 300


def dp_lanes_phase(Trainer, TrainConfig, cuda_tree, dper, card: str, log_dir: str) -> dict:
    """(a) The ``Trainer`` on ``--replay-placement device --p-replay --dp 2``
    in one process, both lanes on ``cuda:0``: 200 grad steps (25
    dispatches of K = 8, B = 256 as 128 a lane, a 1M-row ring striped as
    2 x 500 000 rows with a 2^19-leaf subtree a lane), every dispatch after
    the first under the sync guard. Exact launches (B3 once a lane a
    dispatch, B1f and B1b once a lane a grad step, B2 = B4 = 0), finite
    metrics, the lanes' max_priority equal and off 1.0; then each lane's
    B3 on its own leaves against the plain version (valid under a float64
    cumsum within ``chain_length(2^19)``), and one grad step's combine
    timed on the card."""
    import torch

    from d4pg_tpu_torch.tools import dp_ranks

    n = DP_STEPS
    cfg = TrainConfig(
        env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n,
        eval_episodes=DP_EVAL_EPISODES, log_dir=log_dir, seed=SEED, replay_placement="device",
        prioritized=True, steps_per_dispatch=K, debug_guards=True, dp=DP_LANES,
    )
    trainer = Trainer(cfg, device="cuda")
    try:
        reset_counts()
        t0 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        dispatched = trainer._dispatches
        combine = dp_ranks.combine_ms(trainer._megastep.sync, trainer.state, trainer.device,
                                      COMBINE_REPS)
    finally:
        trainer.close()
    c = trainer.config
    expect = dict(fused_fwd=DP_LANES * n, fused_bwd=DP_LANES * n, project=0,
                  tree_count=DP_LANES * n // K, fused_step=0)
    check(launches == expect, f"dp_lanes: launch counts {launches}, expected {expect}")
    check(dispatched == n // K and trainer.grad_steps == n,
          f"dp_lanes: {dispatched} dispatches for {trainer.grad_steps} grad steps")
    for key in FINITE_KEYS:
        check(key in row and row[key] == row[key] and abs(row[key]) != float("inf"),
              f"dp_lanes: {key} not finite: {row.get(key)}")
    trees = trainer._dev_per.trees
    mps = [float(t.max_priority) for t in trees]
    check(len(set(mps)) == 1 and mps[0] > 1.0, f"dp_lanes: lane max priorities {mps}")
    gen = torch.Generator(trainer.device).manual_seed(SEED + 16)
    b3 = []
    b_local = c.batch_size // DP_LANES
    for d, tree in enumerate(trees):
        half = tree.sums.shape[0] // 2
        leaves = tree.sums[half:]
        L = leaves.numel()
        check(L == TREE_L // 2, f"dp_lanes: lane {d} has {L} leaves, not 2^19")
        chain = cuda_tree.chain_length(L)
        u = torch.rand((K, b_local), generator=gen, device=trainer.device)
        pre = dper.stratified_prefixes(u, K, b_local, tree.sums[1])
        idx, _ = cuda_tree.find_prefix(leaves, pre)
        plain = cuda_tree.find_prefix_plain(leaves, pre)
        ok = valid_under_f64(leaves, pre, idx, chain)
        check(bool(ok.all()), f"dp_lanes: lane {d} B3 L=2^19: {int((~ok).sum())} invalid draws")
        b3.append({"lane": d, "L": L, "filled": int((leaves > 0).sum()), "chain": chain,
                   "draws_differing_from_plain": int((idx != plain).sum()),
                   "max_index_distance": int((idx.long() - plain.long()).abs().max())})
    emit({
        "phase": "dp_lanes", "card": card, "lanes": DP_LANES, "processes": 1,
        "backend": None, "devices": [str(trainer.mesh.lane_device(d)) for d in range(DP_LANES)],
        "width": {"hidden": list(c.agent.hidden_sizes), "atoms": c.agent.dist.num_atoms,
                  "batch": c.batch_size, "batch_per_lane": b_local, "n_step": c.agent.n_step,
                  "replay_capacity": c.replay_capacity, "lane_tree_leaves": TREE_L // 2,
                  "steps_per_dispatch": K},
        "grad_steps": n, "dispatches": n // K,
        "sync_guard": "set_sync_debug_mode('error') on every dispatch after the first",
        "wall_s_incl_warmup_and_eval": wall,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "combine_ms_per_grad_step": combine,
        "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
        "priority_mean": row["priority_mean"], "eval_return_mean": row["eval_return_mean"],
        "max_priority": mps[0], "launches": launches, "b3_lanes": b3, "ok": True,
    })
    return launches


def dp_ranks_phase(TrainConfig, card: str) -> dict:
    """(b) Two ranks spawned over gloo on ``cuda:0``, one lane each, drive
    the sharded device-PER megastep directly (``tools/dp_ranks.py``) on
    one seeded stream dealt by the striped layout: 4 dispatches of K = 8
    interleaved with ingest, under the sync guard, at full width with the
    1M-row replay; the train state, each lane's ring rows and subtree and
    max_priority ``torch.equal`` to the one-process 2-lane run of the same
    code. The train CLI as two such processes runs in
    ``host_kill_relaunch``."""
    from d4pg_tpu_torch.config import apply_env_preset
    from d4pg_tpu_torch.parallel.mesh import make_mesh
    from d4pg_tpu_torch.tools import dp_ranks

    c = apply_env_preset(TrainConfig(env="pendulum"))
    kw = dict(agent_cfg=c.agent, capacity=c.replay_capacity, rounds=list(DP_RANK_ROUNDS), k=K,
              batch=c.batch_size, seed=SEED, guard=True, combine_reps=COMBINE_REPS)
    t0 = time.perf_counter()
    one = dp_ranks.run_lanes(make_mesh(DP_LANES, device="cuda", num_processes=1,
                                       process_index=0), **kw)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = dp_ranks.spawn_ranks(DP_LANES, DP_LANES, "cuda", timeout_s=DP_TIMEOUT_S, **kw)
    ranks_s = time.perf_counter() - t0
    eq = dp_ranks.compare(one, ranks)
    check(all(eq.values()), f"dp_ranks: two ranks differ from two lanes: {eq}")
    d = len(DP_RANK_ROUNDS)
    want_one = dict(fused_fwd=DP_LANES * d * K, fused_bwd=DP_LANES * d * K, project=0,
                    tree_count=DP_LANES * d, fused_step=0)
    check(one["launches"] == want_one, f"dp_ranks: one-process launches {one['launches']}")
    want_rank = {k: v // DP_LANES for k, v in want_one.items()}
    for r in ranks:
        check(r["launches"] == want_rank, f"dp_ranks: rank launches {r['launches']}")
    for key, v in one["metrics"].items():
        check(bool(v.isfinite()), f"dp_ranks: {key} not finite: {float(v)}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in want_one}
    emit({
        "phase": "dp_ranks", "card": card, "lanes": DP_LANES, "processes": DP_LANES,
        "backends": [r["backend"] for r in ranks],
        "width": {"hidden": list(c.agent.hidden_sizes), "atoms": c.agent.dist.num_atoms,
                  "batch": c.batch_size, "batch_per_lane": c.batch_size // DP_LANES,
                  "replay_capacity": c.replay_capacity, "lane_tree_leaves": TREE_L // 2,
                  "steps_per_dispatch": K},
        "rounds": list(DP_RANK_ROUNDS), "dispatches": d, "grad_steps": d * K,
        "sync_guard": "set_sync_debug_mode('error') on every dispatch after the first, "
                      "lifted inside each collective",
        "torch_equal": eq,
        "one_process_s": one_s, "ranks_s_incl_spawn": ranks_s,
        "rank_wall_s": [r["wall_s"] for r in ranks],
        # over dispatches 2-4 and the ingest between them (the first
        # dispatch loads the kernels and the lanes' state)
        "grad_steps_per_sec_one_process_lanes": (d - 1) * K / one["steady_s"],
        "grad_steps_per_sec_ranks": [(d - 1) * K / r["steady_s"] for r in ranks],
        "combine_ms_per_grad_step": {"one_process": one["combine_ms"],
                                     "ranks": [r["combine_ms"] for r in ranks]},
        "launches": launches, "launches_one_process": one["launches"],
        "metrics": {k: float(v) for k, v in one["metrics"].items()},
        "ok": True,
    })
    return launches


def dp_host_run(Trainer, TrainConfig, mode: str, card: str, log_dir: str) -> dict:
    """(c) The host placement with ``--dp 2 --steps-per-dispatch 8`` (the
    lanes' gradients combined every step) or ``--dp-hogwild`` (each lane
    steps its own copy through the dispatch, then one fixed-order mean of
    every float tensor), 200 grad steps at full width on the native tree,
    every dispatch after the first under the sync guard. B1f = B1b = 400
    (one a lane a step), the rest 0; finite metrics; the combine's ms a
    grad step on the card."""
    import torch

    from d4pg_tpu_torch.tools import dp_ranks

    n = DP_STEPS
    cfg = TrainConfig(
        env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n,
        eval_episodes=DP_EVAL_EPISODES, log_dir=log_dir, seed=SEED, replay_placement="host",
        prioritized=True, tree_backend="native", steps_per_dispatch=K, debug_guards=True,
        dp=DP_LANES, dp_hogwild=mode == "dp_hogwild",
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
        fused = trainer._dp_fused
        if mode == "dp_hogwild":
            # one resync a dispatch (the copies are equal after it, so
            # another leaves them as they are), a K-th of it a grad step
            combine = call_ms(fused._resync, n=COMBINE_REPS, warmup=3) / K
        else:
            combine = dp_ranks.combine_ms(fused.sync, trainer.state, trainer.device,
                                          COMBINE_REPS)
    finally:
        trainer.close()
    expect = dict(fused_fwd=DP_LANES * n, fused_bwd=DP_LANES * n, project=0, tree_count=0,
                  fused_step=0)
    check(launches == expect, f"{mode}: launch counts {launches}, expected {expect}")
    check(stages["stage_train_dispatch_calls"] == n // K and trainer.grad_steps == n,
          f"{mode}: {stages['stage_train_dispatch_calls']} dispatches for "
          f"{trainer.grad_steps} grad steps")
    for key in FINITE_KEYS:
        check(key in row and row[key] == row[key] and abs(row[key]) != float("inf"),
              f"{mode}: {key} not finite: {row.get(key)}")
    emit({
        "phase": "dp_host", "mode": mode, "card": card, "lanes": DP_LANES, "processes": 1,
        "backend": None, "tree_backend": trainer.buffer.tree_backend,
        "width": {"hidden": list(trainer.config.agent.hidden_sizes),
                  "batch": trainer.config.batch_size, "steps_per_dispatch": K},
        "grad_steps": n, "dispatches": n // K,
        "sync_guard": "set_sync_debug_mode('error') on every dispatch after the first",
        "wall_s_incl_warmup_and_eval": wall,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "combine_ms_per_grad_step": combine,
        "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
        "priority_mean": row["priority_mean"], "eval_return_mean": row["eval_return_mean"],
        "launches": launches, "stage_ms_per_step": stage_ms_per_step(stages, n), "ok": True,
    })
    return launches


TP = 2                                # tp lanes of every tp phase
TP_STEPS = 96                         # grad steps of tp_host (12 dispatches of K = 8)
TP_MEMBERS_E, TP_MEMBERS_B = 10, 2048  # tp_members: the large_batch recipe's REDQ
TP_TIMED_STEPS = 10                   # timed steps of each tp_members arm
OD_DP_ENVS = 8                        # on_device_dp's envs (4 a lane): K = 256 a train iteration
OD_DP_ITERS = 2
BF16_REL = 6 * 2.0**-7                # the bfloat16 tolerance of tests/test_torch_stacked.py
LEG_DISPATCHES, LEG_K = 2, 4          # the tp gloo leg's depth
LEG_OD = dict(num_envs=8, capacity=4096, k=64, iterations=1)   # the on-device gloo leg's


def _close_params(a, b, lr: float) -> float:
    """Max |a - b| over two whole states' networks, checked within 10·lr
    (one or a few Adam steps: a near-zero gradient coordinate may take the
    other sign and move its weight by 2·lr)."""
    worst = 0.0
    for net in ("actor", "critic", "target_actor", "target_critic"):
        for (name, x), y in zip(getattr(a, net).named_parameters(),
                                getattr(b, net).parameters()):
            d = float((x.detach().float().cpu() - y.detach().float().cpu()).abs().max())
            check(d <= 10 * lr, f"{net}.{name} differs by {d:.3e} > 10·lr")
            worst = max(worst, d)
    return worst


def _replicas_equal(tps) -> int:
    """Every replicated leaf (and its Adam moments) torch.equal on every tp
    lane; returns how many leaves were checked."""
    from d4pg_tpu_torch.parallel.partition import tp_dim

    n = 0
    for net, opt in ((tps.actor, tps.actor_opt), (tps.critic, tps.critic_opt),
                     (tps.target_actor, None), (tps.target_critic, None)):
        for name, spec in net.specs.items():
            if tp_dim(spec) is not None:
                continue
            lanes = net.lane_params(name)
            check(all(torch_equal(lanes[0], q) for q in lanes[1:]),
                  f"replicated {name} differs across tp lanes")
            if opt is not None and opt.state.get(lanes[0]):
                check(all(torch_equal(opt.state[lanes[0]][k], opt.state[q][k])
                          for q in lanes[1:] for k in ("exp_avg", "exp_avg_sq")),
                      f"replicated {name}'s Adam moments differ across tp lanes")
            n += 1
    return n


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def tp_host_phase(Trainer, TrainConfig, card: str, log_dir: str) -> dict:
    """``tp_host``: (1) one TP step of ``--dp 2 --tp 2`` on a 256-row
    batch at the pendulum preset's full width (3x256, 51 atoms) on the
    card, against the unsharded single-device step on the card from the
    same weights: priorities rtol 1e-4 / atol 1e-5 and critic_loss within
    1e-4 relative (before any update), q_mean within 0.3, every parameter
    within 10·lr (after one Adam step); each tp lane holds only its
    shards (hidden_0 128 of 256 columns) and every replicated leaf is
    torch.equal across the tp lanes. (2) The ``Trainer`` with ``--dp 2
    --tp 2 --steps-per-dispatch 8`` on the host placement (native tree),
    96 grad steps, every dispatch after the first under the sync guard:
    B1f = B1b = 1 a dp lane a grad step (192), the rest 0; finite metrics;
    the replicated leaves still equal."""
    import copy

    import numpy as np
    import torch

    from d4pg_tpu_torch.agent import create_train_state, train_step
    from d4pg_tpu_torch.config import apply_env_preset
    from d4pg_tpu_torch.parallel.mesh import make_mesh
    from d4pg_tpu_torch.parallel.partition import auto_parallel_train_step

    agent = apply_env_preset(TrainConfig(env="pendulum")).agent
    B = 256
    batch = {k: torch.from_numpy(v).cuda() for k, v in step_batch(np.random.default_rng(SEED + 17), B).items()}
    whole = create_train_state(agent, SEED, "cuda")
    mesh = make_mesh(DP_LANES, TP, device="cuda", num_processes=1, process_index=0)
    step = auto_parallel_train_step(agent, mesh)
    tps = step.shard(copy.deepcopy(whole))
    check(tps.critic.lane_params("hidden_0.weight")[1].shape[0] == 128,
          "tp_host: hidden_0's shard is not 128 of 256 columns")
    reset_counts()
    _, tm, tpri = step(tps, batch)
    one_launch = read_counts()
    _, wm, wpri = train_step(agent, whole, batch)
    tm = {k: float(v) for k, v in tm.items()}
    wm = {k: float(v) for k, v in wm.items()}
    tpri, wpri = tpri.cpu().numpy(), wpri.cpu().numpy()
    pri_err = float(np.abs(tpri - wpri).max())
    check(np.allclose(tpri, wpri, rtol=1e-4, atol=1e-5), f"tp_host: priorities differ by {pri_err:.3e}")
    check(abs(tm["critic_loss"] - wm["critic_loss"]) <= 1e-4 * abs(wm["critic_loss"]) + 1e-5,
          f"tp_host: critic_loss {tm['critic_loss']} vs {wm['critic_loss']}")
    check(abs(tm["q_mean"] - wm["q_mean"]) <= 0.3, f"tp_host: q_mean {tm['q_mean']} vs {wm['q_mean']}")
    param_err = _close_params(tps.whole(), whole, agent.lr_critic)
    n_rep = _replicas_equal(tps)
    check(one_launch["fused_fwd"] == DP_LANES and one_launch["fused_bwd"] == DP_LANES,
          f"tp_host: one TP step launched {one_launch}")

    n = TP_STEPS
    cfg = TrainConfig(
        env="pendulum", total_steps=n, warmup_steps=1000, eval_interval=n,
        eval_episodes=DP_EVAL_EPISODES, log_dir=log_dir, seed=SEED, replay_placement="host",
        prioritized=True, tree_backend="native", steps_per_dispatch=K, debug_guards=True,
        dp=DP_LANES, tp=TP,
    )
    trainer = Trainer(cfg, device="cuda")
    try:
        check(getattr(trainer.state, "tp", None) == TP, "tp_host: the trainer's state is not sharded")
        reset_counts()
        t0 = time.perf_counter()
        row = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        stages = trainer.timers.scalars()
        n_rep_run = _replicas_equal(trainer.state)
        combine = call_ms(lambda: [trainer._dp_fused.sync(torch.zeros(DP_LANES, k_, device="cuda"))
                                   for k_ in trainer.state.critic.lane_numels()
                                   + trainer.state.actor.lane_numels() + [5]],
                          n=COMBINE_REPS, warmup=3)
    finally:
        trainer.close()
    expect = dict(fused_fwd=DP_LANES * n, fused_bwd=DP_LANES * n, project=0, tree_count=0,
                  fused_step=0)
    check(launches == expect, f"tp_host: launch counts {launches}, expected {expect}")
    check(stages["stage_train_dispatch_calls"] == n // K and trainer.grad_steps == n,
          f"tp_host: {stages['stage_train_dispatch_calls']} dispatches for "
          f"{trainer.grad_steps} grad steps")
    for key in FINITE_KEYS:
        check(key in row and row[key] == row[key] and abs(row[key]) != float("inf"),
              f"tp_host: {key} not finite: {row.get(key)}")
    emit({
        "phase": "tp_host", "card": card, "dp": DP_LANES, "tp": TP, "processes": 1,
        "width": {"hidden": list(agent.hidden_sizes), "atoms": agent.dist.num_atoms,
                  "batch": cfg.batch_size, "batch_per_dp_lane": cfg.batch_size // DP_LANES,
                  "steps_per_dispatch": K},
        "kinds": {"actor": trainer.state.actor.kinds, "critic": trainer.state.critic.kinds},
        "step_vs_unsharded": {"priority_max_abs_err": pri_err, "param_max_abs_err": param_err,
                              "tp": tm, "unsharded": wm, "launches": one_launch,
                              "replicated_leaves_equal": n_rep},
        "grad_steps": n, "dispatches": n // K,
        "sync_guard": "set_sync_debug_mode('error') on every dispatch after the first",
        "wall_s_incl_warmup_and_eval": wall,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "combine_ms_per_grad_step": combine,
        "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
        "priority_mean": row["priority_mean"], "eval_return_mean": row["eval_return_mean"],
        "replicated_leaves_equal_after_run": n_rep_run,
        "launches": launches, "stage_ms_per_step": stage_ms_per_step(stages, n), "ok": True,
    })
    return launches


def tp_members_phase(card: str) -> dict:
    """``tp_members``: ``auto_parallel_train_step(ensemble_axis="tp")`` on
    the large_batch recipe's critic (REDQ, E = 10, M = 2, bfloat16
    compute, B = 2048) over (dp 1, tp 2): each tp lane holds 5 whole
    members. One step against the unsharded stacked step on the card, the
    same subset fed to both: priorities and critic_loss within BF16_REL
    (6·2^-7) relative, every parameter within 10·lr; B1f = B1b = 2 (one
    stacked launch a tp lane, 5 members each). Then each arm's ms a grad
    step (median of 10, CUDA events)."""
    import copy

    import numpy as np
    import torch

    from d4pg_tpu_torch.agent import create_train_state, train_step
    from d4pg_tpu_torch.agent.d4pg import draw_subset
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.models.critic import DistConfig
    from d4pg_tpu_torch.parallel.mesh import make_mesh
    from d4pg_tpu_torch.parallel.partition import auto_parallel_train_step, shard_batch

    agent = D4PGConfig(dist=DistConfig(v_min=-300.0, v_max=0.0), n_step=3,
                       compute_dtype="bfloat16", critic_ensemble=TP_MEMBERS_E,
                       ensemble_min_targets=2)
    B = TP_MEMBERS_B
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in step_batch(np.random.default_rng(SEED + 18), B).items()}
    whole = create_train_state(agent, SEED, "cuda")
    mesh = make_mesh(1, TP, device="cuda", num_processes=1, process_index=0)
    step = auto_parallel_train_step(agent, mesh, ensemble_axis="tp")
    tps = step.shard(copy.deepcopy(whole))
    check(tps.critic.member_parts == [TP_MEMBERS_E // TP] * TP,
          f"tp_members: member blocks {tps.critic.member_parts}")
    subset = draw_subset(agent, whole)
    lanes = shard_batch(batch, mesh)
    reset_counts()
    _, tm, tpri = train_step(agent, tps, lanes, subset=subset, sync_fn=step.sync)
    launches = read_counts()
    _, wm, wpri = train_step(agent, whole, batch, subset=subset)
    tm = {k: float(v) for k, v in tm.items()}
    wm = {k: float(v) for k, v in wm.items()}
    tpri, wpri = tpri.cpu().numpy(), wpri.cpu().numpy()
    pri_err = float(np.abs(tpri - wpri).max())
    check(np.allclose(tpri, wpri, rtol=BF16_REL, atol=0), f"tp_members: priorities differ by {pri_err:.3e}")
    check(abs(tm["critic_loss"] - wm["critic_loss"]) <= BF16_REL * abs(wm["critic_loss"]),
          f"tp_members: critic_loss {tm['critic_loss']} vs {wm['critic_loss']}")
    param_err = _close_params(tps.whole(), whole, agent.lr_critic)
    n_rep = _replicas_equal(tps)
    expect = dict(fused_fwd=TP, fused_bwd=TP, project=0, tree_count=0, fused_step=0)
    check(launches == expect, f"tp_members: launch counts {launches}, expected {expect}")

    def timed(fn) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(TP_TIMED_STEPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    tp_ms = timed(lambda: train_step(agent, tps, lanes, subset=subset, sync_fn=step.sync))
    whole_ms = timed(lambda: train_step(agent, whole, batch, subset=subset))
    emit({
        "phase": "tp_members", "card": card, "dp": 1, "tp": TP, "members": TP_MEMBERS_E,
        "members_per_tp_lane": TP_MEMBERS_E // TP, "batch": B, "compute_dtype": "bfloat16",
        "kinds": tps.critic.kinds, "subset": subset.tolist(),
        "priority_max_abs_err": pri_err, "param_max_abs_err": param_err,
        "tp": tm, "unsharded": wm, "replicated_leaves_equal": n_rep, "launches": launches,
        "ms_per_grad_step": {"tp_members": tp_ms, "unsharded": whole_ms},
        "ok": True,
    })
    return launches


def on_device_dp_phase(TrainConfig, card: str, log_dir: str) -> dict:
    """``on_device_dp``: (1) one iteration of the on-device loop on two
    lanes (pendulum at 3x256, 4 envs and B = 64 over the lanes, K = 4) on
    the card against the same on the CPU, the rollout noise and the PER
    draws fed to both from one NumPy stream: each lane's ring rows within
    rtol 1e-4 / atol 1e-4 (a Pendulum step and an actor forward on each
    device, n-step sums), priorities rtol 1e-3, metrics rtol 1e-3, every
    parameter within 10·lr. (2) ``OnDeviceRun`` with ``--on-device --dp
    2`` (8 envs, 4 a lane: K = 256 an iteration, B = 256 as 128 a lane),
    one warmup segment and two train iterations, every iteration after
    the first under the sync guard: B1f = B1b = 1 a lane a grad step
    (1024), the rest 0; finite metrics; replay_size the lanes' sum."""
    import numpy as np
    import torch

    from d4pg_tpu_torch.agent import create_train_state
    from d4pg_tpu_torch.agent.d4pg import make_noise
    from d4pg_tpu_torch.config import apply_env_preset
    from d4pg_tpu_torch.envs import make_env
    from d4pg_tpu_torch.parallel.mesh import make_mesh
    from d4pg_tpu_torch.runtime.on_device import OnDeviceRun, make_on_device_trainer

    agent = apply_env_preset(TrainConfig(env="pendulum")).agent
    n_env, seg, k, b = 4, 32, 4, 64
    rng = np.random.default_rng(SEED + 19)
    noise = [[rng.normal(0, 0.3, (n_env // DP_LANES, 1)).astype(np.float32)
              for _ in range(2 * seg)] for _ in range(DP_LANES)]
    draws = [torch.from_numpy(rng.uniform(size=(k, b // DP_LANES)).astype(np.float32))
             for _ in range(DP_LANES)]
    out = {}
    for side, dev in (("card", "cuda"), ("host", "cpu")):
        def fed(blocks, dev=dev):
            steps = [torch.from_numpy(x).to(dev) for x in blocks]
            init, _, reset = make_noise(agent, (n_env // DP_LANES,), dev)
            return init, (lambda state, gen, shape: (steps.pop(0), state)), reset

        mesh = make_mesh(DP_LANES, device=dev, num_processes=1, process_index=0)
        init_fn, warm, it = make_on_device_trainer(
            agent, make_env("pendulum"), num_envs=n_env, replay_capacity=512, batch_size=b,
            train_steps_per_iter=k, device=dev, mesh=mesh, noise_fns=[fed(x) for x in noise])
        carry = init_fn(create_train_state(agent, SEED, dev), SEED)
        if side == "host":  # the card's reset states, so both roll the same envs
            carry = carry._replace(env_states=[type(e)(*(t.cpu() for t in e))
                                               for e in out["card"][2]],
                                   obs=[o.cpu() for o in out["card"][3]])
        env0, obs0 = carry.env_states, carry.obs
        carry, m = it(warm(carry, 3.0), 1.0, draws=[d.to(dev) for d in draws])
        out[side] = (carry, {key: float(v) for key, v in m.items()}, env0, obs0)
    (cc, cm, _, _), (hc, hm, _, _) = out["card"], out["host"]
    row_err = 0.0
    for lane in range(DP_LANES):
        for f in ("obs", "action", "reward", "next_obs", "discount"):
            x, y = getattr(cc.replay[lane], f).cpu(), getattr(hc.replay[lane], f)
            check(torch.allclose(x, y, rtol=1e-4, atol=1e-4), f"on_device_dp: lane {lane} {f}")
            row_err = max(row_err, float((x - y).abs().max()))
        check(torch.allclose(cc.replay[lane].priority.cpu(), hc.replay[lane].priority, rtol=1e-3),
              f"on_device_dp: lane {lane} priorities")
    for key in hm:
        check(abs(cm[key] - hm[key]) <= 1e-3 * abs(hm[key]) + 1e-6,
              f"on_device_dp: {key} {cm[key]} (card) vs {hm[key]} (CPU)")
    param_err = _close_params(cc.state, hc.state, agent.lr_critic)

    k_run = OD_DP_ENVS * SEGMENT_LEN_OD
    cfg = TrainConfig(env="pendulum", num_envs=OD_DP_ENVS, n_step=3, warmup_steps=k_run,
                      total_steps=OD_DP_ITERS * k_run, eval_interval=OD_DP_ITERS * k_run,
                      eval_episodes=DP_EVAL_EPISODES, log_dir=log_dir, seed=SEED,
                      debug_guards=True, dp=DP_LANES)
    run = OnDeviceRun(cfg, device="cuda")
    check(run.mesh is not None and run.mesh.dp == DP_LANES, "on_device_dp: no mesh")
    reset_counts()
    t0 = time.perf_counter()
    row = run.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n = OD_DP_ITERS * run.K
    expect = dict(fused_fwd=DP_LANES * n, fused_bwd=DP_LANES * n, project=0, tree_count=0,
                  fused_step=0)
    check(launches == expect, f"on_device_dp: launch counts {launches}, expected {expect}")
    check(run.guarded_iterations == OD_DP_ITERS - 1,
          f"on_device_dp: {run.guarded_iterations} guarded iterations")
    sizes = [r.size for r in run.carry.replay]
    check(row["replay_size"] == sum(sizes) == run.rows_appended,
          f"on_device_dp: replay_size {row['replay_size']}, lanes {sizes}, "
          f"appended {run.rows_appended}")
    mps = [float(r.max_priority) for r in run.carry.replay]
    check(len(set(mps)) == 1 and mps[0] > 1.0, f"on_device_dp: lane max priorities {mps}")
    for key in FINITE_KEYS:
        check(key in row and row[key] == row[key] and abs(row[key]) != float("inf"),
              f"on_device_dp: {key} not finite: {row.get(key)}")
    emit({
        "phase": "on_device_dp", "card": card, "dp": DP_LANES, "processes": 1,
        "card_vs_cpu": {"envs": n_env, "k": k, "batch": b, "ring_row_max_abs_err": row_err,
                        "param_max_abs_err": param_err, "cuda": cm, "cpu": hm},
        "width": {"hidden": list(cfg.agent.hidden_sizes), "atoms": agent.dist.num_atoms,
                  "batch": cfg.batch_size, "batch_per_lane": cfg.batch_size // DP_LANES,
                  "envs": OD_DP_ENVS, "envs_per_lane": OD_DP_ENVS // DP_LANES,
                  "replay_capacity": run.capacity},
        "k_per_iteration": run.K, "iterations": OD_DP_ITERS, "grad_steps": n,
        "wall_s_incl_warmup_and_eval": wall, "warmup_s": run.warmup_s, "eval_s": run.eval_s,
        "grad_steps_per_sec": row["grad_steps_per_sec"],
        "env_steps_per_sec": row["env_steps_per_sec"],
        "replay_size": row["replay_size"], "lane_sizes": sizes, "max_priority": mps[0],
        "critic_loss": row["critic_loss"], "q_mean": row["q_mean"],
        "eval_return_mean": row["eval_return_mean"], "launches": launches, "ok": True,
    })
    return launches


SEGMENT_LEN_OD = 32                   # the on-device loop's segment length


def tp_gloo_legs_phase(TrainConfig, card: str) -> None:
    """The two gloo legs of ``tools/dp_ranks.py`` on ``cuda:0``: ``--dp 2
    --tp 2`` (the TP step, 2 dispatches of K = 4 at the pendulum preset's
    width, B = 256) and ``--on-device --dp 2`` (8 envs, one warmup
    segment and one iteration of K = 64), both run by one pair of spawned
    ranks, one dp lane each, each leg ``torch.equal`` to one process with
    both lanes."""
    from d4pg_tpu_torch.config import apply_env_preset
    from d4pg_tpu_torch.parallel.mesh import make_mesh
    from d4pg_tpu_torch.tools import dp_ranks

    c = apply_env_preset(TrainConfig(env="pendulum"))
    legs = {
        "tp": (TP, dict(agent_cfg=c.agent, dispatches=LEG_DISPATCHES, k=LEG_K,
                        batch=c.batch_size, seed=SEED)),
        "on_device": (1, dict(agent_cfg=c.agent, env_name="pendulum", batch=c.batch_size,
                              seed=SEED, **LEG_OD)),
    }
    ones, one_s = {}, {}
    for leg, (tp, kw) in legs.items():
        t0 = time.perf_counter()
        ones[leg] = dp_ranks.LEGS[leg](make_mesh(DP_LANES, tp, device="cuda", num_processes=1,
                                                 process_index=0), **kw)
        one_s[leg] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # one pair of ranks runs both legs: a rank's start (imports, the card,
    # the process group) costs more than either leg
    by_leg = dp_ranks.spawn_legs(DP_LANES, DP_LANES, "cuda",
                                 [(leg, tp, kw) for leg, (tp, kw) in legs.items()],
                                 timeout_s=DP_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    for leg, ranks in zip(legs, by_leg):
        one = ones[leg]
        tp = legs[leg][0]
        eq = dp_ranks.compare_leg(one, ranks)
        check(all(eq.values()), f"{leg} gloo leg: two ranks differ from one process: {eq}")
        backends = [r["backend"] for r in ranks]
        check(backends == ["gloo"] * DP_LANES, f"{leg} gloo leg: backends {backends}")
        emit({"phase": f"gloo_leg_{leg}", "card": card, "dp": DP_LANES, "tp": tp,
              "ranks": DP_LANES, "backends": backends, "torch_equal": eq,
              "one_process_s": one_s[leg], "rank_leg_s": [r["wall_s"] for r in ranks],
              "ranks_s_both_legs_incl_spawn": ranks_s,
              "launches_one_process": one["launches"],
              "launches_ranks": [r["launches"] for r in ranks], "ok": True})


# ------------------------------------- recovery across processes, league
HK_EVAL_EPISODES = 2
HK_TIMEOUT_S = 300


def host_kill_relaunch_phase(card: str, log_dir: str) -> dict:
    """``host_kill_relaunch`` (ROADMAP A11 (f)): the relaunching supervisor
    ``d4pg_tpu_torch/tools/multihost_smoke.py`` on ``cuda:0``, the train
    CLI as two processes over gloo (``--dp 2 --num-processes 2``, one lane
    each) at the pendulum preset's default width with the 1M-row replay
    (``--replay-placement device --p-replay --snapshot-replay
    --debug-guards``, K = 8, checkpoints every 16 grad steps). Leg 1:
    ``host_kill@4:1`` SIGKILLs process 1 at grad step 24, after the
    checkpoint at 16; the survivor reaped by SIGKILL; no manifest past 16.
    Leg 2: both relaunched with ``--resume`` for 16 grad steps: each
    resumed from step 16 with the replay snapshot and the device-PER
    sidecar, their ``done:`` lines' model metrics equal, each launch line
    B1f = B1b = 16, B3 = 2 (one a dispatch on its lane), B2 = B4 = 0; no
    process left. The CLI pair's layout: both ``[distributed]`` lines name
    gloo, checkpoint steps 16 and 32 under process 0's directory only,
    process 1's finite metrics row under ``worker1/``."""
    import os

    from d4pg_tpu_torch.tools import multihost_smoke

    interval, leg2_steps = multihost_smoke.INTERVAL, multihost_smoke.LEG2_STEPS
    check(multihost_smoke.K == K, f"host_kill_relaunch: the supervisor's K {multihost_smoke.K}")
    t0 = time.perf_counter()
    out = multihost_smoke.run(
        log_dir, device="cuda", timeout_s=HK_TIMEOUT_S,
        extra=["--eval-interval", str(10 * multihost_smoke.LEG1_STEPS),
               "--eval-episodes", str(HK_EVAL_EPISODES)])
    phase_s = time.perf_counter() - t0
    leg1, leg2 = out["leg1"], out["leg2"]
    check(leg1["committed_step"] == interval and leg1["manifest_steps"] == [interval],
          f"host_kill_relaunch: leg 1 {leg1}")
    want = dict(project=0, fused_fwd=leg2_steps, fused_bwd=leg2_steps,
                tree_count=leg2_steps // K, fused_step=0)
    for r in leg2["ranks"]:
        check(r["launches"] == want, f"host_kill_relaunch: rank launches {r['launches']}")
    m = leg2["model_metrics"]
    for key in FINITE_KEYS:
        check(key in m and m[key] == m[key] and abs(m[key]) != float("inf"),
              f"host_kill_relaunch: {key} not finite: {m.get(key)}")
    launches = {k: sum(r["launches"][k] for r in leg2["ranks"]) for k in want}
    distributed = []
    for rank in range(2):
        with open(os.path.join(log_dir, f"leg2_p{rank}.log")) as f:
            distributed += [ln.strip() for ln in f if ln.startswith("[distributed]")]
    check(len(distributed) == 2 and all("'backend': 'gloo'" in ln for ln in distributed),
          f"host_kill_relaunch: {distributed}")
    end = interval + leg2_steps
    ckpt = sorted(int(x) for x in os.listdir(os.path.join(log_dir, "checkpoints")) if x.isdigit())
    worker = os.path.join(log_dir, "worker1")
    stray = [x for x in os.listdir(os.path.join(worker, "checkpoints")) if x.isdigit()] \
        if os.path.isdir(os.path.join(worker, "checkpoints")) else []
    with open(os.path.join(worker, "metrics.jsonl")) as f:
        worker_rows = [json.loads(line) for line in f]
    check(ckpt == [interval, end] and not stray and [r["step"] for r in worker_rows] == [end]
          and all(worker_rows[0].get(k) is not None and worker_rows[0][k] == worker_rows[0][k]
                  and abs(worker_rows[0][k]) != float("inf") for k in FINITE_KEYS),
          f"host_kill_relaunch: checkpoints {ckpt}, under worker1 {stray}, "
          f"worker1 rows {worker_rows}")
    emit({
        "phase": "host_kill_relaunch", "card": card, "processes": 2, "lanes": 2,
        "backend": "gloo", "width": "the pendulum preset's (3x256, 51 atoms, B = 256, "
                                    "1M-row replay), K = 8",
        "leg1": leg1, "leg2": {k: leg2[k] for k in ("rcs", "resumed_from", "wall_s",
                                                    "model_metrics")},
        "replay_rows_restored": [r["replay_rows_restored"] for r in leg2["ranks"]],
        "grad_steps_per_sec": [r["done"]["grad_steps_per_sec"] for r in leg2["ranks"]],
        "launches_per_rank": [r["launches"] for r in leg2["ranks"]],
        "distributed_lines": distributed, "checkpoint_steps": ckpt,
        "orphans_swept": out["orphans_swept"], "launches": launches, "phase_s": phase_s,
        "ok": True,
    })
    return launches


LEAGUE_GENOMES = (                    # scripts/league_smoke.sh's: the horizon separates fitness
    "lr_actor=1e-4,max_episode_steps=50",
    "lr_actor=1e-4,max_episode_steps=200",
    "lr_actor=1e-3,max_episode_steps=250",
)
# A learner's fitness cadence (eval interval) and checkpoint interval: more
# than two saves an eval apart, so a learner that dies at its first eval's
# print (its controller killed, its pipe gone) leaves two intact steps, and
# a fork torn by clone_corrupt keeps one to fall back to.
LEAGUE_EVAL = 96
LEAGUE_CKPT = 32
LEAGUE_POLL_S = 0.5
LEAGUE_TIMEOUT_S = 240
LEAGUE_LEARNER = ("--replay-placement", "device", "--p-replay", "--fused-descent",
                  "--snapshot-replay", "--debug-guards", "--steps-per-dispatch", str(K),
                  "--eval-interval", str(LEAGUE_EVAL), "--eval-episodes", "1",
                  "--checkpoint-interval", str(LEAGUE_CKPT), "--total-steps", "1000000")


def _league_leg(league_dir: str, chaos: str, log: str, kill_in: str = ""):
    """One run of ``python -m d4pg_tpu_torch.league`` over the card's
    learners; returns (rc, stdout lines), its stdout also written to
    ``log`` and its stderr beside it. With ``kill_in``, the harness SIGKILLs the controller from
    outside as soon as its journal (``league.json``) shows the pending
    generation's action in that phase: a kill that lands on a state, not
    on a tick count, whatever the host's speed."""
    import os
    import signal

    argv = [sys.executable, "-m", "d4pg_tpu_torch.league", "--dir", league_dir, "--seed", "7",
            "--generations", "1", "--poll-interval", str(LEAGUE_POLL_S),
            "--gen-timeout", "120", "--drain-timeout", "60", "--attest-timeout", "120",
            "--observe-timeout", "120", "--debug-guards", "--chaos", chaos]
    for g in LEAGUE_GENOMES:
        argv += ["--genome", g]
    argv += ["--", sys.executable, "-m", "d4pg_tpu_torch.train", *LEAGUE_LEARNER]
    root = os.path.dirname(os.path.abspath(__file__))
    journal, killed = os.path.join(league_dir, "league.json"), False
    deadline = time.monotonic() + LEAGUE_TIMEOUT_S
    with open(log, "w") as out, open(log + ".err", "w") as err:
        p = subprocess.Popen(argv, cwd=root, stdout=out, stderr=err, text=True)
        try:
            while p.poll() is None and time.monotonic() < deadline:
                if kill_in and not killed:
                    try:
                        with open(journal) as f:
                            pending = json.load(f).get("pending")
                    except (OSError, ValueError):
                        pending = None
                    if pending and pending["actions"][0]["phase"] == kill_in:
                        os.kill(p.pid, signal.SIGKILL)
                        killed = True
                time.sleep(0.05)
        finally:
            if p.poll() is None:
                p.kill()
            p.wait()
    with open(log) as f:
        stdout = f.read()
    check(time.monotonic() < deadline, f"league_device: a leg outlived {LEAGUE_TIMEOUT_S} s: "
          + "\n".join(stdout.splitlines()[-30:]))
    return p.returncode, stdout.splitlines()


def _league_tenures(lines) -> list:
    """Each learner tenure that printed a launch line: (uid, its ``done:``
    dict, its launches), from the controller's tagged output."""
    import ast

    from d4pg_tpu_torch.train import LAUNCHES_LINE

    done, out = {}, []
    for ln in lines:
        if not ln.startswith("[v0"):
            continue
        tag, _, rest = ln.partition("] ")
        uid = int(tag[2:])
        if rest.startswith("done:"):
            done[uid] = ast.literal_eval(rest[len("done:"):].strip())
        elif rest.startswith(LAUNCHES_LINE):
            out.append((uid, done.pop(uid, None), json.loads(rest[len(LAUNCHES_LINE):])))
    return out


def league_device_phase(card: str, log_dir: str) -> dict:
    """``league_device`` (ROADMAP A11 (e5)): ``python -m
    d4pg_tpu_torch.league`` over three learners on the card, each
    ``python -m d4pg_tpu_torch.train --replay-placement device --p-replay
    --fused-descent --snapshot-replay --debug-guards`` at the pendulum
    preset's default width with the 1M-row replay (K = 8, an eval every
    96 grad steps, a checkpoint every 32), the genomes of
    ``scripts/league_smoke.sh`` (the episode horizon separates fitness).
    Leg 1: one generation under ``seed=5;clone_corrupt@1`` (the fork torn),
    the controller SIGKILLed by the harness as soon as its journal shows
    the clone observed (the signal ``controller_kill`` sends itself, on a
    state rather than a tick count). Leg 2: the rerun, with
    ``clone_corrupt@1`` re-armed as the JAX soak re-arms it (the fork is
    torn whichever side of the crash it lands on): ``journal_resumed``,
    the generation completed once, a fork of manifest-verified steps, a
    torn step and the clone's restore falling back, a perturbed clone
    attested under its own variant id (its trainer meta and metrics rows),
    promoted or rolled back; no quarantine, the ``league-tenure`` identity
    on every row (its flow verdict and the summary), no orphan. Every
    learner tenure that exited 0 or 75 printed its launch line: a tenure
    that trained B1b = B4 = 8 x B3 > 0, B1f = B2 = 0; one stopped before
    its first dispatch, all 0."""
    import os

    from d4pg_tpu_torch.utils.procs import pids_with_cmdline

    os.makedirs(log_dir, exist_ok=True)
    league = os.path.join(log_dir, "league")
    t0 = time.perf_counter()
    rc1, out1 = _league_leg(league, "seed=5;clone_corrupt@1", os.path.join(log_dir, "leg1.log"),
                            kill_in="observing")
    leg1_s = time.perf_counter() - t0
    with open(os.path.join(league, "league.json")) as f:
        at_kill = json.load(f)
    pending = at_kill.get("pending")
    landed = pending["actions"][0]["phase"] if pending else "no_pending_generation"
    check(rc1 == -9 and landed == "observing",
          f"league_device: leg 1 rc {rc1}, the kill landed in {landed}: " + "\n".join(out1[-30:]))
    t1 = time.perf_counter()
    rc2, out2 = _league_leg(league, "seed=5;clone_corrupt@1", os.path.join(log_dir, "leg2.log"))
    leg2_s = time.perf_counter() - t1
    check(rc2 == 0 and any('"journal_resumed"' in ln for ln in out2),
          f"league_device: leg 2 rc {rc2}: " + "\n".join(out2[-40:]))
    with open(os.path.join(league, "league_summary.json")) as f:
        s = json.load(f)
    with open(os.path.join(league, "league_events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    rows = s["variants"]
    sick = [u for u, v in rows.items() if v["quarantined"]]
    check(s["generations_completed"] == 1 and not sick,
          f"league_device: generations {s['generations_completed']}, quarantined {sick}: "
          + json.dumps({u: {k: v[k] for k in ("status", "spawned", "exited_err", "restarts")}
                        for u, v in rows.items()})
          + "\n" + "\n".join(json.dumps(e) for e in events[-25:])
          + "\n" + "\n".join([ln for ln in out1 + out2
                               if any(ln.startswith(f"[v{int(u):04d}]") for u in sick)][-40:]))
    check(s["identity_ok"] and s["orphans_swept"] == 0, f"league_device: summary {s}")
    bad = [u for u, v in rows.items() if v["spawned"] + v["adopted"] != v["exited_0"]
           + v["exited_75"] + v["exited_err"] + v["killed"] + v["live"]]
    verdicts = [json.loads(ln.split(" ", 1)[1]) for ln in out2 if ln.startswith("[flow-verdict]")]
    tenure = [v for v in verdicts if v["family"] == "league-tenure"]
    check(not bad and len(tenure) == 1 and tenure[0]["ok"]
          and tenure[0]["counters"] == {"rows": len(rows), "bad_rows": 0},
          f"league_device: league-tenure rows {bad}, verdicts {tenure}")
    done = [e["gen"] for e in events if e["event"] == "generation_done"]
    check(done == [1], f"league_device: generation_done events {done}")
    forks = [e for e in events if e["event"] == "checkpoint_forked"]
    check(forks and all(e["steps"] for e in forks), f"league_device: forks {forks}")
    both = out1 + out2
    check(any("[chaos] truncated" in ln for ln in both), "league_device: no fork was torn")
    fallbacks = [ln for ln in both if "[checkpoint] fallback" in ln]
    check(fallbacks, "league_device: no clone fell back from its torn step")
    edge = next(e for e in s["lineage"] if e["reason"] == "clone")
    child, parent = str(edge["child"]), str(edge["parent"])
    check(rows[child]["genome"] != rows[parent]["genome"],
          f"league_device: clone genome {rows[child]['genome']} unperturbed")
    outcomes = [e for e in events if e["event"] in ("clone_promoted", "clone_rolled_back")]
    check(outcomes, "league_device: the clone was neither promoted nor rolled back")
    with open(os.path.join(league, f"v{int(child):04d}", "checkpoints",
                           "trainer_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(league, f"v{int(child):04d}", "metrics.jsonl")) as f:
        child_rows = [json.loads(line) for line in f]
    check(meta.get("variant_id") == int(child) and child_rows
          and all(r["variant_id"] == int(child) for r in child_rows),
          f"league_device: the clone's attestation {meta}")
    left = pids_with_cmdline(league)
    check(not left, f"league_device: processes left {left}")
    # every exit 0 / 75 printed its launch line
    tenures = _league_tenures(out1) + _league_tenures(out2)
    clean = {}
    for e in events:
        if e["event"] in ("learner_exited", "learner_killed") and e.get("rc") in (0, 75):
            clean[e["uid"]] = clean.get(e["uid"], 0) + 1
    printed = {}
    for uid, _done, _l in tenures:
        printed[uid] = printed.get(uid, 0) + 1
    check(all(printed.get(u, 0) >= n for u, n in clean.items()),
          f"league_device: exits 0/75 {clean}, launch lines {printed}")
    launches = dict(project=0, fused_fwd=0, fused_bwd=0, tree_count=0, fused_step=0)
    trained = 0
    for uid, d, lc in tenures:
        check(lc["fused_fwd"] == 0 and lc["project"] == 0, f"league_device: v{uid} {lc}")
        if d:
            check(lc["fused_bwd"] == lc["fused_step"] == K * lc["tree_count"] > 0,
                  f"league_device: v{uid} trained with launches {lc}")
            trained += 1
        else:
            check(set(lc.values()) == {0}, f"league_device: v{uid} untrained, launches {lc}")
        for k in launches:
            launches[k] += lc[k]
    check(trained >= 1 and launches["fused_step"] > 0, f"league_device: tenures {tenures}")
    emit({
        "phase": "league_device", "card": card, "learners": len(LEAGUE_GENOMES),
        "width": "the pendulum preset's (3x256, 51 atoms, B = 256, 1M-row replay), K = 8",
        "genomes": list(LEAGUE_GENOMES), "kill_landed": landed, "generation_at_kill": at_kill["generation"],
        "leg1_s": leg1_s, "leg2_s": leg2_s,
        "events": {k: sum(e["event"] == k for e in events) for k in (
            "learner_spawned", "learner_adopted", "learner_died_unsupervised",
            "learner_exited", "learner_killed", "checkpoint_forked", "clone_promoted",
            "clone_rolled_back")},
        "forks": [{"src": e["src"], "child": e["child"], "steps": e["steps"]} for e in forks],
        "fallbacks": [ln.split("] ", 1)[-1] for ln in fallbacks],
        "outcomes": [{k: e.get(k) for k in ("event", "uid", "why")} for e in outcomes],
        "lineage": s["lineage"], "promotions": s["promotions"], "rollbacks": s["rollbacks"],
        "fitness": {u: v["fitness"] for u, v in rows.items()},
        "tenures_printed": len(tenures), "tenures_trained": trained,
        "launches": launches, "phase_s": leg1_s + leg2_s, "ok": True,
    })
    return launches


def _pid_alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie counts as gone)."""
    import os

    try:
        os.kill(pid, 0)
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except (ProcessLookupError, FileNotFoundError):
        return False


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
        paths["guards_device"] = guards_device_phase(Trainer, TrainConfig, card,
                                                     f"{tmp}/guards_device")
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
        paths["host_pool_pixel"] = host_pool_pixel_phase(
            Trainer, TrainConfig, card, f"{tmp}/host_pool_pixel")
        paths["guards_chaos_pool"] = guards_chaos_pool_phase(
            Trainer, TrainConfig, card, f"{tmp}/guards_chaos_pool")
        paths["fleet_pixel"] = fleet_pixel_phase(Trainer, TrainConfig, card, f"{tmp}/fleet_pixel")
        paths["fleet_device"] = fleet_device_phase(Trainer, TrainConfig, card,
                                                   f"{tmp}/fleet_device")
        paths["flywheel_pixel"] = flywheel_pixel_phase(Trainer, TrainConfig, card,
                                                       f"{tmp}/flywheel_pixel")
        paths["dp_lanes"] = dp_lanes_phase(Trainer, TrainConfig, cuda_tree, dper, card,
                                           f"{tmp}/dp_lanes")
        paths["dp_ranks"] = dp_ranks_phase(TrainConfig, card)
        # side by side: each phase drives CLI processes of its own on the
        # card and checks them by their output and files, and neither
        # waits on a clock that the other's load could make it miss
        with ThreadPoolExecutor(1) as pool:
            relaunch = pool.submit(host_kill_relaunch_phase, card, f"{tmp}/host_kill")
            paths["league_device"] = league_device_phase(card, f"{tmp}/league_device")
            paths["host_kill_relaunch"] = relaunch.result()
        for mode in ("dp", "dp_hogwild"):
            paths[f"dp_host_{mode}"] = dp_host_run(Trainer, TrainConfig, mode, card,
                                                   f"{tmp}/{mode}")
        paths["tp_host"] = tp_host_phase(Trainer, TrainConfig, card, f"{tmp}/tp_host")
        paths["tp_members"] = tp_members_phase(card)
        paths["on_device_dp"] = on_device_dp_phase(TrainConfig, card, f"{tmp}/on_device_dp")
        tp_gloo_legs_phase(TrainConfig, card)
        paths["serve"] = serve_phase(card, f"{tmp}/fused", tmp, run_actor)
        paths["serve_guards_chaos"] = serve_guards_chaos_phase(card, f"{tmp}/bundle_default")
        paths["router_serve"] = router_serve_phase(card, f"{tmp}/bundle_default", tmp)

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
