"""Dynamic micro-batching around the deterministic actor, one CUDA graph a
bucket (the port's counterpart of ``d4pg_tpu/serve/batcher.py``).

Requests from any number of connections funnel into ONE bounded queue
consumed by ONE device thread, which assembles batches under a
``(max_batch, max_wait_us)`` window — a batch dispatches when it reaches
``max_batch`` rows or when ``max_wait_us`` has elapsed since its first
request, whichever comes first. Batching turns N tiny actor forwards into
one device call: the launch cost of a call dominates a 3x256 MLP forward.

Shape discipline: batches are padded up to a small fixed ladder of bucket
sizes (powers of two up to ``max_batch``). On the card each bucket is ONE
CUDA graph, captured at warmup and replayed for every batch of that size:
the actor forward, ``clamp(-1, 1)`` and the affine map to the env's
bounds, reading a static input ``[b, obs_dim]`` and writing a static
output ``[b, action_dim]``: one specialization a bucket of the batcher's
``<name>.infer`` program (``utils/graphs.py``). A hot reload copies the
new weights into the captured parameters and never recaptures.
:attr:`DynamicBatcher.compile_count` counts the specializations (on the
CPU, where there is no graph, the per-bucket programs built at warmup):
only ``warmup()`` builds them, once, so it is ``len(buckets)`` by
construction, and the recompile sentinel (``sentinel=``, the server's
``debug_guards``) holds it to that budget. What a hot reload could
break is the binding: a graph reads its parameters by address, and
:meth:`DynamicBatcher.rebound_params` names any parameter that is no
longer the tensor the graphs captured. :attr:`DynamicBatcher.replays`
counts one replay a batch.

Load shedding is explicit and immediate: a full queue rejects the request
with ``queue_full`` (the caller replies ``OVERLOADED``), and requests whose
deadline expired while queued are dropped at assembly time with
``deadline``.

Guards (``guard_sync``, the server's ``debug_guards``): on the card every
batch dispatches under ``set_sync_debug_mode("error")``
(``analysis/transfer.py:sync_guard``). A batch's one transfer in is the
input slot's explicit copy into the captured graph's static input, and
the replay takes no operand, so there is no operand to check; with a
``ledger`` every input slot is written and held through a
:class:`~d4pg_tpu_torch.analysis.ledger.StagingLedger` (see ``_infer``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from d4pg_tpu_torch import resolve_device
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.analysis import lockwitness
from d4pg_tpu_torch.analysis.ledger import NULL_LEDGER
from d4pg_tpu_torch.analysis.transfer import sync_guard
from d4pg_tpu_torch.serve.bundle import build_actor
from d4pg_tpu_torch.serve.stats import ServeStats
from d4pg_tpu_torch.utils import graphs
from d4pg_tpu_torch.utils.profiling import StageTimers

WARMUP_CALLS = 3  # eager forwards on the batcher's stream before each capture
# the normalizer of the JAX trainer's RunningObsNorm: clip of the
# normalized observation, and the floor of its std
OBS_NORM_CLIP = 5.0
OBS_NORM_EPS = 1e-2


class ShedError(Exception):
    """The request was load-shed, not failed. ``reason`` is the wire reason
    (``queue_full`` | ``deadline`` | ``draining``)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _Request:
    __slots__ = ("obs", "deadline", "future", "t_submit")

    def __init__(self, obs, deadline, future, t_submit):
        self.obs = obs
        self.deadline = deadline    # absolute perf_counter seconds, or None
        self.future = future
        self.t_submit = t_submit


def default_buckets(max_batch: int) -> tuple:
    """Powers of two up to ``max_batch``, always ending exactly at it."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return tuple(sorted(set(out)))


class _Bucket:
    """One bucket: its specialization of the batcher's ``<name>.infer``
    program (the static input and output on the device, the captured
    graph, None on the CPU) and two host slots each way (pinned on the
    card) with one completion event a slot."""

    __slots__ = ("size", "spec", "in_slots", "out_slots", "events")

    def __init__(self, size, spec, in_slots, out_slots, events):
        self.size = size
        self.spec = spec
        self.in_slots = in_slots
        self.out_slots = out_slots
        self.events = events

    @property
    def static_in(self) -> torch.Tensor:
        return self.spec.inputs[0]

    @property
    def static_out(self) -> torch.Tensor:
        return self.spec.outputs[0]

    @property
    def graph(self):
        return self.spec.graph


class DynamicBatcher:
    """Single-device-thread dynamic batcher over the deterministic actor.

    ``submit(obs, deadline_s)`` → Future resolving to the env-scale action
    (normalize → actor → clip(−1,1) → affine to [low, high]); raises
    :class:`ShedError` through the future (or synchronously on queue-full)
    when shed. ``params`` is the actor's ``state_dict``.
    """

    def __init__(
        self,
        config: D4PGConfig,
        params,
        *,
        max_batch: int = 64,
        max_wait_us: int = 2000,
        queue_limit: int = 256,
        action_low=None,
        action_high=None,
        obs_norm_stats: Optional[dict] = None,
        guard_sync: bool = False,
        name: str = "serve",
        device=None,
        ledger=None,
        sentinel=None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if queue_limit < max_batch:
            raise ValueError(
                f"queue_limit ({queue_limit}) must be >= max_batch "
                f"({max_batch}): a full window must fit in the queue"
            )
        self.config = config
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.max_batch = int(max_batch)
        self.max_wait_s = max_wait_us / 1e6
        self.queue_limit = int(queue_limit)
        self.buckets = default_buckets(max_batch)
        self.stats = ServeStats(
            batch_edges=self.buckets,
            queue_edges=default_buckets(max(queue_limit, 1)),
        )
        # ``name`` scopes the stages' profiler ranges (``serve/assemble``,
        # ``serve[cheetah]/assemble``) and the threads: a multi-policy
        # server runs one batcher per resident policy.
        self.name = name
        self.timers = StageTimers(annotate_prefix=f"{name}/")

        # Published as ONE (mean, std) tuple read exactly once per
        # normalize — hot reload (set_obs_norm) swaps it atomically from
        # the watcher thread while submit() reads it.
        self._obs_pub = self._derive_obs_pub(obs_norm_stats)

        low = (
            np.full(config.action_dim, -1.0, np.float32)
            if action_low is None
            else np.asarray(action_low, np.float32)
        )
        high = (
            np.full(config.action_dim, 1.0, np.float32)
            if action_high is None
            else np.asarray(action_high, np.float32)
        )
        # the identity box skips the affine, so a default bundle's actions
        # equal the direct forward bit for bit
        self._identity_bounds = bool(np.all(low == -1.0) and np.all(high == 1.0))
        self._low = torch.from_numpy(low).to(self.device)
        self._high = torch.from_numpy(high).to(self.device)

        # The captured parameters: set once here, then only ever written
        # in place by the device thread (_apply_pending_params).
        self._actor = build_actor(config, self.device)
        self._actor.load_state_dict(params)
        self._serving = self._actor.state_dict()
        self._shapes = {k: tuple(v.shape) for k, v in self._serving.items()}
        self._captured_ptrs: dict = {}  # name -> data_ptr, set at warmup
        self._pending_params = None
        self._params_lock = lockwitness.named_lock("DynamicBatcher._params_lock")

        self._guard_sync = bool(guard_sync)
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._upload_stream = torch.cuda.Stream(self.device) if self._cuda else None
        # ONE compiled program, one specialization (and on the card one
        # CUDA graph) a bucket; its count is the sentinel's and
        # compile_count's
        self._program = graphs.Program(f"{name}.infer", self._body, self.device,
                                       state=lambda: list(self._serving.values()),
                                       warmup=WARMUP_CALLS)
        if sentinel is not None:
            sentinel.track(f"{name}.infer", self._program, budget=len(self.buckets))
        self._programs: dict[int, _Bucket] = {}
        self._replays = 0
        # Two rotating host slots per bucket each way. The H2D copy out of
        # an input slot and the D2H copy into an output slot are
        # asynchronous, so a slot must not be rewritten while its batch can
        # still be in flight. Two slots are enough ONLY because
        # ``_inflight`` bounds the device thread to two outstanding
        # batches: when it assembles a batch into slot s of bucket b, the
        # one other batch it may have outstanding used slot 1 - s if it
        # was of bucket b, so the last user of slot s is older — and the
        # reply thread released that batch's permit only after its
        # event, recorded after the D2H copy, completed and its rows were
        # copied out. The static input and output on the device are shared
        # by consecutive batches of a bucket; stream order puts batch
        # N+1's H2D after batch N's replay and batch N+1's replay after
        # batch N's D2H, so neither is overwritten early.
        self._staging_flip = {b: 0 for b in self.buckets}
        self._inflight = threading.Semaphore(2)
        # Staging ledger (debug_guards): generation-tags the two input
        # slots a bucket; a write into a slot whose batch's H2D copy the
        # reply thread has not seen complete raises at the overwrite. The
        # group names are made once, not per batch.
        self._ledger = ledger if ledger is not None else NULL_LEDGER
        self._staging_group = {b: f"{name}.staging[{b}]" for b in self.buckets}
        # Test hook (the ledger's seeded fault): pin the rotation to one
        # slot, the early-reuse bug class the two slots exist to prevent.
        self._test_force_flip: Optional[int] = None

        self._queue: deque[_Request] = deque()
        self._cond = lockwitness.named_condition("DynamicBatcher._cond")
        self._draining = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        # single transition None→exception; readers check-then-raise
        self._thread_error: Optional[BaseException] = None
        # Reply distribution runs on its OWN thread: resolving futures fires
        # the callers' callbacks (the server writes a socket frame per
        # reply), and doing that inline would stall the device thread for
        # the whole fan-out. The device thread hands over the batch's
        # output slot and event; the reply thread waits for it.
        self._reply_q: deque = deque()
        self._reply_cond = lockwitness.named_condition("DynamicBatcher._reply_cond")
        self._reply_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self, warmup: bool = True) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("batcher device thread already running")
        if warmup:
            self.warmup()
        with self._cond:  # same guard as every other _draining/_stopped write
            self._draining = False
            self._stopped = False
        self._thread = threading.Thread(
            target=self._device_loop, name=f"{self.name}-batcher", daemon=True
        )
        self._thread.start()
        self._reply_thread = threading.Thread(
            target=self._reply_loop, name=f"{self.name}-reply", daemon=True
        )
        self._reply_thread.start()

    def _body(self, obs: torch.Tensor) -> torch.Tensor:
        """What a bucket's program computes: actor, clip, affine."""
        a = self._actor(obs).clamp(-1.0, 1.0)
        if not self._identity_bounds:
            a = self._low + (a + 1.0) * 0.5 * (self._high - self._low)
        return a

    @torch.no_grad()
    def warmup(self) -> None:
        """Build every bucket's specialization up front, so no live request
        pays a capture. On the card each is a CUDA graph captured on the
        program's stream after a few eager forwards there (which also pick
        and load a pixel actor's cuDNN convolutions); a failed capture
        raises. cuDNN's autotuner stays off throughout, so the capture
        records the algorithms the eager forwards ran
        (``utils/graphs.py``)."""
        if self._programs:
            return
        obs_dim, action_dim = self.config.obs_dim, self.config.action_dim
        for b in self.buckets:
            spec, leaves = self._program.specialization(torch.zeros(b, obs_dim, device=self.device))
            spec.load(leaves)
            spec.prepare()
            pin = self._cuda
            self._programs[b] = _Bucket(
                b, spec,
                [torch.zeros(b, obs_dim, pin_memory=pin) for _ in range(2)],
                [torch.zeros(b, action_dim, pin_memory=pin) for _ in range(2)],
                [torch.cuda.Event() if self._cuda else None for _ in range(2)],
            )
        if self._cuda:
            torch.cuda.synchronize(self.device)
        self._captured_ptrs = {k: v.data_ptr() for k, v in self._serving.items()}

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the device thread. ``drain=True``: new submissions shed
        ``draining`` but everything already queued is answered first."""
        with self._cond:
            self._draining = True
            if not drain:
                while self._queue:
                    req = self._queue.popleft()
                    self._shed(req, "draining")
            self._stopped = not drain or not self._queue
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("batcher device thread failed to drain")
            self._thread = None
        if self._reply_thread is not None:
            with self._reply_cond:
                self._reply_q.append(None)  # sentinel AFTER the last batch
                self._reply_cond.notify()
            self._reply_thread.join(timeout)
            if self._reply_thread.is_alive():
                raise RuntimeError("batcher reply thread failed to drain")
            self._reply_thread = None

    @property
    def compile_count(self) -> int:
        """Specializations of ``<name>.infer`` built, the count the recompile
        sentinel reads: one CUDA graph captured a bucket on the card, one
        program a bucket on the CPU. Only warmup() builds them."""
        return self._program._cache_size()

    def rebound_params(self) -> list:
        """The parameters that are no longer the tensors the bucket graphs
        captured, in the actor or in the set that hot reload writes into.
        A graph replays on the addresses it captured, so a parameter
        rebound after warmup (not copied into in place) would leave every
        replay on the old weights. Empty when the binding holds."""
        live = self._actor.state_dict()
        return sorted(
            k for k, ptr in self._captured_ptrs.items()
            if live[k].data_ptr() != ptr or self._serving[k].data_ptr() != ptr
        )

    @property
    def replays(self) -> int:
        """Bucket programs run: one per dispatched batch."""
        return self._replays

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def check_alive(self) -> None:
        if self._thread_error is not None:
            raise RuntimeError("batcher device thread died") from self._thread_error

    # ------------------------------------------------------------ hot reload
    def set_params(self, params, version: Optional[int] = None) -> None:
        """Swap serving params. The new ``state_dict`` must match the
        captured structure and shapes (same actor architecture); a mismatch
        raises here, on the caller's thread, before anything moves. The
        tensors are then copied to the device into a side buffer, and the
        device thread copies them into the captured parameters between two
        batches, on its own stream: in-flight batches finish on the
        params they started with, the next batch uses the new ones, and
        nothing is recaptured."""
        if set(params) != set(self._shapes):
            raise ValueError("new params tree structure differs from serving tree")
        for k, shape in self._shapes.items():
            if tuple(params[k].shape) != shape:
                raise ValueError(
                    f"new params leaf shape {tuple(params[k].shape)} differs from "
                    f"serving shape {shape}"
                )
        keys = list(self._shapes)
        host = [torch.as_tensor(params[k], dtype=torch.float32) for k in keys]
        if self._cuda:
            # pinned host memory and an async copy on the upload stream: no
            # host synchronisation, so a hot reload never trips the sync
            # guard a device thread may be running under
            with torch.cuda.stream(self._upload_stream):
                side = [t.pin_memory().to(self.device, non_blocking=True) for t in host]
                ready = torch.cuda.Event()
                ready.record(self._upload_stream)
        else:
            side, ready = [t.clone() for t in host], None
        with self._params_lock:
            self._pending_params = (keys, side, ready)
        self.stats.inc("params_reloads")
        if version is not None:
            with self.stats._lock:
                self.stats.params_version = version
        else:
            self.stats.inc("params_version")

    def _apply_pending_params(self) -> None:
        """Device thread only, between two batches: copy the newest pending
        params into the captured ones, stream-ordered after the upload and
        after every batch already enqueued."""
        with self._params_lock:
            pending, self._pending_params = self._pending_params, None
        if pending is None:
            return
        keys, side, ready = pending
        if self._cuda:
            self._stream.wait_event(ready)
            for k, t in zip(keys, side):
                self._serving[k].copy_(t, non_blocking=True)
                t.record_stream(self._stream)
        else:
            for k, t in zip(keys, side):
                self._serving[k].copy_(t)

    def _derive_obs_pub(self, stats: Optional[dict]):
        """(mean_f32, std_f32_floored) from persisted Welford stats, or
        None when normalization is off — the derivation the JAX trainer's
        RunningObsNorm.load_state_dict applies."""
        if stats is None:
            return None
        count = float(stats["count"])
        mean = np.asarray(stats["mean"], np.float64)
        if mean.shape != (self.config.obs_dim,):
            raise ValueError(
                f"obs_norm stats are {mean.shape}-shaped, obs_dim is "
                f"{self.config.obs_dim}"
            )
        m2 = np.asarray(stats["m2"], np.float64)
        std = (
            np.sqrt(np.maximum(m2 / count, 0.0))
            if count > 0
            else np.ones_like(mean)
        )
        return (
            mean.astype(np.float32),
            np.maximum(std, OBS_NORM_EPS).astype(np.float32),
        )

    def set_obs_norm(self, stats: Optional[dict]) -> None:
        """Hot-swap the normalizer statistics (bundle re-export flow):
        params trained under fresher running statistics must be served
        with them."""
        self._obs_pub = self._derive_obs_pub(stats)  # atomic publication

    # ------------------------------------------------------------ submission
    def _normalize(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float32).reshape(self.config.obs_dim)
        pub = self._obs_pub  # one read: matched (mean, std), never torn
        if pub is None:
            return obs
        mean, std = pub
        return np.clip((obs - mean) / std, -OBS_NORM_CLIP, OBS_NORM_CLIP)

    def submit(self, obs: np.ndarray, deadline_s: Optional[float] = None) -> Future:
        """Enqueue one observation. ``deadline_s`` is relative seconds the
        client is willing to wait; past it the request is shed rather than
        computed. Raises :class:`ShedError` synchronously on queue-full /
        draining (the fast path for the overload reply)."""
        self.check_alive()
        self.stats.inc("requests_total")
        t = time.perf_counter()
        req = _Request(
            self._normalize(obs),
            None if deadline_s is None else t + deadline_s,
            Future(),
            t,
        )
        with self._cond:
            if self._draining:
                self.stats.inc("shed_draining")
                raise ShedError("draining")
            if len(self._queue) >= self.queue_limit:
                self.stats.inc("shed_queue_full")
                raise ShedError("queue_full")
            self._queue.append(req)
            self.stats.inc("inflight")
            self.stats.queue_hist.add(len(self._queue))
            self._cond.notify()
        # Outside the lock: the callback may fire inline if the device
        # thread already resolved the future, and it takes the stats lock.
        # add_done_callback fires exactly once on EVERY resolution path.
        req.future.add_done_callback(self._dec_inflight)
        return req.future

    def _dec_inflight(self, _fut) -> None:
        self.stats.inc("inflight", -1)

    def _shed(self, req: _Request, reason: str) -> None:
        if reason == "deadline":
            self.stats.inc("shed_deadline")
        elif reason == "draining":
            self.stats.inc("shed_draining")
        if not req.future.set_running_or_notify_cancel():
            return
        req.future.set_exception(ShedError(reason))

    # ------------------------------------------------------------ device loop
    def _take_batch(self) -> Optional[list]:
        """Block for the first request, then fill the window: up to
        ``max_batch`` rows or ``max_wait_s`` after the first row, whichever
        first. Returns None when stopped and drained."""
        with self._cond:
            while not self._queue:
                if self._stopped or (self._draining and not self._queue):
                    return None
                self._cond.wait(0.05)
            batch = [self._queue.popleft()]
            window_end = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                while self._queue and len(batch) < self.max_batch:
                    batch.append(self._queue.popleft())
                if len(batch) >= self.max_batch or self._draining:
                    break
                remaining = window_end - time.perf_counter()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                if not self._queue and time.perf_counter() >= window_end:
                    break
            return batch

    def _infer(self, bucket: int, flip: int):
        """Enqueue one batch: new params if any, the input slot's H2D copy
        into the static input, the replay, the D2H copy into the output
        slot, then the slot's event — all on this batcher's stream. On the
        CPU the same steps run synchronously and the event is None.

        On the card the input slot is read by the ``non_blocking`` copy
        some time after this returns: its ledger hold is released only by
        the reply thread, once the slot's event (recorded after that copy
        and the output copy) has completed. This is the one hold whose
        race exists only on the GPU."""
        prog = self._programs[bucket]
        self._replays += 1
        if not self._cuda:
            self._apply_pending_params()
            prog.static_in.copy_(prog.in_slots[flip])
            with torch.no_grad():
                prog.spec.run()
            prog.out_slots[flip].copy_(prog.static_out)
            return None
        with torch.cuda.stream(self._stream):
            self._apply_pending_params()
            prog.static_in.copy_(prog.in_slots[flip], non_blocking=True)
            prog.spec.run()
            prog.out_slots[flip].copy_(prog.static_out, non_blocking=True)
            event = prog.events[flip]
            event.record(self._stream)
        return event

    def _device_loop(self) -> None:
        live: list = []  # the in-hand batch; ownership moves to the reply
        # queue on append, so the except sweep below never double-resolves
        guard = sync_guard if self._guard_sync and self._cuda else contextlib.nullcontext
        try:
            while True:
                batch = self._take_batch()
                if batch is None:
                    return
                now = time.perf_counter()
                live = []
                for req in batch:
                    if req.deadline is not None and now > req.deadline:
                        self._shed(req, "deadline")
                    elif req.future.set_running_or_notify_cancel():
                        live.append(req)
                if not live:
                    continue
                n = len(live)
                bucket = next(b for b in self.buckets if b >= n)
                # Backpressure: at most 2 batches between here and the
                # reply thread's copy-out (staging-slot safety + bounded
                # reply queue). The timeout loop keeps a dead reply
                # thread from wedging this one forever.
                while not self._inflight.acquire(timeout=0.5):
                    if self._thread_error is not None:
                        raise RuntimeError(
                            "reply thread died; device thread stopping"
                        ) from self._thread_error
                with self.timers.stage("assemble"):
                    flip = self._staging_flip[bucket]
                    if self._test_force_flip is not None:
                        flip = self._test_force_flip
                    self._staging_flip[bucket] = 1 - flip
                    self._ledger.write(self._staging_group[bucket], flip)
                    staging = self._programs[bucket].in_slots[flip].numpy()
                    for i, req in enumerate(live):
                        staging[i] = req.obs
                with self.timers.stage("device_infer"), guard():
                    event = self._infer(bucket, flip)
                # the holder formatted only for a real ledger: guards-off
                # batches pay no per-batch f-string
                hold = self._ledger.hold(
                    self._staging_group[bucket], flip,
                    holder=f"dispatch(n={n})" if self._ledger is not NULL_LEDGER else None,
                )
                with self._reply_cond:
                    self._reply_q.append((live, bucket, flip, event, hold))
                    self._reply_cond.notify()
                live = []  # resolved (or failed) by the reply thread now
                self.stats.observe_batch(n, bucket)
                with self._cond:
                    if self._draining and not self._queue:
                        self._stopped = True
                        self._cond.notify_all()
        except BaseException as e:
            self._thread_error = e
            # Fail everything this thread still owns — the queue AND the
            # in-hand `live` batch (whose futures are already RUNNING but
            # were never handed to the reply queue): a dead device thread
            # must not leave any client waiting out its full timeout.
            for req in live:
                if not req.future.done():
                    req.future.set_exception(e)
            with self._cond:
                pending, self._queue = list(self._queue), deque()
                self._stopped = True
                self._cond.notify_all()
            for req in pending:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(e)
            raise

    def _reply_loop(self) -> None:
        try:
            while True:
                with self._reply_cond:
                    # Bounded wait: the device thread can die without
                    # stop() ever pushing the sentinel — this thread must
                    # wake on its own clock and EXIT once the device thread
                    # is gone and the reply queue is drained (its death
                    # sweep already failed everything queued behind us).
                    while not self._reply_q:
                        if self._thread_error is not None:
                            return
                        self._reply_cond.wait(0.5)
                    item = self._reply_q.popleft()
                if item is None:
                    return
                live, bucket, flip, event, hold = item
                with self.timers.stage("reply"):
                    if event is not None:
                        # the D2H copy into the output slot landed, and the
                        # H2D copy out of the input slot before it
                        event.synchronize()
                    hold.release()
                    actions = self._programs[bucket].out_slots[flip].numpy()
                    # per-row copies: the futures outlive the slot, which
                    # the device thread reuses once the permit is back
                    rows = [actions[i].copy() for i in range(len(live))]
                    self._inflight.release()
                    t_done = time.perf_counter()
                    for req, row in zip(live, rows):
                        req.future.set_result(row)
                        self.stats.latency.add(t_done - req.t_submit)
                    self.stats.inc("replies_ok", len(live))
        except BaseException as e:
            self._thread_error = e
            # fail the batches still queued for reply, then everything in
            # the submit queue via the device-thread contract; the device
            # thread notices _thread_error in its bounded acquire loop
            with self._reply_cond:
                items, self._reply_q = list(self._reply_q), deque()
            for item in items:
                if item is None:
                    continue
                for req in item[0]:
                    if not req.future.done():
                        req.future.set_exception(e)
            raise
