"""Compiled programs: the port's counterpart of ``jax.jit``.

A :class:`Program` wraps a body of tensors in and tensors out. Every
non-tensor argument is bound when the program is built (``functools.
partial``, a closure), as ``jax.jit``'s static arguments are. The program
keeps one *specialization* for each input signature (the inputs' pytree
structure and each leaf's shape, dtype and device), as jit's cache does,
and :meth:`Program._cache_size` counts them: the number the recompile
sentinel (``analysis/recompile.py``) reads.

Each specialization owns static input buffers and static outputs. A call
copies its inputs into the static inputs, runs the body on them, and
returns COPIES of the outputs, so a caller never holds a buffer that the
next call overwrites (a priority block handed to a write-back thread, the
metrics a metrics row reads).

- On the card the body is captured once as a ``torch.cuda.CUDAGraph`` and
  replayed. Before the capture it runs ``warmup`` eager calls on the
  program's capture stream (real calls with the caller's inputs: a
  learner's first dispatch makes Adam's moments, a PER tier's first
  descent makes kernel B3's ticket counters), with cuDNN's autotuner off,
  so the capture records the algorithms the eager calls ran, and with
  Python's garbage collector held off (:func:`_no_collection`). A capture
  that fails raises; nothing falls back to eager.
- On the CPU the same body runs eagerly on the same static buffers, and its
  outputs are copied into static outputs before the copies are returned.
  So a bug in the buffer bindings (an input not copied in, a static output
  read after the next call, a Python scalar frozen at build) shows in the
  CPU tests too.

The body's host side effects run only at its eager calls and at the
capture: a replay runs no Python. The learner keeps its host step count
outside the body for that reason (``runtime/trainer.py``).

``state`` names the tensors the body closes over (parameters, Adam's
moments, the replay ring, the PER tree): a callable returning them. Their
``data_ptr``s are recorded when a specialization is captured (on the CPU
after its first call), and a later call whose state tensors are not the
recorded ones raises :class:`GraphBindingError` before it runs: a graph
replays on the addresses it captured, so a rebound tensor would be read
stale. ``generators`` are the device generators the body draws from; each
is registered with every graph (``CUDAGraph.register_generator_state``),
so a replay draws the next numbers of the generator's stream, as an eager
call would, and the generator stays checkpointable.

Every specialization built in the process (a capture on the card, a
program built on the CPU) is reported to the listeners of
:func:`add_build_listener`: the counterpart of the JAX sentinel's
``jax.monitoring`` compile stream.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Iterable, Optional

import torch
from torch.utils import _pytree as pytree

WARMUP_CALLS = 1  # eager calls of a specialization before its capture

_listeners_lock = threading.Lock()
_listeners: list = []


class GraphBindingError(RuntimeError):
    """A state tensor of a captured program is no longer the tensor it
    captured: a replay would read stale memory."""


def add_build_listener(fn: Callable[[str], None]) -> None:
    """Call ``fn(program_name)`` at every specialization built from now on."""
    with _listeners_lock:
        _listeners.append(fn)


def remove_build_listener(fn: Callable[[str], None]) -> None:
    with _listeners_lock:
        if fn in _listeners:
            _listeners.remove(fn)


def _report_build(name: str) -> None:
    with _listeners_lock:
        listeners = list(_listeners)
    for fn in listeners:
        fn(name)


@contextlib.contextmanager
def build_context():
    """What a warm-up and a capture run under: cuDNN's autotuner off (the
    capture must record the eager calls' algorithms), and the sync guard
    lifted (a capture synchronises the device once at its start, a build
    cost like a JAX compile, never a steady-state one)."""
    prev_bench = torch.backends.cudnn.benchmark
    prev_sync = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else 0
    torch.backends.cudnn.benchmark = False
    if prev_sync:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev_bench
        if prev_sync:
            torch.cuda.set_sync_debug_mode(prev_sync)


@contextlib.contextmanager
def _no_collection():
    """Python's cyclic garbage collector run to its end, then held off,
    around a capture: a collection inside the capture could destroy an
    unreachable graph (a program and its specializations refer to each
    other), and ``cudaGraphExecDestroy`` on the capturing thread
    invalidates the capture (seen on the H100: "operation not permitted
    when stream is capturing (function reset)", then the capture's end
    failing)."""
    gc.collect()
    was_enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def _signature(leaves: list, spec) -> tuple:
    return (str(spec),) + tuple(
        (tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor) else ("const", t)
        for t in leaves)


class Specialization:
    """One input signature's static buffers and, on the card, its graph.
    ``inputs`` are the static input leaves, ``outputs`` the static output
    leaves (set by the capture, or on the CPU by the first call)."""

    def __init__(self, program: "Program", leaves: list, spec):
        self.program = program
        self.in_spec = spec
        self.inputs = [torch.empty_like(t, memory_format=torch.contiguous_format)
                       for t in leaves]
        self.outputs: Optional[list] = None
        self.out_spec = None
        self.graph = None
        self.calls = 0
        self._bound: Optional[list] = None

    # ------------------------------------------------------------ bindings
    def _state(self) -> list:
        return list(self.program.state()) if self.program.state is not None else []

    def _record_bindings(self) -> None:
        self._bound = [(t, t.data_ptr()) for t in self._state()]

    def check_bindings(self) -> None:
        """Raise :class:`GraphBindingError` if any state tensor is not the
        one recorded at the capture (or at the CPU's first call)."""
        if self._bound is None:
            return
        live = self._state()
        if len(live) != len(self._bound):
            raise GraphBindingError(
                f"{self.program.name}: {len(live)} state tensors, {len(self._bound)} captured")
        for i, (t, (old, ptr)) in enumerate(zip(live, self._bound)):
            if t.data_ptr() != ptr or t.shape != old.shape:
                raise GraphBindingError(
                    f"{self.program.name}: state tensor {i} {tuple(t.shape)} was rebound "
                    "after the capture (restore into the captured tensors, copy_, never "
                    "replace them)")

    # ---------------------------------------------------------------- run
    def load(self, leaves: list) -> None:
        """Copy a call's input leaves into the static inputs (asynchronous on
        the card: the copies queue on the current stream, before the run)."""
        for dst, src in zip(self.inputs, leaves):
            dst.copy_(src, non_blocking=True)

    def run(self) -> list:
        """Run the body on the static inputs: a replay once captured, else a
        warm-up call, the capture (then a replay), or on the CPU an eager
        call. Returns the output leaves to read: the static outputs, or a
        warm-up call's own tensors."""
        prog = self.program
        self.calls += 1
        if self.graph is not None:
            self.check_bindings()
            self.graph.replay()
            return self.outputs
        if prog.device.type != "cuda":
            self.check_bindings()
            out = self._flat(prog.body(*pytree.tree_unflatten(self.inputs, self.in_spec)))
            if self.outputs is None:
                self.outputs = [t.clone() for t in out]
                self._record_bindings()
            else:
                for dst, src in zip(self.outputs, out):
                    dst.copy_(src)
            return self.outputs
        if self.calls <= prog.warmup:
            return self._warm()
        self.capture()
        self.graph.replay()
        return self.outputs

    def _flat(self, out) -> list:
        leaves, spec = pytree.tree_flatten(() if out is None else out)
        if self.out_spec is None:
            self.out_spec = spec
        return leaves

    def _warm(self) -> list:
        """One eager call of the body on the capture stream, ordered after
        the caller's stream and before its next work; its outputs handed to
        the caller's stream."""
        prog = self.program
        stream, cur = prog.stream(), torch.cuda.current_stream(prog.device)
        stream.wait_stream(cur)
        with build_context(), torch.cuda.stream(stream):
            out = self._flat(prog.body(*pytree.tree_unflatten(self.inputs, self.in_spec)))
        cur.wait_stream(stream)
        for t in out:
            t.record_stream(cur)
        return out

    def capture(self) -> None:
        """Capture the body as this specialization's graph (once)."""
        if self.graph is not None:
            return
        prog = self.program
        graph = torch.cuda.CUDAGraph()
        for gen in prog.generators:
            graph.register_generator_state(gen)
        stream = prog.stream()
        with build_context(), _no_collection():
            stream.wait_stream(torch.cuda.current_stream(prog.device))
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                out = self._flat(prog.body(*pytree.tree_unflatten(self.inputs, self.in_spec)))
        self.outputs = out
        self.graph = graph
        self._record_bindings()
        prog.captures += 1
        _report_build(prog.name)

    def prepare(self) -> "Specialization":
        """Build now, on whatever the static inputs hold: the program's
        warm-up calls and the capture on the card, one call on the CPU (a
        serving bucket, whose forward has no side effect, is built this way
        before its first request)."""
        if self.outputs is not None:
            return self
        if self.program.device.type != "cuda":
            self.run()
            return self
        for _ in range(self.program.warmup):
            self._warm()
        self.capture()
        return self

    def copy_outputs(self, leaves: list):
        return pytree.tree_unflatten([t.clone() for t in leaves], self.out_spec)


class Program:
    """A body of tensors in and tensors out, one specialization a signature.

    ``device`` is where the program runs (a body may take no tensor
    input); None takes the device of the first call's first tensor input.
    ``state`` is a callable returning the tensors the body closes over,
    ``generators`` the device generators it draws from."""

    def __init__(self, name: str, body: Callable, device=None, state: Optional[Callable] = None,
                 generators: Iterable = (), warmup: int = WARMUP_CALLS):
        self.name = name
        self.body = body
        self.device = None if device is None else torch.device(device)
        self.state = state
        self.generators = [g for g in generators if g is not None]
        self.warmup = int(warmup)
        self.captures = 0
        self._specs: dict = {}
        self._stream = None

    def stream(self):
        """The side stream this program warms up and captures on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def specialization(self, *args) -> tuple:
        """(specialization, input leaves) of ``args``, the specialization
        made (not yet built) at a new signature."""
        leaves, spec = pytree.tree_flatten(args)
        if self.device is None:
            self.device = next(t.device for t in leaves if isinstance(t, torch.Tensor))
        key = _signature(leaves, spec)
        s = self._specs.get(key)
        if s is None:
            s = self._specs[key] = Specialization(self, leaves, spec)
            if self.device.type != "cuda":
                _report_build(self.name)
        return s, leaves

    def __call__(self, *args):
        s, leaves = self.specialization(*args)
        s.load(leaves)
        return s.copy_outputs(s.run())

    def _cache_size(self) -> int:
        """Specializations held: the count ``jax.jit``'s ``_cache_size()``
        gives, which the recompile sentinel reads."""
        return len(self._specs)


def module_tensors(*modules) -> list:
    """Every parameter and buffer of ``modules``, in order."""
    out = []
    for m in modules:
        out += list(m.parameters()) + list(m.buffers())
    return out


def optimizer_tensors(*opts) -> list:
    """Every tensor of the optimizers' per-parameter state (Adam's moments
    and, capturable, its step), in parameter order."""
    out = []
    for opt in opts:
        for group in opt.param_groups:
            for p in group["params"]:
                st = opt.state.get(p)
                if st:
                    out += [v for _, v in sorted(st.items()) if isinstance(v, torch.Tensor)]
    return out
