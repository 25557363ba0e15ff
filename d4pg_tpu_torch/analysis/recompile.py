"""Recompile sentinel: per-program specialization accounting with budgets
(the port's counterpart of ``d4pg_tpu/analysis/recompile.py``).

A silent recapture is a correctness and a performance bug: the learner's
dispatch must build exactly one program for its config (an input that
changes shape or dtype between dispatches builds another specialization,
and on the card another CUDA graph, with the eager warm-up and the capture
that cost), the ring and tree ingests one for the whole run, and the
serving batcher one a bucket, never again across hot reloads.

The port's compiled programs are :class:`d4pg_tpu_torch.utils.graphs.
Program` objects: one specialization an input signature, a captured CUDA
graph each on the card. Two mechanisms, as in the JAX sentinel:

- **per-entry accounting** — :meth:`RecompileSentinel.track` registers a
  program by name and reads its specialization count
  (``fn._cache_size()``). Anything that is not such a program (an eager
  callable: the lanes' steps of a run of several processes) counts 0, as
  the JAX rule counts anything that is not a jit.
- **global build stream** — a listener of ``utils/graphs.py`` counts every
  specialization built in the process while started
  (:attr:`total_compiles`): on the card each CUDA graph captured, on the
  CPU each program built.

Budgets: :meth:`freeze` snapshots each tracked entry's current count as
its budget (optionally overridden per entry); :meth:`check` raises
:class:`RecompileBudgetError` naming every entry over budget. The trainer
pins its dispatch's budget after the first dispatch and checks at eval
crossings and at the end of ``train()``; the server checks each policy's
``<name>.infer`` (budget: the bucket count) at drain.
"""

from __future__ import annotations

from typing import Optional

from d4pg_tpu_torch.analysis import lockwitness


class RecompileBudgetError(RuntimeError):
    """A tracked program built more specializations than its budget."""


class _Entry:
    __slots__ = ("name", "fn", "budget")

    def __init__(self, name, fn, budget):
        self.name = name
        self.fn = fn
        self.budget = budget


def _cache_size(fn) -> int:
    """Number of specializations held by a program. ``graphs.Program``
    exposes ``_cache_size()``; anything else is treated as never
    recompiling."""
    sizer = getattr(fn, "_cache_size", None)
    return int(sizer()) if callable(sizer) else 0


class RecompileSentinel:
    """Records specializations per program and asserts budgets.

    Use as a context manager (or ``start()``/``stop()``) to also count
    the process-wide build stream; ``track``/``freeze``/``check`` work
    regardless."""

    def __init__(self):
        self._lock = lockwitness.named_lock("RecompileSentinel._lock")
        self._entries: dict[str, _Entry] = {}
        self._listener = None
        self._total = 0

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "RecompileSentinel":
        """Register the global build listener (idempotent)."""
        if self._listener is not None:
            return self
        from d4pg_tpu_torch.utils import graphs

        def _on_build(name: str) -> None:
            with self._lock:
                self._total += 1

        graphs.add_build_listener(_on_build)
        self._listener = _on_build
        return self

    def stop(self) -> None:
        """Unregister the global listener."""
        if self._listener is None:
            return
        from d4pg_tpu_torch.utils import graphs

        graphs.remove_build_listener(self._listener)
        self._listener = None

    def __enter__(self) -> "RecompileSentinel":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- tracking
    def track(self, name: str, fn, budget: Optional[int] = None) -> None:
        """Register a program under ``name``. ``budget`` caps its allowed
        specialization count; None = unbudgeted until :meth:`freeze`.
        Re-tracking a name replaces the program."""
        with self._lock:
            self._entries[name] = _Entry(name, fn, budget)

    def count(self, name: str) -> int:
        with self._lock:
            e = self._entries[name]
        return _cache_size(e.fn)

    def counts(self) -> dict:
        with self._lock:
            entries = list(self._entries.values())
        return {e.name: _cache_size(e.fn) for e in entries}

    @property
    def total_compiles(self) -> int:
        """Process-wide specializations built while started (every
        program's, tracked or not)."""
        with self._lock:
            return self._total

    # -------------------------------------------------------------- budgets
    def set_budget(self, name: str, budget: Optional[int]) -> None:
        """Pin one entry's budget (None = unbudgeted, skipped by check)."""
        with self._lock:
            self._entries[name].budget = budget

    def freeze(self, **overrides: int) -> dict:
        """Snapshot each tracked entry's current count as its budget (the
        warm-up builds ARE the budget); ``overrides`` pin specific entries
        to an explicit budget. Returns the budgets."""
        with self._lock:
            entries = list(self._entries.values())
        budgets = {}
        for e in entries:
            e.budget = int(overrides.get(e.name, _cache_size(e.fn)))
            budgets[e.name] = e.budget
        return budgets

    def check(self, where: str = "") -> dict:
        """Assert every budgeted entry is within budget; returns current
        counts. Raises :class:`RecompileBudgetError` naming each offender
        with its count and budget."""
        with self._lock:
            entries = list(self._entries.values())
        counts, over = {}, []
        for e in entries:
            n = _cache_size(e.fn)
            counts[e.name] = n
            if e.budget is not None and n > e.budget:
                over.append(f"{e.name}: {n} compiles > budget {e.budget}")
        if over:
            ctx = f" ({where})" if where else ""
            raise RecompileBudgetError(
                f"recompile budget exceeded{ctx}: " + "; ".join(over)
                + " — a traced argument likely degraded to a constant or "
                "changed shape/dtype between dispatches"
            )
        return counts
