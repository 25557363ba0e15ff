"""Runtime lock-order witness: actual nesting against the port's committed
lock graph (the port's copy of ``d4pg_tpu/analysis/lockwitness.py``).

The static half is the repo's lock-graph analyzer
(``tools/d4pglint/wholeprog/lockgraph.py:build_lock_graph``) run over
``d4pg_tpu_torch/``: its acquisition-order graph of the PORT's locks is
committed as ``d4pg_tpu_torch/analysis/lock_order_graph.json`` (the JAX
package's ``benchmarks/lock_order_graph.json`` names the JAX package's
locks, so checking the port against it would prove nothing). The package
never imports the analyzer; ``tests/test_torch_guards.py`` holds the
committed graph equal to the analyzer's output and acyclic, and
regenerates it (``python tests/test_torch_guards.py --write-lock-graph``).

Static analysis over-approximates in one direction (paths that cannot
execute) and under-approximates in another (callbacks, dynamic
dispatch); this module closes the loop from the runtime side: under
``debug_guards`` every named lock records the ACTUAL nesting (which locks
were held when it was acquired), and at drain/close the observed edges
are checked against the committed graph. An observed edge that the
static pass missed is tolerated alone, but an observed edge that
CONTRADICTS the static order (it makes the combined static and observed
graph cyclic) raises :class:`LockOrderWitnessError`: a lock inversion the
committed graph claims cannot happen just executed.

Wiring: construction sites call :func:`named_lock` / :func:`named_rlock` /
:func:`named_condition` with the lock's STATIC node id (the
``Class._attr`` / ``module:NAME`` naming the analyzer derives), so the
two halves speak one identity space. With the witness disabled (the
default), those helpers return plain ``threading`` primitives: zero
hot-path overhead. :func:`enable` (called when ``--debug-guards`` parses)
must run before the guarded objects are constructed.

Pure ``threading``: the pool, the chaos plan and the serving front end
import it.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

__all__ = [
    "LockOrderWitnessError", "enable", "enabled", "reset", "named_lock",
    "named_rlock", "named_condition", "observed_edges",
    "check_against", "check_against_committed",
]


class LockOrderWitnessError(RuntimeError):
    """A runtime acquisition order contradicts the committed lock graph."""


_ENABLED = False
_TLS = threading.local()            # .held: list[str] per thread
_REG_LOCK = threading.Lock()        # leaf-only: guards _EDGES, never nested
_EDGES: dict = {}                   # (held, acquired) -> count


def enable() -> None:
    """Arm the witness. Call BEFORE constructing guarded components
    (the train and serve CLIs do this while parsing --debug-guards)."""
    global _ENABLED
    _ENABLED = True


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Drop observed edges and disarm (tests)."""
    global _ENABLED
    _ENABLED = False
    with _REG_LOCK:
        _EDGES.clear()


def _held() -> list:
    held = getattr(_TLS, "held", None)
    if held is None:
        held = _TLS.held = []
    return held


def _record_acquire(name: str, obj_id: int) -> None:
    """Record edges held->name. Entries carry the proxy's object id so a
    REENTRANT acquisition (same RLock object already held by this
    thread) records no self-edge — that is legal — while nesting two
    DIFFERENT instances that share a node name (two clients' same attr)
    still records the self-edge, which IS a two-instance ordering
    hazard."""
    held = _held()
    if held:
        with _REG_LOCK:
            for h_name, h_id in held:
                if h_name == name and h_id == obj_id:
                    continue  # reentrant re-acquisition, not an ordering
                key = (h_name, name)
                _EDGES[key] = _EDGES.get(key, 0) + 1
    held.append((name, obj_id))


def _record_release(name: str, obj_id: int) -> None:
    held = _held()
    # remove the LAST occurrence: releases are usually LIFO but the
    # witness must not corrupt its stack when they are not
    for i in range(len(held) - 1, -1, -1):
        if held[i] == (name, obj_id):
            del held[i]
            return


class _Witnessed:
    """Context-manager/lock proxy recording nesting around the inner
    primitive. Condition methods pass through (``wait`` releases and
    reacquires the inner lock while this thread is parked, which cannot
    acquire anything else — the held stack stays truthful)."""

    __slots__ = ("_name", "_inner")

    def __init__(self, name: str, inner):
        self._name = name
        self._inner = inner

    # ---- lock surface
    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            _record_acquire(self._name, id(self))
        return got

    def release(self) -> None:
        self._inner.release()
        _record_release(self._name, id(self))

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self._inner.__enter__()
        _record_acquire(self._name, id(self))
        return self

    def __exit__(self, *exc):
        _record_release(self._name, id(self))
        return self._inner.__exit__(*exc)

    # ---- condition surface (delegates; no nesting events of their own)
    def wait(self, timeout: Optional[float] = None):
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()

    def __repr__(self) -> str:
        return f"Witnessed({self._name!r}, {self._inner!r})"


def named_lock(name: str):
    """A ``threading.Lock`` — witnessed under --debug-guards. ``name`` is
    the lock's STATIC graph node id (``Class._attr``)."""
    lock = threading.Lock()
    return _Witnessed(name, lock) if _ENABLED else lock


def named_rlock(name: str):
    lock = threading.RLock()
    return _Witnessed(name, lock) if _ENABLED else lock


def named_condition(name: str):
    cond = threading.Condition()
    return _Witnessed(name, cond) if _ENABLED else cond


def observed_edges() -> dict:
    """(held, acquired) -> count snapshot."""
    with _REG_LOCK:
        return dict(_EDGES)


def _cyclic_with(static_edges, observed) -> list:
    """Observed edges that close a cycle against the static graph: for
    each observed (a, b), a static-∪-observed path b -> a means two
    orders coexist. Returns the contradicting observed edges."""
    adj: dict = {}
    for a, b in static_edges:
        adj.setdefault(a, set()).add(b)
    for a, b in observed:
        adj.setdefault(a, set()).add(b)

    def reaches(src: str, dst: str) -> bool:
        seen = {src}
        frontier = [src]
        while frontier:
            for w in adj.get(frontier.pop(), ()):
                if w == dst:
                    return True
                if w not in seen:
                    seen.add(w)
                    frontier.append(w)
        return False

    return [(a, b) for a, b in sorted(observed) if a != b and reaches(b, a)] \
        + [(a, b) for a, b in sorted(observed) if a == b]


def check_against(graph: dict) -> dict:
    """Compare observed nesting to a lock-graph document. Raises
    :class:`LockOrderWitnessError` on contradiction; returns a summary
    dict otherwise."""
    static_edges = [(e["from"], e["to"]) for e in graph.get("edges", [])]
    observed = observed_edges()
    bad = _cyclic_with(static_edges, list(observed))
    if bad:
        detail = ", ".join(
            f"{a} -> {b} (observed {observed[(a, b)]}x)" for a, b in bad
        )
        raise LockOrderWitnessError(
            f"runtime lock order contradicts the committed graph: {detail} "
            "— a lock inversion the static analysis claims cannot happen "
            "just executed; fix the nesting and regenerate "
            "d4pg_tpu_torch/analysis/lock_order_graph.json"
        )
    novel = sorted(set(observed) - set(static_edges))
    return {
        "observed_edges": len(observed),
        "contradictions": 0,
        "novel_edges": len(novel),
    }


GRAPH_FILE = "lock_order_graph.json"


def committed_graph_path(root: Optional[str] = None) -> str:
    """The port's committed graph: beside this module, or under
    ``root/d4pg_tpu_torch/analysis/`` for a checkout at ``root``."""
    if root is None:
        return os.path.join(os.path.dirname(os.path.abspath(__file__)), GRAPH_FILE)
    return os.path.join(root, "d4pg_tpu_torch", "analysis", GRAPH_FILE)


def check_against_committed(
    root: Optional[str] = None, where: str = ""
) -> Optional[dict]:
    """Check observed nesting against the port's committed graph and
    print a one-line summary. No-op (None) when the witness is off or the
    graph file is absent."""
    if not _ENABLED:
        return None
    path = committed_graph_path(root)
    try:
        with open(path, encoding="utf-8") as f:
            graph = json.load(f)
    except (OSError, ValueError):
        print(f"[lockwitness] no committed graph at {path}; skipping check")
        return None
    summary = check_against(graph)
    ctx = f" ({where})" if where else ""
    print(
        f"[lockwitness]{ctx} {summary['observed_edges']} runtime "
        f"lock-order edges, 0 contradictions, "
        f"{summary['novel_edges']} beyond the static graph",
        flush=True,
    )
    return summary
