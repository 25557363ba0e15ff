"""Staging ledger: generation-tagged rotated host staging slots (the
port's copy of ``d4pg_tpu/analysis/ledger.py``).

Three hot paths hand a *preallocated* host buffer to a consumer that
reads it later, and rotate a few slots so that the next producer write
lands on memory nobody reads any more: PER ``sample_block``'s staging
slots (three), the host actor pool's reply slots (two) and the serving
batcher's input slots (two a bucket). Rewriting a slot too early is
silent data corruption: a dispatch trains or serves on rows that were
overwritten under it, and nothing crashes.

The ledger turns that into an immediate, attributable error:

- every rotated slot is *generation-tagged*: a producer calls
  :meth:`StagingLedger.write` before filling the slot;
- every consumer takes a :class:`Hold` on the slot once it has handed
  the slot to whatever reads it, and releases it at the point after
  which nothing reads it (where that is, is each wiring site's own
  argument: a pinned host copy that ``pin_memory`` finished, a CUDA
  event that completed, the caller's next step);
- a ``write`` to a slot with an unreleased hold raises
  :class:`StagingReuseError` naming the slot, the writer, and every
  holder: the bug fires at the overwrite site, not later as NaNs.

Pure ``threading`` and no torch: the pool module imports it, and spawned
pool workers must load nothing heavy. Guard wiring is behind
``debug_guards``; with guards off, components carry the shared
:data:`NULL_LEDGER` whose methods are no-ops, so the hot path pays one
attribute lookup and an empty call.
"""

from __future__ import annotations

import threading
from typing import Optional

from d4pg_tpu_torch.analysis import lockwitness


class StagingReuseError(RuntimeError):
    """A staging slot was rewritten while an in-flight dispatch held it."""


class Hold:
    """One consumer's claim on a staging slot (see :meth:`StagingLedger.hold`).

    ``release()`` is idempotent and thread-safe; call it at the point
    that synchronizes the consumer's read of the slot (a D2H fetch of
    the dispatch's output, a blocking result, …).
    """

    __slots__ = ("_ledger", "group", "index", "holder", "gen", "_released")

    def __init__(self, ledger: "StagingLedger", group: str, index: int,
                 holder: str, gen: int):
        self._ledger = ledger
        self.group = group
        self.index = index
        self.holder = holder
        self.gen = gen
        self._released = False

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._ledger._release(self)

    def __repr__(self) -> str:  # shows up in StagingReuseError messages
        state = "released" if self._released else "active"
        return (
            f"Hold({self.group}[{self.index}] gen={self.gen} "
            f"holder={self.holder!r} {state})"
        )


class StagingLedger:
    """Generation-tags rotated staging slots and polices write-while-held.

    Slots are addressed ``(group, index)`` — e.g. group
    ``"per.sample_block[n=512]"`` with index = rotation position.  The
    ledger never allocates or touches the buffers themselves; it only
    tracks who wrote and who still holds each slot.
    """

    def __init__(self, name: str = "staging"):
        self.name = name
        self._lock = lockwitness.named_lock("StagingLedger._lock")
        self._gen: dict = {}     # (group, index) -> write generation
        self._holds: dict = {}   # (group, index) -> list[Hold] (active)
        self._writes = 0
        self._trips = 0

    # ------------------------------------------------------------- producer
    def write(self, group: str, index: int, writer: Optional[str] = None) -> int:
        """Record a producer write to slot ``(group, index)``; returns the
        new generation. Raises :class:`StagingReuseError` if any consumer
        still holds the slot — the data an in-flight dispatch is reading
        would be overwritten."""
        who = writer or threading.current_thread().name
        with self._lock:
            key = (group, index)
            active = [h for h in self._holds.get(key, ()) if not h.released]
            if active:
                self._trips += 1
                holders = ", ".join(repr(h) for h in active)
                raise StagingReuseError(
                    f"[{self.name}] staging slot {group}[{index}] rewritten "
                    f"by {who!r} while still held by {holders}: an in-flight "
                    "dispatch reads this memory (buffer-reuse bug — the slot "
                    "rotation is too shallow or a hold was never released)"
                )
            gen = self._gen.get(key, 0) + 1
            self._gen[key] = gen
            self._holds[key] = []
            self._writes += 1
            return gen

    # ------------------------------------------------------------- consumer
    def hold(self, group: str, index: int, holder: Optional[str] = None) -> Hold:
        """Claim slot ``(group, index)`` on behalf of an in-flight consumer
        (dispatch). The slot's current generation is captured for the error
        message. Release at the consumer's true synchronization point."""
        who = holder or threading.current_thread().name
        with self._lock:
            key = (group, index)
            h = Hold(self, group, index, who, self._gen.get(key, 0))
            self._holds.setdefault(key, []).append(h)
            return h

    def _release(self, hold: Hold) -> None:
        with self._lock:
            holds = self._holds.get((hold.group, hold.index))
            if holds is not None and hold in holds:
                holds.remove(hold)

    # ------------------------------------------------------------ inspection
    def active_holds(self) -> list:
        with self._lock:
            return [h for hs in self._holds.values() for h in hs if not h.released]

    def stats(self) -> dict:
        with self._lock:
            return {
                "writes": self._writes,
                "trips": self._trips,
                "active_holds": sum(
                    sum(1 for h in hs if not h.released)
                    for hs in self._holds.values()
                ),
            }


class _NullHold:
    __slots__ = ()
    released = True

    def release(self) -> None:
        pass


class _NullLedger:
    """No-op ledger carried by components when guards are off: the hot
    path's ``ledger.write(...)`` costs an empty method call."""

    __slots__ = ()
    name = "null"
    _NULL_HOLD = _NullHold()

    def write(self, group: str, index: int, writer: Optional[str] = None) -> int:
        return 0

    def hold(self, group: str, index: int, holder: Optional[str] = None):
        return self._NULL_HOLD

    def active_holds(self) -> list:
        return []

    def stats(self) -> dict:
        return {"writes": 0, "trips": 0, "active_holds": 0}


NULL_LEDGER = _NullLedger()
