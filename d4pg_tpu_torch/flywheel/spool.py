"""The mirror spool: a bounded on-disk log of mirrored WINDOWS2 payloads
(the port's copy of ``d4pg_tpu/flywheel/spool.py``: the same records and
segment names, so each package reads the other's spool).

The tap appends every mirrored frame's PAYLOAD bytes, exactly what went
to the fleet ingest with the behavior log-prob column, and the
promotion gate reads them back. One codec (``fleet/wire.py``), two
consumers.

Records are length-prefixed payloads (``u32`` byte count, then the
payload) in numbered segment files (``mirror-00000.log``,
``mirror-00001.log``, …). The writer rotates to a new segment past
``segment_bytes`` and deletes the oldest past ``max_segments``: the
spool is a bounded window over recent traffic (the gate estimates the
CURRENT serving distribution), never an unbounded disk leak. The reader
walks the segments in order and stops cleanly at a torn tail (a writer
that died mid-append): a torn record never half-decodes.

Writer and reader run in different processes with no locking: segments
are append-only, the reader takes whatever records are complete when it
reads, and rotation unlinks whole segments (a reader holding a deleted
segment's fd just finishes it).

numpy and the stdlib only.
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

from d4pg_tpu_torch.fleet import wire

_REC_HEAD = struct.Struct("<I")  # payload byte count
_SEGMENT_FMT = "mirror-%05d.log"
_SEGMENT_PREFIX = "mirror-"
_SEGMENT_SUFFIX = ".log"


def _segment_paths(root: str) -> List[str]:
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    segs = sorted(n for n in names
                  if n.startswith(_SEGMENT_PREFIX) and n.endswith(_SEGMENT_SUFFIX))
    return [os.path.join(root, n) for n in segs]


class MirrorSpool:
    """The append-only writer. Not thread-safe by itself: the tap's one
    sender thread is its only writer."""

    def __init__(self, root: str, *, segment_bytes: int = 8 << 20, max_segments: int = 8):
        assert segment_bytes > 0 and max_segments >= 1
        self.root = root
        self.segment_bytes = int(segment_bytes)
        self.max_segments = int(max_segments)
        os.makedirs(root, exist_ok=True)
        existing = _segment_paths(root)
        if existing:
            last = os.path.basename(existing[-1])
            self._seq = int(last[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)])
        else:
            self._seq = 0
        self._path = os.path.join(root, _SEGMENT_FMT % self._seq)
        self._f = open(self._path, "ab")
        self.appended = 0       # records appended by this process
        self.bytes_appended = 0

    def append(self, payload: bytes) -> None:
        """One mirrored WINDOWS2 payload, flushed at once: the gate may
        read from another process at any moment, and a record buffered
        here is one it never sees."""
        self._f.write(_REC_HEAD.pack(len(payload)) + payload)
        self._f.flush()
        self.appended += 1
        self.bytes_appended += _REC_HEAD.size + len(payload)
        if self._f.tell() >= self.segment_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._f.close()
        self._seq += 1
        self._path = os.path.join(self.root, _SEGMENT_FMT % self._seq)
        self._f = open(self._path, "ab")
        segs = _segment_paths(self.root)
        while len(segs) > self.max_segments:
            try:
                os.unlink(segs.pop(0))
            except OSError:
                break  # a racing cleanup: bounded either way

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def iter_payloads(root: str) -> Iterator[bytes]:
    """Every complete record across all segments, oldest first; stops
    cleanly at a torn tail (a short header or a short payload)."""
    for path in _segment_paths(root):
        try:
            f = open(path, "rb")
        except OSError:
            continue  # rotated away between listdir and open
        with f:
            while True:
                head = f.read(_REC_HEAD.size)
                if len(head) < _REC_HEAD.size:
                    break
                (n,) = _REC_HEAD.unpack(head)
                payload = f.read(n)
                if len(payload) < n:
                    break  # torn tail: the writer died mid-append
                yield payload


def read_windows(
    root: str,
    obs_dim: int,
    action_dim: int,
    *,
    min_generation: Optional[int] = None,
    max_windows: Optional[int] = None,
) -> Tuple[dict, int]:
    """The spool decoded into one concatenated column dict, newest last.

    Returns ``(cols, n)``: obs / action / reward / next_obs / discount /
    logprob arrays, all float32 (u8 rows are decoded ÷255, so the gate
    sees floats). Frames without the logprob column are skipped (the gate
    cannot weight a window whose propensity was never logged), and so is
    any record that does not decode at these dims. ``min_generation``
    drops windows of bundles older than that generation; ``max_windows``
    keeps only the newest that many. Nothing to read gives ``({}, 0)``.
    """
    import numpy as np

    frames = []
    for payload in iter_payloads(root):
        try:
            gen, _stats_gen, _mode, _relab, cols = wire.decode_windows2(
                payload, obs_dim, action_dim)
        except Exception:
            # any undecodable record (foreign dims, a torn column block)
            # is skipped: the gate reads best-effort from a spool another
            # process writes
            continue
        if "logprob" not in cols:
            continue
        if min_generation is not None and gen < min_generation:
            continue
        frames.append(cols)
    if not frames:
        return {}, 0
    keys = ("obs", "action", "reward", "next_obs", "discount", "logprob")
    out = {k: np.concatenate([f[k] for f in frames]) for k in keys}
    n = len(out["reward"])
    if max_windows is not None and n > max_windows:
        out = {k: v[-max_windows:] for k, v in out.items()}
        n = max_windows
    return out, n
