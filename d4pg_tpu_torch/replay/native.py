"""ctypes bindings for the port's native C++ segment trees
(``d4pg_tpu_torch/csrc/sumtree.cpp``).

The port's own copy of ``d4pg_tpu/replay/native.py``. The source is
compiled on first use with ``g++ -O3 -shared -fPIC`` into
``d4pg_tpu_torch/_build/libsumtree.so`` (gitignored) and loaded with
ctypes; the C ABI keeps the binding free of any build dependency. It is
host code: nvcc never sees it. API-equal to the port's NumPy
:class:`~d4pg_tpu_torch.replay.SumTree` / ``MinTree``, so
:class:`~d4pg_tpu_torch.replay.PrioritizedReplayBuffer` swaps backends
through its ``tree_backend`` argument.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()


def _source_path() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(pkg, "csrc", "sumtree.cpp")


def _build_dir() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.path.join(pkg, "_build")
    os.makedirs(d, exist_ok=True)
    return d


def load_library() -> ctypes.CDLL:
    """Compile (if stale) and load the shared library. Raises on any
    failure; a buffer with ``tree_backend='auto'`` catches it and falls back
    to the NumPy trees with a printed line."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        src = _source_path()
        so = os.path.join(_build_dir(), "libsumtree.so")
        # <= so a fresh checkout (equal mtimes) rebuilds rather than loading
        # a foreign binary; no -march=native for the same reason.
        if not os.path.exists(so) or os.path.getmtime(so) <= os.path.getmtime(src):
            # The lock serializes this process's first users; the build goes
            # to a private name and is renamed into place, so another
            # process building at the same time never loads a torn file.
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise RuntimeError(f"g++ failed for {src}:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.st_create.restype = ctypes.c_void_p
        lib.st_create.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.st_destroy.restype = None
        lib.st_destroy.argtypes = [ctypes.c_void_p]
        lib.st_capacity.restype = ctypes.c_int64
        lib.st_capacity.argtypes = [ctypes.c_void_p]
        lib.st_set.restype = None
        lib.st_set.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.st_get.restype = None
        lib.st_get.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.st_root.restype = ctypes.c_double
        lib.st_root.argtypes = [ctypes.c_void_p]
        lib.st_find_prefix.restype = None
        lib.st_find_prefix.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.st_sample_gather.restype = None
        lib.st_sample_gather.argtypes = [
            ctypes.c_void_p,                   # sum tree
            ctypes.c_void_p,                   # min tree
            ctypes.POINTER(ctypes.c_double),   # prefixes [n]
            ctypes.c_int64,                    # n = K*B
            ctypes.c_int64,                    # deal_k
            ctypes.c_int64,                    # size (live rows)
            ctypes.c_double,                   # beta
            ctypes.c_void_p,                   # obs ring (f32 or u8)
            ctypes.POINTER(ctypes.c_float),    # action ring
            ctypes.POINTER(ctypes.c_float),    # reward ring
            ctypes.c_void_p,                   # next_obs ring
            ctypes.POINTER(ctypes.c_float),    # discount ring
            ctypes.POINTER(ctypes.c_int64),    # generation ring
            ctypes.c_int64,                    # obs_dim
            ctypes.c_int64,                    # act_dim
            ctypes.c_int,                      # obs_mode
            ctypes.POINTER(ctypes.c_int64),    # idx out
            ctypes.POINTER(ctypes.c_int64),    # gen out
            ctypes.POINTER(ctypes.c_float),    # weights out
            ctypes.c_void_p,                   # obs out
            ctypes.POINTER(ctypes.c_float),    # action out
            ctypes.POINTER(ctypes.c_float),    # reward out
            ctypes.c_void_p,                   # next_obs out
            ctypes.POINTER(ctypes.c_float),    # discount out
        ]
        lib.st_update_priorities.restype = ctypes.c_double
        lib.st_update_priorities.argtypes = [
            ctypes.c_void_p,                   # sum tree
            ctypes.c_void_p,                   # min tree
            ctypes.POINTER(ctypes.c_int64),    # idx [n]
            ctypes.POINTER(ctypes.c_double),   # priorities [n] (|td|+eps)
            ctypes.c_int64,                    # n
            ctypes.POINTER(ctypes.c_int64),    # sample_gen [n] or None
            ctypes.POINTER(ctypes.c_int64),    # current generation ring
            ctypes.c_double,                   # alpha
        ]
        _LIB = lib
        return _LIB


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _vp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


# obs_mode values of st_sample_gather (must match csrc/sumtree.cpp): a
# float32 buffer passes OBS_F32; a pixel buffer (uint8 rows) OBS_U8_DECODE,
# or OBS_U8_RAW for the uint8 wire (PrioritizedReplayBuffer._native_obs_mode).
OBS_F32 = 0        # float32 rows copied as-is
OBS_U8_DECODE = 1  # uint8 rows decoded to float32/255 at gather time
OBS_U8_RAW = 2     # uint8 rows copied raw (uint8 wire format)


class SampleGatherCall:
    """Precomputed ``st_sample_gather`` argument block for one (ring,
    staging-slot) pair.

    Marshalling a pointer (``ndarray.ctypes.data_as``) costs ~1-2 µs and
    the call takes 24 arguments, which at batch 256 rivals the gather
    itself. The ring arrays and the staging buffers are stable allocations,
    so every pointer but the per-call ``prefixes`` is computed ONCE here
    and the hot path marshals one array. The ring arrays must not be
    reallocated while this object lives (the buffer never does).
    """

    def __init__(
        self,
        sum_tree: "NativeSumTree",
        min_tree: "NativeMinTree",
        obs: np.ndarray,
        action: np.ndarray,
        reward: np.ndarray,
        next_obs: np.ndarray,
        discount: np.ndarray,
        gen: np.ndarray,
        obs_mode: int,
        out: dict,
    ):
        want = np.float32 if obs_mode != OBS_U8_RAW else np.uint8
        if out["obs"].dtype != want:
            raise TypeError(f"staging obs is {out['obs'].dtype}, obs_mode {obs_mode} needs {want}")
        for a in (obs, action, reward, next_obs, discount, gen, *out.values()):
            if not a.flags.c_contiguous:
                raise ValueError("st_sample_gather needs C-contiguous arrays")
        self._fn = load_library().st_sample_gather
        # the pointers below are raw: keep the trees and arrays alive
        self._keep = (sum_tree, min_tree, obs, action, reward, next_obs, discount, gen, out)
        self._trees = (sum_tree._h, min_tree._h)
        self._ring = (
            _vp(obs), _f32(action), _f32(reward), _vp(next_obs),
            _f32(discount), _i64(gen), obs.shape[1], action.shape[1],
            int(obs_mode),
        )
        self._out = (
            _i64(out["idx"]), _i64(out["gen"]), _f32(out["weights"]),
            _vp(out["obs"]), _f32(out["action"]), _f32(out["reward"]),
            _vp(out["next_obs"]), _f32(out["discount"]),
        )

    def __call__(
        self, prefixes: np.ndarray, deal_k: int, size: int, beta: float
    ) -> None:
        """Run the fused descent + IS weights + generation capture + row
        gather. ``prefixes`` [n] come from the caller's NumPy Generator,
        so the seeded draw stream equals the NumPy backend's."""
        prefixes = np.ascontiguousarray(prefixes, np.float64)
        self._fn(
            *self._trees, _f64(prefixes), prefixes.size, deal_k, size,
            float(beta), *self._ring, *self._out,
        )


def update_priorities(
    sum_tree: "NativeSumTree",
    min_tree: "NativeMinTree",
    idx: np.ndarray,
    priorities: np.ndarray,
    sample_gen: np.ndarray | None,
    cur_gen: np.ndarray,
    alpha: float,
) -> float:
    """Batched generation-filtered priority write-back; returns the max
    applied pre-α priority (0.0 when every entry was dropped as
    recycled)."""
    lib = load_library()
    idx = np.ascontiguousarray(idx, np.int64)
    priorities = np.ascontiguousarray(priorities, np.float64)
    if idx.size != priorities.size:
        raise ValueError(f"{idx.size} indices for {priorities.size} priorities")
    if idx.size and (idx.min() < 0 or idx.max() >= cur_gen.size):
        raise IndexError(f"priority index out of [0, {cur_gen.size})")
    if sample_gen is not None:
        sample_gen = np.ascontiguousarray(sample_gen, np.int64)
        if sample_gen.size != idx.size:
            raise ValueError(f"{sample_gen.size} generations for {idx.size} indices")
    sg = _i64(sample_gen) if sample_gen is not None else None
    return lib.st_update_priorities(
        sum_tree._h, min_tree._h, _i64(idx), _f64(priorities), idx.size,
        sg, _i64(cur_gen), float(alpha),
    )


class _NativeTreeBase:
    def __init__(self, capacity: int, is_min: bool):
        self._lib = load_library()
        self._h = self._lib.st_create(capacity, 1 if is_min else 0)
        self.capacity = self._lib.st_capacity(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.st_destroy(self._h)
            self._h = None

    def _indices(self, indices) -> np.ndarray:
        idx = np.ascontiguousarray(np.atleast_1d(indices), np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.capacity):
            raise IndexError(f"tree index out of [0, {self.capacity})")
        return idx

    def set(self, indices, values) -> None:
        idx = self._indices(indices)
        vals = np.ascontiguousarray(np.broadcast_to(values, idx.shape), np.float64)
        self._lib.st_set(self._h, _i64(idx), _f64(vals), idx.size)

    def get(self, indices) -> np.ndarray:
        idx = self._indices(indices)
        out = np.empty(idx.size, np.float64)
        self._lib.st_get(self._h, _i64(idx), _f64(out), idx.size)
        return out

    @property
    def root(self) -> float:
        return self._lib.st_root(self._h)


class NativeSumTree(_NativeTreeBase):
    def __init__(self, capacity: int):
        super().__init__(capacity, is_min=False)

    def sum(self) -> float:
        return self.root

    def find_prefixsum_idx(self, prefixes) -> np.ndarray:
        p = np.ascontiguousarray(np.atleast_1d(prefixes), np.float64)
        out = np.empty(p.size, np.int64)
        self._lib.st_find_prefix(self._h, _f64(p), _i64(out), p.size)
        return out


class NativeMinTree(_NativeTreeBase):
    def __init__(self, capacity: int):
        super().__init__(capacity, is_min=True)

    def min(self) -> float:
        return self.root
