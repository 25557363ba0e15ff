"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

at first use, into ``d4pg_tpu_torch/_build/`` (listed in ``.gitignore``).
The file name carries a hash of the flags, the source and every header it
includes from ``csrc/`` (quoted ``#include``, followed transitively), so
an edited source or header is rebuilt and a stale library is never
loaded. No PyTorch header is included, which keeps a build to seconds;
:func:`build_all` runs one ``nvcc`` per source, all at once. A missing
``nvcc`` or a failed build raises: there is no fallback to the plain
versions on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source,
# kept for chip_smoke.py to print.
build_logs: dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from d4pg_tpu_torch/csrc at first use"
    )


def _inputs(src: Path) -> list[Path]:
    """``src`` and every file it includes by a quoted ``#include`` that
    exists beside the including file, transitively, in a fixed order."""
    seen: set[Path] = set()
    todo = [src]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for inc in _INCLUDE.findall(path.read_text()):
            header = path.parent / inc
            if header.exists():
                todo.append(header)
    return sorted(seen)


def _target(name: str, csrc: Path = CSRC) -> tuple[Path, Path]:
    src = csrc / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _inputs(src):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    src, out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_logs[name] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build_all(names) -> None:
    """Build several sources at once, one ``nvcc`` process each; raises the
    first failure after all have finished. ``chip_smoke.py`` builds every
    source this way: its time limit is fixed while each slice adds sources,
    so the build costs the slowest source, not their sum."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for fut in [pool.submit(_build, n) for n in names]:
            fut.result()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_build(name)))
        return _libs[name]


def bind(name: str, signatures: dict) -> dict:
    """Load ``csrc/<name>.cu`` and type its C entry points: ``signatures``
    maps each symbol to its argtypes (the trailing stream pointer
    included); every entry returns a CUDA error code as ``int``."""
    lib = load(name)
    fns = {}
    for sym, argtypes in signatures.items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[sym] = fn
    return fns


def launch(fn, device: torch.device, *args) -> None:
    """Call a bound entry point with ``device``'s current stream as its last
    argument; raise if CUDA refused the launch."""
    with torch.cuda.device(device):
        status = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"{fn.__name__} launch failed with CUDA error {status}")
