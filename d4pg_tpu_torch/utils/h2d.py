"""Host-to-device copies: at once on the compute stream, or ahead on a
CUDA stream of their own.

:func:`to_device` serves a consumer that reads the tensors at once: pinned
host copies and ``non_blocking`` copies on the current stream, in stream
order with the work already there. Such a copy queues behind the
dispatch in flight, so it cannot overlap it. :class:`H2DStream` serves a
copy started ahead of its consumer (a prefetched batch, a staged ring
chunk) and issues it on a dedicated stream instead: the host arrays are
pinned (a host copy), the device tensors are allocated and filled under
the copy stream, and an event is recorded after the copies. The consumer
calls :meth:`H2DStream.consume` before it reads them: its stream waits on
that event and takes ownership of the tensors (``record_stream``), so the
caching allocator cannot hand their memory out again while the consumer's
kernels still read it. Nothing here synchronises the host.

On the CPU the arrays are wrapped as tensors without a copy and there is
no event. An array may also be a host tensor already (a bfloat16 wire
batch, which numpy cannot hold).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.contiguous()
    return torch.from_numpy(np.ascontiguousarray(v))


def to_device(arrays: Mapping[str, np.ndarray], device: torch.device) -> dict:
    """Copy every array to ``device`` on the current stream; the copies
    are asynchronous (pinned, ``non_blocking``) and the tensors may be
    read at once by work on that stream. pin_memory() copies, so the
    caller may reuse its arrays at once; PyTorch's host allocator keeps
    each pinned block until its copy has run."""
    out = {}
    for k, v in arrays.items():
        t = _host_tensor(v)
        out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


class H2DStream:
    """Copies dicts of host arrays to ``device`` off the compute stream."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def put(self, arrays: Mapping[str, np.ndarray]):
        """Start the copy of every array; returns ``(tensors, ready)``:
        device tensors under the same keys and the copy-done event (None on
        the CPU). The tensors may be read only after :meth:`consume`."""
        if self._stream is None:
            return to_device(arrays, self.device), None
        # pinned as in to_device, but allocated and copied under the stream
        pinned = {k: _host_tensor(v).pin_memory() for k, v in arrays.items()}
        with torch.cuda.stream(self._stream):
            out = {k: p.to(self.device, non_blocking=True) for k, p in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def consume(self, tensors: Mapping[str, torch.Tensor], ready: Optional[torch.cuda.Event]) -> None:
        """Order the current stream after the copies of :meth:`put` and hand
        it the tensors' memory. A no-op on the CPU."""
        if ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        for t in tensors.values():
            t.record_stream(stream)
