"""The lane layout (counterpart of ``d4pg_tpu/parallel/mesh.py``).

A lane is the port's counterpart of one device on the JAX ``("dp",
"tp")`` mesh. ``make_mesh(dp, tp)`` lays ``dp × tp`` lanes out in the
JAX grid's row-major order: lane ``(d, t)`` is grid entry ``d·tp + t``.
A dp lane (a row of the grid) owns ``batch/dp`` rows of every grad step
and, on the device placement, ``capacity/dp`` ring rows and their
priority subtree; its ``tp`` lanes hold the tensor-parallel shards of
the train state (``parallel/partition.py``, ``parallel/tp.py``). The dp
rows are split over ``num_processes`` ranks, one rank per process:
process ``p`` owns the contiguous dp lanes ``[p·dp/P, (p+1)·dp/P)``
(the JAX ``local_shard_span`` invariant) with all their tp lanes, so a
tp combine never crosses ranks, and runs them one after another, in lane
order. dp lane ``d`` and all its tp lanes sit on ``cuda:(d %
torch.cuda.device_count())`` (the CPU for a CPU run): the tp lanes of a
process share its card (one process's lanes on several cards are ROADMAP
A7 (d)), so on a one-card machine every lane shares ``cuda:0``.
``devices[d]`` is dp lane ``d``'s device, ``grid`` every lane's.

The only cross-lane arithmetic is ``parallel/dp.py``'s fixed-order mean
over the dp lanes and ``parallel/tp.py``'s fixed-order sum over the tp
lanes, so the numbers do not depend on how the lanes are split into
processes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

@dataclass(frozen=True)
class Mesh:
    """``dp × tp`` lanes over ``num_processes`` ranks; ``process_index``
    is this process's rank and ``devices[d]`` dp lane ``d``'s device."""

    dp: int
    tp: int
    num_processes: int
    process_index: int
    devices: tuple

    @property
    def grid(self) -> tuple:
        """Every lane's device, row-major: lane ``(d, t)`` at ``d·tp + t``."""
        return tuple(dev for dev in self.devices for _ in range(self.tp))

    @property
    def shape(self) -> dict:
        """The mesh axes' sizes, as the JAX ``Mesh.shape``."""
        return {"dp": self.dp, "tp": self.tp}

    @property
    def lanes_per_process(self) -> int:
        return self.dp // self.num_processes

    def owner(self, lane: int) -> int:
        """The rank that runs lane ``lane``."""
        return lane // self.lanes_per_process

    @property
    def local_lanes(self) -> range:
        """This process's lanes, in lane order."""
        lo = self.process_index * self.lanes_per_process
        return range(lo, lo + self.lanes_per_process)

    def lane_device(self, lane: int) -> torch.device:
        return self.devices[lane]

    @property
    def device(self) -> torch.device:
        """The device this rank computes on: its first lane's. Its lanes
        must all sit there (:func:`check_one_device`)."""
        return self.devices[self.local_lanes[0]]


def make_mesh(
    dp: int | None = None,
    tp: int = 1,
    device=None,
    num_processes: int | None = None,
    process_index: int | None = None,
) -> Mesh:
    """The lane layout of a ``dp × tp`` run. ``dp=None`` gives a dp lane
    to every card of every process (one per process on the CPU).
    The rank count and index default to the process group's
    (``parallel/distributed.py``), 1 and 0 without one. ``device`` is the
    device type the lanes run on (default: the CUDA card). A layout in
    which a process would hold part of a dp row's tp lanes raises
    ``tp_group_spans_ranks``."""
    from d4pg_tpu_torch import resolve_device
    from d4pg_tpu_torch.parallel import distributed

    if tp < 1:
        raise ValueError(f"mesh needs tp >= 1, got {tp}")
    kind = resolve_device(device).type
    cards = torch.cuda.device_count() if kind == "cuda" else 1
    if num_processes is None:
        num_processes = distributed.process_count()
    if process_index is None:
        process_index = distributed.process_index()
    if dp is None:
        dp = num_processes * cards
    if dp < 1:
        raise ValueError(f"mesh needs dp >= 1, got {dp}")
    if dp % num_processes and (dp * tp) % num_processes == 0:
        raise ValueError(
            f"tp_group_spans_ranks: {dp}x{tp} lanes over {num_processes} processes would "
            "split a dp row's tp lanes between ranks; each process must own whole dp "
            "rows (--dp divisible by --num-processes), so a tp combine never crosses ranks"
        )
    if dp % num_processes:
        raise ValueError(
            f"--dp {dp} must be divisible by --num-processes {num_processes} "
            "(each process owns dp/num_processes contiguous mesh shards)"
        )
    if not 0 <= process_index < num_processes:
        raise ValueError(f"process_index {process_index} not in [0, {num_processes})")
    devices = tuple(
        torch.device("cuda", d % cards) if kind == "cuda" else torch.device("cpu")
        for d in range(dp)
    )
    return Mesh(dp, tp, num_processes, process_index, devices)


def check_one_device(mesh: Mesh) -> torch.device:
    """The rank's device, after checking that all its lanes sit on it:
    lanes of ONE process on different cards would need a state replica per
    card, which is not ported (run one process per card instead)."""
    devs = {mesh.lane_device(d) for d in mesh.local_lanes}
    if len(devs) > 1:
        raise NotImplementedError(
            f"lanes {list(mesh.local_lanes)} of process {mesh.process_index} sit on "
            f"{sorted(str(d) for d in devs)}: one process's lanes on several cards "
            "(a state replica per card) is not ported to d4pg_tpu_torch yet "
            "(ROADMAP A7 (d)); run one process per card with --num-processes"
        )
    return mesh.device
