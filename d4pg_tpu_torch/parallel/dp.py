"""Synchronous data parallelism over lanes with a fixed-order gradient
mean (counterpart of ``d4pg_tpu/parallel/dp.py``).

Every lane holds the same train state, computes the gradients of its
``batch/dp`` rows, and one combine gives every lane the same mean, so the
replicas stay equal. The combine is :func:`det_pmean`, the JAX
``det_pmean``: the lanes' flat gradients are gathered into ``[dp, n]``
(a copy, ``parallel/distributed.all_gather_lanes``) and summed lane 0 to
dp−1 as explicit sequential adds, then divided by dp. No ``all_reduce``,
``torch.sum`` or ``stack(...).sum(0)``: their accumulation order is the
library's choice, this one is the program's, so a run of 2 ranks and a
run of 1 rank with 2 lanes give the same bits.

- :func:`make_dp_train_step` / :func:`make_dp_fused_train_step`: the
  host placement's ``--dp`` step: the batch's rows are split into
  ``dp`` contiguous lane shards (the JAX ``P("dp")``), every lane's
  critic and actor gradients are combined between backward and Adam
  (``agent/d4pg.py:train_step``'s ``sync_fn``), and the metrics too;
- :func:`make_hogwild_dp_train_step` (``--dp-hogwild``): each lane runs
  its K steps on its own copy of the state with no sync, then one
  fixed-order mean over every float tensor (params, targets, both Adam
  moment sets) makes the copies equal again; integer counters (Adam's
  step, the state's step) pass through, every copy advanced them alike.
"""

from __future__ import annotations

import copy

import torch

from d4pg_tpu_torch.agent.d4pg import fused_train_scan, train_step
from d4pg_tpu_torch.parallel.distributed import all_gather_lanes


def det_mean_rows(rows: torch.Tensor) -> torch.Tensor:
    """Fixed-order mean over the leading axis: ``acc = rows[0]``, then
    ``acc = acc + rows[i]`` for i = 1..n−1, then ``acc / n``."""
    n = rows.shape[0]
    acc = rows[0]
    for i in range(1, n):
        acc = acc + rows[i]
    return acc / n


def det_pmean(rows: torch.Tensor) -> torch.Tensor:
    """``[L, ...]`` rows of this rank's lanes → the fixed-order mean over
    every lane of every rank (a gather, then :func:`det_mean_rows`)."""
    return det_mean_rows(all_gather_lanes(rows))


class LaneSync:
    """The lanes' ``sync_fn``: :func:`det_pmean` over a mesh's lanes, plus
    the exact lane-wise min and max the sharded megastep takes of its PER
    scalars. ``calls`` counts the means (through a compiled program, its
    :class:`LaneProgram` keeps the count)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.calls = 0

    def _gather(self, rows: torch.Tensor) -> torch.Tensor:
        rows = all_gather_lanes(rows)
        if rows.shape[0] != self.mesh.dp:
            raise ValueError(f"gathered {rows.shape[0]} lanes, the mesh has {self.mesh.dp}")
        return rows

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        return det_mean_rows(self._gather(rows))

    def min(self, local: torch.Tensor) -> torch.Tensor:
        """Min of per-lane scalars ``[L]`` over all lanes (exact in any order)."""
        return self._gather(local).min()

    def max(self, local: torch.Tensor) -> torch.Tensor:
        return self._gather(local).max()


def split_lanes(batch: dict, n_lanes: int, axis: int = 0, dp: int | None = None) -> list:
    """A batch's rows (``axis`` 0 of [B, ...], 1 of [K, B, ...]) as
    ``n_lanes`` contiguous lane shards, views, in lane order."""
    rows = batch["reward"].shape[axis]
    if rows % n_lanes:
        raise ValueError(f"batch {rows} not divisible by dp={dp or n_lanes}")
    b = rows // n_lanes
    return [{k: v.narrow(axis, j * b, b) for k, v in batch.items()} for j in range(n_lanes)]


def _local_lanes(mesh) -> int:
    return len(mesh.local_lanes)


def make_dp_train_step(config, mesh):
    """``(state, batch) -> (state, metrics, priorities)``: one grad step
    over this rank's rows (the whole batch in one process), split into
    its lanes; ``priorities`` [B] in row order."""
    sync = LaneSync(mesh)

    def step(state, batch):
        return train_step(config, state, split_lanes(batch, _local_lanes(mesh), dp=mesh.dp),
                          sync_fn=sync)

    step.sync = sync
    return step


def make_dp_fused_train_step(config, mesh):
    """``(state, batches [K, B]) -> (state, metrics [K], priorities [K,
    B])``: K synchronous grad steps, each over this rank's lanes."""
    sync = LaneSync(mesh)

    def step(state, batches):
        lanes = split_lanes(batches, _local_lanes(mesh), axis=1, dp=mesh.dp)
        return fused_train_scan(config, state, lanes, sync_fn=sync)

    step.sync = sync
    return step


def replicate(state, n: int) -> list:
    """``[state]`` and ``n − 1`` deep copies of it: one train state per
    local lane of a hogwild window (modules, optimizers and generators
    copied together, so each copy's Adam steps its own parameters)."""
    return [state] + [copy.deepcopy(state) for _ in range(n - 1)]


def float_tensors(state) -> list:
    """Every float tensor a hogwild resync averages, in a fixed order: the
    four networks' parameters and buffers, then each optimizer's Adam
    moments (its float ``step`` is a counter and passes through)."""
    out = []
    for module in (state.actor, state.critic, state.target_actor, state.target_critic):
        out += [t for t in module.state_dict(keep_vars=True).values() if t.is_floating_point()]
    for opt in (state.actor_opt, state.critic_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                s = opt.state.get(p, {})
                out += [s[k] for k in ("exp_avg", "exp_avg_sq") if k in s]
    return out


class HogwildStep:
    """``(state, batches [K, B]) -> (state, metrics [K], priorities [K,
    B])``: each local lane steps its own copy of the state through its K
    shards with no per-step sync, then every float tensor of every copy is
    set to the fixed-order mean over all lanes. Copy 0 is ``state``; the
    others persist between windows (equal to it after each resync). A
    call makes them for a state it has not seen; a compiled program makes
    them first (:meth:`bind`), since a replay runs no Python."""

    def __init__(self, config, mesh):
        self.config = config
        self.mesh = mesh
        self.sync = LaneSync(mesh)
        self.replicas = None

    def bind(self, state) -> list:
        """Make ``state``'s replicas now (copies of it as it stands);
        returns the copies other than ``state``."""
        self.replicas = replicate(state, _local_lanes(self.mesh))
        return self.replicas[1:]

    def reload(self) -> None:
        """Copy copy 0 (restored in place by a resume) into the other
        copies, IN PLACE: a captured program reads them by address."""
        from d4pg_tpu_torch.runtime.checkpoint import load_state_into, state_dict_of

        saved = copy.deepcopy(state_dict_of(self.replicas[0]))
        for r in self.replicas[1:]:
            load_state_into(r, saved)

    @torch.no_grad()
    def _resync(self) -> None:
        per_lane = [float_tensors(r) for r in self.replicas]
        mean = self.sync(torch.stack([torch.cat([t.reshape(-1) for t in ts]) for ts in per_lane]))
        for ts in per_lane:
            offset = 0
            for t in ts:
                t.copy_(mean[offset: offset + t.numel()].view_as(t))
                offset += t.numel()

    def __call__(self, state, batches):
        n = _local_lanes(self.mesh)
        if self.replicas is None or self.replicas[0] is not state:
            self.bind(state)
        lanes = split_lanes(batches, n, axis=1, dp=self.mesh.dp)
        outs = [fused_train_scan(self.config, r, lb) for r, lb in zip(self.replicas, lanes)]
        self._resync()
        metrics = {k: self.sync(torch.stack([m[k] for _, m, _ in outs])) for k in outs[0][1]}
        return state, metrics, torch.cat([p for _, _, p in outs], dim=1)


def make_hogwild_dp_train_step(config, mesh) -> HogwildStep:
    return HogwildStep(config, mesh)


class LaneProgram:
    """A compiled program whose body combines through :class:`LaneSync` objects.
    The body's own count of its combines stops at the capture on the card
    (a replay runs no Python), so this wrapper counts them outside the
    body: the combines the program's first call made, again at every
    call, the way ``Trainer._run_program`` advances the step. So
    ``LaneSync.calls`` reads the same on the CPU and on the card. Every
    other attribute is the program's."""

    def __init__(self, program, *syncs):
        self.program = program
        self.syncs = syncs
        self.combines = None  # per call, one count a sync

    def __call__(self, *args):
        before = [s.calls for s in self.syncs]
        out = self.program(*args)
        if self.combines is None:
            self.combines = [s.calls - b for s, b in zip(self.syncs, before)]
        for s, b, n in zip(self.syncs, before, self.combines):
            s.calls = b + n
        return out

    def __getattr__(self, name):
        return getattr(self.program, name)


def lane_program(name: str, body, states, syncs, device=None) -> LaneProgram:
    """``body`` (tensors in and out) as a compiled program named ``name``
    over the train states ``states()`` returns (a state, or a hogwild
    window's state and its replicas): every tensor of every state bound by
    address, every state's generators registered."""
    from d4pg_tpu_torch.runtime.megastep import learner_generators, learner_tensors
    from d4pg_tpu_torch.utils import graphs

    prog = graphs.Program(
        name, body, device=device,
        state=lambda: [t for st in states() for t in learner_tensors(st)],
        generators=[g for st in states() for g in learner_generators(st)])
    return LaneProgram(prog, *syncs)
