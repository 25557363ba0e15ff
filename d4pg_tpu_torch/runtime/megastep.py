"""The megastep: K grad steps per dispatch over the device-resident ring.

Counterpart of ``d4pg_tpu/runtime/megastep.py`` on one device (the
sharded megasteps wait for ROADMAP A7). One dispatch draws its [K, B]
indices on the device (or, on the ``hybrid`` placement, takes them from
the host tree), gathers the K batches from the device ring in one op per
field, runs K ``train_step``s and, with device PER, writes the priorities
back into the device tree. Nothing is read on the host: the state, the
ring, the tree and the generator stay on the device between dispatches,
and every body runs clean under ``torch.cuda.set_sync_debug_mode("error")``.

JAX jits each body into one donated-buffer program; here the bodies run
eagerly and update the train state (``train_step``), the tree's ``sums``
and ``max_priority`` IN PLACE. Each returns the K-step mean of the step
metrics as 0-d device tensors (the hybrid body also its [K, B]
priorities).

Four bodies, one per tier:

- :func:`megastep_uniform_body`: uniform draws, no IS weights;
- :func:`megastep_device_per_body`: the stratified PER draw over the whole
  [K, B] block descended once (kernel B3), IS
  weights from the leaves at dispatch start, K steps (the categorical
  head's on the fused loss kernels B1f and B1b, the scalar and MoG heads'
  in plain PyTorch), then the last-wins write-back;
- :func:`megastep_device_per_fused_body`: one B3 call descends the first
  step's prefixes and returns the tree's chunk offsets; from then on each
  step's loss kernel (B4) also descends the NEXT step's prefixes on those
  offsets, so a dispatch runs B3 once and B4 K times (categorical head
  only);
- :func:`megastep_hybrid_body`: the ``hybrid`` placement (any head). The host PER
  tree drew the [K, B] indices and IS weights (the only host-to-device
  copy of the dispatch); the rows come from the device ring, and the
  [K, B] priorities go back to the host tree (the only copy back).

Every other body takes an explicit ``idx`` / ``prefixes`` for tests that
feed the JAX package's draws; by default it draws from the ``torch.Generator``
it is given.

A CUDA graph of a PER dispatch must be captured after one eager dispatch
on the same device: kernel B3 (``ops/cuda_tree.py``) makes its ticket
counters at a device's first call, and refuses that first call inside a
capture. The graph then keeps the counter of the stream it was captured
on, so it must not replay while a B3 call on that stream is in flight.
"""

from __future__ import annotations

from functools import partial

import torch

from d4pg_tpu_torch.agent.d4pg import fused_train_scan, gather_batches, train_step
from d4pg_tpu_torch.agent.state import D4PGConfig, TrainState
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_ring import DeviceRing


def _mean(metrics: dict) -> dict:
    return {k: v.mean() for k, v in metrics.items()}


def draw_uniform_indices(
    generator: torch.Generator, k: int, batch: int, size: torch.Tensor
) -> torch.Tensor:
    """[k, batch] int64 uniform over ``[0, size)``, ``size`` a 0-d device
    int: ``floor(u·size)`` from float64 uniforms (the bias against
    ``randint`` is below 2^-32 at a million rows), clamped for the u·size
    rounding edge."""
    u = torch.rand((k, batch), generator=generator, device=size.device, dtype=torch.float64)
    idx = (u * size).long()
    return torch.minimum(idx, (size - 1).clamp_min(0).long())


def megastep_uniform_body(
    config: D4PGConfig, k: int, batch: int,
    state: TrainState, ring: DeviceRing, generator: torch.Generator,
    idx: torch.Tensor | None = None,
) -> dict:
    """K grad steps on uniform draws from the ring. No ``weights`` key (the
    JAX body's rule): uniform IS weights are identically 1."""
    if idx is None:
        idx = draw_uniform_indices(generator, k, batch, ring.size)
    batches = gather_batches(ring, idx)
    _, metrics, _ = fused_train_scan(config, state, batches)
    return _mean(metrics)


def _draw_prefixes(generator, k, batch, total, prefixes):
    if prefixes is not None:
        return prefixes
    u = torch.rand((k, batch), generator=generator, device=total.device)
    return dper.stratified_prefixes(u, k, batch, total)


def _write_back(config, ring, tree, idx, priorities) -> None:
    _, mp = dper.write_back_lane(
        tree.sums, idx, priorities, config.per_alpha, config.per_eps,
        capacity=ring.obs.shape[0],
    )
    tree.max_priority.copy_(torch.maximum(tree.max_priority, mp))


def megastep_device_per_body(
    config: D4PGConfig, k: int, batch: int,
    state: TrainState, ring: DeviceRing, tree: dper.DevicePerTree,
    generator: torch.Generator, prefixes: torch.Tensor | None = None,
) -> dict:
    """K grad steps on PER draws from the device tree: stratified prefixes,
    one B3 descent of the whole [K, B] block, IS weights from the leaves
    and β at dispatch start, K train steps, then the last-wins
    priority write-back and the max-priority update, all IN PLACE on
    ``tree``."""
    pre = _draw_prefixes(generator, k, batch, tree.sums[1], prefixes)
    idx, p_leaf, total = dper.lane_draw(tree.sums, pre, ring.size)
    min_ratio = dper.lane_min_leaf(tree.sums) / total
    beta = dper.beta_at(state.step, config.per_beta0, config.per_beta_steps)
    batches = gather_batches(ring, idx)
    batches["weights"] = dper.importance_weights(p_leaf, total, min_ratio, ring.size, beta)
    _, metrics, priorities = fused_train_scan(config, state, batches)
    _write_back(config, ring, tree, idx, priorities)
    return _mean(metrics)


def megastep_device_per_fused_body(
    config: D4PGConfig, k: int, batch: int,
    state: TrainState, ring: DeviceRing, tree: dper.DevicePerTree,
    generator: torch.Generator, prefixes: torch.Tensor | None = None,
) -> dict:
    """The fused-descent tier: the draws, weights and write-back of
    :func:`megastep_device_per_body`, but pipelined. The tree is constant until the write-back, so every step's
    prefixes are known up front: one B3 call descends ``pre[0]`` (and
    yields the chunk offsets, which stay on the device), then step t's loss
    kernel B4 descends ``pre[t+1]`` on them. The last step descends the rolled-around ``pre[0]`` and
    that result is dropped, as in the JAX body."""
    sums = tree.sums
    half = sums.shape[0] // 2
    leaves, total = sums[half:], sums[1]
    pre = _draw_prefixes(generator, k, batch, total, prefixes)
    raw0, chunk_offsets = dper.find_leaves(sums, pre[0])
    idx_t = dper.clamp_to_fill(raw0, ring.size)
    min_ratio = dper.lane_min_leaf(sums) / total
    beta = dper.beta_at(state.step, config.per_beta0, config.per_beta_steps)
    pre_next = torch.roll(pre, -1, dims=0)
    step_metrics, priorities, drawn = [], [], []
    for t in range(k):
        batch_t = gather_batches(ring, idx_t)
        batch_t["weights"] = dper.importance_weights(
            leaves.index_select(0, idx_t.long()), total, min_ratio, ring.size, beta
        )
        _, m, pri, raw = train_step(
            config, state, batch_t, descent=(leaves, pre_next[t], chunk_offsets)
        )
        step_metrics.append(m)
        priorities.append(pri)
        drawn.append(idx_t)
        idx_t = dper.clamp_to_fill(raw, ring.size)
    _write_back(config, ring, tree, torch.stack(drawn), torch.stack(priorities))
    return {key: torch.stack([m[key] for m in step_metrics]).mean() for key in step_metrics[0]}


def megastep_hybrid_body(
    config: D4PGConfig, state: TrainState, ring: DeviceRing,
    idx: torch.Tensor, weights: torch.Tensor,
):
    """K grad steps on host-descended PER draws: ``idx`` and ``weights``
    are the [K, B] blocks of the host tree's ``sample_block_indices``, on
    the device; the rows are gathered from the ring. Returns ``(metrics,
    the K-step mean; priorities [K, B])``. The caller writes the
    priorities back into the host tree."""
    batches = gather_batches(ring, idx)
    batches["weights"] = weights
    _, metrics, priorities = fused_train_scan(config, state, batches)
    return _mean(metrics), priorities


def make_megastep_uniform(config: D4PGConfig, k: int, batch: int):
    """``(state, ring, tree, generator) -> metrics``; ``tree`` is unused
    (``None``), so all three makers share one signature."""
    body = partial(megastep_uniform_body, config, k, batch)
    return lambda state, ring, tree, generator: body(state, ring, generator)


def make_megastep_device_per(config: D4PGConfig, k: int, batch: int):
    """``(state, ring, tree, generator) -> metrics``, the separate-kernels tier."""
    return partial(megastep_device_per_body, config, k, batch)


def make_megastep_device_per_fused(config: D4PGConfig, k: int, batch: int):
    """``(state, ring, tree, generator) -> metrics``, the fused-descent tier."""
    return partial(megastep_device_per_fused_body, config, k, batch)


def make_megastep_hybrid(config: D4PGConfig):
    """``(state, ring, idx, weights) -> (metrics, priorities)``; K and B
    come from the index block's shape."""
    return partial(megastep_hybrid_body, config)
