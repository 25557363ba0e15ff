"""The megastep: K grad steps per dispatch over the device-resident ring.

Counterpart of ``d4pg_tpu/runtime/megastep.py``. One dispatch draws its [K, B]
indices on the device (or, on the ``hybrid`` placement, takes them from
the host tree), gathers the K batches from the device ring in one op per
field, runs K ``train_step``s and, with device PER, writes the priorities
back into the device tree. Nothing is read on the host: the state, the
ring, the tree and the generator stay on the device between dispatches,
and every body runs clean under ``torch.cuda.set_sync_debug_mode("error")``.

JAX jits each body into one donated-buffer program. Here each body
updates the train state (``train_step``), the tree's ``sums`` and
``max_priority`` IN PLACE, and :func:`megastep_program` and
:func:`hybrid_program` make the single-device bodies compiled programs
(``utils/graphs.py``): a CUDA graph captured after one eager dispatch and
replayed on the card, the same body run eagerly on static buffers on the
CPU. Each returns the K-step mean of the step metrics as 0-d device
tensors (the hybrid body also its [K, B] priorities). The PER tiers' β is
an input of the program (:func:`~d4pg_tpu_torch.replay.device_per.
beta_tensor` of the host step at dispatch start), so every replay anneals
it.

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

The sharded bodies (``--dp`` on the device placement) run the same
dispatch over the lanes of a ``parallel.mesh.Mesh``: each lane draws
``batch/dp`` rows a step from its own striped ring and (PER) its own
subtree, with its own generator, seeded from ``(seed, lane)``
(:func:`lane_generators`, the JAX ``fold_in(key, shard)``); the lanes'
gradients and metrics meet in ``parallel/dp.py``'s fixed-order mean,
and the PER weight ratio and the max priority in an exact min and max
over the lanes. B3 runs once per lane per dispatch, B1f and B1b once per
lane per grad step. In one process the lanes run one after another, which
is the JAX package's single-device vmap oracle; split over processes they
give the same bits. The fused-descent tier stays single-device.
:func:`sharded_megastep_program` makes them a compiled program as
:func:`megastep_program` does the single-device ones, its bound state
every local lane's ring, subtree and generator; β is its input here too.

Every other body takes an explicit ``idx`` / ``prefixes`` for tests that
feed the JAX package's draws; by default it draws from the ``torch.Generator``
it is given.

A CUDA graph of a PER dispatch must be captured after one eager dispatch
on the same device: kernel B3 (``ops/cuda_tree.py``) makes its ticket
counters at a device's first call, and refuses that first call inside a
capture. The program's one eager warm-up dispatch is that call. The graph
then keeps the counter of the program's capture stream, on which nothing
else runs B3, so no replay meets a B3 call in flight on that counter.

Over several processes the sharded bodies stay eager: their combines
cross the processes on the host, which no CUDA graph can hold.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from d4pg_tpu_torch.agent.d4pg import fused_train_scan, gather_batches, train_step
from d4pg_tpu_torch.agent.state import D4PGConfig, TrainState
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.replay.device_ring import DeviceRing
from d4pg_tpu_torch.utils import graphs


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


def _beta(config: D4PGConfig, state: TrainState, device, beta):
    """The dispatch's β: the given 0-d input, else the host step's."""
    if beta is not None:
        return beta
    return dper.beta_tensor(state.step, config.per_beta0, config.per_beta_steps, device)


def megastep_device_per_body(
    config: D4PGConfig, k: int, batch: int,
    state: TrainState, ring: DeviceRing, tree: dper.DevicePerTree,
    generator: torch.Generator, prefixes: torch.Tensor | None = None,
    beta: torch.Tensor | None = None,
) -> dict:
    """K grad steps on PER draws from the device tree: stratified prefixes,
    one B3 descent of the whole [K, B] block, IS weights from the leaves
    and β at dispatch start (``beta``, a 0-d float32 device tensor; by
    default the host step's), K train steps, then the last-wins
    priority write-back and the max-priority update, all IN PLACE on
    ``tree``."""
    pre = _draw_prefixes(generator, k, batch, tree.sums[1], prefixes)
    idx, p_leaf, total = dper.lane_draw(tree.sums, pre, ring.size)
    min_ratio = dper.lane_min_leaf(tree.sums) / total
    beta = _beta(config, state, tree.sums.device, beta)
    batches = gather_batches(ring, idx)
    batches["weights"] = dper.importance_weights(p_leaf, total, min_ratio, ring.size, beta)
    _, metrics, priorities = fused_train_scan(config, state, batches)
    _write_back(config, ring, tree, idx, priorities)
    return _mean(metrics)


def megastep_device_per_fused_body(
    config: D4PGConfig, k: int, batch: int,
    state: TrainState, ring: DeviceRing, tree: dper.DevicePerTree,
    generator: torch.Generator, prefixes: torch.Tensor | None = None,
    beta: torch.Tensor | None = None,
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
    beta = _beta(config, state, sums.device, beta)
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


def learner_tensors(state: TrainState, ring: DeviceRing | None = None,
                    tree: dper.DevicePerTree | None = None) -> list:
    """Every tensor a learner program reads by address: the four networks'
    parameters and buffers, both optimizers' state (Adam's moments and, on
    the card, its step), the ring's fields and the tree. What
    ``graphs.Program`` records at the capture and checks at each replay."""
    out = graphs.module_tensors(state.actor, state.critic, state.target_actor,
                                state.target_critic)
    out += graphs.optimizer_tensors(state.actor_opt, state.critic_opt)
    return out + replay_tensors(ring, tree)


def replay_tensors(ring: DeviceRing | None, tree: dper.DevicePerTree | None = None) -> list:
    """The ring's fields and fill count, then the tree's sums and max
    priority (each part empty when None)."""
    out = []
    if ring is not None:
        out += [ring.obs, ring.action, ring.reward, ring.next_obs, ring.discount, ring.size]
    if tree is not None:
        out += [tree.sums, tree.max_priority]
    return out


def learner_generators(state: TrainState, *more) -> tuple:
    """The device generators a learner program draws from: the given ones,
    the REDQ subsets' and the DrQ shift's (each None when unused)."""
    return (*more, state.subset_gen, state.augment_gen)


def megastep_program(config: D4PGConfig, k: int, batch: int, state: TrainState,
                     ring: DeviceRing, tree: dper.DevicePerTree | None,
                     generator: torch.Generator, fused: bool = False) -> graphs.Program:
    """The device placement's megastep as one compiled program named
    ``megastep``: the uniform tier (no input; ``tree`` None), the device
    PER tier or, with ``fused``, the fused-descent tier (input: the
    dispatch's β, :func:`~d4pg_tpu_torch.replay.device_per.beta_tensor`).
    Returns the K-step mean metrics. The caller advances ``state.step``
    (a replay runs no Python)."""
    if tree is None:
        def body():
            return megastep_uniform_body(config, k, batch, state, ring, generator)
    else:
        tier = megastep_device_per_fused_body if fused else megastep_device_per_body

        def body(beta):
            return tier(config, k, batch, state, ring, tree, generator, beta=beta)
    return graphs.Program("megastep", body, device=ring.obs.device,
                          state=lambda: learner_tensors(state, ring, tree),
                          generators=learner_generators(state, generator))


def hybrid_program(config: D4PGConfig, state: TrainState, ring: DeviceRing) -> graphs.Program:
    """The hybrid placement's megastep as one compiled program named
    ``megastep``: inputs the host tree's [K, B] ``idx`` and ``weights``,
    outputs ``(metrics, priorities)``."""
    return graphs.Program("megastep", partial(megastep_hybrid_body, config, state, ring),
                          device=ring.obs.device,
                          state=lambda: learner_tensors(state, ring),
                          generators=learner_generators(state))


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


# ------------------------------------------------------------ sharded (dp)
def lane_generators(seed: int, mesh) -> list:
    """One device generator for each of this process's lanes, seeded from
    ``(seed, global lane index)``: a lane draws the same stream whichever
    process runs it."""
    return [
        torch.Generator(mesh.lane_device(d)).manual_seed(
            int(np.random.SeedSequence([seed, d]).generate_state(1, np.uint64)[0]))
        for d in mesh.local_lanes
    ]


def _lane_fill(ring: DeviceRing, d: int, n_shards: int) -> torch.Tensor:
    """Lane ``d``'s mirrored rows, ``ceil((size − d)/D)`` from the global
    fill count on the device (striping lands host slot j on lane j % D)."""
    return (ring.size - d + n_shards - 1) // n_shards


def sharded_megastep_uniform_body(
    config: D4PGConfig, k: int, b_local: int, mesh, sync,
    state: TrainState, rings: list, generators: list, idx: list | None = None,
) -> dict:
    """K grad steps on lane-local uniform draws: lane d draws [k, b_local]
    rows from its ``size // D`` fully mirrored rows (every lane has that
    many once ``size >= D``), no IS weights."""
    batches = []
    for j, ring in enumerate(rings):
        lane_idx = idx[j] if idx is not None else draw_uniform_indices(
            generators[j], k, b_local, ring.size // mesh.dp)
        batches.append(gather_batches(ring, lane_idx))
    _, metrics, _ = fused_train_scan(config, state, batches, sync_fn=sync)
    return _mean(metrics)


def sharded_megastep_device_per_body(
    config: D4PGConfig, k: int, b_local: int, mesh, sync,
    state: TrainState, rings: list, trees: list, generators: list,
    prefixes: list | None = None, beta: torch.Tensor | None = None,
) -> dict:
    """K grad steps on PER draws from every lane's subtree: each lane's
    stratified prefixes over its own mass, one B3 descent of its [k,
    b_local] block, the IS weights of the two-level scheme normalized by
    the smallest draw probability over ALL lanes (an exact min), K train
    steps over the lanes, then each lane's last-wins write-back and the
    max priority over all lanes (an exact max) into every lane's tree.
    ``beta`` is the dispatch's β (a 0-d float32 device tensor; by default
    the host step's)."""
    D = mesh.dp
    draws, ratios = [], []
    for j, d in enumerate(mesh.local_lanes):
        sums = trees[j].sums
        gen = None if generators is None else generators[j]
        pre = _draw_prefixes(gen, k, b_local, sums[1], None if prefixes is None else prefixes[j])
        idx, p_leaf, total = dper.lane_draw(sums, pre, _lane_fill(rings[j], d, D))
        draws.append((idx, p_leaf, total))
        ratios.append(dper.lane_min_leaf(sums) / (D * total))
    min_ratio = sync.min(torch.stack(ratios))
    beta = _beta(config, state, trees[0].sums.device, beta)
    batches = []
    for ring, (idx, p_leaf, total) in zip(rings, draws):
        lane = gather_batches(ring, idx)
        lane["weights"] = dper.importance_weights(p_leaf, total, min_ratio, ring.size, beta,
                                                  n_shards=D)
        batches.append(lane)
    _, metrics, priorities = fused_train_scan(config, state, batches, sync_fn=sync)
    peaks = []
    for j, (ring, (idx, _, _)) in enumerate(zip(rings, draws)):
        pri = priorities[:, j * b_local: (j + 1) * b_local]
        _, mp = dper.write_back_lane(trees[j].sums, idx, pri, config.per_alpha, config.per_eps,
                                     capacity=ring.obs.shape[0])
        peaks.append(mp)
    mp = sync.max(torch.stack(peaks))
    for tree in trees:
        tree.max_priority.copy_(torch.maximum(tree.max_priority, mp))
    return _mean(metrics)


def _check_sharded(mesh, batch: int) -> int:
    if batch % mesh.dp:
        raise ValueError(f"sharded megastep: batch {batch} not divisible by dp={mesh.dp}")
    return batch // mesh.dp


def make_megastep_uniform_sharded(config: D4PGConfig, k: int, batch: int, mesh):
    """``(state, rings, trees, generators) -> metrics`` over this
    process's lanes (``rings`` and ``generators`` in lane order; ``trees``
    unused), ``batch`` the global batch. ``.sync`` is its combine."""
    from d4pg_tpu_torch.parallel.dp import LaneSync

    sync = LaneSync(mesh)
    body = partial(sharded_megastep_uniform_body, config, k, _check_sharded(mesh, batch), mesh,
                   sync)

    def run(state, rings, trees, generators, idx=None):
        return body(state, rings, generators, idx)

    run.sync = sync
    return run


def make_megastep_device_per_sharded(config: D4PGConfig, k: int, batch: int, mesh):
    """``(state, rings, trees, generators) -> metrics``, the device-PER
    tier over this process's lanes. ``.sync`` is its combine."""
    from d4pg_tpu_torch.parallel.dp import LaneSync

    sync = LaneSync(mesh)
    run = partial(sharded_megastep_device_per_body, config, k, _check_sharded(mesh, batch), mesh,
                  sync)
    run.sync = sync
    return run


def sharded_megastep_program(config: D4PGConfig, k: int, batch: int, mesh, state: TrainState,
                             rings: list, trees: list | None, generators: list):
    """The sharded megastep of one process's lanes as one compiled program
    named ``megastep`` (a :class:`~d4pg_tpu_torch.parallel.dp.LaneProgram`,
    ``.sync`` its combine): the uniform tier (no input; ``trees`` None) or
    the device-PER tier (input: the dispatch's β, :func:`~d4pg_tpu_torch.
    replay.device_per.beta_tensor`). Its bound state is the train state
    and every local lane's ring and subtree; it draws from every lane's
    generator. Returns the K-step mean metrics. The caller advances
    ``state.step``."""
    from d4pg_tpu_torch.parallel.dp import LaneProgram, LaneSync

    if mesh.num_processes > 1:
        raise ValueError("the sharded megastep of several processes stays eager: its "
                         "combines cross the processes on the host")
    sync = LaneSync(mesh)
    b_local = _check_sharded(mesh, batch)
    if trees is None:
        def body():
            return sharded_megastep_uniform_body(config, k, b_local, mesh, sync, state, rings,
                                                 generators)
    else:
        def body(beta):
            return sharded_megastep_device_per_body(config, k, b_local, mesh, sync, state,
                                                    rings, trees, generators, beta=beta)

    def tensors():
        lanes = zip(rings, trees or [None] * len(rings))
        return learner_tensors(state) + [t for ring, tree in lanes
                                         for t in replay_tensors(ring, tree)]

    prog = graphs.Program("megastep", body, device=rings[0].obs.device, state=tensors,
                          generators=learner_generators(state, *generators))
    out = LaneProgram(prog, sync)
    out.sync = sync
    return out


def _oracle_mesh(n_shards: int, device):
    from d4pg_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n_shards, device=device, num_processes=1, process_index=0)


def make_megastep_uniform_oracle(config: D4PGConfig, k: int, batch: int, n_shards: int,
                                 device=None):
    """The sharded uniform megastep with all ``n_shards`` lanes in this
    process: the lane loop IS the one-process oracle."""
    return make_megastep_uniform_sharded(config, k, batch, _oracle_mesh(n_shards, device))


def make_megastep_device_per_oracle(config: D4PGConfig, k: int, batch: int, n_shards: int,
                                    device=None):
    """The sharded device-PER megastep with all ``n_shards`` lanes here."""
    return make_megastep_device_per_sharded(config, k, batch, _oracle_mesh(n_shards, device))
