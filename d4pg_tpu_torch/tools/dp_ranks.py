"""Two ranks against one process with two lanes, on one stream of rows.

The sharded device-PER megastep is driven directly (no trainer): a
seeded NumPy stream of transitions is written into the replay in rounds,
each round followed by a flush and one dispatch of K grad steps. In one
process every lane is local and one buffer takes the whole stream; over
P processes each takes the rows the striped layout deals it (global
write j belongs to lane ``j % D``, so to process ``(j % D) // (D/P)``)
into a buffer of ``capacity/P`` rows. :func:`run_lanes` returns what the
lanes hold afterwards, and the two topologies must be ``torch.equal``:
the train state (params, targets, both Adam moment sets), each lane's
ring rows and subtree, and ``max_priority``.

Run from Python: :func:`spawn_ranks` starts the ranks (``spawn``, a free
port on 127.0.0.1; gloo when they share a card, NCCL when each has its
own) and collects their results;
``run_lanes(make_mesh(D, num_processes=1, process_index=0), ...)`` is the
one-process side. ``chip_smoke.py``'s ``dp_ranks`` phase and
``tests/test_torch_sharded_megastep.py`` use both.

Run from the command line on a machine with at least two cards, it holds
the NCCL path to the same bits: ``python -m d4pg_tpu_torch.tools.dp_ranks``
runs the one-process lanes all on ``cuda:0``, then two ranks, one card
each, at the default width (``pendulum``'s preset, B = 256,
K = 8, the 1M-row replay), and prints one JSON line: the backend every
rank chose, the ``torch.equal`` verdicts, the combine's ms a grad step
and the card's name and power limit. It exits 1 unless every rank chose
NCCL and every verdict holds.
"""

from __future__ import annotations

import os
import socket
import statistics
import tempfile
import time

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def row_stream(seed: int, n: int, obs_dim: int, action_dim: int) -> dict:
    """``n`` transitions in global write order."""
    r = np.random.default_rng(seed)
    return {
        "obs": r.normal(size=(n, obs_dim)).astype(np.float32),
        "action": r.uniform(-1, 1, (n, action_dim)).astype(np.float32),
        "reward": r.uniform(-1, 0, n).astype(np.float32),
        "next_obs": r.normal(size=(n, obs_dim)).astype(np.float32),
        "discount": np.where(r.uniform(size=n) < 0.1, 0.0, 0.99**3).astype(np.float32),
    }


def dealt(rows: dict, first: int, mesh) -> dict:
    """The rows of global writes ``[first, first + n)`` that this process's
    lanes own, in write order."""
    n = len(rows["reward"])
    j = first + np.arange(n)
    mine = (j % mesh.dp) // mesh.lanes_per_process == mesh.process_index
    return {k: v[mine] for k, v in rows.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def combine_ms(sync, state, device, reps: int) -> float:
    """Median ms of one grad step's combines at ``state``'s sizes (the
    critic's and the actor's gradient rows and the 5 metrics, one row a
    local lane): gather plus fixed-order sum, between CUDA events on the
    card (the host clock on the CPU). Every rank must call it: the
    combines are collectives."""
    n_local = len(sync.mesh.local_lanes)
    sizes = (sum(p.numel() for p in state.critic.parameters()),
             sum(p.numel() for p in state.actor.parameters()), 5)
    rows = [torch.randn(n_local, n, device=device) for n in sizes]
    cuda = device.type == "cuda"
    times = []
    for i in range(reps + 3):
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for r in rows:
            sync(r)
        if cuda:
            end.record()
            end.synchronize()
        if i >= 3:  # warm
            times.append(start.elapsed_time(end) if cuda else (time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_lanes(mesh, agent_cfg, capacity: int, rounds: list, k: int, batch: int,
              seed: int = 0, guard: bool = False, combine_reps: int = 0) -> dict:
    """Write ``rounds[i]`` rows of the stream, flush, dispatch, for each
    round; returns the lanes' state as CPU tensors, the kernels' launch
    counts over the rounds, ``steady_s`` (the wall seconds of the rounds
    after the first, ingest included, to the device's end of the last
    dispatch) and, with ``combine_reps``, :func:`combine_ms`.
    ``guard`` runs every dispatch after the first under
    ``set_sync_debug_mode("error")`` (the collectives lift it)."""
    from d4pg_tpu_torch.agent import create_train_state
    from d4pg_tpu_torch.ops import cuda_fused_step, cuda_projection, cuda_tree
    from d4pg_tpu_torch.parallel.dp import float_tensors
    from d4pg_tpu_torch.replay import ReplayBuffer, Transition
    from d4pg_tpu_torch.replay.device_per import DevicePerSync
    from d4pg_tpu_torch.replay.device_ring import (
        FIELDS,
        MultihostRingSync,
        ShardedDeviceRingSync,
        lane_rings_init,
    )
    from d4pg_tpu_torch.runtime import megastep

    device = mesh.device
    obs_dim, act_dim = agent_cfg.obs_dim, agent_cfg.action_dim
    buf = ReplayBuffer(capacity // mesh.num_processes, obs_dim, act_dim)
    rings = lane_rings_init(capacity, obs_dim, act_dim, mesh)
    sync_cls = MultihostRingSync if mesh.num_processes > 1 else ShardedDeviceRingSync
    ring_sync = sync_cls(buf, mesh)
    per = DevicePerSync(capacity, agent_cfg.per_alpha, mesh=mesh)
    ring_sync.tree_hook = per.on_lane_chunk
    state = create_train_state(agent_cfg, seed, device)
    gens = megastep.lane_generators(seed + 3, mesh)
    mega = megastep.make_megastep_device_per_sharded(agent_cfg, k, batch, mesh)
    stream = row_stream(seed + 1, sum(rounds), obs_dim, act_dim)
    counters = (cuda_projection.LAUNCHES, cuda_tree.LAUNCHES, cuda_fused_step.LAUNCHES)
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    first = 0
    t_steady = None
    for i, n in enumerate(rounds):
        if i == 1:  # the first dispatch built and loaded everything
            _sync(device)
            t_steady = time.perf_counter()
        part = {key: v[first: first + n] for key, v in stream.items()}
        buf.add_batch(Transition(**dealt(part, first, mesh)))
        first += n
        ring_sync.flush(rings)
        prev = torch.cuda.get_sync_debug_mode() if device.type == "cuda" else 0
        if guard and i and device.type == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            metrics = mega(state, rings, per.trees, gens)
        finally:
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode(prev)
    _sync(device)
    steady_s = time.perf_counter() - t_steady if t_steady is not None else None
    launches = {key: v for c in counters for key, v in c.items()}
    combines = mega.sync.calls  # before the timed ones
    return {
        "launches": launches,
        "steady_s": steady_s,
        "combine_ms": combine_ms(mega.sync, state, device, combine_reps) if combine_reps else None,
        "lanes": list(mesh.local_lanes),
        "state": [t.detach().cpu().clone() for t in float_tensors(state)],
        "step": state.step,
        "rings": [{f: getattr(r, f).cpu().clone() for f in FIELDS + ("size",)} for r in rings],
        "sums": [t.sums.cpu().clone() for t in per.trees],
        "max_priority": [t.max_priority.cpu().clone() for t in per.trees],
        "metrics": {key: v.cpu() for key, v in metrics.items()},
        "combines": combines,
    }


def _rank_main(rank: int, world: int, port: int, out: str, kwargs: dict) -> None:
    from d4pg_tpu_torch.parallel.distributed import backend, initialize_distributed, shutdown
    from d4pg_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    device = kwargs.pop("device")
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device=device,
                           dp=kwargs["dp"], timeout_s=kwargs.pop("timeout_s"))
    try:
        mesh = make_mesh(kwargs.pop("dp"), device=device)
        t0 = time.perf_counter()
        result = run_lanes(mesh, **kwargs)
        result["wall_s"] = time.perf_counter() - t0
        result["backend"] = backend()
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        shutdown()


def spawn_ranks(world: int, dp: int, device: str, timeout_s: float = 120.0, **kwargs) -> list:
    """:func:`run_lanes` in ``world`` spawned ranks over gloo (or NCCL when
    each rank has a card of its own); their results in rank order. Raises
    if a rank fails or the ranks outlive ``timeout_s``; every rank is gone
    when it returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, port, out,
                                   dict(kwargs, dp=dp, device=device, timeout_s=timeout_s)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"dp ranks exited with {codes}")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def compare(one: dict, ranks: list) -> dict:
    """``torch.equal`` of the one-process lanes against the ranks' lanes,
    field by field; returns ``{what: bool}``."""
    eq = {"state": all(torch.equal(a, b) for r in ranks for a, b in zip(one["state"], r["state"]))
          and all(len(one["state"]) == len(r["state"]) for r in ranks),
          "step": all(one["step"] == r["step"] for r in ranks)}
    rings = sums = mps = True
    for r in ranks:
        for j, lane in enumerate(r["lanes"]):
            rings &= all(torch.equal(one["rings"][lane][f], r["rings"][j][f])
                         for f in one["rings"][lane])
            sums &= torch.equal(one["sums"][lane], r["sums"][j])
            mps &= torch.equal(one["max_priority"][lane], r["max_priority"][j])
    eq.update(rings=rings, subtrees=sums, max_priority=mps)
    return eq


RANKS = 2
ROUNDS = (4096, 1024, 1024, 1024)   # chip_smoke.py's DP_RANK_ROUNDS


def main() -> int:
    import dataclasses
    import json
    import subprocess

    from d4pg_tpu_torch.config import TrainConfig, apply_env_preset
    from d4pg_tpu_torch.parallel.mesh import make_mesh

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < RANKS:
        print(f"needs {RANKS} CUDA cards, found {cards}")
        return 2
    c = apply_env_preset(TrainConfig(env="pendulum"))
    kw = dict(agent_cfg=c.agent, capacity=c.replay_capacity, rounds=list(ROUNDS), k=8,
              batch=c.batch_size, seed=0, guard=True, combine_reps=50)
    # the oracle: every lane in this process, all on cuda:0
    mesh = make_mesh(RANKS, device="cuda", num_processes=1, process_index=0)
    one = run_lanes(dataclasses.replace(mesh, devices=(torch.device("cuda", 0),) * RANKS), **kw)
    ranks = spawn_ranks(RANKS, RANKS, "cuda", timeout_s=300.0, **kw)
    eq = compare(one, ranks)
    backends = [r["backend"] for r in ranks]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    ok = all(eq.values()) and backends == ["nccl"] * RANKS
    print(json.dumps({
        "ok": ok, "cards": cards, "backends": backends,
        "rank_devices": [f"cuda:{r['lanes'][0] % cards}" for r in ranks],
        "torch_equal": eq, "launches_one_process": one["launches"],
        "launches_ranks": [r["launches"] for r in ranks],
        "grad_steps_per_sec_one_process": (len(ROUNDS) - 1) * 8 / one["steady_s"],
        "grad_steps_per_sec_ranks": [(len(ROUNDS) - 1) * 8 / r["steady_s"] for r in ranks],
        "combine_ms_per_grad_step": {"one_process": one["combine_ms"],
                                     "ranks": [r["combine_ms"] for r in ranks]},
        "nvidia_smi": smi,
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
