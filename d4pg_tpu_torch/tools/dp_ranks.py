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

Two more legs run the same way (``spawn_ranks(..., leg=)``), each held
``torch.equal`` to one process with the same lanes: ``leg="tp"``
(:func:`run_tp_lanes`, ``--dp D --tp N`` on the host placement: the TP
step of ``parallel/partition.py`` over K-step dispatches of a seeded
batch stream, each rank taking its dp lanes' rows) and
``leg="on_device"`` (:func:`run_on_device_lanes`, ``--on-device --dp D``:
the on-device loop of ``runtime/on_device.py`` on the mesh, each lane
with its own envs, ring and generators).

Run from the command line on a machine with at least two cards, it holds
the NCCL path to the same bits: ``python -m d4pg_tpu_torch.tools.dp_ranks``
runs the one-process lanes all on ``cuda:0``, then two ranks, one card
each, at the default width (``pendulum``'s preset, B = 256,
K = 8, the 1M-row replay), and prints one JSON line: the backend every
rank chose, the ``torch.equal`` verdicts, the combine's ms a grad step
and the card's name and power limit. It exits 1 unless every rank chose
NCCL and every verdict holds. ``--tp 2`` runs the tp leg instead (a
rank's tp lanes share its card) and ``--on-device`` the on-device leg.
"""

from __future__ import annotations

import os
import statistics
import tempfile
import time

import numpy as np
import torch

from d4pg_tpu_torch.utils.procs import free_port


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
    counters = _kernel_counters()
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


def _kernel_counters() -> tuple:
    from d4pg_tpu_torch.ops import cuda_fused_step, cuda_projection, cuda_tree

    counters = (cuda_projection.LAUNCHES, cuda_tree.LAUNCHES, cuda_fused_step.LAUNCHES)
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    return counters


def batch_stream(seed: int, n: int, k: int, batch: int, obs_dim: int, action_dim: int) -> list:
    """``n`` dispatches of [K, B] batches (with IS weights), seeded."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = row_stream(int(r.integers(2**31)), k * batch, obs_dim, action_dim)
        b = {key: v.reshape((k, batch) + v.shape[1:]) for key, v in rows.items()}
        b["weights"] = r.uniform(0.2, 1.0, (k, batch)).astype(np.float32)
        out.append(b)
    return out


def run_tp_lanes(mesh, agent_cfg, dispatches: int, k: int, batch: int, seed: int = 0) -> dict:
    """``--dp D --tp N`` on the host placement without the trainer: a
    state sharded over ``mesh.tp``, ``dispatches`` K-step TP dispatches of
    :func:`batch_stream`, this process taking its dp lanes' rows of each
    batch. Returns the state gathered whole, the last metrics and the
    priorities of this process's rows, as CPU tensors, and the kernels'
    launch counts."""
    from d4pg_tpu_torch.agent import create_train_state
    from d4pg_tpu_torch.parallel.dp import float_tensors, make_dp_fused_train_step
    from d4pg_tpu_torch.parallel.partition import shard_train_state, stack_axes_for

    device = mesh.device
    state = shard_train_state(create_train_state(agent_cfg, seed, device), mesh,
                              stack_axes=stack_axes_for(agent_cfg))
    step = make_dp_fused_train_step(agent_cfg, mesh)
    lo, n = mesh.local_lanes[0] * (batch // mesh.dp), len(mesh.local_lanes) * (batch // mesh.dp)
    counters = _kernel_counters()
    priorities = []
    for b in batch_stream(seed + 1, dispatches, k, batch, agent_cfg.obs_dim,
                          agent_cfg.action_dim):
        mine = {key: torch.from_numpy(np.ascontiguousarray(v[:, lo: lo + n])).to(device)
                for key, v in b.items()}
        _, metrics, pri = step(state, mine)
        priorities.append(pri.cpu())
    _sync(device)
    return {
        "launches": {key: v for c in counters for key, v in c.items()},
        "lanes": list(mesh.local_lanes),
        "state": [t.detach().cpu().clone() for t in float_tensors(state.whole())],
        "shards": [t.detach().cpu().clone() for t in float_tensors(state)],
        "step": state.step,
        "metrics": {key: v.cpu() for key, v in metrics.items()},
        "priorities": torch.cat(priorities, dim=0),  # [dispatches·K, rows]
        "combines": step.sync.calls,
    }


def run_on_device_lanes(mesh, agent_cfg, env_name: str, num_envs: int, capacity: int,
                        batch: int, k: int, iterations: int, seed: int = 0,
                        prioritized: bool = True) -> dict:
    """``--on-device --dp D`` without ``OnDeviceRun``: the on-device loop
    on ``mesh`` (this process's lanes), one warmup segment and
    ``iterations`` train iterations. Returns the state, each local lane's
    ring and the last metrics as CPU tensors, and the kernels' launch
    counts."""
    from d4pg_tpu_torch.agent import create_train_state
    from d4pg_tpu_torch.envs import make_env
    from d4pg_tpu_torch.parallel.dp import float_tensors
    from d4pg_tpu_torch.runtime.on_device import make_on_device_trainer

    device = mesh.device
    init_fn, warmup_fn, iterate_fn = make_on_device_trainer(
        agent_cfg, make_env(env_name), num_envs=num_envs, replay_capacity=capacity,
        batch_size=batch, train_steps_per_iter=k, prioritized=prioritized, device=device,
        mesh=mesh)
    carry = warmup_fn(init_fn(create_train_state(agent_cfg, seed, device), seed + 1), 3.0)
    counters = _kernel_counters()
    for _ in range(iterations):
        carry, metrics = iterate_fn(carry, 1.0)
    _sync(device)
    ring_keys = ("obs", "action", "reward", "next_obs", "discount", "priority", "max_priority")
    return {
        "launches": {key: v for c in counters for key, v in c.items()},
        "lanes": list(mesh.local_lanes),
        "state": [t.detach().cpu().clone() for t in float_tensors(carry.state)],
        "step": carry.state.step,
        "rings": [{f: getattr(r, f).cpu().clone() for f in ring_keys} for r in carry.replay],
        "sizes": [int(r.size) for r in carry.replay],
        "metrics": {key: v.cpu() for key, v in metrics.items()},
    }


LEGS = {"megastep": run_lanes, "tp": run_tp_lanes, "on_device": run_on_device_lanes}


def _rank_main(rank: int, world: int, port: int, out: str, job: dict) -> None:
    from d4pg_tpu_torch.parallel.distributed import backend, initialize_distributed, shutdown
    from d4pg_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    device, dp = job["device"], job["dp"]
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device=device, dp=dp,
                           timeout_s=job["timeout_s"])
    try:
        results = []
        for leg, tp, kwargs in job["legs"]:
            mesh = make_mesh(dp, tp, device=device)
            t0 = time.perf_counter()
            result = LEGS[leg](mesh, **kwargs)
            result["wall_s"] = time.perf_counter() - t0
            result["backend"] = backend()
            results.append(result)
        torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    finally:
        shutdown()


def spawn_legs(world: int, dp: int, device: str, legs: list, timeout_s: float = 120.0) -> list:
    """``legs`` (``(leg, tp, kwargs)`` each, a name of :data:`LEGS` on a
    ``dp × tp`` mesh) run one after another in ``world`` spawned ranks
    over gloo (or NCCL when each rank has a card of its own); for each leg
    its ranks' results in rank order. Raises if a rank fails or the ranks
    outlive ``timeout_s``; every rank is gone when it returns."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    job = dict(device=device, dp=dp, timeout_s=timeout_s, legs=list(legs))
    with tempfile.TemporaryDirectory() as out:
        procs = [ctx.Process(target=_rank_main, args=(r, world, port, out, job))
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
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    return [[r[i] for r in ranks] for i in range(len(job["legs"]))]


def spawn_ranks(world: int, dp: int, device: str, timeout_s: float = 120.0,
                leg: str = "megastep", tp: int = 1, **kwargs) -> list:
    """:func:`run_lanes` (or the ``leg`` of :data:`LEGS`, on a ``dp × tp``
    mesh) in ``world`` spawned ranks (:func:`spawn_legs`); their results
    in rank order."""
    return spawn_legs(world, dp, device, [(leg, tp, kwargs)], timeout_s)[0]


def compare_leg(one: dict, ranks: list) -> dict:
    """:func:`compare` for the ``tp`` and ``on_device`` legs: the whole
    state (and the tp shards), the step, the metrics, each rank's
    priorities against its rows of the one process's, and each lane's
    ring; returns ``{what: bool}``."""
    eq = {"state": all(len(one["state"]) == len(r["state"]) and all(
              torch.equal(a, b) for a, b in zip(one["state"], r["state"])) for r in ranks),
          "step": all(one["step"] == r["step"] for r in ranks),
          "metrics": all(torch.equal(one["metrics"][key], r["metrics"][key])
                         for r in ranks for key in one["metrics"])}
    if "shards" in one:
        eq["shards"] = all(torch.equal(a, b) for r in ranks
                           for a, b in zip(one["shards"], r["shards"]))
        cols = one["priorities"].shape[1] // len(one["lanes"])
        eq["priorities"] = all(torch.equal(
            one["priorities"][:, r["lanes"][0] * cols: (r["lanes"][-1] + 1) * cols],
            r["priorities"]) for r in ranks)
    if "rings" in one:
        eq["rings"] = all(torch.equal(one["rings"][lane][f], r["rings"][j][f])
                          for r in ranks for j, lane in enumerate(r["lanes"])
                          for f in one["rings"][lane])
    return eq


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


def main(argv=None) -> int:
    import argparse
    import dataclasses
    import json
    import subprocess

    from d4pg_tpu_torch.config import TrainConfig, apply_env_preset
    from d4pg_tpu_torch.parallel.mesh import make_mesh

    p = argparse.ArgumentParser(description="two ranks against one process, one card a rank")
    p.add_argument("--tp", type=int, default=1,
                   help="run the --dp 2 --tp N leg (the host TP step) instead of the megastep")
    p.add_argument("--on-device", action="store_true",
                   help="run the --on-device --dp 2 leg instead of the megastep")
    args = p.parse_args(argv)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < RANKS:
        print(f"needs {RANKS} CUDA cards, found {cards}")
        return 2
    c = apply_env_preset(TrainConfig(env="pendulum"))
    leg = "on_device" if args.on_device else "tp" if args.tp > 1 else "megastep"
    if leg == "megastep":
        kw = dict(agent_cfg=c.agent, capacity=c.replay_capacity, rounds=list(ROUNDS), k=8,
                  batch=c.batch_size, seed=0, guard=True, combine_reps=50)
    elif leg == "tp":
        kw = dict(agent_cfg=c.agent, dispatches=4, k=8, batch=c.batch_size, seed=0)
    else:
        kw = dict(agent_cfg=c.agent, env_name="pendulum", num_envs=64, capacity=65536,
                  batch=c.batch_size, k=64, iterations=3, seed=0)
    tp = args.tp if leg == "tp" else 1
    # the oracle: every lane in this process, all on cuda:0
    mesh = make_mesh(RANKS, tp, device="cuda", num_processes=1, process_index=0)
    mesh = dataclasses.replace(mesh, devices=(torch.device("cuda", 0),) * RANKS)
    one = LEGS[leg](mesh, **kw)
    ranks = spawn_ranks(RANKS, RANKS, "cuda", timeout_s=300.0, leg=leg, tp=tp, **kw)
    eq = compare(one, ranks) if leg == "megastep" else compare_leg(one, ranks)
    backends = [r["backend"] for r in ranks]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    ok = all(eq.values()) and backends == ["nccl"] * RANKS
    out = {
        "ok": ok, "leg": leg, "tp": tp, "cards": cards, "backends": backends,
        "rank_devices": [f"cuda:{r['lanes'][0] % cards}" for r in ranks],
        "torch_equal": eq, "launches_one_process": one["launches"],
        "launches_ranks": [r["launches"] for r in ranks], "nvidia_smi": smi,
    }
    if leg == "megastep":
        out.update({
            "grad_steps_per_sec_one_process": (len(ROUNDS) - 1) * 8 / one["steady_s"],
            "grad_steps_per_sec_ranks": [(len(ROUNDS) - 1) * 8 / r["steady_s"] for r in ranks],
            "combine_ms_per_grad_step": {"one_process": one["combine_ms"],
                                         "ranks": [r["combine_ms"] for r in ranks]},
        })
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
