"""The port's runtime guards (``d4pg_tpu_torch/analysis``) held against the
JAX package's (``d4pg_tpu/analysis``), and wired where the JAX package
wires them: each guard stays silent on the clean path and catches a
seeded violation with an attributable error.

Regenerate the port's committed lock graph with
``python tests/test_torch_guards.py --write-lock-graph``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script (--write-lock-graph)
    sys.path.insert(0, REPO)

from d4pg_tpu.analysis import flowledger as j_flow  # noqa: E402
from d4pg_tpu.analysis import ledger as j_ledger  # noqa: E402
from d4pg_tpu.analysis import lockwitness as j_witness  # noqa: E402
from d4pg_tpu_torch.analysis import flowledger, ledger, lockwitness  # noqa: E402
from d4pg_tpu_torch.analysis.transfer import (  # noqa: E402
    TransferGuardError,
    check_operands,
    no_implicit_transfers,
    no_transfers,
)


def port_lock_graph() -> dict:
    """The lock-graph analyzer's graph of ``d4pg_tpu_torch/``, in the
    committed file's form."""
    from tools.d4pglint.core import parse_files
    from tools.d4pglint.wholeprog.lockgraph import build_lock_graph

    files, errors = parse_files(["d4pg_tpu_torch"], root=REPO)
    assert not errors, errors
    graph = build_lock_graph(files)
    graph.pop("_sites")
    graph["generated_by"] = "python tests/test_torch_guards.py --write-lock-graph"
    return graph


@pytest.fixture
def armed():
    """Both witnesses and both flow ledgers armed for the test, disarmed
    and cleared after it."""
    for m in (lockwitness, j_witness):
        m.reset()
        m.enable()
    flowledger.enable()
    j_flow.enable()
    yield
    for m in (lockwitness, j_witness):
        m.reset()
    flowledger.reset()
    j_flow.reset()


# ------------------------------------------------------------ the lock graph
def test_committed_lock_graph_matches_the_analyzer_and_is_acyclic():
    from tools.d4pglint.wholeprog.lockgraph import find_cycles

    with open(lockwitness.committed_graph_path()) as f:
        committed = json.load(f)
    fresh = port_lock_graph()
    assert committed["nodes"] == fresh["nodes"]
    assert committed["edges"] == fresh["edges"]
    assert find_cycles([(e["from"], e["to"]) for e in committed["edges"]]) == []
    # every lock the port names for the witness is a node of its graph
    for node in ("Trainer._wb_idle_lock", "Trainer._eval_req_lock", "ReplayBuffer._lock",
                 "DynamicBatcher._cond", "DynamicBatcher._reply_cond", "ServeStats._lock",
                 "PolicyClient._conn_lock", "StageTimers._lock", "FrameLoop._cb_lock",
                 "Connection._lock", "StagingLedger._lock", "ChaosInjector._lock",
                 "IngestServer._cond", "IngestServer._counters_lock",
                 "IngestServer._conns_lock", "FleetLink._pending_lock",
                 "FleetActor._stats_lock", "MirrorTap._lock", "MirrorTap._cond",
                 "RouterStats._lock", "Router._lock", "Router._events_lock",
                 "Autoscaler._lock", "RouterReplicaPool._lock", "ActorHostPool._lock"):
        assert node in committed["nodes"], node
    # the JAX package's graph names the JAX package's files, never the port's
    with open(os.path.join(REPO, "benchmarks", "lock_order_graph.json")) as f:
        jax_graph = json.load(f)
    assert not any("d4pg_tpu_torch" in s for e in jax_graph["edges"] for s in e["sites"])
    assert all(s.startswith("d4pg_tpu_torch/") for e in committed["edges"] for s in e["sites"])


# ------------------------------------------------------------------- ledger
LEDGER_TRACES = {
    "clean_rotation": [("write", "g", 0), ("hold", "g", 0), ("write", "g", 1),
                       ("hold", "g", 1), ("release", 0), ("write", "g", 0),
                       ("release", 1), ("write", "g", 1)],
    "write_while_held": [("write", "g", 0), ("hold", "g", 0), ("write", "g", 1),
                         ("write", "g", 0)],
    "two_holders_one_released": [("write", "s", 3), ("hold", "s", 3), ("hold", "s", 3),
                                 ("release", 0), ("write", "s", 3)],
    "release_twice_then_rewrite": [("write", "g", 0), ("hold", "g", 0), ("release", 0),
                                   ("release", 0), ("write", "g", 0), ("write", "g", 0)],
    "groups_are_separate": [("write", "a", 0), ("hold", "a", 0), ("write", "b", 0),
                            ("hold", "b", 0), ("write", "b", 1), ("write", "a", 0)],
}


def _run_trace(mod, trace):
    led = mod.StagingLedger("t")
    holds, out = [], []
    for i, op in enumerate(trace):
        try:
            if op[0] == "write":
                out.append(("gen", led.write(op[1], op[2], writer="w")))
            elif op[0] == "hold":
                holds.append(led.hold(op[1], op[2], holder=f"d{i}"))
                out.append(("hold", holds[-1].gen))
            else:
                holds[op[1]].release()
                out.append(("released", holds[op[1]].released))
        except RuntimeError as e:
            out.append(("raised", type(e).__name__, str(e)))
        out.append(("stats", led.stats()))
    return out


@pytest.mark.parametrize("name", sorted(LEDGER_TRACES))
def test_staging_ledger_traces_match_the_jax_ledger(name):
    """Equal generations, stats after every step, and a raise on the same
    step with the same words."""
    ours = _run_trace(ledger, LEDGER_TRACES[name])
    ref = _run_trace(j_ledger, LEDGER_TRACES[name])
    assert ours == ref
    raised = [o for o in ours if o[0] == "raised"]
    assert bool(raised) == (name in ("write_while_held", "two_holders_one_released",
                                     "groups_are_separate"))
    for r in raised:
        assert r[1] == "StagingReuseError" and "held by" in r[2]


def test_null_ledger_is_free():
    assert ledger.NULL_LEDGER.write("g", 0) == 0
    h = ledger.NULL_LEDGER.hold("g", 0)
    h.release()
    assert ledger.NULL_LEDGER.stats() == j_ledger.NULL_LEDGER.stats()


# ------------------------------------------------------------- lock witness
def _witness_verdict(mod, nest, graph):
    """Acquire ``nest`` (a list of lock-name chains, each acquired in order
    on one thread), then check against ``graph``: the summary, or the
    error's type."""
    mod.reset()
    mod.enable()
    locks: dict = {}
    for chain in nest:
        held = []
        for name in chain:
            lock = mod.named_lock(name) if name not in locks or name.endswith("*") \
                else locks[name]
            locks.setdefault(name, lock)
            lock.acquire()
            held.append(lock)
        for lock in reversed(held):
            lock.release()
    try:
        return mod.check_against(graph)
    except RuntimeError as e:
        return type(e).__name__
    finally:
        mod.reset()


def _graph(*edges):
    return {"edges": [{"from": a, "to": b} for a, b in edges]}


WITNESS_CASES = {
    "agrees": ([["A", "B"]], _graph(("A", "B"))),
    "novel_but_acyclic": ([["A", "C"]], _graph(("A", "B"))),
    "contradicts": ([["B", "A"]], _graph(("A", "B"))),
    "contradicts_through_a_path": ([["C", "A"]], _graph(("A", "B"), ("B", "C"))),
    "two_instances_one_name": ([["X*", "X*"]], _graph()),
    "unlocked_chains": ([["A"], ["B"]], _graph(("B", "A"))),
}


@pytest.mark.parametrize("name", sorted(WITNESS_CASES))
def test_check_against_gives_the_jax_verdict(name):
    nest, graph = WITNESS_CASES[name]
    ours = _witness_verdict(lockwitness, nest, graph)
    ref = _witness_verdict(j_witness, nest, graph)
    assert ours == ref
    assert (ours == "LockOrderWitnessError") == (
        name in ("contradicts", "contradicts_through_a_path", "two_instances_one_name"))


def test_witness_off_hands_out_plain_primitives():
    lockwitness.reset()
    assert type(lockwitness.named_lock("A")) is type(threading.Lock())
    assert type(lockwitness.named_rlock("A")) is type(threading.RLock())
    assert isinstance(lockwitness.named_condition("A"), threading.Condition)
    assert lockwitness.check_against_committed() is None


# -------------------------------------------------------------- flow ledger
# The family's name is spelt in two pieces and its counters are read from
# the port's table: this file is no assertion site of the JAX package's
# identities, which tools/d4pglint's flow scan looks for in tests/.
SERVE_FAMILY = "serve" + "-stats"
FLEET_FAMILIES = ("fleet" + "-actor", "fleet" + "-ingest")
FLYWHEEL_FAMILIES = ("mirror" + "-tap",)
ROUTER_FAMILIES = ("router", "router" + "-gate", "router" + "-tenant")
LEAGUE_FAMILIES = ("league" + "-tenure",)


def _flow_cases() -> dict:
    from d4pg_tpu_torch.analysis.flow_identities import FLOW_IDENTITIES

    left, right = FLOW_IDENTITIES[SERVE_FAMILY]["identity"].split("==")
    lhs, terms = left.strip(), [t.strip() for t in right.split("+")]
    parts = dict(zip(terms, (6, 1, 1, 1, 1)))
    return {
        "balanced": {lhs: 10, **parts},
        "drained": {lhs: 5, terms[0]: 5},
        "lost_one": {lhs: 11, **parts},
        "double_booked": {lhs: 9, **parts},
        "empty": {},
    }


@pytest.mark.parametrize("name", ["balanced", "drained", "lost_one", "double_booked", "empty"])
def test_serve_stats_identity_gives_the_jax_verdict(name, armed, capsys):
    counters = _flow_cases()[name]

    def verdict(mod):
        try:
            return mod.check(SERVE_FAMILY, counters, where="t")
        except RuntimeError as e:
            return type(e).__name__

    ours, ref = verdict(flowledger), verdict(j_flow)
    assert ours == ref
    assert ours == (True if name in ("balanced", "drained", "empty") else "ConservationError")
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[flow" + "-verdict]")]
    assert len(lines) == 2 and lines[0] == lines[1]  # one verdict each, the same JSON


def test_flow_identities_are_the_jax_tables():
    from d4pg_tpu_torch.analysis.flow_identities import FLOW_IDENTITIES
    from tools.d4pglint.wholeprog.config import FLOW_IDENTITIES as J

    assert list(FLOW_IDENTITIES) == [SERVE_FAMILY, *FLEET_FAMILIES, *FLYWHEEL_FAMILIES,
                                     *ROUTER_FAMILIES, *LEAGUE_FAMILIES]
    assert sorted(FLOW_IDENTITIES) == sorted(J)  # every JAX family is ported
    for family in FLOW_IDENTITIES:
        assert FLOW_IDENTITIES[family]["identity"] == J[family]["identity"]
        assert FLOW_IDENTITIES[family].get("per_row") == J[family].get("per_row")
        # the port's families name the port's classes (a per-row family none)
        cls = FLOW_IDENTITIES[family]["class"]
        assert cls.startswith("d4pg_tpu_torch/") if J[family]["class"] else cls is None
    lhs = FLOW_IDENTITIES[SERVE_FAMILY]["identity"].split("==")[0].strip()
    # off: a no-op, as in the JAX ledger; a family the table lacks is skipped
    flowledger.reset()
    assert flowledger.check(SERVE_FAMILY, {lhs: 1}) is None
    flowledger.enable()
    try:
        assert flowledger.check("not-a-family", {"x": 1}) is None
        assert flowledger.check_rows(SERVE_FAMILY, {"a": {}, "b": {lhs: 0}}) is True
        with pytest.raises(flowledger.ConservationError, match="1 row"):
            flowledger.check_rows(SERVE_FAMILY, {"a": {lhs: 1}})
    finally:
        flowledger.reset()


# ---------------------------------------------------------- transfer guards
# On the CPU, "meta" tensors stand in for the device: the guard only asks
# whether a dispatch's operands mix CPU tensors with tensors on another
# device.
DEV = torch.device("meta")


def _ring(size_device):
    from d4pg_tpu_torch.replay.device_ring import DeviceRing

    return DeviceRing(obs=torch.zeros(4, 3, device=DEV), action=torch.zeros(4, 1, device=DEV),
                      reward=torch.zeros(4, device=DEV), next_obs=torch.zeros(4, 3, device=DEV),
                      discount=torch.zeros(4, device=DEV),
                      size=torch.zeros((), dtype=torch.int32, device=size_device))


@pytest.mark.parametrize("guard", [no_implicit_transfers, no_transfers])
def test_a_cpu_operand_among_device_operands_raises(guard):
    with guard(_ring(DEV), [torch.ones(2, device=DEV)], {"k": 8, "name": "x"}):
        pass                              # Python numbers and strings are no operands
    with guard({"obs": torch.ones(2, 3)}, torch.tensor(1.0)):
        pass                              # host-only operands are no transfer
    with pytest.raises(TransferGuardError, match=r"cpu int32\[\] into a dispatch on meta"):
        with guard(_ring("cpu")):         # the 0-d fill count torch would upload silently
            pass
    with pytest.raises(TransferGuardError, match=r"implicit host-to-device transfer of cpu int64\[2\]"):
        with guard(_ring(DEV), {"idx": torch.tensor([0, 1]), "w": torch.ones(2, device=DEV)}):
            pass


def test_the_operand_walk_reaches_modules_and_objects_but_not_optimizers():
    """A train state is walked through its modules' parameters and buffers;
    Adam's step counts stay on the host by design and are not operands."""
    from d4pg_tpu_torch.agent import create_train_state, train_step
    from d4pg_tpu_torch.agent.state import D4PGConfig

    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(8, 8))
    state = create_train_state(cfg, 0, torch.device("cpu"))
    train_step(cfg, state, _cpu_batch())  # Adam's state, its CPU step counts included
    assert any(s["step"].device.type == "cpu" for s in state.critic_opt.state.values())
    for net in (state.actor, state.critic, state.target_actor, state.target_critic):
        net.to(DEV)
    check_operands(state, _ring(DEV))
    state.critic.register_buffer("stray", torch.zeros(()))
    with pytest.raises(TransferGuardError, match=r"of cpu float32\[\] into"):
        check_operands(state, _ring(DEV))


def test_guards_are_off_when_disabled_and_walk_a_cycle_once():
    class Node:
        def __init__(self):
            self.me = self
            self.t = torch.zeros(())

    node = Node()
    with no_transfers(node, _ring(DEV), enabled=False), \
            no_implicit_transfers(node, _ring(DEV), enabled=False):
        pass
    with pytest.raises(TransferGuardError) as e:
        check_operands([node, node], _ring(DEV))
    assert str(e.value).count("cpu float32[]") == 1


def _cpu_batch():
    g = torch.Generator().manual_seed(0)
    return {"obs": torch.randn(4, 3, generator=g), "action": torch.rand(4, 1, generator=g),
            "reward": torch.randn(4, generator=g), "next_obs": torch.randn(4, 3, generator=g),
            "discount": torch.full((4,), 0.99), "weights": torch.ones(4)}


def test_a_cpu_train_step_runs_clean_under_both_guards():
    """The guards are silent on a whole host train step (forward, backward,
    Adam) whose operands all lie on one device."""
    from d4pg_tpu_torch.agent import create_train_state, train_step
    from d4pg_tpu_torch.agent.state import D4PGConfig

    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(8, 8))
    state = create_train_state(cfg, 0, torch.device("cpu"))
    batch = _cpu_batch()
    for guard in (no_implicit_transfers, no_transfers):
        with guard(state, batch):
            _, metrics, _ = train_step(cfg, state, batch)
        assert all(torch.isfinite(v).all() for v in metrics.values())


# ------------------------------------------------------------ the wiring
def _pool(**kw):
    from d4pg_tpu_torch.runtime.actor_pool import HostActorPool

    return HostActorPool("Pendulum-v1", 2, 20, seed=0, start_method="fork",
                         step_timeout_s=10.0, **kw)


def test_pool_reply_slots_held_one_step_and_single_buffering_trips():
    pytest.importorskip("gymnasium")
    led = ledger.StagingLedger("pool")
    pool = _pool(ledger=led)
    try:
        pool.reset_all(seed=0)
        for _ in range(5):
            pool.step(np.zeros((2, 1), np.float32))
            assert led.stats()["active_holds"] <= 2
        assert led.stats() == {"writes": 5, "trips": 0, "active_holds": 2}
        # the seeded fault: single-buffer the replies. Step 5 wrote slot 0,
        # which the caller still reads during step 6; pinning step 6 to
        # slot 0 rewrites it under the hold
        pool._reply_next = 0
        with pytest.raises(ledger.StagingReuseError, match=r"pool.reply\[0\]"):
            pool.step(np.zeros((2, 1), np.float32))
    finally:
        pool.close()
    assert led.stats()["active_holds"] == 0  # close releases what it held


class _GatedEvent:
    """A CUDA-event stand-in whose ``synchronize`` waits on a gate: makes
    "the slot's copy has not completed" a fact on the CPU."""

    def __init__(self, gate):
        self.gate = gate

    def synchronize(self):
        self.gate.wait(10.0)


def _batcher(**kw):
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.serve.batcher import DynamicBatcher
    from d4pg_tpu_torch.serve.bundle import build_actor

    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(8, 8))
    return DynamicBatcher(cfg, build_actor(cfg, torch.device("cpu")).state_dict(),
                          max_batch=2, max_wait_us=0, device="cpu", **kw)


def test_batcher_ledger_clean_under_traffic():
    led = ledger.StagingLedger("serve")
    b = _batcher(ledger=led)
    b.start()
    try:
        futs = [b.submit(np.zeros(3, np.float32)) for _ in range(12)]
        for f in futs:
            f.result(timeout=30)
    finally:
        b.stop()
    st = led.stats()
    assert st["trips"] == 0 and st["active_holds"] == 0 and st["writes"] == b.replays


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_batcher_forced_flip_onto_an_uncompleted_slot_trips():
    """``_test_force_flip`` pins the rotation to slot 0; with the first
    batch's copy not complete (its event gated), the next batch's write
    into slot 0 raises ``StagingReuseError`` naming slot and holder."""
    led = ledger.StagingLedger("serve")
    b = _batcher(ledger=led)
    gate = threading.Event()
    real = b._infer
    b._infer = lambda bucket, flip: (real(bucket, flip), _GatedEvent(gate))[1]
    b._test_force_flip = 0
    b.start()
    try:
        first = b.submit(np.zeros(3, np.float32))
        time.sleep(0.2)  # batch 1 dispatched, its slot held
        second = b.submit(np.ones(3, np.float32))
        with pytest.raises(ledger.StagingReuseError, match=r"serve.staging\[1\]\[0\].*dispatch\(n=1\)"):
            second.result(timeout=10)
        gate.set()
        first.result(timeout=10)
    finally:
        gate.set()
        try:
            b.stop(timeout=5)
        except RuntimeError:
            pass  # the device thread died on the trip, as seeded
    assert led.stats()["trips"] == 1


def _guarded_trainer(tmp_path, **kw):
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.config import TrainConfig
    from d4pg_tpu_torch.runtime.trainer import Trainer

    base = dict(num_envs=2, batch_size=8, warmup_steps=64, total_steps=12, eval_interval=12,
                eval_episodes=1, replay_capacity=512, steps_per_dispatch=2, prefetch=True,
                async_priority_writeback=True, tree_backend="numpy", debug_guards=True,
                log_dir=str(tmp_path), agent=D4PGConfig(hidden_sizes=(16, 16)))
    base.update(kw)
    return Trainer(TrainConfig(**base), device="cpu")


def test_trainer_staging_holds_end_clean_and_witness_agrees(tmp_path, armed, capsys):
    """Host PER with --prefetch and the flusher under debug_guards: one
    ledger write a sampled block, no trip, no hold left, and the lock
    witness finds no contradiction at close."""
    t = _guarded_trainer(tmp_path)
    try:
        t.train()
    finally:
        t.close()
    st = t._ledger.stats()
    assert st == {"writes": t._dispatches, "trips": 0, "active_holds": 0}
    assert "0 contradictions" in capsys.readouterr().out
    # the trainer's locks were made witnessed (armed before construction)
    assert isinstance(t._wb_idle_lock, lockwitness._Witnessed)
    assert isinstance(t.buffer._lock, lockwitness._Witnessed)


def test_trainer_hold_never_released_trips_at_the_rotation(tmp_path):
    """The seeded fault: a consumer that never releases its hold. The
    fourth sampled block rewrites the first slot (three slots) while it
    is held, and the ledger raises there."""
    t = _guarded_trainer(tmp_path, prefetch=False, async_priority_writeback=False)
    t._release_staging_holds = lambda n=1: None
    try:
        with pytest.raises(ledger.StagingReuseError, match=r"per.sample_block\[n=16\]\[0\]"):
            t.train()
    finally:
        t.close()
    assert t._ledger.stats()["trips"] == 1


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-lock-graph"]:
        raise SystemExit("usage: python tests/test_torch_guards.py --write-lock-graph")
    path = lockwitness.committed_graph_path(REPO)
    with open(path, "w") as f:
        json.dump(port_lock_graph(), f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}")
