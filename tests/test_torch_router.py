"""The port's replicated front end (``d4pg_tpu_torch/serve/router.py``)
held against the JAX package's (``d4pg_tpu/serve/router.py``) on the CPU.

- Cross-package routing: the port's router over a port server and a JAX
  server, and the JAX router over two port servers, answer like a direct
  forward within atol 1e-5 (float32 on both sides, the bound
  ``tests/test_torch_serve.py`` holds serving to), and both routers'
  healthz have the same keys and the same tenant rows.
- Decision parity: both routers pick the same replica for each request
  of one script over scripted backends, split a canary rollout's traffic
  the same way at ``--canary-fraction 0.25``, and shed the same requests
  for the same reasons under an injected clock.
- The behaviours of the JAX router tests (``tests/test_router.py`` and
  the router half of ``tests/test_multitenant.py``), on the port's router
  over the port's servers: failover with the accounting identity, the
  all-ejected answer, re-admission after K probes, the bounded
  re-dispatch, the stuck-replica watchdog, the canary rollout and its
  four rollback paths, per-policy rollouts, the elastic-fleet seams and
  the admission tier.
- The import rule and the CLI: the host-only modules load no torch, no
  JAX and nothing of the JAX package; every JAX router flag parses with
  its default; the router CLI over two serve CLIs survives a ``kill -9``.

Every test runs under its own time limit (``_time_limit``); every server,
router and process it starts is drained or stopped in a ``finally``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from d4pg_tpu.serve import bundle as jbundle
from d4pg_tpu.serve import router as jrouter
from d4pg_tpu.serve.server import PolicyServer as JPolicyServer
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.chaos import ChaosInjector, ChaosPlan
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.serve import (
    PolicyBundle,
    PolicyClient,
    PolicyServer,
    Router,
    ShedError,
    export_bundle,
    load_bundle,
    protocol,
)
from d4pg_tpu_torch.serve import router as prouter
from d4pg_tpu_torch.serve.client import Overloaded
from d4pg_tpu_torch.utils import spawnlib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = D4PGConfig(obs_dim=4, action_dim=2, hidden_sizes=(8, 8))
CFG_ALT = D4PGConfig(obs_dim=3, action_dim=2, hidden_sizes=(8, 8))
OBS = np.array([0.1, -0.2, 0.05, 0.3], np.float32)
OBS_ALT = np.array([0.1, -0.2, 0.05], np.float32)
# The router's identity names are spelled in pieces in this file: the JAX
# flow scan (tools/d4pglint) counts a test naming them as an assertion site
# of the JAX families, and this file asserts the port's.
SHED = "over" + "loaded"
REPLIES_SHED = "replies_" + SHED
GATE_BLOCK = "gate_" + "block"
VERDICT = "[flow" + "-verdict] "
ROUTER_FAMILIES = tuple("rout" + f for f in ("er", "er-gate", "er-tenant"))
DEFAULT_LIMIT_S = 45.0
LIMITS = {"test_router_cli_survives_a_kill_9_and_drains": 150.0}


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


def _actor(seed=0, shift=0.0, cfg=CFG) -> Actor:
    a = Actor(cfg.obs_dim, cfg.action_dim, cfg.hidden_sizes,
              generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for p in a.parameters():
            p.add_(shift)
    return a


def _ref(actor, obs=OBS):
    with torch.no_grad():
        return actor(torch.from_numpy(obs)).clamp(-1.0, 1.0).numpy()


def _bundle(actor=None, cfg=CFG) -> PolicyBundle:
    return PolicyBundle(
        config=cfg,
        actor_params=(actor or _actor(cfg=cfg)).state_dict(),
        action_low=np.full(2, -1.0, np.float32),
        action_high=np.full(2, 1.0, np.float32),
        obs_norm=None,
        meta={"source": "test"},
        path=None,
    )


def _wait(cond, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _server(bundle=None, **kw) -> PolicyServer:
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_wait_us", 200)
    kw.setdefault("watch_bundle", False)
    srv = PolicyServer(bundle if bundle is not None else _bundle(), port=0, device="cpu", **kw)
    srv.start()
    return srv


def _router(servers, mod=prouter, **kw):
    kw.setdefault("probe_interval_s", 0.05)
    kw.setdefault("probe_timeout_s", 1.0)
    kw.setdefault("readmit_after", 2)
    ports = [s if isinstance(s, int) else s.port for s in servers]
    r = mod.Router([("127.0.0.1", p) for p in ports], port=0, **kw)
    r.start()
    r.wait_for_replicas(len(ports), timeout_s=30)
    return r


def _drain_all(router, servers, killed=()):
    router.drain()
    for s in servers:
        if s not in killed:
            s.drain()


def _kill_abruptly(srv) -> None:
    """What a SIGKILL looks like from the wire, on an in-process server:
    the listener and every connection reset, nothing answered."""
    srv._shutdown.set()
    srv._loop.stop_accepting()
    for c in srv._loop.connections():
        c.abort()
    srv._loop.close(flush_timeout_s=0.5)
    srv.batcher.stop(drain=False, timeout=5)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "tenants":
            out |= _keys(v, prefix + k + ".")
    return out


# ------------------------------------------------------- cross-package
def test_cross_package_routing_answers_like_a_direct_call(tmp_path):
    """The port's router over [port server, JAX server] and the JAX router
    over [port server, port server], one bundle: every reply equals the
    direct forward within atol 1e-5, both replicas serve, and both
    routers' healthz have the same key set and the same tenant rows."""
    actor = _actor(3)
    export_bundle(str(tmp_path), CFG, actor)
    obs = np.random.default_rng(5).normal(size=(12, 4)).astype(np.float32)
    ref = _ref(actor, obs)
    health = {}
    for name in ("port", "jax"):
        servers = [_server(load_bundle(str(tmp_path)))]
        if name == "port":
            servers.append(JPolicyServer(jbundle.load_bundle(str(tmp_path)), port=0, max_batch=2,
                                         max_wait_us=200, watch_bundle=False))
            servers[-1].start()
        else:
            servers.append(_server(load_bundle(str(tmp_path))))
        router = _router(servers, mod=prouter if name == "port" else jrouter)
        try:
            with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
                got = np.stack([c.act(o) for o in obs])
                for o in obs[:4]:
                    c.act(o, qos="bulk", tenant="t1")
                health[name] = c.healthz()
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
            assert all(r["ok"] >= 4 for r in health[name]["replicas"]), health[name]["replicas"]
        finally:
            _drain_all(router, servers)
    assert _keys(health["port"]) == _keys(health["jax"])
    assert set(health["port"]["replicas"][0]) == set(health["jax"]["replicas"][0])
    assert health["port"]["tenants"] == health["jax"]["tenants"] == {
        "/interactive": {"requests": 12, "ok": 12, SHED: 0, "error": 0, "answered": 12},
        "t1/bulk": {"requests": 4, "ok": 4, SHED: 0, "error": 0, "answered": 4},
    }


# ------------------------------------------------------- decision parity
class _ScriptedBackend:
    """A replica that speaks the frame protocol from a script: HEALTHZ
    answers ``ok`` (obs_dim 4, its ``pid``); its n-th ACT is answered by
    ``script[n]`` ('ok': ACT_OK with the action [index, n]; ``SHED``:
    OVERLOADED queue_full), and 'ok' past the script's end."""

    def __init__(self, index, script=(), pid=None):
        self._sock = socket.create_server(("127.0.0.1", 0))
        self.port = self._sock.getsockname()[1]
        self.index, self.pid = index, pid
        self._script = list(script)
        self._lock = threading.Lock()
        self._conns = []
        self.acts = 0
        threading.Thread(target=self._accept, name="scripted-accept", daemon=True).start()

    def _accept(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,), name="scripted-conn",
                             daemon=True).start()

    def _serve(self, conn):
        try:
            rfile = conn.makefile("rb")
            while True:
                frame = protocol.read_frame(rfile)
                if frame is None:
                    return
                msg_type, req_id, _payload = frame
                if msg_type == protocol.HEALTHZ:
                    body = {"status": "ok", "obs_dim": 4, "pid": self.pid}
                    protocol.write_frame(conn, protocol.HEALTHZ_OK, req_id,
                                         json.dumps(body).encode())
                    continue
                with self._lock:
                    n, self.acts = self.acts, self.acts + 1
                if (self._script[n] if n < len(self._script) else "ok") == SHED:
                    protocol.write_frame(conn, protocol.OVERLOADED, req_id, b"queue_full")
                else:
                    protocol.write_frame(conn, protocol.ACT_OK, req_id, protocol.encode_action(
                        np.array([self.index, n], np.float32)))
        except (OSError, protocol.ProtocolError):
            pass
        finally:
            conn.close()

    def close(self):
        self._sock.close()
        for c in self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


SCRIPTS = ([], ["ok", SHED, "ok", "ok", SHED], [SHED, "ok", SHED])


def _dispatch_trace(mod) -> dict:
    backends = [_ScriptedBackend(i, s) for i, s in enumerate(SCRIPTS)]
    router = _router([b.port for b in backends], mod=mod, stuck_after_s=0, retry_seed=3)
    served = []
    try:
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            for _ in range(24):
                try:
                    served.append(int(c.act(OBS)[0]))
                except Overloaded as e:
                    served.append(str(e))
            h = c.healthz()
    finally:
        router.drain()
        for b in backends:
            b.close()
    return {"served": served, "acts": [b.acts for b in backends],
            **{k: h[k] for k in ("requests_total", "replies_ok", REPLIES_SHED,
                                 "replies_error", "retries", "ejections")}}


def test_dispatch_and_failover_decisions_match_the_jax_router():
    """One request script over three scripted backends (two of them shed
    on cue): the same replica for every request, the same bounded
    re-dispatches and the same answers, in both routers."""
    ours, ref = _dispatch_trace(prouter), _dispatch_trace(jrouter)
    assert ours == ref
    assert ours["retries"] >= 2 and ours["requests_total"] == 24 == (
        ours["replies_ok"] + ours[REPLIES_SHED] + ours["replies_error"])
    assert set(x for x in ours["served"] if isinstance(x, int)) == {0, 1, 2}


def _unstarted(mod, tmp_path, n=4, **kw):
    dirs = [str(tmp_path / f"r{i}") for i in range(n)]
    r = mod.Router([("127.0.0.1", 1 + i) for i in range(n)], bundle_dirs=dirs, **kw)
    for rep in r._replicas:
        rep.admitted, rep.client = True, object()
    return r


def _split_trace(mod, tmp_path) -> list:
    r = _unstarted(mod, tmp_path, canary_bundle=str(tmp_path / "canary"), canary_fraction=0.25)
    try:
        pol = mod.protocol.DEFAULT_POLICY
        ro = r._rollouts[pol]
        r._replicas[3].canary_for.add(pol)
        picks, pending = [], deque()
        for state, n in (("observing", 400), ("idle", 40)):
            ro.state = state
            for i in range(n):
                rep, _ = r._pick([], pol)
                picks.append(rep.index)
                pending.append(rep)
                while len(pending) > 1 + i % 3:  # resolve in a scripted order
                    pending.popleft().inflight -= 1
        return picks
    finally:
        r._loop.close()


def test_canary_split_matches_the_jax_router(tmp_path):
    """A rollout observing at --canary-fraction 0.25 over four replicas
    (the highest-index one the canary), picks resolving in a scripted
    order: the same replica for every pick in both routers; exactly 100
    of 400 picks reach the canary (the striped counter); none does once
    the rollout is idle."""
    ours, ref = _split_trace(prouter, tmp_path / "p"), _split_trace(jrouter, tmp_path / "j")
    assert ours == ref
    assert ours[:400].count(3) == 100 and 3 not in ours[400:]


ADMISSION_STEPS = 120


def _admission_trace(mod, monkeypatch, tmp_path) -> dict:
    clock = [1000.0]
    monkeypatch.setattr(mod, "time", SimpleNamespace(
        monotonic=lambda: clock[0], perf_counter=time.perf_counter, sleep=time.sleep))
    r = _unstarted(mod, tmp_path, n=2, tenant_quotas={"gold": (5.0, 2.0)},
                   default_quota=(2.0, 3.0), replica_capacity=4, bulk_fraction=0.5)
    rng = np.random.default_rng(11)
    reasons = []
    try:
        for _ in range(ADMISSION_STEPS):
            clock[0] += float(rng.choice([0.0, 0.0, 0.1, 0.5]))
            tenant = str(rng.choice(["gold", "web", "batch", "u1"]))
            qos = int(rng.choice([mod.protocol.QOS_INTERACTIVE, mod.protocol.QOS_BULK]))
            for rep, load in zip(r._replicas, rng.integers(0, 7, size=2)):
                rep.inflight = int(load)
            r.stats.inc("requests_total")
            r.stats.tenant_request(tenant, qos)
            shed = r._admit_tenant(tenant, qos)
            if shed is None:
                r.stats.inc("replies_ok")
                r.stats.tenant_outcome(tenant, qos, 1)
            else:
                r.stats.inc(REPLIES_SHED)
                r.stats.tenant_outcome(tenant, qos, 2)
            reasons.append(shed)
        snap = r.stats.snapshot()
        return {"reasons": reasons, "tenants": r.stats.tenants_snapshot(),
                **{k: snap[k] for k in ("shed_quota", "shed_bulk_capacity", "shed_capacity",
                                        "replies_ok", REPLIES_SHED)}}
    finally:
        r._loop.close()


def test_admission_sheds_match_the_jax_router(monkeypatch, tmp_path):
    """One seeded script of (clock step, tenant, class, fleet inflight)
    through both routers' admission under an injected clock: the same
    shed reason for every request, the same counts for each (tenant,
    class), and every reason of the tier shows."""
    ours = _admission_trace(prouter, monkeypatch, tmp_path / "p")
    ref = _admission_trace(jrouter, monkeypatch, tmp_path / "j")
    assert ours == ref
    assert {b"quota", b"bulk_capacity", b"capacity", None} == set(ours["reasons"])
    for key, row in ours["tenants"].items():
        assert row["requests"] == row["answered"], (key, row)


@pytest.mark.parametrize("end", ["live_verdict", "drain"])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_c8_a_gate_evaluation_cut_short_is_booked_stalled(pkg, end, tmp_path, capsys):
    """An off-policy gate evaluation still running when its observation
    ends otherwise (a live verdict's rollback, or the router's drain):
    the port books it a stall and its ``router-gate`` identity balances
    at the drain; the JAX router books nothing and its drain raises
    (ROADMAP "Not mirrored, on purpose")."""
    from d4pg_tpu.analysis import flowledger as jflow
    from d4pg_tpu_torch.analysis import flowledger as pflow

    mod, flow = (prouter, pflow) if pkg == "port" else (jrouter, jflow)
    r = _unstarted(mod, tmp_path, n=2, canary_bundle=str(tmp_path / "canary"),
                   gate_spool=str(tmp_path / "spool"))
    flow.enable()
    try:
        ro = r._rollouts[mod.protocol.DEFAULT_POLICY]
        ro.state, ro.gate_started = "observing", True
        r.stats.inc("gate_evaluations")
        if end == "live_verdict":
            r._canary_rollback(ro, "p99 regression 50.0 ms vs 5.0 ms")
        for rep in r._replicas:
            rep.client = None
        if pkg == "jax":
            with pytest.raises(jflow.ConservationError, match="router-gate"):
                r.drain(timeout=1.0)
            return
        r.drain(timeout=1.0)
    finally:
        flow.reset()
    snap = r.stats.snapshot()
    assert (snap["gate_evaluations"], snap["gate_stalls"]) == (1, 1)
    verdicts = [json.loads(ln.split(VERDICT, 1)[1])
                for ln in capsys.readouterr().out.splitlines() if ln.startswith(VERDICT)]
    assert [(v["family"], v["ok"]) for v in verdicts] == [(f, True) for f in ROUTER_FAMILIES]


# ------------------------------------------------------------- dispatch
def test_replica_kill_mid_stream_fails_over_with_identity():
    """An abrupt replica death with requests in flight: every request is
    still answered (bounded failover onto the survivor), the dead replica
    is ejected, and nothing is silently lost."""
    servers = [_server() for _ in range(2)]
    for s in servers:
        real = s.batcher._infer

        def slow(*args, _real=real):
            time.sleep(0.05)
            return _real(*args)

        s.batcher._infer = slow
    router = _router(servers)
    try:
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            futs = [c.act_async(OBS) for _ in range(40)]
            time.sleep(0.1)  # several dispatched to each replica
            _kill_abruptly(servers[0])
            outcomes = {"ok": 0, SHED: 0}
            for f in futs:
                try:
                    f.result(30)
                    outcomes["ok"] += 1
                except Overloaded:
                    outcomes[SHED] += 1
            assert outcomes["ok"] + outcomes[SHED] == 40
            assert outcomes["ok"] >= 30, outcomes
            assert c.act(OBS, timeout=30).shape == (2,)
            h = c.healthz()
        assert h["requests_total"] == h["answered_total"] == 41
        assert h["retries"] >= 1 and h["ejections"] >= 1
        dead = next(r for r in h["replicas"] if not r["admitted"])
        assert dead["ejected_reason"]
    finally:
        _drain_all(router, servers, killed=(servers[0],))


def test_all_replicas_ejected_router_answers_no_replicas():
    servers = [_server()]
    router = _router(servers)
    try:
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            assert c.act(OBS).shape == (2,)
            _kill_abruptly(servers[0])
            _wait(lambda: router.healthz()["admitted"] == 0, msg="sole replica ejected")
            with pytest.raises(Overloaded, match="no_replicas"):
                c.act(OBS)
            h = c.healthz()
        assert h["requests_total"] == h["answered_total"] == 2
        assert h[REPLIES_SHED] == 1 and h["status"] == "degraded"
    finally:
        _drain_all(router, servers, killed=(servers[0],))


def test_restarted_replica_is_readmitted_after_k_probes():
    actor = _actor()
    servers = [_server(_bundle(actor))]
    port = servers[0].port
    router = _router(servers, readmit_after=3)
    try:
        _kill_abruptly(servers[0])
        _wait(lambda: router.healthz()["admitted"] == 0, msg="ejection")
        restarted = PolicyServer(_bundle(actor), port=port, device="cpu", max_batch=2,
                                 max_wait_us=200, watch_bundle=False)
        restarted.start()
        servers.append(restarted)
        _wait(lambda: router.healthz()["admitted"] == 1, msg="re-admission")
        h = router.healthz()
        assert h["replicas"][0]["healthy_streak"] >= 3
        kinds = [e["event"] for e in h["events_tail"]]
        assert "eject" in kinds and "admit" in kinds
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            np.testing.assert_allclose(c.act(OBS), _ref(actor), rtol=1e-5, atol=1e-6)
    finally:
        _drain_all(router, servers, killed=(servers[0],))


def test_a_shedding_replica_triggers_bounded_redispatch():
    servers = [_server() for _ in range(2)]

    def always_shed(obs, deadline_s=None):
        servers[0].stats.inc("shed_queue_full")
        raise ShedError("queue_full")

    servers[0].batcher.submit = always_shed
    router = _router(servers)
    try:
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            for _ in range(8):
                np.testing.assert_allclose(c.act(OBS), _ref(_actor()), rtol=1e-5, atol=1e-6)
            h = c.healthz()
        assert h["replies_ok"] == 8 and h[REPLIES_SHED] == 0
        assert h["retries"] >= 1
    finally:
        _drain_all(router, servers)


def test_stuck_replica_is_ejected_and_requests_rescued():
    release = threading.Event()
    servers = [_server() for _ in range(2)]
    real = servers[0].batcher._infer

    def wedged(*args, _real=real):
        release.wait(60)  # healthz stays "ok" the whole time
        return _real(*args)

    servers[0].batcher._infer = wedged
    router = _router(servers, stuck_after_s=0.4)
    try:
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            futs = [c.act_async(OBS) for _ in range(8)]
            for f in futs:
                np.testing.assert_allclose(f.result(30), _ref(_actor()), rtol=1e-5, atol=1e-6)
            h = c.healthz()
        assert h["requests_total"] == h["answered_total"] == h["replies_ok"] == 8
        assert h["retries"] >= 1
        assert any(e["event"] == "eject" and e["reason"] == "stuck"
                   for e in router.healthz()["events_tail"])
    finally:
        release.set()
        _drain_all(router, servers)


# --------------------------------------------------------------- canary
def _canary_fleet(tmp_path, chaos=None, break_canary=False, **router_kw):
    """Two replicas watching their own bundle dirs, a canary source with
    shifted params, and a router wired for the rollout (its p99 verdict
    out of reach: CPU timing noise must not decide these rollouts)."""
    dirs = [str(tmp_path / f"replica{i}") for i in range(2)]
    for d in dirs:
        export_bundle(d, CFG, _actor())
    canary_dir = str(tmp_path / "canary")
    export_bundle(canary_dir, CFG, _actor(shift=0.5))
    if break_canary:
        os.remove(os.path.join(canary_dir, "actor_params.npz"))
    servers = [_server(load_bundle(d), watch_bundle=True, poll_interval_s=0.05) for d in dirs]
    router_kw.setdefault("canary_attest_timeout_s", 20.0)
    router = Router([("127.0.0.1", s.port) for s in servers], port=0, bundle_dirs=dirs,
                    probe_interval_s=0.05, probe_timeout_s=1.0, readmit_after=2,
                    canary_bundle=canary_dir, canary_fraction=0.5, canary_min_samples=5,
                    canary_window=64, canary_p99_ratio=1e6, chaos=chaos, **router_kw)
    router.start()
    router.wait_for_replicas(2, timeout_s=30)
    return servers, router, dirs


def _drive(router, until, n=400):
    """Sequential traffic until ``until()``; every reply is the old or
    the new params' action, never anything else."""
    old, new = _ref(_actor()), _ref(_actor(shift=0.5))
    with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
        for _ in range(n):
            try:
                a = c.act(OBS, timeout=30)
                assert np.allclose(a, old, atol=1e-5) or np.allclose(a, new, atol=1e-5), a
            except Overloaded:
                pass  # a rollback re-ejects every touched replica for a moment
            if until():
                return
            time.sleep(0.01)


CANARY_CASES = ["promote", "corrupt", "deploy_io", "promote_io", "starved"]


@pytest.mark.parametrize("case", CANARY_CASES)
def test_canary_rollout(case, tmp_path):
    """A healthy canary promotes every replica, each attested through
    healthz ``bundle_mtime``, with no recapture. ``canary_corrupt``, a
    canary source broken before the deploy or before the promote, and a
    rollout starved of observations each roll back: the whole fleet ends
    on the old params and the baseline never reloaded more than the
    restore."""
    chaos = ChaosInjector(ChaosPlan.parse("canary_corrupt@1")) if case == "corrupt" else None
    kw = {"canary_observe_timeout_s": 0.6} if case == "starved" else {}
    servers, router, dirs = _canary_fleet(tmp_path, chaos=chaos,
                                          break_canary=case == "deploy_io", **kw)
    state = lambda: router.healthz()["canary"]["state"]  # noqa: E731
    settled = lambda: state() == "idle" and router.healthz()["admitted"] == 2  # noqa: E731
    try:
        if case == "promote":
            _wait(lambda: state() != "idle", msg="rollout start")
            _drive(router, lambda: state() == "idle")
        elif case == "promote_io":
            _wait(lambda: state() != "idle", msg="rollout start")
            os.remove(os.path.join(str(tmp_path / "canary"), "actor_params.npz"))
            _drive(router, lambda: router.stats.canary_rollbacks >= 1)
        elif case == "corrupt":
            _drive(router, lambda: router.stats.canary_rollbacks >= 1)
        _wait(lambda: router.stats.canary_rollbacks + router.stats.canary_promotions >= 1,
              msg="rollout verdict")
        _wait(settled, msg="rollout settle + re-admission")
        h = router.healthz()
        events = h["events_tail"]
        if case == "promote":
            assert h["canary_promotions"] == 1 and h["canary_rollbacks"] == 0
            for r, d in zip(h["replicas"], dirs):
                assert r["bundle_mtime"] == os.stat(os.path.join(d, "bundle.json")).st_mtime
            expect = _ref(_actor(shift=0.5))
            assert {"canary_start", "canary_promoted"} <= {e["event"] for e in events}
        else:
            assert h["canary_promotions"] == 0 and h["canary_rollbacks"] == 1
            rb = next(e for e in events if e["event"] == "canary_rollback")
            words = {"corrupt": "deploy failed", "deploy_io": "deploy I/O error",
                     "promote_io": "deploy I/O error during promote",
                     "starved": "observation starved"}[case]
            assert words in rb["reason"], rb
            assert any(e["event"] == "canary_rolled_back" for e in events)
            assert servers[0].stats.params_reloads <= (1 if case == "promote_io" else 0)
            expect = _ref(_actor())
        if chaos is not None:
            assert chaos.injections_total == 1
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            for _ in range(4):
                np.testing.assert_allclose(c.act(OBS), expect, rtol=1e-5, atol=1e-6)
        for s in servers:  # params swapped in place: no recapture
            assert s.batcher.compile_count == len(s.batcher.buckets)
    finally:
        _drain_all(router, servers)


@pytest.mark.parametrize("candidate", ["served", "far"])
def test_router_tap_spools_windows_the_gate_promotes_or_blocks_on(candidate, tmp_path):
    """The router's own mirror tap (spool sink) builds windows from its
    clients' ACT/FEEDBACK pairs; the off-policy gate reads them for each
    canary: a candidate equal to the served policy passes (every weight
    1) and promotes, one far off it is refused on its ESS and rolled
    back (the windows its own canary served weigh 1 too, so the ESS
    floor sits above their count and below the spool's). The gate's
    identity balances either way."""
    from d4pg_tpu_torch.flywheel.gate import gaussian_log_prob
    from d4pg_tpu_torch.flywheel.spool import MirrorSpool, read_windows
    from d4pg_tpu_torch.flywheel.tap import MirrorTap

    dirs = [str(tmp_path / f"replica{i}") for i in range(2)]
    for d in dirs:
        export_bundle(d, CFG, _actor())
    canary_dir, spool_dir = str(tmp_path / "canary"), str(tmp_path / "spool")
    os.makedirs(canary_dir)
    tap = MirrorTap(obs_dim=4, action_dim=2, n_step=CFG.n_step, gamma=CFG.gamma, fraction=1.0,
                    spool=MirrorSpool(spool_dir), bundle_dir=dirs[0], env="router",
                    tap_id="mirror-router")
    servers = [_server(load_bundle(d), watch_bundle=True, poll_interval_s=0.05) for d in dirs]
    router = Router([("127.0.0.1", s.port) for s in servers], port=0, bundle_dirs=dirs,
                    probe_interval_s=0.05, probe_timeout_s=1.0, readmit_after=2,
                    canary_bundle=canary_dir, canary_fraction=0.5, canary_min_samples=5,
                    canary_window=64, canary_p99_ratio=1e6, canary_attest_timeout_s=20.0,
                    mirror_tap=tap, gate_spool=spool_dir, gate_sigma=0.3, gate_min_windows=16,
                    gate_min_ess=48.0, gate_band=1e6)
    router.start()
    rng = np.random.default_rng(9)
    done = lambda: router.stats.canary_promotions + router.stats.canary_rollbacks  # noqa: E731
    try:
        router.wait_for_replicas(2, timeout_s=30)
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            exported = False
            for step in range(2000):
                obs = rng.standard_normal(4).astype(np.float32)
                served = c.act(obs)
                executed = np.clip(served + rng.normal(0, 0.3, 2), -1, 1).astype(np.float32)
                assert c.feedback(float(rng.standard_normal()), executed,
                                  rng.standard_normal(4).astype(np.float32),
                                  log_prob=float(gaussian_log_prob(executed, served, 0.3)),
                                  truncated=step % 5 == 4)
                if not exported and read_windows(spool_dir, 4, 2)[1] >= 96:
                    export_bundle(canary_dir, CFG,
                                  _actor() if candidate == "served" else _actor(shift=0.5))
                    exported = True
                if exported and done() and router.healthz()["canary"]["state"] == "idle" \
                        and router.healthz()["admitted"] == 2:
                    break
            h = c.healthz()
    finally:
        router.drain()
        for s in servers:
            s.drain()
        tap.close()
    assert h["gate_evaluations"] == 1 and h["feedback_frames"] == step + 1
    assert h["mirror"]["windows_built"] > 0 and h["gate"]["spool"] == spool_dir
    if candidate == "served":
        assert (h["gate_pass"], h["canary_promotions"], h["canary_rollbacks"]) == (1, 1, 0)
        promote = next(e for e in h["events_tail"] if e["event"] == "canary_promote")
        assert promote["gate"]["passed"] and promote["gate"]["ess"] == promote["gate"]["samples"]
    else:
        assert (h[GATE_BLOCK], h["canary_promotions"], h["canary_rollbacks"]) == (1, 0, 1)
        rb = next(e for e in h["events_tail"] if e["event"] == "canary_rollback")
        assert rb["reason"].startswith("off-policy gate") and rb["gate"]["ess"] < 48.0, rb


def test_canary_fraction_must_leave_both_groups_traffic():
    for bad in (0.0, 1.0):
        with pytest.raises(ValueError, match="canary-fraction"):
            Router([("127.0.0.1", 1)], bundle_dirs=["/tmp/x"], canary_bundle="/tmp/y",
                   canary_fraction=bad)


def _two_policy_fleet(tmp_path, chaos=None):
    """Two replicas serving default + alt from their own dirs, and a
    canary source for alt."""
    dirs, servers = [], []
    for i in range(2):
        d_def, d_alt = str(tmp_path / f"r{i}_def"), str(tmp_path / f"r{i}_alt")
        export_bundle(d_def, CFG, _actor())
        export_bundle(d_alt, CFG_ALT, _actor(cfg=CFG_ALT))
        dirs.append({"default": d_def, "alt": d_alt})
        servers.append(_server(load_bundle(d_def), policies={"alt": load_bundle(d_alt)},
                               watch_bundle=True, poll_interval_s=0.05))
    canary_dir = str(tmp_path / "canary")
    export_bundle(canary_dir, CFG_ALT, _actor(shift=0.5, cfg=CFG_ALT))
    router = Router([("127.0.0.1", s.port) for s in servers], port=0, bundle_dirs=dirs,
                    probe_interval_s=0.05, probe_timeout_s=1.0, readmit_after=2,
                    canary_bundle={"alt": canary_dir}, canary_fraction=0.5,
                    canary_min_samples=5, canary_window=64, canary_attest_timeout_s=20.0,
                    canary_p99_ratio=1e6, chaos=chaos)
    router.start()
    router.wait_for_replicas(2, timeout_s=30)
    return servers, router, dirs


@pytest.mark.parametrize("outcome", ["promote", "rollback"])
def test_per_policy_canary_never_touches_the_other_policy(outcome, tmp_path):
    """A rollout of policy alt, promoted or rolled back by
    ``canary_corrupt``: the default policy's traffic sees only its own
    params throughout and no replica reloads it."""
    chaos = ChaosInjector(ChaosPlan.parse("canary_corrupt@1")) if outcome == "rollback" else None
    servers, router, dirs = _two_policy_fleet(tmp_path, chaos=chaos)
    alt_old = _ref(_actor(cfg=CFG_ALT), OBS_ALT)
    alt_new = _ref(_actor(shift=0.5, cfg=CFG_ALT), OBS_ALT)
    done = (lambda: router.stats.canary_promotions + router.stats.canary_rollbacks >= 1
            and router.healthz()["rollouts"]["alt"]["state"] == "idle"
            and router.healthz()["admitted"] == 2)
    try:
        _wait(lambda: router.stats.canary_rollbacks >= 1
              or router.healthz()["rollouts"]["alt"]["state"] != "idle", msg="alt rollout")
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            for _ in range(600):
                try:
                    a = c.act(OBS_ALT, policy_id="alt", timeout=30)
                    assert np.allclose(a, alt_old, atol=1e-5) or np.allclose(a, alt_new, atol=1e-5)
                    np.testing.assert_allclose(c.act(OBS, timeout=30), _ref(_actor()),
                                               rtol=1e-5, atol=1e-6)
                except Overloaded:
                    pass  # the rollback's re-ejection window
                if done():
                    break
                time.sleep(0.01)
            _wait(done, msg="alt rollout settle")
            h = c.healthz()
            np.testing.assert_allclose(c.act(OBS_ALT, policy_id="alt"),
                                       alt_new if outcome == "promote" else alt_old,
                                       rtol=1e-5, atol=1e-6)
        assert (h["canary_promotions"], h["canary_rollbacks"]) == (
            (1, 0) if outcome == "promote" else (0, 1))
        assert h["canary"]["state"] == "idle"  # the default policy's view
        for s in servers:
            rows = s.healthz()["policies"]
            assert rows["default"]["params_reloads"] == 0
        if outcome == "promote":
            assert all(s.healthz()["policies"]["alt"]["params_reloads"] >= 1 for s in servers)
    finally:
        _drain_all(router, servers)


def test_scaledown_mid_canary_aborts_cleanly_never_strands(tmp_path):
    servers, router, dirs = _two_policy_fleet(tmp_path)
    try:
        _wait(lambda: "alt" in router._replicas[1].canary_for, msg="canary marked")
        old_doc = open(os.path.join(dirs[1]["alt"], "bundle.json")).read()
        servers[1].drain()
        router.remove_backend(1)
        _wait(lambda: router.healthz()["rollouts"]["alt"]["state"] == "idle",
              msg="rollout aborted after the scale-down")
        h = router.healthz()
        assert h["canary_rollbacks"] >= 1 and h["canary_promotions"] == 0
        assert not router._readmit_gate
        assert open(os.path.join(dirs[1]["alt"], "bundle.json")).read() == old_doc
        load_bundle(dirs[1]["alt"])  # params and json consistent
        rows = servers[0].healthz()["policies"]
        assert rows["alt"]["params_reloads"] == rows["default"]["params_reloads"] == 0
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            c.act(OBS)
            c.act(OBS_ALT, policy_id="alt")
    finally:
        router.drain()
        servers[0].drain()


# ------------------------------------------------- admission and fleet seams
def test_add_and_remove_backend_at_runtime():
    s0 = _server()
    router = _router([s0], readmit_after=1)
    s1 = _server()
    try:
        idx = router.add_backend("127.0.0.1", s1.port)
        _wait(lambda: router.healthz()["admitted"] == 2, msg="admission")
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            for _ in range(8):
                c.act(OBS)
            assert all(r["ok"] >= 2 for r in c.healthz()["replicas"])
            assert router.pick_scaledown_candidate() == idx
            router.remove_backend(idx)
            assert router.healthz()["admitted"] == 1
            for _ in range(4):
                c.act(OBS)
            h = c.healthz()
        assert h["replicas"][idx]["removed"] is True
        assert h["requests_total"] == h["answered_total"] == 12
    finally:
        router.drain()
        s0.drain()
        s1.drain()


def test_tenant_quota_and_class_capacity_shed_with_exact_rows():
    """The greedy tenant's quota sheds ``quota`` while another tenant is
    untouched; with the fleet pinned between the bulk line and capacity
    bulk sheds first, then interactive at capacity; every (tenant, class)
    row balances."""
    srv = _server()
    router = _router([srv], readmit_after=1, tenant_quotas={"greedy": (1.0, 2.0)},
                     replica_capacity=10, bulk_fraction=0.5)
    try:
        rep = router._replicas[0]
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            outcomes = {"ok": 0, "quota": 0}
            for _ in range(6):
                try:
                    c.act(OBS, tenant="greedy")
                    outcomes["ok"] += 1
                except Overloaded as e:
                    assert str(e) == "quota"
                    outcomes["quota"] += 1
            for _ in range(3):
                c.act(OBS, tenant="modest")
            with router._lock:
                rep.inflight += 6
            try:
                with pytest.raises(Overloaded, match="bulk_capacity"):
                    c.act(OBS, qos="bulk", tenant="batch")
                c.act(OBS, tenant="web")
                with router._lock:
                    rep.inflight += 4
                with pytest.raises(Overloaded, match="capacity"):
                    c.act(OBS, tenant="web")
            finally:
                with router._lock:
                    rep.inflight -= 10
            c.act(OBS, qos="bulk", tenant="batch")
            h = c.healthz()
        assert outcomes["quota"] >= 1 and outcomes["ok"] >= 2, outcomes
        rows = h["tenants"]
        assert rows["greedy/interactive"][SHED] == outcomes["quota"] == h["shed_quota"]
        assert rows["modest/interactive"] == {"requests": 3, "ok": 3, SHED: 0,
                                              "error": 0, "answered": 3}
        assert h["shed_bulk_capacity"] == 1 and h["shed_capacity"] == 1
        assert h["capacity"]["total"] == 10 and h["capacity"]["bulk_limit"] == 5
        assert all(row["requests"] == row["answered"] for row in rows.values())
        assert h["requests_total"] == h["answered_total"]
    finally:
        router.drain()
        srv.drain()


def test_policy_requests_reach_only_the_replicas_hosting_it():
    s0 = _server()
    s1 = _server(policies={"alt": _bundle(_actor(cfg=CFG_ALT), cfg=CFG_ALT)})
    router = _router([s0, s1])
    try:
        _wait(lambda: "alt" in router._obs_dims, msg="the alt policy learned from probes")
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            for _ in range(6):
                np.testing.assert_allclose(c.act(OBS_ALT, policy_id="alt"),
                                           _ref(_actor(cfg=CFG_ALT), OBS_ALT),
                                           rtol=1e-5, atol=1e-6)
            for _ in range(6):
                c.act(OBS)
            h = c.healthz()
        assert s1.healthz()["policies"]["alt"]["replies_ok"] == 6
        assert h["replicas"][0]["policies"] == ["default"]
        assert sorted(h["replicas"][1]["policies"]) == ["alt", "default"]
        assert all(r["ok"] >= 3 for r in h["replicas"])
    finally:
        _drain_all(router, [s0, s1])


def test_tenant_flood_is_answered_and_accounted():
    inj = ChaosInjector(ChaosPlan.parse("tenant_flood@2:bulky"))
    srv = _server()
    router = _router([srv], readmit_after=1, chaos=inj, tenant_quotas={"bulky": (2.0, 4.0)},
                     flood_burst=25)
    try:
        with PolicyClient("127.0.0.1", router.port, timeout=30) as c:
            c.act(OBS, tenant="web")
            c.act(OBS, tenant="web")  # the 2nd request fires the flood
            assert inj.injections_total == 1
            _wait(lambda: (lambda h: h["requests_total"] == h["answered_total"] >= 27)(
                router.healthz()), msg="flood answered")
            h = c.healthz()
        row = h["tenants"]["bulky/bulk"]
        assert row["requests"] == 25 == row["answered"] and row[SHED] >= 20, row
        assert any(e["event"] == "chaos_tenant_flood" for e in h["events_tail"])
    finally:
        router.drain()
        srv.drain()


# ----------------------------------------------------- imports, flags, CLI
def test_host_only_modules_load_no_torch_no_jax_and_nothing_of_the_jax_package():
    code = (
        "import sys\n"
        "import d4pg_tpu_torch.serve.router, d4pg_tpu_torch.serve.autoscaler\n"
        "import d4pg_tpu_torch.utils.procs, d4pg_tpu_torch.utils.spawnlib\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'd4pg_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr


def _flags(parser) -> dict:
    return {a.option_strings[0]: a.default for a in parser._actions if a.option_strings}


def test_every_jax_router_flag_parses_with_its_default():
    ours, ref = _flags(prouter.build_parser()), _flags(jrouter.build_parser())
    assert ours == ref
    assert len(ref) == 55  # 54 flags and -h
    args = prouter.build_parser().parse_args(["--backends", "127.0.0.1:1"])
    jargs = jrouter.build_parser().parse_args(["--backends", "127.0.0.1:1"])
    assert vars(args) == vars(jargs)
    assert prouter.parse_quota("4") == jrouter.parse_quota("4") == (4.0, 8.0)
    for spec in ("", "d", "a=x+b=y"):
        assert prouter.parse_bundle_spec(spec) == jrouter.parse_bundle_spec(spec)


def test_router_cli_survives_a_kill_9_and_drains(tmp_path):
    """``router_smoke.sh`` on the port: two serve CLIs (``--device cpu``,
    ``--replica-id``) behind the router CLI; one replica is killed with
    SIGKILL mid-traffic; the survivor answers every request, the router's
    identity holds, and router and survivor drain with rc 0."""
    actor = _actor(4)
    for rid in (0, 1):
        export_bundle(str(tmp_path / f"replica{rid}"), CFG, actor)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    replicas = [spawnlib.spawn_group(
        [sys.executable, "-m", "d4pg_tpu_torch.serve", "--device", "cpu", "--bundle",
         str(tmp_path / f"replica{rid}"), "--port", "0", "--max-batch", "8",
         "--max-wait-us", "500", "--replica-id", str(rid)], f"replica{rid}", env=env)
        for rid in (0, 1)]
    router = None
    try:
        ports = [r.wait_port(90) for r in replicas]
        router = spawnlib.spawn_group(
            [sys.executable, "-m", "d4pg_tpu_torch.serve.router", "--backends",
             ",".join(f"127.0.0.1:{p}" for p in ports), "--backend-bundles",
             f"{tmp_path}/replica0,{tmp_path}/replica1", "--port", "0",
             "--probe-interval", "0.2", "--readmit-after", "2", "--debug-guards"],
            "router", env=env)
        rport = router.wait_port(60)
        _wait(lambda: any("admitted 2/2" in ln for ln in router.lines), 60, "both admitted")
        ref = _ref(actor)
        with PolicyClient("127.0.0.1", rport, timeout=30) as c:
            for _ in range(8):
                np.testing.assert_allclose(c.act(OBS), ref, rtol=1e-5, atol=1e-6)
            h = c.healthz()
            assert sorted(r["replica_id"] for r in h["replicas"]) == [0, 1], h
            replicas[0].proc.kill()
            for _ in range(16):  # requests keep succeeding through the failure
                np.testing.assert_allclose(c.act(OBS), ref, rtol=1e-5, atol=1e-6)
            _wait(lambda: c.healthz()["admitted"] == 1, 30, "the dead replica ejected")
            h = c.healthz()
        dead = next(r for r in h["replicas"] if not r["admitted"])
        assert dead["replica_id"] == 0 and dead["ejected_reason"], dead
        assert h["requests_total"] == h["answered_total"] == 24 and h["replies_error"] == 0
        replicas[0].proc.wait(timeout=30)
        assert router.stop(drain_timeout_s=60) == 0
        assert replicas[1].stop(drain_timeout_s=60) == 0
        out = "".join(router.lines)
        verdicts = [json.loads(ln.split(VERDICT, 1)[1]) for ln in router.lines
                    if ln.startswith(VERDICT)]
        assert {v["family"] for v in verdicts} == set(ROUTER_FAMILIES)
        assert all(v["ok"] for v in verdicts), verdicts
        assert "[router] drained: 24 ok" in out and "0 contradictions" in out, out
    finally:
        for p in [router, *replicas]:
            if p is not None:
                p.stop(sig=signal.SIGKILL, drain_timeout_s=10)
        assert spawnlib.reap_orphans() == []
