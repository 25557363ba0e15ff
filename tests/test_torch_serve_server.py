"""The port's policy server end to end over real sockets on the CPU: the
same raw request bytes against the JAX server, every fault path a public
endpoint must survive, hot reload under live traffic, the graceful drain,
the event loop's evictions, and the CLI as a subprocess.

Every server and loop a test starts is drained or closed in a ``finally``
(or a fixture's teardown), every client has a timeout, and reload tests
call ``check_reload()`` directly instead of waiting on the watcher.
Actions are held to atol 1e-5 against the JAX server (float32, the
reason in test_torch_serve.py) and to rtol 1e-5 / atol 1e-6 against the
port's own forward of the same rows.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from d4pg_tpu.serve import bundle as jbundle
from d4pg_tpu.serve.server import PolicyServer as JPolicyServer
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.netio import FrameLoop
from d4pg_tpu_torch.serve import (
    Overloaded,
    PolicyBundle,
    PolicyClient,
    PolicyServer,
    ShedError,
    export_bundle,
    load_bundle,
)
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.protocol import encode_frame, read_frame, write_frame
from d4pg_tpu_torch.weights import save_best_actor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = D4PGConfig(obs_dim=4, action_dim=2, hidden_sizes=(32, 32))
TIMEOUT = 30.0


def _actor(seed=0) -> Actor:
    return Actor(4, 2, (32, 32), generator=torch.Generator().manual_seed(seed))


def _bundle(actor=None, path=None) -> PolicyBundle:
    return PolicyBundle(
        config=CFG,
        actor_params=(actor or _actor()).state_dict(),
        action_low=np.full(2, -1.0, np.float32),
        action_high=np.full(2, 1.0, np.float32),
        obs_norm=None,
        meta={"source": "test"},
        path=path,
    )


def _forward(actor, obs, stats=None):
    obs = np.asarray(obs, np.float32)
    if stats is not None:
        mean = np.asarray(stats["mean"], np.float32)
        std = np.maximum(np.sqrt(np.asarray(stats["m2"]) / stats["count"]), 1e-2)
        obs = np.clip((obs - mean) / std.astype(np.float32), -5, 5)
    with torch.no_grad():
        return actor(torch.from_numpy(obs)).clamp(-1.0, 1.0).numpy()


def _server(bundle=None, **kw) -> PolicyServer:
    kw.setdefault("watch_bundle", False)
    srv = PolicyServer(bundle or _bundle(), port=0, device="cpu", **kw)
    srv.start()
    return srv


def _client(srv) -> PolicyClient:
    return PolicyClient("127.0.0.1", srv.port, timeout=TIMEOUT)


def _bump_mtime(path, by):
    t = time.time() + by
    os.utime(os.path.join(path, "bundle.json"), (t, t))


@pytest.fixture(scope="module")
def server():
    srv = _server(max_batch=4, max_wait_us=500, queue_limit=16)
    yield srv
    srv.drain()


# ---------------------------------------------------------- server vs JAX
def _exchange(port, blob, n_frames):
    """Send ``blob``; the replies as (header bytes, payload), by req_id."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=10) as c:
        c.sendall(blob)
        f = c.makefile("rb")
        for _ in range(n_frames):
            hdr = protocol.recv_exact(f, protocol.HEADER.size)
            out.append((hdr, protocol.recv_exact(f, protocol.HEADER.unpack(hdr)[4]) or b""))
    return sorted(out, key=lambda r: protocol.HEADER.unpack(r[0])[3])


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def test_replies_match_the_jax_server_byte_for_byte(tmp_path):
    """The same raw request bytes to a JAX server and to the port's, both
    serving one bundle with obs-norm stats and non-identity bounds: reply
    headers byte-identical, actions within 1e-5, error frames identical,
    healthz with the same key set recursively."""
    stats = {"count": 9.0, "mean": [0.5, -0.25, 0.0, 1.0], "m2": [9.0, 4.0, 1.0, 16.0]}
    export_bundle(str(tmp_path), CFG, _actor(3), action_low=[-3.0, 0.0], action_high=[3.0, 2.0],
                  obs_norm_state=stats)
    obs = np.random.default_rng(5).normal(size=(12, 4)).astype(np.float32)
    frames = [encode_frame(protocol.ACT, i + 1, protocol.encode_act(o)) for i, o in enumerate(obs)]
    frames.append(encode_frame(protocol.ACT2, 50, protocol.encode_act2(obs[0], policy_id="nope")))
    frames.append(encode_frame(protocol.ACT2, 51, protocol.encode_act2(np.zeros(3, np.float32))))
    frames.append(encode_frame(protocol.FEEDBACK, 52, protocol.encode_feedback(
        1.0, np.zeros(2, np.float32), obs[1])))
    frames.append(encode_frame(protocol.FEEDBACK, 53, protocol.encode_feedback(
        1.0, np.zeros(3, np.float32), obs[1])))
    blob = b"".join(frames)
    kw = dict(port=0, max_batch=4, max_wait_us=500, queue_limit=16, watch_bundle=False)
    replies, health = {}, {}
    for name in ("jax", "port"):
        srv = (JPolicyServer(jbundle.load_bundle(str(tmp_path)), **kw) if name == "jax"
               else PolicyServer(load_bundle(str(tmp_path)), device="cpu", **kw))
        srv.start()
        try:
            replies[name] = _exchange(srv.port, blob, len(frames))
            health[name] = srv.healthz()
        finally:
            srv.drain()
    for (jh, jp), (ph, pp) in zip(replies["jax"], replies["port"]):
        assert ph == jh  # magic, version, type, req_id and length
        if protocol.HEADER.unpack(ph)[2] == protocol.ACT_OK:
            np.testing.assert_allclose(protocol.decode_action(pp), protocol.decode_action(jp),
                                       rtol=0, atol=1e-5)
        else:
            assert pp == jp, (ph, pp, jp)
    types = [protocol.HEADER.unpack(h)[2] for h, _ in replies["port"]]
    assert types == [protocol.ACT_OK] * 12 + [protocol.ERROR] * 2 + [
        protocol.FEEDBACK_OK, protocol.ERROR]
    assert _keys(health["port"]) == _keys(health["jax"])


def test_raw_socket_reply_bytes_pinned(server):
    """Handcrafted request bytes in, the exact reply header layout out."""
    with socket.create_connection(("127.0.0.1", server.port), timeout=5) as c:
        c.sendall(protocol.HEADER.pack(protocol.MAGIC, 1, protocol.HEALTHZ, 77, 0))
        hdr = protocol.recv_exact(c, protocol.HEADER.size)
        magic, ver, typ, rid, ln = protocol.HEADER.unpack(hdr)
        assert (magic, ver, typ, rid) == (protocol.MAGIC, 1, protocol.HEALTHZ_OK, 77)
        snap = json.loads(protocol.recv_exact(c, ln))
        assert snap["status"] in ("ok", "degraded") and "netio" in snap
        payload = protocol.encode_act(np.zeros(4, np.float32), 0)
        c.sendall(protocol.HEADER.pack(protocol.MAGIC, 1, protocol.ACT, 78, len(payload))
                  + payload)
        hdr = protocol.recv_exact(c, protocol.HEADER.size)
        magic, ver, typ, rid, ln = protocol.HEADER.unpack(hdr)
        assert (magic, ver, typ, rid, ln) == (protocol.MAGIC, 1, protocol.ACT_OK, 78, 8)
        assert protocol.decode_action(protocol.recv_exact(c, ln)).shape == (2,)
    with socket.create_connection(("127.0.0.1", server.port), timeout=5) as c:
        c.sendall(b"XY" + bytes(14))
        expected = encode_frame(protocol.ERROR, 0, b"bad magic b'XY'")
        got = b""
        while len(got) < len(expected):
            chunk = c.recv(4096)
            if not chunk:
                break
            got += chunk
        assert got == expected
        assert c.recv(4096) == b""  # FIN after the notice


# ------------------------------------------------------- server mechanics
def test_roundtrip_and_pipelining_match_the_direct_forward(server):
    obs = np.random.default_rng(4).normal(size=(16, 4)).astype(np.float32)
    with _client(server) as c:
        one = c.act(obs[0])
        futs = [c.act_async(o) for o in obs]
        got = np.stack([f.result(TIMEOUT) for f in futs])
    ref = _forward(_actor(), obs)
    np.testing.assert_allclose(one, ref[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_healthz_schema(server):
    with _client(server) as c:
        c.act(np.zeros(4, np.float32))
        h = c.healthz()
    assert h["status"] == "ok"
    assert h["obs_dim"] == 4 and h["action_dim"] == 2
    assert h["replies_ok"] >= 1 and h["requests_total"] >= 1
    assert h["compile_count"] == len(h["buckets"])
    assert set(h["stage_ms"]) == {"assemble", "device_infer", "reply"}
    assert server.batcher.replays == server.stats.batches_total


def test_malformed_frame_gets_error_reply_and_close(server):
    before = server.stats.protocol_errors
    with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
        s.sendall(b"GARBAGE-NOT-A-FRAME" + bytes(16))
        msg_type, _, payload = protocol.read_frame(s)
        assert msg_type == protocol.ERROR and b"magic" in payload
        assert s.recv(1) == b""  # server closed the connection
    assert server.stats.protocol_errors == before + 1
    with _client(server) as c:  # still healthy for the next client
        assert c.act(np.zeros(4, np.float32)).shape == (2,)


def test_wrong_obs_size_and_oversize_are_refused(server):
    with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
        write_frame(s, protocol.ACT, 5, protocol.encode_act(np.zeros(9, np.float32)))
        msg_type, _, payload = protocol.read_frame(s)
        assert msg_type == protocol.ERROR and b"obs_dim" in payload
    with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
        s.sendall(protocol.HEADER.pack(protocol.MAGIC, protocol.PROTOCOL_VERSION, protocol.ACT,
                                       1, protocol.MAX_PAYLOAD + 1))
        msg_type, _, payload = protocol.read_frame(s)
        assert msg_type == protocol.ERROR and b"max" in payload


def test_client_disconnect_mid_request_does_not_poison_server(server):
    dropped_before = server.stats.dropped_replies
    s = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    write_frame(s, protocol.ACT, 9, protocol.encode_act(np.zeros(4, np.float32)))
    s.close()  # gone before the reply
    deadline = time.time() + 5
    while server.stats.dropped_replies == dropped_before and time.time() < deadline:
        time.sleep(0.01)
    with _client(server) as c:
        assert c.act(np.zeros(4, np.float32)).shape == (2,)


def _slow(srv, delay_s):
    real = srv.batcher._infer

    def slow(*args):
        time.sleep(delay_s)
        return real(*args)

    srv.batcher._infer = slow


def test_queue_full_shedding_over_socket():
    srv = _server(max_batch=2, max_wait_us=0, queue_limit=2)
    _slow(srv, 0.3)
    try:
        with _client(srv) as c:
            futs = [c.act_async(np.zeros(4, np.float32)) for _ in range(12)]
            outcomes = {"ok": 0, "queue_full": 0}
            for f in futs:
                try:
                    f.result(60)
                    outcomes["ok"] += 1
                except Overloaded as e:
                    assert e.reason == "queue_full"
                    outcomes["queue_full"] += 1
            assert outcomes["queue_full"] >= 1 and outcomes["ok"] >= 2, outcomes
        assert srv.stats.shed_queue_full >= 1
    finally:
        srv.drain()


def test_hot_reload_during_live_traffic(tmp_path):
    """Params swap mid-traffic: every reply is the old or the new
    forward, none dropped, no recapture; every request sent after
    check_reload() returned gets the new params."""
    d = str(tmp_path / "hot")
    old = _actor(1)
    export_bundle(d, CFG, old)
    srv = _server(load_bundle(d), max_batch=4, max_wait_us=500, queue_limit=64,
                  watch_bundle=True, poll_interval_s=3600.0)
    try:
        obs = np.full(4, 0.3, np.float32)
        new = _actor(1)
        with torch.no_grad():
            for p in new.parameters():
                p.add_(0.5)
        ref_old, ref_new = _forward(old, obs[None])[0], _forward(new, obs[None])[0]
        captures = srv.batcher.compile_count
        results, errors, stop = [], [], threading.Event()

        def traffic():
            try:
                with _client(srv) as c:
                    while not stop.is_set():
                        results.append(c.act(obs, timeout=TIMEOUT))
            except Exception as e:  # surfaced below
                errors.append(e)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()
        time.sleep(0.15)  # traffic flowing on old params
        export_bundle(d, CFG, new)
        _bump_mtime(d, 2)
        assert srv.check_reload() is True
        with _client(srv) as c:
            after = c.act(obs)
        time.sleep(0.15)  # traffic flowing on new params
        stop.set()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive() and not errors, errors
        assert srv.batcher.compile_count == captures  # zero recaptures
        assert srv.batcher.rebound_params() == []  # copied into the captured ones
        assert srv.stats.params_reloads == 1
        np.testing.assert_allclose(after, ref_new, rtol=1e-5, atol=1e-6)
        n_old = n_new = 0
        for a in results:
            if np.allclose(a, ref_old, atol=1e-5):
                n_old += 1
            elif np.allclose(a, ref_new, atol=1e-5):
                n_new += 1
            else:
                raise AssertionError(f"reply matches neither param set: {a}")
        assert n_old >= 1 and n_new >= 1, (n_old, n_new)
    finally:
        srv.drain()


def test_bundle_reload_swaps_obs_norm_and_refuses_config_change(tmp_path):
    d = str(tmp_path / "b")
    actor = _actor(2)
    stats0 = {"count": 4.0, "mean": [0.0] * 4, "m2": [4.0] * 4}
    export_bundle(d, CFG, actor, obs_norm_state=stats0)
    srv = _server(load_bundle(d), max_batch=2, max_wait_us=100, watch_bundle=True,
                  poll_interval_s=3600.0)
    try:
        obs = np.full(4, 2.0, np.float32)
        with _client(srv) as c:
            a0 = c.act(obs)
            stats1 = {"count": 4.0, "mean": [1.5] * 4, "m2": [1.0] * 4}
            export_bundle(d, CFG, actor, obs_norm_state=stats1)
            _bump_mtime(d, 2)
            assert srv.check_reload() is True
            a1 = c.act(obs)
            assert not np.allclose(a0, a1)
            np.testing.assert_allclose(a1, _forward(actor, obs[None], stats1)[0],
                                       rtol=1e-5, atol=1e-6)
            other = D4PGConfig(obs_dim=4, action_dim=2, hidden_sizes=(16, 16))
            export_bundle(d, other, Actor(4, 2, (16, 16)), obs_norm_state=stats1)
            _bump_mtime(d, 4)
            assert srv.check_reload() is False
            assert srv.healthz()["last_reload"].startswith("failed: agent config changed")
            np.testing.assert_allclose(c.act(obs), a1, rtol=1e-5, atol=1e-6)
    finally:
        srv.drain()


def test_watch_run_reloads_a_port_runs_best_actor(tmp_path):
    """--watch-run: a new best_eval.json (best_actor.npz already on disk,
    written by the port's trainer code) swaps serving params."""
    run = tmp_path / "run"
    new = _actor(5)
    save_best_actor(str(run), new)
    srv = _server(max_batch=2, max_wait_us=100, watch_run=str(run))
    try:
        assert srv.check_reload() is False  # no best_eval.json yet
        with open(run / "best_eval.json", "w") as f:
            json.dump({"step": 7, "eval_return_mean": 1.0, "env_steps": 10}, f)
        assert srv.check_reload() is True
        obs = np.full(4, -0.2, np.float32)
        with _client(srv) as c:
            np.testing.assert_allclose(c.act(obs), _forward(new, obs[None])[0],
                                       rtol=1e-5, atol=1e-6)
        assert srv.healthz()["last_reload"] == "ok: best_actor.npz"
    finally:
        srv.drain()


def test_healthz_reports_degraded_after_failed_reload(tmp_path):
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    srv = _server(max_batch=4, watch_run=str(run))
    try:
        h = srv.healthz()
        assert h["status"] == "ok" and h["last_reload"] is None and h["draining"] is False
        (run / "best_eval.json").write_text('{"eval_return_mean": 1.0}')
        (run / "checkpoints" / "best_actor.npz").write_bytes(b"not an npz")
        assert srv.check_reload() is False
        h = srv.healthz()
        assert h["status"] == "degraded" and h["last_reload"].startswith("failed")
        save_best_actor(str(run), _actor(6))
        st = os.stat(run / "best_eval.json")
        os.utime(run / "best_eval.json", (st.st_atime, st.st_mtime + 5))
        assert srv.check_reload() is True
        h = srv.healthz()
        assert h["status"] == "ok" and h["last_reload"].startswith("ok")
    finally:
        srv.drain()


def test_drain_sheds_new_answers_admitted():
    srv = _server(max_batch=2, max_wait_us=0, queue_limit=32)
    _slow(srv, 0.05)
    obs = np.zeros(4, np.float32)
    drainer = threading.Thread(target=srv.drain, daemon=True)
    try:
        with _client(srv) as c:
            futs = [c.act_async(obs) for _ in range(8)]
            time.sleep(0.02)
            drainer.start()
            ok = 0
            for f in futs:
                try:
                    f.result(TIMEOUT)
                    ok += 1
                except Overloaded as e:
                    assert e.reason in ("draining", "queue_full")
                except Exception:
                    pass  # connection torn at the tail of the drain
            drainer.join(timeout=TIMEOUT)
            assert not drainer.is_alive()
            assert ok >= 1  # admitted work was answered, not dropped
    finally:
        if drainer.ident is None:  # failed before the drain began
            srv.drain()
        drainer.join(timeout=TIMEOUT)
    assert not srv._loop._thread.is_alive()
    with pytest.raises((ShedError, RuntimeError)):
        srv.batcher.submit(obs)


def test_two_policies_route_on_policy_id_and_capture_separately(tmp_path):
    cheetah_cfg = D4PGConfig(obs_dim=17, action_dim=6, hidden_sizes=(32, 32))
    cheetah = Actor(17, 6, (32, 32), generator=torch.Generator().manual_seed(8))
    export_bundle(str(tmp_path), cheetah_cfg, cheetah)
    srv = _server(max_batch=4, max_wait_us=200, policies={"cheetah": load_bundle(str(tmp_path))})
    try:
        obs = np.random.default_rng(9).normal(size=17).astype(np.float32)
        with _client(srv) as c:
            a = c.act(obs, policy_id="cheetah")
            with pytest.raises(Exception, match="unknown policy"):
                c.act(obs, policy_id="nope")
            d = c.act(np.zeros(4, np.float32))
        np.testing.assert_allclose(a, _forward(cheetah, obs[None])[0], rtol=1e-5, atol=1e-6)
        assert d.shape == (2,)
        h = srv.healthz()
        assert h["compile_count"] == 2 * 3 and set(h["policies"]) == {"default", "cheetah"}
        assert h["policies"]["cheetah"]["compile_count"] == 3
        assert srv.batcher.timers is not srv.policies["cheetah"].timers
    finally:
        srv.drain()


def test_metrics_rows_and_the_capture_budget_at_drain(tmp_path):
    """``log_dir`` rows go through the port's MetricsLogger (the extra
    policy under its ``policy_<id>_`` prefix); with ``debug_guards`` a
    drain after a parameter was rebound, not copied into, raises: the
    graphs would serve the old weights."""
    cheetah = Actor(17, 6, (32, 32), generator=torch.Generator().manual_seed(8))
    export_bundle(str(tmp_path / "hc"), D4PGConfig(obs_dim=17, action_dim=6,
                                                   hidden_sizes=(32, 32)), cheetah)
    srv = _server(max_batch=4, log_dir=str(tmp_path / "log"), metrics_interval_s=3600.0,
                  debug_guards=True, replica_id=3,
                  policies={"cheetah": load_bundle(str(tmp_path / "hc"))})
    try:
        with _client(srv) as c:
            c.act(np.zeros(4, np.float32))
    finally:
        srv.drain()  # every parameter still the captured one: no raise
    (row,) = [json.loads(line) for line in open(tmp_path / "log" / "metrics.jsonl")]
    assert row["replies_ok"] == 1.0 and row["replica_id"] == 3.0
    assert row["policy_cheetah_replies_ok"] == 0.0
    srv = _server(max_batch=4, debug_guards=True)
    actor = srv.batcher._actor
    fresh = {k: v + 0.25 for k, v in actor.state_dict().items()}
    actor.load_state_dict(fresh, assign=True)  # a reload that rebinds
    assert srv.batcher.rebound_params() == sorted(fresh)
    with pytest.raises(RuntimeError, match="rebound after capture"):
        srv.drain()


# ------------------------------------------------------ client retry, Backoff
@pytest.mark.parametrize("kw", [
    dict(jitter=0.0),
    dict(jitter=0.5, max_s=3.0, max_attempts=6),
    dict(jitter=0.25, factor=3.0, base_s=0.05),
], ids=["exact", "jitter_capped", "jitter_factor3"])
def test_backoff_schedule_matches_the_reference(kw):
    """The port's Backoff against JAX's, both seeded alike: the same
    delays, the same end of the attempt budget, the same sleeps between
    the iterator's attempts, and the monotonic deadline."""
    import random

    from d4pg_tpu.utils.retry import Backoff as JBackoff
    from d4pg_tpu_torch.utils.retry import Backoff

    def pair(**extra):
        return [cls(**kw, **extra, rng=random.Random(11))
                for cls in (Backoff, JBackoff)]

    mine, ref = pair()
    assert [mine.next_delay() for _ in range(10)] == [ref.next_delay() for _ in range(10)]
    mine_slept, ref_slept = [], []
    mine, ref = pair(sleep=mine_slept.append)[0], pair(sleep=ref_slept.append)[1]
    assert list(mine) == list(ref) and mine_slept == ref_slept
    now = [0.0]
    mine = Backoff(**kw, deadline_s=1.0, clock=lambda: now[0])
    assert mine.next_delay() is not None
    now[0] = 1.0
    assert mine.next_delay() is None


class _ScriptedBackend:
    """Speaks the wire protocol for the client's retry path: each accepted
    connection runs one script — ``"reset"`` takes one request and closes
    abortively, a list answers its ACTs in turn with ``"shed"`` (an
    OVERLOADED reply) or ``"ok"`` (a zero action)."""

    def __init__(self, scripts):
        self._sock = socket.create_server(("127.0.0.1", 0))
        self.port = self._sock.getsockname()[1]
        self._scripts = list(scripts)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for script in self._scripts:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with conn:
                try:
                    if script == "reset":
                        with conn.makefile("rb") as rfile:  # its fd ref goes first
                            read_frame(rfile)
                        protocol.abortive_close(conn)
                        continue
                    rfile, replies = conn.makefile("rb"), list(script)
                    while (frame := read_frame(rfile)) is not None:
                        kind = replies.pop(0) if replies else "ok"
                        if kind == "shed":
                            write_frame(conn, protocol.OVERLOADED, frame[1], b"queue_full")
                        else:
                            write_frame(conn, protocol.ACT_OK, frame[1],
                                        protocol.encode_action(np.zeros(2, np.float32)))
                except OSError:
                    pass

    def close(self):
        self._sock.close()
        self._thread.join(timeout=TIMEOUT)


@pytest.mark.parametrize("scripts, retries, outcome", [
    ([["shed", "ok"]], 0, Overloaded),
    ([["shed", "shed", "ok"]], 2, "ok"),
    ([["shed"] * 8], 1, Overloaded),
    (["reset", ["ok"]], 3, "ok"),
], ids=["off_fast_fails", "rides_through_shed", "budget_bounded", "redials_dead_link"])
def test_client_bounded_retry(scripts, retries, outcome):
    """``retries=`` is off by default (a shed surfaces), rides through
    sheds within its budget, surfaces the last one past it, and re-dials a
    link that died mid-request — the JAX client's contract."""
    backend = _ScriptedBackend(scripts)
    try:
        with PolicyClient("127.0.0.1", backend.port, timeout=TIMEOUT, retries=retries,
                          retry_seed=0) as c:
            if outcome == "ok":
                np.testing.assert_array_equal(c.act(np.zeros(4, np.float32)), np.zeros(2))
            else:
                with pytest.raises(outcome):
                    c.act(np.zeros(4, np.float32))
    finally:
        backend.close()


# -------------------------------------------------------------------- netio
def _deadline_wait(pred, timeout_s=8.0, tick=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(tick)
    return bool(pred())


class _EchoLoop:
    """A FrameLoop that echoes every frame back."""

    def __init__(self, on_open=None, **loop_kw):
        self.loop = FrameLoop(name="test-io", **loop_kw)
        sock = socket.create_server(("127.0.0.1", 0))
        self.port = sock.getsockname()[1]
        self.loop.serve(sock, on_frame=lambda conn, t, r, p: conn.send(t, r, p), on_open=on_open)
        self.loop.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.loop.close(flush_timeout_s=2.0)

    def connect(self, timeout=5.0):
        c = socket.create_connection(("127.0.0.1", self.port), timeout=timeout)
        c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return c


def _tiny_sndbuf(conn):
    conn.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)


def test_loop_echo_roundtrip_blocking_client():
    with _EchoLoop() as srv:
        with srv.connect() as c:
            sent = [(protocol.ACT, 1, b"\x00" * 24), (protocol.HEALTHZ, 2, b""),
                    (protocol.ACT2, 3, bytes(range(256)) * 64)]
            for f in sent:
                write_frame(c, *f)
            assert [read_frame(c) for _ in sent] == sent
        assert _deadline_wait(lambda: srv.loop.stats()["frames_out"] == 3), srv.loop.stats()
        assert srv.loop.stats()["frames_in"] == 3
        assert _deadline_wait(lambda: srv.loop.stats()["conns_open"] == 0)


def test_loop_protocol_error_replies_then_closes():
    with _EchoLoop() as srv:
        with srv.connect() as good, srv.connect() as bad:
            bad.sendall(b"XX" + b"\x00" * 14)
            assert read_frame(bad) == (protocol.ERROR, 0, b"bad magic b'XX'")
            assert read_frame(bad) is None  # FIN after the notice
            write_frame(good, protocol.ACT, 7, b"still here")
            assert read_frame(good) == (protocol.ACT, 7, b"still here")


def test_loop_slowloris_partial_frame_evicted():
    with _EchoLoop(read_stall_s=0.3) as srv:
        with srv.connect() as c:
            c.sendall(encode_frame(protocol.ACT, 1, b"\x00" * 64)[:10])
            t, r, p = read_frame(c)
            assert (t, r) == (protocol.ERROR, 0) and p.startswith(b"read stall")
            assert read_frame(c) is None
        assert srv.loop.stats()["evicted_read_stall"] == 1


@pytest.mark.parametrize("bound", ["watermark", "write_stall"])
def test_loop_zero_window_peer_evicted(bound):
    """A peer that stops draining while replies pile up: evicted by the
    write-buffer watermark, or (watermark out of reach) by the
    write-progress deadline."""
    kw = (dict(write_buffer_limit=1 << 16, write_stall_s=30.0) if bound == "watermark"
          else dict(write_stall_s=0.4))
    size, count = (1 << 14, 64) if bound == "watermark" else (1 << 12, 16)
    with _EchoLoop(on_open=_tiny_sndbuf, **kw) as srv:
        with srv.connect() as c:
            c.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
            c.sendall(b"".join(encode_frame(protocol.ACT, i, b"\x00" * size)
                               for i in range(count)))
            assert _deadline_wait(lambda: srv.loop.stats()["evicted_write_stall"] >= 1), \
                srv.loop.stats()


# ---------------------------------------------------------------------- CLI
def test_serve_cli_subprocess_serves_then_drains_on_sigterm(tmp_path):
    export_bundle(str(tmp_path), CFG, _actor(7))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "d4pg_tpu_torch.serve", "--device", "cpu", "--bundle",
         str(tmp_path), "--port", "0", "--max-batch", "4"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("[serve] listening on 127.0.0.1:"), line
        port = int(line.split()[3].rsplit(":", 1)[1])
        with PolicyClient("127.0.0.1", port, timeout=TIMEOUT) as c:
            a = c.act(np.full(4, 0.1, np.float32))
        np.testing.assert_allclose(a, _forward(_actor(7), np.full((1, 4), 0.1))[0],
                                   rtol=1e-5, atol=1e-6)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "[serve] drained: 1 served, 0 shed" in out, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
