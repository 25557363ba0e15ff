"""The port's chaos harness (``d4pg_tpu_torch/chaos.py``,
``d4pg_tpu_torch/netio/attack.py``) held against the JAX package's, and
the recovery paths its sites prove on the port: the pool's supervisor
under ``env_raise`` / ``worker_kill`` with the flusher stalled
(``wb_stall``) and every guard green, the verified restore's fallback
under ``ckpt_truncate``, and the server under ``sock_reset`` and the
connection attacks.
"""

from __future__ import annotations

import json
import os
import resource
import shutil
import signal
import subprocess
import sys
import time
from collections import deque

import numpy as np
import pytest
import torch

from d4pg_tpu import chaos as jchaos
from d4pg_tpu_torch import chaos
from d4pg_tpu_torch.analysis import flowledger, lockwitness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = "seed=3;env_raise@5#0;worker_kill@9#1;wb_stall@1:0.2"


def _entries(plan):
    return [(e.site, e.at, e.arg, e.actor, e.label, str(e)) for e in plan.entries]


# ------------------------------------------------------------------ the plan
# the JAX tests' specs (tests/test_chaos.py), and the whole site list
SPECS = [
    "seed=7; env_raise@40 ; env_hang@60:30#0, worker_kill@12#1;"
    "ckpt_truncate@1;wb_stall@3:0.5;sock_reset@5",
    "tenant_flood@30:bulky;policy_skew@40;scaledown_during_canary@3",
    "tenant_flood@1:42",
    "seed=7;env_raise@40;env_hang@9#1",
    "env_raise@4#0;env_hang@6:2#1;worker_kill@2#0",
    "worker_kill@5#0;env_raise@5#1",
    PLAN + ";ckpt_truncate@1",
    "sock_reset@5;slowloris@2:4;zero_window@3:1500;fd_exhaust@5:150",
    ";".join(f"{s}@{i + 1}" for i, s in enumerate(jchaos.KNOWN_SITES)),
]
BAD = ["boom@3", "env_raise@zero", "env_raise@0", "env_raise", "@3",
       "policy_skew@2:notanumber", "worker_kill@5#0;worker_kill@5#1", "kill@3",
       "wb_stall@1:x#2", "seed=x;wb_stall@1"]


def test_known_sites_are_the_jax_sites():
    assert chaos.KNOWN_SITES == jchaos.KNOWN_SITES
    assert chaos.WORKER_SITES == jchaos.WORKER_SITES
    assert chaos.LABEL_ARG_SITES == jchaos.LABEL_ARG_SITES


@pytest.mark.parametrize("spec", SPECS)
def test_plan_parses_as_the_jax_plan_parses(spec):
    ours, ref = chaos.ChaosPlan.parse(spec), jchaos.ChaosPlan.parse(spec)
    assert ours.seed == ref.seed and _entries(ours) == _entries(ref)
    for n in (2, 3, 16):
        try:
            r_ref = ref.resolve_actors(n)
        except ValueError as e:
            with pytest.raises(ValueError, match="targets actor") as ei:
                ours.resolve_actors(n)
            assert str(ei.value) == str(e)
            continue
        r_ours = ours.resolve_actors(n)
        assert _entries(r_ours) == _entries(r_ref)
        for actor in range(n):
            assert r_ours.worker_entries(actor) == r_ref.worker_entries(actor)


@pytest.mark.parametrize("bad", BAD)
def test_malformed_plans_raise_the_jax_words(bad):
    with pytest.raises(ValueError) as ref:
        jchaos.ChaosPlan.parse(bad)
    with pytest.raises(ValueError) as ours:
        chaos.ChaosPlan.parse(bad)
    assert str(ours.value) == str(ref.value)


def test_injector_ticks_as_the_jax_injector():
    spec = "wb_stall@3;wb_stall@5:0.1;sock_reset@1;slowloris@2:4"
    ours = chaos.ChaosInjector(chaos.ChaosPlan.parse(spec))
    ref = jchaos.ChaosInjector(jchaos.ChaosPlan.parse(spec))
    for site in ["wb_stall"] * 8 + ["sock_reset"] * 3 + ["slowloris"] * 3 + ["host_kill"]:
        a, b = ours.tick(site), ref.tick(site)
        assert (a is None) == (b is None) and (a is None or str(a) == str(b))
    assert ours.summary() == ref.summary() == {"chaos_injections": 4, "chaos_pending": 0}
    assert ours.injections_total == 4


# ----------------------------------------------------- ckpt_truncate, resume
def _train_config(tmp_path, **kw):
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.config import TrainConfig

    base = dict(num_envs=2, batch_size=8, warmup_steps=64, total_steps=8, eval_interval=8,
                eval_episodes=1, replay_capacity=512, checkpoint_interval=4,
                log_dir=str(tmp_path), agent=D4PGConfig(hidden_sizes=(16, 16)))
    base.update(kw)
    return TrainConfig(**base)


def test_truncated_step_makes_the_verified_restore_fall_back_one_step(tmp_path):
    """``ckpt_truncate@2`` cuts the newest of two committed steps (the JAX
    victim rule: the largest file, halved); the resume leg's verified
    restore falls back to the older one, says so in its rows, and trains
    on."""
    import dataclasses

    from d4pg_tpu_torch.runtime.trainer import Trainer

    cfg = _train_config(tmp_path, chaos="ckpt_truncate@2")
    t = Trainer(cfg, device="cpu")
    try:
        t.train()
        assert t._chaos.injections_total == 1
    finally:
        t.close()
    step_dir = t.ckpt.step_dir(8)
    # the port's victim is the JAX function's on a copy of the same step
    mirror = tmp_path / "mirror"
    shutil.copytree(t.ckpt.step_dir(4), mirror)
    sizes = {p: os.path.getsize(os.path.join(mirror, p)) for p in os.listdir(mirror)}
    victim = jchaos.truncate_checkpoint_step(str(mirror))
    assert os.path.basename(victim) == "state.pt"
    assert os.path.getsize(victim) == sizes["state.pt"] // 2
    assert os.path.getsize(os.path.join(step_dir, "state.pt")) == os.path.getsize(victim)
    t2 = Trainer(dataclasses.replace(cfg, resume=True, chaos=None), device="cpu")
    try:
        assert t2._ckpt_fallbacks == 1 and t2.grad_steps == 4
        row = t2.train(total_steps=4)
        assert row["checkpoint_fallbacks"] == 1.0 and np.isfinite(row["critic_loss"])
        assert t2.grad_steps == 8
    finally:
        t2.close()


def test_host_kill_is_refused_by_name_with_several_processes(tmp_path):
    from d4pg_tpu_torch.config import check_chaos

    with pytest.raises(ValueError, match="host_kill_needs_supervisor"):
        check_chaos(_train_config(tmp_path, chaos="host_kill@2:1", num_processes=2))
    check_chaos(_train_config(tmp_path, chaos="host_kill@2:1"))  # one process: accepted
    check_chaos(_train_config(tmp_path, chaos="wb_stall@1", num_processes=2))


# ------------------------------------------------ the pool, the flusher, guards
def _pool_config(mod, tmp_path, tag, **kw):
    base = dict(env="Pendulum-v1", num_envs=2, total_steps=40, warmup_steps=40,
                batch_size=16, replay_capacity=2_000, eval_interval=40, eval_episodes=1,
                max_episode_steps=20, checkpoint_interval=100_000, pool_start_method="fork",
                pool_step_timeout_s=10.0, async_priority_writeback=True, debug_guards=True,
                chaos=PLAN, log_dir=str(tmp_path / tag))
    base.update(kw)
    cfg_mod = __import__(f"{mod}.config", fromlist=["TrainConfig"])
    state_mod = __import__(f"{mod}.agent.state", fromlist=["D4PGConfig"])
    return cfg_mod.TrainConfig(agent=state_mod.D4PGConfig(hidden_sizes=(16, 16)), **base)


def _chaos_books(t) -> dict:
    return {"chaos_injections": t._chaos.injections_total,
            "failures": t.pool.failures_total, "restarts": t.pool.restarts_total}


@pytest.fixture
def witness():
    lockwitness.reset()
    lockwitness.enable()
    yield
    lockwitness.reset()


def test_chaos_train_run_completes_with_guards_green_as_the_jax_run(tmp_path, witness, capsys):
    """The JAX acceptance gate (``test_chaos_train_run_completes_with_guards_
    green``) on the port: a pool run under env_raise, worker_kill and
    wb_stall with debug_guards takes every budgeted step, reports the
    injections in its rows and ends with no ledger trip, no hold left and
    no lock-order contradiction. The JAX trainer on the same plan, config
    and pool seed counts the same injections, failures and restarts."""
    pytest.importorskip("gymnasium")
    from d4pg_tpu.config import apply_env_preset as j_preset
    from d4pg_tpu.runtime.trainer import Trainer as JTrainer
    from d4pg_tpu_torch.runtime.trainer import Trainer

    t = Trainer(_pool_config("d4pg_tpu_torch", tmp_path, "port"), device="cpu")
    try:
        out = t.train()
        assert t.grad_steps == 40  # every budgeted step
        assert np.isfinite(out["critic_loss"])
        assert t.pool.failures_total >= 2 and t.pool.restarts_total >= 1
    finally:
        t.close()
    ours = _chaos_books(t)
    assert t._ledger.stats()["trips"] == 0
    assert t._ledger.stats()["active_holds"] == 0
    assert t._ledger.stats()["writes"] > 0  # the pool's and the PER slots were policed
    assert "0 contradictions" in capsys.readouterr().out
    with open(tmp_path / "port" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert any(r.get("chaos_injections") == ours["chaos_injections"] for r in rows)
    assert any(r.get("pool_worker_restarts", 0) >= 1 for r in rows)

    jt = JTrainer(j_preset(_pool_config("d4pg_tpu", tmp_path, "jax")))
    try:
        jt.train()
    finally:
        jt.close()
    assert ours == _chaos_books(jt) == {"chaos_injections": 2, "failures": 2, "restarts": 2}


# ------------------------------------------------------------------- serving
def _export(tmp_path):
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.models.actor import Actor
    from d4pg_tpu_torch.serve.bundle import export_bundle

    cfg = D4PGConfig(obs_dim=4, action_dim=2, hidden_sizes=(32, 32))
    actor = Actor(4, 2, (32, 32), generator=torch.Generator().manual_seed(7))
    export_bundle(str(tmp_path), cfg, actor)
    return cfg, actor


def test_sock_reset_under_guards_drains_clean(tmp_path, capsys):
    """The server under ``sock_reset@3`` with every guard armed: the reset
    connection's client sees it, a fresh one is served, and the drain's
    witness and serve-stats identity pass."""
    from d4pg_tpu_torch.serve.bundle import load_bundle
    from d4pg_tpu_torch.serve.client import ConnectionClosed, PolicyClient
    from d4pg_tpu_torch.serve.server import PolicyServer

    _export(tmp_path)
    lockwitness.reset()
    lockwitness.enable()
    flowledger.enable()
    try:
        srv = PolicyServer(load_bundle(str(tmp_path)), port=0, device="cpu", max_batch=4,
                           watch_bundle=False, debug_guards=True,
                           chaos=chaos.ChaosInjector(chaos.ChaosPlan.parse("sock_reset@3")))
        srv.start()
        served = 0
        with PolicyClient("127.0.0.1", srv.port, timeout=30) as c:
            for _ in range(2):
                c.act(np.zeros(4, np.float32))
                served += 1
            with pytest.raises((ConnectionClosed, ConnectionError, OSError)):
                c.act(np.zeros(4, np.float32))  # the 3rd frame: reset
        with PolicyClient("127.0.0.1", srv.port, timeout=30) as c:
            c.act(np.zeros(4, np.float32))
            served += 1
            assert c.healthz()["chaos_injections"] == 1
        srv.drain()
        assert srv.ledger.stats() == {"writes": served, "trips": 0, "active_holds": 0}
    finally:
        lockwitness.reset()
        flowledger.reset()
    out = capsys.readouterr().out
    verdict = json.loads(out.split("[flow-verdict] ", 1)[1].splitlines()[0])
    assert verdict["ok"] and verdict["counters"]["replies_ok"] == served
    assert "0 contradictions" in out


SERVE_PLAN = "sock_reset@5;slowloris@2:4;zero_window@3:30000;fd_exhaust@40:2000"
HELD = 64  # client connections kept open through the attacks
BURST = 8  # the first round's connections


def _limit_fds():
    # fd_exhaust hoards descriptors up to the soft limit: keep it small
    resource.setrlimit(resource.RLIMIT_NOFILE,
                       (1024, resource.getrlimit(resource.RLIMIT_NOFILE)[1]))


def test_serve_cli_under_attack_keeps_serving_and_drains_clean(tmp_path):
    """``python -m d4pg_tpu_torch.serve --debug-guards --chaos`` with
    sock_reset and the three connection attacks, short stall bounds: the
    client whose 5th frame is reset reconnects and is served, the
    attackers are evicted or shed, healthz counts the injections, and
    SIGTERM drains with the serve-stats identity and the lock witness
    clean (rc 0). The zero-window attacker gets up to 30 s: a loopback
    send buffer absorbs ~3 MB of its unread replies before the
    write-progress clock can start."""
    from d4pg_tpu_torch.serve.client import PolicyClient

    _export(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "d4pg_tpu_torch.serve", "--device", "cpu", "--bundle",
         str(tmp_path), "--port", "0", "--max-batch", "4", "--debug-guards",
         "--io-read-stall-s", "0.5", "--io-write-stall-s", "0.5",
         "--chaos", SERVE_PLAN],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=_limit_fds)
    try:
        line = proc.stdout.readline()
        assert line.startswith("[serve] listening on 127.0.0.1:"), line
        port = int(line.split()[3].rsplit(":", 1)[1])
        obs = np.zeros(4, np.float32)
        with PolicyClient("127.0.0.1", port, timeout=10) as c:
            for _ in range(4):
                c.act(obs)
            with pytest.raises(RuntimeError):  # the 5th frame: reset
                c.act(obs)
        # Fresh connections tick the accept sites (slowloris at the 2nd
        # accept, zero_window the 3rd, fd_exhaust the 40th, late enough that
        # the zero-window attacker's own connection is in): a first burst
        # of BURST, then pairs. The last HELD connections stay open, so no
        # close frees an fd during the hoard and the accepts after it are
        # shed.
        answered, failed, held, net = 0, 0, deque(), {}
        t_end = time.monotonic() + 30.0
        burst = BURST
        while time.monotonic() < t_end and not (
                net.get("evicted_read_stall") and net.get("evicted_write_stall")
                and net.get("accept_shed") and answered >= 30):
            pair = []
            try:
                for _ in range(burst):
                    pair.append(PolicyClient("127.0.0.1", port, timeout=10))
                for c in pair:
                    c.act(obs)
                    answered += 1
                net = pair[0].healthz()["netio"]
            except (OSError, RuntimeError):
                failed += 1
            held.extend(pair)
            while len(held) > HELD:
                held.popleft().close()
            burst = 2
        for c in held:
            c.close()
        with PolicyClient("127.0.0.1", port, timeout=10) as c:
            health = c.healthz()
        net = health["netio"]
        assert answered >= 30 and failed >= 1, (answered, failed)
        assert health["chaos_injections"] == 4, health
        assert net["evicted_read_stall"] >= 1, net   # slowloris
        assert net["evicted_write_stall"] >= 1, net  # zero_window
        assert net["accept_shed"] >= 1, net          # fd_exhaust
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        verdicts = [json.loads(x.split("[flow-verdict] ", 1)[1])
                    for x in out.splitlines() if x.startswith("[flow-verdict] ")]
        assert verdicts and all(v["ok"] for v in verdicts), out
        assert "0 contradictions" in out, out
        ledger = [json.loads(x.split("[serve] staging ledger: ", 1)[1])
                  for x in out.splitlines() if x.startswith("[serve] staging ledger: ")]
        assert ledger and ledger[0]["trips"] == 0 and ledger[0]["active_holds"] == 0, out
        # the server's own launch counts: its forward runs no hand kernel
        launches = [json.loads(x.split("[serve] kernel launches: ", 1)[1])
                    for x in out.splitlines() if x.startswith("[serve] kernel launches: ")]
        assert launches == [dict.fromkeys(
            ("project", "fused_fwd", "fused_bwd", "tree_count", "fused_step"), 0)], out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


# --------------------------------------------------------------- fleet sites
# The seven sites of the collection fleet tick in the port's fleet modules
# where they tick in the JAX package's: each scenario runs on both packages
# (the actor, the ingest and the injector of one package) and must leave
# the same observations.
FLEET_SITES = ("partition", "reconnect_flap", "slow_link", "pixel_truncate", "stale_bundle",
               "stale_stats", "her_actor_kill")


def _fleet_pkg(jax_side: bool):
    if jax_side:
        from d4pg_tpu.fleet import actor, ingest, wire
        from d4pg_tpu.replay.uniform import ReplayBuffer
        from d4pg_tpu.serve import protocol
        return dict(actor=actor, ingest=ingest, wire=wire, buf=ReplayBuffer, protocol=protocol,
                    chaos=jchaos, jax=True)
    from d4pg_tpu_torch.fleet import actor, ingest, wire
    from d4pg_tpu_torch.replay.uniform import ReplayBuffer
    from d4pg_tpu_torch.serve import protocol
    return dict(actor=actor, ingest=ingest, wire=wire, buf=ReplayBuffer, protocol=protocol,
                chaos=chaos, jax=False)


def _fleet_bundle(path, generation=0, obs_norm=False, seed=0):
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.models.actor import Actor
    from d4pg_tpu_torch.serve.bundle import export_bundle

    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(8, 8), n_step=3)
    actor = Actor(3, 1, (8, 8), generator=torch.Generator().manual_seed(seed))
    stats = {"count": 10.0 + generation, "mean": [0.1, 0.2, 0.3], "m2": [5.0, 6.0, 7.0]} \
        if obs_norm else None
    export_bundle(str(path), cfg, actor, obs_norm_state=stats,
                  meta={"generation": generation, "stats_generation": generation,
                        "env": "Pendulum-v1"})
    # a distinct mtime for every export, however fast they follow each other
    meta = os.path.join(str(path), "bundle.json")
    os.utime(meta, ns=(time.time_ns(), time.time_ns() + generation * 10**9))


def _until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _fleet_scenario(site, pkg, tmp_path, monkeypatch):
    """Run ``site``'s scenario on one package; returns what it observed."""
    inj = pkg["chaos"].ChaosInjector(pkg["chaos"].ChaosPlan.parse(
        {"partition": "partition@2", "slow_link": "slow_link@1:50",
         "her_actor_kill": "her_actor_kill@5"}.get(site, f"{site}@1")))
    buf = pkg["buf"](256, 3, 1)
    srv = pkg["ingest"].IngestServer(
        buf, obs_dim=3, action_dim=1, n_step=3, gamma=0.99,
        chaos=inj if site == "partition" else None,
        caps=dict(obs_mode="f32", her=False, obs_norm=site == "stale_stats")).start()
    _fleet_bundle(tmp_path, obs_norm=site == "stale_stats")
    actor = pkg["actor"].FleetActor(connect=f"127.0.0.1:{srv.port}", bundle_dir=str(tmp_path),
                                    num_envs=1, seed=3, batch_windows=4,
                                    chaos=None if site == "partition" else inj)
    seen = {}
    try:
        if site == "partition":
            proto, wire_ = pkg["protocol"], pkg["wire"]
            import socket as _socket

            s = _socket.create_connection(("127.0.0.1", srv.port), timeout=5)
            proto.write_frame(s, proto.HELLO, 1, wire_.encode_hello(
                actor_id="t", env="e", obs_dim=3, action_dim=1, n_step=3, gamma=0.99,
                generation=0))
            proto.read_frame(s)
            cols = {"obs": np.ones((3, 3), np.float32), "action": np.ones((3, 1), np.float32),
                    "reward": np.ones(3, np.float32), "next_obs": np.ones((3, 3), np.float32),
                    "discount": np.ones(3, np.float32)}
            for req in (2, 3):
                proto.write_frame(s, proto.WINDOWS, req, wire_.encode_windows(0, **cols))
                try:
                    frame = proto.read_frame(s)
                    seen[f"reply_{req}"] = None if frame is None else frame[0]
                except (OSError, proto.ProtocolError):
                    seen[f"reply_{req}"] = "reset"
            s.close()
            _until(lambda: srv.counters()["connections"] == 0)
        elif site == "reconnect_flap":
            seen["first"] = actor._ensure_link()
            seen["after_flap"] = dict(actor.stats())
            actor._retry_at = 0.0
            seen["second"] = actor._ensure_link()
        elif site in ("slow_link", "pixel_truncate"):
            for _ in range(8):
                actor._step_envs()
            t0 = time.monotonic()
            seen["sent"] = actor._flush_once()
            seen["stalled"] = time.monotonic() - t0 >= 0.05
            if site == "pixel_truncate":
                if not pkg["jax"]:
                    # the torn frame dies with its connection, whole, at
                    # once: EOF mid-frame at the server (ROADMAP C-5: the
                    # JAX link keeps its socket open and the server waits)
                    assert _until(lambda: srv.counters()["connections"] == 0)
                    seen["link_dead"] = actor._link.dead is not None
                    seen["server"] = {k: srv.counters()[k]
                                      for k in ("protocol_errors", "windows_ingested")}
            else:
                _until(lambda: actor._link.inflight() == 0)
        elif site in ("stale_bundle", "stale_stats"):
            for generation in (1, 2):
                _fleet_bundle(tmp_path, generation=generation, obs_norm=site == "stale_stats",
                              seed=generation)
                actor._maybe_reload_bundle()
                seen[generation] = (actor.policy.generation, actor.policy.stats_generation,
                                    actor.spool.generation, actor.spool.stats_generation)
        elif site == "her_actor_kill":
            class Killed(Exception):
                pass

            def fake_kill(pid, sig):
                raise Killed(sig)

            monkeypatch.setattr(os, "kill", fake_kill)
            steps = 0
            with pytest.raises(Killed):
                while True:
                    actor._step_envs()
                    steps += 1
            seen["steps_before_kill"] = steps
    finally:
        if actor._link is not None:
            actor._link.close()
        for env in actor.envs:
            env.close()
        srv.close()
    # the readers book a closed connection on their own threads
    _until(lambda: srv.counters()["connections"] == 0)
    stats = actor.stats()
    seen["actor"] = {k: v for k, v in stats.items() if k != "env_steps" or site != "slow_link"}
    if site != "pixel_truncate":
        seen["ingest"] = {k: v for k, v in srv.counters().items() if k != "bytes_total"}
    seen["rows"] = len(buf)
    seen["injections"] = inj.injections_total
    return seen


@pytest.mark.parametrize("site", FLEET_SITES)
def test_fleet_sites_tick_where_the_jax_fleet_ticks_them(site, tmp_path, monkeypatch):
    assert site in chaos.KNOWN_SITES
    ours = _fleet_scenario(site, _fleet_pkg(False), tmp_path / "port", monkeypatch)
    ref = _fleet_scenario(site, _fleet_pkg(True), tmp_path / "jax", monkeypatch)
    if site == "pixel_truncate":
        assert ours.pop("link_dead") and ours.pop("server") == {
            "protocol_errors": 1, "windows_ingested": 0}
        assert ours["rows"] == 0 and ours["actor"]["windows_dropped_reconnect"] > 0
    assert ours == ref
    assert ours["injections"] == 1
