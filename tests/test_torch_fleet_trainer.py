"""The port's trainer with the collection fleet (``fleet_listen``), on the
CPU: a fleet-only learner fed by a port ``FleetActor`` thread on the host
and device placements, the generation across ``--resume``, the stall
heartbeat, a dead ingest thread in the mixed mode, and the CLI pair (the
train CLI with ``--num-envs 0 --fleet-listen 0`` beside an actor
process), each as the JAX package's ``tests/test_fleet.py`` holds its own.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.analysis import flowledger
from d4pg_tpu_torch.analysis.flow_identities import FLOW_IDENTITIES
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.fleet.actor import FleetActor
from d4pg_tpu_torch.runtime.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = D4PGConfig(hidden_sizes=(16, 16))


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _cfg(tmp_path, **kw):
    base = dict(env="pendulum", total_steps=8, warmup_steps=32, batch_size=16,
                replay_capacity=4096, eval_interval=4, eval_episodes=1, max_episode_steps=50,
                checkpoint_interval=1000, log_dir=str(tmp_path / "run"), agent=SMALL)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("placement", ["host", "device"])
def test_fleet_only_trainer_takes_its_grad_steps_on_ingested_windows(placement, tmp_path):
    kw = dict(replay_placement="device", steps_per_dispatch=4, fused_descent=True) \
        if placement == "device" else {}
    t = Trainer(_cfg(tmp_path, num_envs=0, fleet_listen=0, fleet_host="127.0.0.1",
                     fleet_bundle=str(tmp_path / "bundle"), fleet_publish_interval=4, **kw),
                device="cpu")
    stop = threading.Event()
    actor = FleetActor(connect=f"127.0.0.1:{t._fleet.port}", bundle_dir=str(tmp_path / "bundle"),
                       env_id="Pendulum-v1", num_envs=2, seed=1, batch_windows=8,
                       poll_interval_s=0.05, stop_event=stop)
    th = threading.Thread(target=actor.run, daemon=True)
    th.start()
    try:
        last = t.train()
        assert t.grad_steps == 8
        rows = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
        assert [r["step"] for r in rows] == [4, 8]
        for r in rows:
            assert r["fleet_windows_ingested"] == r["env_steps"] >= 32
            assert r["fleet_generation"] == r["step"] // 4
            assert np.isfinite(r["critic_loss"])
        assert last["fleet_protocol_errors"] == 0
        stop.set()
        th.join(30)
        acked = actor.stats()["windows_acked"]
        assert _wait(lambda: t._fleet.counters()["windows_ingested"] == acked)
        if placement == "device":
            # the ring mirrors the ingested rows as any others
            t._ring_sync.flush(t._ring)
            n = len(t.buffer)
            for k in ("obs", "action", "reward", "next_obs", "discount"):
                assert torch.equal(getattr(t._ring, k)[:n].cpu(),
                                   torch.from_numpy(getattr(t.buffer, k)[:n])), k
    finally:
        stop.set()
        th.join(30)
        t.close()
    stats = actor.stats()
    assert stats["bundle_reloads"] >= 1 and stats["generation"] >= 1
    # the actor's books balance by the port's identity table
    identity = FLOW_IDENTITIES["fleet" + "-actor"]["identity"]
    assert flowledger._evaluate(identity, stats)


def test_fleet_generation_survives_resume(tmp_path):
    def cfg(**kw):
        return _cfg(tmp_path, total_steps=4, eval_interval=1000, checkpoint_interval=4,
                    num_envs=2, fleet_listen=0, fleet_host="127.0.0.1",
                    fleet_bundle=str(tmp_path / "bundle"), fleet_publish_interval=2, **kw)

    t = Trainer(cfg(), device="cpu")
    try:
        t.train()  # publications at steps 2 and 4
        gen = t._fleet_gen
        assert gen == 2
    finally:
        t.close()
    with open(tmp_path / "run" / "checkpoints" / "trainer_meta.json") as f:
        assert json.load(f)["fleet_generation"] == gen
    r = Trainer(cfg(resume=True), device="cpu")
    try:
        assert r._fleet_gen == gen
        assert r._fleet.generation == gen  # pushed into the ingest at the publication
        with open(tmp_path / "bundle" / "bundle.json") as f:
            assert json.load(f)["meta"]["generation"] == gen
    finally:
        r.close()


def test_fleet_stall_heartbeat_warns(tmp_path, capsys):
    t = Trainer(_cfg(tmp_path, num_envs=0, fleet_listen=0, fleet_host="127.0.0.1"), device="cpu")
    try:
        t._fleet_stall_check()  # the zero-ingested baseline
        t._fleet_stall_check()  # no progress, but the interval has not passed
        assert "no windows ingested" not in capsys.readouterr().out
        t._fleet_stall_t -= 31.0
        t._fleet_stall_check()
        out = capsys.readouterr().out
        assert "no windows ingested" in out and "0 live actor" in out
    finally:
        t.close()


def test_mixed_mode_dead_ingest_thread_fails_loudly(tmp_path):
    t = Trainer(_cfg(tmp_path, total_steps=2, warmup_steps=8, batch_size=8, num_envs=2,
                     eval_interval=1000, fleet_listen=0, fleet_host="127.0.0.1"), device="cpu")
    try:
        t._fleet._thread_error = RuntimeError("boom")
        with pytest.raises(RuntimeError, match="ingest thread died"):
            t.train()
    finally:
        t.close()


def test_cli_fleet_only_learner_beside_an_actor_process(tmp_path):
    """``python -m d4pg_tpu_torch.train --device cpu --num-envs 0
    --fleet-listen 0 --fleet-bundle …`` trains on a ``python -m
    d4pg_tpu_torch.fleet.actor`` process's windows; each ends inside its
    own timeout (the actor on SIGTERM, draining, rc 0)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    bundle = tmp_path / "bundle"
    learner = subprocess.Popen(
        [sys.executable, "-m", "d4pg_tpu_torch.train", "--device", "cpu", "--env", "Pendulum-v1",
         "--num-envs", "0", "--fleet-listen", "0", "--fleet-host", "127.0.0.1",
         "--fleet-bundle", str(bundle), "--fleet-publish-interval", "4",
         "--fleet-max-gen-lag", "1", "--fleet-wire-dtype", "float32", "--hidden-sizes", "16,16",
         "--bsize", "16", "--warmup", "64", "--rmsize", "4096", "--total-steps", "8",
         "--eval-interval", "8", "--eval-episodes", "1", "--max-steps", "50",
         "--debug-guards", "--log-dir", str(tmp_path / "run")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    actor = None
    try:
        port = None
        lines = []
        for line in learner.stdout:
            lines.append(line)
            m = re.search(r"\[fleet\] ingest listening on :(\d+)", line)
            if m:
                port = int(m.group(1))
            if port is not None and (bundle / "bundle.json").exists():
                break
        assert port is not None, "".join(lines)
        actor = subprocess.Popen(
            [sys.executable, "-m", "d4pg_tpu_torch.fleet.actor", "--connect", f"127.0.0.1:{port}",
             "--bundle", str(bundle), "--env", "Pendulum-v1", "--num-envs", "2",
             "--batch-windows", "8", "--poll-interval", "0.1", "--debug-guards"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        out, _ = learner.communicate(timeout=180)
        out = "".join(lines) + out
        assert learner.returncode == 0, out
        assert "published bundle generation 2" in out
        assert '"ok": true' in out and "0 contradictions" in out  # guards green at close
        actor.send_signal(signal.SIGTERM)
        aout, _ = actor.communicate(timeout=60)
        assert actor.returncode == 0, aout
        assert "[fleet-actor] drained" in aout and "hot-swapped bundle generation" in aout
        rows = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
        assert rows[-1]["step"] == 8 and rows[-1]["fleet_windows_ingested"] >= 64
    finally:
        for p in (learner, actor):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
