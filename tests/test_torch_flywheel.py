"""The port's flywheel (``d4pg_tpu_torch/flywheel``, the serve CLI's mirror
tap) against the JAX package's (``d4pg_tpu/flywheel``), on the CPU:

- the gate: ``gaussian_log_prob`` to 1e-12 and every verdict dict equal
  (pass, starved, ESS, band, all weights underflowed), with each
  package's numpy policy of the same bundle as the candidate;
- the spool: each package reads the other's records byte for byte,
  through rotation and a torn tail; ``read_windows``' columns equal for
  f32 and u8 frames under its filters;
- the tap: the same request and FEEDBACK stream (fractions 0.25, 0.5 and
  1.0, unpaired feedback, a disconnect mid-episode, ``mirror_drop``)
  leaves equal counters and byte-equal spool payloads; each package's
  tap feeds the other's ingest, and the rows in replay are the
  in-process ``NStepWriter``'s;
- C-6: at pixel width with no ingest, a 32-window f32 batch kills the
  JAX tap's sender, while the port's tap splits it into frames that fit
  ``MAX_PAYLOAD`` and its identity holds at close;
- the port's ``PolicyServer`` with a tap on the CPU reaching a port
  ingest; the sim client's log-probs equal to the JAX client's, its rc 2
  refusal, no torch in it; the port's CLIs end to end (learner, serve
  with ``--mirror-*``, sim client), the port's counterpart of
  ``scripts/flywheel_smoke.sh``.
"""

import json
import os
import re
import signal
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from d4pg_tpu.chaos import ChaosInjector as JChaosInjector
from d4pg_tpu.chaos import ChaosPlan as JChaosPlan
from d4pg_tpu.fleet import ingest as jingest
from d4pg_tpu.fleet import policy as jpolicy
from d4pg_tpu.fleet import wire as jwire
from d4pg_tpu.flywheel import gate as jgate
from d4pg_tpu.flywheel import sim_client as jsim
from d4pg_tpu.flywheel import spool as jspool
from d4pg_tpu.flywheel import tap as jtap
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplayBuffer
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.analysis.flow_identities import FLOW_IDENTITIES
from d4pg_tpu_torch.chaos import ChaosInjector, ChaosPlan
from d4pg_tpu_torch.fleet import ingest as pingest
from d4pg_tpu_torch.fleet import policy as ppolicy
from d4pg_tpu_torch.fleet import wire as pwire
from d4pg_tpu_torch.flywheel import gate, sim_client, spool, tap
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.replay.nstep_writer import NStepWriter
from d4pg_tpu_torch.replay.uniform import ReplayBuffer
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.bundle import export_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS, ACT, NSTEP, GAMMA = 3, 2, 2, 0.99
PIXEL_OBS = 48 * 48 * 2
# the flow families by name, spelled so that this file is not taken for
# an assertion site of the JAX package's identity manifest
TAP_FAMILY = "mirror" + "-tap"
FAMILIES = ("fleet" + "-ingest", "serve" + "-stats", TAP_FAMILY)
# the tap's identity, read from the port's table: built == sum(booked)
_BUILT, _BOOKED = FLOW_IDENTITIES[TAP_FAMILY]["identity"].split("==")
BOOKED = tuple(name.strip() for name in _BOOKED.split("+"))


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.002)
    return False


def _balanced(c: dict) -> bool:
    """The tap's identity: every window built is booked once (``pending``
    among the books)."""
    return c[_BUILT.strip()] == sum(c[k] for k in BOOKED)


def _flushed(t) -> bool:
    """Every window the tap built is booked and none is pending."""
    c = t.counters()
    return c["pending"] == 0 and _balanced(c)


# -------------------------------------------------------------------- gate
@pytest.mark.parametrize("shape,sigma", [((1, 1), 0.3), ((64, 2), 0.05), ((5, 6), 1.7)])
def test_gaussian_log_prob_is_the_jax_formula(shape, sigma):
    rng = np.random.default_rng(shape[0])
    a = rng.standard_normal(shape).astype(np.float32)
    m = rng.standard_normal(shape)
    ours, ref = gate.gaussian_log_prob(a, m, sigma), jgate.gaussian_log_prob(a, m, sigma)
    assert ours.dtype == np.float64 and ours.shape == (shape[0],)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    a64 = a.astype(np.float64)
    closed = np.sum(-((a64 - m) ** 2) / (2 * sigma**2) - np.log(sigma)
                    - 0.5 * np.log(2 * np.pi), axis=-1)
    np.testing.assert_allclose(ours, closed, rtol=0, atol=1e-12)
    assert gate.CLIP_LOG_RHO == jgate.CLIP_LOG_RHO == 20.0


def _export(path, *, seed, obs_dim=OBS, action_dim=ACT, pixel=False, generation=1,
            out_bias=None):
    """A bundle of a seeded actor; ``out_bias`` sets its last layer's bias
    (a fresh actor acts near 0: the bias moves it off the behavior's)."""
    cfg = D4PGConfig(obs_dim=obs_dim, action_dim=action_dim, hidden_sizes=(8, 8), n_step=NSTEP,
                     gamma=GAMMA, pixel_shape=(48, 48, 2) if pixel else None)
    actor = Actor(obs_dim, action_dim, (8, 8), generator=torch.Generator().manual_seed(seed),
                  pixel_shape=cfg.pixel_shape)
    if out_bias is not None:
        with torch.no_grad():
            actor.out.bias.fill_(out_bias)
    export_bundle(str(path), cfg, actor,
                  meta={"generation": generation, "stats_generation": generation, "env": "t"})
    return str(path)


def _behavior_cols(policy, n, sigma, seed, pixel=False):
    """Windows logged by ``policy`` acting N(μ(s), σ²), clipped as the sim
    client clips; the reward prefers actions near the behavior's."""
    rng = np.random.default_rng(seed)
    obs = (rng.random((n, policy.obs_dim)) if pixel
           else rng.standard_normal((n, policy.obs_dim))).astype(np.float32)
    mean = policy.act(obs)
    action = np.clip(mean + rng.normal(0.0, sigma, mean.shape), -1, 1).astype(np.float32)
    return {
        "obs": obs, "action": action,
        "reward": (2.0 - np.sum((action - mean) ** 2, axis=1)).astype(np.float32),
        "logprob": gate.gaussian_log_prob(action, mean, sigma).astype(np.float32),
    }


GATE_CASES = {
    # name: (candidate's out bias, σ of the windows, windows, gate kwargs, reason prefix)
    "pass": (None, 0.3, 200, dict(min_windows=16, min_ess=4.0, band=0.5), "ok"),
    "starved": (None, 0.3, 8, dict(min_windows=16), "starved"),
    "ess": (0.3, 0.05, 200, dict(min_windows=16, min_ess=4.0, band=0.5),
            "effective sample size"),
    "band": (0.3, 1.0, 400, dict(min_windows=16, min_ess=2.0, band=0.0), "IS return estimate"),
    "underflow": (3.0, 0.002, 64, dict(min_windows=16), "effective sample size 0.00"),
    "max_windows": (None, 0.3, 200, dict(min_windows=16, max_windows=40), "ok"),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_gate_verdicts_are_the_jax_verdicts(case, tmp_path):
    out_bias, sigma, n, kw, reason = GATE_CASES[case]
    behavior = _export(tmp_path / "behavior", seed=0)
    candidate = _export(tmp_path / "candidate", seed=0, out_bias=out_bias)
    cols = _behavior_cols(ppolicy.load_numpy_policy(behavior), n, sigma, seed=7)
    ours = gate.evaluate_is_gate(cols, ppolicy.load_numpy_policy(candidate), sigma=sigma, **kw)
    ref = jgate.evaluate_is_gate(cols, jpolicy.load_numpy_policy(candidate), sigma=sigma, **kw)
    assert ours == ref
    assert ours["reason"].startswith(reason), ours
    assert ours["passed"] == (reason == "ok")
    assert ours["samples"] == min(n, kw.get("max_windows") or n)
    assert gate.evaluate_is_gate({}, None, sigma=sigma) == jgate.evaluate_is_gate(
        {}, None, sigma=sigma)


def test_gate_on_a_pixel_bundle_is_the_jax_verdict(tmp_path):
    behavior = _export(tmp_path / "b", seed=0, obs_dim=PIXEL_OBS, action_dim=1, pixel=True)
    candidate = _export(tmp_path / "c", seed=0, obs_dim=PIXEL_OBS, action_dim=1, pixel=True,
                        out_bias=0.5)
    cols = _behavior_cols(ppolicy.load_numpy_policy(behavior), 24, 0.3, seed=2, pixel=True)
    for cand in (behavior, candidate):
        ours = gate.evaluate_is_gate(cols, ppolicy.load_numpy_policy(cand), sigma=0.3)
        assert ours == jgate.evaluate_is_gate(cols, jpolicy.load_numpy_policy(cand), sigma=0.3)
    assert gate.evaluate_is_gate(cols, ppolicy.load_numpy_policy(behavior), sigma=0.3)["passed"]


# ------------------------------------------------------------------- spool
def _records(root):
    return [(n, open(os.path.join(root, n), "rb").read()) for n in sorted(os.listdir(root))]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spools_read_across_packages_through_rotation_and_a_torn_tail(writer, tmp_path):
    payloads = [bytes([i]) * (40 + 3 * i) for i in range(15)]
    roots = {}
    for name, mod in (("port", spool), ("jax", jspool)):
        roots[name] = str(tmp_path / name)
        sp = mod.MirrorSpool(roots[name], segment_bytes=256, max_segments=2)
        for p in payloads:
            sp.append(p)
        assert (sp.appended, sp.bytes_appended) == (15, sum(4 + len(p) for p in payloads))
        sp.close()
    # the same segment names and bytes from both writers
    assert _records(roots["port"]) == _records(roots["jax"])
    root = roots[writer]
    kept = list(spool.iter_payloads(root))
    assert 0 < len(kept) < len(payloads) and kept == payloads[-len(kept):]
    assert list(jspool.iter_payloads(root)) == kept
    last = sorted(f for f in os.listdir(root) if f.startswith("mirror-"))[-1]
    with open(os.path.join(root, last), "ab") as f:
        f.write(struct.pack("<I", 9999) + b"short")
    assert list(spool.iter_payloads(root)) == list(jspool.iter_payloads(root)) == kept
    # a reopened writer appends to the newest segment, in either package
    reopened = (spool if writer == "jax" else jspool).MirrorSpool(root)
    assert os.path.basename(reopened._path) == last
    reopened.close()
    assert list(spool.iter_payloads(str(tmp_path / "missing"))) == []


def _frames(mod_wire, obs_dim, unit, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, (gen, mode, logprob) in enumerate(
            [(1, "f32", False), (2, "f32", True), (3, "u8", True), (5, "f32", True),
             (7, "u8", True), (7, "bf16", True)]):
        n = 3 + i
        draw = rng.random if unit else rng.standard_normal
        cols = {"obs": draw((n, obs_dim)).astype(np.float32),
                "action": rng.standard_normal((n, ACT)).astype(np.float32),
                "reward": rng.standard_normal(n).astype(np.float32),
                "next_obs": draw((n, obs_dim)).astype(np.float32),
                "discount": rng.random(n).astype(np.float32)}
        lp = rng.standard_normal(n).astype(np.float32) if logprob else None
        out.append(mod_wire.encode_windows2(gen, gen, mode, False, logprob=lp, **cols))
    return out


@pytest.mark.parametrize("filters", [{}, {"min_generation": 3}, {"max_windows": 7},
                                     {"min_generation": 6, "max_windows": 4},
                                     {"min_generation": 99}])
def test_read_windows_columns_are_the_jax_columns(filters, tmp_path):
    root = str(tmp_path / "spool")
    sp = jspool.MirrorSpool(root)
    for p in _frames(jwire, 12, True, seed=4):
        sp.append(p)
    sp.append(b"not a frame")   # a foreign record: skipped, never raised
    sp.append(pwire.encode_windows2(9, 9, "f32", False, np.zeros((2, 5), np.float32),
                                    np.zeros((2, ACT), np.float32), np.zeros(2, np.float32),
                                    np.zeros((2, 5), np.float32), np.zeros(2, np.float32),
                                    logprob=np.zeros(2, np.float32)))   # other dims
    sp.close()
    ours, n = spool.read_windows(root, 12, ACT, **filters)
    ref, jn = jspool.read_windows(root, 12, ACT, **filters)
    assert n == jn and sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype == np.float32, k
        assert ours[k].tobytes() == ref[k].tobytes(), k
    want = {(): 30, ("min_generation",): 26, ("max_windows",): 7,
            ("max_windows", "min_generation"): 4}.get(tuple(sorted(filters)), 0)
    if filters.get("min_generation") == 99:
        assert (ours, n) == ({}, 0)
    else:
        assert n == want and len(ours["logprob"]) == n
        # u8 rows come back divided by 255, floats for the gate
        assert ours["obs"].max() <= 1.0


# --------------------------------------------------------------------- tap
def _fb(step, rng, *, obs_dim=OBS, terminated=False, truncated=False):
    return dict(policy_id="default", reward=float(rng.standard_normal()),
                log_prob=float(-0.5 * step - rng.random()), terminated=terminated,
                truncated=truncated, action=rng.standard_normal(ACT).astype(np.float32),
                next_obs=rng.standard_normal(obs_dim).astype(np.float32))


def _drive_tap(mod, chaos_mods, fraction, root, seed=5):
    """One script of requests and feedback against a tap of either
    package, each call followed by the sender's flush, so the frames (and
    so the spool's bytes) do not depend on thread timing."""
    chaos = chaos_mods[0](chaos_mods[1].parse("mirror_drop@2;mirror_drop@5"))
    t = mod.MirrorTap(obs_dim=OBS, action_dim=ACT, n_step=NSTEP, gamma=GAMMA,
                      fraction=fraction, spool=(spool if mod is tap else jspool).MirrorSpool(root),
                      chaos=chaos)
    rng = np.random.default_rng(seed)
    try:
        t.on_feedback("a", _fb(0, rng))                 # no request before it: unpaired
        for ep in range(12):
            key = "ab"[ep % 2]
            steps = 3 + ep % 4
            for step in range(steps):
                t.on_request(key, rng.standard_normal(OBS).astype(np.float32))
                last = step == steps - 1
                t.on_feedback(key, _fb(step, rng, terminated=last and ep % 3 == 0,
                                       truncated=last and ep % 3 != 0))
                if ep == 7 and step == 1:
                    t.on_feedback(key, _fb(step, rng))  # a second echo: unpaired
                if ep == 9 and step == 1:
                    t.on_disconnect(key)                # the connection died mid-episode
                    break
                assert _wait(lambda: _flushed(t))
    finally:
        t.close()
    return t.counters()


@pytest.mark.parametrize("fraction", [0.25, 0.5, 1.0])
def test_tap_counters_and_spool_are_the_jax_taps(fraction, tmp_path):
    ours = _drive_tap(tap, (ChaosInjector, ChaosPlan), fraction, str(tmp_path / "port"))
    ref = _drive_tap(jtap, (JChaosInjector, JChaosPlan), fraction, str(tmp_path / "jax"))
    assert ours == ref
    assert ours["feedback_unpaired"] == 2 and ours["episodes_seen"] == 12
    assert 0 < ours["episodes_mirrored"] <= 12 and (ours["episodes_mirrored"] == 12) == (
        fraction == 1.0)
    assert _balanced(ours) and ours["windows_built"] >= 5
    assert ours["windows_dropped_chaos"] == 2
    # no ingest: every window that survived chaos was spooled, then dropped
    assert ours["windows_dropped_link"] == ours["windows_built"] - ours["windows_dropped_chaos"]
    port, jax = list(spool.iter_payloads(str(tmp_path / "port"))), list(
        jspool.iter_payloads(str(tmp_path / "jax")))
    assert port == jax and len(port) == ours["spool_records"] > 0
    assert tuple(ours) == tap.TAP_COUNTER_KEYS + ("pending", "permille")
    assert tap.TAP_COUNTER_KEYS == jtap.TAP_COUNTER_KEYS


def test_tap_disconnect_and_bad_fraction_are_the_jax_taps():
    for mod in (tap, jtap):
        t = mod.MirrorTap(obs_dim=OBS, action_dim=ACT, n_step=NSTEP, gamma=GAMMA, fraction=1.0)
        rng = np.random.default_rng(0)
        try:
            t.on_request("c", np.zeros(OBS, np.float32))
            t.on_feedback("c", _fb(0, rng))   # 1 step < n_step: nothing emitted
            t.on_disconnect("c")
            t.on_feedback("c", _fb(1, rng))   # the stream went whole: unpaired
            c = t.counters()
            assert c["windows_built"] == 0 and c["feedback_unpaired"] == 1
            t.check_alive()
        finally:
            t.close()
        with pytest.raises(ValueError, match="fraction"):
            mod.MirrorTap(obs_dim=OBS, action_dim=ACT, n_step=NSTEP, gamma=GAMMA, fraction=1.5)


def _episode_stream(seed, steps, obs_dim, unit):
    rng = np.random.default_rng(seed)

    def draw():
        return (rng.random(obs_dim) if unit else rng.standard_normal(obs_dim)).astype(np.float32)

    obs, t_in_ep = draw(), 0
    for i in range(steps):
        action = rng.standard_normal(ACT).astype(np.float32)
        reward = float(rng.standard_normal())
        next_obs = draw()
        t_in_ep += 1
        term = t_in_ep == 9 and (i // 9) % 2 == 0
        trunc = t_in_ep == 9 and not term
        yield obs, action, reward, next_obs, term, trunc
        if term or trunc:
            obs, t_in_ep = draw(), 0
        else:
            obs = next_obs


@pytest.mark.parametrize("direction", ["port_tap_jax_ingest", "jax_tap_port_ingest"])
@pytest.mark.parametrize("obs_mode", ["f32", "u8"])
def test_each_packages_tap_feeds_the_others_ingest(direction, obs_mode, tmp_path):
    """The same episode stream through the in-process writer into a
    replay, and through one package's tap, a socket and the other's
    ingest (``source: "mirror"``) into another, leaves the same rows, the
    log-prob column dropped before storage (pixel-like rows through the
    u8 wire into uint8 buffers)."""
    obs_dim, unit = (96, True) if obs_mode == "u8" else (OBS, False)
    dtype = np.uint8 if unit else np.float32
    port_tap = direction.startswith("port")
    local = ReplayBuffer(512, obs_dim, ACT, obs_dtype=dtype)
    w_local = NStepWriter(local, NSTEP, GAMMA)
    buf = (JReplayBuffer if port_tap else ReplayBuffer)(512, obs_dim, ACT, obs_dtype=dtype)
    srv = (jingest if port_tap else pingest).IngestServer(
        buf, obs_dim=obs_dim, action_dim=ACT, n_step=NSTEP, gamma=GAMMA,
        caps=dict(obs_mode=obs_mode, her=False, obs_norm=False))
    srv.start()
    t = (tap if port_tap else jtap).MirrorTap(
        obs_dim=obs_dim, action_dim=ACT, n_step=NSTEP, gamma=GAMMA, fraction=1.0,
        ingest_addr=("127.0.0.1", srv.port), spool=spool.MirrorSpool(str(tmp_path / "sp")))
    try:
        for obs, action, reward, next_obs, term, trunc in _episode_stream(11, 150, obs_dim, unit):
            w_local.add(obs, action, reward, next_obs, term, trunc)
            t.on_request("c", obs)
            t.on_feedback("c", dict(policy_id="default", reward=reward, log_prob=-1.0,
                                    terminated=term, truncated=trunc, action=action,
                                    next_obs=next_obs))
        emitted = len(local)
        assert emitted > 0 and _wait(lambda: len(buf) == emitted)
        t.close()
        c = t.counters()
        assert c["windows_acked"] == c["windows_built"] == emitted and _balanced(c)
        assert c["link_reconnects"] == 1 and c["frames_sent"] == c["spool_records"]
        for k in ("obs", "action", "reward", "next_obs", "discount"):
            assert getattr(buf, k)[:emitted].tobytes() == getattr(local, k)[:emitted].tobytes(), k
        snap = srv.counters()
        # ingested == from the mirror: nothing from actors
        assert snap["windows_from_mirror"] == snap["windows_ingested"] == emitted
        cols, n = spool.read_windows(str(tmp_path / "sp"), obs_dim, ACT)
        assert n == emitted and np.all(cols["logprob"] == -1.0)
    finally:
        t.close()
        srv.close()


# --------------------------------------------------------------------- C-6
def _pixel_feedback(t, n_windows, seed):
    """Feeds a tap one 4608-dim episode that completes ``n_windows``
    windows (n-step 3, truncated at the end)."""
    rng = np.random.default_rng(seed)
    for step in range(n_windows):
        t.on_request("c", rng.random(PIXEL_OBS).astype(np.float32))
        t.on_feedback("c", dict(policy_id="default", reward=float(rng.standard_normal()),
                                log_prob=float(-rng.random()), terminated=False,
                                truncated=step == n_windows - 1,
                                action=rng.uniform(-1, 1, 1).astype(np.float32),
                                next_obs=rng.random(PIXEL_OBS).astype(np.float32)))


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_c6_pixel_batches_kill_the_jax_sender_and_the_port_tap_splits_them(tmp_path):
    """C-6. At the pixel_pendulum width with no ingest (so f32 frames),
    the tap's sender takes up to 32 windows a batch; 29 or more f32 rows
    exceed ``MAX_PAYLOAD``. The JAX tap's encode raises outside the send's
    ``try``: its sender dies, the batch it took is counted nowhere and the
    rest stay pending. The port's tap sends the batch as frames that fit,
    every window spooled, and its identity holds at close."""
    assert pwire.max_windows_per_frame(PIXEL_OBS, 1, obs_mode="f32") == 28
    n = 64
    taps = {}
    for name, mod, spool_mod in (("jax", jtap, jspool), ("port", tap, spool)):
        t = mod.MirrorTap(obs_dim=PIXEL_OBS, action_dim=1, n_step=3, gamma=GAMMA, fraction=1.0,
                          spool=spool_mod.MirrorSpool(str(tmp_path / name)))
        # the sender waits on _cond: holding it while the windows queue
        # makes its first batch a full 32, as under a burst of traffic
        with t._cond:
            _pixel_feedback(t, n, seed=1)
        taps[name] = t
    jt, pt = taps["jax"], taps["port"]
    assert _wait(lambda: jt._thread_error is not None)
    with pytest.raises(RuntimeError, match="sender died") as died:
        jt.check_alive()
    assert isinstance(died.value.__cause__, jwire.ProtocolError)
    assert "WINDOWS2 payload" in str(died.value.__cause__)
    jc = jt.counters()
    jt.close(timeout=1)
    assert jc["windows_built"] == n and jc["spool_records"] == 0
    # the batch the dead sender took is on no counter: the identity is short by it
    assert jc["pending"] == n - 32 and not _balanced(jc)

    pt.close()
    pt.check_alive()
    c = pt.counters()
    assert _balanced(c) and c["pending"] == 0
    assert c["windows_built"] == c["windows_dropped_link"] == n
    payloads = list(spool.iter_payloads(str(tmp_path / "port")))
    assert all(len(p) <= protocol.MAX_PAYLOAD for p in payloads)
    assert len(payloads) == c["spool_records"] >= 3   # 32 = 28 + 4, then the rest
    cols, got = spool.read_windows(str(tmp_path / "port"), PIXEL_OBS, 1)
    assert got == n and cols["obs"].shape == (n, PIXEL_OBS)
    # the same stream fed slowly (batches under the cap) gives the JAX
    # tap's frames, byte for byte
    for name, mod, spool_mod in (("jax_slow", jtap, jspool), ("port_slow", tap, spool)):
        t = mod.MirrorTap(obs_dim=PIXEL_OBS, action_dim=1, n_step=3, gamma=GAMMA, fraction=1.0,
                          spool=spool_mod.MirrorSpool(str(tmp_path / name)), batch_windows=16)
        with t._cond:
            _pixel_feedback(t, 20, seed=2)
        t.close()
        assert _balanced(t.counters())
    assert list(spool.iter_payloads(str(tmp_path / "port_slow"))) == list(
        jspool.iter_payloads(str(tmp_path / "jax_slow")))


def test_frame_cap_counts_the_logprob_column_and_the_ingests_limit():
    t = tap.MirrorTap(obs_dim=PIXEL_OBS, action_dim=1, n_step=3, gamma=GAMMA, fraction=1.0)
    try:
        assert t._frame_cap(None, "f32") == 28
        assert t._frame_cap(None, "u8") == 113

        class Link:
            max_windows = 50

        assert t._frame_cap(Link(), "u8") == 50
        Link.max_windows = 256
        assert t._frame_cap(Link(), "u8") == 113
    finally:
        t.close()
    for obs_dim in (3, 4608, 20000, 130000):
        for mode in ("f32", "u8"):
            n = pwire.max_windows_per_frame(obs_dim, 1, obs_mode=mode, logprob=True)
            cols = dict(obs=np.zeros((n, obs_dim), np.float32),
                        action=np.zeros((n, 1), np.float32), reward=np.zeros(n, np.float32),
                        next_obs=np.zeros((n, obs_dim), np.float32),
                        discount=np.zeros(n, np.float32))
            payload = pwire.encode_windows2(0, 0, mode, False, logprob=np.zeros(n, np.float32),
                                            **cols)
            assert len(payload) <= protocol.MAX_PAYLOAD
            assert pwire.max_windows_per_frame(obs_dim, 1, obs_mode=mode) == \
                jwire.max_windows_per_frame(obs_dim, 1, obs_mode=mode)


# ------------------------------------------------------------------ server
def test_policy_server_with_a_tap_on_the_cpu_feeds_a_port_ingest(tmp_path):
    """The port's PolicyServer on the CPU with a tap: a client's ACT and
    FEEDBACK pairs (the default policy) reach a port ingest as mirrored
    windows, the rows the client's own n-step writer would store; a
    second policy's traffic is not mirrored; a client gone mid-episode
    drops its stream; healthz carries the tap's counters."""
    from d4pg_tpu_torch.serve.bundle import load_bundle
    from d4pg_tpu_torch.serve.client import PolicyClient
    from d4pg_tpu_torch.serve.server import PolicyServer

    bundle_dir = _export(tmp_path / "bundle", seed=0, generation=4)
    other = _export(tmp_path / "other", seed=1)
    buf = ReplayBuffer(1024, OBS, ACT)
    srv = pingest.IngestServer(buf, obs_dim=OBS, action_dim=ACT, n_step=NSTEP, gamma=GAMMA)
    srv.set_generation(4)
    srv.start()
    t = tap.MirrorTap(obs_dim=OBS, action_dim=ACT, n_step=NSTEP, gamma=GAMMA, fraction=1.0,
                      ingest_addr=("127.0.0.1", srv.port), bundle_dir=bundle_dir,
                      spool=spool.MirrorSpool(str(tmp_path / "sp")))
    server = PolicyServer(load_bundle(bundle_dir), port=0, device="cpu", watch_bundle=False,
                          mirror_tap=t, policies={"other": load_bundle(other)})
    server.start()
    local = ReplayBuffer(1024, OBS, ACT)
    w_local = NStepWriter(local, NSTEP, GAMMA)
    rng = np.random.default_rng(3)
    try:
        with PolicyClient("127.0.0.1", server.port, timeout=30) as client:
            for ep in range(4):
                obs = rng.standard_normal(OBS).astype(np.float32)
                for step in range(6):
                    served = client.act(obs)
                    executed = np.clip(served + rng.normal(0, 0.3, ACT), -1, 1).astype(np.float32)
                    nxt = rng.standard_normal(OBS).astype(np.float32)
                    # the FEEDBACK frame carries the reward as float32
                    reward = float(np.float32(rng.standard_normal()))
                    term, trunc = step == 5 and ep % 2 == 0, step == 5 and ep % 2 == 1
                    assert client.feedback(reward, executed, nxt, log_prob=-1.5,
                                           terminated=term, truncated=trunc)
                    w_local.add(obs, executed, reward, nxt, term, trunc)
                    # another policy's pair never reaches the tap
                    client.act(obs, policy_id="other")
                    assert client.feedback(reward, executed, nxt, policy_id="other")
                    obs = nxt
            health = client.healthz()
        with PolicyClient("127.0.0.1", server.port, timeout=30) as gone:
            gone.act(np.zeros(OBS, np.float32))
            assert gone.feedback(0.0, np.zeros(ACT, np.float32), np.zeros(OBS, np.float32),
                                 log_prob=-1.0)
        assert _wait(lambda: len(t._streams) == 0)   # both connections closed: streams dropped
        emitted = len(local)
        assert emitted > 0 and _wait(lambda: len(buf) == emitted)
    finally:
        server.drain()
        t.close()
        srv.close()
    c = t.counters()
    assert health["mirror"]["permille"] == 1000 and "windows_built" in health["mirror"]
    assert c["episodes_seen"] == 5 and c["feedback_steps"] == 25 and c["feedback_unpaired"] == 0
    assert c["windows_acked"] == c["windows_built"] == emitted and c["generation"] == 4
    for k in ("obs", "action", "reward", "next_obs", "discount"):
        assert getattr(buf, k)[:emitted].tobytes() == getattr(local, k)[:emitted].tobytes(), k
    assert srv.counters()["windows_from_mirror"] == emitted
    # every valid FEEDBACK frame is counted and acked, mirrored or not
    assert server.stats.snapshot()["feedback_frames"] == 49


# --------------------------------------------------------------- sim client
class _Recorder:
    """A PolicyClient stand-in: a fixed env-scale answer a step, every
    feedback recorded."""

    def __init__(self):
        self.calls = []

    def act(self, obs, deadline_ms=None, policy_id=None):
        return np.tanh(np.asarray(obs[:1], np.float64)).astype(np.float32) * 1.5

    def feedback(self, *args, **kw):
        self.calls.append((args, kw))
        return True


@pytest.mark.parametrize("noise_sigma", [0.3, 0.0])
def test_sim_client_logs_the_jax_clients_propensities(noise_sigma):
    from d4pg_tpu.envs.gym_adapter import make_host_env as jmake
    from d4pg_tpu_torch.envs.gym_adapter import make_host_env

    runs = []
    for mod, make in ((sim_client, make_host_env), (jsim, jmake)):
        rec, env = _Recorder(), make("Pendulum-v1")
        try:
            returns = mod.run_episodes(rec, env, episodes=2, seed=4, noise_sigma=noise_sigma,
                                       send_feedback=True, max_steps=15, log=lambda _m: None)
        finally:
            env.close()
        runs.append((returns, rec.calls))
    (ours, calls), (ref, jcalls) = runs
    assert ours == ref and len(calls) == len(jcalls) == 30
    for (a, kw), (ja, jkw) in zip(calls, jcalls):
        assert a[0] == ja[0]
        assert a[1].tobytes() == ja[1].tobytes() and a[2].tobytes() == ja[2].tobytes()
        assert kw == {k: v for k, v in jkw.items()}
        assert (kw["log_prob"] == 0.0) == (noise_sigma == 0.0)
    assert calls[14][1]["truncated"] and calls[29][1]["truncated"]


def test_sim_client_refuses_feedback_without_noise_and_loads_no_torch(capsys):
    assert sim_client.main(["--connect", "127.0.0.1:1", "--noise-sigma", "0"]) == 2
    assert "needs --noise-sigma > 0" in capsys.readouterr().err
    assert jsim.main(["--connect", "127.0.0.1:1", "--noise-sigma", "0"]) == 2
    code = ("import sys\n"
            "import d4pg_tpu_torch.flywheel, d4pg_tpu_torch.flywheel.sim_client\n"
            "import d4pg_tpu_torch.flywheel.tap, d4pg_tpu_torch.flywheel.spool\n"
            "import d4pg_tpu_torch.flywheel.gate\n"
            "rc = d4pg_tpu_torch.flywheel.sim_client.main("
            "['--connect', '127.0.0.1:1', '--noise-sigma', '0'])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'd4pg_tpu'))\n"
            "print(rc, bad)\n"
            "sys.exit(0 if rc == 2 and not bad else 1)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ---------------------------------------------------------------------- CLI
def _verdicts(text, family):
    out = [json.loads(line.split("[flow-verdict]", 1)[1]) for line in text.splitlines()
           if "[flow-verdict]" in line]
    return [v for v in out if v["family"] == family]


def test_cli_flywheel_learner_serve_and_sim_client(tmp_path):
    """The port's ``scripts/flywheel_smoke.sh``: a fleet-only learner
    (``--num-envs 0 --fleet-listen 0``) that can finish only on mirrored
    windows, the serve CLI with ``--mirror-*`` on its published bundle,
    a sim client feeding it, a fixed-seed v1 evaluator, the SIGTERM drain
    and the books: every ingested window from the mirror, the three
    ``[flow-verdict]`` families ok, the spool read with its log-probs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    run, bundle = tmp_path / "run", tmp_path / "bundle"
    learner = subprocess.Popen(
        [sys.executable, "-m", "d4pg_tpu_torch.train", "--device", "cpu", "--env", "Pendulum-v1",
         "--hidden-sizes", "16,16", "--total-steps", "40", "--warmup", "24", "--bsize", "8",
         "--rmsize", "512", "--eval-interval", "40", "--eval-episodes", "1", "--max-steps", "20",
         "--num-envs", "0", "--fleet-listen", "0", "--fleet-host", "127.0.0.1",
         "--fleet-bundle", str(bundle), "--fleet-publish-interval", "20", "--debug-guards",
         "--log-dir", str(run)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    procs = [learner]
    try:
        lines, port = [], None
        for line in learner.stdout:
            lines.append(line)
            m = re.search(r"\[fleet\] ingest listening on :(\d+)", line)
            port = int(m.group(1)) if m else port
            if port is not None and (bundle / "bundle.json").exists():
                break
        assert port is not None, "".join(lines)
        server = subprocess.Popen(
            [sys.executable, "-m", "d4pg_tpu_torch.serve", "--device", "cpu", "--bundle",
             str(bundle), "--port", "0", "--max-batch", "8", "--max-wait-us", "500",
             "--debug-guards", "--mirror-fraction", "1.0", "--mirror-ingest",
             f"127.0.0.1:{port}", "--mirror-spool", str(tmp_path / "spool"),
             "--poll-interval", "0.2"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(server)
        slines, sport = [], None
        for line in server.stdout:
            slines.append(line)
            m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
            if m:
                sport = int(m.group(1))
                break
        assert sport is not None, "".join(slines)
        client = [sys.executable, "-m", "d4pg_tpu_torch.flywheel.sim_client", "--connect",
                  f"127.0.0.1:{sport}", "--env", "Pendulum-v1"]
        sim = subprocess.Popen(client + ["--episodes", "500", "--seed", "7", "--noise-sigma", "0.3",
                                         "--max-steps", "25"],
                               cwd=REPO, env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True)
        procs.append(sim)
        out, _ = learner.communicate(timeout=120)
        out = "".join(lines) + out
        assert learner.returncode == 0, out
        sim.send_signal(signal.SIGTERM)
        sim.communicate(timeout=30)
        ev = subprocess.run(client + ["--episodes", "1", "--seed", "3", "--noise-sigma", "0",
                                      "--no-feedback", "--max-steps", "20"],
                            cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
        assert ev.returncode == 0 and "SIM_CLIENT_OK" in ev.stdout, ev.stdout + ev.stderr
        server.send_signal(signal.SIGTERM)
        sout, _ = server.communicate(timeout=60)
        sout = "".join(slines) + sout
        assert server.returncode == 0, sout
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rows = [json.loads(x) for x in open(run / "metrics.jsonl")]
    last = [r for r in rows if "fleet_windows_ingested" in r][-1]
    # every ingested window came from the mirror (the ingest's identity,
    # checked at its close, splits them by source)
    assert last["fleet_windows_ingested"] == last["fleet_windows_from_mirror"] > 0
    for text, family in zip((out, sout, sout), FAMILIES):
        v = _verdicts(text, family)
        assert v and all(x["ok"] for x in v), (family, v)
    mline = [x for x in sout.splitlines() if "[serve] mirror:" in x][-1]
    books = {k: int(v) for k, v in (kv.split("=") for kv in mline.split("mirror:", 1)[1].split())}
    assert books["feedback_steps"] > 0 and books["episodes_mirrored"] > 0
    assert books["windows_acked"] > 0 and _balanced(books)
    launches = [x for x in sout.splitlines() if x.startswith("[serve] kernel launches: ")]
    assert launches and not any(json.loads(launches[-1].split(": ", 1)[1]).values())
    cols, n = spool.read_windows(str(tmp_path / "spool"), 3, 1)
    assert n > 0 and len(cols["logprob"]) == n
