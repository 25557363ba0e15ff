"""The port's collection fleet (``d4pg_tpu_torch/fleet``,
``d4pg_tpu_torch/replay/source.py``) against the JAX package's, on the CPU:

- the wire: every codec, obs mode and flag gives the JAX module's bytes,
  each side decodes the other's, and malformed payloads raise in both;
- the negotiation: the HELLO's chosen capabilities and gap codes, and the
  training configuration's fleet gaps, as the JAX package's;
- the numpy policy: ``np.array_equal`` to the JAX one on the same bundle
  (flat, pixel, obs-norm), and within 1e-5 of the port's torch actor;
- the actor: the same seed and bundle leave byte-identical spools;
- the ingest: the same frames (a stale generation, a torn frame, a shed,
  a partition) leave byte-identical buffers and equal counters, and each
  package's actor feeds the other's ingest;
- the content claim: a fleet stream and the in-process writer leave the
  same replay rows (f32, and pixel rows through the uint8 wire);
- no fleet module loads torch; the C-4 refusal in both CLIs.
"""

import dataclasses
import os
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from d4pg_tpu.chaos import ChaosInjector as JChaosInjector
from d4pg_tpu.chaos import ChaosPlan as JChaosPlan
from d4pg_tpu.fleet import actor as jactor
from d4pg_tpu.fleet import ingest as jingest
from d4pg_tpu.fleet import policy as jpolicy
from d4pg_tpu.fleet import wire as jwire
from d4pg_tpu.replay import source as jsource
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplayBuffer
from d4pg_tpu.serve import protocol as jprotocol
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.chaos import ChaosInjector, ChaosPlan
from d4pg_tpu_torch.fleet import actor as pactor
from d4pg_tpu_torch.fleet import ingest as pingest
from d4pg_tpu_torch.fleet import policy as ppolicy
from d4pg_tpu_torch.fleet import wire as pwire
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.replay import source as psource
from d4pg_tpu_torch.replay.nstep_writer import NStepWriter
from d4pg_tpu_torch.replay.uniform import ReplayBuffer
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.bundle import export_bundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS, ACT, NSTEP, GAMMA = 5, 2, 3, 0.99
PIXEL_SHAPE = (48, 48, 2)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def _cols(n, seed=0, obs_dim=OBS, unit=False):
    rng = np.random.default_rng(seed)
    obs = rng.random((n, obs_dim)) if unit else rng.standard_normal((n, obs_dim)) * 3
    nxt = rng.random((n, obs_dim)) if unit else rng.standard_normal((n, obs_dim)) * 3
    return {
        "obs": obs.astype(np.float32),
        "action": rng.standard_normal((n, ACT)).astype(np.float32),
        "reward": rng.standard_normal(n).astype(np.float32),
        "next_obs": nxt.astype(np.float32),
        "discount": rng.random(n).astype(np.float32),
    }


# -------------------------------------------------------------------- wire
CAPS = dict(wire=2, obs_modes=["f32", "u8"], her=True, obs_norm=False, variant=3)
HELLO = dict(actor_id="a0", env="Pendulum-v1", obs_dim=OBS, action_dim=ACT, n_step=NSTEP,
             gamma=GAMMA, generation=4)
CHOSEN = dict(obs_mode="u8", her=True, obs_norm=True, variant=2)


def _wire_cases():
    cases = {
        "hello_v1": ("encode_hello", (), dict(HELLO), "decode_hello", ()),
        "hello_caps": ("encode_hello", (), dict(HELLO, caps=CAPS), "decode_hello", ()),
        "hello_caps_defaults": ("encode_hello", (), dict(HELLO, caps={}), "decode_hello", ()),
        "hello_ok_v1": ("encode_hello_ok", (), dict(generation=7, max_windows=64, max_inflight=8),
                        "decode_hello_ok", ()),
        "hello_ok_caps": ("encode_hello_ok", (), dict(generation=7, max_windows=64, max_inflight=8,
                                                      caps=CHOSEN, stats_generation=5),
                          "decode_hello_ok", ()),
        "refusal": ("encode_refusal", ("obs_dim 3 != 5",
                                       (jsource.CapabilityGap("her_required", "m"),)), {},
                    "decode_refusal", ()),
        "windows": ("encode_windows", (3,), _cols(11), "decode_windows", (OBS, ACT)),
        "windows_ok": ("encode_windows_ok", (5, 2), {}, "decode_windows_ok", ()),
    }
    for mode in ("f32", "u8", "bf16"):
        for relabeled in (False, True):
            for logprob in (False, True):
                cols = _cols(9, seed=2, unit=mode == "u8")
                kw = dict(cols, logprob=np.linspace(-3, 0, 9, dtype=np.float32) if logprob else None)
                cases[f"windows2_{mode}_{'rel' if relabeled else 'orig'}"
                      f"{'_logprob' if logprob else ''}"] = (
                    "encode_windows2", (6, 4, mode, relabeled), kw, "decode_windows2", (OBS, ACT))
    return cases


WIRE_CASES = _wire_cases()


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_bytes_equal_the_jax_bytes_and_decode_both_ways(case):
    enc, args, kw, dec, dargs = WIRE_CASES[case]
    ours = getattr(pwire, enc)(*args, **kw)
    ref = getattr(jwire, enc)(*args, **kw)
    assert ours == ref
    assert _same(getattr(pwire, dec)(ref, *dargs), getattr(jwire, dec)(ours, *dargs))


MALFORMED = {
    "hello_not_json": ("decode_hello", b"not json", ()),
    "hello_missing_keys": ("decode_hello", b'{"obs_dim": 3}', ()),
    "hello_null_dim": ("decode_hello", b'{"obs_dim": null, "action_dim": 3, "n_step": 5,'
                                       b' "gamma": 0.99}', ()),
    "hello_ok_missing": ("decode_hello_ok", b'{"generation": 1}', ()),
    "hello_ok_null": ("decode_hello_ok", b'{"generation": 1, "max_windows_per_frame": null,'
                                         b' "max_inflight": 4}', ()),
    "windows_short_header": ("decode_windows", b"\x01", (OBS, ACT)),
    "windows_truncated": ("decode_windows", jwire.encode_windows(0, **_cols(2))[:-4], (OBS, ACT)),
    "windows_wrong_dims": ("decode_windows", jwire.encode_windows(0, **_cols(2)), (OBS + 1, ACT)),
    "windows2_short_header": ("decode_windows2", b"\x00" * 5, (OBS, ACT)),
    "windows2_truncated_u8": ("decode_windows2", jwire.encode_windows2(
        0, 0, "u8", False, **_cols(4, unit=True))[:-7], (OBS, ACT)),
    "windows2_unknown_mode": ("decode_windows2", bytes(8) + b"\x02\x00\x00\x00\x07\x00\x00\x00",
                              (OBS, ACT)),
    "windows_ok_long": ("decode_windows_ok", jwire.encode_windows_ok(5, 2) + b"x", ()),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_payloads_raise_in_both(case):
    dec, payload, args = MALFORMED[case]
    with pytest.raises(jprotocol.ProtocolError) as ref:
        getattr(jwire, dec)(payload, *args)
    with pytest.raises(protocol.ProtocolError) as ours:
        getattr(pwire, dec)(payload, *args)
    assert str(ours.value) == str(ref.value)


def test_bf16_without_ml_dtypes_gives_the_ml_dtypes_bytes(monkeypatch):
    """The card's machine has no ml_dtypes: the bf16 wire then rounds in
    numpy, to the same bits (ties to even, NaN and inf included), and
    decodes without it."""
    import ml_dtypes

    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 1e3,
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32).view(np.float32),
        np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 3.4028235e38, 1e-45,
                  1.00390625, 1.01171875], np.float32),  # two ties, to even
    ])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    assert np.array_equal(pwire.bf16_bits_numpy(x), want)
    cols = _cols(6, seed=4)
    ref = jwire.encode_windows2(1, 1, "bf16", False, **cols)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)  # import ml_dtypes now fails
    with pytest.raises(ImportError):
        import ml_dtypes  # noqa: F401,F811
    assert pwire.encode_windows2(1, 1, "bf16", False, **cols) == ref
    got = pwire.decode_windows2(ref, OBS, ACT)[4]["obs"]
    assert np.array_equal(got, cols["obs"].astype(ml_dtypes.bfloat16).astype(np.float32))


def test_u8_rows_decode_raw_or_divided():
    cols = _cols(5, seed=5, unit=True)
    payload = pwire.encode_windows2(0, 0, "u8", False, **cols)
    raw = pwire.decode_windows2(payload, OBS, ACT, raw_u8=True)[4]
    dec = pwire.decode_windows2(payload, OBS, ACT)[4]
    assert raw["obs"].dtype == np.uint8
    assert np.array_equal(raw["obs"], pwire.quantize_obs_u8(cols["obs"]))
    assert np.array_equal(dec["obs"], raw["obs"].astype(np.float32) / np.float32(255.0))
    # the uint8 replay stores either as the same bytes
    a, b = ReplayBuffer(8, OBS, ACT, obs_dtype=np.uint8), ReplayBuffer(8, OBS, ACT, obs_dtype=np.uint8)
    from d4pg_tpu_torch.replay.uniform import Transition

    a.add_batch(Transition(**raw))
    b.add_batch(Transition(**dec))
    assert np.array_equal(a.obs, b.obs) and np.array_equal(a.next_obs, b.next_obs)


# ------------------------------------------------------------- negotiation
ACTOR_CAPS = {
    "legacy": None,
    "full": dict(wire=2, obs_modes=["f32", "u8", "bf16"], her=False, obs_norm=False),
    "f32_only": dict(wire=2, obs_modes=["f32"], her=False, obs_norm=False),
    "her": dict(wire=2, obs_modes=["f32", "u8"], her=True, obs_norm=False),
    "norm": dict(wire=2, obs_modes=["f32", "u8", "bf16"], her=False, obs_norm=True),
    "her_norm_v1": dict(wire=2, obs_modes=["f32", "u8"], her=True, obs_norm=True, variant=1),
    "mirror": dict(wire=2, obs_modes=["f32"], her=False, obs_norm=False, source="mirror"),
}
LEARNER_REQUESTS = [
    dict(pixel=pixel, fleet_wire=wire_, her=her, obs_norm=norm, variant=variant)
    for pixel in (False, True) for wire_ in ("auto", "bfloat16") for her in (False, True)
    for norm in (False, True) for variant in (0, 1)
]


@pytest.mark.parametrize("actor", sorted(ACTOR_CAPS))
def test_hello_negotiation_gives_the_jax_verdicts(actor):
    for req in LEARNER_REQUESTS:
        learner = psource.learner_fleet_caps(psource.RequestedCaps(**req))
        assert learner == jsource.learner_fleet_caps(jsource.RequestedCaps(**req))
        caps = ACTOR_CAPS[actor] or psource.LEGACY_ACTOR_CAPS
        if ACTOR_CAPS[actor] is not None:
            caps = pwire.decode_hello(pwire.encode_hello(**HELLO, caps=caps))["caps"]
        ours, ours_gaps = psource.negotiate_fleet(learner, caps)
        ref, ref_gaps = jsource.negotiate_fleet(learner, caps)
        assert ours == ref, req
        assert [(g.code, g.message) for g in ours_gaps] == [(g.code, g.message) for g in ref_gaps]
    assert psource.LEGACY_ACTOR_CAPS == jsource.LEGACY_ACTOR_CAPS
    assert psource.OBS_MODES == jsource.OBS_MODES


FLEET_CODES = ("fleet_bundle_requires_listen", "obs_norm_fleet_single_writer",
               "fleet_only_async_collect", "fleet_wire_bf16_flat_only",
               "fleet_wire_requires_listen", "unknown_fleet_wire", "no_collection_source",
               "on_device_fleet")
SOURCE_REQUESTS = {
    "fleet_only": dict(fleet=True, fleet_only=True, fleet_bundle=True, num_envs=0),
    "bundle_without_listen": dict(fleet_bundle=True),
    "mixed_obs_norm": dict(fleet=True, num_envs=2, obs_norm=True, is_jax_env=False),
    "fleet_only_obs_norm": dict(fleet=True, fleet_only=True, num_envs=0, obs_norm=True,
                                is_jax_env=False),
    "fleet_only_async": dict(fleet=True, fleet_only=True, num_envs=0, async_collect=True),
    "bf16_pixel": dict(fleet=True, fleet_only=True, num_envs=0, pixel=True, fleet_wire="bfloat16"),
    "bf16_without_listen": dict(fleet_wire="bfloat16"),
    "unknown_wire": dict(fleet=True, fleet_wire="float16"),
    "unknown_wire_without_listen": dict(fleet_wire="float16"),
    "no_source": dict(num_envs=0),
    "on_device_fleet": dict(fleet=True, on_device=True),
    "device_fleet": dict(fleet=True, fleet_only=True, num_envs=0, placement="device"),
    "plain": dict(),
}


@pytest.mark.parametrize("case", sorted(SOURCE_REQUESTS))
def test_source_gaps_are_the_jax_fleet_gaps(case):
    req = SOURCE_REQUESTS[case]
    # the port's request carries the fields its verdicts read
    fields = {f.name for f in dataclasses.fields(psource.RequestedCaps)}
    ours = psource.negotiate_source(psource.RequestedCaps(
        **{k: v for k, v in req.items() if k in fields}))
    ref = jsource.negotiate(jsource.RequestedCaps(**req))
    want = [(g.code, g.message) for g in ref.gaps if g.code in FLEET_CODES]
    assert [(g.code, g.message) for g in ours.gaps] == want
    assert ours.ok == (not want)


TRAINER_CONFIGS = {
    "no_source": dict(num_envs=0),
    "bundle_without_listen": dict(num_envs=2, fleet_bundle="b"),
    "async_fleet_only": dict(env="Pendulum-v1", num_envs=0, fleet_listen=0, async_collect=True),
    "mixed_obs_norm": dict(env="Pendulum-v1", num_envs=2, fleet_listen=0, obs_norm=True),
    "bf16_pixel": dict(env="pixel_pendulum", num_envs=0, fleet_listen=0,
                       fleet_wire_dtype="bfloat16"),
    "bf16_without_listen": dict(num_envs=2, fleet_wire_dtype="bfloat16"),
    "fleet_only": dict(num_envs=0, fleet_listen=0, fleet_bundle="b"),
}


@pytest.mark.parametrize("case", sorted(TRAINER_CONFIGS))
def test_train_config_refusals_are_the_jax_trainers(case):
    """``config.check_fleet`` refuses a port TrainConfig where the JAX
    ``validate_train_config`` refuses the same config, with its code."""
    from d4pg_tpu.config import TrainConfig as JTrainConfig
    from d4pg_tpu_torch.config import TrainConfig, apply_env_preset, check_fleet

    kw = TRAINER_CONFIGS[case]
    cfg = apply_env_preset(TrainConfig(**kw))
    jcfg = JTrainConfig(**kw)
    if kw.get("env") == "pixel_pendulum":
        jcfg = dataclasses.replace(jcfg, agent=dataclasses.replace(
            jcfg.agent, pixel_shape=PIXEL_SHAPE))
    torch_env = kw.get("env", "pendulum") in ("pendulum", "pixel_pendulum")
    ref = jsource.negotiate(jsource.from_train_config(jcfg, is_jax_env=torch_env))
    want = [g.code for g in ref.gaps if g.code in FLEET_CODES]
    if want:
        with pytest.raises(ValueError) as e:
            check_fleet(cfg)
        assert re.findall(r"(?:^|; )([a-z0-9_]+): ", str(e.value)) == want
        with pytest.raises(ValueError):
            jsource.validate_train_config(jcfg, is_jax_env=torch_env)
    else:
        check_fleet(cfg)


# ------------------------------------------------------------------ policy
def _export(path, *, pixel=False, obs_norm=False, seed=0, generation=3, env="Pendulum-v1",
            obs_dim=OBS, action_dim=ACT, hidden=(8, 8), n_step=NSTEP):
    obs_dim = int(np.prod(PIXEL_SHAPE)) if pixel else obs_dim
    cfg = D4PGConfig(obs_dim=obs_dim, action_dim=action_dim, hidden_sizes=hidden, n_step=n_step,
                     gamma=GAMMA, pixel_shape=PIXEL_SHAPE if pixel else None)
    actor = Actor(obs_dim, action_dim, hidden, generator=torch.Generator().manual_seed(seed),
                  pixel_shape=cfg.pixel_shape)
    stats = None
    if obs_norm:
        rng = np.random.default_rng(seed)
        stats = {"count": 37.0, "mean": (rng.standard_normal(obs_dim) * 0.5).tolist(),
                 "m2": (rng.random(obs_dim) * 80 + 1).tolist()}
    export_bundle(str(path), cfg, actor, obs_norm_state=stats,
                  meta={"generation": generation, "stats_generation": generation, "env": env})
    return actor, stats


@pytest.mark.parametrize("kind", ["flat", "pixel", "obs_norm"])
def test_numpy_policy_is_the_jax_policy_and_the_torch_actor(kind, tmp_path):
    actor, stats = _export(tmp_path, pixel=kind == "pixel", obs_norm=kind == "obs_norm")
    ours, ref = ppolicy.load_numpy_policy(str(tmp_path)), jpolicy.load_numpy_policy(str(tmp_path))
    for attr in ("obs_dim", "action_dim", "n_step", "gamma", "env", "generation",
                 "stats_generation", "has_obs_norm", "pixel_shape"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    rng = np.random.default_rng(1)
    obs = (rng.random((6, ours.obs_dim)) if kind == "pixel"
           else rng.standard_normal((16, ours.obs_dim)) * 2).astype(np.float32)
    got = ours.act(obs)
    assert np.array_equal(got, ref.act(obs))
    x = obs
    if stats is not None:
        mean, std = ppolicy._derive_obs_norm(stats, ours.obs_dim)
        x = np.clip((obs - mean) / std, -5.0, 5.0)
    with torch.no_grad():
        want = actor(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_bundle_constants_and_refusals_are_the_jax_loaders(tmp_path):
    import json

    from d4pg_tpu_torch.serve import bundle as sb

    assert (ppolicy.BUNDLE_VERSION, ppolicy.PARAMS_FILE, ppolicy.META_FILE) == (
        sb.BUNDLE_VERSION, sb.PARAMS_FILE, sb.META_FILE)
    _export(tmp_path)
    meta = tmp_path / "bundle.json"
    doc = json.loads(meta.read_text())
    for change, match in (({"hidden_sizes": [16, 16]}, "mismatch|leaves"),
                          ({"pixel_shape": [8, 8, 2]}, "pixel"),
                          ({"hidden_sizes": [8] * 10}, "at most 9")):
        meta.write_text(json.dumps(dict(doc, agent=dict(doc["agent"], **change))))
        with pytest.raises(ValueError, match=match):
            ppolicy.load_numpy_policy(str(tmp_path))
        with pytest.raises(ValueError, match=match):
            jpolicy.load_numpy_policy(str(tmp_path))
    assert ppolicy.bundle_meta_mtime(str(tmp_path / "none")) is None


# ------------------------------------------------------------------- actor
ACTOR_ENVS = {
    "pendulum": dict(env="Pendulum-v1", obs_dim=3, action_dim=1, num_envs=2, steps=70, her=False),
    "pixel": dict(env="pixel_pendulum_host", obs_dim=None, action_dim=1, num_envs=2, steps=8,
                  her=False),
    "her": dict(env="toy_goal_env:ToyGoal-v0", obs_dim=4, action_dim=2, num_envs=2, steps=60,
                her=True),
}


def _spool_rows(spool):
    return [(tag, o.tobytes(), a.tobytes(), np.float32(r).tobytes(), n.tobytes(),
             np.float32(d).tobytes()) for tag, o, a, r, n, d in spool.rows]


@pytest.mark.parametrize("case", sorted(ACTOR_ENVS))
def test_actor_spools_are_the_jax_actors(case, tmp_path):
    c = ACTOR_ENVS[case]
    _export(tmp_path, pixel=c["obs_dim"] is None, obs_dim=c["obs_dim"] or OBS,
            action_dim=c["action_dim"], env=c["env"], n_step=1 if c["her"] else NSTEP)
    actors = [mod.FleetActor(connect="127.0.0.1:1", bundle_dir=str(tmp_path), num_envs=c["num_envs"],
                             seed=11, her=c["her"], her_k=2)
              for mod in (pactor, jactor)]
    try:
        for _ in range(c["steps"]):
            for a in actors:
                a._step_envs()
        ours, ref = (_spool_rows(a.spool) for a in actors)
        assert len(ours) > 0 and ours == ref
        assert actors[0].stats() == actors[1].stats()
        assert actors[0]._hello() == actors[1]._hello()
    finally:
        for a in actors:
            for env in a.envs:
                env.close()


# ------------------------------------------------------------------ ingest
def _hello(mod_wire, generation=0, caps=None, obs_dim=OBS):
    return mod_wire.encode_hello(actor_id="t", env="e", obs_dim=obs_dim, action_dim=ACT,
                                 n_step=NSTEP, gamma=GAMMA, generation=generation, caps=caps)


def _connect(port, hello):
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    s.settimeout(5)
    protocol.write_frame(s, protocol.HELLO, 1, hello)
    return s, protocol.read_frame(s)


class _Gated:
    """A buffer whose ``add_batch`` waits on a gate, so the writer thread
    can be held while the queue fills; the rows then land in ``inner``."""

    def __init__(self, inner):
        self.inner = inner
        self.obs_dtype = inner.obs_dtype
        self.entered = threading.Event()
        self.gate = threading.Event()

    def add_batch(self, t):
        self.entered.set()
        self.gate.wait(10)
        return self.inner.add_batch(t)


def _drive_ingest(srv_mod, buf_mod, wire_mod, chaos_mods):
    """One script of frames against an ingest server of either package;
    returns (buffer, counters, replies)."""
    inner = buf_mod.ReplayBuffer(64, OBS, ACT)
    gated = _Gated(inner)
    srv = srv_mod.IngestServer(gated, obs_dim=OBS, action_dim=ACT, n_step=NSTEP, gamma=GAMMA,
                               queue_limit=1, max_gen_lag=1,
                               chaos=chaos_mods[0](chaos_mods[1].parse("seed=1;partition@6")))
    srv.start()
    replies = []
    try:
        srv.set_generation(2)
        s, (t, _r, p) = _connect(srv.port, _hello(wire_mod, generation=2))
        replies.append((t, p))

        def send(req, gen, seed, n=4):
            protocol.write_frame(s, protocol.WINDOWS, req,
                                 wire_mod.encode_windows(gen, **_cols(n, seed=seed)))
            frame = protocol.read_frame(s)
            replies.append(frame)
            return frame

        send(2, 2, 0)                       # accepted; the writer holds it at the gate
        assert gated.entered.wait(5)
        send(3, 0, 1)                       # stale: 0 < 2 - 1
        send(4, 1, 2)                       # queued (inside the lag)
        send(5, 2, 3)                       # the queue is full: shed
        gated.gate.set()
        assert _wait(lambda: len(inner) == 8)
        send(6, 2, 4, n=3)                  # accepted
        # the 6th frame of the connection: the partition resets it
        protocol.write_frame(s, protocol.WINDOWS, 7, wire_mod.encode_windows(2, **_cols(2, seed=5)))
        try:
            replies.append(protocol.read_frame(s))
        except (OSError, protocol.ProtocolError):
            replies.append("reset")
        s.close()
        # a torn frame on a fresh connection dies whole
        s, _ok = _connect(srv.port, _hello(wire_mod, generation=2))
        payload = wire_mod.encode_windows(2, **_cols(5, seed=6))
        s.sendall(protocol.HEADER.pack(protocol.MAGIC, 1, protocol.WINDOWS, 8, len(payload))
                  + payload[:len(payload) // 2])
        s.close()
        # a refused handshake
        s, refused = _connect(srv.port, _hello(wire_mod, obs_dim=OBS + 1))
        replies.append(refused[0])
        s.close()
        assert _wait(lambda: srv.counters()["connections"] == 0)
        assert _wait(lambda: len(inner) == 11)
    finally:
        gated.gate.set()
        srv.close()
    return inner, srv.counters(), replies


def test_ingest_leaves_the_jax_ingests_buffer_and_counters():
    ours = _drive_ingest(pingest, __import__("d4pg_tpu_torch.replay.uniform", fromlist=["x"]),
                         pwire, (ChaosInjector, ChaosPlan))
    ref = _drive_ingest(jingest, __import__("d4pg_tpu.replay.uniform", fromlist=["x"]),
                        jwire, (JChaosInjector, JChaosPlan))
    (buf, counters, replies), (jbuf, jcounters, jreplies) = ours, ref
    assert counters == jcounters
    assert counters["windows_shed"] == 4 and counters["windows_dropped_stale_gen"] == 4
    assert counters["protocol_errors"] == 1 and counters["handshake_refusals"] == 1
    assert replies == jreplies
    for k in ("obs", "action", "reward", "next_obs", "discount"):
        assert getattr(buf, k).tobytes() == getattr(jbuf, k).tobytes(), k
    assert len(buf) == len(jbuf) == 11


def _cross_run(actor_mod, ingest_mod, buf, tmp_path, env, obs_mode):
    """An actor of one package against the other's ingest, to its drain."""
    srv = ingest_mod.IngestServer(buf, obs_dim=buf.obs.shape[1], action_dim=1, n_step=NSTEP,
                                  gamma=GAMMA, caps=dict(obs_mode=obs_mode, her=False,
                                                         obs_norm=False))
    srv.start()
    try:
        actor = actor_mod.FleetActor(connect=f"127.0.0.1:{srv.port}", bundle_dir=str(tmp_path),
                                     env_id=env, num_envs=2, seed=4, batch_windows=8,
                                     max_env_steps=40)
        stats = actor.run()
        assert _wait(lambda: srv.counters()["windows_ingested"] == stats["windows_acked"])
    finally:
        srv.close()
    return stats, srv.counters()


@pytest.mark.parametrize("direction", ["jax_actor_port_ingest", "port_actor_jax_ingest"])
@pytest.mark.parametrize("env", ["Pendulum-v1", "pixel_pendulum_host"])
def test_each_packages_actor_feeds_the_others_ingest(direction, env, tmp_path):
    pixel = env == "pixel_pendulum_host"
    _export(tmp_path, pixel=pixel, obs_dim=3, action_dim=1, env=env)
    obs_dim = int(np.prod(PIXEL_SHAPE)) if pixel else 3
    dtype = np.uint8 if pixel else np.float32
    port_side = direction.startswith("jax_actor")
    buf = (ReplayBuffer if port_side else JReplayBuffer)(4096, obs_dim, 1, obs_dtype=dtype)
    stats, counters = _cross_run(jactor if port_side else pactor,
                                 pingest if port_side else jingest, buf, tmp_path, env,
                                 "u8" if pixel else "f32")
    assert stats["windows_acked"] == stats["windows_emitted"] == counters["windows_ingested"] > 0
    assert len(buf) == counters["windows_ingested"]
    assert counters["protocol_errors"] == counters["handshake_refusals"] == 0


# ------------------------------------------------------------------ content
def _episode_stream(seed, steps, obs_dim, unit):
    rng = np.random.default_rng(seed)

    def draw():
        x = rng.random(obs_dim) if unit else rng.standard_normal(obs_dim)
        return x.astype(np.float32)

    obs, t_in_ep = draw(), 0
    for i in range(steps):
        action = rng.standard_normal(ACT).astype(np.float32)
        reward = float(rng.standard_normal())
        next_obs = draw()
        t_in_ep += 1
        term = t_in_ep == 13 and (i // 13) % 2 == 0
        trunc = t_in_ep == 13 and not term
        yield obs, action, reward, next_obs, term, trunc
        if term or trunc:
            obs, t_in_ep = draw(), 0
        else:
            obs = next_obs


@pytest.mark.parametrize("obs_mode", ["f32", "u8"])
def test_fleet_and_inprocess_replay_content_identical(obs_mode):
    """The same episode stream through the in-process n-step writer into
    the replay, and through the spool, a socket and the ingest into
    another, leaves the same rows, in order (pixel-like rows through the
    u8 wire into uint8 buffers)."""
    obs_dim, unit = (96, True) if obs_mode == "u8" else (OBS, False)
    dtype = np.uint8 if unit else np.float32
    local = ReplayBuffer(512, obs_dim, ACT, obs_dtype=dtype)
    w_local = NStepWriter(local, NSTEP, GAMMA)
    srv = pingest.IngestServer(ReplayBuffer(512, obs_dim, ACT, obs_dtype=dtype), obs_dim=obs_dim,
                               action_dim=ACT, n_step=NSTEP, gamma=GAMMA,
                               caps=dict(obs_mode=obs_mode, her=False, obs_norm=False)).start()
    acks = dict.fromkeys(pactor.ACK_KEYS, 0)

    def on_ack(kind, n):
        acks[kind] += n

    try:
        link = pactor.FleetLink(
            "127.0.0.1", srv.port,
            dict(actor_id="p", env="e", obs_dim=obs_dim, action_dim=ACT, n_step=NSTEP,
                 gamma=GAMMA, generation=0, caps=dict(obs_modes=["f32", "u8"])),
            on_ack=on_ack)
        spool = pactor._Spool(4096)
        w_fleet = NStepWriter(spool, NSTEP, GAMMA)
        for obs, action, reward, next_obs, term, trunc in _episode_stream(7, 200, obs_dim, unit):
            w_local.add(obs, action, reward, next_obs, term, trunc)
            w_fleet.add(obs, action, reward, next_obs, term, trunc)
        emitted = len(spool)
        assert emitted == len(local) > 0
        while spool.rows:
            assert link.acquire_credit(5)
            link.send_windows(*spool.take_frame(link.max_windows))
        assert _wait(lambda: link.inflight() == 0)
        link.close()
        fleet = srv.buffer
        assert _wait(lambda: len(fleet) == emitted)
        assert acks == {"accepted": emitted, "stale": 0, "shed": 0, "dropped": 0}
        for k in ("obs", "action", "reward", "next_obs", "discount"):
            assert getattr(fleet, k)[:emitted].tobytes() == getattr(local, k)[:emitted].tobytes()
    finally:
        srv.close()


# --------------------------------------------------------- imports, C-4
def test_fleet_modules_load_no_torch_and_no_jax():
    code = (
        "import sys\n"
        "import d4pg_tpu_torch.fleet, d4pg_tpu_torch.fleet.actor, d4pg_tpu_torch.fleet.ingest\n"
        "import d4pg_tpu_torch.fleet.wire, d4pg_tpu_torch.fleet.policy\n"
        "import d4pg_tpu_torch.replay.source, d4pg_tpu_torch.replay.nstep_writer\n"
        "import d4pg_tpu_torch.envs.gym_adapter, d4pg_tpu_torch.chaos\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'd4pg_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_num_envs_0_without_fleet_listen_is_refused_by_both_clis(tmp_path):
    """C-4: ``--num-envs 0`` with nothing to collect is refused, by name,
    before any env or learner is built, in both CLIs: each ends inside
    its own timeout with a non-zero exit and the gap's words."""
    flags = ["--hidden-sizes", "32,32", "--num-envs", "0", "--bsize", "32", "--warmup", "64",
             "--total-steps", "4"]
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    procs = [
        subprocess.Popen([sys.executable, "-m", "d4pg_tpu_torch.train", "--device", "cpu",
                          *flags, "--log-dir", str(tmp_path / "port")], cwd=REPO, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
        subprocess.Popen([sys.executable, "train.py", *flags, "--log-dir", str(tmp_path / "jax")],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True),
    ]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode != 0, out
        assert "--num-envs 0 means no local collection at all" in out, out
    assert not (tmp_path / "port" / "metrics.jsonl").exists()
