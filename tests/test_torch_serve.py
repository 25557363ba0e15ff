"""The port's serving pieces in isolation against the JAX package's, on the
CPU: protocol frames, bundles both ways, the dynamic batcher, and the
``--export-bundle`` / ``python -m d4pg_tpu_torch.serve`` CLIs. Socket
end to end lives in test_torch_serve_server.py.

Inputs are made from a numpy seed and shared as numpy arrays. Tolerances:

- frames and bundle files: byte-equal; configs and leaves: equal.
- float32 actions: atol 1e-5. The two packages run the same float32
  actor on the same normalized rows (the normalization is the same NumPy
  expression on both), summing each product in another order; a few
  float32 ulps of a tanh in (-1, 1) mapped onto bounds at most 4 wide.
- bfloat16 actions: ``test_torch_stacked``'s BF16_REL (6·2^-7) of the
  largest action magnitude, for the reason given there; the affine to the
  bounds runs in float32 after the bf16 actor.
"""

import dataclasses
import json
import os
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.agent.state import D4PGConfig as JConfig
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.serve import batcher as jbatcher
from d4pg_tpu.serve import bundle as jbundle
from d4pg_tpu.serve import protocol as jprotocol
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.models.actor import Actor
from d4pg_tpu_torch.serve import protocol
from d4pg_tpu_torch.serve.batcher import DynamicBatcher, ShedError, default_buckets
from d4pg_tpu_torch.serve.bundle import (
    config_from_json,
    config_to_json,
    export_bundle,
    load_bundle,
)
from d4pg_tpu_torch.serve.protocol import ProtocolError
from d4pg_tpu_torch.weights import flax_to_state_dict

BF16_REL = 6 * 2.0**-7
CFG = D4PGConfig(obs_dim=4, action_dim=2, hidden_sizes=(32, 32))
STATS = {"count": 9.0, "mean": [0.5, -0.25, 0.0, 1.0], "m2": [9.0, 4.0, 1.0, 16.0]}
LOW, HIGH = [-3.0, 0.0], [3.0, 2.0]


def jconfig(cfg: D4PGConfig, **kw) -> JConfig:
    """The JAX config with the port config's shared fields."""
    shared = {f.name for f in dataclasses.fields(JConfig)} & {
        f.name for f in dataclasses.fields(D4PGConfig)}
    d = {k: getattr(cfg, k) for k in shared if k not in ("projection_backend", "dist")}
    return dataclasses.replace(JConfig(), dist=JDist(**dataclasses.asdict(cfg.dist)), **d, **kw)


def jax_params(cfg: D4PGConfig, seed: int):
    """Seeded Flax actor params of the config's shapes (numpy leaves)."""
    rng = np.random.default_rng(seed)
    template = jbundle.actor_template(jconfig(cfg))
    return jax.tree_util.tree_map(
        lambda x: (rng.normal(size=np.shape(x)) * 0.3).astype(np.float32), template)


def torch_actor(cfg: D4PGConfig, seed: int) -> Actor:
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return Actor(cfg.obs_dim, cfg.action_dim, cfg.hidden_sizes,
                 generator=torch.Generator().manual_seed(seed), compute_dtype=dtype)


# ---------------------------------------------------------------- protocol
def _act2_kw():
    return dict(policy_id="cheetah", qos=jprotocol.QOS_BULK, tenant="t-7")


CODECS = {
    "frame": lambda m, obs: m.encode_frame(m.ACT2, 0xDEADBEEF, obs.tobytes()),
    "act": lambda m, obs: m.encode_act(obs, 123456),
    "act2": lambda m, obs: m.encode_act2(obs, 77, **_act2_kw()),
    "feedback": lambda m, obs: m.encode_feedback(
        -1.5, obs[:3], obs, log_prob=-0.25, terminated=True, policy_id="x"),
    "action": lambda m, obs: m.encode_action(obs),
}


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_encoders_are_byte_equal_and_decoders_agree(codec):
    obs = np.random.default_rng(11).normal(size=17).astype(np.float32)
    ours, ref = CODECS[codec](protocol, obs), CODECS[codec](jprotocol, obs)
    assert ours == ref
    if codec == "frame":
        assert protocol.FrameAssembler().next_frame() is None
        a = protocol.FrameAssembler()
        a.feed(ours)
        assert a.next_frame() == (protocol.ACT2, 0xDEADBEEF, obs.tobytes())
    elif codec == "act":
        (o1, d1), (o2, d2) = protocol.decode_act(ours, 17), jprotocol.decode_act(ref, 17)
        np.testing.assert_array_equal(o1, o2)
        assert d1 == d2 == 123456
    elif codec == "act2":
        got, want = protocol.decode_act2(ours), jprotocol.decode_act2(ref)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] == (77, "cheetah", protocol.QOS_BULK, "t-7")
    elif codec == "feedback":
        got, want = protocol.decode_feedback(ours), jprotocol.decode_feedback(ref)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(protocol.decode_action(ours), jprotocol.decode_action(ref))


def test_constants_match_the_reference():
    names = ["MAGIC", "PROTOCOL_VERSION", "SUPPORTED_VERSIONS", "MAX_PAYLOAD", "ACT", "ACT_OK",
             "OVERLOADED", "ERROR", "HEALTHZ", "HEALTHZ_OK", "HELLO", "HELLO_OK", "WINDOWS",
             "WINDOWS_OK", "ACT2", "WINDOWS2", "FEEDBACK", "FEEDBACK_OK", "QOS_INTERACTIVE",
             "QOS_BULK", "QOS_NAMES", "DEFAULT_POLICY", "FEEDBACK_TERMINATED",
             "FEEDBACK_TRUNCATED", "_FRAME_MIN_VERSION"]
    for n in names:
        assert getattr(protocol, n) == getattr(jprotocol, n), n
    assert protocol.HEADER.format == jprotocol.HEADER.format


def test_protocol_roundtrip_over_a_socket():
    a, b = socket.socketpair()
    try:
        obs = np.arange(5, dtype=np.float32)
        protocol.write_frame(a, protocol.ACT, 7, protocol.encode_act(obs, 1234))
        msg_type, req_id, payload = protocol.read_frame(b)
        assert (msg_type, req_id) == (protocol.ACT, 7)
        got, deadline = protocol.decode_act(payload, 5)
        np.testing.assert_array_equal(got, obs)
        assert deadline == 1234
    finally:
        a.close(), b.close()


def test_protocol_clean_eof_and_mid_frame_eof():
    a, b = socket.socketpair()
    a.close()
    assert protocol.read_frame(b) is None  # clean EOF between frames
    b.close()
    a, b = socket.socketpair()
    a.sendall(protocol.HEADER.pack(protocol.MAGIC, protocol.PROTOCOL_VERSION,
                                   protocol.ACT, 1, 64) + b"short")
    a.close()
    with pytest.raises(ProtocolError, match="EOF"):
        protocol.read_frame(b)
    b.close()


@pytest.mark.parametrize("case", ["magic", "version", "max"])
def test_protocol_rejects_bad_magic_version_and_oversize(case):
    header = {
        "magic": b"XX" + bytes(protocol.HEADER.size - 2),
        "version": protocol.HEADER.pack(protocol.MAGIC, 99, protocol.ACT, 1, 0),
        "max": protocol.HEADER.pack(protocol.MAGIC, protocol.PROTOCOL_VERSION, protocol.ACT, 1,
                                    protocol.MAX_PAYLOAD + 1),
    }[case]
    a, b = socket.socketpair()
    try:
        a.sendall(header)
        with pytest.raises(ProtocolError, match=case) as ours:
            protocol.read_frame(b)
        ja, jb = socket.socketpair()
        try:
            ja.sendall(header)
            with pytest.raises(jprotocol.ProtocolError) as ref:
                jprotocol.read_frame(jb)
        finally:
            ja.close(), jb.close()
        assert str(ours.value) == str(ref.value)
        with pytest.raises(ProtocolError):
            protocol.write_frame(a, protocol.ACT, 1, b"x" * (protocol.MAX_PAYLOAD + 1))
    finally:
        a.close(), b.close()


def test_decode_act_size_mismatch():
    with pytest.raises(ProtocolError, match="expected"):
        protocol.decode_act(b"\x00" * 11, obs_dim=4)


# ------------------------------------------------------------------ bundles
def test_config_json_is_the_jax_schema_in_its_order():
    ours = config_to_json(D4PGConfig(), prioritized=True)
    ref = dataclasses.asdict(JConfig(projection_backend="pallas_fused"))
    assert list(ours) == list(ref)
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(ref))
    assert config_from_json(ours) == D4PGConfig()
    back = config_from_json(config_to_json(CFG))
    assert back == CFG and isinstance(back.hidden_sizes, tuple)


def test_config_json_unknown_field_and_pixels_are_refused():
    d = config_to_json(D4PGConfig())
    d["from_the_future"] = 1
    with pytest.raises(ValueError, match="from_the_future"):
        config_from_json(d)
    ref = dict(d)
    with pytest.raises(ValueError) as jerr:
        jbundle.config_from_json(ref)
    with pytest.raises(ValueError) as err:
        config_from_json(d)
    assert str(err.value) == str(jerr.value)
    # pixels are ported (A10 (c)): a JAX pixel config comes across with its
    # encoder fields, and goes back as the JAX schema
    pix = dataclasses.asdict(JConfig(obs_dim=8 * 8 * 3, pixel_shape=(8, 8, 3),
                                     encoder_embed_dim=20, augment_pad=2))
    got = config_from_json(pix)
    assert (got.pixel_shape, got.encoder_embed_dim, got.augment_pad) == ((8, 8, 3), 20, 2)
    back = config_to_json(got)
    assert back["pixel_shape"] == (8, 8, 3) and back["encoder_embed_dim"] == 20


@pytest.mark.parametrize("hidden", [(32, 32), (256, 256, 256)], ids=["narrow", "3x256"])
def test_a_jax_bundle_loads_into_the_port(hidden, tmp_path):
    cfg = dataclasses.replace(CFG, hidden_sizes=hidden)
    jparams = jax_params(cfg, 1)
    jbundle.export_bundle(str(tmp_path), jconfig(cfg, prioritized=False), jparams,
                          action_low=LOW, action_high=HIGH, obs_norm_state=STATS,
                          meta={"source": "jax"})
    b = load_bundle(str(tmp_path))
    assert b.config == dataclasses.replace(cfg, projection_backend="fused")
    want = flax_to_state_dict(jparams)
    assert b.actor_params.keys() == want.keys()
    for k in want:
        assert torch.equal(b.actor_params[k], want[k]), k
    np.testing.assert_array_equal(b.action_low, LOW)
    np.testing.assert_array_equal(b.action_high, HIGH)
    assert b.obs_norm == STATS and b.meta == {"source": "jax"}


@pytest.mark.parametrize("hidden", [(32, 32), (256, 256, 256)], ids=["narrow", "3x256"])
def test_a_port_bundle_loads_into_jax(hidden, tmp_path):
    cfg = dataclasses.replace(CFG, hidden_sizes=hidden, projection_backend="projection")
    actor = torch_actor(cfg, 2)
    export_bundle(str(tmp_path), cfg, actor, action_low=LOW, action_high=HIGH,
                  obs_norm_state=STATS, meta={"source": "port"}, prioritized=False)
    jb = jbundle.load_bundle(str(tmp_path))
    assert jb.config == jconfig(cfg, prioritized=False, projection_backend="pallas")
    got = flax_to_state_dict(jb.actor_params)
    for k, v in actor.state_dict().items():
        assert torch.equal(got[k], v), k
    with np.load(tmp_path / "actor_params.npz") as z:
        assert sorted(z.files) == [f"leaf_{i:05d}" for i in range(2 * (len(hidden) + 1))]
    np.testing.assert_array_equal(jb.action_high, HIGH)
    assert jb.obs_norm == STATS and jb.meta == {"source": "port"}


def test_bundle_validation_raises(tmp_path):
    actor = torch_actor(CFG, 3)
    with pytest.raises(ValueError):
        export_bundle(str(tmp_path / "bad"), CFG, actor, action_low=[1.0, 1.0],
                      action_high=[-1.0, -1.0])
    d = str(tmp_path / "norm")
    export_bundle(d, CFG, actor, obs_norm_state={"count": 1.0, "mean": [0.0], "m2": [1.0]})
    with pytest.raises(ValueError, match="obs_norm"):
        load_bundle(d)
    # config/params mismatch fails loudly, with the JAX wording
    d = str(tmp_path / "wide")
    export_bundle(d, CFG, actor)
    with open(os.path.join(d, "bundle.json")) as f:
        doc = json.load(f)
    doc["agent"] = config_to_json(dataclasses.replace(CFG, hidden_sizes=(16, 16)))
    with open(os.path.join(d, "bundle.json"), "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="bundle param leaf 0 has shape"):
        load_bundle(d)
    doc["agent"] = config_to_json(dataclasses.replace(CFG, hidden_sizes=(32,)))
    with open(os.path.join(d, "bundle.json"), "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="config/params mismatch"):
        load_bundle(d)
    # a pixel config (ported, A10 (c)) over a flat actor's params: its
    # encoder's leaves are missing
    doc["agent"] = dataclasses.asdict(JConfig(obs_dim=48, pixel_shape=(4, 4, 3)))
    with open(os.path.join(d, "bundle.json"), "w") as f:
        json.dump(doc, f)
    with pytest.raises(ValueError, match="config/params mismatch"):
        load_bundle(d)


# ---------------------------------------------------------- batcher vs JAX
def _run_batcher(b, obs):
    b.start()
    try:
        futs = [b.submit(o) for o in obs]
        return np.stack([f.result(60) for f in futs])
    finally:
        b.stop()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batcher_matches_the_jax_batcher(dtype, tmp_path):
    """Both batchers serve one JAX bundle with obs-norm stats and
    non-identity bounds: 64 seeded observations, actions within the
    module's tolerance."""
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    jbundle.export_bundle(str(tmp_path), jconfig(cfg), jax_params(cfg, 4), action_low=LOW,
                          action_high=HIGH, obs_norm_state=STATS)
    obs = np.random.default_rng(5).normal(size=(64, 4)).astype(np.float32) * 2
    jb, b = jbundle.load_bundle(str(tmp_path)), load_bundle(str(tmp_path))
    kw = dict(max_batch=8, max_wait_us=200, queue_limit=64)
    want = _run_batcher(jbatcher.DynamicBatcher(
        jb.config, jb.actor_params, action_low=jb.action_low, action_high=jb.action_high,
        obs_norm_stats=jb.obs_norm, **kw), obs)
    got = _run_batcher(DynamicBatcher(
        b.config, b.actor_params, action_low=b.action_low, action_high=b.action_high,
        obs_norm_stats=b.obs_norm, device="cpu", **kw), obs)
    atol = 1e-5 if dtype == "float32" else BF16_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.all(got >= np.array(LOW) - 1e-6) and np.all(got <= np.array(HIGH) + 1e-6)


def test_batcher_at_default_bounds_is_the_direct_forward():
    actor = torch_actor(CFG, 6)
    obs = np.random.default_rng(7).normal(size=(6, 4)).astype(np.float32)
    got = _run_batcher(DynamicBatcher(CFG, actor.state_dict(), max_batch=4, max_wait_us=200,
                                      queue_limit=16, device="cpu"), obs)
    with torch.no_grad():
        ref = actor(torch.from_numpy(obs)).clamp(-1.0, 1.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- batcher mechanics
def test_default_buckets_end_at_max_batch():
    assert default_buckets(8) == (1, 2, 4, 8)
    assert default_buckets(12) == (1, 2, 4, 8, 12)
    assert default_buckets(1) == (1,)
    assert default_buckets(64) == jbatcher.default_buckets(64)


def _slow_batcher(delay_s: float, **kw):
    """A batcher whose device call sleeps — the slow-device stub that makes
    queue buildup deterministic."""
    b = DynamicBatcher(CFG, torch_actor(CFG, 0).state_dict(), device="cpu", **kw)
    real = b._infer

    def slow(*args):
        time.sleep(delay_s)
        return real(*args)

    b._infer = slow
    return b


def test_batcher_queue_full_sheds_synchronously():
    b = _slow_batcher(0.2, max_batch=2, max_wait_us=50_000, queue_limit=2)
    b.start()
    try:
        obs = np.zeros(4, np.float32)
        futs = [b.submit(obs) for _ in range(2)]  # consumed into a batch
        time.sleep(0.05)  # device thread now sleeping inside the stub
        futs += [b.submit(obs), b.submit(obs)]  # fills the queue
        with pytest.raises(ShedError, match="queue_full"):
            b.submit(obs)
        assert b.stats.shed_queue_full == 1
        for f in futs:
            assert f.result(30).shape == (2,)  # admitted work still answered
    finally:
        b.stop()


def test_batcher_deadline_expired_requests_are_dropped():
    b = _slow_batcher(0.25, max_batch=2, max_wait_us=0, queue_limit=16)
    b.start()
    try:
        obs = np.zeros(4, np.float32)
        first = [b.submit(obs) for _ in range(2)]  # occupy the device
        time.sleep(0.05)
        doomed = b.submit(obs, deadline_s=0.05)  # expires while queued
        ok = b.submit(obs, deadline_s=30.0)
        with pytest.raises(ShedError, match="deadline"):
            doomed.result(30)
        assert ok.result(30).shape == (2,)
        assert b.stats.shed_deadline == 1
        for f in first:
            f.result(30)
    finally:
        b.stop()


def test_batcher_drain_answers_queued_then_sheds_new():
    b = _slow_batcher(0.1, max_batch=2, max_wait_us=0, queue_limit=32)
    b.start()
    obs = np.zeros(4, np.float32)
    futs = [b.submit(obs) for _ in range(6)]
    stopper = threading.Thread(target=b.stop, kwargs={"drain": True})
    stopper.start()
    try:
        time.sleep(0.02)
        with pytest.raises(ShedError, match="draining|queue_full"):
            for _ in range(40):  # racing the drain flag; one of them must shed
                b.submit(obs)
    finally:
        stopper.join(timeout=30)
    assert not stopper.is_alive()
    for f in futs:
        assert f.result(5).shape == (2,)  # everything admitted was answered


def test_batcher_hot_swap_no_recapture_and_validates():
    actor = torch_actor(CFG, 8)
    b = DynamicBatcher(CFG, actor.state_dict(), max_batch=4, max_wait_us=100, queue_limit=16,
                       device="cpu")
    b.start()
    try:
        obs = np.ones(4, np.float32)
        a_old = b.submit(obs).result(30)
        captures = b.compile_count
        assert captures == len(b.buckets)  # warmup built each bucket once
        bumped = {k: v + 0.25 for k, v in actor.state_dict().items()}
        b.set_params(bumped)
        a_new = b.submit(obs).result(30)
        assert b.compile_count == captures  # the whole point of hot reload
        assert b.rebound_params() == []  # the swap copied into the captured params
        assert not np.allclose(a_old, a_new)  # new params actually serve
        with torch.no_grad():
            actor.load_state_dict(bumped)
            ref = actor(torch.from_numpy(obs)[None]).clamp(-1, 1)[0].numpy()
        np.testing.assert_allclose(a_new, ref, rtol=1e-5, atol=1e-6)
        wide = Actor(4, 2, (16, 16)).state_dict()
        with pytest.raises(ValueError, match="shape"):
            b.set_params(wide)
        with pytest.raises(ValueError, match="structure"):
            b.set_params({k: v for k, v in bumped.items() if k != "out.bias"})
        assert b.stats.params_reloads == 1
        assert b.replays == b.stats.batches_total
    finally:
        b.stop()


def test_batcher_pads_to_buckets_and_counts():
    b = _slow_batcher(0.05, max_batch=8, max_wait_us=50_000, queue_limit=64)
    b.start()
    try:
        obs = np.zeros(4, np.float32)
        # 3 requests land within one window → bucket 4, one padded row
        futs = [b.submit(obs) for _ in range(3)]
        for f in futs:
            f.result(30)
        hist = b.stats.batch_hist.snapshot()
        assert hist["le_4"] >= 1
        assert b.stats.padded_rows_total >= 1
    finally:
        b.stop()


def test_batcher_under_sixteen_submitting_threads_answers_each_row_its_own():
    """16 threads (more than this host's cores) submit distinct rows with a
    short switch interval: every future gets its own row's action, and the
    counters balance (no lost update, no row handed to another future)."""
    import sys

    actor = torch_actor(CFG, 12)
    b = DynamicBatcher(CFG, actor.state_dict(), max_batch=8, max_wait_us=100, queue_limit=512,
                       device="cpu")
    obs = np.random.default_rng(13).normal(size=(16, 20, 4)).astype(np.float32)
    got = np.zeros((16, 20, 2), np.float32)
    start = threading.Barrier(16)

    def work(t):
        start.wait(timeout=30)
        futs = [b.submit(o) for o in obs[t]]
        for i, f in enumerate(futs):
            got[t, i] = f.result(60)

    b.start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        b.stop()
    assert not any(t.is_alive() for t in threads)
    want = _forward_rows(actor, obs.reshape(-1, 4)).reshape(16, 20, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    snap = b.stats.snapshot()
    assert snap["requests_total"] == snap["replies_ok"] == 320 and snap["inflight"] == 0
    assert b.replays == snap["batches_total"]


def _forward_rows(actor, obs):
    with torch.no_grad():
        return actor(torch.from_numpy(obs)).clamp(-1.0, 1.0).numpy()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_dead_device_thread_fails_every_pending_future():
    """The device thread re-raises its fault after failing every pending
    future (the thread's exception is the expected outcome)."""
    b = DynamicBatcher(CFG, torch_actor(CFG, 0).state_dict(), max_batch=2, max_wait_us=0,
                       queue_limit=16, device="cpu")

    def boom(*args):
        time.sleep(0.05)
        raise RuntimeError("device fault")

    b._infer = boom
    b.start()
    try:
        futs = [b.submit(np.zeros(4, np.float32)) for _ in range(6)]
        for f in futs:
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(30)
        with pytest.raises(RuntimeError, match="died"):
            b.submit(np.zeros(4, np.float32))
    finally:
        b.stop()


# ---------------------------------------------------------------------- CLI
def test_every_jax_serve_flag_is_parsed_or_refused_by_name():
    from d4pg_tpu.serve.__main__ import build_parser as j_build_parser
    from d4pg_tpu_torch.serve.__main__ import build_parser

    ours = {o for a in build_parser()._actions for o in a.option_strings}
    ref = [o for a in j_build_parser()._actions for o in a.option_strings]
    assert len(ref) > 20
    # every JAX flag is parsed since the flywheel's mirror flags were ported
    assert set(ref) <= ours, sorted(set(ref) - ours)
    assert "--device" in ours and "--debug-guards" in ours
    mirror = {"--mirror-fraction", "--mirror-ingest", "--mirror-spool"}
    assert mirror <= ours
    args = build_parser().parse_args(["--bundle", "b", "--mirror-fraction", "0.5",
                                      "--mirror-ingest", "h:1", "--mirror-spool", "s"])
    assert (args.mirror_fraction, args.mirror_ingest, args.mirror_spool) == (0.5, "h:1", "s")


def test_serve_cli_raises_without_a_card(monkeypatch, tmp_path):
    from d4pg_tpu_torch.serve.__main__ import main

    export_bundle(str(tmp_path), CFG, torch_actor(CFG, 0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--bundle", str(tmp_path), "--port", "0"])
    # --chaos is ported (ROADMAP A11 (e1)): parsed, then the device rule
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--bundle", str(tmp_path), "--chaos", "sock_reset@3"])


def _export_argv(run, bundle):
    return ["--device", "cpu", "--env", "pendulum", "--hidden-sizes", "16,16",
            "--log-dir", str(run), "--export-bundle", str(bundle)]


def test_export_bundle_from_best_actor(tmp_path):
    from d4pg_tpu_torch.train import main
    from d4pg_tpu_torch.weights import save_best_actor

    run = tmp_path / "run"
    actor = Actor(3, 1, (16, 16), generator=torch.Generator().manual_seed(9))
    save_best_actor(str(run), actor)
    with open(run / "best_eval.json", "w") as f:
        json.dump({"step": 7, "eval_return_mean": -150.0, "env_steps": 99}, f)
    at_best = {"count": 5.0, "mean": [1.0] * 3, "m2": [5.0] * 3}
    with open(run / "checkpoints" / "trainer_meta.json", "w") as f:
        json.dump({"env_steps": 123, "ewma_return": 0.0,
                   "obs_norm": {"count": 99.0, "mean": [9.0] * 3, "m2": [9.0] * 3}}, f)
    with open(run / "checkpoints" / "best_obs_norm.json", "w") as f:
        json.dump(at_best, f)
    main(_export_argv(run, tmp_path / "bundle"))
    b = load_bundle(str(tmp_path / "bundle"))
    assert (b.config.obs_dim, b.config.action_dim, b.config.hidden_sizes) == (3, 1, (16, 16))
    assert (b.config.dist.v_min, b.config.dist.v_max) == (-300.0, 0.0)
    for k, v in actor.state_dict().items():
        assert torch.equal(b.actor_params[k], v), k
    assert b.meta["source"] == "best_actor.npz" and b.meta["best_eval"]["step"] == 7
    assert b.meta["env_steps"] == 123
    assert b.obs_norm == at_best  # the paired snapshot, not the drifted meta
    np.testing.assert_array_equal(b.action_low, [-1.0])
    jb = jbundle.load_bundle(str(tmp_path / "bundle"))
    assert jb.config.hidden_sizes == (16, 16) and jb.config.prioritized is True


def test_export_bundle_from_the_newest_checkpoint(tmp_path):
    from d4pg_tpu_torch.agent import create_train_state
    from d4pg_tpu_torch.config import TrainConfig, apply_env_preset
    from d4pg_tpu_torch.runtime.checkpoint import CheckpointManager
    from d4pg_tpu_torch.train import main

    run = tmp_path / "run"
    with pytest.raises(SystemExit, match="no best_actor.npz and no checkpoint"):
        main(_export_argv(run, tmp_path / "bundle"))
    cfg = apply_env_preset(TrainConfig(env="pendulum", agent=D4PGConfig(hidden_sizes=(16, 16))))
    mgr = CheckpointManager(str(run / "checkpoints"))
    old = create_train_state(cfg.agent, 1, device="cpu")
    mgr.save(8, old)
    state = create_train_state(cfg.agent, 2, device="cpu")
    mgr.save(16, state)
    main(_export_argv(run, tmp_path / "bundle") + ["--no-p-replay"])
    b = load_bundle(str(tmp_path / "bundle"))
    for k, v in state.actor.state_dict().items():
        assert torch.equal(b.actor_params[k], v), k
    assert b.meta["source"] == "state:16" and b.meta["grad_steps"] == 16
    assert jbundle.load_bundle(str(tmp_path / "bundle")).config.prioritized is False
