"""The port's checkpoint contract against the JAX package, on the CPU.

Where a file is shared between the packages (the manifests,
``trainer_meta.json``, ``best_eval.json``, ``best_actor.npz``,
``replay.npz`` and ``device_per.npz``) the port writes what the JAX
package reads and reads what it writes: equal manifests and verdicts,
byte-identical JSON, equal arrays and equal PER draws after a restore in
either direction. The step directories are the port's own (``state.pt``);
its :class:`CheckpointManager` is held to the behaviour of
``tests/test_crash_consistency.py``, its trainer to ``--resume`` giving
back every tensor bit for bit, and preemption to
``tests/test_preemption.py``.

Tolerances: none, except the actor forward across the two packages
(1e-6 absolute, float32 matmuls in another order).
"""

import os
import signal
import subprocess
import sys
import threading
import time
import zipfile

import jax
import numpy as np
import pytest
import torch

from d4pg_tpu.chaos import truncate_checkpoint_step
from d4pg_tpu.models.actor import Actor as JActor
from d4pg_tpu.replay.device_per import DevicePerSync as JDevicePerSync
from d4pg_tpu.replay.device_per import tree_from_priorities as j_tree_from_priorities
from d4pg_tpu.replay.per import PrioritizedReplayBuffer as JPER
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplay
from d4pg_tpu.replay.uniform import Transition as JTransition
from d4pg_tpu.runtime import checkpoint as jckpt
from d4pg_tpu.runtime import manifest as jman
from d4pg_tpu.runtime.trainer import load_best_actor as j_load_best_actor
from d4pg_tpu_torch.agent import D4PGConfig, create_train_state, train_step
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.models import Actor
from d4pg_tpu_torch.replay import PrioritizedReplayBuffer, ReplayBuffer, Transition
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.runtime import checkpoint as ckpt
from d4pg_tpu_torch.runtime import manifest as man
from d4pg_tpu_torch.runtime.trainer import Trainer
from d4pg_tpu_torch.train import install_preemption_handlers
from d4pg_tpu_torch.weights import (
    load_best_actor,
    load_jax_params,
    state_dict_to_flax,
    to_jax_params,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAUGHT = (OSError, ValueError, KeyError, zipfile.BadZipFile)
AGENT = D4PGConfig(hidden_sizes=(8, 8))


# ------------------------------------------------------------- manifests
def _write(path, nbytes, seed):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(np.random.default_rng(seed).bytes(nbytes))


def _run_dir(root, steps=(7,)):
    """A run: step directories with two files each, a small side file in
    ``checkpoints/`` and one above it, and a side file over the (lowered)
    digest limit, recorded by size only."""
    ck = root / "checkpoints"
    for s in steps:
        _write(ck / str(s) / "state.pt", 300 + s, s)
        _write(ck / str(s) / "sub" / "extra.bin", 40, 100 + s)
    _write(ck / "trainer_meta.json", 30, 1)
    _write(ck / "replay.npz", 200, 2)
    _write(root / "best_eval.json", 20, 3)
    sides = [str(ck / "trainer_meta.json"), str(ck / "replay.npz"), str(root / "best_eval.json")]
    return ck, sides


@pytest.fixture
def small_digest_limit(monkeypatch):
    for mod in (man, jman):
        monkeypatch.setattr(mod, "SIDE_DIGEST_MAX_BYTES", 64)


def test_build_manifest_equals_the_reference(tmp_path, small_digest_limit):
    ck, sides = _run_dir(tmp_path)
    ours = man.build_manifest(7, str(ck / "7"), sides)
    assert ours == jman.build_manifest(7, str(ck / "7"), sides)
    assert "sha256" not in ours["side"]["replay.npz"]  # over the limit: size only
    assert set(ours["files"]) == {"state.pt", "sub/extra.bin"}


def _damage(case, ck):
    if case == "truncated":
        truncate_checkpoint_step(str(ck / "7"))
    elif case == "missing_file":
        os.remove(ck / "7" / "sub" / "extra.bin")
    elif case == "missing_manifest":
        os.remove(man.manifest_path(str(ck), 7))
    elif case == "side_drift":
        _write(ck / "trainer_meta.json", 31, 9)


@pytest.mark.parametrize("case", ["intact", "truncated", "missing_file", "missing_manifest", "side_drift"])
def test_verify_step_dir_gives_the_reference_verdict(case, tmp_path, small_digest_limit):
    ck, sides = _run_dir(tmp_path)
    man.write_manifest_file(man.manifest_path(str(ck), 7), man.build_manifest(7, str(ck / "7"), sides))
    _damage(case, ck)
    ours = man.verify_step_dir(str(ck), 7, man.default_step_dir(str(ck), 7))
    ref = jman.verify_step_dir(str(ck), 7, jman.default_step_dir(str(ck), 7))
    assert ours == ref
    assert ours[0] == (case in ("intact", "side_drift"))
    assert bool(ours[2]) == (case == "side_drift")


def test_intact_steps_and_fork_copy_what_the_reference_copies(tmp_path):
    src, sides = _run_dir(tmp_path / "src", steps=(1, 2, 3))
    for s in (1, 2, 3):
        man.write_manifest_file(man.manifest_path(str(src), s),
                                man.build_manifest(s, str(src / str(s)), sides))
    truncate_checkpoint_step(str(src / "3"))
    assert man.intact_steps(str(src)) == jman.intact_steps(str(src)) == [1, 2]
    ours = man.fork_checkpoint(str(src), str(tmp_path / "a" / "checkpoints"))
    ref = jman.fork_checkpoint(str(src), str(tmp_path / "b" / "checkpoints"))
    assert ours == ref == [1, 2]

    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert listing(tmp_path / "a") == listing(tmp_path / "b")
    assert man.intact_steps(str(tmp_path / "a" / "checkpoints")) == [1, 2]


# ------------------------------------------------------ CheckpointManager
def _state(seed=0, steps=0):
    """A tiny CPU TrainState after ``steps`` train steps (Adam moments and
    step entries populated)."""
    st = create_train_state(AGENT, seed, "cpu")
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        batch = {
            "obs": rng.normal(size=(8, 3)), "action": rng.uniform(-1, 1, size=(8, 1)),
            "reward": rng.uniform(-16, 0, size=8), "next_obs": rng.normal(size=(8, 3)),
            "discount": np.full(8, 0.97),
        }
        train_step(AGENT, st, {k: torch.tensor(v, dtype=torch.float32) for k, v in batch.items()})
    return st


def _tensors(state):
    """(name, tensor) for every tensor a checkpoint holds."""
    for name in ckpt.NETWORKS:
        for k, v in getattr(state, name).state_dict().items():
            yield f"{name}.{k}", v
    for name in ckpt.OPTIMIZERS:
        opt = getattr(state, name)
        for i, p in enumerate(opt.param_groups[0]["params"]):
            for k, v in sorted(opt.state[p].items()):
                yield f"{name}.{i}.{k}", v


def assert_states_equal(a, b):
    assert a.step == b.step
    ta, tb = dict(_tensors(a)), dict(_tensors(b))
    assert ta.keys() == tb.keys() and len(ta) > 0
    for k in ta:
        assert ta[k].device == tb[k].device, k
        assert torch.equal(ta[k], tb[k]), k


def _save_attested(mgr, step, state):
    state.step = step
    mgr.save(step, state)
    mgr.write_manifest(step)


def _round_trip(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "checkpoints"))
    saved = _state(0, steps=2)
    _save_attested(mgr, 2, saved)
    live = _state(5)
    opt_params = live.actor_opt.param_groups[0]["params"]
    restored = mgr.restore(live)
    assert restored is live
    assert_states_equal(live, saved)
    # restored in place: the optimizer still steps the live parameters
    assert all(a is b for a, b in zip(opt_params, live.actor.parameters()))
    assert all(st["step"].device.type == "cpu" for st in live.critic_opt.state.values())


def _max_to_keep(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "checkpoints"), max_to_keep=2)
    st = _state()
    for s in (1, 2, 3):
        _save_attested(mgr, s, st)
    assert mgr.all_steps() == [2, 3]
    assert not os.path.exists(mgr.manifest_path(1)) and os.path.exists(mgr.manifest_path(3))


def _stale_dir(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "checkpoints"))
    st = _state()
    _save_attested(mgr, 2000, st)
    with pytest.raises(RuntimeError, match="--resume, or use a fresh"):
        mgr.save(4, st)
    mgr.save(2000, st)  # the same step again: skipped, no error
    assert mgr.all_steps() == [2000]


def _truncation_fallback(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "checkpoints"))
    one = _state(1, steps=1)
    _save_attested(mgr, 1, one)
    _save_attested(mgr, 2, _state(2, steps=1))
    truncate_checkpoint_step(mgr.step_dir(2))
    restored, step, fallbacks = mgr.restore_verified(_state(3))
    assert step == 1 and len(fallbacks) == 1 and "step 2" in fallbacks[0]
    assert_states_equal(restored, one)
    assert mgr.all_steps() == [1] and not os.path.exists(mgr.manifest_path(2))
    _save_attested(mgr, 2, _state(2))  # the pruned branch does not collide
    assert mgr.restore_verified(_state())[1:] == (2, [])


def _uncommitted(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "checkpoints"))
    _save_attested(mgr, 1, _state())
    mgr.save(2, _state())  # on disk, but no manifest: never committed
    _, step, fallbacks = mgr.restore_verified(_state())
    assert step == 1 and "no manifest" in fallbacks[0]
    assert mgr.all_steps() == [1]


def _legacy(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "checkpoints"))
    st = _state()
    for s in (1, 2):
        st.step = s
        mgr.save(s, st)
    restored, step, fallbacks = mgr.restore_verified(_state())
    assert (step, fallbacks, restored.step) == (2, [], 2)


def _delete(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "checkpoints"))
    _save_attested(mgr, 1, _state())
    mgr.delete(1)
    assert not os.path.exists(mgr.manifest_path(1)) and mgr.all_steps() == []


@pytest.mark.parametrize("case", [_round_trip, _max_to_keep, _stale_dir, _truncation_fallback,
                                  _uncommitted, _legacy, _delete], ids=lambda f: f.__name__[1:])
def test_checkpoint_manager_contract(case, tmp_path):
    case(tmp_path)


# ------------------------------------------------ trainer meta, best eval
@pytest.mark.parametrize("ewma", [None, -123.456789])
def test_trainer_meta_and_best_eval_are_the_reference_bytes(ewma, tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        os.makedirs(d / "checkpoints")
    ckpt.save_trainer_meta(str(a), 4096, ewma)
    jckpt.save_trainer_meta(str(b), 4096, ewma)
    assert open(ckpt.trainer_meta_path(str(a)), "rb").read() == \
        open(jckpt.trainer_meta_path(str(b)), "rb").read()
    ckpt.save_best_eval(str(a), 208, -150.25, 4096)
    jckpt.save_best_eval(str(b), 208, -150.25, 4096)
    assert open(ckpt.best_eval_path(str(a)), "rb").read() == \
        open(jckpt.best_eval_path(str(b)), "rb").read()
    assert ckpt.load_trainer_meta(str(b)) == jckpt.load_trainer_meta(str(a))
    ckpt.invalidate_best_eval(str(a))
    assert not os.path.exists(ckpt.best_eval_path(str(a)))


def test_torn_trainer_meta_reads_as_empty(tmp_path):
    assert ckpt.load_trainer_meta(str(tmp_path)) == {}
    os.makedirs(tmp_path / "checkpoints")
    with open(ckpt.trainer_meta_path(str(tmp_path)), "w") as f:
        f.write('{"env_steps": 123, "ewma_re')
    assert ckpt.load_trainer_meta(str(tmp_path)) == {}


# ---------------------------------------------------------- replay interop
CAP = 64


def _fill(buf, transition, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n // 16):
        buf.add_batch(transition(
            rng.normal(size=(16, 3)).astype(np.float32),
            rng.uniform(-1, 1, size=(16, 1)).astype(np.float32),
            rng.normal(size=16).astype(np.float32),
            rng.normal(size=(16, 3)).astype(np.float32),
            rng.uniform(0, 1, size=16).astype(np.float32),
        ))


def _make(pkg, kind, capacity=CAP):
    if pkg == "jax":
        return JReplay(capacity, 3, 1) if kind == "uniform" else \
            JPER(capacity, 3, 1, beta_steps=50, tree_backend="numpy")
    return ReplayBuffer(capacity, 3, 1) if kind == "uniform" else \
        PrioritizedReplayBuffer(capacity, 3, 1, beta_steps=50)


@pytest.mark.parametrize("wrapped", [False, True], ids=["partial", "wrapped"])
@pytest.mark.parametrize("kind", ["uniform", "per"])
@pytest.mark.parametrize("source", ["jax", "port"])
def test_replay_snapshot_restores_in_both_packages(source, kind, wrapped, tmp_path):
    src = _make(source, kind)
    _fill(src, JTransition if source == "jax" else Transition, 96 if wrapped else 48, seed=0)
    if kind == "per":
        rng = np.random.default_rng(1)
        idx = rng.integers(0, len(src), 24)
        src.update_priorities(idx, rng.gamma(2.0, size=24))
        src._sum.set(np.array([5]), np.array([0.0]))  # a zero leaf: re-seeded on restore
    snap = str(tmp_path / "replay.npz")
    src.snapshot(snap)
    with np.load(snap) as z:
        assert sorted(z.files) == sorted(
            ["obs", "action", "reward", "next_obs", "discount", "pos", "size"]
            + (["tree_priorities", "max_priority"] if kind == "per" else []))
    ours, ref = _make("port", kind), _make("jax", kind)
    assert ours.restore(snap) == ref.restore(snap) == len(src)
    for buf in (ours, ref):
        # the lifetime count is re-derived from the write head and the fill
        assert (buf._pos, buf._size) == (src._pos, src._size)
        assert buf.total_added == (src._pos + CAP if wrapped else len(src))
        for k in ("obs", "action", "reward", "next_obs", "discount"):
            np.testing.assert_array_equal(getattr(buf, k), getattr(src, k))
    if kind == "per":
        assert ours._max_priority == ref._max_priority == src._max_priority
        np.testing.assert_array_equal(ours._sum.tree, ref._sum.tree)
        np.testing.assert_array_equal(ours._min.tree, ref._min.tree)
        assert ours._sum.get(np.array([5]))[0] == ours._max_priority ** ours.alpha
        a = ours.sample(16, np.random.default_rng(7), step=30)
        b = ref.sample(16, np.random.default_rng(7), step=30)
        np.testing.assert_array_equal(a["indices"].idx, b["indices"].idx)
        np.testing.assert_array_equal(a["weights"], b["weights"])


def test_uniform_snapshot_into_per_seeds_max_priority_and_clears_the_tail(tmp_path):
    src = ReplayBuffer(CAP, 3, 1)
    _fill(src, Transition, 32, seed=3)
    src.snapshot(str(tmp_path / "r.npz"))
    ours, ref = _make("port", "per"), _make("jax", "per")
    for buf, tr in ((ours, Transition), (ref, JTransition)):
        _fill(buf, tr, 64, seed=4)  # a used buffer: stale mass past row 32
        buf.update_priorities(np.arange(64), np.full(64, 3.0))
        buf.restore(str(tmp_path / "r.npz"))
    np.testing.assert_array_equal(ours._sum.tree, ref._sum.tree)
    np.testing.assert_array_equal(ours._min.tree, ref._min.tree)
    assert ours._sum.sum() == pytest.approx(32 * ours._max_priority ** ours.alpha)


def test_restore_refuses_a_smaller_buffer_and_a_torn_file(tmp_path):
    src = ReplayBuffer(CAP, 3, 1)
    _fill(src, Transition, 48, seed=0)
    snap = tmp_path / "replay.npz"
    src.snapshot(str(snap))
    with pytest.raises(ValueError, match="rmsize"):
        ReplayBuffer(32, 3, 1).restore(str(snap))
    with pytest.raises(ValueError, match="obs_dim"):
        ReplayBuffer(CAP, 4, 1).restore(str(snap))
    raw = snap.read_bytes()
    snap.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(CAUGHT):
        ReplayBuffer(CAP, 3, 1).restore(str(snap))


# --------------------------------------------------------- device sidecar
def test_device_per_sidecar_equals_the_reference():
    cap, alpha = 200, 0.6
    rng = np.random.default_rng(0)
    pa = (rng.gamma(2.0, size=cap) ** alpha).astype(np.float32)
    pa[150:] = 0.0  # rows the ring never filled
    ours = dper.DevicePerSync(cap, alpha, device="cpu")
    ref = JDevicePerSync(cap, alpha)
    ours.restore_host(pa, 2.5)
    ref.restore_host(pa, 2.5)
    got, ref_got = ours.snapshot_host(), ref.snapshot_host()
    np.testing.assert_array_equal(got[0], ref_got[0])
    assert got[1] == ref_got[1] == 2.5
    np.testing.assert_array_equal(
        ours.tree.sums.numpy(), np.asarray(j_tree_from_priorities(pa, cap).sums)[0])


def test_device_per_sidecar_restores_a_live_tree_bit_for_bit():
    """A tree built by the trainer's incremental writes (ingest seeds, then
    last-wins write-backs) snapshots and rebuilds to the same bits."""
    cap, alpha = 300, 0.6
    live = dper.DevicePerSync(cap, alpha, device="cpu")
    gen = torch.Generator().manual_seed(0)
    live.on_chunk(torch.arange(0, 256))
    for _ in range(5):
        idx = torch.randint(0, 256, (64,), generator=gen)
        dper.write_back_lane(live.tree.sums, idx, torch.rand(64, generator=gen) * 5, alpha, 1e-6, cap)
    pa, mp = live.snapshot_host()
    again = dper.DevicePerSync(cap, alpha, device="cpu")
    again.restore_host(pa, mp)
    assert torch.equal(again.tree.sums, live.tree.sums)
    assert torch.equal(again.tree.max_priority, live.tree.max_priority)


# -------------------------------------------------------------- best actor
def _j_actor(hidden):
    return JActor(action_dim=1, hidden_sizes=hidden)


def test_best_actor_npz_loads_in_the_reference(tmp_path):
    t = _trainer(tmp_path, total_steps=4, eval_interval=4)
    t.train()
    t.close()  # one eval, at the end: the champion is the final actor
    obs = np.random.default_rng(0).normal(size=(32, 3)).astype(np.float32)
    template = _j_actor((16, 16)).init(jax.random.PRNGKey(1), obs)
    params = j_load_best_actor(str(tmp_path), template)
    want = t.state.actor(torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(np.asarray(_j_actor((16, 16)).apply(params, obs)), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="hidden-sizes"):
        j_load_best_actor(str(tmp_path), _j_actor((16, 8)).init(jax.random.PRNGKey(1), obs))


def test_reference_best_actor_npz_loads_into_the_port(tmp_path):
    obs = np.random.default_rng(1).normal(size=(32, 3)).astype(np.float32)
    params = _j_actor((16, 16)).init(jax.random.PRNGKey(3), obs)
    # the JAX trainer's _save_best layout
    leaves = jax.tree_util.tree_leaves(jax.device_get(params))
    os.makedirs(tmp_path / "checkpoints")
    np.savez(tmp_path / "checkpoints" / "best_actor.npz",
             **{f"leaf_{i:04d}": np.asarray(x) for i, x in enumerate(leaves)})
    actor = load_best_actor(str(tmp_path), Actor(3, 1, (16, 16)))
    got = actor(torch.from_numpy(obs)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(_j_actor((16, 16)).apply(params, obs)), rtol=0, atol=1e-6)
    flax = state_dict_to_flax(actor)["params"]
    np.testing.assert_array_equal(flax["hidden_0"]["kernel"], params["params"]["hidden_0"]["kernel"])
    with pytest.raises(ValueError, match="hidden-sizes"):
        load_best_actor(str(tmp_path), Actor(3, 1, (16, 8)))


def test_to_jax_params_apply_in_the_reference_and_round_trip():
    state = _state(4, steps=1)
    actor_params, critic_params = to_jax_params(state)
    obs = np.random.default_rng(2).normal(size=(16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(_j_actor((8, 8)).apply(actor_params, obs)),
        state.actor(torch.from_numpy(obs)).detach().numpy(), rtol=0, atol=1e-6)
    fresh = _state(9)
    load_jax_params(fresh, actor_params, critic_params)
    for name in ("actor", "critic"):
        for k, v in getattr(state, name).state_dict().items():
            assert torch.equal(getattr(fresh, name).state_dict()[k], v), (name, k)


# ------------------------------------------------------------------ resume
def _trainer(tmp_path, device_placement=False, **kw):
    base = dict(num_envs=2, batch_size=8, warmup_steps=64, total_steps=8, eval_interval=8,
                eval_episodes=1, replay_capacity=512, checkpoint_interval=4,
                snapshot_replay=True, log_dir=str(tmp_path),
                agent=D4PGConfig(hidden_sizes=(16, 16)))
    if device_placement:
        base.update(replay_placement="device", steps_per_dispatch=4, fused_descent=True,
                    debug_guards=True)
    base.update(kw)
    return Trainer(TrainConfig(**base), device="cpu")


def _resumed(t, **kw):
    import dataclasses

    return Trainer(dataclasses.replace(t.config, resume=True, **kw), device="cpu")


@pytest.mark.parametrize("placement", ["host", "device"])
def test_resume_gives_back_every_tensor(placement, tmp_path):
    t1 = _trainer(tmp_path, placement == "device")
    t1.train()
    t1.close()
    assert t1.ckpt.all_steps() == [4, 8]
    t2 = _resumed(t1)
    assert (t2.grad_steps, t2.env_steps, t2.ewma_return, t2._best_eval) == \
        (t1.grad_steps, t1.env_steps, t1.ewma_return, t1._best_eval)
    assert t2._noise_scale() == t1._noise_scale() and t2._ckpt_fallbacks == 0
    assert_states_equal(t2.state, t1.state)
    assert t2._replay_restored and t2._effective_warmup() == 0
    assert (len(t2.buffer), t2.buffer._pos, t2.buffer.total_added) == \
        (len(t1.buffer), t1.buffer._pos, t1.buffer.total_added)
    n = len(t1.buffer)
    for k in ("obs", "action", "reward", "next_obs", "discount"):
        np.testing.assert_array_equal(getattr(t2.buffer, k)[:n], getattr(t1.buffer, k)[:n])
    t2.warmup()
    assert t2.env_steps == t1.env_steps  # the warmup was skipped
    if placement == "host":
        with np.load(t1._replay_snapshot_path()) as z:
            np.testing.assert_array_equal(t2.buffer._sum.get(np.arange(n)), z["tree_priorities"])
        return
    assert torch.equal(t2._ring.size, t1._ring.size)
    for k in ("obs", "action", "reward", "next_obs", "discount"):
        assert torch.equal(getattr(t2._ring, k)[:n], getattr(t1._ring, k)[:n]), k
    assert torch.equal(t2._dev_per.tree.sums, t1._dev_per.tree.sums)
    assert torch.equal(t2._dev_per.tree.max_priority, t1._dev_per.tree.max_priority)
    # one dispatch on each, from the same generator state: the same bits
    t2._megastep_gen.set_state(t1._megastep_gen.get_state())
    t1._megastep_dispatch_once()
    t2._megastep_dispatch_once()
    assert_states_equal(t2.state, t1.state)
    assert torch.equal(t2._dev_per.tree.sums, t1._dev_per.tree.sums)


def test_resume_falls_back_past_a_torn_step_and_says_so(tmp_path):
    from tools.d4pglint.schema_check import check_metrics_jsonl

    t1 = _trainer(tmp_path, True)
    t1.train()
    t1.close()
    truncate_checkpoint_step(t1.ckpt.step_dir(8))
    t2 = _resumed(t1)
    assert (t2.grad_steps, t2._ckpt_fallbacks, t2.ckpt.all_steps()) == (4, 1, [4])
    row = t2.train(total_steps=4)
    t2.close()
    assert row["checkpoint_fallbacks"] == 1.0
    assert t2.ckpt.all_steps() == [4, 8]  # the resumed leg re-saved step 8
    assert check_metrics_jsonl(str(tmp_path / "metrics.jsonl")) == []


def test_torn_replay_snapshot_degrades_to_an_empty_buffer(tmp_path, capsys):
    t1 = _trainer(tmp_path)
    t1.train()
    t1.close()
    path = t1._replay_snapshot_path()
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])
    t2 = _resumed(t1)
    assert not t2._replay_restored and len(t2.buffer) == 0 and t2.grad_steps == 8
    assert "unreadable" in capsys.readouterr().out
    t2.close()


# -------------------------------------------------------------- preemption
def test_preempt_before_train_checkpoints_and_stops(tmp_path):
    t = _trainer(tmp_path)
    t.request_preemption()
    out = t.train()
    t.close()
    assert t.preempted and out == {} and t.grad_steps == 0
    assert os.path.exists(ckpt.trainer_meta_path(str(tmp_path)))
    assert t.ckpt.latest_step() == 0 and t.ckpt.verify_step(0)[0]


def test_preempt_in_warmup_on_device_placement_resumes_with_live_priorities(tmp_path):
    # the warmup's rows reach the ring (and the tree) only at a dispatch;
    # the preemption save must flush them so the sidecar is not all zeros
    t = _trainer(tmp_path, True)
    t._collect_once(noise_scale=3.0)  # some warmup rows, none dispatched
    t.request_preemption()
    assert t.train() == {} and t.preempted
    t.close()
    n = len(t.buffer)
    with np.load(t._device_per_snapshot_path()) as z:
        assert (z["priorities_alpha"][:n] > 0).all()
    t2 = _resumed(t)
    assert t2._replay_restored and len(t2.buffer) == n and int(t2._ring.size) == n
    sums = t2._dev_per.tree.sums
    leaves = sums[sums.shape[0] // 2:]
    assert float(sums[1]) > 0
    assert torch.equal(sums[1], leaves[:n].sum()) and not leaves[n:].any()
    row = t2.train(total_steps=4)
    t2.close()
    assert all(np.isfinite(v) for v in row.values() if isinstance(v, float))


def test_rss_watchdog_checkpoints_and_stops(tmp_path, capsys):
    t = _trainer(tmp_path, total_steps=16, eval_interval=4, checkpoint_interval=1000,
                 max_rss_gb=1e-6)  # below any live RSS: it fires at the first eval
    t.train()
    t.close()
    assert t.preempted and t.grad_steps == 4
    assert t.ckpt.latest_step() == 4 and t.ckpt.verify_step(4)[0]
    assert "[rss-watchdog]" in capsys.readouterr().out


@pytest.mark.parametrize("placement", ["host", "device"])
def test_preempt_mid_train_saves_and_resumes(placement, tmp_path):
    # total_steps only bounds the run should the preemption never land
    t = _trainer(tmp_path, placement == "device", total_steps=400,
                 checkpoint_interval=1000, eval_interval=1000)

    def arm():
        while t.grad_steps < 4:
            time.sleep(0.005)
        t.request_preemption()

    th = threading.Thread(target=arm, daemon=True)
    th.start()
    t.train()
    th.join(timeout=30)
    assert not th.is_alive()
    t.close()
    saved = t.ckpt.latest_step()
    assert t.preempted and saved == t.grad_steps >= 4
    assert t.ckpt.verify_step(saved)[0]
    t2 = _resumed(t)
    assert t2.grad_steps == saved and t2._replay_restored
    t2.close()


def test_install_preemption_handlers_wiring():
    fired = []
    old_term, old_int = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        install_preemption_handlers(lambda: fired.append(True))
        signal.raise_signal(signal.SIGTERM)
        assert fired == [True]
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
        assert signal.getsignal(signal.SIGINT) is not signal.SIG_DFL
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)


def _cli_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return env


@pytest.mark.slow
def test_sigterm_on_a_live_cli_run_exits_75(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, "-m", "d4pg_tpu_torch.train", "--device", "cpu", "--hidden-sizes", "16,16",
         "--num-envs", "2", "--bsize", "8", "--warmup", "64", "--rmsize", "4096",
         "--total-steps", "100000", "--eval-interval", "100000",
         "--checkpoint-interval", "100000", "--snapshot-replay", "--log-dir", str(tmp_path)],
        cwd=REPO, env=_cli_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        deadline = time.monotonic() + 120
        for line in proc.stdout:  # wait until it trains
            if line.startswith("config:") or time.monotonic() > deadline:
                break
        time.sleep(3.0)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 75, out[-2000:]
    assert os.path.exists(ckpt.trainer_meta_path(str(tmp_path)))
    assert os.path.exists(tmp_path / "checkpoints" / "replay.npz")
