"""The port's recompile sentinel (``d4pg_tpu_torch/analysis/recompile.py``)
over its compiled programs (``d4pg_tpu_torch/utils/graphs.py``), held
against the JAX sentinel over ``jax.jit`` on the same call scripts, and
wired where the JAX package wires it: the trainer's learner entries and
the server's ``<name>.infer``, on the CPU.

Counts, budgets and error texts are compared exactly: a specialization is
a signature in both packages. The JAX trainer also tracks its acting jits,
which the port does not have (its acting stays eager), so the trainers are
compared on the learner entries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.analysis import RecompileBudgetError as JBudgetError
from d4pg_tpu.analysis import RecompileSentinel as JSentinel
from d4pg_tpu_torch.analysis import RecompileBudgetError, RecompileSentinel
from d4pg_tpu_torch.utils import graphs

LEARNER_ENTRIES = ("train_step", "fused_step", "megastep", "ring_ingest", "tree_ingest")


def _program(fn):
    return graphs.Program("f", fn, device="cpu")


def _error(sentinel, exc, where=""):
    with pytest.raises(exc) as ei:
        sentinel.check(where)
    return str(ei.value)


# ------------------------------------------------------------ call scripts
def test_shape_drift_gives_the_jax_counts_budgets_and_error():
    """One program called on (3,), (3,), (4,), frozen after the first call."""
    f = jax.jit(lambda x: x * 2)
    g = _program(lambda x: x * 2)
    with JSentinel() as js, RecompileSentinel() as ts:
        js.track("f", f)
        ts.track("f", g)
        j0, t0 = js.total_compiles, ts.total_compiles
        f(jnp.ones(3))
        g(torch.ones(3))
        assert js.count("f") == ts.count("f") == 1
        assert js.total_compiles > j0 and ts.total_compiles == t0 + 1
        assert js.freeze() == ts.freeze() == {"f": 1}
        f(jnp.ones(3))
        g(torch.ones(3))
        assert js.check("steady") == ts.check("steady") == {"f": 1}
        f(jnp.ones(4))
        g(torch.ones(4))
        assert js.counts() == ts.counts() == {"f": 2}
        jerr = _error(js, JBudgetError, "steady")
        terr = _error(ts, RecompileBudgetError, "steady")
    assert terr == jerr
    assert "f: 2 compiles > budget 1" in terr
    # stopped: the build stream is no longer counted
    n = ts.total_compiles
    g(torch.ones(5))
    assert ts.total_compiles == n


def test_explicit_budget_and_unbudgeted_entries_give_the_jax_verdicts():
    """The two programs of the JAX test of the same name: an explicit budget
    of 2, an unbudgeted entry, then the budget pinned to 1."""
    jf, jg = jax.jit(lambda x: x + 1), jax.jit(lambda x: x - 1)
    tf, tg = _program(lambda x: x + 1), _program(lambda x: x - 1)
    js, ts = JSentinel(), RecompileSentinel()
    for s, f, g in ((js, jf, jg), (ts, tf, tg)):
        s.track("f", f, budget=2)
        s.track("g", g)
    for n in (2, 3):
        jf(jnp.ones(n))
        tf(torch.ones(n))
        jg(jnp.ones(n))
        tg(torch.ones(n))
    assert js.check() == ts.check() == {"f": 2, "g": 2}
    js.set_budget("f", 1)
    ts.set_budget("f", 1)
    assert _error(ts, RecompileBudgetError) == _error(js, JBudgetError)
    assert js.freeze(g=1) == ts.freeze(g=1) == {"f": 2, "g": 1}
    assert _error(ts, RecompileBudgetError, "x") == _error(js, JBudgetError, "x")


def test_a_dtype_change_and_a_pytree_change_are_new_specializations():
    jf = jax.jit(lambda d: d["a"] * 2)
    tf = _program(lambda d: d["a"] * 2)
    js, ts = JSentinel(), RecompileSentinel()
    js.track("f", jf)
    ts.track("f", tf)
    for jx, tx in ((jnp.ones(2), torch.ones(2)),
                   (jnp.ones(2, jnp.int32), torch.ones(2, dtype=torch.int32))):
        jf({"a": jx})
        tf({"a": tx})
    jf({"a": jnp.ones(2), "b": jnp.ones(2)})
    tf({"a": torch.ones(2), "b": torch.ones(2)})
    assert js.counts() == ts.counts() == {"f": 3}


def test_anything_not_a_program_counts_zero_as_a_non_jit_does():
    js, ts = JSentinel(), RecompileSentinel()
    js.track("eager", lambda x: x)
    ts.track("eager", lambda x: x)
    ts.track("none", None)
    js.track("none", None)
    assert js.counts() == ts.counts() == {"eager": 0, "none": 0}
    assert js.freeze() == ts.freeze()


# ----------------------------------------------------------- the trainers
def _configs(tmp_path, tag, **kw):
    """The JAX test's guarded config (tests/test_analysis_guards.py), in
    each package."""
    from d4pg_tpu.agent import D4PGConfig as JAgent
    from d4pg_tpu.config import TrainConfig as JTrain
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.config import TrainConfig

    base = dict(env="pendulum", total_steps=4, warmup_steps=32, batch_size=16, num_envs=2,
                eval_interval=1000, checkpoint_interval=1000, debug_guards=True,
                replay_capacity=4096)
    base.update(kw)
    # The JAX fused descent cannot run here (its Pallas tree calls pl.load,
    # which this jax lacks: ROADMAP C-i); its separate-kernels tier tracks
    # the same entries
    jbase = {k: v for k, v in base.items() if k != "fused_descent"}
    j = JTrain(log_dir=str(tmp_path / f"j_{tag}"), agent=JAgent(hidden_sizes=(16, 16)), **jbase)
    t = TrainConfig(log_dir=str(tmp_path / f"t_{tag}"), agent=D4PGConfig(hidden_sizes=(16, 16)),
                    **base)
    return j, t


PLACEMENTS = {
    "host": dict(),
    "host_prefetch": dict(prefetch=True),
    "host_k4": dict(steps_per_dispatch=4, total_steps=8),
    "device": dict(replay_placement="device", prioritized=True, steps_per_dispatch=4,
                   total_steps=8),
    "device_fused": dict(replay_placement="device", prioritized=True, fused_descent=True,
                         steps_per_dispatch=4, total_steps=8),
    "hybrid": dict(replay_placement="hybrid", prioritized=True, steps_per_dispatch=4,
                   total_steps=8),
    # the in-process lanes (conftest.py's 8 host devices give the JAX
    # trainer its dp x tp mesh)
    "host_dp": dict(dp=2),
    "host_dp_k4": dict(dp=2, steps_per_dispatch=4, total_steps=8),
    "host_hogwild_k4": dict(dp=2, dp_hogwild=True, steps_per_dispatch=4, total_steps=8),
    "host_dp_tp": dict(dp=2, tp=2, steps_per_dispatch=4, total_steps=8),
    "device_dp": dict(replay_placement="device", prioritized=True, dp=2, steps_per_dispatch=4,
                      total_steps=8),
}


@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_trainer_learner_entries_stay_flat_and_equal_the_jax_trainers(tmp_path, placement):
    """Under debug_guards: the learner entries after the first leg equal the
    JAX trainer's on the same config, and a second ``train()`` leg against
    the pinned budgets moves nothing."""
    from d4pg_tpu.runtime.trainer import Trainer as JTrainer
    from d4pg_tpu_torch.runtime.trainer import Trainer

    jcfg, tcfg = _configs(tmp_path, placement, **PLACEMENTS[placement])
    jt = JTrainer(jcfg)
    try:
        jt.train()
        jcounts = {k: v for k, v in jt.sentinel.counts().items() if k in LEARNER_ENTRIES}
    finally:
        jt.close()
    t = Trainer(tcfg, device="cpu")
    try:
        t.train()
        counts = t.sentinel.counts()
        assert counts == jcounts
        t.train(total_steps=tcfg.total_steps)
        assert t.sentinel.counts() == counts
        t.sentinel.check("second leg")
        assert t.sentinel.total_compiles == sum(counts.values())
    finally:
        t.close()


@pytest.mark.parametrize("placement", ["host", "host_prefetch", "device", "hybrid",
                                       "host_dp_k4", "host_hogwild_k4", "host_dp_tp",
                                       "device_dp"])
def test_trainer_entries_stay_flat_across_a_resume(tmp_path, placement):
    from d4pg_tpu_torch.runtime.trainer import Trainer

    kw = dict(PLACEMENTS[placement], checkpoint_interval=4, snapshot_replay=True)
    _, cfg = _configs(tmp_path, f"res_{placement}", **kw)
    t = Trainer(cfg, device="cpu")
    try:
        t.train()
        before = t.sentinel.counts()
    finally:
        t.close()
    import dataclasses

    r = Trainer(dataclasses.replace(cfg, resume=True, total_steps=2 * cfg.total_steps),
                device="cpu")
    try:
        r.train()
        assert r.grad_steps > cfg.total_steps
        assert r.sentinel.counts() == before
        r.train(total_steps=cfg.total_steps)
        assert r.sentinel.counts() == before
    finally:
        r.close()


def test_trainer_planted_second_batch_shape_trips_at_the_next_check(tmp_path):
    from d4pg_tpu_torch.runtime.trainer import Trainer

    _, cfg = _configs(tmp_path, "plant")
    t = Trainer(cfg, device="cpu")
    try:
        t.train()
        _, batch, _ = t._sample_staged(1)
        t._release_staging_holds(len(t._staging_holds))
        t._run_program(t._train_step_prog, {k: v[:-1] for k, v in batch.items()})
        with pytest.raises(RecompileBudgetError, match="train_step: 2 compiles > budget 1"):
            t.sentinel.check("planted")
    finally:
        t.close()


def test_trainer_without_guards_has_no_sentinel(tmp_path):
    import dataclasses

    from d4pg_tpu_torch.runtime.trainer import Trainer

    _, cfg = _configs(tmp_path, "off")
    t = Trainer(dataclasses.replace(cfg, debug_guards=False), device="cpu")
    try:
        assert t.sentinel is None
        t.train()
    finally:
        t.close()


# ------------------------------------------------------------- the server
def test_server_infer_stays_at_the_bucket_count_across_a_hot_reload(tmp_path):
    from d4pg_tpu_torch.agent import D4PGConfig, create_train_state
    from d4pg_tpu_torch.serve.bundle import export_bundle, load_bundle
    from d4pg_tpu_torch.serve.client import PolicyClient
    from d4pg_tpu_torch.serve.server import PolicyServer

    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(16, 16))
    st = create_train_state(cfg, seed=0, device="cpu")
    export_bundle(str(tmp_path / "b"), cfg, st.actor.state_dict())
    server = PolicyServer(load_bundle(str(tmp_path / "b")), port=0, max_batch=8,
                          watch_bundle=False, debug_guards=True, device="cpu")
    server.start()
    try:
        batcher = server.batcher
        assert server.sentinel.counts() == {"serve.infer": 4} == {
            "serve.infer": batcher.compile_count}
        with PolicyClient("127.0.0.1", server.port) as c:
            for i in range(6):
                c.act(np.full(3, 0.1 * i, np.float32))
        st2 = create_train_state(cfg, seed=1, device="cpu")
        batcher.set_params({k: v.numpy() for k, v in st2.actor.state_dict().items()})
        with PolicyClient("127.0.0.1", server.port) as c:
            for i in range(6):
                c.act(np.full(3, 0.2 * i, np.float32))
        assert server.sentinel.counts() == {"serve.infer": 4}
    finally:
        server.drain()
    assert batcher.compile_count == 4


def test_server_drain_raises_on_a_planted_fifth_specialization(tmp_path):
    from d4pg_tpu_torch.agent import D4PGConfig, create_train_state
    from d4pg_tpu_torch.serve.bundle import export_bundle, load_bundle
    from d4pg_tpu_torch.serve.server import PolicyServer

    cfg = D4PGConfig(obs_dim=3, action_dim=1, hidden_sizes=(16, 16))
    st = create_train_state(cfg, seed=0, device="cpu")
    export_bundle(str(tmp_path / "b"), cfg, st.actor.state_dict())
    server = PolicyServer(load_bundle(str(tmp_path / "b")), port=0, max_batch=8,
                          watch_bundle=False, debug_guards=True, device="cpu")
    server.start()
    with torch.no_grad():
        server.batcher._program(torch.zeros(3, 3))
    with pytest.raises(RecompileBudgetError, match="serve.infer: 5 compiles > budget 4"):
        server.drain()
