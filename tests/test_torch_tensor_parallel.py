"""The port's tensor parallelism (``d4pg_tpu_torch/parallel/partition.py``
and ``parallel/tp.py``) against the JAX package's, on the CPU, at 2x64
nets, 11 atoms and B = 16.

Both sides start from one JAX ``create_train_state`` carried across with
``weights.py``. The TP step runs on a (dp 2, tp 2) mesh of lanes in one
process; the JAX side is the single-device ``jit_train_step`` on the
whole batch (the dp mean of two half-batch gradients is the whole-batch
gradient), and once its GSPMD ``auto_parallel_train_step`` on a (2, 2)
mesh of the virtual CPU devices.

Tolerances, with their reasons:

- the partition rules: exact (the same first-match table on the same
  names and shapes: spec, outcome and rule leaf for leaf);
- the float32 TP step: ``test_torch_parallel``'s dp bounds: loss and
  priorities rtol 1e-4 / atol 1e-6 (the same float32 math, the row
  layers' partials summed lane by lane), q_mean and actor_loss atol 1e-3,
  params after three steps atol 10·lr and median lr/10 (Adam's near-sign
  first updates);
- the bfloat16 TP step: ``test_torch_stacked``'s ``BF16_REL = 6·2^-7``:
  priorities and losses relative, q_mean BF16_REL·300 on the 300-wide
  support, params after one step within 2·lr(1 + 1e-3);
- the replicated leaves across tp lanes, the shard and gather fns, a
  checkpoint across tp and the two gloo ranks: ``torch.equal``.
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.agent import jit_train_step
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.parallel import make_mesh as j_make_mesh
from d4pg_tpu.parallel import partition as jpart
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state
from d4pg_tpu_torch.agent.d4pg import build_networks, train_step
from d4pg_tpu_torch.parallel import partition as tpart
from d4pg_tpu_torch.parallel.dp import float_tensors
from d4pg_tpu_torch.parallel.mesh import make_mesh
from d4pg_tpu_torch.parallel.tp import TPModule
from d4pg_tpu_torch.runtime.checkpoint import CheckpointManager
from d4pg_tpu_torch.tools import dp_ranks
from d4pg_tpu_torch.weights import load_jax_params, state_dict_to_flax

LR = 1e-4
B, HIDDEN, ATOMS = 16, (64, 64), 11
BF16_REL = 6 * 2.0**-7
RANKS_TIMEOUT_S = 120.0

# name -> (obs_dim, action_dim, extra config fields, ensemble_axis, network)
CASES = {
    "actor": (3, 1, {}, None, "actor"),
    "critic_a1": (3, 1, {}, None, "critic"),
    "critic_a6": (17, 6, {}, None, "critic"),
    "twin": (3, 1, dict(twin_critic=True), None, "critic"),
    "redq": (3, 1, dict(critic_ensemble=4), None, "critic"),
    "redq_members": (3, 1, dict(critic_ensemble=4), "tp", "critic"),
    "mog": (3, 1, dict(head="mixture_gaussian"), None, "critic"),
    "scalar": (3, 1, dict(head="scalar"), None, "critic"),
    "pixel": (16 * 16 * 2, 1, dict(pixel_shape=(16, 16, 2)), None, "critic"),
}


def _configs(obs_dim=3, action_dim=1, head="categorical", dtype="float32", v=(-300.0, 0.0),
             **kw):
    common = dict(obs_dim=obs_dim, action_dim=action_dim, hidden_sizes=HIDDEN, tau=0.05,
                  n_step=3, lr_actor=LR, lr_critic=LR, compute_dtype=dtype, **kw)
    dist = dict(kind=head, num_atoms=ATOMS, v_min=v[0], v_max=v[1], num_mixtures=5)
    jcfg = JConfig(dist=JDist(**dist), projection_backend="pallas_fused", **common)
    tcfg = D4PGConfig(dist=DistConfig(**dist), projection_backend="fused", **common)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _case_trees(case):
    obs, act, extra, _, net = CASES[case]
    jcfg, tcfg = _configs(obs, act, **extra)
    jst = j_create(jcfg, jax.random.PRNGKey(0))
    jtree = jax.device_get(jst.actor_params if net == "actor" else jst.critic_params)
    actor, critic = build_networks(tcfg, torch.Generator().manual_seed(0))
    module = actor if net == "actor" else critic
    return jcfg, tcfg, jtree, module


def _rows(entries):
    return [(e["name"], tuple(e["shape"]), tuple(e["spec"]), e["outcome"], e["rule"])
            for e in entries]


def _mesh(dp, tp):
    return make_mesh(dp, tp, device="cpu", num_processes=1, process_index=0)


# --------------------------------------------------------------- specs
@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_partition_rules_match_the_reference(case, tp):
    """The port's matcher on the port's Flax view of a network gives the
    JAX matcher's spec, outcome and rule on the JAX tree, leaf for leaf,
    and ``module_specs`` hands each spec back in the parameter's layout."""
    jcfg, tcfg, jtree, module = _case_trees(case)
    ens = CASES[case][3]
    jmesh, tmesh = j_make_mesh(dp=2, tp=tp), _mesh(2, tp)
    want = jpart.explain_partition_rules(jpart.DEFAULT_RULES, jtree, jmesh,
                                         jpart.stack_axes_for(jcfg, ens))
    ttree = state_dict_to_flax(module)
    axes = tpart.stack_axes_for(tcfg, ens)
    got = tpart.explain_partition_rules(tpart.DEFAULT_RULES, ttree, tmesh, axes)
    assert _rows(got) == _rows(want)
    assert {e["outcome"] for e in got} <= {"scalar", "rule", "stack", "fallback_rank",
                                           "fallback_fit", "fallback_catchall",
                                           "fallback_nomatch"}
    jspecs = jpart.match_partition_rules(jpart.DEFAULT_RULES, jtree, jmesh,
                                         jpart.stack_axes_for(jcfg, ens))
    tspecs = tpart.match_partition_rules(tpart.DEFAULT_RULES, ttree, tmesh, axes)
    assert jax.tree_util.tree_map(tuple, jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)) == \
        jax.tree_util.tree_map(tuple, tspecs, is_leaf=lambda x: isinstance(x, tpart.P))
    by_name = {e["name"]: tuple(e["spec"]) for e in want}
    for name, spec in tpart.module_specs(module, tmesh, stack_axes=axes).items():
        flax_name, flax_shape, perm = tpart.flax_view(name, tuple(module.get_parameter(name).shape))
        full = by_name[flax_name] + (None,) * (len(flax_shape) - len(by_name[flax_name]))
        assert tuple(spec) == tuple(full[d] for d in perm), name


def test_rule_tables_are_the_references():
    for ours, theirs in ((tpart.DEFAULT_RULES, jpart.DEFAULT_RULES),
                         (tpart.RING_RULES, jpart.RING_RULES),
                         (tpart.PER_TREE_RULES, jpart.PER_TREE_RULES)):
        assert [(r, tuple(s)) for r, s in ours] == [(r, tuple(s)) for r, s in theirs]
    assert tpart.DEFAULT_STACK_AXES == jpart.DEFAULT_STACK_AXES
    ring = {k: np.zeros((8, 3)) for k in ("obs", "action", "next_obs")}
    ring.update(reward=np.zeros(8), discount=np.zeros(8), size=np.zeros((), np.int32))
    want = jpart.match_partition_rules(jpart.RING_RULES, ring)
    assert {k: tuple(s) for k, s in tpart.ring_partition_specs(ring).items()} == \
        {k: tuple(s) for k, s in want.items()}
    tree = {"sums": np.zeros((2, 16)), "max_priority": np.ones(())}
    want = jpart.match_partition_rules(jpart.PER_TREE_RULES, tree)
    assert {k: tuple(s) for k, s in tpart.tree_partition_specs(tree).items()} == \
        {k: tuple(s) for k, s in want.items()}


# ------------------------------------------------------------- the step
def _batch(rng, obs_dim, action_dim, n=B):
    b = {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(n, action_dim)).astype(np.float32),
        "reward": rng.uniform(-16, 0, size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "discount": np.where(rng.uniform(size=n) < 0.2, 0.0, 0.99**3).astype(np.float32),
        "weights": rng.uniform(0.2, 1.0, size=n).astype(np.float32),
    }
    b["reward"][1] = -400.0  # the target clips at v_min
    return b


def _j_subset(jcfg, jst):
    """The subset the JAX step draws from its state's key."""
    k_subset, _ = jax.random.split(jst.key)
    return torch.from_numpy(np.asarray(
        jax.random.permutation(k_subset, jcfg.critic_ensemble)[: jcfg.ensemble_min_targets]
    ).astype(np.int64))


def _pair(jcfg, tcfg, seed=0):
    jst = j_create(jcfg, jax.random.PRNGKey(seed))
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, jax.device_get(jst.actor_params), jax.device_get(jst.critic_params))
    return jst, tst


def _leaves(module, tree):
    """(name, torch parameter, the JAX leaf in the torch layout)."""
    layers = jax.device_get(tree)["params"]
    for name, prm in module.named_parameters():
        layer, kind = name.split(".")
        leaf = np.asarray(layers[layer]["bias" if kind == "bias" else "kernel"])
        yield name, prm, (leaf.T if kind == "weight" else leaf)


def _assert_state_close(whole, jst, atol=10 * LR, median=LR / 10):
    for module, tree in ((whole.actor, jst.actor_params), (whole.critic, jst.critic_params),
                         (whole.target_actor, jst.target_actor_params),
                         (whole.target_critic, jst.target_critic_params)):
        for name, prm, leaf in _leaves(module, tree):
            diff = np.abs(prm.detach().numpy() - leaf)
            assert diff.max() <= atol, (name, diff.max())
            assert np.median(diff) <= median, (name, np.median(diff))


def _assert_replicas_equal(state):
    """Every replicated leaf, and its Adam moments, torch.equal on every tp lane."""
    for net, opt in ((state.actor, state.actor_opt), (state.critic, state.critic_opt),
                     (state.target_actor, None), (state.target_critic, None)):
        for name, spec in net.specs.items():
            if tpart.tp_dim(spec) is not None:
                continue
            lanes = net.lane_params(name)
            assert all(torch.equal(lanes[0], q) for q in lanes[1:]), name
            if opt is not None and opt.state.get(lanes[0]):
                for k in ("exp_avg", "exp_avg_sq"):
                    assert all(torch.equal(opt.state[lanes[0]][k], opt.state[q][k])
                               for q in lanes[1:]), (name, k)


STEP_CASES = {
    "a1": (3, 1, {}, None),
    "a6": (17, 6, {}, None),
    "twin": (3, 1, dict(twin_critic=True), None),
    "redq": (3, 1, dict(critic_ensemble=4), None),
    "redq_members": (3, 1, dict(critic_ensemble=4), "tp"),
    "bf16": (3, 1, dict(dtype="bfloat16"), None),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_tp_step_matches_the_single_device_step(case):
    """The TP step over (dp 2, tp 2) lanes against the JAX single-device
    step on the same state and batches (REDQ: the JAX subset fed in)."""
    obs, act, extra, ens = STEP_CASES[case]
    jcfg, tcfg = _configs(obs, act, **extra)
    jst, tst = _pair(jcfg, tcfg, seed=3)
    mesh = _mesh(2, 2)
    step = tpart.auto_parallel_train_step(tcfg, mesh, ensemble_axis=ens)
    tps = step.shard(tst)
    # each tp lane holds only its shard: hidden_0's kernel has 32 of 64 columns
    for net in (tps.actor, tps.critic):
        shard = net.lane_params("hidden_0." + ("kernel" if net.stacked else "weight"))[1]
        cols = shard.shape[-1] if net.stacked else shard.shape[0]
        assert cols == (64 if ens and net.stacked else 32)
    if ens:
        assert tps.critic.member_parts == [2, 2]
        assert tps.critic.lane_params("out.kernel")[0].shape[0] == 2  # E/tp whole members
    if case == "a6":  # hidden_1's 70 rows split [0, 35), [35, 70): not hidden_0's columns
        assert tps.critic.kinds["hidden_1"] == "row"
        assert tps.critic.lane_params("hidden_1.weight")[0].shape == (64, 35)
    if case == "a1":  # 65 rows: replicated
        assert tps.critic.kinds["hidden_1"] == "rep"
    jstep = jit_train_step(jcfg, donate=False)
    rng = np.random.default_rng(4)
    bf16 = case == "bf16"
    for i in range(1 if bf16 else 3):
        batch = _batch(rng, obs, act)
        subset = _j_subset(jcfg, jst) if tcfg.critic_ensemble else None
        jst, jm, jpri = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        if case == "a1":
            _, tm, tpri = step(tps, tb)
        else:
            _, tm, tpri = train_step(tcfg, tps, tpart.shard_batch(tb, mesh), subset=subset,
                                     sync_fn=step.sync)
        if i == 0 and bf16:
            np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri), rtol=BF16_REL, atol=0)
            for k in ("critic_loss", "priority_mean"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=BF16_REL, err_msg=k)
            np.testing.assert_allclose(float(tm["q_mean"]), float(jm["q_mean"]),
                                       atol=BF16_REL * 300)
        elif i == 0:
            np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri), rtol=1e-4, atol=1e-6)
            for k in ("critic_loss", "priority_mean", "q_support_frac"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6,
                                           err_msg=k)
            for k in ("q_mean", "actor_loss"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-3, err_msg=k)
    assert tps.step == (1 if bf16 else 3)
    if bf16:
        _assert_state_close(tps.whole(), jst, atol=2 * LR * (1 + 1e-3),
                            median=2 * LR * (1 + 1e-3))
    else:
        _assert_state_close(tps.whole(), jst)
    _assert_replicas_equal(tps)


def test_tp_step_matches_the_reference_gspmd_step():
    """One step against the JAX ``auto_parallel_train_step`` on a (2, 2)
    mesh of the virtual CPU devices (A = 6: the misaligned concat rows)."""
    jcfg, tcfg = _configs(17, 6)
    jst, tst = _pair(jcfg, tcfg, seed=5)
    batch = _batch(np.random.default_rng(6), 17, 6)
    t0 = time.perf_counter()
    jmesh = j_make_mesh(dp=2, tp=2)
    jstep = jpart.auto_parallel_train_step(jcfg, jmesh, donate=False)
    jout, jm, jpri = jstep(jpart.shard_train_state(jst, jmesh), jpart.shard_batch(batch, jmesh))
    jax_s = time.perf_counter() - t0
    assert jax_s < 20.0, jax_s  # the JAX GSPMD compile on the CPU: a fast-tier test
    mesh = _mesh(2, 2)
    step = tpart.auto_parallel_train_step(tcfg, mesh)
    tps = step.shard(tst)
    _, tm, tpri = step(tps, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri), rtol=1e-4, atol=1e-6)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    _assert_state_close(tps.whole(), jout)
    with pytest.raises(TypeError, match="step.shard"):
        step(tst, {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------- round trips
@pytest.mark.parametrize("case", ["critic_a6", "twin", "redq_members", "pixel"])
def test_shard_then_gather_is_the_identity(case):
    _, tcfg, _, module = _case_trees(case)
    ens = CASES[case][3]
    mesh = _mesh(2, 2)
    specs = tpart.module_specs(module, mesh, stack_axes=tpart.stack_axes_for(tcfg, ens))
    shard, gather = tpart.make_shard_and_gather_fns(specs, mesh)
    for name, p in module.named_parameters():
        shards = shard[name](p)
        assert len(shards) == 2 and torch.equal(gather[name](shards), p.detach()), name
        if tpart.tp_dim(specs[name]) is not None:
            assert sum(s.numel() for s in shards) == p.numel(), name
    tpm = TPModule(module, specs, 2)
    for a, b in zip(tpm.gather_module().parameters(), module.parameters()):
        assert torch.equal(a, b)


def _whole_tensors(state):
    whole = state.whole() if hasattr(state, "whole") else state
    return [t.detach().clone() for t in float_tensors(whole)], whole.step


def test_checkpoint_moves_between_tp_layouts_bit_exact(tmp_path):
    """A (dp 2, tp 2) state after two steps, saved whole, restores at
    (2, 1) (a whole state) and at (2, 2) bit for bit; the whole
    checkpoint restores into a tp state, the reverse."""
    jcfg, tcfg = _configs(17, 6, critic_ensemble=4)
    mesh = _mesh(2, 2)
    step = tpart.auto_parallel_train_step(tcfg, mesh, ensemble_axis="tp")
    tps = step.shard(create_train_state(tcfg, 1, "cpu"))
    rng = np.random.default_rng(2)
    for _ in range(2):
        step(tps, {k: torch.from_numpy(v) for k, v in _batch(rng, 17, 6).items()})
    want, want_step = _whole_tensors(tps)
    ckpt = CheckpointManager(str(tmp_path / "tp2"))
    ckpt.save(tps.step, tps)
    for restored in (create_train_state(tcfg, 9, "cpu"),
                     step.shard(create_train_state(tcfg, 9, "cpu")),
                     tpart.shard_train_state(create_train_state(tcfg, 9, "cpu"), mesh)):
        ckpt.restore(restored)
        got, got_step = _whole_tensors(restored)
        assert got_step == want_step == 2
        assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(restored.subset_gen.get_state(), tps.subset_gen.get_state())
    # the reverse: a whole (tp 1) checkpoint into a tp 2 state
    whole = tps.whole()
    ckpt1 = CheckpointManager(str(tmp_path / "tp1"))
    ckpt1.save(whole.step, whole)
    fresh = step.shard(create_train_state(tcfg, 7, "cpu"))
    ckpt1.restore(fresh)
    got, _ = _whole_tensors(fresh)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _assert_replicas_equal(fresh)


def test_cli_runs_tp_and_resumes_at_tp_1(tmp_path):
    from d4pg_tpu_torch.train import main

    args = ["--device", "cpu", "--hidden-sizes", "16,16", "--num-envs", "2", "--bsize", "8",
            "--warmup", "64", "--rmsize", "4096", "--total-steps", "8", "--eval-interval", "8",
            "--eval-episodes", "1", "--steps-per-dispatch", "4", "--dp", "2",
            "--checkpoint-interval", "8", "--log-dir", str(tmp_path)]
    final = main(args + ["--tp", "2"])
    assert np.isfinite(final["critic_loss"])
    assert (tmp_path / "checkpoints" / "8").is_dir()
    assert (tmp_path / "checkpoints" / "best_actor.npz").exists()
    final = main(args + ["--tp", "1", "--resume"])
    assert np.isfinite(final["critic_loss"]) and (tmp_path / "checkpoints" / "16").is_dir()
    final = main(args + ["--tp", "2", "--dp-hogwild", "--resume"])
    assert np.isfinite(final["critic_loss"])


# --------------------------------------------------------- two ranks
def _rank_cfg():
    return dataclasses.replace(_configs(3, 1)[1], hidden_sizes=(32, 32))


def test_two_gloo_ranks_equal_one_process_with_the_same_lanes():
    """``--dp 2 --tp 2`` as two spawned gloo ranks (one dp lane and its
    two tp lanes each) against one process with both dp lanes: the state,
    its tp shards, the metrics and each rank's priorities torch.equal."""
    kw = dict(agent_cfg=_rank_cfg(), dispatches=2, k=2, batch=B)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank runs: CPU GEMM bits depend on the split
    try:
        one = dp_ranks.run_tp_lanes(_mesh(2, 2), **kw)
    finally:
        torch.set_num_threads(threads)
    ranks = dp_ranks.spawn_ranks(2, 2, "cpu", timeout_s=RANKS_TIMEOUT_S, leg="tp", tp=2, **kw)
    assert dp_ranks.compare_leg(one, ranks) == dict(
        state=True, step=True, metrics=True, shards=True, priorities=True)
    assert one["step"] == 4 and one["combines"] == 4 * (2 + 2 + 1)  # tp critic + tp actor + metrics
