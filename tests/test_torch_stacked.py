"""Stacked critics (twin, REDQ ensembles), the bfloat16 compute path,
``--batch-scale`` and the bfloat16 ring and wire of the port, against the
JAX package on the CPU.

Both sides start from ONE JAX ``create_train_state`` carried across with
``d4pg_tpu_torch.weights.load_jax_params`` (stacked leaves: [E, in, out]
kernels) and take the same numpy batches. The JAX side runs its Pallas
kernels in interpret mode (``pallas_fused`` for the port's ``fused`` rung,
``pallas`` for ``projection``) and its XLA tree descent; the port runs its
kernels' plain versions, which take the same stacked shapes. REDQ's target
subset cannot match across RNGs (Threefry against Philox): the test draws
it from the JAX state's key as the JAX step does
(``permutation(split(key)[0], E)[:M]``) and feeds it to the port through
``train_step(subset=)``. In the megastep and on-device bodies, which draw
their own subsets, the ensemble runs with M = E: every member is in the
subset, so the draw cannot change the target.

Tolerances, with their reasons:

- float32 stacked steps: ``test_torch_agent``'s. First-step gradients,
  losses and priorities rtol 1e-4 / atol 1e-6 (the same float32 math summed
  in another order); values read after an Adam step (q_mean, actor_loss)
  atol 1e-3 on a 300-wide support; params and targets after chained steps
  atol 10·lr with a median of lr/10 (Adam's first steps move a coordinate
  by about ±lr whatever its gradient, so a near-zero gradient whose sign
  differs between the two sums moves it by up to 2·lr a step).
- bfloat16: bf16 keeps 8 significant bits, so one rounding is exact to
  u = 2^-8 of its value and two roundings of the same float32 sum can land
  one ulp (2^-7 relative) apart when the two frameworks' float32
  accumulation orders put the sum on either side of a rounding boundary.
  A layer rounds its product and then its bias add: two roundings, and the
  next layer carries the difference forward. Over the critic's three
  layers that is at most 2·3 = 6 ulps of the layer's scale: logits and
  actions within BF16_REL = 6·2^-7 (4.7e-2) of the largest magnitude of
  the row set. Losses and priorities are float32 functions of those logits
  (log-softmax against a fixed target): held to BF16_REL relative. Params
  after one Adam step: every coordinate moves by at most lr·(1 + 1e-3)
  on each side, so they agree within 2·lr whatever the gradients' bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.agent import jit_train_step
from d4pg_tpu.agent.d4pg import build_networks as j_build
from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.config import apply_batch_scale as j_apply_batch_scale
from d4pg_tpu.config import apply_env_preset as j_apply_env_preset
from d4pg_tpu.envs.pendulum import Pendulum as JPendulum
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.replay import device_per as jdper
from d4pg_tpu.runtime import megastep as jmega
from d4pg_tpu.runtime import on_device as jod
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state, train_step
from d4pg_tpu_torch.agent.d4pg import draw_subset, gather_batches
from d4pg_tpu_torch.config import TrainConfig, apply_batch_scale, apply_env_preset
from d4pg_tpu_torch.envs import EnvState, Pendulum
from d4pg_tpu_torch.models import StackedCritic
from d4pg_tpu_torch.replay import device_per as dper
from d4pg_tpu_torch.runtime import megastep
from d4pg_tpu_torch.runtime import on_device as od
from d4pg_tpu_torch.runtime.checkpoint import CheckpointManager, StackMismatch
from d4pg_tpu_torch.weights import load_jax_params, to_jax_params
from tests import test_torch_megastep as tm_helpers
from tests import test_torch_on_device as od_helpers

LR = 1e-4
HIDDEN = (16, 16)
B, A = 8, 51
BF16_REL = 6 * 2.0**-7
# (twin_critic, critic_ensemble, ensemble_min_targets) of each stack; "redq"
# draws 2 of 3, "redq_all" takes all 3 (the bodies that draw their own)
STACKS = {"twin": (True, 0, 2), "redq": (False, 3, 2), "redq_all": (False, 3, 3)}
PAIRS = {"fused": "pallas_fused", "projection": "pallas"}


def _configs(stack, backend="fused", dtype="float32", atoms=A, v=(-300.0, 0.0), **kw):
    twin, ens, m = STACKS[stack] if stack else (False, 0, 2)
    common = dict(obs_dim=3, action_dim=1, hidden_sizes=HIDDEN, tau=0.05, n_step=3,
                  lr_actor=LR, lr_critic=LR, twin_critic=twin, critic_ensemble=ens,
                  ensemble_min_targets=m, compute_dtype=dtype, **kw)
    jcfg = JConfig(dist=JDist(num_atoms=atoms, v_min=v[0], v_max=v[1]),
                   projection_backend=PAIRS[backend], **common)
    tcfg = D4PGConfig(dist=DistConfig(num_atoms=atoms, v_min=v[0], v_max=v[1]),
                      projection_backend=backend, **common)
    return jcfg, tcfg


def _batch(rng, n=B):
    b = {
        "obs": rng.normal(size=(n, 3)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(n, 1)).astype(np.float32),
        "reward": rng.uniform(-16, 0, size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
        "discount": np.where(rng.uniform(size=n) < 0.2, 0.0, 0.99**3).astype(np.float32),
        "weights": rng.uniform(0.2, 1.0, size=n).astype(np.float32),
    }
    b["reward"][1] = -400.0  # target clips at v_min
    return b


def _pair(jcfg, tcfg, seed=0):
    jst = j_create(jcfg, jax.random.PRNGKey(seed))
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, jax.device_get(jst.actor_params), jax.device_get(jst.critic_params))
    return jst, tst


def _leaves(module, tree):
    """(name, torch parameter, matching JAX leaf in the torch layout)."""
    layers = tree["params"]
    for name, prm in module.named_parameters():
        layer, kind = name.split(".")
        leaf = np.asarray(layers[layer]["bias" if kind == "bias" else "kernel"])
        yield name, prm, (leaf.T if kind == "weight" else leaf)


def _j_subset(jcfg, jst):
    """The subset the JAX step draws from its state's key."""
    k_subset, _ = jax.random.split(jst.key)
    return torch.from_numpy(np.asarray(
        jax.random.permutation(k_subset, jcfg.critic_ensemble)[: jcfg.ensemble_min_targets]
    ).astype(np.int64))


def _step(jstep, jcfg, tcfg, jst, tst, batch):
    subset = _j_subset(jcfg, jst) if tcfg.critic_ensemble else None
    jst, jm, jpri = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm, tpri = train_step(tcfg, tst, {k: torch.from_numpy(v) for k, v in batch.items()},
                             subset=subset)
    return jst, jm, np.asarray(jpri), tm, tpri.numpy()


def _assert_state_close(tst, jst, atol=10 * LR, median=LR / 10):
    pairs = [(tst.actor, jst.actor_params), (tst.critic, jst.critic_params),
             (tst.target_actor, jst.target_actor_params),
             (tst.target_critic, jst.target_critic_params)]
    for module, tree in pairs:
        for name, prm, leaf in _leaves(module, tree):
            diff = np.abs(prm.detach().numpy() - leaf)
            assert diff.max() <= atol, (name, diff.max())
            assert np.median(diff) <= median, (name, np.median(diff))


# ----------------------------------------------------------------- init
@pytest.mark.parametrize("stack", ["twin", "redq"])
def test_stacked_init_shapes_and_independent_members(stack):
    jcfg, tcfg = _configs(stack)
    E = 2 if stack == "twin" else 3
    st = create_train_state(tcfg, seed=5, device="cpu")
    assert isinstance(st.critic, StackedCritic) and st.critic.num_members == E
    jparams = jax.device_get(j_create(jcfg, jax.random.PRNGKey(0)).critic_params)["params"]
    for name, prm in st.critic.named_parameters():
        layer, kind = name.split(".")
        assert tuple(prm.shape) == jparams[layer][kind].shape, name
        assert prm.shape[0] == E
        flat = prm.detach().reshape(E, -1)
        for i in range(E):
            for j in range(i + 1, E):  # every member drew its own init
                assert not torch.equal(flat[i], flat[j]), (name, i, j)
        value = prm.detach()
        if layer == "out":  # Flax uniform(3e-4): [0, 3e-4)
            assert 0.0 <= float(value.min()) and float(value.max()) < 3e-4
        else:  # fan-in: the kernel by its input width, the bias by its output width
            bound = 1 / np.sqrt(prm.shape[1]) if kind == "kernel" else 1 / np.sqrt(prm.shape[-1])
            assert float(value.abs().max()) <= bound
    for a, b in zip(st.critic.parameters(), st.target_critic.parameters()):
        assert torch.equal(a, b) and not b.requires_grad
    other = create_train_state(tcfg, seed=6, device="cpu")
    assert not torch.equal(other.critic.hidden_0.kernel, st.critic.hidden_0.kernel)
    again = create_train_state(tcfg, seed=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.critic.parameters(), st.critic.parameters()))
    assert (st.subset_gen is None) == (stack == "twin")
    assert st.stack == {"twin_critic": stack == "twin", "critic_ensemble": 0 if stack == "twin" else 3,
                        "compute_dtype": "float32"}


@pytest.mark.parametrize(
    "kw,match",
    [(dict(critic_ensemble=2, twin_critic=True), "critic_ensemble and twin_critic are mutually "
                                                  "exclusive: an E=2, ensemble_min_targets=2 "
                                                  "ensemble IS the twin"),
     (dict(critic_ensemble=1), r"critic_ensemble must be >= 2 \(got 1\); 0 disables"),
     (dict(critic_ensemble=3, ensemble_min_targets=4),
      r"ensemble_min_targets must be in \[1, critic_ensemble=3\], got 4"),
     (dict(compute_dtype="float16"), "compute_dtype must be one of")],
    ids=["twin_and_ensemble", "ensemble_of_one", "subset_too_large", "dtype"],
)
def test_stack_refusals_are_the_references(kw, match):
    from d4pg_tpu.agent.d4pg import _stacked_critics

    cfg = D4PGConfig(hidden_sizes=(8,), **kw)
    with pytest.raises(ValueError, match=match):
        create_train_state(cfg, device="cpu")
    if "compute_dtype" not in kw:
        with pytest.raises(ValueError, match=match):
            _stacked_critics(JConfig(**kw))


# -------------------------------------------------------------- weights
@pytest.mark.parametrize("stack", ["twin", "redq"])
def test_load_jax_params_carries_stacked_leaves_both_ways(stack):
    jcfg, tcfg = _configs(stack)
    jst, tst = _pair(jcfg, tcfg)
    jactor, jcritic = jax.device_get((jst.actor_params, jst.critic_params))
    actor_back, critic_back = to_jax_params(tst)
    for back, orig in ((critic_back, jcritic), (actor_back, jactor)):
        assert back["params"].keys() == orig["params"].keys()
        for layer, leaves in orig["params"].items():
            for kind, leaf in leaves.items():
                np.testing.assert_array_equal(back["params"][layer][kind], np.asarray(leaf))
    # the stacked forward is the JAX vmap over the members, obs and action shared
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(B, 3)).astype(np.float32)
    act = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
    _, critic = j_build(jcfg)
    want = np.asarray(jax.vmap(lambda p: critic.apply(p, obs, act))(jst.critic_params))
    got = tst.critic(torch.from_numpy(obs), torch.from_numpy(act)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for e in range(want.shape[0]):
        one = tst.critic(torch.from_numpy(obs), torch.from_numpy(act), member=e)
        np.testing.assert_allclose(one.detach().numpy(), want[e], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- host steps
@pytest.mark.parametrize("backend", ["fused", "projection"])
@pytest.mark.parametrize("stack", ["twin", "redq"])
def test_host_step_matches_the_reference(stack, backend):
    """One stacked step: every member's gradient (from optax's first
    moment), the summed loss over members, the mean priorities, the
    metrics; then two more chained steps (REDQ: a fresh JAX subset each)."""
    jcfg, tcfg = _configs(stack, backend)
    jst, tst = _pair(jcfg, tcfg, seed=1)
    rng = np.random.default_rng(2)
    jstep = jit_train_step(jcfg, donate=False)
    jst1, jm, jpri, tm, tpri = _step(jstep, jcfg, tcfg, jst, tst, _batch(rng))
    b1 = jcfg.adam_b1
    for module, opt_state in ((tst.critic, jst1.critic_opt_state), (tst.actor, jst1.actor_opt_state)):
        for name, prm, leaf in _leaves(module, opt_state[0].mu):
            np.testing.assert_allclose(prm.grad.numpy(), leaf / (1 - b1), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    np.testing.assert_allclose(tpri, jpri, rtol=1e-4, atol=1e-6)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("q_mean", "actor_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=1e-3, err_msg=k)
    assert set(tm) == set(jm) and tpri.shape == (B,)
    jst = jst1
    for _ in range(2):
        jst, jm, jpri, tm, tpri = _step(jstep, jcfg, tcfg, jst, tst, _batch(rng))
    assert tst.step == int(jst.step) == 3
    _assert_state_close(tst, jst)
    np.testing.assert_allclose(tpri, jpri, rtol=1e-2, atol=1e-3)


def test_redq_target_takes_the_subsets_argmin_member():
    """The REDQ target is, per sample, the whole distribution of the
    smallest-mean member of the subset: feeding {1} alone backs up member
    1's target head, and the subset's order does not change the result."""
    from d4pg_tpu_torch.agent.d4pg import _target_head, support_of

    _, tcfg = _configs("redq")
    st = create_train_state(tcfg, seed=3, device="cpu")
    with torch.no_grad():  # spread the members apart
        st.target_critic.out.bias.add_(torch.arange(3.0)[:, None] * torch.linspace(-2, 2, A))
    obs = torch.from_numpy(np.random.default_rng(4).normal(size=(B, 3)).astype(np.float32))
    sup = support_of(tcfg)
    with torch.no_grad():
        heads = st.target_critic(obs, st.target_actor(obs))
        one = _target_head(tcfg, sup, st, obs, torch.tensor([1]))
        assert torch.equal(one, heads[1])
        ab = _target_head(tcfg, sup, st, obs, torch.tensor([0, 2]))
        ba = _target_head(tcfg, sup, st, obs, torch.tensor([2, 0]))
    assert torch.equal(ab, ba)
    vals = (torch.softmax(heads, -1) * sup.atoms()).sum(-1)
    pick = torch.where(vals[0] <= vals[2], 0, 2)
    assert torch.equal(ab, heads[pick, torch.arange(B)])
    draws = {tuple(sorted(draw_subset(tcfg, st).tolist())) for _ in range(60)}
    assert draws == {(0, 1), (0, 2), (1, 2)}  # M = 2 distinct members of 3


# ------------------------------------------------------------ megastep
@pytest.mark.parametrize("stack", ["twin", "redq_all"])
def test_fused_descent_body_matches_the_reference(stack):
    """The fused-descent body (one B3 call, then the stacked B4 per step,
    one descent for every member) against the JAX separate-kernels
    megastep with its XLA descent: the same indices, and the state, tree
    and metrics of the JAX step with the fused Pallas loss (interpret
    mode). JAX's own fused-descent tier has no CPU oracle here."""
    K, Bm = tm_helpers.K, tm_helpers.B
    jcfg, tcfg = _configs(stack, atoms=11, v=(-5.0, 5.0))
    jst, jring, jper = tm_helpers._j_setup(jcfg)
    init = tm_helpers._params(jst)
    mega = jmega.make_megastep_device_per(jcfg, K, Bm, tree_backend="xla")
    tst, ring, per = tm_helpers._port_side(tcfg, init)
    key, tree = jax.random.PRNGKey(7), jper.tree
    for _ in range(tm_helpers.DISPATCHES):
        lane = tree.sums[0]
        k_lane = jax.random.fold_in(jax.random.split(key)[1], jnp.int32(0))
        pre = jdper.host_prefixes(k_lane, K, Bm, float(lane[1]))
        want_idx = np.asarray(jdper.lane_draw(lane, k_lane, K, Bm, jring.size)[0])
        jst, tree, key, jm = mega(jst, jring, tree, key)
        idx, _, _ = dper.lane_draw(per.tree.sums, torch.tensor(pre), ring.size)
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        tmet = megastep.megastep_device_per_fused_body(
            tcfg, K, Bm, tst, ring, per.tree, None, prefixes=torch.tensor(pre))
        np.testing.assert_allclose(per.tree.sums.numpy(), np.asarray(tree.sums[0]), rtol=1e-3)
    assert tst.step == int(jst.step) == K * tm_helpers.DISPATCHES
    _assert_state_close(tst, jst)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tmet[k]), float(jm[k]), rtol=1e-3, err_msg=k)


def test_stacked_fused_descent_tier_equals_the_separate_tier():
    """Under REDQ the fused tier (B4 over the E x B rows, one descent) is
    torch.equal to the separate tier: same subsets from one seed, same
    draws, losses, write-back and members."""
    _, tcfg = _configs("redq", atoms=11, v=(-5.0, 5.0))
    jcfg, _ = _configs("redq", atoms=11, v=(-5.0, 5.0))
    init = tm_helpers._params(j_create(jcfg, jax.random.PRNGKey(1)))
    sides = [tm_helpers._port_side(tcfg, init) for _ in range(2)]
    for st, _, _ in sides:
        st.subset_gen.manual_seed(5)
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    K, Bm = tm_helpers.K, tm_helpers.B
    for _ in range(2):
        (s0, r0, p0), (s1, r1, p1) = sides
        m0 = megastep.megastep_device_per_body(tcfg, K, Bm, s0, r0, p0.tree, gens[0])
        m1 = megastep.megastep_device_per_fused_body(tcfg, K, Bm, s1, r1, p1.tree, gens[1])
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert torch.equal(sides[0][2].tree.sums, sides[1][2].tree.sums)
    for a, b in zip(sides[0][0].critic.parameters(), sides[1][0].critic.parameters()):
        assert torch.equal(a, b)


# ----------------------------------------------------------- on-device
@pytest.mark.parametrize("stack", ["twin", "redq_all"])
def test_on_device_iterate_matches_the_reference(stack):
    """One warmup and one PER train iteration of each package's on-device
    loop with stacked critics, the JAX rollout's noise and train draws fed
    to the port (``test_torch_on_device``'s harness)."""
    N, SEG, CAP, K, Bo = (od_helpers.N_ENVS, od_helpers.SEG, od_helpers.CAP, od_helpers.K,
                          od_helpers.B)
    jcfg, tcfg = _configs(stack, atoms=11, v=(-50.0, 0.0))
    init_fn, warmup_fn, iterate_fn = jod.make_on_device_trainer(
        jcfg, JPendulum(), num_envs=N, segment_len=SEG, replay_capacity=CAP,
        batch_size=Bo, train_steps_per_iter=K)
    jst = j_create(jcfg, jax.random.PRNGKey(1))
    carry = init_fn(jst, jax.random.PRNGKey(2))
    init_params = [jax.device_get(p) for p in (jst.actor_params, jst.critic_params)]
    env_states, obs = carry[1], carry[2]
    _, k_roll_w = jax.random.split(carry[5])
    carry = warmup_fn(carry, 3.0)
    _, k_roll_i, k_train = jax.random.split(carry[5], 3)
    draws = np.array(jax.random.uniform(k_train, (K, Bo)))
    carry, jm = iterate_fn(carry, 1.0)
    noise = [od_helpers._segment_noise(k_roll_w, jcfg), od_helpers._segment_noise(k_roll_i, jcfg)]
    t_init, t_warm, t_iter = od.make_on_device_trainer(
        tcfg, Pendulum(), num_envs=N, segment_len=SEG, replay_capacity=CAP, batch_size=Bo,
        train_steps_per_iter=K, device="cpu", noise_fns=od_helpers._fed_noise(noise))
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, *init_params)
    tc = t_init(tst, 0)._replace(
        env_states=EnvState(torch.tensor(np.asarray(env_states.physics)),
                            torch.tensor(np.asarray(env_states.t))),
        obs=torch.tensor(np.asarray(obs)))
    tc = t_warm(tc, 3.0)
    tc, tmet = t_iter(tc, 1.0, draws=torch.from_numpy(draws))
    assert tc.state.step == int(carry[0].step) == K
    _assert_state_close(tc.state, carry[0])
    for k in jm:
        np.testing.assert_allclose(float(tmet[k]), float(jm[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tc.replay.priority.numpy(), np.asarray(carry[4].priority), rtol=1e-3)


# ---------------------------------------------------------------- bf16
@pytest.mark.parametrize("stack", [None, "twin"], ids=["single", "twin"])
def test_bf16_forward_matches_the_reference(stack):
    """Actor and critic in bfloat16 on float32 masters: the action and the
    logits come back float32, within BF16_REL of the JAX modules'."""
    jcfg, tcfg = _configs(stack, dtype="bfloat16")
    jst, tst = _pair(jcfg, tcfg, seed=4)
    rng = np.random.default_rng(5)
    obs = rng.normal(size=(64, 3)).astype(np.float32)
    act = rng.uniform(-1, 1, (64, 1)).astype(np.float32)
    jactor, jcritic = j_build(jcfg)
    ja = np.asarray(jactor.apply(jst.actor_params, obs))
    if stack:
        jq = np.asarray(jax.vmap(lambda p: jcritic.apply(p, obs, act))(jst.critic_params))
    else:
        jq = np.asarray(jcritic.apply(jst.critic_params, obs, act))
    ta = tst.actor(torch.from_numpy(obs)).detach()
    tq = tst.critic(torch.from_numpy(obs), torch.from_numpy(act)).detach()
    assert ta.dtype == tq.dtype == torch.float32 and ja.dtype == jq.dtype == np.float32
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=BF16_REL * np.abs(ja).max())
    np.testing.assert_allclose(tq.numpy(), jq, rtol=0, atol=BF16_REL * np.abs(jq).max())
    # really bfloat16: the float32 forward of the same weights differs
    f32 = create_train_state(dataclasses.replace(tcfg, compute_dtype="float32"), device="cpu")
    f32.critic.load_state_dict(tst.critic.state_dict())
    assert not torch.equal(f32.critic(torch.from_numpy(obs), torch.from_numpy(act)), tq)


@pytest.mark.parametrize("stack", [None, "redq"], ids=["single", "redq"])
def test_bf16_step_matches_the_reference(stack):
    jcfg, tcfg = _configs(stack, dtype="bfloat16")
    jst, tst = _pair(jcfg, tcfg, seed=6)
    batch = _batch(np.random.default_rng(7))
    jst1, jm, jpri, tm, tpri = _step(jit_train_step(jcfg, donate=False), jcfg, tcfg, jst, tst, batch)
    np.testing.assert_allclose(tpri, jpri, rtol=BF16_REL, atol=0)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=BF16_REL, err_msg=k)
    # q_mean on the 300-wide support, read after the Adam step
    np.testing.assert_allclose(float(tm["q_mean"]), float(jm["q_mean"]), atol=BF16_REL * 300)
    _assert_state_close(tst, jst1, atol=2 * LR * (1 + 1e-3), median=2 * LR * (1 + 1e-3))
    for p in list(tst.critic.parameters()) + list(tst.target_critic.parameters()):
        assert p.dtype == torch.float32  # float32 masters and targets


# ------------------------------------------------------ ring and wire
def test_bf16_ring_round_trip_matches_ml_dtypes():
    """``ring_dtype="bfloat16"``: the ring stores the observations as
    bfloat16 (the JAX ``_encode_obs``, round to nearest even) and the
    gather decodes them to float32, bit for bit the ``ml_dtypes`` round
    trip; the other fields stay float32."""
    _, tcfg = _configs(None)
    ring = od.device_replay_init(64, 3, 1, "cpu", obs_dtype=torch.bfloat16)
    b = od_helpers._batch(16, 3)
    b["obs"][0, :] = [1.0 + 2.0**-8, 1.0 + 3 * 2.0**-8, -(2.0**-9)]  # ties to even
    od._append(ring, {k: torch.from_numpy(v) for k, v in b.items()}, 16, tcfg.per_alpha)
    assert ring.obs.dtype == ring.next_obs.dtype == torch.bfloat16
    got = gather_batches(ring, torch.arange(16)[None])
    for k in ("obs", "next_obs"):
        want = b[k].astype(ml_dtypes.bfloat16).astype(np.float32)
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k][0].numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(jod._decode_obs(jod._encode_obs(jnp.asarray(b[k]), jnp.bfloat16),
                                       jnp.bfloat16)), want)
    np.testing.assert_array_equal(got["reward"][0].numpy(), b["reward"])


def test_bf16_wire_round_trip_matches_ml_dtypes(tmp_path):
    """``transfer_dtype="bfloat16"`` on the host placement: the staged
    batch carries bfloat16 observations (the JAX trainer's
    ``astype(ml_dtypes.bfloat16)``), which the dispatch casts back to
    float32; the other fields cross as float32."""
    from d4pg_tpu_torch.runtime.trainer import Trainer

    cfg = TrainConfig(num_envs=2, batch_size=8, warmup_steps=64, total_steps=2, eval_interval=2,
                      eval_episodes=1, replay_capacity=512, log_dir=str(tmp_path),
                      agent=D4PGConfig(hidden_sizes=(8,)), transfer_dtype="bfloat16", seed=3)
    t = Trainer(cfg, device="cpu")
    t.warmup()
    idx, dev, _ = t._sample_staged(1)
    for k in ("obs", "next_obs"):
        assert dev[k].dtype == torch.bfloat16
        want = getattr(t.buffer, k)[idx.idx].astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(dev[k].float().numpy(), want)
    assert dev["reward"].dtype == torch.float32
    row = t.train()
    t.close()
    assert np.isfinite(row["critic_loss"]) and t.grad_steps == 2


def test_wire_and_ring_dtype_refusals():
    from d4pg_tpu_torch.config import check_wire_dtypes

    # the uint8 wire needs a pixel env (the JAX uint8_wire_requires_pixel gap)
    with pytest.raises(ValueError, match="uint8_wire_requires_pixel"):
        check_wire_dtypes(TrainConfig(transfer_dtype="uint8"))
    with pytest.raises(ValueError, match="transfer_dtype"):
        check_wire_dtypes(TrainConfig(transfer_dtype="float16"))
    with pytest.raises(ValueError, match="ring_dtype"):
        check_wire_dtypes(TrainConfig(ring_dtype="uint8"))


# --------------------------------------------------------- batch scale
@pytest.mark.parametrize("s", [1, 2, 8])
def test_apply_batch_scale_matches_the_reference(s):
    kw = dict(env="pendulum", batch_scale=s, steps_per_dispatch=32, batch_size=256,
              warmup_steps=1000)
    jc = j_apply_batch_scale(j_apply_env_preset(JTrainConfig(**kw)))
    tc = apply_batch_scale(apply_env_preset(TrainConfig(**kw)))
    for f in ("batch_scale", "batch_size", "warmup_steps", "steps_per_dispatch"):
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("lr_actor", "lr_critic", "per_beta_steps"):
        assert getattr(tc.agent, f) == getattr(jc.agent, f), f
    if s == 8:
        assert (tc.batch_size, tc.steps_per_dispatch) == (2048, 4)


# ---------------------------------------------------- trainer paths
@pytest.mark.parametrize(
    "kw",
    [dict(agent=dict(twin_critic=True)),
     dict(agent=dict(critic_ensemble=3), steps_per_dispatch=4, tree_backend="numpy"),
     dict(agent=dict(compute_dtype="bfloat16", critic_ensemble=3), replay_placement="device",
          steps_per_dispatch=4, fused_descent=True),
     dict(agent=dict(twin_critic=True), batch_scale=2, replay_placement="hybrid",
          steps_per_dispatch=8)],
    ids=["host_twin", "host_k4_redq", "device_fused_redq_bf16", "hybrid_twin_scale2"],
)
def test_trainer_paths_run_stacked_and_bf16(kw, tmp_path):
    from d4pg_tpu_torch.runtime.trainer import Trainer

    agent = D4PGConfig(hidden_sizes=(8, 8), **kw.pop("agent"))
    cfg = TrainConfig(num_envs=2, batch_size=8, warmup_steps=64, total_steps=8, eval_interval=8,
                      eval_episodes=1, replay_capacity=4096, log_dir=str(tmp_path), agent=agent,
                      **kw)
    t = Trainer(cfg, device="cpu")
    row = t.train()
    t.close()
    assert t.grad_steps == 8
    for k in ("critic_loss", "q_mean", "priority_mean", "actor_loss"):
        assert np.isfinite(row[k]), (k, row[k])
    if cfg.batch_scale == 2:
        # the Trainer takes the batch as given, as the JAX Trainer does
        # (the CLI scales it: test_torch_batch_scale.py)
        assert (t.config.batch_size, t.config.steps_per_dispatch) == (8, 8)


# ---------------------------------------------------------- checkpoints
def _redq_state(seed, **kw):
    _, tcfg = _configs("redq", **kw)
    return tcfg, create_train_state(tcfg, seed=seed, device="cpu")


def test_resume_continues_the_redq_subset_stream(tmp_path):
    """The subset generator is in the checkpoint: a state restored after
    two steps draws the subsets an unbroken run draws next."""
    tcfg, st = _redq_state(0)
    rng = np.random.default_rng(8)
    for _ in range(2):
        train_step(tcfg, st, {k: torch.from_numpy(v) for k, v in _batch(rng).items()})
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(st.step, st)
    _, resumed = _redq_state(9)  # another seed: another stream until restored
    mgr.restore(resumed)
    assert resumed.step == st.step == 2
    nxt = [draw_subset(tcfg, st) for _ in range(8)]
    got = [draw_subset(tcfg, resumed) for _ in range(8)]
    assert all(torch.equal(a, b) for a, b in zip(nxt, got))
    for a, b in zip(st.critic_opt.state_dict()["state"].values(),
                    resumed.critic_opt.state_dict()["state"].values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and a["exp_avg"].shape[0] == 3


@pytest.mark.parametrize(
    "change,field",
    [(dict(agent=dict(critic_ensemble=3)), "critic_ensemble"),
     (dict(agent=dict(twin_critic=False)), "twin_critic"),
     (dict(agent=dict(twin_critic=True, compute_dtype="bfloat16")), "compute_dtype")],
    ids=["ensemble", "twin", "dtype"],
)
def test_resume_under_another_stack_is_refused(change, field, tmp_path):
    from d4pg_tpu_torch.runtime.trainer import Trainer

    def cfg(**agent):
        return TrainConfig(num_envs=2, batch_size=8, warmup_steps=64, total_steps=4,
                           eval_interval=4, eval_episodes=1, replay_capacity=512,
                           checkpoint_interval=4, log_dir=str(tmp_path),
                           agent=D4PGConfig(hidden_sizes=(8,), **agent))

    t = Trainer(cfg(twin_critic=True), device="cpu")
    t.train()
    t.close()
    with pytest.raises(StackMismatch, match=field):
        Trainer(dataclasses.replace(cfg(**change["agent"]), resume=True), device="cpu")
