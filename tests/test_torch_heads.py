"""The scalar and mixture-of-Gaussians critic heads of the port against
the JAX package, on the CPU.

Both sides start from ONE JAX ``create_train_state`` carried across with
``d4pg_tpu_torch.weights.load_jax_params`` and take the same numpy
batches; REDQ's target subset is the one the JAX step draws, fed through
``train_step(subset=)`` (``test_torch_stacked``'s helper). Neither head
reaches a Pallas kernel in the JAX package: its MoG and scalar losses are
XLA.

Tolerances, with their reasons:

- the forward pass from JAX params: atol 1e-6 (the same float32 products
  summed in another order, values of order 1);
- ``ops/mog.py`` against ``d4pg_tpu.ops.mog``: rtol 1e-5 / atol 1e-6.
  The quadrature nodes and weights are the same numpy float64 values
  rounded to float32; the log-densities reach ~1e3 in magnitude at the
  tail nodes of a narrow component, where a float32 ulp is ~6e-5, so the
  relative bound carries them;
- one ``train_step``: gradients, loss and priorities rtol 1e-4 / atol
  1e-6, ``test_torch_agent``'s; q_mean and actor_loss, read after one Adam
  step, atol 1e-3 (see there); the second chained step's priorities rtol
  1e-3 / atol 1e-4 (they read params after one Adam step);
- bfloat16 compute: ``test_torch_stacked``'s BF16_REL (derived there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.agent import jit_train_step
from d4pg_tpu.agent.d4pg import build_networks as j_build
from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.ops import mog as jmog
from d4pg_tpu.replay.source import validate_train_config
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state, train_step
from d4pg_tpu_torch.config import TrainConfig, check_placement
from d4pg_tpu_torch.models.critic import Critic, mog_bias_offsets
from d4pg_tpu_torch.ops import mog
from d4pg_tpu_torch.runtime.checkpoint import StackMismatch
from d4pg_tpu_torch.weights import load_jax_params, to_jax_params
from tests import test_torch_stacked as stacked

LR = 1e-4
HIDDEN = (16, 16)
B = 8
M = 5
HEADS = ("scalar", "mixture_gaussian")
STACKS = (None, "twin", "redq")
FUSED_ONLY_CATEGORICAL = (
    "--fused-descent fuses into the CATEGORICAL projection kernel; quantile/IQN "
    "heads keep the separate-programs tier"
)


def _configs(kind, stack=None, v=(-300.0, 0.0), m=M):
    twin, ens, msub = stacked.STACKS[stack] if stack else (False, 0, 2)
    common = dict(obs_dim=3, action_dim=1, hidden_sizes=HIDDEN, tau=0.05, n_step=3,
                  lr_actor=LR, lr_critic=LR, twin_critic=twin, critic_ensemble=ens,
                  ensemble_min_targets=msub)
    jcfg = JConfig(dist=JDist(kind=kind, num_mixtures=m, v_min=v[0], v_max=v[1]),
                   projection_backend="pallas_fused", **common)
    tcfg = D4PGConfig(dist=DistConfig(kind=kind, num_mixtures=m, v_min=v[0], v_max=v[1]),
                      projection_backend="fused", **common)
    return jcfg, tcfg


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("stack", STACKS, ids=["single", "twin", "redq"])
@pytest.mark.parametrize("kind", ("categorical",) + HEADS)
def test_forward_from_jax_params_and_weights_round_trip(kind, stack):
    """The critic's head from JAX params through ``weights.py`` equals the
    JAX forward (a stack: its vmap over members), and the params come back
    out unchanged: the ``out`` layer is only wider or narrower."""
    jcfg, tcfg = _configs(kind, stack)
    jst, tst = stacked._pair(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(4)
    obs = rng.normal(size=(B, 3)).astype(np.float32)
    act = rng.uniform(-1, 1, (B, 1)).astype(np.float32)
    _, critic = j_build(jcfg)
    if stack:
        want = np.asarray(jax.vmap(lambda p: critic.apply(p, obs, act))(jst.critic_params))
    else:
        want = np.asarray(critic.apply(jst.critic_params, obs, act))
    got = tst.critic(torch.from_numpy(obs), torch.from_numpy(act)).detach().numpy()
    assert got.shape == want.shape and got.shape[-1] == tcfg.dist.head_dim
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    _, critic_back = to_jax_params(tst)
    orig = jax.device_get(jst.critic_params)["params"]
    for layer, leaves in orig.items():
        for leaf_kind, leaf in leaves.items():
            np.testing.assert_array_equal(critic_back["params"][layer][leaf_kind], np.asarray(leaf))


# ----------------------------------------------------------------- ops
def _mog_inputs(seed=0, n=16, m=M):
    rng = np.random.default_rng(seed)
    head = rng.normal(size=(n, 3 * m)).astype(np.float32)
    head[:, m:2 * m] *= 50.0                        # means spread over a wide support
    head[:, 2 * m:] = rng.uniform(-7.0, 7.0, (n, m))  # log-stds past both clips
    reward = rng.uniform(-16, 0, n).astype(np.float32)
    discount = np.full(n, 0.99**3, np.float32)
    discount[::3] = 0.0                             # terminal rows: the std floor
    return head, reward, discount


@pytest.mark.parametrize("q", [4, 8])
def test_mog_ops_match_the_reference(q):
    head, reward, discount = _mog_inputs()
    target, _, _ = _mog_inputs(seed=1)
    jy, jw = jmog.mog_bellman_targets(jnp.asarray(target), jnp.asarray(reward),
                                      jnp.asarray(discount), M, q)
    ty, tw = mog.mog_bellman_targets(torch.from_numpy(target), torch.from_numpy(reward),
                                     torch.from_numpy(discount), M, q)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw.sum(dim=(-2, -1)).numpy(), 1.0, atol=1e-5)
    jlp = jmog.mog_log_prob(jnp.asarray(head), jy, M)
    y_nodes, node_w = torch.from_numpy(np.array(jy)), torch.from_numpy(np.array(jw))
    tlp = mog.mog_log_prob(torch.from_numpy(head), y_nodes, M)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=1e-5, atol=1e-6)
    jce = jmog.mog_cross_entropy(jnp.asarray(head), jy, jw, M)
    tce = mog.mog_cross_entropy(torch.from_numpy(head), y_nodes, node_w, M)
    np.testing.assert_allclose(tce.numpy(), np.asarray(jce), rtol=1e-5, atol=1e-6)
    assert np.isfinite(tce.numpy()).all()
    # a stacked head scores every member against the same nodes
    two = torch.from_numpy(np.stack([head, target]))
    both = mog.mog_cross_entropy(two, ty, tw, M)
    np.testing.assert_allclose(both[0].numpy(), tce.numpy(), rtol=1e-6)
    assert not ty.requires_grad and not tw.requires_grad


def test_mog_targets_carry_no_gradient():
    target, reward, discount = _mog_inputs()
    t = torch.from_numpy(target).requires_grad_(True)
    y, w = mog.mog_bellman_targets(t, torch.from_numpy(reward), torch.from_numpy(discount), M)
    assert not y.requires_grad and not w.requires_grad


# ----------------------------------------------------------------- step
@pytest.mark.parametrize("stack", STACKS, ids=["single", "twin", "redq"])
@pytest.mark.parametrize("kind", HEADS)
def test_train_step_matches_the_reference(kind, stack):
    """One step: every gradient (from optax's first moment), the loss, the
    priorities and the metrics; then a second chained step."""
    jcfg, tcfg = _configs(kind, stack)
    jst, tst = stacked._pair(jcfg, tcfg, seed=1)
    rng = np.random.default_rng(2)
    jstep = jit_train_step(jcfg, donate=False)
    jst1, jm, jpri, tm, tpri = stacked._step(jstep, jcfg, tcfg, jst, tst, stacked._batch(rng))
    b1 = jcfg.adam_b1
    for module, opt_state in ((tst.critic, jst1.critic_opt_state), (tst.actor, jst1.actor_opt_state)):
        for name, prm, leaf in stacked._leaves(module, opt_state[0].mu):
            np.testing.assert_allclose(prm.grad.numpy(), leaf / (1 - b1), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    np.testing.assert_allclose(tpri, jpri, rtol=1e-4, atol=1e-6)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("q_mean", "actor_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=1e-3, err_msg=k)
    assert set(tm) == set(jm) and "q_support_frac" not in tm and tpri.shape == (B,)
    jst2, jm, jpri, tm, tpri = stacked._step(jstep, jcfg, tcfg, jst1, tst, stacked._batch(rng))
    np.testing.assert_allclose(tpri, jpri, rtol=1e-3, atol=1e-4)
    assert tst.step == int(jst2.step) == 2


@pytest.mark.parametrize("kind", HEADS)
def test_stacked_target_member_is_chosen_by_the_heads_mean(kind):
    """Twin critics back up, per sample, the target member whose head has
    the smaller E[Z] under the configured head: the mixture mean (not a
    softmax over the 3M head), the scalar itself."""
    from d4pg_tpu_torch.agent.d4pg import _critic_value, _target_head

    _, tcfg = _configs(kind, "twin")
    st = create_train_state(tcfg, seed=0, device="cpu")
    with torch.no_grad():
        for p in st.target_critic.parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    obs = torch.from_numpy(np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32))
    with torch.no_grad():
        # shift member 1's E[Z] onto member 0's on average, so that each
        # member is the smaller one for some samples
        vals = _critic_value(tcfg, None, st.target_critic(obs, st.target_actor(obs)))
        shift = slice(0, 1) if kind == "scalar" else slice(M, 2 * M)
        st.target_critic.out.bias[1, shift] += (vals[0] - vals[1]).mean()
        got = _target_head(tcfg, None, st, obs, None)
        heads = st.target_critic(obs, st.target_actor(obs))
    vals = _critic_value(tcfg, None, heads)
    want = torch.where((vals[0] <= vals[1])[:, None], heads[0], heads[1])
    assert torch.equal(got, want)
    assert 0 < int((vals[0] <= vals[1]).sum()) < 64  # both members chosen somewhere


@pytest.mark.parametrize("kind", HEADS)
def test_bf16_heads_return_float32_and_step_as_the_reference(kind):
    """Under bfloat16 compute the head comes back float32 and the MoG
    quadrature runs in float32; one step against the JAX bf16 step at
    ``test_torch_stacked``'s bf16 tolerances (BF16_REL relative on the
    loss and priorities, BF16_REL of the 300-wide support on q_mean)."""
    jcfg, tcfg = _configs(kind)
    jcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    jst, tst = stacked._pair(jcfg, tcfg, seed=6)
    batch = stacked._batch(np.random.default_rng(7))
    obs, act = torch.from_numpy(batch["obs"]), torch.from_numpy(batch["action"])
    head = tst.critic(obs, act)
    assert head.dtype == torch.float32
    if kind == "mixture_gaussian":
        y, w = mog.mog_bellman_targets(head, torch.from_numpy(batch["reward"]),
                                       torch.from_numpy(batch["discount"]), M)
        assert y.dtype == w.dtype == torch.float32
    _, jm, jpri, tm, tpri = stacked._step(jit_train_step(jcfg, donate=False), jcfg, tcfg,
                                          jst, tst, batch)
    np.testing.assert_allclose(tpri, jpri, rtol=stacked.BF16_REL, atol=0)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=stacked.BF16_REL, err_msg=k)
    np.testing.assert_allclose(float(tm["q_mean"]), float(jm["q_mean"]), atol=stacked.BF16_REL * 300)


# ----------------------------------------------------------------- init
@pytest.mark.parametrize(
    "argv,support",
    [(["--env", "pendulum", "--critic-head", "mixture_gaussian"], (-300.0, 0.0)),
     (["--env", "pendulum", "--critic-head", "mixture_gaussian", "--num-mixtures", "7",
       "--v-min", "-400"], (-400.0, 0.0)),
     (None, (-10.0, 10.0))],
    ids=["preset", "explicit", "from_code_defaults"],
)
def test_mog_bias_init_matches_the_reference(argv, support, tmp_path):
    """The MoG head's bias: U[0, 3e-4) plus the centers and log-stds of the
    support the trainer resolves (a MoG head built from code with the
    default DistConfig keeps [-10, 10], as the JAX trainer does)."""
    from d4pg_tpu_torch.runtime.trainer import Trainer
    from d4pg_tpu_torch.train import build_parser, config_from_args

    small = ["--hidden-sizes", "8", "--rmsize", "256", "--num-envs", "2",
             "--log-dir", str(tmp_path)]
    if argv is None:
        cfg = TrainConfig(env="pendulum", replay_capacity=256, num_envs=2, log_dir=str(tmp_path),
                          agent=D4PGConfig(hidden_sizes=(8,),
                                           dist=DistConfig(kind="mixture_gaussian")))
    else:
        cfg = config_from_args(build_parser().parse_args(argv + small))
    t = Trainer(cfg, device="cpu")
    t.close()
    dist = t.config.agent.dist
    assert (dist.v_min, dist.v_max) == support
    m = dist.num_mixtures
    # the JAX init's arithmetic (d4pg_tpu/models/critic.py:102-110), in jnp
    span = dist.v_max - dist.v_min
    centers = dist.v_min + (jnp.arange(m) + 0.5) * span / m
    offsets = mog_bias_offsets(dist).numpy()
    np.testing.assert_array_equal(offsets[m:2 * m], np.asarray(centers, np.float32))
    np.testing.assert_array_equal(offsets[2 * m:], np.full(m, jnp.log(span / m), np.float32))
    assert not offsets[:m].any()
    jcfg = JConfig(obs_dim=3, action_dim=1, hidden_sizes=(8,),
                   dist=JDist(kind="mixture_gaussian", num_mixtures=m, v_min=dist.v_min,
                              v_max=dist.v_max))
    jbias = np.asarray(j_create(jcfg, jax.random.PRNGKey(0)).critic_params["params"]["out"]["bias"])
    tbias = t.state.critic.out.bias.detach().numpy()
    slack = np.spacing(np.abs(offsets)).max()  # base + offset − offset is base to an ulp
    for bias in (jbias, tbias):
        base = bias - offsets
        assert base.min() >= -slack and base.max() < 3e-4 + slack
    head = Critic(3, 1, dist, (8,), generator=torch.Generator().manual_seed(0))
    assert head.out.bias.shape == (3 * m,)


# ------------------------------------------------------------ refusals
def test_fused_descent_refuses_the_other_heads_with_the_reference_text():
    for kind in HEADS:
        cfg = TrainConfig(replay_placement="device", prioritized=True, fused_descent=True,
                          agent=D4PGConfig(dist=DistConfig(kind=kind)))
        with pytest.raises(ValueError) as ours:
            check_placement(cfg)
        assert str(ours.value) == f"fused_descent_categorical_only: {FUSED_ONLY_CATEGORICAL}"
        jcfg = JTrainConfig(replay_placement="device", prioritized=True, fused_descent=True,
                            agent=JConfig(dist=JDist(kind=kind),
                                          projection_backend="pallas_fused"))
        with pytest.raises(ValueError, match="fuses into the CATEGORICAL"):
            validate_train_config(jcfg, is_jax_env=True)
        _, tcfg = _configs(kind)
        st = create_train_state(tcfg, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in stacked._batch(np.random.default_rng(0)).items()}
        with pytest.raises(ValueError, match="requires the categorical head"):
            train_step(tcfg, st, batch, descent=(torch.ones(8), torch.zeros(B), torch.zeros(1)))


@pytest.mark.parametrize(
    "first,second,field",
    [(dict(kind="mixture_gaussian", num_mixtures=17), dict(), "critic_head"),
     (dict(kind="mixture_gaussian", num_mixtures=3), dict(kind="mixture_gaussian",
                                                          num_mixtures=5), "num_mixtures"),
     (dict(kind="scalar"), dict(kind="mixture_gaussian"), "critic_head")],
    ids=["mog17_as_categorical51", "mixtures", "scalar_as_mog"],
)
def test_resume_under_another_head_is_refused(first, second, field, tmp_path):
    """A MoG head of M = 17 is 51 wide, as the categorical head: the
    checkpoint's head record, not the layer shape, refuses the resume,
    before any step."""
    from d4pg_tpu_torch.runtime.trainer import Trainer

    def cfg(**dist):
        return TrainConfig(num_envs=2, batch_size=8, warmup_steps=64, total_steps=4,
                           eval_interval=4, eval_episodes=1, replay_capacity=512,
                           checkpoint_interval=4, log_dir=str(tmp_path),
                           agent=D4PGConfig(hidden_sizes=(8,), dist=DistConfig(**dist)))

    t = Trainer(cfg(**first), device="cpu")
    t.train()
    t.close()
    with pytest.raises(StackMismatch, match=field):
        Trainer(dataclasses.replace(cfg(**second), resume=True), device="cpu")
    again = Trainer(dataclasses.replace(cfg(**first), resume=True), device="cpu")
    again.close()
    assert again.grad_steps == 4
