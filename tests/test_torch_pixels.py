"""The pixel path of the port (ROADMAP A10 (c)) against the JAX package,
on the CPU: the conv encoder, the DrQ random shift, the arm render, the
uint8 encode and decode, one pixel train step under each head and a twin
and a REDQ critic, the weights both ways, ``best_actor.npz``, a JAX pixel
bundle served by the port and the shift generator in ``state.pt``.

Frames are 10x14x2 (H ≠ W, so a transposed axis fails) and the MLPs
16 wide; the encoder keeps its 4x32 convs and 50-wide embedding. The
JAX step's randomness is fed in: its two shift draws (``k_obs``,
``k_next`` split from ``TrainState.key``) through ``train_step(shift=)``
and REDQ's subset (split from what is left) through ``subset=``. No pixel
op reaches a Pallas kernel in the JAX package; its step's categorical
loss runs the fused Pallas kernel in interpret mode, as the JAX tests run
it.

Tolerances, with their reasons:

- the encoder in float32: atol 1e-5 (the same products summed in another
  order over up to 288-term convolutions and the 1120-term Dense, then a
  LayerNorm and tanh of values of order 1);
- the encoder in bfloat16: atol ``BF16_ATOL`` = 2^-6 on the tanh output.
  Each conv rounds its output to bfloat16 (relative 2^-9), the two
  packages' float32 accumulations of the same bfloat16 products differ by
  an ulp before that rounding, so an element can land one bfloat16 ulp
  (2^-8 relative) apart after each of the 5 products; the LayerNorm
  rescales to unit variance and tanh is 1-Lipschitz, so a few ulps of 2^-8
  bound it;
- ``random_shift`` with the JAX offsets fed in, the uint8 encode and
  decode: exact (``torch.equal`` / ``array_equal``): gathers, one
  rounding and one division, the same float32 operations on both sides;
- the render: atol 1e-5 against the JAX function and against the NumPy
  twin. The stroke is ``sigmoid((1.2 − d)/0.5)`` of a float32 distance d
  of up to ~34 px, whose ulp is 3.8e-6; ``sin``/``cos``, ``sqrt`` and
  ``exp`` differ by an ulp between XLA, NumPy and torch, and the stroke's
  slope in d is at most 0.5, so a few ulps of d stay well under 1e-5;
- one train step: the critic's gradients, the losses and priorities
  rtol 1e-4 / atol 1e-6 (``test_torch_heads``' bound); the actor's
  gradients rtol 1e-4 / atol 1e-5, and q_mean and actor_loss atol 1e-3:
  they read the critic after its Adam step, where a coordinate whose
  gradient is within float32 noise of 0 (a dead ReLU's, of which the
  encoder has many) may step by lr = 1e-4 the other way on the other
  side. Seen: 1.6e-6 on the actor's output bias under the categorical
  head;
- the weights both ways: exact.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.agent import jit_train_step
from d4pg_tpu.agent.d4pg import build_networks as j_build
from d4pg_tpu.envs.pixel_pendulum import PixelPendulum as JPixelPendulum
from d4pg_tpu.envs.pixel_pendulum import render_arm as j_render_arm
from d4pg_tpu.envs.pixel_pendulum_host import PixelPendulumHost as JHost
from d4pg_tpu.envs.pixel_pendulum_host import render_arm_np as j_render_arm_np
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu.models.encoders import PixelEncoder as JPixelEncoder
from d4pg_tpu.ops.augment import random_shift as j_random_shift
from d4pg_tpu.replay.uniform import ReplayBuffer as JReplayBuffer
from d4pg_tpu.runtime import on_device as jod
from d4pg_tpu.runtime.trainer import load_best_actor as j_load_best_actor
from d4pg_tpu.serve import batcher as jbatcher
from d4pg_tpu.serve import bundle as jbundle
from d4pg_tpu_torch.agent import D4PGConfig, DistConfig, create_train_state, train_step
from d4pg_tpu_torch.agent.d4pg import decode_obs, encode_obs
from d4pg_tpu_torch.envs import EnvState, make_env
from d4pg_tpu_torch.envs.pixel_pendulum import PixelPendulum, render_arm
from d4pg_tpu_torch.envs.pixel_pendulum_host import PixelPendulumHost, render_arm_np
from d4pg_tpu_torch.models.encoders import PixelEncoder, same_pad
from d4pg_tpu_torch.ops.augment import draw_offsets, random_shift
from d4pg_tpu_torch.replay import ReplayBuffer, Transition
from d4pg_tpu_torch.runtime.checkpoint import CheckpointManager
from d4pg_tpu_torch.serve.batcher import DynamicBatcher
from d4pg_tpu_torch.serve.bundle import load_bundle
from d4pg_tpu_torch.weights import (
    flax_leaves,
    flax_to_state_dict,
    load_best_actor,
    load_jax_params,
    save_best_actor,
    state_dict_to_flax,
    to_jax_params,
)

# MKL's threads per pytest worker slow the convolutions down many times
# under xdist (PERF.md section 7); one thread a file
torch.set_num_threads(1)

SHAPE = (10, 14, 2)
OBS = SHAPE[0] * SHAPE[1] * SHAPE[2]
HIDDEN = (16, 16)
B = 8
LR = 1e-4
PAD = 4
BF16_ATOL = 2.0**-6
STACKS = {None: (False, 0, 2), "twin": (True, 0, 2), "redq": (False, 3, 2)}
PAIRS = {"categorical": "pallas_fused", "scalar": "pallas_fused",
         "mixture_gaussian": "pallas_fused"}


def _frames(rng, n, shape=SHAPE):
    """n flattened frames of quantized [0, 1] values (what replay decodes)."""
    return (rng.integers(0, 256, size=(n, int(np.prod(shape)))) / 255.0).astype(np.float32)


def _configs(kind="categorical", stack=None, dtype="float32", shape=SHAPE):
    twin, ens, m = STACKS[stack]
    common = dict(obs_dim=int(np.prod(shape)), action_dim=1, hidden_sizes=HIDDEN,
                  pixel_shape=tuple(shape), tau=0.05, n_step=3, lr_actor=LR, lr_critic=LR,
                  twin_critic=twin, critic_ensemble=ens, ensemble_min_targets=m,
                  compute_dtype=dtype, augment_pad=PAD)
    jcfg = JConfig(dist=JDist(kind=kind, v_min=-300.0, v_max=0.0),
                   projection_backend=PAIRS[kind], **common)
    tcfg = D4PGConfig(dist=DistConfig(kind=kind, v_min=-300.0, v_max=0.0),
                      projection_backend="fused", **common)
    return jcfg, tcfg


def _pair(jcfg, tcfg, seed=0):
    jst = j_create(jcfg, jax.random.PRNGKey(seed))
    tst = create_train_state(tcfg, device="cpu")
    load_jax_params(tst, jax.device_get(jst.actor_params), jax.device_get(jst.critic_params))
    return jst, tst


def _batch(rng, n=B):
    b = {
        "obs": _frames(rng, n),
        "action": rng.uniform(-1, 1, size=(n, 1)).astype(np.float32),
        "reward": rng.uniform(-16, 0, size=n).astype(np.float32),
        "next_obs": _frames(rng, n),
        "discount": np.where(rng.uniform(size=n) < 0.2, 0.0, 0.99**3).astype(np.float32),
        "weights": rng.uniform(0.2, 1.0, size=n).astype(np.float32),
    }
    b["reward"][1] = -400.0  # the target clips at v_min
    return b


def _j_draws(jcfg, key, n=B):
    """The JAX step's shift offsets (two [B, 2] draws) and, for REDQ, its
    subset, from ``TrainState.key``: ``split(key, 3)`` gives k_obs, k_next
    and the key REDQ splits its subset key from."""
    k_obs, k_next, rest = jax.random.split(key, 3)
    pad = jcfg.augment_pad
    shift = tuple(torch.from_numpy(np.array(jax.random.randint(k, (n, 2), -pad, pad + 1)))
                  .long() for k in (k_obs, k_next))
    subset = None
    if jcfg.critic_ensemble:
        k_subset, _ = jax.random.split(rest)
        subset = torch.from_numpy(np.array(
            jax.random.permutation(k_subset, jcfg.critic_ensemble)[: jcfg.ensemble_min_targets]
        ).astype(np.int64))
    return shift, subset


# ------------------------------------------------------------- encoder
@pytest.mark.parametrize("h,w,c", [(10, 14, 2), (11, 9, 3), (48, 48, 2)])
def test_same_padding_is_xlas(h, w, c):
    """The encoder's per-axis padding equals ``lax.padtype_to_pads``'s
    SAME padding: (0, 1) for a stride-2 conv of an even size."""
    for size in (h, w):
        for s in (1, 2):
            want = jax.lax.padtype_to_pads((size,), (3,), (s,), "SAME")[0]
            assert same_pad(size, s) == tuple(want)


@pytest.mark.parametrize("shape", [(10, 14, 2), (11, 9, 3)], ids=["10x14x2", "11x9x3"])
def test_encoder_matches_the_reference(shape):
    """The JAX ``PixelEncoder``'s params carried across: the embedding
    within 1e-5 (float32), channels-last frames of H ≠ W."""
    jenc = JPixelEncoder(embed_dim=50)
    frames = _frames(np.random.default_rng(1), 16, shape)
    imgs = frames.reshape(16, *shape)
    params = jenc.init(jax.random.PRNGKey(2), imgs[:1])
    want = np.asarray(jenc.apply(params, imgs))
    enc = PixelEncoder(shape, 50)
    enc.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    got = enc(torch.from_numpy(frames)).detach().numpy()
    assert got.shape == want.shape == (16, 50)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    back = state_dict_to_flax(enc)["params"]
    for leaf_a, leaf_b in zip(flax_leaves(back), flax_leaves(jax.device_get(params)["params"])):
        np.testing.assert_array_equal(leaf_a, np.asarray(leaf_b))


def test_bf16_encoder_matches_the_reference():
    jenc = JPixelEncoder(embed_dim=50, dtype=jnp.bfloat16)
    frames = _frames(np.random.default_rng(3), 16)
    imgs = frames.reshape(16, *SHAPE)
    params = jenc.init(jax.random.PRNGKey(4), imgs[:1])
    want = np.asarray(jenc.apply(params, imgs))
    enc = PixelEncoder(SHAPE, 50, compute_dtype=torch.bfloat16)
    enc.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    got = enc(torch.from_numpy(frames))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=BF16_ATOL)


def test_encoder_init_is_flax_lecun_normal():
    """Conv and Dense kernels: a normal truncated at 2 standard deviations
    of variance 1/fan_in (the JAX draw's moments on the same shape);
    biases zero; LayerNorm scale one."""
    enc = PixelEncoder((48, 48, 2), 50, generator=torch.Generator().manual_seed(0))
    jparams = JPixelEncoder(embed_dim=50).init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 48, 2)))
    jp = jax.device_get(jparams)["params"]
    for name, fan_in in (("Conv_1", 9 * 32), ("Dense_0", 24 * 24 * 32)):
        w = flax_to_state_dict({name: jp[name]})[f"{name}.weight"].numpy()
        ours = getattr(enc, name).weight.detach().numpy()
        std = np.sqrt(1.0 / fan_in)
        for x in (ours, w):
            assert abs(x.std() / std - 1.0) < 0.05 and np.abs(x).max() <= 2 * std / 0.8796 + 1e-7
        assert not getattr(enc, name).bias.detach().any()
    assert torch.equal(enc.LayerNorm_0.weight.detach(), torch.ones(50))


# --------------------------------------------------------------- shift
@pytest.mark.parametrize("pad", [1, 4])
def test_random_shift_with_the_reference_offsets_is_equal(pad):
    frames = _frames(np.random.default_rng(5), 32)
    key = jax.random.PRNGKey(pad)
    want = np.asarray(j_random_shift(jnp.asarray(frames), key, SHAPE, pad))
    offsets = torch.from_numpy(np.array(jax.random.randint(key, (32, 2), -pad, pad + 1)))
    got = random_shift(torch.from_numpy(frames), offsets.long(), SHAPE)
    assert torch.equal(got, torch.from_numpy(np.array(want)))
    # the draw covers [-pad, pad] on both axes
    drawn = draw_offsets(4096, pad, torch.Generator().manual_seed(0))
    assert drawn.min() == -pad and drawn.max() == pad and drawn.shape == (4096, 2)


# -------------------------------------------------------------- render
def test_render_matches_both_reference_twins():
    rng = np.random.default_rng(6)
    theta = rng.uniform(-4, 4, 64).astype(np.float32)
    got = render_arm(torch.from_numpy(theta), 48).numpy()
    want = np.asarray(jax.vmap(lambda t: j_render_arm(t, 48))(jnp.asarray(theta)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    host = np.stack([j_render_arm_np(t, 48) for t in theta])
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-5)
    ours_np = np.stack([render_arm_np(t, 48) for t in theta])
    np.testing.assert_array_equal(ours_np, host)
    assert got.min() >= 0 and got.max() <= 1 and (got > 0.5).any()


def test_pixel_pendulum_steps_as_the_reference():
    """The same physics through a step: obs (both channels), reward and
    flags against the JAX env vmapped over the same states."""
    rng = np.random.default_rng(7)
    n = 16
    physics = np.stack([rng.uniform(-np.pi, np.pi, n), rng.uniform(-8, 8, n)], -1)
    physics = physics.astype(np.float32)
    t = rng.integers(190, 200, n).astype(np.int32)
    action = rng.uniform(-1.2, 1.2, (n, 1)).astype(np.float32)
    env = make_env("pixel_pendulum")
    assert isinstance(env, PixelPendulum) and env.pixel_shape == (48, 48, 2)
    state = EnvState(physics=torch.from_numpy(physics), t=torch.from_numpy(t))
    _, obs, r, term, trunc = env.step(state, torch.from_numpy(action))
    jenv = JPixelPendulum()
    from d4pg_tpu.envs.api import EnvState as JState
    jst = JState(physics=jnp.asarray(physics), t=jnp.asarray(t),
                 key=jax.random.split(jax.random.PRNGKey(0), n))
    _, jobs, jr, jterm, jtrunc = jax.vmap(jenv.step)(jst, jnp.asarray(action))
    assert obs.shape == (n, 48 * 48 * 2)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc, np.float32))
    np.testing.assert_array_equal(term.numpy(), np.asarray(jterm, np.float32))


def test_host_twin_is_the_references():
    """The port's NumPy env is the JAX package's: the same seeded episode,
    byte for byte."""
    ours, ref = PixelPendulumHost(size=12), JHost(size=12)
    np.testing.assert_array_equal(ours.reset(seed=3), ref.reset(seed=3))
    for a in np.linspace(-1.5, 1.5, 7):
        o1, r1, t1, tr1, _ = ours.step(np.array([a], np.float32))
        o2, r2, t2, tr2, _ = ref.step(np.array([a], np.float32))
        np.testing.assert_array_equal(o1, o2)
        assert (r1, t1, tr1) == (r2, t2, tr2)


# ------------------------------------------------------ uint8 storage
def _edge_frames(rng, n):
    """Frames with values at the rounding edges: k/255 and (k + 0.5)/255,
    where round-half-to-even decides, plus out-of-range values."""
    x = _frames(rng, n)
    k = rng.integers(0, 255, size=x.shape)
    x[:, ::3] = ((k[:, ::3] + 0.5) / 255.0).astype(np.float32)
    x[0, :4] = [-0.1, 1.2, 0.5 / 255, 254.5 / 255]
    return x


def test_uint8_replay_encodes_and_decodes_as_the_reference():
    """Host buffer: the stored bytes and the decoded batch are the JAX
    buffer's, bit for bit; the raw mode returns the bytes; the device
    encode and decode (the on-device ring's) equal the JAX ring's."""
    rng = np.random.default_rng(8)
    obs, nxt = _edge_frames(rng, 32), _edge_frames(rng, 32)
    t = Transition(obs, rng.uniform(-1, 1, (32, 1)).astype(np.float32),
                   rng.normal(size=32).astype(np.float32), nxt, np.ones(32, np.float32))
    ours = ReplayBuffer(64, OBS, 1, obs_dtype=np.uint8)
    ref = JReplayBuffer(64, OBS, 1, obs_dtype=np.uint8)
    ours.add_batch(t)
    ref.add_batch(t)
    np.testing.assert_array_equal(ours.obs, ref.obs)
    np.testing.assert_array_equal(ours.next_obs, ref.next_obs)
    idx = rng.integers(0, 32, 16)
    got, want = ours.gather(idx), ref.gather(idx)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    raw = ReplayBuffer(64, OBS, 1, obs_dtype=np.uint8, decode_on_sample=False)
    raw.add_batch(t)
    assert raw.gather(idx)["obs"].dtype == np.uint8
    np.testing.assert_array_equal(raw.gather(idx)["obs"], ref.obs[idx])
    # the device ring's encode and decode
    enc = encode_obs(torch.from_numpy(obs))
    jenc = np.asarray(jod._encode_obs(jnp.asarray(obs), jnp.uint8))
    np.testing.assert_array_equal(enc.numpy(), jenc)
    np.testing.assert_array_equal(enc.numpy(), ref.obs[:32])
    np.testing.assert_array_equal(decode_obs(enc).numpy(),
                                  np.asarray(jod._decode_obs(jnp.asarray(jenc), jnp.uint8)))


# ---------------------------------------------------------------- step
def _grads(module):
    return {n: p.grad for n, p in module.named_parameters()}


@pytest.mark.parametrize(
    "kind,stack",
    [("categorical", None), ("scalar", None), ("mixture_gaussian", None),
     ("categorical", "twin"), ("categorical", "redq")],
    ids=["categorical", "scalar", "mixture_gaussian", "twin", "redq"],
)
def test_pixel_train_step_matches_the_reference(kind, stack):
    """One pixel step from one JAX state, the JAX step's shift (and
    subset) draws fed in: every gradient (from optax's first moment, the
    encoders' included), the losses, the priorities and the metrics."""
    jcfg, tcfg = _configs(kind, stack)
    jst, tst = _pair(jcfg, tcfg, seed=1)
    batch = _batch(np.random.default_rng(2))
    shift, subset = _j_draws(jcfg, jst.key)
    jst1, jm, jpri = jit_train_step(jcfg, donate=False)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    _, tm, tpri = train_step(tcfg, tst, {k: torch.from_numpy(v) for k, v in batch.items()},
                             subset=subset, shift=shift)
    b1 = jcfg.adam_b1
    for module, opt_state in ((tst.critic, jst1.critic_opt_state),
                              (tst.actor, jst1.actor_opt_state)):
        want = flax_to_state_dict(jax.device_get(opt_state[0].mu))
        grads = _grads(module)
        assert set(grads) == set(want)
        assert any(n.startswith("PixelEncoder_0.") for n in grads)
        atol = 1e-6 if module is tst.critic else 1e-5
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy() / (1 - b1),
                                       rtol=1e-4, atol=atol, err_msg=name)
    np.testing.assert_allclose(tpri.numpy(), np.asarray(jpri), rtol=1e-4, atol=1e-6)
    for k in ("critic_loss", "priority_mean"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    for k in ("q_mean", "actor_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=0, atol=1e-3, err_msg=k)
    assert set(tm) == set(jm)


def test_train_step_draws_its_shift_from_the_augment_generator():
    """Without ``shift=`` the step draws two offset blocks from
    ``state.augment_gen``; fed the same blocks, a copy of the state takes
    the same step. With ``augment_pad`` 0 there is no generator and no
    shift."""
    import copy

    _, tcfg = _configs()
    st = create_train_state(tcfg, seed=3, device="cpu")
    twin = copy.deepcopy(st)
    gen = torch.Generator().set_state(st.augment_gen.get_state())
    shift = (draw_offsets(B, PAD, gen), draw_offsets(B, PAD, gen))
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(4)).items()}
    _, m1, p1 = train_step(tcfg, st, batch)
    _, m2, p2 = train_step(tcfg, twin, batch, shift=shift)
    assert torch.equal(p1, p2) and torch.equal(m1["critic_loss"], m2["critic_loss"])
    assert torch.equal(st.augment_gen.get_state(), gen.get_state())
    off = create_train_state(dataclasses.replace(tcfg, augment_pad=0), device="cpu")
    assert off.augment_gen is None


# ------------------------------------------------------------ weights
@pytest.mark.parametrize("stack", [None, "twin"], ids=["single", "twin"])
def test_weights_carry_both_ways_and_forward_equal(stack):
    """JAX → port → JAX is the identity on every nested leaf (conv kernels
    HWIO, LayerNorm scale, stacked [E, ...] leaves), and the port's critic
    and actor forwards from them equal the JAX forwards."""
    jcfg, tcfg = _configs(stack=stack)
    jst, tst = _pair(jcfg, tcfg, seed=5)
    actor_back, critic_back = to_jax_params(tst)
    for got, want in ((actor_back, jst.actor_params), (critic_back, jst.critic_params)):
        want = jax.device_get(want)["params"]
        assert jax.tree_util.tree_structure(got["params"]) == jax.tree_util.tree_structure(want)
        for a, b in zip(flax_leaves(got["params"]), flax_leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    rng = np.random.default_rng(6)
    obs, act = _frames(rng, B), rng.uniform(-1, 1, (B, 1)).astype(np.float32)
    jactor, jcritic = j_build(jcfg)
    if stack:
        want = jax.vmap(lambda p: jcritic.apply(p, obs, act))(jst.critic_params)
    else:
        want = jcritic.apply(jst.critic_params, obs, act)
    got = tst.critic(torch.from_numpy(obs), torch.from_numpy(act)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tst.actor(torch.from_numpy(obs)).detach().numpy(),
                               np.asarray(jactor.apply(jst.actor_params, obs)), rtol=0, atol=1e-5)


def test_best_actor_npz_is_the_jax_leaf_layout(tmp_path):
    """``PixelEncoder_0`` sorts before ``hidden_0``: the port's
    best_actor.npz loads in the JAX package and back, leaf for leaf."""
    jcfg, tcfg = _configs()
    jst, tst = _pair(jcfg, tcfg, seed=7)
    save_best_actor(str(tmp_path), tst.actor)
    template = jax.device_get(jst.actor_params)
    loaded = j_load_best_actor(str(tmp_path), template)
    for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(template)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(os.path.join(tmp_path, "checkpoints", "best_actor.npz")) as z:
        assert z["leaf_0000"].shape == (32,) and z["leaf_0001"].shape == (3, 3, 2, 32)
    other = create_train_state(tcfg, seed=8, device="cpu").actor
    load_best_actor(str(tmp_path), other)
    for (n, a), b in zip(other.state_dict().items(), tst.actor.state_dict().values()):
        assert torch.equal(a, b), n


def test_a_jax_pixel_bundle_is_served_by_the_port(tmp_path):
    """A JAX pixel bundle (``pixel_shape`` in its json) loads into the
    port; the port's batcher and the JAX batcher answer the same frames
    within 1e-5."""
    jcfg, _ = _configs()
    jparams = jax.device_get(j_create(jcfg, jax.random.PRNGKey(9)).actor_params)
    jbundle.export_bundle(str(tmp_path), jcfg, jparams)
    b = load_bundle(str(tmp_path))
    assert b.config.pixel_shape == SHAPE and b.config.encoder_embed_dim == 50
    obs = _frames(np.random.default_rng(10), 12)
    jb = jbundle.load_bundle(str(tmp_path))
    kw = dict(max_batch=4, max_wait_us=200, queue_limit=32)
    outs = []
    for batcher in (jbatcher.DynamicBatcher(jb.config, jb.actor_params, **kw),
                    DynamicBatcher(b.config, b.actor_params, device="cpu", **kw)):
        batcher.start()
        try:
            outs.append(np.stack([f.result(60) for f in [batcher.submit(o) for o in obs]]))
        finally:
            batcher.stop()
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-5)


# --------------------------------------------------------- checkpoint
def test_state_pt_carries_the_augment_generator(tmp_path):
    """The shift generator is in the checkpoint: a state restored after two
    steps draws the offsets an unbroken run draws next."""
    _, tcfg = _configs()
    st = create_train_state(tcfg, seed=0, device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(2):
        train_step(tcfg, st, {k: torch.from_numpy(v) for k, v in _batch(rng).items()})
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(st.step, st)
    resumed = create_train_state(tcfg, seed=9, device="cpu")
    assert not torch.equal(resumed.augment_gen.get_state(), st.augment_gen.get_state())
    mgr.restore(resumed)
    want = [draw_offsets(B, PAD, st.augment_gen) for _ in range(4)]
    got = [draw_offsets(B, PAD, resumed.augment_gen) for _ in range(4)]
    assert all(torch.equal(a, b) for a, b in zip(want, got))
