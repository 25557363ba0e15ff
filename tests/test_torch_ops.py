"""Parity of the port's tensor ops with the JAX package, on the CPU.

The same numpy inputs go through ``d4pg_tpu.ops`` (the XLA path, and the
Pallas kernels in interpret mode, as ``tests/test_pallas_projection.py``
runs them) and through ``d4pg_tpu_torch.ops`` (whose kernel wrappers run
their plain PyTorch versions on CPU tensors). The CUDA kernels themselves
are held against those plain versions on the card by ``chip_smoke.py``.

Tolerance: atol 1e-5 unless stated. Both sides sum the same float32 terms
in another order (the plain projection is an einsum, the Pallas kernel an
unrolled loop); the gap measured on these inputs is ≤ 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.ops import categorical as jcat
from d4pg_tpu.ops import nstep as jnstep
from d4pg_tpu.ops import polyak as jpolyak
from d4pg_tpu.ops.pallas_projection import (
    categorical_projection_pallas,
    fused_categorical_loss as j_fused_loss,
)
from d4pg_tpu_torch.ops import categorical as tcat
from d4pg_tpu_torch.ops import cuda_projection as cp
from d4pg_tpu_torch.ops.nstep import nstep_returns
from d4pg_tpu_torch.ops.polyak import polyak_update

ATOL = 1e-5
SUPPORTS = [(-300.0, 0.0), (-10.0, 10.0)]


def _inputs(B, A, v_min, v_max, seed=0):
    """Logits, target probs, rewards and discounts with terminal rows and
    rows whose targets clip at v_min and at v_max."""
    rng = np.random.default_rng(seed)
    span = v_max - v_min
    q = (2.0 * rng.normal(size=(B, A))).astype(np.float32)
    logits = 2.0 * rng.normal(size=(B, A))
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    r = (v_min + 0.3 * span * rng.uniform(size=B)).astype(np.float32)
    d = np.full(B, 0.99**3, np.float32)
    d[0::5] = 0.0                        # terminal
    r[1::5] = v_min - 0.5 * span         # clips at v_min
    r[2::5] = v_max + 0.5 * span         # clips at v_max
    g_ce = (rng.uniform(size=B) + 0.5).astype(np.float32)
    g_ov = (rng.uniform(size=B) - 0.5).astype(np.float32)
    return q, p, r, d, g_ce, g_ov


def _xla_atol(A, v_min, v_max):
    """Tolerance of the port's projections against the XLA projection.
    XLA takes z from ``jnp.linspace``, the port's one-hot projection from
    ``torch.linspace``, the Pallas kernel and the port's hat projection
    from v_min + j·delta; these differ by up to half an ulp of max|v|, which
    moves tz by an ulp and bfrac by ulp(max|v|)/delta, so m by that times
    p_j. Up to A = 51 that term stays under 5.1e-06 and ATOL holds; at
    A = 101 on [-300, 0] the JAX package's own XLA and Pallas projections
    differ by 1.02e-05 (seed 0, B = 200), so wider supports add it."""
    if A <= 51:
        return ATOL
    delta = (v_max - v_min) / (A - 1)
    return ATOL + float(np.spacing(np.float32(max(abs(v_min), abs(v_max))))) / delta


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("v_min,v_max", SUPPORTS)
@pytest.mark.parametrize(
    "B,A",
    # the A = 51 cases keep their ids; A = 2 and 101 put fewer atoms than a
    # warp and several atoms a lane in the CUDA kernel's warp-per-row body
    [pytest.param(B, 51, id=str(B)) for B in (7, 200)]
    + [pytest.param(B, A, id=f"{B}-A{A}") for A in (2, 101) for B in (7, 200)],
)
def test_projection_matches_xla_and_pallas(B, A, v_min, v_max):
    q, p, r, d, _, _ = _inputs(B, A, v_min, v_max)
    jsup = jcat.make_support(v_min, v_max, A)
    tsup = tcat.make_support(v_min, v_max, A)
    want_xla = np.asarray(jcat.categorical_projection(jsup, *_j(p, r, d)))
    want_pallas = np.asarray(categorical_projection_pallas(jsup, *_j(p, r, d), True))
    onehot = tcat.categorical_projection(tsup, *_t(p, r, d)).numpy()
    hat = cp.project(tsup, *_t(p, r, d)).numpy()
    np.testing.assert_allclose(onehot, want_xla, atol=_xla_atol(A, v_min, v_max), rtol=0)
    np.testing.assert_allclose(hat, want_pallas, atol=ATOL, rtol=0)
    np.testing.assert_allclose(hat, want_xla, atol=_xla_atol(A, v_min, v_max), rtol=0)
    # terminal rows put all mass on clip(r); mass is conserved everywhere
    np.testing.assert_allclose(hat.sum(-1), 1.0, atol=ATOL)


@pytest.mark.parametrize("v_min,v_max", SUPPORTS)
def test_projection_matches_xla_at_1024_atoms(v_min, v_max):
    """The widest support the CUDA kernels take (32 atoms a lane), against
    the XLA projection only: the Pallas interpreter unrolls one pass per
    source atom. Rows 0 and 5 are terminal, rows 1 and 6 clip at v_min and
    row 2 at v_max."""
    A = 1024
    _, p, r, d, _, _ = _inputs(7, A, v_min, v_max)
    jsup = jcat.make_support(v_min, v_max, A)
    tsup = tcat.make_support(v_min, v_max, A)
    want_xla = np.asarray(jcat.categorical_projection(jsup, *_j(p, r, d)))
    hat = cp.project(tsup, *_t(p, r, d)).numpy()
    np.testing.assert_allclose(hat, want_xla, atol=_xla_atol(A, v_min, v_max), rtol=0)
    # Mass is conserved as the reference conserves it. A source clipped at
    # v_max may round its bfrac one ulp of A - 1 past the last atom, and
    # the part past it leaves the support in both (one_hot of A is zero):
    # 2.37e-05 of row 2 on [-300, 0].
    np.testing.assert_allclose(hat.sum(-1), want_xla.sum(-1), atol=ATOL, rtol=0)
    np.testing.assert_allclose(hat.sum(-1), 1.0, atol=ATOL + float(np.spacing(np.float32(A - 1))))


@pytest.mark.parametrize("v_min,v_max", SUPPORTS)
@pytest.mark.parametrize("B", [7, 200])
def test_fused_loss_forward_matches_pallas(B, v_min, v_max):
    q, p, r, d, _, _ = _inputs(B, 51, v_min, v_max, seed=1)
    jsup = jcat.make_support(v_min, v_max, 51)
    tsup = tcat.make_support(v_min, v_max, 51)
    ce_j, ov_j = j_fused_loss(jsup, *_j(q, p, r, d), interpret=True)
    ce_t, ov_t = cp.fused_categorical_loss(tsup, *_t(q, p, r, d))
    # ce reaches ~10 here, so a relative term of 1e-6 joins the atol
    np.testing.assert_allclose(ce_t.detach().numpy(), np.asarray(ce_j), atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(ov_t.detach().numpy(), np.asarray(ov_j), atol=ATOL, rtol=1e-6)
    # and against the unfused XLA definition
    m = jcat.categorical_projection(jsup, *_j(p, r, d))
    ce_x = -jnp.sum(m * jax.nn.log_softmax(jnp.asarray(q)), -1)
    np.testing.assert_allclose(ce_t.detach().numpy(), np.asarray(ce_x), atol=ATOL, rtol=1e-6)


@pytest.mark.parametrize("v_min,v_max", SUPPORTS)
@pytest.mark.parametrize(
    "B,A",
    # the A = 51 cases keep their ids; A = 2 and 101 put fewer atoms than a
    # warp and several atoms a lane in the CUDA kernel's warp-per-row body
    [pytest.param(B, 51, id=str(B)) for B in (7, 200)]
    + [pytest.param(B, A, id=f"{B}-A{A}") for A in (2, 101) for B in (7, 200)],
)
def test_fused_loss_gradient_matches_pallas_vjp(B, A, v_min, v_max):
    """dq for nonzero cotangents on BOTH outputs (ce and overlap)."""
    q, p, r, d, g_ce, g_ov = _inputs(B, A, v_min, v_max, seed=2)
    jsup = jcat.make_support(v_min, v_max, A)
    tsup = tcat.make_support(v_min, v_max, A)
    jp, jr, jd = _j(p, r, d)
    _, vjp = jax.vjp(lambda x: j_fused_loss(jsup, x, jp, jr, jd, interpret=True), jnp.asarray(q))
    (dq_j,) = vjp((jnp.asarray(g_ce), jnp.asarray(g_ov)))
    qt = torch.from_numpy(q).requires_grad_(True)
    ce, ov = cp.fused_categorical_loss(tsup, qt, *_t(p, r, d))
    dq_t, = torch.autograd.grad((ce, ov), qt, _t(g_ce, g_ov))
    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j), atol=ATOL, rtol=0)
    # the wrapper's backward is fused_loss_bwd: same numbers when called directly
    dq_w = cp.fused_loss_bwd(tsup, *_t(q, p, r, d, g_ce, g_ov))
    np.testing.assert_allclose(dq_w.numpy(), dq_t.numpy(), atol=1e-6, rtol=0)


def test_fused_loss_gradient_of_weighted_mean_matches_jax_grad():
    """jax.grad of mean(w·ce) + 0.3·mean(ov), the shape the train step uses."""
    q, p, r, d, g_ce, _ = _inputs(33, 51, -300.0, 0.0, seed=3)
    jsup = jcat.make_support(-300.0, 0.0, 51)
    tsup = tcat.make_support(-300.0, 0.0, 51)
    jp, jr, jd, jw = _j(p, r, d, g_ce)

    def jloss(x):
        ce, ov = j_fused_loss(jsup, x, jp, jr, jd, interpret=True)
        return jnp.mean(jw * ce) + 0.3 * jnp.mean(ov)

    want = jax.grad(jloss)(jnp.asarray(q))
    qt = torch.from_numpy(q).requires_grad_(True)
    ce, ov = cp.fused_categorical_loss(tsup, qt, *_t(p, r, d))
    (torch.from_numpy(g_ce) * ce).mean().add(0.3 * ov.mean()).backward()
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want), atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("v_min,v_max", SUPPORTS)
def test_expected_value_and_td_loss_match(v_min, v_max):
    q, p, r, d, g_ce, _ = _inputs(9, 51, v_min, v_max, seed=4)
    jsup = jcat.make_support(v_min, v_max, 51)
    tsup = tcat.make_support(v_min, v_max, 51)
    np.testing.assert_allclose(
        tcat.expected_value(tsup, torch.from_numpy(p)).numpy(),
        np.asarray(jcat.expected_value(jsup, jnp.asarray(p))),
        rtol=1e-6, atol=1e-4,  # E[Z] reaches ~300 on the Pendulum support
    )
    for w in (None, g_ce):
        lt, pt = tcat.categorical_td_loss(
            torch.from_numpy(q), torch.from_numpy(p), None if w is None else torch.from_numpy(w)
        )
        lj, pj = jcat.categorical_td_loss(
            jnp.asarray(q), jnp.asarray(p), None if w is None else jnp.asarray(w)
        )
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=ATOL, rtol=1e-6)


def test_make_support_validates_like_the_reference():
    for args in [(0.0, 1.0, 1), (1.0, 1.0, 51), (2.0, 1.0, 51)]:
        with pytest.raises(ValueError):
            jcat.make_support(*args)
        with pytest.raises(ValueError):
            tcat.make_support(*args)
    assert tcat.make_support(-300, 0, 51).delta == jcat.make_support(-300, 0, 51).delta


@pytest.mark.parametrize(
    "bad",
    ["dtype", "shape", "atoms", "contiguous", "rank", "device_mix"],
)
def test_wrappers_refuse_what_the_kernel_does_not_take(bad):
    q, p, r, d, _, _ = _t(*_inputs(8, 51, -10.0, 10.0))
    sup = tcat.make_support(-10.0, 10.0, 51)
    if bad == "dtype":
        p = p.double()
    elif bad == "shape":
        r = r[:4]
    elif bad == "atoms":
        sup = tcat.make_support(-10.0, 10.0, 41)
    elif bad == "contiguous":
        p = torch.cat([p, p], dim=1)[:, ::2]
    elif bad == "rank":
        p = p[None]
    elif bad == "device_mix":
        r = r.to("meta")
    with pytest.raises((TypeError, ValueError)):
        cp.project(sup, p, r, d)


def test_wrappers_count_no_launch_on_the_cpu():
    cp.reset_launch_counts()
    q, p, r, d, g_ce, g_ov = _t(*_inputs(8, 51, -10.0, 10.0))
    sup = tcat.make_support(-10.0, 10.0, 51)
    cp.project(sup, p, r, d)
    cp.fused_loss_fwd(sup, q, p, r, d)
    cp.fused_loss_bwd(sup, q, p, r, d, g_ce, g_ov)
    assert cp.LAUNCHES == {"project": 0, "fused_fwd": 0, "fused_bwd": 0}


def test_nstep_returns_match_reference():
    rng = np.random.default_rng(5)
    T = 17
    rew = rng.normal(size=T).astype(np.float32)
    done = (rng.uniform(size=T) < 0.15).astype(np.float32)
    trunc = (rng.uniform(size=T) < 0.1).astype(np.float32)
    for n in (1, 3, 5):
        want = jnstep.nstep_returns(jnp.asarray(rew), jnp.asarray(done), 0.99, n, jnp.asarray(trunc))
        got = nstep_returns(torch.from_numpy(rew), torch.from_numpy(done), 0.99, n, torch.from_numpy(trunc))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_polyak_update_matches_reference():
    rng = np.random.default_rng(6)
    online = torch.nn.Linear(4, 3)
    target = torch.nn.Linear(4, 3)
    with torch.no_grad():
        for mod in (online, target):
            for prm in mod.parameters():
                prm.copy_(torch.from_numpy(rng.normal(size=prm.shape).astype(np.float32)))
    jt = {n: jnp.asarray(p.detach().numpy()) for n, p in target.named_parameters()}
    jo = {n: jnp.asarray(p.detach().numpy()) for n, p in online.named_parameters()}
    want = jpolyak.polyak_update(jt, jo, 0.05)
    polyak_update(target, online, 0.05)
    for n, prm in target.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), np.asarray(want[n]), atol=1e-7)


def _inject_normals(monkeypatch, draws):
    """Both packages draw their noise internally (a JAX key, a torch
    generator); feed both the same normal draws instead."""
    jq, tq = list(draws), list(draws)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: jnp.asarray(jq.pop(0)).reshape(shape))
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: torch.from_numpy(tq.pop(0)).reshape(shape))


def test_gaussian_noise_matches_reference_on_injected_draws(monkeypatch):
    from d4pg_tpu.ops import noise as jn
    from d4pg_tpu_torch.ops import noise as tn

    draws = [np.random.default_rng(8).normal(size=(4, 2)).astype(np.float32)]
    _inject_normals(monkeypatch, draws)
    want = jn.gaussian_noise_sample(jn.gaussian_noise_init(0.3), jax.random.PRNGKey(0), (4, 2), mu=0.1, sigma=0.5)
    got = tn.gaussian_noise_sample(tn.gaussian_noise_init(0.3), torch.Generator(), (4, 2), mu=0.1, sigma=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
    js = jn.gaussian_noise_reset(jn.gaussian_noise_init(0.3), decay=0.1, epsilon_min=0.05)
    ts = tn.gaussian_noise_reset(tn.gaussian_noise_init(0.3), decay=0.1, epsilon_min=0.05)
    np.testing.assert_allclose(float(ts.epsilon), float(js.epsilon), rtol=1e-7)


def test_ou_noise_chain_matches_reference_on_injected_draws(monkeypatch):
    from d4pg_tpu.ops import noise as jn
    from d4pg_tpu_torch.ops import noise as tn

    rng = np.random.default_rng(9)
    draws = [rng.normal(size=(3,)).astype(np.float32) for _ in range(6)]
    _inject_normals(monkeypatch, draws)
    js, ts = jn.ou_noise_init(3, epsilon=0.7, x0=0.2), tn.ou_noise_init(3, epsilon=0.7, x0=0.2)
    for _ in range(6):
        jx, js = jn.ou_noise_sample(js, jax.random.PRNGKey(0), theta=0.3, mu=0.1, sigma=0.4)
        tx, ts = tn.ou_noise_sample(ts, torch.Generator(), theta=0.3, mu=0.1, sigma=0.4)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    js, ts = jn.ou_noise_reset(js, decay=0.5), tn.ou_noise_reset(ts, decay=0.5)
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), atol=0)
    np.testing.assert_allclose(float(ts.epsilon), float(js.epsilon), rtol=1e-7)


def test_exploration_mixture_replaces_whole_action_vectors():
    from d4pg_tpu_torch.agent import D4PGConfig, exploration_mixture

    a = torch.zeros(4000, 3)
    out = exploration_mixture(D4PGConfig(random_eps=0.25), torch.Generator().manual_seed(0), a)
    replaced = (out != 0).any(-1)
    assert 0.22 < replaced.float().mean() < 0.28
    assert out.abs().max() <= 1.0
    assert torch.equal(exploration_mixture(D4PGConfig(), torch.Generator(), a), a)


def test_build_hash_covers_included_headers(tmp_path):
    """A library's name hashes its source AND every csrc header it
    includes, so an edited shared header rebuilds every kernel that uses
    it and no other."""
    import shutil

    from d4pg_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    names = ("projection", "per_tree", "fused_step")
    before = {n: _build._target(n, csrc)[1].name for n in names}
    assert before == {n: _build._target(n)[1].name for n in names}
    (csrc / "per_tree.cuh").write_text((csrc / "per_tree.cuh").read_text() + "\n// edit\n")
    after = {n: _build._target(n, csrc)[1].name for n in names}
    assert after["projection"] == before["projection"]
    assert after["per_tree"] != before["per_tree"]
    assert after["fused_step"] != before["fused_step"]
    (csrc / "c51_rows.cuh").write_text((csrc / "c51_rows.cuh").read_text() + "\n// edit\n")
    assert _build._target("projection", csrc)[1].name != before["projection"]
    assert _build._target("fused_step", csrc)[1].name != after["fused_step"]
