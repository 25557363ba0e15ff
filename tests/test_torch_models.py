"""The port's actor and critic against the Flax modules, on the CPU.

Parameters come from one JAX ``create_train_state`` and are carried across
by ``d4pg_tpu_torch.weights``; the same numpy observations and actions go
through both. Tolerance: atol 1e-5 on tanh actions and 1e-4 on logits
(float32 matmuls of the same weights, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d4pg_tpu.agent import D4PGConfig as JConfig
from d4pg_tpu.agent import create_train_state as j_create
from d4pg_tpu.agent.d4pg import build_networks
from d4pg_tpu.models.critic import DistConfig as JDist
from d4pg_tpu_torch.models import Actor, Critic, DistConfig
from d4pg_tpu_torch.weights import from_jax_params


def _flax_state(hidden, atoms=51, obs_dim=3, act_dim=1, seed=0):
    cfg = JConfig(obs_dim=obs_dim, action_dim=act_dim, hidden_sizes=hidden,
                  dist=JDist(num_atoms=atoms, v_min=-300.0, v_max=0.0))
    return cfg, j_create(cfg, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("hidden", [(32,), (32, 48), (32, 32, 32)])
def test_forward_parity_on_carried_params(hidden):
    obs_dim, act_dim = 5, 2
    cfg, st = _flax_state(hidden, obs_dim=obs_dim, act_dim=act_dim)
    j_actor, j_critic = build_networks(cfg)
    actor_sd, critic_sd = from_jax_params(jax.device_get(st.actor_params), jax.device_get(st.critic_params))
    actor = Actor(obs_dim, act_dim, hidden)
    critic = Critic(obs_dim, act_dim, DistConfig(num_atoms=51), hidden)
    actor.load_state_dict(actor_sd)
    critic.load_state_dict(critic_sd)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, obs_dim)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(64, act_dim)).astype(np.float32)
    want_a = np.asarray(j_actor.apply(st.actor_params, jnp.asarray(obs)))
    want_q = np.asarray(j_critic.apply(st.critic_params, jnp.asarray(obs), jnp.asarray(act)))
    with torch.no_grad():
        got_a = actor(torch.from_numpy(obs)).numpy()
        got_q = critic(torch.from_numpy(obs), torch.from_numpy(act)).numpy()
    assert got_a.shape == (64, act_dim) and got_q.shape == (64, 51)
    assert got_q.dtype == np.float32
    np.testing.assert_allclose(got_a, want_a, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_q, want_q, atol=1e-4, rtol=1e-5)
    # a trained-looking critic: scale the head so logits are O(1), not O(1e-4)
    with torch.no_grad():
        critic.out.weight.mul_(1e3)
    scaled = {k: dict(v) for k, v in jax.device_get(st.critic_params)["params"].items()}
    scaled["out"]["kernel"] = scaled["out"]["kernel"] * np.float32(1e3)
    want_q = np.asarray(j_critic.apply({"params": scaled}, jnp.asarray(obs), jnp.asarray(act)))
    with torch.no_grad():
        got_q = critic(torch.from_numpy(obs), torch.from_numpy(act)).numpy()
    np.testing.assert_allclose(got_q, want_q, atol=1e-4, rtol=1e-5)


def test_layer_shapes_match_flax_tree():
    hidden = (32, 48, 16)
    cfg, st = _flax_state(hidden)
    actor = Actor(3, 1, hidden)
    critic = Critic(3, 1, DistConfig(), hidden)
    for module, tree in ((actor, st.actor_params), (critic, st.critic_params)):
        for name, layer in tree["params"].items():
            lin = getattr(module, name)
            assert tuple(lin.weight.shape) == tuple(layer["kernel"].shape)[::-1]
            assert tuple(lin.bias.shape) == tuple(layer["bias"].shape)
        assert len(list(module.children())) == len(tree["params"])


def test_init_ranges():
    gen = torch.Generator().manual_seed(0)
    hidden = (256, 256, 256)
    actor = Actor(3, 1, hidden, generator=gen)
    critic = Critic(3, 1, DistConfig(), hidden, generator=gen)
    for module, final in ((actor, 3e-3), (critic, 3e-4)):
        for i in range(len(hidden)):
            lin = getattr(module, f"hidden_{i}")
            bw, bb = 1 / lin.in_features**0.5, 1 / lin.out_features**0.5
            assert lin.weight.abs().max() <= bw and lin.bias.abs().max() <= bb
            # spread over the whole range, not a constant
            assert lin.weight.max() > 0.9 * bw and lin.weight.min() < -0.9 * bw
        out = module.out
        for t in (out.weight.detach(), out.bias.detach()):
            assert float(t.min()) >= 0.0 and float(t.max()) < final
    # the critic's second layer takes the action after the state-only first
    assert critic.hidden_1.in_features == 256 + 1


def test_init_is_seeded():
    a = Actor(3, 1, (32, 32), generator=torch.Generator().manual_seed(7))
    b = Actor(3, 1, (32, 32), generator=torch.Generator().manual_seed(7))
    c = Actor(3, 1, (32, 32), generator=torch.Generator().manual_seed(8))
    for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.hidden_0.weight, c.hidden_0.weight)


@pytest.mark.parametrize("kind", ["scalar", "mixture_gaussian"])
def test_unported_heads_raise(kind):
    """The scalar and MoG heads are ported (their parity is in
    ``tests/test_torch_heads.py``): each builds at the JAX head width, and
    a head kind neither package has raises."""
    critic = Critic(3, 1, DistConfig(kind=kind), (32,))
    assert critic.out.out_features == {"scalar": 1, "mixture_gaussian": 15}[kind]
    with pytest.raises(ValueError, match="unknown critic head kind: quantile"):
        Critic(3, 1, DistConfig(kind="quantile"), (32,))
