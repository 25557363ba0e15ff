"""The port's host env adapters against the JAX package's, on the CPU.

- ``GymAdapter`` / ``make_host_env`` on ``Pendulum-v1``, ``HalfCheetah-v4``,
  the goal-dict ``ToyGoal-v0`` (``tests/toy_goal_env.py``: flattening,
  goal views, success terminating the episode) and ``dmc:cartpole:swingup``
  in state mode (also at action repeat 2): the same seeds and the same
  seeded actions give ``array_equal`` observations, rewards and flags, and
  equal dims, limits, supports and goal views;
- ``make_env`` falls through to the host adapters for any name it does not
  know, as the JAX ``make_env`` does, with the JAX refusal of
  ``--action-repeat`` outside dm_control;
- ``NormalizeAction``, ``ENV_VALUE_RANGES`` and ``DMC_VALUE_RANGE`` equal the
  JAX package's;
- ``apply_env_preset(config, env)`` gives what the JAX trainer's
  ``_reconcile_config`` gives for every gym id of the JAX presets, a
  ``dmc:`` id and the goal env: dims, support, episode limit, capacity.
"""

import numpy as np
import pytest

from d4pg_tpu.config import TrainConfig as JTrainConfig
from d4pg_tpu.envs import dmc_adapter as jdmc
from d4pg_tpu.envs import gym_adapter as jgym
from d4pg_tpu.runtime.trainer import _reconcile_config
from d4pg_tpu_torch.config import TrainConfig, apply_env_preset
from d4pg_tpu_torch.envs import dmc_adapter, gym_adapter, make_env

gym = pytest.importorskip("gymnasium")

GOAL_ENV = "toy_goal_env:ToyGoal-v0"
STEPS = 40


def _drive(env, actions, seed):
    """Reset at ``seed``, step ``actions`` (resetting at each episode end):
    every observation, reward, flag and goal view."""
    out = {"obs": [env.reset(seed=seed)], "reward": [], "terminated": [], "truncated": [],
           "goals": []}
    for a in actions:
        obs, r, term, trunc, _ = env.step(a)
        out["reward"].append(r)
        out["terminated"].append(term)
        out["truncated"].append(trunc)
        g = getattr(env, "last_goal_obs", None)
        if g is not None:
            out["goals"].append(np.concatenate([np.ravel(g[k]) for k in sorted(g)]))
        out["obs"].append(env.reset() if term or trunc else obs)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize(
    "name,limit,repeat",
    [("Pendulum-v1", 15, 1), ("HalfCheetah-v4", 25, 1), (GOAL_ENV, None, 1),
     ("dmc:cartpole:swingup", 12, 1), ("dmc:cartpole:swingup", 12, 2)],
    ids=["pendulum", "halfcheetah", "toy_goal", "dmc_cartpole", "dmc_cartpole_repeat2"],
)
def test_adapters_step_as_the_reference_steps(name, limit, repeat):
    ours = gym_adapter.make_host_env(name, limit, action_repeat=repeat)
    ref = jgym.make_host_env(name, limit, action_repeat=repeat)
    try:
        assert type(ours).__name__ == type(ref).__name__
        for attr in ("observation_dim", "action_dim", "max_episode_steps", "v_min", "v_max",
                     "is_goal_env"):
            assert getattr(ours, attr, None) == getattr(ref, attr, None), attr
        rng = np.random.default_rng(3)
        # a few actions outside the box: both clip them
        actions = rng.uniform(-1.3, 1.3, (STEPS, ours.action_dim)).astype(np.float32)
        a, b = _drive(ours, actions, seed=11), _drive(ref, actions, seed=11)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if name == GOAL_ENV:
            # success terminates a goal episode; the goal views came along
            assert a["goals"].shape == (STEPS, 6)
            assert ours.compute_reward(np.zeros(2), np.zeros(2)) == ref.compute_reward(
                np.zeros(2), np.zeros(2)) == 0.0
        if hasattr(ref, "to_canonical_action"):  # the gymnasium adapter's inverse map
            np.testing.assert_array_equal(ours.to_canonical_action(actions[0]),
                                          ref.to_canonical_action(actions[0]))
    finally:
        ours.close()
        ref.close()


def test_make_env_falls_through_to_the_host_adapters():
    from d4pg_tpu_torch.envs.pixel_pendulum_host import PixelPendulumHost

    env = make_env("Pendulum-v1", 7)
    assert isinstance(env, gym_adapter.GymAdapter) and env.max_episode_steps == 7
    env.close()
    assert isinstance(make_env("pixel_pendulum_host"), PixelPendulumHost)
    assert make_env("pixel_pendulum_host", 30).max_episode_steps == 30
    dmc = make_env("dmc:cartpole:swingup", action_repeat=4)
    assert isinstance(dmc, dmc_adapter.DMControlAdapter) and dmc.max_episode_steps == 250
    dmc.close()
    for name in ("Pendulum-v1", "pendulum"):
        with pytest.raises(ValueError) as ours:
            make_env(name, action_repeat=2)
        with pytest.raises(ValueError) as ref:
            jgym.make_env(name, action_repeat=2)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="bad dm_control env id"):
        make_env("dmc:cartpole")


def test_action_maps_and_value_tables_are_the_references():
    low, high = np.array([-2.0, 0.0, -1.0], np.float32), np.array([2.0, 3.0, 1.0], np.float32)
    ours, ref = gym_adapter.NormalizeAction(low, high), jgym.NormalizeAction(low, high)
    a = np.random.default_rng(0).uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(ours.to_env(a), ref.to_env(a))
    np.testing.assert_array_equal(ours.to_canonical(ours.to_env(a)), ref.to_canonical(ref.to_env(a)))
    assert gym_adapter.ENV_VALUE_RANGES == jgym.ENV_VALUE_RANGES
    assert dmc_adapter.DMC_VALUE_RANGE == jdmc.DMC_VALUE_RANGE


@pytest.mark.parametrize(
    "name,limit",
    [("Pendulum-v1", None), ("HalfCheetah-v4", None), ("HalfCheetah-v5", 300),
     ("Humanoid-v4", None), ("Humanoid-v5", None), ("Hopper-v4", None),
     ("dmc:cartpole:swingup", None), (GOAL_ENV, None)],
)
def test_config_from_the_env_is_the_jax_trainers(name, limit):
    ours_env, ref_env = make_env(name, limit), jgym.make_env(name, limit)
    try:
        ours = apply_env_preset(TrainConfig(env=name, max_episode_steps=limit), ours_env)
        ref = _reconcile_config(JTrainConfig(env=name, max_episode_steps=limit), ref_env)
        for f in ("obs_dim", "action_dim", "pixel_shape", "n_step"):
            assert getattr(ours.agent, f) == getattr(ref.agent, f), f
        assert (ours.agent.dist.v_min, ours.agent.dist.v_max) == (
            ref.agent.dist.v_min, ref.agent.dist.v_max)
        assert ours.max_episode_steps == ref.max_episode_steps
        assert ours.replay_capacity == ref.replay_capacity
    finally:
        ours_env.close()
        ref_env.close()
