"""Exploration collection on the device (counterpart of
``d4pg_tpu/runtime/collect.py``).

One call rolls every env one segment under the noisy actor (auto-reset,
noise state threaded through) and collapses the segment into n-step
transitions, all as tensor ops on the env's device. The host trainer then
copies the flat block to the host and inserts it into replay in one call.

Windows never span segment boundaries: the last up-to-(n−1) steps of a
segment bootstrap early with the exact ``γ^m`` of their shortened window,
a valid m-step Bellman target, the same convention as episode truncation
(:func:`d4pg_tpu_torch.ops.nstep_returns` with ``truncations``).
"""

from __future__ import annotations

import torch

from d4pg_tpu_torch.agent.d4pg import make_noise, noisy_explore
from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.envs.rollouts import Trajectory, rollout
from d4pg_tpu_torch.ops.nstep import nstep_returns


def collapse_nstep(traj: Trajectory, gamma: float, n: int) -> dict[str, torch.Tensor]:
    """n-step-collapse an [N, T] segment into N·T flat transitions:
    obs, action, reward = R^(m), next_obs = s_{t+m}, discount =
    γ^m·(1−terminal)."""
    N, T = traj.reward.shape
    rets, boots, offs = nstep_returns(
        traj.reward, traj.terminated, gamma, n, truncations=traj.truncated
    )
    # the bootstrap state s_{t+m} is next_obs[t + m - 1]
    idx = (torch.arange(T, device=offs.device) + offs - 1).clamp(0, T - 1).long()
    next_obs = torch.gather(
        traj.next_obs, 1, idx[..., None].expand(-1, -1, traj.next_obs.shape[-1])
    )
    flat = {
        "obs": traj.obs,
        "action": traj.action,
        "reward": rets,
        "next_obs": next_obs,
        "discount": boots,
    }
    return {k: v.reshape((N * T,) + v.shape[2:]) for k, v in flat.items()}


def make_segment_collector(
    config: D4PGConfig, env, num_envs: int, segment_len: int, noise_fns=None
):
    """Build ``collect(actor, env_states, obs, noise_states, generator,
    noise_scale) -> (env_states, obs, noise_states, flat, traj)`` where
    ``flat`` is :func:`collapse_nstep` of the segment and ``traj`` the raw
    [N, T] segment."""
    _, noise_sample, noise_reset = noise_fns or make_noise(config, (num_envs,))

    @torch.no_grad()
    def collect(actor, env_states, obs, noise_states, generator, noise_scale):
        def policy(o, gen, nstate):
            return noisy_explore(config, noise_sample, actor(o), gen, nstate, noise_scale)

        env_states, obs, noise_states, traj = rollout(
            env, policy, generator, segment_len,
            init_state=env_states, init_obs=obs,
            policy_state=noise_states, policy_state_reset=noise_reset,
        )
        flat = collapse_nstep(traj, config.gamma, config.n_step)
        return env_states, obs, noise_states, flat, traj

    return collect
