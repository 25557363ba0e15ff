"""The sim-attached serve client: env episodes THROUGH the serve path (the
port's copy of ``d4pg_tpu/flywheel/sim_client.py``).

``python -m d4pg_tpu_torch.flywheel.sim_client --connect HOST:PORT --env NAME``

The policy lives behind the wire, the world in front of it:

- the observation comes from the env, the ACTION from the policy server;
- the client adds Gaussian exploration noise σ to the served action,
  executes it, and echoes the reward and episode bits back on a
  ``FEEDBACK`` frame with the EXECUTED action and its log-prob under
  ``N(served_action, σ²)``: the propensity the promotion gate weights by
  (``gate.gaussian_log_prob``, the formula the gate evaluates the
  candidate with);
- with ``--noise-sigma 0 --no-feedback`` it is a fixed-seed EVALUATOR:
  plain v1 ACT traffic, nothing mirrored.

The env comes from ``envs/gym_adapter.make_host_env`` (a gymnasium id,
``dmc:…`` or ``pixel_pendulum_host``, which needs no gymnasium). Prints
one line an episode, a ``[sim-client] episodes=… mean_return=…`` summary
and ``SIM_CLIENT_OK``. Feedback with ``--noise-sigma 0`` is refused with
exit code 2 (a degenerate propensity cannot be importance-weighted).

numpy, the env and a socket: no torch is imported.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from d4pg_tpu_torch.flywheel.gate import gaussian_log_prob
from d4pg_tpu_torch.serve.client import PolicyClient


def run_episodes(
    client: PolicyClient,
    env,
    *,
    episodes: int,
    seed: int,
    noise_sigma: float,
    send_feedback: bool,
    policy_id=None,
    deadline_ms=None,
    max_steps: int = 1000,
    log=print,
) -> list:
    """→ the episodes' returns. One env, episodes in turn, request then
    feedback a step (the tap's pairing contract)."""
    rng = np.random.default_rng(seed)
    # The server answers in the env's action scale (the bundle's bounds);
    # replay and the gate's numpy policy work in the canonical (−1, 1).
    # Map back here, so the logged action and propensity live in the
    # training space. Envs already canonical (dmc, the pixel host) have no
    # mapper.
    to_canonical = getattr(env, "to_canonical_action", lambda a: a)
    returns = []
    for ep in range(episodes):
        obs = np.asarray(env.reset(seed=seed + 1000 * ep), np.float32)
        ep_return, steps = 0.0, 0
        while True:
            served = np.asarray(
                to_canonical(client.act(obs, deadline_ms, policy_id=policy_id)), np.float32)
            if noise_sigma > 0:
                executed = np.clip(
                    served + rng.normal(0.0, noise_sigma, served.shape), -1.0, 1.0,
                ).astype(np.float32)
                log_prob = float(gaussian_log_prob(executed[None], served[None], noise_sigma)[0])
            else:
                executed, log_prob = served, 0.0
            next_obs, reward, terminated, truncated, _info = env.step(executed)
            next_obs = np.asarray(next_obs, np.float32)
            steps += 1
            ep_return += reward
            if steps >= max_steps:
                truncated = True
            if send_feedback:
                client.feedback(reward, executed, next_obs, log_prob=log_prob,
                                terminated=terminated, truncated=truncated,
                                policy_id=policy_id)
            if terminated or truncated:
                break
            obs = next_obs
        returns.append(ep_return)
        log(f"[sim-client] episode {ep} return={ep_return:.3f} steps={steps}")
    return returns


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m d4pg_tpu_torch.flywheel.sim_client",
        description="Play env episodes through the serve path, echoing "
        "reward/done back as FEEDBACK frames (the flywheel's traffic "
        "source), or, with --noise-sigma 0 --no-feedback, evaluate the "
        "served policy with fixed seeds over plain v1 ACT traffic.",
    )
    p.add_argument("--connect", required=True, metavar="HOST:PORT",
                   help="policy server or router address")
    p.add_argument("--env", default="Pendulum-v1")
    p.add_argument("--episodes", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-sigma", type=float, default=0.3,
                   help="Gaussian exploration noise added to served "
                   "actions; the behavior propensity is logged under "
                   "this σ (0 = execute the served action verbatim)")
    p.add_argument("--no-feedback", action="store_true",
                   help="pure v1 ACT traffic: no reward echo, nothing "
                   "mirrored (the evaluator mode)")
    p.add_argument("--policy", default=None,
                   help="policy id (v2 ACT2 routing; default: v1 ACT)")
    p.add_argument("--deadline-ms", type=float, default=None)
    p.add_argument("--max-steps", type=int, default=1000,
                   help="per-episode step cap (over the env's own truncation)")
    p.add_argument("--retries", type=int, default=8,
                   help="bounded act() retry budget on shed/reset")
    p.add_argument("--timeout", type=float, default=30.0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    send_feedback = not args.no_feedback
    if send_feedback and args.noise_sigma <= 0:
        print(
            "[sim-client] FATAL: feedback needs --noise-sigma > 0 (a "
            "degenerate propensity cannot be importance-weighted); use "
            "--no-feedback for deterministic evaluation",
            file=sys.stderr,
        )
        return 2
    host, port = args.connect.rsplit(":", 1)
    from d4pg_tpu_torch.envs.gym_adapter import make_host_env

    env = make_host_env(args.env)
    client = PolicyClient(host, int(port), timeout=args.timeout, retries=args.retries,
                          retry_seed=args.seed, policy_id=args.policy)
    try:
        returns = run_episodes(
            client,
            env,
            episodes=args.episodes,
            seed=args.seed,
            noise_sigma=args.noise_sigma,
            send_feedback=send_feedback,
            policy_id=args.policy,
            deadline_ms=args.deadline_ms,
            max_steps=args.max_steps,
        )
    finally:
        client.close()
        env.close()
    mean = float(np.mean(returns)) if returns else 0.0
    print(f"[sim-client] episodes={len(returns)} mean_return={mean:.4f} "
          f"sigma={args.noise_sigma:g} feedback={int(send_feedback)}")
    print("SIM_CLIENT_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
