"""Training CLI of the port: ``python -m d4pg_tpu_torch.train``.

The flags are the subset of ``train.py:build_parser`` that this slice
honours, under the same names, plus ``--device {cuda,cpu}`` (default
cuda: with no card and no ``--device cpu`` the run raises). A flag of the
JAX CLI whose feature is not ported yet raises ``NotImplementedError``
naming the ROADMAP item (:data:`UNPORTED_FLAGS`); any other unknown flag
is refused by argparse.

SIGTERM/SIGINT trigger a graceful preemption: the current dispatch
finishes, a full checkpoint (and the replay snapshot with
``--snapshot-replay``) lands, and the process exits 75, the "restart me
with --resume" contract of the JAX CLI. A second signal hard-kills.

Examples:
    python -m d4pg_tpu_torch.train --env pendulum --total-steps 50000
    python -m d4pg_tpu_torch.train --env pendulum --replay-placement device \
        --p-replay --steps-per-dispatch 8 --fused-descent
    python -m d4pg_tpu_torch.train --device cpu --hidden-sizes 32,32 \
        --num-envs 2 --bsize 32 --warmup 128 --total-steps 20
    python -m d4pg_tpu_torch.train --log-dir runs/p1 --checkpoint-interval 5000 \
        --snapshot-replay            # then the same command with --resume
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig
from d4pg_tpu_torch.models.critic import DistConfig

# Flags of the JAX CLI (``train.py:build_parser``) whose feature the port
# does not carry yet, each with the ROADMAP item that brings it.
UNPORTED_FLAGS = {
    "--critic-head": "the scalar and mixture-of-Gaussians critic heads (ROADMAP A10)",
    "--twin-critic": "twin critics (ROADMAP A10)",
    "--critic-ensemble": "critic ensembles (ROADMAP A10)",
    "--compute-dtype": "bfloat16 compute (ROADMAP A3)",
    "--her": "hindsight relabeling (ROADMAP A10)",
    "--obs-norm": "observation normalization (ROADMAP A10)",
    "--async-collect": "asynchronous collection (ROADMAP A5)",
    "--prefetch": "the prefetch double buffer (ROADMAP A5)",
    "--ingest-prefetch": "the double-buffered device ring ingest (ROADMAP A6)",
    "--dp": "data parallelism (ROADMAP A7)",
    "--fleet-listen": "the collection fleet (ROADMAP A11)",
    "--async-writeback": "the asynchronous priority write-back (ROADMAP A5 (c))",
    "--publish-interval": "asynchronous collection (ROADMAP A5 (c))",
    "--concurrent-eval": "the concurrent evaluator thread (ROADMAP A5 (c))",
    "--no-concurrent-eval": "the concurrent evaluator thread (ROADMAP A5 (c))",
    "--tree-backend": "the native sum tree (ROADMAP A5 (b))",
    "--pool-start-method": "the host actor pool (ROADMAP A5 (d))",
    "--pool-step-timeout": "the host actor pool (ROADMAP A5 (d))",
    "--actor-device": "the host actor pool (ROADMAP A5 (d))",
    "--device-tree-backend": "a choice of device PER descent: the port has one, "
                             "kernel B3, and takes no --device-tree-backend (ROADMAP A6)",
    "--ring-dtype": "the bfloat16 device ring (ROADMAP A3)",
    "--transfer-dtype": "the bfloat16 and uint8 batch wire formats (ROADMAP A3)",
    "--on-device": "the on-device rollout learner (ROADMAP A9)",
    "--action-repeat": "the on-device rollout learner (ROADMAP A9)",
    "--tp": "tensor parallelism (ROADMAP A7)",
    "--dp-hogwild": "asynchronous data parallelism (ROADMAP A7)",
    "--distributed": "multi-host training (ROADMAP A7)",
    "--coordinator": "multi-host training (ROADMAP A7)",
    "--num-processes": "multi-host training (ROADMAP A7)",
    "--process-id": "multi-host training (ROADMAP A7)",
    "--export-bundle": "serving bundles (ROADMAP A8)",
    "--her-k": "hindsight relabeling (ROADMAP A10)",
    "--num-mixtures": "the mixture-of-Gaussians critic head (ROADMAP A10)",
    "--ensemble-min-targets": "critic ensembles (ROADMAP A10)",
    "--batch-scale": "the --batch-scale recipe (ROADMAP A10)",
    "--profile-dir": "profiler traces (ROADMAP A11 (c))",
    "--chaos": "fault injection (ROADMAP A11 (e))",
    "--fleet-host": "the collection fleet (ROADMAP A11 (e))",
    "--fleet-bundle": "the collection fleet (ROADMAP A11 (e))",
    "--fleet-publish-interval": "the collection fleet (ROADMAP A11 (e))",
    "--fleet-max-gen-lag": "the collection fleet (ROADMAP A11 (e))",
    "--fleet-wire-dtype": "the collection fleet (ROADMAP A11 (e))",
    "--variant-id": "league training (ROADMAP A11 (e))",
    "--league-generation": "league training (ROADMAP A11 (e))",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="D4PG on PyTorch/CUDA")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default) runs the CUDA kernels; cpu runs their "
                        "plain PyTorch versions")
    p.add_argument("--env", default="pendulum", help="pendulum")
    p.add_argument("--rmsize", "--replay-capacity", dest="replay_capacity",
                   type=int, default=None, help="replay capacity (default 1M)")
    p.add_argument("--tau", type=float, default=0.001)
    p.add_argument("--bsize", "--batch-size", dest="batch_size", type=int, default=256)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--max-steps", dest="max_episode_steps", type=int, default=None)
    p.add_argument("--warmup", dest="warmup_steps", type=int, default=1_000)
    p.add_argument("--p-replay", "--prioritized", dest="prioritized",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--v-min", type=float, default=None)
    p.add_argument("--v-max", type=float, default=None)
    p.add_argument("--n-atoms", type=int, default=51)
    p.add_argument("--n-step", "--n-steps", dest="n_step", type=int, default=3)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--ou-theta", type=float, default=0.15)
    p.add_argument("--ou-sigma", type=float, default=0.2)
    p.add_argument("--ou-mu", type=float, default=0.0)
    p.add_argument("--noise", choices=["gaussian", "ou"], default="gaussian")
    p.add_argument("--noise-epsilon", type=float, default=0.3)
    p.add_argument("--noise-decay-steps", type=int, default=0)
    p.add_argument("--noise-scale-final", type=float, default=0.1)
    p.add_argument("--random-eps", type=float, default=0.0)
    p.add_argument("--action-l2", type=float, default=0.0)
    p.add_argument("--num-envs", type=int, default=16,
                   help="batched exploration envs on the device")
    p.add_argument("--hidden-sizes", default=None,
                   help="comma-separated MLP trunk widths (default 256,256,256)")
    p.add_argument("--projection", choices=["fused", "projection"], default="fused",
                   help="fused = one kernel for projection + CE, forward and "
                        "backward; projection = the projection kernel, then "
                        "the CE in torch")
    p.add_argument("--total-steps", type=int, default=100_000,
                   help="learner grad steps")
    p.add_argument("--replay-placement", choices=["host", "device", "hybrid"],
                   default="host",
                   help="host = host replay, one batch copy per grad step; "
                        "device = device ring (+ device PER tree) and one "
                        "megastep of K grad steps per dispatch; hybrid is "
                        "not ported yet (ROADMAP A6)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K grad steps per megastep dispatch (device placement)")
    p.add_argument("--fused-descent", action="store_true",
                   help="fuse each step's loss with the next step's descent "
                        "(CUDA kernel B4); needs --replay-placement device, "
                        "--p-replay and --projection fused")
    p.add_argument("--debug-guards", action="store_true",
                   help="run every megastep dispatch after the first under "
                        "torch.cuda.set_sync_debug_mode('error')")
    p.add_argument("--env-steps-per-train-step", type=float, default=1.0)
    p.add_argument("--eval-interval", type=int, default=2_000)
    p.add_argument("--eval-episodes", type=int, default=10)
    p.add_argument("--checkpoint-interval", type=int, default=10_000)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--snapshot-replay", action="store_true",
                   help="save/restore the replay buffer with checkpoints so "
                        "--resume keeps its experience")
    p.add_argument("--max-rss-gb", type=float, default=0.0,
                   help="RSS watchdog: past this limit the trainer "
                        "checkpoints and exits 75 so a supervisor can "
                        "--resume (0 = off)")
    p.add_argument("--lr-actor", type=float, default=1e-4)
    p.add_argument("--lr-critic", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    return p


def refuse_unported(argv) -> None:
    """Raise ``NotImplementedError`` for a flag of :data:`UNPORTED_FLAGS`."""
    for arg in argv:
        what = UNPORTED_FLAGS.get(arg.split("=", 1)[0])
        if what is not None:
            raise NotImplementedError(f"{arg}: {what} is not ported to d4pg_tpu_torch yet")


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    defaults = DistConfig()
    dist = DistConfig(
        num_atoms=args.n_atoms,
        v_min=defaults.v_min if args.v_min is None else args.v_min,
        v_max=defaults.v_max if args.v_max is None else args.v_max,
    )
    agent = D4PGConfig(
        dist=dist,
        gamma=args.gamma,
        n_step=args.n_step,
        tau=args.tau,
        lr_actor=args.lr_actor,
        lr_critic=args.lr_critic,
        noise_kind=args.noise,
        noise_epsilon=args.noise_epsilon,
        noise_decay_steps=args.noise_decay_steps,
        noise_scale_final=args.noise_scale_final,
        random_eps=args.random_eps,
        action_l2=args.action_l2,
        ou_theta=args.ou_theta,
        ou_sigma=args.ou_sigma,
        ou_mu=args.ou_mu,
        projection_backend=args.projection,
    )
    if args.hidden_sizes:
        agent = dataclasses.replace(
            agent,
            hidden_sizes=tuple(int(h) for h in args.hidden_sizes.split(",") if h.strip()),
        )
    log_dir = args.log_dir or (
        f"runs/torch_{args.env}_{'PER' if args.prioritized else 'UNI'}"
        f"_n{args.n_step}_{args.num_envs}env"
    )
    return TrainConfig(
        env=args.env,
        max_episode_steps=args.max_episode_steps,
        num_envs=args.num_envs,
        total_steps=args.total_steps,
        warmup_steps=args.warmup_steps,
        env_steps_per_train_step=args.env_steps_per_train_step,
        batch_size=args.batch_size,
        replay_capacity=args.replay_capacity,
        prioritized=args.prioritized,
        n_step=args.n_step,
        eval_interval=args.eval_interval,
        eval_episodes=args.eval_episodes,
        log_dir=log_dir,
        agent=agent,
        seed=args.seed,
        replay_placement=args.replay_placement,
        steps_per_dispatch=args.steps_per_dispatch,
        fused_descent=args.fused_descent,
        debug_guards=args.debug_guards,
        checkpoint_interval=args.checkpoint_interval,
        resume=args.resume,
        snapshot_replay=args.snapshot_replay,
        max_rss_gb=args.max_rss_gb,
    )


def install_preemption_handlers(stop_callback) -> None:
    """SIGTERM/SIGINT → graceful preemption via ``stop_callback`` (which
    must be signal-safe: it only sets an event). The first signal arms the
    checkpoint-and-exit-75 path, a second hard-kills."""
    from d4pg_tpu_torch.utils.signals import install_graceful_signals

    install_graceful_signals(
        stop_callback,
        "[signal] {sig}: checkpointing and exiting 75 "
        "(--resume restarts; second signal hard-kills)",
    )


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_unported(argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    from d4pg_tpu_torch.runtime.trainer import Trainer

    trainer = Trainer(cfg, device=args.device)
    print(f"config: {trainer.config}", flush=True)
    install_preemption_handlers(trainer.request_preemption)
    try:
        final = trainer.train()
    finally:
        trainer.close()
    print(f"done: {final}", flush=True)
    if trainer.preempted:
        # EX_TEMPFAIL: "checkpointed, restart me with --resume"; a
        # supervisor tells preemption (75) from completion (0) by it
        sys.exit(75)
    return final


if __name__ == "__main__":
    main()
