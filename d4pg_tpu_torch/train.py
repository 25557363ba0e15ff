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
    python -m d4pg_tpu_torch.train --env pendulum --steps-per-dispatch 8 \
        --tree-backend native     # host replay, one [8, B] block a dispatch
    python -m d4pg_tpu_torch.train --env pendulum --replay-placement device \
        --p-replay --steps-per-dispatch 8 --fused-descent
    python -m d4pg_tpu_torch.train --env pendulum --replay-placement hybrid \
        --p-replay --steps-per-dispatch 8   # host tree, device ring
    python -m d4pg_tpu_torch.train --env pendulum --steps-per-dispatch 8 \
        --prefetch --async-writeback --profile-dir runs/trace
    python -m d4pg_tpu_torch.train --device cpu --hidden-sizes 32,32 \
        --num-envs 2 --bsize 32 --warmup 128 --total-steps 20
    python -m d4pg_tpu_torch.train --log-dir runs/p1 --checkpoint-interval 5000 \
        --snapshot-replay            # then the same command with --resume
    python -m d4pg_tpu_torch.train --env halfcheetah --on-device --num-envs 128 \
        --n-step 5 --v-min -100 --v-max 1500 --rmsize 1048576
        # rollout, device ring, device PER and learner all on the card
    python -m d4pg_tpu_torch.train --env pendulum --replay-placement device \
        --p-replay --steps-per-dispatch 32 --fused-descent --batch-scale 8 \
        --compute-dtype bfloat16 --critic-ensemble 10 --ensemble-min-targets 2
        # the large-batch recipe (B = 2048, K = 4) with a REDQ ensemble
    python -m d4pg_tpu_torch.train --env hopper --on-device --num-envs 64 \
        --n-step 3 --twin-critic     # twin critics, the preset's [0, 500]
    python -m d4pg_tpu_torch.train --env humanoid --on-device --num-envs 64 \
        --rmsize 524288 --n-step 3 --v-min 0 --v-max 1500 \
        --noise-decay-steps 2000000 --noise-scale-final 0.1
        # Humanoid on the 3D spatial engine, fully on the card
    python -m d4pg_tpu_torch.train --env pendulum --critic-head mixture_gaussian \
        --num-mixtures 5 --replay-placement device --p-replay --steps-per-dispatch 8
    python -m d4pg_tpu_torch.train --env pointmass_goal --her --n-step 1
        # hindsight relabeling, one single-env episode at a time
    python -m d4pg_tpu_torch.train --env pixel_pendulum --on-device --num-envs 64 \
        --noise-decay-steps 100000 --noise-scale-final 0.15
        # 48x48x2 frames through the conv encoder with the DrQ shift, a
        # uint8 ring; on the host placement add --transfer-dtype uint8
    python -m d4pg_tpu_torch.train --env pendulum --log-dir runs/p1 \
        --export-bundle runs/p1/bundle   # package for d4pg_tpu_torch.serve

``--on-device`` runs :func:`d4pg_tpu_torch.runtime.on_device.run_on_device`
(the JAX CLI's ``--on-device``) after the same validation plus its own
refusals (``config.check_on_device``).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from d4pg_tpu_torch.agent.state import D4PGConfig
from d4pg_tpu_torch.config import TrainConfig, cli_support
from d4pg_tpu_torch.models.critic import DistConfig

# Flags of the JAX CLI (``train.py:build_parser``) whose feature the port
# does not carry yet, each with the ROADMAP item that brings it.
UNPORTED_FLAGS = {
    "--obs-norm": "observation normalization (ROADMAP A10 (d))",
    "--async-collect": "asynchronous collection, which needs the host actor pool (ROADMAP A5 (d))",
    "--dp": "data parallelism (ROADMAP A7)",
    "--fleet-listen": "the collection fleet (ROADMAP A11)",
    "--publish-interval": "asynchronous collection, which needs the host actor pool "
                          "(ROADMAP A5 (d))",
    "--concurrent-eval": "the concurrent evaluator thread, which scores host-pool envs "
                         "(ROADMAP A5 (d))",
    "--no-concurrent-eval": "the concurrent evaluator thread, which scores host-pool envs "
                            "(ROADMAP A5 (d))",
    "--pool-start-method": "the host actor pool (ROADMAP A5 (d))",
    "--pool-step-timeout": "the host actor pool (ROADMAP A5 (d))",
    "--actor-device": "the host actor pool (ROADMAP A5 (d))",
    "--device-tree-backend": "a choice of device PER descent: the port has one, "
                             "kernel B3, and takes no --device-tree-backend (ROADMAP A6)",
    "--tp": "tensor parallelism (ROADMAP A7)",
    "--dp-hogwild": "asynchronous data parallelism (ROADMAP A7)",
    "--distributed": "multi-host training (ROADMAP A7)",
    "--coordinator": "multi-host training (ROADMAP A7)",
    "--num-processes": "multi-host training (ROADMAP A7)",
    "--process-id": "multi-host training (ROADMAP A7)",
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
    p.add_argument("--env", default="pendulum",
                   help="pendulum, pixel_pendulum, pointmass_goal, halfcheetah, hopper, "
                        "walker2d, humanoid, ant")
    p.add_argument("--rmsize", "--replay-capacity", dest="replay_capacity",
                   type=int, default=None,
                   help="replay capacity (default 1M; the pixel_pendulum preset's "
                        "100k unless given)")
    p.add_argument("--tau", type=float, default=0.001)
    p.add_argument("--bsize", "--batch-size", dest="batch_size", type=int, default=256)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--max-steps", dest="max_episode_steps", type=int, default=None)
    p.add_argument("--action-repeat", type=int, default=1,
                   help="must be 1: the ported envs bake their frame skip "
                        "into their substeps")
    p.add_argument("--on-device", action="store_true",
                   help="rollout, device replay ring (PER by cumsum + "
                        "searchsorted) and learner all on the device; "
                        "num_envs x 32 env steps and round(num_envs x 32 / "
                        "env_steps_per_train_step) grad steps an iteration")
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
    p.add_argument("--her", action="store_true",
                   help="hindsight relabeling on a goal env (pointmass_goal): "
                        "whole single-env episodes, each stored with --her-k "
                        "'future' relabels a step")
    p.add_argument("--her-k", type=int, default=4)
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
                   help="host = host replay, one [K, B] batch copy per "
                        "dispatch; device = device ring (+ device PER tree) "
                        "and one megastep of K grad steps per dispatch; "
                        "hybrid = host PER tree, device ring: only the "
                        "[K, B] indices and IS weights cross per dispatch "
                        "(needs --p-replay)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K grad steps per dispatch (every placement)")
    p.add_argument("--tree-backend", choices=["auto", "numpy", "native"], default="auto",
                   help="host PER trees: native = the C++ trees built with "
                        "g++ at first use (raises if they cannot be); numpy; "
                        "auto = native, else numpy with a printed line")
    p.add_argument("--fused-descent", action="store_true",
                   help="fuse each step's loss with the next step's descent "
                        "(CUDA kernel B4); needs --replay-placement device, "
                        "--p-replay and --projection fused")
    p.add_argument("--debug-guards", action="store_true",
                   help="run every host, megastep and hybrid dispatch after "
                        "the first under torch.cuda.set_sync_debug_mode('error')")
    p.add_argument("--prefetch", action="store_true",
                   help="double-buffered replay->device pipeline: batch N+1 "
                        "is host-sampled and its copy to the device started "
                        "while the device runs step N, so sampling + H2D "
                        "transfer leave the critical path (one dispatch of "
                        "priority/freshness staleness, same class as "
                        "--steps-per-dispatch; host placement)")
    p.add_argument("--async-writeback", action="store_true",
                   help="flush PER priorities from a background thread that "
                        "drains everything queued since its last wake and "
                        "waits once for the newest device->host copy (host "
                        "and hybrid placements). Measured on an H100 it "
                        "costs the K = 1 host loop 10-29%% of its grad "
                        "steps/s and gains nothing at K = 8 or on hybrid "
                        "(PERF.md section 5)")
    p.add_argument("--ingest-prefetch", action="store_true",
                   help="double-buffer the ring ingest: gather + H2D the "
                        "next flush's first chunk right after each "
                        "megastep dispatch, overlapping the transfer with "
                        "the in-flight compute (device placement; ignored "
                        "— declared — elsewhere)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace (Chrome trace "
                        "*.pt.trace.json) of grad steps 10-60 here")
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
    p.add_argument("--twin-critic", action="store_true",
                   help="clipped double-Q (TD3-style) distributional twin "
                        "critics; fixes the single-critic plateau on "
                        "Hopper/Walker2d-class tasks")
    p.add_argument("--critic-head", choices=["categorical", "scalar", "mixture_gaussian"],
                   default="categorical",
                   help="critic value head: categorical (C51, the default), "
                        "scalar (plain DDPG) or mixture_gaussian (MoG with the "
                        "Gauss-Hermite cross-entropy Bellman backup, ops/mog.py)")
    p.add_argument("--num-mixtures", type=int, default=5,
                   help="mixture components M for --critic-head mixture_gaussian")
    p.add_argument("--critic-ensemble", type=int, default=0,
                   help="REDQ-style critic ensemble width E (0 = off): E "
                        "stacked critics, Bellman targets min over a random "
                        "subset, actor ascends the ensemble mean; mutually "
                        "exclusive with --twin-critic")
    p.add_argument("--ensemble-min-targets", type=int, default=2,
                   help="size M of the random target subset the ensemble "
                        "backup minimizes over (M=E recovers min-over-all)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="network compute dtype; bfloat16 keeps float32 master "
                        "weights, Adam moments, targets and losses")
    p.add_argument("--batch-scale", type=int, default=1, metavar="S",
                   help="the large-batch recipe in one knob: batch x S, "
                        "lr x S (linear scaling), PER-beta anneal / S, "
                        "warmup x S, steps-per-dispatch / S")
    p.add_argument("--ring-dtype", choices=["auto", "float32", "bfloat16"], default="auto",
                   help="--on-device ring row dtype for the observations; "
                        "bfloat16 halves their bytes")
    p.add_argument("--transfer-dtype", choices=["float32", "bfloat16", "uint8"],
                   default="float32",
                   help="host placement: the observations' host->device wire "
                        "format; bfloat16 halves their bytes, uint8 (pixel "
                        "envs) ships the replay's stored bytes")
    p.add_argument("--lr-actor", type=float, default=1e-4)
    p.add_argument("--lr-critic", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export-bundle", default=None, metavar="DIR",
                   help="instead of training: package this run's champion "
                        "actor (checkpoints/best_actor.npz, else the newest "
                        "checkpoint's state.pt) + config + action bounds + "
                        "obs-norm stats into a serving bundle at DIR for "
                        "python -m d4pg_tpu_torch.serve, then exit (needs "
                        "no card)")
    return p


def refuse_unported(argv) -> None:
    """Raise ``NotImplementedError`` for a flag of :data:`UNPORTED_FLAGS`."""
    for arg in argv:
        what = UNPORTED_FLAGS.get(arg.split("=", 1)[0])
        if what is not None:
            raise NotImplementedError(f"{arg}: {what} is not ported to d4pg_tpu_torch yet")


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    """The flags as a ``TrainConfig``. The support is resolved as the JAX
    CLI resolves it: the env preset's, then each explicit ``--v-min`` /
    ``--v-max`` on its own; the trainers keep it."""
    v_min, v_max = cli_support(args.env, args.v_min, args.v_max)
    dist = DistConfig(
        kind=args.critic_head,
        num_atoms=args.n_atoms,
        num_mixtures=args.num_mixtures,
        v_min=v_min,
        v_max=v_max,
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
        twin_critic=args.twin_critic,
        critic_ensemble=args.critic_ensemble,
        ensemble_min_targets=args.ensemble_min_targets,
        compute_dtype=args.compute_dtype,
    )
    if args.hidden_sizes:
        agent = dataclasses.replace(
            agent,
            hidden_sizes=tuple(int(h) for h in args.hidden_sizes.split(",") if h.strip()),
        )
    log_dir = args.log_dir or (
        f"runs/torch_{args.env}_{'PER' if args.prioritized else 'UNI'}"
        f"{'_HER' if args.her else ''}_n{args.n_step}_{args.num_envs}env"
    )
    return TrainConfig(
        env=args.env,
        max_episode_steps=args.max_episode_steps,
        action_repeat=args.action_repeat,
        num_envs=args.num_envs,
        her=args.her,
        her_k=args.her_k,
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
        tree_backend=args.tree_backend,
        fused_descent=args.fused_descent,
        debug_guards=args.debug_guards,
        prefetch=args.prefetch,
        async_priority_writeback=args.async_writeback,
        ingest_prefetch=args.ingest_prefetch,
        profile_dir=args.profile_dir,
        checkpoint_interval=args.checkpoint_interval,
        resume=args.resume,
        snapshot_replay=args.snapshot_replay,
        max_rss_gb=args.max_rss_gb,
        batch_scale=args.batch_scale,
        ring_dtype=args.ring_dtype,
        transfer_dtype=args.transfer_dtype,
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


def export_bundle_from_run(cfg: TrainConfig, bundle_dir: str) -> str:
    """Package a trained run into a serving bundle (``--export-bundle``).

    Prefers the keep-best champion (``checkpoints/best_actor.npz``, the
    policy ``best_eval.json`` attests); falls back to the actor of the
    newest checkpoint step (``state.pt``, loaded on the CPU). Every env of
    the port acts in the canonical (−1, 1) box, so the bundle's bounds are
    that box. Reads and writes files only: no card is needed.
    """
    import json
    import os

    import torch

    from d4pg_tpu_torch.config import apply_env_preset
    from d4pg_tpu_torch.runtime.checkpoint import (
        STATE_FILE,
        CheckpointManager,
        load_trainer_meta,
    )
    from d4pg_tpu_torch.serve.bundle import build_actor, export_bundle
    from d4pg_tpu_torch.weights import load_best_actor

    # the env's dims and support before the actor is built, as the trainer
    # reconciles them: a HalfCheetah run's actor is 17 -> 6
    agent_cfg = apply_env_preset(cfg).agent
    actor = build_actor(agent_cfg)
    ckpt_dir = os.path.join(cfg.log_dir, "checkpoints")
    meta = load_trainer_meta(cfg.log_dir)
    provenance = {
        "env": cfg.env,
        "log_dir": os.path.abspath(cfg.log_dir),
        "env_steps": meta.get("env_steps"),
    }
    obs_norm_state = meta.get("obs_norm")
    if os.path.exists(os.path.join(ckpt_dir, "best_actor.npz")):
        load_best_actor(cfg.log_dir, actor)
        provenance["source"] = "best_actor.npz"
        best_json = os.path.join(cfg.log_dir, "best_eval.json")
        if os.path.exists(best_json):
            try:
                with open(best_json) as f:
                    provenance["best_eval"] = json.load(f)
            except (OSError, ValueError):
                pass
        # Pair the champion with the normalizer statistics captured WHEN it
        # was scored (best_obs_norm.json, beside best_actor.npz), not the
        # later trainer_meta.json ones.
        best_norm = os.path.join(ckpt_dir, "best_obs_norm.json")
        if os.path.exists(best_norm):
            with open(best_norm) as f:
                obs_norm_state = json.load(f)
    else:
        step = CheckpointManager(ckpt_dir).latest_step() if os.path.isdir(ckpt_dir) else None
        if step is None:
            raise SystemExit(
                f"--export-bundle: no best_actor.npz and no checkpoint "
                f"under {ckpt_dir} — train (and checkpoint) first"
            )
        saved = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                           map_location="cpu", weights_only=True)
        actor.load_state_dict(saved["actor"])
        provenance["source"] = f"state:{step}"
        provenance["grad_steps"] = step
    out = export_bundle(
        bundle_dir,
        agent_cfg,
        actor,
        obs_norm_state=obs_norm_state,
        meta=provenance,
        prioritized=cfg.prioritized,
    )
    print(
        f"[export-bundle] wrote {out} "
        f"(source={provenance['source']}, obs_dim={agent_cfg.obs_dim}, "
        f"action_dim={agent_cfg.action_dim}, "
        f"obs_norm={'yes' if obs_norm_state else 'no'})",
        flush=True,
    )
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_unported(argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.export_bundle:
        export_bundle_from_run(cfg, args.export_bundle)
        return {}
    if args.on_device:
        return _main_on_device(cfg, args.device)
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


def _main_on_device(cfg: TrainConfig, device: str) -> dict:
    """``--on-device``: validate, then the on-device loop with the
    preemption handlers setting its stop event (exit 75 when it stopped
    for a ``--resume`` restart)."""
    import threading

    from d4pg_tpu_torch.config import check_on_device
    from d4pg_tpu_torch.runtime.on_device import run_on_device

    print(f"config: {cfg}", flush=True)
    try:
        check_on_device(cfg)  # the JAX CLI's validation exits with its message
    except ValueError as e:
        raise SystemExit(str(e))
    preempt_event = threading.Event()
    install_preemption_handlers(preempt_event.set)
    final = run_on_device(cfg, preempt_event=preempt_event, device=device)
    preempted = final.pop("_preempted", False)
    print(f"done: {final}", flush=True)
    if preempted:
        sys.exit(75)
    return final


if __name__ == "__main__":
    main()
