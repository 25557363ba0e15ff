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
A training run that ends with exit 0 or 75 prints, after its ``done:``
line, ``[train] kernel launches: {...}``: the launch counts of the hand
kernels' wrappers in this process (the serve CLI prints the same line).

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
    python -m d4pg_tpu_torch.train --env HalfCheetah-v4 --num-envs 4 \
        --async-collect --obs-norm     # the host actor pool over gymnasium
    python -m d4pg_tpu_torch.train --env dmc:cartpole:swingup --num-envs 8
    python -m d4pg_tpu_torch.train --env pendulum --replay-placement device \
        --p-replay --steps-per-dispatch 8 --dp 2   # two lanes in one process
    python -m d4pg_tpu_torch.train --env pendulum --replay-placement device \
        --p-replay --steps-per-dispatch 8 --dp 2 --num-processes 2 \
        --process-id 0 --coordinator 127.0.0.1:29500 --log-dir runs/dp
        # and the same with --process-id 1: one lane a process; process 1
        # logs under runs/dp/worker1, checkpoints are process 0's
    python -m d4pg_tpu_torch.train --env pendulum --dp 2 --tp 2
        # host placement: two dp lanes, each with its state on two tp lanes
    python -m d4pg_tpu_torch.train --env pendulum --on-device --dp 2
        # the on-device loop on two lanes: envs, ring and batch split
    python -m d4pg_tpu_torch.train --env pixel_pendulum --num-envs 0 \
        --fleet-listen 7470 --fleet-bundle runs/fleet/bundle
        # a fleet-only learner; its actors run
        # python -m d4pg_tpu_torch.fleet.actor --connect HOST:7470 \
        #     --bundle runs/fleet/bundle --env pixel_pendulum_host

``--on-device`` runs :func:`d4pg_tpu_torch.runtime.on_device.run_on_device`
(the JAX CLI's ``--on-device``) after the same validation plus its own
refusals (``config.check_on_device``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

# The module imports no torch at its top: the host actor pool's spawned
# workers re-import the ``-m`` main module (as ``__mp_main__``), and must
# stay free of torch. The config classes are imported where they are used.

# Flags of the JAX CLI (``train.py:build_parser``) whose feature the port
# does not carry yet, each with the ROADMAP item that brings it.
UNPORTED_FLAGS = {
    "--device-tree-backend": "a choice of device PER descent: the port has one, "
                             "kernel B3, and takes no --device-tree-backend (ROADMAP A6)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="D4PG on PyTorch/CUDA")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default) runs the CUDA kernels; cpu runs their "
                        "plain PyTorch versions")
    p.add_argument("--env", default="pendulum",
                   help="pendulum, pixel_pendulum, pointmass_goal, halfcheetah, hopper, "
                        "walker2d, humanoid, ant (torch envs on the device), or a "
                        "gymnasium id (Pendulum-v1, HalfCheetah-v4, ...) or "
                        "dmc:<domain>:<task> stepped on the host")
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
                   help="batched exploration envs on the device, or the host "
                        "actor pool's size for gymnasium and dmc: envs")
    p.add_argument("--obs-norm", action="store_true",
                   help="running observation normalization at the data "
                        "boundary: clip((x-mean)/std, +-5), Welford stats "
                        "folded once per observed env step at collection "
                        "(never per sampled batch), applied to sampled "
                        "batches and to the acting and eval forwards "
                        "(host state-feature envs only)")
    p.add_argument("--async-collect", action="store_true",
                   help="decouple actors from the learner: the host actor pool "
                        "collects in a background thread against published "
                        "actor copies (a single env gets a pool of 1)")
    p.add_argument("--publish-interval", type=int, default=10,
                   help="grad steps between actor-param publications (async)")
    p.add_argument("--pool-start-method", choices=["spawn", "fork", "forkserver"],
                   default="spawn",
                   help="actor-pool worker start method; spawn keeps children "
                        "free of torch and CUDA, fork starts faster (a forked "
                        "child uses numpy only, never the parent's CUDA context)")
    p.add_argument("--pool-step-timeout", dest="pool_step_timeout_s",
                   type=float, default=60.0,
                   help="supervised actor pool: seconds a worker may take "
                        "to answer one step before it is declared hung and "
                        "restarted (monotonic deadline)")
    p.add_argument("--actor-device", choices=["auto", "cpu", "default"],
                   default="auto",
                   help="where host-env collection and eval forwards run: cpu "
                        "(a CPU copy of the actor), default (the learner's "
                        "device), auto = cpu whenever the learner is on the card")
    p.add_argument("--concurrent-eval", dest="concurrent_eval",
                   action=argparse.BooleanOptionalAction, default=True,
                   help="host-env eval runs in a dedicated thread on a "
                        "published param copy, so eval crossings cost zero "
                        "grad steps")
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
                   help="runtime guards (d4pg_tpu_torch/analysis): on the card "
                        "every host, megastep and hybrid dispatch after the first "
                        "under the zero-transfer budget (no CPU tensor operand, "
                        "no host sync inside), a "
                        "staging ledger on the PER and pool staging slots, the "
                        "recompile sentinel (the dispatch's program and the "
                        "ingests at one specialization each, checked at every "
                        "eval and at the end of a leg), and "
                        "the lock witness checked against the port's lock graph "
                        "at close; a trip raises")
    p.add_argument("--chaos", default=None, metavar="PLAN",
                   help="deterministic fault injection (d4pg_tpu_torch/chaos.py): "
                        "';'-separated site@count[:arg][#actor] entries, e.g. "
                        "'seed=7;env_raise@40;worker_kill@12#1;ckpt_truncate@1;"
                        "wb_stall@3:0.5'; host_kill@N:P SIGKILLs process P at "
                        "its Nth megastep or hybrid dispatch (the relaunching "
                        "supervisor: python -m d4pg_tpu_torch.tools.multihost_smoke)")
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
    p.add_argument("--dp", type=int, default=None,
                   help="data-parallel lanes (None = one device): the batch's rows "
                        "split over the lanes, their gradients combined by a "
                        "fixed-order mean every grad step")
    p.add_argument("--dp-hogwild", action="store_true",
                   help="host placement: each lane runs the K = --steps-per-dispatch "
                        "steps of a dispatch on its own copy of the state, then one "
                        "fixed-order mean of every float tensor resyncs the copies")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor parallelism: with --dp on the host placement, "
                        "each dp lane's train state sharded over N tp lanes "
                        "(the Megatron step); no effect without --dp")
    # multi-process bring-up (torch.distributed): every process runs the
    # same command with its own --process-id; env-var fallbacks let a
    # launcher template one command line
    p.add_argument("--distributed", action="store_true",
                   help="join the process group from a launcher's variables "
                        "(env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)")
    p.add_argument("--coordinator", default=os.environ.get("D4PG_COORDINATOR"),
                   help="HOST:PORT of process 0's rendezvous (tcp://), for an "
                        "explicit cluster (env D4PG_COORDINATOR)")
    p.add_argument("--num-processes", type=int,
                   default=int(os.environ.get("D4PG_NUM_PROCESSES", "0")) or None,
                   help="total process count (env D4PG_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int,
                   default=int(os.environ["D4PG_PROCESS_ID"])
                   if os.environ.get("D4PG_PROCESS_ID") is not None else None,
                   help="this process's rank (env D4PG_PROCESS_ID)")
    # the collection fleet (d4pg_tpu_torch/fleet)
    p.add_argument("--fleet-listen", type=int, default=None, metavar="PORT",
                   help="run the experience-ingest server on PORT (0 = "
                        "ephemeral, printed at startup): remote actor hosts "
                        "(python -m d4pg_tpu_torch.fleet.actor) stream n-step "
                        "windows into replay, beside local collection or, "
                        "with --num-envs 0, instead of it")
    p.add_argument("--fleet-host", default="0.0.0.0", metavar="ADDR",
                   help="ingest bind address (default 0.0.0.0 so remote "
                        "actor hosts can reach it; 127.0.0.1 = loopback-"
                        "only fleet)")
    p.add_argument("--fleet-bundle", default=None, metavar="DIR",
                   help="publish the acting bundle here for fleet actors "
                        "(atomic re-export every --fleet-publish-interval "
                        "grad steps, bumping the bundle generation; actors "
                        "hot-swap on the bundle.json mtime)")
    p.add_argument("--fleet-publish-interval", type=int, default=200,
                   help="grad steps between fleet bundle publications")
    p.add_argument("--fleet-max-gen-lag", type=int, default=1,
                   help="ingest drops windows produced under a bundle (or "
                        "obs-norm stats) generation older than current "
                        "minus this lag")
    p.add_argument("--fleet-wire-dtype", choices=["auto", "float32", "bfloat16"],
                   default="auto",
                   help="fleet ingest wire encoding for flat observation "
                        "rows: auto/float32 = byte-identical f32; bfloat16 "
                        "halves wire bytes with a declared bf16 round "
                        "(pixel envs always negotiate u8-quantized rows)")
    # league membership (d4pg_tpu_torch/league): set by the controller when
    # it spawns or forks this learner, never by hand
    p.add_argument("--variant-id", type=int, default=None,
                   help="league variant id this learner is: stamped onto "
                        "every metrics.jsonl row + trainer_meta.json (the "
                        "league controller's fork-resume attestation) and "
                        "negotiated in the fleet HELLO (actors assigned "
                        "elsewhere are refused)")
    p.add_argument("--league-generation", type=int, default=0,
                   help="league generation that spawned/forked this "
                        "learner (rides the metrics rows next to "
                        "--variant-id)")
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


def config_from_args(args: argparse.Namespace):
    """The flags as a ``TrainConfig``. The support is resolved as the JAX
    CLI resolves it: the env preset's, then each explicit ``--v-min`` /
    ``--v-max`` on its own; the trainers keep it. ``--batch-scale`` is
    applied here, as the JAX CLI applies it after the env preset (which
    the trainers apply: a host env's preset needs the built env, and it
    sets none of the knobs the scale moves)."""
    from d4pg_tpu_torch.agent.state import D4PGConfig
    from d4pg_tpu_torch.config import TrainConfig, apply_batch_scale, check_chaos, cli_support
    from d4pg_tpu_torch.models.critic import DistConfig

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
    cfg = apply_batch_scale(TrainConfig(
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
        obs_norm=args.obs_norm,
        async_collect=args.async_collect,
        publish_interval=args.publish_interval,
        pool_start_method=args.pool_start_method,
        pool_step_timeout_s=args.pool_step_timeout_s,
        actor_device=args.actor_device,
        concurrent_eval=args.concurrent_eval,
        dp=args.dp,
        dp_hogwild=args.dp_hogwild,
        tp=args.tp,
        num_processes=args.num_processes or 1,
        chaos=args.chaos,
        fleet_listen=args.fleet_listen,
        fleet_host=args.fleet_host,
        fleet_bundle=args.fleet_bundle,
        fleet_publish_interval=args.fleet_publish_interval,
        fleet_max_gen_lag=args.fleet_max_gen_lag,
        fleet_wire_dtype=args.fleet_wire_dtype,
        variant_id=args.variant_id,
        league_generation=args.league_generation,
    ))
    check_chaos(cfg)  # before any process group forms
    return cfg


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


def export_bundle_from_run(cfg, bundle_dir: str) -> str:
    """Package a trained run into a serving bundle (``--export-bundle``).

    Prefers the keep-best champion (``checkpoints/best_actor.npz``, the
    policy ``best_eval.json`` attests); falls back to the actor of the
    newest checkpoint step (``state.pt``, loaded on the CPU). A host env
    (gymnasium, ``dmc:``) is built here when it can be, for its dims and
    its action bounds (its ``NormalizeAction`` box); every torch env acts
    in the canonical (−1, 1) box, the bounds then. Reads and writes files
    only: no card is needed.
    """
    import json
    import os

    import torch

    from d4pg_tpu_torch.config import apply_env_preset
    from d4pg_tpu_torch.envs import ENVS, make_env
    from d4pg_tpu_torch.runtime.checkpoint import (
        STATE_FILE,
        CheckpointManager,
        load_trainer_meta,
    )
    from d4pg_tpu_torch.serve.bundle import build_actor, export_bundle
    from d4pg_tpu_torch.weights import load_best_actor

    # the env's dims and support before the actor is built, as the trainer
    # reconciles them: a HalfCheetah run's actor is 17 -> 6
    env = low = high = None
    if cfg.env not in ENVS:
        try:
            env = make_env(cfg.env, cfg.max_episode_steps, cfg.action_repeat)
        except Exception as e:  # an env this machine cannot build: the preset
            print(f"[export-bundle] could not construct env {cfg.env!r} ({e}); "
                  "using preset dims and canonical (-1,1) action bounds", flush=True)
    if env is not None:
        norm = getattr(env, "_normalize", None)
        if norm is not None:
            low, high = norm.low, norm.high
    agent_cfg = apply_env_preset(cfg, env).agent
    if env is not None and hasattr(env, "close"):
        env.close()
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
        elif cfg.obs_norm:
            print(
                "[export-bundle] warning: no best_obs_norm.json next to "
                "best_actor.npz; using trainer_meta.json statistics, which "
                "may postdate the champion params", flush=True,
            )
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
    if cfg.obs_norm and obs_norm_state is None:
        raise SystemExit(
            "--export-bundle: run is flagged --obs-norm but neither "
            "best_obs_norm.json nor trainer_meta.json carries normalizer "
            "statistics; export would serve the net un-normalized inputs"
        )
    out = export_bundle(
        bundle_dir,
        agent_cfg,
        actor,
        action_low=low,
        action_high=high,
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


LAUNCHES_LINE = "[train] kernel launches: "


def print_kernel_launches() -> None:
    """The ``[train] kernel launches: {...}`` line: every hand kernel
    wrapper's launch count in this process, so a supervisor of CLI
    processes can tell which kernels a run went through."""
    import json

    from d4pg_tpu_torch.ops import cuda_fused_step, cuda_projection, cuda_tree

    launches = {k: v for mod in (cuda_projection, cuda_tree, cuda_fused_step)
                for k, v in mod.LAUNCHES.items()}
    print(LAUNCHES_LINE + json.dumps(launches), flush=True)


def bring_up(args, cfg):
    """Join the process group when the flags ask for several processes
    (before the Trainer is built) and print the ``[distributed]`` line.
    Returns the config with the process count, and for a secondary
    process its log dir ``log_dir/worker{i}`` with ``run_root`` the shared
    ``log_dir`` (the JAX CLI's layout)."""
    if not (args.distributed or args.coordinator or (args.num_processes or 0) > 1):
        return cfg
    from d4pg_tpu_torch.parallel.distributed import initialize_distributed

    info = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                  autodetect=args.distributed, device=args.device, dp=args.dp)
    print(f"[distributed] {info}", flush=True)
    cfg = dataclasses.replace(cfg, num_processes=info["process_count"])
    if info["process_index"] != 0:
        cfg = dataclasses.replace(
            cfg, run_root=cfg.log_dir,
            log_dir=os.path.join(cfg.log_dir, f"worker{info['process_index']}"))
    return cfg


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    refuse_unported(argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.debug_guards:
        # Arm the lock witness BEFORE any guarded component builds its
        # locks (the named helpers wrap only when enabled); Trainer.close
        # checks the recorded nesting against the port's committed graph.
        # The flow ledger rides the same flag.
        from d4pg_tpu_torch.analysis import flowledger, lockwitness

        lockwitness.enable()
        flowledger.enable()
    if args.export_bundle:
        export_bundle_from_run(cfg, args.export_bundle)
        return {}
    from d4pg_tpu_torch.config import check_fleet
    from d4pg_tpu_torch.parallel.distributed import shutdown

    try:
        # the experience source before any env, process group or learner
        # (no_collection_source: --num-envs 0 with nothing else collecting)
        check_fleet(cfg, on_device=args.on_device)
    except ValueError as e:
        raise SystemExit(str(e))
    cfg = bring_up(args, cfg)
    if args.on_device:
        try:
            return _main_on_device(cfg, args.device)
        finally:
            shutdown()
    from d4pg_tpu_torch.runtime.trainer import Trainer

    try:
        trainer = Trainer(cfg, device=args.device)
        print(f"config: {trainer.config}", flush=True)
        install_preemption_handlers(trainer.request_preemption)
        try:
            final = trainer.train()
        finally:
            trainer.close()
    finally:
        shutdown()
    print(f"done: {final}", flush=True)
    print_kernel_launches()
    if trainer.preempted:
        # EX_TEMPFAIL: "checkpointed, restart me with --resume"; a
        # supervisor tells preemption (75) from completion (0) by it
        sys.exit(75)
    return final


def _main_on_device(cfg, device: str) -> dict:
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
    print_kernel_launches()
    if preempted:
        sys.exit(75)
    return final


if __name__ == "__main__":
    main()
