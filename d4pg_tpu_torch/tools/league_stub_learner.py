"""A deterministic stand-in learner for the league controller's tests (the
port's copy of ``scripts/league_stub_learner.py``, on the port's
``runtime/manifest.py``).

It speaks the league's surface of ``python -m d4pg_tpu_torch.train`` and
nothing else, in milliseconds instead of a torch import's seconds, so a
controller's whole lifecycle (spawn, the SIGTERM exit-75 drain,
manifest-attested checkpoints, a fork resumed with the verify-on-restore
fallback, the trainer_meta attestation, fitness from metrics rows and
``best_eval.json``) runs in a test:

- checkpoints: ``checkpoints/<step>/params.bin``, ``trainer_meta.json``
  stamped with ``variant_id`` and ``league_generation``, then the step's
  manifest (``runtime/manifest.py``, the digests the trainer's
  ``restore_verified`` checks) LAST;
- ``--resume``: the newest INTACT step wins; a truncated newest step (the
  ``clone_corrupt`` fault) prints ``[checkpoint] fallback: ...`` and the
  older step is restored;
- fitness, set by the genome:
  ``100 - 20·|log10(lr_actor/1e-4)| - 0.2·max_episode_steps`` plus a
  seeded jitter below 0.1, so the planted better variant wins;
- SIGTERM: a final checkpoint, exit 75;
- failure knobs: ``--stub-no-checkpoint`` (never attests: a rollback on
  the attest timeout) and ``--stub-crash-after N`` (exit 3 at step N:
  restarts, then quarantine); an ``lr_actor`` of 0.5 or more crashes at
  the first step.

Run: ``python -m d4pg_tpu_torch.tools.league_stub_learner --log-dir DIR
...`` (imports no torch).
"""

import argparse
import json
import math
import os
import signal
import sys
import time

from d4pg_tpu_torch.runtime import manifest as ckpt_manifest


def parse_args(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--log-dir", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--variant-id", type=int, default=0)
    p.add_argument("--league-generation", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--total-steps", type=int, default=10**9)
    p.add_argument("--checkpoint-interval", type=int, default=4)
    p.add_argument("--eval-interval", type=int, default=2)
    p.add_argument("--lr-actor", type=float, default=1e-4)
    p.add_argument("--lr-critic", type=float, default=1e-4)
    p.add_argument("--noise-epsilon", type=float, default=0.3)
    p.add_argument("--tau", type=float, default=0.001)
    p.add_argument("--max-steps", type=int, default=200)
    p.add_argument("--bsize", type=int, default=8)
    p.add_argument("--n-step", type=int, default=3)
    p.add_argument("--tick-seconds", type=float, default=0.05)
    p.add_argument("--stub-no-checkpoint", action="store_true")
    p.add_argument("--stub-crash-after", type=int, default=0)
    args, _unknown = p.parse_known_args(argv)
    return args


def fitness(args, step):
    base = 100.0 - 20.0 * abs(math.log10(args.lr_actor / 1e-4))
    base -= 0.2 * args.max_steps
    jitter = (((args.seed * 1103515245 + step * 12345) >> 8) % 1000) / 1e4
    return base + jitter


def atomic(path, doc):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def save_checkpoint(args, ckpt_dir, step):
    step_dir = os.path.join(ckpt_dir, str(step))
    os.makedirs(step_dir, exist_ok=True)
    # bytes set by the genome and the step: a fork carries checkable bytes
    with open(os.path.join(step_dir, "params.bin"), "wb") as f:
        f.write(
            f"lr={args.lr_actor} tau={args.tau} step={step}".encode() * 64
        )
    meta_path = os.path.join(ckpt_dir, "trainer_meta.json")
    atomic(meta_path, {
        "env_steps": step * 10,
        "ewma_return": fitness(args, step),
        "variant_id": args.variant_id,
        "league_generation": args.league_generation,
    })
    # the commit record LAST, as the trainer writes it
    ckpt_manifest.write_manifest_file(
        ckpt_manifest.manifest_path(ckpt_dir, step),
        ckpt_manifest.build_manifest(step, step_dir, [meta_path]),
    )


def restore(ckpt_dir):
    steps = ckpt_manifest.manifest_steps(ckpt_dir)
    for step in sorted(steps, reverse=True):
        ok, why, _warn = ckpt_manifest.verify_step_dir(
            ckpt_dir, step, ckpt_manifest.default_step_dir(ckpt_dir, step)
        )
        if not ok:
            print(f"[checkpoint] fallback: step {step}: {why}", flush=True)
            continue
        print(f"[checkpoint] resumed from step {step}", flush=True)
        return step
    if steps:
        print("[checkpoint] no intact step; starting fresh", flush=True)
    return 0


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    run = args.log_dir
    ckpt_dir = os.path.join(run, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(1))
    signal.signal(signal.SIGINT, lambda *_: stop.append(1))
    # a diverged genome: an absurd actor lr crashes at the first step,
    # before any eval row, so the variant crash-loops into quarantine (a
    # crasher with a fitness would be culled instead)
    crash_after = args.stub_crash_after or (1 if args.lr_actor >= 0.5 else 0)
    step = restore(ckpt_dir) if args.resume else 0
    print(f"[stub-learner] v{args.variant_id} step={step} "
          f"lr={args.lr_actor} max_steps={args.max_steps}", flush=True)
    metrics = open(os.path.join(run, "metrics.jsonl"), "a")
    t0 = time.monotonic()
    while step < args.total_steps and not stop:
        time.sleep(args.tick_seconds)
        step += 1
        if crash_after and step >= crash_after:
            print("[stub-learner] poison crash", flush=True)
            sys.exit(3)
        if step % args.eval_interval == 0:
            score = fitness(args, step)
            row = {
                "step": step,
                "t": round(time.monotonic() - t0, 4),
                "variant_id": float(args.variant_id),
                "league_generation": float(args.league_generation),
                "eval_return_mean": score,
                "avg_test_reward_ewma": score,
            }
            metrics.write(json.dumps(row) + "\n")
            metrics.flush()
            atomic(os.path.join(run, "best_eval.json"), {
                "step": step, "eval_return_mean": score,
                "env_steps": step * 10,
            })
        if step % args.checkpoint_interval == 0 and not args.stub_no_checkpoint:
            save_checkpoint(args, ckpt_dir, step)
    if stop:
        if not args.stub_no_checkpoint:
            save_checkpoint(args, ckpt_dir, step)
        print("[stub-learner] preempted: checkpointed, exiting 75",
              flush=True)
        sys.exit(75)
    print("[stub-learner] done", flush=True)
    sys.exit(0)


if __name__ == "__main__":
    main()
