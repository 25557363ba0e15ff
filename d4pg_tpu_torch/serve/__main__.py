"""``python -m d4pg_tpu_torch.serve``: run a policy server from a bundle.

The flags are those of ``python -m d4pg_tpu.serve`` under the same names,
plus ``--device {cuda,cpu}`` (default cuda: with no card and no
``--device cpu`` the server raises before it loads anything).

Installs SIGTERM/SIGINT handlers that trigger the graceful drain: stop
accepting, answer everything admitted, then exit 0 — so an orchestrator's
preemption notice never drops admitted requests. A second signal
hard-kills (the handler restores the default disposition after the
first).

Examples:
    python -m d4pg_tpu_torch.train --env pendulum --log-dir runs/p1 \
        --export-bundle runs/p1/bundle
    python -m d4pg_tpu_torch.serve --bundle runs/p1/bundle --port 7431
    python -m d4pg_tpu_torch.serve --bundle runs/p1/bundle \
        --policy cheetah=runs/hc/bundle --debug-guards
    python -m d4pg_tpu_torch.serve --bundle runs/fw/bundle --mirror-fraction 1.0 \
        --mirror-ingest 127.0.0.1:7470 --mirror-spool runs/fw/spool
"""

from __future__ import annotations

import argparse
import json
import sys

from d4pg_tpu_torch.utils.signals import install_graceful_signals

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m d4pg_tpu_torch.serve",
                                description="Serve a policy bundle on PyTorch/CUDA")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default) captures one CUDA graph a bucket; cpu "
                        "runs the forward on the CPU")
    p.add_argument("--bundle", required=True,
                   help="bundle directory from --export-bundle (the DEFAULT "
                        "policy: v1 clients with no policy-id field land here)")
    p.add_argument("--policy", action="append", default=[], metavar="NAME=DIR",
                   help="additional resident policy (repeatable): NAME is the "
                        "ACT2 policy_id, DIR its bundle. Each policy gets its "
                        "own batcher, stream, graphs and hot-reload watch")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7431,
                   help="0 = ephemeral (printed on startup)")
    p.add_argument("--max-batch", type=int, default=64,
                   help="batch window cap; also the largest bucket")
    p.add_argument("--max-wait-us", type=int, default=2000,
                   help="batching window: max microseconds a batch waits "
                        "for more requests after its first")
    p.add_argument("--queue-limit", type=int, default=256,
                   help="bounded request queue; past it requests shed with "
                        "an explicit 'overloaded' reply")
    p.add_argument("--default-deadline-ms", type=float, default=0.0,
                   help="deadline applied to requests that carry none "
                        "(0 = unbounded)")
    p.add_argument("--watch-run", default=None,
                   help="training run dir to hot-reload best_actor.npz "
                        "from when its best_eval.json changes")
    p.add_argument("--no-watch-bundle", dest="watch_bundle", action="store_false",
                   help="disable hot-reloading the bundle dir on re-export")
    p.add_argument("--poll-interval", type=float, default=2.0,
                   help="hot-reload poll seconds")
    p.add_argument("--log-dir", default=None,
                   help="append serve metrics rows (metrics.jsonl) here")
    p.add_argument("--metrics-interval", type=float, default=30.0)
    p.add_argument("--replica-id", type=int, default=None,
                   help="fleet identity: stamped into healthz and every "
                        "metrics.jsonl row")
    p.add_argument("--mirror-fraction", type=float, default=0.0,
                   help="flywheel mirror tap: fraction of served EPISODES "
                        "(Bresenham-striped per connection) whose "
                        "obs/action/reward traffic is mirrored into "
                        "training windows; needs clients that echo reward "
                        "via FEEDBACK frames (flywheel/sim_client.py)")
    p.add_argument("--mirror-ingest", default=None, metavar="HOST:PORT",
                   help="fleet ingest to stream mirrored WINDOWS2 frames "
                        "to (the learner's --fleet-listen port)")
    p.add_argument("--mirror-spool", default=None, metavar="DIR",
                   help="on-disk spool of mirrored frames (what the "
                        "off-policy promotion gate reads); independent of "
                        "--mirror-ingest liveness")
    p.add_argument("--io-read-stall-s", type=float, default=30.0,
                   help="event loop: evict a connection whose partial "
                        "frame makes no completion progress for this long "
                        "(the slowloris bound)")
    p.add_argument("--io-write-stall-s", type=float, default=10.0,
                   help="event loop: evict a connection that drains none "
                        "of its buffered replies for this long (the "
                        "zero-window bound)")
    p.add_argument("--chaos", default=None, metavar="PLAN",
                   help="deterministic fault injection (d4pg_tpu_torch/chaos.py): "
                        "e.g. 'sock_reset@5' force-resets the serving "
                        "connection at its 5th frame; 'slowloris@N:bps' / "
                        "'zero_window@N:ms' / 'fd_exhaust@N:ms' launch "
                        "connection-level attacks at the Nth accept (the "
                        "netio deadlines must evict them); 'mirror_drop@N' "
                        "loses the mirror tap's Nth window before both sinks")
    p.add_argument("--debug-guards", action="store_true",
                   help="runtime guards (d4pg_tpu_torch/analysis): on the card "
                        "every batch after warmup dispatches under "
                        "torch.cuda.set_sync_debug_mode('error'), a staging "
                        "ledger polices the batcher's input slots, and drain "
                        "checks that every CUDA graph still reads the "
                        "parameters hot reload writes into, the lock witness against the "
                        "port's lock graph and the serve-stats identity; the "
                        "mirror tap's close checks the mirror-tap identity")
    return p


def _kernel_modules() -> tuple:
    """The modules of the port's hand kernels, each with its ``LAUNCHES``
    counter and ``reset_launch_counts``."""
    from d4pg_tpu_torch.ops import cuda_fused_step, cuda_projection, cuda_tree

    return (cuda_projection, cuda_tree, cuda_fused_step)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.debug_guards:
        # Armed BEFORE anything builds its locks (the named helpers wrap
        # only when enabled); drain checks both.
        from d4pg_tpu_torch.analysis import flowledger, lockwitness

        lockwitness.enable()
        flowledger.enable()
    chaos = None
    if args.chaos:
        from d4pg_tpu_torch.chaos import ChaosInjector, ChaosPlan

        chaos = ChaosInjector(ChaosPlan.parse(args.chaos))
    from d4pg_tpu_torch import resolve_device
    from d4pg_tpu_torch.serve.bundle import load_bundle
    from d4pg_tpu_torch.serve.server import PolicyServer

    device = resolve_device(args.device)  # no card and no --device cpu: raises
    bundle = load_bundle(args.bundle)
    policies = {}
    for spec in args.policy:
        name, sep, path = spec.partition("=")
        if not sep or not name or not path:
            raise SystemExit(f"--policy wants NAME=DIR, got {spec!r}")
        if name in policies:
            raise SystemExit(f"--policy {name!r} given twice")
        policies[name] = load_bundle(path)
    tap = None
    if args.mirror_fraction > 0:
        from d4pg_tpu_torch.flywheel.spool import MirrorSpool
        from d4pg_tpu_torch.flywheel.tap import MirrorTap

        ingest_addr = None
        if args.mirror_ingest:
            ih, _, ip = args.mirror_ingest.rpartition(":")
            ingest_addr = (ih, int(ip))
        spool = MirrorSpool(args.mirror_spool) if args.mirror_spool else None
        tap = MirrorTap(
            obs_dim=bundle.obs_dim,
            action_dim=bundle.action_dim,
            n_step=bundle.config.n_step,
            gamma=bundle.config.gamma,
            fraction=args.mirror_fraction,
            ingest_addr=ingest_addr,
            spool=spool,
            bundle_dir=args.bundle,
            env=bundle.meta.get("env", "unknown"),
            tap_id=f"mirror-replica-{args.replica_id}"
            if args.replica_id is not None else "mirror-replica",
            chaos=chaos,
        )
    server = PolicyServer(
        bundle,
        policies=policies or None,
        host=args.host,
        port=args.port,
        max_batch=args.max_batch,
        max_wait_us=args.max_wait_us,
        queue_limit=args.queue_limit,
        default_deadline_ms=args.default_deadline_ms,
        watch_run=args.watch_run,
        watch_bundle=args.watch_bundle,
        poll_interval_s=args.poll_interval,
        log_dir=args.log_dir,
        metrics_interval_s=args.metrics_interval,
        debug_guards=args.debug_guards,
        chaos=chaos,
        replica_id=args.replica_id,
        mirror_tap=tap,
        io_read_stall_s=args.io_read_stall_s,
        io_write_stall_s=args.io_write_stall_s,
        device=device,
    )

    install_graceful_signals(
        server.request_shutdown,
        "[serve] {sig}: draining (second signal hard-kills)",
    )

    server.start()
    # the hand kernels' launch counters, from 0 for the serving window
    # (printed at drain: the server runs none of them, its forward is a
    # CUDA graph)
    for mod in _kernel_modules():
        mod.reset_launch_counts()
    rid = f"replica_id={args.replica_id} " if args.replica_id is not None else ""
    print(
        f"[serve] listening on {server.host}:{server.port} {rid}"
        f"obs_dim={bundle.obs_dim} action_dim={bundle.action_dim} "
        f"buckets={list(server.batcher.buckets)} "
        f"policies={sorted(server.policies)} "
        f"source={bundle.meta.get('source', '?')}",
        flush=True,
    )
    server.serve_until_shutdown()
    if tap is not None:
        # the tap drains AFTER the server: every admitted request's
        # feedback has been acked, so the mirror books are final
        tap.close()
        mc = tap.counters()
        print("[serve] mirror: " + " ".join(f"{k}={mc[k]}" for k in sorted(mc)), flush=True)
    if server.ledger is not None:
        print(f"[serve] staging ledger: {json.dumps(server.ledger.stats())}", flush=True)
    launches = {k: v for mod in _kernel_modules() for k, v in mod.LAUNCHES.items()}
    print(f"[serve] kernel launches: {json.dumps(launches)}", flush=True)
    snap = server.healthz()
    # aggregate across every resident policy (top-level counters are the
    # DEFAULT policy's)
    served = sum(r["replies_ok"] for r in snap["policies"].values())
    shed = snap["shed_total"] + sum(
        r["shed_total"] for pid, r in snap["policies"].items() if pid != "default"
    )
    print(
        f"[serve] drained: {served} served, {shed} shed, p99={snap.get('p99_ms')} ms",
        flush=True,
    )
    sys.exit(0)


if __name__ == "__main__":
    main()
