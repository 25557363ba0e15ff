"""Policy serving: obs → action inference as a standalone subsystem (the
port's counterpart of ``d4pg_tpu/serve``).

- :mod:`~d4pg_tpu_torch.serve.bundle`   — self-contained export/load of
  params + config + bounds + obs-norm stats, in the JAX package's format
  (``python -m d4pg_tpu_torch.train --export-bundle``);
- :mod:`~d4pg_tpu_torch.serve.batcher`  — dynamic micro-batching onto one
  device thread, one CUDA graph a bucket, explicit load shedding;
- :mod:`~d4pg_tpu_torch.serve.server`   — socket front-end on the
  ``d4pg_tpu_torch.netio`` event loop, with deadlines, hot reload,
  graceful drain, healthz;
- :mod:`~d4pg_tpu_torch.serve.client`   — blocking + pipelined client;
- :mod:`~d4pg_tpu_torch.serve.protocol` — the length-prefixed binary frames;
- :mod:`~d4pg_tpu_torch.serve.stats`    — p50/p95/p99, batch/queue histograms;
- :mod:`~d4pg_tpu_torch.serve.router`   — replicated front-end: least-loaded
  dispatch over replicas, healthz-driven ejection, a canary rollout per
  policy with auto-rollback, QoS and tenant admission (torch-free);
- :mod:`~d4pg_tpu_torch.serve.autoscaler` — healthz-driven control loop
  that spawns and drains replicas or actor hosts (torch-free).

Run it: ``python -m d4pg_tpu_torch.serve --bundle <dir>``;
``--debug-guards`` arms the staging ledger, the transfer and sync guards,
the lock witness and the ``serve-stats`` flow identity
(``d4pg_tpu_torch/analysis``), and ``--chaos`` the serving fault sites
(``sock_reset`` and the connection attacks of ``netio/attack.py``);
``--mirror-fraction``, ``--mirror-ingest`` and ``--mirror-spool`` attach
the flywheel's mirror tap (``d4pg_tpu_torch/flywheel``).
``python -m d4pg_tpu_torch.serve.router --backends host:port,...`` fronts
several such servers (``--autoscale`` grows and drains the fleet).

The names below load their module on first use, so importing the
protocol or the client does not build the batcher's machinery.
"""

import importlib

_EXPORTS = {
    "DynamicBatcher": "d4pg_tpu_torch.serve.batcher",
    "ShedError": "d4pg_tpu_torch.serve.batcher",
    "default_buckets": "d4pg_tpu_torch.serve.batcher",
    "PolicyBundle": "d4pg_tpu_torch.serve.bundle",
    "export_bundle": "d4pg_tpu_torch.serve.bundle",
    "load_bundle": "d4pg_tpu_torch.serve.bundle",
    "ConnectionClosed": "d4pg_tpu_torch.serve.client",
    "Overloaded": "d4pg_tpu_torch.serve.client",
    "PolicyClient": "d4pg_tpu_torch.serve.client",
    "ServerError": "d4pg_tpu_torch.serve.client",
    "PolicyServer": "d4pg_tpu_torch.serve.server",
    "Router": "d4pg_tpu_torch.serve.router",
    "Autoscaler": "d4pg_tpu_torch.serve.autoscaler",
    "ScaleSignal": "d4pg_tpu_torch.serve.autoscaler",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


def __dir__():
    return __all__
