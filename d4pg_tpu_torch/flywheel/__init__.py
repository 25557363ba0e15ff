"""The flywheel (the port's counterpart of ``d4pg_tpu/flywheel``): served
traffic becomes training data, gated off-policy.

It closes the loop between the serving stack (``d4pg_tpu_torch/serve``)
and the training stack (the ``d4pg_tpu_torch/fleet`` ingest → replay →
learner):

- :mod:`~d4pg_tpu_torch.flywheel.tap` — the mirror tap. Rides inside the
  policy server (``serve/server.py``, ``--mirror-fraction``), mirrors a
  Bresenham-striped fraction of the episodes whose reward the client
  echoes back (``FEEDBACK`` frames), assembles them through the
  ``NStepWriter`` into generation-tagged WINDOWS2 frames with the
  behavior log-prob column, and streams them to the fleet ingest
  (``source: "mirror"``) and to the on-disk spool;
- :mod:`~d4pg_tpu_torch.flywheel.spool` — the bounded on-disk frame log
  the tap writes and the promotion gate reads (in another process: the
  spool is the shared-filesystem seam);
- :mod:`~d4pg_tpu_torch.flywheel.gate` — the off-policy promotion gate:
  a self-normalized importance-sampling return estimate of a CANDIDATE
  bundle over mirrored windows, with the torch-free numpy bundle policy;
- :mod:`~d4pg_tpu_torch.flywheel.sim_client` — the sim-attached client:
  plays env episodes through the serve path and echoes the outcome as
  ``FEEDBACK``; with ``--noise-sigma 0 --no-feedback`` a fixed-seed
  evaluator.

No module here imports torch (nor does anything they import), and the
names below load their module on first use.
"""

from d4pg_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "CLIP_LOG_RHO": "d4pg_tpu_torch.flywheel.gate",
    "evaluate_is_gate": "d4pg_tpu_torch.flywheel.gate",
    "gaussian_log_prob": "d4pg_tpu_torch.flywheel.gate",
    "MirrorSpool": "d4pg_tpu_torch.flywheel.spool",
    "iter_payloads": "d4pg_tpu_torch.flywheel.spool",
    "read_windows": "d4pg_tpu_torch.flywheel.spool",
    "MirrorLink": "d4pg_tpu_torch.flywheel.tap",
    "MirrorTap": "d4pg_tpu_torch.flywheel.tap",
    "TAP_COUNTER_KEYS": "d4pg_tpu_torch.flywheel.tap",
    "run_episodes": "d4pg_tpu_torch.flywheel.sim_client",
}

__all__ = sorted(_EXPORTS)
__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
