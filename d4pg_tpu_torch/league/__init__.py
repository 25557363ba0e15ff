"""League training (the port's counterpart of ``d4pg_tpu/league``): a
crash-consistent population based training controller.

``python -m d4pg_tpu_torch.league`` supervises N variant learners, each
with its own run dir, fleet port and hyperparameter genome, and runs a
seeded exploit/explore loop over them: stop the worst quartile (SIGTERM,
the learner's exit-75 drain, then a bounded group SIGKILL), fork the
best one's manifest-verified checkpoint, perturb its genome, restart it
with ``--resume`` and gate the clone through attest, observe, then
promote or roll back. Every durable decision is journaled atomically to
``league.json``, so a controller killed with SIGKILL restarts into the
same generation and re-adopts the learners still running. Stdlib only:
importing the package loads no torch.
"""

from d4pg_tpu_torch._lazy import lazy_exports

__getattr__, __dir__ = lazy_exports(
    __name__,
    {
        "LeagueController": "d4pg_tpu_torch.league.controller",
        "LeagueConfig": "d4pg_tpu_torch.league.controller",
        "perturb_genome": "d4pg_tpu_torch.league.controller",
    },
)
