"""The port's flow identities: for each counter family, the conservation
identity its books must satisfy at drain time (the port's own table; the
JAX package's lives in ``tools/d4pglint/wholeprog/config.py:
FLOW_IDENTITIES``, which the port does not import).

Only the families of ported modules are here:

- ``serve-stats``, the policy server's (``serve/stats.py:ServeStats``):
  every admitted request ends as exactly one of a reply, a shed of one
  of three kinds, or is still in flight;
- ``fleet-actor``, a fleet actor host's (``fleet/actor.py:FleetActor``,
  checked at its drain): every window it emitted was acknowledged,
  answered stale, shed, dropped at a disconnect, dropped by the full
  spool, or is still spooled;
- ``fleet-ingest``, the learner's ingest (``fleet/ingest.py:
  IngestServer``, checked at its close): the ingested windows split
  exactly into the collection fleet's and the mirror tap's;
- ``mirror-tap``, the flywheel's tap (``flywheel/tap.py:MirrorTap``,
  checked at its close): every window it built was acknowledged, answered
  stale, shed, dropped by chaos, by a missing link or by the full queue,
  or is still pending;
- ``router``, ``router-gate`` and ``router-tenant``, the replicated front
  end's (``serve/router.py:RouterStats``, checked at the router's drain):
  every request the router counted was answered ok, overloaded or with an
  error; every off-policy gate evaluation passed, blocked or stalled; and
  both hold row by row for each (tenant, class);
- ``league-tenure``, the league controller's (``league/controller.py``,
  checked row by row in its summary): every process tenure of a variant
  (spawned or adopted) ended as exactly one of exit 0, exit 75, an error
  exit or a kill, or is still live.

An identity is one ``==`` between sums and differences of counter names
and numeric constants (``flowledger._evaluate``); ``per_row`` families
are checked row by row (``flowledger.check_rows``).
"""

from __future__ import annotations

FLOW_IDENTITIES = {
    "serve-stats": {
        "class": "d4pg_tpu_torch/serve/stats.py::ServeStats",
        "identity": (
            "requests_total == replies_ok + shed_queue_full"
            " + shed_deadline + shed_draining + inflight"
        ),
        "gauges": ("inflight",),
    },
    "fleet-actor": {
        "class": "d4pg_tpu_torch/fleet/actor.py::FleetActor",
        "identity": (
            "windows_emitted == windows_acked + windows_stale"
            " + windows_shed + windows_dropped_reconnect"
            " + windows_dropped_spool + spool_depth"
        ),
        "gauges": (),
    },
    "fleet-ingest": {
        "class": "d4pg_tpu_torch/fleet/ingest.py::IngestServer",
        "identity": "windows_from_actors + windows_from_mirror == windows_ingested",
        "gauges": (),
    },
    "mirror-tap": {
        "class": "d4pg_tpu_torch/flywheel/tap.py::MirrorTap",
        "identity": (
            "windows_built == windows_acked + windows_stale + windows_shed"
            " + windows_dropped_chaos + windows_dropped_link"
            " + windows_dropped_full + pending"
        ),
        "gauges": (),
    },
    "router": {
        "class": "d4pg_tpu_torch/serve/router.py::RouterStats",
        "identity": (
            "requests_total == replies_ok + replies_overloaded"
            " + replies_error"
        ),
        "gauges": (),
    },
    "router-gate": {
        "class": "d4pg_tpu_torch/serve/router.py::RouterStats",
        "identity": (
            "gate_evaluations == gate_pass + gate_block + gate_stalls"
        ),
        "gauges": (),
    },
    "router-tenant": {
        "class": None,  # per-row: RouterStats.tenants_snapshot() rows
        "identity": "requests == ok + overloaded + error",
        "gauges": (),
        "per_row": True,
    },
    "league-tenure": {
        "class": None,  # per-row: the league controller's per-uid dicts
        "identity": (
            "spawned + adopted == exited_0 + exited_75 + exited_err"
            " + killed + live"
        ),
        "gauges": (),
        "per_row": True,
    },
}
