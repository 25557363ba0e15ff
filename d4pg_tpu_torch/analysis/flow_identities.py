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
  exactly into the collection fleet's and the mirror tap's.

The JAX table's other families (``mirror-tap``, ``router``,
``router-gate``, ``router-tenant``, ``league-tenure``) belong to modules
not ported yet (ROADMAP A11 (e3)-(e5)) and come with them.

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
}
