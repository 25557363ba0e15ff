"""The port's flow identities: for each counter family, the conservation
identity its books must satisfy at drain time (the port's own table; the
JAX package's lives in ``tools/d4pglint/wholeprog/config.py:
FLOW_IDENTITIES``, which the port does not import).

Only the families of ported modules are here. ``serve-stats`` is the
policy server's (``serve/stats.py:ServeStats``): every admitted request
ends as exactly one of a reply, a shed of one of three kinds, or is still
in flight. The JAX table's other families (``fleet-actor``,
``mirror-tap``, ``fleet-ingest``, ``router``, ``router-gate``,
``router-tenant``, ``league-tenure``) belong to modules not ported yet
(ROADMAP A11 (e2)-(e5)) and come with them.

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
}
