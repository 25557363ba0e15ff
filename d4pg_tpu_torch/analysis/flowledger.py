"""Conservation ledger: the runtime half of the flow-identity contract
(the port's copy of ``d4pg_tpu/analysis/flowledger.py``).

At drain or close each subsystem registers its counter dict against its
family in the port's own table (``analysis/flow_identities.py``); the
declared identity is evaluated against the live values, and an imbalance
raises :class:`ConservationError` naming the family and the numbers. One
machine-readable ``[flow-verdict]`` JSON line is printed per
registration, so a soak or a smoke script parses the verdict instead of
re-deriving the equations.

Pure stdlib, off by default, and armed by ``--debug-guards`` via
:func:`enable`. When disabled every check is a no-op returning ``None``,
so drain paths cost nothing in production runs. A family the table does
not hold is skipped (``None``), as the JAX ledger skips one its manifest
lacks.
"""

from __future__ import annotations

import ast
import json

_ENABLED = False


class ConservationError(RuntimeError):
    """A declared flow identity did not balance at drain time."""


def enable() -> None:
    """Arm the ledger (called by --debug-guards paths)."""
    global _ENABLED
    _ENABLED = True


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    """Disarm (tests)."""
    global _ENABLED
    _ENABLED = False


def _manifest():
    from d4pg_tpu_torch.analysis.flow_identities import FLOW_IDENTITIES

    return FLOW_IDENTITIES


def _evaluate(identity: str, counters: dict):
    """Evaluate the identity expression with names bound to counter
    values (missing names read 0). Tiny safe evaluator: names, numeric
    constants, ``+``/``-``, and one comparison — nothing else."""
    tree = ast.parse(identity, mode="eval")

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1 or not isinstance(node.ops[0], ast.Eq):
                raise ValueError(f"unsupported identity: {identity!r}")
            return ev(node.left) == ev(node.comparators[0])
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Add, ast.Sub)
        ):
            l, r = ev(node.left), ev(node.right)
            return l + r if isinstance(node.op, ast.Add) else l - r
        if isinstance(node, ast.Name):
            return int(counters.get(node.id, 0))
        if isinstance(node, ast.Constant) and isinstance(
            node.value, (int, float)
        ):
            return node.value
        raise ValueError(f"unsupported identity: {identity!r}")

    return ev(tree)


def _names(identity: str) -> list:
    return sorted(
        {
            n.id
            for n in ast.walk(ast.parse(identity, mode="eval"))
            if isinstance(n, ast.Name)
        }
    )


def _verdict(family: str, where: str, ok: bool, identity: str,
             counters: dict) -> None:
    print(
        "[flow-verdict] "
        + json.dumps(
            {
                "family": family,
                "where": where,
                "ok": bool(ok),
                "identity": identity,
                "counters": {k: int(v) for k, v in sorted(counters.items())},
            },
            sort_keys=True,
        ),
        flush=True,
    )


def check(family: str, counters: dict, where: str = ""):
    """Check one subsystem's counter dict against its declared identity.

    No-op (returns ``None``) unless :func:`enable` armed the ledger.
    Prints the ``[flow-verdict]`` line, returns ``True`` on balance, and
    raises :class:`ConservationError` on imbalance.
    """
    if not _ENABLED:
        return None
    manifest = _manifest()
    if manifest is None or family not in manifest:
        return None
    identity = manifest[family]["identity"]
    ok = bool(_evaluate(identity, counters))
    _verdict(family, where, ok, identity,
             {k: counters.get(k, 0) for k in _names(identity)})
    if not ok:
        shown = {k: int(counters.get(k, 0)) for k in _names(identity)}
        raise ConservationError(
            f"[{family}] conservation identity violated"
            + (f" at {where}" if where else "")
            + f": {identity} with {shown} — an item was consumed without "
            "booking exactly one terminal counter"
        )
    return True


def check_rows(family: str, rows: dict, where: str = ""):
    """Per-row families (tenant rows, league tenure): every row must
    balance. ``rows`` maps row key -> counter dict."""
    if not _ENABLED:
        return None
    manifest = _manifest()
    if manifest is None or family not in manifest:
        return None
    identity = manifest[family]["identity"]
    bad = {}
    for key, counters in sorted(rows.items()):
        if not _evaluate(identity, counters):
            bad[key] = {k: int(counters.get(k, 0)) for k in _names(identity)}
    # one verdict line for the whole table: per-row spam would swamp the
    # soak logs; the counters field carries the row count instead
    _verdict(family, where, not bad, identity,
             {"rows": len(rows), "bad_rows": len(bad)})
    if bad:
        raise ConservationError(
            f"[{family}] conservation identity violated"
            + (f" at {where}" if where else "")
            + f" for {len(bad)} row(s): {identity} with {bad}"
        )
    return True
