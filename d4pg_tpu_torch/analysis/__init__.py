"""Runtime guards for the port's data plane (``--debug-guards``; the port's
counterpart of ``d4pg_tpu/analysis``).

- :class:`~d4pg_tpu_torch.analysis.ledger.StagingLedger`: generation-tagged
  rotated host staging slots; a write while a consumer still holds the
  slot raises naming slot and holder (PER ``sample_block``, the host actor
  pool's replies, the serving batcher's input slots).
- :func:`~d4pg_tpu_torch.analysis.transfer.no_implicit_transfers`: a
  CPU tensor among a dispatch's device operands raises, checked once on
  entry; :func:`~d4pg_tpu_torch.analysis.transfer.no_transfers` (the
  zero-transfer budget) adds
  :func:`~d4pg_tpu_torch.analysis.transfer.sync_debug_error`, under which
  a host synchronisation inside the dispatch raises.
- ``lockwitness``: the runtime nesting of every named lock, checked at
  close and drain against the port's committed lock graph.
- ``flowledger``: the conservation identities of the port's counter
  families (``flow_identities.py``), checked at drain.

- :class:`~d4pg_tpu_torch.analysis.recompile.RecompileSentinel`: the
  specializations of every compiled program (``utils/graphs.py``: one
  CUDA graph a specialization on the card) against a budget, checked at
  eval crossings, at the end of ``train()`` and at the serve drain; an
  entry over budget raises
  :class:`~d4pg_tpu_torch.analysis.recompile.RecompileBudgetError`.

The package imports no torch: ``ledger`` and ``lockwitness`` ride into
the host actor pool's module, which spawned workers import; hence the
lazy re-exports.
"""

from __future__ import annotations

from d4pg_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "StagingLedger": "d4pg_tpu_torch.analysis.ledger",
    "StagingReuseError": "d4pg_tpu_torch.analysis.ledger",
    "Hold": "d4pg_tpu_torch.analysis.ledger",
    "NULL_LEDGER": "d4pg_tpu_torch.analysis.ledger",
    "TransferGuardError": "d4pg_tpu_torch.analysis.transfer",
    "no_implicit_transfers": "d4pg_tpu_torch.analysis.transfer",
    "no_transfers": "d4pg_tpu_torch.analysis.transfer",
    "explicit_transfer": "d4pg_tpu_torch.analysis.transfer",
    "sync_debug_error": "d4pg_tpu_torch.analysis.transfer",
    "ConservationError": "d4pg_tpu_torch.analysis.flowledger",
    "LockOrderWitnessError": "d4pg_tpu_torch.analysis.lockwitness",
    "RecompileSentinel": "d4pg_tpu_torch.analysis.recompile",
    "RecompileBudgetError": "d4pg_tpu_torch.analysis.recompile",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)

__all__ = sorted(_EXPORTS)
