"""Data and tensor parallelism over lanes (counterpart of
``d4pg_tpu/parallel``).

``mesh`` lays ``dp × tp`` lanes over the processes, ``distributed``
brings up ``torch.distributed`` and carries the exact gathers, ``dp``
holds the fixed-order mean and the host-path dp steps, ``partition`` the
JAX rule tables, the shard and gather fns and the TP step, ``tp`` the
Megatron forward and the sharded train state. The striped replay layout
is ``replay/device_ring.py:striped_perm``.
"""

from d4pg_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "Mesh": "d4pg_tpu_torch.parallel.mesh",
    "make_mesh": "d4pg_tpu_torch.parallel.mesh",
    "LaneSync": "d4pg_tpu_torch.parallel.dp",
    "det_pmean": "d4pg_tpu_torch.parallel.dp",
    "make_dp_train_step": "d4pg_tpu_torch.parallel.dp",
    "make_dp_fused_train_step": "d4pg_tpu_torch.parallel.dp",
    "make_hogwild_dp_train_step": "d4pg_tpu_torch.parallel.dp",
    "replicate": "d4pg_tpu_torch.parallel.dp",
    "DEFAULT_RULES": "d4pg_tpu_torch.parallel.partition",
    "auto_parallel_train_step": "d4pg_tpu_torch.parallel.partition",
    "explain_partition_rules": "d4pg_tpu_torch.parallel.partition",
    "match_partition_rules": "d4pg_tpu_torch.parallel.partition",
    "shard_batch": "d4pg_tpu_torch.parallel.partition",
    "shard_train_state": "d4pg_tpu_torch.parallel.partition",
    "stack_axes_for": "d4pg_tpu_torch.parallel.partition",
    "TPTrainState": "d4pg_tpu_torch.parallel.tp",
    "initialize_distributed": "d4pg_tpu_torch.parallel.distributed",
    "gather_global": "d4pg_tpu_torch.parallel.distributed",
    "host_allgather_i64": "d4pg_tpu_torch.parallel.distributed",
    "local_shard_span": "d4pg_tpu_torch.parallel.distributed",
}

__getattr__, __dir__ = lazy_exports(__name__, _EXPORTS)
__all__ = sorted(_EXPORTS)
