"""Intra-replica parallelism: mesh building, sharding rules, HSDP
composition, pipeline and expert parallelism, the scale rehearsal and
degraded-mode re-lowering.

The port of ``torchft_tpu/parallel/``.  Inside a replica group the
parameters are sharded over a torch ``DeviceMesh`` (FSDP2 ``fully_shard``
and tensor parallelism); the replica (outer-DP) dimension is handled by the
Manager and the communicator and stays off these meshes, so a change of
membership never rebuilds a mesh.  The JAX package's ``parallel/_compat.py``
(a ``shard_map`` shim across JAX versions) has no counterpart here.
"""

_LAZY = {
    "make_mesh": ("torchft_tpu_torch.parallel.mesh", "make_mesh"),
    "MeshAxes": ("torchft_tpu_torch.parallel.mesh", "MeshAxes"),
    "shard_pytree": ("torchft_tpu_torch.parallel.mesh", "shard_pytree"),
    "shard_model": ("torchft_tpu_torch.parallel.hsdp", "shard_model"),
    "HSDPTrainer": ("torchft_tpu_torch.parallel.hsdp", "HSDPTrainer"),
    "pipeline_spmd": ("torchft_tpu_torch.parallel.pipeline", "pipeline_spmd"),
    "PipelinedLlama": ("torchft_tpu_torch.parallel.pipeline", "PipelinedLlama"),
    "MoE": ("torchft_tpu_torch.parallel.moe", "MoE"),
    "rehearse": ("torchft_tpu_torch.parallel.rehearsal", "rehearse"),
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
