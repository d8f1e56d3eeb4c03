"""Device mesh construction for the intra-replica-group axes.

The port of ``torchft_tpu/parallel/mesh.py``.  A replica group owns a set
of ranks (one process each); inside it :func:`make_mesh` builds a torch
``DeviceMesh`` with the JAX package's six axes, in its order:

- ``pp``   — pipeline parallelism (GPipe stages, ``parallel/pipeline.py``)
- ``dp``   — within-group data parallelism (batch dim)
- ``fsdp`` — parameter/optimizer sharding (the FSDP dimension of HSDP)
- ``ep``   — expert parallelism (MoE experts over ``all_to_all``, ``parallel/moe.py``)
- ``sp``   — sequence parallelism (ring attention, ``parallel/ring_attention.py``)
- ``tp``   — tensor (Megatron) parallelism for the matmuls

Size-1 axes are kept, so a submesh is named the same way at any layout.
The outer fault-tolerant replica dimension has no axis here: it runs on
the Manager's ring.  FSDP2 shards over fsdp and sp together, flattened into
one axis (:func:`fsdp_sp_mesh`, torchtitan's ``dp_shard_cp``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@dataclass(frozen=True)
class MeshAxes:
    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def total(self) -> int:
        return self.pp * self.dp * self.fsdp * self.tp * self.sp * self.ep


AXIS_NAMES: Tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")


def make_mesh(
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    sp: int = 1,
    ep: int = 1,
    pp: int = 1,
    ranks: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """Build a mesh with axes (pp, dp, fsdp, ep, sp, tp) over the first
    ``pp·dp·fsdp·ep·sp·tp`` of ``ranks`` (default: every rank of the
    default process group), ``tp`` innermost.  Every rank of the default
    group must call it (the mesh's process groups are made collectively);
    a rank outside the mesh gets one it is not part of.  ``device_type``
    defaults to ``cuda`` under NCCL, else ``cpu``.  Raises when the mesh
    needs more ranks than there are."""
    axes = MeshAxes(pp=pp, dp=dp, fsdp=fsdp, tp=tp, sp=sp, ep=ep)
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    if axes.total > len(ranks):
        raise ValueError(f"mesh needs {axes.total} ranks, only {len(ranks)} available")
    grid = torch.tensor(ranks[: axes.total], dtype=torch.int64).reshape(pp, dp, fsdp, ep, sp, tp)
    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(device_type, grid, mesh_dim_names=AXIS_NAMES)


FSDP_SP = "fsdp_sp"  # the flattened (fsdp, sp) axis of fsdp_sp_mesh


def fsdp_sp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The (fsdp, sp) submesh flattened into one axis named
    :data:`FSDP_SP`: sp ranks see different tokens of the same rows, so
    their gradients combine like those of the data axes.  After this call
    ``mesh["dp", FSDP_SP]`` names the 2-D (replicate, shard) mesh of HSDP
    inside the group.  Every rank of the mesh must call it."""
    return mesh["fsdp", "sp"]._flatten(FSDP_SP)


def mesh_axes(mesh: DeviceMesh) -> MeshAxes:
    """The axis sizes of a mesh built by :func:`make_mesh`."""
    return MeshAxes(**dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))


def named_sharding(mesh: DeviceMesh, *spec: Any) -> Tuple[DeviceMesh, tuple]:
    """A JAX ``PartitionSpec`` as DTensor placements: ``spec[d]`` names the
    mesh axis (or tuple of axes) tensor dim ``d`` is split over, or None.
    Returns the submesh of the named axes and one placement per axis of it
    (``Shard(d)``); an empty spec is replicated over the whole mesh.  A dim
    split over several axes takes them in mesh order, as JAX does."""
    from torch.distributed.tensor import Replicate, Shard

    dims = {}
    for d, axis in enumerate(spec):
        for name in (axis,) if isinstance(axis, str) else tuple(axis or ()):
            dims[name] = d
    names = [n for n in mesh.mesh_dim_names if n in dims]
    if not names:
        return mesh, tuple(Replicate() for _ in mesh.mesh_dim_names)
    sub = mesh[tuple(names)] if len(names) > 1 else mesh[names[0]]
    return sub, tuple(Shard(dims[n]) for n in names)


def shard_pytree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """``distribute_tensor`` every tensor leaf of ``tree`` with its spec
    (``specs`` mirrors ``tree``; a spec is a tuple as in
    :func:`named_sharding`, None replicates)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: shard_pytree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(specs, tuple):
        return type(tree)(shard_pytree(v, s, mesh) for v, s in zip(tree, specs))
    sub, placements = named_sharding(mesh, *(specs or ()))
    return distribute_tensor(tree, sub, placements)
