"""Degraded-mode re-lowering: keep a wounded replica group contributing.

The port of ``torchft_tpu/parallel/degraded.py``.  When ranks of a replica
group are lost, re-shaping the inner parallelism onto the survivors turns
a cliff-edge fleet shrink into graceful capacity decay.  This module is
the in-group half of that design (the fleet half — capacity-weighted
outer reduce, data-shard rescale — lives in ``manager.py``,
``collectives.py`` and ``data.py``):

1. :func:`plan_surviving` — pick the best tp×fsdp×pp×ep layout for the
   surviving rank count: every factorization of every ``m <= n_surviving``
   (most ranks first, then the most fsdp).  The plan's ``capacity``
   (``devices_used / original_devices``) is what the Manager advertises.
   With a model (``model=``) each candidate is rehearsed
   (``parallel/rehearsal.py``) and the first that rehearses clean wins.
2. :func:`relower_hsdp_trainer` — apply a plan to a live
   :class:`~torchft_tpu_torch.parallel.hsdp.HSDPTrainer`: gather the state
   over the old mesh while every rank lives, build the mesh on the
   survivors, and redistribute the parameters and the AdamW state there.
   Values are moved, never recomputed.  Call between
   ``Manager.begin_relower()`` and ``Manager.complete_relower(capacity)``
   (``HSDPTrainer.relower`` does) so a crash mid-reshard never votes
   commit.  Degraded capacity needs the Python control plane: the C++
   sidecar advertises none, and ``complete_relower`` refuses there.

A rank here plays the part a device plays in the JAX package: the
"devices" of these functions are the ranks of the group's process group.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)

# Axes a degraded re-lower may redistribute over, innermost-preference
# order: fsdp first (parameter sharding buys back the memory the lost rank
# held), then tp, then ep/pp.
RELOWER_AXES: Tuple[str, ...] = ("fsdp", "tp", "ep", "pp")


@dataclass(frozen=True)
class DegradedPlan:
    """One surviving-rank layout: the mesh axes to re-lower onto, how many
    ranks it uses, and the capacity fraction to advertise."""

    mesh_axes: Dict[str, int] = field(default_factory=dict)
    devices_used: int = 0
    original_devices: int = 0
    report: Optional[Any] = None  # the rehearsal report of a model-backed plan

    @property
    def capacity(self) -> float:
        if self.original_devices <= 0:
            return 1.0
        return self.devices_used / self.original_devices


def _factorizations(m: int, axes: Sequence[str]) -> List[Dict[str, int]]:
    """Every assignment of factors of ``m`` to ``axes`` (product == m)."""
    if not axes:
        return [{}] if m == 1 else []
    head, rest = axes[0], axes[1:]
    out: List[Dict[str, int]] = []
    f = 1
    while f <= m:
        if m % f == 0:
            for tail in _factorizations(m // f, rest):
                out.append({head: f, **tail})
        f += 1
    return out


def surviving_layouts(
    n_surviving: int, axes: Sequence[str] = RELOWER_AXES
) -> List[Dict[str, int]]:
    """Candidate layouts for a wounded group, best-first: most ranks used,
    then the most fsdp, then the most tp, then the flattest split.
    Deterministic — every observer ranks the same plan first."""
    candidates: List[Dict[str, int]] = []
    for m in range(n_surviving, 0, -1):
        candidates.extend(_factorizations(m, axes))

    def _key(layout: Dict[str, int]) -> tuple:
        used = 1
        for v in layout.values():
            used *= v
        return (
            -used,
            -layout.get("fsdp", 1),
            -layout.get("tp", 1),
            tuple(sorted(layout.items())),
        )

    return sorted(candidates, key=_key)


def plan_surviving(
    n_surviving: int,
    original_devices: int,
    model: Any = None,
    optimizer: Any = None,
    batch: int = 8,
    seq: int = 2048,
    chip: str = "h100",
    axes: Sequence[str] = RELOWER_AXES,
    lower: bool = False,
) -> DegradedPlan:
    """Pick the best layout for ``n_surviving`` of ``original_devices``
    ranks.  Without a model the structural ranking alone decides.  With a
    ``model`` (built on ``meta``; ``optimizer`` builds its optimizer,
    default ``hsdp.adamw()``), each candidate is rehearsed through
    :func:`~torchft_tpu_torch.parallel.rehearsal.rehearse` — what the
    port's layout cannot take and the memory per card must pass (and the
    lowering with ``lower=True``) — and the first that rehearses clean
    wins.  Raises ``RuntimeError`` when none does: the replica should then
    die normally rather than train on a layout that cannot hold it."""
    if n_surviving < 1:
        raise ValueError(f"no surviving devices to re-lower onto ({n_surviving})")
    if n_surviving > original_devices:
        raise ValueError(
            f"survivors ({n_surviving}) exceed the original device count "
            f"({original_devices})"
        )
    candidates = surviving_layouts(n_surviving, axes)
    if model is None:
        layout = candidates[0]
        return DegradedPlan(mesh_axes=dict(layout), devices_used=_used(layout),
                            original_devices=original_devices)
    from torchft_tpu_torch.parallel.rehearsal import rehearse

    last_report = None
    for layout in candidates:
        used = _used(layout)
        report = rehearse(model, optimizer, dict(layout), batch=batch, seq=seq,
                          name=f"degraded_{used}of{original_devices}", chip=chip, lower=lower)
        last_report = report
        if report.ok:
            return DegradedPlan(mesh_axes=dict(layout), devices_used=used,
                                original_devices=original_devices, report=report)
    raise RuntimeError(
        "no surviving-device layout rehearses clean for "
        f"{n_surviving}/{original_devices} devices (last: "
        f"{last_report.summary() if last_report else 'none'})"
    )


def _used(layout: Dict[str, int]) -> int:
    used = 1
    for v in layout.values():
        used *= v
    return used


def chaos_device_loss() -> int:
    """How many of this group's ranks "died" before startup, from
    ``TORCHFT_CHAOS_DEVICE_LOSS`` in the group's spawn env (0 when unset —
    the normal case)."""
    from torchft_tpu_torch import knobs

    return max(0, knobs.get_int("TORCHFT_CHAOS_DEVICE_LOSS", 0))


def startup_surviving_devices(devices: Sequence[Any]) -> List[Any]:
    """Apply the device-loss chaos knob at startup: the last N ranks (or
    devices) are treated as dead (at least one always survives).  A group
    that builds its mesh from this list comes up wounded and should plan
    via :func:`plan_surviving` and advertise ``plan.capacity``."""
    lost = chaos_device_loss()
    devices = list(devices)
    if lost <= 0:
        return devices
    survivors = max(1, len(devices) - lost)
    logger.warning(
        "chaos: %d of %d devices lost before startup — coming up wounded",
        len(devices) - survivors,
        len(devices),
    )
    return devices[:survivors]


def _full(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a (possibly distributed) tensor; every rank of
    its mesh must call it."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _place(full: torch.Tensor, like: torch.Tensor) -> None:
    """Write ``full`` into ``like``'s placement: the local shard of a
    DTensor, the whole tensor otherwise."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    with torch.no_grad():
        if isinstance(like, DTensor):
            shard = distribute_tensor(
                full.to(like.device), like.device_mesh, like.placements
            ).to_local()
            like.to_local().copy_(shard)
        else:
            like.copy_(full)


def reshard_params(params: Dict[str, torch.Tensor], model: Any) -> None:
    """Write a gathered parameter dict (``name → full tensor``) into the
    placements of ``model``'s parameters — the reshard half of a re-lower.
    Values are moved, never recomputed."""
    for name, p in model.named_parameters():
        _place(params[name], p)


def _reshard_opt_state(opt_state: Dict[str, Dict[str, torch.Tensor]], trainer: Any) -> None:
    """Write a gathered AdamW state (``name → {step, exp_avg,
    exp_avg_sq}``) into the trainer's new optimizer: the moments take
    their parameter's placement (``hsdp.sharded_opt_init`` pinned them
    there), the step counts stay whole."""
    live = trainer.opt_state()
    for name, state in opt_state.items():
        for key, value in state.items():
            _place(value, live[name][key])


def relower_hsdp_trainer(
    trainer: Any,
    surviving_devices: Sequence[int],
    plan: Optional[DegradedPlan] = None,
) -> DegradedPlan:
    """Re-lower a live HSDP trainer onto the ranks ``surviving_devices``.

    Every rank of the old mesh calls it (the gather and the new mesh's
    process groups are collectives of the old group).  The ranks the plan
    uses end with the new mesh, a rebuilt model (``trainer.model_fn``) and
    optimizer holding exactly the old values; the others end with
    ``trainer.active`` False and leave their train loop.  Sequencing
    contract: ``manager.begin_relower()`` first and
    ``manager.complete_relower(plan.capacity)`` after this returns, on the
    ranks that stay."""
    from torchft_tpu_torch.parallel.hsdp import shard_model
    from torchft_tpu_torch.parallel.mesh import make_mesh

    original = int(trainer.mesh.mesh.numel())
    if plan is None:
        plan = plan_surviving(len(surviving_devices), original_devices=original)
    if plan.devices_used > len(surviving_devices):
        raise ValueError(
            f"plan needs {plan.devices_used} devices, only {len(surviving_devices)} survive"
        )
    # gather within the old group while every rank still lives
    params = {n: _full(p.detach()) for n, p in trainer.params.items()}
    opt_state = {
        n: {k: _full(v) for k, v in s.items()} for n, s in trainer.opt_state().items()
    }
    ranks = list(surviving_devices)[: plan.devices_used]
    new_mesh = make_mesh(ranks=ranks, **plan.mesh_axes)
    if new_mesh.get_coordinate() is None:
        trainer.deactivate()
        logger.warning("re-lowered out of the group: this rank leaves its loop")
        return plan
    model = trainer.model_fn()
    shard_model(model, new_mesh)
    reshard_params(params, model)
    trainer.rebuild(model, new_mesh)
    _reshard_opt_state(opt_state, trainer)
    logger.warning(
        "re-lowered onto %d/%d ranks (%s) — capacity %.3f",
        plan.devices_used,
        plan.original_devices or original,
        plan.mesh_axes,
        plan.capacity,
    )
    return plan
