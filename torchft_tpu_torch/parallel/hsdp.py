"""HSDP composition: FSDP2 and tensor parallelism inside a replica group ×
fault-tolerant DDP across groups.

The port of ``torchft_tpu/parallel/hsdp.py``, in torchft's own layout
(torchtitan's): one process per rank, one Manager per rank
(``rank=group_rank``, ``world_size=group_world_size``).

- **inner**: :func:`shard_model` applies the model's tensor-parallel plan
  over the mesh's ``tp`` axis, then ``fully_shard`` (FSDP2) on every
  ``LlamaLayer`` and on the root over the (dp, fsdp·sp) submesh:
  parameters, gradients and AdamW's moments are DTensors, and the backward
  pass reduce-scatters (and averages) the gradients over (dp, fsdp·sp)
  inside the group.  The f32 RMSNorm weights stay whole on every rank
  (FSDP2 takes one dtype per unit, and the matrices are bf16); the grad
  step averages their gradients over (dp, fsdp, sp) itself.
- **sequence parallelism**: sp ranks hold different blocks of the same
  rows (ring attention over the sp axis), so their gradients combine like
  those of the data axes, and FSDP2 shards over fsdp and sp together
  (torchtitan's ``dp_shard_cp``).  The JAX package replicates the
  parameters over sp instead; the numbers are the same, the memory layout
  differs.
- **outer**: the Manager averages each rank's local gradient shard with
  the same rank of every other group (``ddp.ft_allreduce`` on DTensor
  gradients): rank r of every group holds the same region, so the
  shard-local average is exact and no rank assembles a whole tensor.
  The replica count never enters the inner mesh, so a change of
  membership rebuilds nothing.

The gradient FSDP leaves is the mean over (dp, fsdp, sp) of each rank's
local-block mean; it equals the JAX grad step's global-batch mean when
every rank holds an equal share of the tokens, so the batch must divide by
dp·fsdp and the sequence by sp (:func:`local_rows` raises otherwise).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from torchft_tpu_torch.ddp import _local, ft_allreduce, restore_tree_like
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.obs.spans import device_fence
from torchft_tpu_torch.parallel.mesh import FSDP_SP, fsdp_sp_mesh, mesh_axes

Optimizer = torch.optim.Optimizer
OptimizerFn = Callable[[Iterable[nn.Parameter]], Optimizer]


def placement_groups(params: Iterable[nn.Parameter]) -> List[Dict[str, Any]]:
    """``params`` as optimizer parameter groups, one per placement: the
    DTensors of each mesh (FSDP2's, an ep split's) and the plain tensors
    apart.  The CUDA optimizers' foreach kernels take one kind per call,
    and an MoE puts plain bf16 experts beside FSDP2's bf16 DTensors."""
    from torch.distributed.tensor import DTensor

    groups: Dict[Any, List[nn.Parameter]] = {}
    for p in params:
        key = tuple(p.device_mesh.mesh_dim_names) if isinstance(p, DTensor) else None
        groups.setdefault(key, []).append(p)
    return [{"params": ps} for ps in groups.values()]


def adamw(lr: float = 1e-3) -> OptimizerFn:
    """``torch.optim.AdamW`` with ``optax.adamw``'s defaults (torch's
    default weight decay of 1e-2 differs from optax's 1e-4), over
    :func:`placement_groups`."""

    def make(params: Iterable[nn.Parameter]) -> Optimizer:
        return torch.optim.AdamW(placement_groups(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)

    return make


def fsdp_mesh(mesh: Any) -> Any:
    """The submesh FSDP2 shards over: ``fsdp`` (with sp > 1 the flattened
    (fsdp, sp) axis, :func:`~.mesh.fsdp_sp_mesh`), and with dp > 1 the 2-D
    mesh of dp and that axis — replicated over dp, sharded over the other
    (HSDP inside the group).  Every rank of the mesh must call it."""
    axes = mesh_axes(mesh)
    if axes.sp > 1:
        flat = fsdp_sp_mesh(mesh)
        return mesh["dp", FSDP_SP] if axes.dp > 1 else flat
    return mesh["dp", "fsdp"] if axes.dp > 1 else mesh["fsdp"]


def shard_model(model: Any, mesh: Any) -> Any:
    """Shard ``model`` (a :class:`~torchft_tpu_torch.models.llama.Llama`,
    ``LlamaMoE`` or ``PipelinedLlama``) in place onto ``mesh``: with
    pp > 1 this rank keeps its stage's layers (a ``PipelinedLlama``); with
    ep > 1 each MoE splits its experts over ep (``Shard(0)``, the JAX
    ``MoE.param_specs``); the tensor-parallel plan over ``tp`` (when
    tp > 1), then FSDP2 on each layer and the root over
    :func:`fsdp_mesh`.  A model with ``config.sp_axis`` runs its ring
    attention over this mesh's sp axis.  Returns the model."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor.parallel import parallelize_module

    axes = mesh_axes(mesh)
    if axes.pp > 1:
        if not hasattr(model, "keep_stage"):
            raise ValueError(f"the mesh splits the layers over pp = {axes.pp}, but "
                             f"{type(model).__name__} is not pipelined (use PipelinedLlama)")
        model.keep_stage(mesh)
    if axes.ep > 1:
        if not hasattr(model, "moe_layers"):
            raise ValueError(f"the mesh splits experts over ep = {axes.ep}, but "
                             f"{type(model).__name__} has no MoE layers (use LlamaMoE)")
        for moe in model.moe_layers():
            moe.split_experts(mesh["ep"])
    if axes.sp > 1 and model.config.sp_axis != "sp":
        raise ValueError(
            f"the mesh splits the sequence over sp = {axes.sp}, but the model's sp_axis is "
            f"{model.config.sp_axis!r} (set it to 'sp')"
        )
    if model.config.sp_axis is not None:
        model.mesh = mesh
    if axes.tp > 1:
        tp_mesh = mesh["tp"]
        model.shard_embed(tp_mesh)
        parallelize_module(model, tp_mesh, model.param_specs(axes.tp))
    inner = fsdp_mesh(mesh)
    # FSDP2 takes one dtype per unit, and the norms are f32 beside bf16
    # weights: they stay whole on every rank, as do the MoE's router (f32)
    # and experts (replicated over fsdp in the JAX specs); make_grad_step
    # averages their gradients over the group
    whole = set(whole_params(model))
    for layer in model.blocks():
        fully_shard(layer, mesh=inner, ignored_params=whole)
    fully_shard(model, mesh=inner, ignored_params=whole)
    return model


def whole_params(model: Any) -> List[nn.Parameter]:
    """The parameters FSDP2 leaves whole on every rank of the fsdp axis:
    the RMSNorm weights (f32 beside the bf16 matrices) and the MoE's
    router and experts (the experts split over ep only)."""
    return [p for n, p in model.named_parameters() if n.endswith("norm") or ".moe." in n]


def shard_init(model_fn: Callable[[], Any], mesh: Any) -> Any:
    """Build a model (``model_fn()``, on the mesh's device) and shard it."""
    return shard_model(model_fn(), mesh)


def local_rows(mesh: Any, batch: torch.Tensor, spec: Tuple[Any, ...]) -> torch.Tensor:
    """This rank's block of a global batch, split as ``spec`` (one entry of
    ``Llama.batch_specs``) says: dimension d over the mesh axes ``spec[d]``
    names (rows over (dp, fsdp), the sequence over sp), replicated over the
    other axes."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for d, axes in enumerate(spec):
        names = (axes,) if isinstance(axes, str) else tuple(axes or ())
        n, idx = 1, 0
        for name in names:
            n, idx = n * sizes[name], idx * sizes[name] + coord[name]
        if batch.shape[d] % n:
            raise ValueError(
                f"dimension {d} of {batch.shape[d]} does not split over {'·'.join(names)} = {n}")
        per = batch.shape[d] // n
        batch = batch.narrow(d, idx * per, per)
    return batch


# the axes whose ranks hold different tokens: their gradients and losses
# are averaged over the group
DATA_AXES = ("dp", "fsdp", "sp")


def group_mean(mesh: Any, value: torch.Tensor) -> torch.Tensor:
    """Mean of ``value`` over the (dp, fsdp, sp) ranks of ``mesh`` (every
    rank of it must call)."""
    axes = mesh_axes(mesh)
    out = value.detach().clone()
    n = 1
    for name in DATA_AXES:
        if getattr(axes, name) > 1:
            dist.all_reduce(out, group=mesh[name].get_group())
            n *= getattr(axes, name)
    return out / n


def make_grad_step(model: Any, mesh: Any) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(tokens, targets) → loss``: forward and backward on this rank's
    block of the global batch, gradients left in ``.grad`` as DTensors
    sharded like the parameters (FSDP2 reduce-scatters them inside the
    backward); the loss returned is the global-batch mean.  The gradients
    of the parameters the layout replicates over the data axes (the
    norms, the MoE's router and experts) are averaged over them here; with
    pp > 1 the embedding's, which only stage 0 computes, is summed over
    pp."""

    whole = whole_params(model)
    specs = model.batch_specs()
    axes = mesh_axes(mesh)
    embed_pp = mesh["pp"].get_group() if axes.pp > 1 else None

    def step(tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        loss = model.loss(local_rows(mesh, tokens, specs[0]), local_rows(mesh, targets, specs[1]))
        loss.backward()
        for p in whole:
            if p.grad is not None:
                g = _local(p.grad)
                g.copy_(group_mean(mesh, g))
        if embed_pp is not None:
            embed = model.embed
            if embed.grad is None:
                embed.grad = torch.zeros_like(embed)
            dist.all_reduce(_local(embed.grad), group=embed_pp)
        return group_mean(mesh, loss)

    return step


def sharded_opt_init(optimizer: Optimizer) -> Optimizer:
    """Create AdamW's state up front, each moment ``zeros_like`` its
    parameter — so it has the parameter's placement — and the step counts
    whole (torch creates the state lazily at the first step; a heal needs
    it to exist to load into)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if not optimizer.state[p]:
                optimizer.state[p] = {
                    "step": torch.tensor(0.0),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }
    return optimizer


class HSDPTrainer:
    """Fault-tolerant HSDP training driver (the JAX package's BASELINE
    config 3).

    Per step (``train_step``): ``start_quorum`` → forward and backward on
    this rank's rows (FSDP's reduce-scatter inside the group) →
    ``ft_allreduce`` of the local gradient shards across groups →
    ``should_commit`` → the optimizer step only if committed.

    ``tx`` builds the optimizer from the parameters (:func:`adamw`);
    ``model_fn`` builds a fresh unsharded model, which :meth:`relower`
    needs.  The trainer registers its state as ``"hsdp"`` with the
    Manager: a healing rank loads the source rank's local shards in place
    (``ddp.restore_tree_like``)."""

    def __init__(
        self,
        model: Any,
        tx: OptimizerFn,
        mesh: Any,
        manager: Manager,
        quantize_outer: bool = False,
        model_fn: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.tx = tx
        self.manager = manager
        self.quantize_outer = quantize_outer
        self.model_fn = model_fn
        self.active = True
        self.rebuild(shard_model(model, mesh), mesh)
        manager.register_state_dict_fn("hsdp", self._load_state, self._save_state)

    def rebuild(self, model: Any, mesh: Any) -> None:
        """Adopt a sharded ``model`` on ``mesh`` with a fresh optimizer."""
        self.model, self.mesh = model, mesh
        # the sharded parameters, held here: during a forward FSDP2 swaps
        # the module's attributes for unsharded tensors, and a heal source
        # serves its state from the quorum thread while the step runs
        self.params: Dict[str, nn.Parameter] = dict(model.named_parameters())
        self.optimizer = sharded_opt_init(self.tx(self.params.values()))
        self._grad_step = make_grad_step(model, mesh)
        # the update step: AdamW over the sharded parameters and state
        self._update_step = self.optimizer.step

    def _shard_grads(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(gradients of the sharded parameters, of the whole ones)."""
        from torch.distributed.tensor import DTensor

        grads: Tuple[List[torch.Tensor], List[torch.Tensor]] = ([], [])
        for p in self.params.values():
            if p.grad is not None:
                grads[not isinstance(p, DTensor)].append(p.grad)
        return grads

    def deactivate(self) -> None:
        """This rank left the group's mesh (a re-lower did not keep it)."""
        self.active = False

    def opt_state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """AdamW's state per parameter name (``step``, ``exp_avg``,
        ``exp_avg_sq``), the live tensors."""
        return {n: self.optimizer.state[p] for n, p in self.params.items()}

    def _save_state(self) -> Dict[str, Any]:
        return {
            "params": {n: p.detach() for n, p in self.params.items()},
            "opt_state": self.opt_state(),
        }

    def _load_state(self, state: Dict[str, Any]) -> None:
        restore_tree_like(state["params"], self.params)
        restore_tree_like(state["opt_state"], self.opt_state())

    def relower(self, surviving_devices: Any, plan: Any = None) -> Any:
        """Degraded-mode re-lower onto the surviving ranks: every rank of
        the old mesh calls it; the commit vote is fenced across the
        transition by ``Manager.begin_relower`` / ``complete_relower``
        (the latter on the ranks that stay).  Returns the applied
        :class:`~torchft_tpu_torch.parallel.degraded.DegradedPlan`."""
        from torchft_tpu_torch.parallel.degraded import relower_hsdp_trainer

        self.manager.begin_relower()
        plan = relower_hsdp_trainer(self, surviving_devices, plan)
        if self.active:
            self.manager.complete_relower(plan.capacity)
        return plan

    def train_step(
        self,
        tokens: torch.Tensor,
        targets: torch.Tensor,
        phases: Optional[List[Dict[str, float]]] = None,
    ) -> Tuple[float, bool]:
        """One fault-tolerant step on a global batch; returns (loss,
        committed).  With ``phases`` given, appends the step's wall seconds
        in ``compute`` (forward and backward, the quorum overlapping it),
        ``allreduce`` (the outer average of the local shards) and
        ``commit`` (the vote and the optimizer step), fenced with device
        synchronizes."""
        fence = device_fence(tokens.device) if phases is not None else None
        marks = [fence()] if fence else []
        self.manager.start_quorum()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._grad_step(tokens, targets)
        if fence:
            marks.append(fence())
        # the local shards, then the whole (replicated) parameters in a
        # collective of their own: at one offset on every rank of the group
        # they are averaged alike on each rank's ring, also through the
        # quantized wire's rows and a ring's summation order
        for grads in self._shard_grads():
            if grads:
                ft_allreduce(self.manager, grads, should_quantize=self.quantize_outer)
        if fence:
            marks.append(fence())
        committed = self.manager.should_commit()
        if committed:
            self._update_step()
        if fence:
            marks.append(fence())
            phases.append(
                {k: b - a for k, a, b in zip(("compute", "allreduce", "commit"), marks, marks[1:])}
            )
        return float(loss), committed

