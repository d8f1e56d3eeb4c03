"""Pipeline parallelism: GPipe microbatching over the ``pp`` mesh axis.

The port of ``torchft_tpu/parallel/pipeline.py``.  The JAX engine is one
SPMD program: a ``lax.scan`` over ``M + P − 1`` ticks in which every stage
runs every tick (the bubble ticks on garbage, their outputs thrown away),
activations hop stages by ``lax.ppermute``, and reverse-mode AD through
the scan gives the mirrored backward pipeline.  The port keeps that design
— one schedule, autograd through the hops, no hand-written 1F1B runtime —
and runs only the live ticks: stage j applies its layers to microbatches
0 … M−1 in order (ticks j … j+M−1), so every hop feeds an output that is
used and every hop's backward runs on both of its sides.

:func:`pipeline_spmd` takes the hop as a parameter:

- ``group=None``: every stage in this process, a hop hands the tensor to
  the next stage (:class:`LocalHop`; what ``chip_smoke.py`` runs on one
  card);
- a process group over the pp ranks: this rank runs its own stage and a
  hop is a point-to-point send to the next rank (:class:`P2PHop`), an
  autograd function whose backward receives the cotangent back.

The last stage's outputs then reach every stage (the JAX ``psum``), and
every stage computes the head and the loss.  That hand-off's backward
hands the last stage its own cotangent, once, and ties the other stages'
sends into their graph so that their backward receives.  The embedding
is used on stage 0 only; ``parallel/hsdp.py:make_grad_step`` sums its
gradient over pp.

Bubble math: utilization = M / (M + P − 1) for M microbatches over P
stages — M ≥ 4·P gives over 80%.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from torchft_tpu_torch.models.llama import Llama, LlamaConfig, rms_norm

StageFn = Callable[[int, torch.Tensor], torch.Tensor]


class LocalHop:
    """Every stage in this process: a hop hands the tensor on, in order."""

    def __init__(self) -> None:
        self._held: dict = {}

    def stages(self, num_stages: int) -> Sequence[int]:
        return range(num_stages)

    def send(self, stage: int, y: torch.Tensor) -> None:
        self._held.setdefault(stage + 1, []).append(y)

    def recv(self, stage: int, like: torch.Tensor) -> torch.Tensor:
        return self._held[stage].pop(0)

    def finish(self, outputs: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        return torch.cat(outputs)


class _Send(torch.autograd.Function):
    """Send y to ``dst``; returns a 0-d token for the graph.  The backward
    receives y's cotangent from ``dst``."""

    @staticmethod
    def forward(ctx, y, group, dst):
        ctx.group, ctx.dst, ctx.like = group, dst, (y.shape, y.dtype, y.device)
        dist.send(y.contiguous(), dst, group=group)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _token):
        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, ctx.dst, group=ctx.group)
        return g, None, None


class _Recv(torch.autograd.Function):
    """Receive a tensor like ``like`` from ``src`` (``anchor`` only puts the
    result in the graph).  The backward sends its cotangent back to
    ``src``."""

    @staticmethod
    def forward(ctx, anchor, group, src, like):
        ctx.group, ctx.src = group, src
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        dist.recv(out, src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.src, group=ctx.group)
        return torch.zeros((), device=g.device), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every stage of ``group`` (a broadcast).
    Every stage computes the same loss from them, so the last stage's
    backward passes its own cotangent, once; the other stages' input is
    the sum of their send tokens, whose zero cotangent makes each send's
    backward run."""

    @staticmethod
    def forward(ctx, src, group, root, like, is_last):
        ctx.is_last = is_last
        out = (src.contiguous().clone() if is_last
               else torch.empty(like.shape, dtype=like.dtype, device=like.device))
        dist.broadcast(out, root, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_last else torch.zeros((), device=g.device)), None, None, None, None


class P2PHop:
    """One stage per rank of the pp process group ``group``: a hop is a
    send to the next rank and a receive from the previous one."""

    def __init__(self, group: Any) -> None:
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._tokens: List[torch.Tensor] = []

    def _global(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def stages(self, num_stages: int) -> Sequence[int]:
        if num_stages != self.size:
            raise ValueError(f"{num_stages} stages over a pp group of {self.size} ranks")
        return [self.rank]

    def send(self, stage: int, y: torch.Tensor) -> None:
        self._tokens.append(_Send.apply(y, self.group, self._global(stage + 1)))

    def recv(self, stage: int, like: torch.Tensor) -> torch.Tensor:
        anchor = torch.zeros((), device=like.device, requires_grad=True)
        return _Recv.apply(anchor, self.group, self._global(stage - 1), like)

    def finish(self, outputs: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
        is_last = self.rank == self.size - 1
        src = torch.cat(outputs) if is_last else torch.stack(self._tokens).sum()
        return _FromLast.apply(src, self.group, self._global(self.size - 1), like, is_last)


def pipeline_spmd(
    stage_fn: StageFn,
    x: torch.Tensor,
    *,
    num_stages: int,
    num_microbatches: int,
    group: Any = None,
    remat: bool = False,
) -> torch.Tensor:
    """Run ``x`` [B, ...] through ``num_stages`` stages, GPipe-microbatched
    into ``num_microbatches`` along the batch.  ``stage_fn(j, h)`` applies
    stage j to a microbatch ``h``.  ``group=None`` runs every stage here;
    a pp process group runs this rank's stage, and ``x`` matters only on
    stage 0 (the other stages read its shape).  ``remat=True`` recomputes
    each stage's activations in the backward pass.  Returns the last
    stage's output [B, ...] on every stage."""
    B = x.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by M={num_microbatches}")
    fn = stage_fn
    if remat:
        from torch.utils.checkpoint import checkpoint

        def fn(j: int, h: torch.Tensor) -> torch.Tensor:
            return checkpoint(stage_fn, j, h, use_reentrant=False)

    x_mb = x.chunk(num_microbatches)
    hop = LocalHop() if group is None else P2PHop(group)
    outputs: List[torch.Tensor] = []
    for j in hop.stages(num_stages):
        for m in range(num_microbatches):
            h = x_mb[m] if j == 0 else hop.recv(j, x_mb[m])
            y = fn(j, h)
            if j == num_stages - 1:
                outputs.append(y)
            else:
                hop.send(j, y)
    return hop.finish(outputs, x)


class PipelinedLlama(Llama):
    """Llama with its layers pipelined over ``num_stages`` stages.

    The embedding, the final norm and the head run outside the pipeline,
    replicated over pp; the layers run through :func:`pipeline_spmd`,
    stage j holding layers ``j·L/P … (j+1)·L/P − 1``.  The layers are a
    ``ModuleDict`` keyed by their index, so the parameter names are the
    plain :class:`Llama`'s and one ``state_dict`` fits both.

    ``pp`` sets the stage count (default: the mesh's pp axis, else 1).
    Built without a pp process group, every stage runs in this process;
    ``parallel/hsdp.py:shard_model`` on a mesh with pp > 1 keeps this
    rank's stage (:meth:`keep_stage`) and the stages hop over the mesh's
    pp group.  ``num_microbatches`` defaults to 4·pp.  ``remat=True``
    recomputes every layer of a stage in the backward pass (the config's
    "layer" mode: the JAX engine checkpoints the whole stage; the math is
    the same, and a per-layer checkpoint sits inside FSDP2's units).

    pp × sp composes: under ``config.sp_axis`` each stage's attention is
    ring attention over the mesh's sp group on this rank's sequence block,
    RoPE at the block's global positions.

    On the CPU attention inside the pipeline is the plain version, as the
    JAX engine turns flash off there; on a CUDA device it runs the flash
    kernels.

    Constraints (``ValueError``, as in JAX): ``n_layers % pp == 0``; the
    batch divides by ``num_microbatches``.
    """

    def __init__(
        self,
        config: LlamaConfig,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
        mesh: Any = None,
        *,
        pp: Optional[int] = None,
        pp_axis: str = "pp",
        num_microbatches: Optional[int] = None,
        remat: bool = False,
    ) -> None:
        if remat:
            config = dataclasses.replace(config, remat_mode="layer")
        if pp is None:
            pp = 1 if mesh is None else dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))[pp_axis]
        self._check_stages(config, pp)
        super().__init__(config, device, generator, mesh)
        self.pp_axis = pp_axis
        self.layers = nn.ModuleDict({str(i): layer for i, layer in enumerate(self.layers)})
        for layer in self.blocks():
            layer.cpu_flash = False
        self.num_stages = pp
        self.num_microbatches = num_microbatches or 4 * pp
        self.remat = remat
        self.stage: Optional[int] = None  # this rank's stage once kept; None: all here

    @staticmethod
    def _check_stages(config: LlamaConfig, pp: int) -> None:
        if config.n_layers % pp:
            raise ValueError(f"n_layers={config.n_layers} not divisible by pp={pp}")

    def blocks(self) -> List[nn.Module]:
        return list(self.layers.values())

    def keep_stage(self, mesh: Any) -> None:
        """Take the stage count from ``mesh``'s pp axis and drop the layers
        of the other stages."""
        pp = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))[self.pp_axis]
        self._check_stages(self.config, pp)
        self.mesh, self.num_stages = mesh, pp
        self.stage = mesh[self.pp_axis].get_local_rank()
        per = self.config.n_layers // pp
        for key in list(self.layers):
            if int(key) // per != self.stage:
                del self.layers[key]

    def pp_group(self) -> Any:
        """The pp process group, or None when every stage runs here."""
        if self.stage is None:
            return None
        return self.mesh[self.pp_axis].get_group()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        B, S = tokens.shape
        group = self.pp_group()
        if group is None or self.stage == 0:
            x = self._embed(tokens).to(cfg.dtype)
        else:  # only its shape matters off stage 0
            x = torch.empty(B, S, cfg.dim, dtype=cfg.dtype, device=tokens.device)
        sp_group = self.sp_group()
        start = 0 if sp_group is None else S * self.mesh[cfg.sp_axis].get_local_rank()
        rope = self.rope(S, tokens.device, start)
        per = cfg.n_layers // self.num_stages

        def stage_fn(j: int, h: torch.Tensor) -> torch.Tensor:
            for i in range(j * per, (j + 1) * per):
                h = self.layers[str(i)](h, rope, sp_group)
            return h

        x = pipeline_spmd(stage_fn, x, num_stages=self.num_stages,
                          num_microbatches=self.num_microbatches, group=group)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.lm_head(x).float()
