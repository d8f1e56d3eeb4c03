"""Expert parallelism: a top-1 switch Mixture-of-Experts FFN, its experts
split over the ``ep`` mesh axis.

The port of ``torchft_tpu/parallel/moe.py``, with the same math:

- routing (:meth:`MoE.route`): f32 router logits, softmax, ``argmax`` (a
  tie goes to the first expert), each token's place in its expert's buffer
  by a cumulative sum, ``capacity = max(1, int(cf·T/E))``; a token past its
  expert's capacity is dropped and the caller's residual carries it;
- dispatch and combine are einsums against a one-hot mask [E, C, T], so
  every expert gets a gradient (zero or not) on every step and every
  replica's gradient layout is the same;
- the expert FFN (:func:`expert_ffn`) is a relu FFN, not SwiGLU.

The expert-parallel path (:meth:`MoE.forward` with ``ep_group``) is the
per-process form of the JAX ``_apply_ep_local``: every ep rank holds the
same tokens (the batch splits over dp and fsdp, not ep) and E/ep experts.
Rank r takes block r of the flat tokens and routes it; its [E, C, D]
buffers, regrouped as [ep, E/ep, C, D], go to their owners in one
``all_to_all_single``; each owner runs its experts on [E/ep, ep·C, D];
the results come back over the same exchange, are combined, and the token
blocks are gathered on every ep rank.  The loss is then the same on every
ep rank, so each collective's backward delivers a cotangent once: the
gather's backward keeps this rank's block, the split's gathers the blocks'
cotangents, and the router (used on this rank's block only) sums its
gradient over the ep ranks.

A rank's capacity group is its own block of its own rows (T_local/ep
tokens).  The JAX shard_map takes the flat tokens of the whole batch
(``P(ep, None)``, gathered over fsdp), so its group spans the fsdp ranks.
The two agree exactly when no token overflows, and at dp·fsdp = 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


@dataclass(frozen=True)
class MoEConfig:
    dim: int
    ffn_hidden: int
    num_experts: int
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32  # expert weights and compute


def capacity(capacity_factor: float, tokens: int, num_experts: int) -> int:
    """Slots per expert for ``tokens`` routed tokens (the JAX truncating
    ``int``)."""
    return max(1, int(capacity_factor * tokens / num_experts))


def route(router: torch.Tensor, x: torch.Tensor,
          cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, D] → (dispatch [E, C, T] one-hot in x's dtype, combine [E, C,
    T] f32: dispatch times the gate, kept [T] bool)."""
    num_experts = router.shape[1]
    logits = x.float() @ router  # [T, E] f32
    probs = torch.softmax(logits, dim=-1)
    gate, expert = probs.max(dim=-1)  # the first maximum, as jnp.argmax
    # one-hots by comparison with an arange (no data-dependent shape check,
    # so the rehearsal traces it under FakeTensorMode)
    onehot = (expert[:, None] == torch.arange(num_experts, device=x.device)).long()  # [T, E]
    position = torch.cumsum(onehot, dim=0) * onehot  # 1-based
    pos_in_expert = position.sum(dim=-1) - 1  # [T]
    keep = pos_in_expert < cap
    slot = pos_in_expert[:, None] == torch.arange(cap, device=x.device)  # [T, C], none if dropped
    dispatch = (onehot[:, :, None] * slot[:, None, :]).to(x.dtype)  # [T, E, C]
    dispatch = dispatch.permute(1, 2, 0)  # [E, C, T]
    combine = dispatch * gate[None, None, :]  # promotes to f32, as in JAX
    return dispatch, combine, keep


def expert_ffn(w_up: torch.Tensor, w_down: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] through per-expert weights [E, D, F] and [E, F, D]."""
    h = torch.relu(torch.einsum("ecd,edf->ecf", x, w_up))
    return torch.einsum("ecf,efd->ecd", h, w_down)


class _AllToAll(torch.autograd.Function):
    """Block j of dim 0 goes to rank j of ``group``; block j of the result
    came from rank j.  Equal blocks make it its own inverse, so the
    backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()  # the collectives read and write dense memory
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


class _SplitTokens(torch.autograd.Function):
    """x [T, D], the same on every rank of ``group`` → this rank's block of
    rows.  The backward gathers every rank's block cotangent: the whole
    cotangent of x, on every rank."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return x.chunk(n)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


class _GatherTokens(torch.autograd.Function):
    """Each rank's block of rows → the whole [T, D] on every rank of
    ``group``.  Every rank computes the same loss from it, so the backward
    keeps this rank's block of the cotangent, once."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _gather(y, group)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n)[r].contiguous(), None


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the gradient over ``group``: a weight
    each rank applies to its own block of the tokens."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, differentiably; any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class MoE(nn.Module):
    """Top-1 switch MoE layer: [B, S, D] → [B, S, D] (the residual is the
    caller's), in ``x``'s dtype promoted with f32 (the combine is f32, as in
    JAX).  ``router`` [D, E] is f32; ``w_up`` [E, D, F] and ``w_down``
    [E, F, D] are in ``config.dtype`` — on an ep mesh, DTensors split on
    dim 0 (``parallel/hsdp.py:shard_model``)."""

    def __init__(self, config: MoEConfig, device: Any = "cuda") -> None:
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MoE: CUDA requested but not available (pass device='cpu')")
        cfg = config
        self.config = cfg
        E, D, F = cfg.num_experts, cfg.dim, cfg.ffn_hidden
        self.router = nn.Parameter(torch.empty(D, E, device=device, dtype=torch.float32))
        self.w_up = nn.Parameter(torch.empty(E, D, F, device=device, dtype=cfg.dtype))
        self.w_down = nn.Parameter(torch.empty(E, F, D, device=device, dtype=cfg.dtype))
        # the ep process group once the experts are split (shard_model)
        self.ep_group: Any = None
        # tokens past their expert's capacity in the last forward (on this
        # rank's block): a 0-d tensor, read without a device sync here
        self.last_dropped: Optional[torch.Tensor] = None
        self.reset_parameters()

    @staticmethod
    def fan_in(name: str, p: torch.Tensor) -> int:
        """router [D, E]: D; w_up [E, D, F]: D; w_down [E, F, D]: F."""
        return p.shape[0] if name.endswith("router") else p.shape[1]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 1/fan_in), drawn in f32 and cast to the parameter's dtype
        (the JAX ``init``'s distribution, not its numbers)."""
        for name, p in self.named_parameters():
            w = torch.empty(p.shape, device=p.device, dtype=torch.float32)
            w.normal_(generator=generator).div_(float(np.sqrt(self.fan_in(name, p))))
            p.copy_(w)

    def split_experts(self, ep_mesh: Any) -> None:
        """Split ``w_up`` and ``w_down`` on dim 0 over the 1-D ``ep_mesh``
        (DTensors, ``Shard(0)``: this rank keeps E/ep experts) and route
        over its process group.  Every rank of the mesh holds the same
        whole weights when it calls."""
        from torch.distributed.tensor import Shard, distribute_tensor

        n = ep_mesh.size()
        if self.config.num_experts % n:
            raise ValueError(f"num_experts={self.config.num_experts} not divisible by ep={n}")
        for name in ("w_up", "w_down"):
            w = getattr(self, name).detach()
            setattr(self, name, nn.Parameter(distribute_tensor(w, ep_mesh, [Shard(0)])))
        self.ep_group = ep_mesh.get_group()

    def _dense(self, router: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
        """All experts local (the JAX ``_apply_dense``): x [T, D] → [T, D]."""
        cap = capacity(self.config.capacity_factor, x.shape[0], self.config.num_experts)
        dispatch, combine, keep = route(router, x, cap)
        self.last_dropped = (~keep).sum()
        expert_in = torch.einsum("ect,td->ecd", dispatch, x)
        expert_out = expert_ffn(w_up, w_down, expert_in)
        return torch.einsum("ect,ecd->td", combine, expert_out.float())

    def _expert_parallel(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX ``_apply_ep_local`` over ``self.ep_group``: x [T, D], the
        same on every ep rank → [T, D] on every ep rank."""
        group = self.ep_group
        cfg = self.config
        n = dist.get_world_size(group)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} tokens do not split over ep = {n}")
        w_up, w_down = _local(self.w_up), _local(self.w_down)
        e_loc = w_up.shape[0]
        x_loc = _SplitTokens.apply(x, group)
        router = _SumGrad.apply(self.router, group)
        cap = capacity(cfg.capacity_factor, x_loc.shape[0], cfg.num_experts)
        dispatch, combine, keep = route(router, x_loc, cap)
        self.last_dropped = (~keep).sum()
        expert_in = torch.einsum("ect,td->ecd", dispatch, x_loc)  # [E, C, D]
        # experts are contiguous per rank: [E, C, D] → [n, e_loc, C, D] → to
        # their owners; each owner receives every rank's buffers of its experts
        routed = _AllToAll.apply(expert_in.reshape(n, e_loc, cap, cfg.dim), group)
        routed = routed.transpose(0, 1).reshape(e_loc, n * cap, cfg.dim)
        out = expert_ffn(w_up, w_down, routed)
        out = out.reshape(e_loc, n, cap, cfg.dim).transpose(0, 1)
        returned = _AllToAll.apply(out.contiguous(), group).reshape(n * e_loc, cap, cfg.dim)
        y_loc = torch.einsum("ect,ecd->td", combine, returned.float())
        return _GatherTokens.apply(y_loc, group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, S, D = x.shape
        flat = x.reshape(B * S, D)
        if self.ep_group is None or dist.get_world_size(self.ep_group) == 1:
            out = self._dense(self.router, _local(self.w_up), _local(self.w_down), flat)
        else:
            out = self._expert_parallel(flat)
        return out.reshape(B, S, D)
