"""Ring attention: sequence parallelism over the ``sp`` mesh axis.

The port of ``torchft_tpu/parallel/ring_attention.py``.  Q/K/V are split on
the sequence dimension over the ``sp`` ranks; at each of the ``n`` ring
steps a rank attends its query block to the K/V block it holds, then hands
that block to the next rank.  Causality across blocks falls out of the
global block indices: a K/V block from a later position contributes
nothing, the diagonal block is masked triangularly, earlier blocks attend
fully.  K/V travel un-repeated (GQA), which cuts the bytes on the ring by
the group factor.

Two branches, gated as the model gates its attention
(``models.llama.use_flash`` on the local block length: the flash branch
always on a CUDA device, the JAX gate on the CPU):

- the flash branch runs ``flash_attention_lse`` on every held block (the
  Hopper kernels on the card): causal on the diagonal block, non-causal on
  earlier blocks, skipped for later ones, and merges the normalized
  partials exactly through their logsumexp;
- the online-softmax branch accumulates an unnormalized output, the row
  maximum and the denominator across the steps, the scores in f32.

The block schedule and the merge (:func:`ring_schedule`) see the ring only
through ``block_at(t)``, the K/V block held at ring step t.  The exchange
(:func:`ring_attention`) rotates the blocks over a process group with
point-to-point ops in an autograd function whose backward rotates the
cotangents the other way (the gradient ``jax.grad`` takes of
``lax.ppermute``); everything else is differentiated through the flash
kernels' own backward, which takes the lse cotangent.  The single-process
version (:func:`ring_attention_blocks`) indexes a list of the ranks'
blocks: it runs the same schedule where one device holds every rank.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

Block = Tuple[torch.Tensor, torch.Tensor]
# attend(q, k, v, causal) -> (o [B, S, H, D], lse [B, S, H] f32)
Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, bool], Tuple[torch.Tensor, torch.Tensor]]

CAUSAL, FULL, SKIP = "causal", "full", "skip"


def block_kind(my_idx: int, src_idx: int) -> str:
    """How rank ``my_idx``'s queries attend the K/V block of rank
    ``src_idx``: the diagonal block causally, an earlier one fully, a later
    one not at all."""
    if src_idx == my_idx:
        return CAUSAL
    return FULL if src_idx < my_idx else SKIP


def schedule(my_idx: int, n: int) -> List[str]:
    """The block kind of each ring step of rank ``my_idx`` of ``n``: at
    step t it holds the block of rank ``(my_idx - t) mod n``."""
    return [block_kind(my_idx, (my_idx - t) % n) for t in range(n)]


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool):
    """One block through the flash wrapper (the CUDA kernels for CUDA
    tensors, their plain versions for CPU tensors), with the model's block
    sizes (``models.llama.kernel_blocks``)."""
    from torchft_tpu_torch.models.llama import kernel_blocks
    from torchft_tpu_torch.ops.flash_attention import flash_attention_lse

    block_q, block_k = kernel_blocks(q.shape[1], q.device)
    return flash_attention_lse(q, k, v, causal=causal, block_q=block_q, block_k=block_k)


def ring_schedule(
    q: torch.Tensor,
    block_at: Callable[[int], Block],
    my_idx: int,
    n: int,
    attend: Attend = flash_attend,
) -> torch.Tensor:
    """The flash branch's schedule and merge for rank ``my_idx`` of ``n``:
    ``attend`` on each held block that the causal order lets the queries
    see, merged as ``lse' = logaddexp(lse, lse_b)``, ``o' = o·exp(lse −
    lse') + o_b·exp(lse_b − lse')`` in f32.  Step 0 is the diagonal block,
    so the merge starts from its finite lse.  ``block_at(t)`` is called at
    every step, skipped ones included (the exchange is collective)."""
    o = lse = None
    for t, kind in enumerate(schedule(my_idx, n)):
        k_blk, v_blk = block_at(t)
        if kind == SKIP:
            continue
        o_b, lse_b = attend(q, k_blk, v_blk, kind == CAUSAL)
        if o is None:
            o, lse = o_b.float(), lse_b
            continue
        lse_new = torch.logaddexp(lse, lse_b)
        o = o * torch.exp(lse - lse_new)[..., None] + o_b.float() * torch.exp(lse_b - lse_new)[..., None]
        lse = lse_new
    return o.to(q.dtype)


def ring_local(
    q: torch.Tensor,
    block_at: Callable[[int], Block],
    my_idx: int,
    n: int,
) -> torch.Tensor:
    """The online-softmax branch for rank ``my_idx`` of ``n``, taken on the
    CPU only (``models.llama.use_flash`` never sends a CUDA tensor here): q
    [B, S, H, D], each held block [B, S, KV, D] broadcast to the H heads
    at compute time; scores in f32 with the JAX package's −1e30 mask; the
    running output, row maximum and denominator carried across the steps.
    A skipped block would add exp(−1e30 − m) = 0 at a correction of 1, so
    it is not computed."""
    B, S, H, D = q.shape
    scale = 1.0 / float(np.sqrt(D))
    q32 = q.float()
    o = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, S, H), -float("inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, S, H), dtype=torch.float32, device=q.device)
    tri = torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device))
    for t, kind in enumerate(schedule(my_idx, n)):
        k_blk, v_blk = block_at(t)
        if kind == SKIP:
            continue
        groups = H // k_blk.shape[2]
        k_full = k_blk.repeat_interleave(groups, dim=2).float()
        v_full = v_blk.repeat_interleave(groups, dim=2).float()
        scores = torch.einsum("bqhd,bkhd->bqhk", q32, k_full) * scale
        if kind == CAUSAL:
            scores = scores.masked_fill(~tri[None, :, None, :], -1e30)
        m_new = torch.maximum(m, scores.amax(-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * correction + p.sum(-1)
        o = o * correction[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, v_full)
        m = m_new
    denom = torch.where(l > 0, l, torch.ones_like(l))
    return (o / denom[..., None]).to(q.dtype)


def _rotate(tensors: Sequence[torch.Tensor], group, shift: int) -> Tuple[torch.Tensor, ...]:
    """Send each tensor ``shift`` ranks on around ``group`` and receive the
    ones ``shift`` ranks back, in one batch of point-to-point ops."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    sends = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in sends]
    ops = [dist.P2POp(dist.isend, t, dst, group) for t in sends]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in outs]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(outs)


class _RingRotate(torch.autograd.Function):
    """(k, v) → the (k, v) of the previous rank of the ring: send to rank
    + 1, receive from rank − 1.  The backward rotates the cotangents the
    other way, so each block's gradient returns to the rank that sent it."""

    @staticmethod
    def forward(ctx, group, k, v):
        ctx.group = group
        return _rotate((k, v), group, 1)

    @staticmethod
    def backward(ctx, dk, dv):
        return (None, *_rotate((dk, dv), ctx.group, -1))


class _After(torch.autograd.Function):
    """o, unchanged, made to depend on the last rotated block: every rank's
    backward then runs every rotation's backward, in the same order (a
    rank that attends none of the rotated blocks still relays the others'
    cotangents to their owners).  The last block gets a zero cotangent."""

    @staticmethod
    def forward(ctx, o, k, v):
        ctx.like = [(t.shape, t.dtype, t.device) for t in (k, v)]
        return o.clone()

    @staticmethod
    def backward(ctx, do):
        return (do, *(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.like))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group: dist.ProcessGroup,
) -> torch.Tensor:
    """Causal ring attention over the sp process group ``group`` (every
    rank of it calls).  q: this rank's block [B, S_blk, H, D]; k/v:
    [B, S_blk, KV, D] with H % KV == 0, un-repeated; rank i of the group
    holds sequence block i.  Returns this rank's output block in q's
    layout; differentiable in q, k and v."""
    from torchft_tpu_torch.models.llama import use_flash

    n, my_idx = dist.get_world_size(group), dist.get_rank(group)
    held = [(k, v)]

    def block_at(t: int) -> Block:
        if t:
            held[0] = _RingRotate.apply(group, *held[0])
        return held[0]

    if use_flash(q.shape[1], q.device):
        o = ring_schedule(q, block_at, my_idx, n)
    else:
        o = ring_local(q, block_at, my_idx, n)
    return _After.apply(o, *held[0]) if n > 1 else o


def ring_attention_blocks(
    qs: Sequence[torch.Tensor],
    ks: Sequence[torch.Tensor],
    vs: Sequence[torch.Tensor],
    attend: Attend = flash_attend,
) -> List[torch.Tensor]:
    """The flash branch's ring in one process: rank r's query block
    ``qs[r]`` against the K/V blocks ``ks``/``vs`` in the order the ring
    hands them to rank r.  Returns each rank's output block;
    differentiable, with each K/V block's gradient accumulating on the
    tensor given (as the exchange returns it to its owner)."""
    n = len(qs)
    return [
        ring_schedule(qs[r], lambda t, r=r: (ks[(r - t) % n], vs[(r - t) % n]), r, n, attend)
        for r in range(n)
    ]
