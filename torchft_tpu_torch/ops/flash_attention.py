"""Fused causal GQA flash attention — forward and backward on Hopper.

The port of ``torchft_tpu/ops/flash_attention.py``.  The naive attention
path materializes the [B, H, S, S] score matrix in device memory; the flash
construction keeps it on chip: online softmax with f32 statistics and
accumulators, bf16 tensor-core products, the score matrix rebuilt tile by
tile in the backward from the saved logsumexp.

Three hand-written CUDA kernels replace the three Pallas TPU kernels:

- ``flash_fwd``  (``_fwd_kernel``): o and lse = m + log l, in
  ``csrc/flash_fwd_sm90.cu`` (wgmma products, a TMA ring of K/V tiles, the
  softmax in registers; Hopper helpers in ``csrc/sm90.cuh``);
- ``flash_dq``   (``_dq_kernel``):  dq = Σ_k ds·k, in ``csrc/flash_dq_sm90.cu``
  (wgmma products, a TMA ring of K/V tiles, dS packed in registers as the
  A operand of dQ += dS·K, dQ in registers; no cross-block sum);
- ``flash_dkv``  (``_dkv_kernel``): dv = Σ pᵀ·do, dk = Σ dsᵀ·q, summed over
  the whole GQA group, in ``csrc/flash_dkv_sm90.cu`` (wgmma on transposed
  scores, a TMA ring of Q/dO tiles, dK and dV in registers; one block per
  q-head, the group summed in a fixed order by the last block to finish).

``delta = rowsum(do·o) − dlse`` stays a plain torch op, as the JAX package
computes it outside Pallas.  Beside each kernel sits its plain PyTorch
version (``*_plain``): the same tiled arithmetic in eager torch.  A wrapper
takes the plain version only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.  Each launch adds one to ``launches[name]``,
and a causal one also to ``causal_launches[name]``.

Kernel layout is heads-major ([B, H, S, D]); the public functions keep the
model's [B, S, H, D] layout.  K/V carry ``KV`` heads (H % KV == 0), never
repeated to H in device memory.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.ops import cuda_build

_NEG_INF = -1e30
FWD_SOURCE = "flash_fwd_sm90"  # csrc/<name>.cu of the forward kernel
DQ_SOURCE = "flash_dq_sm90"  # of the dq kernel
DKV_SOURCE = "flash_dkv_sm90"  # of the dk/dv kernel
KERNEL_SOURCES = (FWD_SOURCE, DQ_SOURCE, DKV_SOURCE)
KERNEL_HEAD_DIMS = (64, 128)  # head dims the CUDA sources instantiate

# launch counts of each kernel since the last reset_launches(), and of its
# causal launches among them
launches: Dict[str, int] = {"fwd": 0, "dq": 0, "dkv": 0}
causal_launches: Dict[str, int] = {"fwd": 0, "dq": 0, "dkv": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for counts in (launches, causal_launches):
            for name in counts:
                counts[name] = 0


def _count(name: str, causal: bool) -> None:
    with _launch_lock:
        launches[name] += 1
        causal_launches[name] += bool(causal)


# ---------------------------------------------------------------------------
# plain versions (heads-major): the kernels' arithmetic in eager torch
# ---------------------------------------------------------------------------


def _scores(qb, kb, sm_scale, causal, q0, k0):
    """Scaled [.., bq, bk] f32 scores of one tile pair, causal-masked with
    the TPU kernel's −1e30."""
    s = (qb @ kb.transpose(-1, -2)) * sm_scale
    if causal:
        rows = torch.arange(q0, q0 + s.shape[-2], device=s.device)[:, None]
        cols = torch.arange(k0, k0 + s.shape[-1], device=s.device)[None, :]
        s = s.masked_fill(rows < cols, _NEG_INF)
    return s


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    return x.repeat_interleave(groups, dim=1) if groups > 1 else x


def flash_fwd_plain(q, k, v, sm_scale, causal, block_q, block_k):
    """q [B,H,Sq,D], k/v [B,KV,Sk,D] → (o [B,H,Sq,D], lse [B,H,Sq] f32):
    tiled online softmax; causally dead k-tiles are skipped."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    groups = H // k.shape[1]
    kh, vh = _repeat_kv(k, groups), _repeat_kv(v, groups)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, block_q):
        qb = q[:, :, q0 : q0 + block_q].float()
        bq = qb.shape[2]
        m = torch.full((B, H, bq, 1), _NEG_INF, device=q.device)
        l = torch.zeros((B, H, bq, 1), device=q.device)
        acc = torch.zeros((B, H, bq, D), device=q.device)
        for k0 in range(0, Sk, block_k):
            if causal and k0 > q0 + bq - 1:
                break
            s = _scores(qb, kh[:, :, k0 : k0 + block_k].float(), sm_scale, causal, q0, k0)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            # p · V takes p rounded to the value dtype, as the kernel does
            vb = vh[:, :, k0 : k0 + block_k]
            acc = acc * corr + p.to(vb.dtype).float() @ vb.float()
            m = m_new
        denom = torch.where(l > 0, l, torch.ones_like(l))  # fully-masked rows
        o[:, :, q0 : q0 + bq] = (acc / denom).to(q.dtype)
        lse[:, :, q0 : q0 + bq] = (m + torch.log(denom))[..., 0]
    return o, lse


def _p_ds(qb, kb, vb, dob, lse_b, delta_b, sm_scale, causal, q0, k0):
    """Backward recompute of one tile pair (``_recompute_p_ds``): the
    normalized probabilities p and the score gradient ds, both f32."""
    s = _scores(qb, kb, sm_scale, causal, q0, k0)
    p = torch.exp(s - lse_b)
    dp = dob @ vb.transpose(-1, -2)
    return p, p * (dp - delta_b) * sm_scale


def flash_dq_plain(q, k, v, lse, do, delta, sm_scale, causal, block_q, block_k):
    """dq [B,H,Sq,D] from the saved lse and delta (both [B,H,Sq] f32)."""
    Sq, Sk = q.shape[2], k.shape[2]
    groups = q.shape[1] // k.shape[1]
    kh, vh = _repeat_kv(k, groups), _repeat_kv(v, groups)
    dq = torch.empty_like(q)
    for q0 in range(0, Sq, block_q):
        qb = q[:, :, q0 : q0 + block_q].float()
        dob = do[:, :, q0 : q0 + block_q].float()
        bq = qb.shape[2]
        lse_b = lse[:, :, q0 : q0 + bq, None]
        delta_b = delta[:, :, q0 : q0 + bq, None]
        acc = torch.zeros_like(qb)
        for k0 in range(0, Sk, block_k):
            if causal and k0 > q0 + bq - 1:
                break
            kb = kh[:, :, k0 : k0 + block_k]
            _, ds = _p_ds(
                qb, kb.float(), vh[:, :, k0 : k0 + block_k].float(), dob,
                lse_b, delta_b, sm_scale, causal, q0, k0,
            )
            acc = acc + ds.to(kb.dtype).float() @ kb.float()
        dq[:, :, q0 : q0 + bq] = acc.to(q.dtype)
    return dq


def flash_dkv_plain(q, k, v, lse, do, delta, sm_scale, causal, block_q, block_k):
    """(dk, dv) [B,KV,Sk,D]: each kv-head sums its whole GQA group."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    groups = H // KV
    kh, vh = _repeat_kv(k, groups), _repeat_kv(v, groups)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, Sk, block_k):
        kb = kh[:, :, k0 : k0 + block_k].float()
        vb = vh[:, :, k0 : k0 + block_k].float()
        bk = kb.shape[2]
        dk_acc = torch.zeros((B, H, bk, D), device=q.device)
        dv_acc = torch.zeros((B, H, bk, D), device=q.device)
        for q0 in range(0, Sq, block_q):
            qb_raw = q[:, :, q0 : q0 + block_q]
            bq = qb_raw.shape[2]
            if causal and q0 + bq - 1 < k0:
                continue
            qb = qb_raw.float()
            dob_raw = do[:, :, q0 : q0 + bq]
            p, ds = _p_ds(
                qb, kb, vb, dob_raw.float(), lse[:, :, q0 : q0 + bq, None],
                delta[:, :, q0 : q0 + bq, None], sm_scale, causal, q0, k0,
            )
            dv_acc = dv_acc + p.to(dob_raw.dtype).float().transpose(-1, -2) @ dob_raw.float()
            dk_acc = dk_acc + ds.to(qb_raw.dtype).float().transpose(-1, -2) @ qb
        dk[:, :, k0 : k0 + bk] = dk_acc.view(B, KV, groups, bk, D).sum(2).to(k.dtype)
        dv[:, :, k0 : k0 + bk] = dv_acc.view(B, KV, groups, bk, D).sum(2).to(v.dtype)
    return dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# each source's C entry points and their count of leading pointer arguments
_ENTRY_POINTS = {
    FWD_SOURCE: {"tft_flash_fwd_sm90": 5},  # q k v o lse
    DQ_SOURCE: {"tft_flash_dq_sm90": 7},  # q k v lse do delta dq
    DKV_SOURCE: {"tft_flash_dkv_sm90": 10},  # q k v lse do delta dk dv partial counters
}
_lib_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _lib(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, built at first use."""
    with _lib_lock:
        lib = _libs.get(source)
        if lib is None:
            lib = cuda_build.load(source)
            dims = [_I] * 5 + [_I, _F, _I, _P]  # B H KV Sq Sk, D scale causal stream
            for name, pointers in _ENTRY_POINTS[source].items():
                fn = getattr(lib, name)
                fn.argtypes = [_P] * pointers + dims
                fn.restype = _I
            lib.tft_cuda_error_string.argtypes = [_I]
            lib.tft_cuda_error_string.restype = ctypes.c_char_p
            if source == DKV_SOURCE:
                lib.tft_flash_dkv_sm90_counters.argtypes = [_I] * 3  # B KV Sk
                lib.tft_flash_dkv_sm90_counters.restype = _I
            _libs[source] = lib
        return lib


def _check(
    q: torch.Tensor,
    k: torch.Tensor,
    causal: bool,
    others: Dict[str, Tuple[torch.Tensor, Tuple[int, ...], torch.dtype]],
) -> Tuple[int, int, int, int, int, int]:
    """Validate the kernel's operands: CUDA, one device, bf16 q/k/v-shaped
    tensors, f32 row statistics, contiguous and 16-byte aligned."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash kernels take heads-major [B, H, S, D] tensors")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if causal and Sq != Sk:
        raise ValueError(f"causal attention needs Sq == Sk, got Sq={Sq} Sk={Sk}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {KERNEL_HEAD_DIMS}")
    tensors = {"q": (q, (B, H, Sq, D), torch.bfloat16), "k": (k, (B, KV, Sk, D), torch.bfloat16)}
    tensors.update(others)
    for name, (t, shape, dtype) in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be on q's CUDA device, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return B, H, KV, Sq, Sk, D


def _raise_on(rc: int, name: str, lib: ctypes.CDLL) -> None:
    if rc:
        msg = "unsupported head dim" if rc == -1 else lib.tft_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash {name} kernel launch failed ({rc}): {msg}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, sm_scale, causal, block_q=64, block_k=64):
    """Forward kernel (wgmma + TMA, ``csrc/flash_fwd_sm90.cu``): (o, lse
    [B,H,Sq] f32).  ``block_q/k`` tile only the plain version taken for CPU
    tensors; the kernel's tiles are its own (128 q rows × 128 keys)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, sm_scale, causal, block_q, block_k)
    B, H, KV, Sq, Sk, D = _check(q, k, causal, {"v": (v, tuple(k.shape), torch.bfloat16)})
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    lib = _lib(FWD_SOURCE)
    rc = lib.tft_flash_fwd_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, H, KV, Sq, Sk, D, float(sm_scale), int(causal), _stream(q),
    )
    _raise_on(rc, "fwd", lib)
    _count("fwd", causal)
    return o, lse


def _bwd_operands(q, k, v, lse, do, delta):
    rows = (tuple(q.shape[:3]), torch.float32)
    return {
        "v": (v, tuple(k.shape), torch.bfloat16),
        "lse": (lse, *rows),
        "do": (do, tuple(q.shape), torch.bfloat16),
        "delta": (delta, *rows),
    }


def flash_dq(q, k, v, lse, do, delta, sm_scale, causal, block_q=64, block_k=64):
    """dq kernel (wgmma + TMA, ``csrc/flash_dq_sm90.cu``): dq [B,H,Sq,D].
    One block per (128 q-rows, q-head, batch) sums its rows' dq over the
    k-tiles in registers.  ``block_q/k`` tile only the plain version taken
    for CPU tensors."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, lse, do, delta, sm_scale, causal, block_q, block_k)
    B, H, KV, Sq, Sk, D = _check(q, k, causal, _bwd_operands(q, k, v, lse, do, delta))
    dq = torch.empty_like(q)
    lib = _lib(DQ_SOURCE)
    rc = lib.tft_flash_dq_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
        delta.data_ptr(), dq.data_ptr(),
        B, H, KV, Sq, Sk, D, float(sm_scale), int(causal), _stream(q),
    )
    _raise_on(rc, "dq", lib)
    _count("dq", causal)
    return dq


def flash_dkv(q, k, v, lse, do, delta, sm_scale, causal, block_q=64, block_k=64):
    """dk/dv kernel (wgmma + TMA, ``csrc/flash_dkv_sm90.cu``): (dk, dv)
    [B,KV,Sk,D], each kv-head summing its GQA group.  One block per
    (k-tile, q-head, batch); for G = H / KV > 1 each writes an f32 partial
    to scratch, and the last block of each group sums them in a fixed
    order.  ``block_q/k`` tile only the plain version taken for CPU
    tensors."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, lse, do, delta, sm_scale, causal, block_q, block_k)
    B, H, KV, Sq, Sk, D = _check(q, k, causal, _bwd_operands(q, k, v, lse, do, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib(DKV_SOURCE)
    partial = counters = None
    if H > KV:
        partial = torch.empty(2 * B * H * Sk * D, dtype=torch.float32, device=q.device)
        n_counters = lib.tft_flash_dkv_sm90_counters(B, KV, Sk)
        counters = torch.zeros(n_counters, dtype=torch.int32, device=q.device)
    rc = lib.tft_flash_dkv_sm90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        B, H, KV, Sq, Sk, D, float(sm_scale), int(causal), _stream(q),
    )
    _raise_on(rc, "dkv", lib)
    _count("dkv", causal)
    return dk, dv


def backward_delta(do, o, dlse=None):
    """delta = rowsum(do·o) − dlse in f32 ([B,H,Sq]): a plain op, as in the
    JAX package (``_bwd``)."""
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


# ---------------------------------------------------------------------------
# autograd + public entry points ([B, S, H, D] layout)
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Heads-major flash attention returning (o, lse); differentiable in
    both (the lse cotangent folds into delta).  ``kernels`` is the (fwd, dq,
    dkv) triple it runs: the wrappers, or :data:`PLAIN` to hold the same
    chain to the plain versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, block_q, block_k, kernels=None):
        fwd, ctx.dq, ctx.dkv = kernels or (flash_fwd, flash_dq, flash_dkv)
        o, lse = fwd(q, k, v, sm_scale, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (sm_scale, causal, block_q, block_k)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = torch.zeros_like(o) if do is None else do.contiguous()
        delta = backward_delta(do, o, dlse).contiguous()
        dq = ctx.dq(q, k, v, lse, do, delta, *ctx.cfg)
        dk, dv = ctx.dkv(q, k, v, lse, do, delta, *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None


# the plain versions in the order _FlashAttention takes its kernels
PLAIN = (flash_fwd_plain, flash_dq_plain, flash_dkv_plain)


def _validate(q, k, causal, sm_scale, block_q, block_k):
    """Shape/divisibility validation for the public wrappers ([B, S, H, D]
    layout), with the JAX package's errors.  Returns (sm_scale, bq, bk)."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    Sk = k.shape[1]
    if H % KV:
        raise ValueError(f"GQA needs H % KV == 0, got H={H} KV={KV}")
    if causal and Sk != S:
        raise ValueError(f"causal attention needs Sq == Sk, got Sq={S} Sk={Sk}")
    block_q = min(block_q, S)
    block_k = min(block_k, Sk)
    if S % block_q or Sk % block_k:
        raise ValueError(f"Sq={S}/Sk={Sk} not divisible by blocks ({block_q},{block_k})")
    if sm_scale is None:
        sm_scale = 1.0 / float(np.sqrt(D))
    return float(sm_scale), block_q, block_k


def _heads_major(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention` but also returns the rowwise logsumexp
    (``[B, S, H]``, f32), so partial results over different K/V blocks can
    be merged exactly.  K/V may carry a different sequence length than q
    when ``causal=False``."""
    sm_scale, block_q, block_k = _validate(q, k, causal, sm_scale, block_q, block_k)
    o, lse = _FlashAttention.apply(
        _heads_major(q), _heads_major(k), _heads_major(v),
        sm_scale, causal, block_q, block_k,
    )
    return o.transpose(1, 2), lse.transpose(1, 2)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 512,
) -> torch.Tensor:
    """Fused differentiable attention in the model's layout.

    q: [B, S, H, D]; k/v: [B, Sk, KV, D] with H % KV == 0 (GQA, un-repeated).
    Returns [B, S, H, D].  S must be divisible by the (clamped) block sizes,
    as in the JAX package; the CUDA kernels use their own tiles regardless."""
    o, _ = flash_attention_lse(
        q, k, v, causal=causal, sm_scale=sm_scale, block_q=block_q, block_k=block_k
    )
    return o
