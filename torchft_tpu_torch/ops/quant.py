"""Rowwise int8 / fp8 quantize, fused reduce and dequantize on the card.

The port of ``torchft_tpu/ops/pallas_quant.py``.  Gradients are quantized
on the card before they leave device memory, so the host (and then the
wire) moves a 1-byte payload plus f32 rowwise scales — a quarter of the f32
bytes.  Three hand-written CUDA kernels replace the three Pallas TPU
kernels, quantize and dequantize in ``csrc/quant.cu``, the reduce in
``csrc/quant_reduce_sm90.cu`` (a ring of bulk copies), all on the wire
arithmetic of ``csrc/quant.cuh``:

- ``quantize_rowwise_device``   (``_quant_kernel``):  f32 [n] → payload
  [rows, 1024] + scales [rows, 1];
- ``reduce_quantized_device``   (``_reduce_kernel``): Σ_w q_w·s_w in f32,
  requantized (the pipeline's per-window dequant-sum-requant);
- ``dequantize_rowwise_device`` (``_dequant_kernel``): q·s → f32 [n].

Two wire kinds, matching the host format (``torchft_tpu_torch/
quantization.py``): ``int8`` (scale = absmax/127, round half to even) and
``fp8`` (``float8_e4m3fn``, scale = absmax/448, saturating round to nearest
even after the clip).  Layout: the flat input is viewed as rows of
``ROW_SIZE`` with rows padded to a multiple of ``BLOCK_ROWS`` — the JAX
package's geometry, so a mixed fleet agrees on row counts.  The kernels
mask the ragged tail themselves; no padded copy of the input is made.

Beside each kernel sits its plain PyTorch version (``*_plain``), the same
IEEE operations in the same order.  A wrapper takes the plain version only
for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises.  Each launch adds one to ``launches[name]``.

The two sides produce the same bytes except for NaN bit patterns: x86
keeps a NaN operand's sign and makes ``inf/inf`` negative, while the card
returns its canonical positive NaN, so a row holding NaN or inf gets a NaN
scale with other bits, and an fp8 NaN payload byte 0x7f on the card where
the host may write 0xff.  Both decode to NaN.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from torchft_tpu_torch.ops import cuda_build

ROW_SIZE = 1024  # the wire's row; the only row size the kernels take
BLOCK_ROWS = 32  # rows are padded to a multiple of this (the TPU's 1-byte tile)

INT8 = "int8"
FP8 = "fp8"
FP8_MAX = 448.0  # float8_e4m3fn max magnitude

KERNEL_SOURCE = "quant"  # quantize, dequantize
REDUCE_SOURCE = "quant_reduce_sm90"
KERNEL_SOURCES = (KERNEL_SOURCE, REDUCE_SOURCE)
_KIND_CODE = {INT8: 0, FP8: 1}

# launch counts of each kernel since the last reset_launches()
launches: Dict[str, int] = {"quantize": 0, "reduce": 0, "dequantize": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def _wire_dtype(kind: str) -> torch.dtype:
    if kind == INT8:
        return torch.int8
    if kind == FP8:
        return torch.float8_e4m3fn
    raise ValueError(f"unknown wire kind {kind!r}")


def _kind_of(q: torch.Tensor) -> str:
    if q.dtype == torch.int8:
        return INT8
    if q.dtype == torch.float8_e4m3fn:
        return FP8
    raise ValueError(f"a wire payload is int8 or float8_e4m3fn, got {q.dtype}")


def padded_rows(n: int, row_size: int = ROW_SIZE) -> int:
    """Rows of the payload for ``n`` elements: whole rows, at least one,
    rounded up to a multiple of ``BLOCK_ROWS`` (``_pad_to_rows``)."""
    rows = max(1, -(-n // row_size))
    return -(-rows // BLOCK_ROWS) * BLOCK_ROWS


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic in eager torch
# ---------------------------------------------------------------------------


def _quant_math(x: torch.Tensor, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 rows [rows, R] → (payload [rows, R], f32 scales [rows, 1])."""
    qmax = 127.0 if kind == INT8 else FP8_MAX
    absmax = x.abs().amax(dim=-1, keepdim=True)  # keeps NaN, as numpy's max
    # a tensor divisor: torch on CUDA turns division by a Python scalar into
    # a multiply by its reciprocal, which is not the IEEE division
    scale = absmax / torch.full_like(absmax, qmax)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    v = x / safe
    if kind == INT8:
        r = torch.clamp(torch.round(v), -127, 127)
        # numpy casts NaN to int8 0 on x86; say so rather than inherit a cast
        q = torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)
    else:
        q = torch.clamp(v, -FP8_MAX, FP8_MAX).to(_wire_dtype(kind))
    return q, scale


def _pad_to_rows(flat: torch.Tensor, row_size: int) -> torch.Tensor:
    n = flat.shape[0]
    rows = padded_rows(n, row_size)
    padded = torch.zeros(rows * row_size, dtype=torch.float32, device=flat.device)
    padded[:n] = flat
    return padded.view(rows, row_size)


def quantize_rowwise_plain(
    flat: torch.Tensor, row_size: int = ROW_SIZE, kind: str = INT8
) -> Tuple[torch.Tensor, torch.Tensor]:
    return _quant_math(_pad_to_rows(flat, row_size), kind)


def reduce_quantized_plain(
    qs: torch.Tensor, scales: torch.Tensor, kind: str = INT8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contributions summed in ascending w onto +0 (numpy's sum: a sum of
    -0 products is +0), each product rounded before its add (no fused
    multiply-add)."""
    scales = scales.reshape(qs.shape[0], qs.shape[1], 1)
    total = torch.zeros(qs.shape[1:], dtype=torch.float32, device=qs.device)
    for w in range(qs.shape[0]):
        total = total + qs[w].float() * scales[w]
    return _quant_math(total, kind)


def dequantize_rowwise_plain(q: torch.Tensor, scales: torch.Tensor, n: int) -> torch.Tensor:
    return (q.float() * scales.reshape(-1, 1)).reshape(-1)[:n]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib_lock = threading.Lock()
_lib_cache: Dict[str, ctypes.CDLL] = {}
# per source: its entry points with their argument types, and its
# error-string export
_ENTRIES = {
    KERNEL_SOURCE: ((("tft_quantize_rowwise", [_P, _P, _P, _L, _L, _I, _P]),
                     ("tft_dequantize_rowwise", [_P, _P, _P, _L, _I, _P])),
                    "tft_quant_error_string"),
    REDUCE_SOURCE: ((("tft_reduce_quantized_sm90", [_P, _P, _P, _P, _I, _L, _I, _P]),),
                    "tft_quant_reduce_error_string"),
}


def _lib(source: str) -> ctypes.CDLL:
    with _lib_lock:
        lib = _lib_cache.get(source)
        if lib is None:
            lib = cuda_build.load(source)
            entries, error_string = _ENTRIES[source]
            for name, argtypes in entries:
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, _I
            lib.error_string = getattr(lib, error_string)
            lib.error_string.argtypes, lib.error_string.restype = [_I], ctypes.c_char_p
            _lib_cache[source] = lib
        return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _raise_on(rc: int, name: str, lib: ctypes.CDLL) -> None:
    if rc:
        msg = "bad argument" if rc < 0 else lib.error_string(rc).decode()
        raise RuntimeError(f"quant {name} kernel launch failed ({rc}): {msg}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def quantize_rowwise_device(
    flat: torch.Tensor, row_size: int = ROW_SIZE, kind: str = INT8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """flat float [n] → (wire payload [rows, row_size], f32 scales
    [rows, 1]), rows padded to ``BLOCK_ROWS``.  On the card the kernel
    reads ``flat`` once (f32) and writes only the payload and scales."""
    if flat.dim() != 1:
        raise ValueError(f"quantize_rowwise_device takes a flat tensor, got {tuple(flat.shape)}")
    if flat.device.type == "cpu":
        return quantize_rowwise_plain(flat, row_size, kind)
    if row_size != ROW_SIZE:
        raise ValueError(f"the quantize kernel takes rows of {ROW_SIZE}, got {row_size}")
    _check("flat", flat, torch.float32, flat.device)
    n = flat.shape[0]
    rows = padded_rows(n)
    q = torch.empty(rows, ROW_SIZE, dtype=_wire_dtype(kind), device=flat.device)
    scales = torch.empty(rows, 1, dtype=torch.float32, device=flat.device)
    lib = _lib(KERNEL_SOURCE)
    rc = lib.tft_quantize_rowwise(
        flat.data_ptr(), q.data_ptr(), scales.data_ptr(), n, rows, _KIND_CODE[kind],
        _stream(flat),
    )
    _raise_on(rc, "quantize", lib)
    _count("quantize")
    return q, scales


def reduce_quantized_device(
    qs: torch.Tensor, scales: torch.Tensor, kind: str = INT8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused dequant-sum-requant of ``w`` quantized contributions: qs wire
    [w, rows, row_size], scales f32 [w, rows, 1] (or [w, rows]) → (wire
    [rows, row_size], f32 [rows, 1]) of the float32 sum."""
    if qs.dim() != 3:
        raise ValueError(f"qs must be [w, rows, row_size], got {tuple(qs.shape)}")
    w, rows, row_size = qs.shape
    if w < 1:
        raise ValueError("reduce_quantized_device needs at least one contribution, got w=0")
    if scales.numel() != w * rows:
        raise ValueError(f"scales {tuple(scales.shape)} do not match qs {tuple(qs.shape)}")
    if qs.device.type == "cpu":
        return reduce_quantized_plain(qs, scales, kind)
    if row_size != ROW_SIZE:
        raise ValueError(f"the reduce kernel takes rows of {ROW_SIZE}, got {row_size}")
    _check("qs", qs, _wire_dtype(kind), qs.device)
    _check("scales", scales, torch.float32, qs.device)
    q = torch.empty(rows, ROW_SIZE, dtype=qs.dtype, device=qs.device)
    out_scales = torch.empty(rows, 1, dtype=torch.float32, device=qs.device)
    lib = _lib(REDUCE_SOURCE)
    rc = lib.tft_reduce_quantized_sm90(
        qs.data_ptr(), scales.data_ptr(), q.data_ptr(), out_scales.data_ptr(), w, rows,
        _KIND_CODE[kind], _stream(qs),
    )
    _raise_on(rc, "reduce", lib)
    _count("reduce")
    return q, out_scales


def dequantize_rowwise_device(
    q: torch.Tensor, scales: torch.Tensor, n: int, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(wire [rows, row_size], f32 [rows, 1]) → float32 [n], written into
    ``out`` (f32, n elements) when given.  The wire kind is carried by
    ``q.dtype``."""
    kind = _kind_of(q)
    if q.dim() != 2 or scales.numel() != q.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} and scales {tuple(scales.shape)} do not match")
    if not 0 <= n <= q.numel():
        raise ValueError(f"n={n} is outside the payload's {q.numel()} elements")
    if out is not None and out.numel() != n:
        raise ValueError(f"out has {out.numel()} elements, not n={n}")
    if q.device.type == "cpu" and (out is None or out.device.type == "cpu"):
        plain = dequantize_rowwise_plain(q, scales, n)
        return plain if out is None else out.copy_(plain.view(out.shape))
    if q.shape[1] != ROW_SIZE:
        raise ValueError(f"the dequantize kernel takes rows of {ROW_SIZE}, got {q.shape[1]}")
    _check("q", q, q.dtype, q.device)
    _check("scales", scales, torch.float32, q.device)
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=q.device)
    _check("out", out, torch.float32, q.device)
    lib = _lib(KERNEL_SOURCE)
    rc = lib.tft_dequantize_rowwise(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, _KIND_CODE[kind], _stream(q),
    )
    _raise_on(rc, "dequantize", lib)
    _count("dequantize")
    return out


# int8-named surface, as in the JAX package
def quantize_int8_rowwise_device(
    flat: torch.Tensor, row_size: int = ROW_SIZE
) -> Tuple[torch.Tensor, torch.Tensor]:
    return quantize_rowwise_device(flat, row_size, INT8)


def dequantize_int8_rowwise_device(q: torch.Tensor, scales: torch.Tensor, n: int) -> torch.Tensor:
    return dequantize_rowwise_device(q, scales, n)
