"""Rowwise quantization (int8 / fp8) for bandwidth-reduced collectives.

The port of ``torchft_tpu/quantization.py``: the host side of the wire
format, as vectorized numpy (the JAX package's optional C++ tier is not
ported).  The device twins, hand-written CUDA kernels, live in
``torchft_tpu_torch/ops/quant.py``.

Wire format per buffer: the flat array is viewed as rows of ``row_size``
elements (last row padded); each row is scaled by ``max(|row|)/Q`` into the
wire dtype — int8 (Q=127) or float8_e4m3fn (Q=448).  Scales travel as
float32 alongside the payload.  Both formats are one byte per element.

fp8 without ml_dtypes: the host holds e4m3 payloads as their ``uint8`` bit
patterns and converts through torch's ``float8_e4m3fn`` (round to nearest
even after the clip to ±448), which gives the same bytes as ml_dtypes.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

DEFAULT_ROW_SIZE = 1024
FP8_MAX = 448.0

INT8 = "int8"
FP8 = "fp8"


def quant_kind() -> str:
    """The configured wire format for quantized collectives:
    ``TORCHFT_QUANT_KIND`` = ``int8`` (default) or ``fp8`` (e4m3).  Raises
    on anything else — the Manager validates at startup so a typo fails
    fast instead of silently discarding every step through the error
    funnel."""
    kind = os.environ.get("TORCHFT_QUANT_KIND", INT8).strip().lower()
    if kind not in (INT8, FP8):
        raise ValueError(
            f"TORCHFT_QUANT_KIND={kind!r}: must be {INT8!r} or {FP8!r}"
        )
    return kind


def wire_dtype(kind: str) -> np.dtype:
    """Host dtype of a payload: int8, or fp8's bit pattern as uint8."""
    if kind == INT8:
        return np.dtype(np.int8)
    if kind == FP8:
        return np.dtype(np.uint8)
    raise ValueError(f"unknown wire dtype {kind!r}")


def _wire_max(kind: str) -> float:
    return 127.0 if kind == INT8 else FP8_MAX


def _fp8_encode(x: np.ndarray) -> np.ndarray:
    """f32 (already clipped to ±448) → e4m3fn bit patterns (uint8)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return t.to(torch.float8_e4m3fn).view(torch.uint8).numpy()


def _fp8_decode(bits: np.ndarray) -> np.ndarray:
    """e4m3fn bit patterns (uint8) → f32, exactly."""
    t = torch.from_numpy(np.ascontiguousarray(bits, dtype=np.uint8))
    return t.view(torch.float8_e4m3fn).float().numpy()


def _to_f32(q: np.ndarray) -> np.ndarray:
    return _fp8_decode(q) if q.dtype == np.uint8 else q.astype(np.float32)


# Rows quantized at a time: bounds the f32 temporaries of a large buffer to
# a few of these blocks.  Each row is quantized on its own, so the bytes do
# not depend on it.
_BLOCK_ROWS = 16384


def _requantize(x: np.ndarray, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """Rows of f32 ``x`` [rows, row_size] → (payload, f32 scales [rows])."""
    if x.shape[0] > _BLOCK_ROWS:
        q = np.empty(x.shape, wire_dtype(kind))
        scales = np.empty(x.shape[0], np.float32)
        for r in range(0, x.shape[0], _BLOCK_ROWS):
            q[r : r + _BLOCK_ROWS], scales[r : r + _BLOCK_ROWS] = _requantize(
                x[r : r + _BLOCK_ROWS], kind
            )
        return q, scales
    qmax = _wire_max(kind)
    absmax = np.abs(x).max(axis=1)
    scales = (absmax / qmax).astype(np.float32)
    safe = np.where(scales > 0, scales, 1.0)
    scaled = x / safe[:, None]
    if kind == INT8:
        q = np.clip(np.rint(scaled), -127, 127).astype(np.int8)
    else:
        q = _fp8_encode(np.clip(scaled, -qmax, qmax))
    return q, scales


def quantize_rowwise(
    flat: np.ndarray, row_size: int = DEFAULT_ROW_SIZE, kind: str = INT8
) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize a flat float array → (1-byte payload [rows, row_size],
    float32 scales [rows]). The payload is padded to a whole row."""
    if flat.ndim != 1:
        raise ValueError(f"quantize_rowwise takes a flat array, got shape {flat.shape}")
    n = flat.size
    rows = max(1, -(-n // row_size))
    if flat.dtype == np.float32 and n == rows * row_size:
        return _requantize(flat.reshape(rows, row_size), kind)  # whole rows: no copy
    padded = np.zeros(rows * row_size, dtype=np.float32)
    padded[:n] = flat.astype(np.float32, copy=False)
    return _requantize(padded.reshape(rows, row_size), kind)


def dequantize_rowwise(
    q: np.ndarray, scales: np.ndarray, n: int, dtype: np.dtype
) -> np.ndarray:
    """Inverse of :func:`quantize_rowwise`, truncated to ``n`` (dtype of
    ``q`` distinguishes the wire format)."""
    out = (_to_f32(q) * scales[:, None]).reshape(-1)[:n]
    return out.astype(dtype, copy=False)


def reduce_quantized(
    qs: np.ndarray, scales: np.ndarray, kind: str = INT8
) -> Tuple[np.ndarray, np.ndarray]:
    """Sum ``w`` quantized copies: qs [w, rows, row_size], scales [w, rows]
    → requantized (q [rows, row_size], scales [rows]) of the float sum.

    The accumulate happens in float32, contributions added onto +0 in
    ascending ``w`` (numpy's sum); the device twin is
    ``ops.quant.reduce_quantized_device``."""
    total = (_to_f32(qs) * scales[:, :, None]).sum(axis=0)
    return _requantize(total, kind)


# int8-named surface, as in the JAX package
def quantize_int8_rowwise(
    flat: np.ndarray, row_size: int = DEFAULT_ROW_SIZE
) -> Tuple[np.ndarray, np.ndarray]:
    return quantize_rowwise(flat, row_size, INT8)


def dequantize_int8_rowwise(
    q: np.ndarray, scales: np.ndarray, n: int, dtype: np.dtype
) -> np.ndarray:
    return dequantize_rowwise(q, scales, n, dtype)
