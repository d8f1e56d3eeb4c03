"""bfloat16 on the host, without an extension dtype.

The JAX package holds bf16 host buffers as ``ml_dtypes.bfloat16``; the port
has no ml_dtypes.  A bf16 host buffer here is an array of :data:`BF16`, a
one-field structured dtype over the raw ``uint16`` bit pattern: the same two
bytes per element on the wire, and a dtype that numpy keeps through views,
slices, copies and concatenation, so the ring can tell it from a genuine
``uint16`` buffer (which still reduces as an integer).

Arithmetic matches ml_dtypes bit for bit: each operand widens exactly to f32,
the operation runs in f32, and the result rounds to nearest even.  A NaN
result becomes ml_dtypes' quiet NaN (``0x7fc0``) with the sign the f32
operation gave it on x86: the first NaN operand's, else negative (the
default NaN of ``inf - inf``).  The element-wise work runs as torch CPU
operations, which use every core; numpy's per-pass version of the same
arithmetic is ~10x slower on the gradient ring.
"""

from __future__ import annotations

import numpy as np
import torch

BF16 = np.dtype([("bf16", "<u2")])

_QNAN, _NEG_QNAN = 0x7FC0, -0x40  # 0xffc0 as int16


def is_bf16(a: np.ndarray) -> bool:
    return a.dtype == BF16


def from_tensor(t: torch.Tensor) -> np.ndarray:
    """A CPU bf16 tensor's memory as a :data:`BF16` array (no copy)."""
    return t.view(torch.int16).numpy().view(BF16)


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """A :data:`BF16` array as a CPU bf16 tensor sharing its memory."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)


def _round(total: torch.Tensor, *operands: torch.Tensor) -> torch.Tensor:
    """f32 ``total`` of ``operands`` (f32) rounded to bf16 as ml_dtypes
    rounds it, NaN signs included."""
    out = total.to(torch.bfloat16)
    nan = torch.isnan(total)
    if bool(nan.any()):
        negative = torch.ones_like(nan)
        for op in reversed(operands):
            negative = torch.where(torch.isnan(op), torch.signbit(op), negative)
        bits = torch.where(negative, _NEG_QNAN, _QNAN).to(torch.int16)
        out.view(torch.int16)[nan] = bits[nan]
    return out


def to_f32(a: np.ndarray) -> np.ndarray:
    """Exact widening of a :data:`BF16` array to f32."""
    return to_tensor(a).float().numpy().reshape(a.shape)


def from_f32(x: np.ndarray) -> np.ndarray:
    """Round f32 to nearest even bf16 (as a :data:`BF16` array)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return from_tensor(_round(t, t)).reshape(np.shape(x))


def _finite(t: torch.Tensor) -> bool:
    """No NaN or inf in bf16 ``t``: no element has an all-ones exponent."""
    return int(t.view(torch.int16).bitwise_and(0x7F80).max()) != 0x7F80


def assign(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[...] = src`` for :data:`BF16` arrays, through their uint16 view
    (numpy copies structured elements one by one)."""
    dst.view(np.uint16)[...] = src.view(np.uint16).reshape(dst.shape)


def add_into(acc: np.ndarray, incoming: np.ndarray) -> None:
    """``acc += incoming`` in bf16, in place (ml_dtypes' add)."""
    a, b = to_tensor(acc), to_tensor(incoming)
    if a.numel() == 0:
        return
    if acc.flags.c_contiguous and _finite(a) and _finite(b):
        # finite operands make no NaN, and torch's own bf16 add is the f32
        # add rounded to nearest even: one pass, in acc's memory
        a.add_(b)
        return
    a, b = a.float(), b.float()
    assign(acc, from_tensor(_round(a + b, a, b)))


def div(a: np.ndarray, n: int) -> np.ndarray:
    """``(a / n).astype(bfloat16)``, out of place: ml_dtypes divides a bf16
    array by a Python int in f32."""
    x = to_tensor(a).float()
    return from_tensor(_round(x / n, x)).reshape(a.shape)


def scale(a: np.ndarray, factor: float) -> np.ndarray:
    """``(a * factor).astype(bfloat16)``: the product in f32, rounded once."""
    x = to_tensor(a).float()
    return from_tensor(_round(x * float(factor), x)).reshape(a.shape)
