"""The AVG divide of a summed gradient on the card, into the ``.grad`` leaves.

A ring returns each bucket's SUM on the host; ``ddp.py`` copies it back to
the card as it is and :func:`average_into` divides it by the participant
count there, storing each element in its leaf's dtype
(``csrc/avg.cu``).  The host's arithmetic is kept bit for bit: a bf16 sum
widens exactly to f32, the quotient is the IEEE f32 division rounded to
nearest even, a bf16 result rounds that quotient to nearest even, and a
NaN sum gives ml_dtypes' quiet NaN with the sum's sign in bf16 (what
``bf16.div`` gives) and the sum itself made quiet in f32 (what numpy's
division gives on x86) — not the card's canonical NaN.

Beside the kernel sits its plain PyTorch version (:func:`average_into_plain`),
the same operations.  The wrapper takes the plain version only for tensors
on the CPU; for a CUDA tensor it launches the kernel or raises.  Each
launch adds one to ``launches["avg"]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from torchft_tpu_torch.ops import cuda_build

KERNEL_SOURCE = "avg"
KERNEL_SOURCES = (KERNEL_SOURCE,)
# the dtypes the kernel reads and writes, by its kind code
KINDS = {torch.float32: 0, torch.bfloat16: 1}

_QNAN, _NEG_QNAN = 0x7FC0, -0x40  # bf16 0x7fc0 / 0xffc0 as int16
_QUIET_F32 = 0x00400000

# launch counts of the kernel since the last reset_launches()
launches: Dict[str, int] = {"avg": 0}
_launch_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib_cache: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _launch_lock:
        launches["avg"] = 0


def average_into_plain(src: torch.Tensor, divisor: int, dst: torch.Tensor) -> None:
    """``dst = src / divisor`` in eager torch, the kernel's arithmetic.  The
    divisor is a tensor: torch on CUDA turns division by a Python scalar
    into a multiply by its reciprocal, which is not the IEEE division."""
    x = src.reshape(-1).float()
    q = x / torch.full((), float(divisor), device=x.device)
    nan = torch.isnan(x)
    if dst.dtype == torch.bfloat16:
        bits = q.to(torch.bfloat16).view(torch.int16)
        signed = torch.where(torch.signbit(x), _NEG_QNAN, _QNAN).to(torch.int16)
        out = torch.where(nan, signed, bits).view(torch.bfloat16)
    else:
        quiet = (x.view(torch.int32) | _QUIET_F32).view(torch.float32)
        out = torch.where(nan, quiet, q).to(dst.dtype)
    dst.copy_(out.view(dst.shape))


def _lib() -> ctypes.CDLL:
    with _lib_lock:
        lib = _lib_cache.get(KERNEL_SOURCE)
        if lib is None:
            lib = cuda_build.load(KERNEL_SOURCE)
            P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.tft_average_into.argtypes = [P, I, P, I, L, L, P]
            lib.tft_average_into.restype = I
            lib.tft_average_error_string.argtypes = [I]
            lib.tft_average_error_string.restype = ctypes.c_char_p
            _lib_cache[KERNEL_SOURCE] = lib
        return lib


def average_into(src: torch.Tensor, divisor: int, dst: torch.Tensor) -> None:
    """``dst = src / divisor`` element by element (``src`` flat, ``dst`` any
    shape of as many elements; the same memory divides in place), each in
    its own dtype, f32 or bf16: on the card by the kernel, on the stream
    current for ``dst``'s device; on the CPU by the plain version."""
    if src.numel() != dst.numel():
        raise ValueError(f"src has {src.numel()} elements, dst {dst.numel()}")
    if divisor < 1:
        raise ValueError(f"divisor must be at least 1, got {divisor}")
    if src.device.type == "cpu" and dst.device.type == "cpu":
        average_into_plain(src, divisor, dst)
        return
    for name, t in (("src", src), ("dst", dst)):
        if t.device != dst.device or t.dtype not in KINDS or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 or bf16 tensor on {dst.device}, "
                             f"got {t.dtype} on {t.device}")
    lib = _lib()
    rc = lib.tft_average_into(
        src.data_ptr(), KINDS[src.dtype], dst.data_ptr(), KINDS[dst.dtype], dst.numel(),
        divisor, torch.cuda.current_stream(dst.device).cuda_stream,
    )
    if rc:
        msg = "bad argument" if rc < 0 else lib.tft_average_error_string(rc).decode()
        raise RuntimeError(f"avg kernel launch failed ({rc}): {msg}")
    with _launch_lock:
        launches["avg"] += 1
