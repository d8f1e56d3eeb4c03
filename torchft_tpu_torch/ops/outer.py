"""DiLoCo's sharded outer update on the card, one pipeline chunk at a time.

The owner of a shard of the outer optimizer state receives, per chunk, the
``w`` replicas' f32 pseudo-gradient contributions; :func:`outer_update`
sums them, scales the sum by ``1/P`` and steps the outer SGD (optionally
Nesterov) momentum on the shard's trace, writing the delta every replica
applies and the new trace (``csrc/outer.cu``):

    g = (0 + c[0] + c[1] + ... + c[w-1]) * scale   (c[0] * scale at w = 1)
    t' = g + m·t;   d = g + m·t' (Nesterov) | t' (momentum) | g (none)
    delta = (−lr)·d

Each product and sum is rounded on its own and the scalars are f32, so the
result is the host pipeline's bit for bit: ``np.sum(np.stack(g), axis=0)``
(which starts from +0, so a sum of -0s is +0; a single contribution is
scaled as it is), ``acc *= 1/P`` and
:meth:`~torchft_tpu_torch.optim.OuterSGD.update`.  A NaN result carries the
card's canonical NaN bits where the host's carry an operand's payload.

Beside the kernel sits its plain PyTorch version (:func:`outer_update_plain`),
the same operations, each a separate one (``torch.add(..., alpha=)`` may
fuse its product and sum, so it is not used).  The wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.  Each launch adds one to ``launches["outer"]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from torchft_tpu_torch.ops import cuda_build

KERNEL_SOURCE = "outer"
KERNEL_SOURCES = (KERNEL_SOURCE,)
# the kernel's update rule, by its mode code
MODE_SGD, MODE_MOMENTUM, MODE_NESTEROV = 0, 1, 2

# launch counts of the kernel since the last reset_launches()
launches: Dict[str, int] = {"outer": 0}
_launch_lock = threading.Lock()
_lib_lock = threading.Lock()
_lib_cache: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _launch_lock:
        launches["outer"] = 0


def _mode(momentum: float, nesterov: bool) -> int:
    if not momentum:
        if nesterov:
            raise ValueError("nesterov needs a momentum")
        return MODE_SGD
    return MODE_NESTEROV if nesterov else MODE_MOMENTUM


def outer_update_plain(
    contribs: torch.Tensor,
    scale: float,
    delta: torch.Tensor,
    lr: float,
    momentum: float = 0.0,
    nesterov: bool = False,
    trace: Optional[torch.Tensor] = None,
    new_trace: Optional[torch.Tensor] = None,
) -> None:
    """The kernel's arithmetic in eager torch, one operation at a time,
    each scalar cast to f32 first (as ``np.float32(-lr)`` is)."""

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32).to(contribs.device)

    w = contribs.shape[0]
    g = contribs[0].clone() if w == 1 else torch.zeros_like(contribs[0]) + contribs[0]
    for k in range(1, w):
        g = g + contribs[k]
    g = g * f32(scale)
    mode = _mode(momentum, nesterov)
    if mode == MODE_SGD:
        d = g
    else:
        assert trace is not None and new_trace is not None
        t = g + f32(momentum) * trace
        d = g + f32(momentum) * t if mode == MODE_NESTEROV else t
        new_trace.copy_(t)
    delta.copy_(f32(-lr) * d)


def _lib() -> ctypes.CDLL:
    with _lib_lock:
        lib = _lib_cache.get(KERNEL_SOURCE)
        if lib is None:
            lib = cuda_build.load(KERNEL_SOURCE)
            P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
            lib.tft_outer_update.argtypes = [P, I, L, F, F, F, I, P, P, P, P]
            lib.tft_outer_update.restype = I
            lib.tft_outer_error_string.argtypes = [I]
            lib.tft_outer_error_string.restype = ctypes.c_char_p
            _lib_cache[KERNEL_SOURCE] = lib
        return lib


def outer_update(
    contribs: torch.Tensor,
    scale: float,
    delta: torch.Tensor,
    lr: float,
    momentum: float = 0.0,
    nesterov: bool = False,
    trace: Optional[torch.Tensor] = None,
    new_trace: Optional[torch.Tensor] = None,
) -> None:
    """One chunk's outer update: ``contribs`` f32 [w, n] (the gathered
    contributions, in rank order), ``delta`` f32 [n] written; with a
    momentum, ``trace`` f32 [n] read and ``new_trace`` f32 [n] written (it
    may be ``trace``).  On the card by the kernel, on the stream current for
    ``delta``'s device; on the CPU by the plain version."""
    mode = _mode(momentum, nesterov)
    if contribs.dim() != 2 or contribs.shape[0] < 1:
        raise ValueError(f"contribs must be [w >= 1, n], got {tuple(contribs.shape)}")
    n = contribs.shape[1]
    tensors = {"contribs": contribs, "delta": delta}
    if mode != MODE_SGD:
        if trace is None or new_trace is None:
            raise ValueError("a momentum needs trace and new_trace")
        tensors.update(trace=trace, new_trace=new_trace)
    for name, t in tensors.items():
        if name != "contribs" and t.numel() != n:
            raise ValueError(f"{name} has {t.numel()} elements, the contributions {n}")
    if all(t.device.type == "cpu" for t in tensors.values()):
        outer_update_plain(contribs, scale, delta, lr, momentum, nesterov, trace, new_trace)
        return
    for name, t in tensors.items():
        if t.device != delta.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 tensor on {delta.device}, "
                             f"got {t.dtype} on {t.device}")
    lib = _lib()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.tft_outer_update(
        contribs.data_ptr(), contribs.shape[0], n, scale, momentum, -lr, mode,
        ptr(trace), ptr(new_trace), delta.data_ptr(),
        torch.cuda.current_stream(delta.device).cuda_stream,
    )
    if rc:
        msg = "bad argument" if rc < 0 else lib.tft_outer_error_string(rc).decode()
        raise RuntimeError(f"outer kernel launch failed ({rc}): {msg}")
    with _launch_lock:
        launches["outer"] += 1
