"""Fault-tolerant data parallelism over the replica dimension.

The port of ``torchft_tpu/ddp.py``.  Gradients are the ``.grad`` tensors of
a module's parameters; the replica-dim average runs on the host.

- Float path: each dtype's gradients are flattened into buckets of at most
  ``TORCHFT_BUCKET_CAP_MB`` (the JAX package's boundaries), copied to pinned
  host memory with non-blocking transfers started up front, ring-allreduced
  by ``Manager.allreduce`` over the TCP communicator, and copied back into
  the ``.grad`` tensors in place.  bf16 buckets travel as bf16 bytes (the
  bit pattern, ``bf16.py``) and are added and divided as ml_dtypes does, so
  the result is bit-identical to the JAX package's at any replica count and
  a mixed quorum exchanges frames of one size.
- Quantized path (``should_quantize=True``): the gradients are flattened to
  f32 on the card and quantized there by the rowwise kernel
  (``ops.quant``); only the 1-byte payload and the f32 scales are copied to
  the host, averaged by ``Manager.allreduce_prequantized`` (the windowed
  quantized pipeline, whose per-window reduce runs on the card too), and
  copied back into the ``.grad`` tensors.
- Parameter averaging (:func:`allreduce_tensors`, LocalSGD's sync): the
  same buckets and rings over the tensors themselves; the averaged host
  tensors are returned, not written back.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
from concurrent.futures import Future
from typing import Callable, Dict, Iterable, List, Optional, Tuple, TypeVar, Union

import numpy as np
import torch
from torch import nn

from torchft_tpu_torch import bf16
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.work import DummyWork, Work

logger = logging.getLogger(__name__)

T = TypeVar("T")

# Split gradient buckets at this size (same knob, parse and default as the
# JAX package).  MUST be uniform across replicas: bucket boundaries shape
# the collective sequence.
BUCKET_CAP_MB_ENV = "TORCHFT_BUCKET_CAP_MB"
DEFAULT_BUCKET_CAP_MB = 32


@functools.lru_cache(maxsize=None)
def _parse_bucket_cap(raw: str) -> int:
    try:
        mb = float(raw) if raw else float(DEFAULT_BUCKET_CAP_MB)
    except ValueError:
        logger.warning(
            "invalid %s=%r; using %d MB", BUCKET_CAP_MB_ENV, raw, DEFAULT_BUCKET_CAP_MB
        )
        mb = float(DEFAULT_BUCKET_CAP_MB)
    return max(1, int(mb * (1 << 20)))


def _bucket_cap_bytes() -> int:
    return _parse_bucket_cap(os.environ.get(BUCKET_CAP_MB_ENV, ""))


def bucket_groups(nbytes: List[int], dtypes: List[str], cap: int) -> List[List[int]]:
    """Indices grouped per dtype (in first-seen order), each group split
    greedily at ``cap`` bytes — the bucket boundaries of
    ``torchft_tpu.ddp.allreduce_pytree``."""
    order: Dict[str, List[int]] = {}
    for i, name in enumerate(dtypes):
        order.setdefault(name, []).append(i)
    groups: List[List[int]] = []
    for idxs in order.values():
        group: List[int] = []
        group_bytes = 0
        for i in idxs:
            if group and group_bytes + nbytes[i] > cap:
                groups.append(group)
                group, group_bytes = [], 0
            group.append(i)
            group_bytes += nbytes[i]
        if group:
            groups.append(group)
    return groups


def _gradients(module_or_params: Union[nn.Module, Iterable[torch.Tensor]]) -> List[torch.Tensor]:
    params = (
        module_or_params.parameters()
        if isinstance(module_or_params, nn.Module)
        else module_or_params
    )
    return [p.grad for p in params if p.grad is not None]


def allreduce_gradients(
    manager: Manager,
    module_or_params: Union[nn.Module, Iterable[torch.Tensor]],
    should_quantize: bool = False,
) -> Work:
    """Average the ``.grad`` tensors across participating replicas, in
    place.  Returns a Work whose value is the list of gradient tensors;
    the whole composite (rings and copy-back) is fenced at
    ``should_commit``.  Error swallowing and participation zeroing happen
    inside ``manager.allreduce``: on error the gradients keep this
    replica's values and the vote discards the step."""
    grads = _gradients(module_or_params)
    if manager.errored() or manager.allreduce_is_identity() or not grads:
        # single-member quorum: averaging is the identity; skip the
        # device→host→device round trip entirely
        return DummyWork(grads)
    if should_quantize:
        return _allreduce_gradients_device_quantized(manager, grads)

    groups, works = _submit_buckets(manager, grads, should_quantize=False, register_pending=True)

    def _copy_back() -> List[torch.Tensor]:
        for g, avg in zip(grads, _gather(grads, groups, works)):
            g.copy_(avg)  # casts back, moves H2D
        return grads

    return _composite(manager, _copy_back, grads)


def allreduce_tensors(
    manager: Manager,
    tensors: List[torch.Tensor],
    should_quantize: bool = False,
    stream: Optional[int] = None,
) -> Work:
    """Average ``tensors`` themselves (not their ``.grad``) across the
    participating replicas: the counterpart of ``allreduce_pytree``, on the
    same buckets as :func:`allreduce_gradients`.

    The Work's value is the list of averaged host tensors, in ``tensors``'
    dtypes and shapes; nothing is written back (LocalSGD adopts them only
    on a committed vote).  When averaging is the identity, or this step
    already errored, the value is ``tensors`` themselves.
    ``should_quantize`` sends each bucket through the host-quantized wire
    (``Manager.allreduce(should_quantize=True)``).

    ``stream``, when given, marks an ASYNC streamed submit (the
    TORCHFT_STREAM_SYNC LocalSGD scheduler): exactly one Work — the
    composite covering every bucket ring and the gather — registers in the
    Manager's stream-fence registry instead of the pending works; the
    bucket rings register nowhere."""
    tensors = list(tensors)
    if manager.errored() or manager.allreduce_is_identity() or not tensors:
        out = DummyWork(tensors)
        return out if stream is None else manager.stream_submitted(stream, out)

    groups, works = _submit_buckets(
        manager, tensors, should_quantize=should_quantize, register_pending=stream is None
    )
    return _composite(manager, lambda: _gather(tensors, groups, works), tensors, stream)


def _gather(
    tensors: List[torch.Tensor], groups: List[List[int]], works: List[Work]
) -> List[torch.Tensor]:
    """Each tensor's average: a host view into its bucket's result."""
    out = list(tensors)
    for group, work in zip(groups, works):
        avg = _host_tensor(work.wait())
        off = 0
        for i in group:
            n = tensors[i].numel()
            out[i] = avg[off : off + n].view(tensors[i].shape)
            off += n
    return out


def _submit_buckets(
    manager: Manager, tensors: List[torch.Tensor], should_quantize: bool, register_pending: bool
) -> Tuple[List[List[int]], List[Work]]:
    """Flatten ``tensors`` into the dtype buckets of :func:`bucket_groups`,
    copy each to (pinned) host memory and submit its ring.  Every
    device→host copy starts up front (non-blocking into pinned memory, an
    event behind each), so the transfers of later buckets overlap the
    earlier rings; a bucket's ring is submitted once its event completes.
    Returns the buckets (indices into ``tensors``) and their rings' Works."""
    groups = bucket_groups(
        [t.numel() * t.element_size() for t in tensors],
        [str(t.dtype) for t in tensors],
        _bucket_cap_bytes(),
    )
    staged: List[Tuple[List[int], torch.Tensor, object]] = []
    for group in groups:
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in group])
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = flat, None
        staged.append((group, host, done))

    works: List[Work] = []
    for _group, host, done in staged:
        if done is not None:
            done.synchronize()
        # in_place: the bucket is ours and discarded after the gather
        works.append(
            manager.allreduce(
                _host_array(host),
                should_quantize=should_quantize,
                in_place=True,
                register_pending=register_pending,
            )
        )
    return groups, works


def _composite(manager: Manager, finish: Callable[[], T], fallback: T, stream: Optional[int] = None) -> Work:
    """Run ``finish`` off-thread and register the composite with the
    manager (the stream-fence registry when ``stream`` is given): the WHOLE
    pipeline (including the copy-back or gather) is fenced at commit, not
    just the wire — a copy-back failure after the vote would otherwise
    apply unaveraged values on this replica only.  On an error the value is
    ``fallback`` and the vote discards the step."""
    fut: "Future[T]" = Future()

    def _run() -> None:
        try:
            fut.set_result(finish())
        except Exception as e:  # noqa: BLE001 — funnel, never raise
            manager.report_error(e)
            fut.set_result(fallback)

    threading.Thread(target=_run, name="tpuft_ddp_gather", daemon=True).start()
    out = Work(fut)
    if stream is None:
        manager._register_pending(out)
    else:
        manager.stream_submitted(stream, out)
    return out


def _host_array(host: torch.Tensor) -> np.ndarray:
    """A host bucket as the numpy array the ring reduces: bf16 as its bit
    pattern (:data:`bf16.BF16`), every other dtype as itself."""
    return bf16.from_tensor(host) if host.dtype == torch.bfloat16 else host.numpy()


def _host_tensor(avg: np.ndarray) -> torch.Tensor:
    return bf16.to_tensor(avg) if bf16.is_bf16(avg) else torch.from_numpy(avg)


def _flatten_f32(grads: List[torch.Tensor]) -> torch.Tensor:
    """Every gradient, widened to f32, in one flat tensor on their device;
    each leaf is cast straight into its slice, so no per-leaf f32 copy is
    made."""
    flat = torch.empty(sum(g.numel() for g in grads), dtype=torch.float32, device=grads[0].device)
    off = 0
    for g in grads:
        n = g.numel()
        flat[off : off + n].copy_(g.detach().reshape(-1))
        off += n
    return flat


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _allreduce_gradients_device_quantized(manager: Manager, grads: List[torch.Tensor]) -> Work:
    """Device quantize → Manager-orchestrated wire pipeline → copy back.

    The counterpart of ``_allreduce_pytree_device_quantized``: the
    fault-tolerance orchestration (quorum wait, participation zeroing,
    capacity weight, error funnel) lives in
    ``Manager.allreduce_prequantized``; this function flattens and
    quantizes on the card, ships the 1-byte payload and the scales to the
    host, and copies the average back into the ``.grad`` tensors
    (``copy_`` rounds f32 to bf16 to nearest even)."""
    from torchft_tpu_torch.ops.quant import quantize_rowwise_device
    from torchft_tpu_torch.quantization import FP8, quant_kind

    try:
        kind = quant_kind()
        flat = _flatten_f32(grads)
        n = flat.numel()
        q, scales = quantize_rowwise_device(flat, kind=kind)
        del flat  # the f32 copy is the largest buffer of the step
        if kind == FP8:
            q = q.view(torch.uint8)  # the host holds e4m3 as its bit pattern
        # the only device→host bytes: the 1-byte payload + rowwise scales
        q_np = _to_host(q).numpy()
        s_np = _to_host(scales).numpy()
        work = manager.allreduce_prequantized(q_np, s_np, n)
    except Exception as e:  # noqa: BLE001 — errors never reach the train loop
        manager.report_error(e)
        return DummyWork(grads)

    def _copy_back() -> List[torch.Tensor]:
        avg = torch.from_numpy(work.wait())
        off = 0
        for g in grads:
            k = g.numel()
            g.copy_(avg[off : off + k].view(g.shape))  # casts, moves H2D
            off += k
        return grads

    return _composite(manager, _copy_back, grads)
