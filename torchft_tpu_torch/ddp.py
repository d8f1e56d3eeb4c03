"""Fault-tolerant data parallelism over the replica dimension.

The port of ``torchft_tpu/ddp.py``.  Gradients are the ``.grad`` tensors of
a module's parameters; the replica-dim average runs on the host.

- Float path: each dtype's gradients are flattened into buckets of at most
  ``TORCHFT_BUCKET_CAP_MB`` (the JAX package's boundaries), copied to
  pinned host memory with non-blocking transfers started up front, and
  ring-summed in place by
  ``Manager.allreduce`` over the TCP communicator.  Each bucket's SUM goes
  back to the card from its buffer, and the avg kernel (``ops.avg``)
  divides it by the participant count into the ``.grad`` tensors.  bf16
  buckets travel as bf16 bytes (the bit pattern, ``bf16.py``), are added
  as ml_dtypes adds and divided as it divides, so the result is
  bit-identical to the JAX package's at any replica count and a mixed
  quorum exchanges frames of one size.
- Quantized path (``should_quantize=True``): the gradients are flattened to
  f32 on the card and quantized there by the rowwise kernel
  (``ops.quant``); only the 1-byte payload and the f32 scales are copied to
  the host and summed by ``Manager.allreduce_prequantized`` (the windowed
  quantized pipeline, whose per-window reduce runs on the card too), which
  hands back the reduced stream in the same buffers; the card dequantizes
  it and divides it into the ``.grad`` tensors.
- Parameter averaging (:func:`allreduce_tensors`, LocalSGD's sync): the
  same buckets and rings over the tensors themselves; the averaged host
  tensors are returned, not written back.
- Sharded gradients (HSDP, ``parallel/hsdp.py``): a DTensor gradient
  contributes only its local shard (``to_local()``) and the average is
  written back into that shard.  Rank r of every replica group holds the
  same region (equal meshes and placements), and the Manager of rank r
  rings with rank r of the other groups, so shard-local averaging is exact
  and no rank ever assembles a whole tensor — the JAX package's
  ``_host_contribution``, with a rank in the place of a host.
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
from torchft_tpu_torch.checkpointing.serialization import ShardedHostArray
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.obs.spans import span as obs_span
from torchft_tpu_torch.ops import avg as avg_ops
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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage), any other tensor
    itself: what this rank contributes to the replica-dim average."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def allreduce_gradients(
    manager: Manager,
    module_or_params: Union[nn.Module, Iterable[torch.Tensor]],
    should_quantize: bool = False,
) -> Work:
    """Average the ``.grad`` tensors across participating replicas, in
    place (a DTensor gradient: its local shard).  Returns a Work whose
    value is the list of gradient tensors (local shards); the whole
    composite (rings and copy-back) is fenced at ``should_commit``.  Error
    swallowing and participation zeroing happen inside
    ``manager.allreduce``: on error the gradients keep this replica's
    values and the vote discards the step."""
    return _average_in_place(manager, _gradients(module_or_params), should_quantize)


def _average_in_place(
    manager: Manager, tensors: List[torch.Tensor], should_quantize: bool
) -> Work:
    grads = [_local(g) for g in tensors]
    with obs_span("ddp::quorum_wait"):  # the async quorum, if still running
        identity = manager.errored() or manager.allreduce_is_identity()
    if identity or not grads:
        # single-member quorum: averaging is the identity; skip the
        # device→host→device round trip entirely
        return DummyWork(grads)
    if should_quantize:
        return _allreduce_gradients_device_quantized(manager, grads)

    groups, works, hosts = _submit_buckets(
        manager, grads, should_quantize=False, register_pending=True, summed=True
    )
    divisor = manager.num_participants()

    def _copy_back() -> List[torch.Tensor]:
        try:
            for group, work, host in zip(groups, works, hosts):
                value = work.wait()
                if manager.errored() is not None:
                    break  # the vote discards this step
                leaves = [grads[i] for i in group]
                with obs_span("ddp::copy_back"):
                    if host.dtype in avg_ops.KINDS:
                        _average_into(host, value, divisor, leaves)
                    else:  # a dtype the kernel does not take: divided on the host
                        for g, a in zip(leaves, _views(_host_tensor(value), leaves)):
                            g.copy_(a)
        finally:
            with obs_span("ddp::copy_back"):
                _wait_for_card(grads)  # the copies from the pinned buckets too
        return grads

    return _composite(manager, _copy_back, grads)


def _views(flat: torch.Tensor, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
    """``flat`` cut into one view per leaf, each in its leaf's shape."""
    out, off = [], 0
    for g in leaves:
        out.append(flat[off : off + g.numel()].view(g.shape))
        off += g.numel()
    return out


def _average_into(
    host: torch.Tensor, value: np.ndarray, divisor: int, leaves: List[torch.Tensor]
) -> None:
    """Write a bucket's SUM divided by ``divisor`` into its ``leaves``, on
    their device (``ops.avg``: the host divide's arithmetic bit for bit).
    ``value`` is what the ring returned, mostly ``host`` itself reduced in
    place; each leaf's part goes to the card straight from that pinned
    buffer into the leaf, and the kernel divides it there in place (no
    device buffer of the bucket's size)."""
    src = host if _aliases(value, host) else _host_tensor(value)
    off = 0
    for g in leaves:
        n = g.numel()
        dst = g if g.is_contiguous() else torch.empty_like(g, memory_format=torch.contiguous_format)
        flat = dst.view(-1)
        if flat.dtype == src.dtype:
            flat.copy_(src[off : off + n], non_blocking=True)
            avg_ops.average_into(flat, divisor, flat)
        else:  # the sum in another dtype (f32 into bf16): divided before the cast
            avg_ops.average_into(src[off : off + n].to(flat.device), divisor, flat)
        if dst is not g:
            g.copy_(dst)
        off += n


# elements of the f32 sum the int8 path dequantizes on the card at a time:
# the card holds one piece (256 MiB), not the whole gradient in f32
_DEQUANT_PIECE = 1 << 26


def _dequantize_average(
    q: torch.Tensor, scales: torch.Tensor, divisor: int, leaves: List[torch.Tensor]
) -> None:
    """The reduced int8 / fp8 stream ``q`` [rows, 1024], ``scales``
    [rows, 1] (on the leaves' device), dequantized piece by piece and each
    piece divided by ``divisor`` into the part of the leaves it covers."""
    from torchft_tpu_torch.ops.quant import ROW_SIZE, dequantize_rowwise_device

    off = 0
    for g in leaves:
        dst = g if g.is_contiguous() else torch.empty_like(g, memory_format=torch.contiguous_format)
        flat = dst.view(-1)
        for lo in range(0, flat.numel(), _DEQUANT_PIECE):
            hi = min(lo + _DEQUANT_PIECE, flat.numel())
            # rows from a multiple of 4 (the scales' 16-byte alignment)
            r0 = (off + lo) // ROW_SIZE // 4 * 4
            r1 = -(-(off + hi) // ROW_SIZE)
            part = dequantize_rowwise_device(q[r0:r1], scales[r0:r1], (r1 - r0) * ROW_SIZE)
            start = off + lo - r0 * ROW_SIZE
            avg_ops.average_into(part[start : start + hi - lo], divisor, flat[lo:hi])
        if dst is not g:
            g.copy_(dst)
        off += g.numel()


def _aliases(value: np.ndarray, host: torch.Tensor) -> bool:
    return (
        isinstance(value, np.ndarray)
        and value.__array_interface__["data"][0] == host.data_ptr()
        and value.nbytes == host.numel() * host.element_size()
    )


def _wait_for_card(tensors: List[torch.Tensor]) -> None:
    """Block until the card has finished the copies and kernels queued for
    ``tensors``, so a done composite means averaged gradients."""
    if tensors and tensors[0].is_cuda:
        torch.cuda.current_stream(tensors[0].device).synchronize()


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

    groups, works, _ = _submit_buckets(
        manager, tensors, should_quantize=should_quantize, register_pending=stream is None
    )
    return _composite(manager, lambda: _gather(tensors, groups, works), tensors, stream)


def _gather(
    tensors: List[torch.Tensor], groups: List[List[int]], works: List[Work]
) -> List[torch.Tensor]:
    """Each tensor's average: a host view into its bucket's result."""
    out = list(tensors)
    for group, work in zip(groups, works):
        value = work.wait()
        with obs_span("ddp::gather"):
            for i, view in zip(group, _views(_host_tensor(value), [tensors[i] for i in group])):
                out[i] = view
    return out


def _submit_buckets(
    manager: Manager,
    tensors: List[torch.Tensor],
    should_quantize: bool,
    register_pending: bool,
    summed: bool = False,
) -> Tuple[List[List[int]], List[Work], List[torch.Tensor]]:
    """Flatten ``tensors`` into the dtype buckets of :func:`bucket_groups`,
    copy each to (pinned) host memory and submit its ring.  Every
    device→host copy starts up front (non-blocking into pinned memory, an
    event behind each), so the transfers of later buckets overlap the earlier rings; a
    bucket's ring is submitted once its event completes.  With ``summed``
    (the gradient path) the ring of a bucket the card can divide (f32,
    bf16) returns its SUM: the caller divides (:func:`_average_into`).
    Returns the buckets (indices into ``tensors``), their rings' Works and
    their host buffers."""
    groups = bucket_groups(
        [t.numel() * t.element_size() for t in tensors],
        [str(t.dtype) for t in tensors],
        _bucket_cap_bytes(),
    )
    staged: List[Tuple[torch.Tensor, object]] = []
    for group in groups:
        with obs_span("ddp::stage"):
            flat = torch.cat([tensors[i].detach().reshape(-1) for i in group])
            if flat.is_cuda:
                host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                host.copy_(flat, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = flat, None
        staged.append((host, done))

    works: List[Work] = []
    for host, done in staged:
        if done is not None:
            with obs_span("ddp::stage"):
                done.synchronize()
        # in_place: the bucket is ours and discarded after the gather
        with obs_span("ddp::submit"):
            works.append(
                manager.allreduce(
                    _host_array(host),
                    should_quantize=should_quantize,
                    in_place=True,
                    register_pending=register_pending,
                    normalize=not summed or host.dtype not in avg_ops.KINDS,
                )
            )
    return groups, works, [host for host, _ in staged]


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
    """Device quantize → Manager-orchestrated wire pipeline → average on
    the card.

    The counterpart of ``_allreduce_pytree_device_quantized``: the
    fault-tolerance orchestration (quorum wait, participation zeroing,
    capacity weight, error funnel) lives in
    ``Manager.allreduce_prequantized``; this function flattens and
    quantizes on the card and ships the 1-byte payload and the scales to
    the host.  The pipeline returns the reduced stream in those same pinned
    buffers, and the card dequantizes it (``ops.quant``), divides it by the
    participant count and writes each gradient in its dtype (``ops.avg``):
    the host's f32 dequantize, divide and cast, bit for bit."""
    from torchft_tpu_torch.ops.quant import quantize_rowwise_device
    from torchft_tpu_torch.quantization import FP8, quant_kind

    try:
        kind = quant_kind()
        with obs_span("ddp::stage"):
            flat = _flatten_f32(grads)
            n = flat.numel()
            q, scales = quantize_rowwise_device(flat, kind=kind)
            del flat  # the f32 copy is the largest buffer of the step
            if kind == FP8:
                q = q.view(torch.uint8)  # the host holds e4m3 as its bit pattern
            # the only device→host bytes: the 1-byte payload + rowwise scales
            q_host, s_host = _to_host(q), _to_host(scales)
        with obs_span("ddp::submit"):
            work = manager.allreduce_prequantized(q_host.numpy(), s_host.numpy(), n)
            divisor = manager.num_participants()
    except Exception as e:  # noqa: BLE001 — errors never reach the train loop
        manager.report_error(e)
        return DummyWork(grads)

    def _copy_back() -> List[torch.Tensor]:
        value = work.wait()
        if manager.errored() is not None:
            return grads  # the vote discards this step
        device = grads[0].device
        with obs_span("ddp::copy_back"):
            if isinstance(value, tuple):  # the reduced stream
                q_sum = _onto(q_host, value[0], device)
                if kind == FP8:
                    q_sum = q_sum.view(torch.float8_e4m3fn)
                _dequantize_average(q_sum, _onto(s_host, value[1], device), divisor, grads)
            else:  # the f32 sum (a hierarchical topology dequantizes on the host)
                _average_into(torch.from_numpy(value), value, divisor, grads)
            _wait_for_card(grads)
        return grads

    return _composite(manager, _copy_back, grads)


def _onto(host: torch.Tensor, value: np.ndarray, device: torch.device) -> torch.Tensor:
    """``value`` on ``device``, from ``host``'s (pinned) memory when the
    pipeline wrote it there, in ``host``'s dtype and shape."""
    src = host if _aliases(value, host) else torch.from_numpy(value).view(host.dtype)
    return src.reshape(host.shape).to(device, non_blocking=True)


def ft_allreduce(
    manager: Manager, tensors: Iterable[torch.Tensor], should_quantize: bool = False
) -> List[torch.Tensor]:
    """Synchronous convenience: average ``tensors`` (gradients; a DTensor
    by its local shard) across the participating replicas in place and
    return them, or leave them unchanged if this step already errored (the
    vote will discard it)."""
    tensors = list(tensors)
    _average_in_place(manager, tensors, should_quantize).wait()
    return tensors


class DistributedDataParallel:
    """Object-style facade matching the reference class name
    (``torchft/ddp.py:31-78``): holds the manager and averages the
    gradients a backward pass left in ``.grad``."""

    def __init__(self, manager: Manager) -> None:
        self.manager = manager

    def average_gradients(
        self, grads: Iterable[torch.Tensor], should_quantize: bool = False
    ) -> List[torch.Tensor]:
        return ft_allreduce(self.manager, grads, should_quantize)

    def average_gradients_async(
        self, grads: Iterable[torch.Tensor], should_quantize: bool = False
    ) -> Work:
        return _average_in_place(self.manager, list(grads), should_quantize)


def restore_like(new: object, old: object) -> object:
    """Load one healed leaf back into ``old``'s placement, in place.

    ``new`` is what the checkpoint transport delivered: a CPU tensor, or a
    :class:`ShardedHostArray` when ``old`` is a DTensor (the source rank
    shipped its local shard; it must cover the region this rank's shard
    covers, else :class:`~torchft_tpu_torch.checkpointing.serialization.HealLayoutError`).
    A tensor ``old`` is returned with the values copied into it; any other
    leaf is replaced by ``new``."""
    from torch.distributed.tensor import DTensor

    from torchft_tpu_torch.checkpointing.serialization import HealLayoutError

    if isinstance(old, DTensor):
        if not isinstance(new, ShardedHostArray):
            raise HealLayoutError(
                "heal source sent a whole tensor for a leaf this rank holds sharded"
            )
        new.check_layout(old)
        with torch.no_grad():
            old.to_local().copy_(new.local)
        return old
    if isinstance(new, ShardedHostArray):
        raise HealLayoutError("heal source sent a shard for a leaf this rank holds whole")
    if isinstance(old, torch.Tensor):
        with torch.no_grad():
            old.copy_(torch.as_tensor(new))
        return old
    return new


def restore_tree_like(new_tree: object, old_tree: object) -> object:
    """:func:`restore_like` over matching dicts and lists
    (``ShardedHostArray`` leaves kept atomic)."""
    if isinstance(old_tree, dict):
        if set(new_tree) != set(old_tree):
            raise ValueError(f"healed keys {sorted(new_tree)} differ from {sorted(old_tree)}")
        return {k: restore_tree_like(new_tree[k], v) for k, v in old_tree.items()}
    if isinstance(old_tree, (list, tuple)):
        if len(new_tree) != len(old_tree):
            raise ValueError(f"healed {len(new_tree)} leaves into {len(old_tree)}")
        return type(old_tree)(restore_tree_like(n, o) for n, o in zip(new_tree, old_tree))
    return restore_like(new_tree, old_tree)
