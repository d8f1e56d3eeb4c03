"""Fault-tolerant data parallelism over the replica dimension.

The port of ``torchft_tpu/ddp.py``'s float path.  Gradients are the
``.grad`` tensors of a module's parameters; the replica-dim average runs on
the host: each dtype's gradients are flattened into buckets of at most
``TORCHFT_BUCKET_CAP_MB`` (the JAX package's boundaries), copied to pinned
host memory with non-blocking transfers started up front, ring-allreduced
by ``Manager.allreduce`` over the TCP communicator, and copied back into the
``.grad`` tensors in place.

bf16 (and f16) buckets travel as f32: they are widened on the device before
the copy to host and rounded back after.  The wire carries twice the bytes,
and no host code needs a bf16 numpy dtype.  With two replicas the result
equals the JAX package's bf16 average exactly; with more it is within one
bf16 ulp.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
from concurrent.futures import Future
from typing import Dict, Iterable, List, Tuple, Union

import torch
from torch import nn

from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.work import DummyWork, Work

logger = logging.getLogger(__name__)

# Split gradient buckets at this size (same knob, parse and default as the
# JAX package).  MUST be uniform across replicas: bucket boundaries shape
# the collective sequence.
BUCKET_CAP_MB_ENV = "TORCHFT_BUCKET_CAP_MB"
DEFAULT_BUCKET_CAP_MB = 32

# dtypes the host ring cannot add natively travel widened to f32
_WIDENED = (torch.bfloat16, torch.float16)


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
    if should_quantize:
        raise NotImplementedError(
            "the quantized gradient sync lands in a later slice of the port"
        )
    grads = _gradients(module_or_params)
    if manager.errored() or manager.allreduce_is_identity() or not grads:
        # single-member quorum: averaging is the identity; skip the
        # device→host→device round trip entirely
        return DummyWork(grads)

    groups = bucket_groups(
        [g.numel() * g.element_size() for g in grads],
        [str(g.dtype) for g in grads],
        _bucket_cap_bytes(),
    )
    # start every device→host copy up front (non-blocking into pinned
    # memory) so the transfers of later buckets overlap the earlier rings
    staged: List[Tuple[List[int], torch.Tensor, object]] = []
    for group in groups:
        flat = torch.cat([grads[i].detach().reshape(-1) for i in group])
        if flat.dtype in _WIDENED:
            flat = flat.float()
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
        # in_place: the bucket is ours and discarded after the copy-back
        works.append(manager.allreduce(host.numpy(), in_place=True))

    def _copy_back() -> None:
        for (group, _host, _done), work in zip(staged, works):
            avg = torch.from_numpy(work.wait())
            off = 0
            for i in group:
                g = grads[i]
                n = g.numel()
                g.copy_(avg[off : off + n].view(g.shape))  # casts back, moves H2D
                off += n

    fut: "Future[List[torch.Tensor]]" = Future()

    def _finish() -> None:
        try:
            _copy_back()
        except Exception as e:  # noqa: BLE001 — funnel, never raise
            manager.report_error(e)
        fut.set_result(grads)

    threading.Thread(target=_finish, name="tpuft_ddp_gather", daemon=True).start()
    out = Work(fut)
    # fence the WHOLE pipeline (including the copy-back) at commit, not
    # just the rings: a copy-back failure after the vote would otherwise
    # apply unaveraged gradients on this replica only
    manager._register_pending(out)
    return out
