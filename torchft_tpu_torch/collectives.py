"""Quantized collectives: int8/fp8 allreduce over the replica dimension.

The port of the quantized-allreduce part of ``torchft_tpu/collectives.py``
(the sharded outer sync comes with DiLoCo).  The pipeline: quantize →
``alltoall`` row shards → dequant-sum-requant of this rank's shard →
allgather → dequantize.  Per-rank bytes drop from ~2·n·4 (f32 ring) to
~2·n·1 + scales.

Two overlap mechanisms:

- the whole pipeline runs off-thread and returns a pending Work;
- within the pipeline, the buffer is split into fixed-size row windows
  walked in a deterministic schedule — ``a2a(0), a2a(1), ag(0), a2a(2),
  ag(1), …`` — so while the op thread drives window ``w+1``'s alltoall and
  window ``w-1``'s allgather over the wire, the caller thread
  dequant-sum-requants window ``w``.  The schedule is identical on every
  rank (the op queue executes in submission order and frames are
  tag-checked), so windows can never cross.

The reduce step runs on the card when one is present and the shard is big
enough (the hand-written CUDA dequant-sum-requant kernel,
``ops/quant.py reduce_quantized_device``): the host round-trips 1-byte
shards only, never float32.  Elsewhere it runs as vectorized numpy.  The
wire bytes are the JAX package's, so mixed quorums interoperate.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

import torch

from torchft_tpu_torch import bf16, wire
from torchft_tpu_torch.communicator import Communicator, CommunicatorError
from torchft_tpu_torch.quantization import (
    DEFAULT_ROW_SIZE,
    FP8,
    INT8,
    dequantize_rowwise,
    quantize_rowwise,
    reduce_quantized,
    wire_dtype,
)
from torchft_tpu_torch.wire import (
    DEVICE_QUANT_PIPELINE_TAG_BASE,
    QUANT_PIPELINE_TAG_BASE,
    QUANT_RING_TAG,
)
from torchft_tpu_torch.work import DummyWork, Work

logger = logging.getLogger(__name__)

Buffers = Union[np.ndarray, List[np.ndarray]]

# Rows per pipeline window are sized so one window's payload is about this
# many bytes; smaller windows overlap wire and reduce at finer grain but pay
# more per-frame overhead.
WINDOW_MB_ENV = "TORCHFT_QUANT_WINDOW_MB"
DEFAULT_WINDOW_MB = 4.0

# Device-side fused reduce: "1" forces on, "0" forces off, unset/auto uses
# the card when present and the window is big enough to amortize transfers.
DEVICE_REDUCE_ENV = "TORCHFT_QUANT_DEVICE_REDUCE"
_DEVICE_REDUCE_MIN_BYTES = 256 << 10


def _window_rows(row_size: int) -> int:
    try:
        mb = float(os.environ.get(WINDOW_MB_ENV, "") or DEFAULT_WINDOW_MB)
    except ValueError:
        mb = DEFAULT_WINDOW_MB
    return max(1, int(mb * (1 << 20)) // row_size)


def _kind_of(q: np.ndarray) -> str:
    return INT8 if q.dtype == np.int8 else FP8


def _use_device_reduce(shard_bytes: int) -> bool:
    mode = os.environ.get(DEVICE_REDUCE_ENV, "")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return torch.cuda.is_available() and shard_bytes >= _DEVICE_REDUCE_MIN_BYTES


def _as_f32(a: np.ndarray) -> np.ndarray:
    """A contribution widened to f32 (bf16 exactly, from its bit pattern)."""
    return bf16.to_f32(a) if bf16.is_bf16(a) else np.asarray(a, dtype=np.float32)


def _cast(x: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """An f32 result back in the contribution's dtype (bf16 rounds to
    nearest even, as ml_dtypes does)."""
    return bf16.from_f32(x).reshape(x.shape) if dtype == bf16.BF16 else x.astype(dtype, copy=False)


# two-byte wire-format header leading every packed shard: both kinds are
# 1 byte/element with identical geometry, so a TORCHFT_QUANT_KIND mismatch
# across replicas would otherwise reinterpret peers' bytes silently —
# garbage gradients instead of an error.  header[0] is a nonzero magic so a
# headerless legacy payload (int8-quantized gradients are mostly near zero,
# making a leading 0 byte common) fails LOUDLY instead of parsing 8 bytes
# shifted; header[1] is the kind tag.
_WIRE_MAGIC = 0xA7
_KIND_TAG = {INT8: 1, FP8: 2}
_TAG_KIND = {v: k for k, v in _KIND_TAG.items()}


_HDR = 8  # 8-byte header (magic + kind + reserved) keeps the f32 scales view aligned


def _pack(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Header + payload + scales in one uint8 buffer so one collective
    carries all three."""
    header = np.zeros(_HDR, dtype=np.uint8)
    header[0] = _WIRE_MAGIC
    header[1] = _KIND_TAG[_kind_of(q)]
    return np.concatenate(
        [
            header,
            np.ascontiguousarray(q).reshape(-1).view(np.uint8),
            scales.view(np.uint8),
        ]
    )


def _unpack(
    buf: np.ndarray, rows: int, row_size: int, kind: str
) -> Tuple[np.ndarray, np.ndarray]:
    if int(buf[0]) != _WIRE_MAGIC:
        raise CommunicatorError(
            "quantized-wire header magic mismatch: peer payload does not "
            "start with the framed header (mixed-version replica group? "
            "all groups must run the same quantized wire build)"
        )
    got = _TAG_KIND.get(int(buf[1]))
    if got != kind:
        raise CommunicatorError(
            f"quantized-wire kind mismatch: peer sent {got!r}, this replica "
            f"is configured for {kind!r} (check TORCHFT_QUANT_KIND agrees "
            "across all replica groups)"
        )
    payload = rows * row_size
    return (
        buf[_HDR : _HDR + payload].view(wire_dtype(kind)).reshape(rows, row_size),
        buf[_HDR + payload :].view(np.float32),
    )


def _reduce_shards(
    qs: np.ndarray, scs: np.ndarray, kind: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Dequant-sum-requant ``w`` shards.  On the device path the shards
    move to an explicit device — the card when there is one, the CPU only
    when ``TORCHFT_QUANT_DEVICE_REDUCE=1`` forces the path on a host
    without one (where the wrapper runs the kernel's plain version) — so
    only 1-byte payloads and scales cross to the card and back."""
    if _use_device_reduce(qs[0].nbytes):
        from torchft_tpu_torch.ops.quant import reduce_quantized_device

        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
        q_t = torch.from_numpy(np.ascontiguousarray(qs)).to(device)
        if kind == FP8:
            q_t = q_t.view(torch.float8_e4m3fn)
        s_t = torch.from_numpy(np.ascontiguousarray(scs, dtype=np.float32)).to(device)
        q_dev, s_dev = reduce_quantized_device(q_t, s_t, kind=kind)
        if kind == FP8:
            q_dev = q_dev.view(torch.uint8)
        return q_dev.cpu().numpy(), s_dev.reshape(-1).cpu().numpy()
    return reduce_quantized(qs, scs, kind)


# ---------------------------------------------------------------------------
# single-window core (shared with reduce_scatter and kept as the fallback)
# ---------------------------------------------------------------------------


def _quantized_reduce_scatter_sync(
    comm: Communicator, flat: np.ndarray, row_size: int, tag: int, kind: str = INT8
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Core shared by both quantized collectives: quantize, pad rows to an
    equal per-rank share, alltoall, dequant-sum-requant our shard.

    Returns (reduced q shard, its scales, total unpadded rows, rows/rank).
    """
    q, scales = quantize_rowwise(flat, row_size, kind)
    return _prequantized_reduce_scatter_sync(comm, q, scales, tag)


def _prequantized_reduce_scatter_sync(
    comm: Communicator, q: np.ndarray, scales: np.ndarray, tag: int
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Same core for input already quantized (e.g. on the card by the CUDA
    kernel, so only 1-byte payload + scales ever crossed HBM→host)."""
    kind = _kind_of(q)
    ws = comm.size()
    row_size = q.shape[1]
    rows = q.shape[0]
    rows_per_rank = -(-rows // ws)
    padded_rows = rows_per_rank * ws
    if padded_rows != rows:
        q = np.concatenate(
            [q, np.zeros((padded_rows - rows, row_size), q.dtype)]
        )
        scales = np.concatenate(
            [scales, np.zeros(padded_rows - rows, np.float32)]
        )

    chunks = [
        _pack(
            q[p * rows_per_rank : (p + 1) * rows_per_rank],
            scales[p * rows_per_rank : (p + 1) * rows_per_rank],
        )
        for p in range(ws)
    ]
    gathered = comm.alltoall(chunks, tag=tag).wait()

    qs, scs = zip(*(_unpack(g, rows_per_rank, row_size, kind) for g in gathered))
    q_red, s_red = _reduce_shards(np.stack(qs), np.stack(scs), kind)
    return q_red, s_red, rows, rows_per_rank


def _allgather_reduced_shards(
    comm: Communicator,
    q_red: np.ndarray,
    s_red: np.ndarray,
    rows: int,
    rows_per_rank: int,
    row_size: int,
    n: int,
    tag: int,
    pipeline_err: Optional[BaseException],
    kind: str = INT8,
) -> np.ndarray:
    """Shared tail of the single-window allreduce: allgather the reduced
    shards and dequantize.  Always participates in the allgather — even
    after an upstream failure (``pipeline_err``), a zero shard is
    contributed so healthy peers are never wedged — then re-raises."""
    all_shards = comm.allgather(_pack(q_red, s_red), tag=tag).wait()
    if pipeline_err is not None:
        raise pipeline_err
    qs_full, ss_full = zip(
        *(_unpack(s, rows_per_rank, row_size, kind) for s in all_shards)
    )
    q_full = np.concatenate(qs_full)[:rows]
    s_full = np.concatenate(ss_full)[:rows]
    return dequantize_rowwise(q_full, s_full, n, np.float32)


def _zero_shard(
    rows: int, row_size: int, ws: int, kind: str = INT8
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Zero contribution with the shard geometry peers expect (``rows`` must
    equal the unpadded row count every rank derived from its own input)."""
    rows_per_rank = -(-rows // ws)
    return (
        np.zeros((rows_per_rank, row_size), wire_dtype(kind)),
        np.zeros(rows_per_rank, np.float32),
        rows,
        rows_per_rank,
    )


# ---------------------------------------------------------------------------
# windowed pipelined allreduce
# ---------------------------------------------------------------------------


def _allreduce_pipelined_sync(
    comm: Communicator,
    q: np.ndarray,
    scales: np.ndarray,
    n: int,
    tag_base: int,
) -> np.ndarray:
    """SUM-allreduce of quantized rows with window-level overlap.

    Deterministic per-rank schedule (identical everywhere, so the single op
    thread pairs frames correctly):

        submit a2a(0)
        for w: wait a2a(w); submit a2a(w+1); reduce(w); submit ag(w)
        for w: wait ag(w); dequantize into the output

    While the caller reduces window ``w``, the op thread drives ``a2a(w+1)``
    then ``ag(w-1)`` over the sockets.  Any stage failure degrades that
    window (and the rest of the schedule, if the communicator died) to zero
    shards so peers never wedge, then the first error re-raises at the end —
    same containment contract as the single-window path.
    """
    kind = _kind_of(q)
    ws = comm.size()
    rows, row_size = q.shape
    win = _window_rows(row_size)
    windows: List[Tuple[int, int]] = [
        (start, min(start + win, rows)) for start in range(0, rows, win)
    ]
    W = len(windows)
    # window tags are allocated 2 per window from tag_base; past the span
    # declared in wire.USER_TAG_ALLOCATIONS they spill into neighboring
    # allocations (pairing stays unambiguous today only because ops are
    # serialized per epoch and a2a/ag tags differ in parity — see the
    # registry comment).  Warn loudly so giant payloads get a bigger
    # TORCHFT_QUANT_WINDOW_MB instead of relying on that accident.
    span = next(
        (
            s
            for b, s in wire.USER_TAG_ALLOCATIONS.values()
            if b == tag_base
        ),
        None,
    )
    if span is not None and 2 * W > span:
        logger.warning(
            "quantized pipeline needs %d windows (%d tags) but tag base %d "
            "has a span of only %d — raise TORCHFT_QUANT_WINDOW_MB to "
            "shrink the window count",
            W,
            2 * W,
            tag_base,
            span,
        )
    err: Optional[BaseException] = None
    out = np.empty(rows * row_size, dtype=np.float32)

    # one padded staging scratch (q rows + their scales), sized for the
    # largest window and reused across windows — the previous per-window
    # np.concatenate allocated fresh padding buffers every window.  Reuse is
    # safe while earlier windows' collectives are still in flight because
    # ``_pack`` copies the rows into the wire buffer before submission.
    max_padded = max(
        (-(-(stop - start) // ws) * ws for start, stop in windows), default=0
    )
    pad_q: Optional[np.ndarray] = None
    pad_s: Optional[np.ndarray] = None

    def _submit_a2a(w: int) -> Work:
        nonlocal pad_q, pad_s
        start, stop = windows[w]
        wq, wsc = q[start:stop], scales[start:stop]
        wrows = stop - start
        rows_per_rank = -(-wrows // ws)
        padded = rows_per_rank * ws
        if padded != wrows:
            if pad_q is None:
                pad_q = np.empty((max_padded, row_size), q.dtype)
                pad_s = np.empty(max_padded, np.float32)
            pad_q[:wrows] = wq
            pad_q[wrows:padded] = 0
            pad_s[:wrows] = wsc
            pad_s[wrows:padded] = 0.0
            wq, wsc = pad_q[:padded], pad_s[:padded]
        chunks = [
            _pack(
                wq[p * rows_per_rank : (p + 1) * rows_per_rank],
                wsc[p * rows_per_rank : (p + 1) * rows_per_rank],
            )
            for p in range(ws)
        ]
        return comm.alltoall(chunks, tag=tag_base + 2 * w)

    def _rows_per_rank(w: int) -> int:
        start, stop = windows[w]
        return -(-(stop - start) // ws)

    a2a_work = _submit_a2a(0)
    ag_works: List[Work] = []
    for w in range(W):
        rows_per_rank = _rows_per_rank(w)
        try:
            gathered = a2a_work.wait()
        except BaseException as e:  # noqa: BLE001 — degrade, keep schedule
            err = err or e
            gathered = None
        if w + 1 < W:
            a2a_work = _submit_a2a(w + 1)
        if gathered is not None:
            try:
                qs, scs = zip(
                    *(
                        _unpack(g, rows_per_rank, row_size, kind)
                        for g in gathered
                    )
                )
                q_red, s_red = _reduce_shards(np.stack(qs), np.stack(scs), kind)
            except BaseException as e:  # noqa: BLE001
                err = err or e
                gathered = None
        if gathered is None:
            q_red = np.zeros((rows_per_rank, row_size), wire_dtype(kind))
            s_red = np.zeros(rows_per_rank, np.float32)
        ag_works.append(
            comm.allgather(_pack(q_red, s_red), tag=tag_base + 2 * w + 1)
        )

    for w, work in enumerate(ag_works):
        start, stop = windows[w]
        rows_per_rank = _rows_per_rank(w)
        try:
            all_shards = work.wait()
            qs_full, ss_full = zip(
                *(
                    _unpack(s, rows_per_rank, row_size, kind)
                    for s in all_shards
                )
            )
            q_full = np.concatenate(qs_full)[: stop - start]
            s_full = np.concatenate(ss_full)[: stop - start]
            out[start * row_size : stop * row_size] = dequantize_rowwise(
                q_full, s_full, (stop - start) * row_size, np.float32
            )
        except BaseException as e:  # noqa: BLE001
            err = err or e
            out[start * row_size : stop * row_size] = 0.0

    if err is not None:
        raise err
    return out[:n]



def _hier_topology(comm: Communicator) -> Optional[dict]:
    """The epoch's ACTIVE hierarchical topology (uniform across ranks), or
    None for flat tiers/epochs."""
    fn = getattr(comm, "hier_topology", None)
    return fn() if callable(fn) else None


def _hier_allreduce_quantized_sync(
    comm: Communicator,
    topo: dict,
    flat: np.ndarray,
    row_size: int,
    kind: str,
    tag_base: int,
) -> np.ndarray:
    """Topology-aware quantized SUM-allreduce: reduce float32 once per host
    over shared memory, quantize ONCE PER HOST, run the windowed pipeline
    only among host leaders, shm-broadcast the dequantized sum back out.
    Int8 wire bytes drop by the local-group factor on top of the 4x from
    quantization, and non-leaders never touch the DCN.

    Numerics differ from the flat pipeline (host contributions are summed
    in f32 BEFORE quantization — strictly less quantization error), so the
    contract vs the true sum is the same quantized tolerance, not
    bit-equality with the flat path."""
    # any stage failure degrades toward zeros but KEEPS the shm schedule —
    # skipping the broadcast would leave host peers spinning until their
    # deadline (the underlying shm ops run on the op thread even when a
    # wrapper fails only the returned future), then re-raises so the step
    # is voted down; same containment contract as the flat pipeline
    err: Optional[BaseException] = None
    host_sum: Optional[np.ndarray] = None
    try:
        host_sum = comm.intra_reduce(flat).wait()  # type: ignore[attr-defined]
    except BaseException as e:  # noqa: BLE001
        err = e
    out: Optional[np.ndarray] = None
    if topo["is_leader"]:
        try:
            if host_sum is None:
                raise err or CommunicatorError("intra-host reduce failed")
            q, scales = quantize_rowwise(host_sum, row_size, kind)
            lead = comm.leader_comm()  # type: ignore[attr-defined]
            if lead.size() > 1:
                out = _allreduce_pipelined_sync(
                    lead, q, scales, flat.size, tag_base=tag_base
                )
            else:
                # single host: the wire round-trip degenerates but the
                # quantization error stays observable, like ws==1 flat
                out = dequantize_rowwise(q, scales, flat.size, np.float32)
        except BaseException as e:  # noqa: BLE001
            err = err or e
            out = np.zeros(flat.size, dtype=np.float32)
    summed = comm.intra_broadcast(  # type: ignore[attr-defined]
        out, flat.size, np.float32
    ).wait()
    if err is not None:
        raise err
    return summed


def _allreduce_quantized_sync(
    comm: Communicator, arrays: List[np.ndarray], row_size: int, kind: str = INT8
) -> List[np.ndarray]:
    layout = [(a.shape, a.dtype, a.size) for a in arrays]
    flat = np.concatenate(
        [_as_f32(a).reshape(-1) for a in arrays]
    )
    topo = _hier_topology(comm)
    if topo is not None:
        summed = _hier_allreduce_quantized_sync(
            comm, topo, flat, row_size, kind, tag_base=QUANT_PIPELINE_TAG_BASE
        )
    else:
        q, scales = quantize_rowwise(flat, row_size, kind)
        summed = _allreduce_pipelined_sync(
            comm, q, scales, flat.size, tag_base=QUANT_PIPELINE_TAG_BASE
        )

    out: List[np.ndarray] = []
    off = 0
    for shape, dtype, size in layout:
        out.append(
            _cast(summed[off : off + size].reshape(shape), dtype)
        )
        off += size
    return out


def allreduce_prequantized(
    comm: Communicator,
    q: np.ndarray,
    scales: np.ndarray,
    n: int,
) -> np.ndarray:
    """SUM-allreduce of an already-quantized stream (1-byte rows + f32
    rowwise scales, e.g. produced on the card by ``ops.quant``);
    returns the dequantized float32 sum of length ``n``.  Synchronous —
    callers layer Work/threading on top (``Manager.allreduce_prequantized``)."""
    scales = np.asarray(scales).reshape(-1)
    if comm.size() == 1 or getattr(comm, "is_passthrough", False):
        return dequantize_rowwise(q, scales, n, np.float32)
    topo = _hier_topology(comm)
    if topo is not None:
        # prequantized input on a hierarchical topology: dequantize locally
        # (host-side f32, the shm hop is cheap) and take the once-per-host
        # requantize path — leaders alone quantize for the DCN
        flat = dequantize_rowwise(q, scales, n, np.float32)
        return _hier_allreduce_quantized_sync(
            comm, topo, flat, q.shape[1], _kind_of(q),
            tag_base=DEVICE_QUANT_PIPELINE_TAG_BASE,
        )
    return _allreduce_pipelined_sync(
        comm, q, scales, n, tag_base=DEVICE_QUANT_PIPELINE_TAG_BASE
    )


def allreduce_quantized(
    comm: Communicator,
    buffers: Buffers,
    row_size: int = DEFAULT_ROW_SIZE,
    kind: str = INT8,
) -> Work:
    """SUM-allreduce through a 1-byte wire format (int8 default, fp8
    optional): the Work's value mirrors ``buffers`` with summed float values
    (the Manager divides by participants afterwards, exactly like the
    unquantized path).

    Accuracy: rowwise int8 carries ~2-3 decimal digits; intended for DiLoCo
    pseudogradients where the outer optimizer tolerates it (the reference
    ships fp8 with the same caveat — pass ``kind="fp8"`` for that format).
    """
    single = isinstance(buffers, np.ndarray)
    arrays: List[np.ndarray] = [buffers] if single else list(buffers)

    if comm.size() == 1 or getattr(comm, "is_passthrough", False):
        # single member (or a passthrough test double): the sum is our own
        # contribution; round-trip through the wire format so quantization
        # error stays observable in tests
        out = []
        for a in arrays:
            flat = _as_f32(a).reshape(-1)
            q, s = quantize_rowwise(flat, row_size, kind)
            out.append(
                _cast(dequantize_rowwise(q, s, flat.size, np.float32).reshape(a.shape), a.dtype)
            )
        return DummyWork(out[0] if single else out)

    fut: Future = Future()

    def _run() -> None:
        try:
            out = _allreduce_quantized_sync(comm, arrays, row_size, kind)
            fut.set_result(out[0] if single else out)
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(
        target=_run, name="tpuft_quantized_allreduce", daemon=True
    ).start()
    return Work(fut)


def reduce_scatter_quantized(
    comm: Communicator,
    buffers: Buffers,
    row_size: int = DEFAULT_ROW_SIZE,
    kind: str = INT8,
) -> Work:
    """Quantized reduce-scatter (``collectives.py:159-294``): each rank gets
    the dequantized sum of its row-shard only (flat float32)."""
    single = isinstance(buffers, np.ndarray)
    arrays: List[np.ndarray] = [buffers] if single else list(buffers)
    flat = np.concatenate(
        [_as_f32(a).reshape(-1) for a in arrays]
    )
    if comm.size() == 1 or getattr(comm, "is_passthrough", False):
        q, s = quantize_rowwise(flat, row_size, kind)
        return DummyWork(dequantize_rowwise(q, s, flat.size, np.float32))

    fut: Future = Future()

    def _run() -> None:
        try:
            topo = _hier_topology(comm)
            if topo is not None:
                # hierarchical: once-per-host quantized allreduce, then
                # requantize the full sum and slice this rank's row-shard —
                # same shard geometry as the flat alltoall path
                summed = _hier_allreduce_quantized_sync(
                    comm, topo, flat, row_size, kind, tag_base=QUANT_RING_TAG
                )
                q_full, s_full = quantize_rowwise(summed, row_size, kind)
                ws = comm.size()
                rows_per_rank = -(-q_full.shape[0] // ws)
                r = comm.rank()
                q_red = np.zeros((rows_per_rank, row_size), wire_dtype(kind))
                s_red = np.zeros(rows_per_rank, np.float32)
                shard = q_full[r * rows_per_rank : (r + 1) * rows_per_rank]
                q_red[: shard.shape[0]] = shard
                s_red[: shard.shape[0]] = s_full[
                    r * rows_per_rank : r * rows_per_rank + shard.shape[0]
                ]
            else:
                q_red, s_red, _rows, rows_per_rank = (
                    _quantized_reduce_scatter_sync(
                        comm, flat, row_size, tag=QUANT_RING_TAG, kind=kind
                    )
                )
            total = (q_red.astype(np.float32) * s_red[:, None]).reshape(-1)
            fut.set_result(total)
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(
        target=_run, name="tpuft_quantized_reduce_scatter", daemon=True
    ).start()
    return Work(fut)
