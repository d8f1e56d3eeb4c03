"""Quantized collectives: int8/fp8 allreduce over the replica dimension.

The port of ``torchft_tpu/collectives.py``: the quantized allreduce, and
DiLoCo's sharded outer sync (:func:`outer_sharded_sync`: host numpy as in
the JAX package, or, for a fragment on the card, its card path, where each
chunk's sum and outer step run in one kernel and the delta stays in device
memory).  The quantized pipeline: quantize →
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

import contextlib
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
from torchft_tpu_torch.obs.spans import span as obs_span
from torchft_tpu_torch.quantization import (
    DEFAULT_ROW_SIZE,
    FP8,
    INT8,
    _to_f32,
    dequantize_rowwise,
    quantize_rowwise,
    reduce_quantized,
    wire_dtype,
)
from torchft_tpu_torch.wire import (
    DEVICE_QUANT_PIPELINE_TAG_BASE,
    OUTER_SHARD_TAG_BASE,
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


def _quantize_rows(x: np.ndarray, row_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`quantize_rowwise` of an f32 ``x`` of whole rows, by the
    quantize kernel (``ops.quant``) where the device reduce is on (the same
    gate: the card when there is one): the host wire's bytes, computed on
    the card instead of in host numpy passes."""
    if row_size != DEFAULT_ROW_SIZE or not _use_device_reduce(x.nbytes):
        return quantize_rowwise(x, row_size, kind)
    from torchft_tpu_torch.ops.quant import quantize_rowwise_device

    rows = -(-x.size // row_size)
    q, s = quantize_rowwise_device(torch.from_numpy(x).to(_reduce_device()), row_size, kind)
    if kind == FP8:
        q = q.view(torch.uint8)  # the host holds e4m3 as its bit pattern
    return q[:rows].cpu().numpy(), s.reshape(-1)[:rows].cpu().numpy()


def _dequantize_rows(q: np.ndarray, scales: np.ndarray, n: int) -> np.ndarray:
    """:func:`dequantize_rowwise` to f32, by the dequantize kernel where
    the device reduce is on (as :func:`_quantize_rows`)."""
    if q.shape[-1] != DEFAULT_ROW_SIZE or not _use_device_reduce(q.nbytes):
        return dequantize_rowwise(q, scales, n, np.float32)
    from torchft_tpu_torch.ops.quant import dequantize_rowwise_device

    device = _reduce_device()
    q_t = torch.from_numpy(np.ascontiguousarray(q)).to(device)
    if _kind_of(q) == FP8:
        q_t = q_t.view(torch.float8_e4m3fn)
    s_t = torch.from_numpy(np.ascontiguousarray(scales, dtype=np.float32)).to(device)
    return dequantize_rowwise_device(q_t, s_t, n).cpu().numpy()


def _reduce_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


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

        device = _reduce_device()
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


# ---------------------------------------------------------------------------
# windowed pipelined allreduce
# ---------------------------------------------------------------------------


def _allreduce_pipelined_sync(
    comm: Communicator,
    q: np.ndarray,
    scales: np.ndarray,
    n: int,
    tag_base: int,
    dequantize: bool = True,
) -> Optional[np.ndarray]:
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

    With ``dequantize=False`` the reduced rows and scales are written over
    ``q`` and ``scales`` (every a2a has packed them by then) and None is
    returned.
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
    out = np.empty(rows * row_size, dtype=np.float32) if dequantize else None

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
            if not dequantize:
                q[start:stop] = q_full
                scales[start:stop] = s_full
                continue
            with obs_span("quant::dequantize"):
                out[start * row_size : stop * row_size] = dequantize_rowwise(
                    q_full, s_full, (stop - start) * row_size, np.float32
                )
        except BaseException as e:  # noqa: BLE001
            err = err or e
            if dequantize:
                out[start * row_size : stop * row_size] = 0.0
            else:
                scales[start:stop] = 0.0

    if err is not None:
        raise err
    return out[:n] if dequantize else None



# ---------------------------------------------------------------------------
# sharded outer sync: chunk-pipelined reduce_scatter → update → allgather
# ---------------------------------------------------------------------------

# Bytes of the FULL flat buffer covered by one pipeline chunk (each chunk's
# per-shard slice is this divided by the shard count).  Smaller chunks start
# the outer update sooner and overlap at finer grain; larger chunks amortize
# the per-exchange RTT gates — on wan_1g-class links (10 ms RTT) chunks
# below ~8 MB cost more in frame gates than the overlap buys back.
OUTER_CHUNK_MB_ENV = "TORCHFT_OUTER_CHUNK_MB"
DEFAULT_OUTER_CHUNK_MB = 16.0
# Pipeline depth cap: tags are allocated 2 per chunk from the sharded-sync
# tag base, and a deeper pipeline stops paying for itself anyway.
_MAX_OUTER_CHUNKS = 64
_OUTER_TAG_BASE = OUTER_SHARD_TAG_BASE


def _outer_chunk_ranges(
    per: int, unit: int, gsize: int, max_chunks: int = _MAX_OUTER_CHUNKS
) -> List[Tuple[int, int]]:
    """Pipeline chunk ranges WITHIN one shard's [0, per) element extent,
    unit-aligned so quantization rows never split; identical on every
    replica (pure function of the layout).  ``max_chunks`` bounds the
    pipeline depth to the caller's tag window (2 tags per chunk)."""
    try:
        mb = float(
            os.environ.get(OUTER_CHUNK_MB_ENV, "") or DEFAULT_OUTER_CHUNK_MB
        )
    except ValueError:
        mb = DEFAULT_OUTER_CHUNK_MB
    # per-shard slice of one chunk, in elements (f32), unit-aligned
    want = int(mb * (1 << 20)) // 4 // max(1, gsize)
    want = max(unit, want // unit * unit)
    floor = -(-per // (max_chunks * unit)) * unit  # cap chunk count
    step = max(want, floor, unit)
    return [(c, min(c + step, per)) for c in range(0, per, step)]


def outer_shard_layout(
    n: int, gsize: int, should_quantize: bool, row_size: int = DEFAULT_ROW_SIZE
) -> Tuple[int, int, int]:
    """Per-replica shard layout of a flat ``n``-element f32 buffer over
    ``gsize`` shard owners: returns ``(padded, per, unit)`` elements where
    every shard is exactly ``per`` elements, ``padded = per * gsize``, and
    boundaries are ``unit``-aligned (16 f32 = 64 B raw; one quantization
    row when the wire is quantized, so each byte is quantized exactly once
    and no row straddles shards).  Thin wrapper over the wire-level
    :func:`communicator.outer_shard_parts` (mirrored in ``csrc/native/comm.h``)
    so shard ownership stays tier-uniform."""
    from torchft_tpu_torch.communicator import outer_shard_parts

    unit = row_size if should_quantize else 16
    parts = outer_shard_parts(n * 4, gsize, unit * 4)
    per = (parts[0][1] - parts[0][0]) // 4
    return per * gsize, per, unit


def outer_sharded_sync(
    comm: Communicator,
    flat: np.ndarray,
    update_cb: Callable[[int, int, np.ndarray], np.ndarray],
    num_participants: int,
    should_quantize: bool = False,
    kind: str = INT8,
    row_size: int = DEFAULT_ROW_SIZE,
    timings: Optional[dict] = None,
    tap: Optional[Callable[[np.ndarray], None]] = None,
    weight: Optional[float] = None,
    tag_base: int = _OUTER_TAG_BASE,
    tag_span: int = wire.OUTER_SHARD_TAG_SPAN,
    device: Optional[torch.device] = None,
) -> Union[np.ndarray, torch.Tensor]:
    """ZeRO-1-style sharded outer sync: chunk-pipelined
    ``reduce_scatter → sharded outer update → allgather(update)``.

    ``flat`` is this replica's f32 pseudo-gradient (length n).  The buffer
    is split into deterministic per-owner shards (:func:`outer_shard_layout`)
    and each shard into pipeline chunks; per chunk the schedule is

        alltoall(pseudo-grad slices)         # the reduce-scatter
        avg = Σ contributions / participants
        delta = update_cb(lo, hi, avg)       # the sharded outer step
        allgather(delta)                     # owners' updates, fanned out

    with chunk ``c+1``'s alltoall submitted before chunk ``c``'s update
    runs, so the outer optimizer computes while later chunks are still
    reducing on the op thread — the ``reduce_scatter_then`` hook.  Every
    replica applies the identical wire-format delta (its own included), so
    params stay bit-identical across replicas.

    ``device``, when given, runs the chunk arithmetic there (the card path):
    each chunk's gathered contributions go to the device once (on the int8
    wire dequantized there, ``ops.quant``), ``update_cb.on_card(lo, hi,
    contribs, scale, out)`` sums them, scales by ``1/participants`` and
    steps the owner's shard in one pass (``ops.outer``) into the device
    delta, whose chunk comes back to the host once for the allgather (on
    the int8 wire quantized there first), and the allgathered deltas are
    written (dequantized) into that device delta.  On a CUDA device the
    work runs on a stream of its own, which first waits for the work the
    caller queued on its current stream (the staged copy of the owner's
    state that ``update_cb`` writes) and is synchronized before the delta is
    returned; the host crosses only where the wire needs bytes.  The result
    is the host path's bit for bit (NaN bits aside).

    Hierarchical topologies compose: the host reduces once over shared
    memory, HOST LEADERS run the chunk pipeline (shards owned per host via
    ``leader_comm``; with ``device``, its card path), and the allgathered
    delta shm-broadcasts back out as one host array, which every rank of
    the host returns — non-leaders move zero socket bytes and own no shard
    (``update_cb`` is never invoked on them).

    When quantized, the pseudo-gradient is rowwise-quantized ONCE for the
    whole buffer (each byte quantized exactly once — shard and chunk
    boundaries are row-aligned) and the delta rides the wire as one more
    rowwise pass; error containment matches the pipelined allreduce: a
    failed chunk degrades to a zero delta so peers never wedge, then the
    first error re-raises after the schedule completes.

    Returns the f32 delta of length ``len(flat)`` (apply as
    ``params = backup + delta``): a tensor on ``device`` on the flat card
    path, else a host array.  Fills ``timings`` (if given) with ``scatter_s`` /
    ``update_s`` / ``gather_s`` / ``wall_s`` / ``overlap_ratio``.

    ``tap``, if given, observes the assembled delta as host f32 (identical
    bytes on every replica by construction — the allgather fans out ONE
    wire-format update) right before it is returned: the hot-spare delta
    feed rides this hook so parked observers can keep a shadow bit-exact
    without participating in the collective.  A tap failure never fails
    the sync.

    ``tag_base`` / ``tag_span`` frame the chunk collectives: the default is
    the legacy OUTER_SHARD window (byte-identical to the pre-stream path);
    the streamed fragment scheduler passes a rotating per-fragment
    STREAM_OUTER window (``wire.stream_frag_tag_window``) so consecutive
    streamed syncs can never alias tags.  The pipeline depth is capped at
    ``tag_span // 2`` chunks (2 tags per chunk).

    ``weight``, if given, turns the sync into a capacity-WEIGHTED sum
    (degraded-mode fleets): this replica's contribution is pre-scaled by
    its normalized capacity share before quantization/transport and the
    ``num_participants`` division drops out (weights sum to 1 across the
    fleet by construction — every rank must pass a weight, or none).  The
    delta stays bit-identical across replicas exactly as before: the
    weighting changes the bytes each rank CONTRIBUTES, never how the
    summed wire-format delta is applied.
    """
    t_wall = time.perf_counter()
    if weight is not None:
        flat = np.asarray(flat, dtype=np.float32) * np.float32(weight)
        num_participants = 1  # weighted contributions need no division
    n = flat.size
    tm = {"scatter_s": 0.0, "update_s": 0.0, "gather_s": 0.0}
    topo = _hier_topology(comm)
    err: Optional[BaseException] = None
    delta_full: Union[np.ndarray, torch.Tensor, None] = None

    if topo is None:
        gsize = max(1, comm.size())
        group: Communicator = comm
        contrib: Optional[np.ndarray] = np.asarray(flat, dtype=np.float32)
        owns = True
    else:
        # intra-host reduce once; leaders shard the outer step per host
        gsize = len(topo["leader_ring"])
        owns = bool(topo["is_leader"])
        contrib = None
        try:
            contrib = comm.intra_reduce(  # type: ignore[attr-defined]
                np.asarray(flat, dtype=np.float32)
            ).wait()
        except BaseException as e:  # noqa: BLE001 — degrade, keep schedule
            err = e
        group = comm.leader_comm() if owns else comm  # type: ignore[attr-defined]

    padded, per, unit = outer_shard_layout(n, gsize, should_quantize, row_size)
    with _device_stream(device):
        if owns:
            try:
                if contrib is None:
                    raise err or CommunicatorError("intra-host reduce failed")
                with obs_span("outer_shard::pipeline"):
                    delta_full = _outer_sharded_pipeline(
                        group,
                        contrib,
                        padded,
                        per,
                        unit,
                        update_cb,
                        num_participants,
                        should_quantize,
                        kind,
                        row_size,
                        tm,
                        tag_base=tag_base,
                        tag_span=tag_span,
                        device=device,
                    )
            except BaseException as e:  # noqa: BLE001
                err = err or e
                delta_full = (np.zeros(padded, dtype=np.float32) if device is None
                              else torch.zeros(padded, dtype=torch.float32, device=device))

        if topo is not None:
            # members receive the delta; leaders always broadcast (zeros after a
            # failure) so host peers are never wedged — same containment
            # contract as the hierarchical quantized allreduce.  The shm hop
            # moves host arrays: a leader's card delta crosses back once
            delta_full = comm.intra_broadcast(  # type: ignore[attr-defined]
                None if delta_full is None else _host_f32(delta_full), padded, np.float32
            ).wait()
        if err is not None:
            raise err
        assert delta_full is not None
        tm["wall_s"] = time.perf_counter() - t_wall
        busy = tm["scatter_s"] + tm["update_s"] + tm["gather_s"]
        tm["overlap_ratio"] = round(busy / tm["wall_s"], 4) if tm["wall_s"] > 0 else 0.0
        if timings is not None:
            timings.update({k: round(v, 6) for k, v in tm.items()})
        if tap is not None:
            try:
                tap(_host_f32(delta_full[:n]))
            except Exception:  # noqa: BLE001 — observers must not fail the sync
                pass
    return delta_full[:n]


@contextlib.contextmanager
def _device_stream(device: Optional[torch.device]):
    """On a CUDA device, a stream of the card path's own, current while the
    block runs.  It starts after the work queued on the caller's current
    stream (the staged copy of the owner's shard that the kernel writes, the
    state loaded onto the card at a reshard) and is synchronized (it alone,
    not the device) when it ends, so the delta is whole once the sync
    returns while the other work on the card (another replica's inner
    steps) runs on; elsewhere nothing."""
    if device is None or device.type != "cuda":
        yield
        return
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        stream.synchronize()


def _host_f32(x: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    """``x`` as a host f32 array (a tensor on a device copied back once)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _wire_bytes(x: Union[np.ndarray, torch.Tensor]) -> np.ndarray:
    """The host array the allgather sends for a delta chunk.  A chunk on the
    card is copied back once into page-locked memory from PyTorch's caching
    host allocator (later chunks and syncs reuse its blocks), which the card
    fills at DMA rate where pageable memory takes ~7x longer (the copy A/B
    of ``chip_smoke.outer_phase``); the array keeps its block alive until
    the wire is done with it."""
    if not isinstance(x, torch.Tensor) or not x.is_cuda:
        return _host_f32(x)
    out = torch.empty(x.numel(), dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out.numpy()


def _padded_copy(contrib: np.ndarray, padded: int) -> np.ndarray:
    buf = np.zeros(padded, dtype=np.float32)
    buf[: contrib.size] = contrib
    return buf


def _part(contrib: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """This replica's contribution over ``[lo, hi)`` of the padded element
    space: a view where it lies inside ``contrib``, a zero-filled copy
    where it runs past the end (only the last shard's last chunk)."""
    if hi <= contrib.size:
        return contrib[lo:hi]
    out = np.zeros(hi - lo, dtype=np.float32)
    if lo < contrib.size:
        out[: contrib.size - lo] = contrib[lo:]
    return out


def _quantize_on_card(x: torch.Tensor, row_size: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """The wire bytes (payload rows, f32 scales) of ``x``, whole rows,
    quantized on ``x``'s device (B1) and copied back once."""
    from torchft_tpu_torch.ops.quant import quantize_rowwise_device

    rows = x.numel() // row_size
    q, s = quantize_rowwise_device(x, row_size, kind)
    if kind == FP8:
        q = q.view(torch.uint8)  # the host holds e4m3 as its bit pattern
    return q[:rows].cpu().numpy(), s.reshape(-1)[:rows].cpu().numpy()


def _dequantize_on_card(q: np.ndarray, scales: np.ndarray, out: torch.Tensor) -> None:
    """Wire rows (host) dequantized into ``out`` on its device (B3)."""
    from torchft_tpu_torch.ops.quant import dequantize_rowwise_device

    q_t = torch.from_numpy(np.ascontiguousarray(q)).to(out.device)
    if _kind_of(q) == FP8:
        q_t = q_t.view(torch.float8_e4m3fn)
    s_t = torch.from_numpy(np.ascontiguousarray(scales, dtype=np.float32)).to(out.device)
    dequantize_rowwise_device(q_t, s_t, out.numel(), out=out)


def _contribs_on_card(parts: list, length: int, device: torch.device) -> torch.Tensor:
    """One chunk's contributions, f32 host arrays or wire ``(q, scales)``
    rows, as a [w, length] f32 tensor on ``device``: each crosses once."""
    out = torch.empty((len(parts), length), dtype=torch.float32, device=device)
    for k, part in enumerate(parts):
        if isinstance(part, tuple):
            _dequantize_on_card(part[0], part[1], out[k])
        else:
            out[k].copy_(torch.from_numpy(np.ascontiguousarray(part, dtype=np.float32)))
    return out


def _outer_sharded_pipeline(
    group: Communicator,
    contrib: np.ndarray,
    padded: int,
    per: int,
    unit: int,
    update_cb: Callable[[int, int, np.ndarray], np.ndarray],
    num_participants: int,
    should_quantize: bool,
    kind: str,
    row_size: int,
    tm: dict,
    tag_base: int = _OUTER_TAG_BASE,
    tag_span: int = wire.OUTER_SHARD_TAG_SPAN,
    device: Optional[torch.device] = None,
) -> Union[np.ndarray, torch.Tensor]:
    """Shard-owner body of :func:`outer_sharded_sync` over ``group`` (the
    flat communicator, or the leader view on hierarchical topologies); with
    ``device``, the card path (see there)."""
    gsize = max(1, group.size())
    gidx = group.rank() if gsize > 1 else 0
    chunks = _outer_chunk_ranges(per, unit, gsize, max_chunks=tag_span // 2)
    inv = 1.0 / max(1, num_participants)
    card = device is not None
    delta_full: Union[np.ndarray, torch.Tensor] = (
        torch.empty(padded, dtype=torch.float32, device=device) if card
        else np.empty(padded, dtype=np.float32)
    )
    err: Optional[BaseException] = None

    q_full: Optional[np.ndarray] = None
    s_full: Optional[np.ndarray] = None
    if should_quantize:
        # quantize the whole contribution ONCE; every a2a slice below is a
        # row-aligned view of this single pass
        with obs_span("outer_shard::contribution"):
            if card:
                x = torch.zeros(padded, dtype=torch.float32, device=device)
                x[: contrib.size].copy_(torch.from_numpy(contrib))
                q_full, s_full = _quantize_on_card(x, row_size, kind)
                del x
            else:
                q_full, s_full = _quantize_rows(_padded_copy(contrib, padded), row_size, kind)

    def rows_of(lo: int, hi: int) -> Tuple[np.ndarray, np.ndarray]:
        assert q_full is not None and s_full is not None
        return q_full[lo // row_size : hi // row_size], s_full[lo // row_size : hi // row_size]

    def update(lo: int, hi: int, parts: list, out: Optional[torch.Tensor]):
        """The owner's update of ``[lo, hi)`` from one chunk's gathered
        contributions (f32 arrays or wire rows): on the card into ``out``;
        on the host the delta array it returns."""
        length = hi - lo
        if card:
            with obs_span("outer_shard::to_card"):
                contribs = _contribs_on_card(parts, length, device)
            t0 = time.perf_counter()
            with obs_span("outer_shard::chunk_update"):
                update_cb.on_card(lo, hi, contribs, inv, out)  # type: ignore[attr-defined]
            tm["update_s"] += time.perf_counter() - t0
            return out
        with obs_span("outer_shard::sum"):
            if should_quantize and len(parts) == 1:
                acc = _dequantize_rows(parts[0][0], parts[0][1], length)
            elif should_quantize:
                qs, scs = zip(*parts)
                acc = np.einsum("wrc,wr->rc", _to_f32(np.stack(qs)), np.stack(scs)).reshape(-1)
            elif len(parts) == 1:
                acc = np.array(parts[0], dtype=np.float32)
            else:
                acc = np.sum(np.stack(parts), axis=0)
            acc *= inv
        t0 = time.perf_counter()
        with obs_span("outer_shard::chunk_update"):
            delta = np.asarray(update_cb(lo, hi, acc), dtype=np.float32)
        tm["update_s"] += time.perf_counter() - t0
        return delta

    if gsize == 1 or getattr(group, "is_passthrough", False):
        # degenerate single-owner group: no wire, but keep the per-chunk
        # schedule (and, when quantized, the wire-format round trip) so the
        # numerics match the multi-owner path's contract
        for c0, c1 in chunks:
            part = rows_of(c0, c1) if should_quantize else _part(contrib, c0, c1)
            if card:
                dst = delta_full[c0:c1]
                if not should_quantize:
                    update(c0, c1, [part], dst)
                    continue
                own = torch.empty(c1 - c0, dtype=torch.float32, device=device)
                update(c0, c1, [part], own)
                _dequantize_on_card(*_quantize_on_card(own, row_size, kind), dst)
                continue
            delta = update(c0, c1, [part], None)
            if should_quantize:
                dq, ds = _quantize_rows(delta, row_size, kind)
                delta = _dequantize_rows(dq, ds, c1 - c0)
            delta_full[c0:c1] = delta
        return delta_full

    my_base = gidx * per

    def _submit_a2a(ci: int) -> Work:
        c0, c1 = chunks[ci]
        if should_quantize:
            parts = [_pack(*rows_of(p * per + c0, p * per + c1)) for p in range(gsize)]
        else:
            parts = [_part(contrib, p * per + c0, p * per + c1) for p in range(gsize)]
        return group.alltoall(parts, tag=tag_base + 2 * ci)

    a2a_work = _submit_a2a(0)
    ag_works: List[Work] = []
    for ci, (c0, c1) in enumerate(chunks):
        rows = (c1 - c0) // row_size
        lo, hi = my_base + c0, my_base + c1
        t0 = time.perf_counter()
        try:
            with obs_span("outer_shard::scatter_wait", chunk=ci):
                gathered = a2a_work.wait()
        except BaseException as e:  # noqa: BLE001 — degrade, keep schedule
            err = err or e
            gathered = None
        tm["scatter_s"] += time.perf_counter() - t0
        if ci + 1 < len(chunks):
            a2a_work = _submit_a2a(ci + 1)
        # on the float card path the owner's delta lands in its own range of
        # the device delta; on int8 every replica applies the wire delta
        own = (None if not card else delta_full[lo:hi] if not should_quantize
               else torch.empty(c1 - c0, dtype=torch.float32, device=device))
        delta = None
        if gathered is not None:
            try:
                parts = ([_unpack(g, rows, row_size, kind) for g in gathered]
                         if should_quantize else list(gathered))
                delta = update(lo, hi, parts, own)
            except BaseException as e:  # noqa: BLE001
                err = err or e
                delta = None
        with obs_span("outer_shard::to_wire", chunk=ci):
            if delta is None and own is not None:
                delta = own.zero_()
            elif delta is None:
                delta = np.zeros(c1 - c0, dtype=np.float32)
            if should_quantize:
                dq, ds = (_quantize_on_card(delta, row_size, kind) if card
                          else _quantize_rows(delta, row_size, kind))
                payload = _pack(dq, ds)
            else:
                payload = _wire_bytes(delta)
        ag_works.append(group.allgather(payload, tag=tag_base + 2 * ci + 1))

    for ci, work in enumerate(ag_works):
        c0, c1 = chunks[ci]
        rows = (c1 - c0) // row_size
        t0 = time.perf_counter()
        try:
            with obs_span("outer_shard::gather_wait", chunk=ci):
                all_deltas = work.wait()
        except BaseException as e:  # noqa: BLE001
            err = err or e
            all_deltas = None
        tm["gather_s"] += time.perf_counter() - t0
        with obs_span("outer_shard::from_wire", chunk=ci):
            for p in range(gsize):
                dst = delta_full[p * per + c0 : p * per + c1]
                if all_deltas is None:
                    dst[:] = 0.0
                elif should_quantize:
                    # every replica (the owner included) applies the WIRE
                    # delta, so params stay bit-identical across replicas
                    try:
                        dq, ds = _unpack(all_deltas[p], rows, row_size, kind)
                        if card:
                            _dequantize_on_card(dq, ds, dst)
                        else:
                            dst[:] = _dequantize_rows(dq, ds, c1 - c0)
                    except BaseException as e:  # noqa: BLE001
                        err = err or e
                        dst[:] = 0.0
                elif card:
                    if p != gidx:  # the owner's own delta is already there
                        dst.copy_(torch.from_numpy(np.asarray(all_deltas[p], np.float32)))
                else:
                    dst[:] = all_deltas[p]

    if err is not None:
        raise err
    return delta_full


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
    dequantize: bool = True,
) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """SUM-allreduce of an already-quantized stream (1-byte rows + f32
    rowwise scales, e.g. produced on the card by ``ops.quant``);
    returns the dequantized float32 sum of length ``n``.  Synchronous —
    callers layer Work/threading on top (``Manager.allreduce_prequantized``).

    ``dequantize=False`` returns the reduced stream instead, ``(q,
    scales)`` written over the arrays given (whose rows the pipeline has
    sent by then), for the caller to dequantize; a hierarchical topology
    still returns the float32 sum."""
    scales = np.asarray(scales).reshape(-1)
    if comm.size() == 1 or getattr(comm, "is_passthrough", False):
        return dequantize_rowwise(q, scales, n, np.float32) if dequantize else (q, scales)
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
    out = _allreduce_pipelined_sync(
        comm, q, scales, n, tag_base=DEVICE_QUANT_PIPELINE_TAG_BASE, dequantize=dequantize
    )
    return out if dequantize else (q, scales)


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
            total = (_to_f32(q_red) * s_red[:, None]).reshape(-1)
            fut.set_result(total)
        except BaseException as e:  # noqa: BLE001
            fut.set_exception(e)

    threading.Thread(
        target=_run, name="tpuft_quantized_reduce_scatter", daemon=True
    ).start()
    return Work(fut)
