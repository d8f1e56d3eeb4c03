"""Reconfigurable host-side communicators for the replica (outer-DP) dimension.

This is the data-plane analog of the reference's reconfigurable
ProcessGroups (``torchft/process_group.py``), redesigned for TPU: the
replica dimension lives *outside* XLA programs.  Gradients produced by a
jit-compiled step are averaged across replica groups by a host-driven
communicator over DCN/TCP, so membership changes never invalidate compiled
executables — ``configure()`` swaps the communicator; the gradient divisor is
a runtime scalar (SURVEY.md §7.3).

Semantics carried over from the reference (SURVEY.md §5.8):

1. ``configure()`` is callable repeatedly, each call rendezvousing under a
   fresh per-quorum store namespace and fully superseding the previous
   communicator (``process_group.py:435-471``).
2. ``abort()`` unblocks in-flight collectives and poisons the communicator
   until the next ``configure()`` (``process_group.py:875-888``).
3. Collectives return :class:`~torchft_tpu.work.Work` handles with value
   chaining (``manager.py:1216-1363``).
4. Errors are recorded, never raised into the train loop (the Manager votes
   the step down instead, ``manager.py:487-493``).
5. Timeouts are userspace and per-operation: an op that exceeds its deadline
   aborts the communicator rather than killing the process
   (``process_group.py:714-777``).

The wire tier here (:class:`TCPCommunicator`) is the CPU/"gloo" equivalent
that runs anywhere; the same interface is implemented by the C++ runtime
(``native/``) for production DCN use.
"""

from __future__ import annotations

import contextlib
import logging
import mmap
import os
import platform
import queue
import select
import socket
import struct
import tempfile
import threading
import time
import uuid
from abc import ABC, abstractmethod
from concurrent.futures import Future
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from torchft_tpu_torch import bf16
from torchft_tpu_torch.futures import TimerHandle, schedule_timeout
from torchft_tpu_torch.obs.flight import FlightEvent, FlightRecorder
from torchft_tpu_torch.obs.spans import span as obs_span, spans_enabled
from torchft_tpu_torch.store import create_store_client
from torchft_tpu_torch import wire as wire_tags
from torchft_tpu_torch.wire import create_listener
from torchft_tpu_torch.work import DummyWork, Work

logger = logging.getLogger(__name__)


def _spanned(name: str):
    """Wrap a hot method in an obs trace span — one truthiness check when
    spans are disabled, a recorded wall-clock window when enabled."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not spans_enabled():
                return fn(*args, **kwargs)
            with obs_span(name):
                return fn(*args, **kwargs)

        return inner

    return deco


Buffers = Union[np.ndarray, Sequence[np.ndarray]]


class ReduceOp(Enum):
    """Reduction for collectives; AVG divides the SUM by the communicator
    world size (the Manager instead divides by live participants)."""

    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"


def _bytes_view(arr: np.ndarray) -> memoryview:
    """Writable raw-byte view of a contiguous array; extension dtypes like
    bfloat16 reject memoryview.cast, so reinterpret through uint8 instead."""
    return memoryview(arr.reshape(-1).view(np.uint8))


def _reduce_into(op: ReduceOp, acc: np.ndarray, incoming: np.ndarray) -> None:
    if bf16.is_bf16(acc):
        # bf16 travels as its bit pattern; reduce as ml_dtypes does
        if op in (ReduceOp.SUM, ReduceOp.AVG):
            bf16.add_into(acc, incoming)
            return
        pick = np.maximum if op == ReduceOp.MAX else np.minimum
        bf16.assign(acc, bf16.from_f32(pick(bf16.to_f32(acc), bf16.to_f32(incoming))))
        return
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        np.add(acc, incoming, out=acc)
    elif op == ReduceOp.MAX:
        np.maximum(acc, incoming, out=acc)
    elif op == ReduceOp.MIN:
        np.minimum(acc, incoming, out=acc)
    else:  # pragma: no cover
        raise ValueError(f"unsupported reduce op {op}")


class CommunicatorError(RuntimeError):
    pass


class CommunicatorAborted(CommunicatorError):
    pass


class PeerGoneError(CommunicatorError):
    """A peer's connection is DEAD (closed socket / failed send) — a
    fail-stop condition scoped to that pair.  Distinct from protocol errors
    (tag/size mismatch) where the socket survives with a desynchronized
    stream and the whole epoch must be poisoned."""


@contextlib.contextmanager
def closing_parts(parts: Any) -> Any:
    """``parts`` for a ``for`` loop, closed at its end (a generator of
    staged chunks stops its copier there, however the loop ends)."""
    try:
        yield parts
    finally:
        close = getattr(parts, "close", None)
        if close is not None:
            close()


def join_parts(parts: Any, nbytes: int) -> bytearray:
    """A frame's ``(view, release)`` parts copied into one buffer, each
    released once copied."""
    out = bytearray(nbytes)
    off = 0
    with closing_parts(parts) as each:
        for view, release in each:
            n = len(view)
            if off + n > nbytes:
                raise CommunicatorError(f"frame parts carry more than {nbytes} bytes")
            out[off : off + n] = view
            release()
            off += n
    if off != nbytes:
        raise CommunicatorError(f"frame parts carried {off} bytes, not {nbytes}")
    return out


class Communicator(ABC):
    """Abstract reconfigurable communicator (``process_group.py:131-399``)."""

    @abstractmethod
    def configure(
        self,
        store_addr: str,
        replica_id: str,
        rank: int,
        world_size: int,
        quorum_id: int = 0,
        group_rank: int = 0,
        group_world_size: int = 1,
        global_ranks: Sequence[int] = (),
    ) -> None:
        ...

    @abstractmethod
    def allreduce(
        self,
        buffers: Buffers,
        op: ReduceOp = ReduceOp.SUM,
        in_place: bool = False,
    ) -> Work:
        """Reduce ``buffers`` across ranks; the Work's value is the reduced
        list of arrays (AVG divides by world size).

        ``in_place=True`` lets the tier reduce directly in the caller's
        (contiguous, writable) buffers and return them aliased — c10d
        allreduce semantics, skipping a full-payload copy.  Only pass it for
        buffers you own and will not reuse (on error the contents are
        unspecified; the step is voted down anyway)."""

    @abstractmethod
    def broadcast(self, buffers: Buffers, root: int = 0) -> Work:
        ...

    @abstractmethod
    def send_bytes(self, data: bytes, dst: int, tag: int = 0) -> Work:
        ...

    @abstractmethod
    def recv_bytes(self, src: int, tag: int = 0) -> Work:
        ...

    @abstractmethod
    def barrier(self) -> Work:
        ...

    def alltoall(self, chunks: List[np.ndarray], tag: int = 0) -> Work:
        raise NotImplementedError

    def allgather(self, data: np.ndarray, tag: int = 0) -> Work:
        raise NotImplementedError

    def recv_bytes_into(self, src: int, out: np.ndarray, tag: int = 0) -> Work:
        """Zero-copy variant: receive one frame directly into ``out`` (a
        contiguous writable array); the Work's value is the payload size."""
        raise NotImplementedError

    def send_frame_parts(self, parts: Any, nbytes: int, dst: int, tag: int = 0) -> Work:
        """Send one frame of ``nbytes`` whose payload comes as ``parts``,
        ``(view, release)`` pairs in order (a ``StagingRing``'s chunks):
        each is ``release()``d once its bytes are written.  The frame on
        the wire is :meth:`send_bytes`' of the joined payload.  This
        default, for a communicator that cannot write a frame in pieces,
        joins the parts into one host buffer and sends that."""
        return self.send_bytes(join_parts(parts, nbytes), dst, tag)

    def heal_drain(
        self,
        chunk_views: List[memoryview],
        expected: Dict[int, List[int]],
        orphans: List[int],
        chunk_tag: Callable[[int], int],
        ctrl_tag: int,
        make_need: Callable[[List[int]], bytes],
        done_blob: bytes,
        timeout_s: Optional[float] = None,
    ) -> Work:
        """Striped-heal receive: concurrently drain disjoint chunk frames
        from many source peers straight into ``chunk_views`` (see
        :meth:`TCPCommunicator.heal_drain`).  ``timeout_s`` bounds the whole
        drain (it may legitimately outlast the per-collective op timeout).
        Tiers without it raise, and the checkpoint transport falls back to
        the single-source heal."""
        raise NotImplementedError

    def reduce_scatter(
        self, data: np.ndarray, op: ReduceOp = ReduceOp.SUM
    ) -> Work:
        """Reduce ``data`` (same shape on every rank) across ranks and
        scatter: the Work's value is THIS rank's chunk of the flattened
        reduction (chunk r of ``world_size`` near-equal chunks, the first
        ``n % ws`` chunks one element longer).  Half the wire cost of a full
        allreduce when each rank only needs its own slice — the reference
        carries the same op on its PG surface (``process_group.py:236-276``).
        """
        raise NotImplementedError

    @abstractmethod
    def abort(self, reason: str = "aborted") -> None:
        ...

    @abstractmethod
    def errored(self) -> Optional[Exception]:
        ...

    @abstractmethod
    def rank(self) -> int:
        ...

    @abstractmethod
    def size(self) -> int:
        ...

    def set_timeout(self, timeout_s: float) -> None:
        ...

    def lane_stats(self) -> Dict[str, object]:
        """Per-lane data-plane counters of the current epoch (lane count,
        stripe floor, bytes, stall events); empty for tiers without lane
        striping or before configure."""
        return {}

    def hier_topology(self) -> Optional[Dict[str, object]]:
        """Facts of the epoch's active hierarchical host topology (host
        count, local group, leader ring) or None when collectives run flat.
        Tiers without topology awareness report None."""
        return None

    def shutdown(self) -> None:
        ...


# ---------------------------------------------------------------------------
# TCP mesh
# ---------------------------------------------------------------------------

_HDR = struct.Struct("<QQ")  # payload nbytes, tag


class _StreamBucket:
    """Per-connection token bucket modeling a cwnd-limited TCP stream:
    rate = cwnd/RTT, burst = cwnd."""

    __slots__ = ("rate", "burst", "_tokens", "_last")

    def __init__(self, rate: float, burst: int) -> None:
        self.rate = rate
        self.burst = burst
        self._tokens = float(burst)
        self._last = time.monotonic()

    def allow(self, want: int) -> int:
        now = time.monotonic()
        self._tokens = min(
            float(self.burst), self._tokens + (now - self._last) * self.rate
        )
        self._last = now
        return max(0, min(want, int(self._tokens)))

    def consume(self, n: int) -> None:
        self._tokens -= n


class _LinkBucket:
    """Process-shared token bucket for one emulated LINK — the host NIC:
    a :class:`_StreamBucket` (same capped accrual math, one source of
    truth) behind a lock, because op threads of several communicators pace
    concurrently.

    Every communicator in a process draws from the same bucket (keyed by
    the link parameters), because one process models one host: replicas
    co-located on a host share its uplink, which is exactly the contention
    the hierarchical collectives exist to relieve.  Benches emulate an
    N-replica host by running N ranks as threads of one process
    (``dcn_bench.py --hosts``); single-rank processes (the existing bench
    layouts) are unaffected — their bucket has one tenant."""

    __slots__ = ("_bucket", "_lock")

    def __init__(self, rate: float, burst: int) -> None:
        self._bucket = _StreamBucket(rate, burst)
        self._lock = threading.Lock()

    def allow(self, want: int) -> int:
        with self._lock:
            return self._bucket.allow(want)

    def consume(self, n: int) -> None:
        with self._lock:
            self._bucket.consume(n)


_LINK_BUCKETS: Dict[Tuple[float, int], _LinkBucket] = {}
_LINK_BUCKETS_LOCK = threading.Lock()


def _shared_link(rate: float, burst: int) -> _LinkBucket:
    with _LINK_BUCKETS_LOCK:
        bucket = _LINK_BUCKETS.get((rate, burst))
        if bucket is None:
            bucket = _LINK_BUCKETS[(rate, burst)] = _LinkBucket(rate, burst)
        return bucket


class _NetEmu:
    """Deterministic sender-side network emulation (netem analog) for the
    TCP tier: a shared token-bucket link cap, a per-connection cwnd-limited
    stream cap, and a half-RTT gate before each frame's first byte.
    Loopback hides the regime the replica dimension is designed for (DCN:
    ~1-10 Gb/s, 2-10 ms RTT); with this, ring / quantized ring /
    heal-transfer behavior at DCN profiles is measured rather than
    extrapolated (``benchmarks/dcn_bench.py``).

    The stream cap is what makes multi-lane striping measurable: a single
    TCP stream on a long-RTT path is limited by min(link, cwnd/RTT), so one
    connection cannot saturate the link — exactly the underutilization the
    lane striping in :class:`_TcpMesh` exists to cure.  Default cwnd is
    ``TORCHFT_NET_CWND_KB`` (256 KiB; ``0`` disables the stream cap and
    restores the pure link-rate model); it only engages when RTT > 0.

    Enabled only via env — ``TORCHFT_NET_EMU`` (a named profile:
    ``wan_1g`` = 1 Gb/s / 10 ms, ``dcn_10g`` = 10 Gb/s / 2 ms) or the raw
    ``TORCHFT_NET_GBPS`` (link rate, Gbit/s) and ``TORCHFT_NET_RTT_MS``
    knobs — and never in production paths by default."""

    def __init__(
        self, gbps: float, rtt_ms: float, cwnd_bytes: int = 256 << 10
    ) -> None:
        self.bytes_per_s = gbps * 1e9 / 8.0
        self.half_rtt_s = rtt_ms / 2e3
        self.rtt_s = rtt_ms / 1e3
        # per-stream throughput cap (cwnd/RTT); 0 = uncapped
        self.stream_bytes_per_s = (
            cwnd_bytes / self.rtt_s if cwnd_bytes > 0 and self.rtt_s > 0 else 0.0
        )
        self.cwnd_bytes = cwnd_bytes
        self.burst = max(64 << 10, int(self.bytes_per_s * 0.005))
        # the LINK bucket is process-shared (one process = one emulated
        # host NIC; see _LinkBucket); stream buckets stay per-mesh since a
        # cwnd is per-connection state
        self._link = (
            _shared_link(self.bytes_per_s, self.burst)
            if self.bytes_per_s > 0
            else None
        )
        self._streams: Dict[object, _StreamBucket] = {}

    def frame_gate(self) -> float:
        """Earliest monotonic time the next frame may start transmitting."""
        return time.monotonic() + self.half_rtt_s

    def bdp_bytes(self) -> int:
        """RTT × bandwidth product of the emulated link (0 when either is
        unshaped) — the natural frame size on this profile."""
        if self.bytes_per_s <= 0 or self.rtt_s <= 0:
            return 0
        return int(self.bytes_per_s * self.rtt_s)

    def allow(self, want: int, stream: object = None) -> int:
        """Bytes the link (and, when RTT emulation is on, ``stream``'s cwnd
        bucket) permit right now (<= ``want``)."""
        if self._link is not None:
            want = self._link.allow(want)
        if stream is not None and self.stream_bytes_per_s > 0 and want > 0:
            bucket = self._streams.get(stream)
            if bucket is None:
                bucket = self._streams[stream] = _StreamBucket(
                    self.stream_bytes_per_s, self.cwnd_bytes
                )
            want = bucket.allow(want)
        return want

    def consume(self, n: int, stream: object = None) -> None:
        if self._link is not None:
            self._link.consume(n)
        if stream is not None and self.stream_bytes_per_s > 0:
            bucket = self._streams.get(stream)
            if bucket is not None:
                bucket.consume(n)


# ---------------------------------------------------------------------------
# fault injection (gray failures)
# ---------------------------------------------------------------------------

# Per-link fault program for the TCP tier's data plane — the gray-failure
# analog of the _NetEmu pacer: where the pacer shapes HEALTHY links, the
# fault program makes them flaky.  Spec syntax (comma-separated terms):
#
#   loss:P            per-sub-frame drop probability; a dropped sub-frame is
#                     retransmitted after one RTO (sender stalls ~2xRTT) —
#                     the TCP-over-lossy-link throughput penalty, without
#                     breaking the reliable-stream contract
#   reset:P           per-sub-frame probability the lane's connection is
#                     reset (socket closed mid-collective) — what the
#                     in-epoch lane retry/failover machinery recovers from
#   reset_once:N      deterministic form: exactly ONE reset after N
#                     sub-frames have been sent (tests/drills)
#   stall:P:MS        per-sub-frame probability the lane stalls MS
#                     milliseconds (one slow-NIC hiccup)
#   partition:A+B|self  partition mask: frames between the listed ranks and
#                     everyone else are silently blackholed (both
#                     directions); 'self' resolves to this mesh's own rank
#
# Armed via env (TORCHFT_NET_FAULTS=loss:0.01,reset:0.002) or at runtime —
# TCPCommunicator.arm_faults() — so chaos can flip a healthy link
# mid-collective.  TORCHFT_NET_FAULT_SEED makes draws reproducible.
NET_FAULTS_ENV = "TORCHFT_NET_FAULTS"
NET_FAULT_SEED_ENV = "TORCHFT_NET_FAULT_SEED"
# In-epoch lane recovery: how many re-dial attempts a transiently-reset
# lane gets before its traffic fails over to the surviving lanes, and the
# base of the jittered exponential backoff between attempts.
LANE_RETRIES_ENV = "TORCHFT_LANE_RETRIES"
LANE_BACKOFF_MS_ENV = "TORCHFT_LANE_BACKOFF_MS"
_LANE_RETRIES_DEFAULT = 2
_LANE_BACKOFF_MS_DEFAULT = 50.0


class _FaultProgram:
    """Parsed TORCHFT_NET_FAULTS spec (immutable; per-mesh RNG state lives
    on the mesh so one program can arm many meshes)."""

    __slots__ = (
        "loss", "reset", "reset_once", "stall_p", "stall_ms", "partition",
    )

    def __init__(
        self,
        loss: float = 0.0,
        reset: float = 0.0,
        reset_once: int = -1,
        stall_p: float = 0.0,
        stall_ms: float = 200.0,
        partition: Optional[frozenset] = None,
    ) -> None:
        self.loss = loss
        self.reset = reset
        self.reset_once = reset_once
        self.stall_p = stall_p
        self.stall_ms = stall_ms
        self.partition = partition

    def active(self) -> bool:
        return bool(
            self.loss > 0
            or self.reset > 0
            or self.reset_once >= 0
            or self.stall_p > 0
            or self.partition
        )

    def partitions(self, my_rank: int, peer: int) -> bool:
        """True when the (my_rank, peer) link crosses the partition mask."""
        if not self.partition:
            return False
        mask = {my_rank if m == "self" else m for m in self.partition}
        return (my_rank in mask) != (peer in mask)


def parse_fault_spec(raw: Optional[str]) -> Optional[_FaultProgram]:
    """Parse a fault-program spec string; None/empty disables injection."""
    if not raw or not raw.strip():
        return None
    kw: Dict[str, object] = {}
    for term in raw.strip().split(","):
        parts = term.strip().split(":")
        name = parts[0].strip().lower()
        try:
            if name == "loss":
                kw["loss"] = float(parts[1])
            elif name == "reset":
                kw["reset"] = float(parts[1])
            elif name == "reset_once":
                kw["reset_once"] = int(parts[1])
            elif name == "stall":
                kw["stall_p"] = float(parts[1])
                if len(parts) > 2:
                    kw["stall_ms"] = float(parts[2])
            elif name == "partition":
                kw["partition"] = frozenset(
                    "self" if m.strip().lower() == "self" else int(m)
                    for m in parts[1].split("+")
                )
            else:
                raise ValueError(f"unknown fault {name!r}")
        except (IndexError, ValueError) as e:
            # loud, not silent: a typo'd program would otherwise run CLEAN
            # and record healthy numbers as a fault drill
            raise CommunicatorError(
                f"unparseable {NET_FAULTS_ENV} term {term!r}: {e} "
                "(valid: loss:P, reset:P, reset_once:N, stall:P:MS, "
                "partition:A+B|self)"
            ) from e
    return _FaultProgram(**kw)  # type: ignore[arg-type]


def _net_faults_from_env() -> Optional[_FaultProgram]:
    return parse_fault_spec(os.environ.get(NET_FAULTS_ENV))


def _lane_retry_knobs() -> Tuple[int, float]:
    """(re-dial attempts, backoff base seconds) for in-epoch lane recovery."""
    try:
        retries = int(
            os.environ.get(LANE_RETRIES_ENV, "") or _LANE_RETRIES_DEFAULT
        )
        backoff_ms = float(
            os.environ.get(LANE_BACKOFF_MS_ENV, "") or _LANE_BACKOFF_MS_DEFAULT
        )
    except ValueError as e:
        raise CommunicatorError(
            f"unparseable {LANE_RETRIES_ENV}="
            f"{os.environ.get(LANE_RETRIES_ENV)!r} / {LANE_BACKOFF_MS_ENV}="
            f"{os.environ.get(LANE_BACKOFF_MS_ENV)!r}"
        ) from e
    return max(0, retries), max(0.001, backoff_ms / 1000.0)


# named emulation profiles (TORCHFT_NET_EMU): (link Gbit/s, RTT ms).  The
# aliases with the explicit RTT suffix match benchmarks/dcn_bench.py's
# profile names, so a bench row can be reproduced verbatim from env.
_NET_EMU_PROFILES = {
    "wan_1g": (1.0, 10.0),
    "wan_1g_10ms": (1.0, 10.0),
    "dcn_10g": (10.0, 2.0),
    "dcn_10g_2ms": (10.0, 2.0),
    "loopback": (0.0, 0.0),
}


def _net_emu_from_env() -> Optional["_NetEmu"]:
    profile = os.environ.get("TORCHFT_NET_EMU", "").strip().lower()
    prof_gbps, prof_rtt = 0.0, 0.0
    if profile:
        if profile not in _NET_EMU_PROFILES:
            # loud, not silent: a typo'd profile would otherwise run
            # UNSHAPED and record loopback numbers as a DCN profile
            raise CommunicatorError(
                f"unknown TORCHFT_NET_EMU profile {profile!r}; "
                f"valid: {sorted(_NET_EMU_PROFILES)}"
            )
        prof_gbps, prof_rtt = _NET_EMU_PROFILES[profile]
    try:
        gbps = float(os.environ.get("TORCHFT_NET_GBPS", "") or prof_gbps)
        rtt_ms = float(os.environ.get("TORCHFT_NET_RTT_MS", "") or prof_rtt)
        cwnd = int(
            float(os.environ.get("TORCHFT_NET_CWND_KB", "") or 256) * 1024
        )
    except ValueError as e:
        raise CommunicatorError(
            "unparseable network-emulation knob: "
            f"TORCHFT_NET_GBPS={os.environ.get('TORCHFT_NET_GBPS')!r} "
            f"TORCHFT_NET_RTT_MS={os.environ.get('TORCHFT_NET_RTT_MS')!r} "
            f"TORCHFT_NET_CWND_KB={os.environ.get('TORCHFT_NET_CWND_KB')!r}"
        ) from e
    if gbps <= 0 and rtt_ms <= 0:
        return None
    return _NetEmu(gbps, rtt_ms, cwnd)


# ---------------------------------------------------------------------------
# lane striping
# ---------------------------------------------------------------------------

# Parallel-connection ("lane") count for ring collectives.  One TCP stream
# on a long-RTT DCN path is cwnd-limited far below the link rate; striping
# each ring chunk across L independent connections is the standard cure
# (cf. PAPERS.md: HSDP-at-100k-GPUs / SPARe stripe inter-replica reduction
# the same way).  MUST be uniform across replicas (verified loudly at
# rendezvous); "auto"/unset derives it from the emulated link profile (1 on
# plain loopback, where a single stream already saturates).
RING_LANES_ENV = "TORCHFT_RING_LANES"
# Floor for one striped sub-frame, in KiB.  Unset/auto picks the link's
# RTT×bandwidth product (jumbo frames on DCN so the per-frame half-RTT gate
# amortizes; 64 KiB on loopback).  Uniform across replicas, like the lanes.
RING_FRAME_KB_ENV = "TORCHFT_RING_FRAME_KB"
_MAX_AUTO_LANES = 4
_MIN_STRIPE_BYTES = 64 << 10
# sub-frame boundaries are 64-byte aligned so no element of any supported
# dtype (itemsize a power of two <= 64) ever splits across lanes — the
# receive path can reduce a completed part without waiting for its siblings
_STRIPE_ALIGN = 64

# High bit of the rendezvous hello's rank field marks the EXTENDED hello
# (rank|flag, lane, lane count, stripe floor; 32 bytes), sent whenever
# lanes > 1.  A single-lane build sends the legacy 8-byte rank hello —
# wire-identical to every pre-lane build — and the flag bit lets EITHER
# side detect a lane-config disagreement from the first 8 bytes and fail
# loudly, instead of wedging on missing hello bytes or misparsing the
# extended hello's tail as a frame header.  (Ranks are tiny integers; the
# top bit is never a real rank.)
_LANE_HELLO_FLAG = 1 << 63
# Second-highest bit marks a RECONNECT hello: a lane re-dialed mid-epoch
# after a transient reset (in-epoch lane recovery).  Always the extended
# 32-byte form; only this build speaks it, which is fine — a peer that
# cannot reconnect simply leaves the lane dead and the legacy poison path
# applies.
_LANE_RECONN_FLAG = 1 << 62
# Reserved frame tag for in-band lane-failover control frames (a dead
# lane's endpoints agree on outstanding sub-frames over a surviving lane).
# Data tags are small positive ints (tag bases + step indices); the top of
# the u64 space is never a real tag.
_LANE_CTRL_TAG = (1 << 64) - 17
_LANE_CTRL = struct.Struct("<QQQ")  # kind, dead lane, completed-rx count
_LANE_RESYNC = struct.Struct("<QQ")  # tx seq, rx seq (reconnect handshake)


def _ring_lanes(emu: Optional[_NetEmu]) -> int:
    raw = os.environ.get(RING_LANES_ENV, "").strip().lower()
    if raw and raw != "auto":
        try:
            lanes = int(raw)
        except ValueError as e:
            raise CommunicatorError(
                f"unparseable {RING_LANES_ENV}={raw!r} (int or 'auto')"
            ) from e
        if lanes < 1:
            raise CommunicatorError(f"{RING_LANES_ENV} must be >= 1")
        return lanes
    # auto: enough lanes that the aggregate stream rate reaches the link
    # rate, capped; 1 when unshaped (loopback) or the stream cap is off
    if emu is None or emu.stream_bytes_per_s <= 0 or emu.bytes_per_s <= 0:
        return 1
    need = -(-int(emu.bytes_per_s) // max(1, int(emu.stream_bytes_per_s)))
    return max(1, min(_MAX_AUTO_LANES, need))


def _stripe_floor(emu: Optional[_NetEmu]) -> int:
    raw = os.environ.get(RING_FRAME_KB_ENV, "").strip().lower()
    if raw and raw != "auto":
        try:
            return max(_STRIPE_ALIGN, int(float(raw) * 1024))
        except ValueError as e:
            raise CommunicatorError(
                f"unparseable {RING_FRAME_KB_ENV}={raw!r} (KiB or 'auto')"
            ) from e
    if emu is not None:
        bdp = emu.bdp_bytes()
        if bdp > 0:
            # jumbo frames on DCN: one sub-frame covers at least a BDP so
            # the half-RTT frame gate amortizes over a full pipe of bytes
            return max(_MIN_STRIPE_BYTES, min(bdp, 8 << 20))
    return _MIN_STRIPE_BYTES


def _lane_parts(
    nbytes: int, lanes: int, floor: int
) -> List[Tuple[int, int, int]]:
    """Deterministic split of one ``nbytes`` frame into per-lane sub-frames:
    ``[(lane, start, stop), ...]``.  Both endpoints compute this from the
    frame length alone, so no extra wire metadata is needed; the native tier
    (``native/comm.h lane_parts``) implements the identical math so the
    tiers stay wire-compatible at any lane count.  Payloads smaller than
    two floors ride lane 0 whole (striping tiny frames only adds per-frame
    overhead)."""
    if lanes <= 1 or nbytes < 2 * floor:
        return [(0, 0, nbytes)]
    k = min(lanes, max(1, nbytes // floor))
    if k <= 1:
        return [(0, 0, nbytes)]
    bounds = [0]
    for i in range(1, k):
        cut = (i * nbytes // k) // _STRIPE_ALIGN * _STRIPE_ALIGN
        bounds.append(max(cut, bounds[-1]))
    bounds.append(nbytes)
    return [(lane, bounds[lane], bounds[lane + 1]) for lane in range(k)]


def outer_shard_parts(
    nbytes: int, parts: int, unit: int = _STRIPE_ALIGN
) -> List[Tuple[int, int]]:
    """Deterministic per-replica shard split for the sharded outer
    optimizer (``local_sgd``): the buffer is padded up to a multiple of
    ``parts * unit`` and every shard is exactly ``padded // parts`` bytes.
    A pure function of the payload size and the participant count — every
    replica derives identical shard ownership with no extra wire metadata,
    the same contract as :func:`_lane_parts` — and ``unit``-aligned so a
    shard boundary never splits an element (64 B default) or a
    quantization row (callers pass the row byte size).  Mirrored exactly in
    ``native/comm.h outer_shard_parts`` so the tiers agree on shard
    ownership at any world size.  Returns ``[(start, stop), ...]`` over the
    PADDED byte range, one entry per shard."""
    if parts < 1:
        raise CommunicatorError("outer_shard_parts: parts must be >= 1")
    if unit < 1 or unit % _STRIPE_ALIGN != 0:
        raise CommunicatorError(
            f"outer_shard_parts: unit must be a positive multiple of "
            f"{_STRIPE_ALIGN}, got {unit}"
        )
    share = -(-nbytes // (parts * unit)) * unit
    return [(p * share, (p + 1) * share) for p in range(parts)]


# ---------------------------------------------------------------------------
# host topology + shared-memory intra-host transport
# ---------------------------------------------------------------------------

# Hierarchical (topology-aware) collectives gate: "auto" (default) turns
# the two-level schedule on when the discovered topology has >= 2 hosts AND
# at least one host holds >= 2 replicas — the regime where flat rings push
# every byte across the DCN once per REPLICA instead of once per HOST.
# "1" forces it on (any topology, including all-one-host: collectives then
# run entirely over shared memory); "0" pins the flat ring, byte-for-byte
# identical to the pre-topology wire behavior.  A peer that speaks no
# topology (gate "0", legacy or native-tier build) never publishes its
# topology key: "auto" groups deterministically fall back to the flat ring
# (the key lands in the store before the dialable address, so absence
# after rendezvous is a fact, not a race); a forced "1" fails loudly.
HIERARCHICAL_ENV = "TORCHFT_HIERARCHICAL"
# Overrides host-group identity for this replica.  Default grouping is by
# the advertised rendezvous address' host part (same-IP grouping), which is
# right for one-process-per-replica SLURM/bench layouts; set distinct
# TORCHFT_HOST_ID values to partition co-located replicas into emulated
# hosts, or identical values to co-group replicas NAT'd behind one IP.
HOST_ID_ENV = "TORCHFT_HOST_ID"
# Per-member slot capacity of the intra-host shared-memory segment, MiB.
# Payloads larger than a slot stream through it in chunks.
SHM_SLOT_MB_ENV = "TORCHFT_SHM_SLOT_MB"
_SHM_SLOT_DEFAULT_MB = 16.0


def _hier_mode(override: Optional[str] = None) -> str:
    raw = (
        override
        if override is not None
        else os.environ.get(HIERARCHICAL_ENV, "auto")
    )
    raw = str(raw).strip().lower()
    if raw in ("", "auto"):
        return "auto"
    if raw in ("1", "true", "on"):
        return "1"
    if raw in ("0", "false", "off"):
        return "0"
    raise CommunicatorError(
        f"unparseable {HIERARCHICAL_ENV}={raw!r} (auto|0|1)"
    )


def _shm_slot_bytes() -> int:
    raw = os.environ.get(SHM_SLOT_MB_ENV, "").strip()
    try:
        mb = float(raw) if raw else _SHM_SLOT_DEFAULT_MB
    except ValueError as e:
        raise CommunicatorError(
            f"unparseable {SHM_SLOT_MB_ENV}={raw!r} (MiB)"
        ) from e
    # 64-byte multiple so chunk boundaries never split an element of any
    # supported dtype (same rationale as _STRIPE_ALIGN)
    return max(64 << 10, int(mb * (1 << 20)) // 64 * 64)


class _HostTopology:
    """Host grouping of one quorum epoch, identical on every rank.

    Hosts are ordered by their smallest global rank; each host's leader IS
    that smallest rank, and the cross-host ring runs over ``leader_ring``
    in that order — all derived from the (rank -> host id) map alone, so
    every rank computes the same schedule with no extra wire metadata.
    The native tier (``native/comm.h HostTopology``) implements the
    identical ordering so the tiers stay wire-compatible."""

    def __init__(self, host_of: Dict[int, str], rank: int) -> None:
        self.host_of = dict(host_of)
        groups: Dict[str, List[int]] = {}
        for r in sorted(host_of):
            groups.setdefault(host_of[r], []).append(r)
        self.hosts: List[List[int]] = sorted(
            groups.values(), key=lambda g: g[0]
        )
        self.leader_ring: List[int] = [g[0] for g in self.hosts]
        self.local: List[int] = next(g for g in self.hosts if rank in g)
        self.leader: int = self.local[0]
        self.is_leader: bool = rank == self.leader
        self.local_index: int = self.local.index(rank)

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    @property
    def local_world(self) -> int:
        return len(self.local)

    def worth_it(self) -> bool:
        """The "auto" criterion: hierarchy only pays when a cross-host ring
        exists AND some host would otherwise push duplicate bytes."""
        return self.num_hosts > 1 and any(len(g) > 1 for g in self.hosts)


_SHM_ABORT_OFF = 0  # u64 abort latch at the head of the segment header
_SHM_HDR = 64
_SHM_SLOT_HDR = 64  # u64 publish-sequence, padded to a cache line


class _ShmSeg:
    """mmap'd per-host segment: the zero-socket intra-host transport.

    The host leader creates a file under ``/dev/shm`` (tmpdir fallback),
    every local member maps it, and the leader unlinks it the moment all
    members acknowledge the mapping — unlinked-after-map, so a killed
    replica leaks nothing: the kernel frees the pages when the last
    mapping dies, and ``/dev/shm`` never shows an orphan.

    One slot per local member plus a seqlock-style publish protocol:
    a writer copies its payload into its slot and then publishes a
    monotonically increasing sequence number; readers spin (abort- and
    deadline-checked) until the slot's sequence reaches the op's expected
    value.  The sequence store happens strictly after the payload copy
    (single ``struct.pack_into`` following the slice assignment), which on
    the GIL within a process — and x86-TSO across processes — is exactly
    the publish-after-payload order a seqlock needs.  Flow control is
    lock-step per chunk: the consumer republishes the same sequence on its
    OWN slot as an ack before the producer may overwrite.

    ``_seq`` is a local op counter advanced identically on every member
    (collectives execute in submission order on each rank's op thread, and
    submission order matches across ranks), so expected sequence values
    never ride the wire either."""

    def __init__(self, mm: mmap.mmap, members: int, slot_bytes: int) -> None:
        self._mm = mm
        self.members = members
        self.slot_bytes = slot_bytes
        self._seq = 0

    # -- lifecycle -----------------------------------------------------------

    @staticmethod
    def size_for(members: int, slot_bytes: int) -> int:
        return _SHM_HDR + members * (_SHM_SLOT_HDR + slot_bytes)

    @classmethod
    def create(cls, members: int, slot_bytes: int) -> Tuple["_ShmSeg", str]:
        base = "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()
        path = os.path.join(base, f"tpuft_shm_{uuid.uuid4().hex}")
        nbytes = cls.size_for(members, slot_bytes)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, nbytes)
            mm = mmap.mmap(fd, nbytes)
        except BaseException:
            os.close(fd)
            os.unlink(path)
            raise
        os.close(fd)
        return cls(mm, members, slot_bytes), path

    @classmethod
    def attach(cls, path: str, members: int, slot_bytes: int) -> "_ShmSeg":
        nbytes = cls.size_for(members, slot_bytes)
        fd = os.open(path, os.O_RDWR)
        try:
            mm = mmap.mmap(fd, nbytes)
        finally:
            os.close(fd)
        return cls(mm, members, slot_bytes)

    def _slot_off(self, idx: int) -> int:
        return _SHM_HDR + idx * (_SHM_SLOT_HDR + self.slot_bytes)

    # -- abort latch ---------------------------------------------------------

    def set_abort(self) -> None:
        try:
            struct.pack_into("<Q", self._mm, _SHM_ABORT_OFF, 1)
        except ValueError:  # pragma: no cover - segment already torn down
            pass

    def aborted(self) -> bool:
        return struct.unpack_from("<Q", self._mm, _SHM_ABORT_OFF)[0] != 0

    # -- seqlock publish / wait ---------------------------------------------

    def post(self, idx: int, seq: int, payload: Optional[memoryview]) -> None:
        """Copy ``payload`` (None = flag-only ack) into slot ``idx``, then
        publish ``seq``."""
        off = self._slot_off(idx)
        if payload is not None and len(payload) > 0:
            start = off + _SHM_SLOT_HDR
            self._mm[start : start + len(payload)] = payload
        struct.pack_into("<Q", self._mm, off, seq)

    def wait(
        self,
        idx: int,
        seq: int,
        deadline: float,
        extra_abort: Optional[threading.Event] = None,
    ) -> None:
        """Spin until slot ``idx`` publishes a sequence >= ``seq``."""
        off = self._slot_off(idx)
        spins = 0
        while struct.unpack_from("<Q", self._mm, off)[0] < seq:
            if self.aborted() or (
                extra_abort is not None and extra_abort.is_set()
            ):
                raise CommunicatorAborted("communicator aborted (shm)")
            if time.monotonic() > deadline:
                raise TimeoutError("intra-host shm op timed out")
            spins += 1
            # yield the GIL so a sibling-thread writer can run; back off to
            # a real sleep once it is clearly a cross-process wait
            time.sleep(0 if spins < 2000 else 0.0002)

    def view(self, idx: int, nbytes: int) -> memoryview:
        start = self._slot_off(idx) + _SHM_SLOT_HDR
        return memoryview(self._mm)[start : start + nbytes]


def _rearm_frame(frame: dict) -> None:
    """(Re)build a send frame's live buffer list from its retained
    originals — fresh frames and reset-replayed frames go through the same
    path, so a replay is byte-identical to the first transmission."""
    bufs = [memoryview(frame["hdr"])]
    payload = frame["payload"]
    if payload is not None and len(payload):
        bufs.append(payload)
    frame["bufs"] = bufs


def _mk_frame(hdr: bytes, payload: Optional[memoryview], ctrl: bool = False) -> dict:
    frame = {"hdr": hdr, "payload": payload, "ctrl": ctrl, "checked": ctrl}
    _rearm_frame(frame)
    return frame


class _ExchangeCtx:
    """Mutable state of one ``exchange()`` call, shared with the lane
    recovery machinery: the send/recv FIFOs, per-socket receive state, the
    completed-sub-frame log (replay source for lane resets), pacer gates,
    and in-flight failover handshakes."""

    __slots__ = (
        "send_q", "recv_q", "recv_st", "sent_log", "frame_gates",
        "pending_failover", "dying", "dying_sends",
    )

    def __init__(self) -> None:
        self.send_q: Dict[Tuple[int, int], List[dict]] = {}
        self.recv_q: Dict[Tuple[int, int], List[dict]] = {}
        self.recv_st: Dict[Tuple[int, int], dict] = {}
        self.sent_log: Dict[Tuple[int, int], List[dict]] = {}
        self.frame_gates: Dict[Tuple[int, int], float] = {}
        self.pending_failover: Dict[Tuple[int, int], dict] = {}
        # injected-reset half-close state: lanes we SHUT_WR'd and are
        # draining to EOF before recovery (so no flushed byte is ever
        # destroyed by an abortive close), with their parked sends
        self.dying: set = set()
        self.dying_sends: Dict[Tuple[int, int], List[dict]] = {}


class _TcpMesh:
    """Full mesh of rank-to-rank lane sockets for one quorum epoch.

    Rendezvous: every rank publishes its listener under ``{prefix}/{rank}``
    in the store; for each pair (i, j) with i < j, j dials i — once per
    **lane**.  Lanes are parallel TCP connections that one logical
    collective stripes its frames across (``_lane_parts``), curing
    single-stream cwnd underutilization on long-RTT links; lane count MUST
    be uniform across ranks and is verified in the hello frame.  All data
    ops for the epoch run on a single op thread, so sockets need no locking
    and collective issue order matches across ranks; one select loop
    multiplexes every lane.

    Point-to-point byte ops (sends/recvs, heal drains) ride the LAST lane
    (``p2p_lane``) whole — with lanes > 1 that keeps striped heal traffic
    off lane 0, where collective control frames (barriers, small rings)
    concentrate; with lanes == 1 it is byte-for-byte the legacy behavior.
    """

    def __init__(
        self,
        store_addr: str,
        rank: int,
        world_size: int,
        timeout_s: float,
        lanes: int = 0,
        host_id: Optional[str] = None,
        hier: Optional[str] = None,
        faults: Optional[_FaultProgram] = None,
        flight: Optional[FlightRecorder] = None,
    ) -> None:
        self.rank = rank
        self.world_size = world_size
        # flight recorder of the owning communicator (None when unattached):
        # lane reconnects/failovers and env-armed fault programs record here
        self._flight = flight
        self._aborted = threading.Event()
        # netem-style pacing (off unless TORCHFT_NET_EMU/GBPS/RTT_MS set)
        self._emu = _net_emu_from_env()
        self.lanes = lanes if lanes > 0 else _ring_lanes(self._emu)
        self.p2p_lane = self.lanes - 1
        self.stripe_floor = _stripe_floor(self._emu)
        # lane-0 sockets keep the legacy name: single-lane code paths (and
        # tests) address peers through it unchanged
        self.peers: Dict[int, socket.socket] = {}
        self.lane_socks: Dict[Tuple[int, int], socket.socket] = {}
        self._sock_key: Dict[socket.socket, Tuple[int, int]] = {}
        # per-lane observability: payload bytes moved and stall events
        # (pacer denials / kernel would-block) — surfaced via
        # TCPCommunicator.lane_stats() into manager.last_quorum_timings
        self.lane_tx_bytes = [0] * self.lanes
        self.lane_rx_bytes = [0] * self.lanes
        self.lane_stalls = [0] * self.lanes
        # gray-failure machinery: fault program (env or runtime-armed),
        # in-epoch lane recovery knobs + counters, per-(peer, lane)
        # completed-sub-frame sequence counters the reconnect/failover
        # resync handshakes run on, and the per-peer dead-lane set (agreed
        # by handshake, so both sides route identically)
        self.faults: Optional[_FaultProgram] = (
            faults if faults is not None else _net_faults_from_env()
        )
        if faults is None and self.faults is not None and self._flight:
            # process-plane chaos arming: the fault program rode the spawn
            # env (TORCHFT_NET_FAULTS); runtime arming records in
            # arm_faults instead, so the two planes never double-record
            self._flight.record(
                FlightEvent.CHAOS_INJECT, via="env", armed=True
            )
        import random as _random

        seed_raw = os.environ.get(NET_FAULT_SEED_ENV, "")
        self._fault_rng = _random.Random(
            (int(seed_raw) * 1_000_003 + rank) if seed_raw else None
        )
        self.lane_retries, self.lane_backoff_s = _lane_retry_knobs()
        self.lane_reconnects = 0
        self.lane_failovers = 0
        self.faults_injected = 0
        self._fault_frames = 0
        self._reset_once_fired = False
        self._tx_seq: Dict[Tuple[int, int], int] = {}
        self._rx_seq: Dict[Tuple[int, int], int] = {}
        self.dead_lanes: Dict[int, set] = {}
        # lane re-dials land here (accept thread -> recovering op thread)
        self._pending_reconn: Dict[Tuple[int, int], socket.socket] = {}
        self._reconn_cv = threading.Condition()
        self._peer_addrs: Dict[int, Tuple[str, int]] = {}
        # topology (hierarchical collectives): filled by _topo_rendezvous
        # below; None = flat ring (the byte-for-byte legacy data plane)
        self.topo: Optional[_HostTopology] = None
        self.shm: Optional[_ShmSeg] = None
        self.shm_tx_bytes = 0
        self.shm_rx_bytes = 0
        hier_mode = _hier_mode(hier)

        store = create_store_client(store_addr, timeout=timeout_s)

        listener = create_listener("0.0.0.0:0", backlog=world_size * self.lanes)
        port = listener.getsockname()[1]
        host = socket.gethostname()
        try:
            # prefer a dialable address even on hosts with odd hostname setup
            socket.getaddrinfo(host, port)
        except socket.gaierror:
            host = "127.0.0.1"
        self._my_host_id = host_id or os.environ.get(HOST_ID_ENV) or host
        if "|" in self._my_host_id:
            raise CommunicatorError(
                f"host id {self._my_host_id!r} must not contain '|'"
            )
        if hier_mode != "0":
            # published BEFORE the dialable address: a completed socket mesh
            # then implies every topology-speaking peer's key is already
            # visible, so "key absent" after rendezvous is a deterministic
            # legacy/native-tier signal (fall back to flat), never a race.
            # The MODE rides along so an auto-vs-forced disagreement (which
            # would let one rank engage the two-level schedule while a peer
            # stays flat) fails loudly, like the lane-count hello.
            store.set(
                f"topo_{rank}", f"{hier_mode}|{self._my_host_id}".encode()
            )
        store.set(f"{rank}", f"{host}:{port}".encode())

        expected_inbound = (world_size - rank - 1) * self.lanes
        inbound: Dict[Tuple[int, int], socket.socket] = {}
        accept_err: List[BaseException] = []

        def _accept_all() -> None:
            try:
                listener.settimeout(timeout_s)
                for _ in range(expected_inbound):
                    conn, _ = listener.accept()
                    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    raw = _recv_exact(conn, 8, self._aborted, timeout_s)
                    (first,) = struct.unpack("<Q", raw)
                    if not first & _LANE_HELLO_FLAG:
                        # legacy 8-byte hello: a single-lane peer.  A lane
                        # disagreement is a config error — fail LOUDLY here
                        # instead of desynchronizing frames mid-collective.
                        if self.lanes != 1:
                            raise CommunicatorError(
                                f"lane-count mismatch: rank {first} has 1 "
                                f"lane, we have {self.lanes} "
                                f"({RING_LANES_ENV} must be uniform)"
                            )
                        inbound[(int(first), 0)] = conn
                        continue
                    peer_rank = int(first & ~_LANE_HELLO_FLAG)
                    tail = _recv_exact(conn, 24, self._aborted, timeout_s)
                    lane, peer_lanes, peer_floor = struct.unpack("<QQQ", tail)
                    if int(peer_lanes) != self.lanes:
                        raise CommunicatorError(
                            f"lane-count mismatch: rank {peer_rank} has "
                            f"{peer_lanes} lanes, we have {self.lanes} "
                            f"({RING_LANES_ENV} must be uniform)"
                        )
                    if int(peer_floor) != self.stripe_floor:
                        # the floor shapes the deterministic sub-frame
                        # split — a disagreement would desynchronize every
                        # striped frame
                        raise CommunicatorError(
                            f"stripe-floor mismatch: rank {peer_rank} has "
                            f"{peer_floor} bytes, we have "
                            f"{self.stripe_floor} ({RING_FRAME_KB_ENV} / "
                            "the net-emu profile must be uniform)"
                        )
                    inbound[(peer_rank, int(lane))] = conn
            except BaseException as e:  # noqa: BLE001
                accept_err.append(e)

        acceptor = threading.Thread(target=_accept_all, daemon=True)
        acceptor.start()

        try:
            for peer in range(rank):
                addr = store.get(f"{peer}", timeout=timeout_s).decode()
                peer_host, peer_port = addr.rsplit(":", 1)
                # kept for in-epoch lane re-dials (we are the dialer for
                # every peer with a lower rank)
                self._peer_addrs[peer] = (peer_host.strip("[]"), int(peer_port))
                for lane in range(self.lanes):
                    sock = socket.create_connection(
                        (peer_host.strip("[]"), int(peer_port)),
                        timeout=timeout_s,
                    )
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    if self.lanes == 1:
                        sock.sendall(struct.pack("<Q", rank))
                    else:
                        sock.sendall(
                            struct.pack(
                                "<QQQQ",
                                rank | _LANE_HELLO_FLAG,
                                lane,
                                self.lanes,
                                self.stripe_floor,
                            )
                        )
                    self.lane_socks[(peer, lane)] = sock

            acceptor.join(timeout=timeout_s + 5.0)
            if accept_err:
                raise CommunicatorError(
                    f"rank {rank} rendezvous accept failed: {accept_err[0]}"
                ) from accept_err[0]
            if acceptor.is_alive():
                raise CommunicatorError(f"rank {rank} rendezvous timed out")
            self.lane_socks.update(inbound)
        except BaseException:
            listener.close()
            raise
        # the listener stays open for the epoch: a transiently-reset lane
        # re-dials it mid-epoch (in-epoch lane recovery) instead of forcing
        # a full re-rendezvous; abort() closes it
        self._listener = listener
        self._timeout_s = timeout_s
        threading.Thread(
            target=self._reconn_accept,
            name=f"tpuft_lane_reconn_{rank}",
            daemon=True,
        ).start()

        for (peer, lane), sock in self.lane_socks.items():
            sock.setblocking(False)
            self._sock_key[sock] = (peer, lane)
            if lane == 0:
                self.peers[peer] = sock

        if hier_mode != "0":
            try:
                self._topo_rendezvous(store, hier_mode, timeout_s)
            except BaseException:
                self.abort()  # close the lane sockets a failed epoch leaves
                raise

    def _topo_rendezvous(self, store, hier_mode: str, timeout_s: float) -> None:
        """Host-group discovery + per-host shared-memory segment setup.

        Every topology-speaking rank published its host identity under
        ``topo_{rank}`` (the explicit ctor/``TORCHFT_HOST_ID`` override,
        else the host part of its advertised rendezvous address — same-IP
        grouping) BEFORE its dialable address, so with the socket mesh up
        every such key is already visible.  A peer with no key is a
        legacy/native-tier build or runs ``TORCHFT_HIERARCHICAL=0``: in
        "auto" mode the whole group deterministically falls back to the
        flat ring (every rank observes the same missing key); a FORCED "1"
        fails loudly instead — the operator demanded a schedule the peer
        cannot speak."""
        host_of = {self.rank: self._my_host_id}
        for peer in range(self.world_size):
            if peer == self.rank:
                continue
            # present-or-never (see publication ordering above), so the
            # non-blocking exists() is unambiguous: False IS "peer speaks
            # no topology", never "not yet".  A store ERROR must raise —
            # mapping it to the flat fallback could desync this rank's
            # schedule from peers that read the key fine.
            if not store.exists(f"topo_{peer}"):
                if hier_mode == "1":
                    raise CommunicatorError(
                        f"rank {peer} published no topology key — "
                        f"{HIERARCHICAL_ENV}=1 requires every replica "
                        "(and tier) to speak topology"
                    )
                logger.info(
                    "topology: rank %d speaks no topology; flat ring", peer
                )
                return
            peer_mode, peer_host = (
                store.get(f"topo_{peer}", timeout=timeout_s)
                .decode()
                .split("|", 1)
            )
            if peer_mode != hier_mode:
                # auto-vs-forced would leave the engaged/flat decision to
                # each rank's own gate — a silent schedule desync on any
                # topology where the two disagree.  Loud, like lanes.
                raise CommunicatorError(
                    f"{HIERARCHICAL_ENV} mismatch: rank {peer} runs "
                    f"{peer_mode!r}, we run {hier_mode!r} (must be uniform)"
                )
            host_of[peer] = peer_host
        topo = _HostTopology(host_of, self.rank)
        if hier_mode != "1" and not topo.worth_it():
            return  # auto: flat topology, keep the legacy ring
        if platform.machine().lower() not in ("x86_64", "amd64"):
            # the shm seqlock's publish-after-payload ordering leans on
            # x86-TSO for CROSS-PROCESS members; weaker memory models could
            # let a reader see the sequence before the payload lands
            if hier_mode == "1":
                raise CommunicatorError(
                    "the shared-memory intra-host transport requires a TSO "
                    f"architecture (x86_64); this host is "
                    f"{platform.machine()!r} — unset {HIERARCHICAL_ENV}"
                )
            logger.warning(
                "topology: non-TSO architecture %s; flat ring",
                platform.machine(),
            )
            return
        self.topo = topo
        if topo.local_world == 1:
            return  # leader-only host: the cross-host ring needs no shm
        # the leader's slot size wins so an intra-host TORCHFT_SHM_SLOT_MB
        # disagreement can corrupt nothing — members adopt it from the key
        if topo.is_leader:
            slot_bytes = _shm_slot_bytes()
            seg, path = _ShmSeg.create(topo.local_world, slot_bytes)
            store.set(f"shmseg_{topo.leader}", f"{path}|{slot_bytes}".encode())
            try:
                for member in topo.local[1:]:
                    store.get(f"shmok_{member}", timeout=timeout_s)
            finally:
                # unlinked-after-map: from here the segment exists only as
                # live mappings; a killed replica leaks nothing in /dev/shm
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self.shm = seg
        else:
            raw = store.get(f"shmseg_{topo.leader}", timeout=timeout_s).decode()
            path, slot_raw = raw.rsplit("|", 1)
            self.shm = _ShmSeg.attach(path, topo.local_world, int(slot_raw))
            store.set(f"shmok_{self.rank}", b"1")

    # -- intra-host shared-memory collectives --------------------------------

    def _shm_chunks(self, nbytes: int) -> List[Tuple[int, int]]:
        assert self.shm is not None
        cap = self.shm.slot_bytes
        if nbytes == 0:
            return [(0, 0)]
        return [(s, min(s + cap, nbytes)) for s in range(0, nbytes, cap)]

    def shm_reduce(self, flat: np.ndarray, op: ReduceOp, deadline: float) -> None:
        """Intra-host reduce into the host leader's ``flat``, in FIXED
        ascending global-rank order (run-to-run deterministic: the leader's
        own buffer is the accumulator, members fold in by local index).
        Members' buffers are left untouched; lock-step per chunk — the
        leader's ack republish gates each member's next chunk."""
        seg, topo = self.shm, self.topo
        assert topo is not None
        if seg is None or topo.local_world == 1:
            return
        view = _bytes_view(flat)
        chunks = self._shm_chunks(view.nbytes)
        base = seg._seq
        itemsize = flat.dtype.itemsize
        me = topo.local_index
        if me == 0:
            acc = flat.reshape(-1)
            for c, (s, e) in enumerate(chunks):
                lo, hi = s // itemsize, e // itemsize
                for j in range(1, topo.local_world):
                    seg.wait(j, base + c + 1, deadline, self._aborted)
                    incoming = np.frombuffer(
                        seg.view(j, e - s), dtype=flat.dtype
                    )
                    _reduce_into(op, acc[lo:hi], incoming)
                    self.shm_rx_bytes += e - s
                seg.post(0, base + c + 1, None)  # ack: slots may be reused
        else:
            for c, (s, e) in enumerate(chunks):
                seg.post(me, base + c + 1, view[s:e])
                self.shm_tx_bytes += e - s
                seg.wait(0, base + c + 1, deadline, self._aborted)
        seg._seq = base + len(chunks)

    def shm_bcast(
        self, flat: np.ndarray, deadline: float, src_idx: int = 0
    ) -> None:
        """Intra-host broadcast of ``flat`` from local member ``src_idx``
        (the leader by default) into every other member's ``flat``."""
        seg, topo = self.shm, self.topo
        assert topo is not None
        if seg is None or topo.local_world == 1:
            return
        view = _bytes_view(flat)
        chunks = self._shm_chunks(view.nbytes)
        base = seg._seq
        me = topo.local_index
        readers = [j for j in range(topo.local_world) if j != src_idx]
        if me == src_idx:
            for c, (s, e) in enumerate(chunks):
                seg.post(src_idx, base + c + 1, view[s:e])
                self.shm_tx_bytes += e - s
                for j in readers:
                    seg.wait(j, base + c + 1, deadline, self._aborted)
        else:
            for c, (s, e) in enumerate(chunks):
                seg.wait(src_idx, base + c + 1, deadline, self._aborted)
                view[s:e] = seg.view(src_idx, e - s)
                self.shm_rx_bytes += e - s
                seg.post(me, base + c + 1, None)  # ack
        seg._seq = base + len(chunks)

    def shm_gather(
        self, arr: np.ndarray, deadline: float
    ) -> Optional[List[np.ndarray]]:
        """Intra-host gather: the leader returns every local member's
        buffer (local-group order, its own included); members return None.
        Same shape/dtype on every member."""
        seg, topo = self.shm, self.topo
        assert topo is not None
        if seg is None or topo.local_world == 1:
            return [arr] if topo.is_leader else None
        view = _bytes_view(arr)
        chunks = self._shm_chunks(view.nbytes)
        base = seg._seq
        me = topo.local_index
        out: Optional[List[np.ndarray]] = None
        if me == 0:
            out = [arr] + [
                np.empty_like(arr) for _ in range(topo.local_world - 1)
            ]
            views = [_bytes_view(a) for a in out]
            for c, (s, e) in enumerate(chunks):
                for j in range(1, topo.local_world):
                    seg.wait(j, base + c + 1, deadline, self._aborted)
                    views[j][s:e] = seg.view(j, e - s)
                    self.shm_rx_bytes += e - s
                seg.post(0, base + c + 1, None)  # ack
        else:
            for c, (s, e) in enumerate(chunks):
                seg.post(me, base + c + 1, view[s:e])
                self.shm_tx_bytes += e - s
                seg.wait(0, base + c + 1, deadline, self._aborted)
        seg._seq = base + len(chunks)
        return out

    # -- lane lookups --------------------------------------------------------

    def lane_sock(self, peer: int, lane: int) -> socket.socket:
        return self.lane_socks[(peer, lane)]

    def _alive_lanes(self, peer: int) -> List[int]:
        dead = self.dead_lanes.get(peer, ())
        return [ln for ln in range(self.lanes) if ln not in dead]

    def _lane_route(self, peer: int, lane: int) -> int:
        """Transport lane actually carrying logical lane ``lane`` to
        ``peer``: identity while the lane lives; after an agreed failover,
        the lowest surviving lane.  Both endpoints derive the dead set from
        the same failover handshake, so routed frames stay matched — the
        LOGICAL ``_lane_parts`` split (and therefore the reduction math)
        never changes, only the transport assignment."""
        dead = self.dead_lanes.get(peer)
        if not dead or lane not in dead:
            return lane
        alive = self._alive_lanes(peer)
        if not alive:
            raise PeerGoneError(f"all lanes to rank {peer} are dead")
        return alive[0]

    def p2p_sock(self, peer: int) -> socket.socket:
        """The designated point-to-point lane socket (last lane; the one and
        only socket at lanes == 1).  Routed around failed-over lanes."""
        return self.lane_socks[(peer, self._lane_route(peer, self.p2p_lane))]

    # -- in-epoch lane recovery ----------------------------------------------

    def _reconn_accept(self) -> None:
        """Accept in-epoch lane re-dials for the life of the mesh.

        A reconnect hello is always the 32-byte extended form with
        ``_LANE_RECONN_FLAG`` set; anything else is dropped (stray dials).
        The accepted socket is parked in ``_pending_reconn`` for the
        recovering op thread to pick up — the resync handshake runs there,
        never here, so this loop can stay dumb and lock-free."""
        try:
            self._listener.settimeout(0.25)
        except OSError:
            return
        while not self._aborted.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn.settimeout(5.0)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                raw = _recv_exact(conn, 8, self._aborted, 5.0)
                (first,) = struct.unpack("<Q", raw)
                if not first & _LANE_RECONN_FLAG:
                    conn.close()
                    continue
                peer_rank = int(
                    first & ~(_LANE_HELLO_FLAG | _LANE_RECONN_FLAG)
                )
                tail = _recv_exact(conn, 24, self._aborted, 5.0)
                lane, peer_lanes, peer_floor = struct.unpack("<QQQ", tail)
                if (
                    not 0 <= peer_rank < self.world_size
                    or int(peer_lanes) != self.lanes
                    or int(peer_floor) != self.stripe_floor
                    or not 0 <= int(lane) < self.lanes
                ):
                    conn.close()
                    continue
            except (OSError, CommunicatorError):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            with self._reconn_cv:
                stale = self._pending_reconn.pop((peer_rank, int(lane)), None)
                if stale is not None:
                    try:
                        stale.close()
                    except OSError:
                        pass
                self._pending_reconn[(peer_rank, int(lane))] = conn
                self._reconn_cv.notify_all()

    # -- low-level duplex IO -------------------------------------------------

    def abort(self) -> None:
        self._aborted.set()
        if self.shm is not None:
            # latch the abort into the shared segment so local members
            # blocked in an shm spin (possibly in OTHER processes) unblock
            # with CommunicatorAborted, same poison path as the sockets
            self.shm.set_abort()
        listener = getattr(self, "_listener", None)
        if listener is not None:
            try:
                listener.close()
            except OSError:
                pass
        with self._reconn_cv:
            pending, self._pending_reconn = dict(self._pending_reconn), {}
            self._reconn_cv.notify_all()
        for sock in pending.values():
            try:
                sock.close()
            except OSError:
                pass
        for sock in self.lane_socks.values():
            try:
                sock.close()
            except OSError:
                pass

    def _check_abort(self) -> None:
        if self._aborted.is_set():
            raise CommunicatorAborted("communicator aborted")

    def send_frame_stream(
        self, dst: int, tag: int, nbytes: int, parts: Any, deadline: float
    ) -> None:
        """One frame of ``nbytes`` on the p2p lane, its payload written
        as ``parts`` (``(view, release)`` pairs) arrive: the bytes on the
        wire are :meth:`exchange`'s for the joined payload."""
        key = (dst, self._lane_route(dst, self.p2p_lane))
        sock = self.lane_socks[key]

        def _send_all(view: memoryview) -> None:
            while len(view):
                self._check_abort()
                if time.monotonic() > deadline:
                    raise TimeoutError("send_frame_stream timed out")
                _, writable, _ = select.select([], [sock], [], 0.1)
                if not writable:
                    continue
                try:
                    sent = sock.send(view)
                except BlockingIOError:
                    self.lane_stalls[key[1]] += 1
                    continue
                except OSError as e:
                    raise PeerGoneError(f"send to rank {dst} failed: {e}") from e
                self.lane_tx_bytes[key[1]] += sent
                view = view[sent:]

        _send_all(memoryview(_HDR.pack(nbytes, tag)))
        sent = 0
        with closing_parts(parts) as each:
            for view, release in each:
                view = memoryview(view).cast("B")
                _send_all(view)
                release()
                sent += len(view)
        if sent != nbytes:
            raise CommunicatorError(f"frame parts carried {sent} bytes, not {nbytes}")
        self._tx_seq[key] = self._tx_seq.get(key, 0) + 1

    def recv_dynamic_into(
        self, src: int, tag: int, view: memoryview, deadline: float
    ) -> int:
        """Header-aware zero-copy receive: payload lands in ``view`` (cap
        semantics — payload may be smaller); returns the payload size."""
        sock = self.p2p_sock(src)

        def _recv_some(into: memoryview) -> int:
            while True:
                self._check_abort()
                if time.monotonic() > deadline:
                    raise TimeoutError("recv_dynamic_into timed out")
                readable, _, _ = select.select([sock], [], [], 0.1)
                if not readable:
                    continue
                try:
                    n = sock.recv_into(into)
                except BlockingIOError:
                    continue
                if n == 0:
                    raise PeerGoneError(f"connection to rank {src} closed")
                return n

        hdr = bytearray(_HDR.size)
        off = 0
        while off < len(hdr):
            off += _recv_some(memoryview(hdr)[off:])
        nbytes, rtag = _HDR.unpack(bytes(hdr))
        if rtag != tag:
            raise CommunicatorError(
                f"tag mismatch from rank {src}: got {rtag}, want {tag}"
            )
        if nbytes > len(view):
            # drain into scratch so the stream stays frame-aligned, THEN fail
            scratch = bytearray(min(1 << 20, nbytes))
            remaining = nbytes
            while remaining > 0:
                got = _recv_some(memoryview(scratch)[: min(len(scratch), remaining)])
                remaining -= got
            raise CommunicatorError(
                f"recv buffer too small: payload {nbytes} > cap {len(view)}"
            )
        off = 0
        while off < nbytes:
            off += _recv_some(view[off:nbytes])
        return nbytes

    def recv_dynamic(self, src: int, tag: int, deadline: float) -> bytes:
        """Receive one frame from ``src`` without knowing its size upfront —
        the frame header carries nbytes, so this pairs with any plain send."""
        sock = self.p2p_sock(src)

        def _recv_some(view: memoryview) -> int:
            while True:
                self._check_abort()
                if time.monotonic() > deadline:
                    raise TimeoutError("recv_dynamic timed out")
                readable, _, _ = select.select([sock], [], [], 0.1)
                if not readable:
                    continue
                try:
                    n = sock.recv_into(view)
                except BlockingIOError:
                    continue
                if n == 0:
                    raise PeerGoneError(f"connection to rank {src} closed")
                return n

        hdr = bytearray(_HDR.size)
        off = 0
        while off < len(hdr):
            off += _recv_some(memoryview(hdr)[off:])
        nbytes, rtag = _HDR.unpack(bytes(hdr))
        if rtag != tag:
            raise CommunicatorError(
                f"tag mismatch from rank {src}: got {rtag}, want {tag}"
            )
        buf = bytearray(nbytes)
        off = 0
        while off < nbytes:
            off += _recv_some(memoryview(buf)[off:])
        return bytes(buf)

    @_spanned("comm::lane_window")
    def exchange(
        self,
        sends: List[Tuple[int, int, memoryview]],
        recvs: Sequence[Tuple],
        deadline: float,
        lane: Optional[int] = None,
    ) -> None:
        """Concurrently push ``sends`` and drain ``recvs``.

        ``sends`` entries are ``(peer_rank, tag, payload_view)``; ``recvs``
        entries additionally accept an optional 4th element — an
        ``on_part(start, stop)`` callable invoked (on the op thread) as each
        completed byte range of the payload lands, which is what lets the
        ring reduce a lane's sub-chunk while the other lanes still stream.

        With ``lane=None`` every frame is striped across the mesh's lanes
        by the deterministic ``_lane_parts`` split (both endpoints compute
        the identical split from the frame length, and sub-frame boundaries
        are element-aligned, so results are bit-identical at any lane
        count); pass an explicit ``lane`` to pin a whole frame to one
        connection (the point-to-point path).

        Concurrent duplex IO (select-driven, non-blocking sockets, one loop
        multiplexing all lanes) is what makes ring steps deadlock-free:
        every rank sends to its right neighbor while receiving from its
        left without ordering constraints.

        Gray-failure resilience (striped path only, ``lane=None``): a
        transient connection reset on one lane re-dials with bounded
        jittered backoff (``TORCHFT_LANE_RETRIES`` /
        ``TORCHFT_LANE_BACKOFF_MS``) and replays the sub-frames the reset
        swallowed (every completed sub-frame of the CURRENT exchange is
        retained for replay; resets reaching deeper poison the epoch as
        before).  If re-dial fails, the two endpoints agree — via a control
        frame on a surviving lane — on the dead lane's outstanding
        sub-frames and re-route them; the epoch only poisons when every
        lane to a peer is dead.  Point-to-point ops (explicit ``lane``)
        keep the peer-scoped fail-stop contract the striped heal relies on.
        """
        emu = self._emu
        recovery_ok = lane is None

        def _parts(nbytes: int) -> List[Tuple[int, int, int]]:
            if lane is not None:
                return [(lane, 0, nbytes)]
            return _lane_parts(nbytes, self.lanes, self.stripe_floor)

        # per-socket FIFO of outgoing sub-frames; each frame keeps its
        # original (header, payload) so a lane reset can replay it whole,
        # plus the live buffer list carrying sub-frames strictly in order
        ctx = _ExchangeCtx()
        send_q, recv_q = ctx.send_q, ctx.recv_q
        for peer, tag, view in sends:
            for ln, start, stop in _parts(len(view)):
                header = _HDR.pack(stop - start, tag)
                key = (peer, self._lane_route(peer, ln))
                send_q.setdefault(key, []).append(
                    _mk_frame(header, view[start:stop] if stop > start else None)
                )
        for entry in recvs:
            peer, tag, view = entry[0], entry[1], entry[2]
            on_part = entry[3] if len(entry) > 3 else None
            for ln, start, stop in _parts(len(view)):
                key = (peer, self._lane_route(peer, ln))
                recv_q.setdefault(key, []).append(
                    {
                        "view": view[start:stop],
                        "tag": tag,
                        "start": start,
                        "stop": stop,
                        "on_part": on_part,
                    }
                )

        frame_gates = ctx.frame_gates
        if emu is not None:
            for key in send_q:
                # half-RTT before the first frame's first byte leaves; the
                # gate re-arms as each subsequent frame reaches the head
                frame_gates[key] = emu.frame_gate()

        partition_noted: set = set()

        def _blocked(key: Tuple[int, int]) -> bool:
            prog = self.faults
            if prog is None or not prog.partitions(self.rank, key[0]):
                return False
            if key[0] not in partition_noted:
                partition_noted.add(key[0])
                self.faults_injected += 1
                logger.warning(
                    "fault injection: partition mask blackholes rank %d <-> %d",
                    self.rank,
                    key[0],
                )
            return True

        while send_q or recv_q or ctx.pending_failover or ctx.dying:
            self._check_abort()
            if time.monotonic() > deadline:
                raise TimeoutError("collective exchange timed out")
            failover_peers = {k[0] for k in ctx.pending_failover}
            rlist = [
                self.lane_socks[k]
                for k in self.lane_socks
                if not _blocked(k)
                and (
                    k in recv_q
                    or k in ctx.dying
                    or k[0] in failover_peers
                    or (k in ctx.recv_st and ctx.recv_st[k]["hdr"])
                )
            ]
            wlist = [
                self.lane_socks[k]
                for k in send_q
                if k in self.lane_socks
                and not _blocked(k)
                and k not in ctx.dying
            ]
            if not rlist and not wlist:
                # everything outstanding is blackholed (partition mask) or
                # parked on a failover handshake: wait out the deadline
                time.sleep(0.01)
                continue
            readable, writable, _ = select.select(rlist, wlist, [], 0.1)

            paced_block = False
            faulted: List[Tuple[Tuple[int, int], BaseException]] = []
            for sock in writable:
                key = self._sock_key.get(sock)
                if key is None:
                    continue
                frames = send_q.get(key)
                if frames is None:
                    continue
                ln = key[1]
                if time.monotonic() < frame_gates.get(key, 0.0):
                    paced_block = True
                    self.lane_stalls[ln] += 1
                    continue
                try:
                    while frames:
                        frame = frames[0]
                        bufs = frame["bufs"]
                        # len 0 = a zero-payload frame's body (e.g. the
                        # empty ring chunk at ws=2): nothing to pace
                        while bufs and len(bufs[0]) == 0:
                            bufs.pop(0)
                        if not bufs:
                            frames.pop(0)
                            if not frame["ctrl"]:
                                ctx.sent_log.setdefault(key, []).append(frame)
                                self._tx_seq[key] = (
                                    self._tx_seq.get(key, 0) + 1
                                )
                            if frames and emu is not None:
                                frame_gates[key] = emu.frame_gate()
                                break
                            continue
                        verdict = self._fault_gate(key, frame, frame_gates)
                        if verdict == "reset":
                            # half-close choreography: FIN our send side,
                            # park the unsent frames, and keep DRAINING
                            # until the peer's EOF comes back — an abortive
                            # close would destroy flushed-but-unread bytes
                            # and push the loss beyond the replay log
                            try:
                                sock.shutdown(socket.SHUT_WR)
                            except OSError:
                                pass
                            ctx.dying.add(key)
                            ctx.dying_sends[key] = send_q.pop(key, [])
                            logger.warning(
                                "fault injection: reset lane %s", key
                            )
                            break
                        if verdict == "stall":
                            paced_block = True
                            self.lane_stalls[ln] += 1
                            break
                        chunk = bufs[0]
                        if emu is not None:
                            allowed = emu.allow(len(chunk), stream=key)
                            if allowed <= 0:
                                paced_block = True
                                self.lane_stalls[ln] += 1
                                break
                            chunk = chunk[:allowed]
                        sent = sock.send(chunk)
                        if emu is not None:
                            emu.consume(sent, stream=key)
                        self.lane_tx_bytes[ln] += sent
                        if sent == len(bufs[0]):
                            bufs.pop(0)
                        else:
                            bufs[0] = bufs[0][sent:]
                            break
                except BlockingIOError:
                    self.lane_stalls[ln] += 1
                except PeerGoneError as e:
                    faulted.append((key, e))
                    continue
                except OSError as e:
                    faulted.append(
                        (key, PeerGoneError(f"send to rank {key[0]} failed: {e}"))
                    )
                    continue
                if frames is not None and not frames:
                    send_q.pop(key, None)

            for sock in readable:
                key = self._sock_key.get(sock)
                if key is None:
                    continue
                if any(k == key for k, _ in faulted):
                    continue
                peer, ln = key
                # drain the socket fully per readiness event (sub-frames
                # arrive back to back): one recv per select round would
                # multiply the syscall count and cap the aggregate rate
                try:
                    while True:
                        # stop at the exchange's expectation boundary: with
                        # nothing expected and no frame mid-flight, reading
                        # on would eat the NEXT exchange's bytes (only a
                        # pending failover justifies listening for a
                        # peer's control frame beyond that)
                        if (
                            key not in ctx.recv_st
                            and not recv_q.get(key)
                            and key not in ctx.dying
                            and key[0]
                            not in {k[0] for k in ctx.pending_failover}
                        ):
                            break
                        st = ctx.recv_st.setdefault(
                            key, {"hdr": bytearray(), "off": 0, "exp": None}
                        )
                        if len(st["hdr"]) < _HDR.size:
                            chunk = sock.recv(_HDR.size - len(st["hdr"]))
                            if not chunk:
                                raise PeerGoneError(
                                    f"connection to rank {peer} closed"
                                )
                            st["hdr"] += chunk
                            if len(st["hdr"]) == _HDR.size:
                                nbytes, tag = _HDR.unpack(bytes(st["hdr"]))
                                if tag == _LANE_CTRL_TAG:
                                    if nbytes != _LANE_CTRL.size:
                                        raise CommunicatorError(
                                            f"bad lane ctrl frame from rank "
                                            f"{peer}: {nbytes} bytes"
                                        )
                                    st["exp"] = {
                                        "view": memoryview(
                                            bytearray(_LANE_CTRL.size)
                                        ),
                                        "ctrl": True,
                                    }
                                else:
                                    queue_ = recv_q.get(key)
                                    if not queue_:
                                        raise CommunicatorError(
                                            f"unexpected frame tag {tag} "
                                            f"from rank {peer} (lane {ln})"
                                        )
                                    exp = queue_[0]
                                    if tag != exp["tag"]:
                                        raise CommunicatorError(
                                            f"tag mismatch from rank {peer}: "
                                            f"got {tag}, want {exp['tag']}"
                                        )
                                    if nbytes != len(exp["view"]):
                                        raise CommunicatorError(
                                            f"size mismatch from rank {peer}: "
                                            f"got {nbytes}, want "
                                            f"{len(exp['view'])} (lane {ln})"
                                        )
                                    st["exp"] = exp
                        elif st["off"] < len(st["exp"]["view"]):
                            n = sock.recv_into(st["exp"]["view"][st["off"] :])
                            if n == 0:
                                raise PeerGoneError(
                                    f"connection to rank {peer} closed"
                                )
                            st["off"] += n
                            if not st["exp"].get("ctrl"):
                                self.lane_rx_bytes[ln] += n
                        # complete once the header arrived and the payload
                        # (possibly zero-length) is fully received
                        if (
                            len(st["hdr"]) == _HDR.size
                            and st["off"] == len(st["exp"]["view"])
                        ):
                            exp = st["exp"]
                            ctx.recv_st.pop(key, None)
                            if exp.get("ctrl"):
                                _kind, dead_ln, peer_rx = _LANE_CTRL.unpack(
                                    bytes(exp["view"])
                                )
                                self._handle_lane_ctrl(
                                    peer, int(dead_ln), int(peer_rx), ctx
                                )
                            else:
                                queue_ = recv_q[key]
                                queue_.pop(0)
                                if not queue_:
                                    del recv_q[key]
                                self._rx_seq[key] = (
                                    self._rx_seq.get(key, 0) + 1
                                )
                                if exp["on_part"] is not None:
                                    exp["on_part"](exp["start"], exp["stop"])
                except BlockingIOError:
                    pass
                except (OSError, PeerGoneError) as e:
                    faulted.append(
                        (
                            key,
                            e
                            if isinstance(e, PeerGoneError)
                            else PeerGoneError(str(e)),
                        )
                    )

            for key, exc in faulted:
                if not recovery_ok:
                    raise exc
                self._lane_fault(key, exc, ctx, deadline)

            if paced_block:
                # socket writable but the pacer denied bytes — select would
                # return immediately and spin the op thread hot
                time.sleep(0.0005)

    # -- gray-failure recovery internals -------------------------------------

    def _fault_gate(
        self, key: Tuple[int, int], frame: dict, frame_gates: Dict
    ) -> Optional[str]:
        """Evaluate the armed fault program once per sub-frame, at the
        moment the frame reaches the head of its lane queue (before its
        first byte leaves).  Returns 'reset' (connection torn down),
        'stall' (a loss-retransmit or slow-NIC window was injected as a
        frame gate), or None (clean)."""
        prog = self.faults
        if prog is None or frame["checked"]:
            return None
        frame["checked"] = True
        if not prog.active():
            return None
        if prog.reset_once >= 0 and not self._reset_once_fired:
            self._fault_frames += 1
            if self._fault_frames > prog.reset_once:
                self._reset_once_fired = True
                self.faults_injected += 1
                return "reset"
        if prog.reset > 0 and self._fault_rng.random() < prog.reset:
            self.faults_injected += 1
            return "reset"
        if prog.loss > 0 and self._fault_rng.random() < prog.loss:
            # a dropped sub-frame costs one retransmit timeout: the sender
            # stalls ~2xRTT before the bytes go out — the TCP-on-lossy-link
            # throughput penalty without breaking the reliable stream
            rtt = self._emu.rtt_s if self._emu is not None else 0.0
            self.faults_injected += 1
            frame_gates[key] = time.monotonic() + max(2.0 * rtt, 0.02)
            return "stall"
        if prog.stall_p > 0 and self._fault_rng.random() < prog.stall_p:
            self.faults_injected += 1
            frame_gates[key] = time.monotonic() + prog.stall_ms / 1000.0
            return "stall"
        return None

    def _lane_fault(
        self,
        key: Tuple[int, int],
        exc: BaseException,
        ctx: _ExchangeCtx,
        deadline: float,
    ) -> None:
        """One lane to a live peer died mid-exchange: re-dial it with
        bounded jittered backoff and replay what the reset swallowed; if
        that fails, fail the lane over to a survivor.  Raises (poisoning
        the epoch) only when no lane to the peer survives or the reset ate
        sub-frames older than the current collective."""
        if key in ctx.dying:
            # we half-closed this lane ourselves (injected reset) and have
            # now drained it to EOF: un-park the sends so recovery replays
            # them like any other outstanding frames
            ctx.dying.discard(key)
            parked = ctx.dying_sends.pop(key, [])
            if parked:
                ctx.send_q[key] = parked + ctx.send_q.get(key, [])
        old = self.lane_socks.get(key)
        if old is not None:
            self._sock_key.pop(old, None)
            try:
                old.close()
            except OSError:
                pass
        # discard partial receive state: post-resync the peer re-sends the
        # interrupted sub-frame whole
        ctx.recv_st.pop(key, None)
        logger.warning(
            "lane %s: transient fault (%s); attempting in-epoch recovery",
            key,
            exc,
        )
        if self._try_reconnect(key, ctx, deadline):
            self.lane_reconnects += 1
            if self._flight:
                self._flight.record(
                    FlightEvent.LANE_RECONNECT, peer=key[0], lane=key[1]
                )
            logger.info("lane %s: reconnected in-epoch", key)
            return
        self._initiate_failover(key, ctx, exc)

    def _try_reconnect(
        self, key: Tuple[int, int], ctx: _ExchangeCtx, deadline: float
    ) -> bool:
        """Bounded re-dial of one lane.  The endpoint that dialed the lane
        at rendezvous (the higher rank) re-dials the peer's epoch listener;
        the other side waits for the accept thread to park the replacement.
        On success both run the resync handshake and replay."""
        peer, ln = key
        retries = self.lane_retries
        if retries <= 0:
            return False
        if self.rank > peer:
            addr = self._peer_addrs.get(peer)
            if addr is None:
                return False
            for attempt in range(retries):
                delay = (
                    self.lane_backoff_s
                    * (2 ** attempt)
                    * (0.5 + self._fault_rng.random())
                )
                if self._aborted.wait(delay):
                    raise CommunicatorAborted("communicator aborted")
                if time.monotonic() > deadline:
                    return False
                sock: Optional[socket.socket] = None
                try:
                    sock = socket.create_connection(
                        addr,
                        timeout=min(
                            5.0, max(0.1, deadline - time.monotonic())
                        ),
                    )
                    sock.setsockopt(
                        socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
                    )
                    sock.settimeout(5.0)
                    sock.sendall(
                        struct.pack(
                            "<QQQQ",
                            self.rank
                            | _LANE_HELLO_FLAG
                            | _LANE_RECONN_FLAG,
                            ln,
                            self.lanes,
                            self.stripe_floor,
                        )
                    )
                    sock.sendall(
                        _LANE_RESYNC.pack(
                            self._tx_seq.get(key, 0), self._rx_seq.get(key, 0)
                        )
                    )
                    raw = _recv_exact(
                        sock, _LANE_RESYNC.size, self._aborted, 5.0
                    )
                    _peer_tx, peer_rx = _LANE_RESYNC.unpack(raw)
                except (OSError, CommunicatorError):
                    if sock is not None:
                        try:
                            sock.close()
                        except OSError:
                            pass
                    continue
                self._install_lane(key, sock, int(peer_rx), ctx)
                return True
            return False
        # the peer re-dials us; its worst-case retry schedule bounds our
        # wait (plus slack so a slow final attempt still lands)
        window = self.lane_backoff_s * 1.5 * (2 ** retries) + 0.25
        wait_deadline = min(deadline, time.monotonic() + window)
        with self._reconn_cv:
            while key not in self._pending_reconn:
                if self._aborted.is_set():
                    raise CommunicatorAborted("communicator aborted")
                remaining = wait_deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._reconn_cv.wait(min(remaining, 0.1))
            sock = self._pending_reconn.pop(key)
        try:
            sock.settimeout(5.0)
            raw = _recv_exact(sock, _LANE_RESYNC.size, self._aborted, 5.0)
            _peer_tx, peer_rx = _LANE_RESYNC.unpack(raw)
            sock.sendall(
                _LANE_RESYNC.pack(
                    self._tx_seq.get(key, 0), self._rx_seq.get(key, 0)
                )
            )
        except (OSError, CommunicatorError):
            try:
                sock.close()
            except OSError:
                pass
            return False
        self._install_lane(key, sock, int(peer_rx), ctx)
        return True

    def _install_lane(
        self,
        key: Tuple[int, int],
        sock: socket.socket,
        peer_rx: int,
        ctx: _ExchangeCtx,
    ) -> None:
        """Swap a re-dialed socket into the lane maps and replay the
        sub-frames the reset swallowed (peer_rx = how many completed data
        sub-frames the peer HAS; everything we counted beyond that is
        re-sent whole, byte-identical, from the exchange's sent log)."""
        peer, ln = key
        missing = self._tx_seq.get(key, 0) - peer_rx
        log = ctx.sent_log.get(key, [])
        if missing < 0 or missing > len(log):
            try:
                sock.close()
            except OSError:
                pass
            raise CommunicatorError(
                f"lane {key} reset lost {missing} sub-frames beyond the "
                "current collective; cannot replay in-epoch"
            )
        q = ctx.send_q.setdefault(key, [])
        if missing:
            replay = log[-missing:]
            del log[-missing:]
            q[:0] = replay
            self._tx_seq[key] = peer_rx
        # re-arm every queued frame whole: the head may have been
        # part-written when the lane died, and the peer discarded its
        # partial receive state at resync
        for frame in q:
            _rearm_frame(frame)
        if not q:
            ctx.send_q.pop(key, None)
        sock.setblocking(False)
        self.lane_socks[key] = sock
        self._sock_key[sock] = key
        if ln == 0:
            self.peers[peer] = sock
        ctx.frame_gates.pop(key, None)

    def _initiate_failover(
        self, key: Tuple[int, int], ctx: _ExchangeCtx, exc: BaseException
    ) -> None:
        """Re-dial failed: park the dead lane's outstanding traffic and
        tell the peer (a control frame on the lowest surviving lane, with
        our completed-rx count) so both sides can agree on what to replay
        where.  Raises PeerGoneError when no lane survives — the epoch
        poisons only then."""
        peer, ln = key
        if key in ctx.dying:
            ctx.dying.discard(key)
            parked = ctx.dying_sends.pop(key, [])
            if parked:
                ctx.send_q[key] = parked + ctx.send_q.get(key, [])
        self.lane_socks.pop(key, None)
        alive = [
            l
            for l in self._alive_lanes(peer)
            if l != ln
            and (peer, l) in self.lane_socks
            and (peer, l) not in ctx.pending_failover
        ]
        if not alive:
            raise PeerGoneError(
                f"rank {peer} unreachable on every lane: {exc}"
            )
        surv = alive[0]
        ent = ctx.pending_failover.get(key)
        if ent is None:
            ent = ctx.pending_failover[key] = {
                "surv": surv,
                "peer_rx": None,
                "sent_ctrl": False,
                "sends": [],
                "recvs": [],
            }
        ent["sends"].extend(ctx.send_q.pop(key, []))
        ent["recvs"].extend(ctx.recv_q.pop(key, []))
        ctx.recv_st.pop(key, None)
        if not ent["sent_ctrl"]:
            blob = _LANE_CTRL.pack(1, ln, self._rx_seq.get(key, 0))
            raw = _HDR.pack(len(blob), _LANE_CTRL_TAG) + blob
            ctx.send_q.setdefault((peer, surv), []).append(
                _mk_frame(raw, None, ctrl=True)
            )
            ent["sent_ctrl"] = True
            logger.warning(
                "lane %s dead after retries (%s); failing over to lane %d",
                key,
                exc,
                surv,
            )
        if ent["peer_rx"] is not None:
            self._finalize_failover(key, ctx)

    def _handle_lane_ctrl(
        self, peer: int, dead_ln: int, peer_rx: int, ctx: _ExchangeCtx
    ) -> None:
        """The peer declared one of our shared lanes dead.  Adopt (close
        our end, park, answer with our own declaration) if we had not
        noticed, then finalize once both declarations are in hand."""
        key = (peer, dead_ln)
        if dead_ln in self.dead_lanes.get(peer, ()):
            return  # duplicate declaration for an already-buried lane
        ent = ctx.pending_failover.get(key)
        if ent is None:
            sock = self.lane_socks.get(key)
            if sock is not None:
                self._sock_key.pop(sock, None)
                try:
                    sock.close()
                except OSError:
                    pass
            try:
                self._initiate_failover(
                    key, ctx, CommunicatorError("peer declared lane dead")
                )
            except PeerGoneError as e:
                # no survivor left: total peer loss, poison the epoch (the
                # caller's recv loop must not mistake this for a
                # recoverable fault on the lane that carried the ctrl)
                raise CommunicatorError(str(e)) from e
            ent = ctx.pending_failover[key]
        ent["peer_rx"] = peer_rx
        if ent["sent_ctrl"]:
            self._finalize_failover(key, ctx)

    def _finalize_failover(self, key: Tuple[int, int], ctx: _ExchangeCtx) -> None:
        """Both endpoints agreed the lane is dead: replay the sub-frames
        the peer is missing and re-route all parked traffic onto the
        surviving lane.  The LOGICAL ``_lane_parts`` split is untouched —
        only transport assignment changes — so results stay bit-identical."""
        peer, ln = key
        ent = ctx.pending_failover.pop(key)
        surv_key = (peer, ent["surv"])
        if surv_key not in self.lane_socks:
            # the survivor chosen at initiate died while the handshake was
            # in flight (a second transient fault in one exchange): poison
            # NOW rather than stranding the re-routed frames on a dead
            # queue until the op deadline.  Concurrent multi-lane faults
            # stay fail-stop — exactly the legacy contract.
            raise CommunicatorError(
                f"lane {key} failover target lane {ent['surv']} died "
                "mid-handshake; poisoning the epoch"
            )
        missing = self._tx_seq.get(key, 0) - ent["peer_rx"]
        log = ctx.sent_log.get(key, [])
        if missing < 0 or missing > len(log):
            raise CommunicatorError(
                f"lane {key} failover lost {missing} sub-frames beyond the "
                "current collective; cannot replay"
            )
        replay: List[dict] = []
        if missing:
            replay = log[-missing:]
            del log[-missing:]
            self._tx_seq[key] = ent["peer_rx"]
        moved = replay + ent["sends"]
        for frame in moved:
            _rearm_frame(frame)
        if moved:
            ctx.send_q.setdefault(surv_key, []).extend(moved)
        if ent["recvs"]:
            ctx.recv_q.setdefault(surv_key, []).extend(ent["recvs"])
        self.dead_lanes.setdefault(peer, set()).add(ln)
        self.lane_failovers += 1
        if self._flight:
            self._flight.record(
                FlightEvent.LANE_FAILOVER, peer=peer, lane=ln, surv=ent["surv"]
            )
        ctx.frame_gates.pop(key, None)
        logger.warning(
            "lane %s failed over: %d outstanding sub-frames re-routed to "
            "lane %d",
            key,
            len(moved) + len(ent["recvs"]),
            ent["surv"],
        )

    def striped_drain(
        self,
        chunk_views: List[memoryview],
        expected: Dict[int, List[int]],
        orphans: List[int],
        chunk_tag: Callable[[int], int],
        ctrl_tag: int,
        make_need: Callable[[List[int]], bytes],
        done_blob: bytes,
        deadline: float,
    ) -> Dict[str, object]:
        """Concurrently drain disjoint chunk frames from MANY peers into one
        assembly buffer — the striped-heal receive path.

        Per-chunk recv ops would serialize on the op thread and cap a
        multi-source heal at one link's bandwidth; this runs as ONE op,
        select-driven across every source socket at once (the same duplex
        pattern as :meth:`exchange`), so P paced senders aggregate to ~P
        links.

        ``chunk_views`` maps each chunk index to the writable buffer slice
        its bytes land in (usually a range of a preallocated final array —
        the heal has no reassembly pass).  ``expected`` maps each live
        source rank to the ORDERED chunk indices it will push
        spontaneously; ``orphans`` are chunks whose owner was already dead
        at start.  A source that errors mid-drain
        has its outstanding chunks (including the partially-received one —
        chunk content is byte-identical across peers, so a re-fetch simply
        overwrites) re-requested from the least-loaded survivor via a
        ``make_need`` control frame on the dst→src direction.  Survivors
        get ``done_blob`` when everything landed.  Raises only when ALL
        sources are dead with chunks outstanding (or on deadline); returns
        ``{"per_source": {rank: bytes}, "dead": {rank: exc}, "stolen": n}``.
        """
        needed = set(orphans)
        for lst in expected.values():
            needed.update(lst)
        queues: Dict[int, List[int]] = {p: list(lst) for p, lst in expected.items()}
        # heal frames ride the designated p2p lane (the last lane): with
        # lanes > 1 a heal no longer contends with lane 0, where the
        # collective epoch's control frames concentrate; with lanes == 1
        # this is exactly the legacy single-socket behavior
        socks: Dict[int, socket.socket] = {p: self.p2p_sock(p) for p in queues}
        sock_peer: Dict[socket.socket, int] = {s: p for p, s in socks.items()}
        pending_ctrl: Dict[int, List[memoryview]] = {p: [] for p in queues}
        frame_gates: Dict[int, float] = {}
        recv_st: Dict[int, Optional[dict]] = {p: None for p in queues}
        received: set = set()
        per_source: Dict[int, int] = {p: 0 for p in queues}
        dead: Dict[int, BaseException] = {}
        stolen = [0]
        orphan_list = list(orphans)

        def _enqueue_ctrl(p: int, payload: bytes) -> None:
            frame = _HDR.pack(len(payload), ctrl_tag) + payload
            pending_ctrl[p].append(memoryview(frame))

        def _assign_orphans() -> None:
            if not orphan_list:
                return
            alive = [p for p in queues if p not in dead]
            if not alive:
                return
            target = min(alive, key=lambda p: len(queues[p]))
            batch = sorted(orphan_list)
            orphan_list.clear()
            stolen[0] += len(batch)
            _enqueue_ctrl(target, make_need(batch))
            queues[target].extend(batch)

        def _mark_dead(p: int, e: BaseException) -> None:
            dead[p] = e
            orphan_list.extend(i for i in queues[p] if i not in received)
            queues[p] = []
            recv_st[p] = None
            pending_ctrl[p] = []
            if not isinstance(e, PeerGoneError):
                # protocol error (tag/size mismatch): the pair's stream is
                # desynchronized but the socket is alive — close it so later
                # ops fail cleanly instead of misparsing garbage frames
                try:
                    socks[p].close()
                except OSError:
                    pass
            logger.warning(
                "striped drain: source rank %d died (%s); reassigning", p, e
            )
            _assign_orphans()

        def _flush_writes(wlist_socks: List[socket.socket]) -> bool:
            paced = False
            for sock in wlist_socks:
                p = sock_peer[sock]
                bufs = pending_ctrl.get(p)
                if not bufs or p in dead:
                    continue
                if self._emu is not None:
                    gate = frame_gates.setdefault(p, self._emu.frame_gate())
                    if time.monotonic() < gate:
                        paced = True
                        continue
                try:
                    while bufs:
                        chunk_b = bufs[0]
                        if self._emu is not None and len(chunk_b) > 0:
                            allowed = self._emu.allow(
                                len(chunk_b), stream=(p, self.p2p_lane)
                            )
                            if allowed <= 0:
                                paced = True
                                break
                            chunk_b = chunk_b[:allowed]
                        sent = sock.send(chunk_b)
                        if self._emu is not None:
                            self._emu.consume(sent, stream=(p, self.p2p_lane))
                        if sent == len(bufs[0]):
                            bufs.pop(0)
                            frame_gates.pop(p, None)
                        else:
                            bufs[0] = bufs[0][sent:]
                            break
                except BlockingIOError:
                    pass
                except OSError as e:
                    _mark_dead(p, PeerGoneError(f"send to rank {p} failed: {e}"))
            return paced

        _assign_orphans()

        while received != needed:
            self._check_abort()
            if time.monotonic() > deadline:
                raise TimeoutError("striped drain timed out")
            alive = [p for p in queues if p not in dead]
            if not alive:
                first = next(iter(dead.values()))
                raise CommunicatorError(
                    f"all heal sources died with "
                    f"{len(needed) - len(received)} chunks outstanding: {first}"
                )
            rlist = [socks[p] for p in alive if queues[p]]
            wlist = [socks[p] for p in alive if pending_ctrl[p]]
            if not rlist and not wlist:
                time.sleep(0.001)  # only orphan bookkeeping left; rare
                continue
            readable, writable, _ = select.select(rlist, wlist, [], 0.1)
            paced_block = _flush_writes(writable)
            for sock in readable:
                p = sock_peer[sock]
                # drain the socket fully per readiness event (frames arrive
                # back to back): one recv per select round would double the
                # syscall count and cap the aggregate drain rate
                while p not in dead and queues[p]:
                    st = recv_st[p]
                    if st is None:
                        st = recv_st[p] = {"hdr": bytearray(), "off": 0}
                    try:
                        if len(st["hdr"]) < _HDR.size:
                            chunk_b = sock.recv(_HDR.size - len(st["hdr"]))
                            if not chunk_b:
                                raise PeerGoneError(
                                    f"connection to rank {p} closed"
                                )
                            st["hdr"] += chunk_b
                            if len(st["hdr"]) == _HDR.size:
                                nbytes, tag = _HDR.unpack(bytes(st["hdr"]))
                                idx = queues[p][0]
                                view = chunk_views[idx]
                                if tag != chunk_tag(idx):
                                    raise CommunicatorError(
                                        f"tag mismatch from rank {p}: got "
                                        f"{tag}, want {chunk_tag(idx)} "
                                        f"(chunk {idx})"
                                    )
                                if nbytes != len(view):
                                    raise CommunicatorError(
                                        f"size mismatch from rank {p}: got "
                                        f"{nbytes}, want {len(view)} "
                                        f"(chunk {idx})"
                                    )
                                st["view"] = view
                        elif st["off"] < len(st["view"]):
                            n = sock.recv_into(st["view"][st["off"] :])
                            if n == 0:
                                raise PeerGoneError(
                                    f"connection to rank {p} closed"
                                )
                            st["off"] += n
                    except BlockingIOError:
                        break
                    except (OSError, CommunicatorError) as e:
                        _mark_dead(
                            p,
                            e
                            if isinstance(e, CommunicatorError)
                            else CommunicatorError(str(e)),
                        )
                        break
                    if len(st["hdr"]) == _HDR.size and st["off"] == len(
                        st.get("view", b"")
                    ):
                        idx = queues[p].pop(0)
                        received.add(idx)
                        per_source[p] += len(st["view"])
                        recv_st[p] = None
            if paced_block:
                time.sleep(0.0005)

        # release surviving senders from their steal-service loops
        # (best-effort, bounded: a wedged survivor must not park the heal)
        for p in [p for p in queues if p not in dead]:
            _enqueue_ctrl(p, done_blob)
        flush_deadline = min(deadline, time.monotonic() + 5.0)
        while any(
            pending_ctrl[p] for p in queues if p not in dead
        ) and time.monotonic() < flush_deadline:
            self._check_abort()
            wlist = [
                socks[p]
                for p in queues
                if p not in dead and pending_ctrl[p]
            ]
            if not wlist:
                break
            _, writable, _ = select.select([], wlist, [], 0.1)
            if _flush_writes(writable):
                time.sleep(0.0005)

        return {"per_source": per_source, "dead": dead, "stolen": stolen[0]}


def _recv_exact(
    sock: socket.socket, n: int, aborted: threading.Event, timeout_s: float
) -> bytes:
    # poll in short slices (capped by the remaining deadline) so an abort
    # latched by a peer propagates in ~250 ms instead of parking in the
    # kernel for the full op timeout before ``aborted`` is re-checked
    deadline = time.monotonic() + timeout_s
    out = b""
    while len(out) < n:
        if aborted.is_set():
            raise CommunicatorAborted("communicator aborted")
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(f"recv timed out after {timeout_s}s")
        sock.settimeout(min(0.25, remaining))
        try:
            chunk = sock.recv(n - len(out))
        except socket.timeout:
            continue
        if not chunk:
            raise CommunicatorError("connection closed during recv")
        out += chunk
    return out


# ---------------------------------------------------------------------------
# TCPCommunicator
# ---------------------------------------------------------------------------


class TCPCommunicator(Communicator):
    """Host-driven collectives over TCP with ring allreduce.

    The CPU-anywhere tier (the reference's Gloo analog,
    ``process_group.py:643-711``) and the semantic model for the DCN tier:
    bandwidth-optimal ring reduce-scatter + allgather on numpy buffers, all
    ops serialized on a per-epoch op thread, per-op userspace timeouts that
    ``abort()`` the communicator on expiry.

    Ring collectives stripe every frame across ``TORCHFT_RING_LANES``
    parallel connections per peer (``_TcpMesh``/``_lane_parts``) — the cure
    for cwnd-limited single TCP streams on long-RTT DCN links — with
    bit-identical results at any lane count and the same epoch/abort
    semantics (peer death on any lane latches the epoch error exactly
    once).
    """

    def __init__(
        self,
        timeout_s: float = 60.0,
        host_id: Optional[str] = None,
        hierarchical: Optional[str] = None,
    ) -> None:
        """``host_id`` / ``hierarchical`` override the ``TORCHFT_HOST_ID``
        and ``TORCHFT_HIERARCHICAL`` env knobs per instance — the hook
        thread-plane harnesses (where ranks share one process env) use to
        build emulated multi-host topologies."""
        self._timeout_s = timeout_s
        self._host_id = host_id
        self._hier = hierarchical
        # runtime-armed fault program (chaos hook); None = follow the
        # TORCHFT_NET_FAULTS env
        self._fault_override: Optional[_FaultProgram] = None
        self._mesh: Optional[_TcpMesh] = None
        self._rank = 0
        self._world_size = 1
        self._quorum_id = -1
        self._errored: Optional[Exception] = None
        self._ops: "queue.Queue[Optional[Tuple[Callable[[], object], Future, bool, Optional[float]]]]" = (
            queue.Queue()
        )
        self._op_thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._epoch = 0
        # count of ops currently executing on the op thread (plus queued
        # ones via self._ops.qsize) — the foreground-busy probe behind
        # busy(), which idle-priority traffic (spare warm serving) polls to
        # yield to live collectives.  Updated under its own lock: an old
        # epoch's op thread can overlap the new epoch's (teardown queues a
        # sentinel but never joins), and an unsynchronized += / -= pair
        # racing across threads can lose an update, sticking the counter
        # above zero (warm serving waits the full yield window forever) or
        # below (warm serving never yields).
        self._inflight_ops = 0
        self._inflight_lock = threading.Lock()
        # flight recorder attachment point: the owning Manager sets this to
        # its per-replica recorder; epoch lifecycle (configure / abort /
        # poison) and the mesh's lane-recovery machinery record into it
        self.flight: Optional[FlightRecorder] = None

    # -- lifecycle -----------------------------------------------------------

    def configure(
        self,
        store_addr: str,
        replica_id: str,
        rank: int,
        world_size: int,
        quorum_id: int = 0,
        group_rank: int = 0,
        group_world_size: int = 1,
        global_ranks: Sequence[int] = (),
    ) -> None:
        # Rendezvous can block up to timeout_s waiting for peers; it must
        # happen OUTSIDE self._lock so timers/aborts stay responsive.
        with self._lock:
            self._teardown_locked(reason="superseded by reconfigure")
            self._epoch += 1
            epoch = self._epoch
            self._rank = rank
            self._world_size = world_size
            self._quorum_id = quorum_id
            self._errored = None
            self._mesh = None

        mesh: Optional[_TcpMesh] = None
        if world_size > 1:
            with obs_span("comm::rendezvous", epoch=epoch):
                mesh = _TcpMesh(
                    store_addr,
                    rank,
                    world_size,
                    self._timeout_s,
                    host_id=self._host_id,
                    hier=self._hier,
                    faults=self._fault_override,
                    flight=self.flight,
                )

        with self._lock:
            if self._epoch != epoch:
                # superseded while we were rendezvousing
                if mesh is not None:
                    mesh.abort()
                raise CommunicatorAborted(
                    "configure superseded by a newer configure/abort"
                )
            self._mesh = mesh
            self._ops = queue.Queue()
            self._op_thread = threading.Thread(
                target=self._run_ops,
                args=(self._ops, epoch),
                name=f"tpuft_comm_ops_{epoch}",
                daemon=True,
            )
            self._op_thread.start()
        if self.flight:
            self.flight.set_comm_epoch(epoch)
            self.flight.record(
                FlightEvent.COMM_CONFIGURE,
                comm_epoch=epoch,
                quorum_id=quorum_id,
                rank=rank,
                world=world_size,
                lanes=mesh.lanes if mesh is not None else 0,
            )
        logger.info(
            "communicator configured: replica_id=%s rank=%d/%d quorum_id=%d",
            replica_id,
            rank,
            world_size,
            quorum_id,
        )

    def _teardown_locked(self, reason: str) -> None:
        if self._mesh is not None:
            self._mesh.abort()  # unblocks any op mid-IO with CommunicatorAborted
            self._mesh = None
        # fail everything still queued (items the old op thread also races for
        # just fail against the closed mesh instead — either way they error)
        try:
            while True:
                item = self._ops.get_nowait()
                if item is not None:
                    item[1].set_exception(CommunicatorAborted(reason))
        except queue.Empty:
            pass
        if self._op_thread is not None:
            self._ops.put(None)  # exit sentinel, consumed after any in-flight op
            self._op_thread = None

    def abort(self, reason: str = "aborted") -> None:
        """Unblock in-flight collectives and poison until reconfigure."""
        with self._lock:
            newly_poisoned = self._errored is None
            lane_summary = self._lane_summary_locked()
            self._abort_locked(reason)
        if self.flight:
            self.flight.record(FlightEvent.COMM_ABORT, reason=reason)
        self._flight_poison(reason, newly_poisoned, lane_summary)
        logger.warning("communicator aborted: %s", reason)

    def _lane_summary_locked(self) -> Dict[str, int]:
        """Counter summary of the (dying) epoch's mesh, captured under the
        lock BEFORE teardown clears it — the stall/fault evidence a
        postmortem chains from injection to poison."""
        mesh = self._mesh
        if mesh is None:
            return {}
        return {
            "stalls": sum(mesh.lane_stalls),
            "reconnects": mesh.lane_reconnects,
            "failovers": mesh.lane_failovers,
            "faults_injected": mesh.faults_injected,
        }

    def _flight_poison(
        self,
        reason: str,
        newly_poisoned: bool,
        lane_summary: Dict[str, int],
    ) -> None:
        """Record the epoch poison (when an error actually latched) plus a
        rate-limited flight dump.  Runs OUTSIDE every communicator lock:
        dumps do file IO."""
        flight = self.flight
        if flight is None:
            return
        if newly_poisoned and reason != "shutdown":
            flight.record(
                FlightEvent.COMM_POISON, reason=reason, **lane_summary
            )
            flight.maybe_dump("comm_poison")

    def _abort_locked(self, reason: str) -> None:
        if self._errored is None:
            self._errored = CommunicatorAborted(reason)
        self._teardown_locked(reason=reason)
        self._epoch += 1  # invalidates in-flight configure/timers

    def errored(self) -> Optional[Exception]:
        return self._errored

    def shutdown(self) -> None:
        self.abort("shutdown")

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._world_size

    def set_timeout(self, timeout_s: float) -> None:
        self._timeout_s = timeout_s

    def busy(self) -> bool:
        """True while a collective/p2p op is executing or queued in the
        current epoch.  Idle-priority consumers (the manager server's
        spare warm-range handler) poll this to yield the NIC to foreground
        collectives; a racy read only costs one brief extra yield."""
        if self._inflight_ops > 0:
            return True
        ops = self._ops
        return ops is not None and not ops.empty()

    def _op_started(self) -> None:
        """Enter the in-flight window of :meth:`busy`.  The counter rides
        its own lock because old and new epoch op threads overlap (teardown
        queues a sentinel but never joins), and an unsynchronized ``+=`` /
        ``-=`` pair can lose an update either way — sticking ``busy()``
        above zero forever or letting warm serving never yield (pinned by
        a contention regression test)."""
        with self._inflight_lock:
            self._inflight_ops += 1

    def _op_finished(self) -> None:
        with self._inflight_lock:
            self._inflight_ops -= 1

    def arm_faults(self, spec: Union[str, _FaultProgram, None]) -> None:
        """Arm (or with ``None`` disarm) a per-link fault program at
        runtime — the chaos hook that flips a healthy link flaky
        mid-collective.  Applies to the CURRENT epoch's mesh immediately
        and to every future epoch of this communicator; ``None`` falls back
        to the ``TORCHFT_NET_FAULTS`` env program."""
        prog = parse_fault_spec(spec) if isinstance(spec, str) else spec
        self._fault_override = prog
        mesh = self._mesh
        if mesh is not None:
            mesh.faults = prog if prog is not None else _net_faults_from_env()
        if self.flight:
            self.flight.record(
                FlightEvent.CHAOS_INJECT,
                via="arm_faults",
                armed=prog is not None,
                spec=spec if isinstance(spec, str) else None,
            )
        logger.info(
            "fault program %s", "armed" if prog is not None else "disarmed"
        )

    def lane_stats(self) -> Dict[str, object]:
        """Per-lane observability of the current epoch's mesh: lane count,
        payload bytes sent/received per lane, stall events (pacer denials /
        kernel would-block) per lane, and the gray-failure counters
        (in-epoch lane reconnects/failovers, injected faults).  Empty when
        unconfigured or single-member."""
        mesh = self._mesh
        if mesh is None:
            return {}
        stats: Dict[str, object] = {
            "lanes": mesh.lanes,
            "stripe_floor_bytes": mesh.stripe_floor,
            "lane_tx_bytes": list(mesh.lane_tx_bytes),
            "lane_rx_bytes": list(mesh.lane_rx_bytes),
            "lane_stalls": list(mesh.lane_stalls),
            "lane_reconnects": mesh.lane_reconnects,
            "lane_failovers": mesh.lane_failovers,
            "faults_injected": mesh.faults_injected,
            "dead_lanes": sum(len(v) for v in mesh.dead_lanes.values()),
        }
        if mesh.topo is not None:
            stats.update(
                topo_hosts=mesh.topo.num_hosts,
                topo_local_world=mesh.topo.local_world,
                topo_is_leader=mesh.topo.is_leader,
                shm_tx_bytes=mesh.shm_tx_bytes,
                shm_rx_bytes=mesh.shm_rx_bytes,
            )
        return stats

    # -- hierarchical topology surface (collectives.py consumes this) --------

    def hier_topology(self) -> Optional[Dict[str, object]]:
        """Facts of the current epoch's ACTIVE hierarchical topology, or
        None when the epoch runs the flat ring.  Identical on every rank
        (derived from the shared host map), so callers may branch on it to
        pick collective schedules without desynchronizing."""
        mesh = self._mesh
        if mesh is None or mesh.topo is None:
            return None
        t = mesh.topo
        return {
            "hosts": t.num_hosts,
            "local_world": t.local_world,
            "is_leader": t.is_leader,
            "leader": t.leader,
            "leader_ring": list(t.leader_ring),
            "local_group": list(t.local),
        }

    def intra_reduce(self, flat: np.ndarray, op: ReduceOp = ReduceOp.SUM) -> Work:
        """Intra-host SUM (default) reduce of ``flat`` over shared memory:
        the host leader's Work resolves to the host-reduced array (the
        input, reduced in place on a private copy), members' to None.
        No-socket op — safe to interleave with cross-host collectives."""
        arr = np.array(flat, copy=True).reshape(-1)

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                mesh = ctx.mesh
                if mesh is None or mesh.topo is None:
                    return arr
                mesh.shm_reduce(arr, op, ctx.deadline())
                return arr if mesh.topo.is_leader else None

            return _run

        return self._submit(_make)

    def intra_broadcast(
        self,
        flat: Optional[np.ndarray],
        count: int,
        dtype: "np.dtype" = np.float32,
    ) -> Work:
        """Intra-host broadcast from the host leader (which passes the
        array; members pass None and receive a fresh one of ``count``
        elements of ``dtype``)."""

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                mesh = ctx.mesh
                if mesh is None or mesh.topo is None:
                    return flat
                arr = (
                    np.ascontiguousarray(flat).reshape(-1)
                    if flat is not None
                    else np.empty(count, dtype=dtype)
                )
                mesh.shm_bcast(arr, ctx.deadline())
                return arr

            return _run

        return self._submit(_make)

    def leader_comm(self) -> "Communicator":
        """A communicator view over the per-host leader subgroup of the
        CURRENT epoch: size() = host count, rank() = this host's position
        in the leader ring.  Valid only on leaders (members have no
        business on the DCN in a hierarchical schedule); collectives ride
        the same mesh, epoch and abort semantics as the parent."""
        topo = self.hier_topology()
        if topo is None:
            return self
        return _LeaderComm(self, list(topo["leader_ring"]))  # type: ignore[arg-type]

    # -- op submission -------------------------------------------------------

    def _abort_if_epoch(self, epoch: int, reason: str) -> None:
        # Check-and-abort atomically so a stale timer can never poison a
        # newer epoch; runs on a spawned thread so the shared timer thread
        # is never blocked on this lock.
        def _do() -> None:
            with self._lock:
                if self._epoch != epoch:
                    return
                newly_poisoned = self._errored is None
                lane_summary = self._lane_summary_locked()
                self._abort_locked(reason)
            if self.flight:
                self.flight.record(FlightEvent.COMM_ABORT, reason=reason)
            self._flight_poison(reason, newly_poisoned, lane_summary)
            logger.warning("communicator aborted: %s", reason)

        threading.Thread(target=_do, name="tpuft_comm_abort", daemon=True).start()

    def _run_ops(
        self,
        ops: "queue.Queue[Optional[Tuple[Callable[[], object], Future, bool, Optional[float]]]]",
        epoch: int,
    ) -> None:
        while True:
            item = ops.get()
            if item is None:
                return
            fn, fut, peer_fail_stop, op_timeout_s = item
            if not fut.set_running_or_notify_cancel():
                continue
            # Userspace per-op watchdog: a wedged collective aborts the
            # communicator (unblocking the socket IO) instead of hanging the
            # train loop or killing the process.  A long-running op (a
            # striped heal drain) may carry its own bound.
            timeout_s = op_timeout_s if op_timeout_s is not None else self._timeout_s
            handle: TimerHandle = schedule_timeout(
                timeout_s,
                lambda: self._abort_if_epoch(
                    epoch, f"op timed out after {timeout_s}s"
                ),
            )
            self._op_started()
            try:
                with obs_span("comm::op", epoch=epoch):
                    result = fn()
            except BaseException as e:  # noqa: BLE001
                # A fail-stop PEER death on a point-to-point byte op (dead
                # socket — the striped-heal failover case) stays scoped to
                # that op: the pair's socket is permanently closed, other
                # pairs' streams are untouched, so poisoning the epoch would
                # only turn a survivable source loss into a failed heal.
                # Everything else still latches: collective failures leave
                # OTHER pairs mid-frame, protocol errors (tag/size mismatch)
                # leave THIS pair's stream desynchronized on a live socket,
                # and op timeouts already abort via the watchdog above.
                peer_scoped = peer_fail_stop and isinstance(e, PeerGoneError)
                latched = False
                lane_summary: Dict[str, int] = {}
                if not peer_scoped:
                    with self._lock:
                        if self._epoch == epoch and self._errored is None:
                            self._errored = (
                                e
                                if isinstance(e, Exception)
                                else RuntimeError(str(e))
                            )
                            latched = True
                            lane_summary = self._lane_summary_locked()
                if latched:
                    self._flight_poison(str(e), True, lane_summary)
                fut.set_exception(e)
            else:
                fut.set_result(result)
            finally:
                self._op_finished()
                handle.cancel()

    def _submit(
        self,
        make_fn: Callable[["_CommCtx"], Callable[[], object]],
        peer_fail_stop: bool = False,
        op_timeout_s: Optional[float] = None,
    ) -> Work:
        # Ops capture an epoch-pinned snapshot of (mesh, rank, ws) so an op
        # drained late from a superseded queue can never touch the sockets of
        # a newer epoch.
        with self._lock:
            if self._errored is not None:
                fut: Future = Future()
                fut.set_exception(self._errored)
                return Work(fut)
            if self._op_thread is None:
                fut = Future()
                fut.set_exception(
                    CommunicatorError("communicator not configured")
                )
                return Work(fut)
            ctx = _CommCtx(
                mesh=self._mesh,
                rank=self._rank,
                world_size=self._world_size,
                timeout_s=(
                    op_timeout_s if op_timeout_s is not None else self._timeout_s
                ),
            )
            fut = Future()
            self._ops.put((make_fn(ctx), fut, peer_fail_stop, op_timeout_s))
            return Work(fut)

    # -- collectives ---------------------------------------------------------

    @staticmethod
    def _as_list(buffers: Buffers) -> List[np.ndarray]:
        if isinstance(buffers, np.ndarray):
            return [buffers]
        return [np.asarray(b) for b in buffers]

    def allreduce(
        self,
        buffers: Buffers,
        op: ReduceOp = ReduceOp.SUM,
        in_place: bool = False,
    ) -> Work:
        arrays = self._as_list(buffers)
        single = isinstance(buffers, np.ndarray)

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                out = _allreduce_sync(ctx, arrays, op, in_place=in_place)
                return out[0] if single else out

            return _run

        return self._submit(_make)

    def broadcast(self, buffers: Buffers, root: int = 0) -> Work:
        arrays = self._as_list(buffers)
        single = isinstance(buffers, np.ndarray)

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                out = _broadcast_sync(ctx, arrays, root)
                return out[0] if single else out

            return _run

        return self._submit(_make)

    def reduce_scatter(
        self, data: np.ndarray, op: ReduceOp = ReduceOp.SUM
    ) -> Work:
        arr = np.asarray(data)

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                ws = ctx.world_size
                flat = np.array(arr, copy=True).reshape(-1)
                topo = ctx.mesh.topo if ctx.mesh is not None else None
                if topo is not None and len(topo.leader_ring) < ws:
                    # hierarchical: full two-level allreduce (host-shm +
                    # leader ring), then slice this rank's chunk.  Cross-
                    # host bytes are 2(H-1)/H·n per host vs the flat ring's
                    # L(ws-1)/ws·n — a win from L >= 2 replicas/host, a
                    # wash at exactly 2; a leader-ring reduce-scatter with
                    # an shm scatter would halve it again but needs
                    # host-contiguous rank chunks, deferred until profiles
                    # demand it.
                    _hier_allreduce(
                        ctx, flat, op, tag_base=wire_tags.RING_REDUCE_TAG_BASE
                    )
                    bounds = _ring_bounds(flat.size, ws)
                    own = flat[bounds[ctx.rank] : bounds[ctx.rank + 1]]
                else:
                    # flat, and also the forced one-replica-per-host
                    # topology (leader ring == all ranks): the plain ring
                    # reduce-scatter moves HALF the allreduce's bytes
                    own = _ring_reduce_scatter(
                        ctx, flat, op, tag_base=wire_tags.RING_REDUCE_TAG_BASE
                    )
                if op == ReduceOp.AVG:
                    _avg_in_place(own, ws)
                # compact: own is a view of the full-size working copy;
                # returning it would pin all n elements for the Work's life
                return own.copy()

            return _run

        return self._submit(_make)

    def send_bytes(self, data, dst: int, tag: int = 0) -> Work:
        """Send any contiguous buffer (bytes, memoryview, numpy array) with
        no intermediate copy."""
        if isinstance(data, np.ndarray):
            view = _bytes_view(np.ascontiguousarray(data))
        else:
            view = memoryview(data)
            if view.format != "B":
                view = view.cast("B")

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                mesh = ctx.require_peer(dst)
                # whole frame on the designated p2p lane: the receive paths
                # (recv_dynamic*/striped_drain) read that one socket
                mesh.exchange(
                    [(dst, tag, view)], [], ctx.deadline(), lane=mesh.p2p_lane
                )
                return view.nbytes

            return _run

        return self._submit(_make, peer_fail_stop=True)

    def send_frame_parts(self, parts, nbytes: int, dst: int, tag: int = 0) -> Work:
        """One frame written as its parts arrive, in one op on the p2p
        lane (:meth:`_TcpMesh.send_frame_stream`).  Under the link
        emulator or a fault program the parts are joined and sent as one
        frame, so pacing and injected faults apply as to any frame."""

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                mesh = ctx.require_peer(dst)
                if mesh._emu is None and mesh.faults is None:
                    mesh.send_frame_stream(dst, tag, nbytes, parts, ctx.deadline())
                else:
                    mesh.exchange([(dst, tag, memoryview(join_parts(parts, nbytes)))], [],
                                  ctx.deadline(), lane=mesh.p2p_lane)
                return nbytes

            return _run

        return self._submit(_make, peer_fail_stop=True)

    def recv_bytes(self, src: int, tag: int = 0) -> Work:
        """Receive one frame from ``src``; the size rides in the frame header
        so this pairs directly with :meth:`send_bytes` of any length."""

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                mesh = ctx.require_peer(src)
                return mesh.recv_dynamic(src, tag, ctx.deadline())

            return _run

        return self._submit(_make, peer_fail_stop=True)

    def recv_bytes_into(self, src: int, out: np.ndarray, tag: int = 0) -> Work:
        view = _bytes_view(out)

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                mesh = ctx.require_peer(src)
                # cap semantics (payload may be smaller than the buffer),
                # matching the native tier's recv_into contract
                return mesh.recv_dynamic_into(src, tag, view, ctx.deadline())

            return _run

        return self._submit(_make, peer_fail_stop=True)

    def heal_drain(
        self,
        chunk_views: List[memoryview],
        expected: Dict[int, List[int]],
        orphans: List[int],
        chunk_tag: Callable[[int], int],
        ctrl_tag: int,
        make_need: Callable[[List[int]], bytes],
        done_blob: bytes,
        timeout_s: Optional[float] = None,
    ) -> Work:
        """Striped-heal receive: concurrently drain disjoint chunk frames
        from every source peer straight into ``chunk_views`` as ONE op (see
        :meth:`_TcpMesh.striped_drain`) — per-chunk recv ops would
        serialize on the op thread and cap the heal at a single link's
        bandwidth.  ``timeout_s`` (default: the communicator op timeout)
        bounds the whole drain, watchdog included — a heal given a longer
        deadline than one collective must not be aborted mid-transfer."""

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                for p in expected:
                    ctx.require_peer(p)
                assert ctx.mesh is not None
                return ctx.mesh.striped_drain(
                    chunk_views,
                    expected,
                    orphans,
                    chunk_tag,
                    ctrl_tag,
                    make_need,
                    done_blob,
                    ctx.deadline(),
                )

            return _run

        return self._submit(_make, peer_fail_stop=True, op_timeout_s=timeout_s)

    def _all_exchange(
        self,
        send_for_peer: Callable[[int], np.ndarray],
        recv_template: Callable[[int], np.ndarray],
        own: np.ndarray,
        tag: int,
    ) -> Work:
        """Shared skeleton for alltoall/allgather: send ``send_for_peer(p)``
        to every peer, receive into ``empty_like(recv_template(p))``, pass
        our own buffer through at index ``rank``."""

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                return _all_exchange_sync(
                    ctx, send_for_peer, recv_template, own, tag
                )

            return _run

        return self._submit(_make)

    def alltoall(self, chunks: List[np.ndarray], tag: int = 0) -> Work:
        """Exchange ``chunks[j]`` with rank j (keeping our own); the Work's
        value is the list of received chunks indexed by source rank.  Chunk j
        must have the shape rank j expects back (symmetric splits)."""
        arrays = [np.ascontiguousarray(c) for c in chunks]
        assert len(arrays) == self._world_size, "need one chunk per rank"
        rank = self._rank
        return self._all_exchange(
            send_for_peer=lambda p: arrays[p],
            recv_template=lambda p: arrays[p],
            own=arrays[rank],
            tag=wire_tags.ALLTOALL_TAG_OFFSET + tag,
        )

    def allgather(self, data: np.ndarray, tag: int = 0) -> Work:
        """Gather every rank's buffer (same shape/dtype on all ranks); the
        Work's value is a list indexed by rank.  On a hierarchical topology
        the gather runs host-blocked: shm to the host leader, leader-block
        exchange across the DCN, shm broadcast back out."""
        array = np.ascontiguousarray(data)

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                if (
                    ctx.world_size > 1
                    and ctx.mesh is not None
                    and ctx.mesh.topo is not None
                ):
                    return _hier_allgather_sync(
                        ctx, array, wire_tags.ALLGATHER_TAG_OFFSET + tag
                    )
                return _all_exchange_sync(
                    ctx,
                    send_for_peer=lambda p: array,
                    recv_template=lambda p: array,
                    own=array,
                    tag=wire_tags.ALLGATHER_TAG_OFFSET + tag,
                )

            return _run

        return self._submit(_make)

    def barrier(self) -> Work:
        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                _allreduce_sync(ctx, [np.zeros(1, dtype=np.float32)], ReduceOp.SUM)
                return None

            return _run

        return self._submit(_make)


def _all_exchange_sync(
    ctx: "_CommCtx",
    send_for_peer: Callable[[int], np.ndarray],
    recv_template: Callable[[int], np.ndarray],
    own: np.ndarray,
    tag: int,
    ring: Optional[List[int]] = None,
) -> List[np.ndarray]:
    """All-to-all exchange body shared by alltoall, the non-hierarchical
    allgather path, and (via ``ring`` — participating global ranks in
    order, results indexed by ring position) the leader-subgroup views."""
    if ring is None:
        ring = list(range(ctx.world_size))
    ws = len(ring)
    if ws == 1:
        return [own]
    mesh = ctx.mesh
    assert mesh is not None
    pos = ring.index(ctx.rank)
    out = [np.empty_like(recv_template(p)) for p in range(ws)]
    out[pos] = own
    sends = [
        (ring[p], tag, _bytes_view(send_for_peer(p)))
        for p in range(ws)
        if p != pos
    ]
    recvs = [
        (ring[p], tag, _bytes_view(out[p])) for p in range(ws) if p != pos
    ]
    mesh.exchange(sends, recvs, ctx.deadline())
    return out


class _CommCtx:
    """Epoch-pinned op context: the mesh and layout captured at submit time."""

    __slots__ = ("mesh", "rank", "world_size", "timeout_s")

    def __init__(
        self,
        mesh: Optional[_TcpMesh],
        rank: int,
        world_size: int,
        timeout_s: float,
    ) -> None:
        self.mesh = mesh
        self.rank = rank
        self.world_size = world_size
        self.timeout_s = timeout_s

    def deadline(self) -> float:
        return time.monotonic() + self.timeout_s

    def require_peer(self, peer: int) -> _TcpMesh:
        if self.mesh is None or peer not in self.mesh.peers:
            raise CommunicatorError(f"no peer {peer} in communicator")
        return self.mesh


class _LeaderComm(Communicator):
    """Leader-subgroup view of a :class:`TCPCommunicator` for one epoch.

    The quantized DiLoCo pipeline runs its alltoall/allgather windows on
    this view so only HOST LEADERS touch the DCN — one quantized stream per
    host instead of one per replica.  Ops ride the parent's mesh, op
    thread, epoch and abort semantics; rank()/size() are the leader-ring
    position and host count.  Distinct tag bases (7000/8000) keep leader
    frames un-confusable with flat alltoall/allgather frames."""

    def __init__(self, parent: TCPCommunicator, ring: List[int]) -> None:
        self._parent = parent
        self._ring = ring

    def configure(self, *args, **kwargs) -> None:  # type: ignore[override]
        raise RuntimeError("_LeaderComm is a per-epoch view; configure the parent")

    def rank(self) -> int:
        return self._ring.index(self._parent.rank())

    def size(self) -> int:
        return len(self._ring)

    def alltoall(self, chunks: List[np.ndarray], tag: int = 0) -> Work:
        arrays = [np.ascontiguousarray(c) for c in chunks]
        assert len(arrays) == len(self._ring), "need one chunk per leader"
        ring = self._ring
        pos = self.rank()

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                return _all_exchange_sync(
                    ctx,
                    send_for_peer=lambda p: arrays[p],
                    recv_template=lambda p: arrays[p],
                    own=arrays[pos],
                    tag=wire_tags.LEADER_ALLTOALL_TAG_OFFSET + tag,
                    ring=ring,
                )

            return _run

        return self._parent._submit(_make)

    def allgather(self, data: np.ndarray, tag: int = 0) -> Work:
        array = np.ascontiguousarray(data)
        ring = self._ring

        def _make(ctx: "_CommCtx") -> Callable[[], object]:
            def _run() -> object:
                return _all_exchange_sync(
                    ctx,
                    send_for_peer=lambda p: array,
                    recv_template=lambda p: array,
                    own=array,
                    tag=wire_tags.LEADER_ALLGATHER_TAG_OFFSET + tag,
                    ring=ring,
                )

            return _run

        return self._parent._submit(_make)

    def allreduce(
        self,
        buffers: Buffers,
        op: ReduceOp = ReduceOp.SUM,
        in_place: bool = False,
    ) -> Work:
        raise NotImplementedError("leader view carries alltoall/allgather only")

    def broadcast(self, buffers: Buffers, root: int = 0) -> Work:
        raise NotImplementedError("leader view carries alltoall/allgather only")

    def send_bytes(self, data: bytes, dst: int, tag: int = 0) -> Work:
        raise NotImplementedError("leader view carries alltoall/allgather only")

    def recv_bytes(self, src: int, tag: int = 0) -> Work:
        raise NotImplementedError("leader view carries alltoall/allgather only")

    def barrier(self) -> Work:
        raise NotImplementedError("leader view carries alltoall/allgather only")

    def abort(self, reason: str = "aborted") -> None:
        self._parent.abort(reason)

    def errored(self) -> Optional[Exception]:
        return self._parent.errored()


def _allreduce_sync(
    ctx: _CommCtx,
    arrays: List[np.ndarray],
    op: ReduceOp,
    in_place: bool = False,
) -> List[np.ndarray]:
    ws = ctx.world_size
    out = [
        a
        if in_place
        and isinstance(a, np.ndarray)
        and a.flags.c_contiguous
        and a.flags.writeable
        else np.array(a, copy=True)
        for a in arrays
    ]
    if ws > 1:
        assert ctx.mesh is not None
        # topology-aware dispatch: hierarchical when the epoch discovered a
        # multi-host topology (mesh.topo is uniform across ranks), else the
        # byte-for-byte legacy flat ring
        reduce_flat = (
            _hier_allreduce if ctx.mesh.topo is not None else _ring_allreduce
        )
        # one flat ring per dtype — concatenating mixed dtypes would silently
        # promote (f32+i64 → f64) and return wrong-dtype buffers
        by_dtype: Dict[str, List[int]] = {}
        for i, a in enumerate(out):
            by_dtype.setdefault(a.dtype.name, []).append(i)
        for ring_idx, idxs in enumerate(by_dtype.values()):
            if len(idxs) == 1 and out[idxs[0]].flags.c_contiguous:
                flat = out[idxs[0]].reshape(-1)
                reduce_flat(
                    ctx, flat, op,
                    tag_base=ring_idx * wire_tags.RING_BUFFER_TAG_STRIDE,
                )
                out[idxs[0]] = flat.reshape(out[idxs[0]].shape)
                continue
            flat = np.concatenate([out[i].reshape(-1) for i in idxs])
            reduce_flat(
                    ctx, flat, op,
                    tag_base=ring_idx * wire_tags.RING_BUFFER_TAG_STRIDE,
                )
            offset = 0
            for i in idxs:
                n = out[i].size
                out[i] = flat[offset : offset + n].reshape(out[i].shape)
                offset += n
    if op == ReduceOp.AVG:
        for a in out:
            _avg_in_place(a, ws)
    return out


def _avg_in_place(a: np.ndarray, ws: int) -> None:
    """``a /= ws`` for the AVG reductions: integers floor-divide, bf16
    rounds back from f32, other dtypes true-divide in place."""
    if bf16.is_bf16(a):
        bf16.assign(a, bf16.div(a, ws))
    elif np.issubdtype(a.dtype, np.integer):
        a //= ws
    else:
        np.divide(a, ws, out=a)


def _ring_bounds(n: int, ws: int) -> List[int]:
    bounds = [0]
    base, extra = divmod(n, ws)
    for i in range(ws):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return bounds


def _ring_reduce_scatter(
    ctx: _CommCtx,
    flat: np.ndarray,
    op: ReduceOp,
    tag_base: int = 0,
    ring: Optional[List[int]] = None,
) -> np.ndarray:
    """In-place ring reduce-scatter phase: after ws-1 duplex steps, this
    rank's chunk (``_ring_bounds`` chunk ``rank``) holds the full reduction;
    returns a view of it.  The schedule is shifted by one vs the textbook
    ring so rank r ends up owning chunk r (the conventional contract).

    ``ring`` (global ranks in ring order; default = all ranks) restricts
    the ring to a subset — the hierarchical leader ring.  The flat default
    compiles to the identical schedule (position == rank), so the legacy
    wire behavior is byte-for-byte unchanged."""
    if ring is None:
        ring = list(range(ctx.world_size))
    ws = len(ring)
    if ws == 1:
        return flat
    mesh = ctx.mesh
    assert mesh is not None
    pos = ring.index(ctx.rank)
    right = ring[(pos + 1) % ws]
    left = ring[(pos - 1) % ws]
    deadline = ctx.deadline()
    bounds = _ring_bounds(flat.size, ws)

    def chunk(i: int) -> np.ndarray:
        i %= ws
        return flat[bounds[i] : bounds[i + 1]]

    scratch = np.empty(bounds[1], dtype=flat.dtype)
    itemsize = flat.dtype.itemsize
    for step in range(ws - 1):
        send_idx = (pos - step - 1) % ws
        recv_idx = (pos - step - 2) % ws
        send_chunk = chunk(send_idx)
        recv_chunk = chunk(recv_idx)
        recv_buf = scratch[: recv_chunk.size]

        # reduce each completed lane sub-range as it lands, while the other
        # lanes are still streaming — sub-frame boundaries are 64-byte
        # aligned so element ranges never split, and every element still
        # sees exactly one add per step: bit-identical at any lane count
        def _reduce_part(
            start: int, stop: int, _dst=recv_chunk, _src=recv_buf
        ) -> None:
            lo, hi = start // itemsize, stop // itemsize
            _reduce_into(op, _dst[lo:hi], _src[lo:hi])

        mesh.exchange(
            [(right, tag_base + 1000 + step, _bytes_view(send_chunk))],
            [(left, tag_base + 1000 + step, _bytes_view(recv_buf), _reduce_part)],
            deadline,
        )
    return chunk(pos)


def _ring_allreduce(
    ctx: _CommCtx,
    flat: np.ndarray,
    op: ReduceOp,
    tag_base: int = 0,
    ring: Optional[List[int]] = None,
) -> None:
    """In-place bandwidth-optimal ring allreduce.

    Reduce-scatter then allgather, ws-1 steps each; every step exchanges one
    chunk with both neighbors concurrently via duplex IO (deadlock-free even
    at world size 2, where both directions share one socket pair).  Each
    chunk's frame is lane-striped by ``exchange``; the per-element reduction
    order is fixed by the chunk schedule alone, so lane count never changes
    the bits.  ``ring`` restricts to a rank subset (the hierarchical leader
    ring); the default is the byte-for-byte legacy flat ring.
    """
    if ring is None:
        ring = list(range(ctx.world_size))
    ws = len(ring)
    if ws == 1:
        return
    mesh = ctx.mesh
    assert mesh is not None
    pos = ring.index(ctx.rank)
    right = ring[(pos + 1) % ws]
    left = ring[(pos - 1) % ws]
    deadline = ctx.deadline()

    _ring_reduce_scatter(ctx, flat, op, tag_base, ring=ring)
    bounds = _ring_bounds(flat.size, ws)

    def chunk(i: int) -> np.ndarray:
        i %= ws
        return flat[bounds[i] : bounds[i + 1]]

    # allgather phase: ring position p starts owning reduced chunk p
    for step in range(ws - 1):
        send_idx = (pos - step) % ws
        recv_idx = (pos - step - 1) % ws
        mesh.exchange(
            [(right, tag_base + 2000 + step, _bytes_view(chunk(send_idx)))],
            [(left, tag_base + 2000 + step, _bytes_view(chunk(recv_idx)))],
            deadline,
        )


def _hier_allreduce(
    ctx: _CommCtx, flat: np.ndarray, op: ReduceOp, tag_base: int = 0
) -> None:
    """Two-level in-place allreduce over the discovered host topology:
    intra-host shared-memory reduce (fixed ascending-rank order) → striped
    multi-lane cross-host ring among the per-host leaders → intra-host
    broadcast.  Each byte crosses the DCN once per HOST instead of once per
    replica; results are deterministic (fixed reduction order) and
    bit-identical across lane counts at a fixed topology, though not
    bit-identical to the flat ring (different reduction ORDER — allclose)."""
    mesh = ctx.mesh
    assert mesh is not None and mesh.topo is not None
    topo = mesh.topo
    deadline = ctx.deadline()
    mesh.shm_reduce(flat, op, deadline)
    if topo.is_leader and len(topo.leader_ring) > 1:
        _ring_allreduce(ctx, flat, op, tag_base, ring=topo.leader_ring)
    mesh.shm_bcast(flat, deadline)


def _hier_allgather_sync(
    ctx: _CommCtx, array: np.ndarray, tag: int
) -> List[np.ndarray]:
    """Hierarchical allgather: shm-gather each host's buffers to its
    leader, exchange whole host BLOCKS among leaders (each byte crosses the
    DCN once per host pair, not once per replica pair), then shm-broadcast
    the assembled result.  Same value contract as the flat path: a list
    indexed by global rank, own entry aliasing the input."""
    mesh = ctx.mesh
    assert mesh is not None and mesh.topo is not None
    topo = mesh.topo
    ws, rank = ctx.world_size, ctx.rank
    deadline = ctx.deadline()
    n = array.nbytes
    total = np.empty(ws * n, dtype=np.uint8)

    gathered = mesh.shm_gather(array, deadline)
    if topo.is_leader:
        if len(topo.leader_ring) > 1:
            assert gathered is not None
            my_block = np.concatenate(
                [
                    np.frombuffer(_bytes_view(a), dtype=np.uint8)
                    for a in gathered
                ]
            )
            other = [g for g in topo.hosts if rank not in g]
            blocks = {g[0]: np.empty(len(g) * n, dtype=np.uint8) for g in other}
            sends = [
                (g[0], wire_tags.HIER_HOST_BLOCK_TAG_OFFSET + tag, _bytes_view(my_block))
                for g in other
            ]
            recvs = [
                (g[0], wire_tags.HIER_HOST_BLOCK_TAG_OFFSET + tag, _bytes_view(blocks[g[0]]))
                for g in other
            ]
            mesh.exchange(sends, recvs, deadline)
            for g in other:
                block = blocks[g[0]]
                for k, member in enumerate(g):
                    total[member * n : (member + 1) * n] = block[
                        k * n : (k + 1) * n
                    ]
        assert gathered is not None
        for k, member in enumerate(topo.local):
            total[member * n : (member + 1) * n] = _bytes_view(gathered[k])
    mesh.shm_bcast(total, deadline)

    out: List[np.ndarray] = []
    for p in range(ws):
        if p == rank:
            out.append(array)
        else:
            out.append(
                total[p * n : (p + 1) * n]
                .view(array.dtype)
                .reshape(array.shape)
                .copy()
            )
    return out


def _hier_broadcast_sync(
    ctx: _CommCtx, arrays: List[np.ndarray], root: int
) -> List[np.ndarray]:
    """Hierarchical broadcast: the root pushes each buffer once per OTHER
    host (to its leader); delivery inside every host is a shared-memory
    broadcast.  Wire bytes drop by the local-group factor vs the flat
    root-to-every-peer fanout."""
    mesh = ctx.mesh
    assert mesh is not None and mesh.topo is not None
    topo = mesh.topo
    out = [np.ascontiguousarray(a) for a in arrays]
    deadline = ctx.deadline()
    root_local = root in topo.local
    src_idx = topo.local.index(root) if root_local else 0
    for i, a in enumerate(out):
        view = _bytes_view(a)
        if ctx.rank == root:
            other_leads = [g[0] for g in topo.hosts if root not in g]
            if other_leads:
                mesh.exchange(
                    [
                        (lead, wire_tags.BROADCAST_TAG_OFFSET + i, view)
                        for lead in other_leads
                    ],
                    [],
                    deadline,
                )
        elif topo.is_leader and not root_local:
            mesh.exchange(
                [], [(root, wire_tags.BROADCAST_TAG_OFFSET + i, view)], deadline
            )
        mesh.shm_bcast(a, deadline, src_idx=src_idx)
    return out


def _broadcast_sync(ctx: _CommCtx, arrays: List[np.ndarray], root: int) -> List[np.ndarray]:
    ws = ctx.world_size
    out = [np.ascontiguousarray(a) for a in arrays]
    if ws == 1:
        return out
    mesh = ctx.mesh
    assert mesh is not None
    if mesh.topo is not None:
        return _hier_broadcast_sync(ctx, out, root)
    deadline = ctx.deadline()
    if ctx.rank == root:
        for i, a in enumerate(out):
            view = _bytes_view(a)
            sends = [
                (p, wire_tags.BROADCAST_TAG_OFFSET + i, view) for p in mesh.peers
            ]
            mesh.exchange(sends, [], deadline)
    else:
        for i, a in enumerate(out):
            mesh.exchange(
                [], [(root, wire_tags.BROADCAST_TAG_OFFSET + i, _bytes_view(a))], deadline
            )
    return out


# ---------------------------------------------------------------------------
# Test / adapter communicators
# ---------------------------------------------------------------------------


class DummyCommunicator(Communicator):
    """World-size-1 no-op communicator (``process_group.py:1005-1134``):
    returns inputs unchanged; soaks up wrapper init in tests.

    ``is_passthrough`` marks the "collectives return my own contribution"
    fiction so shard-structured pipelines (quantized allreduce) can take an
    equivalent local path instead of mis-assembling shards."""

    is_passthrough = True

    def __init__(self, rank: int = 0, world_size: int = 1) -> None:
        self._rank = rank
        self._world_size = world_size
        self.configure_count = 0

    def configure(self, store_addr: str, replica_id: str, rank: int, world_size: int, **kw) -> None:  # type: ignore[override]
        self._rank = rank
        self._world_size = world_size
        self.configure_count += 1

    def allreduce(
        self,
        buffers: Buffers,
        op: ReduceOp = ReduceOp.SUM,
        in_place: bool = False,
    ) -> Work:
        return DummyWork(buffers)

    def broadcast(self, buffers: Buffers, root: int = 0) -> Work:
        return DummyWork(buffers)

    def reduce_scatter(
        self, data: np.ndarray, op: ReduceOp = ReduceOp.SUM
    ) -> Work:
        flat = np.asarray(data).reshape(-1)
        bounds = _ring_bounds(flat.size, self._world_size)
        return DummyWork(flat[bounds[self._rank] : bounds[self._rank + 1]])

    def send_bytes(self, data, dst: int, tag: int = 0) -> Work:
        nbytes = data.nbytes if hasattr(data, "nbytes") else len(data)
        return DummyWork(nbytes)

    def recv_bytes(self, src: int, tag: int = 0) -> Work:
        return DummyWork(b"")

    def recv_bytes_into(self, src, out, tag: int = 0) -> Work:
        return DummyWork(0)

    def alltoall(self, chunks, tag: int = 0) -> Work:
        # mirror-world fiction: every peer sends us what we'd send ourselves
        return DummyWork([chunks[self._rank]] * self._world_size)

    def allgather(self, data, tag: int = 0) -> Work:
        return DummyWork([data] * self._world_size)

    def barrier(self) -> Work:
        return DummyWork(None)

    def abort(self, reason: str = "aborted") -> None:
        pass

    def errored(self) -> Optional[Exception]:
        return None

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._world_size


class FakeCommunicatorWrapper(Communicator):
    """Error-injection wrapper for tests (``process_group.py:1252-1317``):
    ``report_future_error`` makes the next collective's *future* fail while
    the underlying collective still runs, so peers are not wedged — matching
    the reference semantics (``process_group.py:1290-1317``)."""

    def __init__(self, comm: Communicator) -> None:
        self._comm = comm
        self._next_error: Optional[Exception] = None
        self._errored: Optional[Exception] = None

    def report_future_error(self, err: Exception) -> None:
        self._next_error = err

    def _wrap(self, work: Work) -> Work:
        if self._next_error is not None:
            err, self._next_error = self._next_error, None
            self._errored = err

            def _fail(_value: object) -> object:
                raise err

            return work.then(_fail)
        return work

    def configure(self, *args, **kwargs) -> None:  # type: ignore[override]
        self._errored = None
        self._comm.configure(*args, **kwargs)

    def allreduce(
        self,
        buffers: Buffers,
        op: ReduceOp = ReduceOp.SUM,
        in_place: bool = False,
    ) -> Work:
        return self._wrap(self._comm.allreduce(buffers, op, in_place=in_place))

    def broadcast(self, buffers: Buffers, root: int = 0) -> Work:
        return self._wrap(self._comm.broadcast(buffers, root))

    def reduce_scatter(
        self, data: np.ndarray, op: ReduceOp = ReduceOp.SUM
    ) -> Work:
        return self._wrap(self._comm.reduce_scatter(data, op))

    def send_bytes(self, data: bytes, dst: int, tag: int = 0) -> Work:
        return self._wrap(self._comm.send_bytes(data, dst, tag))

    def send_frame_parts(self, parts, nbytes: int, dst: int, tag: int = 0) -> Work:
        return self._wrap(self._comm.send_frame_parts(parts, nbytes, dst, tag))

    def recv_bytes(self, src: int, tag: int = 0) -> Work:
        return self._wrap(self._comm.recv_bytes(src, tag))

    def recv_bytes_into(self, src: int, out, tag: int = 0) -> Work:
        return self._wrap(self._comm.recv_bytes_into(src, out, tag))

    def heal_drain(self, *args, **kwargs) -> Work:
        return self._wrap(self._comm.heal_drain(*args, **kwargs))

    def alltoall(self, chunks, tag: int = 0) -> Work:
        return self._wrap(self._comm.alltoall(chunks, tag))

    def allgather(self, data, tag: int = 0) -> Work:
        return self._wrap(self._comm.allgather(data, tag))

    def lane_stats(self) -> Dict[str, object]:
        return self._comm.lane_stats()

    def arm_faults(self, spec) -> None:
        self._comm.arm_faults(spec)  # type: ignore[attr-defined]

    def hier_topology(self) -> Optional[Dict[str, object]]:
        return self._comm.hier_topology()

    def intra_reduce(self, flat, op: ReduceOp = ReduceOp.SUM) -> Work:
        return self._wrap(self._comm.intra_reduce(flat, op))  # type: ignore[attr-defined]

    def intra_broadcast(self, flat, count: int, dtype=np.float32) -> Work:
        return self._wrap(
            self._comm.intra_broadcast(flat, count, dtype)  # type: ignore[attr-defined]
        )

    def leader_comm(self) -> "Communicator":
        return self._comm.leader_comm()  # type: ignore[attr-defined]

    def barrier(self) -> Work:
        return self._wrap(self._comm.barrier())

    def abort(self, reason: str = "aborted") -> None:
        self._comm.abort(reason)

    def errored(self) -> Optional[Exception]:
        return self._errored or self._comm.errored()

    def rank(self) -> int:
        return self._comm.rank()

    def size(self) -> int:
        return self._comm.size()

    def set_timeout(self, timeout_s: float) -> None:
        self._comm.set_timeout(timeout_s)

    def shutdown(self) -> None:
        self._comm.shutdown()


class ManagedCommunicator(Communicator):
    """Routes collectives through a Manager so unmodified data-parallel code
    sees fault-tolerant semantics transparently
    (``process_group.py:1320-1353``): ``allreduce`` goes through
    ``manager.allreduce`` (error-swallowing, participation-aware) and
    ``size()`` reports the participating world size."""

    def __init__(self, manager) -> None:  # type: ignore[no-untyped-def]
        self._manager = manager

    def configure(self, *args, **kwargs) -> None:  # type: ignore[override]
        raise RuntimeError("ManagedCommunicator is configured by its Manager")

    def allreduce(
        self,
        buffers: Buffers,
        op: ReduceOp = ReduceOp.SUM,
        in_place: bool = False,
    ) -> Work:
        return self._manager.allreduce(buffers)

    def broadcast(self, buffers: Buffers, root: int = 0) -> Work:
        return self._manager._comm.broadcast(buffers, root)

    def reduce_scatter(
        self, data: np.ndarray, op: ReduceOp = ReduceOp.SUM
    ) -> Work:
        return self._manager._comm.reduce_scatter(data, op)

    def send_bytes(self, data: bytes, dst: int, tag: int = 0) -> Work:
        return self._manager._comm.send_bytes(data, dst, tag)

    def send_frame_parts(self, parts, nbytes: int, dst: int, tag: int = 0) -> Work:
        return self._manager._comm.send_frame_parts(parts, nbytes, dst, tag)

    def recv_bytes(self, src: int, tag: int = 0) -> Work:
        return self._manager._comm.recv_bytes(src, tag)

    def recv_bytes_into(self, src: int, out, tag: int = 0) -> Work:
        return self._manager._comm.recv_bytes_into(src, out, tag)

    def heal_drain(self, *args, **kwargs) -> Work:
        return self._manager._comm.heal_drain(*args, **kwargs)

    def lane_stats(self) -> Dict[str, object]:
        return self._manager._comm.lane_stats()

    def arm_faults(self, spec) -> None:
        self._manager._comm.arm_faults(spec)

    def hier_topology(self) -> Optional[Dict[str, object]]:
        return self._manager._comm.hier_topology()

    def intra_reduce(self, flat, op: ReduceOp = ReduceOp.SUM) -> Work:
        return self._manager._comm.intra_reduce(flat, op)

    def intra_broadcast(self, flat, count: int, dtype=np.float32) -> Work:
        return self._manager._comm.intra_broadcast(flat, count, dtype)

    def leader_comm(self) -> "Communicator":
        return self._manager._comm.leader_comm()

    def barrier(self) -> Work:
        return self._manager._comm.barrier()

    def abort(self, reason: str = "aborted") -> None:
        self._manager._comm.abort(reason)

    def errored(self) -> Optional[Exception]:
        return self._manager._comm.errored()

    def rank(self) -> int:
        return self._manager.participating_rank() or 0

    def size(self) -> int:
        return self._manager.num_participants()
