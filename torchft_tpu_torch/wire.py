"""Framed binary wire protocol for the torchft_tpu control plane.

The reference implements its control plane as gRPC/protobuf services
(``proto/torchft.proto:37-130``, tonic servers in ``src/lighthouse.rs`` /
``src/manager.rs``).  We use a purpose-built framed binary protocol instead:
it needs no code generation, is trivially implementable from both Python and
C++ (``native/``), and the control plane traffic is tiny (a few KB per step).

Framing
-------
Every message is one frame::

    u32  payload_len          (little endian, excludes these 4 bytes)
    u8   msg_type             (MsgType)
    ...  body                 (fields in fixed order per message type)

Primitive encodings (all little endian):

- ``u8`` / ``u32`` / ``u64`` / ``i64``: fixed width integers
- ``f64``: IEEE double
- ``str``: ``u32`` length + UTF-8 bytes
- ``bytes``: ``u32`` length + raw bytes
- ``bool``: ``u8`` 0/1
- ``list<T>``: ``u32`` count + items
- ``optional<T>``: ``u8`` present flag + value when present

Request deadlines ride in the request body as ``timeout_ms`` (u64) — the
server honors the client's deadline on blocking RPCs the same way the
reference parses the ``grpc-timeout`` header server-side
(``src/timeout.rs:26-69``).

Errors are returned as an ``ERROR`` frame carrying an error code and a
message; clients raise ``TimeoutError`` for deadline errors, mirroring the
pyo3 timeout mapping in ``src/lib.rs:673-685``.
"""

from __future__ import annotations

import os
import random
import socket
import struct
import time
from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional, Tuple

MAX_FRAME_BYTES = 64 * 1024 * 1024

# Dial attempts for control-plane connections (``connect()``), with
# jittered exponential backoff between attempts, all inside the caller's
# timeout budget — the analog of the reference's retry-with-backoff channel
# helper (``src/net.rs:16-42``), so replicas racing a restarting
# lighthouse/store don't die at dial time.
CONNECT_RETRIES_ENV = "TORCHFT_CONNECT_RETRIES"
_CONNECT_RETRIES_DEFAULT = 3
_CONNECT_BACKOFF_BASE_S = 0.1

# Wire version of the MGR_QUORUM_RESP body.  v1 is the original fixed field
# order; v2 appends the striped-healing fields (every healthy peer's replica
# rank + manager address, and the full recovery-destination set) AFTER the v1
# fields, prefixed by this version number.  v3 adds the spare-replica fields
# (is_spare, registered spare ids, participant manager addresses) in the
# same tail.  v4 adds the hierarchical coordination plane: LH_QUORUM_REQ
# grows a delta-base tail (the requester's last-seen quorum digest, so the
# lighthouse can answer with a LH_QUORUM_DELTA_RESP instead of the full
# membership), heartbeats may carry a spare warm-step tail, and the
# aggregated-beat messages (AGG_BEAT / LH_AGG_BEAT) exist at all.  v5 adds
# degraded-mode capacity: a replica that lost in-replica devices and
# re-lowered onto the survivors advertises a capacity fraction (0, 1] on
# its quorum registration and its heartbeats, the Quorum broadcast carries
# per-participant capacities, and MGR_QUORUM_RESP fans them out to every
# rank (data-shard rescale + weighted outer reduce inputs).  v1 decoders
# ignore trailing bytes and v2+ decoders treat their absence as "no
# striping/spare/delta/capacity info", so mixed fleets interoperate during
# a rolling upgrade; pin TORCHFT_WIRE_COMPAT=1/2/3/4 on upgraded processes
# until every peer understands the newer version (a v4 pin keeps every
# frame byte-identical to the pre-v5 protocol).  The v3 spare fields are
# additionally emitted only when spare content EXISTS (a spare-free fleet
# stays byte-for-byte on the v2 layout), the v5 capacity fields only when
# some replica is actually degraded (a full-capacity fleet stays
# byte-for-byte on the v4 layout), and a delta response is only ever sent
# to a requester that advertised a v4 delta base.
MANAGER_QUORUM_WIRE_VERSION = 5
WIRE_COMPAT_ENV = "TORCHFT_WIRE_COMPAT"

# QuorumMember roles (wire v3).  ACTIVE members count toward min_replicas /
# majority and run collectives; SPARE members pre-join the control plane and
# keep a warm shadow of the fleet state but contribute nothing until the
# lighthouse promotes them.  The role rides as a version-gated TAIL byte on
# LH_QUORUM_REQ (after timeout_ms) and the spare list as a tail on the
# Quorum broadcast — legacy decoders ignore trailing bytes, and the tails
# are emitted only when a spare is actually involved, so role-free fleets
# stay byte-identical to v2.
ROLE_ACTIVE = 0
ROLE_SPARE = 1


def manager_quorum_wire_version() -> int:
    compat = os.environ.get(WIRE_COMPAT_ENV)
    if compat:
        try:
            pinned = int(compat)
        except ValueError as e:
            # name the knob: a bare int() error deep in the quorum RPC path
            # would hide which env var is at fault
            raise ValueError(
                f"unparseable {WIRE_COMPAT_ENV}={compat!r} (expected an "
                f"integer wire version <= {MANAGER_QUORUM_WIRE_VERSION})"
            ) from e
        return max(1, min(MANAGER_QUORUM_WIRE_VERSION, pinned))
    return MANAGER_QUORUM_WIRE_VERSION


class MsgType(IntEnum):
    # Store ops (store.py)
    STORE_SET = 0x01
    STORE_GET = 0x02
    STORE_ADD = 0x03
    STORE_EXISTS = 0x04
    STORE_DELETE = 0x05
    STORE_OK = 0x0E
    # Lighthouse service (reference proto/torchft.proto:69-73)
    LH_QUORUM_REQ = 0x10
    LH_QUORUM_RESP = 0x11
    LH_HEARTBEAT_REQ = 0x12
    LH_HEARTBEAT_RESP = 0x13
    LH_STATUS_REQ = 0x14
    LH_STATUS_RESP = 0x15
    # Hierarchical coordination plane (wire v4, coord/aggregator.py):
    # AGG_BEAT is one member's heartbeat to its zone aggregator;
    # LH_AGG_BEAT is the aggregator's batched upstream flush (one RPC per
    # tick carrying every member beat collected since the last flush).
    # LH_QUORUM_DELTA_RESP answers a quorum request whose v4 tail
    # advertised a delta base the server still holds: membership deltas +
    # compact per-index step updates instead of the full member list.
    LH_AGG_BEAT_REQ = 0x16
    LH_AGG_BEAT_RESP = 0x17
    LH_QUORUM_DELTA_RESP = 0x18
    AGG_BEAT_REQ = 0x19
    AGG_BEAT_RESP = 0x1A
    # Manager service (reference proto/torchft.proto:124-130)
    MGR_QUORUM_REQ = 0x20
    MGR_QUORUM_RESP = 0x21
    MGR_CKPT_META_REQ = 0x22
    MGR_CKPT_META_RESP = 0x23
    MGR_SHOULD_COMMIT_REQ = 0x24
    MGR_SHOULD_COMMIT_RESP = 0x25
    MGR_KILL_REQ = 0x26
    MGR_KILL_RESP = 0x27
    # Spare warm channels (manager_server.py): chunk-addressable snapshot
    # index + ranges (per-chunk version watermarks ride the staged step),
    # and the outer-sync delta feed spares subscribe to.
    MGR_WARM_INDEX_REQ = 0x28
    MGR_WARM_INDEX_RESP = 0x29
    MGR_WARM_RANGE_REQ = 0x2A
    MGR_WARM_RANGE_RESP = 0x2B
    MGR_DELTA_REQ = 0x2C
    MGR_DELTA_RESP = 0x2D
    # Communicator data plane (communicator.py)
    COMM_HELLO = 0x30
    COMM_DATA = 0x31
    # Error frame (any service)
    ERROR = 0x7F


class ErrCode(IntEnum):
    UNKNOWN = 0
    TIMEOUT = 1
    NOT_FOUND = 2
    INVALID = 3
    SHUTDOWN = 4


# ---------------------------------------------------------------------------
# Data-plane collective tag registry
# ---------------------------------------------------------------------------
#
# Every COMM_DATA frame carries a u64 tag that pairs sends with receives
# within one mesh epoch.  The tag space used to be allocated by scattered
# literals (103, 880/881, 900, 4000/5000, 7000/8000, ...); this registry is
# now the single place tags are assigned, and the ftlint wire checker
# (torchft_tpu/analysis/wireproto.py) fails the build on any tag literal
# that is not declared here or any two allocations that collide.
#
# Two kinds of entry:
#
# - USER allocations: tag values callers pass to alltoall/allgather &c.
#   Declared as (base, span) — the caller may use [base, base+span).
# - WIRE offsets: namespace offsets the communicator adds to a user tag so
#   different primitives' frames can never pair up (alltoall vs allgather
#   vs leader-ring variants).
#
# Ring collectives allocate internally (RING_BUFFER_TAG_STRIDE per buffer,
# +1000/+2000 phase offsets) and the striped heal salts per step in a
# 10M-wide range (HEAL_STEP_TAG_STRIDE) on the dedicated p2p lane, so
# neither can collide with user allocations.

# -- USER tag allocations (value space: what callers pass as `tag=`) --------
STREAM_OUTER_TAG_BASE = 8  # streamed DiLoCo fragment sync (collectives.py):
STREAM_OUTER_TAG_SPAN = 88  # 8..95, carved into STREAM_FRAG_WINDOWS rotating
#   per-fragment windows so consecutive streamed fragment syncs can never
#   alias tags even if a late frame lingers past its sync's resolution.
#   Kept below every legacy allocation (and far below the wire offsets) so
#   the namespace-composition properties match the proven blocking path —
#   but ABOVE ftlint's ad-hoc literal ceiling (tags <= 7 are lint-legal
#   without registration; carving the window into that range would let an
#   unflagged literal alias streamed frames).
STREAM_FRAG_WINDOWS = 4  # a streamed sync frames in window key % WINDOWS
#   (key = outer step + fragment index — see Manager.outer_shard_allreduce)
STREAM_FRAG_WINDOW_SPAN = STREAM_OUTER_TAG_SPAN // STREAM_FRAG_WINDOWS  # 22
#   tags per window = 11 pipeline chunks (2 tags/chunk); the chunk planner
#   grows the chunk size past TORCHFT_OUTER_CHUNK_MB when a fragment would
#   need more chunks than its window holds.
QUANT_RING_TAG = 103  # quantized ring allreduce (collectives.py)
QUANT_PIPELINE_TAG_BASE = 110  # windowed quant pipeline, 2 tags/window
QUANT_PIPELINE_TAG_SPAN = 770  # 110..879 (384 windows ≈ 1.5 GB @ 4 MB)
RESHARD_LEN_TAG = 880  # outer-shard reshard: length exchange (local_sgd.py)
RESHARD_BLOB_TAG = 881  # outer-shard reshard: blob exchange (local_sgd.py)
OUTER_SHARD_TAG_BASE = 900  # sharded outer sync, 2 tags/chunk, <=64 chunks
OUTER_SHARD_TAG_SPAN = 128  # 900..1027
DEVICE_QUANT_PIPELINE_TAG_BASE = 1050  # on-device dequant+reduce pipeline
DEVICE_QUANT_PIPELINE_TAG_SPAN = 1950  # 1050..2999 (user tags stay below
#   every wire offset; the pipeline warns when a payload would need more
#   windows than its span covers)

# -- WIRE namespace offsets (added by the communicator, never by callers) ---
BROADCAST_TAG_OFFSET = 3000  # broadcast: offset + buffer index
ALLTOALL_TAG_OFFSET = 4000  # alltoall frames: offset + user tag
ALLGATHER_TAG_OFFSET = 5000  # allgather frames: offset + user tag
LEADER_ALLTOALL_TAG_OFFSET = 7000  # leader-ring alltoall (hierarchical)
LEADER_ALLGATHER_TAG_OFFSET = 8000  # leader-ring allgather (hierarchical)
HIER_HOST_BLOCK_TAG_OFFSET = 9000  # hier allgather host-block exchange
#   (applied ON TOP of ALLGATHER_TAG_OFFSET, so host-block frames live at
#   14000 + user tag — clear of every first-order namespace)

# -- internal allocators ----------------------------------------------------
RING_REDUCE_TAG_BASE = 30_000  # explicit reduce_scatter API calls
RING_BUFFER_TAG_STRIDE = 10_000  # multi-buffer allreduce: buffer i at i*stride
HEAL_TAG_BASE = 9000  # striped heal (comm_transport.py): base*1000 +
HEAL_STEP_TAG_STRIDE = 10_000_000  # step*stride salting, p2p lane only

# The machine-readable allocation table the ftlint wire checker enforces:
# name -> (base, span).  USER allocations must be pairwise disjoint and must
# stay below the smallest WIRE offset; WIRE offsets must be pairwise
# >= 1000 apart (the nominal per-namespace width).
#
# Honest limit of the static proof: the namespaces are nominal-width, so a
# user tag above 1000 composed with an offset spills past the next
# namespace boundary (e.g. allgather(1050+2w) -> 6051+2w crosses 7000 at
# w >= 475).  Pairing stays unambiguous in practice because within one
# pipeline the alltoall and allgather window tags have opposite parities
# and collectives on one communicator epoch are serialized per op thread —
# but the checker cannot prove that, which is why the quantized pipelines
# WARN at runtime when a payload would exceed the declared span (see
# collectives._allreduce_pipelined_sync).
USER_TAG_ALLOCATIONS = {
    "STREAM_OUTER": (STREAM_OUTER_TAG_BASE, STREAM_OUTER_TAG_SPAN),
    "QUANT_RING": (QUANT_RING_TAG, 1),
    "QUANT_PIPELINE": (QUANT_PIPELINE_TAG_BASE, QUANT_PIPELINE_TAG_SPAN),
    "RESHARD_LEN": (RESHARD_LEN_TAG, 1),
    "RESHARD_BLOB": (RESHARD_BLOB_TAG, 1),
    "OUTER_SHARD": (OUTER_SHARD_TAG_BASE, OUTER_SHARD_TAG_SPAN),
    "DEVICE_QUANT_PIPELINE": (
        DEVICE_QUANT_PIPELINE_TAG_BASE,
        DEVICE_QUANT_PIPELINE_TAG_SPAN,
    ),
}
WIRE_TAG_OFFSETS = {
    "BROADCAST": BROADCAST_TAG_OFFSET,
    "ALLTOALL": ALLTOALL_TAG_OFFSET,
    "ALLGATHER": ALLGATHER_TAG_OFFSET,
    "LEADER_ALLTOALL": LEADER_ALLTOALL_TAG_OFFSET,
    "LEADER_ALLGATHER": LEADER_ALLGATHER_TAG_OFFSET,
    "HIER_HOST_BLOCK": HIER_HOST_BLOCK_TAG_OFFSET,
}
INTERNAL_TAG_BASES = {
    "RING_REDUCE": RING_REDUCE_TAG_BASE,
    "RING_BUFFER_STRIDE": RING_BUFFER_TAG_STRIDE,
    "HEAL": HEAL_TAG_BASE,
    "HEAL_STEP_STRIDE": HEAL_STEP_TAG_STRIDE,
}


def stream_frag_tag_window(key: int) -> "tuple[int, int]":
    """``(tag_base, tag_span)`` of the rotating STREAM_OUTER window a
    streamed fragment sync must frame its chunk collectives in.  A pure
    function of the caller's window key, so every replica picks the
    identical window with no wire metadata.  The scheduler keys on
    ``outer step + fragment index`` (quorum-shared state, so a healed
    replica agrees with the survivors): consecutive streamed syncs land
    in disjoint windows — including at ``num_fragments=1``, where the
    advancing step alone rotates them — so a streamed sync can never
    pair a lingering frame from the previous (already-resolved) sync."""
    window = key % STREAM_FRAG_WINDOWS
    return (
        STREAM_OUTER_TAG_BASE + window * STREAM_FRAG_WINDOW_SPAN,
        STREAM_FRAG_WINDOW_SPAN,
    )


class WireError(RuntimeError):
    def __init__(self, code: ErrCode, msg: str) -> None:
        super().__init__(msg)
        self.code = code


class Writer:
    """Append-only little-endian message builder."""

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def u8(self, v: int) -> "Writer":
        self._buf += struct.pack("<B", v)
        return self

    def u32(self, v: int) -> "Writer":
        self._buf += struct.pack("<I", v)
        return self

    def u64(self, v: int) -> "Writer":
        self._buf += struct.pack("<Q", v)
        return self

    def i64(self, v: int) -> "Writer":
        self._buf += struct.pack("<q", v)
        return self

    def f64(self, v: float) -> "Writer":
        self._buf += struct.pack("<d", v)
        return self

    def boolean(self, v: bool) -> "Writer":
        return self.u8(1 if v else 0)

    def string(self, v: str) -> "Writer":
        raw = v.encode("utf-8")
        self.u32(len(raw))
        self._buf += raw
        return self

    def blob(self, v: bytes) -> "Writer":
        self.u32(len(v))
        self._buf += v
        return self

    def opt_i64(self, v: Optional[int]) -> "Writer":
        if v is None:
            return self.u8(0)
        return self.u8(1).i64(v)

    def payload(self) -> bytes:
        return bytes(self._buf)


class Reader:
    """Sequential little-endian message parser."""

    __slots__ = ("_view", "_off")

    def __init__(self, data: bytes) -> None:
        self._view = memoryview(data)
        self._off = 0

    def _take(self, n: int) -> memoryview:
        if self._off + n > len(self._view):
            raise WireError(ErrCode.INVALID, "truncated frame")
        out = self._view[self._off : self._off + n]
        self._off += n
        return out

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def boolean(self) -> bool:
        return self.u8() != 0

    def string(self) -> str:
        n = self.u32()
        return bytes(self._take(n)).decode("utf-8")

    def blob(self) -> bytes:
        n = self.u32()
        return bytes(self._take(n))

    def opt_i64(self) -> Optional[int]:
        if self.u8() == 0:
            return None
        return self.i64()

    def done(self) -> bool:
        return self._off == len(self._view)


# ---------------------------------------------------------------------------
# Shared control-plane dataclasses
# ---------------------------------------------------------------------------


@dataclass
class QuorumMember:
    """One replica group in a quorum.

    Mirrors ``QuorumMember`` in the reference wire protocol
    (``proto/torchft.proto:37-47``): identity, RPC address, store address for
    communicator rendezvous, current step, group world size, and the
    shrink_only / commit_failures / opaque-data knobs.
    """

    replica_id: str
    address: str = ""
    store_address: str = ""
    step: int = 0
    world_size: int = 1
    shrink_only: bool = False
    commit_failures: int = 0
    data: str = ""
    # NOT part of the fixed encode layout (legacy compatibility): the role
    # rides as a version-gated tail on the messages that carry members —
    # see ROLE_ACTIVE/ROLE_SPARE above.
    role: int = ROLE_ACTIVE
    # Degraded-mode capacity fraction (wire v5), also a version-gated tail:
    # 1.0 = full width; a replica that lost devices and re-lowered onto the
    # survivors advertises the surviving fraction.  Inputs to data-shard
    # rescale, the weighted outer reduce, and the lighthouse's
    # wound→swap→evict policy ladder.
    capacity: float = 1.0

    def encode(self, w: Writer) -> None:
        (
            w.string(self.replica_id)
            .string(self.address)
            .string(self.store_address)
            .i64(self.step)
            .u64(self.world_size)
            .boolean(self.shrink_only)
            .i64(self.commit_failures)
            .string(self.data)
        )

    @staticmethod
    def decode(r: Reader) -> "QuorumMember":
        return QuorumMember(
            replica_id=r.string(),
            address=r.string(),
            store_address=r.string(),
            step=r.i64(),
            world_size=r.u64(),
            shrink_only=r.boolean(),
            commit_failures=r.i64(),
            data=r.string(),
        )


@dataclass
class CommHealth:
    """Compact cumulative comm-health summary one replica reports with its
    heartbeats (derived from ``Communicator.lane_stats()``): data-plane
    stall events, in-epoch lane reconnects/failovers, injected faults, and
    payload bytes moved.  Counters are job-lifetime cumulative so the
    lighthouse can difference consecutive beats into rates.

    Rides OPTIONALLY at the tail of ``LH_HEARTBEAT_REQ`` (flag byte +
    fixed-width fields): a legacy server reads the replica id and ignores
    the tail; a new server treats absence as "no health report"."""

    stalls: int = 0
    reconnects: int = 0
    failovers: int = 0
    faults: int = 0
    tx_bytes: int = 0
    rx_bytes: int = 0

    def encode(self, w: Writer) -> None:
        (
            w.u64(self.stalls)
            .u64(self.reconnects)
            .u64(self.failovers)
            .u64(self.faults)
            .u64(self.tx_bytes)
            .u64(self.rx_bytes)
        )

    @staticmethod
    def decode(r: Reader) -> "CommHealth":
        return CommHealth(
            stalls=r.u64(),
            reconnects=r.u64(),
            failovers=r.u64(),
            faults=r.u64(),
            tx_bytes=r.u64(),
            rx_bytes=r.u64(),
        )


@dataclass
class Quorum:
    """A computed quorum (``proto/torchft.proto`` ``Quorum`` message).

    ``spares`` (wire v3) rides as a version-gated tail AFTER the
    participant list: registered spare replicas that pre-joined the control
    plane but are NOT participants — they never count toward membership,
    never affect ``quorum_id``, and a v1/v2 decoder never sees them (it
    stops after the participants).  The tail is emitted only when spares
    exist, so spare-free quorums stay byte-identical to v2.

    Per-participant capacities (wire v5) ride a second tail AFTER the
    spares tail, emitted only when some participant is actually degraded
    (full-capacity quorums stay byte-identical to v4); when emitted, the
    spares tail is always emitted too (possibly with zero spares) so v3/v4
    decoders — which read the first tail as spares — stop cleanly before
    the capacity bytes."""

    quorum_id: int
    participants: List[QuorumMember] = field(default_factory=list)
    created: float = 0.0  # unix seconds
    spares: List[QuorumMember] = field(default_factory=list)

    def encode(self, w: Writer) -> None:
        w.i64(self.quorum_id).f64(self.created).u32(len(self.participants))
        for p in self.participants:
            p.encode(w)
        wire_version = manager_quorum_wire_version()
        has_capacity_tail = wire_version >= 5 and any(
            p.capacity != 1.0 for p in self.participants
        )
        # the capacity tail implies the spares tail (possibly empty): v3/v4
        # decoders read the first tail as spares and stop before the
        # capacity bytes
        has_spare_tail = wire_version >= 3 and (
            bool(self.spares) or has_capacity_tail
        )
        if has_spare_tail:
            w.u32(3)
            w.u32(len(self.spares))
            for s in self.spares:
                s.encode(w)
        if has_capacity_tail:
            w.u32(5)
            w.u32(len(self.participants))
            for p in self.participants:
                w.f64(p.capacity)

    @staticmethod
    def decode(r: Reader) -> "Quorum":
        quorum_id = r.i64()
        created = r.f64()
        n = r.u32()
        out = Quorum(
            quorum_id=quorum_id,
            created=created,
            participants=[QuorumMember.decode(r) for _ in range(n)],
        )
        if not r.done() and r.u32() >= 3:
            out.spares = [QuorumMember.decode(r) for _ in range(r.u32())]
            for s in out.spares:
                s.role = ROLE_SPARE
        if not r.done() and r.u32() >= 5:
            capacities = [r.f64() for _ in range(r.u32())]
            for p, cap in zip(out.participants, capacities):
                p.capacity = cap
        return out


def _member_sig(m: QuorumMember) -> tuple:
    """Canonical identity of one member for digest/delta math: the fixed
    wire-layout fields only.  ``role`` is deliberately excluded — it never
    rides the fixed layout (which list a member appears in IS its role), so
    including it would make server-side digests (which may hold a promoted
    spare's original role) disagree with a client's decoded view.

    ``capacity`` (wire v5) is appended ONLY when degraded: a full-capacity
    member's sig is byte-for-byte what a v4 peer computes, so mixed v4/v5
    fleets keep agreeing on digests (and riding deltas) until somebody is
    actually wounded — at which point the v4 peer's digest mismatch
    degrades it to full snapshots, never to a wrong membership view."""
    sig = (
        m.replica_id,
        m.address,
        m.store_address,
        m.step,
        m.world_size,
        m.shrink_only,
        m.commit_failures,
        m.data,
    )
    return sig if m.capacity == 1.0 else sig + (m.capacity,)


def _member_static_sig(m: QuorumMember) -> tuple:
    """Like :func:`_member_sig` minus the per-round movers (step,
    commit_failures) — members equal under this sig ride a quorum delta as
    a compact per-index step update instead of a full record.  ``capacity``
    rides here too (conditionally, like :func:`_member_sig`): a capacity
    change must travel as a full upsert, never be lost in a step update."""
    sig = (
        m.replica_id,
        m.address,
        m.store_address,
        m.world_size,
        m.shrink_only,
        m.data,
    )
    return sig if m.capacity == 1.0 else sig + (m.capacity,)


def quorum_digest(quorum: "Quorum") -> int:
    """Stable 64-bit content digest of a quorum's membership (participants
    + spares, canonical sorted order), independent of wire version and of
    ``quorum_id``/``created`` (those ride the delta header).  Both ends of
    a delta-coded broadcast verify against it."""
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    for m in quorum.participants:
        h.update(repr(_member_sig(m)).encode())
    h.update(b"|spares|")
    for s in quorum.spares:
        h.update(repr(_member_sig(s)).encode())
    return int.from_bytes(h.digest(), "little")


@dataclass
class MemberBeat:
    """One member's heartbeat as carried to (and batched by) a zone
    aggregator (wire v4).  ``warm_step`` is the spare warm watermark
    (-1 for actives / unknown) so spare warm-progress rides the aggregate
    instead of requiring a quorum-RPC re-registration; ``health`` is the
    same cumulative :class:`CommHealth` summary a direct heartbeat
    carries."""

    replica_id: str
    role: int = ROLE_ACTIVE
    warm_step: int = -1
    health: Optional[CommHealth] = None

    def encode(self, w: Writer) -> None:
        w.string(self.replica_id).u8(self.role).i64(self.warm_step)
        w.boolean(self.health is not None)
        if self.health is not None:
            self.health.encode(w)

    @staticmethod
    def decode(r: Reader) -> "MemberBeat":
        return MemberBeat(
            replica_id=r.string(),
            role=r.u8(),
            warm_step=r.i64(),
            health=CommHealth.decode(r) if r.boolean() else None,
        )


@dataclass
class AggBeat:
    """One aggregator→lighthouse flush (wire v4): the aggregator's id plus
    every member beat collected since the previous flush (latest per
    member).  One upstream RPC per tick replaces one RPC per member per
    heartbeat interval."""

    agg_id: str
    beats: List[MemberBeat] = field(default_factory=list)

    def encode(self, w: Writer) -> None:
        w.string(self.agg_id)
        w.u32(len(self.beats))
        for b in self.beats:
            b.encode(w)

    @staticmethod
    def decode(r: Reader) -> "AggBeat":
        return AggBeat(
            agg_id=r.string(),
            beats=[MemberBeat.decode(r) for _ in range(r.u32())],
        )


@dataclass
class QuorumDelta:
    """Delta-coded quorum broadcast (wire v4): the edit from a base quorum
    (identified by content digest) to the new one.  Membership changes ride
    as removals + full upserted member records; members whose only movers
    are ``step``/``commit_failures`` (the common case — everyone advances
    one step per round) ride as compact ``(base_index, step,
    commit_failures)`` triples against the base's canonical sorted order.
    The receiver applies the edit to its cached base and verifies
    ``new_digest`` — a mismatch is a protocol error, and the client falls
    back to a full snapshot on its next request.

    Upserted members' degraded capacities (wire v5) ride a version-gated
    tail aligned with ``upserts`` (a capacity change always travels as a
    full upsert — ``_member_static_sig`` includes capacity); emitted only
    when some upsert is actually degraded, so full-capacity deltas stay
    byte-identical to v4."""

    quorum_id: int = 0
    created: float = 0.0
    base_digest: int = 0
    new_digest: int = 0
    removed: List[str] = field(default_factory=list)
    upserts: List[QuorumMember] = field(default_factory=list)
    step_updates: List[Tuple[int, int, int]] = field(default_factory=list)
    spare_removed: List[str] = field(default_factory=list)
    spare_upserts: List[QuorumMember] = field(default_factory=list)

    def encode(self, w: Writer) -> None:
        w.i64(self.quorum_id).f64(self.created)
        w.u64(self.base_digest).u64(self.new_digest)
        w.u32(len(self.removed))
        for rid in self.removed:
            w.string(rid)
        w.u32(len(self.upserts))
        for m in self.upserts:
            m.encode(w)
        w.u32(len(self.step_updates))
        for idx, step, cf in self.step_updates:
            w.u32(idx)
            w.i64(step)
            w.i64(cf)
        w.u32(len(self.spare_removed))
        for rid in self.spare_removed:
            w.string(rid)
        w.u32(len(self.spare_upserts))
        for s in self.spare_upserts:
            s.encode(w)
        if manager_quorum_wire_version() >= 5 and any(
            m.capacity != 1.0 for m in self.upserts
        ):
            w.u32(5)
            w.u32(len(self.upserts))
            for m in self.upserts:
                w.f64(m.capacity)

    @staticmethod
    def decode(r: Reader) -> "QuorumDelta":
        out = QuorumDelta(
            quorum_id=r.i64(),
            created=r.f64(),
            base_digest=r.u64(),
            new_digest=r.u64(),
        )
        out.removed = [r.string() for _ in range(r.u32())]
        out.upserts = [QuorumMember.decode(r) for _ in range(r.u32())]
        n_steps = r.u32()
        for _ in range(n_steps):
            idx = r.u32()
            step = r.i64()
            cf = r.i64()
            out.step_updates.append((idx, step, cf))
        out.spare_removed = [r.string() for _ in range(r.u32())]
        out.spare_upserts = [QuorumMember.decode(r) for _ in range(r.u32())]
        for s in out.spare_upserts:
            s.role = ROLE_SPARE
        if not r.done() and r.u32() >= 5:
            capacities = [r.f64() for _ in range(r.u32())]
            for m, cap in zip(out.upserts, capacities):
                m.capacity = cap
        return out


def make_quorum_delta(base: "Quorum", new: "Quorum") -> QuorumDelta:
    """Compute the delta turning ``base`` into ``new`` (both in canonical
    sorted order, as the lighthouse issues them)."""
    base_map = {m.replica_id: (i, m) for i, m in enumerate(base.participants)}
    new_ids = {m.replica_id for m in new.participants}
    delta = QuorumDelta(
        quorum_id=new.quorum_id,
        created=new.created,
        base_digest=quorum_digest(base),
        new_digest=quorum_digest(new),
        removed=[rid for rid in base_map if rid not in new_ids],
    )
    for m in new.participants:
        entry = base_map.get(m.replica_id)
        if entry is None:
            delta.upserts.append(m)
            continue
        idx, bm = entry
        if _member_sig(m) == _member_sig(bm):
            continue
        if _member_static_sig(m) == _member_static_sig(bm):
            delta.step_updates.append((idx, m.step, m.commit_failures))
        else:
            delta.upserts.append(m)
    base_spares = {s.replica_id: s for s in base.spares}
    new_spare_ids = {s.replica_id for s in new.spares}
    delta.spare_removed = [
        rid for rid in base_spares if rid not in new_spare_ids
    ]
    delta.spare_upserts = [
        s
        for s in new.spares
        if s.replica_id not in base_spares
        or _member_sig(s) != _member_sig(base_spares[s.replica_id])
    ]
    return delta


def apply_quorum_delta(
    base: Optional["Quorum"],
    delta: QuorumDelta,
    base_digest: Optional[int] = None,
) -> "Quorum":
    """Apply one :class:`QuorumDelta` to the cached base quorum, verifying
    both digests.  Raises :class:`WireError` (INVALID) on any mismatch —
    the caller must clear its cache so its next request advertises no base
    and receives a full snapshot."""
    import dataclasses

    if base is None:
        raise WireError(ErrCode.INVALID, "quorum delta without a cached base")
    if base_digest is None:
        base_digest = quorum_digest(base)
    if base_digest != delta.base_digest:
        raise WireError(
            ErrCode.INVALID,
            f"quorum delta base digest mismatch "
            f"(have {base_digest:#x}, delta wants {delta.base_digest:#x})",
        )
    parts = list(base.participants)
    for idx, step, cf in delta.step_updates:
        if idx >= len(parts):
            raise WireError(
                ErrCode.INVALID,
                f"quorum delta step update index {idx} out of range "
                f"({len(parts)} base participants)",
            )
        parts[idx] = dataclasses.replace(
            parts[idx], step=step, commit_failures=cf
        )
    by_id = {m.replica_id: m for m in parts}
    for rid in delta.removed:
        by_id.pop(rid, None)
    for m in delta.upserts:
        by_id[m.replica_id] = m
    spares_by_id = {s.replica_id: s for s in base.spares}
    for rid in delta.spare_removed:
        spares_by_id.pop(rid, None)
    for s in delta.spare_upserts:
        spares_by_id[s.replica_id] = s
    out = Quorum(
        quorum_id=delta.quorum_id,
        created=delta.created,
        participants=sorted(by_id.values(), key=lambda m: m.replica_id),
        spares=sorted(spares_by_id.values(), key=lambda m: m.replica_id),
    )
    if quorum_digest(out) != delta.new_digest:
        raise WireError(
            ErrCode.INVALID,
            "quorum delta digest mismatch after apply (divergent base)",
        )
    return out


@dataclass
class ManagerQuorumResult:
    """Per-rank quorum view computed by the manager server.

    Mirrors ``ManagerQuorumResponse`` (``proto/torchft.proto:84-100``) and the
    pyo3 ``QuorumResult`` (``src/lib.rs:284-319``): the deterministic
    replica_rank, recovery source/destinations, the primary store address for
    communicator rendezvous, and max-step participation facts.
    """

    quorum_id: int = 0
    replica_rank: int = 0
    replica_world_size: int = 1
    recover_src_manager_address: str = ""
    recover_src_replica_rank: Optional[int] = None
    recover_dst_replica_ranks: List[int] = field(default_factory=list)
    store_address: str = ""
    max_step: int = 0
    max_replica_rank: Optional[int] = None
    max_world_size: int = 1
    heal: bool = False
    commit_failures: int = 0
    replica_ids: List[str] = field(default_factory=list)
    # -- v2 (striped healing) ------------------------------------------------
    # Canonical ascending list of every max-step replica rank able to serve a
    # heal, with matching manager addresses.  The ORDER is load-bearing: the
    # CommTransport chunk assignment is `chunk_idx % len(sources)` against
    # this exact list on both the sending and healing side.  Empty on v1
    # peers and when nobody is recovering.
    recover_src_replica_ranks: List[int] = field(default_factory=list)
    recover_src_manager_addresses: List[str] = field(default_factory=list)
    # Every recovering replica rank (the union of all sources' recover_dst
    # assignments) so EVERY healthy peer — not just the round-robin primary —
    # stages/serves its checkpoint for a striped heal.
    all_recover_dst_replica_ranks: List[int] = field(default_factory=list)
    # -- v3 (hot spares) -----------------------------------------------------
    # True when THIS replica is a registered spare of the quorum (not a
    # participant): it must warm, not train.  ``spare_replica_ids`` lists
    # the registered spares (actives use it to keep a warm snapshot
    # staged); ``all_manager_addresses`` aligns with ``replica_ids`` so a
    # spare can reach every participant's manager for warm fetches and the
    # outer-delta feed.  Emitted only when spare content exists — a
    # spare-free fleet stays byte-for-byte on the v2 layout.
    is_spare: bool = False
    spare_replica_ids: List[str] = field(default_factory=list)
    all_manager_addresses: List[str] = field(default_factory=list)
    # -- v5 (degraded-mode capacity) -----------------------------------------
    # Per-participant capacity fractions aligned with ``replica_ids`` so
    # every rank can rescale its data shard and weight the outer reduce.
    # Emitted only when some participant is actually degraded — a
    # full-capacity fleet stays byte-for-byte on the v4 layout.
    participant_capacities: List[float] = field(default_factory=list)

    def heal_sources(self) -> List[Tuple[int, str]]:
        """(replica_rank, manager_address) of every peer able to serve this
        replica's heal, canonical order; falls back to the single v1
        recover_src when the v2 fields are absent."""
        if self.recover_src_replica_ranks:
            return list(
                zip(self.recover_src_replica_ranks, self.recover_src_manager_addresses)
            )
        if self.recover_src_replica_rank is not None:
            return [(self.recover_src_replica_rank, self.recover_src_manager_address)]
        return []

    def encode(self, w: Writer) -> None:
        w.i64(self.quorum_id)
        w.i64(self.replica_rank)
        w.i64(self.replica_world_size)
        w.string(self.recover_src_manager_address)
        w.opt_i64(self.recover_src_replica_rank)
        w.u32(len(self.recover_dst_replica_ranks))
        for rank in self.recover_dst_replica_ranks:
            w.i64(rank)
        w.string(self.store_address)
        w.i64(self.max_step)
        w.opt_i64(self.max_replica_rank)
        w.i64(self.max_world_size)
        w.boolean(self.heal)
        w.i64(self.commit_failures)
        w.u32(len(self.replica_ids))
        for rid in self.replica_ids:
            w.string(rid)
        wire_version = manager_quorum_wire_version()
        has_capacity_tail = wire_version >= 5 and any(
            c != 1.0 for c in self.participant_capacities
        )
        has_spare_tail = wire_version >= 3 and (
            self.is_spare or bool(self.spare_replica_ids) or has_capacity_tail
        )
        if wire_version >= 2:
            w.u32(
                5 if has_capacity_tail else 3 if has_spare_tail else 2
            )
            w.u32(len(self.recover_src_replica_ranks))
            for rank in self.recover_src_replica_ranks:
                w.i64(rank)
            w.u32(len(self.recover_src_manager_addresses))
            for addr in self.recover_src_manager_addresses:
                w.string(addr)
            w.u32(len(self.all_recover_dst_replica_ranks))
            for rank in self.all_recover_dst_replica_ranks:
                w.i64(rank)
        if has_spare_tail:
            w.boolean(self.is_spare)
            w.u32(len(self.spare_replica_ids))
            for rid in self.spare_replica_ids:
                w.string(rid)
            w.u32(len(self.all_manager_addresses))
            for addr in self.all_manager_addresses:
                w.string(addr)
        if has_capacity_tail:
            w.u32(len(self.participant_capacities))
            for cap in self.participant_capacities:
                w.f64(cap)

    @staticmethod
    def decode(r: Reader) -> "ManagerQuorumResult":
        out = ManagerQuorumResult()
        out.quorum_id = r.i64()
        out.replica_rank = r.i64()
        out.replica_world_size = r.i64()
        out.recover_src_manager_address = r.string()
        out.recover_src_replica_rank = r.opt_i64()
        out.recover_dst_replica_ranks = [r.i64() for _ in range(r.u32())]
        out.store_address = r.string()
        out.max_step = r.i64()
        out.max_replica_rank = r.opt_i64()
        out.max_world_size = r.i64()
        out.heal = r.boolean()
        out.commit_failures = r.i64()
        out.replica_ids = [r.string() for _ in range(r.u32())]
        if not r.done():
            tail_version = r.u32()
            if tail_version >= 2:
                out.recover_src_replica_ranks = [
                    r.i64() for _ in range(r.u32())
                ]
                out.recover_src_manager_addresses = [
                    r.string() for _ in range(r.u32())
                ]
                out.all_recover_dst_replica_ranks = [
                    r.i64() for _ in range(r.u32())
                ]
            if tail_version >= 3:
                out.is_spare = r.boolean()
                out.spare_replica_ids = [r.string() for _ in range(r.u32())]
                out.all_manager_addresses = [
                    r.string() for _ in range(r.u32())
                ]
            if tail_version >= 5:
                out.participant_capacities = [
                    r.f64() for _ in range(r.u32())
                ]
        return out


# ---------------------------------------------------------------------------
# Socket framing helpers
# ---------------------------------------------------------------------------


def send_frame(sock: socket.socket, msg_type: int, payload: bytes = b"") -> None:
    header = struct.pack("<IB", len(payload) + 1, msg_type)
    sock.sendall(header + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining > 0:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise ConnectionError("connection closed mid-frame")
        chunks.append(chunk)
        remaining -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> tuple[int, Reader]:
    """Receive one frame, returning (msg_type, body reader).

    Raises ``ConnectionError`` on EOF and ``socket.timeout`` on socket
    timeouts (callers translate to ``TimeoutError``).
    """
    (length,) = struct.unpack("<I", _recv_exact(sock, 4))
    if length < 1 or length > MAX_FRAME_BYTES:
        raise WireError(ErrCode.INVALID, f"bad frame length {length}")
    body = _recv_exact(sock, length)
    return body[0], Reader(body[1:])


def send_error(sock: socket.socket, code: ErrCode, msg: str) -> None:
    send_frame(sock, MsgType.ERROR, Writer().u8(int(code)).string(msg).payload())


def raise_if_error(msg_type: int, r: Reader) -> None:
    """Translate an ERROR frame into the appropriate Python exception."""
    if msg_type != MsgType.ERROR:
        return
    code = ErrCode(r.u8())
    msg = r.string()
    if code == ErrCode.TIMEOUT:
        raise TimeoutError(msg)
    raise WireError(code, msg)


def read_http_path(sock: socket.socket, timeout: float = 5.0) -> Optional[str]:
    """Read one HTTP request head off ``sock`` and return its path (None
    when the peer closes before a full head arrives).  Shared by the
    lighthouse dashboard and the ManagerServer /metrics endpoint — both
    sniff HTTP off their framed-RPC ports."""
    sock.settimeout(timeout)
    data = b""
    while b"\r\n\r\n" not in data:
        chunk = sock.recv(4096)
        if not chunk:
            return None
        data += chunk
    request_line = data.split(b"\r\n", 1)[0].decode("latin-1")
    parts = request_line.split()
    return parts[1] if len(parts) >= 2 else "/"


def send_http_response(
    sock: socket.socket, status: str, ctype: str, body: bytes
) -> None:
    """One complete connection-close HTTP response (best-effort: a dead
    client must not raise into the serving loop)."""
    resp = (
        f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
    ).encode() + body
    try:
        sock.sendall(resp)
    except OSError:
        pass


def create_listener(bind: str, backlog: int = 512) -> socket.socket:
    """Bound+listening server socket from a ``host:port`` string, dual-stack
    where possible (the reference binds ``[::]`` with v6only off so one
    socket serves both families, ``torchft/http.py:11-13``).

    ``0.0.0.0`` / ``[::]`` / empty host → wildcard dual-stack (falls back to
    IPv4-only on kernels without IPv6); an explicit IPv6 literal (in
    brackets) or any address that resolves to v6 binds AF_INET6; everything
    else AF_INET."""
    raw_host, _, port_str = bind.rpartition(":")
    host = raw_host.strip("[]")
    port = int(port_str)
    wildcard = host in ("", "0.0.0.0", "::")
    candidates = []
    if wildcard:
        candidates.append((socket.AF_INET6, "::", True))
        candidates.append((socket.AF_INET, "0.0.0.0", False))
    else:
        try:
            infos = socket.getaddrinfo(
                host, port, type=socket.SOCK_STREAM, flags=socket.AI_PASSIVE
            )
        except socket.gaierror:
            infos = [(socket.AF_INET, None, None, None, (host, port))]
        # v4 results first: a hostname like "localhost" resolving to ::1
        # first must not silently become a v6-only listener that refuses
        # the v4 clients it served before (an explicit [v6] literal still
        # resolves to AF_INET6 only)
        infos = sorted(infos, key=lambda i: i[0] != socket.AF_INET)
        for family, *_rest, sockaddr in infos:
            candidates.append((family, sockaddr[0], False))
    last_err: Optional[OSError] = None
    for family, bind_host, dual in candidates:
        sock = socket.socket(family, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if dual and hasattr(socket, "IPV6_V6ONLY"):
                # dual-stack: one wildcard socket accepts v4-mapped peers too
                sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0)
            sock.bind((bind_host, port))
            sock.listen(backlog)
            return sock
        except OSError as e:
            last_err = e
            sock.close()
    raise last_err if last_err else OSError(f"cannot bind {bind!r}")


def connect(addr: str, timeout: float, retries: Optional[int] = None) -> socket.socket:
    """Dial ``host:port`` with a connect deadline and bounded jittered
    retry (the reference's channel helper retries with exponential backoff
    and HTTP2 keepalives, ``src/net.rs:16-42``; TCP keepalive serves the
    same dead-server-detection role here).

    A refused/unreachable dial is retried up to ``retries`` times
    (``TORCHFT_CONNECT_RETRIES``, default 3) with jittered exponential
    backoff, never exceeding the overall ``timeout`` budget — so a replica
    racing a restarting lighthouse/store rides out the restart instead of
    dying at dial time."""
    host, port_str = addr.rsplit(":", 1)
    host = host.strip("[]")
    if retries is None:
        from torchft_tpu_torch import knobs

        retries = knobs.get_int(CONNECT_RETRIES_ENV, _CONNECT_RETRIES_DEFAULT)
    deadline = time.monotonic() + timeout
    attempt = 0
    while True:
        remaining = deadline - time.monotonic()
        try:
            sock = socket.create_connection(
                (host, int(port_str)), timeout=max(0.05, remaining)
            )
            break
        except OSError:
            attempt += 1
            backoff = (
                _CONNECT_BACKOFF_BASE_S
                * (2 ** (attempt - 1))
                * (0.5 + random.random())
            )
            if attempt > retries or time.monotonic() + backoff >= deadline:
                raise
            time.sleep(backoff)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
    return sock


def configure_server_socket(conn: socket.socket) -> None:
    """Options for server-accepted connections: keepalive mirrors connect()
    so a silently-dead peer can't park a handler thread forever."""
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)


class RpcClient:
    """Single-socket request/response client with reconnect-on-timeout.

    Shared base for the store / lighthouse / manager clients.  After a
    client-side timeout the server's late response may still arrive; reusing
    the socket would mispair it with the next rpc, so the socket is dropped
    and re-dialed on the next call.  ``headroom_s`` keeps the client deadline
    behind the server-honored deadline so the server's TIMEOUT error frame
    (the analog of honoring ``grpc-timeout`` server-side) wins the race.
    """

    def __init__(
        self, addr: str, connect_timeout: float, headroom_s: float = 5.0
    ) -> None:
        import threading

        self._addr = addr
        self._connect_timeout = connect_timeout
        self._headroom_s = headroom_s
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = connect(addr, connect_timeout)

    @property
    def addr(self) -> str:
        return self._addr

    def _drop_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def call(
        self,
        msg_type: int,
        payload: bytes,
        timeout: float,
        idempotent: bool = False,
    ) -> tuple[int, Reader]:
        """One rpc round-trip; raises ``TimeoutError`` on deadline and drops
        the socket on any transport fault.

        ``idempotent=True`` grants ONE bounded reconnect-retry after a
        transport fault (reset/refused — never a timeout, which may mean
        the server acted): safe only for rpcs whose re-execution is
        harmless (heartbeat, status, store get/exists), and exactly what
        keeps a replica alive through a lighthouse connection blip."""
        # The three blocking-under-lock pragmas below share one reason: this
        # lock EXISTS to serialize the single-connection round-trip (one
        # outstanding rpc per client), every call sets a socket deadline
        # first, and interrupt() closes the socket from another thread to
        # sever a wedged call — the lock is never held indefinitely.
        with self._lock:
            attempts = 2 if idempotent else 1
            for attempt in range(attempts):
                if self._sock is None:
                    # ftlint: ignore[blocking-under-lock] — see above
                    self._sock = connect(self._addr, self._connect_timeout)
                self._sock.settimeout(timeout + self._headroom_s)
                try:
                    # ftlint: ignore[blocking-under-lock] — see above
                    send_frame(self._sock, msg_type, payload)
                    return recv_frame(self._sock)  # ftlint: ignore[blocking-under-lock] — see above
                except socket.timeout as e:
                    self._drop_socket()
                    raise TimeoutError(
                        f"rpc 0x{msg_type:x} to {self._addr} timed out"
                    ) from e
                except WireError:
                    self._drop_socket()
                    raise
                except (ConnectionError, OSError):
                    self._drop_socket()
                    if attempt + 1 >= attempts:
                        raise
            raise AssertionError("unreachable")  # pragma: no cover

    def interrupt(self) -> None:
        """Sever the live socket WITHOUT taking the rpc lock: a call parked
        in recv on another thread errors out immediately instead of waiting
        its full deadline.  Used when the caller KNOWS the server went away
        and came back (e.g. a lighthouse restart detected by the heartbeat
        loop); the interrupted call's error path drops and re-dials."""
        sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            self._drop_socket()
