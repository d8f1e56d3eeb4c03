"""Streaming serialization for pytrees of torch tensors and numpy arrays.

The reference streams ``torch.save``-serialized state dicts
(``torchft/checkpointing/_serialization.py:14-39``); here the state is an
arbitrary pytree whose array leaves are torch tensors or numpy arrays.  The
format separates the (pickled) tree skeleton from raw array payloads so
multi-MB tensors stream as straight buffer copies with no pickle overhead:

``TFTC`` magic + version, skeleton (pickle with array leaves replaced by
placeholders), then per-array: dtype tag, shape, raw little-endian bytes.

Like the reference (which pickles tensor metadata over its transports,
``pg_transport.py:32-146``), the skeleton uses pickle and therefore assumes
the same trust model: checkpoint peers are other replicas of the same job
inside the cluster, never untrusted parties.

Tensors are copied to host a chunk at a time on save and every array leaf
comes back as a CPU torch tensor on load; a DTensor leaf (a parameter or
optimizer moment sharded inside a replica group) ships this rank's local
shard and comes back as a :class:`ShardedHostArray` — the consumer decides placement
(``load_state_dict`` of a module or optimizer copies each into the live
tensor on its device).
Dtypes travel by name (``float32``, ``bfloat16``, …) and rebuild through
torch alone, so bfloat16 needs no numpy extension dtype on either side.
"""

from __future__ import annotations

import bisect
import contextlib
import hashlib
import io
import os
import pickle
import queue
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.obs.spans import span as obs_span

MAGIC = b"TFTC\x01"

# Top-level packages whose classes a JAX-package snapshot's skeleton names
# (its ``_ArrayPlaceholder`` lives in ``torchft_tpu``).  The skeleton
# unpickler refuses them by name, before anything is imported.
_FOREIGN_PACKAGES = ("torchft_tpu", "jax", "jaxlib", "ml_dtypes")

# Target striped-heal chunk size.  Smaller chunks stripe/steal at finer
# granularity (better load balance, cheaper mid-heal failover) at the cost
# of more requests/frames; the default keeps per-chunk overhead <1% on
# multi-MB transfers.
HEAL_CHUNK_MB_ENV = "TORCHFT_HEAL_CHUNK_MB"
DEFAULT_HEAL_CHUNK_BYTES = 4 << 20

# save_pytree's unit of staging: a leaf moves to host in chunks of this
# many bytes (the last one of a leaf shorter), and a digest takes each
CHUNK_BYTES = 64 << 20
# chunks staged ahead of the slowest consumer: the pinned ring a save of a
# CUDA state holds (RING_CHUNKS * CHUNK_BYTES = 512 MiB)
RING_CHUNKS = 8

# A heal's sender stages each CUDA leaf to the host in chunks of
# SEND_SLOT_BYTES through a StagingRing of SEND_RING_SLOTS pinned buffers;
# every request being served (an HTTP range, a comm stream) has a ring of
# its own, so its peak extra host memory is SEND_RING_SLOTS * SEND_SLOT_BYTES
# (64 MiB), not a leaf
SEND_SLOT_BYTES = 16 << 20
SEND_RING_SLOTS = 4


def heal_chunk_bytes() -> int:
    mb = os.environ.get(HEAL_CHUNK_MB_ENV)
    if mb:
        return max(1 << 16, int(float(mb) * (1 << 20)))
    return DEFAULT_HEAL_CHUNK_BYTES


def chunk_ranges(
    header_len: int, leaf_nbytes: List[int], target_bytes: int
) -> List[Tuple[int, int]]:
    """Deterministic chunk boundaries over the serialized stream.

    The stream is a sequence of units — the header, then one (8-byte length
    + payload) per array.  Whole units pack greedily up to ``target_bytes``;
    a unit larger than the target splits at target granularity from its own
    start.  Boundaries are therefore a pure function of the tree structure
    and leaf sizes, so every peer holding the same state at the same step
    produces the SAME ranges over byte-identical content — the property that
    lets a healer assemble one buffer from many peers' streams.
    """
    target = max(1, int(target_bytes))
    units = [header_len] + [8 + n for n in leaf_nbytes]
    chunks: List[Tuple[int, int]] = []
    off = 0
    cur_start = 0
    cur = 0  # bytes accumulated in the open chunk
    for unit in units:
        if unit > target:
            if cur:
                chunks.append((cur_start, off))
            start = off
            while start < off + unit:
                stop = min(off + unit, start + target)
                chunks.append((start, stop))
                start = stop
            off += unit
            cur_start, cur = off, 0
            continue
        off += unit
        cur += unit
        if cur >= target:
            chunks.append((cur_start, off))
            cur_start, cur = off, 0
    if cur:
        chunks.append((cur_start, off))
    return chunks


def as_byte_view(arr: np.ndarray) -> memoryview:
    """Raw little-endian bytes of a contiguous array; works for extension
    dtypes (bfloat16, fp8) that reject ``memoryview.cast``."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _resolve_dtype(name: str) -> torch.dtype:
    """Torch dtype for a wire dtype name.  numpy and torch share the names
    of every dtype a state dict carries (``float32``, ``int64``, ``bool``,
    ``bfloat16``, ``float8_e4m3fn``), so a raw 16-bit bfloat16 payload
    lands in a ``torch.bfloat16`` tensor with no extension dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unsupported checkpoint dtype {name!r}")
    return dtype


def _dtype_name(dtype: Any) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _tensor_bytes(t: torch.Tensor) -> np.ndarray:
    """Flat uint8 view of a contiguous CPU tensor's bytes (any dtype)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


@dataclass
class _ArrayPlaceholder:
    index: int
    dtype: str
    shape: Tuple[int, ...]


def _is_array_leaf(x: Any) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard_layout(t: Any) -> Tuple:
    """What a DTensor's local shard covers: its mesh's axis names and
    shape, its placements and this rank's coordinate on the mesh.  Two
    ranks whose layouts are equal hold the same region of the tensor."""
    mesh = t.device_mesh
    return (
        tuple(mesh.mesh_dim_names or ()),
        tuple(mesh.mesh.shape),
        tuple(str(p) for p in t.placements),
        tuple(mesh.get_coordinate() or ()),
    )


class HealLayoutError(ValueError):
    """A sharded leaf arrived from a source whose layout (mesh, placements
    or this rank's coordinate) differs from the healing rank's, e.g. a
    degraded peer: its local shard covers another region, and the heal
    refuses it rather than load the wrong elements."""


@dataclass
class _ShardedArrayPlaceholder:
    """Skeleton marker for a DTensor: this rank's local shard rides as one
    payload array, with the global shape, the dtype and the layout."""

    shape: Tuple[int, ...]
    dtype: str
    layout: Tuple
    entry: _ArrayPlaceholder


@dataclass
class ShardedHostArray:
    """Host-side form of a DTensor leaf from a healing checkpoint: the
    sender rank's local shard (a CPU tensor) with the global shape and its
    layout.  ``ddp.restore_like`` writes it into the local shard of an
    existing DTensor — rank r of the healing group loads from rank r of
    the source, which hold the same region when the meshes are equal."""

    shape: Tuple[int, ...]
    dtype: str
    layout: Tuple
    local: torch.Tensor

    def check_layout(self, like: Any) -> None:
        """Raise :class:`HealLayoutError` unless ``like`` (a DTensor) has
        this leaf's global shape and layout."""
        want = (tuple(like.shape), shard_layout(like))
        if (tuple(self.shape), tuple(self.layout)) != want:
            raise HealLayoutError(
                f"heal source shard layout {self.layout} of a {self.shape} tensor differs "
                f"from this rank's {want[1]} of {want[0]}: a heal between groups of "
                "different layouts (e.g. a degraded peer) is not supported"
            )


def materialize_leaf(leaf: Any) -> np.ndarray:
    """Host bytes of a collected leaf: numpy arrays as they are, tensors as
    a flat uint8 view of a host copy (device tensors are copied to host
    here, NOT at extraction time — the point of the lazy plan is that only
    one leaf's host copy is ever live during a streaming send)."""
    if isinstance(leaf, np.ndarray):
        return leaf
    return _tensor_bytes(leaf.detach().cpu())


class StagingRing:
    """Byte ranges of leaves brought to the host through a ring of reused
    buffers, a copier thread ahead of the consumer.

    :meth:`chunks` takes pieces ``(source, lo, hi)`` in order.  A host
    source (a memoryview) passes through as it is; a tensor source (a flat
    uint8 tensor: a CUDA leaf's bytes) is copied ``slot_bytes`` at a time
    into the ring's slots, pinned when the source is on the card.  Each
    chunk comes out as ``(view, release)``: the consumer calls ``release()``
    once every write that reads ``view`` is done, and only then does the
    copier refill that slot.  A consumer must hold fewer than ``slots``
    unreleased chunks when it asks for the next one.  A pinned allocation
    that fails raises; nothing falls back to pageable memory.  The copies'
    seconds add up in ``copy_s`` and, under ``copy_span``, in
    ``obs.spans``."""

    def __init__(self, slots: Optional[int] = None, slot_bytes: Optional[int] = None,
                 copy_span: str = "heal::send_copy") -> None:
        self.slots = slots or SEND_RING_SLOTS
        self.slot_bytes = slot_bytes or SEND_SLOT_BYTES
        self.copy_span = copy_span
        self.copy_s = 0.0
        self._copy_s_lock = threading.Lock()
        self._bufs: List[Optional[torch.Tensor]] = [None] * self.slots

    def _slot(self, i: int, pin: bool) -> torch.Tensor:
        buf = self._bufs[i]
        if buf is None or buf.is_pinned() != pin:
            buf = self._bufs[i] = torch.empty(self.slot_bytes, dtype=torch.uint8, pin_memory=pin)
        return buf

    def chunks(
        self, pieces: Iterable[Tuple[Any, int, int]]
    ) -> Iterator[Tuple[memoryview, Callable[[], None]]]:
        free: "queue.Queue[int]" = queue.Queue()
        for i in range(self.slots):
            free.put(i)
        ready: "queue.Queue[Any]" = queue.Queue()
        stop = threading.Event()

        def _noop() -> None:
            pass

        def _copy() -> None:
            try:
                for src, lo, hi in pieces:
                    if not isinstance(src, torch.Tensor):
                        ready.put((memoryview(src)[lo:hi], _noop))
                        continue
                    for off in range(lo, hi, self.slot_bytes):
                        i = free.get()
                        if stop.is_set():
                            return
                        n = min(self.slot_bytes, hi - off)
                        t0 = time.perf_counter()
                        with obs_span(self.copy_span):
                            staged = self._slot(i, src.is_cuda)[:n]
                            staged.copy_(src[off : off + n])
                        with self._copy_s_lock:
                            self.copy_s += time.perf_counter() - t0
                        ready.put((memoryview(staged.numpy()), lambda i=i: free.put(i)))
            except BaseException as e:  # noqa: BLE001 — raised on the consumer
                ready.put(e)
            else:
                ready.put(None)

        copier = threading.Thread(target=_copy, name="tpuft_heal_stage", daemon=True)
        copier.start()
        try:
            while True:
                item = ready.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            free.put(-1)  # wakes a copier waiting for a slot
            copier.join()


def _leaf_meta(leaf: Any) -> Tuple[str, Tuple[int, ...]]:
    """(dtype name, shape) without materializing the leaf on host."""
    return _dtype_name(leaf.dtype), tuple(leaf.shape)


def _extract_arrays(obj: Any, arrays: List[Any]) -> Any:
    """Deep-copy the container skeleton, swapping array leaves for
    placeholders (handles dict/list/tuple; other types pickle as-is).

    ``arrays`` collects the RAW leaves (numpy arrays, torch tensors on any
    device) — call :func:`materialize_leaf` to get host bytes for one.  A
    DTensor contributes its local shard, with its global shape and layout
    (:class:`_ShardedArrayPlaceholder`)."""
    if isinstance(obj, torch.Tensor) and _is_dtensor(obj):
        local = obj.to_local()
        dtype_name, local_shape = _leaf_meta(local)
        entry = _ArrayPlaceholder(index=len(arrays), dtype=dtype_name, shape=local_shape)
        arrays.append(local)
        return _ShardedArrayPlaceholder(
            shape=tuple(obj.shape), dtype=dtype_name, layout=shard_layout(obj), entry=entry
        )
    if _is_array_leaf(obj):
        # dtype.name (not .str) so extension dtypes like bfloat16 round-trip
        dtype_name, shape = _leaf_meta(obj)
        placeholder = _ArrayPlaceholder(
            index=len(arrays), dtype=dtype_name, shape=shape
        )
        arrays.append(obj)
        return placeholder
    if isinstance(obj, dict):
        return {k: _extract_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        mapped = [_extract_arrays(v, arrays) for v in obj]
        if isinstance(obj, list):
            return mapped
        # preserve NamedTuple types
        if hasattr(obj, "_fields"):
            return type(obj)(*mapped)
        return tuple(mapped)
    return obj


def _restore_arrays(obj: Any, arrays: List[Any]) -> Any:
    if isinstance(obj, _ArrayPlaceholder):
        return arrays[obj.index]
    if isinstance(obj, _ShardedArrayPlaceholder):
        return ShardedHostArray(
            shape=obj.shape, dtype=obj.dtype, layout=obj.layout, local=arrays[obj.entry.index]
        )
    if isinstance(obj, dict):
        return {k: _restore_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        mapped = [_restore_arrays(v, arrays) for v in obj]
        if isinstance(obj, list):
            return mapped
        if hasattr(obj, "_fields"):
            return type(obj)(*mapped)
        return tuple(mapped)
    return obj


@dataclass
class PytreePlan:
    """Serialization plan: everything needed to stream a pytree without
    bringing more than a ring of chunks of it to the host at a time.

    ``header`` is the byte prefix (magic + skeleton + array count); each
    leaf then rides as an 8-byte length + raw bytes.  ``total_len`` lets a
    server send Content-Length before generating a byte of payload."""

    header: bytes
    leaves: List[Any]
    leaf_nbytes: List[int]
    total_len: int
    # one-leaf host memo of _materialize (a warm snapshot's crc pass reads
    # every chunk of a leaf in turn); write_range stages through a ring
    _memo: Optional[Tuple[int, np.ndarray]] = None
    _memo_lock: threading.Lock = field(default_factory=threading.Lock)

    def header_digest(self) -> str:
        """Digest of the byte prefix (magic + skeleton + count).  Striped
        healers compare it across sources: peers serving the same step must
        agree byte-for-byte or assembling one buffer from many streams would
        silently corrupt."""
        return hashlib.sha256(self.header).hexdigest()

    def chunk_ranges(
        self, target_bytes: Optional[int] = None
    ) -> List[Tuple[int, int]]:
        return chunk_ranges(
            len(self.header), self.leaf_nbytes, target_bytes or heal_chunk_bytes()
        )

    def _materialize(self, index: int) -> np.ndarray:
        with self._memo_lock:
            if self._memo is not None and self._memo[0] == index:
                return self._memo[1]
        with obs_span("heal::send_copy"):
            arr = materialize_leaf(self.leaves[index])
        with self._memo_lock:
            self._memo = (index, arr)
        return arr

    def write_range(self, start: int, stop: int, stream: BinaryIO) -> None:
        """Stream bytes [start, stop) of the serialized form (chunked HTTP
        fetches): only the leaves that overlap the range are read, a CUDA
        leaf through a :class:`StagingRing` of this call's own."""
        pieces: List[Tuple[Any, int, int]] = []
        off = 0

        def _add(source: Any, n: int) -> None:
            nonlocal off
            lo, hi = max(start, off), min(stop, off + n)
            if lo < hi:
                pieces.append((source, lo - off, hi - off))
            off += n

        _add(self.header, len(self.header))
        for i, nbytes in enumerate(self.leaf_nbytes):
            if off + 8 + nbytes <= start:
                off += 8 + nbytes  # fully before the range: skip cheaply
                continue
            if off >= stop:
                break
            _add(struct.pack("<Q", nbytes), 8)
            if off + nbytes <= start:
                off += nbytes
                continue
            _add(i, nbytes)

        def _sources() -> Iterator[Tuple[Any, int, int]]:
            # a leaf (by index) is looked up as the copier reaches it
            for source, lo, hi in pieces:
                yield (_leaf_source(self.leaves[source]) if isinstance(source, int)
                       else source), lo, hi

        with contextlib.closing(StagingRing().chunks(_sources())) as staged:
            for view, release in staged:
                with obs_span("heal::send_write"):
                    stream.write(view)
                release()


def _snapshot_leaf(leaf: Any) -> Any:
    """Point-in-time snapshot of one collected leaf without bringing it to
    host: numpy copies on host; tensors ``clone()`` on their own device
    (device-to-device for CUDA) — the optimizer updates parameters in place,
    so a mere reference would change under a peer still fetching it."""
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf.detach().clone()


def plan_pytree(state: Any, snapshot: bool = False) -> PytreePlan:
    """Build the streaming plan for ``state``.

    ``snapshot`` makes the plan a point-in-time checkpoint that stays valid
    while training continues: numpy leaves are host-copied, tensors are
    cloned on their device (see :func:`_snapshot_leaf`); host bytes still materialize
    one leaf at a time during streaming."""
    arrays: List[Any] = []
    skeleton = _extract_arrays(state, arrays)
    if snapshot:
        arrays = [_snapshot_leaf(a) for a in arrays]
    payload = pickle.dumps(skeleton, protocol=pickle.HIGHEST_PROTOCOL)
    header = (
        MAGIC
        + struct.pack("<I", len(payload))
        + payload
        + struct.pack("<I", len(arrays))
    )
    leaf_nbytes = []
    for leaf in arrays:
        dtype_name, shape = _leaf_meta(leaf)
        nbytes = _resolve_dtype(dtype_name).itemsize
        for d in shape:
            nbytes *= d
        leaf_nbytes.append(nbytes)
    total = len(header) + sum(8 + n for n in leaf_nbytes)
    return PytreePlan(
        header=header, leaves=arrays, leaf_nbytes=leaf_nbytes, total_len=total
    )


def _leaf_source(leaf: Any) -> Any:
    """A leaf's bytes as something sliceable into chunks: a flat uint8
    tensor on the card for a plain CUDA tensor (staged chunk by chunk),
    else a host byte view (copied to host whole, as a heal does)."""
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        return leaf.detach().contiguous().view(-1).view(torch.uint8)
    return as_byte_view(materialize_leaf(leaf))


def save_pytree(
    state: Any, stream: Optional[BinaryIO] = None, digest: Any = None
) -> Dict[str, float]:
    """Stream-serialize ``state``: the header, then each leaf's 8-byte
    length and bytes.  Leaves move to host in :data:`CHUNK_BYTES` chunks,
    in order, through a :class:`StagingRing` of :data:`RING_CHUNKS`
    buffers (pinned for a CUDA tensor, which copies several times faster
    than a pageable copy; peak extra host RSS: the ring, or one leaf of a
    host state), while a writer thread writes the chunks before them to
    ``stream``.  ``digest``, if given, takes every chunk of every leaf
    (``digest.submit(view) -> futures``, done before the view is reused,
    as :class:`~torchft_tpu_torch.utils.checkpoint.ChunkDigest` does);
    with no ``stream`` nothing is written and the leaves are only hashed.
    Returns the busy seconds of the copies (``host_copy_s``) and of the
    writes (``write_s``); they overlap."""
    plan = plan_pytree(state)
    busy = {"host_copy_s": 0.0, "write_s": 0.0}

    def _write(data: Any) -> None:
        t0 = time.perf_counter()
        stream.write(data)
        busy["write_s"] += time.perf_counter() - t0  # the writer thread alone

    def _pieces() -> Iterator[Tuple[Any, int, int]]:
        # one piece a chunk of each leaf (an empty leaf: one empty chunk),
        # each leaf's bytes looked up as its turn comes
        for leaf, nbytes in zip(plan.leaves, plan.leaf_nbytes):
            src = _leaf_source(leaf)
            if len(src) != nbytes:
                raise ValueError(f"leaf changed size while saving: {len(src)} != {nbytes}")
            for off in range(0, max(nbytes, 1), CHUNK_BYTES):
                yield (src if nbytes else memoryview(b"")), off, min(off + CHUNK_BYTES, nbytes)

    # beside each chunk, the leaf's length where it is the leaf's first
    firsts = [nbytes if off == 0 else None for nbytes in plan.leaf_nbytes
              for off in range(0, max(nbytes, 1), CHUNK_BYTES)]
    ring = StagingRing(RING_CHUNKS, CHUNK_BYTES, copy_span="checkpoint::host_copy")
    writer = ThreadPoolExecutor(1, thread_name_prefix="save_pytree") if stream else None
    pending: deque = deque()  # each chunk's futures and its slot's release, oldest first
    try:
        if writer is not None:
            pending.append(([writer.submit(_write, plan.header)], None))
        with contextlib.closing(ring.chunks(_pieces())) as staged:
            for first, (view, release) in zip(firsts, staged):
                futs = []
                if writer is not None:
                    if first is not None:
                        futs.append(writer.submit(_write, struct.pack("<Q", first)))
                    futs.append(writer.submit(_write, view))
                if digest is not None:
                    futs += digest.submit(view)
                pending.append((futs, release))
                while len(pending) >= RING_CHUNKS:  # the ring's slots, all but one held
                    _settle(pending.popleft())
        while pending:
            _settle(pending.popleft())
    finally:
        if writer is not None:
            writer.shutdown(wait=True)
    busy["host_copy_s"] = ring.copy_s
    return busy


def _settle(entry: Tuple[List[Any], Optional[Callable[[], None]]]) -> None:
    """Wait a staged chunk's writes and digests, then free its slot."""
    futs, release = entry
    for fut in futs:
        fut.result()
    if release is not None:
        release()


def _read_exact(stream: BinaryIO, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = stream.read(n - len(out))
        if not chunk:
            raise EOFError("truncated checkpoint stream")
        out += chunk
    return out


class ForeignSnapshotError(ValueError):
    """A snapshot written by the JAX package (``torchft_tpu``): the port
    refuses it by name, and a reader that skips unreadable snapshots must
    not take it for a torn one."""


class _SkeletonUnpickler(pickle.Unpickler):
    """Unpickles a skeleton, refusing any class of the JAX package (and of
    jax, jaxlib, ml_dtypes) without importing it: a snapshot written by
    ``torchft_tpu`` holds that package's placeholders, and a heal across
    the two packages is not supported."""

    def find_class(self, module: str, name: str) -> Any:
        if module.split(".", 1)[0] in _FOREIGN_PACKAGES:
            raise ForeignSnapshotError(
                f"checkpoint skeleton names {module}.{name}: the snapshot was written by "
                "the JAX package (torchft_tpu), and a heal across packages is not supported"
            )
        return super().find_class(module, name)


def _read_header(stream: BinaryIO) -> Tuple[Any, List[_ArrayPlaceholder]]:
    """The skeleton and each array's placeholder, in payload order, from the
    stream's header (magic, skeleton, array count)."""
    magic = _read_exact(stream, len(MAGIC))
    if magic != MAGIC:
        raise ValueError(f"bad checkpoint magic {magic!r}")
    (skel_len,) = struct.unpack("<I", _read_exact(stream, 4))
    skeleton = _SkeletonUnpickler(io.BytesIO(_read_exact(stream, skel_len))).load()
    (narrays,) = struct.unpack("<I", _read_exact(stream, 4))

    placeholders: List[_ArrayPlaceholder] = [None] * narrays  # type: ignore[list-item]

    def _collect(obj: Any) -> None:
        if isinstance(obj, _ArrayPlaceholder):
            placeholders[obj.index] = obj
        elif isinstance(obj, _ShardedArrayPlaceholder):
            placeholders[obj.entry.index] = obj.entry
        elif isinstance(obj, dict):
            for v in obj.values():
                _collect(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                _collect(v)

    _collect(skeleton)
    for i, ph in enumerate(placeholders):
        if ph is None:
            raise ValueError(f"missing placeholder for array {i}")
    return skeleton, placeholders


def header_len_of(prefix: bytes) -> int:
    """The header's length from its first ``len(MAGIC) + 4`` bytes."""
    if prefix[: len(MAGIC)] != MAGIC:
        raise ValueError(f"bad checkpoint magic {prefix[: len(MAGIC)]!r}")
    (skel_len,) = struct.unpack("<I", prefix[len(MAGIC) : len(MAGIC) + 4])
    return len(MAGIC) + 4 + skel_len + 4


def read_into(stream: BinaryIO, view: memoryview) -> None:
    """Exactly ``len(view)`` bytes of ``stream`` into ``view``."""
    read_into_ = getattr(stream, "readinto", None)
    off = 0
    while off < len(view):
        if read_into_ is not None:
            n = read_into_(view[off:])
        else:
            chunk = stream.read(min(1 << 20, len(view) - off))
            n = len(chunk)
            view[off : off + n] = chunk
        if not n:
            raise EOFError("truncated checkpoint stream")
        off += n


# a landing buffer at least this large is mapped with its pages faulted in
# at once (MAP_POPULATE): 5.27 GB/s against 3.70 GB/s for the page faults
# of a first write, on the H100 80GB HBM3 host at 700.00 W
# (scripts/heal_probe.py)
POPULATE_MIN_BYTES = 1 << 20


def populated_empty(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """An uninitialized CPU tensor whose pages are already faulted in (a
    fresh anonymous mapping with ``MAP_POPULATE``; small ones are plain
    ``torch.empty``): a receive lands in it without a page fault."""
    nbytes = dtype.itemsize
    for d in shape:
        nbytes *= d
    if nbytes < POPULATE_MIN_BYTES:
        return torch.empty(shape, dtype=dtype)
    import mmap

    region = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE)
    return torch.frombuffer(region, dtype=torch.uint8).view(dtype).view(shape)


def _landing_arrays(placeholders: List[_ArrayPlaceholder]) -> List[torch.Tensor]:
    with obs_span("heal::recv_land"):
        return [torch.empty(ph.shape, dtype=_resolve_dtype(ph.dtype)) for ph in placeholders]


def load_pytree(stream: BinaryIO, leaf_hook: Any = None) -> Any:
    """Inverse of :func:`save_pytree`, reading payloads straight into
    preallocated arrays (``readinto``, no intermediate copies).

    Every array leaf comes back as a CPU torch tensor.  ``leaf_hook(t) ->
    Any``, if given, maps each tensor right after its bytes arrive — e.g. a
    ``copy_`` into the live parameter on its device — so the host copy of
    each leaf can be dropped as soon as the next one starts arriving
    (in-place-on-arrival heal)."""
    skeleton, placeholders = _read_header(stream)
    arrays: List[Any] = []
    for i, ph in enumerate(placeholders):
        (nbytes,) = struct.unpack("<Q", _read_exact(stream, 8))
        (arr,) = _landing_arrays([ph])
        expected = arr.numel() * arr.element_size()
        if nbytes != expected:
            raise ValueError(
                f"array {i}: payload {nbytes} bytes != expected {expected}"
            )
        with obs_span("heal::recv_read"):
            read_into(stream, memoryview(_tensor_bytes(arr)))
        arrays.append(arr if leaf_hook is None else leaf_hook(arr))

    return _restore_arrays(skeleton, arrays)


class StreamLanding:
    """The serialized stream landed in place from byte ranges read in any
    order, on any threads: the header parsed once, every array allocated
    once, and each range read straight into where its bytes belong (the
    header's copy, a leaf's 8-byte length, a leaf's payload).  Parallel
    range fetches of one heal so land in the arrays the state comes back
    in, with no buffer of the whole stream and no second copy."""

    def __init__(self, header: bytes) -> None:
        stream = io.BytesIO(header)
        self._skeleton, placeholders = _read_header(stream)
        if stream.tell() != len(header):
            raise ValueError("checkpoint header has trailing bytes")
        self._header = header
        self.arrays = _landing_arrays(placeholders)
        self._header_copy = bytearray(len(header))
        self._lengths = [bytearray(8) for _ in self.arrays]
        self._segments: List[Tuple[int, memoryview]] = [(0, memoryview(self._header_copy))]
        off = len(header)
        for length, arr in zip(self._lengths, self.arrays):
            self._segments.append((off, memoryview(length)))
            off += 8
            if arr.numel():
                self._segments.append((off, memoryview(_tensor_bytes(arr))))
                off += arr.numel() * arr.element_size()
        self._starts = [start for start, _ in self._segments]
        self.total_len = off

    def read_range(self, stream: BinaryIO, start: int, stop: int) -> None:
        """Bytes [start, stop) of the serialized stream from ``stream``."""
        if not 0 <= start <= stop <= self.total_len:
            raise ValueError(f"bad range [{start}, {stop}) of {self.total_len}")
        i = bisect.bisect_right(self._starts, start) - 1
        off = start
        while off < stop:
            seg_start, view = self._segments[i]
            hi = min(len(view), stop - seg_start)
            read_into(stream, view[off - seg_start : hi])
            off = seg_start + hi
            i += 1

    def finish(self, leaf_hook: Any = None) -> Any:
        """The state, once every byte of the stream has landed: checks the
        header's copy and each leaf's length, maps each leaf through
        ``leaf_hook`` as :func:`load_pytree` does."""
        if bytes(self._header_copy) != self._header:
            raise ValueError("the ranges of the stream carry another header")
        arrays: List[Any] = []
        for i, (length, arr) in enumerate(zip(self._lengths, self.arrays)):
            (nbytes,) = struct.unpack("<Q", length)
            expected = arr.numel() * arr.element_size()
            if nbytes != expected:
                raise ValueError(f"array {i}: payload {nbytes} bytes != expected {expected}")
            arrays.append(arr if leaf_hook is None else leaf_hook(arr))
        return _restore_arrays(self._skeleton, arrays)


def array_chunk_ranges(
    nbytes_list: List[int], target_bytes: int
) -> List[Tuple[int, int, int]]:
    """Chunk index at RAW array-payload granularity: ``(array_index, start,
    stop)`` byte ranges within each array's buffer, each at most
    ``target_bytes`` long.  Used by the comm-transport striped heal, whose
    chunks land directly in the final (preallocated) array buffers — no
    serialized-stream reassembly pass.  Deterministic given identical array
    metas, which same-step peers share by construction."""
    target = max(1, int(target_bytes))
    out: List[Tuple[int, int, int]] = []
    for ai, n in enumerate(nbytes_list):
        start = 0
        while start < n:
            stop = min(n, start + target)
            out.append((ai, start, stop))
            start = stop
    return out


def balanced_shares(sizes: List[int], num_shares: int) -> List[List[int]]:
    """Deterministic byte-balanced assignment of chunk indices to shares
    (greedy longest-first onto the least-loaded share, ties to the lowest
    index).  Plain ``idx % num_shares`` can hand one source most of the
    bytes when chunk sizes are uneven — the heal then runs at the slowest
    share's pace.  Every peer computes the SAME assignment from the same
    chunk table, which is what lets senders and the healer agree without a
    negotiation round-trip."""
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    loads = [0] * num_shares
    shares: List[List[int]] = [[] for _ in range(num_shares)]
    for i in order:
        target = min(range(num_shares), key=lambda s: (loads[s], s))
        shares[target].append(i)
        loads[target] += sizes[i]
    return [sorted(s) for s in shares]


def dumps_pytree(state: Any) -> bytes:
    buf = io.BytesIO()
    save_pytree(state, buf)
    return buf.getvalue()


def loads_pytree(data: bytes) -> Any:
    return load_pytree(io.BytesIO(data))
