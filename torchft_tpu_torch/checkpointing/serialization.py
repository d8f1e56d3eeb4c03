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

Tensors are copied to host one leaf at a time on save and every array leaf
comes back as a CPU torch tensor on load — the consumer decides placement
(``load_state_dict`` of a module or optimizer copies each into the live
tensor on its device).
Dtypes travel by name (``float32``, ``bfloat16``, …) and rebuild through
torch alone, so bfloat16 needs no numpy extension dtype on either side.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
import struct
import threading
from dataclasses import dataclass, field
from typing import Any, BinaryIO, List, Optional, Tuple

import numpy as np
import torch

MAGIC = b"TFTC\x01"

# Target striped-heal chunk size.  Smaller chunks stripe/steal at finer
# granularity (better load balance, cheaper mid-heal failover) at the cost
# of more requests/frames; the default keeps per-chunk overhead <1% on
# multi-MB transfers.
HEAL_CHUNK_MB_ENV = "TORCHFT_HEAL_CHUNK_MB"
DEFAULT_HEAL_CHUNK_BYTES = 4 << 20


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


def materialize_leaf(leaf: Any) -> np.ndarray:
    """Host bytes of a collected leaf: numpy arrays as they are, tensors as
    a flat uint8 view of a host copy (device tensors are copied to host
    here, NOT at extraction time — the point of the lazy plan is that only
    one leaf's host copy is ever live during a streaming send)."""
    if isinstance(leaf, np.ndarray):
        return leaf
    return _tensor_bytes(leaf.detach().cpu())


def _leaf_meta(leaf: Any) -> Tuple[str, Tuple[int, ...]]:
    """(dtype name, shape) without materializing the leaf on host."""
    return _dtype_name(leaf.dtype), tuple(leaf.shape)


def _extract_arrays(obj: Any, arrays: List[Any]) -> Any:
    """Deep-copy the container skeleton, swapping array leaves for
    placeholders (handles dict/list/tuple; other types pickle as-is).

    ``arrays`` collects the RAW leaves (numpy arrays, torch tensors on any
    device) — call :func:`materialize_leaf` to get host bytes for one."""
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
    materializing more than one leaf on host at a time.

    ``header`` is the byte prefix (magic + skeleton + array count); each
    leaf then rides as an 8-byte length + raw bytes.  ``total_len`` lets a
    server send Content-Length before generating a byte of payload."""

    header: bytes
    leaves: List[Any]
    leaf_nbytes: List[int]
    total_len: int
    # one-leaf D2H memo: several striped range requests cut the same large
    # leaf, and each write_range would otherwise copy the whole leaf to host
    # again; the memo holds the most recent materialization
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
        arr = materialize_leaf(self.leaves[index])
        with self._memo_lock:
            self._memo = (index, arr)
        return arr

    def write_range(self, start: int, stop: int, stream: BinaryIO) -> None:
        """Stream bytes [start, stop) of the serialized form, materializing
        only the leaves that overlap the range (chunked HTTP fetches)."""
        off = 0

        def _emit(chunk) -> None:
            nonlocal off
            n = len(chunk)
            lo, hi = max(start, off), min(stop, off + n)
            if lo < hi:
                stream.write(memoryview(chunk)[lo - off : hi - off])
            off += n

        _emit(self.header)
        for i, nbytes in enumerate(self.leaf_nbytes):
            if off + 8 + nbytes <= start:
                off += 8 + nbytes  # fully before the range: skip cheaply
                continue
            if off >= stop:
                break
            _emit(struct.pack("<Q", nbytes))
            if off + nbytes <= start:
                off += nbytes
                continue
            _emit(as_byte_view(self._materialize(i)))


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


def save_pytree(state: Any, stream: BinaryIO) -> None:
    """Stream-serialize: leaves are materialized to host one at a time as
    they are written (peak extra host RSS ≈ one leaf)."""
    plan = plan_pytree(state)
    stream.write(plan.header)
    for leaf, nbytes in zip(plan.leaves, plan.leaf_nbytes):
        arr = materialize_leaf(leaf)
        if arr.nbytes != nbytes:
            raise ValueError(f"leaf changed size while saving: {arr.nbytes} != {nbytes}")
        stream.write(struct.pack("<Q", nbytes))
        stream.write(as_byte_view(arr))


def _read_exact(stream: BinaryIO, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = stream.read(n - len(out))
        if not chunk:
            raise EOFError("truncated checkpoint stream")
        out += chunk
    return out


def load_pytree(stream: BinaryIO, leaf_hook: Any = None) -> Any:
    """Inverse of :func:`save_pytree`, reading payloads straight into
    preallocated arrays (``readinto``, no intermediate copies).

    Every array leaf comes back as a CPU torch tensor.  ``leaf_hook(t) ->
    Any``, if given, maps each tensor right after its bytes arrive — e.g. a
    ``copy_`` into the live parameter on its device — so the host copy of
    each leaf can be dropped as soon as the next one starts arriving
    (in-place-on-arrival heal)."""
    magic = _read_exact(stream, len(MAGIC))
    if magic != MAGIC:
        raise ValueError(f"bad checkpoint magic {magic!r}")
    (skel_len,) = struct.unpack("<I", _read_exact(stream, 4))
    skeleton = pickle.loads(_read_exact(stream, skel_len))
    (narrays,) = struct.unpack("<I", _read_exact(stream, 4))

    placeholders: List[_ArrayPlaceholder] = [None] * narrays  # type: ignore[list-item]

    def _collect(obj: Any) -> None:
        if isinstance(obj, _ArrayPlaceholder):
            placeholders[obj.index] = obj
        elif isinstance(obj, dict):
            for v in obj.values():
                _collect(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                _collect(v)

    _collect(skeleton)

    arrays: List[Any] = []
    for i in range(narrays):
        ph = placeholders[i]
        if ph is None:
            raise ValueError(f"missing placeholder for array {i}")
        (nbytes,) = struct.unpack("<Q", _read_exact(stream, 8))
        arr = torch.empty(ph.shape, dtype=_resolve_dtype(ph.dtype))
        expected = arr.numel() * arr.element_size()
        if nbytes != expected:
            raise ValueError(
                f"array {i}: payload {nbytes} bytes != expected {expected}"
            )
        view = memoryview(_tensor_bytes(arr))
        read_into = stream.readinto if hasattr(stream, "readinto") else None
        off = 0
        while off < nbytes:
            if read_into is not None:
                n = read_into(view[off:])
                if not n:
                    raise EOFError("truncated checkpoint stream")
            else:
                chunk = stream.read(min(1 << 20, nbytes - off))
                if not chunk:
                    raise EOFError("truncated checkpoint stream")
                view[off : off + len(chunk)] = chunk
                n = len(chunk)
            off += n
        arrays.append(arr if leaf_hook is None else leaf_hook(arr))

    return _restore_arrays(skeleton, arrays)


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


class ViewReader:
    """Minimal read/readinto stream over a memoryview (no BytesIO copy) —
    the zero-copy way to ``load_pytree`` an assembled striped-heal buffer."""

    def __init__(self, view: memoryview) -> None:
        self._view = view
        self._off = 0

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = len(self._view) - self._off
        out = bytes(self._view[self._off : self._off + n])
        self._off += len(out)
        return out

    def readinto(self, out) -> int:
        n = min(len(out), len(self._view) - self._off)
        out[:n] = self._view[self._off : self._off + n]
        self._off += n
        return n


def dumps_pytree(state: Any) -> bytes:
    buf = io.BytesIO()
    save_pytree(state, buf)
    return buf.getvalue()


def loads_pytree(data: bytes) -> Any:
    return load_pytree(io.BytesIO(data))
