"""Checkpoint transport over the data-plane communicator.

The port of ``torchft_tpu/checkpointing/comm_transport.py`` (the twin of
the reference's PGTransport, ``torchft/checkpointing/pg_transport.py``):
instead of a side HTTP channel, healing weights ride the same communicator
as the gradients, on its dedicated point-to-point lane.

Protocol per (src → dst) pair, tags in the heal range of ``wire.py``:

1. one framed metadata blob: the pickled skeleton and each array's
   (dtype name, shape);
2. one framed raw-byte payload per array (tag base + 1 + i).

The frames are the JAX package's byte for byte: the same tags in the same
order, the same array payloads, the same ``array_meta`` and chunk index;
only the skeleton's pickle names this package's classes.  A CUDA leaf
leaves the sender through a ring of reused pinned buffers
(``serialization.StagingRing``), a copier thread ahead of the writes: its
frame is written in parts as they are staged
(``Communicator.send_frame_parts``), a striped chunk's frame from one slot.
Leaves land on the receiver in CPU tensors, received straight into their
bytes, so bf16 needs no extension dtype; a thread maps each landing buffer
with its pages faulted in ahead of the frame that lands in it.  Received
leaves are CPU tensors, as ``HTTPTransport`` returns them; a DTensor leaf
comes back as a ``ShardedHostArray`` of the sender rank's local shard.  ``recv_checkpoint(into=...)`` lands each payload in place in
a matching contiguous CPU tensor (or numpy array) of ``into``.
"""

from __future__ import annotations

import contextlib
import io
import logging
import pickle
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple, TypeVar

import numpy as np
import torch

from torchft_tpu_torch import wire
from torchft_tpu_torch.checkpointing.serialization import (
    StagingRing,
    _SkeletonUnpickler,
    _dtype_name,
    _extract_arrays,
    _leaf_meta,
    _leaf_source,
    _resolve_dtype,
    _restore_arrays,
    _tensor_bytes,
    array_chunk_ranges,
    balanced_shares,
    heal_chunk_bytes,
    populated_empty,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.communicator import Communicator
from torchft_tpu_torch.obs.spans import span as obs_span
from torchft_tpu_torch.observability import HealMetrics

logger = logging.getLogger(__name__)

T = TypeVar("T")

_TAG_BASE = wire.HEAL_TAG_BASE

# Striped-heal tag offsets inside one step's tag range.  Distinct from the
# per-array tags (base + 1 + i), so a striped healer paired with a
# per-array sender fails on a tag mismatch instead of misreading frames.
_S_META_OFF = 7_000_000  # src → dst: pickled chunk index
_S_CHUNK_OFF = 7_000_001  # src → dst: + chunk_idx, raw chunk bytes
_S_CTRL_OFF = 8_000_000  # dst → src: pickled ("need", [idx...]) / ("done",)


def _loads(blob: bytes) -> Any:
    """Unpickle a peer's metadata, refusing the JAX package's classes (a
    heal across the packages is not supported)."""
    return _SkeletonUnpickler(io.BytesIO(blob)).load()


def _nbytes(dtype_name: str, shape) -> int:
    return _resolve_dtype(dtype_name).itemsize * int(np.prod(shape, dtype=np.int64))


def _landing_bytes(target: Any) -> np.ndarray:
    """Flat uint8 view of a landing buffer's memory (CPU tensor or numpy)."""
    if isinstance(target, torch.Tensor):
        return _tensor_bytes(target.detach())
    return target.reshape(-1).view(np.uint8)


def _inplace_targets(into: Any, array_meta: List[Tuple[str, Tuple[int, ...]]]) -> List[Any]:
    """Per array of the incoming checkpoint, the leaf of ``into`` its bytes
    may land in: a contiguous CPU tensor or a C-contiguous writable numpy
    array of the same dtype and shape; None elsewhere."""
    out: List[Any] = [None] * len(array_meta)
    if into is None:
        return out
    existing: List[Any] = []
    _extract_arrays(into, existing)
    for i, ((dtype_name, shape), arr) in enumerate(zip(array_meta, existing)):
        if _dtype_name(arr.dtype) != dtype_name or tuple(arr.shape) != tuple(shape):
            continue
        if isinstance(arr, torch.Tensor):
            if arr.device.type == "cpu" and arr.is_contiguous():
                out[i] = arr
        elif arr.flags.c_contiguous and arr.flags.writeable:
            out[i] = arr
    return out


def _land_ahead(target: Any, dtype_name: str, shape) -> Any:
    """``target``, or a fresh landing buffer with its pages faulted in."""
    if target is not None:
        return target
    with obs_span("heal::recv_land"):
        return populated_empty(tuple(shape), _resolve_dtype(dtype_name))


def _landing_buffers(inplace: List[Any], array_meta) -> List[Any]:
    return [
        target if target is not None else torch.empty(tuple(shape), dtype=_resolve_dtype(name))
        for target, (name, shape) in zip(inplace, array_meta)
    ]


def _whole_leaf(leaf: Any, nbytes: int) -> Iterator[Tuple[Any, int, int]]:
    """A leaf's bytes as one piece for a :class:`StagingRing`, looked up
    when its frame is written (a non-contiguous CUDA leaf is made
    contiguous on the card only then)."""
    yield _leaf_source(leaf), 0, nbytes


class CommTransport(CheckpointTransport[T]):
    """Checkpoint transport over ``Communicator.send_bytes/recv_bytes``.

    The communicator must be the manager's (re)configured one: send and
    recv pair up between the quorum's replica ranks.  Per-step tag salting
    keeps a late transfer of an earlier heal from pairing with a new one.
    """

    # at most this many leaves' frames are queued a destination while
    # streaming a heal (a communicator that joins a frame's parts before
    # sending holds each queued leaf on the host)
    _SEND_WINDOW_LEAVES = 4

    def __init__(self, comm: Communicator, timeout: float = 60.0) -> None:
        # ``timeout`` is taken for the JAX package's signature; every call
        # passes its own
        del timeout
        self._comm = comm
        # the most recent heal's metrics, and the striped serve loop's chaos
        # trip wire: abort the communicator after serving ~N bytes (counted
        # only once ``chaos_arm``, if given, is set)
        self.last_heal_metrics: Optional[HealMetrics] = None
        self.chaos_die_after_bytes: Optional[int] = None
        self.chaos_arm: Optional[threading.Event] = None
        self.chaos_fired = threading.Event()

    def metadata(self) -> str:
        return "<comm>"

    @staticmethod
    def _tags(step: int) -> int:
        # salted by the full step (tags are uint64 on both tiers), so a
        # transfer stale by any number of steps never aliases a newer one
        return _TAG_BASE * 1000 + step * wire.HEAL_STEP_TAG_STRIDE

    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: T, timeout: float
    ) -> None:
        arrays: List[Any] = []
        skeleton = _extract_arrays(state_dict, arrays)
        meta = pickle.dumps(
            (skeleton, [_leaf_meta(a) for a in arrays]), protocol=pickle.HIGHEST_PROTOCOL
        )
        base = self._tags(step)
        deadline = time.monotonic() + timeout
        # each leaf is one frame a destination, written as a ring of that
        # destination's own stages it from the card (a host leaf passes
        # through); the frames queue in order on the op thread
        works = deque(self._comm.send_bytes(meta, dst, tag=base) for dst in dst_ranks)
        rings = {dst: StagingRing() for dst in dst_ranks}
        for i, leaf in enumerate(arrays):
            nbytes = _nbytes(*_leaf_meta(leaf))
            for dst in dst_ranks:
                parts = rings[dst].chunks(_whole_leaf(leaf, nbytes))
                works.append(self._comm.send_frame_parts(parts, nbytes, dst, tag=base + 1 + i))
            with obs_span("heal::send_write"):
                while len(works) > self._SEND_WINDOW_LEAVES * len(dst_ranks):
                    works.popleft().wait(timeout=max(0.0, deadline - time.monotonic()))
        with obs_span("heal::send_write"):
            for work in works:
                work.wait(timeout=max(0.0, deadline - time.monotonic()))
        logger.info("sent checkpoint step=%d (%d arrays) to ranks %s", step, len(arrays), dst_ranks)

    def recv_checkpoint(
        self,
        src_rank: int,
        metadata: str,
        step: int,
        timeout: float,
        into: Optional[T] = None,
    ) -> T:
        t0 = time.monotonic()
        base = self._tags(step)
        skeleton, array_meta = _loads(self._comm.recv_bytes(src_rank, tag=base).wait(timeout=timeout))
        # the landing buffers are mapped in order on a thread of their own,
        # their pages faulted in there, while the frames land in the ones
        # before them
        inplace = _inplace_targets(into, array_meta)
        arrays: List[Any] = []
        total = 0
        lander = ThreadPoolExecutor(1, thread_name_prefix="tpuft_heal_land")
        try:
            landing = [lander.submit(_land_ahead, target, name, shape)
                       for target, (name, shape) in zip(inplace, array_meta)]
            for i, future in enumerate(landing):
                target = future.result()
                arrays.append(target)
                view = _landing_bytes(target)
                with obs_span("heal::recv_read"):
                    got = self._comm.recv_bytes_into(src_rank, view, tag=base + 1 + i).wait(
                        timeout=timeout)
                if got != view.nbytes:
                    raise ValueError(
                        f"checkpoint array {i}: payload {got} bytes != expected {view.nbytes}"
                    )
                total += view.nbytes
        finally:
            lander.shutdown(wait=False, cancel_futures=True)
        self.last_heal_metrics = HealMetrics(
            step=step,
            num_sources=1,
            bytes_total=total,
            duration_s=time.monotonic() - t0,
            per_source_bytes={f"rank{src_rank}": total},
        )
        logger.info(
            "received checkpoint step=%d (%d arrays) from rank %d", step, len(arrays), src_rank
        )
        return _restore_arrays(skeleton, arrays)

    # ------------------------------------------------------------------
    # striped healing
    # ------------------------------------------------------------------
    #
    # The raw array payloads split into a chunk index
    # (``serialization.array_chunk_ranges``): every chunk is a byte range of
    # one array's buffer, so the healer lands frames from all sources
    # directly in the final arrays.  Chunk → source assignment is the
    # deterministic byte-balanced ``balanced_shares`` over the canonical
    # source list, computed alike on every peer; a dead source's chunks are
    # re-requested from a survivor over the dst → src control channel.

    def send_checkpoint_striped(
        self,
        dst_ranks: List[int],
        step: int,
        state_dict: T,
        timeout: float,
        source_index: int = 0,
        num_sources: int = 1,
    ) -> None:
        if num_sources <= 1:
            self.send_checkpoint(dst_ranks, step, state_dict, timeout)
            return
        arrays: List[Any] = []
        skeleton = _extract_arrays(state_dict, arrays)
        array_meta = [_leaf_meta(a) for a in arrays]
        chunks = array_chunk_ranges([_nbytes(d, s) for d, s in array_meta], heal_chunk_bytes())
        meta_blob = pickle.dumps(
            {"skeleton": skeleton, "array_meta": array_meta, "chunks": chunks},
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        own = balanced_shares([e - s for _, s, e in chunks], num_sources)[source_index]
        deadline = time.monotonic() + timeout

        def _remaining() -> float:
            return max(0.0, deadline - time.monotonic())

        def _serve_dst(dst: int) -> None:
            base = self._tags(step)
            sent_bytes = 0

            def _send_chunks(indices: List[int]) -> None:
                # each chunk is one frame, staged through a ring of this
                # stream's own (a slot holds the largest chunk) and reused
                # once the frame that reads it is sent
                nonlocal sent_bytes
                ring = StagingRing(
                    slot_bytes=max((chunks[i][2] - chunks[i][1] for i in indices), default=1))
                pieces = ((_leaf_source(arrays[chunks[i][0]]), chunks[i][1], chunks[i][2])
                          for i in indices)
                window: List[tuple] = []
                with contextlib.closing(ring.chunks(pieces)) as staged:
                    for i, (blob, release) in zip(indices, staged):
                        # the trip wire honors its arm gate: bytes served
                        # before the event is set neither count nor kill
                        armed = self.chaos_arm is None or self.chaos_arm.is_set()
                        if (
                            armed
                            and self.chaos_die_after_bytes is not None
                            and sent_bytes >= self.chaos_die_after_bytes
                        ):
                            self.chaos_fired.set()
                            self._comm.abort("chaos: heal source killed mid-transfer")
                            raise ConnectionError("chaos: heal source killed mid-transfer")
                        window.append((self._comm.send_bytes(blob, dst, tag=base + _S_CHUNK_OFF + i),
                                       release))
                        if armed:
                            sent_bytes += len(blob)
                        with obs_span("heal::send_write"):
                            while len(window) >= ring.slots:
                                work, done = window.pop(0)
                                work.wait(timeout=_remaining())
                                done()
                    with obs_span("heal::send_write"):
                        for work, done in window:
                            work.wait(timeout=_remaining())
                            done()

            self._comm.send_bytes(meta_blob, dst, tag=base + _S_META_OFF).wait(timeout=_remaining())
            _send_chunks(own)
            # answer ("need", [...]) re-requests for a dead peer's chunks
            # until the healer says done or the deadline passes.  The ctrl
            # recv is an ordinary op bounded by the communicator's op
            # timeout, so its timeout must be at least the heal's
            while time.monotonic() < deadline:
                try:
                    ctrl = _loads(
                        self._comm.recv_bytes(dst, tag=base + _S_CTRL_OFF).wait(timeout=_remaining())
                    )
                except Exception as e:  # noqa: BLE001 — healer gone: stop serving
                    logger.info("striped heal: control channel to dst %d closed (%s)", dst, e)
                    return
                if ctrl[0] == "done":
                    return
                if ctrl[0] != "need":
                    raise ValueError(f"striped heal: unexpected control message {ctrl!r}")
                _send_chunks(list(ctrl[1]))

        if len(dst_ranks) == 1:
            _serve_dst(dst_ranks[0])
        else:
            errors: List[BaseException] = []

            def _run_serve(dst: int) -> None:
                try:
                    _serve_dst(dst)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    errors.append(e)

            threads = [
                threading.Thread(target=_run_serve, args=(dst,), name=f"tpuft_heal_src_{dst}",
                                 daemon=True)
                for dst in dst_ranks
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=_remaining())
            # a failed or stuck serve surfaces to the manager's error funnel
            if errors:
                raise errors[0]
            stuck = [t.name for t in threads if t.is_alive()]
            if stuck:
                raise TimeoutError(f"striped serve still running at deadline: {stuck}")
        logger.info(
            "served striped checkpoint step=%d share %d/%d (%d/%d chunks) to %s",
            step, source_index, num_sources, len(own), len(chunks), dst_ranks,
        )

    def recv_checkpoint_striped(
        self,
        sources: List[Tuple[int, Optional[str]]],
        step: int,
        timeout: float,
        into: Optional[T] = None,
    ) -> T:
        """Striped heal over the communicator.

        ``sources`` is the quorum's canonical ordered source list: every
        sender computes its chunk share positionally against the same list,
        dead entries included.  Chunk frames from all sources are drained
        concurrently by one op (``Communicator.heal_drain``) straight into
        the final buffers; a tier without it (the C++ tier) drains the
        sources one after another (:meth:`_drain_serially`)."""
        if len(sources) <= 1:
            return self.recv_checkpoint(sources[0][0], "<comm>", step, timeout, into=into)

        base = self._tags(step)
        deadline = time.monotonic() + timeout
        t0 = time.monotonic()
        src_ranks = [r for r, _ in sources]

        def _remaining() -> float:
            return max(0.0, deadline - time.monotonic())

        # every source pushes the same chunk index first: adopt the first,
        # verify the rest, mark the sources that send none as dead
        index: Optional[dict] = None
        dead: Dict[int, BaseException] = {}
        meta_works = [(r, self._comm.recv_bytes(r, tag=base + _S_META_OFF)) for r in src_ranks]
        for s_rank, work in meta_works:
            try:
                meta = _loads(work.wait(timeout=_remaining()))
                if index is None:
                    index = meta
                elif meta["array_meta"] != index["array_meta"] or meta["chunks"] != index["chunks"]:
                    raise ValueError(
                        f"source rank {s_rank} serves a different checkpoint than the adopted index"
                    )
            except Exception as e:  # noqa: BLE001 — source-level failover
                logger.warning("striped heal: no index from source rank %d (%s)", s_rank, e)
                dead[s_rank] = e
        if index is None:
            raise next(iter(dead.values()))

        array_meta = index["array_meta"]
        chunks: List[Tuple[int, int, int]] = [tuple(c) for c in index["chunks"]]
        with obs_span("heal::recv_land"):
            arrays = _landing_buffers(_inplace_targets(into, array_meta), array_meta)
        flat = [_landing_bytes(a) for a in arrays]
        chunk_arrays = [flat[ai][start:stop] for ai, start, stop in chunks]
        chunk_views = [memoryview(a) for a in chunk_arrays]

        shares = balanced_shares([e - s for _, s, e in chunks], len(src_ranks))
        expected = {r: shares[i] for i, r in enumerate(src_ranks) if r not in dead}
        orphans = [c for i, r in enumerate(src_ranks) if r in dead for c in shares[i]]
        with obs_span("heal::recv_read"):
            try:
                drain = self._comm.heal_drain(
                    chunk_views,
                    expected,
                    orphans,
                    chunk_tag=lambda i: base + _S_CHUNK_OFF + i,
                    ctrl_tag=base + _S_CTRL_OFF,
                    make_need=lambda idxs: pickle.dumps(("need", list(idxs))),
                    done_blob=pickle.dumps(("done",)),
                    timeout_s=_remaining(),
                )
                res = drain.wait(timeout=_remaining())
            except NotImplementedError:
                logger.warning(
                    "striped heal: communicator has no heal_drain; draining %d sources one "
                    "after another", len(expected),
                )
                res = self._drain_serially(chunk_arrays, expected, orphans, base, _remaining)
        dead.update(res["dead"])

        total_bytes = sum(len(v) for v in chunk_views)
        self.last_heal_metrics = HealMetrics(
            step=step,
            num_sources=len(src_ranks),
            bytes_total=total_bytes,
            duration_s=time.monotonic() - t0,
            per_source_bytes={f"rank{p}": n for p, n in res["per_source"].items() if n},
            failed_sources=[f"rank{p}" for p in sorted(dead)],
            stolen_chunks=int(res["stolen"]),
        )
        logger.info(
            "striped heal step=%d: %d bytes from %d/%d sources in %.3fs",
            step, total_bytes, len(src_ranks) - len(dead), len(src_ranks),
            self.last_heal_metrics.duration_s,
        )
        return _restore_arrays(index["skeleton"], arrays)

    def _drain_serially(
        self,
        chunk_arrays: List[np.ndarray],
        expected: Dict[int, List[int]],
        orphans: List[int],
        base: int,
        remaining: Any,
    ) -> Dict[str, Any]:
        """``heal_drain``'s result on a tier without it: each live source's
        share received in turn (one link at a time), then the chunks of the
        sources that sent no index re-requested from the first live one,
        then ("done",) to each.  Every source streams its share whatever
        the healer's tier, so the healer must read each share (a
        single-source receive would meet chunk frames where it expects
        per-array ones).  A source lost here fails the heal."""

        def _recv(src: int, i: int) -> int:
            view = chunk_arrays[i]
            got = self._comm.recv_bytes_into(src, view, tag=base + _S_CHUNK_OFF + i).wait(
                timeout=remaining()
            )
            if got != view.nbytes:
                raise ValueError(f"chunk {i} from rank {src}: {got} bytes != {view.nbytes}")
            return got

        per_source = {src: sum(_recv(src, i) for i in idxs) for src, idxs in expected.items()}
        first = next(iter(expected))
        if orphans:
            self._comm.send_bytes(
                pickle.dumps(("need", list(orphans))), first, tag=base + _S_CTRL_OFF
            ).wait(timeout=remaining())
            per_source[first] += sum(_recv(first, i) for i in orphans)
        for src in expected:
            self._comm.send_bytes(pickle.dumps(("done",)), src, tag=base + _S_CTRL_OFF).wait(
                timeout=remaining()
            )
        return {"dead": {}, "per_source": per_source, "stolen": len(orphans)}

    def disallow_checkpoint(self) -> None:
        pass

    def shutdown(self, wait: bool = True) -> None:
        pass
