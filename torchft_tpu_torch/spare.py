"""Hot spares: continuously-warmed standby replicas, sub-second promotion.

The port of ``torchft_tpu/spare.py``.  A spare replica keeps a shadow of
an active peer's state warm over two channels and is promoted by the
lighthouse in the same membership edit that would have shrunk the fleet,
instead of a dead replica restarting and healing cold:

- :class:`WarmChunkStore` — warm channel (b): a per-chunk, crc-watermarked
  cache of an active peer's serialized state dict, filled at idle priority
  over the manager warm RPCs (``MGR_WARM_INDEX``/``MGR_WARM_RANGE``).
  Chunks are keyed at ARRAY-payload granularity
  (``serialization.array_chunk_ranges``) so keys are stable across steps;
  a chunk is re-fetched exactly when its crc moved — "a stale chunk is
  re-fetched rather than trusted" — and partial progress survives quorum
  epochs, source rotation, and source death (resume from the cache).
- :class:`SpareAgent` — the spare replica's state machine: register with
  the lighthouse as ``ROLE_SPARE`` via the manager quorum path, warm on
  both channels (the outer-sync delta feed keeps a DiLoCo shadow bit-exact
  at commit granularity; the chunk store converges the full state dict
  between syncs), and run the promotion handshake when the lighthouse
  moves this replica into the participant set: adopt the promotion quorum
  (``Manager._adopt_quorum`` — no fresh RPC, the actives are already
  parked in mesh rendezvous waiting), flip the role to ACTIVE, and hand
  the caller a manager that is mid-``start_quorum`` of its first active
  step.
- :func:`diloco_delta_apply` — the delta feed's consumer for a spare
  shadowing a DiLoCo fleet, over the port's fragments (backups and live
  parameters on their device).

The ACTIVE side (staging warm snapshots, publishing committed deltas)
lives in ``manager.py``/``manager_server.py``; a spare is a pure consumer
and a dying or poisoned spare can never stall or fork the active fleet —
every warm RPC is served outside the heal path, the delta feed ring is
bounded, and the fleet's quorum math never counts a spare.  The spare role
runs on the Python tier: the C++ manager sidecar refuses it.

Two departures from the JAX package, both about host memory at Llama-3-8B
width (13.38 GB of state): a complete snapshot is handed to ``load_pytree``
as a stream over the cached chunks (:class:`_ChunkStream`, the same bytes
in the same order) instead of a joined copy of them, and a refresh pass can
skip deserializing a snapshot no newer than the shadow (``min_step``).
"""

from __future__ import annotations

import itertools
import logging
import struct
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch import knobs
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.wire import WireError

logger = logging.getLogger(__name__)

# Pause between warm chunk fetches (idle priority, spare side): keeps the
# warm stream from ever saturating a source's NIC; the source additionally
# yields warm responses to live collectives (ManagerServer.busy_fn).
SPARE_WARM_PACE_MS_ENV = "TORCHFT_SPARE_WARM_PACE_MS"  # default 5
# Per-round warm budget: how long one SpareAgent.step() spends fetching
# chunks before going back to park on the quorum RPC.
SPARE_WARM_BUDGET_S_ENV = "TORCHFT_SPARE_WARM_BUDGET_S"  # default 2.0


def _env_float(env: str, default: float) -> float:
    return knobs.get_float(env, default)


class _ChunkStream:
    """read/readinto over a sequence of byte pieces, in order: the
    serialized stream of a complete snapshot without a second copy of it
    (``load_pytree`` reads its payloads straight into fresh tensors)."""

    def __init__(self, pieces: Sequence[bytes]) -> None:
        self._pieces = pieces
        self._i = 0
        self._off = 0

    def readinto(self, out) -> int:
        out = memoryview(out).cast("B")
        n = 0
        while n < len(out) and self._i < len(self._pieces):
            piece = self._pieces[self._i]
            take = min(len(out) - n, len(piece) - self._off)
            out[n : n + take] = memoryview(piece)[self._off : self._off + take]
            n += take
            self._off += take
            if self._off == len(piece):
                self._i += 1
                self._off = 0
        return n

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = sum(len(p) for p in self._pieces[self._i :]) - self._off
        buf = bytearray(n)
        return bytes(buf[: self.readinto(buf)])


class WarmChunkStore:
    """crc-watermarked chunk cache of one peer's serialized state dict.

    Chunk keys are ``(array_index, lo, hi)`` byte ranges WITHIN each array
    payload (``array_chunk_ranges``) — stable across steps for a fixed
    tree structure, unlike serialized-stream offsets (the pickled header's
    length can drift with the step integer's pickle width).  A chunk's
    watermark is its content crc32: the refresh pass diffs cached crcs
    against the source's index and fetches only movers, so a shadow that
    is mostly warm costs a final delta, not a bulk transfer.
    """

    def __init__(self) -> None:
        self.leaf_nbytes: List[int] = []
        # prefix[i] = sum(leaf_nbytes[:i]) — O(1) stream-offset lookups
        # (a per-chunk O(leaves) sum would make a refresh pass
        # O(chunks x leaves) of pure-Python adds on big trees)
        self._prefix: List[int] = [0]
        self.chunk_target = 0
        self._chunks: Dict[int, Tuple[int, bytes]] = {}  # idx -> (crc, data)
        self._header: Optional[bytes] = None
        self._header_digest = ""
        # cumulative observability (+ how much of the source's index the
        # cache matched on the last refresh — the promotion-cost gauge)
        self.bytes_fetched = 0
        self.chunks_fetched = 0
        self.last_fresh_fraction = 0.0

    def _table(self) -> List[Tuple[int, int, int]]:
        from torchft_tpu_torch.checkpointing.serialization import array_chunk_ranges

        return array_chunk_ranges(self.leaf_nbytes, max(1, self.chunk_target))

    def _stream_offset(self, header_len: int, ai: int, lo: int) -> int:
        # header, then per array: 8-byte length prefix + payload
        return header_len + 8 * (ai + 1) + self._prefix[ai] + lo

    def fresh_fraction(self, hashes: List[int]) -> float:
        if not hashes:
            return 0.0
        fresh = sum(
            1
            for i, h in enumerate(hashes)
            if self._chunks.get(i, (None, b""))[0] == h
        )
        return fresh / len(hashes)

    def refresh(
        self,
        client,
        deadline: float,
        pace_s: float = 0.005,
        min_step: Optional[int] = None,
    ) -> Optional[Tuple[int, object]]:
        """One idle-priority refresh pass against ``client`` (a
        ``ManagerClient``): diff crc watermarks, fetch stale chunks until
        ``deadline``, and — when every chunk matches the source's index —
        deserialize the full state dict.

        Returns ``(step, state_dict)`` when a complete consistent snapshot
        landed this pass, else None (progress is kept either way).  With
        ``min_step``, a complete snapshot at or below that step is not
        deserialized (the caller holds it already) and None is returned.
        Raises the client's transport errors (the caller rotates
        sources)."""
        from torchft_tpu_torch.checkpointing.serialization import load_pytree

        index = client.warm_index()
        step = int(index["step"])
        if (
            list(index["leaf_nbytes"]) != self.leaf_nbytes
            or int(index["chunk_target_bytes"]) != self.chunk_target
        ):
            # tree structure (or chunking) changed: every cached watermark
            # is meaningless — start over
            self._chunks.clear()
            self._header = None
            self.leaf_nbytes = [int(n) for n in index["leaf_nbytes"]]
            self._prefix = [0] + list(itertools.accumulate(self.leaf_nbytes))
            self.chunk_target = int(index["chunk_target_bytes"])
        hashes = [int(h) for h in index["chunk_hashes"]]
        table = self._table()
        if len(hashes) != len(table):
            raise WireError(3, "warm index chunk table mismatch")

        # the header is small and step-dependent (it pickles the step
        # integer): refetch whenever the digest moved
        header_len = int(index["header_len"])
        if self._header is None or self._header_digest != index["header_digest"]:
            header = client.warm_range(step, 0, header_len)
            self._header = bytes(header)
            self._header_digest = str(index["header_digest"])

        stale = [
            i
            for i, h in enumerate(hashes)
            if self._chunks.get(i, (None, b""))[0] != h
        ]
        for i in stale:
            if time.monotonic() > deadline:
                # budget spent; resume next round
                self.last_fresh_fraction = self.fresh_fraction(hashes)
                return None
            ai, lo, hi = table[i]
            off = self._stream_offset(header_len, ai, lo)
            data = client.warm_range(step, off, off + (hi - lo))
            crc = zlib.crc32(data)
            if crc != hashes[i]:
                # the source restaged between index and range at the SAME
                # step label — impossible by protocol (ranges of a moved
                # snapshot are refused), so treat as corruption and drop
                logger.warning("warm chunk %d crc mismatch; dropped", i)
                continue
            self._chunks[i] = (crc, bytes(data))
            self.bytes_fetched += hi - lo
            self.chunks_fetched += 1
            if pace_s > 0:
                time.sleep(pace_s)

        self.last_fresh_fraction = self.fresh_fraction(hashes)
        if self.last_fresh_fraction < 1.0:
            return None
        if min_step is not None and step <= min_step:
            return None

        # complete + consistent: every chunk crc matches ONE index (one
        # step's staging) — stream header, length prefixes and chunks (the
        # serialized stream, byte for byte) into the deserializer
        by_array: Dict[int, List[bytes]] = {}
        for i, (ai, _lo, _hi) in enumerate(table):
            by_array.setdefault(ai, []).append(self._chunks[i][1])
        pieces: List[bytes] = [self._header or b""]
        for ai, nbytes in enumerate(self.leaf_nbytes):
            pieces.append(struct.pack("<Q", nbytes))
            pieces.extend(by_array.get(ai, []))
        state = load_pytree(_ChunkStream(pieces))
        return step, state


class SpareAgent:
    """Drives a ``Manager(role="spare")``: park on the quorum RPC for the
    live membership/commit-front view, warm on both channels between
    rounds, and adopt the promotion quorum when the lighthouse moves this
    replica into the participant set.

    Usage::

        manager = Manager(..., role="spare", use_async_quorum=...)
        agent = SpareAgent(manager, delta_apply=diloco_delta_apply(diloco))
        while not agent.step():
            pass  # warming; agent.metrics has warm_lag_steps etc.
        # promoted: run the normal train loop — the manager is already
        # mid-start_quorum of its first active step (do NOT re-request)

    ``delta_apply(step, frag, payload)`` applies one committed outer-sync
    delta to the caller's shadow (see :func:`diloco_delta_apply`); without
    it the spare warms on the chunk store alone.
    """

    def __init__(
        self,
        manager: Manager,
        delta_apply: Optional[Callable[[int, int, bytes], None]] = None,
    ) -> None:
        if manager.role != "spare":
            raise ValueError("SpareAgent requires Manager(role='spare')")
        self._manager = manager
        self._delta_apply = delta_apply
        self._store = WarmChunkStore()
        self._clients: Dict[str, object] = {}
        self._addresses: List[str] = []
        self._max_step = 0
        self._round = 0
        self._delta_cursor: Tuple[int, int] = (-1, 1 << 60)
        self._loaded_once = False
        # shadow_fresh: True while the delta chain from the last full load
        # is unbroken — a gap (feed ring overrun, missed poll) demotes the
        # shadow to "chunk store only" until the next complete snapshot
        self._shadow_fresh = False
        self.warm_step = -1
        self.promoted = False
        self.metrics: Dict[str, float] = {}

    # -- plumbing ----------------------------------------------------------

    def _client(self, addr: str):
        client = self._clients.get(addr)
        if client is None:
            client = self._manager._peer_client_factory(addr)
            self._clients[addr] = client
        return client

    def _drop_client(self, addr: str) -> None:
        client = self._clients.pop(addr, None)
        if client is not None:
            try:
                client.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close the warm clients and drop the chunk cache (a promoted
        spare no longer warms: the cache would only hold host memory)."""
        for addr in list(self._clients):
            self._drop_client(addr)
        self._store = WarmChunkStore()

    # -- the spare state machine ------------------------------------------

    def step(self, park_timeout_s: float = 2.0) -> bool:
        """One spare round: park on the quorum RPC (registers this replica
        as a spare and yields the live membership view), then warm until
        the round budget runs out.  Returns True exactly once — when the
        lighthouse promoted this replica and the manager adopted the
        promotion quorum (it is then mid-``start_quorum`` of its first
        active step)."""
        m = self._manager
        result = None
        try:
            result = m._client._quorum(
                group_rank=m._group_rank,
                step=max(0, self.warm_step),
                checkpoint_metadata=m._checkpoint_transport.metadata(),
                shrink_only=False,
                timeout=park_timeout_s,
                init_sync=False,
            )
        except TimeoutError:
            pass  # idle fleet: no quorum activity — warm on cached facts
        except WireError as e:
            # the manager server's own lighthouse round failed: when the
            # fleet is idle, its timeout races the client's and arrives as
            # an error frame.  The cached facts still hold — warm on them
            logger.info("spare quorum round failed: %s", e)
        except (ConnectionError, OSError) as e:
            logger.info("spare quorum round failed: %s", e)
            time.sleep(0.1)
            return False

        if result is not None and not result.is_spare:
            self._finalize_promotion(result)
            return True
        if result is not None:
            if result.all_manager_addresses:
                self._addresses = list(result.all_manager_addresses)
            self._max_step = result.max_step
        self._warm()
        return False

    # -- warm channels -----------------------------------------------------

    def _warm(self) -> None:
        if not self._addresses:
            return
        budget = _env_float(SPARE_WARM_BUDGET_S_ENV, 2.0)
        pace = _env_float(SPARE_WARM_PACE_MS_ENV, 5.0) / 1000.0
        deadline = time.monotonic() + budget
        self._poll_deltas()
        # rotate warm sources across rounds (spreads the idle load; a dead
        # source costs one round, the cache resumes against the next)
        addr = self._addresses[self._round % len(self._addresses)]
        self._round += 1
        try:
            loaded = self._store.refresh(
                self._client(addr),
                deadline=deadline,
                pace_s=pace,
                min_step=self.warm_step,
            )
        except (ConnectionError, OSError, TimeoutError) as e:
            logger.info("warm refresh from %s failed: %s", addr, e)
            self._drop_client(addr)
            loaded = None
        except WireError:
            # nothing staged yet (no commit since we registered) — normal
            loaded = None
        if loaded is not None:
            step, state = loaded
            if step > self.warm_step:
                self._load_state(state, step)
        self._export_metrics()

    def _poll_deltas(self) -> None:
        """Warm channel (a): drain the outer-sync delta feed and apply the
        entries in order.  The chain must be gapless from the shadow's
        step — a hole (bounded ring overran us) demotes the shadow until
        the chunk store next converges."""
        if self._delta_apply is None or not self._loaded_once:
            return
        addr = self._addresses[0]
        try:
            entries = self._client(addr).deltas(*self._delta_cursor)
        except (ConnectionError, OSError, TimeoutError, WireError) as e:
            logger.info("delta poll from %s failed: %s", addr, e)
            self._drop_client(addr)
            return
        applied = 0
        for step, frag, payload in entries:
            self._delta_cursor = (step, frag)
            if not self._shadow_fresh:
                continue
            if step != self.warm_step + 1:
                logger.info(
                    "delta chain gap (have step %d, got %d); shadow demoted "
                    "to chunk-store warming",
                    self.warm_step,
                    step,
                )
                self._shadow_fresh = False
                continue
            try:
                self._delta_apply(step, frag, payload)
            except Exception:  # noqa: BLE001 — a bad delta poisons only the
                # SHADOW (refetched from chunks), never the fleet
                logger.exception("delta apply failed; shadow demoted")
                self._shadow_fresh = False
                continue
            self.warm_step = step
            self._manager._step = step
            applied += 1
        if applied:
            self.metrics["warm_deltas_applied"] = (
                self.metrics.get("warm_deltas_applied", 0.0) + applied
            )

    def _load_state(self, state: dict, step: int) -> None:
        """Adopt one complete warm snapshot: apply every registered user
        load fn plus the torchft step facts — the exact load path a heal
        uses, so promotion from here is indistinguishable from a healed
        join."""
        m = self._manager
        user = state.get("user", {})
        with m._state_dict_lock.w_lock():
            for key, load_fn in m._load_state_dict_fns.items():
                if key in user:
                    load_fn(user[key])
        m.load_state_dict(state["torchft"])
        self.warm_step = m._step
        self._loaded_once = True
        self._shadow_fresh = self._delta_apply is not None
        # deltas at or before the snapshot step are already baked in
        self._delta_cursor = (self.warm_step, 1 << 60)
        from torchft_tpu_torch.obs.flight import FlightEvent

        m._flight.record(
            FlightEvent.SPARE_WARM,
            step=self.warm_step,
            lag=max(0, self._max_step - max(0, self.warm_step)),
        )
        logger.info("spare warm snapshot loaded at step %d", self.warm_step)

    def _export_metrics(self) -> None:
        self.metrics.update(
            warm_step=float(self.warm_step),
            warm_lag_steps=float(max(0, self._max_step - max(0, self.warm_step))),
            warm_bytes_fetched=float(self._store.bytes_fetched),
            warm_chunks_fetched=float(self._store.chunks_fetched),
            warm_fresh_fraction=self._store.last_fresh_fraction,
        )
        # spares have no active quorum rounds, so this dict is ours to fill
        self._manager.last_quorum_timings.update(self.metrics)

    # -- promotion ---------------------------------------------------------

    def _finalize_promotion(self, result) -> None:
        """Promotion handshake: adopt the promotion quorum WITHOUT a fresh
        RPC (the actives are already parked in mesh rendezvous waiting for
        this replica), flip the role to ACTIVE, and leave the manager
        mid-``start_quorum`` — the caller's next ``start_quorum()`` is a
        no-op and its step runs under the adopted quorum.  When the warm
        watermark equals the commit front the adopted round has
        ``heal=False``: promotion = quorum adoption + configure, no
        transfer at all; otherwise the standard (striped) heal fetches the
        remainder."""
        m = self._manager
        t0 = time.monotonic()
        m._promote_to_active()
        timings: Dict[str, float] = {}
        m.last_quorum_timings = timings
        timings["promote_warm_lag_steps"] = float(
            max(0, result.max_step - max(0, self.warm_step))
        )
        m._errored = None
        m._healing = False
        with m._pending_works_lock:
            m._pending_works.clear()

        def _stamp_adopt(_fut) -> None:
            # stamped when the adoption (configure + any final heal)
            # actually FINISHES — in async-quorum mode the submit returns
            # immediately, and a promote_s taken there would report
            # microseconds even when a lagging spare runs a striped heal
            timings["promote_s"] = time.monotonic() - t0
            self.metrics["promotion_adopt_s"] = timings["promote_s"]
            logger.warning(
                "spare %s promoted at warm step %d (fleet max_step %d, "
                "adopt %.3fs)",
                m.replica_id,
                self.warm_step,
                result.max_step,
                timings["promote_s"],
            )

        fut = m._executor.submit(m._adopt_quorum, result, True, timings)
        fut.add_done_callback(_stamp_adopt)
        m._quorum_future = fut
        m._adopted_quorum = True
        if not m._use_async_quorum:
            try:
                m.wait_quorum()
            except Exception as e:  # noqa: BLE001 — funnel, never raise
                m.report_error(e)
            else:
                if m._healing:
                    m._apply_pending_state_dict()
                    m._healing = False
        self.metrics.update(
            promote_warm_lag_steps=timings["promote_warm_lag_steps"],
        )
        self.promoted = True


def diloco_delta_apply(diloco) -> Callable[[int, int, bytes], None]:
    """Delta-apply callback for a spare shadowing a DiLoCo fleet: applies
    one committed outer-sync delta to fragment ``frag``'s backup and writes
    the globally-consistent values into its live parameters — bit for bit
    the committed-sharded branch of ``_Fragment.perform_sync`` with no
    local mixing (a parked spare has no inner steps, i.e. local == global,
    so the update is exact at ANY alpha).

    The sum runs in f32 where the backup lives and rounds once to each
    leaf's dtype (``_Fragment.global_from_delta``, that branch's own); the
    live parameters take the result in place.  Only the wire payload passes
    through numpy."""

    def _apply(step: int, frag: int, payload: bytes) -> None:
        f = diloco.fragments[frag]
        delta = torch.from_numpy(np.frombuffer(payload, dtype=np.float32).copy())
        if delta.numel() != f._n:
            raise ValueError(
                f"delta for fragment {frag} has {delta.numel()} elements, "
                f"expected {f._n}"
            )
        new_backup = f.global_from_delta(delta)
        with torch.no_grad():
            for p, g in zip(f._params, new_backup):
                p.copy_(g)
        f.backup = new_backup

    return _apply
