"""Per-replica-group Manager sidecar: barrier, recovery math, commit voting.

The reference runs a Rust ``ManagerServer`` inside the rank-0 Python process
of every replica group (``src/manager.rs:80-328``); all local ranks connect
to it with a ``ManagerClient``.  Its three jobs:

1. **Intra-group quorum barrier** (``src/manager.rs:332-402``): collect one
   ``quorum`` RPC from each of the group's ``world_size`` ranks; when the
   last arrives, forward a single request to the lighthouse (with retries and
   client re-creation, ``src/manager.rs:250-306``) and broadcast the resulting
   quorum to every parked rank.
2. **Recovery assignment** (``compute_quorum_results``,
   ``src/manager.rs:489-625``): sort participants by replica_id for a
   deterministic replica_rank; find the max-step set; pick the primary store
   owner ``group_rank % len(max_participants)``; round-robin assign each
   stale replica a healthy recovery source, offset by group_rank so different
   group ranks spread load across sources.
3. **should_commit AND-barrier** (``src/manager.rs:423-479``): collect votes
   from all local ranks; the decision is the AND of all votes; broadcast and
   reset.

It also stores per-rank checkpoint metadata for healing peers
(``src/manager.rs:404-421``), heartbeats the lighthouse every
``heartbeat_interval`` (``src/manager.rs:194-216``), and answers ``Kill``
by exiting the process (``src/manager.rs:481-487``).
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from torchft_tpu_torch import knobs
from torchft_tpu_torch.lighthouse import LighthouseClient
from torchft_tpu_torch.obs import metrics as obs_metrics
from torchft_tpu_torch.wire import (
    ROLE_ACTIVE,
    ErrCode,
    ManagerQuorumResult,
    MsgType,
    Quorum,
    QuorumMember,
    Reader,
    RpcClient,
    WireError,
    Writer,
    configure_server_socket,
    create_listener,
    raise_if_error,
    read_http_path,
    recv_frame,
    send_error,
    send_frame,
    send_http_response,
)

logger = logging.getLogger(__name__)

# Cap on how many peers serve one striped heal (0 = every up-to-date peer).
# Must be set uniformly across the job: the chunk assignment is positional
# in the source list, so a mismatched cap would desynchronize senders from
# the healer.
HEAL_MAX_SOURCES_ENV = "TORCHFT_HEAL_MAX_SOURCES"

# Spare warm channels.  The outer-delta feed ring is bounded (a slow or
# dead spare must never grow an active replica's memory): oldest entries
# drop first and a spare that fell off the ring re-syncs via the warm
# snapshot instead.
SPARE_DELTA_BUF_MB_ENV = "TORCHFT_SPARE_DELTA_BUF_MB"  # default 128
_SPARE_DELTA_MAX_ENTRIES = 64
# one warm-range response must fit a wire frame with headroom
_WARM_RANGE_MAX_BYTES = 48 << 20
# how long a warm-range handler will wait for foreground collectives to
# drain before serving anyway (idle priority, but never starvation)
_WARM_YIELD_S = 0.25


def _spare_delta_buf_bytes() -> int:
    mb = knobs.get_float(SPARE_DELTA_BUF_MB_ENV, 128.0)
    return max(1 << 20, int(mb * (1 << 20)))


def compute_quorum_results(
    replica_id: str,
    group_rank: int,
    quorum: Quorum,
    init_sync: bool,
) -> ManagerQuorumResult:
    """Derive this rank's view of a quorum (``src/manager.rs:489-625``).

    A replica listed in the quorum's SPARE tail (not its participants)
    gets the spare view: membership facts + every participant's manager
    address for the warm channels, ``is_spare=True``, no rank and no heal
    assignment — it must warm, not train."""
    participants = sorted(quorum.participants, key=lambda p: p.replica_id)
    spare_ids = sorted(s.replica_id for s in quorum.spares)

    replica_rank = next(
        (i for i, p in enumerate(participants) if p.replica_id == replica_id), None
    )
    if replica_rank is None:
        if replica_id not in spare_ids:
            raise WireError(
                ErrCode.NOT_FOUND,
                f"replica {replica_id} not participating in returned quorum",
            )
        max_step = max((p.step for p in participants), default=0)
        max_participants = [p for p in participants if p.step == max_step]
        return ManagerQuorumResult(
            quorum_id=quorum.quorum_id,
            replica_rank=-1,
            replica_world_size=len(participants),
            store_address=(
                max_participants[group_rank % len(max_participants)].store_address
                if max_participants
                else ""
            ),
            max_step=max_step,
            max_replica_rank=None,
            max_world_size=len(max_participants),
            heal=False,
            commit_failures=max(
                (p.commit_failures for p in participants), default=0
            ),
            replica_ids=[p.replica_id for p in participants],
            is_spare=True,
            spare_replica_ids=spare_ids,
            all_manager_addresses=[p.address for p in participants],
            participant_capacities=[p.capacity for p in participants],
        )

    max_step = max(p.step for p in participants)
    max_participants = [p for p in participants if p.step == max_step]
    max_replica_rank = next(
        (
            i
            for i, p in enumerate(max_participants)
            if p.replica_id == replica_id
        ),
        None,
    )

    # The primary store for communicator rendezvous this round; spreading by
    # group_rank balances rendezvous load across up-to-date replicas.
    primary = max_participants[group_rank % len(max_participants)]

    # Replicas recover if behind max_step, or on a fresh job (max_step == 0
    # with init_sync) where everyone but the primary pulls the primary's init.
    force_recover = init_sync and max_step == 0
    recover_dst = [
        i
        for i, p in enumerate(participants)
        if p.step != max_step
        or (force_recover and primary.replica_id != p.replica_id)
    ]
    recover_dst_set = set(recover_dst)
    up_to_date = [i for i in range(len(participants)) if i not in recover_dst_set]

    assignments: Dict[int, List[int]] = {}
    recover_src: Optional[int] = None
    for i, recovering in enumerate(recover_dst):
        src = up_to_date[(i + group_rank) % len(up_to_date)]
        assignments.setdefault(src, []).append(recovering)
        if recovering == replica_rank:
            recover_src = src

    heal = recover_src is not None
    if heal:
        logger.info(
            "[Replica %s] healing is required step=%d, max_step=%d, recover_src_replica_rank=%d",
            replica_id,
            participants[replica_rank].step,
            max_step,
            recover_src,
        )

    # Striped healing (wire v2): the canonical ascending source set — every
    # up-to-date replica — so a healer can fetch disjoint chunk ranges from
    # ALL of them and every source knows to stage/serve.  The list must be
    # identical on every participant (the CommTransport chunk assignment is
    # positional), so the optional cap truncates deterministically.
    striped_sources = up_to_date if recover_dst else []
    max_sources = int(os.environ.get(HEAL_MAX_SOURCES_ENV, "0") or 0)
    if max_sources > 0:
        striped_sources = striped_sources[:max_sources]

    return ManagerQuorumResult(
        quorum_id=quorum.quorum_id,
        replica_rank=replica_rank,
        replica_world_size=len(participants),
        recover_src_manager_address=(
            participants[recover_src].address if recover_src is not None else ""
        ),
        recover_src_replica_rank=recover_src,
        recover_dst_replica_ranks=assignments.get(replica_rank, []),
        store_address=primary.store_address,
        max_step=max_step,
        max_replica_rank=max_replica_rank,
        max_world_size=len(max_participants),
        heal=heal,
        commit_failures=max(p.commit_failures for p in participants),
        replica_ids=[p.replica_id for p in participants],
        recover_src_replica_ranks=striped_sources,
        recover_src_manager_addresses=[
            participants[i].address for i in striped_sources
        ],
        all_recover_dst_replica_ranks=recover_dst,
        spare_replica_ids=spare_ids,
        all_manager_addresses=(
            [p.address for p in participants] if spare_ids else []
        ),
        # degraded-mode (wire v5): per-participant capacities, aligned with
        # ``replica_ids`` (sorted participant order) — the data-shard
        # rescale and weighted-outer-reduce inputs every rank needs
        participant_capacities=[p.capacity for p in participants],
    )


class ManagerServer:
    """Threaded manager sidecar for one replica group."""

    def __init__(
        self,
        replica_id: str,
        lighthouse_addr: str,
        hostname: str = "",
        bind: str = "0.0.0.0:0",
        store_addr: str = "",
        world_size: int = 1,
        heartbeat_interval: float = 0.1,
        connect_timeout: float = 10.0,
        quorum_retries: int = 0,
        kill_fn: Optional[Callable[[str], None]] = None,
        health_fn: Optional[Callable[[], Optional[object]]] = None,
        role: int = ROLE_ACTIVE,
        warm_fn: Optional[Callable[[], Optional[object]]] = None,
        warm_step_fn: Optional[Callable[[], int]] = None,
        capacity_fn: Optional[Callable[[], float]] = None,
        metrics_fn: Optional[Callable[[], Dict[str, float]]] = None,
    ) -> None:
        self._replica_id = replica_id
        self._lighthouse_addr = lighthouse_addr
        self._hostname = hostname or socket.gethostname()
        self._store_addr = store_addr
        self._world_size = world_size
        self._heartbeat_interval = heartbeat_interval
        self._connect_timeout = connect_timeout
        self._quorum_retries = quorum_retries
        self._kill_fn = kill_fn or self._default_kill
        # comm-health provider: each heartbeat carries its latest snapshot
        # (a wire.CommHealth or None) to the lighthouse — the straggler-
        # detection input.  Errors are swallowed: a broken probe must never
        # kill the heartbeat that keeps this replica in the quorum.
        self._health_fn = health_fn
        # quorum role (wire v3): SPARE registers as a hot spare that never
        # counts toward membership; flipped to ACTIVE at promotion (read
        # per quorum round — a plain attribute write is the handshake)
        self.role = role
        # warm-snapshot provider for spare warm fetches: returns the
        # currently staged ``(step, PytreePlan)`` or None.  Served via
        # MGR_WARM_INDEX/MGR_WARM_RANGE entirely OUTSIDE the heal path so a
        # warming spare can never clobber (or block on) a real recovery.
        self._warm_fn = warm_fn
        # spare warm watermark provider (wire v4): rides every heartbeat so
        # the lighthouse's promotion-eligibility view stays fresh at beat
        # cadence, not quorum-RPC re-registration cadence
        self._warm_step_fn = warm_step_fn
        # degraded-capacity provider (wire v5): the surviving-device
        # fraction this replica re-lowered onto (1.0 = full width).  Rides
        # the quorum registration every round and — while degraded — each
        # direct heartbeat, so the lighthouse's wound→swap→evict ladder
        # reacts at beat cadence.  Errors are swallowed like health_fn:
        # the probe must never kill the beat.
        self._capacity_fn = capacity_fn
        # /metrics provider: extra per-replica gauges from the owning
        # Manager (declared names only — obs/metrics.py enforces).  The
        # endpoint rides the same listener via HTTP sniffing and serves a
        # TTL-cached sample set (TORCHFT_METRICS_TTL_S), so a scrape storm
        # re-polls the providers at most once per TTL.
        self._metrics_fn = metrics_fn
        self._metrics_cache: Tuple[float, bytes] = (float("-inf"), b"")
        self._metrics_cache_lock = threading.Lock()
        self.metrics_rebuilds = 0
        # hierarchical coordination plane: beats route through the zone
        # aggregator named by TORCHFT_AGG_ADDR (read live each beat) and
        # fall back to direct lighthouse beats on aggregator death.
        # Counters are single-writer (the heartbeat thread); readers
        # (coord_stats) tolerate a stale snapshot.
        self._beats_via_agg = 0
        self._beats_direct = 0
        self._agg_fallbacks = 0
        # foreground-busy probe (idle-priority warm serving): when set and
        # True, warm-range responses briefly yield so spare traffic never
        # contends with a live collective on the NIC
        self.busy_fn: Optional[Callable[[], bool]] = None
        # per-chunk crc table of the staged warm plan, cached by plan
        # identity (one full materialization pass per restage, not per
        # request) — the version watermarks spares diff against
        self._warm_hash_cache: Tuple[Optional[object], List[int]] = (None, [])
        # one crc pass at a time: at 8B width a pass outlasts the spare's
        # index timeout, and its retry must wait for this pass instead of
        # starting a second one (two passes over different leaves thrash
        # the plan's one-leaf host memo, copying a whole leaf per chunk)
        self._warm_hash_lock = threading.Lock()
        # outer-sync delta feed: committed (step, fragment, payload) blobs
        # spares subscribe to (bounded ring; identical bytes on every
        # replica by construction, so any one publisher suffices)
        self._deltas: List[Tuple[int, int, bytes]] = []
        self._deltas_bytes = 0
        # chaos hook (Failure.PARTITION): a partitioned replica loses its
        # control plane too, so the drill pauses heartbeats alongside the
        # data-plane partition mask
        self.heartbeat_paused = False
        # lighthouse-restart detection: bumped by the heartbeat loop when a
        # beat SUCCEEDS after failures (the lighthouse came back); the
        # parked quorum forwarding call is interrupted so it re-registers
        # against the fresh lighthouse instead of wedging on a dead socket
        # until the quorum timeout
        self._lh_restart_gen = 0

        self._lock = threading.Condition()
        # quorum barrier state
        self._participants: Dict[int, QuorumMember] = {}
        self._checkpoint_metadata: Dict[int, str] = {}
        # quorum rounds: each full group starts one lighthouse forward, its
        # round id counting from 0; ``_quorum_gen`` is one past the newest
        # round whose outcome ``_latest`` / ``_latest_err`` hold, and a rank
        # takes only its own round's outcome or a newer one.  Forwards run
        # one at a time, so an older round can settle after a newer rank
        # parked: handing it that stale outcome (a spare's earlier park, a
        # round from before a promotion) would give the rank a quorum its
        # own request never asked for
        self._rounds_started = 0
        self._quorum_gen = 0
        self._latest: Optional[Quorum] = None
        self._latest_err: Optional[str] = None
        # should_commit barrier state
        self._commit_votes: Set[int] = set()
        self._commit_failures: Set[int] = set()
        self._commit_gen = 0
        self._commit_decision = False

        self._shutdown = False
        # persistent lighthouse connection for quorum forwarding; rounds are
        # normally sequential, but a timed-out round can overlap the next,
        # so serialize access
        self._lh_quorum_client: Optional[LighthouseClient] = None
        self._lh_client_lock = threading.Lock()

        self._sock = create_listener(bind, backlog=64)
        self._port: int = self._sock.getsockname()[1]

        threading.Thread(
            target=self._serve, name="tpuft_manager_accept", daemon=True
        ).start()
        threading.Thread(
            target=self._run_heartbeat, name="tpuft_manager_heartbeat", daemon=True
        ).start()
        logger.info(
            "[Replica %s] Manager listening on %s", replica_id, self.address()
        )

    # -- public -------------------------------------------------------------

    @property
    def port(self) -> int:
        return self._port

    def address(self) -> str:
        return f"{self._hostname}:{self._port}"

    def shutdown(self) -> None:
        self._shutdown = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            self._lock.notify_all()
        # best-effort: an in-flight quorum RPC may hold the lock until its
        # deadline; don't block shutdown on it (threads are daemonized)
        if self._lh_client_lock.acquire(timeout=1.0):
            try:
                if self._lh_quorum_client is not None:
                    self._lh_quorum_client.close()
                    self._lh_quorum_client = None
            finally:
                self._lh_client_lock.release()

    @staticmethod
    def _default_kill(msg: str) -> None:
        logger.warning("got kill request: %s", msg)
        os._exit(1)

    # -- background loops ---------------------------------------------------

    def _run_heartbeat(self) -> None:
        """Heartbeat until shutdown (``src/manager.rs:194-216``), routed
        through the zone aggregator when one is configured
        (``TORCHFT_AGG_ADDR``, wire v4) and falling back to direct
        lighthouse beats whenever the aggregator is unreachable —
        aggregator death costs one beat interval of reporting, never
        membership.  Lighthouse-restart detection works on both paths: the
        direct path sees beat-success-after-failure itself; the aggregated
        path learns it from the restart counter every AGG_BEAT_RESP
        carries."""
        client: Optional[LighthouseClient] = None
        agg_client = None
        agg_down_until = 0.0
        agg_lh_restarts: Optional[int] = None
        beat_failures = 0
        while not self._shutdown:
            if self.heartbeat_paused:
                time.sleep(self._heartbeat_interval)
                continue
            health = None
            if self._health_fn is not None:
                try:
                    health = self._health_fn()
                except Exception:  # noqa: BLE001 — probe must not kill beats
                    health = None
            warm_step = -1
            if self._warm_step_fn is not None:
                try:
                    warm_step = int(self._warm_step_fn())
                except Exception:  # noqa: BLE001 — probe must not kill beats
                    warm_step = -1
            capacity = self._capacity()
            sent = False
            from torchft_tpu_torch.wire import manager_quorum_wire_version

            agg_addr = knobs.get_str("TORCHFT_AGG_ADDR", "")
            if (
                agg_addr
                and manager_quorum_wire_version() >= 4
                and time.monotonic() >= agg_down_until
            ):
                try:
                    if agg_client is None or agg_client.addr != agg_addr:
                        if agg_client is not None:
                            agg_client.close()
                        from torchft_tpu_torch.coord.aggregator import AggMemberClient

                        agg_client = AggMemberClient(
                            agg_addr, connect_timeout=self._connect_timeout
                        )
                    resp = agg_client.beat(
                        self._replica_id,
                        role=self.role,
                        warm_step=warm_step,
                        health=health,
                    )
                    sent = True
                    # ftlint: ignore[thread-safety] — single-writer counter
                    self._beats_via_agg += 1
                    restarts = int(resp["lh_restarts"])  # type: ignore[arg-type]
                    restart_seen = (
                        agg_lh_restarts is not None
                        and restarts > agg_lh_restarts
                    )
                    agg_lh_restarts = restarts
                    if not resp["upstream_ok"]:
                        # the aggregator itself can't reach the lighthouse
                        # (asymmetric partition: we can reach both, it can
                        # reach neither of its flushes through).  A beat
                        # parked in a dead-ended aggregator is NOT a beat —
                        # fall through to a DIRECT one this round, or the
                        # whole zone ages out together when the grace
                        # window expires.  The direct branch tracks its own
                        # failures, so restart detection (and the parked-
                        # quorum interrupt) follows whichever path actually
                        # reaches the lighthouse.
                        sent = False
                    elif beat_failures or restart_seen:
                        beat_failures = 0
                        # ftlint: ignore[thread-safety] — single-writer counter
                        self._lh_restart_gen += 1
                        self._interrupt_lh_quorum()
                except (OSError, TimeoutError, WireError) as e:
                    logger.info(
                        "[Replica %s] aggregator %s unreachable, falling "
                        "back to direct beats: %s",
                        self._replica_id,
                        agg_addr,
                        e,
                    )
                    if agg_client is not None:
                        agg_client.close()
                    agg_client = None
                    agg_lh_restarts = None
                    agg_down_until = time.monotonic() + knobs.get_float(
                        "TORCHFT_AGG_RETRY_S", 2.0
                    )
                    # ftlint: ignore[thread-safety] — single-writer counter
                    self._agg_fallbacks += 1
            if not sent:
                try:
                    if client is None:
                        client = LighthouseClient(
                            self._lighthouse_addr,
                            connect_timeout=self._connect_timeout,
                        )
                    client.heartbeat(
                        self._replica_id,
                        health=health,
                        warm_step=warm_step if warm_step >= 0 else None,
                        capacity=capacity if capacity != 1.0 else None,
                    )
                    # ftlint: ignore[thread-safety] — single-writer counter
                    self._beats_direct += 1
                    if beat_failures:
                        # the lighthouse answered after failing: it (likely)
                        # restarted with empty soft state.  A quorum RPC
                        # parked against the DEAD incarnation would wedge
                        # until its timeout; interrupt it so it re-registers
                        # (idempotent) against the fresh lighthouse
                        # immediately.
                        beat_failures = 0
                        # single-writer counter: only this heartbeat thread
                        # ever increments; readers tolerate a stale
                        # generation (they re-check next round)
                        # ftlint: ignore[thread-safety] — single-writer counter
                        self._lh_restart_gen += 1
                        self._interrupt_lh_quorum()
                except (OSError, TimeoutError, WireError) as e:
                    beat_failures += 1
                    logger.info(
                        "[Replica %s] failed to send heartbeat to lighthouse: %s",
                        self._replica_id,
                        e,
                    )
                    if client is not None:
                        client.close()
                    client = None
            time.sleep(self._heartbeat_interval)
        if client is not None:
            client.close()
        if agg_client is not None:
            agg_client.close()

    def _capacity(self) -> float:
        """This replica's current degraded-capacity fraction (1.0 when no
        provider is wired or the probe fails — full width is the safe
        default: it never triggers the swap/evict rungs)."""
        if self._capacity_fn is None:
            return 1.0
        try:
            cap = float(self._capacity_fn())
        except Exception:  # noqa: BLE001 — probe must not kill beats/quorums
            return 1.0
        return min(1.0, max(0.0, cap)) if cap > 0.0 else 1.0

    def coord_stats(self) -> Dict[str, int]:
        """Coordination-plane beat routing counters (observability: the
        manager folds them into the ``torchft_quorums`` extras)."""
        return {
            "coord_beats_via_agg": self._beats_via_agg,
            "coord_beats_direct": self._beats_direct,
            "coord_agg_fallbacks": self._agg_fallbacks,
        }

    # -- /metrics (Prometheus text; HTTP sniffed off the RPC port) ----------

    def _metrics_text(self) -> bytes:
        """TTL-cached Prometheus text: scrape storms rebuild (and re-poll
        the Manager-side providers) at most once per
        ``TORCHFT_METRICS_TTL_S``; concurrent scrapes serialize on the
        cache lock, never on the quorum barrier."""
        ttl = knobs.get_float("TORCHFT_METRICS_TTL_S", 0.5)
        now = time.monotonic()
        with self._metrics_cache_lock:
            built_ts, raw = self._metrics_cache
            if raw and now - built_ts < ttl:
                return raw
            raw = self._metrics_rebuild().encode()
            self._metrics_cache = (now, raw)
            return raw

    def _metrics_rebuild(self) -> str:
        # ftlint: ignore[thread-safety] — cache-lock-held rebuild counter
        self.metrics_rebuilds += 1
        sample = obs_metrics.metric_sample
        samples = []
        provided: Dict[str, float] = {}
        if self._metrics_fn is not None:
            try:
                provided = self._metrics_fn() or {}
            except Exception:  # noqa: BLE001 — probe must not kill a scrape
                provided = {}
        for name in sorted(provided):
            samples.append(sample(name, provided[name]))
        if "torchft_mgr_capacity" not in provided and self._capacity_fn:
            samples.append(sample("torchft_mgr_capacity", self._capacity()))
        health = None
        if self._health_fn is not None:
            try:
                health = self._health_fn()
            except Exception:  # noqa: BLE001 — probe must not kill a scrape
                health = None
        if health is not None:
            samples += [
                sample("torchft_mgr_comm_tx_bytes_total", health.tx_bytes),
                sample("torchft_mgr_comm_rx_bytes_total", health.rx_bytes),
                sample("torchft_mgr_comm_stalls_total", health.stalls),
                sample("torchft_mgr_comm_reconnects_total", health.reconnects),
                sample("torchft_mgr_comm_failovers_total", health.failovers),
                sample("torchft_mgr_comm_faults_total", health.faults),
            ]
        coord = self.coord_stats()
        samples += [
            sample(
                "torchft_mgr_beats_via_agg_total", coord["coord_beats_via_agg"]
            ),
            sample(
                "torchft_mgr_beats_direct_total", coord["coord_beats_direct"]
            ),
            sample(
                "torchft_mgr_agg_fallbacks_total", coord["coord_agg_fallbacks"]
            ),
        ]
        return obs_metrics.render(samples)

    def _handle_http(self, conn: socket.socket) -> None:
        """Answer one HTTP request on the manager port: ``/metrics`` in
        Prometheus text format (gated by ``TORCHFT_METRICS``)."""
        path = read_http_path(conn)
        if path is None:
            return
        if path == "/metrics" and knobs.get_bool("TORCHFT_METRICS", True):
            body = self._metrics_text()
            status = "200 OK"
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            body = b"not found\n"
            status, ctype = "404 Not Found", "text/plain"
        send_http_response(conn, status, ctype, body)

    def _interrupt_lh_quorum(self) -> None:
        """Sever the persistent quorum-forwarding connection WITHOUT taking
        its rpc lock (the parked call holds it): the blocked recv errors
        out and ``_run_quorum`` retries against the restarted lighthouse."""
        client = self._lh_quorum_client
        if client is not None:
            try:
                client.interrupt()
            except OSError:  # pragma: no cover — already torn down
                pass

    # -- connection handling ------------------------------------------------

    def _serve(self) -> None:
        while not self._shutdown:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            configure_server_socket(conn)
            threading.Thread(
                target=self._handle_conn,
                args=(conn,),
                name="tpuft_manager_conn",
                daemon=True,
            ).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            # sniff HTTP vs framed RPC on one port (lighthouse pattern) —
            # but with NO idle deadline: a ManagerClient connects eagerly
            # in Manager.__init__ and may not issue its first quorum RPC
            # until after a minutes-long model build, and the pre-sniff
            # server blocked in recv_frame indefinitely for exactly that
            # reason.  The blocking MSG_PEEK preserves it; the inner loop
            # only spins between bytes 1..4 of one frame header.
            head = b""
            while len(head) < 4:
                head = conn.recv(4, socket.MSG_PEEK)
                if not head:
                    return  # peer closed before sending anything
                if len(head) < 4:
                    time.sleep(0.01)
            if head[:3] in (b"GET", b"POS", b"HEA"):
                self._handle_http(conn)
                return
            while True:
                msg_type, r = recv_frame(conn)
                if msg_type == MsgType.MGR_QUORUM_REQ:
                    self._handle_quorum(conn, r)
                elif msg_type == MsgType.MGR_CKPT_META_REQ:
                    rank = r.i64()
                    with self._lock:
                        meta = self._checkpoint_metadata.get(rank)
                    if meta is None:
                        send_error(conn, ErrCode.INVALID, "rank not found")
                    else:
                        send_frame(
                            conn,
                            MsgType.MGR_CKPT_META_RESP,
                            Writer().string(meta).payload(),
                        )
                elif msg_type == MsgType.MGR_SHOULD_COMMIT_REQ:
                    self._handle_should_commit(conn, r)
                elif msg_type == MsgType.MGR_WARM_INDEX_REQ:
                    self._handle_warm_index(conn)
                elif msg_type == MsgType.MGR_WARM_RANGE_REQ:
                    self._handle_warm_range(conn, r)
                elif msg_type == MsgType.MGR_DELTA_REQ:
                    self._handle_deltas(conn, r)
                elif msg_type == MsgType.MGR_KILL_REQ:
                    msg = r.string()
                    send_frame(conn, MsgType.MGR_KILL_RESP)
                    self._kill_fn(msg)
                else:
                    send_error(conn, ErrCode.INVALID, f"bad manager op {msg_type}")
        except (ConnectionError, OSError, WireError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- spare warm channels ------------------------------------------------

    def publish_delta(self, step: int, frag: int, payload: bytes) -> None:
        """Append one committed outer-sync delta to the feed ring.  The
        bytes are identical on every replica by construction (the sharded
        outer sync allgathers one wire-format delta), so any single
        publisher keeps every subscribed spare's shadow bit-exact."""
        if len(payload) > _WARM_RANGE_MAX_BYTES:
            # a too-big entry can never ride a wire frame: serving it
            # would fail the spare's recv on EVERY poll (the cursor never
            # advances past it), permanently killing the feed.  Refuse it
            # here — the spare's shadow demotes to chunk-store warming,
            # which chunks arbitrarily large state.
            logger.warning(
                "[Replica %s] outer delta (step %d frag %d, %d bytes) "
                "exceeds the frame budget; dropped — spares warm via "
                "snapshot chunks instead",
                self._replica_id,
                step,
                frag,
                len(payload),
            )
            return
        with self._lock:
            self._deltas.append((step, frag, payload))
            self._deltas_bytes += len(payload)
            cap = _spare_delta_buf_bytes()
            while self._deltas and (
                self._deltas_bytes > cap
                or len(self._deltas) > _SPARE_DELTA_MAX_ENTRIES
            ):
                _s, _f, old = self._deltas.pop(0)
                self._deltas_bytes -= len(old)

    def _handle_deltas(self, conn: socket.socket, r: Reader) -> None:
        """Serve feed entries strictly newer than the subscriber's
        ``(step, frag)`` cursor, oldest first, capped to one frame."""
        after_step = r.i64()
        after_frag = r.i64()
        with self._lock:
            fresh = [
                e for e in self._deltas if (e[0], e[1]) > (after_step, after_frag)
            ]
        w = Writer()
        picked: List[Tuple[int, int, bytes]] = []
        budget = _WARM_RANGE_MAX_BYTES
        for step, frag, payload in fresh:
            if picked and budget - len(payload) < 0:
                break
            picked.append((step, frag, payload))
            budget -= len(payload)
        w.u32(len(picked))
        for step, frag, payload in picked:
            w.i64(step).i64(frag).blob(payload)
        send_frame(conn, MsgType.MGR_DELTA_RESP, w.payload())

    def _warm_plan(self):
        if self._warm_fn is None:
            return None
        try:
            return self._warm_fn()
        except Exception:  # noqa: BLE001 — a broken probe must not kill
            # the connection loop; the spare just sees "nothing staged"
            logger.exception(
                "[Replica %s] warm snapshot provider failed", self._replica_id
            )
            return None

    def _warm_chunk_hashes(self, plan) -> List[int]:
        """crc32 per warm chunk (array-payload granularity — chunk keys
        are STABLE across steps for a fixed tree structure, unlike
        serialized-stream offsets whose pickled header length can drift).
        These are the per-chunk version watermarks: a spare refetches only
        chunks whose crc moved since its last pass."""
        import zlib

        from torchft_tpu_torch.checkpointing.serialization import (
            array_chunk_ranges,
            as_byte_view,
            heal_chunk_bytes,
        )

        with self._warm_hash_lock:
            cached_plan, cached = self._warm_hash_cache
            if cached_plan is plan:
                return cached
            hashes = []
            for ai, lo, hi in array_chunk_ranges(
                plan.leaf_nbytes, heal_chunk_bytes()
            ):
                view = as_byte_view(plan._materialize(ai))[lo:hi]
                hashes.append(zlib.crc32(view))
            self._warm_hash_cache = (plan, hashes)
            return hashes

    def _handle_warm_index(self, conn: socket.socket) -> None:
        staged = self._warm_plan()
        if staged is None:
            send_error(conn, ErrCode.NOT_FOUND, "no warm snapshot staged")
            return
        step, plan = staged
        from torchft_tpu_torch.checkpointing.serialization import heal_chunk_bytes

        hashes = self._warm_chunk_hashes(plan)
        w = Writer()
        w.i64(step)
        w.u64(plan.total_len)
        w.u64(len(plan.header))
        w.string(plan.header_digest())
        w.u32(len(plan.leaf_nbytes))
        for n in plan.leaf_nbytes:
            w.u64(n)
        w.u64(heal_chunk_bytes())
        w.u32(len(hashes))
        for h in hashes:
            w.u32(h)
        send_frame(conn, MsgType.MGR_WARM_INDEX_RESP, w.payload())

    def _handle_warm_range(self, conn: socket.socket, r: Reader) -> None:
        """Serve bytes [start, stop) of the warm snapshot staged at exactly
        ``step`` — a moved snapshot is NOT served (the spare's watermark
        protocol re-fetches the index rather than trusting a stale range).
        Idle priority: yields briefly while foreground collectives run."""
        step = r.i64()
        start = r.u64()
        stop = r.u64()
        staged = self._warm_plan()
        if staged is None or staged[0] != step:
            send_error(
                conn,
                ErrCode.NOT_FOUND,
                f"warm snapshot at step {step} no longer staged",
            )
            return
        _step, plan = staged
        if not 0 <= start <= stop <= plan.total_len:
            send_error(
                conn,
                ErrCode.INVALID,
                f"bad warm range [{start}, {stop}) of {plan.total_len}",
            )
            return
        if stop - start > _WARM_RANGE_MAX_BYTES:
            send_error(
                conn,
                ErrCode.INVALID,
                f"warm range too large ({stop - start} bytes)",
            )
            return
        if self.busy_fn is not None:
            yield_deadline = time.monotonic() + _WARM_YIELD_S
            while time.monotonic() < yield_deadline:
                try:
                    if not self.busy_fn():
                        break
                except Exception:  # noqa: BLE001 — probe must not block serving
                    break
                time.sleep(0.01)
        import io

        buf = io.BytesIO()
        plan.write_range(start, stop, buf)
        send_frame(
            conn,
            MsgType.MGR_WARM_RANGE_RESP,
            Writer().i64(step).blob(buf.getvalue()).payload(),
        )

    # -- quorum barrier -----------------------------------------------------

    def _handle_quorum(self, conn: socket.socket, r: Reader) -> None:
        group_rank = r.i64()
        step = r.i64()
        checkpoint_metadata = r.string()
        shrink_only = r.boolean()
        init_sync = r.boolean()
        commit_failures = r.i64()
        timeout_ms = r.u64()
        deadline = time.monotonic() + timeout_ms / 1000.0

        logger.info(
            "[Replica %s] Start quorum for group_rank %d", self._replica_id, group_rank
        )

        with self._lock:
            self._checkpoint_metadata[group_rank] = checkpoint_metadata
            member = QuorumMember(
                replica_id=self._replica_id,
                address=self.address(),
                store_address=self._store_addr,
                step=step,
                world_size=self._world_size,
                shrink_only=shrink_only,
                commit_failures=commit_failures,
                role=self.role,
                capacity=self._capacity(),
            )
            self._participants[group_rank] = member
            my_round = self._rounds_started

            if len(self._participants) == self._world_size:
                self._participants.clear()
                self._rounds_started += 1
                threading.Thread(
                    target=self._run_quorum,
                    args=(member, timeout_ms / 1000.0, my_round),
                    name="tpuft_manager_quorum",
                    daemon=True,
                ).start()

            failure: Optional[Tuple[ErrCode, str]] = None
            while self._quorum_gen <= my_round:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._shutdown:
                    failure = (
                        ErrCode.SHUTDOWN if self._shutdown else ErrCode.TIMEOUT,
                        f"manager quorum for group_rank {group_rank} "
                        f"{'aborted by shutdown' if self._shutdown else 'timed out'}",
                    )
                    break
                self._lock.wait(min(remaining, 0.1))
            quorum = self._latest
            quorum_err = self._latest_err

        # socket IO outside the server lock (a wedged client must not block
        # the barrier for other ranks)
        conn.settimeout(30.0)
        try:
            if failure is not None:
                send_error(conn, failure[0], failure[1])
                return

            if quorum is None:
                send_error(conn, ErrCode.UNKNOWN, quorum_err or "quorum failed")
                return

            logger.info(
                "[Replica %s] Finished quorum for group_rank %d",
                self._replica_id,
                group_rank,
            )
            try:
                reply = compute_quorum_results(
                    self._replica_id, group_rank, quorum, init_sync
                )
            except WireError as e:
                send_error(conn, e.code, str(e))
                return
            w = Writer()
            reply.encode(w)
            send_frame(conn, MsgType.MGR_QUORUM_RESP, w.payload())
        finally:
            conn.settimeout(None)

    def _run_quorum(self, requester: QuorumMember, timeout_s: float, round_id: int) -> None:
        """Forward round ``round_id``'s request to the lighthouse with retries
        and broadcast the result to every rank parked on it.

        Retry exhaustion is a BROADCAST FAILURE, never a silent park: after
        ``quorum_retries`` failed attempts (plus any free retries granted by
        a detected lighthouse restart, bounded only by the caller's
        deadline), ``_latest`` is cleared, ``_latest_err`` records the last
        transport error, ``_quorum_gen`` is bumped, and ``_lock`` is
        notified — so ranks blocked in the quorum wait wake immediately with
        the error instead of each burning its own full deadline.
        """
        logger.info(
            "[Replica %s] All workers joined - starting quorum", self._replica_id
        )
        quorum: Optional[Quorum] = None
        last_err = "unknown"
        deadline = time.monotonic() + timeout_s
        attempt = 0
        while attempt <= self._quorum_retries:
            if self.heartbeat_paused:
                # chaos partition: the control plane is severed — a quorum
                # rpc is an implicit lighthouse heartbeat, so forwarding it
                # would keep this "partitioned" replica looking alive
                last_err = "control plane severed (chaos partition)"
                break
            restart_gen = self._lh_restart_gen
            try:
              with self._lh_client_lock:
                if requester.role != self.role:
                    # a spare round queued behind the round that carried
                    # its promotion: that round's ranks have their answer,
                    # and this one, sent now, would register the stale
                    # step of a role that no longer holds
                    logger.info(
                        "[Replica %s] dropped a quorum round of the old role",
                        self._replica_id,
                    )
                    return
                # persistent connection across rounds (the reference keeps a
                # tonic channel, src/manager.rs:250-306); recreated on failure
                if self._lh_quorum_client is None:
                    self._lh_quorum_client = LighthouseClient(
                        self._lighthouse_addr, connect_timeout=self._connect_timeout
                    )
                # One in-flight lighthouse RPC on the shared persistent
                # client is this lock's purpose; a parked call is severed by
                # the heartbeat loop's interrupt() on lighthouse restart
                # (tested by the lighthouse-bounce unit test).
                # ftlint: ignore[blocking-under-lock] — serialized rpc by design
                quorum = self._lh_quorum_client.quorum(
                    replica_id=requester.replica_id,
                    timeout=max(0.1, deadline - time.monotonic()),
                    address=requester.address,
                    store_address=requester.store_address,
                    step=requester.step,
                    world_size=requester.world_size,
                    shrink_only=requester.shrink_only,
                    commit_failures=requester.commit_failures,
                    role=requester.role,
                    capacity=self._capacity(),
                )
                break
            except (OSError, TimeoutError, WireError) as e:
                last_err = str(e)
                logger.info(
                    "[Replica %s] lighthouse quorum failed (attempt %d): %s",
                    self._replica_id,
                    attempt,
                    e,
                )
                if self._lh_quorum_client is not None:
                    self._lh_quorum_client.close()
                    self._lh_quorum_client = None
                if (
                    self._lh_restart_gen != restart_gen
                    and time.monotonic() < deadline
                    and not self._shutdown
                ):
                    # the heartbeat loop detected a lighthouse restart and
                    # interrupted this (now moot) parked call: re-register
                    # against the fresh lighthouse at once.  Registration is
                    # idempotent server-side and this retry is FREE (not
                    # counted against quorum_retries) — bounded only by the
                    # caller's deadline — so a default retries=0 fleet still
                    # rides out a lighthouse bounce instead of wedging until
                    # the quorum timeout.
                    continue
                attempt += 1
                if attempt <= self._quorum_retries:
                    # only back off when another attempt remains — otherwise
                    # broadcast the failure to parked ranks immediately
                    time.sleep(
                        max(0.1, timeout_s / max(self._quorum_retries + 1, 1))
                    )

        with self._lock:
            if round_id < self._quorum_gen:
                return  # a newer round settled first: its ranks have theirs
            self._latest = quorum
            self._latest_err = (
                None
                if quorum is not None
                else f"lighthouse quorum failed after {self._quorum_retries} retries: {last_err}"
            )
            self._quorum_gen = round_id + 1
            self._lock.notify_all()

    # -- should_commit barrier ----------------------------------------------

    def _handle_should_commit(self, conn: socket.socket, r: Reader) -> None:
        group_rank = r.i64()
        _step = r.i64()
        should_commit = r.boolean()
        timeout_ms = r.u64()
        deadline = time.monotonic() + timeout_ms / 1000.0

        logger.info(
            "[Replica %s] should_commit request from %d should_commit=%s",
            self._replica_id,
            group_rank,
            should_commit,
        )

        with self._lock:
            if not should_commit:
                self._commit_failures.add(group_rank)
            self._commit_votes.add(group_rank)
            gen = self._commit_gen

            if len(self._commit_votes) == self._world_size:
                decision = len(self._commit_failures) == 0
                logger.info(
                    "[Replica %s] should_commit completed should_commit=%s",
                    self._replica_id,
                    decision,
                )
                self._commit_decision = decision
                self._commit_votes.clear()
                self._commit_failures.clear()
                self._commit_gen += 1
                self._lock.notify_all()

            failure: Optional[Tuple[ErrCode, str]] = None
            while self._commit_gen == gen:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._shutdown:
                    failure = (
                        ErrCode.SHUTDOWN if self._shutdown else ErrCode.TIMEOUT,
                        f"should_commit for group_rank {group_rank} "
                        f"{'aborted by shutdown' if self._shutdown else 'timed out'}",
                    )
                    break
                self._lock.wait(min(remaining, 0.1))
            decision = self._commit_decision

        conn.settimeout(30.0)
        try:
            if failure is not None:
                send_error(conn, failure[0], failure[1])
                return
            send_frame(
                conn,
                MsgType.MGR_SHOULD_COMMIT_RESP,
                Writer().boolean(decision).payload(),
            )
        finally:
            conn.settimeout(None)


class ManagerClient(RpcClient):
    """Client used by every local rank to reach its group's ManagerServer
    (pyo3 analog ``src/lib.rs:153-282``)."""

    def __init__(self, addr: str, connect_timeout: float = 10.0) -> None:
        super().__init__(addr, connect_timeout=connect_timeout)

    def _call(self, msg_type: MsgType, payload: bytes, timeout: float) -> Tuple[int, Reader]:
        return self.call(msg_type, payload, timeout)

    def _quorum(
        self,
        group_rank: int,
        step: int,
        checkpoint_metadata: str,
        shrink_only: bool,
        timeout: float,
        init_sync: bool = True,
        commit_failures: int = 0,
    ) -> ManagerQuorumResult:
        w = (
            Writer()
            .i64(group_rank)
            .i64(step)
            .string(checkpoint_metadata)
            .boolean(shrink_only)
            .boolean(init_sync)
            .i64(commit_failures)
            .u64(int(timeout * 1000))
        )
        msg_type, r = self._call(MsgType.MGR_QUORUM_REQ, w.payload(), timeout)
        raise_if_error(msg_type, r)
        return ManagerQuorumResult.decode(r)

    def _checkpoint_metadata(self, rank: int, timeout: float) -> str:
        msg_type, r = self._call(
            MsgType.MGR_CKPT_META_REQ, Writer().i64(rank).payload(), timeout
        )
        raise_if_error(msg_type, r)
        return r.string()

    def should_commit(
        self, group_rank: int, step: int, should_commit: bool, timeout: float
    ) -> bool:
        w = (
            Writer()
            .i64(group_rank)
            .i64(step)
            .boolean(should_commit)
            .u64(int(timeout * 1000))
        )
        msg_type, r = self._call(MsgType.MGR_SHOULD_COMMIT_REQ, w.payload(), timeout)
        raise_if_error(msg_type, r)
        return r.boolean()

    def kill(self, msg: str, timeout: float = 10.0) -> None:
        msg_type, r = self._call(MsgType.MGR_KILL_REQ, Writer().string(msg).payload(), timeout)
        raise_if_error(msg_type, r)

    # -- spare warm channels ------------------------------------------------

    def warm_index(self, timeout: float = 10.0) -> Dict[str, object]:
        """Chunk-addressable index of the peer's staged warm snapshot:
        ``{"step", "total_len", "header_len", "header_digest",
        "leaf_nbytes"}``.  Raises WireError(NOT_FOUND) when nothing is
        staged (the peer has no spares to feed, or just committed)."""
        msg_type, r = self._call(MsgType.MGR_WARM_INDEX_REQ, b"", timeout)
        raise_if_error(msg_type, r)
        return {
            "step": r.i64(),
            "total_len": r.u64(),
            "header_len": r.u64(),
            "header_digest": r.string(),
            "leaf_nbytes": [r.u64() for _ in range(r.u32())],
            "chunk_target_bytes": r.u64(),
            "chunk_hashes": [r.u32() for _ in range(r.u32())],
        }

    def warm_range(
        self, step: int, start: int, stop: int, timeout: float = 30.0
    ) -> bytes:
        """Bytes [start, stop) of the warm snapshot staged at ``step``;
        NOT_FOUND when the snapshot moved (refetch the index)."""
        w = Writer().i64(step).u64(start).u64(stop)
        msg_type, r = self._call(MsgType.MGR_WARM_RANGE_REQ, w.payload(), timeout)
        raise_if_error(msg_type, r)
        r.i64()  # echoed step
        return r.blob()

    def deltas(
        self, after_step: int, after_frag: int, timeout: float = 10.0
    ) -> List[Tuple[int, int, bytes]]:
        """Outer-sync delta feed entries strictly newer than the
        ``(after_step, after_frag)`` cursor, oldest first."""
        w = Writer().i64(after_step).i64(after_frag)
        msg_type, r = self._call(MsgType.MGR_DELTA_REQ, w.payload(), timeout)
        raise_if_error(msg_type, r)
        return [(r.i64(), r.i64(), r.blob()) for _ in range(r.u32())]
