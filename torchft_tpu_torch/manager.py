"""Manager: the per-replica fault-tolerance state machine.

Behavioral twin of the reference Manager (``torchft/manager.py``), driving
the per-step protocol from an otherwise ordinary train loop:

- ``start_quorum()`` — compute a quorum (usually asynchronously, overlapped
  with the forward pass), reconfigure the communicator when membership
  changed, send live weights to recovering peers, and stage a healing
  checkpoint when this replica is behind (``manager.py:560-813``).
- ``allreduce()`` — average gradients across participating replicas with
  error swallowing and zero-contribution for non-participants
  (``manager.py:410-493``).
- ``should_commit()`` — fence recovery and collectives, pick up async
  errors, vote; commit advances the step, failure discards it
  (``manager.py:855-943``).

The port's copy of ``torchft_tpu/manager.py``: gradients arrive as host
numpy buckets (``ddp.allreduce_gradients`` copies them off the card), the
replica dimension runs host-side over TCP, and the gradient divisor
``num_participants()`` is a runtime scalar.  The device work of a step is
fenced by the ddp composite work, so the reference's stream/event
choreography collapses to thread joins (the ``_quorum_future``) and a plain
recovery event.  bf16 buckets arrive as their bit pattern (``bf16.py``)
and are divided as the JAX package divides ml_dtypes bf16, here or, for
the gradient path, on the card (``allreduce(normalize=False)``).  The sharded
outer sync of DiLoCo runs through ``outer_shard_allreduce``.  A heal
streams over ``HTTPTransport`` unless the caller passes another
``checkpoint_transport`` (``CommTransport`` heals over the communicator).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import socket
import threading
import time
import uuid
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple, TypeVar, Union, cast

import numpy as np

from torchft_tpu_torch import bf16, knobs
from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.obs.flight import FlightEvent, FlightRecorder, flight_dir
from torchft_tpu_torch.obs.spans import span as obs_span
from torchft_tpu_torch.observability import QuorumTracer, traced
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.communicator import Communicator, ReduceOp
from torchft_tpu_torch.manager_server import _WARM_RANGE_MAX_BYTES, ManagerClient, ManagerServer
from torchft_tpu_torch.quantization import quant_kind
from torchft_tpu_torch.store import StoreClient, StoreServer
from torchft_tpu_torch.work import DummyWork, Event, Work

logger = logging.getLogger(__name__)

T = TypeVar("T")

MANAGER_ADDR_KEY = "manager_addr"
REPLICA_ID_KEY = "replica_id"

# Env knobs (same names as the reference, ``manager.py:74-109``)
MANAGER_PORT_ENV = "TORCHFT_MANAGER_PORT"
LIGHTHOUSE_ENV = "TORCHFT_LIGHTHOUSE"
TIMEOUT_SEC_ENV = "TORCHFT_TIMEOUT_SEC"
QUORUM_TIMEOUT_SEC_ENV = "TORCHFT_QUORUM_TIMEOUT_SEC"
CONNECT_TIMEOUT_SEC_ENV = "TORCHFT_CONNECT_TIMEOUT_SEC"
QUORUM_RETRIES_ENV = "TORCHFT_QUORUM_RETRIES"
# Striped healing: fetch the recovery checkpoint as disjoint chunk ranges
# from EVERY up-to-date peer instead of one round-robin source (on by
# default; "0" pins the legacy single-peer heal).  See also
# TORCHFT_HEAL_CHUNK_MB (serialization), TORCHFT_HEAL_MAX_SOURCES
# (manager_server) and TORCHFT_HEAL_SOURCE_TIMEOUT_S (http_transport).
HEAL_STRIPED_ENV = "TORCHFT_HEAL_STRIPED"
# Hot spares: minimum seconds between warm-snapshot restagings on an
# active replica that has registered spares (each restage host-copies the
# state dict once; spares pull chunk ranges from whatever is staged).
SPARE_WARM_REFRESH_S_ENV = "TORCHFT_SPARE_WARM_REFRESH_S"


def _heal_striped_enabled() -> bool:
    return knobs.get_bool(HEAL_STRIPED_ENV, True)


def _env_timeout(env: str, default_s: float) -> float:
    return knobs.get_float(env, default_s)


def extract_trailing_digits(s: str) -> int:
    """Trailing integer of a replica-group name (``manager.py:112-121``),
    used to map replica ids like ``train_ddp_7`` to global rank math."""
    i = len(s) - 1
    while i >= 0 and s[i].isdigit():
        i -= 1
    return int(s[i + 1 :]) if i < len(s) - 1 else 0


class WorldSizeMode(Enum):
    """Numerics when more than ``min_replica_size`` replicas are healthy
    (``manager.py:123-139``): DYNAMIC grows the divisor with membership;
    FIXED_WITH_SPARES keeps exactly ``min_replica_size`` participants and
    spares contribute zero gradients."""

    DYNAMIC = 0
    FIXED_WITH_SPARES = 1


class ExceptionWithTraceback(Exception):
    def __init__(self, e: Exception) -> None:
        import traceback

        self.original_exception = e
        self.stack_trace: str = traceback.format_exc()
        super().__init__(f"{e}\n{self.stack_trace}")


class Manager:
    """Fault-tolerant training loop manager (``torchft/manager.py:148+``)."""

    def __init__(
        self,
        comm: Optional[Communicator] = None,
        load_state_dict: Optional[Callable[[T], None]] = None,
        state_dict: Optional[Callable[[], T]] = None,
        min_replica_size: int = 1,
        use_async_quorum: bool = True,
        timeout: float = 60.0,
        quorum_timeout: float = 60.0,
        connect_timeout: float = 60.0,
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        world_size_mode: WorldSizeMode = WorldSizeMode.DYNAMIC,
        store_addr: Optional[str] = None,
        store_port: Optional[int] = None,
        lighthouse_addr: Optional[str] = None,
        replica_id: Optional[str] = None,
        port: Optional[int] = None,
        hostname: Optional[str] = None,
        heartbeat_interval: float = 0.1,
        checkpoint_transport: Optional[CheckpointTransport] = None,
        init_sync: bool = True,
        max_retries: Optional[int] = None,
        quorum_retries: int = 0,
        _manager_client: Optional[ManagerClient] = None,
        _peer_client_factory: Optional[Callable[[str], ManagerClient]] = None,
        server_cls: Optional[type] = None,
        role: str = "active",
    ) -> None:
        from torchft_tpu_torch.observability import init_structured_logging

        init_structured_logging()  # no-op unless TORCHFT_USE_OTEL/LOG_DIR set
        self.quorum_logger = logging.getLogger("torchft_quorums")
        self.commits_logger = logging.getLogger("torchft_commits")
        self.errors_logger = logging.getLogger("torchft_errors")
        # per-replica flight recorder (obs/flight.py): the manager state
        # machine, the communicator's epoch lifecycle, and the heal path
        # all record into this ring; the replica id is stamped once known
        self._flight = FlightRecorder(replica_id=replica_id or "")

        self._load_state_dict_fns: Dict[str, Callable[[object], None]] = {}
        self._user_state_dicts: Dict[str, Callable[[], object]] = {}
        if load_state_dict and state_dict:
            self.register_state_dict_fn("default", load_state_dict, state_dict)

        self._timeout = _env_timeout(TIMEOUT_SEC_ENV, timeout)
        if comm is None:
            # tier-dispatched default: the native (cpp) mesh whenever the
            # library loads and the topology permits, else the Python tier
            # — so the train loop and the heal drain ride the production
            # data plane without every caller wiring
            # tier.make_communicator themselves
            from torchft_tpu_torch import tier as tier_mod

            comm = tier_mod.make_communicator(timeout_s=self._timeout)
        self._comm = comm
        # attach the recorder to the data plane: epoch configure/abort/
        # poison and lane recovery record into the same per-replica ring
        # (a plain attribute — every tier's communicator carries it)
        self._comm.flight = self._flight
        self._min_replica_size = min_replica_size
        self._use_async_quorum = use_async_quorum
        self._init_sync = init_sync
        self._max_retries = max_retries
        self._replica_world_size_mode = world_size_mode

        self._quorum_timeout = _env_timeout(QUORUM_TIMEOUT_SEC_ENV, quorum_timeout)
        self._connect_timeout = _env_timeout(CONNECT_TIMEOUT_SEC_ENV, connect_timeout)
        quorum_retries = knobs.get_int(QUORUM_RETRIES_ENV, quorum_retries)
        # fail fast on a bad TORCHFT_QUANT_KIND: inside the step it would
        # land in the error funnel and silently discard every step
        quant_kind()

        self._group_rank: int = rank if rank is not None else int(os.environ.get("RANK", 0))
        self._group_world_size: int = (
            world_size
            if world_size is not None
            else int(os.environ.get("WORLD_SIZE", 1))
        )
        hostname = hostname or socket.gethostname()

        # state dict guard: reads (checkpoint serving) vs writes (train loop)
        self._state_dict_lock = RWLock(timeout=self._timeout)
        # per-quorum profiler epochs (TORCHFT_TRACE_DIR; flight-recorder analog)
        self._tracer = QuorumTracer()

        self._pending_state_dict: Optional[Dict[str, object]] = None
        self._healing = False
        self._errored: Optional[ExceptionWithTraceback] = None
        self._recovery_event: Optional[Event] = None

        # outstanding Works issued this step via allreduce/
        # allreduce_prequantized; fenced at should_commit (the analog of the
        # reference's accelerator-stream synchronize, ``manager.py:888-893``)
        self._pending_works: List[Work] = []
        self._pending_works_lock = threading.Lock()
        # streamed fragment syncs (TORCHFT_STREAM_SYNC): per-fragment Works
        # submitted out-of-band of _pending_works so a round's vote never
        # silently fences them — should_commit instead REFUSES (votes
        # False) while any streamed sync is unresolved, the
        # begin_relower fence pattern, so a half-streamed sync can never
        # commit.  The scheduler resolves (waits) a fragment's work before
        # its barrier vote, making the fence a no-op on the healthy path.
        # frag -> (work, submit-time step): the step keys the
        # FRAG_SUBMIT/FRAG_COMMIT pair on the flight timeline
        self._stream_pending: Dict[int, Tuple[Work, int]] = {}

        self._step = 0
        self._batches_committed = 0
        self._commit_failures = 0
        self._quorum_id = -1
        # job-lifetime comm-health counters: completed epochs fold in at
        # each quorum change, live-epoch values ride on top — heartbeats
        # carry the (monotonic) sum to the lighthouse for straggler
        # detection
        self._comm_health_base: Dict[str, int] = {
            "stalls": 0,
            "reconnects": 0,
            "failovers": 0,
            "faults": 0,
            "tx_bytes": 0,
            "rx_bytes": 0,
        }
        # True between "outgoing epoch folded into base" and "mesh
        # reconfigured (live counters reset)": heartbeats landing in that
        # window must report base-only, or the outgoing epoch would count
        # twice and spike the lighthouse's stall-rate EWMA
        self._comm_health_folding = False
        self._quorum_future: Optional[concurrent.futures.Future] = None
        # phase wall-times of the most recent quorum round (see _async_quorum)
        self.last_quorum_timings: Dict[str, float] = {}
        # hot spares: this replica's quorum role ("active" | "spare" — a
        # spare drives spare.SpareAgent instead of the train loop and flips
        # to active at promotion), the spare ids the last quorum advertised
        # (gates warm staging / delta publishing on the active side), and
        # the warm snapshot staged for spare chunk fetches
        if role not in ("active", "spare"):
            raise ValueError(f"role must be 'active' or 'spare', got {role!r}")
        if role == "spare":
            from torchft_tpu_torch.wire import (
                WIRE_COMPAT_ENV,
                manager_quorum_wire_version,
            )

            if manager_quorum_wire_version() < 3:
                # refusing beats silently degrading: without the v3 role
                # tail the lighthouse would register this "spare" as a
                # full ACTIVE — counting toward min_replicas/majority and
                # training on a cold shadow at the first quorum
                raise ValueError(
                    "role='spare' requires quorum wire v3; unset (or raise) "
                    f"{WIRE_COMPAT_ENV} on this replica"
                )
        self._role = role
        # degraded mode (wire v5): the surviving-device fraction this
        # replica re-lowered onto (1.0 = full width), advertised on every
        # quorum registration and — while degraded — on heartbeats;
        # _relower_pending fences the commit vote between begin_relower()
        # and complete_relower() so a half-relowered replica never votes
        # commit; _participant_capacities is the whole quorum's capacity
        # vector (aligned with sorted replica ids) driving the data-shard
        # rescale and the weighted outer reduce
        self._capacity = 1.0
        self._relower_pending = False
        self._participant_capacities: List[float] = []
        self._spare_replica_ids: List[str] = []
        self._warm_staged: Optional[tuple] = None
        self._warm_staged_ts = 0.0
        # set by SpareAgent at promotion: the next start_quorum is a no-op
        # because the promotion quorum was already adopted
        self._adopted_quorum = False
        # delta-tap staging: the sharded outer sync taps its assembled
        # delta here; published to the spare feed only on a committed vote
        self._staged_outer_delta: Optional[bytes] = None
        # pipeline timings of the most recent sharded outer sync; ride the
        # next quorum-change event into torchft_quorums (outer_shard_*)
        self._outer_shard_stats: Dict[str, float] = {}
        self._participating_replica_rank: Optional[int] = None
        self._participating_replica_world_size: int = 0

        # one worker: quorum computation overlaps the forward pass
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tpuft_async_quorum"
        )

        if checkpoint_transport is None:
            from torchft_tpu_torch.checkpointing.http_transport import (
                HEAL_NUM_CHUNKS,
                HTTPTransport,
            )

            checkpoint_transport = HTTPTransport(
                timeout=self._timeout, num_chunks=HEAL_NUM_CHUNKS
            )
        self._checkpoint_transport: CheckpointTransport = checkpoint_transport

        self._own_store: Optional[StoreServer] = None
        self._manager_server: Optional[ManagerServer] = None
        self._peer_client_factory: Callable[[str], ManagerClient] = (
            _peer_client_factory
            or (lambda addr: ManagerClient(addr, connect_timeout=self._connect_timeout))
        )

        if _manager_client is not None:
            # test hook: fully mocked control plane (``manager_test.py:41-82``)
            self._client = _manager_client
            self._replica_id = replica_id or "testing"
            self._flight.set_replica_id(self._replica_id)
            self._store: Optional[StoreClient] = None
            return

        # -- store bootstrap ------------------------------------------------
        if store_addr is None:
            store_addr = os.environ.get("MASTER_ADDR")
            store_port = store_port or int(os.environ.get("MASTER_PORT", 0) or 0)
        if store_addr is None:
            if self._group_world_size != 1:
                raise ValueError(
                    "store_addr (or MASTER_ADDR) is required for multi-rank "
                    "replica groups"
                )
            # single-process replica group: own the store
            self._own_store = StoreServer("0.0.0.0:0")
            store_addr, store_port = "127.0.0.1", self._own_store.port
        self._store = StoreClient(
            f"{store_addr}:{store_port}", timeout=self._connect_timeout
        )
        # the store address peers will use for communicator rendezvous
        advertised_store = f"{hostname}:{store_port}"

        if self._group_rank == 0:
            if replica_id is None:
                replica_id = ""
            # keep the human prefix, add entropy so restarts are distinct
            # (``manager.py:316-320``)
            new_uuid = str(uuid.uuid4())
            replica_id = (
                new_uuid if replica_id in (None, "") else f"{replica_id}:{new_uuid}"
            )
            if lighthouse_addr is None:
                lighthouse_addr = os.environ[LIGHTHOUSE_ENV]
            bind_port = port or int(os.environ.get(MANAGER_PORT_ENV, 0))
            # server_cls lets deployments swap in the C++ sidecar
            # (torchft_tpu_torch.native.CppManagerServer) — same construction
            # surface
            from torchft_tpu_torch.wire import ROLE_ACTIVE, ROLE_SPARE

            self._manager_server = (server_cls or ManagerServer)(
                replica_id=replica_id,
                lighthouse_addr=lighthouse_addr,
                hostname=hostname,
                bind=f"0.0.0.0:{bind_port}",
                store_addr=advertised_store,
                world_size=self._group_world_size,
                heartbeat_interval=heartbeat_interval,
                connect_timeout=self._connect_timeout,
                quorum_retries=quorum_retries,
                health_fn=self._comm_health,
                role=ROLE_SPARE if role == "spare" else ROLE_ACTIVE,
                warm_fn=self._warm_snapshot,
                # spares ride their warm watermark on every beat (wire v4)
                # so promotion eligibility stays fresh without a quorum-RPC
                # re-registration; actives report nothing
                warm_step_fn=(
                    (lambda: self._step) if role == "spare" else None
                ),
                # degraded capacity rides quorum registrations (every
                # round) and, while < 1, direct heartbeats — read live so
                # complete_relower takes effect on the next beat
                capacity_fn=lambda: self._capacity,
                # /metrics provider: per-replica gauges from the same
                # registry that feeds last_quorum_timings (declared names
                # only — obs/metrics.py is the single source of truth)
                metrics_fn=self._metrics_snapshot,
            )
            # idle-priority warm serving: spare chunk fetches yield to live
            # collectives when the communicator exposes a busy probe
            busy_fn = getattr(self._comm, "busy", None)
            if callable(busy_fn) and hasattr(self._manager_server, "busy_fn"):
                self._manager_server.busy_fn = busy_fn
            self._store.set(MANAGER_ADDR_KEY, self._manager_server.address().encode())
            self._store.set(REPLICA_ID_KEY, replica_id.encode())

        addr = self._store.get(MANAGER_ADDR_KEY, timeout=self._connect_timeout).decode()
        self._replica_id = self._store.get(
            REPLICA_ID_KEY, timeout=self._connect_timeout
        ).decode()
        self._flight.set_replica_id(f"{self._replica_id}/{self._group_rank}")
        self._client = ManagerClient(addr, connect_timeout=self._connect_timeout)
        self._logger = _ManagerLogger(self, self._replica_id, self._group_rank)

    # ------------------------------------------------------------------
    # state dict registry
    # ------------------------------------------------------------------

    def register_state_dict_fn(
        self,
        key: str,
        load_state_dict: Callable[[T], None],
        state_dict: Callable[[], T],
    ) -> None:
        """Register one named (load, save) pair; all registered entries ride
        in the healing checkpoint (``manager.py:380-391``)."""
        self._load_state_dict_fns[key] = cast(Callable[[object], None], load_state_dict)
        self._user_state_dicts[key] = state_dict

    def disallow_state_dict_read(self) -> None:
        """Block checkpoint serving while the train loop mutates state
        (``manager.py:366-378``; used as the DiLoCo inner-step pre-hook)."""
        if getattr(self, "_state_dict_write_guard", None) is None:
            self._state_dict_write_guard = self._state_dict_lock.w_lock()

    def allow_state_dict_read(self) -> None:
        guard = getattr(self, "_state_dict_write_guard", None)
        if guard is not None:
            self._state_dict_write_guard = None
            guard.__exit__(None, None, None)

    def _manager_state_dict(self) -> Dict[str, object]:
        with self._state_dict_lock.r_lock():
            return {
                "user": {key: fn() for key, fn in self._user_state_dicts.items()},
                "torchft": self.state_dict(),
            }

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "batches_committed": self._batches_committed}

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        self._step = state_dict["step"]
        self._batches_committed = state_dict["batches_committed"]

    # ------------------------------------------------------------------
    # comm health (straggler-detection input)
    # ------------------------------------------------------------------

    def _comm_health(self):
        """Cumulative comm-health snapshot for the heartbeat: completed
        epochs' fold plus the live epoch's ``lane_stats()``."""
        from torchft_tpu_torch.wire import CommHealth

        base = self._comm_health_base
        stats_fn = getattr(self._comm, "lane_stats", None)
        live = (
            {}
            if self._comm_health_folding
            else stats_fn() if callable(stats_fn) else {}
        )
        return CommHealth(
            stalls=base["stalls"] + sum(live.get("lane_stalls") or []),
            reconnects=base["reconnects"]
            + int(live.get("lane_reconnects", 0) or 0),
            failovers=base["failovers"]
            + int(live.get("lane_failovers", 0) or 0),
            faults=base["faults"] + int(live.get("faults_injected", 0) or 0),
            tx_bytes=base["tx_bytes"] + sum(live.get("lane_tx_bytes") or []),
            rx_bytes=base["rx_bytes"] + sum(live.get("lane_rx_bytes") or []),
        )

    # mapping from last_quorum_timings keys to their declared /metrics
    # names (obs/metrics.py registry; the ftlint metrics-registry checker
    # pins every literal below to a declaration)
    _TIMING_METRICS = (
        ("quorum_rpc_s", "torchft_mgr_quorum_rpc_seconds"),
        ("configure_s", "torchft_mgr_configure_seconds"),
        ("heal_send_s", "torchft_mgr_heal_send_seconds"),
        ("heal_recv_s", "torchft_mgr_heal_recv_seconds"),
        ("heal_bytes_per_sec", "torchft_mgr_heal_bytes_per_sec"),
        ("ring_lanes", "torchft_mgr_ring_lanes"),
        ("outer_shard_overlap_ratio", "torchft_mgr_outer_shard_overlap_ratio"),
    )

    def _metrics_snapshot(self) -> Dict[str, float]:
        """Per-replica /metrics gauges for the ManagerServer endpoint —
        the same registry that feeds ``last_quorum_timings``.  Racy reads
        are fine: a scrape tolerates one stale value."""
        out: Dict[str, float] = {
            "torchft_mgr_step": float(self._step),
            "torchft_mgr_quorum_id": float(self._quorum_id),
            "torchft_mgr_capacity": float(self._capacity),
            "torchft_mgr_batches_committed_total": float(
                self._batches_committed
            ),
            "torchft_mgr_commit_failures": float(self._commit_failures),
            "torchft_mgr_flight_events": float(len(self._flight)),
            "torchft_mgr_flight_dumps_total": float(
                self._flight.dumps_total
            ),
        }
        timings = self.last_quorum_timings
        for key, name in self._TIMING_METRICS:
            value = timings.get(key)
            if value is not None:
                out[name] = float(value)
        return out

    # ------------------------------------------------------------------
    # hot spares (warm channels + promotion handshake)
    # ------------------------------------------------------------------

    @property
    def role(self) -> str:
        """``"active"`` or ``"spare"``; a spare flips at promotion."""
        return self._role

    def _promote_to_active(self) -> None:
        """Promotion handshake, spare side: from here on this replica
        registers with role=ACTIVE (acknowledging the lighthouse's
        promotion) and runs the normal train-loop state machine."""
        from torchft_tpu_torch.wire import ROLE_ACTIVE

        self._flight.record(FlightEvent.SPARE_PROMOTE, step=self._step)
        self._role = "active"
        if self._manager_server is not None:
            self._manager_server.role = ROLE_ACTIVE

    def _warm_snapshot(self) -> Optional[tuple]:
        """Server hook: the currently staged ``(step, PytreePlan)``."""
        return self._warm_staged

    def _maybe_stage_warm(self) -> None:
        """Active side of warm channel (b): after a commit, (re)stage a
        chunk-addressable snapshot of the state dict for spare warm
        fetches — rate-limited, entirely outside the heal path, and only
        while the quorum actually advertises spares.  The host copy runs
        on the quorum executor (behind this round's quorum RPC), NOT the
        train thread — staging a multi-GB state dict inline would tax
        every step by a full-model copy; the ``_state_dict_lock`` rwlock
        gives the executor thread the same consistency the heal path's
        executor-side ``send_checkpoint`` staging already relies on.
        Never raises: a failed staging costs warmth, not the step."""
        if (
            self._manager_server is None
            or not self._spare_replica_ids
            or self._role != "active"
        ):
            return
        interval = _env_timeout(SPARE_WARM_REFRESH_S_ENV, 1.0)
        now = time.monotonic()
        if self._warm_staged is not None and self._warm_staged[0] == self._step:
            return
        # rate-limit on the SUBMIT stamp, independent of whether a staging
        # has landed yet: while the first copy is still queued (or staging
        # keeps failing) the interval must still hold, or every round
        # would queue another full-model copy on the quorum executor
        if self._warm_staged_ts and now - self._warm_staged_ts < interval:
            return
        self._warm_staged_ts = now
        self._executor.submit(self._stage_warm_now)

    def _stage_warm_now(self) -> None:
        """Executor-side body of :meth:`_maybe_stage_warm`."""
        try:
            from torchft_tpu_torch.checkpointing.serialization import plan_pytree

            plan = plan_pytree(self._manager_state_dict(), snapshot=True)
            self._warm_staged = (self._step, plan)
        except Exception as e:  # noqa: BLE001 — warmth is best-effort
            self._logger.warn(f"warm snapshot staging failed: {e}")

    def _stage_outer_delta(self, delta: "np.ndarray") -> None:
        """collectives.outer_sharded_sync tap: hold the assembled delta
        bytes until the commit vote decides their fate.  A delta over the
        feed's frame budget is not staged: the feed would refuse it
        (``ManagerServer.publish_delta``), and at Llama-3-8B width a
        fragment's delta is gigabytes of host memory."""
        delta = np.asarray(delta, dtype=np.float32)
        if delta.nbytes > _WARM_RANGE_MAX_BYTES:
            self._staged_outer_delta = None
            self._logger.warn(
                f"outer delta of {delta.nbytes} bytes exceeds the spare feed's "
                "frame budget; not staged (spares warm via snapshot chunks)"
            )
            return
        self._staged_outer_delta = delta.tobytes()

    def publish_staged_outer_delta(self, frag: int) -> None:
        """Publish the delta the last sharded sync staged — call ONLY after
        a committed vote (an aborted sync's delta must never reach a
        spare's shadow)."""
        payload, self._staged_outer_delta = self._staged_outer_delta, None
        if payload is not None:
            self.publish_outer_delta(frag, payload)

    def publish_outer_delta(self, frag: int, payload: bytes) -> None:
        """Feed one COMMITTED outer-sync delta (identical bytes on every
        replica by construction) to subscribed spares — warm channel (a).
        No-op without a manager server or registered spares; never raises
        (a dead feed must not fail the committed step it describes)."""
        if self._manager_server is None or not self._spare_replica_ids:
            return
        publish = getattr(self._manager_server, "publish_delta", None)
        if not callable(publish):
            return  # C++ sidecar: no spare feed
        try:
            publish(self._step, frag, bytes(payload))
        except Exception as e:  # noqa: BLE001
            self._logger.warn(f"outer delta publish failed: {e}")

    # ------------------------------------------------------------------
    # degraded mode (survive in-replica device loss)
    # ------------------------------------------------------------------

    @property
    def capacity(self) -> float:
        """Surviving-device fraction this replica runs at (1.0 = full
        width).  Advertised to the lighthouse on every quorum registration
        (and on heartbeats while degraded) as the wire-v5 capacity tail."""
        return self._capacity

    def participant_capacities(self) -> List[float]:
        """Per-participant capacity fractions of the current quorum,
        aligned with the sorted replica-id order (empty on pre-v5 peers or
        before the first quorum).  Callers must hold a completed quorum
        (``wait_quorum``) — the data-shard rescale path does."""
        return list(self._participant_capacities)

    def begin_relower(self) -> None:
        """Mark the start of a degraded re-lower (device loss detected;
        inner mesh about to be rebuilt on the survivors).  Between here and
        :meth:`complete_relower` every commit vote is forced False: a
        half-relowered replica holds inner state that is neither the old
        nor the new layout, and a commit landing in that window would fork
        it from the fleet.  Idempotent; crash-safe by construction (a
        replica that dies mid-relower simply never voted commit)."""
        self._flight.record(FlightEvent.RELOWER_BEGIN, step=self._step)
        self._relower_pending = True

    def complete_relower(self, capacity: float) -> None:
        """Finish a degraded re-lower: the inner mesh is consistent again
        on the surviving devices and this replica now runs at ``capacity``
        (0 < capacity <= 1).  Lifts the commit fence and advertises the new
        fraction on the next quorum registration/heartbeat.  Also the
        restore path: ``complete_relower(1.0)`` after the wounded devices
        heal re-admits a swapped-out replica."""
        if not 0.0 < capacity <= 1.0:
            raise ValueError(
                f"capacity must be in (0, 1], got {capacity!r}"
            )
        if capacity < 1.0 and self._manager_server is not None and not hasattr(
            self._manager_server, "_capacity_fn"
        ):
            # the C++ sidecar has no capacity plumbing: registering
            # full-width while actually degraded would make peers weight
            # this replica's starved contribution at full strength —
            # refuse loudly (docs/operations.md §16 fallback matrix)
            raise RuntimeError(
                "degraded mode requires the Python control plane; this "
                "replica's manager server does not advertise capacity"
            )
        self._capacity = capacity
        self._relower_pending = False
        self._flight.record(
            FlightEvent.RELOWER_COMPLETE, step=self._step, capacity=capacity
        )
        self._logger.info(
            f"re-lower complete: running at capacity {capacity:.3f}"
        )

    def _capacity_weights_engaged(self) -> bool:
        """True when the outer reduce must be capacity-weighted this step.
        A pure function of quorum facts (the capacity vector and the
        participant count), so every rank reaches the same verdict — a
        split decision would fork the divisor across the fleet.  Weighted
        mode requires participation to cover the whole quorum (sync-quorum
        rounds, or async rounds with nobody healing): with healers
        excluded, capacity shares normalized over all members would
        mis-scale the average, so those rounds fall back to the uniform
        1/num_participants divisor."""
        caps = self._participant_capacities
        return bool(
            caps
            and any(c < 1.0 for c in caps)
            and sum(caps) > 0.0
            and self._participating_replica_world_size == len(caps)
        )

    def _own_capacity_weight(self) -> float:
        """This replica's normalized capacity share w_i = cap_i / Σ cap
        under the current quorum (0.0 when not participating).  Only
        meaningful when :meth:`_capacity_weights_engaged` is True."""
        caps = self._participant_capacities
        rank = self._participating_replica_rank
        if rank is None or not 0 <= rank < len(caps):
            return 0.0
        return caps[rank] / sum(caps)

    def _capacity_weight_scale(self) -> Optional[float]:
        """Pre-scale factor turning the standard ``sum / num_participants``
        average into the capacity-weighted average: ``w_i × N`` applied to
        this replica's contribution before the collective, so the shared
        post-division yields ``Σ w_i · g_i``.  None when unweighted."""
        if not self._capacity_weights_engaged():
            return None
        return self._own_capacity_weight() * self.num_participants()

    # ------------------------------------------------------------------
    # error funnel
    # ------------------------------------------------------------------

    def errored(self) -> Optional[ExceptionWithTraceback]:
        return self._errored

    def report_error(self, e: Exception) -> None:
        """Record an error for this step; the step will be voted down at
        commit instead of raising into the train loop
        (``manager.py:495-520``)."""
        wrapped = (
            e
            if isinstance(e, ExceptionWithTraceback)
            else ExceptionWithTraceback(e)
        )
        self._errored = wrapped
        self._flight.record(
            FlightEvent.ERROR, step=self._step, error=str(e)[:200]
        )
        self._flight.maybe_dump("error_funnel")
        self.errors_logger.info(
            "",
            extra={
                "job_id": os.environ.get("JOB_ID", "unknown"),
                "replica_id": self._replica_id,
                "rank": self._group_rank,
                "quorum_id": self._quorum_id,
                "step": self._step,
                "error": str(e),
            },
        )

    def wrap_work(self, work: Work, default: object) -> Work:
        """Swallow errors from async work: on failure, record and substitute
        ``default`` (``manager.py:522-558``)."""

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _chain(f: concurrent.futures.Future) -> None:
            err = f.exception()
            if err is not None:
                if isinstance(err, Exception):
                    self.report_error(err)
                fut.set_result(default)
            else:
                fut.set_result(f.result())

        work.future().add_done_callback(_chain)
        return Work(fut)

    # ------------------------------------------------------------------
    # quorum
    # ------------------------------------------------------------------

    def start_quorum(
        self,
        allow_heal: bool = True,
        shrink_only: bool = False,
        timeout: Optional[float] = None,
    ) -> None:
        """Compute a new quorum and ready the manager for a new step
        (``manager.py:560-615``)."""
        if self._adopted_quorum:
            # promotion handshake: the spare already adopted a quorum (and
            # possibly a heal) for THIS step via spare.SpareAgent — a fresh
            # RPC would park against actives mid-rendezvous.  Consume the
            # flag; the pending future/recovery event fence as usual.
            self._adopted_quorum = False
            return
        if self._quorum_future is not None:
            try:
                self._quorum_future.result()
            except Exception:  # noqa: BLE001
                # already funneled (or about to be superseded): the failed
                # step was voted down at should_commit; the retry starting
                # here must not re-raise the same error into the train loop
                pass

        self._errored = None
        self._healing = False
        self._flight.set_context(step=self._step)
        self._flight.record(FlightEvent.QUORUM_START, step=self._step)
        # drop stale works from a step the caller abandoned without voting;
        # RESOLVED stream entries whose barrier never ran are abandoned the
        # same way (their staged outer state was never adopted), but an
        # entry still in flight stays — the vote fence must keep refusing
        # until the collective actually drains
        with self._pending_works_lock:
            self._pending_works.clear()
            self._stream_pending = {
                f: e for f, e in self._stream_pending.items() if not e[0].done()
            }

        self._quorum_future = self._executor.submit(
            self._async_quorum,
            allow_heal=allow_heal,
            shrink_only=shrink_only,
            quorum_timeout=timeout or self._quorum_timeout,
        )
        # hot spares, warm channel (b): (re)stage a chunk-addressable
        # snapshot of the state dict for spare warm fetches.  HERE — not at
        # the commit vote — because state is quiescent at a step boundary:
        # every committed update is fully applied and ``_step`` labels it
        # exactly (the same consistency model heal staging relies on).
        # Submitted AFTER the quorum so the copy queues behind this
        # round's RPC on the (single-thread) executor, never ahead of it.
        self._maybe_stage_warm()
        if not self._use_async_quorum:
            # sync quorum (DiLoCo/LocalSGD): a failed quorum RPC funnels to
            # a False vote like everywhere else, never into the train loop
            try:
                self.wait_quorum()
            except Exception as e:  # noqa: BLE001
                self.report_error(e)
                return
            if self._healing:
                # heal eagerly so the forward pass runs on good state
                self._apply_pending_state_dict()
                self._healing = False

    @traced("torchft::manager::wait_quorum")
    def wait_quorum(self) -> None:
        """Block until the pending quorum completes; the communicator is in a
        healthy (re)configured state afterwards (``manager.py:617-627``)."""
        assert self._quorum_future is not None, (
            "must call start_quorum before wait_quorum"
        )
        self._quorum_future.result()

    @traced("torchft::manager::_async_quorum")
    def _async_quorum(
        self, allow_heal: bool, shrink_only: bool, quorum_timeout: float
    ) -> None:
        # per-phase wall times of THIS quorum round, for heal attribution
        # (bench/operators read it after wait_quorum; the reference leaves
        # this to profiler spans — a dict is greppable in a kill report)
        timings: Dict[str, float] = {}
        self.last_quorum_timings = timings
        t0 = time.monotonic()
        with obs_span("manager::quorum_rpc", step=self._step):
            quorum = self._client._quorum(
                group_rank=self._group_rank,
                step=self._step,
                checkpoint_metadata=self._checkpoint_transport.metadata(),
                shrink_only=shrink_only,
                timeout=quorum_timeout,
                init_sync=self._init_sync,
                commit_failures=self._commit_failures,
            )
        timings["quorum_rpc_s"] = time.monotonic() - t0
        self._adopt_quorum(quorum, allow_heal, timings)

    def _adopt_quorum(
        self,
        quorum,
        allow_heal: bool,
        timings: Dict[str, float],
    ) -> None:
        """Apply one quorum result: reconfigure the communicator on a
        membership change, serve/fetch heals, and refresh participation
        facts.  Factored out of :meth:`_async_quorum` so a promoted spare
        can adopt the quorum it was handed by the promotion fast-path
        WITHOUT issuing a fresh quorum RPC (the actives are already parked
        in mesh rendezvous waiting for it)."""
        # registered spares this round (v3; empty on legacy peers) gate the
        # active-side warm channels
        self._spare_replica_ids = list(quorum.spare_replica_ids)
        # per-participant capacities (v5; empty on legacy peers): the
        # weighted-outer-reduce and data-shard-rescale inputs — refreshed
        # every round even without a membership change, since a wound
        # never bumps quorum_id by itself
        self._participant_capacities = list(
            getattr(quorum, "participant_capacities", None) or []
        )

        quorum_id = quorum.quorum_id
        replica_rank = quorum.replica_rank
        replica_world_size = quorum.replica_world_size
        heal = quorum.heal
        max_step = quorum.max_step

        # ``ranks_in_quorum``: global ranks across the whole job
        # (``manager.py:668-672``)
        ranks_in_quorum = [
            extract_trailing_digits(rid.split(":")[0]) * self._group_world_size
            + self._group_rank
            for rid in quorum.replica_ids
        ]

        # async quorum → healers are excluded (max-step set); sync quorum →
        # everyone counts because heal completes before the step
        self._participating_replica_rank, self._participating_replica_world_size = (
            (quorum.max_replica_rank, quorum.max_world_size)
            if self._use_async_quorum or not allow_heal
            else (replica_rank, replica_world_size)
        )

        if self._replica_world_size_mode == WorldSizeMode.FIXED_WITH_SPARES:
            self._participating_replica_world_size = min(
                self._participating_replica_world_size, self._min_replica_size
            )
            if (
                self._participating_replica_rank is not None
                and self._participating_replica_rank >= self._min_replica_size
            ):
                self._participating_replica_rank = None

        if quorum_id != self._quorum_id:
            # lane counters of the OUTGOING epoch (bytes/stalls accumulated
            # since its configure) ride the quorum-change event: per-lane
            # imbalance or a stall-heavy lane is visible per epoch without
            # any scraping of the data plane itself
            quorum_extra = {
                "job_id": os.environ.get("JOB_ID", "unknown"),
                "replica_id": self._replica_id,
                "rank": self._group_rank,
                "quorum_id": quorum_id,
                "step": max_step,
            }
            if self._outer_shard_stats:
                # sharded-outer-sync pipeline timings of the outgoing epoch
                # (scatter/update/gather + overlap ratio) ride the same
                # event, then reset so an epoch with no sharded sync never
                # re-reports a stale overlap_ratio
                quorum_extra.update(self._outer_shard_stats)
                self._outer_shard_stats = {}
            coord_stats_fn = getattr(
                self._manager_server, "coord_stats", None
            )
            if callable(coord_stats_fn):
                # coordination-plane beat routing of this replica (via-agg
                # vs direct vs fallbacks) rides the same event
                quorum_extra.update(coord_stats_fn())
            lane_stats_fn = getattr(self._comm, "lane_stats", None)
            prev_lane_stats = lane_stats_fn() if callable(lane_stats_fn) else {}
            if prev_lane_stats:
                quorum_extra.update(
                    comm_lanes=prev_lane_stats.get("lanes"),
                    comm_lane_tx_bytes=prev_lane_stats.get("lane_tx_bytes"),
                    comm_lane_rx_bytes=prev_lane_stats.get("lane_rx_bytes"),
                    comm_lane_stalls=prev_lane_stats.get("lane_stalls"),
                    comm_lane_reconnects=prev_lane_stats.get(
                        "lane_reconnects", 0
                    ),
                    comm_lane_failovers=prev_lane_stats.get(
                        "lane_failovers", 0
                    ),
                    comm_injected_faults=prev_lane_stats.get(
                        "faults_injected", 0
                    ),
                )
                # fold the OUTGOING epoch's counters into the job-lifetime
                # base the heartbeat health summary reports from; from here
                # until the fresh mesh is configured the live counters are
                # already IN the base, so heartbeats report base-only
                self._comm_health_folding = True
                base = self._comm_health_base
                base["stalls"] += sum(prev_lane_stats.get("lane_stalls") or [])
                base["reconnects"] += int(
                    prev_lane_stats.get("lane_reconnects", 0) or 0
                )
                base["failovers"] += int(
                    prev_lane_stats.get("lane_failovers", 0) or 0
                )
                base["faults"] += int(
                    prev_lane_stats.get("faults_injected", 0) or 0
                )
                base["tx_bytes"] += sum(
                    prev_lane_stats.get("lane_tx_bytes") or []
                )
                base["rx_bytes"] += sum(
                    prev_lane_stats.get("lane_rx_bytes") or []
                )
                # gray-failure counters next to the phase wall-times, so a
                # drill can assert in-epoch recovery without scraping logs
                timings["comm_lane_reconnects"] = float(
                    base["reconnects"]
                )
                timings["comm_lane_failovers"] = float(base["failovers"])
                timings["comm_injected_faults"] = float(base["faults"])
                if prev_lane_stats.get("topo_hosts"):
                    # hierarchical-topology counters of the outgoing epoch:
                    # host grouping + shared-memory bytes that never touched
                    # the DCN (the cross-host byte reduction, observable)
                    quorum_extra.update(
                        comm_topo_hosts=prev_lane_stats.get("topo_hosts"),
                        comm_topo_local_world=prev_lane_stats.get(
                            "topo_local_world"
                        ),
                        comm_shm_bytes=(
                            int(prev_lane_stats.get("shm_tx_bytes", 0))
                            + int(prev_lane_stats.get("shm_rx_bytes", 0))
                        ),
                    )
            self.quorum_logger.info("", extra=quorum_extra)
            store_prefixed_addr = (
                f"{quorum.store_address}/torchft/{quorum_id}/{self._group_rank}"
            )
            self._logger.info(
                f"reconfiguring for quorum_id={quorum_id} store={store_prefixed_addr}"
            )
            # fresh profiler epoch per quorum (flight-recorder analog)
            self._tracer.on_quorum_change(quorum_id)
            # the (quorum_id, step) pair stamped here is the correlation
            # anchor flight_merge aligns replicas' clocks on
            self._flight.set_context(step=max_step, quorum_id=quorum_id)
            self._flight.record(
                FlightEvent.QUORUM_ADOPT,
                step=max_step,
                quorum_id=quorum_id,
                world=replica_world_size,
                replica_rank=replica_rank,
            )
            t_cfg = time.monotonic()
            try:
                self._quorum_id = quorum_id
                with obs_span(
                    "manager::comm_configure", quorum_id=quorum_id
                ):
                    self._comm.configure(
                        store_prefixed_addr,
                        self._replica_id if self._replica_id is not None else "0",
                        replica_rank,
                        replica_world_size,
                        quorum_id=quorum_id,
                        group_rank=self._group_rank,
                        group_world_size=self._group_world_size,
                        global_ranks=ranks_in_quorum,
                    )
            except Exception as e:  # noqa: BLE001
                self._logger.exception(f"got exception in comm configure: {e}")
                self.report_error(e)
                return
            finally:
                self._comm_health_folding = False
                timings["configure_s"] = time.monotonic() - t_cfg
            # lane layout of the fresh epoch (benches/operators read it from
            # last_quorum_timings next to the phase wall-times)
            fresh_lane_stats = (
                lane_stats_fn() if callable(lane_stats_fn) else {}
            )
            if fresh_lane_stats.get("lanes"):
                timings["ring_lanes"] = float(fresh_lane_stats["lanes"])
                timings["ring_stripe_floor_bytes"] = float(
                    fresh_lane_stats.get("stripe_floor_bytes", 0)
                )
            if fresh_lane_stats.get("topo_hosts"):
                # topology of the fresh epoch, next to the phase wall-times
                timings["topo_hosts"] = float(fresh_lane_stats["topo_hosts"])
                timings["topo_local_world"] = float(
                    fresh_lane_stats.get("topo_local_world", 1)
                )

        if allow_heal:
            # The reference runs recovery on a dedicated CUDA stream
            # (``manager.py:746-813``); here the quorum thread *is* the
            # recovery lane and the event fences should_commit.
            recovery_event = Event()
            # striped healing engages only when the quorum advertised 2+
            # up-to-date sources (wire v2) and the env gate is on; the
            # single-peer path below is the byte-for-byte legacy behavior
            # and the automatic P=1 fallback
            striped_sources = (
                quorum.recover_src_replica_ranks if _heal_striped_enabled() else []
            )
            i_am_striped_source = (
                len(striped_sources) > 1
                and replica_rank in striped_sources
                and bool(quorum.all_recover_dst_replica_ranks)
            )
            try:
                send_dsts = (
                    list(quorum.all_recover_dst_replica_ranks)
                    if i_am_striped_source
                    else list(quorum.recover_dst_replica_ranks)
                )
                if send_dsts:
                    self._logger.info(f"peers need recovery from us {send_dsts}")
                    t_send = time.monotonic()
                    self._flight.record(
                        FlightEvent.HEAL_SEND_BEGIN,
                        step=max_step,
                        dst_ranks=list(send_dsts),
                        striped=i_am_striped_source,
                    )
                    with obs_span("manager::heal_send", step=max_step):
                        if i_am_striped_source:
                            self._checkpoint_transport.send_checkpoint_striped(
                                dst_ranks=send_dsts,
                                step=max_step,
                                state_dict=self._manager_state_dict(),
                                timeout=self._timeout,
                                source_index=striped_sources.index(replica_rank),
                                num_sources=len(striped_sources),
                            )
                        else:
                            self._checkpoint_transport.send_checkpoint(
                                dst_ranks=send_dsts,
                                step=max_step,
                                state_dict=self._manager_state_dict(),
                                timeout=self._timeout,
                            )
                    timings["heal_send_s"] = time.monotonic() - t_send
                    self._flight.record(
                        FlightEvent.HEAL_SEND_END,
                        step=max_step,
                        duration_s=round(timings["heal_send_s"], 4),
                    )

                if heal:
                    t_recv = time.monotonic()
                    self._healing = True
                    self._flight.record(
                        FlightEvent.HEAL_RECV_BEGIN,
                        step=max_step,
                        sources=len(striped_sources) or 1,
                    )
                    if len(striped_sources) > 1:
                        with obs_span("manager::heal_recv", step=max_step):
                            self._pending_state_dict = self._recv_striped_checkpoint(
                                quorum.heal_sources(), max_step, timings
                            )
                    else:
                        self._logger.info(
                            "healing required, fetching checkpoint metadata from "
                            f"{quorum.recover_src_manager_address} max_step={max_step}"
                        )
                        primary_client = self._peer_client_factory(
                            quorum.recover_src_manager_address
                        )
                        checkpoint_metadata = primary_client._checkpoint_metadata(
                            self._group_rank, timeout=self._timeout
                        )
                        primary_client.close()
                        recover_src_replica_rank = quorum.recover_src_replica_rank
                        assert recover_src_replica_rank is not None, (
                            "must have a recover rank when healing"
                        )
                        self._logger.info(
                            f"fetching checkpoint from {recover_src_replica_rank=} "
                            f"with {checkpoint_metadata=}"
                        )
                        # applied on the main thread at should_commit when safe
                        with obs_span("manager::heal_recv", step=max_step):
                            self._pending_state_dict = (
                                self._checkpoint_transport.recv_checkpoint(
                                    src_rank=recover_src_replica_rank,
                                    metadata=checkpoint_metadata,
                                    step=max_step,
                                    timeout=self._timeout,
                                )
                            )
                    self.load_state_dict(
                        cast(Dict[str, int], self._pending_state_dict["torchft"])
                    )
                    self._step = max_step
                    timings["heal_recv_s"] = time.monotonic() - t_recv
                    self._flight.set_context(step=max_step)
                    self._flight.record(
                        FlightEvent.HEAL_RECV_END,
                        step=max_step,
                        duration_s=round(timings["heal_recv_s"], 4),
                    )
            except Exception as e:  # noqa: BLE001
                self._logger.exception(f"got exception in recovery: {e}")
                self.report_error(e)
            recovery_event.record()
            self._recovery_event = recovery_event

    def _recv_striped_checkpoint(
        self,
        sources: List,
        max_step: int,
        timings: Dict[str, float],
    ) -> Dict[str, object]:
        """Striped multi-source heal: collect each source's transport
        metadata (tolerating unreachable managers — a dead source stays in
        the list as a positional placeholder so chunk assignments agree
        across peers) and fetch disjoint chunk ranges from all of them."""
        self._logger.info(
            f"healing required, striped fetch from {len(sources)} sources "
            f"max_step={max_step}"
        )
        src_list: List = []
        for src_rank, addr in sources:
            metadata: Optional[str] = None
            try:
                peer = self._peer_client_factory(addr)
                metadata = peer._checkpoint_metadata(
                    self._group_rank, timeout=self._timeout
                )
                peer.close()
            except Exception as e:  # noqa: BLE001 — source-level failover
                self._logger.warn(
                    f"heal source {src_rank} at {addr} unreachable: {e}"
                )
            src_list.append((src_rank, metadata))
        if all(metadata is None for _, metadata in src_list):
            raise RuntimeError(
                f"no heal source produced checkpoint metadata ({sources})"
            )
        state = self._checkpoint_transport.recv_checkpoint_striped(
            sources=src_list, step=max_step, timeout=self._timeout
        )
        metrics = getattr(self._checkpoint_transport, "last_heal_metrics", None)
        if metrics is not None:
            from torchft_tpu_torch.observability import log_heal

            timings["heal_bytes"] = float(metrics.bytes_total)
            timings["heal_bytes_per_sec"] = metrics.bytes_per_sec
            timings["heal_num_sources"] = float(metrics.num_sources)
            timings["heal_stolen_chunks"] = float(metrics.stolen_chunks)
            log_heal(
                metrics,
                replica_id=self._replica_id,
                rank=self._group_rank,
                quorum_id=self._quorum_id,
            )
        return cast(Dict[str, object], state)

    def _apply_pending_state_dict(self) -> None:
        assert self._healing, "must be in healing state"
        assert self._quorum_future is not None, "must call step before should_commit"
        self._quorum_future.result()

        pending_state_dict = self._pending_state_dict
        if pending_state_dict is None:
            assert self.errored(), "checkpoint was not staged and no error occurred"
            return
        self._logger.info("applying pending state dict")
        assert self._load_state_dict_fns, "user load_state_dict is not initialized"
        pending_user = cast(Dict[str, object], pending_state_dict["user"])
        with self._state_dict_lock.w_lock(), obs_span("manager::heal_apply", step=self._step):
            for key, load_fn in self._load_state_dict_fns.items():
                load_fn(pending_user[key])
            self._pending_state_dict = None
        self._flight.record(FlightEvent.HEAL_APPLY, step=self._step)
        self._logger.info("Loaded state dict.")

    # ------------------------------------------------------------------
    # gradient averaging
    # ------------------------------------------------------------------

    def allreduce_is_identity(self) -> bool:
        """True when the replica-dim average is mathematically the identity
        (single-member communicator, this replica fully participating) —
        callers may then skip device↔host gradient movement entirely, the
        analog of a world-size-1 NCCL allreduce being free."""
        try:
            self.wait_quorum()
        except Exception as e:  # noqa: BLE001 — funnel, never raise
            self.report_error(e)
            return False
        return (
            self._comm.size() <= 1
            and self.num_participants() == 1
            and self.is_participating()
            and self._errored is None
        )

    def allreduce(
        self,
        data: Union[np.ndarray, List[np.ndarray]],
        should_quantize: bool = False,
        in_place: bool = False,
        stream: Optional[int] = None,
        register_pending: bool = True,
        normalize: bool = True,
    ) -> Work:
        """Fault-tolerant AVG allreduce of gradients across the participating
        replicas (``manager.py:410-493``).

        Returns a Work whose value is the averaged array(s).  If an error was
        already recorded this step the input is returned unchanged; if this
        replica is not participating (healing/spare) its contribution is
        zeroed and the result is still divided by ``num_participants()``.

        ``in_place=True`` skips the communicator's full-payload defensive
        copy by reducing directly in ``data``'s buffers — pass it ONLY for
        buffers you built for this call and will not read afterwards (the
        ddp bucket path does); buffers that alias live state (LocalSGD's
        host params) must keep the default.

        ``stream``, when given, marks this as an ASYNC streamed fragment
        submit (the TORCHFT_STREAM_SYNC scheduler riding the legacy
        replicated outer wire): the work registers in the stream-fence
        registry instead of ``_pending_works`` — same contract as
        :meth:`outer_shard_allreduce`'s ``stream``.

        ``register_pending=False`` registers the work NOWHERE: for
        constituent works whose owner fences a composite covering them
        (``ddp.allreduce_pytree``'s streamed bucket rings — the composite
        is what rides the stream-fence registry).

        ``normalize=False`` leaves the divide to the caller: the value is
        the SUM, to be divided by ``num_participants()`` (``ddp.py``
        divides each gradient bucket on the card).  On an error the value
        is still the input unchanged.
        """

        def _failed_fast(w: Work) -> Work:
            # a fail-fast streamed submit still registers (and stamps
            # FRAG_SUBMIT): the caller's barrier will stream_resolved the
            # fragment, and a FRAG_ABORT must always have a paired submit
            # on the flight timeline
            return w if stream is None else self.stream_submitted(stream, w)

        if self.errored():
            return _failed_fast(DummyWork(data))

        # a failed quorum funnels like any collective error: the input rides
        # through unchanged and the vote discards the step — errors must
        # never propagate into the train loop (``manager.py:487-493``)
        try:
            self.wait_quorum()
        except Exception as e:  # noqa: BLE001
            self.report_error(e)
            return _failed_fast(DummyWork(data))
        num_participants = self.num_participants()

        if not self.is_participating():
            # contribute zeros (the reference zeroes the grad tensors in
            # place, ``manager.py:441-442``; inputs here may be views the
            # caller still reads, so swap in zero buffers instead)
            if isinstance(data, np.ndarray):
                data = np.zeros_like(data)
            else:
                data = [np.zeros_like(a) for a in data]
        elif (scale := self._capacity_weight_scale()) is not None:
            # degraded fleet: pre-scale this replica's contribution by
            # w_i × N so the shared 1/N post-division yields the
            # capacity-weighted average Σ w_i·g_i — matching the
            # capacity-proportional data shards each replica processed.
            # The collective's summed bytes stay identical on every rank,
            # so replicas never fork.  Integer grads are left unweighted
            # (fractional scaling would truncate them to garbage).
            data = _scale_contribution(data, scale)

        try:
            if should_quantize:
                from torchft_tpu_torch.collectives import allreduce_quantized

                # wire format for the quantized ring: int8 (default) or
                # fp8 e4m3 via TORCHFT_QUANT_KIND
                work = allreduce_quantized(self._comm, data, kind=quant_kind())
            else:
                work = self._comm.allreduce(data, ReduceOp.SUM, in_place=in_place)

            # AVG = SUM / runtime participant count — replica count is never
            # baked into compiled programs (SURVEY.md §7 hard part 1)
            def _normalize(value: object) -> object:
                with obs_span("manager::avg", step=self._step):
                    if isinstance(value, np.ndarray):
                        return _div(value, num_participants)
                    return [_div(a, num_participants) for a in cast(list, value)]

            wrapped = self.wrap_work(work.then(_normalize) if normalize else work, data)
            if stream is not None:
                self.stream_submitted(stream, wrapped)
            elif register_pending:
                self._register_pending(wrapped)
            return wrapped
        except Exception as e:  # noqa: BLE001
            self._logger.exception(f"got exception in all reduce -- skipping remaining: {e}")
            self.report_error(e)
            return _failed_fast(DummyWork(data))

    def allreduce_prequantized(
        self, q: np.ndarray, scales: np.ndarray, n: int
    ) -> Work:
        """Fault-tolerant SUM-allreduce of an already-quantized stream (int8
        or fp8 rows + rowwise f32 scales, e.g. quantized on the card by
        ``ops.quant``), to be divided by ``num_participants()`` by the
        caller.

        Same orchestration contract as :meth:`allreduce`: waits the quorum,
        zeroes the contribution of non-participants, swallows errors into a
        failed vote, and returns a pending Work (the wire pipeline runs
        off-thread) whose value is the reduced stream ``(q, scales)``,
        written into the arrays given when this replica contributes them,
        whose dequantize is the f32 SUM of length ``n`` (on a hierarchical
        topology, the f32 SUM itself).  ``ddp.py`` dequantizes and divides
        it on the card.  On error the value is the input, mirroring the
        unquantized input-passthrough."""
        from torchft_tpu_torch.collectives import allreduce_prequantized

        if self.errored():
            return DummyWork((q, scales))

        try:
            self.wait_quorum()
        except Exception as e:  # noqa: BLE001 — funnel, never raise
            self.report_error(e)
            return DummyWork((q, scales))
        q_in, s_in = q, scales
        if not self.is_participating():
            q_in = np.zeros_like(q)
            s_in = np.zeros_like(scales)
        elif (scale := self._capacity_weight_scale()) is not None:
            # weighted average on an already-quantized stream: the 1-byte
            # payload is untouchable, but dequant = q × scale — so the
            # capacity weight rides the rowwise scales
            s_in = (np.asarray(scales, np.float32) * np.float32(scale))

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _run() -> None:
            try:
                with obs_span("quant::pipeline", step=self._step):
                    reduced = allreduce_prequantized(self._comm, q_in, s_in, n, dequantize=False)
                fut.set_result(reduced)
            except Exception as e:  # noqa: BLE001 — funnel, never raise
                self.report_error(e)
                fut.set_result((q, scales))

        threading.Thread(
            target=_run, name="tpuft_prequantized_allreduce", daemon=True
        ).start()
        out = Work(fut)
        self._register_pending(out)
        return out

    def outer_shard_group(self) -> tuple:
        """``(group_size, group_index, owns_shard)`` for the sharded outer
        optimizer under the CURRENT quorum: flat topologies shard across the
        communicator world (one shard per replica); hierarchical topologies
        shard across HOSTS (owners are the host leaders — members ride the
        shared-memory hops and own no outer state).  Callers must hold a
        completed quorum (``wait_quorum``) — the fragment sync path does."""
        comm = self._comm
        topo_fn = getattr(comm, "hier_topology", None)
        topo = topo_fn() if callable(topo_fn) else None
        if topo:
            ring = list(topo["leader_ring"])
            if topo["is_leader"]:
                return len(ring), ring.index(comm.rank()), True
            return len(ring), -1, False
        ws = max(1, comm.size())
        return ws, comm.rank() if ws > 1 else 0, True

    def outer_shard_allreduce(
        self,
        flat: np.ndarray,
        update_cb: Callable[[int, int, np.ndarray], np.ndarray],
        should_quantize: bool = False,
        stream: Optional[int] = None,
        device: Optional["torch.device"] = None,
    ) -> Work:
        """Fault-tolerant sharded outer sync (ZeRO-1 over the replica dim):
        chunk-pipelined ``reduce_scatter → update_cb → allgather`` of the
        flat f32 pseudo-gradient, normalized by ``num_participants()``.

        Same orchestration contract as :meth:`allreduce`: waits the quorum,
        zeroes the contribution of non-participants (they still run the
        collective schedule and apply the same deltas, so params never
        fork), funnels errors into a failed vote, and returns a pending
        Work.  The value is the f32 delta (``params = backup + delta``) —
        or ``None`` after any error, which the caller must treat as a
        discarded step (the vote will be False).  Pipeline phase timings
        land in ``last_quorum_timings`` as ``outer_shard_*``.

        ``stream``, when given, is the fragment index of an ASYNC streamed
        submit (the TORCHFT_STREAM_SYNC scheduler in ``local_sgd.py``): the
        collectives frame in that fragment's rotating STREAM_OUTER tag
        window, the work registers in the stream-fence registry instead of
        ``_pending_works`` (so ``start_quorum``'s stale-work drop and the
        vote's fence never touch it), and a FRAG_SUBMIT flight event marks
        the submit.  :meth:`should_commit` votes False while any streamed
        work is unresolved — a half-streamed sync NEVER commits; the caller
        must ``wait()`` the work at its bounded-staleness barrier before
        voting.

        ``device``, when given, runs the chunk arithmetic on it
        (``collectives.outer_sharded_sync``'s card path; ``update_cb`` then
        carries ``on_card``) and, on a flat topology, the value is a tensor
        there."""

        def _failed_fast(w: Work) -> Work:
            # fail-fast streamed submits still register + stamp FRAG_SUBMIT
            # so the barrier's FRAG_ABORT always has its pair (see allreduce)
            return w if stream is None else self.stream_submitted(stream, w)

        if self.errored():
            return _failed_fast(DummyWork(None))
        try:
            self.wait_quorum()
        except Exception as e:  # noqa: BLE001 — funnel, never raise
            self.report_error(e)
            return _failed_fast(DummyWork(None))
        num_participants = self.num_participants()
        if not self.is_participating():
            flat = np.zeros_like(flat)

        # degraded fleet: the sharded outer sync runs as a WEIGHTED sum —
        # every rank pre-scales its pseudo-gradient by its normalized
        # capacity share and the division drops out (weights sum to 1).
        # The engage decision is a pure function of quorum facts, so the
        # whole fleet flips together; the allgathered wire-format delta
        # stays bit-identical across replicas either way.
        weight: Optional[float] = None
        if self._capacity_weights_engaged():
            weight = self._own_capacity_weight() if self.is_participating() else 0.0

        from torchft_tpu_torch import wire as wire_mod
        from torchft_tpu_torch.collectives import outer_sharded_sync

        kind = quant_kind() if should_quantize else None
        timings = self.last_quorum_timings
        fut: concurrent.futures.Future = concurrent.futures.Future()
        if stream is None:
            tag_base, tag_span = (
                wire_mod.OUTER_SHARD_TAG_BASE,
                wire_mod.OUTER_SHARD_TAG_SPAN,
            )
        else:
            # window keyed on (outer step + fragment): consecutive streamed
            # syncs land in distinct windows even at num_fragments=1 (the
            # step advances every committed round, and a failed round
            # poisons the comm epoch, whose reconfigure flushes the old
            # connections), and the key is quorum-shared state, so a healed
            # replica picks the same window as the survivors — a local
            # submit counter would drift permanently after a restart
            tag_base, tag_span = wire_mod.stream_frag_tag_window(
                self._step + stream
            )

        def _run() -> None:
            tm: Dict[str, float] = {}
            try:
                delta = outer_sharded_sync(
                    self._comm,
                    flat,
                    update_cb,
                    num_participants,
                    should_quantize=should_quantize,
                    kind=kind or "int8",
                    timings=tm,
                    weight=weight,
                    # delta-tap: stage the (replica-identical) delta bytes
                    # for the spare feed; published only on a committed vote
                    tap=(
                        self._stage_outer_delta
                        if self._spare_replica_ids
                        else None
                    ),
                    tag_base=tag_base,
                    tag_span=tag_span,
                    device=device,
                )
                fut.set_result(delta)
            except Exception as e:  # noqa: BLE001 — funnel, never raise
                self.report_error(e)
                fut.set_result(None)
            finally:
                if tm:
                    stats = {f"outer_shard_{k}": v for k, v in tm.items()}
                    timings.update(stats)
                    self._outer_shard_stats = stats

        threading.Thread(
            target=_run, name="tpuft_outer_shard_sync", daemon=True
        ).start()
        out = Work(fut)
        if stream is None:
            self._register_pending(out)
        else:
            self.stream_submitted(stream, out)
        return out

    def stream_submitted(self, frag: int, work: Work) -> Work:
        """Register an async streamed fragment sync in the stream-fence
        registry (NOT ``_pending_works`` — see :meth:`outer_shard_allreduce`)
        and stamp the FRAG_SUBMIT flight event.  Returns ``work``."""
        self._flight.record(
            FlightEvent.FRAG_SUBMIT, step=self._step, frag=frag
        )
        with self._pending_works_lock:
            self._stream_pending[frag] = (work, self._step)
        return work

    def stream_unresolved(self) -> List[int]:
        """Fragment indices of streamed outer syncs whose collectives are
        still in flight.  Non-empty at vote time forces the vote False
        (:meth:`should_commit`) — the commit fence that guarantees a
        half-streamed sync never commits."""
        with self._pending_works_lock:
            return sorted(
                f
                for f, (w, _s) in self._stream_pending.items()
                if not w.done()
            )

    def stream_resolved(self, frag: int, committed: Optional[bool]) -> None:
        """Mark a streamed fragment sync fully resolved (waited + voted +
        applied or discarded) and record its lifecycle flight event —
        stamped with the SUBMIT-time step, so the FRAG_SUBMIT/FRAG_COMMIT
        pair shares a ``(step, frag)`` key on the merged timeline (a
        committed vote bumps ``_step`` before the caller gets here)."""
        with self._pending_works_lock:
            entry = self._stream_pending.pop(frag, None)
        self._flight.record(
            FlightEvent.FRAG_COMMIT if committed else FlightEvent.FRAG_ABORT,
            step=entry[1] if entry is not None else self._step,
            frag=frag,
        )

    def _register_pending(self, work: Work) -> None:
        with self._pending_works_lock:
            self._pending_works.append(work)

    def _fence_pending_works(self) -> None:
        """Wait every collective issued this step before voting: a failure
        landing after the vote would otherwise let this replica commit with
        its own unaveraged gradients (error-funnel substitution) while peers
        commit averaged ones — silent cross-replica divergence.  Analog of
        the reference's stream synchronize (``manager.py:888-893``)."""
        import time as _time

        with self._pending_works_lock:
            pending, self._pending_works = self._pending_works, []
        deadline = _time.monotonic() + self._timeout  # one shared budget
        for work in pending:
            try:
                # errors are already swallowed by wrap_work / the funnel;
                # only a genuine stall can raise (TimeoutError) here
                work.wait(timeout=max(0.0, deadline - _time.monotonic()))
            except Exception as e:  # noqa: BLE001
                self.report_error(e)

    # ------------------------------------------------------------------
    # commit
    # ------------------------------------------------------------------

    @traced("torchft::manager::should_commit")
    def should_commit(self, timeout: Optional[float] = None) -> bool:
        """Vote on committing this step (``manager.py:855-943``)."""
        # the vote depends on this step's quorum results (participation
        # facts, healing state) — wait it even if no allreduce ran this step
        # (e.g. a protocol-only or fully-quantized step); otherwise the vote
        # can read a stale participant count and spuriously fail.  A quorum
        # failure becomes a False vote (absorbed by the commit_failures /
        # max_retries path), not an exception out of the train loop —
        # calling without start_quorum at all is still a loud error (a real
        # raise, not ``assert`` — that would vanish under ``python -O``)
        if self._quorum_future is None:
            raise RuntimeError(
                "must call start_quorum before should_commit"
            )
        try:
            self.wait_quorum()
        except Exception as e:  # noqa: BLE001 — funnel, never raise
            self.report_error(e)
        # fence all in-flight collectives, then recovery, before voting
        with obs_span("manager::fence", step=self._step):
            self._fence_pending_works()
            if self._recovery_event is not None:
                self._recovery_event.synchronize(timeout=self._timeout)
                self._recovery_event = None
        self._flight.record(FlightEvent.COMMIT_FENCE, step=self._step)

        if (err := self._comm.errored()) is not None:
            self.report_error(err)

        if self._healing:
            self._apply_pending_state_dict()

        if self._relower_pending:
            # degraded re-lower in flight: inner state is mid-transition
            # between device layouts — committing now would fork this
            # replica from the fleet (and a crash here must read as "never
            # voted commit", which funneling to a False vote guarantees)
            self.report_error(
                RuntimeError(
                    "degraded re-lower in progress; refusing to commit a "
                    "half-relowered step"
                )
            )

        if stale_frags := self.stream_unresolved():
            # stream fence (the begin_relower pattern): a streamed fragment
            # sync whose collectives are still in flight at a vote means
            # the protocol was violated (the scheduler waits the work at
            # its staleness barrier before voting) — committing would let
            # this replica adopt a half-streamed delta later while peers
            # may have discarded it.  Force the vote False.
            self.report_error(
                RuntimeError(
                    f"streamed fragment sync(s) {stale_frags} still in "
                    "flight at the commit vote; refusing to commit a "
                    "half-streamed sync"
                )
            )

        enough_replicas = self.num_participants() >= self._min_replica_size
        local_should_commit = enough_replicas and self._errored is None
        self._flight.record(
            FlightEvent.COMMIT_VOTE, step=self._step, local=local_should_commit
        )
        with obs_span("manager::should_commit", step=self._step):
            should_commit = self._client.should_commit(
                self._group_rank,
                self._step,
                local_should_commit,
                timeout=timeout or self._timeout,
            )
        self._flight.record(
            FlightEvent.COMMIT_RESULT,
            step=self._step,
            committed=should_commit,
        )
        self._logger.info(
            f"should_commit={should_commit} enough_replicas={enough_replicas}, "
            f"errored={self._errored}"
        )

        self.commits_logger.info(
            "",
            extra={
                "job_id": os.environ.get("JOB_ID", "unknown"),
                "replica_id": self._replica_id,
                "rank": self._group_rank,
                "quorum_id": self._quorum_id,
                "step": self._step,
                "commit_result": should_commit,
            },
        )

        self._checkpoint_transport.disallow_checkpoint()

        if should_commit:
            # single-writer by protocol: wait_quorum() above joined the
            # quorum future, so the quorum thread's `_step = max_step` has
            # a happens-before edge to this train-thread increment, and no
            # new quorum starts until the train loop calls start_quorum
            # ftlint: ignore[thread-safety] — ordered by wait_quorum join
            self._step += 1
            # ftlint: ignore[thread-safety] — ordered by wait_quorum join
            self._batches_committed += self.num_participants()
            self._commit_failures = 0
        else:
            self._commit_failures += 1
            if (
                self._max_retries is not None
                and self._commit_failures > self._max_retries
            ):
                msg = (
                    f"should_commit failed {self._commit_failures} times "
                    f"consecutively, exceeding max_retries={self._max_retries}"
                )
                self._logger.exception(msg)
                raise RuntimeError(msg)
        return should_commit

    # ------------------------------------------------------------------
    # participation facts
    # ------------------------------------------------------------------

    def is_participating(self) -> bool:
        """False while healing (async quorum) or parked as a spare
        (``manager.py:1003-1020``)."""
        if self._participating_replica_rank is None:
            return False
        if self._healing:
            assert self._use_async_quorum
            return False
        return True

    def num_participants(self) -> int:
        assert self._participating_replica_world_size >= 0, "internal error"
        return self._participating_replica_world_size

    def participating_rank(self) -> Optional[int]:
        assert self._quorum_future is not None, "must call start_quorum before"
        self._quorum_future.result()
        return self._participating_replica_rank

    def current_step(self) -> int:
        """Current step count; incremented only on committed steps
        (``manager.py:1030-1040``)."""
        return self._step

    def batches_committed(self) -> int:
        return self._batches_committed

    @property
    def replica_id(self) -> str:
        return self._replica_id

    # ------------------------------------------------------------------

    def shutdown(self) -> None:
        self._tracer.stop()  # flush the final quorum epoch's trace
        if flight_dir():
            # the final complete ring (atexit's analog for in-process
            # replicas — a thread-plane victim's dump survives its death)
            try:
                self._flight.dump("shutdown")
            except OSError:
                pass
        self._checkpoint_transport.shutdown(wait=False)
        if self._quorum_future is not None:
            try:
                self._quorum_future.result(timeout=1.0)
            except Exception:  # noqa: BLE001
                pass
        self._executor.shutdown(wait=False)
        if self._manager_server is not None:
            self._manager_server.shutdown()
        if self._store is not None:
            self._store.close()
        if self._own_store is not None:
            self._own_store.shutdown()
        self._comm.shutdown()
        # the manager server's threads may outlive shutdown and reach this
        # object: drop the user's state callbacks so they cannot pin the
        # model and optimizer (device memory) past the replica's life
        self._user_state_dicts.clear()
        self._load_state_dict_fns.clear()

    # test-friendly logger attribute (mocked-client path sets it lazily)
    @property
    def _logger(self) -> "_ManagerLogger":
        if not hasattr(self, "_logger_obj"):
            self._logger_obj = _ManagerLogger(
                self, getattr(self, "_replica_id", "?"), self._group_rank
            )
        return self._logger_obj

    @_logger.setter
    def _logger(self, value: "_ManagerLogger") -> None:
        self._logger_obj = value


def _scale_contribution(
    data: Union[np.ndarray, List[np.ndarray]], scale: float
) -> Union[np.ndarray, List[np.ndarray]]:
    """Out-of-place capacity-weight pre-scale of a gradient contribution
    (same dtype-preservation contract as :func:`_div`; integer arrays pass
    through unscaled — fractional weights would floor them to noise)."""

    def _one(a: np.ndarray) -> np.ndarray:
        if bf16.is_bf16(a):
            return bf16.scale(a, scale)
        if np.issubdtype(a.dtype, np.integer):
            return a
        return (a * scale).astype(a.dtype)

    if isinstance(data, np.ndarray):
        return _one(data)
    return [_one(a) for a in data]


def _div(a: np.ndarray, n: int) -> np.ndarray:
    # Always out-of-place: the communicator may return the caller's own
    # buffer aliased (DummyCommunicator passthrough), and mutating it would
    # silently corrupt a retained gradient. Integer grads floor-divide;
    # bf16 (its bit pattern, see ``bf16.py``) rounds back from an f32
    # divide; everything else true-divides.
    if bf16.is_bf16(a):
        return bf16.div(a, n)
    if np.issubdtype(a.dtype, np.integer):
        return a // n
    return (a / n).astype(a.dtype)


class _ManagerLogger:
    """Prefixes ``[replica/rank - step N]`` (``manager.py:1056-1073``)."""

    def __init__(self, manager: Manager, replica_id: str, group_rank: int) -> None:
        self._logger = logging.getLogger(__name__)
        self._replica_id = replica_id
        self._group_rank = group_rank
        self._manager = manager

    def _prefix(self) -> str:
        return (
            f"[{self._replica_id}/{self._group_rank} - "
            f"step {self._manager.current_step()}]"
        )

    def info(self, msg: str) -> None:
        self._logger.info(f"{self._prefix()} {msg}")

    def warn(self, msg: str) -> None:
        self._logger.warning(f"{self._prefix()} {msg}")

    def exception(self, msg: str) -> None:
        self._logger.exception(f"{self._prefix()} {msg}")
