"""Zone aggregator: batch member heartbeats into one upstream RPC per tick.

One :class:`ZoneAggregator` runs per host or failure zone.  Members send
their ordinary heartbeats (replica id, role, spare warm-step, cumulative
``CommHealth``) to the aggregator over ``AGG_BEAT`` frames at their normal
cadence; the aggregator keeps only the LATEST beat per member and flushes
the whole batch upstream as a single ``LH_AGG_BEAT`` RPC every
``TORCHFT_AGG_FLUSH_MS`` — so the lighthouse-inbound RPC rate is
``aggregators / flush_interval`` instead of ``members / beat_interval``
(~50x lower at 500 members, 2 zones, defaults).

Failure semantics (the load-bearing part):

- **Aggregator death is a reporting gap, not a member death.**  The
  lighthouse tracks which aggregator last reported each member; when that
  aggregator's own flushes stop, affected members get a bounded extra
  grace window (``TORCHFT_AGG_GRACE_S``) before the heartbeat verdict
  applies — enough for their managers to notice the dead aggregator and
  fall back to direct beats (``manager_server._run_heartbeat``).  A member
  that stays silent past the grace is genuinely dead.
- **Upstream state rides the member response.**  Each ``AGG_BEAT_RESP``
  carries whether the aggregator's last upstream flush succeeded plus a
  lighthouse-restart counter (success-after-failure transitions), so a
  member beating via the aggregator still learns about lighthouse bounces
  and can interrupt its parked quorum RPC exactly like the direct path.
- **The aggregator holds no quorum state.**  Crash/restart loses nothing
  but a flush tick; members re-route or fall back within a beat interval.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
import uuid
from typing import Dict, Optional

from torchft_tpu_torch import knobs
from torchft_tpu_torch.wire import (
    AggBeat,
    CommHealth,
    ErrCode,
    MemberBeat,
    MsgType,
    ROLE_ACTIVE,
    RpcClient,
    WireError,
    Writer,
    configure_server_socket,
    create_listener,
    raise_if_error,
    recv_frame,
    send_error,
    send_frame,
)

logger = logging.getLogger(__name__)

AGG_ADDR_ENV = "TORCHFT_AGG_ADDR"
AGG_FLUSH_MS_ENV = "TORCHFT_AGG_FLUSH_MS"  # default 100
AGG_RETRY_S_ENV = "TORCHFT_AGG_RETRY_S"  # default 2.0


class ZoneAggregator:
    """Threaded per-zone heartbeat aggregator (see module docstring)."""

    def __init__(
        self,
        lighthouse_addr: str,
        bind: str = "0.0.0.0:0",
        agg_id: Optional[str] = None,
        flush_interval_s: Optional[float] = None,
        connect_timeout: float = 10.0,
    ) -> None:
        self._lighthouse_addr = lighthouse_addr
        self._agg_id = agg_id or (
            f"agg_{socket.gethostname()}_{uuid.uuid4().hex[:8]}"
        )
        self._flush_interval_s = flush_interval_s
        self._connect_timeout = connect_timeout

        self._lock = threading.Lock()
        # latest beat per member since the last flush
        self._pending: Dict[str, MemberBeat] = {}
        # upstream link state, mirrored into every member response
        self._upstream_failures = 0
        self._lh_restarts = 0
        self._upstream_ok = False
        # cumulative observability
        self.beats_in = 0
        self.flushes = 0
        self.flush_errors = 0
        self.members_seen: set = set()

        self._shutdown = False
        self._upstream: Optional[RpcClient] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()

        self._sock = create_listener(bind, backlog=512)
        self._port: int = self._sock.getsockname()[1]
        threading.Thread(
            target=self._serve, name="tpuft_agg_accept", daemon=True
        ).start()
        threading.Thread(
            target=self._run_flush, name="tpuft_agg_flush", daemon=True
        ).start()
        logger.info(
            "ZoneAggregator %s listening on %s (upstream %s)",
            self._agg_id,
            self.local_address(),
            lighthouse_addr,
        )

    # -- public -------------------------------------------------------------

    @property
    def port(self) -> int:
        return self._port

    @property
    def agg_id(self) -> str:
        return self._agg_id

    def address(self) -> str:
        return f"{socket.gethostname()}:{self._port}"

    def local_address(self) -> str:
        return f"127.0.0.1:{self._port}"

    def shutdown(self) -> None:
        self._shutdown = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        upstream = self._upstream
        if upstream is not None:
            upstream.close()

    # -- member side --------------------------------------------------------

    def _serve(self) -> None:
        while not self._shutdown:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            configure_server_socket(conn)
            with self._conns_lock:
                if self._shutdown:
                    conn.close()
                    continue
                self._conns.add(conn)
            threading.Thread(
                target=self._handle_conn,
                args=(conn,),
                name="tpuft_agg_conn",
                daemon=True,
            ).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                msg_type, r = recv_frame(conn)
                if msg_type != MsgType.AGG_BEAT_REQ:
                    send_error(
                        conn, ErrCode.INVALID, f"bad aggregator op {msg_type}"
                    )
                    continue
                beat = MemberBeat.decode(r)
                with self._lock:
                    self._pending[beat.replica_id] = beat
                    self.beats_in += 1
                    self.members_seen.add(beat.replica_id)
                    ok, restarts = self._upstream_ok, self._lh_restarts
                w = Writer().boolean(ok).u64(restarts)
                send_frame(conn, MsgType.AGG_BEAT_RESP, w.payload())
        except (ConnectionError, OSError, WireError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- upstream side ------------------------------------------------------

    def _flush_interval(self) -> float:
        if self._flush_interval_s is not None:
            return self._flush_interval_s
        return max(0.005, knobs.get_float(AGG_FLUSH_MS_ENV, 100.0) / 1000.0)

    def _run_flush(self) -> None:
        while not self._shutdown:
            time.sleep(self._flush_interval())
            self._flush_once()

    def _flush_once(self) -> None:
        """One upstream flush: ship every pending beat as a single RPC.
        An EMPTY flush still goes out — the flush itself is the
        aggregator's own liveness signal (``agg_last`` on the lighthouse),
        and a silent idle aggregator would look dead."""
        with self._lock:
            batch, self._pending = self._pending, {}
        agg = AggBeat(agg_id=self._agg_id, beats=list(batch.values()))
        w = Writer()
        agg.encode(w)
        try:
            if self._upstream is None:
                self._upstream = RpcClient(
                    self._lighthouse_addr,
                    connect_timeout=self._connect_timeout,
                )
            msg_type, r = self._upstream.call(
                MsgType.LH_AGG_BEAT_REQ, w.payload(), timeout=5.0
            )
            raise_if_error(msg_type, r)
            with self._lock:
                self.flushes += 1
                if self._upstream_failures:
                    # success after failure: the lighthouse (likely)
                    # restarted — members learn via the response counter
                    self._upstream_failures = 0
                    self._lh_restarts += 1
                self._upstream_ok = True
        except (OSError, TimeoutError, WireError) as e:
            logger.info(
                "aggregator %s upstream flush failed: %s", self._agg_id, e
            )
            with self._lock:
                self.flush_errors += 1
                self._upstream_failures += 1
                self._upstream_ok = False
                # re-queue the batch so the beats land on the next
                # successful flush instead of vanishing (newer beats win)
                merged = dict(batch)
                merged.update(self._pending)
                self._pending = merged
            upstream = self._upstream
            self._upstream = None
            if upstream is not None:
                upstream.close()


class AggMemberClient(RpcClient):
    """Member-side client for one :class:`ZoneAggregator`.  ``beat``
    returns the aggregator's upstream view so callers can mirror the
    direct path's lighthouse-restart detection."""

    def __init__(self, addr: str, connect_timeout: float = 10.0) -> None:
        super().__init__(addr, connect_timeout=connect_timeout)

    def beat(
        self,
        replica_id: str,
        role: int = ROLE_ACTIVE,
        warm_step: int = -1,
        health: Optional[CommHealth] = None,
        timeout: float = 5.0,
    ) -> Dict[str, object]:
        w = Writer()
        MemberBeat(
            replica_id=replica_id,
            role=role,
            warm_step=warm_step,
            health=health,
        ).encode(w)
        msg_type, r = self.call(
            MsgType.AGG_BEAT_REQ, w.payload(), timeout, idempotent=True
        )
        raise_if_error(msg_type, r)
        return {"upstream_ok": r.boolean(), "lh_restarts": r.u64()}
