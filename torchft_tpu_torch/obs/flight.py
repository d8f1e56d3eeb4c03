"""Flight recorder: a lock-cheap per-replica ring of typed protocol events.

Every fault-tolerance mechanism in the stack emits scattered counters
(``lane_stats``, ``CommHealth``, ``last_quorum_timings``, the structured
loggers) — none of which answers the question operators actually ask after
an incident: *what exactly happened, in what order, across which replicas?*
The flight recorder answers it: each replica appends typed, monotonic-
stamped events keyed by ``(step, quorum_id, comm_epoch)`` to a bounded ring
(``TORCHFT_FLIGHT_EVENTS`` slots; ``collections.deque`` appends ride the
GIL, so the hot path takes no lock and costs ~a microsecond), and the ring
is dumped — newest state wins, written atomically — when something goes
wrong:

- **comm-epoch poison** (the communicator latched an error),
- the **Manager error funnel** (``report_error``),
- **SIGUSR2** (operator-requested snapshot of every live recorder),
- **atexit** / ``Manager.shutdown`` (the final complete ring).

Dumps land as ``flight_{replica_id}.jsonl`` under ``TORCHFT_FLIGHT_DIR``
(one JSON object per line, schema below) and announce themselves on the
``torchft_flight`` structured logger.  ``scripts/flight_merge.py`` aligns
several replicas' dumps on shared ``(quorum_id, step)`` anchors into one
Perfetto-loadable fleet timeline — the postmortem view.

The native tier records its epoch lifecycle into a C-side fixed-slot ring
(``native/comm.h``); :meth:`FlightRecorder.register_native_source` merges
those events into every dump via ``tpuft_comm_flight_drain`` (the ftlint
``native-mirror`` checker pins the event-id enum across the tiers).

Event schema (one JSON object per line)::

    {"seq": 17, "t": 1234.567890, "ev": 2, "name": "QUORUM_ADOPT",
     "step": 40, "quorum_id": 3, "comm_epoch": 5, "replica_id": "train_0",
     ...detail keys, "native": true when drained from the C ring}
"""

from __future__ import annotations

import atexit
import collections
import enum
import itertools
import json
import logging
import os
import signal
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

from torchft_tpu_torch import knobs

logger = logging.getLogger(__name__)

FLIGHT_EVENTS_ENV = "TORCHFT_FLIGHT_EVENTS"
FLIGHT_DIR_ENV = "TORCHFT_FLIGHT_DIR"
FLIGHT_DUMP_MIN_S_ENV = "TORCHFT_FLIGHT_DUMP_MIN_S"


class FlightEvent(enum.IntEnum):
    """Typed flight-recorder events.  Values are STABLE WIRE IDS: dumps
    carry them numerically, the merge tool keys on them, and the native
    tier mirrors the data-plane block (20..29) as ``kFlight*`` constants in
    ``native/comm.h`` — the ftlint ``native-mirror`` checker fails the
    build on any drift.  Add new events at the end of their block; never
    renumber."""

    # -- Manager state machine ---------------------------------------------
    QUORUM_START = 1  # start_quorum called (step)
    QUORUM_ADOPT = 2  # quorum adopted / reconfigured (quorum_id, world)
    COMMIT_FENCE = 3  # pending works + recovery fenced before the vote
    COMMIT_VOTE = 4  # this replica's local vote (detail: local)
    COMMIT_RESULT = 5  # the fleet's AND-decision (detail: committed)
    ERROR = 6  # error funnel (detail: error)
    # -- heal phases ---------------------------------------------------------
    HEAL_SEND_BEGIN = 7
    HEAL_SEND_END = 8  # detail: dst_ranks, duration_s
    HEAL_RECV_BEGIN = 9
    HEAL_RECV_END = 10  # detail: bytes, sources, duration_s
    HEAL_APPLY = 11  # pending state dict applied on the train thread
    # -- hot spares ----------------------------------------------------------
    SPARE_WARM = 12  # warm progress (detail: warm_step, lag)
    SPARE_PROMOTE = 13  # promotion (replica side AND lighthouse side)
    # -- degraded mode -------------------------------------------------------
    RELOWER_BEGIN = 14  # device loss: commit fence raised
    RELOWER_COMPLETE = 15  # re-lowered (detail: capacity)
    DEGRADED_SWAP = 16  # lighthouse: wounded replica traded for a spare
    DEGRADED_EVICT = 17  # lighthouse: wounded below the capacity floor
    # -- chaos / coordination ------------------------------------------------
    CHAOS_INJECT = 18  # a fault program / failure class armed (both planes)
    QUORUM_ISSUE = 19  # lighthouse: quorum issued (quorum_id, world)
    # -- data plane (native/comm.h mirrors kFlight* of this block) -----------
    COMM_CONFIGURE = 20  # epoch configured (rank, world, lanes)
    COMM_ABORT = 21  # abort() tore the epoch down
    COMM_POISON = 22  # the epoch latched an error (detail: reason + lane
    # counters of the dying epoch — the stall evidence a postmortem chains)
    LANE_RECONNECT = 23  # one lane re-dialed in-epoch
    LANE_FAILOVER = 24  # one lane failed over to a survivor
    # -- lighthouse policy (python only) -------------------------------------
    EVICT_SLOW = 25  # straggler shed from the quorum
    # -- streamed fragment sync (python only) --------------------------------
    FRAG_SUBMIT = 26  # streamed fragment outer sync submitted (detail: frag)
    FRAG_COMMIT = 27  # streamed fragment delta applied on a committed vote
    FRAG_ABORT = 28  # streamed fragment sync discarded (failed vote / error)


# data-plane events the native tier may record; the ftlint checker requires
# every kFlight* constant in comm.h to name one of these with the same value
NATIVE_EVENT_BLOCK = (
    FlightEvent.COMM_CONFIGURE,
    FlightEvent.COMM_ABORT,
    FlightEvent.COMM_POISON,
    FlightEvent.LANE_RECONNECT,
    FlightEvent.LANE_FAILOVER,
)

# live recorders, for the SIGUSR2 / atexit fleet-wide dump triggers
_RECORDERS: "weakref.WeakSet[FlightRecorder]" = weakref.WeakSet()
_signal_installed = False
_atexit_installed = False
_install_lock = threading.Lock()


def _flight_cap() -> int:
    return max(0, knobs.get_int(FLIGHT_EVENTS_ENV, 4096))


def flight_dir() -> Optional[str]:
    return knobs.get_str(FLIGHT_DIR_ENV) or None


class FlightRecorder:
    """One replica's bounded event ring.

    ``record()`` is the hot path: a tuple append onto a ``deque(maxlen=cap)``
    (GIL-atomic — no lock) plus a monotonic stamp.  Context (``step`` /
    ``quorum_id`` from the manager, ``comm_epoch`` from the communicator)
    is sticky: events recorded without explicit keys inherit the last
    ``set_context`` / ``set_comm_epoch`` values, so data-plane threads need
    no plumbing to stay correlated."""

    def __init__(
        self, replica_id: str = "", cap: Optional[int] = None
    ) -> None:
        self.replica_id = replica_id
        self._cap = _flight_cap() if cap is None else max(0, cap)
        self._events: "collections.deque" = collections.deque(
            maxlen=self._cap or 1
        )
        self._seq = itertools.count()
        # sticky correlation context (single-writer per field in practice;
        # a racy read only mis-stamps one event's context, never corrupts)
        self._step = -1
        self._quorum_id = -1
        self._comm_epoch = -1
        # native-ring sources: weakrefs to objects exposing flight_drain()
        self._native_sources: List["weakref.ref"] = []
        self._last_auto_dump = float("-inf")
        self.dumps_total = 0
        _RECORDERS.add(self)
        _install_triggers()

    # -- recording ----------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._cap > 0

    def __len__(self) -> int:
        return len(self._events) if self._cap else 0

    def __bool__(self) -> bool:
        # an EMPTY recorder is still a recorder: `if self.flight:` guards
        # attachment, not ring occupancy (len() would otherwise leak into
        # truthiness and silently skip the first events)
        return True

    def set_replica_id(self, replica_id: str) -> None:
        self.replica_id = replica_id

    def set_context(
        self, step: Optional[int] = None, quorum_id: Optional[int] = None
    ) -> None:
        if step is not None:
            self._step = step
        if quorum_id is not None:
            self._quorum_id = quorum_id

    def set_comm_epoch(self, epoch: int) -> None:
        self._comm_epoch = epoch

    def record(
        self,
        ev: FlightEvent,
        step: Optional[int] = None,
        quorum_id: Optional[int] = None,
        comm_epoch: Optional[int] = None,
        **detail: Any,
    ) -> None:
        if not self._cap:
            return
        self._events.append(
            (
                next(self._seq),
                time.monotonic(),
                int(ev),
                self._step if step is None else step,
                self._quorum_id if quorum_id is None else quorum_id,
                self._comm_epoch if comm_epoch is None else comm_epoch,
                detail or None,
            )
        )

    def record_raw(self, event: Dict[str, Any]) -> None:
        """Append one pre-built event dict (a drained native slot): stamped
        with its OWN clock/seq fields, stored verbatim."""
        if not self._cap:
            return
        self._events.append(dict(event))

    # -- native ring merge ---------------------------------------------------

    def register_native_source(self, obj: object) -> None:
        """Register an object exposing ``flight_drain() -> List[dict]``
        (the CppCommunicator binding over ``tpuft_comm_flight_drain``).
        Held by weakref; drained into the ring at every dump."""
        self._native_sources.append(weakref.ref(obj))

    def _drain_native(self) -> int:
        drained = 0
        live: List["weakref.ref"] = []
        for ref in self._native_sources:
            obj = ref()
            if obj is None:
                continue
            live.append(ref)
            try:
                events = obj.flight_drain()  # type: ignore[attr-defined]
            except Exception as e:  # noqa: BLE001 — a dead source must not
                # kill the dump that exists to explain the death
                logger.warning("native flight drain failed: %s", e)
                continue
            for event in events:
                event.setdefault("native", True)
                self.record_raw(event)
                drained += 1
        self._native_sources = live
        return drained

    # -- snapshot / dump -----------------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """The ring as a list of event dicts, oldest first.  Non-destructive."""
        out: List[Dict[str, Any]] = []
        for item in list(self._events):
            if isinstance(item, dict):
                out.append(dict(item))
                continue
            seq, t, ev, step, quorum_id, comm_epoch, detail = item
            event: Dict[str, Any] = {
                "seq": seq,
                "t": round(t, 6),
                "ev": ev,
                "name": (
                    FlightEvent(ev).name
                    if ev in FlightEvent._value2member_map_
                    else f"EV_{ev}"
                ),
                "step": step,
                "quorum_id": quorum_id,
                "comm_epoch": comm_epoch,
            }
            if detail:
                event.update(detail)
            out.append(event)
        return out

    def dump(self, reason: str) -> Optional[str]:
        """Write the full current ring (native sources merged) as
        ``flight_{replica_id}.jsonl`` under ``TORCHFT_FLIGHT_DIR``.  Each
        dump REWRITES the file atomically (tmp + rename) — the newest dump
        holds the most complete ring, and a reader never sees a torn file.
        Returns the path, or None when recording/dumping is disabled."""
        if not self._cap:
            return None
        native_events = self._drain_native()
        directory = flight_dir()
        path: Optional[str] = None
        events = self.snapshot()
        if directory:
            os.makedirs(directory, exist_ok=True)
            safe_id = (
                "".join(
                    c if c.isalnum() or c in "-_." else "_"
                    for c in (self.replica_id or "unnamed")
                )
                or "unnamed"
            )
            path = os.path.join(directory, f"flight_{safe_id}.jsonl")
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as f:
                f.write(
                    json.dumps(
                        {
                            "flight_meta": 1,
                            "replica_id": self.replica_id,
                            "reason": reason,
                            "dump_ts": round(time.time(), 3),
                            "dump_t_mono": round(time.monotonic(), 6),
                            "events": len(events),
                        }
                    )
                    + "\n"
                )
                for event in events:
                    event["replica_id"] = self.replica_id
                    f.write(json.dumps(event) + "\n")
            os.replace(tmp, path)
        self.dumps_total += 1
        logging.getLogger("torchft_flight").info(
            "",
            extra={
                "replica_id": self.replica_id,
                "flight_reason": reason,
                "flight_events": len(events),
                "flight_native_events": native_events,
                "flight_path": path or "",
            },
        )
        return path

    def maybe_dump(self, reason: str) -> Optional[str]:
        """Rate-limited automatic dump (the poison / error-funnel triggers):
        a poison storm must not turn into an fsync storm.  Manual triggers
        (SIGUSR2, shutdown) call :meth:`dump` directly."""
        if not self._cap:
            return None
        min_s = knobs.get_float(FLIGHT_DUMP_MIN_S_ENV, 1.0)
        now = time.monotonic()
        if now - self._last_auto_dump < min_s:
            return None
        self._last_auto_dump = now
        try:
            return self.dump(reason)
        except OSError as e:  # a full disk must not fail the train loop
            logger.warning("flight dump failed: %s", e)
            return None


# -- process-wide default recorder + fleet triggers --------------------------

_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()


def default_recorder() -> FlightRecorder:
    """The process-global recorder, for process-plane callers without a
    Manager-owned instance (one replica per process).  Thread-plane
    harnesses attach per-Manager recorders instead."""
    global _default
    with _default_lock:
        if _default is None:
            _default = FlightRecorder(
                replica_id=os.environ.get("JOB_ID", "")
                or f"pid_{os.getpid()}"
            )
        return _default


def dump_all(reason: str) -> List[str]:
    """Dump every live recorder (the SIGUSR2 / atexit trigger body)."""
    paths = []
    for rec in list(_RECORDERS):
        try:
            path = rec.dump(reason)
        except OSError as e:
            logger.warning("flight dump failed: %s", e)
            continue
        if path:
            paths.append(path)
    return paths


def _on_sigusr2(signum, frame) -> None:  # pragma: no cover — signal path
    # NEVER dump inline: the handler runs on the main thread between
    # bytecodes, and a dump drains native rings under their communicator
    # locks — if the main thread already holds one (mid-configure, mid-op
    # enqueue), the inline drain would self-deadlock the process the
    # operator was trying to debug.  A daemon thread takes the locks from
    # a context that can actually wait for them.
    threading.Thread(
        target=dump_all, args=("sigusr2",), name="tpuft_flight_sigusr2",
        daemon=True,
    ).start()


def _install_triggers() -> None:
    """Install the SIGUSR2 handler and the atexit hook once per process.
    Signal installation only works on the main thread (and some embedders
    forbid it) — failure downgrades to the remaining triggers."""
    global _signal_installed, _atexit_installed
    with _install_lock:
        if not _atexit_installed:
            _atexit_installed = True
            atexit.register(_atexit_dump)
        if not _signal_installed:
            try:
                signal.signal(signal.SIGUSR2, _on_sigusr2)
                _signal_installed = True
            except (ValueError, OSError, AttributeError):
                # not the main thread / no SIGUSR2 on this platform
                _signal_installed = True  # don't retry per recorder


def _atexit_dump() -> None:  # pragma: no cover — interpreter teardown
    if flight_dir():
        dump_all("atexit")
