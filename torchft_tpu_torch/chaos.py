"""Programmable failure injection: the Monarch FailureController analog.

The port of ``torchft_tpu/chaos.py`` (it holds no arrays, so it is a copy
with the imports rewritten).  The upstream project's Monarch example
supervises replicas as actors and injects typed failures programmatically
— SEGFAULT / KILL_PROC / COMMS / DEADLOCK / KILL_SLURM
(``examples/monarch/utils/failure.py:24-95`` upstream).  This module gives
the port the same scriptable surface over both replica planes:

- **process plane** (:class:`ProcessReplica`): replica groups as OS
  processes under a supervisor — failures are real signals (SIGKILL /
  SIGSEGV / SIGSTOP-freeze) delivered through the port's
  :class:`~torchft_tpu_torch.launcher.ReplicaSupervisor` (its ``kill`` and,
  for the spawn-env classes, its ``_specs``), whose restart and standby
  promotion are the recovery under test.
- **thread plane** (:class:`ThreadReplica`): replicas as threads in one
  process (the shape of ``drill.py``'s fleets) — failures arm the replica
  loop's cooperative hooks (kill flag, wedge, communicator abort).

:class:`ChaosController` is the scenario driver: ``inject()`` delivers a
typed failure to a chosen (or random) victim, ``await_heal()`` blocks until
the victim commits again, and ``run_poisson()`` is the randomized soak
loop.
"""

from __future__ import annotations

import enum
import logging
import random
import signal
import threading
import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)


class Failure(enum.Enum):
    """Failure classes, matching the reference's enum
    (``examples/monarch/utils/failure.py:24-33``) plus the
    coordination-plane death the reference leaves to manual chaos."""

    KILL = "kill"  # hard process/thread death; supervisor restarts it
    SEGFAULT = "segfault"  # SIGSEGV (process plane)
    DEADLOCK = "deadlock"  # wedge mid-step; peers must evict via timeouts
    COMM_ABORT = "commabort"  # comms die under the replica (NIC analog)
    LIGHTHOUSE = "lighthouse"  # coordination plane dies + restarts
    HEAL_SOURCE = "healsource"  # die mid-transfer while SERVING a heal
    HOST_LEADER = "hostleader"  # kill a replica currently LEADING its host
    # group in the hierarchical data plane: its host's members lose their
    # shm hub and the cross-host ring loses a member mid-collective; the
    # next quorum must re-elect a leader (lowest surviving rank) and
    # /dev/shm must hold no orphaned segments (unlinked-after-map)
    # -- gray failures (arxiv 2508.21613: policy should match failure TYPE;
    # these are TRANSIENT, survived in-epoch, not crash-recovered) --------
    NET_FLAKY = "netflaky"  # flaky link: frame loss + occasional resets;
    # the lane retry/failover machinery must recover IN-epoch (zero quorum
    # reconfigurations), visible as comm_lane_reconnects > 0
    SLOW_NIC = "slownic"  # one persistently slow NIC: heavy stall windows
    # drag every collective; detection (heartbeat comm-health) must flag
    # the victim and, under TORCHFT_EVICT_SLOW, shed it from the quorum
    PARTITION = "partition"  # the victim is cut from the fleet (data-plane
    # partition mask + paused heartbeats): the majority side must form a
    # quorum without it (anti split-brain keeps the minority down)
    SPARE = "spare"  # kill a WARMING hot spare (wire-v3 SPARE role): the
    # active fleet must not notice — zero quorum reconfigurations, no
    # stalls, no poisoned state (a spare never counts toward membership
    # and its warm RPCs are served outside the heal path)
    DEVICE_LOSS = "deviceloss"  # IN-REPLICA device death (wire v5): the
    # replica must NOT die — it re-lowers its inner mesh onto the
    # surviving devices (parallel/degraded.py), advertises the reduced
    # capacity fraction, rescales its data shard, and keeps contributing
    # through the capacity-weighted outer reduce.  Zero full-replica
    # evictions; with a warm spare registered, the lighthouse swaps the
    # wounded replica for the spare in ONE membership edit instead.
    # kw: devices=N (how many devices die), mid_relower=True arms a crash
    # BETWEEN begin_relower and complete_relower (the half-relowered
    # replica must never vote commit).


@dataclass
class ChaosEvent:
    ts: float
    failure: Failure
    victim: Optional[str]
    detail: Dict[str, Any] = field(default_factory=dict)


# default fault programs for the gray failure classes — shared by BOTH
# replica planes so a tuned default cannot silently diverge between them
_GRAY_DEFAULT_SPECS = {
    Failure.NET_FLAKY: "loss:0.01,reset:0.002",
    Failure.SLOW_NIC: "stall:0.5:50",
    Failure.PARTITION: "partition:self",
}


def _flight_note(obj: Any, failure: Failure, **detail: Any) -> None:
    """Best-effort CHAOS_INJECT into the victim's flight recorder — the
    injection anchor a postmortem timeline chains its causal sequence
    from.  Reaches the recorder through the victim's manager (thread
    plane) or its communicator attachment; silently a no-op when neither
    exists (mock harnesses)."""
    manager = getattr(obj, "manager", None)
    flight = getattr(manager, "_flight", None)
    if flight is None:
        flight = getattr(getattr(obj, "comm", None), "flight", None)
    if flight is None:
        return
    from torchft_tpu_torch.obs.flight import FlightEvent

    flight.record(FlightEvent.CHAOS_INJECT, failure=failure.value, **detail)


def arm_heal_source_kill(
    transport: Any,
    after_bytes: int = 1 << 20,
    arm: Optional[threading.Event] = None,
    striped_only: bool = False,
) -> threading.Event:
    """Arm a checkpoint transport to die after SERVING ~``after_bytes`` of
    heal payload — the deterministic form of :attr:`Failure.HEAL_SOURCE`
    (timing a SIGKILL against a transfer is racy; a byte-threshold trip
    wire is not).  Returns an event set when the kill fires.

    ``arm`` (optional) gates the trip wire: bytes served while it is unset
    do not count and do not kill, so a drill can let the initial-sync heal
    pass and only kill the source during the transfer under test.

    ``striped_only`` restricts the kill to STRIPED serving (multi-source
    chunk ranges, where a survivor can steal the dead source's chunks);
    single-source transfers pass untouched — killing the only source is a
    fatal scenario, not a failover drill.  The comm transport's trip wire
    lives in its striped serve loop, so it is striped-only by nature.

    Works on both checkpoint transports:

    - :class:`~torchft_tpu_torch.checkpointing.http_transport.HTTPTransport`:
      the serving handler aborts mid-payload and the HTTP server shuts
      down (further range requests are refused — the source looks dead).
    - :class:`~torchft_tpu_torch.checkpointing.comm_transport.CommTransport`:
      the striped serve loop aborts its communicator after its sent-byte
      counter passes the threshold.
    """
    fired = threading.Event()

    if hasattr(transport, "chaos_die_after_bytes"):  # CommTransport
        transport.chaos_die_after_bytes = after_bytes
        transport.chaos_arm = arm
        return transport.chaos_fired

    if hasattr(transport, "chaos_striped_only"):
        transport.chaos_striped_only = striped_only

    served_while_armed = [0]
    last_total = [0]

    def _hook(total_bytes: int) -> bool:
        delta, last_total[0] = total_bytes - last_total[0], total_bytes
        if arm is not None and not arm.is_set():
            return False
        served_while_armed[0] += delta
        if served_while_armed[0] >= after_bytes:
            fired.set()
            return True
        return False

    transport.chaos_serve_hook = _hook
    return fired


class ReplicaHandle(ABC):
    """One injectable replica.  ``progress()`` must be monotone in
    committed steps — ``await_heal`` is defined in terms of it."""

    name: str

    @abstractmethod
    def supports(self, failure: Failure) -> bool: ...

    @abstractmethod
    def inject(self, failure: Failure, **kw: Any) -> None: ...

    @abstractmethod
    def progress(self) -> int: ...


class ThreadReplica(ReplicaHandle):
    """Adapter over a thread-plane replica object exposing the cooperative
    hook shape used by the soak/chaos harnesses:

    - ``kill_flag: threading.Event`` — raise-and-restart on next step
    - ``wedge_flag: threading.Event`` + ``wedge_secs: float`` — park
      mid-step after joining the quorum
    - ``comm`` — live communicator with ``abort(reason)``
    - ``commits: int`` (or ``progress``) — monotone committed-step count
    """

    def __init__(self, name: str, obj: Any) -> None:
        self.name = name
        self._obj = obj

    def supports(self, failure: Failure) -> bool:
        # liveness probe: a harness that exposes an ``alive`` attribute (a
        # bool or a callable) lets the soak loop's every-victim-dead clean
        # stop actually fire for flag-armed classes too
        alive = getattr(self._obj, "alive", None)
        if alive is not None and not (alive() if callable(alive) else alive):
            return False
        if failure is Failure.HEAL_SOURCE:
            return getattr(self._obj, "heal_transport", None) is not None
        if failure is Failure.HOST_LEADER:
            return self._is_host_leader()
        if failure is Failure.SPARE:
            # only a replica currently in the SPARE role qualifies (a
            # promoted spare is an active — killing it is Failure.KILL)
            manager = getattr(self._obj, "manager", None)
            return getattr(manager, "role", "active") == "spare"
        if failure is Failure.DEVICE_LOSS:
            # the replica loop must expose the degraded-mode hook (it
            # owns the re-lower — chaos only kills devices)
            return getattr(self._obj, "device_loss_flag", None) is not None
        if failure in _GRAY_DEFAULT_SPECS:
            comm = getattr(self._obj, "comm", None)
            return callable(getattr(comm, "arm_faults", None))
        return failure in (Failure.KILL, Failure.DEADLOCK, Failure.COMM_ABORT)

    def _is_host_leader(self) -> bool:
        comm = getattr(self._obj, "comm", None)
        topo_fn = getattr(comm, "hier_topology", None)
        if not callable(topo_fn):
            return False
        try:
            topo = topo_fn()
        except Exception:  # noqa: BLE001 — comm mid-reconfigure
            return False
        return bool(topo and topo.get("is_leader"))

    def inject(self, failure: Failure, **kw: Any) -> None:
        if failure not in _GRAY_DEFAULT_SPECS:
            # gray classes record their CHAOS_INJECT inside
            # comm.arm_faults (which this inject routes through) — noting
            # them here too would double-record every injection
            _flight_note(
                self._obj,
                failure,
                plane="thread",
                **{
                    k: v
                    for k, v in kw.items()
                    if isinstance(v, (int, float, str, bool))
                },
            )
        if failure is Failure.HOST_LEADER:
            # targeted KILL conditioned on the victim's CURRENT topology
            # role — leadership is per-epoch (lowest surviving rank of the
            # host group), so the role is checked at inject time
            if not self._is_host_leader():
                raise RuntimeError(
                    f"{self.name}: not a host leader in the current epoch"
                )
            self._obj.kill_flag.set()
        elif failure is Failure.KILL:
            self._obj.kill_flag.set()
        elif failure is Failure.SPARE:
            if getattr(getattr(self._obj, "manager", None), "role", None) != "spare":
                raise RuntimeError(
                    f"{self.name}: not a spare in the current epoch"
                )
            self._obj.kill_flag.set()
        elif failure is Failure.DEVICE_LOSS:
            flag = getattr(self._obj, "device_loss_flag", None)
            if flag is None:
                raise RuntimeError(
                    f"{self.name}: no device_loss hook on this replica"
                )
            # the replica consumes these at its next step boundary:
            # devices = how many of its (virtual) devices just died;
            # mid_relower arms a crash INSIDE the re-lower window — the
            # kill-mid-relower chaos case proving a half-relowered
            # replica never votes commit
            self._obj.device_loss_count = int(kw.get("devices", 1))
            self._obj.device_loss_mid_relower = bool(
                kw.get("mid_relower", False)
            )
            flag.set()
        elif failure is Failure.DEADLOCK:
            self._obj.wedge_secs = float(kw.get("secs", 10.0))
            self._obj.wedge_flag.set()
        elif failure is Failure.COMM_ABORT:
            comm = getattr(self._obj, "comm", None)
            if comm is None:
                raise RuntimeError(f"{self.name}: no live communicator yet")
            comm.abort(str(kw.get("reason", "chaos: injected comm failure")))
        elif failure is Failure.HEAL_SOURCE:
            transport = getattr(self._obj, "heal_transport", None)
            if transport is None:
                raise RuntimeError(f"{self.name}: no heal transport exposed")
            arm_heal_source_kill(
                transport,
                after_bytes=int(kw.get("after_bytes", 1 << 20)),
                arm=kw.get("arm"),
            )
        elif failure in _GRAY_DEFAULT_SPECS:
            comm = getattr(self._obj, "comm", None)
            if not callable(getattr(comm, "arm_faults", None)):
                raise RuntimeError(
                    f"{self.name}: no fault-armable communicator"
                )
            # spec=None DISARMS — chaos can heal a gray link mid-run
            spec = kw.get("spec", _GRAY_DEFAULT_SPECS[failure])
            comm.arm_faults(spec)
            if failure is Failure.PARTITION:
                # a partitioned replica loses its control plane too: sever
                # the manager's lighthouse path (heartbeats AND quorum
                # forwarding — a quorum rpc is an implicit heartbeat, so
                # pausing only beats would keep the victim looking alive)
                server = getattr(
                    getattr(self._obj, "manager", None), "_manager_server", None
                )
                if server is not None:
                    server.heartbeat_paused = spec is not None
        else:
            raise ValueError(f"thread plane cannot inject {failure}")

    def progress(self) -> int:
        return int(
            getattr(self._obj, "commits", getattr(self._obj, "progress", 0))
        )


class ProcessReplica(ReplicaHandle):
    """Adapter over one replica group of a
    :class:`~torchft_tpu_torch.launcher.ReplicaSupervisor` — failures are
    real signals against the live process; the supervisor's restart/standby
    machinery is the recovery under test.

    ``progress_fn`` reads the group's committed step from the outside
    (an event log, the lighthouse status page, a log scraper).
    """

    def __init__(
        self,
        name: str,
        supervisor: Any,
        replica_group_id: int,
        progress_fn: Callable[[], int] = lambda: 0,
    ) -> None:
        self.name = name
        self._supervisor = supervisor
        self._gid = replica_group_id
        self._progress_fn = progress_fn

    def supports(self, failure: Failure) -> bool:
        if failure in _GRAY_DEFAULT_SPECS or failure is Failure.DEVICE_LOSS:
            # gray failures / device loss arm via the group's spawn env
            # (TORCHFT_NET_FAULTS / TORCHFT_CHAOS_DEVICE_LOSS): supported
            # when the supervisor exposes its specs
            return hasattr(self._supervisor, "_specs")
        return failure in (
            Failure.KILL,
            Failure.SEGFAULT,
            Failure.DEADLOCK,
            Failure.HEAL_SOURCE,
            Failure.HOST_LEADER,
        )

    def inject(self, failure: Failure, **kw: Any) -> None:
        if failure is Failure.DEVICE_LOSS:
            # process plane: a real device can't be unplugged from outside
            # the process, so the loss rides the group's spawn env
            # (TORCHFT_CHAOS_DEVICE_LOSS=N — the worker hides N devices
            # and re-lowers at startup) and lands on the next (re)start;
            # restart=True (default) bounces the process so it comes up
            # wounded now.  devices=0 heals: the env is cleared and the
            # next restart comes up full-width.
            devices = int(kw.get("devices", 1))
            spec_env = next(
                (
                    s.env
                    for s in self._supervisor._specs
                    if s.replica_group_id == self._gid
                ),
                None,
            )
            if spec_env is None:
                raise RuntimeError(f"{self.name}: no spec for group {self._gid}")
            if devices <= 0:
                spec_env.pop("TORCHFT_CHAOS_DEVICE_LOSS", None)
            else:
                spec_env["TORCHFT_CHAOS_DEVICE_LOSS"] = str(devices)
            if kw.get("restart", True):
                ok = self._supervisor.kill(self._gid, sig=signal.SIGKILL)
                if not ok:
                    raise RuntimeError(
                        f"{self.name}: no live process to restart with "
                        f"{failure.value}"
                    )
            return
        if failure in _GRAY_DEFAULT_SPECS:
            # process plane: the fault program rides the group's spawn env
            # (TORCHFT_NET_FAULTS) and lands on the next (re)start; pass
            # restart=True to bounce the process so it comes up flaky now.
            spec = kw.get("spec", _GRAY_DEFAULT_SPECS[failure])
            spec_env = next(
                (
                    s.env
                    for s in self._supervisor._specs
                    if s.replica_group_id == self._gid
                ),
                None,
            )
            if spec_env is None:
                raise RuntimeError(f"{self.name}: no spec for group {self._gid}")
            if spec is None:
                spec_env.pop("TORCHFT_NET_FAULTS", None)
            else:
                spec_env["TORCHFT_NET_FAULTS"] = str(spec)
            if kw.get("restart", True):
                ok = self._supervisor.kill(self._gid, sig=signal.SIGKILL)
                if not ok:
                    raise RuntimeError(
                        f"{self.name}: no live process to restart with "
                        f"{failure.value}"
                    )
            return
        if failure in (Failure.KILL, Failure.HEAL_SOURCE, Failure.HOST_LEADER):
            # process plane: a heal-source or host-leader kill IS a hard
            # kill — the caller picks a victim it knows holds the role (the
            # thread plane checks the role itself via the live comm)
            ok = self._supervisor.kill(self._gid, sig=signal.SIGKILL)
        elif failure is Failure.SEGFAULT:
            ok = self._supervisor.kill(self._gid, sig=signal.SIGSEGV)
        elif failure is Failure.DEADLOCK:
            # the truest deadlock: every thread frozen, heartbeats included;
            # thaw after ``secs`` so the victim rejoins and heals
            secs = float(kw.get("secs", 12.0))
            ok = self._supervisor.kill(self._gid, sig=signal.SIGSTOP)
            if ok:
                timer = threading.Timer(
                    secs,
                    lambda: self._supervisor.kill(
                        self._gid, sig=signal.SIGCONT
                    ),
                )
                timer.daemon = True
                timer.start()
        else:
            raise ValueError(f"process plane cannot inject {failure}")
        if not ok:
            raise RuntimeError(
                f"{self.name}: no live process to inject {failure.value}"
            )

    def progress(self) -> int:
        return int(self._progress_fn())


class ChaosController:
    """Scriptable failure scenarios over a set of replica handles.

    ``lighthouse_restart`` (when provided) implements
    :attr:`Failure.LIGHTHOUSE`: it must tear down the coordination plane
    and bring it back (same address, empty soft state).
    """

    def __init__(
        self,
        replicas: Sequence[ReplicaHandle],
        lighthouse_restart: Optional[Callable[[], None]] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.replicas = list(replicas)
        self._lighthouse_restart = lighthouse_restart
        self._rng = rng or random.Random()
        self.events: List[ChaosEvent] = []

    # -- injection ---------------------------------------------------------

    def inject(
        self,
        failure: Failure,
        victim: Optional[ReplicaHandle] = None,
        **kw: Any,
    ) -> Optional[ReplicaHandle]:
        """Deliver ``failure``; picks a random supporting victim when none
        is given.  Returns the victim (None for fleet-level failures)."""
        if failure is Failure.LIGHTHOUSE:
            if self._lighthouse_restart is None:
                raise ValueError("no lighthouse_restart configured")
            self._lighthouse_restart()
            self.events.append(
                ChaosEvent(time.time(), failure, victim=None, detail=kw)
            )
            logger.info("chaos: lighthouse restarted")
            return None
        if victim is None:
            candidates = [r for r in self.replicas if r.supports(failure)]
            if not candidates:
                raise ValueError(f"no replica supports {failure}")
            victim = self._rng.choice(candidates)
        victim.inject(failure, **kw)
        detail = dict(kw)
        detail["progress_at_inject"] = victim.progress()
        self.events.append(
            ChaosEvent(time.time(), failure, victim=victim.name, detail=detail)
        )
        logger.info("chaos: %s -> %s %s", failure.value, victim.name, kw)
        return victim

    # -- observation -------------------------------------------------------

    def await_progress(
        self,
        victim: ReplicaHandle,
        beyond: int,
        timeout_s: float,
        poll_s: float = 0.1,
    ) -> bool:
        """Block until ``victim.progress() > beyond`` (False on timeout)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if victim.progress() > beyond:
                return True
            time.sleep(poll_s)
        return victim.progress() > beyond

    def await_heal(
        self, victim: ReplicaHandle, timeout_s: float = 60.0
    ) -> bool:
        """Block until the victim commits beyond its progress at the LAST
        injection against it, plus one step of slack — thread-plane
        failures are armed via flags consumed at the victim's next step
        boundary, so the step in flight at inject time may still commit
        before the failure lands and must not count as healed."""
        baseline = victim.progress()
        slack = 0
        for ev in reversed(self.events):
            if ev.victim == victim.name:
                baseline = max(
                    baseline, int(ev.detail.get("progress_at_inject", 0))
                )
                slack = 1  # the step in flight at inject time
                break
        return self.await_progress(victim, baseline + slack, timeout_s)

    # -- randomized soak ---------------------------------------------------

    def run_poisson(
        self,
        classes: Sequence[Failure],
        mtbf_s: float,
        stop: threading.Event,
        on_inject: Optional[Callable[[ChaosEvent], None]] = None,
        deadlock_secs: Optional[Callable[[], float]] = None,
        rng: Optional[random.Random] = None,
    ) -> Dict[Failure, int]:
        """Inject failures on a Poisson schedule until ``stop`` — the soak
        loop.  Returns per-class injection counts.

        ``rng`` (e.g. ``random.Random(seed)``) makes the whole soak
        reproducible: it drives the inter-arrival draws, the class/victim
        choice and the deadlock durations.  The loop stops cleanly — not
        raising — when every victim is already dead (no replica supports
        any of the requested classes)."""
        if rng is not None:
            self._rng = rng
        counts = {c: 0 for c in classes}
        while not stop.is_set():
            stop.wait(self._rng.expovariate(1.0 / mtbf_s))
            if stop.is_set():
                break
            if not any(
                r.supports(c) for r in self.replicas for c in classes
            ) and not (
                Failure.LIGHTHOUSE in classes
                and self._lighthouse_restart is not None
            ):
                logger.info(
                    "chaos: every victim is dead; ending the soak cleanly"
                )
                break
            cls = self._rng.choice(list(classes))
            kw: Dict[str, Any] = {}
            if cls is Failure.DEADLOCK:
                kw["secs"] = (
                    deadlock_secs() if deadlock_secs
                    else self._rng.uniform(2.0, 22.0)
                )
            try:
                self.inject(cls, **kw)
            except (RuntimeError, ValueError) as e:
                # a victim with no live comm yet (etc.) is a no-op draw,
                # not a soak failure
                logger.info("chaos: %s skipped (%s)", cls.value, e)
                continue
            counts[cls] += 1
            if on_inject:
                on_inject(self.events[-1])
        return counts
