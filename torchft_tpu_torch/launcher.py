"""Replica-group launcher: run an FT job on one or many hosts.

The reference ships a TorchX component that launches N single-node torchrun
roles with ``REPLICA_GROUP_ID`` / ``NUM_REPLICA_GROUPS`` env plumbing
(``torchft/torchx.py:17-89``) plus a SLURM runner
(``torchft/examples/slurm/runner.py``).  This launcher (a copy of the JAX
package's; it holds no arrays) does the same job for one host of GPU
replica groups: spawn one training process per
replica group, each pointed at the shared lighthouse, with automatic restart
of crashed groups (the scheduler role the reference delegates to
torchx/SLURM/Monarch).

CLI::

    python -m torchft_tpu_torch.launcher --replicas 2 --min-replicas 1 \
        -- python -m torchft_tpu_torch.train_ddp --steps 100

Env contract for the child (same names as the reference):
``TORCHFT_LIGHTHOUSE``, ``REPLICA_GROUP_ID``, ``NUM_REPLICA_GROUPS``.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger("torchft_tpu_torch.launcher")


def _reap_async(proc: subprocess.Popen, what: str) -> Optional[threading.Thread]:
    """Wait → SIGKILL → wait, off-thread.  The caller delivers SIGTERM
    inline FIRST — off-thread delivery could be skipped entirely if the
    supervisor exits before the daemon thread runs.

    Retirement runs on the supervisor's poll loop; blocking it for a wedged
    child (SIGTERM ignored in native code) would stall crash detection for
    every OTHER group, so escalation happens on a daemon reaper thread.
    ``Popen.wait`` is safe to call concurrently (internal waitpid lock).
    Returns the reaper thread so terminal paths (``stop()``/``run()``) can
    join it — daemon threads die with the interpreter, which would skip the
    SIGKILL."""
    if proc.poll() is not None:
        return None

    def _reap() -> None:
        try:
            proc.wait(timeout=5.0)
            return
        except subprocess.TimeoutExpired:
            pass
        proc.kill()
        try:
            proc.wait(timeout=5.0)
        except subprocess.TimeoutExpired:  # pragma: no cover
            logger.warning("%s did not die after SIGKILL", what)

    t = threading.Thread(target=_reap, name=f"reap-{what}", daemon=True)
    t.start()
    return t


@dataclass
class ReplicaSpec:
    replica_group_id: int
    cmd: List[str]
    env: Dict[str, str] = field(default_factory=dict)
    # when set, the group's stdout/stderr append here (survives restarts)
    log_path: Optional[str] = None
    # warm standby: keep a pre-initialized spare process parked behind the
    # active one and promote it on death (see ReplicaSupervisor)
    standby: bool = False


STANDBY_GATE_ENV = "TPUFT_STANDBY_GATE"


class ReplicaSupervisor:
    """Spawn + monitor + restart replica-group processes.

    ``max_restarts`` bounds per-group restarts (None = unlimited), matching
    the respawn loop of the reference's SLURM/Monarch orchestrators.

    **Warm standby** (``ReplicaSpec.standby=True``): alongside the active
    process, a spare runs the same command with ``TPUFT_STANDBY_GATE=<file>``
    in its env.  A standby-aware worker does all its expensive
    initialization (python boot, CUDA context, model build, the
    kernels' first launches) and then parks, polling for the gate file; it must NOT
    join the quorum while parked.  When the active process dies, the
    supervisor *promotes* the standby by creating its gate file — the spare
    joins the quorum and heals within a step or two instead of paying tens
    of seconds of cold start — and pre-warms a fresh standby behind it.
    This is the process-level analog of the reference's quorum-level spares
    (``WorldSizeMode.FIXED_WITH_SPARES``, ``torchft/manager.py:123-139``).
    Workers that ignore the env var simply run twice, so only enable it for
    standby-aware commands.
    """

    def __init__(
        self,
        specs: List[ReplicaSpec],
        lighthouse_addr: str,
        max_restarts: Optional[int] = None,
        restart_delay_s: float = 1.0,
    ) -> None:
        self._specs = specs
        self._lighthouse_addr = lighthouse_addr
        self._max_restarts = max_restarts
        self._restart_delay_s = restart_delay_s
        self._procs: Dict[int, subprocess.Popen] = {}
        self._standbys: Dict[int, Tuple[subprocess.Popen, str]] = {}
        self._restarts: Dict[int, int] = {}
        self._gate_dir: Optional[str] = None
        self._gate_seq = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._reapers: List[threading.Thread] = []

    def _spawn(
        self, spec: ReplicaSpec, standby_gate: Optional[str] = None
    ) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(spec.env)
        env["TORCHFT_LIGHTHOUSE"] = self._lighthouse_addr
        env["REPLICA_GROUP_ID"] = str(spec.replica_group_id)
        env["NUM_REPLICA_GROUPS"] = str(len(self._specs))
        if standby_gate is not None:
            env[STANDBY_GATE_ENV] = standby_gate
        else:
            env.pop(STANDBY_GATE_ENV, None)
        logger.info(
            "launching replica group %d: %s", spec.replica_group_id, spec.cmd
        )
        log = None
        if spec.log_path:
            try:
                log = open(spec.log_path, "ab")
            except OSError as e:
                # a broken log sink (deleted dir, full disk) must not take
                # down supervision of every other group — run unlogged
                logger.warning(
                    "replica group %d: cannot open log %s (%s); running unlogged",
                    spec.replica_group_id,
                    spec.log_path,
                    e,
                )
        try:
            if log is not None:
                return subprocess.Popen(
                    spec.cmd, env=env, stdout=log, stderr=subprocess.STDOUT
                )
            return subprocess.Popen(spec.cmd, env=env)
        finally:
            if log is not None:
                log.close()  # the child holds its own fd

    def _new_standby(self, spec: ReplicaSpec) -> Tuple[subprocess.Popen, str]:
        if self._gate_dir is None:
            self._gate_dir = tempfile.mkdtemp(prefix="tpuft_standby_")
        self._gate_seq += 1
        gate = os.path.join(
            self._gate_dir,
            f"gate_{spec.replica_group_id}_{self._gate_seq}",
        )
        return self._spawn(spec, standby_gate=gate), gate

    def run(self) -> int:
        """Run until every group exits cleanly (rc 0) or is out of restarts.
        Returns the worst exit code."""
        with self._lock:
            # _stop re-checked under the lock (same race class as the
            # respawn/re-warm paths): a stop() that ran before this spawn
            # loop snapshotted an empty fleet and will terminate nothing
            for spec in self._specs:
                if self._stop.is_set():
                    break
                self._procs[spec.replica_group_id] = self._spawn(spec)
                self._restarts[spec.replica_group_id] = 0
                if spec.standby:
                    self._standbys[spec.replica_group_id] = self._new_standby(
                        spec
                    )

        worst_rc = 0
        alive = {spec.replica_group_id for spec in self._specs}
        try:
            worst_rc = self._supervise(alive)
        finally:
            # always — an exception escaping the supervise loop must not
            # abandon retire-path reapers mid-escalation (daemon threads
            # die with the interpreter, skipping SIGTERM/SIGKILL)
            self._drain_reapers()
        return worst_rc

    def _supervise(self, alive: set) -> int:
        worst_rc = 0
        while alive and not self._stop.is_set():
            time.sleep(0.2)
            for spec in self._specs:
                gid = spec.replica_group_id
                if gid not in alive:
                    continue
                # a standby that died while parked is replaced quietly (it
                # was never part of the fleet)
                if spec.standby:
                    with self._lock:
                        sb = self._standbys.get(gid)
                        # re-check under the lock: a re-warm racing stop()
                        # would land a fresh spare AFTER stop() cleared
                        # _standbys — never terminated, outliving the
                        # supervisor
                        if (
                            sb is not None
                            and sb[0].poll() is not None
                            and not self._stop.is_set()
                        ):
                            logger.warning(
                                "standby for group %d died while parked; "
                                "re-warming",
                                gid,
                            )
                            self._standbys[gid] = self._new_standby(spec)
                proc = self._procs[gid]
                rc = proc.poll()
                if rc is None:
                    continue
                if rc == 0:
                    logger.info("replica group %d finished", gid)
                    alive.discard(gid)
                    self._retire_standby(gid)
                    continue
                # crash: restart (the whole point of per-step fault tolerance
                # is that the surviving groups kept training meanwhile)
                self._restarts[gid] += 1
                if (
                    self._max_restarts is not None
                    and self._restarts[gid] > self._max_restarts
                ):
                    logger.error(
                        "replica group %d exceeded max_restarts (%d), giving up",
                        gid,
                        self._max_restarts,
                    )
                    # poll() reports signal deaths as negative; a permanently
                    # failed group must never read as success
                    worst_rc = max(worst_rc, abs(rc) or 1)
                    alive.discard(gid)
                    self._retire_standby(gid)
                    continue
                promoted = False
                with self._lock:
                    sb = self._standbys.pop(gid, None)
                    if sb is not None and sb[0].poll() is None:
                        # promote: the gate file releases the parked spare,
                        # which joins the quorum already warm — no restart
                        # delay, no cold start
                        with open(sb[1], "w"):
                            pass
                        self._procs[gid] = sb[0]
                        promoted = True
                if promoted:
                    logger.warning(
                        "replica group %d exited rc=%d; promoted warm "
                        "standby (%d)",
                        gid,
                        rc,
                        self._restarts[gid],
                    )
                    with self._lock:
                        if spec.standby and not self._stop.is_set():
                            self._standbys[gid] = self._new_standby(spec)
                    continue
                logger.warning(
                    "replica group %d exited rc=%d; restarting (%d)",
                    gid,
                    rc,
                    self._restarts[gid],
                )
                time.sleep(self._restart_delay_s)
                if self._stop.is_set():
                    break
                with self._lock:
                    # under the lock, re-checking _stop: stop() sets the
                    # flag before snapshotting under this same lock, so a
                    # respawn racing it would land a child stop() never
                    # terminates
                    if self._stop.is_set():
                        break
                    self._procs[gid] = self._spawn(spec)
        return worst_rc

    # bounded by _reap_async's 5 s SIGTERM + 5 s SIGKILL waits, plus margin
    _REAP_DEADLINE_S = 12.0

    def _drain_reapers(self, extra: Sequence[threading.Thread] = ()) -> None:
        """Join all outstanding reaper threads (terminal paths only):
        daemon reapers die with the interpreter, which would skip the
        SIGKILL escalation for a child wedged in native code."""
        with self._lock:
            reapers, self._reapers = self._reapers + list(extra), []
        deadline = time.monotonic() + self._REAP_DEADLINE_S
        for t in reapers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _retire_standby(self, replica_group_id: int) -> None:
        """A group that left the fleet (clean exit or out of restarts) must
        not leak its parked spare — the spare holds a CUDA context and its weights."""
        with self._lock:
            sb = self._standbys.pop(replica_group_id, None)
        if sb is not None:
            # SIGTERM inline (the reaper thread only escalates): if the
            # supervisor exits before the daemon reaper runs, the spare must
            # at least have been told to die
            if sb[0].poll() is None:
                sb[0].terminate()
            t = _reap_async(sb[0], f"standby for group {replica_group_id}")
            if t is not None:
                # terminal paths (stop / run-exit) join these: a daemon
                # reaper dying with the interpreter would skip the SIGKILL
                with self._lock:
                    self._reapers.append(t)

    def kill(self, replica_group_id: int, sig: int = signal.SIGKILL) -> bool:
        """Chaos hook: kill one group's process (it will be restarted)."""
        with self._lock:
            proc = self._procs.get(replica_group_id)
        if proc is None or proc.poll() is not None:
            return False
        proc.send_signal(sig)
        return True

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            procs = list(self._procs.values())
            standbys = [p for p, _gate in self._standbys.values()]
            self._standbys.clear()
        # SIGTERM is delivered inline — stop() may be the supervisor's last
        # act, and a daemon reaper thread is not guaranteed to run before
        # interpreter exit.  The wait/SIGKILL escalation runs on reaper
        # threads (concurrently across children) but stop() JOINS them with
        # a bounded deadline: primaries and spares alike must not outlive
        # the supervisor holding the card, even when wedged in native
        # code ignoring SIGTERM.
        reapers = []
        for proc in procs + standbys:
            if proc.poll() is None:
                proc.terminate()
                t = _reap_async(proc, "child (supervisor stop)")
                if t is not None:
                    reapers.append(t)
        self._drain_reapers(extra=reapers)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        "torchft_tpu_torch.launcher",
        description="Launch N fault-tolerant replica groups + a lighthouse.",
    )
    parser.add_argument("--replicas", type=int, required=True)
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument(
        "--lighthouse",
        default=None,
        help="existing lighthouse addr; if unset, one is started in-process",
    )
    parser.add_argument("--join-timeout-ms", type=int, default=60_000)
    parser.add_argument("--max-restarts", type=int, default=None)
    parser.add_argument(
        "--native",
        action="store_true",
        help="serve the lighthouse from the C++ runtime",
    )
    parser.add_argument("cmd", nargs=argparse.REMAINDER, help="-- <training cmd>")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("training command required after --")

    lighthouse = None
    lighthouse_addr = args.lighthouse
    if lighthouse_addr is None:
        if args.native:
            from torchft_tpu_torch.native import CppLighthouseServer

            lighthouse = CppLighthouseServer(
                bind="0.0.0.0:0",
                min_replicas=args.min_replicas,
                join_timeout_ms=args.join_timeout_ms,
            )
        else:
            from torchft_tpu_torch.lighthouse import LighthouseServer

            lighthouse = LighthouseServer(
                bind="0.0.0.0:0",
                min_replicas=args.min_replicas,
                join_timeout_ms=args.join_timeout_ms,
            )
        lighthouse_addr = f"127.0.0.1:{lighthouse.port}"
        logger.info("started lighthouse on %s", lighthouse_addr)

    specs = [ReplicaSpec(replica_group_id=i, cmd=list(cmd)) for i in range(args.replicas)]
    supervisor = ReplicaSupervisor(
        specs, lighthouse_addr, max_restarts=args.max_restarts
    )
    try:
        rc = supervisor.run()
    except KeyboardInterrupt:
        supervisor.stop()
        rc = 130
    finally:
        if lighthouse is not None:
            lighthouse.shutdown()
    sys.exit(rc)


if __name__ == "__main__":
    main()
