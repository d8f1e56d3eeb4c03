"""Thread-plane coordination scale harness: 500–1000 simulated replicas.

Drives a real lighthouse (by default in a SUBPROCESS, so its CPU burn is
measurable in isolation via /proc) with hundreds of simulated replicas:
each is one thread running the manager-shaped control loop — park on the
quorum RPC, re-register on every broadcast with an advancing step — while
per-zone beat pumps carry the fleet's heartbeats, either through real
:class:`ZoneAggregator` processes-worth of batching or directly, per
member.  A spare pool parks with ``ROLE_SPARE`` and follows the promotion
fast-path when the lighthouse moves one into the participant set.

What it measures:

- ``p99_quorum_latency_s`` — per-replica quorum RPC round-trip (request →
  broadcast received) through quorum/kill/rejoin/promote churn;
- ``lighthouse_cpu_frac`` — lighthouse-subprocess CPU seconds per wall
  second over the measured window (None when run in-process);
- ``rpc_reduction_vs_direct`` — lighthouse-inbound beat-RPC rate of an
  all-direct calibration window divided by the aggregated steady state
  (the >=10x gate at 500 replicas);
- ``spurious_membership_edits`` — observed ``quorum_id`` bumps minus the
  churn plan's expected edits (kills + rejoins; an aggregator bounce must
  contribute ZERO — aggregator death is a reporting gap, not member
  death).

Run it directly::

    python -m torchft_tpu_torch.coord.scale --replicas 500 --aggregators 2

The CPU tests run ~200 replicas under a hard time budget
(``tests/test_torch_coord.py``); the 500-replica run is the ``slow``-marked
variant.  It runs on the host only: the coordination plane holds no
tensors.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torchft_tpu_torch import knobs
from torchft_tpu_torch.coord.aggregator import AggMemberClient, ZoneAggregator
from torchft_tpu_torch.lighthouse import LighthouseClient, LighthouseServer
from torchft_tpu_torch.wire import ROLE_ACTIVE, ROLE_SPARE, WireError

logger = logging.getLogger(__name__)

_LH_SCRIPT = """\
import sys, time
from torchft_tpu_torch.lighthouse import LighthouseServer
s = LighthouseServer(
    bind="127.0.0.1:0",
    min_replicas=int(sys.argv[1]),
    join_timeout_ms=int(sys.argv[2]),
    quorum_tick_ms=int(sys.argv[3]),
    heartbeat_timeout_ms=int(sys.argv[4]),
)
print("PORT", s.port, flush=True)
while True:
    time.sleep(3600)
"""


def _proc_cpu_seconds(pid: int) -> Optional[float]:
    """utime+stime of one pid in seconds (Linux /proc; None elsewhere)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            raw = f.read()
        # comm may contain spaces/parens: fields restart after the last ')'
        rest = raw[raw.rindex(")") + 2 :].split()
        utime, stime = int(rest[11]), int(rest[12])
        return (utime + stime) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class _Lighthouse:
    """A lighthouse either as a subprocess (CPU-measurable) or in-proc."""

    def __init__(
        self,
        min_replicas: int,
        join_timeout_ms: int,
        tick_ms: int,
        hb_timeout_ms: int,
        subprocess_mode: bool,
    ) -> None:
        self.proc: Optional[subprocess.Popen] = None
        self.server: Optional[LighthouseServer] = None
        if subprocess_mode:
            repo_root = os.path.dirname(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            )
            env = dict(os.environ)
            env["PYTHONPATH"] = (
                repo_root + os.pathsep + env.get("PYTHONPATH", "")
            )
            self.proc = subprocess.Popen(
                [
                    sys.executable,
                    "-c",
                    _LH_SCRIPT,
                    str(min_replicas),
                    str(join_timeout_ms),
                    str(tick_ms),
                    str(hb_timeout_ms),
                ],
                stdout=subprocess.PIPE,
                env=env,
                text=True,
            )
            assert self.proc.stdout is not None
            line = self.proc.stdout.readline()
            if not line.startswith("PORT "):
                raise RuntimeError(
                    f"lighthouse subprocess failed to start: {line!r}"
                )
            self.port = int(line.split()[1])
        else:
            self.server = LighthouseServer(
                bind="127.0.0.1:0",
                min_replicas=min_replicas,
                join_timeout_ms=join_timeout_ms,
                quorum_tick_ms=tick_ms,
                heartbeat_timeout_ms=hb_timeout_ms,
            )
            self.port = self.server.port
        self.addr = f"127.0.0.1:{self.port}"

    def cpu_seconds(self) -> Optional[float]:
        if self.proc is not None:
            return _proc_cpu_seconds(self.proc.pid)
        return None

    def shutdown(self) -> None:
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        if self.server is not None:
            self.server.shutdown()


@dataclass
class _SimReplica:
    """One simulated replica: the manager-shaped quorum loop in a thread.
    Heartbeats are carried by the zone's beat pump, not this thread."""

    rid: str
    role: int = ROLE_ACTIVE
    alive: bool = True
    step: int = 0
    warm_step: int = 0
    promoted: bool = False
    latencies: List[float] = field(default_factory=list)
    thread: Optional[threading.Thread] = None
    client: Optional[LighthouseClient] = None

    def kill(self) -> None:
        self.alive = False
        client = self.client
        if client is not None:
            client.interrupt()


class _BeatPump(threading.Thread):
    """Carries heartbeats for a zone's members at a fixed cadence.  One
    pump thread stands in for its members' heartbeat threads — the WIRE
    traffic (one AGG_BEAT or LH_HEARTBEAT frame per member per interval)
    is exactly what per-member threads would produce, which is what the
    lighthouse-inbound measurement cares about.  Implements the same
    fall-back-to-direct-on-aggregator-death policy as
    ``manager_server._run_heartbeat``."""

    def __init__(
        self,
        name: str,
        members: List[_SimReplica],
        lighthouse_addr: str,
        agg_addr: Optional[str],
        interval_s: float,
        stop: threading.Event,
    ) -> None:
        super().__init__(name=f"tpuft_beat_pump_{name}", daemon=True)
        self.members = members
        self._lh_addr = lighthouse_addr
        self.agg_addr = agg_addr
        self._interval_s = interval_s
        self._halt = stop
        self.fallback_beats = 0
        self._agg_down_until = 0.0

    def run(self) -> None:
        agg_client: Optional[AggMemberClient] = None
        direct: Optional[LighthouseClient] = None
        while not self._halt.is_set():
            t0 = time.monotonic()
            for m in list(self.members):
                if not m.alive or self._halt.is_set():
                    continue
                warm = m.warm_step if m.role == ROLE_SPARE else -1
                agg_addr = self.agg_addr
                if (
                    agg_addr is not None
                    and time.monotonic() >= self._agg_down_until
                ):
                    try:
                        if agg_client is None or agg_client.addr != agg_addr:
                            if agg_client is not None:
                                agg_client.close()
                            agg_client = AggMemberClient(
                                agg_addr, connect_timeout=5.0
                            )
                        resp = agg_client.beat(
                            m.rid, role=m.role, warm_step=warm
                        )
                        if resp["upstream_ok"]:
                            continue
                        # aggregator up but its upstream flushes failing:
                        # same policy as the manager — beat direct instead
                    except (OSError, TimeoutError, WireError):
                        # dead aggregator: one failed dial per cooloff, not
                        # one per member per sweep — the rest of this sweep
                        # (and sweeps until the cooloff expires) go direct
                        if agg_client is not None:
                            agg_client.close()
                        agg_client = None
                        self.fallback_beats += 1
                        self._agg_down_until = (
                            time.monotonic()
                            + knobs.get_float("TORCHFT_AGG_RETRY_S", 2.0)
                        )
                try:
                    if direct is None:
                        direct = LighthouseClient(
                            self._lh_addr, connect_timeout=5.0
                        )
                    direct.heartbeat(
                        m.rid, warm_step=warm if warm >= 0 else None
                    )
                except (OSError, TimeoutError, WireError):
                    if direct is not None:
                        direct.close()
                    direct = None
            self._halt.wait(
                max(0.0, self._interval_s - (time.monotonic() - t0))
            )
        for c in (agg_client, direct):
            if c is not None:
                c.close()


def _quorum_loop(
    replica: _SimReplica,
    lighthouse_addr: str,
    stop: threading.Event,
    rpc_timeout_s: float,
    round_pause_s: float,
) -> None:
    client = LighthouseClient(lighthouse_addr, connect_timeout=10.0)
    replica.client = client
    try:
        while not stop.is_set() and replica.alive:
            t0 = time.monotonic()
            try:
                quorum = client.quorum(
                    replica_id=replica.rid,
                    timeout=rpc_timeout_s,
                    address=f"sim://{replica.rid}",
                    store_address=f"sim-store://{replica.rid}",
                    step=replica.step,
                    role=replica.role,
                )
            except TimeoutError:
                continue
            except (ConnectionError, OSError, WireError):
                if stop.is_set() or not replica.alive:
                    return
                time.sleep(0.05)
                continue
            dt = time.monotonic() - t0
            in_quorum = any(
                p.replica_id == replica.rid for p in quorum.participants
            )
            max_step = max(
                (p.step for p in quorum.participants), default=0
            )
            if in_quorum:
                replica.latencies.append(dt)
                if replica.role == ROLE_SPARE:
                    # promotion fast-path landed: from here on this
                    # replica registers as an ordinary active
                    replica.role = ROLE_ACTIVE
                    replica.promoted = True
                # advance the commit front like a training step would
                replica.step = max(replica.step, max_step) + 1
            else:
                # parked spare: track the commit front as its warm
                # watermark (rides the beat pump to the lighthouse)
                replica.warm_step = max_step
            if round_pause_s > 0:
                stop.wait(round_pause_s)
    finally:
        client.close()


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))
    return ordered[idx]


def _beat_rpc_sample(status: dict) -> tuple:
    """(inbound beat RPC total, snapshot clock).  Rates difference against
    the snapshot's OWN rebuild time — status is TTL-cached, so the poll
    time would over/under-state the window by up to one TTL."""
    counts = status.get("rpc_counts", {})
    total = int(counts.get("LH_HEARTBEAT_REQ", 0)) + int(
        counts.get("LH_AGG_BEAT_REQ", 0)
    )
    return total, float(status.get("now_monotonic", 0.0))


def run_scale_harness(
    num_replicas: int = 500,
    num_aggregators: int = 2,
    num_spares: int = 4,
    direct_fraction: float = 0.05,
    kills: int = 2,
    rejoins: int = 1,
    agg_bounce: bool = True,
    beat_interval_s: float = 0.25,
    round_pause_s: Optional[float] = None,
    calibrate_direct_s: float = 1.5,
    steady_s: float = 2.5,
    hb_timeout_ms: int = 2000,
    tick_ms: int = 50,
    join_timeout_ms: int = 1000,
    rpc_timeout_s: float = 15.0,
    lighthouse_subprocess: bool = True,
    deadline_s: float = 180.0,
) -> Dict[str, object]:
    """Run the full churn scenario; returns the metrics dict (see module
    docstring).  Raises AssertionError when an invariant breaks (spurious
    membership edits, promotions that never landed, fleet that never
    converged)."""
    t_start = time.monotonic()
    deadline = t_start + deadline_s
    if round_pause_s is None:
        # self-pace the quorum storm with fleet size: the harness hosts
        # every simulated replica in ONE process, so per-round client-side
        # work is O(replicas^2) and an unpaced storm would starve the
        # measurement at the top of the range
        round_pause_s = max(0.05, num_replicas / 4000.0)
    # same single-process reality for liveness: hundreds of sim threads
    # share one GIL with the beat pumps, so scheduler starvation can
    # stretch a pump sweep well past a bound sized for real fleets —
    # scale the heartbeat verdict with the thread count
    hb_timeout_ms = max(hb_timeout_ms, num_replicas * 10)
    stop = threading.Event()
    lighthouse = _Lighthouse(
        min_replicas=max(1, num_replicas // 2),
        join_timeout_ms=join_timeout_ms,
        tick_ms=tick_ms,
        hb_timeout_ms=hb_timeout_ms,
        subprocess_mode=lighthouse_subprocess,
    )
    status_client = LighthouseClient(lighthouse.addr, connect_timeout=10.0)
    aggregators: List[ZoneAggregator] = []
    pumps: List[_BeatPump] = []
    report: Dict[str, object] = {
        "replicas": num_replicas,
        "aggregators": num_aggregators,
        "spares": num_spares,
        "direct_fraction": direct_fraction,
    }

    def remaining() -> float:
        return deadline - time.monotonic()

    def wait_status(pred, what: str, budget_s: float = 30.0) -> dict:
        end = time.monotonic() + min(budget_s, max(1.0, remaining()))
        status = {}
        while time.monotonic() < end:
            try:
                status = status_client.status(timeout=5.0)
            except (OSError, TimeoutError, WireError):
                time.sleep(0.2)
                continue
            if pred(status):
                return status
            time.sleep(0.1)
        raise AssertionError(f"scale harness: {what} (last status {status})")

    actives = [
        _SimReplica(rid=f"sim_{i:04d}") for i in range(num_replicas)
    ]
    spares = [
        _SimReplica(rid=f"sim_spare_{i:02d}", role=ROLE_SPARE)
        for i in range(num_spares)
    ]
    n_direct = max(0, int(num_replicas * direct_fraction))

    try:
        # -- phase 1: all-direct calibration window -----------------------
        # every member beats the lighthouse directly; the measured beat-RPC
        # rate is the flat-control-plane baseline the aggregation win is
        # quoted against
        calib_pump = _BeatPump(
            "calib",
            actives + spares,
            lighthouse.addr,
            agg_addr=None,
            interval_s=beat_interval_s,
            stop=stop,
        )
        before_n, before_t = _beat_rpc_sample(
            status_client.status(timeout=5.0)
        )
        calib_pump.start()
        time.sleep(max(0.5, calibrate_direct_s))
        after_n, after_t = _beat_rpc_sample(status_client.status(timeout=5.0))
        if after_t <= before_t:  # same cached snapshot: outwait the TTL
            time.sleep(knobs.get_float("TORCHFT_STATUS_TTL_S", 0.5) + 0.1)
            after_n, after_t = _beat_rpc_sample(
                status_client.status(timeout=5.0)
            )
        direct_rate = (after_n - before_n) / max(1e-3, after_t - before_t)
        report["direct_beat_rpcs_per_s"] = round(direct_rate, 1)
        # retire the calibration pump (its Event is shared; use a fresh
        # stop for the real run)
        stop.set()
        calib_pump.join(timeout=10.0)
        stop = threading.Event()

        # -- phase 2: aggregated topology ---------------------------------
        for i in range(num_aggregators):
            aggregators.append(
                ZoneAggregator(
                    lighthouse.addr,
                    bind="127.0.0.1:0",
                    agg_id=f"zone_{i}",
                )
            )
        # mixed fleet: the first n_direct actives beat direct forever; the
        # rest (and every spare) ride their zone's aggregator
        zones: List[List[_SimReplica]] = [[] for _ in aggregators]
        for j, m in enumerate(actives[n_direct:] + spares):
            zones[j % len(zones)].append(m)
        for i, zone in enumerate(zones):
            pumps.append(
                _BeatPump(
                    f"zone{i}",
                    zone,
                    lighthouse.addr,
                    agg_addr=aggregators[i].local_address(),
                    interval_s=beat_interval_s,
                    stop=stop,
                )
            )
        if n_direct:
            pumps.append(
                _BeatPump(
                    "direct",
                    actives[:n_direct],
                    lighthouse.addr,
                    agg_addr=None,
                    interval_s=beat_interval_s,
                    stop=stop,
                )
            )
        for p in pumps:
            p.start()

        # -- phase 3: fleet convergence -----------------------------------
        for m in actives + spares:
            m.thread = threading.Thread(
                target=_quorum_loop,
                args=(m, lighthouse.addr, stop, rpc_timeout_s, round_pause_s),
                name=f"tpuft_sim_{m.rid}",
                daemon=True,
            )
            m.thread.start()
        status = wait_status(
            lambda s: s.get("num_participants") == num_replicas,
            f"fleet never converged to {num_replicas} participants",
            budget_s=60.0,
        )
        qid_converged = int(status["quorum_id"])
        report["converge_s"] = round(time.monotonic() - t_start, 2)

        # -- phase 4: steady-state measurement ----------------------------
        cpu0 = lighthouse.cpu_seconds()
        before_n, before_t = _beat_rpc_sample(
            status_client.status(timeout=5.0)
        )
        t_steady = time.monotonic()
        time.sleep(max(0.5, steady_s))
        after_n, after_t = _beat_rpc_sample(status_client.status(timeout=5.0))
        if after_t <= before_t:
            time.sleep(knobs.get_float("TORCHFT_STATUS_TTL_S", 0.5) + 0.1)
            after_n, after_t = _beat_rpc_sample(
                status_client.status(timeout=5.0)
            )
        agg_rate = (after_n - before_n) / max(1e-3, after_t - before_t)
        report["agg_beat_rpcs_per_s"] = round(agg_rate, 1)
        report["rpc_reduction_vs_direct"] = (
            round(direct_rate / agg_rate, 1) if agg_rate > 0 else None
        )

        # -- phase 5: churn -----------------------------------------------
        expected_edits = 0
        promoted_expected = 0
        killed: List[_SimReplica] = []
        live_spares = num_spares
        for k in range(kills):
            victim = actives[-(1 + k)]
            victim.kill()
            killed.append(victim)
            expected_edits += 1
            if live_spares > 0:
                live_spares -= 1
                promoted_expected += 1
            wait_status(
                lambda s: s.get("num_participants")
                == num_replicas - len(killed) + promoted_expected
                and int(s.get("promotions_total", 0)) >= promoted_expected,
                f"membership never settled after kill #{k + 1}",
                budget_s=45.0,
            )
        if rejoins:
            for j in range(min(rejoins, len(killed))):
                reborn = _SimReplica(rid=f"sim_rejoin_{j:02d}")
                actives.append(reborn)
                zones[j % len(zones)].append(reborn)
                expected_edits += 1
                reborn.thread = threading.Thread(
                    target=_quorum_loop,
                    args=(
                        reborn,
                        lighthouse.addr,
                        stop,
                        rpc_timeout_s,
                        round_pause_s,
                    ),
                    name=f"tpuft_sim_{reborn.rid}",
                    daemon=True,
                )
                reborn.thread.start()
            expected_participants = (
                num_replicas - len(killed) + promoted_expected + rejoins
            )
            wait_status(
                lambda s: s.get("num_participants") == expected_participants,
                "rejoin never landed",
                budget_s=45.0,
            )

        # -- phase 6: aggregator bounce (the reporting-gap proof) ---------
        if agg_bounce and aggregators:
            pre = status_client.status(timeout=5.0)
            qid_pre_bounce = int(pre["quorum_id"])
            bounced = aggregators[0]
            bounced.shutdown()
            # longer than the aggregator-death bound, shorter than the
            # member grace: pumps fall back to direct beats meanwhile
            agg_timeout_s = knobs.get_float("TORCHFT_AGG_TIMEOUT_S", 1.0)
            time.sleep(agg_timeout_s + 1.0)
            replacement = ZoneAggregator(
                lighthouse.addr, bind="127.0.0.1:0", agg_id="zone_0_reborn"
            )
            aggregators.append(replacement)
            for p in pumps:
                if p.agg_addr == bounced.local_address():
                    p.agg_addr = replacement.local_address()
            time.sleep(1.0)
            post = status_client.status(timeout=5.0)
            qid_post_bounce = int(post["quorum_id"])
            report["agg_bounce_edits"] = qid_post_bounce - qid_pre_bounce
            assert qid_post_bounce == qid_pre_bounce, (
                f"aggregator bounce cost {qid_post_bounce - qid_pre_bounce} "
                "membership edit(s) — aggregator death must be a reporting "
                "gap, not a member death"
            )
            report["pump_fallback_beats"] = sum(
                p.fallback_beats for p in pumps
            )

        # -- phase 7: final accounting ------------------------------------
        cpu1 = lighthouse.cpu_seconds()
        final = status_client.status(timeout=5.0)
        qid_final = int(final["quorum_id"])
        observed_edits = qid_final - qid_converged
        report["quorum_id_final"] = qid_final
        report["expected_membership_edits"] = expected_edits
        report["observed_membership_edits"] = observed_edits
        report["spurious_membership_edits"] = observed_edits - expected_edits
        report["promotions_total"] = int(final.get("promotions_total", 0))
        report["promoted_spares"] = sum(1 for s in spares if s.promoted)
        all_latencies = [
            lat for m in actives + spares for lat in m.latencies
        ]
        report["quorum_rounds_observed"] = len(all_latencies)
        report["p50_quorum_latency_s"] = _percentile(all_latencies, 0.50)
        report["p99_quorum_latency_s"] = _percentile(all_latencies, 0.99)
        if cpu0 is not None and cpu1 is not None:
            wall = time.monotonic() - t_steady
            report["lighthouse_cpu_frac"] = round(
                max(0.0, cpu1 - cpu0) / wall, 3
            )
        else:
            report["lighthouse_cpu_frac"] = None
        report["status_rebuilds"] = int(final.get("status_rebuilds", 0))
        report["wall_s"] = round(time.monotonic() - t_start, 2)
        assert report["promotions_total"] >= promoted_expected, report
        assert observed_edits == expected_edits, (
            f"spurious membership edits: expected {expected_edits} "
            f"(kills+rejoins), observed {observed_edits} — {report}"
        )
        return report
    finally:
        stop.set()
        for m in actives + spares:
            m.alive = False
            if m.client is not None:
                m.client.interrupt()
        for m in actives + spares:
            if m.thread is not None:
                m.thread.join(timeout=5.0)
        for p in pumps:
            p.join(timeout=5.0)
        for agg in aggregators:
            agg.shutdown()
        status_client.close()
        lighthouse.shutdown()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser("torchft_tpu_torch coordination scale harness")
    parser.add_argument("--replicas", type=int, default=500)
    parser.add_argument("--aggregators", type=int, default=2)
    parser.add_argument("--spares", type=int, default=4)
    parser.add_argument("--kills", type=int, default=2)
    parser.add_argument("--rejoins", type=int, default=1)
    parser.add_argument("--no-agg-bounce", action="store_true")
    parser.add_argument("--deadline-s", type=float, default=180.0)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    report = run_scale_harness(
        num_replicas=args.replicas,
        num_aggregators=args.aggregators,
        num_spares=args.spares,
        kills=args.kills,
        rejoins=args.rejoins,
        agg_bounce=not args.no_agg_bounce,
        deadline_s=args.deadline_s,
    )
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
