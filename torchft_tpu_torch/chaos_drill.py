"""Scripted chaos scenario against a live FT fleet of the port — the twin of
``examples/chaos_drill.py`` and the user-facing analog of the reference's
Monarch orchestration example (``examples/monarch/train_distributed.py`` +
``utils/failure.py``): supervise N replica groups as real
``python -m torchft_tpu_torch.train_ddp`` processes, inject a typed failure
mid-training, await the heal, and verify the fleet converged to identical
parameters::

    python -m torchft_tpu_torch.chaos_drill --replicas 3 --failure deadlock --steps 120

Failure classes (:class:`torchft_tpu_torch.chaos.Failure`): ``kill``
(SIGKILL + supervisor restart + live heal), ``segfault`` (SIGSEGV, same
recovery), ``deadlock`` (SIGSTOP freeze of every thread — heartbeats
included — until peers evict the frozen member via op timeouts; auto-thaw
then rejoin).  The workers train on the card (``--device cuda``, the
default: Llama-3-8B width cut to ``--layers``, 1 by default so that two
workers with AdamW fit one 80 GB card); ``--device cpu --model
llama_debug`` runs the drill without one.

Every timeout of the drill follows the workers' planned healthy step
(:func:`drill_timing`): the pace ``--step-time`` plus a step's work past it
``--step-work``, whose defaults depend on ``--device``
(:data:`STEP_DEFAULTS`).  The workers' per-op and Manager timeout holds
that work, a deadlock's freeze outlasts the timeout and the lighthouse's
heartbeat timeout, and the warm-up, heal and finish deadlines cover the
steps.  At the JAX example's CPU step they are its constants: a 5 s
timeout, a 12 s freeze and a finish deadline of
``60 + steps * (step_time + 0.4)`` s.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from torchft_tpu_torch.chaos import ChaosController, Failure, ProcessReplica
from torchft_tpu_torch.launcher import ReplicaSpec, ReplicaSupervisor
from torchft_tpu_torch.lighthouse import LighthouseServer

FAILURES = ("kill", "segfault", "deadlock")
# the checkout holding the package: the workers import it with -m
_ROOT = str(Path(__file__).resolve().parent.parent)
# The drill's timing as a function of the workers' healthy step and pace
# (drill_timing).  The per-op and Manager timeout bounds a step's work past
# its pace (at Llama-3-8B width on the card nearly all of it the fence on
# the step's collectives) and a heal's transfer, so it is TIMEOUT_STEPS
# times that work and never under the JAX example's 5 s; a deadlock
# outlasts it, the drill's lighthouse's heartbeat timeout and THAW_SLACK_S
# more, so the peers have evicted the frozen member before it thaws.
MIN_COMM_TIMEOUT_S = 5.0
TIMEOUT_STEPS = 3.0
HEARTBEAT_S = 5.0
THAW_SLACK_S = 2.0
# the steps a thawed member takes to fail its op, rejoin and heal
REJOIN_STEPS = 4
# the steps the fleet commits before the failure, and the JAX example's
# fixed allowances on top of the steps: to get going, to heal, to finish
WARMUP_STEPS = 5
WARMUP_S, HEAL_S, FINISH_S = 180.0, 300.0, 60.0
# the CLI's default (pace, work past it) a step, by the workers' device:
# on the host the JAX example's pace and its allowance for a step's work;
# on the card its default workers' (llama3_8b width, 1 layer: two
# train_ddp workers on one H100 step in ~7 s) and a pace as long, because
# a survivor left alone does little work a step: its step is its pace, and
# with a pace near a healthy step the run's length does not hang on when
# the frozen member returns
STEP_DEFAULTS = {"cpu": (0.15, 0.4), "cuda": (10.0, 10.0)}


class DrillFailed(RuntimeError):
    """The fleet did not start, the victim did not heal, the fleet did not
    finish in time, or the replicas ended with different parameters."""


def committed_progress(text: str) -> int:
    """The highest COMMITTED step a replica group's log shows (the
    ``ReplicaHandle.progress`` contract — ``await_heal`` means "commits
    again", not "attempts again"), as a max over the whole log: a restarted
    incarnation starts logging from step 0 and must not read as
    regression.  Reads ``train_ddp``'s ``step N loss L committed=True``
    lines and its ``FINAL step=N`` line."""
    commits = [int(n) for n in re.findall(r"step (\d+) loss \S+ committed=True", text)]
    commits += [int(n) for n in re.findall(r"FINAL step=(\d+)", text)]
    return max(commits, default=0)


@dataclasses.dataclass(frozen=True)
class DrillTiming:
    """The drill's seconds for a healthy step of ``step_s``, of which
    ``pace_s`` is the workers' pace."""

    step_s: float
    pace_s: float
    comm_timeout_s: float  # the workers' per-op and Manager timeout
    freeze_s: float  # a deadlock's SIGSTOP
    warmup_timeout_s: float  # to commit WARMUP_STEPS steps
    heal_timeout_s: float  # injection to the victim's next commit
    finish_timeout_s: float  # the heal to every worker's FINAL line

    def survivors_outlast_freeze(self, remaining_steps: int) -> bool:
        """Whether survivors with ``remaining_steps`` left after a deadlock's
        injection still train when the frozen member thaws and rejoins: a
        fleet that finishes first leaves the victim to train on alone, and
        the replicas diverge.  The survivors go on alone once the frozen
        member's heartbeat lapses, at no less than their pace a step, and
        must still train when the freeze ends and :data:`REJOIN_STEPS`
        healthy steps later.  On an H100 host a member on the C++ tier
        thawed past its timeout exits (its ``should_commit`` RPC times
        out) and rejoins later than this, as the process its supervisor
        restarts: give such a fleet more steps."""
        return (remaining_steps * self.pace_s
                >= self.freeze_s - HEARTBEAT_S + REJOIN_STEPS * self.step_s)


def drill_timing(step_s: float, steps: int, pace_s: float = STEP_DEFAULTS["cpu"][0],
                 comm_timeout_s: Optional[float] = None,
                 freeze_s: Optional[float] = None) -> DrillTiming:
    """The drill's timing for workers that step in ``step_s``, of which
    ``pace_s`` is their pace, and train ``steps`` steps; ``comm_timeout_s``
    and ``freeze_s``, where given, are kept."""
    comm = (comm_timeout_s if comm_timeout_s is not None
            else max(MIN_COMM_TIMEOUT_S, TIMEOUT_STEPS * max(0.0, step_s - pace_s)))
    freeze = freeze_s if freeze_s is not None else comm + HEARTBEAT_S + THAW_SLACK_S
    return DrillTiming(
        step_s=step_s,
        pace_s=pace_s,
        comm_timeout_s=comm,
        freeze_s=freeze,
        warmup_timeout_s=WARMUP_S + WARMUP_STEPS * step_s,
        # the freeze, the eviction, the rejoin and its heal, two steps
        heal_timeout_s=HEAL_S + freeze + comm + 2 * step_s,
        finish_timeout_s=FINISH_S + steps * step_s,
    )


def final_fields(logs: Dict[int, Path]) -> Dict[int, Dict[str, str]]:
    """Each group's last ``FINAL`` line as its ``key=value`` fields (an
    empty dict if it never finished)."""
    out: Dict[int, Dict[str, str]] = {}
    for gid, path in logs.items():
        lines = re.findall(r"^FINAL (.*)$", path.read_text(), re.M)
        out[gid] = dict(f.split("=", 1) for f in lines[-1].split() if "=" in f) if lines else {}
    return out


def final_hashes(logs: Dict[int, Path]) -> Dict[int, Optional[str]]:
    """Each group's last ``FINAL ... params_sha=`` hash (None if it never
    finished)."""
    out: Dict[int, Optional[str]] = {}
    for gid, path in logs.items():
        found = re.findall(r"FINAL step=(\d+) params_sha=(\w+)", path.read_text())
        out[gid] = found[-1][1] if found else None
    return out


def run_drill(
    replicas: int = 2,
    failure: str = "kill",
    victim: int = 1,
    steps: int = 120,
    freeze_secs: Optional[float] = None,
    step_time: float = STEP_DEFAULTS["cpu"][0],
    step_work: float = STEP_DEFAULTS["cpu"][1],
    worker_args: Optional[List[str]] = None,
    logdir: Optional[str] = None,
) -> Dict[str, object]:
    """Run the drill; returns ``{"params_sha", "events", "logs", "timing",
    "inject_to_commit_s", "wall_s", "finals"}`` or raises
    :class:`DrillFailed`.  ``worker_args`` go to every ``train_ddp``
    process after the drill's own (``--steps``, ``--comm-timeout``,
    ``--step-time``).  The timing is :func:`drill_timing`'s for a healthy
    step of the pace ``step_time`` plus ``step_work``; ``freeze_secs``,
    where given, is kept.  A deadlock's freeze must outlast the timeout,
    and the survivors must outlast the freeze
    (:meth:`DrillTiming.survivors_outlast_freeze`)."""
    if replicas < 2:
        raise ValueError("need replicas >= 2 (the victim heals from a peer)")
    if not 0 <= victim < replicas:
        raise ValueError(f"victim {victim} out of range for {replicas} replicas")
    timing = drill_timing(step_time + step_work, steps, step_time, freeze_s=freeze_secs)
    if failure == "deadlock" and timing.freeze_s <= timing.comm_timeout_s:
        raise ValueError(
            f"a {timing.freeze_s:g} s freeze does not outlast the {timing.comm_timeout_s:g} s "
            "per-op timeout: the peers would never evict the frozen member")
    if failure == "deadlock" and not timing.survivors_outlast_freeze(steps - WARMUP_STEPS - 1):
        raise ValueError(f"{steps} steps of {timing.step_s:g} s end before a "
                         f"{timing.freeze_s:g} s freeze thaws: pass more --steps")
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=1,
        join_timeout_ms=500,
        quorum_tick_ms=20,
        heartbeat_timeout_ms=int(HEARTBEAT_S * 1000),
    )
    out = Path(logdir or tempfile.mkdtemp(prefix="chaos_drill_"))
    cmd = [
        sys.executable, "-m", "torchft_tpu_torch.train_ddp",
        "--steps", str(steps),
        "--comm-timeout", f"{timing.comm_timeout_s:g}",
        "--step-time", str(step_time),
        *(worker_args or []),
    ]
    pythonpath = os.pathsep.join(p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p)
    logs = {i: out / f"rg{i}.log" for i in range(replicas)}
    supervisor = ReplicaSupervisor(
        [
            ReplicaSpec(replica_group_id=i, cmd=list(cmd), log_path=str(logs[i]),
                        env={"PYTHONPATH": pythonpath})
            for i in range(replicas)
        ],
        f"127.0.0.1:{lighthouse.port}",
        restart_delay_s=0.5,
    )

    def _progress(gid: int):
        def read() -> int:
            try:
                return committed_progress(logs[gid].read_text())
            except OSError:
                return 0

        return read

    controller = ChaosController(
        [
            ProcessReplica(f"rg{i}", supervisor, i, progress_fn=_progress(i))
            for i in range(replicas)
        ]
    )
    target = controller.replicas[victim]
    runner = threading.Thread(target=supervisor.run, daemon=True)
    t_start = time.monotonic()
    runner.start()
    try:
        if not controller.await_progress(target, beyond=WARMUP_STEPS,
                                         timeout_s=timing.warmup_timeout_s):
            raise DrillFailed(
                f"fleet never got going in {timing.warmup_timeout_s:.0f} s (per-op timeout "
                f"{timing.comm_timeout_s:g} s for a {timing.step_s:g} s step; logs in {out})")
        kw = {"secs": timing.freeze_s} if failure == "deadlock" else {}
        t_inject = time.monotonic()
        controller.inject(Failure(failure), victim=target, **kw)
        print(f"injected {failure} into {target.name}", flush=True)
        if not controller.await_heal(target, timeout_s=timing.heal_timeout_s):
            raise DrillFailed(f"victim never healed (logs in {out})")
        inject_to_commit_s = time.monotonic() - t_inject
        print(f"{target.name} healed; waiting for the fleet to finish", flush=True)
        runner.join(timeout=timing.finish_timeout_s)
        if runner.is_alive():
            raise DrillFailed(f"fleet did not finish in time (logs in {out})")
        # every replica must print the same final param hash
        hashes = final_hashes(logs)
        missing = [gid for gid, h in hashes.items() if h is None]
        if missing:
            raise DrillFailed(f"replicas {missing} never finished (logs in {out})")
        if len(set(hashes.values())) != 1:
            raise DrillFailed(f"replicas diverged: {hashes}")
        return {
            "params_sha": next(iter(hashes.values())),
            "events": [(e.failure.value, e.victim) for e in controller.events],
            "logs": {gid: str(p) for gid, p in logs.items()},
            "timing": dataclasses.asdict(timing),
            "inject_to_commit_s": inject_to_commit_s,
            "wall_s": time.monotonic() - t_start,
            "finals": final_fields(logs),
        }
    finally:
        supervisor.stop()
        lighthouse.shutdown()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser("chaos_drill", description=__doc__.splitlines()[0])
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--failure", default="kill", choices=FAILURES)
    parser.add_argument("--victim", type=int, default=1)
    parser.add_argument("--steps", type=int, default=120)
    parser.add_argument("--freeze-secs", type=float, default=None,
                        help="a deadlock's freeze (default: the per-op timeout plus the "
                             "lighthouse's heartbeat timeout and 2 s)")
    parser.add_argument("--step-time", type=float, default=None,
                        help="the workers' pace, seconds slept before each step (default by "
                             f"--device: {STEP_DEFAULTS})")
    parser.add_argument("--step-work", type=float, default=None,
                        help="the seconds a healthy step takes past its pace, which the "
                             "timeouts plan for (default by --device, as --step-time's)")
    parser.add_argument("--device", default="cuda", help="the workers' device (cuda or cpu)")
    parser.add_argument("--model", default="llama3_8b", help="the workers' model preset")
    parser.add_argument(
        "--layers", type=int, default=1,
        help="cut the preset's depth to this many layers (default 1, chip_smoke.py's cut: "
             "two llama3_8b-width workers with AdamW fit one 80 GB card, a full-depth one "
             "does not; 0 keeps the preset's depth)")
    parser.add_argument("--seq-len", type=int, default=2048)
    args = parser.parse_args(argv)
    if not 0 <= args.victim < args.replicas:
        parser.error(f"--victim {args.victim} out of range for --replicas {args.replicas}")
    if args.replicas < 2:
        parser.error("need --replicas >= 2 (the victim heals from a peer)")
    worker_args = ["--device", args.device, "--model", args.model, "--seq-len", str(args.seq_len),
                   "--layers", str(args.layers)]
    pace, work = STEP_DEFAULTS["cuda" if args.device.startswith("cuda") else "cpu"]
    try:
        result = run_drill(args.replicas, args.failure, args.victim, args.steps,
                           args.freeze_secs, pace if args.step_time is None else args.step_time,
                           work if args.step_work is None else args.step_work, worker_args)
    except DrillFailed as e:
        print(str(e), file=sys.stderr)
        return 1
    print(
        f"DRILL PASSED: {args.replicas} replicas agree on params_sha={result['params_sha']} "
        f"after {args.failure} (events: {result['events']})"
    )
    print(f"drill numbers: {json.dumps(result)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
