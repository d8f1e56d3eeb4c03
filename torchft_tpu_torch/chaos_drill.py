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
"""

from __future__ import annotations

import argparse
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
    freeze_secs: float = 12.0,
    step_time: float = 0.15,
    worker_args: Optional[List[str]] = None,
    logdir: Optional[str] = None,
) -> Dict[str, object]:
    """Run the drill; returns ``{"params_sha", "events", "logs"}`` or raises
    :class:`DrillFailed`.  ``worker_args`` go to every ``train_ddp``
    process after the drill's own (``--steps``, ``--comm-timeout``,
    ``--step-time``)."""
    if replicas < 2:
        raise ValueError("need replicas >= 2 (the victim heals from a peer)")
    if not 0 <= victim < replicas:
        raise ValueError(f"victim {victim} out of range for {replicas} replicas")
    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=1,
        join_timeout_ms=500,
        quorum_tick_ms=20,
    )
    out = Path(logdir or tempfile.mkdtemp(prefix="chaos_drill_"))
    cmd = [
        sys.executable, "-m", "torchft_tpu_torch.train_ddp",
        "--steps", str(steps),
        "--comm-timeout", "5",
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
    runner.start()
    try:
        if not controller.await_progress(target, beyond=5, timeout_s=180.0):
            raise DrillFailed(f"fleet never got going (logs in {out})")
        kw = {"secs": freeze_secs} if failure == "deadlock" else {}
        controller.inject(Failure(failure), victim=target, **kw)
        print(f"injected {failure} into {target.name}", flush=True)
        if not controller.await_heal(target, timeout_s=300.0):
            raise DrillFailed(f"victim never healed (logs in {out})")
        print(f"{target.name} healed; waiting for the fleet to finish", flush=True)
        deadline = time.monotonic() + 60.0 + steps * (step_time + 0.4)
        runner.join(timeout=max(1.0, deadline - time.monotonic()))
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
    parser.add_argument("--freeze-secs", type=float, default=12.0)
    parser.add_argument("--step-time", type=float, default=0.15)
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
    try:
        result = run_drill(args.replicas, args.failure, args.victim, args.steps,
                           args.freeze_secs, args.step_time, worker_args)
    except DrillFailed as e:
        print(str(e), file=sys.stderr)
        return 1
    print(
        f"DRILL PASSED: {args.replicas} replicas agree on params_sha={result['params_sha']} "
        f"after {args.failure} (events: {result['events']})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
