"""Cluster scheduler shims: render/submit FT jobs to SLURM or GKE.

The reference launches replica groups through TorchX components
(``torchft/torchx.py:17-89`` — one role per replica group with the
``REPLICA_GROUP_ID`` / ``NUM_REPLICA_GROUPS`` / ``TORCHFT_LIGHTHOUSE`` env
contract) and a SLURM runner that submits one app per replica group so each
is an independent failure domain
(``torchft/examples/slurm/runner.py:22-115``).  The port renders the
same contract for GPU nodes (the JAX package's ``scheduler.py`` renders it
for TPU slices; the env contract and the watcher are the same bytes):

- **SLURM**: one sbatch script per replica group, asking for
  ``--gpus-per-node`` cards (``--requeue`` gives the scheduler-level
  auto-restart the reference gets from its monitor loop).
- **GKE**: one Job manifest per replica group against a GPU node pool
  (the ``cloud.google.com/gke-accelerator`` node selector,
  ``nvidia.com/gpu`` resources, ``backoffLimit`` restarts).

The input is the same shape ``torchft_tpu_torch.launcher`` takes (replicas +
training cmd + lighthouse), so moving from a single-host supervisor to a
cluster is a flag change, not a rewrite::

    python -m torchft_tpu_torch.scheduler slurm --replicas 4 \
        --lighthouse head-node:29510 --out-dir jobs/ -- \
        python -m torchft_tpu_torch.train_ddp --steps 1000

Rendering is pure (files written to ``--out-dir``); ``--submit`` execs
``sbatch``/``kubectl apply`` on each rendered file when those binaries
exist on PATH.
"""

from __future__ import annotations

import argparse
import logging
import os
import shlex
import shutil
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger("torchft_tpu_torch.scheduler")


@dataclass
class JobSpec:
    """One FT job: N replica groups running ``cmd`` against a lighthouse."""

    replicas: int
    cmd: List[str]
    lighthouse: str
    job_name: str = "torchft-tpu"
    env: Dict[str, str] = field(default_factory=dict)
    # SLURM knobs
    partition: Optional[str] = None
    nodes_per_replica: int = 1
    # cards per node of a replica group (SLURM --gpus-per-node, GKE
    # nvidia.com/gpu); train_ddp runs one process on one card
    gpus_per_node: int = 1
    time_limit: str = "24:00:00"
    max_restarts: int = 10
    # GKE knobs
    image: str = "python:3.12"
    gpu_accelerator: str = "nvidia-h100-80gb"
    namespace: str = "default"

    def contract_env(self, replica_id: int) -> Dict[str, str]:
        """The env contract every backend must deliver (launcher.py twin,
        same names as the reference)."""
        env = {
            "TORCHFT_LIGHTHOUSE": self.lighthouse,
            "REPLICA_GROUP_ID": str(replica_id),
            "NUM_REPLICA_GROUPS": str(self.replicas),
        }
        env.update(self.env)
        return env


def render_sbatch(spec: JobSpec) -> List[Tuple[str, str]]:
    """One sbatch script per replica group (independent failure domains —
    killing/requeueing one group never touches the others, exactly like the
    reference's per-replica TorchX apps)."""
    out = []
    for rid in range(spec.replicas):
        env_lines = "\n".join(
            f"export {k}={shlex.quote(v)}"
            for k, v in spec.contract_env(rid).items()
        )
        partition = (
            f"#SBATCH --partition={spec.partition}\n" if spec.partition else ""
        )
        script = f"""#!/bin/bash
#SBATCH --job-name={spec.job_name}-rg{rid}
#SBATCH --nodes={spec.nodes_per_replica}
#SBATCH --ntasks-per-node=1
#SBATCH --gpus-per-node={spec.gpus_per_node}
#SBATCH --time={spec.time_limit}
#SBATCH --requeue
#SBATCH --open-mode=append
{partition}
# torchft_tpu_torch replica group {rid}/{spec.replicas}: requeue on failure is the
# scheduler-level restart loop; the surviving groups keep training while
# this one comes back and heals from a live peer.
{env_lines}

# multi-host replica groups: every node of this allocation joins the same
# group; group_rank/group_world_size ride on SLURM's own variables
export TPUFT_GROUP_RANK=${{SLURM_NODEID:-0}}
export TPUFT_GROUP_WORLD_SIZE=${{SLURM_NNODES:-1}}

srun --kill-on-bad-exit=1 {shlex.join(spec.cmd)}
"""
        out.append((f"{spec.job_name}-rg{rid}.sbatch", script))
    return out


def render_gke(spec: JobSpec) -> List[Tuple[str, str]]:
    """One Kubernetes Job per replica group against a GPU node pool."""
    import json

    out = []
    for rid in range(spec.replicas):
        # json.dumps is valid YAML and escapes correctly (repr is not:
        # backslashes/quotes in values would corrupt the manifest)
        env_yaml = "\n".join(
            f"            - name: {k}\n              value: {json.dumps(str(v))}"
            for k, v in spec.contract_env(rid).items()
        )
        manifest = f"""apiVersion: batch/v1
kind: Job
metadata:
  name: {spec.job_name}-rg{rid}
  namespace: {spec.namespace}
  labels:
    app: {spec.job_name}
    replica-group: "{rid}"
spec:
  # the restart loop: a killed/crashed group re-runs and heals from a peer
  backoffLimit: {spec.max_restarts}
  template:
    metadata:
      labels:
        app: {spec.job_name}
        replica-group: "{rid}"
    spec:
      restartPolicy: OnFailure
      nodeSelector:
        cloud.google.com/gke-accelerator: {spec.gpu_accelerator}
      containers:
        - name: train
          image: {spec.image}
          command: {json.dumps(spec.cmd)}
          env:
{env_yaml}
          resources:
            requests:
              nvidia.com/gpu: {spec.gpus_per_node}
            limits:
              nvidia.com/gpu: {spec.gpus_per_node}
"""
        out.append((f"{spec.job_name}-rg{rid}.yaml", manifest))
    return out


def write_specs(
    rendered: List[Tuple[str, str]], out_dir: str
) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, content in rendered:
        path = os.path.join(out_dir, name)
        with open(path, "w") as f:
            f.write(content)
        paths.append(path)
    return paths


def submit(backend: str, paths: List[str]) -> None:
    """Submit rendered specs via the scheduler CLI (sbatch / kubectl)."""
    if backend == "slurm":
        tool, args = "sbatch", []
    else:
        tool, args = "kubectl", ["apply", "-f"]
    if shutil.which(tool) is None:
        raise RuntimeError(
            f"{tool} not found on PATH; rendered specs are in "
            f"{os.path.dirname(paths[0])} for manual submission"
        )
    for path in paths:
        subprocess.run([tool, *args, path], check=True)
        logger.info("submitted %s", path)


# The reference templates protocol timeouts into every replica-group job
# (``torchft/examples/slurm/runner.py:83-89``): quorum timeout must dwarf the
# step time (it is the rejoin window), per-op timeout must stay under it so a
# wedged collective aborts before the quorum gives up on the group.
TIMEOUT_ENV_TEMPLATE: Dict[str, str] = {
    "TORCHFT_QUORUM_TIMEOUT_SEC": "900",
    "TORCHFT_TIMEOUT_SEC": "600",
    "TORCHFT_CONNECT_TIMEOUT_SEC": "60",
}


class SlurmCli:
    """Thin sbatch/squeue shim (injectable for tests)."""

    def submit(self, path: str) -> str:
        out = subprocess.run(
            ["sbatch", "--parsable", path],
            check=True,
            capture_output=True,
            text=True,
        ).stdout.strip()
        return out.split(";")[0]  # "<jobid>[;cluster]"

    def state(self, job_id: str) -> str:
        """"RUNNING"/"PENDING"/... or "DEAD" when the queue no longer knows
        the job (finished, failed, or preempted past requeue)."""
        proc = subprocess.run(
            ["squeue", "-h", "-j", job_id, "-o", "%T"],
            capture_output=True,
            text=True,
        )
        state = proc.stdout.strip().splitlines()
        if proc.returncode != 0 or not state:
            return "DEAD"
        return state[0]


class GkeCli:
    """kubectl shim: job name == manifest metadata.name (the render names
    them deterministically)."""

    def __init__(self, namespace: str = "default") -> None:
        self.namespace = namespace

    def submit(self, path: str) -> str:
        name = os.path.splitext(os.path.basename(path))[0]
        # delete-then-apply: a completed/failed Job of the same name blocks
        # resubmission (Jobs are immutable)
        subprocess.run(
            [
                "kubectl", "delete", "job", name,
                "-n", self.namespace, "--ignore-not-found",
            ],
            check=True,
            capture_output=True,
        )
        subprocess.run(
            ["kubectl", "apply", "-f", path], check=True, capture_output=True
        )
        return name

    def state(self, job_id: str) -> str:
        proc = subprocess.run(
            [
                "kubectl", "get", "job", job_id,
                "-n", self.namespace,
                "-o",
                "jsonpath={.status.active},{.status.failed},{.status.succeeded}",
            ],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            return "DEAD"
        parts = (proc.stdout.strip().split(",") + ["", ""])[:3]
        active, failed, succeeded = parts
        if active not in ("", "0"):
            return "RUNNING"
        # a finished Job — failed OR exited 0 (e.g. node drain SIGTERM) —
        # reads DEAD either way: FT training groups run until the whole job
        # ends, so "completed" mid-watch means the group left the fleet
        # (same semantics as SlurmCli, where a job absent from squeue is
        # DEAD regardless of exit code)
        if failed not in ("", "0") or succeeded not in ("", "0"):
            return "DEAD"
        return "PENDING"


@dataclass
class _WatchedGroup:
    rid: int
    path: str
    job_id: Optional[str] = None
    relaunches: int = 0
    backoff_s: float = 0.0
    not_before: float = 0.0  # monotonic gate for the next (re)launch
    launched_at: float = 0.0  # when the current incarnation was submitted
    running_since: float = 0.0  # first observed RUNNING (0 = not yet seen)
    gave_up: bool = False  # out of relaunch budget; no longer polled


class Watcher:
    """Launch + monitor + relaunch replica-group jobs — the other half of
    the reference's SLURM runner (``torchft/examples/slurm/runner.py:120-221``,
    Monarch does the same actor-style).  Each group is an independent
    failure domain: a dead job is resubmitted with per-group exponential
    backoff while the surviving groups keep training; the rejoined group
    heals from a live peer at its next quorum.

    ``backend`` needs only ``submit(path) -> job_id`` and
    ``state(job_id) -> str`` ("DEAD" meaning gone); tests inject fakes,
    deployments use :class:`SlurmCli` / :class:`GkeCli`.
    """

    def __init__(
        self,
        paths: List[str],
        backend,
        poll_s: float = 10.0,
        initial_backoff_s: float = 5.0,
        max_backoff_s: float = 300.0,
        max_relaunches: Optional[int] = None,
        healthy_reset_s: float = 600.0,
        clock=None,
        sleep=None,
    ) -> None:
        import time

        self._groups = [
            _WatchedGroup(rid=i, path=p) for i, p in enumerate(paths)
        ]
        self._backend = backend
        self._poll_s = poll_s
        self._initial_backoff_s = initial_backoff_s
        self._max_backoff_s = max_backoff_s
        self._max_relaunches = max_relaunches
        self._healthy_reset_s = healthy_reset_s
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self._stop = False

    @property
    def groups(self) -> List[_WatchedGroup]:
        return self._groups

    def stop(self) -> None:
        self._stop = True

    def _submit(self, g: _WatchedGroup) -> bool:
        """Submit one group; a transient scheduler failure (slurmctld
        failover, apiserver blip) must never kill the watch loop — the
        group retries after its backoff."""
        try:
            g.job_id = self._backend.submit(g.path)
        except Exception as e:  # noqa: BLE001
            g.backoff_s = min(
                self._max_backoff_s,
                g.backoff_s * 2 if g.backoff_s else self._initial_backoff_s,
            )
            g.not_before = self._clock() + g.backoff_s
            logger.warning(
                "replica group %d submit failed (%s); retrying in %.0fs",
                g.rid,
                e,
                g.backoff_s,
            )
            return False
        g.launched_at = self._clock()
        return True

    def launch_all(self) -> None:
        for g in self._groups:
            if self._submit(g):
                logger.info(
                    "replica group %d submitted as %s", g.rid, g.job_id
                )

    def poll_once(self) -> int:
        """One monitoring pass; returns how many groups are currently being
        relaunched/backed off (0 = everything alive or given up)."""
        pending = 0
        now = self._clock()
        for g in self._groups:
            if g.gave_up:
                continue
            if g.job_id is not None:
                state = self._backend.state(g.job_id)
                if state != "DEAD":
                    # an incarnation that survived a long RUNNING stretch
                    # earns a fresh backoff (crash loops keep ratcheting; a
                    # job dying after days must not wait minutes to respawn).
                    # PENDING time doesn't count — a job stuck in the queue
                    # never ran, so it proved nothing about stability
                    if state == "RUNNING" and g.running_since == 0.0:
                        g.running_since = now
                    elif state != "RUNNING":
                        g.running_since = 0.0
                    if (
                        g.backoff_s
                        and g.running_since
                        and now - g.running_since > self._healthy_reset_s
                    ):
                        g.backoff_s = 0.0
                    continue
                g.running_since = 0.0
                # job vanished: schedule a relaunch with backoff
                if (
                    self._max_relaunches is not None
                    and g.relaunches >= self._max_relaunches
                ):
                    logger.error(
                        "replica group %d (%s) dead and out of relaunches; "
                        "giving up on it",
                        g.rid,
                        g.job_id,
                    )
                    g.job_id = None
                    g.gave_up = True
                    continue
                g.backoff_s = min(
                    self._max_backoff_s,
                    g.backoff_s * 2 if g.backoff_s else self._initial_backoff_s,
                )
                g.not_before = now + g.backoff_s
                logger.warning(
                    "replica group %d (%s) died; relaunching in %.0fs",
                    g.rid,
                    g.job_id,
                    g.backoff_s,
                )
                g.job_id = None
            if g.job_id is None:
                pending += 1
                if now >= g.not_before and self._submit(g):
                    g.relaunches += 1
                    logger.info(
                        "replica group %d relaunched as %s (restart %d)",
                        g.rid,
                        g.job_id,
                        g.relaunches,
                    )
        return pending

    def run(self) -> int:
        """Block, monitoring until :meth:`stop` or until every group has
        permanently given up (deployments run this in the foreground the way
        the reference runner does).  Returns how many groups gave up — 0 is
        a clean stop, nonzero means the fleet died for good."""
        self.launch_all()
        while not self._stop:
            self.poll_once()
            if all(g.gave_up for g in self._groups):
                logger.error(
                    "every replica group is out of relaunches; watch loop "
                    "exiting"
                )
                break
            self._sleep(self._poll_s)
        return sum(1 for g in self._groups if g.gave_up)


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        "torchft_tpu_torch.scheduler",
        description="Render (and optionally submit) FT replica-group jobs "
        "to a cluster scheduler.",
    )
    parser.add_argument("backend", choices=["slurm", "gke"])
    parser.add_argument("--replicas", type=int, required=True)
    parser.add_argument("--lighthouse", required=True)
    parser.add_argument("--job-name", default="torchft-tpu")
    parser.add_argument("--out-dir", default="jobs")
    parser.add_argument("--partition", default=None)
    parser.add_argument("--nodes-per-replica", type=int, default=1)
    parser.add_argument("--time-limit", default="24:00:00")
    parser.add_argument("--max-restarts", type=int, default=10)
    parser.add_argument("--image", default="python:3.12")
    parser.add_argument("--gpu-accelerator", default="nvidia-h100-80gb")
    parser.add_argument("--gpus-per-node", type=int, default=1)
    parser.add_argument("--namespace", default="default")
    parser.add_argument(
        "--env",
        action="append",
        default=[],
        metavar="K=V",
        help="extra env var for every replica group (repeatable)",
    )
    parser.add_argument("--submit", action="store_true")
    parser.add_argument(
        "--watch",
        action="store_true",
        help="after submitting, monitor job state and relaunch dead replica "
        "groups with backoff (implies --submit)",
    )
    parser.add_argument("--poll-s", type=float, default=10.0)
    parser.add_argument(
        "--max-relaunches",
        type=int,
        default=None,
        help="per-group relaunch budget for --watch (default: unlimited)",
    )
    parser.add_argument(
        "--no-timeout-env",
        action="store_true",
        help="skip templating the TORCHFT_*_TIMEOUT_SEC doctrine into jobs",
    )
    # split at "--" before argparse: REMAINDER after a positional swallows
    # the option flags too
    raw = list(sys.argv[1:] if argv is None else argv)
    cmd: List[str] = []
    if "--" in raw:
        split = raw.index("--")
        raw, cmd = raw[:split], raw[split + 1 :]
    args = parser.parse_args(raw)
    logging.basicConfig(level=logging.INFO)

    if not cmd:
        parser.error("training command required after --")

    env = {} if args.no_timeout_env else dict(TIMEOUT_ENV_TEMPLATE)
    for kv in args.env:
        k, _, v = kv.partition("=")
        env[k] = v

    spec = JobSpec(
        replicas=args.replicas,
        cmd=cmd,
        lighthouse=args.lighthouse,
        job_name=args.job_name,
        env=env,
        partition=args.partition,
        nodes_per_replica=args.nodes_per_replica,
        time_limit=args.time_limit,
        max_restarts=args.max_restarts,
        image=args.image,
        gpus_per_node=args.gpus_per_node,
        gpu_accelerator=args.gpu_accelerator,
        namespace=args.namespace,
    )
    rendered = (
        render_sbatch(spec) if args.backend == "slurm" else render_gke(spec)
    )
    paths = write_specs(rendered, args.out_dir)
    for p in paths:
        print(p)
    if args.watch:
        backend = (
            SlurmCli() if args.backend == "slurm" else GkeCli(args.namespace)
        )
        tool = "sbatch" if args.backend == "slurm" else "kubectl"
        if shutil.which(tool) is None:
            raise RuntimeError(f"--watch needs {tool} on PATH")
        watcher = Watcher(
            paths,
            backend,
            poll_s=args.poll_s,
            max_relaunches=args.max_relaunches,
        )
        try:
            gave_up = watcher.run()
        except KeyboardInterrupt:
            watcher.stop()
        else:
            if gave_up:
                sys.exit(1)
    elif args.submit:
        submit(args.backend, paths)


if __name__ == "__main__":
    main()
