"""The port's scheduler shims (``torchft_tpu_torch.scheduler``):
``tests/test_scheduler.py``'s cases on the port, whose SLURM scripts ask
for ``--gpus-per-node`` cards and whose GKE Jobs select an
``nvidia-h100-80gb`` node pool with ``nvidia.com/gpu`` limits (the JAX
package renders TPU slices); the env contract, the watcher's relaunch and
backoff are the JAX package's, and the contract lines of a rendering equal
the JAX package's byte for byte."""

import subprocess
import sys

import yaml

from torchft_tpu_torch.scheduler import JobSpec, render_gke, render_sbatch


def _spec(**kw) -> JobSpec:
    base = dict(
        replicas=3,
        cmd=["python", "train.py", "--steps", "100"],
        lighthouse="head:29510",
    )
    base.update(kw)
    return JobSpec(**base)


def _contract_lines(text: str) -> list:
    return [line for line in text.splitlines()
            if line.startswith("export ") or line.startswith("srun ")]


class TestSlurm:
    def test_one_script_per_replica_group(self) -> None:
        rendered = render_sbatch(_spec())
        assert len(rendered) == 3
        names = [n for n, _ in rendered]
        assert names == [f"torchft-tpu-rg{i}.sbatch" for i in range(3)]

    def test_env_contract(self) -> None:
        rendered = render_sbatch(_spec(env={"EXTRA": "x y"}))
        for rid, (_, script) in enumerate(rendered):
            assert f"export REPLICA_GROUP_ID={rid}" in script
            assert "export NUM_REPLICA_GROUPS=3" in script
            assert "export TORCHFT_LIGHTHOUSE=head:29510" in script
            assert "export EXTRA='x y'" in script  # quoting
            assert "#SBATCH --requeue" in script  # the restart loop
            assert "python train.py --steps 100" in script

    def test_multihost_group_vars(self) -> None:
        (_, script), *_ = render_sbatch(_spec(nodes_per_replica=4))
        assert "#SBATCH --nodes=4" in script
        assert "TPUFT_GROUP_RANK=${SLURM_NODEID:-0}" in script

    def test_gpus_per_node(self) -> None:
        (_, one), *_ = render_sbatch(_spec())
        assert "#SBATCH --gpus-per-node=1" in one
        (_, eight), *_ = render_sbatch(_spec(gpus_per_node=8))
        assert "#SBATCH --gpus-per-node=8" in eight

    def test_contract_lines_equal_the_jax_rendering(self) -> None:
        from torchft_tpu import scheduler as jax_scheduler

        kw = dict(replicas=3, cmd=["python", "-m", "torchft_tpu_torch.train_ddp"],
                  lighthouse="head:29510", env={"EXTRA": "x y"}, nodes_per_replica=2)
        ours = render_sbatch(JobSpec(**kw))
        theirs = jax_scheduler.render_sbatch(jax_scheduler.JobSpec(**kw))
        assert [n for n, _ in ours] == [n for n, _ in theirs]
        for (_, a), (_, b) in zip(ours, theirs):
            assert _contract_lines(a) == _contract_lines(b)
            assert "srun --kill-on-bad-exit=1 python -m torchft_tpu_torch.train_ddp" in a

    def test_partition_optional(self) -> None:
        (_, with_p), *_ = render_sbatch(_spec(partition="tpu"))
        assert "#SBATCH --partition=tpu" in with_p
        (_, without), *_ = render_sbatch(_spec())
        assert "--partition" not in without


class TestGke:
    def test_manifests_parse_and_carry_contract(self) -> None:
        rendered = render_gke(_spec(gpus_per_node=8))
        assert len(rendered) == 3
        for rid, (_name, manifest) in enumerate(rendered):
            doc = yaml.safe_load(manifest)
            assert doc["kind"] == "Job"
            assert doc["metadata"]["name"] == f"torchft-tpu-rg{rid}"
            container = doc["spec"]["template"]["spec"]["containers"][0]
            env = {e["name"]: e["value"] for e in container["env"]}
            assert env["REPLICA_GROUP_ID"] == str(rid)
            assert env["NUM_REPLICA_GROUPS"] == "3"
            assert env["TORCHFT_LIGHTHOUSE"] == "head:29510"
            assert container["resources"]["limits"]["nvidia.com/gpu"] == 8
            assert container["resources"]["requests"]["nvidia.com/gpu"] == 8
            sel = doc["spec"]["template"]["spec"]["nodeSelector"]
            assert sel == {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}

    def test_env_equals_the_jax_manifest(self) -> None:
        from torchft_tpu import scheduler as jax_scheduler

        kw = dict(replicas=2, cmd=["python", "-m", "torchft_tpu_torch.train_ddp"],
                  lighthouse="lh:1", env={"FLAGS": "a b"})
        for (_, ours), (_, theirs) in zip(render_gke(JobSpec(**kw)),
                                          jax_scheduler.render_gke(jax_scheduler.JobSpec(**kw))):
            c_ours = yaml.safe_load(ours)["spec"]["template"]["spec"]["containers"][0]
            c_theirs = yaml.safe_load(theirs)["spec"]["template"]["spec"]["containers"][0]
            assert c_ours["env"] == c_theirs["env"]
            assert c_ours["command"] == c_theirs["command"]


def test_gke_env_special_chars_survive_yaml(tmp_path) -> None:
    """Backslashes/quotes in env values must round-trip through the
    manifest (json-encoded scalars, not repr)."""
    tricky = 'a\\n--b "quoted" \'single\''
    (_, manifest), *_ = render_gke(_spec(env={"FLAGS": tricky}))
    doc = yaml.safe_load(manifest)
    env = {
        e["name"]: e["value"]
        for e in doc["spec"]["template"]["spec"]["containers"][0]["env"]
    }
    assert env["FLAGS"] == tricky


def test_cli_renders_files(tmp_path) -> None:
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    out = subprocess.run(
        [
            sys.executable,
            "-m",
            "torchft_tpu_torch.scheduler",
            "slurm",
            "--replicas",
            "2",
            "--lighthouse",
            "lh:1234",
            "--out-dir",
            str(tmp_path),
            "--gpus-per-node",
            "4",
            "--",
            "python",
            "-m",
            "torchft_tpu_torch.train_ddp",
        ],
        capture_output=True,
        text=True,
        check=True,
        env=env,
    )
    paths = out.stdout.split()
    assert len(paths) == 2
    content = open(paths[0]).read()
    assert "TORCHFT_LIGHTHOUSE=lh:1234" in content
    assert "#SBATCH --gpus-per-node=4" in content
    assert "python -m torchft_tpu_torch.train_ddp" in content


class _FakeBackend:
    """Scripted scheduler: records submits, serves states from a queue."""

    def __init__(self):
        self.submits = []
        self.states = {}  # job_id -> list of states to serve (last repeats)
        self._n = 0

    def submit(self, path: str) -> str:
        self._n += 1
        job_id = f"job{self._n}"
        self.submits.append((path, job_id))
        return job_id

    def state(self, job_id: str) -> str:
        seq = self.states.get(job_id, ["RUNNING"])
        return seq.pop(0) if len(seq) > 1 else seq[0]


class TestWatcher:
    """The launch/monitor/relaunch loop, against a scripted backend
    (the reference's runner does the same against torchx-slurm,
    ``torchft/examples/slurm/runner.py:120-221``)."""

    def _watcher(self, backend, paths=("a.sbatch", "b.sbatch"), **kw):
        from torchft_tpu_torch.scheduler import Watcher

        clock = {"t": 0.0}
        kw.setdefault("clock", lambda: clock["t"])
        kw.setdefault("sleep", lambda s: None)
        w = Watcher(list(paths), backend, **kw)
        return w, clock

    def test_launches_every_group(self) -> None:
        backend = _FakeBackend()
        w, _ = self._watcher(backend)
        w.launch_all()
        assert [p for p, _ in backend.submits] == ["a.sbatch", "b.sbatch"]
        assert w.poll_once() == 0  # all RUNNING: nothing pending

    def test_dead_group_relaunched_with_backoff(self) -> None:
        backend = _FakeBackend()
        w, clock = self._watcher(backend, initial_backoff_s=5.0)
        w.launch_all()
        backend.states["job2"] = ["DEAD"]
        # death detected: relaunch scheduled, not yet executed (backoff)
        assert w.poll_once() == 1
        assert len(backend.submits) == 2
        clock["t"] = 4.0
        assert w.poll_once() == 1  # still inside the backoff window
        assert len(backend.submits) == 2
        clock["t"] = 5.0
        w.poll_once()
        assert len(backend.submits) == 3
        assert backend.submits[-1][0] == "b.sbatch"  # same group resubmitted
        assert w.groups[1].relaunches == 1
        # the healthy group was never touched
        assert w.groups[0].relaunches == 0

    def test_backoff_doubles_and_caps(self) -> None:
        backend = _FakeBackend()
        w, clock = self._watcher(
            backend, paths=("a.sbatch",), initial_backoff_s=5.0, max_backoff_s=12.0
        )
        w.launch_all()
        expected = [5.0, 10.0, 12.0, 12.0]  # doubling, capped
        for backoff in expected:
            jid = w.groups[0].job_id
            backend.states[jid] = ["DEAD"]
            w.poll_once()
            assert w.groups[0].backoff_s == backoff
            clock["t"] += backoff
            w.poll_once()
            assert w.groups[0].job_id is not None

    def test_max_relaunches_gives_up(self) -> None:
        backend = _FakeBackend()
        w, clock = self._watcher(
            backend, paths=("a.sbatch",), initial_backoff_s=0.0, max_relaunches=2
        )
        w.launch_all()
        for _ in range(5):
            backend.states[w.groups[0].job_id] = ["DEAD"]
            clock["t"] += 1.0
            w.poll_once()
            clock["t"] += 1.0
            w.poll_once()
        assert w.groups[0].relaunches == 2  # budget respected


def test_watch_against_fake_sbatch(tmp_path) -> None:
    """End-to-end through the real SlurmCli against fake sbatch/squeue
    binaries: submit parses --parsable output, a job missing from squeue
    reads as DEAD and is resubmitted."""
    from torchft_tpu_torch.scheduler import SlurmCli, Watcher

    bindir = tmp_path / "bin"
    bindir.mkdir()
    count_file = tmp_path / "count"
    count_file.write_text("0")
    sbatch = bindir / "sbatch"
    sbatch.write_text(
        "#!/bin/bash\n"
        f'n=$(cat {count_file}); n=$((n+1)); echo $n > {count_file}\n'
        'echo "$n;cluster"\n'
    )
    squeue = bindir / "squeue"
    # job 1 is never in the queue (immediate death); later jobs run forever
    squeue.write_text(
        "#!/bin/bash\n"
        'while [ "$1" != "-j" ]; do shift; done\n'
        'if [ "$2" = "1" ]; then exit 0; fi\n'
        'echo RUNNING\n'
    )
    sbatch.chmod(0o755)
    squeue.chmod(0o755)

    import os

    script = tmp_path / "rg0.sbatch"
    script.write_text("#!/bin/bash\ntrue\n")
    old_path = os.environ["PATH"]
    os.environ["PATH"] = f"{bindir}:{old_path}"
    try:
        w = Watcher(
            [str(script)],
            SlurmCli(),
            initial_backoff_s=0.0,
            sleep=lambda s: None,
        )
        w.launch_all()
        assert w.groups[0].job_id == "1"
        w.poll_once()  # detects DEAD (job 1 absent from squeue)
        w.poll_once()  # relaunches
        assert w.groups[0].job_id == "2"
        assert w.groups[0].relaunches == 1
        assert w.poll_once() == 0  # job 2 reads RUNNING: stable
    finally:
        os.environ["PATH"] = old_path


class _FlakyBackend(_FakeBackend):
    """First N submits raise (scheduler control plane down)."""

    def __init__(self, fail_first: int):
        super().__init__()
        self.fail_first = fail_first

    def submit(self, path: str) -> str:
        if self.fail_first > 0:
            self.fail_first -= 1
            raise RuntimeError("slurmctld unreachable")
        return super().submit(path)


class TestWatcherRobustness:
    def test_submit_failure_does_not_kill_watch(self) -> None:
        from torchft_tpu_torch.scheduler import Watcher

        backend = _FlakyBackend(fail_first=1)
        clock = {"t": 0.0}
        w = Watcher(
            ["a.sbatch", "b.sbatch"],
            backend,
            initial_backoff_s=5.0,
            clock=lambda: clock["t"],
            sleep=lambda s: None,
        )
        w.launch_all()  # group 0's submit raises; must not propagate
        assert w.groups[0].job_id is None
        assert w.groups[1].job_id is not None
        clock["t"] = 5.0
        w.poll_once()  # retried after backoff
        assert w.groups[0].job_id is not None

    def test_backoff_resets_after_healthy_run(self) -> None:
        from torchft_tpu_torch.scheduler import Watcher

        backend = _FakeBackend()
        clock = {"t": 0.0}
        w = Watcher(
            ["a.sbatch"],
            backend,
            initial_backoff_s=5.0,
            healthy_reset_s=100.0,
            clock=lambda: clock["t"],
            sleep=lambda s: None,
        )
        w.launch_all()
        backend.states[w.groups[0].job_id] = ["DEAD"]
        w.poll_once()
        clock["t"] = 5.0
        w.poll_once()  # relaunch; backoff_s == 5
        assert w.groups[0].backoff_s == 5.0
        # first RUNNING observation starts the healthy clock...
        clock["t"] = 10.0
        w.poll_once()
        assert w.groups[0].backoff_s == 5.0
        # ...and an incarnation RUNNING well past healthy_reset_s is forgiven
        clock["t"] = 200.0
        w.poll_once()
        assert w.groups[0].backoff_s == 0.0
        # next death starts from the initial backoff again, not 10s
        backend.states[w.groups[0].job_id] = ["DEAD"]
        w.poll_once()
        assert w.groups[0].backoff_s == 5.0

    def test_pending_time_never_forgives_backoff(self) -> None:
        """A job stuck PENDING in the queue past healthy_reset_s never ran,
        so it must not clear its crash-loop backoff."""
        from torchft_tpu_torch.scheduler import Watcher

        backend = _FakeBackend()
        clock = {"t": 0.0}
        w = Watcher(
            ["a.sbatch"],
            backend,
            initial_backoff_s=5.0,
            healthy_reset_s=100.0,
            clock=lambda: clock["t"],
            sleep=lambda s: None,
        )
        w.launch_all()
        backend.states[w.groups[0].job_id] = ["DEAD"]
        w.poll_once()
        clock["t"] = 5.0
        w.poll_once()  # relaunch; backoff_s == 5
        backend.states[w.groups[0].job_id] = ["PENDING"]
        clock["t"] = 400.0
        w.poll_once()
        assert w.groups[0].backoff_s == 5.0

    def test_run_exits_when_all_groups_give_up(self) -> None:
        from torchft_tpu_torch.scheduler import Watcher

        backend = _FakeBackend()
        clock = {"t": 0.0}

        def tick(s):
            clock["t"] += s

        w = Watcher(
            ["a.sbatch"],
            backend,
            initial_backoff_s=0.0,
            max_relaunches=1,
            clock=lambda: clock["t"],
            sleep=tick,
        )
        # every incarnation dies immediately: launch + 1 relaunch, then
        # give up — run() must return (not hang) with the give-up count
        backend.states["job1"] = ["DEAD"]
        backend.states["job2"] = ["DEAD"]
        assert w.run() == 1
        assert w.groups[0].gave_up
