"""The port's process supervisor (``torchft_tpu_torch.launcher``), punisher
and warm standby: ``tests/test_aux.py``'s launcher and punisher cases on
the port's copies, the supervisor's promotion of a parked standby,
``chaos.ProcessReplica`` over the real supervisor (a SIGKILL promotes the
standby, a SIGSEGV restarts cold), and ``train_ddp --device cpu`` under
``TPUFT_STANDBY_GATE``: it parks without a quorum request and trains once
the gate opens.
"""

import json
import os
import random
import signal
import subprocess
import sys
import threading
import time

from torchft_tpu_torch import chaos, punisher
from torchft_tpu_torch.launcher import STANDBY_GATE_ENV, ReplicaSpec, ReplicaSupervisor
from torchft_tpu_torch.lighthouse import LighthouseClient, LighthouseServer
from torchft_tpu_torch.manager_server import ManagerClient, ManagerServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _wait(pred, timeout_s: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


# a standby-aware worker: parks until its gate file appears, records each
# incarnation's role in ``log`` and exits 0 (or dies when ``die`` exists)
_WORKER = (
    "import os, sys, time, pathlib\n"
    "log = pathlib.Path(sys.argv[1])\n"
    "gate = os.environ.get('TPUFT_STANDBY_GATE')\n"
    "if gate:\n"
    "    with log.open('a') as f: f.write(f'parked {os.getpid()}\\n')\n"
    "    while not os.path.exists(gate): time.sleep(0.02)\n"
    "    with log.open('a') as f: f.write(f'promoted {os.getpid()}\\n')\n"
    "else:\n"
    "    with log.open('a') as f: f.write(f'cold {os.getpid()}\\n')\n"
    "while not pathlib.Path(sys.argv[2]).exists(): time.sleep(0.02)\n"
)


class TestLauncher:
    def test_supervisor_restarts_crashed_replica(self, tmp_path) -> None:
        marker = tmp_path / "count"
        script = (
            "import os, sys, pathlib\n"
            f"p = pathlib.Path({str(marker)!r})\n"
            "n = int(p.read_text()) if p.exists() else 0\n"
            "p.write_text(str(n + 1))\n"
            "sys.exit(1 if n == 0 else 0)\n"  # crash once, then succeed
        )
        spec = ReplicaSpec(replica_group_id=0, cmd=[sys.executable, "-c", script])
        supervisor = ReplicaSupervisor(
            [spec], lighthouse_addr="127.0.0.1:1", max_restarts=3, restart_delay_s=0.1
        )
        assert supervisor.run() == 0
        assert marker.read_text() == "2"

    def test_supervisor_gives_up_after_max_restarts(self) -> None:
        spec = ReplicaSpec(replica_group_id=0, cmd=[sys.executable, "-c", "import sys; sys.exit(3)"])
        supervisor = ReplicaSupervisor(
            [spec], lighthouse_addr="127.0.0.1:1", max_restarts=1, restart_delay_s=0.05
        )
        assert supervisor.run() == 3

    def test_standby_retired_when_group_leaves_fleet(self) -> None:
        script = (
            "import os, sys, time\n"
            "if os.environ.get('TPUFT_STANDBY_GATE'):\n"
            "    time.sleep(600)\n"
            "time.sleep(0.5)\n"
            "sys.exit(0)\n"
        )
        spec = ReplicaSpec(replica_group_id=0, cmd=[sys.executable, "-c", script], standby=True)
        supervisor = ReplicaSupervisor([spec], lighthouse_addr="127.0.0.1:1", restart_delay_s=0.05)
        runner = threading.Thread(target=supervisor.run, daemon=True)
        runner.start()
        assert _wait(lambda: 0 in supervisor._standbys, 5.0)
        spare = supervisor._standbys[0][0]
        assert spare.poll() is None
        runner.join(timeout=30.0)
        assert not runner.is_alive()  # clean exit ended supervision
        assert not supervisor._standbys
        assert spare.wait(timeout=10.0) is not None  # spare terminated

    def test_env_contract(self, tmp_path) -> None:
        out = tmp_path / "env.json"
        script = (
            "import os, json, sys\n"
            f"json.dump({{k: os.environ.get(k) for k in "
            f"['TORCHFT_LIGHTHOUSE','REPLICA_GROUP_ID','NUM_REPLICA_GROUPS']}}, "
            f"open({str(out)!r}, 'w'))\n"
        )
        spec = ReplicaSpec(replica_group_id=1, cmd=[sys.executable, "-c", script])
        supervisor = ReplicaSupervisor(
            [spec, ReplicaSpec(2, [sys.executable, "-c", "pass"])], lighthouse_addr="lh:123"
        )
        supervisor.run()
        env = json.loads(out.read_text())
        assert env == {"TORCHFT_LIGHTHOUSE": "lh:123", "REPLICA_GROUP_ID": "1",
                       "NUM_REPLICA_GROUPS": "2"}

    def test_cli_runs_the_fleet_with_its_own_lighthouse(self, tmp_path) -> None:
        out = tmp_path / "rg"
        script = ("import os, pathlib\n"
                  f"pathlib.Path({str(out)!r} + os.environ['REPLICA_GROUP_ID']).write_text("
                  "os.environ['TORCHFT_LIGHTHOUSE'])\n")
        proc = subprocess.run(
            [sys.executable, "-m", "torchft_tpu_torch.launcher", "--replicas", "2", "--",
             sys.executable, "-c", script],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
            timeout=120,
        )
        assert proc.returncode == 0, proc.stderr
        addrs = {(tmp_path / f"rg{g}").read_text() for g in (0, 1)}
        assert len(addrs) == 1 and addrs.pop().startswith("127.0.0.1:")


class TestStandbyPromotion:
    def _fleet(self, tmp_path):
        log, done = tmp_path / "roles.log", tmp_path / "done"
        spec = ReplicaSpec(replica_group_id=0, cmd=[sys.executable, "-c", _WORKER, str(log),
                                                    str(done)], standby=True)
        supervisor = ReplicaSupervisor([spec], lighthouse_addr="127.0.0.1:1", restart_delay_s=0.05)
        runner = threading.Thread(target=supervisor.run, daemon=True)
        runner.start()
        assert _wait(lambda: log.exists() and "parked" in log.read_text()
                     and "cold" in log.read_text())
        return supervisor, runner, log, done

    def _roles(self, log) -> list:
        return [line.split() for line in log.read_text().splitlines()]

    def test_process_replica_kill_promotes_the_parked_standby(self, tmp_path) -> None:
        supervisor, runner, log, done = self._fleet(tmp_path)
        try:
            handle = chaos.ProcessReplica("g0", supervisor, 0)
            assert handle.supports(chaos.Failure.KILL)
            active = supervisor._procs[0]
            parked = supervisor._standbys[0][0]
            handle.inject(chaos.Failure.KILL)
            assert active.wait(timeout=10.0) == -signal.SIGKILL
            # the parked standby is promoted in place of the dead active, and
            # a fresh standby parks behind it
            assert _wait(lambda: ["promoted", str(parked.pid)] in self._roles(log))
            assert supervisor._procs[0] is parked
            assert _wait(lambda: [r[0] for r in self._roles(log)].count("parked") == 2)
            assert [r[0] for r in self._roles(log)].count("cold") == 1
        finally:
            done.touch()
            runner.join(timeout=30.0)
            supervisor.stop()
        assert not runner.is_alive()
        assert all(p.poll() is not None for p in [parked, active])

    def test_process_replica_segfault_without_standby_restarts_cold(self, tmp_path) -> None:
        log, done = tmp_path / "roles.log", tmp_path / "done"
        spec = ReplicaSpec(replica_group_id=0, cmd=[sys.executable, "-c", _WORKER, str(log),
                                                    str(done)])
        supervisor = ReplicaSupervisor([spec], lighthouse_addr="127.0.0.1:1", restart_delay_s=0.05)
        runner = threading.Thread(target=supervisor.run, daemon=True)
        runner.start()
        try:
            assert _wait(lambda: log.exists() and "cold" in log.read_text())
            chaos.ProcessReplica("g0", supervisor, 0).inject(chaos.Failure.SEGFAULT)
            assert _wait(lambda: [r[0] for r in self._roles(log)].count("cold") == 2)
        finally:
            done.touch()
            runner.join(timeout=30.0)
            supervisor.stop()
        assert not runner.is_alive()


class TestPunisher:
    def _victim(self, lighthouse, killed):
        mgr = ManagerServer(
            replica_id="victim",
            lighthouse_addr=lighthouse.local_address(),
            hostname="127.0.0.1",
            bind="127.0.0.1:0",
            store_addr="s",
            world_size=1,
            kill_fn=lambda msg: killed.append(msg),
        )
        client = ManagerClient(f"127.0.0.1:{mgr.port}")
        client._quorum(group_rank=0, step=0, checkpoint_metadata="", shrink_only=False,
                       timeout=10.0)
        client.close()
        return mgr

    def test_kill_one_via_lighthouse(self) -> None:
        """The punisher reads membership from the port's lighthouse and
        delivers a kill RPC to the victim's port manager server."""
        lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=50,
                                      quorum_tick_ms=20)
        killed: list = []
        mgr = self._victim(lighthouse, killed)
        try:
            lh_client = LighthouseClient(lighthouse.local_address(), connect_timeout=5.0)
            assert punisher.kill_one(lh_client, random.Random(0)) == "victim"
            assert _wait(lambda: killed == ["killed by punisher"], 5.0)
            lh_client.close()
        finally:
            mgr.shutdown()
            lighthouse.shutdown()

    def test_cli_kill_all(self) -> None:
        lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=50,
                                      quorum_tick_ms=20)
        killed: list = []
        mgr = self._victim(lighthouse, killed)
        try:
            punisher.main(["--lighthouse", lighthouse.local_address(), "kill-all"])
            assert _wait(lambda: killed == ["killed by punisher"], 5.0)
        finally:
            mgr.shutdown()
            lighthouse.shutdown()

    def test_kill_one_with_no_members(self) -> None:
        lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1)
        try:
            client = LighthouseClient(lighthouse.local_address(), connect_timeout=5.0)
            assert punisher.kill_one(client, random.Random(0)) is None
            client.close()
        finally:
            lighthouse.shutdown()


def test_train_ddp_standby_parks_without_a_quorum_then_trains(tmp_path) -> None:
    """Under ``TPUFT_STANDBY_GATE`` the worker warms up and parks: no
    heartbeat and no quorum request reaches the lighthouse until the gate
    file appears; then it builds its Manager, trains to the end and reports
    its park in the FINAL line."""
    lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=50,
                                  quorum_tick_ms=20)
    gate = tmp_path / "gate"
    env = dict(os.environ, PYTHONPATH=ROOT, TORCHFT_LIGHTHOUSE=lighthouse.local_address(),
               REPLICA_GROUP_ID="0", TORCHFT_TIER="python")
    env[STANDBY_GATE_ENV] = str(gate)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.train_ddp", "--model", "llama_debug",
         "--device", "cpu", "--seq-len", "64", "--batch-size", "2", "--steps", "2"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        assert _wait(lambda: any(line.startswith("STANDBY ") for line in lines), 120.0), lines
        time.sleep(1.0)  # a parked worker stays silent toward the lighthouse
        with lighthouse._lock:
            assert not lighthouse._state.heartbeats
            assert not lighthouse._state.participants
        assert proc.poll() is None
        gate.touch()
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        lighthouse.shutdown()
    reader.join(timeout=10)
    final = next(line for line in lines if line.startswith("FINAL "))
    assert "step=2" in final and "standby_park_s=" in final and "promoted_t=" in final
    assert any(line.startswith("FIRST_COMMIT ") for line in lines)
