"""The port's ``chaos.py`` (``torchft_tpu_torch/chaos.py``), a copy of the
JAX package's with the imports rewritten: the ChaosController cases of
``tests/test_chaos_api.py`` against scripted fake handles (``ProcessReplica``
with a stub supervisor: the port has no launcher yet), the failure classes
and default fault programs held equal to the JAX package's, and the
thread-plane wedge and comm-abort cases of ``tests/test_chaos.py`` end to
end on the port's planes: two replica threads train one 32-element f32
parameter with ``torch.optim.SGD(lr=0.05)`` (the JAX test's
``optax.sgd(0.05)``) and must end with bit-identical parameters.
"""

import random
import threading
import time
from typing import Dict, List, Optional

import pytest
import torch

from torchft_tpu import chaos as jchaos
from torchft_tpu_torch.chaos import (
    ChaosController,
    Failure,
    ProcessReplica,
    ReplicaHandle,
    ThreadReplica,
    _GRAY_DEFAULT_SPECS,
)
from torchft_tpu_torch.communicator import TCPCommunicator
from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.lighthouse import LighthouseServer
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import OptimizerWrapper


def test_failure_classes_and_default_fault_programs_match_the_jax_package():
    assert [(f.name, f.value) for f in Failure] == [(f.name, f.value) for f in jchaos.Failure]
    assert {f.value: spec for f, spec in _GRAY_DEFAULT_SPECS.items()} == {
        f.value: spec for f, spec in jchaos._GRAY_DEFAULT_SPECS.items()
    }


class _FakeHandle(ReplicaHandle):
    def __init__(self, name, supported):
        self.name = name
        self._supported = supported
        self.injected = []
        self._progress = 0

    def supports(self, failure):
        return failure in self._supported

    def inject(self, failure, **kw):
        self.injected.append((failure, kw))

    def progress(self):
        return self._progress


def test_inject_explicit_victim_and_log():
    h = _FakeHandle("a", {Failure.KILL})
    c = ChaosController([h])
    out = c.inject(Failure.KILL, victim=h)
    assert out is h
    assert h.injected == [(Failure.KILL, {})]
    assert c.events[0].failure is Failure.KILL
    assert c.events[0].victim == "a"


def test_random_victim_restricted_to_supporting_handles():
    kill_only = _FakeHandle("k", {Failure.KILL})
    seg_only = _FakeHandle("s", {Failure.SEGFAULT})
    c = ChaosController([kill_only, seg_only], rng=random.Random(0))
    for _ in range(5):
        assert c.inject(Failure.SEGFAULT) is seg_only
    assert not kill_only.injected


def test_inject_unsupported_raises():
    c = ChaosController([_FakeHandle("a", {Failure.KILL})])
    with pytest.raises(ValueError, match="no replica supports"):
        c.inject(Failure.COMM_ABORT)


def test_lighthouse_failure_uses_callback():
    calls = []
    c = ChaosController([], lighthouse_restart=lambda: calls.append(1))
    assert c.inject(Failure.LIGHTHOUSE) is None
    assert calls == [1]
    c2 = ChaosController([])
    with pytest.raises(ValueError, match="lighthouse_restart"):
        c2.inject(Failure.LIGHTHOUSE)


def test_await_heal_observes_progress():
    h = _FakeHandle("a", {Failure.KILL})
    h._progress = 7
    c = ChaosController([h])

    def bump():
        time.sleep(0.2)
        h._progress = 8

    threading.Thread(target=bump, daemon=True).start()
    assert c.await_heal(h, timeout_s=5.0)
    assert not c.await_progress(h, beyond=8, timeout_s=0.3)


def test_poisson_loop_counts_and_stops():
    h = _FakeHandle("a", {Failure.KILL, Failure.COMM_ABORT})
    c = ChaosController([h], rng=random.Random(1))
    stop = threading.Event()
    seen = []
    result = {}

    def run():
        result["counts"] = c.run_poisson(
            [Failure.KILL, Failure.COMM_ABORT],
            mtbf_s=0.02,
            stop=stop,
            on_inject=seen.append,
        )

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.5)
    stop.set()
    t.join(timeout=5.0)
    assert not t.is_alive()
    counts = result["counts"]
    assert sum(counts.values()) >= 3
    assert len(seen) == sum(counts.values()) == len(c.events)


def test_thread_replica_adapter_arms_hooks():
    class Obj:
        def __init__(self):
            self.kill_flag = threading.Event()
            self.wedge_flag = threading.Event()
            self.wedge_secs = 0.0
            self.comm = None
            self.commits = 3

    obj = Obj()
    tr = ThreadReplica("t", obj)
    tr.inject(Failure.KILL)
    assert obj.kill_flag.is_set()
    tr.inject(Failure.DEADLOCK, secs=4.5)
    assert obj.wedge_flag.is_set() and obj.wedge_secs == 4.5
    with pytest.raises(RuntimeError, match="no live communicator"):
        tr.inject(Failure.COMM_ABORT)
    assert tr.progress() == 3
    with pytest.raises(ValueError):
        tr.inject(Failure.SEGFAULT)


def test_process_replica_adapter_signals():
    import signal

    class FakeSupervisor:
        def __init__(self):
            self.kills = []

        def kill(self, gid, sig):
            self.kills.append((gid, sig))
            return True

    sup = FakeSupervisor()
    pr = ProcessReplica("p", sup, replica_group_id=2, progress_fn=lambda: 9)
    pr.inject(Failure.KILL)
    pr.inject(Failure.SEGFAULT)
    pr.inject(Failure.DEADLOCK, secs=0.05)
    time.sleep(0.3)  # the thaw timer must fire
    assert (2, signal.SIGKILL) in sup.kills
    assert (2, signal.SIGSEGV) in sup.kills
    assert (2, signal.SIGSTOP) in sup.kills
    assert (2, signal.SIGCONT) in sup.kills
    assert pr.progress() == 9

    class DeadSupervisor(FakeSupervisor):
        def kill(self, gid, sig):
            return False

    dead = ProcessReplica("d", DeadSupervisor(), 0)
    with pytest.raises(RuntimeError, match="no live process"):
        dead.inject(Failure.KILL)


class _ChaosReplica:
    """Thread replica with the cooperative hook shape ``ThreadReplica``
    adapts (kill/wedge flags + live ``comm``), as ``tests/test_chaos.py``'s,
    training a torch parameter."""

    def __init__(self, idx: int, lighthouse_addr: str, steps: int, timeout_s: float,
                 step_time_s: float = 0.0):
        self.idx = idx
        self.steps = steps
        self.timeout_s = timeout_s
        self.step_time_s = step_time_s
        self.lighthouse_addr = lighthouse_addr
        self.wedge_secs = 0.0
        self.kill_flag = threading.Event()
        self.wedge_flag = threading.Event()
        self.comm = None
        self.failed_steps = 0
        self.progress = 0  # latest committed step, for outside observers
        self.final: Optional[torch.Tensor] = None
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 — surfaced by the test
            self.error = e

    def _run(self) -> None:
        w = torch.nn.Parameter(torch.ones(32, dtype=torch.float32))
        sgd = torch.optim.SGD([w], lr=0.05)

        def load(state: Dict) -> None:
            with torch.no_grad():
                w.copy_(torch.as_tensor(state["w"]))
            sgd.load_state_dict(state["opt"])

        comm = TCPCommunicator(timeout_s=self.timeout_s)
        self.comm = comm
        manager = Manager(
            comm=comm,
            load_state_dict=load,
            state_dict=lambda: {"w": w.detach().clone(), "opt": sgd.state_dict()},
            min_replica_size=1,
            replica_id=f"chaos_{self.idx}",
            lighthouse_addr=self.lighthouse_addr,
            timeout=30.0,
            quorum_timeout=30.0,
        )
        opt = OptimizerWrapper(manager, sgd)
        try:
            while manager.current_step() < self.steps:
                if self.step_time_s:
                    # paced so an outside controller's inject/await window
                    # can't be outrun by a sprinting replica
                    time.sleep(self.step_time_s)
                opt.start_step()
                if self.wedge_flag.is_set():
                    self.wedge_flag.clear()
                    time.sleep(self.wedge_secs)
                w.grad = torch.full_like(w, 0.01 * (self.idx + 1))
                allreduce_gradients(manager, [w])
                if not opt.step():
                    self.failed_steps += 1
                self.progress = manager.current_step()
            self.final = w.detach().clone()
        finally:
            manager.shutdown()


@pytest.fixture()
def lighthouse():
    server = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=1,
        join_timeout_ms=200,
        quorum_tick_ms=20,
        heartbeat_timeout_ms=1500,
    )
    yield server
    server.shutdown()


def _join(replicas: List[_ChaosReplica], threads: List[threading.Thread]) -> None:
    end = time.monotonic() + 120
    for t in threads:
        t.join(timeout=max(1.0, end - time.monotonic()))
    for r in replicas:
        assert r.error is None, f"replica {r.idx} died: {r.error!r}"
        assert r.final is not None


def test_wedged_replica_evicted_then_rejoins(lighthouse) -> None:
    """Wedge > op-timeout, scripted through the ChaosController: the healthy
    peer's collective aborts, the next quorum proceeds without the wedged
    member (which still heartbeats), and ``await_heal`` observes it rejoin
    and commit again."""
    addr = lighthouse.local_address()
    r0 = _ChaosReplica(0, addr, steps=25, timeout_s=2.0, step_time_s=0.1)
    r1 = _ChaosReplica(1, addr, steps=25, timeout_s=2.0, step_time_s=0.1)
    victim = ThreadReplica("r1", r1)
    controller = ChaosController([ThreadReplica("r0", r0), victim])
    threads = [threading.Thread(target=r.run, daemon=True) for r in (r0, r1)]
    for t in threads:
        t.start()
    # let the fleet make real progress, then wedge r1 for 4x the op timeout
    assert controller.await_progress(victim, beyond=4, timeout_s=60.0)
    controller.inject(Failure.DEADLOCK, victim=victim, secs=8.0)
    assert controller.await_heal(victim, timeout_s=90.0)
    _join([r0, r1], threads)
    # the healthy peer had to abort at least one collective on the wedge
    assert r0.failed_steps >= 1
    assert torch.equal(r0.final, r1.final)
    assert [e.failure for e in controller.events] == [Failure.DEADLOCK]


def test_comm_abort_recovers_without_restart(lighthouse) -> None:
    addr = lighthouse.local_address()
    r0 = _ChaosReplica(0, addr, steps=20, timeout_s=5.0, step_time_s=0.1)
    r1 = _ChaosReplica(1, addr, steps=20, timeout_s=5.0, step_time_s=0.1)
    victim = ThreadReplica("r1", r1)
    controller = ChaosController([ThreadReplica("r0", r0), victim])
    threads = [threading.Thread(target=r.run, daemon=True) for r in (r0, r1)]
    for t in threads:
        t.start()
    assert controller.await_progress(victim, beyond=3, timeout_s=60.0)
    controller.inject(Failure.COMM_ABORT, victim=victim)
    # healed = commits again after the abort, with NO process restart
    assert controller.await_heal(victim, timeout_s=90.0)
    _join([r0, r1], threads)
    assert r1.failed_steps >= 1  # the aborted step must not commit
    assert torch.equal(r0.final, r1.final)
