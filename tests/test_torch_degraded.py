"""The port's degraded mode (``torchft_tpu_torch/parallel/degraded.py`` and
the Manager's relower fence and capacity weights) held against the JAX
package's (``tests/test_degraded.py`` is the twin): the same surviving
layouts and plans, startup chaos hiding ranks, the C++ sidecar refusing a
degraded capacity, and the capacity-weighted average equal to the JAX
package's on the Python tier (rtol 1e-6, as there)."""

import shutil
from typing import List, Optional

import numpy as np
import pytest

import tests.test_manager as jtm
from torchft_tpu.parallel import degraded as jdeg
from torchft_tpu_torch import tier
from torchft_tpu_torch.communicator import DummyCommunicator
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel import degraded as tdeg
from torchft_tpu_torch.wire import ManagerQuorumResult


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 8, 12])
@pytest.mark.parametrize("axes", [tdeg.RELOWER_AXES, ("fsdp", "tp"), ("tp", "fsdp", "pp")])
def test_surviving_layouts_equal_jax(n, axes) -> None:
    assert tdeg.surviving_layouts(n, axes) == jdeg.surviving_layouts(n, axes)
    assert tdeg._factorizations(n, axes) == jdeg._factorizations(n, axes)


@pytest.mark.parametrize("n,orig", [(1, 1), (1, 4), (3, 4), (4, 4), (5, 8), (6, 8), (7, 16)])
def test_structural_plan_equals_jax(n, orig) -> None:
    t, j = tdeg.plan_surviving(n, orig), jdeg.plan_surviving(n, orig)
    assert (t.mesh_axes, t.devices_used, t.original_devices) == (
        j.mesh_axes, j.devices_used, j.original_devices)
    assert t.capacity == j.capacity


def test_plan_rejects_what_jax_rejects() -> None:
    for n, orig in ((0, 4), (5, 4)):
        with pytest.raises(ValueError):
            jdeg.plan_surviving(n, orig)
        with pytest.raises(ValueError):
            tdeg.plan_surviving(n, orig)


def test_model_backed_plan_equals_jax() -> None:
    """JAX's ``test_model_backed_plan_rehearses_divisibility`` on the same
    inputs: llama_debug, SGD(0.1), batch 4, sequence 32, 3 of 4 ranks over
    (fsdp, tp); both skip the 3-way layouts and land on fsdp = 2."""
    import optax
    import torch

    from torchft_tpu.models.llama import Llama as JaxLlama, llama_debug as jax_debug
    from torchft_tpu_torch.models.llama import Llama, llama_debug

    j = jdeg.plan_surviving(3, original_devices=4, model=JaxLlama(jax_debug()), tx=optax.sgd(0.1),
                            batch=4, seq=32, axes=("fsdp", "tp"), lower=False)
    t = tdeg.plan_surviving(3, original_devices=4, model=Llama(llama_debug(), "meta"),
                            optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1), batch=4, seq=32,
                            axes=("fsdp", "tp"), lower=False)
    assert (t.mesh_axes, t.devices_used, t.capacity) == (j.mesh_axes, j.devices_used, j.capacity)
    assert t.mesh_axes == {"fsdp": 2, "tp": 1}
    assert t.report is not None and t.report.ok and j.report.ok


def _no_clean_layout(case: str):
    """(port plan, JAX plan or None) for a case where no layout rehearses
    clean."""
    import optax

    from torchft_tpu.models.llama import Llama as JaxLlama, llama3_8b as jax_8b
    from torchft_tpu_torch.models.llama import Llama, llama3_8b, llama_debug
    from torchft_tpu_torch.parallel.pipeline import PipelinedLlama

    if case == "overflow":  # 8B, no remat, at sequence 8192 on two cards: too big at any layout
        kw = dict(batch=8, seq=8192, axes=("fsdp", "tp"))
        return (lambda: tdeg.plan_surviving(2, 4, model=Llama(llama3_8b(), "meta"), **kw),
                lambda: jdeg.plan_surviving(2, 4, model=JaxLlama(jax_8b()), tx=optax.adamw(1e-3),
                                            **kw))
    # the port's layout: every rank's rows (4, 2 or 1) must split into the
    # pipeline's 3 microbatches
    model = PipelinedLlama(llama_debug(), "meta", pp=2, num_microbatches=3)
    return lambda: tdeg.plan_surviving(4, 4, model=model, batch=4, seq=32, axes=("fsdp", "pp")), None


@pytest.mark.parametrize("case", ["overflow", "microbatches"])
def test_model_backed_plan_raises_when_no_layout_rehearses_clean(case) -> None:
    port, jax_plan = _no_clean_layout(case)
    with pytest.raises(RuntimeError, match="no surviving-device layout rehearses clean"):
        port()
    if jax_plan is not None:
        with pytest.raises(RuntimeError, match="no surviving-device layout rehearses clean"):
            jax_plan()


def test_startup_chaos_hides_ranks(monkeypatch) -> None:
    ranks = [0, 1, 2, 3]
    monkeypatch.delenv("TORCHFT_CHAOS_DEVICE_LOSS", raising=False)
    assert tdeg.startup_surviving_devices(ranks) == ranks
    for lost, want in (("1", [0, 1, 2]), ("3", [0]), ("99", [0]), ("-2", ranks)):
        monkeypatch.setenv("TORCHFT_CHAOS_DEVICE_LOSS", lost)
        assert tdeg.startup_surviving_devices(ranks) == want
        assert jdeg.startup_surviving_devices(ranks) == want
        assert tdeg.chaos_device_loss() == jdeg.chaos_device_loss()


# ---------------------------------------------------------------------------
# the Manager: relower fence, C++ refusal, capacity weights
# ---------------------------------------------------------------------------


class StubClient:
    def __init__(self) -> None:
        self.quorum_results: List[ManagerQuorumResult] = []
        self.commit_calls: List[dict] = []

    def _quorum(self, **kwargs) -> ManagerQuorumResult:
        return self.quorum_results.pop(0)

    def should_commit(self, group_rank, step, should_commit, timeout) -> bool:
        self.commit_calls.append(dict(step=step, should_commit=should_commit))
        return should_commit

    def _checkpoint_metadata(self, rank, timeout) -> str:
        return "stub"

    def close(self) -> None:
        pass


def _quorum(n: int = 3, caps: Optional[List[float]] = None) -> ManagerQuorumResult:
    return ManagerQuorumResult(
        quorum_id=1, replica_rank=0, replica_world_size=n, store_address="127.0.0.1:0",
        max_step=0, max_replica_rank=0, max_world_size=n,
        replica_ids=[f"rep_{i}" for i in range(n)], participant_capacities=caps or [],
    )


def _manager(client: StubClient) -> Manager:
    from tests.test_torch_local_sgd import MemoryTransport

    return Manager(
        comm=DummyCommunicator(), load_state_dict=lambda s: None, state_dict=lambda: {},
        min_replica_size=1, checkpoint_transport=MemoryTransport(), _manager_client=client,
        rank=0, world_size=1,
    )


def test_begin_relower_votes_false_until_complete() -> None:
    client = StubClient()
    client.quorum_results += [_quorum(), _quorum()]
    manager = _manager(client)
    manager.start_quorum()
    manager.wait_quorum()
    manager.begin_relower()
    assert manager.should_commit() is False
    assert client.commit_calls[-1]["should_commit"] is False
    manager.complete_relower(0.5)
    assert manager.capacity == 0.5
    manager.start_quorum()
    manager.wait_quorum()
    assert manager.should_commit() is True
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            manager.complete_relower(bad)


@pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent")
def test_complete_relower_refuses_on_the_cpp_sidecar() -> None:
    lh = tier.make_lighthouse(bind="127.0.0.1:0", min_replicas=1, tier="cpp")
    manager = None
    try:
        manager = Manager(
            comm=DummyCommunicator(), min_replica_size=1, replica_id="degraded_cpp",
            lighthouse_addr=lh.local_address(), timeout=10.0, use_async_quorum=False,
            server_cls=tier.manager_server_cls("cpp"),
        )
        assert type(manager._manager_server).__name__ == "CppManagerServer"
        with pytest.raises(RuntimeError, match="requires the Python control plane"):
            manager.complete_relower(0.5)
        manager.complete_relower(1.0)  # full width needs no capacity plumbing
        assert manager.capacity == 1.0
    finally:
        if manager is not None:
            manager.shutdown()
        lh.shutdown()


@pytest.mark.parametrize("caps,n,engaged", [
    ([0.75, 1.0, 1.0], 3, True),  # tests/test_degraded.py:448-457
    ([0.5, 0.25, 1.0], 3, True),
    ([1.0, 1.0, 1.0], 3, False),  # an unwounded fleet keeps the plain average
    ([0.75, 1.0, 1.0], 2, False),  # healers shrink participation: weights off
])
def test_capacity_weighted_average_equals_jax(caps, n, engaged) -> None:
    client, jclient = StubClient(), jtm.StubClient()
    q = _quorum(3, caps)
    q.max_world_size = n
    jq = jtm._quorum_result(replica_world_size=3, max_world_size=n)
    jq.replica_ids = list(q.replica_ids)
    jq.participant_capacities = list(caps)
    client.quorum_results.append(q)
    jclient.quorum_results.append(jq)
    manager, jmanager = _manager(client), jtm._make_manager(jclient)
    x = np.linspace(-2.0, 3.0, 40, dtype=np.float32)
    outs = []
    for m in (manager, jmanager):
        m.start_quorum()
        m.wait_quorum()
        assert m._capacity_weights_engaged() is engaged
        outs.append(m.allreduce(x.copy()).wait())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6)
    if engaged:
        np.testing.assert_allclose(outs[0], x * (caps[0] / sum(caps) * 3) / 3, rtol=1e-6)
    manager.shutdown()
    jmanager.shutdown()
