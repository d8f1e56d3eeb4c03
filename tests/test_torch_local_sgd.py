"""The port's LocalSGD / DiLoCo (``torchft_tpu_torch/local_sgd.py``) held
against the JAX package's (``tests/test_local_sgd.py`` is the twin).

- Unit tests against a stub control plane: partition, LocalSGD cadence and
  a failed commit, DiLoCo's validations, the outer step's math, the reset to
  the backup, alpha mixing, staggered fragments and the delay overlap.
- The golden trajectory ``tests/fixtures/diloco_regression.json`` at the
  JAX test's tolerance (rtol 1e-4, atol 1e-6).
- ``OuterSGD`` against ``optax.sgd`` and ``torch.optim.SGD`` (rtol 1e-6:
  XLA may contract ``g + m·t`` to an FMA).
- Side by side: the same small parameter sets (f32 and bf16, alpha 0 and
  0.25, float and int8) through the JAX package's ``DiLoCo`` and the
  port's, each on a one-replica stub quorum.  The pseudogradient the
  sharded sync receives and its shard layout are bit-identical; the final
  parameters agree within rtol 1e-6, plus one int8 step of the delta's row
  on the quantized wire (the optax update may differ from numpy's by an
  ulp, which can move a rounding boundary of the delta's requantize).
- Threads as replicas over TCP: two replicas with different inner progress
  end bit-identical, float and int8.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import torchft_tpu.quantization as jq
from torchft_tpu import collectives as jcoll
from torchft_tpu import local_sgd as jlocal
from torchft_tpu import manager as jmanager
from torchft_tpu.communicator import DummyCommunicator as JaxDummyCommunicator
from torchft_tpu.models import llama as jllama
from torchft_tpu_torch import local_sgd as tlocal
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.communicator import DummyCommunicator, TCPCommunicator
from torchft_tpu_torch.lighthouse import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD, partition_parameters
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import llama as tllama
from torchft_tpu_torch.optim import OuterSGD
from torchft_tpu_torch.wire import ManagerQuorumResult

from tests.test_manager import MemoryTransport as JaxMemoryTransport
from tests.test_manager import StubClient as JaxStubClient
from tests.test_manager import _quorum_result as jax_quorum_result

FIXTURE_PATH = os.path.join(os.path.dirname(__file__), "fixtures", "diloco_regression.json")


# ---------------------------------------------------------------------------
# a stub control plane for the port's Manager (the twin of tests/test_manager.py's)
# ---------------------------------------------------------------------------


class StubClient:
    """Programmable ManagerClient double."""

    def __init__(self) -> None:
        self.quorum_results: List[ManagerQuorumResult] = []
        self.commit_responses: List[bool] = []

    def _quorum(self, **kwargs) -> ManagerQuorumResult:
        return self.quorum_results.pop(0)

    def should_commit(self, group_rank, step, should_commit, timeout) -> bool:
        if self.commit_responses:
            return self.commit_responses.pop(0)
        return should_commit

    def _checkpoint_metadata(self, rank, timeout) -> str:
        return "stub-metadata"

    def close(self) -> None:
        pass


class MemoryTransport(CheckpointTransport):
    """In-memory transport double."""

    def metadata(self) -> str:
        return "memory://"

    def send_checkpoint(self, dst_ranks, step, state_dict, timeout) -> None:
        pass

    def disallow_checkpoint(self) -> None:
        pass

    def recv_checkpoint(self, src_rank, metadata, step, timeout):
        raise AssertionError("no heal in the stub quorum")

    def shutdown(self, wait: bool = True) -> None:
        pass


def quorum_result(replica_world_size: int = 2, max_world_size: int = 2) -> ManagerQuorumResult:
    return ManagerQuorumResult(
        quorum_id=1, replica_rank=0, replica_world_size=replica_world_size,
        store_address="127.0.0.1:0", max_step=0, max_replica_rank=0,
        max_world_size=max_world_size,
        replica_ids=[f"rep_{i}" for i in range(replica_world_size)],
    )


def stub_manager(client: StubClient, use_async_quorum: bool = True) -> Manager:
    return Manager(
        comm=DummyCommunicator(), load_state_dict=None, state_dict=None, min_replica_size=1,
        use_async_quorum=use_async_quorum, checkpoint_transport=MemoryTransport(),
        _manager_client=client, rank=0, world_size=1,
    )


def solo_manager(quorums: int, use_async_quorum: bool = False) -> Manager:
    """A one-replica quorum, ``quorums`` times."""
    client = StubClient()
    client.quorum_results += [quorum_result(1, 1) for _ in range(quorums)]
    return stub_manager(client, use_async_quorum)


def jax_solo_manager(quorums: int) -> jmanager.Manager:
    client = JaxStubClient()
    client.quorum_results += [
        jax_quorum_result(replica_world_size=1, max_world_size=1) for _ in range(quorums)
    ]
    return jmanager.Manager(
        comm=JaxDummyCommunicator(), load_state_dict=None, state_dict=None,
        min_replica_size=1, use_async_quorum=False,
        checkpoint_transport=JaxMemoryTransport(), _manager_client=client, rank=0, world_size=1,
    )


class Params(nn.Module):
    """A module whose parameters are ``arrays``, registered in sorted-name
    order (a JAX dict's leaf order); bf16 arrays (ml_dtypes) become bf16."""

    def __init__(self, arrays: Dict[str, np.ndarray]) -> None:
        super().__init__()
        for name in sorted(arrays):
            self.register_parameter(name, nn.Parameter(to_tensor(arrays[name])))

    def values(self) -> Dict[str, np.ndarray]:
        return {n: p.detach().float().numpy() for n, p in self.named_parameters()}

    def set(self, arrays: Dict[str, np.ndarray]) -> None:
        with torch.no_grad():
            for name, p in self.named_parameters():
                p.copy_(to_tensor(arrays[name]))


def to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    t = torch.from_numpy(a.astype(np.float32))
    return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t.clone()


def flat(values: Dict[str, np.ndarray]) -> np.ndarray:
    return np.concatenate([np.asarray(values[k], np.float32).ravel() for k in sorted(values)])


# ---------------------------------------------------------------------------


class TestPartition:
    def test_partition_covers_all_parameters(self) -> None:
        model = Params({"a": np.ones((10, 10)), "b": np.ones(5), "c": np.ones((3, 3))})
        groups = partition_parameters(model, 2)
        assert sorted(n for g in groups for n in g) == ["a", "b", "c"]
        assert all(groups)

    @pytest.mark.parametrize("n", [1, 2, 3, 4])
    def test_partition_matches_jax(self, n) -> None:
        import ml_dtypes

        arrays = {
            "a": np.ones((10, 10), np.float32), "b": np.ones(5, np.float32),
            "c": np.ones((3, 3), ml_dtypes.bfloat16), "d": np.ones(300, np.float32),
            "e": np.ones((7, 9), ml_dtypes.bfloat16),
        }
        names = sorted(arrays)
        jax_groups = jlocal.partition_leaves({k: jnp.asarray(v) for k, v in arrays.items()}, n)
        assert partition_parameters(Params(arrays), n) == [[names[i] for i in g] for g in jax_groups]

    def test_too_many_fragments_raises(self) -> None:
        with pytest.raises(ValueError):
            partition_parameters(Params({"a": np.ones(3)}), 2)

    def test_fragments_from_jax_name_the_same_parameters(self) -> None:
        cfg = jllama.llama_debug()
        params = jax.tree_util.tree_map(np.asarray, jllama.Llama(cfg).init(jax.random.PRNGKey(0)))
        jax_groups = jlocal.partition_leaves(params, 2)
        names = tlocal.fragments_from_jax(params, jax_groups, cfg.n_layers)
        port = tllama.params_from_jax(params)
        assert sorted(n for g in names for n in g) == sorted(port)
        leaves = jax.tree_util.tree_leaves(params)
        for group, port_names in zip(jax_groups, names):
            assert sum(leaves[i].size for i in group) == sum(port[n].numel() for n in port_names)


class TestLocalSGD:
    def test_sync_cadence_and_averaging(self) -> None:
        client = StubClient()
        client.quorum_results.append(quorum_result(max_world_size=2))
        model = Params({"w": np.full(3, 4.0, np.float32)})
        local_sgd = LocalSGD(stub_manager(client), model, sync_every=3)
        assert local_sgd.step() is None
        assert local_sgd.step() is None
        # Dummy comm passthrough + AVG over 2 participants → halved
        assert local_sgd.step() is True
        np.testing.assert_allclose(model.values()["w"], np.full(3, 2.0))

    def test_failed_commit_keeps_local(self) -> None:
        client = StubClient()
        client.quorum_results.append(quorum_result(max_world_size=2))
        client.commit_responses.append(False)
        model = Params({"w": np.full(3, 4.0, np.float32)})
        local_sgd = LocalSGD(stub_manager(client), model, sync_every=1)
        assert local_sgd.step() is False
        np.testing.assert_allclose(model.values()["w"], np.full(3, 4.0))

    def test_parameters_stay_the_same_objects(self) -> None:
        """The average lands in the live ``Parameter``s, so an inner
        optimizer keeps its state bound to them."""
        client = StubClient()
        client.quorum_results.append(quorum_result(max_world_size=2))
        model = Params({"w": np.full(3, 4.0, np.float32)})
        before = [id(p) for p in model.parameters()]
        LocalSGD(stub_manager(client), model, sync_every=1).step()
        assert [id(p) for p in model.parameters()] == before


class TestDiLoCo:
    def test_requires_sync_quorum(self) -> None:
        manager = stub_manager(StubClient(), use_async_quorum=True)
        with pytest.raises(ValueError, match="synchronous quorum"):
            DiLoCo(manager, Params({"w": np.ones(2)}), OuterSGD(0.5), sync_every=2)

    def test_validations(self) -> None:
        manager = stub_manager(StubClient(), use_async_quorum=False)
        model = Params({"a": np.ones(4), "b": np.ones(4)})
        with pytest.raises(ValueError, match="divisible"):
            DiLoCo(manager, model, OuterSGD(0.5), sync_every=3, num_fragments=2)
        with pytest.raises(ValueError, match="synced before"):
            DiLoCo(manager, model, OuterSGD(0.5), sync_every=4, num_fragments=2,
                   fragment_sync_delay=2)
        with pytest.raises(ValueError, match="alpha"):
            DiLoCo(manager, model, OuterSGD(0.5), sync_every=2, fragment_update_alpha=2.0)
        with pytest.raises(ValueError, match="nesterov"):
            OuterSGD(0.5, nesterov=True)

    def _inner(self, model: Params, by: float) -> None:
        model.set({k: v - by for k, v in model.values().items()})

    def test_outer_step_math(self) -> None:
        """After a sync: params = backup − lr·(backup − local) for a plain
        SGD outer optimizer."""
        model = Params({"w": np.full(4, 10.0, np.float32)})
        diloco = DiLoCo(solo_manager(1), model, OuterSGD(0.5), sync_every=2)
        for _ in range(2):
            self._inner(model, 1.0)
            result = diloco.step()
        assert result is True
        # backup=10, local=8 → pseudograd=2 → global = 10 - 0.5*2 = 9
        np.testing.assert_allclose(model.values()["w"], np.full(4, 9.0))

    def test_failed_commit_resets_to_backup(self) -> None:
        client = StubClient()
        client.quorum_results.append(quorum_result(1, 1))
        client.commit_responses.append(False)
        model = Params({"w": np.full(4, 10.0, np.float32)})
        diloco = DiLoCo(stub_manager(client, False), model, OuterSGD(0.5), sync_every=1)
        self._inner(model, 3.0)
        assert diloco.step() is False
        np.testing.assert_allclose(model.values()["w"], np.full(4, 10.0))

    def test_alpha_mixing(self) -> None:
        model = Params({"w": np.full(2, 10.0, np.float32)})
        diloco = DiLoCo(solo_manager(1), model, OuterSGD(0.5), sync_every=1,
                        fragment_update_alpha=0.5)
        self._inner(model, 2.0)  # local = 8
        assert diloco.step() is True
        # global = 10 - 0.5*2 = 9; mixed = 0.5*9 + 0.5*8 = 8.5
        np.testing.assert_allclose(model.values()["w"], np.full(2, 8.5))

    def test_streaming_fragments_staggered(self) -> None:
        """Two fragments, sync_every=4 → per-fragment interval 2; fragments
        sync alternately, chosen by manager.current_step() % n."""
        model = Params({"a": np.full(4, 10.0, np.float32), "b": np.full(4, 20.0, np.float32)})
        diloco = DiLoCo(solo_manager(4), model, OuterSGD(1.0), sync_every=4, num_fragments=2)
        results = []
        for _ in range(8):
            self._inner(model, 1.0)
            results.append(diloco.step())
        assert [r for r in results if r is not None] == [True] * 4
        assert results[1] is True and results[0] is None
        assert [f.names for f in diloco.fragments] == [["a"], ["b"]]

    def test_fragment_sync_delay_overlaps(self) -> None:
        model = Params({"w": np.full(2, 10.0, np.float32)})
        diloco = DiLoCo(solo_manager(1), model, OuterSGD(0.5), sync_every=3,
                        fragment_sync_delay=1)
        self._inner(model, 1.0)
        assert diloco.step() is None
        self._inner(model, 1.0)
        assert diloco.step() is None  # prepared here (pseudograd = 2)
        self._inner(model, 1.0)  # local drifts more
        assert diloco.step() is True
        # pseudograd was captured at prepare time: global = 10 - 0.5*2 = 9
        np.testing.assert_allclose(model.values()["w"], np.full(2, 9.0))


class TestOuterSGD:
    GRID = [(0.5, 0.0, False), (0.7, 0.9, False), (0.7, 0.9, True), (1.0, 0.5, True)]

    @pytest.mark.parametrize("lr,momentum,nesterov", GRID)
    def test_matches_torch_sgd(self, lr, momentum, nesterov) -> None:
        """Momentum buffer within rtol 1e-6; parameters within rtol 1e-6
        plus one ulp of the largest parameter: torch's ``add_(alpha=-lr)``
        may fuse into one FMA where the port rounds ``-lr·d`` first."""
        rng = np.random.default_rng(3)
        x0 = rng.standard_normal(257).astype(np.float32)
        p = torch.nn.Parameter(torch.from_numpy(x0.copy()))
        ref = torch.optim.SGD([p], lr=lr, momentum=momentum, nesterov=nesterov, dampening=0)
        outer = OuterSGD(lr, momentum, nesterov)
        x, state = x0.copy(), outer.init(x0)
        for _ in range(4):
            g = rng.standard_normal(257).astype(np.float32)
            p.grad = torch.from_numpy(g.copy())
            ref.step()
            updates, state = outer.update(g, state, x)
            x = x + updates
            ulp = float(np.spacing(np.abs(x).max()))
            np.testing.assert_allclose(x, p.detach().numpy(), rtol=1e-6, atol=ulp)
            with torch.no_grad():
                p.copy_(torch.from_numpy(x))  # step on from one point
            if momentum:
                buf = ref.state[p]["momentum_buffer"].numpy()
                np.testing.assert_allclose(state[0], buf, rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("lr,momentum,nesterov", GRID)
    def test_matches_optax_sgd(self, lr, momentum, nesterov) -> None:
        rng = np.random.default_rng(4)
        x = rng.standard_normal(300).astype(np.float32)
        tx = optax.sgd(lr, momentum=momentum or None, nesterov=nesterov)
        outer = OuterSGD(lr, momentum, nesterov)
        jstate, state = tx.init(x), outer.init(x)
        assert len(jax.tree_util.tree_leaves(jstate)) == len(state)
        for _ in range(4):
            g = rng.standard_normal(300).astype(np.float32)
            jup, jstate = tx.update(g, jstate, x)
            up, state = outer.update(g, state, x)
            np.testing.assert_allclose(up, np.asarray(jup), rtol=1e-6, atol=1e-7)
            for a, b in zip(state, jax.tree_util.tree_leaves(jstate)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


def _regression_trajectory() -> List[List[float]]:
    """The JAX package's golden schedule on the port: inner SGD(0.1,
    momentum 0.9) on synthetic gradients, outer Nesterov SGD(0.7, 0.9),
    sync_every=3, alpha 0.25."""
    model = Params({"w1": np.arange(4, dtype=np.float32), "w2": np.full(3, 2.0, np.float32)})
    inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    diloco = DiLoCo(solo_manager(6), model, OuterSGD(0.7, momentum=0.9, nesterov=True),
                    sync_every=3, fragment_update_alpha=0.25)
    history = []
    for step in range(9):
        for p in model.parameters():
            p.grad = 0.05 * (torch.ones_like(p) + 0.1 * step)
        inner.step()
        diloco.step()
        history.append([round(float(v), 6) for v in flat(model.values())])
    return history


def test_trajectory_matches_fixture() -> None:
    with open(FIXTURE_PATH) as f:
        expected = json.load(f)
    np.testing.assert_allclose(
        np.array(_regression_trajectory()), np.array(expected), rtol=1e-4, atol=1e-6
    )


# ---------------------------------------------------------------------------
# side by side with the JAX package's DiLoCo
# ---------------------------------------------------------------------------


@pytest.fixture()
def numpy_jax_wire(monkeypatch):
    """The JAX package's numpy host wire (its C++ quantizer agrees with it
    on the quantize, but the port pins the numpy path, ROADMAP §C1)."""
    monkeypatch.setattr(jq, "_NATIVE", None)
    monkeypatch.setattr(jcoll, "_use_device_reduce", lambda shard_bytes: False)


def _spy(manager, seen: List[np.ndarray]) -> None:
    inner = manager.outer_shard_allreduce

    def spy(flat, update_cb, **kw):
        seen.append(np.array(flat, copy=True))
        return inner(flat, update_cb, **kw)

    manager.outer_shard_allreduce = spy


@pytest.mark.usefixtures("numpy_jax_wire")
@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("alpha", [0.0, 0.25])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_same_schedule_as_jax(dtype, alpha, quant) -> None:
    import ml_dtypes

    np_dtype = np.float32 if dtype == "f32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(11)
    shapes = {"a": (40, 30), "b": (300,), "c": (2, 3, 7)}
    arrays = {k: rng.standard_normal(s).astype(np_dtype) for k, s in shapes.items()}
    steps, sync_every, frags, delay = 8, 4, 2, 1
    inner = [
        {k: (v.astype(np.float32) - 0.02 * (s + 1) * rng.standard_normal(v.shape)).astype(np_dtype)
         for k, v in arrays.items()}
        for s in range(steps)
    ]

    jm = jax_solo_manager(steps)
    holder = {"params": {k: jnp.asarray(v) for k, v in arrays.items()}}
    jd = jlocal.DiLoCo(jm, holder, optax.sgd(0.7, momentum=0.9, nesterov=True),
                       sync_every=sync_every, num_fragments=frags, should_quantize=quant,
                       fragment_sync_delay=delay, fragment_update_alpha=alpha)
    tm = solo_manager(steps)
    model = Params(arrays)
    td = DiLoCo(tm, model, OuterSGD(0.7, momentum=0.9, nesterov=True), sync_every=sync_every,
                num_fragments=frags, should_quantize=quant, fragment_sync_delay=delay,
                fragment_update_alpha=alpha)
    jseen: List[np.ndarray] = []
    tseen: List[np.ndarray] = []
    _spy(jm, jseen)
    _spy(tm, tseen)
    jres, tres = [], []
    for s in range(steps):
        holder["params"] = {k: jnp.asarray(v) for k, v in inner[s].items()}
        model.set(inner[s])
        jres.append(jd.step())
        tres.append(td.step())
    assert tres == jres and tres.count(True) == steps // (sync_every // frags)
    # the pseudogradients on the wire, bit for bit, and their layout
    assert len(tseen) == len(jseen) == 4
    for a, b in zip(tseen, jseen):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
        assert tcoll_layout(a.size, quant) == jcoll.outer_shard_layout(a.size, 1, quant)
    got = model.values()
    want = {k: np.asarray(v).astype(np.float32) for k, v in holder["params"].items()}
    for k in sorted(want):
        atol = 0.0
        if quant:  # one int8 step of the largest delta row
            atol = float(np.abs(want[k] - arrays[k].astype(np.float32)).max()) / 127
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=atol, err_msg=k)
    # the fragments' backups too
    for tf, jf in zip(td.fragments, jd._fragments):
        for tb, jb in zip(tf.backup, jf.backup):
            np.testing.assert_allclose(tb.float().numpy(), np.asarray(jb).astype(np.float32),
                                       rtol=1e-6, atol=atol)


def tcoll_layout(n: int, quant: bool):
    from torchft_tpu_torch.collectives import outer_shard_layout

    return outer_shard_layout(n, 1, quant)


# ---------------------------------------------------------------------------
# threads as replicas
# ---------------------------------------------------------------------------


@pytest.fixture()
def lighthouse():
    server = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=200,
                              quorum_tick_ms=20, heartbeat_timeout_ms=1000)
    yield server
    server.shutdown()


def _diloco_replica(idx: int, addr: str, num_syncs: int, sync_every: int,
                    quant: bool = False, outer: Optional[OuterSGD] = None) -> np.ndarray:
    model = Params({"w": np.full(2048, 1.0, np.float32)})
    manager = Manager(
        comm=TCPCommunicator(timeout_s=15.0), load_state_dict=lambda s: None,
        state_dict=lambda: {}, min_replica_size=2, use_async_quorum=False,
        replica_id=f"diloco_{idx}", lighthouse_addr=addr, timeout=15.0, quorum_timeout=15.0,
        # identical init → no step-0 heal; keeps the per-replica
        # pseudograds distinct
        init_sync=False,
    )
    diloco = DiLoCo(manager, model, outer or OuterSGD(0.7), sync_every=sync_every,
                    should_quantize=quant)
    syncs = 0
    try:
        with diloco:
            while syncs < num_syncs:
                # replica-dependent inner progress: DiLoCo must reconcile it
                model.set({"w": model.values()["w"] - 0.01 * (idx + 1)})
                if diloco.step() is not None:
                    syncs += 1
        return model.values()["w"]
    finally:
        manager.shutdown()


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_diloco_two_replicas_converge(lighthouse, quant) -> None:
    """Two replicas with different local progress end bit-identical via
    averaged pseudogradients; int8: avg pseudograd (0.02+0.04)/2 = 0.03 per
    sync of sync_every=2, so w ≈ 1 − 0.03 after one sync with lr 1."""
    syncs, outer = (1, OuterSGD(1.0)) if quant else (3, None)
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(_diloco_replica, i, lighthouse.local_address(), syncs, 2,
                               quant, outer) for i in range(2)]
        w0, w1 = [f.result(timeout=120.0) for f in futures]
    np.testing.assert_array_equal(w0, w1)
    assert w0[0] < 1.0
    if quant:
        np.testing.assert_allclose(w0, np.full(2048, 0.97), atol=0.002)
