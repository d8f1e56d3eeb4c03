"""The port's sharded outer optimizer (ZeRO-1 over the replica dim) held
against the JAX package's (``tests/test_outer_shard.py`` is the twin).

- ``outer_shard_layout`` and ``_outer_chunk_ranges`` are equal to the JAX
  package's over a grid of sizes, owner counts and wire kinds.
- The chunk-pipelined reduce_scatter → sharded update → allgather(delta)
  of ``collectives.outer_sharded_sync`` at world sizes 2 and 3, float and
  int8, flat and hierarchical: bit-identical across replicas, within the
  replicated reference's tolerance, and bit-identical to the JAX package's
  pipeline on the same inputs.
- ``_OuterShard`` staging, abort, rebuild and checkpoint round trip.
- ``TORCHFT_OUTER_SHARD=0`` (replicated) and the sharded path agree bit for
  bit at world size 1, and the pipeline's timings land in
  ``last_quorum_timings`` as ``outer_shard_*``.
- Threads as replicas: sharded DiLoCo converges bit-identical, float and
  int8; a mixed quorum (one port rank, one JAX rank, the JAX package on its
  default wire) ends bit-identical, through a reshard whose pickled shard
  states each package loads from the other.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torchft_tpu.quantization as jq
from torchft_tpu import collectives as jcoll
from torchft_tpu import local_sgd as jlocal
from torchft_tpu import manager as jmanager
from torchft_tpu.communicator import TCPCommunicator as JaxTCPCommunicator
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch.communicator import CommunicatorError, TCPCommunicator, outer_shard_parts
from torchft_tpu_torch.lighthouse import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo, _outer_shard_mode, _OuterShard
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import OuterSGD
from torchft_tpu_torch.quantization import DEFAULT_ROW_SIZE
from torchft_tpu_torch.store import StoreServer

from tests.test_torch_local_sgd import Params, solo_manager


@pytest.fixture()
def store():
    server = StoreServer("127.0.0.1:0")
    yield server
    server.shutdown()


@pytest.fixture()
def lighthouse():
    server = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=200,
                              quorum_tick_ms=20, heartbeat_timeout_ms=1000)
    yield server
    server.shutdown()


class TestShardLayout:
    @pytest.mark.parametrize("quant", [False, True])
    @pytest.mark.parametrize("gsize", [1, 2, 3, 5, 8])
    @pytest.mark.parametrize("n", [1, 1000, 123_457, 1 << 20])
    def test_layout_and_chunks_equal_jax(self, n, gsize, quant, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_OUTER_CHUNK_MB", "0.05")
        layout = tcoll.outer_shard_layout(n, gsize, quant)
        assert layout == jcoll.outer_shard_layout(n, gsize, quant)
        _padded, per, unit = layout
        for cap in (64, 11):
            chunks = tcoll._outer_chunk_ranges(per, unit, gsize, max_chunks=cap)
            assert chunks == jcoll._outer_chunk_ranges(per, unit, gsize, max_chunks=cap)
            assert len(chunks) <= cap and chunks[0][0] == 0 and chunks[-1][1] == per

    def test_parts_are_deterministic_aligned_and_equal(self) -> None:
        for nbytes in (0, 64, 1000, 1 << 20, (1 << 20) + 4):
            for parts in (1, 2, 3, 5, 8):
                got = outer_shard_parts(nbytes, parts)
                share = got[0][1] - got[0][0]
                assert share % 64 == 0 and share * parts >= nbytes
                assert got == [(p * share, (p + 1) * share) for p in range(parts)]

    def test_quantized_layout_is_row_aligned(self) -> None:
        for ws in (2, 3, 4):
            padded, per, unit = tcoll.outer_shard_layout(123_457, ws, True)
            assert unit == DEFAULT_ROW_SIZE and per % DEFAULT_ROW_SIZE == 0 and padded == per * ws

    def test_bad_args_are_loud(self) -> None:
        with pytest.raises(CommunicatorError):
            outer_shard_parts(100, 0)
        with pytest.raises(CommunicatorError):
            outer_shard_parts(100, 2, unit=63)

    def test_mode_parse_is_loud(self, monkeypatch) -> None:
        for raw, want in (("", "auto"), ("auto", "auto"), ("1", "1"), ("0", "0")):
            monkeypatch.setenv("TORCHFT_OUTER_SHARD", raw)
            assert _outer_shard_mode() == want
        monkeypatch.setenv("TORCHFT_OUTER_SHARD", "bogus")
        with pytest.raises(ValueError, match="TORCHFT_OUTER_SHARD"):
            _outer_shard_mode()


def _run_comm_ranks(store, comm_classes, fn: Callable, prefix: str,
                    hosts: Optional[List[str]] = None) -> List[object]:
    world = len(comm_classes)

    def _one(rank: int) -> object:
        kwargs = {} if hosts is None else {"host_id": hosts[rank], "hierarchical": "1"}
        comm = comm_classes[rank](timeout_s=30.0, **kwargs)
        comm.configure(f"127.0.0.1:{store.port}/{prefix}", replica_id=f"rep_{rank}",
                       rank=rank, world_size=world)
        try:
            return fn(comm, rank)
        finally:
            comm.shutdown()

    with ThreadPoolExecutor(max_workers=world) as pool:
        return list(pool.map(_one, range(world)))


def _psg(rank: int, n: int) -> np.ndarray:
    return np.random.default_rng(100 + rank).normal(size=n).astype(np.float32)


LR = 0.5
N = 70_000


def _reference(world: int, n: int) -> np.ndarray:
    return (-LR * np.mean([_psg(r, n) for r in range(world)], axis=0)).astype(np.float32)


def _sync(coll):
    def run(comm, rank, quant):
        timings: dict = {}
        delta = coll.outer_sharded_sync(comm, _psg(rank, N), lambda lo, hi, avg: -LR * avg,
                                        num_participants=comm.size(), should_quantize=quant,
                                        timings=timings)
        assert timings["wall_s"] > 0
        return delta

    return run


@pytest.fixture()
def numpy_jax_wire(monkeypatch):
    monkeypatch.setattr(jq, "_NATIVE", None)
    monkeypatch.setattr(jcoll, "_use_device_reduce", lambda shard_bytes: False)


@pytest.mark.usefixtures("numpy_jax_wire")
class TestShardedPipeline:
    @pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
    @pytest.mark.parametrize("world", [2, 3])
    def test_flat_matches_replicated_and_jax(self, store, world, quant) -> None:
        port = _run_comm_ranks(store, [TCPCommunicator] * world,
                               lambda c, r: _sync(tcoll)(c, r, quant), f"p{world}{quant}")
        ref = _run_comm_ranks(store, [JaxTCPCommunicator] * world,
                              lambda c, r: _sync(jcoll)(c, r, quant), f"j{world}{quant}")
        for d in port[1:] + ref:
            assert d.tobytes() == port[0].tobytes()
        want = _reference(world, N)
        # two rowwise int8 passes (pseudo-grad + delta): ~1% of row max
        tol = 2.5 * np.abs(want).max() / 127 if quant else 1e-6
        np.testing.assert_allclose(port[0], want, rtol=1e-5, atol=tol)

    @pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
    def test_hierarchical_matches_replicated(self, store, quant) -> None:
        # 3 replicas on 2 emulated hosts: leaders (ranks 0, 2) own shards,
        # the member rides shm and receives the identical delta
        deltas = _run_comm_ranks(store, [TCPCommunicator] * 3,
                                 lambda c, r: _sync(tcoll)(c, r, quant), f"hier{quant}",
                                 hosts=["h0", "h0", "h1"])
        for d in deltas[1:]:
            np.testing.assert_array_equal(deltas[0], d)
        tol = 2.5 * np.abs(_reference(3, N)).max() / 127 if quant else 1e-5
        np.testing.assert_allclose(deltas[0], _reference(3, N), atol=max(tol, 1e-6))

    def test_chunk_pipeline_update_order(self, store, monkeypatch) -> None:
        """Small chunks → the callback runs once per chunk, in order, over
        exactly this owner's shard ranges."""
        monkeypatch.setenv("TORCHFT_OUTER_CHUNK_MB", "0.05")
        n = 200_000

        def _run(comm, rank):
            seen: List[tuple] = []

            def _cb(lo, hi, avg):
                seen.append((lo, hi))
                return np.zeros(hi - lo, dtype=np.float32)

            tcoll.outer_sharded_sync(comm, _psg(rank, n), _cb, comm.size())
            return seen

        results = _run_comm_ranks(store, [TCPCommunicator] * 2, _run, "chunks")
        _padded, per, _unit = tcoll.outer_shard_layout(n, 2, False)
        for rank, seen in enumerate(results):
            assert len(seen) > 1
            assert seen[0][0] == rank * per and seen[-1][1] == rank * per + per
            for (_a0, a1), (b0, _b1) in zip(seen, seen[1:]):
                assert a1 == b0


def _trajectory(monkeypatch, mode: str, steps: int = 6) -> np.ndarray:
    monkeypatch.setenv("TORCHFT_OUTER_SHARD", mode)
    model = Params({"w1": np.arange(300, dtype=np.float32), "w2": np.full(17, 2.0, np.float32)})
    diloco = DiLoCo(solo_manager(steps), model, OuterSGD(0.7, momentum=0.9, nesterov=True),
                    sync_every=2, fragment_update_alpha=0.25)
    for step in range(steps):
        model.set({k: v - 0.05 * (1.0 + 0.1 * step) for k, v in model.values().items()})
        diloco.step()
    return np.concatenate([v.ravel() for v in model.values().values()])


class TestGateBitIdentity:
    def test_replicated_bit_identical_to_sharded_at_ws1(self, monkeypatch) -> None:
        """At world size 1 the sharded flat-f32 schedule runs the identical
        elementwise math as the replicated path — bit for bit."""
        np.testing.assert_array_equal(_trajectory(monkeypatch, "0"), _trajectory(monkeypatch, "1"))

    def test_sharded_timings_flow_to_quorum_timings(self, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_OUTER_SHARD", "1")
        manager = solo_manager(1)
        model = Params({"w": np.full(64, 4.0, np.float32)})
        diloco = DiLoCo(manager, model, OuterSGD(0.5), sync_every=1)
        model.set({"w": model.values()["w"] - 1.0})
        assert diloco.step() is True
        assert "outer_shard_wall_s" in manager.last_quorum_timings
        assert "outer_shard_update_s" in manager.last_quorum_timings


class TestOuterShardState:
    def _shard_with_state(self, per_owner_n=64, gsize=2, gidx=0):
        n = per_owner_n * gsize
        shard = _OuterShard(OuterSGD(0.5, momentum=0.9), n, should_quantize=False)
        _padded, per, _unit = tcoll.outer_shard_layout(n, gsize, False)
        shard.meta = {"q": 7, "gsize": gsize, "gidx": gidx, "per": per, "n": n, "owns": True}
        shard._state_leaves = shard._fresh_leaves(per)
        return shard, per

    def test_update_cb_stages_until_commit(self) -> None:
        shard, per = self._shard_with_state()
        cb = shard.make_update_cb()
        delta = cb(0, per, np.full(per, 2.0, dtype=np.float32))
        # sgd momentum first step: delta = -lr * avg
        np.testing.assert_allclose(delta, np.full(per, -1.0), atol=1e-6)
        assert float(np.abs(shard._state_leaves[0]).max()) == 0.0  # staged, not live
        shard.commit_stage()
        assert float(np.abs(shard._state_leaves[0]).max()) > 0.0

    def test_abort_stage_keeps_old_state(self) -> None:
        shard, per = self._shard_with_state()
        shard.make_update_cb()(0, per, np.full(per, 2.0, np.float32))
        shard.abort_stage()
        assert float(np.abs(shard._state_leaves[0]).max()) == 0.0

    def test_rebuild_merges_contributions_and_reinits_holes(self) -> None:
        """3-way layout shrinking to 2-way: surviving shards' momentum
        carries over elementwise; the dead owner's range re-initializes."""
        n = 96
        _p3, per3, _u = tcoll.outer_shard_layout(n, 3, False)
        contribs = [
            ({"q": 1, "gsize": 3, "gidx": gidx, "per": per3, "n": n, "owns": True},
             [np.full(per3, 10.0 + gidx, dtype=np.float32)])
            for gidx in (0, 2)  # owner 1 "died"
        ]
        shard = _OuterShard(OuterSGD(0.5, momentum=0.9), n, should_quantize=False)
        _p2, per2, _u2 = tcoll.outer_shard_layout(n, 2, False)
        shard._rebuild(contribs, {"q": 2, "gsize": 2, "gidx": 0, "per": per2, "n": n, "owns": True})
        full = np.zeros(max(3 * per3, 2 * per2), dtype=np.float32)
        full[0:per3] = 10.0
        full[2 * per3 : 3 * per3] = 12.0
        np.testing.assert_array_equal(shard._state_leaves[0], full[:per2])

    def test_save_load_roundtrip_contributes_at_reshard(self) -> None:
        import torch

        shard, per = self._shard_with_state()
        shard._state_leaves[0][:] = 3.5
        saved = shard.save_state()
        # the heal's transport delivers array leaves as CPU tensors
        saved["leaves"] = [torch.from_numpy(l) for l in saved["leaves"]]
        other = _OuterShard(OuterSGD(0.5, momentum=0.9), per * 2, False)
        other.load_state(saved)
        assert other.meta is None  # forces reshard at the next sync
        assert all(isinstance(l, np.ndarray) for _m, ls in other._loaded for l in ls)
        meta = {"q": 9, "gsize": 2, "gidx": 0, "per": per, "n": per * 2, "owns": True}
        other._rebuild(other._export_contribs(), meta)
        np.testing.assert_array_equal(other._state_leaves[0], 3.5)


# ---------------------------------------------------------------------------
# threads as replicas
# ---------------------------------------------------------------------------


def _port_replica(idx, addr, quant, syncs=3, reshard_after=None):
    model = Params({"w": np.full(4096, 1.0, np.float32)})
    manager = Manager(
        comm=TCPCommunicator(timeout_s=10.0), load_state_dict=lambda s: None,
        state_dict=lambda: {}, min_replica_size=2, use_async_quorum=False,
        replica_id=f"shard_{idx}", lighthouse_addr=addr, timeout=10.0, quorum_timeout=10.0,
        init_sync=False,
    )
    diloco = DiLoCo(manager, model, OuterSGD(0.7, momentum=0.9, nesterov=True), sync_every=2,
                    should_quantize=quant)
    try:
        done = 0
        while done < syncs:
            model.set({"w": model.values()["w"] - 0.01 * (idx + 1)})
            if diloco.step() is not None:
                done += 1
                if done == reshard_after:
                    diloco.fragments[0]._shard.meta["q"] = -1  # reshard at the next sync
        return {"w": model.values()["w"], "timings": dict(manager.last_quorum_timings),
                "state": diloco.fragments[0]._shard._state_leaves}
    finally:
        manager.shutdown()


def _jax_replica(idx, addr, quant, syncs=3, reshard_after=None):
    holder = {"params": {"w": jnp.full(4096, 1.0, dtype=jnp.float32)}}
    manager = jmanager.Manager(
        comm=JaxTCPCommunicator(timeout_s=10.0), load_state_dict=lambda s: None,
        state_dict=lambda: {}, min_replica_size=2, use_async_quorum=False,
        replica_id=f"shard_{idx}", lighthouse_addr=addr, timeout=10.0, quorum_timeout=10.0,
        init_sync=False,
    )
    diloco = jlocal.DiLoCo(manager, holder, optax.sgd(0.7, momentum=0.9, nesterov=True),
                           sync_every=2, should_quantize=quant)
    try:
        done = 0
        while done < syncs:
            holder["params"] = {"w": holder["params"]["w"] - 0.01 * (idx + 1)}
            if diloco.step() is not None:
                done += 1
                if done == reshard_after:
                    diloco._fragments[0]._shard.meta["q"] = -1
        return {"w": np.asarray(holder["params"]["w"]), "timings": dict(manager.last_quorum_timings),
                "state": diloco._fragments[0]._shard._state_leaves}
    finally:
        manager.shutdown()


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_diloco_sharded_two_replicas_converge(lighthouse, quant) -> None:
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(_port_replica, i, lighthouse.local_address(), quant)
                   for i in range(2)]
        states = [f.result(timeout=120.0) for f in futures]
    np.testing.assert_array_equal(states[0]["w"], states[1]["w"])
    assert states[0]["w"][0] < 1.0  # outer steps actually applied
    assert "outer_shard_wall_s" in states[0]["timings"]


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_mixed_quorum_sharded_diloco_ends_bit_identical(lighthouse, quant) -> None:
    """One port rank and one JAX rank (each owning a shard, the JAX package
    on its default wire) run sharded DiLoCo; after two syncs both force a
    reshard, so each rebuilds its shard from the pickled states the other
    package sent.  Both end with equal bytes, and each owner kept its own
    shard of the momentum through the exchange."""
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [
            pool.submit(_port_replica, 0, lighthouse.local_address(), quant, 4, 2),
            pool.submit(_jax_replica, 1, lighthouse.local_address(), quant, 4, 2),
        ]
        port, ref = [f.result(timeout=120.0) for f in futures]
    assert port["w"].tobytes() == ref["w"].tobytes()
    assert port["w"][0] < 1.0
    for state in (port["state"], ref["state"]):
        assert len(state) == 1 and np.abs(np.asarray(state[0])).max() > 0
