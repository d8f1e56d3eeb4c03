"""The port's C++ runtime (``torchft_tpu_torch/native.py`` over
``torchft_tpu_torch/csrc/native/``) held against the JAX package's.

The classes of ``tests/test_native.py``, with each C++ server of the port
driven by the JAX package's Python clients and by the port's, and the JAX
package's C++ servers driven by the port's Python clients; the port's
``CppCommunicator`` run alone; rings that mix the four kinds of rank
(port-cpp, port-python, jax-cpp, jax-python), whose every rank must end with
the bytes of an all-JAX-Python ring; the hand-off of host torch tensors; and
a kill-and-heal fleet on the C++ tier against the Python tier.  Everything
skips where g++ is absent.
"""

import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List

import ml_dtypes
import numpy as np
import pytest
import torch

import torchft_tpu.collectives as jcoll
import torchft_tpu.native as jnative
import torchft_tpu.quantization as jq
from torchft_tpu.communicator import ReduceOp as JaxReduceOp
from torchft_tpu.communicator import TCPCommunicator as JaxTCPCommunicator
from torchft_tpu.lighthouse import LighthouseClient as JaxLighthouseClient
from torchft_tpu.manager_server import ManagerClient as JaxManagerClient
from torchft_tpu.store import StoreClient as JaxStoreClient
from torchft_tpu_torch import bf16, native, train_ddp
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch.communicator import CommunicatorError, ReduceOp, TCPCommunicator
from torchft_tpu_torch.lighthouse import LighthouseClient
from torchft_tpu_torch.manager_server import ManagerClient
from torchft_tpu_torch.models.llama import llama_debug
from torchft_tpu_torch.store import StoreClient

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is absent")

CLIENTS = {
    "port": (StoreClient, LighthouseClient, ManagerClient),
    "jax": (JaxStoreClient, JaxLighthouseClient, JaxManagerClient),
}


@pytest.fixture()
def cpp():
    """The port's native module; its library must build here."""
    assert native.available(), native._lib_error
    return native


@pytest.fixture()
def jax_cpp():
    if not jnative.available():
        pytest.skip("the JAX package's C++ tier (native/libtpuft.so) is not available")
    return jnative


@pytest.fixture(params=["port-server/jax-client", "port-server/port-client",
                        "jax-server/port-client"])
def pairing(request, cpp):
    """(server module, client classes): the port's C++ servers against both
    packages' Python clients, and the JAX package's against the port's."""
    server, client = (p.split("-")[0] for p in request.param.split("/"))
    if server == "jax" and not jnative.available():
        pytest.skip("the JAX package's C++ tier is not available")
    return (native if server == "port" else jnative), CLIENTS[client]


class TestCppStore:
    def test_python_client_interop(self, pairing) -> None:
        mod, (store_client, _, _) = pairing
        server = mod.CppStoreServer("127.0.0.1:0")
        try:
            client = store_client(f"127.0.0.1:{server.port}", timeout=5.0)
            client.set("k", b"v")
            assert client.get("k") == b"v"
            assert client.add("n", 5) == 5
            assert client.add("n", 2) == 7
            assert client.exists("k")
            assert not client.exists("zzz")
            client.set("p/a", b"1")
            client.set("p/b", b"2")
            assert client.delete_prefix("p/") == 2
            with pytest.raises(TimeoutError):
                client.get("missing", timeout=0.3)
            client.close()
        finally:
            server.shutdown()

    def test_wait_for_key_across_clients(self, pairing) -> None:
        mod, (store_client, _, _) = pairing
        server = mod.CppStoreServer("127.0.0.1:0")
        try:
            a = store_client(f"127.0.0.1:{server.port}", timeout=5.0)
            b = store_client(f"127.0.0.1:{server.port}", timeout=5.0)

            def _late() -> None:
                time.sleep(0.2)
                b.set("late", b"x")

            t = threading.Thread(target=_late)
            t.start()
            assert a.get("late", timeout=5.0) == b"x"
            t.join()
            a.close()
            b.close()
        finally:
            server.shutdown()


class TestCppLighthouse:
    def test_e2e_quorum(self, pairing) -> None:
        mod, (_, lighthouse_client, _) = pairing
        server = mod.CppLighthouseServer(
            bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=50, quorum_tick_ms=20
        )
        try:
            client = lighthouse_client(server.local_address(), connect_timeout=5.0)
            client.heartbeat("foo")
            quorum = client.quorum(replica_id="foo", timeout=5.0, step=3)
            assert len(quorum.participants) == 1
            assert quorum.participants[0].step == 3
            assert quorum.quorum_id == 1
            assert client.status()["impl"] == "cpp"
            client.close()
        finally:
            server.shutdown()

    def test_two_replicas_and_commit_failure_bump(self, pairing) -> None:
        mod, (_, lighthouse_client, _) = pairing
        server = mod.CppLighthouseServer(
            bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=500, quorum_tick_ms=20
        )
        addr = server.local_address()
        try:
            out: List = []

            def _ask(rid: str, cf: int) -> None:
                c = lighthouse_client(addr, connect_timeout=5.0)
                out.append(c.quorum(replica_id=rid, timeout=10.0, commit_failures=cf))
                c.close()

            for failures in ((0, 0), (0, 2)):
                out.clear()
                threads = [
                    threading.Thread(target=_ask, args=(rid, cf))
                    for rid, cf in zip("ab", failures)
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=10.0)
                if failures == (0, 0):
                    assert all(q.quorum_id == 1 for q in out)
                    assert [p.replica_id for p in out[0].participants] == ["a", "b"]
                else:
                    # commit failures bump the quorum id
                    assert all(q.quorum_id == 2 for q in out)
        finally:
            server.shutdown()

    def test_http_dashboard_and_kill(self, pairing) -> None:
        import json
        import urllib.error
        import urllib.request

        mod, (_, lighthouse_client, _) = pairing
        server = mod.CppLighthouseServer(
            bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=50, quorum_tick_ms=20
        )
        try:
            client = lighthouse_client(server.local_address(), connect_timeout=5.0)
            client.quorum(replica_id="dash", timeout=5.0, step=4, address="vm:1")
            with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/status.json", timeout=5.0
            ) as resp:
                status = json.loads(resp.read())
            assert status["impl"] == "cpp"
            assert status["quorum_id"] == 1
            assert status["participants"][0]["replica_id"] == "dash"
            assert status["participants"][0]["step"] == 4
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/replica/ghost/kill", timeout=5.0
                )
            client.close()
        finally:
            server.shutdown()

    def test_timeout_honored(self, pairing) -> None:
        mod, (_, lighthouse_client, _) = pairing
        server = mod.CppLighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=60000)
        try:
            client = lighthouse_client(server.local_address(), connect_timeout=5.0)
            start = time.monotonic()
            with pytest.raises(TimeoutError):
                client.quorum(replica_id="lonely", timeout=0.3)
            assert time.monotonic() - start < 2.0
            client.close()
        finally:
            server.shutdown()


class TestCppManager:
    def test_quorum_and_commit(self, pairing) -> None:
        mod, (_, _, manager_client) = pairing
        lh = mod.CppLighthouseServer(
            bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=50, quorum_tick_ms=20
        )
        mgr = mod.CppManagerServer(
            replica_id="rep_0", lighthouse_addr=lh.local_address(), hostname="127.0.0.1",
            bind="127.0.0.1:0", store_addr="store_rep0", world_size=1,
        )
        try:
            client = manager_client(f"127.0.0.1:{mgr.port}")
            resp = client._quorum(
                group_rank=0, step=9, checkpoint_metadata="meta", shrink_only=False,
                timeout=10.0,
            )
            assert resp.quorum_id == 1
            assert resp.replica_rank == 0
            assert resp.max_step == 9
            assert not resp.heal
            assert resp.store_address == "store_rep0"
            assert client._checkpoint_metadata(0, timeout=5.0) == "meta"
            assert client.should_commit(0, 9, True, timeout=5.0) is True
            client.close()
        finally:
            mgr.shutdown()
            lh.shutdown()

    def test_heal_assignment_two_replicas(self, pairing) -> None:
        mod, (_, _, manager_client) = pairing
        # min_replicas=2: both replicas are in the quorum however late the
        # second one asks
        lh = mod.CppLighthouseServer(
            bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=100, quorum_tick_ms=20
        )
        mgrs = [
            mod.CppManagerServer(
                replica_id=f"rep_{i}", lighthouse_addr=lh.local_address(),
                hostname="127.0.0.1", bind="127.0.0.1:0", store_addr=f"store_{i}",
                world_size=1,
            )
            for i in range(2)
        ]
        try:
            results: List = [None, None]

            def _ask(i: int, step: int) -> None:
                c = manager_client(f"127.0.0.1:{mgrs[i].port}")
                results[i] = c._quorum(
                    group_rank=0, step=step, checkpoint_metadata=f"m{i}",
                    shrink_only=False, timeout=10.0,
                )
                c.close()

            threads = [threading.Thread(target=_ask, args=(0, 5)),
                       threading.Thread(target=_ask, args=(1, 0))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=10.0)
            assert results[0] is not None and results[1] is not None
            assert not results[0].heal
            assert results[1].heal
            assert results[1].recover_src_replica_rank == results[0].replica_rank
            assert results[0].recover_dst_replica_ranks == [results[1].replica_rank]
            assert results[1].max_step == 5
        finally:
            for m in mgrs:
                m.shutdown()
            lh.shutdown()

    def test_refuses_the_spare_role(self, cpp) -> None:
        with pytest.raises(ValueError, match="SPARE"):
            cpp.CppManagerServer(replica_id="s", lighthouse_addr="127.0.0.1:1", role=1)


@pytest.fixture()
def cpp_store(cpp):
    server = cpp.CppStoreServer("127.0.0.1:0")
    yield server
    server.shutdown()


def _run_ranks(store, world_size: int, fn: Callable, timeout_s: float = 30.0,
               prefix: str = "q0") -> List[object]:
    def _one(rank: int) -> object:
        comm = native.CppCommunicator(timeout_s=timeout_s)
        comm.configure(f"127.0.0.1:{store.port}/{prefix}", replica_id=f"r{rank}", rank=rank,
                       world_size=world_size)
        try:
            return fn(comm, rank)
        finally:
            comm.shutdown()

    with ThreadPoolExecutor(max_workers=world_size) as pool:
        return list(pool.map(_one, range(world_size)))


class TestCppCommunicator:
    @pytest.mark.parametrize("world_size", [1, 2, 3, 4])
    def test_allreduce_sum(self, cpp_store, world_size) -> None:
        n = 1000

        def _fn(comm, rank):
            data = np.arange(n, dtype=np.float32) + rank
            return comm.allreduce(data, ReduceOp.SUM).wait(timeout=30.0)

        expected = sum(np.arange(n, dtype=np.float32) + r for r in range(world_size))
        for res in _run_ranks(cpp_store, world_size, _fn):
            np.testing.assert_allclose(res, expected, rtol=1e-6)

    @pytest.mark.parametrize("world_size", [1, 2, 3])
    def test_reduce_scatter(self, cpp_store, world_size) -> None:
        n = 1000  # not divisible by 3 -> uneven chunks

        def _fn(comm, rank):
            data = np.arange(n, dtype=np.float32) + rank
            keep = data.copy()
            out = comm.reduce_scatter(data, ReduceOp.SUM).wait(timeout=30.0)
            np.testing.assert_array_equal(data, keep)  # input untouched
            return out

        results = _run_ranks(cpp_store, world_size, _fn)
        expected = sum(np.arange(n, dtype=np.float32) + r for r in range(world_size))
        base, extra = divmod(n, world_size)
        off = 0
        for rank, res in enumerate(results):
            size = base + (1 if rank < extra else 0)
            np.testing.assert_allclose(res, expected[off : off + size], rtol=1e-6)
            off += size
        assert off == n

    def test_allreduce_bf16_and_avg(self, cpp_store) -> None:
        """A :data:`bf16.BF16` buffer reduces as bf16 (dtype code 4) and AVG
        divides it as ml_dtypes does; it stays BF16."""

        def _fn(comm, rank):
            data = bf16.from_f32(np.full(513, float(rank + 1), dtype=np.float32))
            return comm.allreduce(data, ReduceOp.AVG).wait(timeout=30.0)

        for res in _run_ranks(cpp_store, 2, _fn):
            assert bf16.is_bf16(res)
            np.testing.assert_array_equal(bf16.to_f32(res), np.full(513, 1.5, np.float32))

    def test_uint16_allreduce_is_refused_as_in_the_jax_package(self, cpp_store, jax_cpp) -> None:
        """The library has no 16-bit integer reduce: a plain uint16 buffer is
        refused loudly by both packages' C++ tier, never reduced as bf16."""
        for mod in (native, jax_cpp):
            comm = mod.CppCommunicator(timeout_s=10.0)
            comm.configure(f"127.0.0.1:{cpp_store.port}/u16_{mod.__name__}", replica_id="r0",
                           rank=0, world_size=1)
            try:
                err = comm.allreduce(np.arange(8, dtype=np.uint16)).exception(timeout=10.0)
                assert err is not None and "unsupported dtype uint16" in str(err)
            finally:
                comm.shutdown()

    def test_broadcast_send_recv(self, cpp_store) -> None:
        def _fn(comm, rank):
            b = comm.broadcast(np.full(7, float(rank), dtype=np.float64), root=1).wait(
                timeout=30.0
            )
            if rank == 0:
                comm.send_bytes(b"ping", dst=1, tag=9).wait(timeout=30.0)
                got = None
            else:
                got = comm.recv_bytes(src=0, tag=9).wait(timeout=30.0)
            return b, got

        results = _run_ranks(cpp_store, 2, _fn)
        np.testing.assert_allclose(results[0][0], np.full(7, 1.0))
        np.testing.assert_allclose(results[1][0], np.full(7, 1.0))
        assert results[1][1] == b"ping"

    def test_alltoall_allgather(self, cpp_store) -> None:
        world_size = 3

        def _fn(comm, rank):
            chunks = [np.full(4, 10 * rank + p, dtype=np.float32) for p in range(world_size)]
            a2a = comm.alltoall(chunks).wait(timeout=30.0)
            ag = comm.allgather(np.full(3, float(rank), dtype=np.float32)).wait(timeout=30.0)
            return a2a, ag

        for rank, (a2a, ag) in enumerate(_run_ranks(cpp_store, world_size, _fn)):
            for src, arr in enumerate(a2a):
                np.testing.assert_allclose(arr, np.full(4, 10 * src + rank))
            for src, arr in enumerate(ag):
                np.testing.assert_allclose(arr, np.full(3, float(src)))

    def test_barrier_and_large_allreduce(self, cpp_store) -> None:
        n = 2_000_000  # 8 MB per rank

        def _fn(comm, rank):
            comm.barrier().wait(timeout=30.0)
            data = np.full(n, float(rank + 1), dtype=np.float32)
            t0 = time.monotonic()
            out = comm.allreduce(data, ReduceOp.SUM).wait(timeout=60.0)
            return out, time.monotonic() - t0

        results = _run_ranks(cpp_store, 2, _fn, timeout_s=60.0)
        for res, _dt in results:
            np.testing.assert_allclose(res[:5], np.full(5, 3.0))
        assert results[0][1] < 5.0

    def test_abort_unblocks_and_reconfigure(self, cpp_store) -> None:
        world_size = 2
        barrier = threading.Barrier(world_size)
        errors: List[Exception] = []
        recovered: List[np.ndarray] = []

        def _fn(rank: int) -> None:
            comm = native.CppCommunicator(timeout_s=5.0)
            comm.configure(f"127.0.0.1:{cpp_store.port}/qa", replica_id=f"r{rank}", rank=rank,
                           world_size=world_size)
            barrier.wait()
            if rank == 1:
                comm.abort("injected")
                comm.shutdown()
                return
            err = comm.allreduce(np.ones(4096, dtype=np.float32)).exception(timeout=30.0)
            assert err is not None
            errors.append(err)
            comm.configure(f"127.0.0.1:{cpp_store.port}/qb", replica_id=f"r{rank}", rank=0,
                           world_size=1)
            recovered.append(comm.allreduce(np.full(4, 2.0, dtype=np.float32)).wait(timeout=10.0))
            comm.shutdown()

        threads = [threading.Thread(target=_fn, args=(r,)) for r in range(world_size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert len(errors) == 1
        assert len(recovered) == 1
        np.testing.assert_allclose(recovered[0], np.full(4, 2.0))


# --- rings that mix tiers and packages --------------------------------------

N = 100_003  # ~400 KB of f32: stripes at 2 lanes, uneven ring chunks
KINDS = {
    "port-cpp": lambda t: native.CppCommunicator(timeout_s=t),
    "port-python": lambda t: TCPCommunicator(timeout_s=t),
    "jax-cpp": lambda t: jnative.CppCommunicator(timeout_s=t),
    "jax-python": lambda t: JaxTCPCommunicator(timeout_s=t),
}
LAYOUTS = [
    ("port-cpp", "jax-python"),
    ("jax-cpp", "port-python"),
    ("port-cpp", "jax-cpp"),
    ("port-cpp", "port-python", "jax-cpp"),
    ("jax-python", "port-cpp", "jax-cpp"),
    ("port-python", "jax-cpp", "port-cpp"),
    ("port-cpp", "port-cpp", "port-cpp"),
]


def _run_layout(store, layout, fn: Callable, prefix: str) -> List[object]:
    """``fn(comm, rank, package)`` on one thread per rank, rank r running
    ``KINDS[layout[r]]`` in one rendezvous."""
    ws = len(layout)

    def _one(rank: int) -> object:
        comm = KINDS[layout[rank]](60.0)
        comm.configure(f"127.0.0.1:{store.port}/{prefix}", replica_id=f"r{rank}", rank=rank,
                       world_size=ws)
        try:
            return fn(comm, rank, layout[rank].split("-")[0])
        finally:
            comm.shutdown()

    with ThreadPoolExecutor(max_workers=ws) as pool:
        return list(pool.map(_one, range(ws)))


def _bf16_bits(rank: int, n: int) -> np.ndarray:
    """Finite bf16 values as uint16 bit patterns, from a numpy seed."""
    x = np.random.default_rng(3000 + rank).normal(size=n).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).view(np.uint16)


def _as_bf16(bits: np.ndarray, package: str) -> np.ndarray:
    """The package's own bf16 host buffer over ``bits`` (a copy)."""
    return bits.copy().view(bf16.BF16 if package == "port" else ml_dtypes.bfloat16)


def _raw(a) -> bytes:
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _collectives(comm, rank: int, package: str) -> List[bytes]:
    """f32 SUM/AVG allreduce, reduce_scatter and allgather; bf16 SUM/AVG
    allreduce and reduce_scatter; uint16 alltoall and allgather."""
    op = ReduceOp if package == "port" else JaxReduceOp
    x = np.random.default_rng(1000 + rank).normal(size=N).astype(np.float32)
    bits = _bf16_bits(rank, N)
    u16 = np.random.default_rng(4000 + rank).integers(0, 1 << 16, size=comm.size() * 257,
                                                      dtype=np.uint16)
    out = [
        comm.allreduce(x.copy(), op.SUM).wait(timeout=60.0),
        comm.allreduce(x.copy(), op.AVG).wait(timeout=60.0),
        comm.reduce_scatter(x.copy(), op.SUM).wait(timeout=60.0),
        *comm.allgather(x[:1001].copy()).wait(timeout=60.0),
        comm.allreduce(_as_bf16(bits, package), op.SUM).wait(timeout=60.0),
        comm.allreduce(_as_bf16(bits, package), op.AVG).wait(timeout=60.0),
        comm.reduce_scatter(_as_bf16(bits, package), op.SUM).wait(timeout=60.0),
        *comm.alltoall(list(u16.reshape(comm.size(), 257))).wait(timeout=60.0),
        *comm.allgather(u16[:333].copy()).wait(timeout=60.0),
    ]
    return [_raw(o) for o in out]


@pytest.fixture()
def mixed_store(cpp):
    if not jnative.available():
        pytest.skip("the JAX package's C++ tier is not available")
    server = native.CppStoreServer("127.0.0.1:0")
    yield server
    server.shutdown()


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS, ids="/".join)
def test_mixed_ring_collectives_equal_an_all_jax_python_ring(mixed_store, layout, lanes,
                                                             monkeypatch) -> None:
    monkeypatch.setenv("TORCHFT_RING_LANES", str(lanes))
    monkeypatch.setenv("TORCHFT_RING_FRAME_KB", "64")
    tag = f"{'_'.join(layout)}_{lanes}"
    got = _run_layout(mixed_store, layout, _collectives, f"mix_{tag}")
    want = _run_layout(mixed_store, ("jax-python",) * len(layout), _collectives, f"ref_{tag}")
    for rank, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            assert a == b, f"rank {rank} ({layout[rank]}): result {i} differs"


def _int8_wire(comm, rank: int, package: str) -> bytes:
    data = np.random.default_rng(2000 + rank).normal(size=64 * 1024 + 300).astype(np.float32)
    coll = tcoll if package == "port" else jcoll
    return _raw(coll.allreduce_quantized(comm, [data], kind="int8").wait(timeout=60.0)[0])


@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS, ids="/".join)
def test_mixed_ring_int8_wire_equals_an_all_jax_python_ring(mixed_store, layout, lanes,
                                                            monkeypatch) -> None:
    """The quantized pipeline rides alltoall/allgather: the same bytes
    through every tier.  The JAX ranks run their numpy host reduce, the one
    the port follows (ROADMAP §C1)."""
    monkeypatch.setenv("TORCHFT_RING_LANES", str(lanes))
    monkeypatch.setenv("TORCHFT_RING_FRAME_KB", "64")
    monkeypatch.setenv("TORCHFT_QUANT_DEVICE_REDUCE", "0")
    monkeypatch.setattr(jq, "_NATIVE", None)
    monkeypatch.setattr(jcoll, "_use_device_reduce", lambda shard_bytes: False)
    tag = f"{'_'.join(layout)}_{lanes}"
    got = _run_layout(mixed_store, layout, _int8_wire, f"mixq_{tag}")
    want = _run_layout(mixed_store, ("jax-python",) * len(layout), _int8_wire, f"refq_{tag}")
    assert got == want


def test_bf16_nan_payload_differs_between_the_tiers_c3(cpp_store) -> None:
    """ROADMAP §C3: the C++ ``f32_to_bf16`` keeps a NaN's payload, ml_dtypes
    (and ``bf16.py``) make every NaN ``0x7fc0``.  One bf16 NaN with payload
    ``0x7FC1`` plus 1.0 at ws=2: ``0x7fc1`` on the C++ tier, ``0x7fc0`` on the
    Python tier, so that a change to either path shows."""
    store_py = cpp_store

    def run(make) -> List[int]:
        def _one(rank: int) -> int:
            comm = make()
            comm.configure(f"127.0.0.1:{store_py.port}/c3_{type(comm).__name__}",
                           replica_id=f"r{rank}", rank=rank, world_size=2)
            try:
                bits = np.array([0x7FC1 if rank == 0 else 0x3F80], dtype=np.uint16)
                out = comm.allreduce(bits.view(bf16.BF16), ReduceOp.SUM).wait(timeout=30.0)
                return int(out.view(np.uint16)[0])
            finally:
                comm.shutdown()

        with ThreadPoolExecutor(max_workers=2) as pool:
            return list(pool.map(_one, range(2)))

    assert run(lambda: native.CppCommunicator(timeout_s=30.0)) == [0x7FC1, 0x7FC1]
    assert run(lambda: TCPCommunicator(timeout_s=30.0)) == [0x7FC0, 0x7FC0]


# --- zero-copy hand-off ------------------------------------------------------


class TestZeroCopyHandoff:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
    def test_cpu_tensor_is_a_view_of_its_memory(self, dtype) -> None:
        t = torch.arange(1024).to(dtype)
        view = native.as_host_array(t)
        assert isinstance(view, np.ndarray)
        assert view.ctypes.data == t.data_ptr() and view.nbytes == t.nbytes
        assert bf16.is_bf16(view) == (dtype == torch.bfloat16)

    def test_tensor_off_the_host_is_refused(self) -> None:
        meta = torch.empty(4, device="meta")
        with pytest.raises(CommunicatorError, match="host buffers"):
            native.as_host_array(meta)

    def test_as_host_array_buffer_protocol(self) -> None:
        raw = bytearray(b"\x01\x02\x03\x04")
        view = native.as_host_array(raw)
        assert view.dtype == np.uint8
        view[0] = 9  # bytearray view is writable and aliases
        assert raw[0] == 9

    def test_tensors_reduce_in_place_in_their_own_memory(self, cpp_store) -> None:
        """CPU tensors, bf16 among them, ride one ring as scattered iovec
        segments; in_place results alias the tensors' memory."""

        def _fn(comm, rank):
            ts = [
                torch.full((1000,), float(rank + 1)),
                torch.full((32, 33), float(10 * (rank + 1))).to(torch.bfloat16),
                torch.full((7,), rank + 1, dtype=torch.int32),
            ]
            out = comm.allreduce(ts, ReduceOp.SUM, in_place=True).wait(timeout=30.0)
            for o, t in zip(out, ts):
                assert o.ctypes.data == t.data_ptr()
            return ts

        for ts in _run_ranks(cpp_store, 2, _fn):
            assert torch.equal(ts[0], torch.full((1000,), 3.0))
            assert torch.equal(ts[1], torch.full((32, 33), 30.0).to(torch.bfloat16))
            assert torch.equal(ts[2], torch.full((7,), 3, dtype=torch.int32))

    def test_single_tensor_allreduce_and_send_bytes(self, cpp_store) -> None:
        def _fn(comm, rank):
            summed = comm.allreduce(torch.arange(10.0) * (rank + 1)).wait(timeout=30.0)
            if rank == 0:
                comm.send_bytes(torch.arange(256, dtype=torch.int32), dst=1, tag=77).wait(
                    timeout=30.0)
                return summed, None
            out = np.empty(256, dtype=np.int32)
            assert comm.recv_bytes_into(0, out, tag=77).wait(timeout=30.0) == out.nbytes
            return summed, out

        results = _run_ranks(cpp_store, 2, _fn)
        for summed, _ in results:
            np.testing.assert_array_equal(summed, np.arange(10.0, dtype=np.float32) * 3)
        np.testing.assert_array_equal(results[1][1], np.arange(256, dtype=np.int32))


# --- lane statistics and pacing ---------------------------------------------


class TestNativeLaneStats:
    def test_lane_stats_tier_agnostic_keys(self, cpp_store, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_RING_LANES", "2")
        monkeypatch.setenv("TORCHFT_RING_FRAME_KB", "64")

        def _fn(comm, rank):
            data = np.ones(200_000, dtype=np.float32) * (rank + 1)
            comm.allreduce(data, ReduceOp.SUM, in_place=True).wait(timeout=30.0)
            return comm.lane_stats()

        stats = _run_ranks(cpp_store, 2, _fn)[0]
        for key in ("lanes", "stripe_floor_bytes", "lane_tx_bytes", "lane_rx_bytes",
                    "lane_stalls", "lane_reconnects", "lane_failovers", "faults_injected",
                    "dead_lanes"):
            assert key in stats, f"missing lane_stats key {key}"
        assert stats["lanes"] == 2
        assert len(stats["lane_tx_bytes"]) == 2
        assert all(b > 0 for b in stats["lane_tx_bytes"])
        assert all(b > 0 for b in stats["lane_rx_bytes"])

    def test_unconfigured_lane_stats_empty(self, cpp) -> None:
        comm = cpp.CppCommunicator(timeout_s=5.0)
        assert comm.lane_stats() == {}
        comm.shutdown()


class TestNativePacerParity:
    def test_auto_lane_and_floor_parity_under_emulation(self, cpp_store, monkeypatch) -> None:
        """Under TORCHFT_NET_EMU both of the port's tiers derive the same auto
        lane count and stripe floor, and a mixed ring still sums exactly."""
        monkeypatch.setenv("TORCHFT_NET_EMU", "dcn_10g")
        n = 50_000

        def _ops(comm, rank, package):
            data = np.arange(n, dtype=np.float32) * (rank + 1)
            return comm.allreduce(data, ReduceOp.SUM).wait(timeout=60.0), comm.lane_stats()

        mixed = _run_layout(cpp_store, ("port-python", "port-cpp"), _ops, "emu_mix")
        for out, _stats in mixed:
            np.testing.assert_array_equal(out, np.arange(n, dtype=np.float32) * 3)
        py_stats, cpp_stats = mixed[0][1], mixed[1][1]
        assert py_stats["lanes"] == cpp_stats["lanes"] == 4  # dcn_10g auto
        assert py_stats["stripe_floor_bytes"] == cpp_stats["stripe_floor_bytes"]

    def test_unknown_profile_is_loud(self, cpp, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_NET_EMU", "wan_9000g")
        comm = cpp.CppCommunicator(timeout_s=5.0)
        store = cpp.CppStoreServer("127.0.0.1:0")
        try:
            with pytest.raises(Exception, match="TORCHFT_NET_EMU"):
                comm.configure(f"127.0.0.1:{store.port}/loud", replica_id="r0", rank=0,
                               world_size=2)
        finally:
            comm.shutdown()
            store.shutdown()


# --- the whole stack ---------------------------------------------------------


def test_fleet_on_the_cpp_tier_heals_and_ends_bit_identical_to_the_python_tier(cpp) -> None:
    """``run_fleet`` with a kill and heal, every plane on the C++ tier, then
    on the Python tier: the same final parameters, bit for bit."""
    shas = {}
    for tier in ("cpp", "python"):
        results = train_ddp.run_fleet(
            llama_debug(), torch.device("cpu"), steps=4, seq=128, batch=2, lr=1e-3,
            kill_at=(1, 2), timeout=30.0, tier=tier,
        )
        assert [r.final_step for r in results] == [4, 4]
        assert results[1].restarts == 1
        assert results[1].heal is not None and results[1].heal.bytes_total > 0
        prefix = "Cpp" if tier == "cpp" else ""
        for r in results:
            assert r.planes == {
                "lighthouse": f"{prefix}LighthouseServer",
                "manager_server": f"{prefix}ManagerServer",
                "communicator": "CppCommunicator" if tier == "cpp" else "TCPCommunicator",
            }
        assert len({r.params_sha256 for r in results}) == 1
        shas[tier] = results[0].params_sha256
    assert shas["cpp"] == shas["python"]


# --- the build -----------------------------------------------------------


def test_artifact_is_keyed_on_the_sources_the_flags_and_the_cpu(tmp_path, monkeypatch) -> None:
    """The library's file name changes with any source, the flags or the
    CPU that ``-march=native`` resolves to, and lies in the port's build
    directory under the port's own name."""
    src = tmp_path / "native"
    shutil.copytree(native.SOURCE_DIR, src)
    monkeypatch.setattr(native, "SOURCE_DIR", src)
    base = native._artifact()
    assert base.parent == native.BUILD_DIR and base.name.startswith("libtpuft_torch-")
    (src / "comm.h").write_text((src / "comm.h").read_text() + "\n// edited\n")
    edited = native._artifact()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    flagged = native._artifact()
    monkeypatch.setattr(native, "_cpu_target", lambda: "another-cpu")
    other_cpu = native._artifact()
    assert len({base, edited, flagged, other_cpu}) == 4
    assert sorted(p.name for p in native.SOURCE_DIR.iterdir()) == [
        "api.cc", "comm.h", "lighthouse.h", "manager.h", "store.h", "types.h", "wire.h"]


def test_concurrent_processes_build_the_library_once(tmp_path) -> None:
    """Six processes (as many as the test workers) ask for the library at
    once: one compiles, the others wait on the lock and load its file.  A
    stand-in ``g++`` on ``PATH`` logs each compile and takes a second."""
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    bin_dir, build_dir = tmp_path / "bin", tmp_path / "build"
    bin_dir.mkdir()
    log = tmp_path / "compiles.log"
    fake = bin_dir / "g++"
    fake.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        case "$*" in *--help=target*) echo "  -march=                     fake"; exit 0;; esac
        echo compile >> {log}
        sleep 1
        while [ "$#" -gt 1 ]; do shift; done
        echo built > "$1"
        """))
    fake.chmod(0o755)
    repo = Path(__file__).resolve().parents[1]
    script = (f"import sys; sys.path.insert(0, {str(repo)!r}); from pathlib import Path; "
              "from torchft_tpu_torch import native; "
              f"native.BUILD_DIR = Path({str(build_dir)!r}); print(native.build())")
    env = {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}
    procs = [subprocess.Popen([sys.executable, "-c", script], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1 and Path(paths.pop()).read_text() == "built\n"
    assert log.read_text().count("compile") == 1
    assert not list(build_dir.glob("*.tmp"))
