"""The port's ``CommTransport`` (``torchft_tpu_torch/checkpointing/comm_transport.py``)
held against the JAX package's (``torchft_tpu/checkpointing/comm_transport.py``).

- Frames: both packages' ``send_checkpoint`` and ``send_checkpoint_striped``
  of one state (bf16, f32 and int64 leaves), recorded by a capturing
  communicator, give the same tags in the same order, bit-identical array
  and chunk frames, and equal ``array_meta`` and chunk index; the pickled
  skeletons differ only in the module that names the placeholder classes,
  and the port refuses the JAX package's (a heal across the packages is
  not supported).
- Round trips over both tiers of the port (``TCPCommunicator``,
  ``CppCommunicator``): in place into ``into``; a two-source striped heal
  with a source killed mid-transfer and its chunks stolen (the Python
  tier's ``heal_drain``); striped heals from one source (the per-array
  path) and from two on each tier (the C++ tier has no ``heal_drain`` and
  drains the sources in turn); a DTensor state over gloo restored as
  ``ShardedHostArray``.
- A 2-replica ``run_fleet(heal_transport="comm")`` with a kill, on each
  tier, ends with the hashes of the HTTP run.
"""

import os
import pickle
import subprocess
import sys
import textwrap
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List

import ml_dtypes
import numpy as np
import pytest
import torch

from torchft_tpu.checkpointing.comm_transport import CommTransport as JaxCommTransport
from torchft_tpu_torch import native, train_ddp
from torchft_tpu_torch.checkpointing.comm_transport import CommTransport
from torchft_tpu_torch.checkpointing.serialization import ShardedHostArray
from torchft_tpu_torch.communicator import TCPCommunicator, join_parts
from torchft_tpu_torch.store import StoreServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
STEP = 5


def _numpy_state(seed: int = 0) -> dict:
    """A state of bf16, f32 and int64 leaves (numpy, the JAX package's
    host form), nested, with a scalar and a non-array entry."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((33, 40)).astype(ml_dtypes.bfloat16),
            "b": rng.standard_normal(17).astype(np.float32),
        },
        "opt": [rng.standard_normal((6, 7)).astype(np.float32), np.array(12, dtype=np.int64)],
        "idx": rng.integers(-(1 << 40), 1 << 40, size=9).astype(np.int64),
        "torchft": {"step": STEP, "batches_committed": 3},
    }


def _torch_state(state):
    """The same state with torch tensor leaves (bf16 through its bits)."""
    if isinstance(state, np.ndarray):
        if state.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(state.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(state.copy())
    if isinstance(state, dict):
        return {k: _torch_state(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_torch_state(v) for v in state]
    return state


def _leaf_bytes(state) -> List[bytes]:
    """Each array leaf's raw bytes, in the transports' leaf order."""
    if isinstance(state, ShardedHostArray):
        return _leaf_bytes(state.local)
    if isinstance(state, torch.Tensor):
        return [state.detach().contiguous().view(-1).view(torch.uint8).numpy().tobytes()]
    if isinstance(state, np.ndarray):
        return [np.ascontiguousarray(state).reshape(-1).view(np.uint8).tobytes()]
    if isinstance(state, dict):
        return [b for v in state.values() for b in _leaf_bytes(v)]
    if isinstance(state, (list, tuple)):
        return [b for v in state for b in _leaf_bytes(v)]
    return []


class _Done:
    def __init__(self, value) -> None:
        self.value = value

    def wait(self, timeout=None):
        return self.value


class _Capture:
    """Records every frame a transport sends: (dst, tag, bytes).  A striped
    serve loop's control receive reads ("done",)."""

    def __init__(self) -> None:
        self.frames = []

    def send_bytes(self, data, dst, tag=0):
        self.frames.append((dst, tag, bytes(memoryview(data).cast("B"))))
        return _Done(len(self.frames[-1][2]))

    def send_frame_parts(self, parts, nbytes, dst, tag=0):
        return self.send_bytes(join_parts(parts, nbytes), dst, tag)

    def recv_bytes(self, src, tag=0):
        return _Done(pickle.dumps(("done",)))


class _Replay:
    """Hands a receiver the frames a capture recorded, by tag."""

    def __init__(self, frames) -> None:
        self.by_tag = {tag: blob for _dst, tag, blob in frames}

    def recv_bytes(self, src, tag=0):
        return _Done(self.by_tag[tag])

    def recv_bytes_into(self, src, out, tag=0):
        blob = self.by_tag[tag]
        out.reshape(-1).view(np.uint8)[: len(blob)] = np.frombuffer(blob, np.uint8)
        return _Done(len(blob))


def _frames(transport_cls, state, striped: bool, monkeypatch):
    monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", str(1024 / (1 << 20)))  # 1 KiB chunks
    comm = _Capture()
    t = transport_cls(comm, timeout=10.0)
    if striped:
        t.send_checkpoint_striped([1], STEP, state, 10.0, source_index=1, num_sources=2)
    else:
        t.send_checkpoint([1], STEP, state, 10.0)
    return comm.frames


@pytest.mark.parametrize("striped", [False, True], ids=["per_array", "striped"])
def test_frames_are_the_jax_packages(monkeypatch, striped) -> None:
    state = _numpy_state()
    jax_frames = _frames(JaxCommTransport, state, striped, monkeypatch)
    port_frames = _frames(CommTransport, _torch_state(state), striped, monkeypatch)
    assert [(d, t) for d, t, _ in port_frames] == [(d, t) for d, t, _ in jax_frames]
    (_, _, jax_meta), *jax_rest = jax_frames
    (_, _, port_meta), *port_rest = port_frames
    # array (or chunk) frames bit for bit; the striped share is non-empty
    assert jax_rest and [b for *_, b in port_rest] == [b for *_, b in jax_rest]
    jmeta, pmeta = pickle.loads(jax_meta), pickle.loads(port_meta)
    if striped:
        assert pmeta["array_meta"] == jmeta["array_meta"]
        assert pmeta["chunks"] == jmeta["chunks"] and len(jmeta["chunks"]) > 4
        jskel, pskel = jmeta["skeleton"], pmeta["skeleton"]
    else:
        (jskel, jarrays), (pskel, parrays) = jmeta, pmeta
        assert parrays == jarrays
        assert [d for d, _ in parrays] == ["bfloat16", "float32", "float32", "int64", "int64"]
    # the skeletons differ only in the placeholder classes' module
    assert repr(pskel) == repr(jskel)
    assert b"torchft_tpu_torch.checkpointing" in port_meta
    assert b"torchft_tpu_torch" not in jax_meta


def test_port_refuses_the_jax_packages_checkpoint(monkeypatch) -> None:
    frames = _frames(JaxCommTransport, _numpy_state(), False, monkeypatch)
    with pytest.raises(ValueError, match="JAX package"):
        CommTransport(_Replay(frames)).recv_checkpoint(0, "<comm>", STEP, 10.0)


def test_replayed_port_frames_restore_the_state(monkeypatch) -> None:
    state = _torch_state(_numpy_state())
    frames = _frames(CommTransport, state, False, monkeypatch)
    t = CommTransport(_Replay(frames))
    got = t.recv_checkpoint(0, "<comm>", STEP, 10.0)
    assert _leaf_bytes(got) == _leaf_bytes(state)
    assert got["params"]["w"].dtype == torch.bfloat16 and got["torchft"]["step"] == STEP
    assert t.last_heal_metrics.bytes_total == sum(len(b) for b in _leaf_bytes(state))


# ---------------------------------------------------------------------------
# round trips over real communicators
# ---------------------------------------------------------------------------

TIERS = {
    "python": lambda: TCPCommunicator(timeout_s=20.0),
    "cpp": lambda: native.CppCommunicator(timeout_s=20.0),
}


def _group(tier: str, fns: List[Callable]) -> list:
    """Run one callable per rank over a configured communicator of
    ``tier``, ranks as threads."""
    if tier == "cpp":
        assert native.available(), native._lib_error
    store = StoreServer("127.0.0.1:0")
    comms = [TIERS[tier]() for _ in fns]

    def _run(rank: int):
        comms[rank].configure(f"127.0.0.1:{store.port}/ct_{tier}", replica_id=f"r{rank}",
                              rank=rank, world_size=len(fns))
        try:
            return fns[rank](comms[rank])
        finally:
            comms[rank].shutdown()

    try:
        with ThreadPoolExecutor(max_workers=len(fns)) as pool:
            return [f.result(timeout=60) for f in [pool.submit(_run, r) for r in range(len(fns))]]
    finally:
        store.shutdown()


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_round_trip_lands_in_place(tier) -> None:
    state = _torch_state(_numpy_state())
    landing = _torch_state(_numpy_state(seed=1))
    landing["opt"][0] = landing["opt"][0].t()  # not contiguous: a fresh buffer
    buffers = [landing["params"]["w"], landing["params"]["b"], landing["idx"]]

    def _send(comm):
        CommTransport(comm).send_checkpoint([1], STEP, state, 20.0)

    def _recv(comm):
        t = CommTransport(comm)
        return t.recv_checkpoint(0, "<comm>", STEP, 20.0, into=landing), t.last_heal_metrics

    _, (got, metrics) = _group(tier, [_send, _recv])
    assert _leaf_bytes(got) == _leaf_bytes(state)
    assert [got["params"]["w"], got["params"]["b"], got["idx"]] == buffers  # the same tensors
    assert all(a is b for a, b in zip([got["params"]["w"], got["params"]["b"], got["idx"]],
                                      buffers))
    assert got["opt"][0] is not landing["opt"][0]
    assert metrics.num_sources == 1 and metrics.per_source_bytes == {"rank0": metrics.bytes_total}


def _big_state() -> dict:
    rng = np.random.default_rng(3)
    return {"a": torch.from_numpy(rng.standard_normal((256, 1024)).astype(np.float32)),
            "b": _torch_state(rng.standard_normal((300, 700)).astype(ml_dtypes.bfloat16)),
            "c": torch.arange(5000, dtype=torch.int64)}


def test_two_source_striped_heal_steals_a_dead_sources_chunks(monkeypatch) -> None:
    """Source 1 aborts its communicator a few chunks in; the healer
    re-requests its chunks from source 0 over the control channel and
    still assembles the state bit for bit (the Python tier's heal_drain)."""
    monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", "0.0625")  # 64 KiB
    state = _big_state()
    fired = threading.Event()

    def _source(idx):
        def _run(comm):
            t = CommTransport(comm, timeout=20.0)
            if idx == 1:
                t.chaos_die_after_bytes = 1 << 18
                with pytest.raises(Exception):
                    t.send_checkpoint_striped([2], STEP, state, 20.0, source_index=1,
                                              num_sources=2)
                assert t.chaos_fired.is_set()
                fired.set()
            else:
                t.send_checkpoint_striped([2], STEP, state, 20.0, source_index=0, num_sources=2)

        return _run

    def _healer(comm):
        t = CommTransport(comm, timeout=20.0)
        return t.recv_checkpoint_striped([(0, "<comm>"), (1, "<comm>")], STEP, 20.0), \
            t.last_heal_metrics

    *_, (got, m) = _group("python", [_source(0), _source(1), _healer])
    assert fired.is_set()
    assert _leaf_bytes(got) == _leaf_bytes(state)
    assert m.num_sources == 2 and m.failed_sources == ["rank1"] and m.stolen_chunks >= 1
    assert sum(m.per_source_bytes.values()) == m.bytes_total == sum(map(len, _leaf_bytes(state)))


@pytest.mark.parametrize("sources", [1, 2])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_striped_heal_on_each_tier(monkeypatch, tier, sources) -> None:
    """One source: the striped call takes the per-array path (what a quorum
    with one up-to-date peer runs).  Two sources, each serving its striped
    share: the Python tier drains them concurrently (heal_drain); the C++
    tier has no heal_drain and drains them one after another (the JAX
    package's fallback there reads per-array frames from a source that
    sends chunks, and fails on the tag)."""
    monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", "0.0625")
    state = _big_state()

    def _src(idx):
        return lambda comm: CommTransport(comm).send_checkpoint_striped(
            [sources], STEP, state, 20.0, source_index=idx, num_sources=sources)

    def _healer(comm):
        t = CommTransport(comm, timeout=20.0)
        got = t.recv_checkpoint_striped([(r, "<comm>") for r in range(sources)], STEP, 20.0)
        return got, t.last_heal_metrics

    *_, (got, m) = _group(tier, [_src(i) for i in range(sources)] + [_healer])
    assert _leaf_bytes(got) == _leaf_bytes(state)
    assert m.num_sources == sources and m.failed_sources == [] and m.stolen_chunks == 0
    assert set(m.per_source_bytes) == {f"rank{r}" for r in range(sources)}
    assert sum(m.per_source_bytes.values()) == m.bytes_total == sum(map(len, _leaf_bytes(state)))


def test_dtensor_state_heals_as_sharded_host_arrays() -> None:
    """In a one-rank gloo world: a state of DTensors (an FSDP2 parameter
    and its AdamW moment) crosses the transport as its local shards with
    their layout, comes back as ShardedHostArray, and restores into
    DTensors of the same layout bit for bit."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from concurrent.futures import ThreadPoolExecutor
        import torch
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Shard, distribute_tensor
        from torchft_tpu_torch.checkpointing.comm_transport import CommTransport
        from torchft_tpu_torch.checkpointing.serialization import ShardedHostArray
        from torchft_tpu_torch.communicator import TCPCommunicator
        from torchft_tpu_torch.ddp import restore_tree_like
        from torchft_tpu_torch.parallel.mesh import make_mesh
        from torchft_tpu_torch.store import StoreServer
        from torchft_tpu_torch.train_hsdp import _free_port

        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{_free_port()}}",
                                rank=0, world_size=1)
        mesh = make_mesh(fsdp=1)["fsdp"]
        gen = torch.Generator().manual_seed(0)
        def state():
            return {{"w": distribute_tensor(torch.randn(8, 6, generator=gen), mesh, [Shard(0)]),
                     "m": distribute_tensor(torch.randn(8, 6, generator=gen).bfloat16(), mesh,
                                            [Shard(0)])}}
        src, dst = state(), state()
        store = StoreServer("127.0.0.1:0")
        comms = [TCPCommunicator(timeout_s=20.0) for _ in range(2)]
        def run(rank):
            comms[rank].configure(f"127.0.0.1:{{store.port}}/dt", replica_id=f"r{{rank}}",
                                  rank=rank, world_size=2)
            t = CommTransport(comms[rank])
            if rank == 0:
                return t.send_checkpoint([1], 3, src, 20.0)
            return t.recv_checkpoint(0, "<comm>", 3, 20.0)
        with ThreadPoolExecutor(2) as pool:
            _, got = [f.result(timeout=60) for f in [pool.submit(run, r) for r in range(2)]]
        for c in comms:
            c.shutdown()
        store.shutdown()
        assert all(isinstance(v, ShardedHostArray) for v in got.values()), got
        assert got["w"].shape == (8, 6) and got["m"].dtype == "bfloat16"
        restore_tree_like(got, dst)
        for k in src:
            assert isinstance(dst[k], DTensor)
            assert torch.equal(dst[k].to_local().view(torch.uint8), src[k].to_local().view(torch.uint8))
        dist.destroy_process_group()
        print("SHARDED_OK")
        """
    )
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0 and "SHARDED_OK" in proc.stdout, proc.stdout + proc.stderr[-4000:]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_fleet_heals_over_comm_with_the_hashes_of_http(tier) -> None:
    if tier == "cpp":
        assert native.available(), native._lib_error
    cfg = train_ddp.model_config("llama_debug")
    runs = {
        transport: train_ddp.run_fleet(cfg, CPU, steps=4, seq=128, batch=2, lr=1e-3,
                                       kill_at=(1, 2), timeout=30.0, tier=tier,
                                       heal_transport=transport)
        for transport in ("http", "comm")
    }
    for transport, results in runs.items():
        assert [r.final_step for r in results] == [4, 4]
        assert [r.restarts for r in results] == [0, 1]
        assert len({r.params_sha256 for r in results}) == 1
    assert runs["comm"][0].params_sha256 == runs["http"][0].params_sha256
    comm_heal, http_heal = runs["comm"][1].heal, runs["http"][1].heal
    # comm counts the array payload; HTTP adds its stream's framing
    assert comm_heal.bytes_total == runs["comm"][1].state_bytes == runs["http"][1].state_bytes
    assert http_heal.bytes_total > comm_heal.bytes_total
    assert comm_heal.per_source_bytes == {"rank0": comm_heal.bytes_total}


def test_heal_transport_names_the_managers_transport() -> None:
    """``--heal-transport``: "comm" builds a CommTransport on the
    replica's own communicator, "http" leaves the Manager's default."""
    comm = TCPCommunicator(timeout_s=5.0)
    t = train_ddp.heal_transport_for("comm", comm)
    assert isinstance(t, CommTransport) and t._comm is comm and t.metadata() == "<comm>"
    assert train_ddp.heal_transport_for("http", comm) is None
    with pytest.raises(ValueError, match="heal transport"):
        train_ddp.heal_transport_for("tcp", comm)
    comm.shutdown()


def test_jax_cpp_tier_striped_fallback_fails_where_the_port_drains(monkeypatch) -> None:
    """Why the port's C++-tier striped heal drains each source: the JAX
    package's healer there (``comm_transport.py:479-497``) falls back to a
    per-array receive from one source while both sources send their
    striped chunk frames, and fails on the tag."""
    import torchft_tpu.native as jnative

    if not jnative.available():
        pytest.skip("the JAX package's C++ tier (native/libtpuft.so) is not available")
    monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", "0.0625")
    state = {"a": np.random.default_rng(0).standard_normal((256, 1024)).astype(np.float32)}
    store = jnative.CppStoreServer("127.0.0.1:0")
    comms = [jnative.CppCommunicator(timeout_s=3.0) for _ in range(3)]

    def _run(rank: int):
        comms[rank].configure(f"127.0.0.1:{store.port}/jaxfb", replica_id=f"r{rank}", rank=rank,
                              world_size=3)
        t = JaxCommTransport(comms[rank], timeout=3.0)
        try:
            if rank < 2:
                return t.send_checkpoint_striped([2], STEP, state, 3.0, source_index=rank,
                                                 num_sources=2)
            return t.recv_checkpoint_striped([(0, "<comm>"), (1, "<comm>")], STEP, 3.0)
        except Exception as e:  # noqa: BLE001 — the outcome under test
            return e
        finally:
            comms[rank].shutdown()

    try:
        with ThreadPoolExecutor(max_workers=3) as pool:
            healed = [f.result(timeout=60) for f in [pool.submit(_run, r) for r in range(3)]][2]
    finally:
        store.shutdown()
    assert isinstance(healed, Exception) and "tag mismatch" in str(healed)
