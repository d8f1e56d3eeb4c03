"""The heal's wire of the port held against the JAX package's, on numpy
inputs from a seed (``torchft_tpu_torch/checkpointing/`` against
``torchft_tpu/checkpointing/``).

The state has every leaf kind a heal carries: bf16, f32, int8 and bool
leaves, an empty one, odd-sized ones, and ones larger than a ring slot that
cross the chunk boundaries.  Each case runs twice: with the port's host
leaves passed through as they are (``host``), and with every tensor leaf
staged through a :class:`StagingRing` of two small slots as a CUDA leaf is
on the card (``ring``; the slots are not pinned on the CPU).

- The served stream: the port's ``PytreePlan.write_range`` gives the JAX
  package's bytes for the whole stream and for every range of the payload
  at ``num_chunks`` 1, 3 and 7.  The two headers differ only in the module
  that names the placeholder classes (each package pickles its own), so
  the skeletons are compared unpickled and the payload byte for byte; an
  HTTP server of each package serves ``/full``, each ``/{i}`` and the
  striped index the same way.
- Heals across the packages: the packages refuse each other's skeleton by
  name (``tests/test_torch_snapshot_isolation.py``); mapped onto each
  other's placeholder classes, a port ``HTTPTransport`` heals from a JAX
  one and a JAX one from a port one bit for bit, at ``num_chunks`` 0, 1, 3
  and 7.
- A chunked heal of a small state (ROADMAP §C26): where the server's chunks
  outnumber the stream's bytes, the last ones start past its end and carry
  nothing.  A port healer at the Manager's ``HEAL_NUM_CHUNKS`` heals every
  server chunk count either package serves (0, 1, 4, 7, 11, 12, 64) to the
  JAX healer's result; at 12 a 50-byte stream's last chunk starts at 55.
- The comm frames: per-array (written in parts) and striped, each the JAX
  package's, through writers held back on purpose (a frame's bytes are
  read only when its send is waited for; a stream's write sleeps before it
  copies): a ring that reused a slot before its write was done would hand
  them another chunk's bytes.
"""

import io
import json
import pickle
import threading
import time
from urllib.request import urlopen

import ml_dtypes
import numpy as np
import pytest
import torch

import torchft_tpu.checkpointing.serialization as jax_serialization
from torchft_tpu.checkpointing.comm_transport import CommTransport as JaxCommTransport
from torchft_tpu.checkpointing.http_transport import HTTPTransport as JaxHTTPTransport
from torchft_tpu_torch.checkpointing import comm_transport
from torchft_tpu_torch.checkpointing import serialization as S
from torchft_tpu_torch.checkpointing.comm_transport import CommTransport
from torchft_tpu_torch.checkpointing.http_transport import HEAL_NUM_CHUNKS, HTTPTransport
from torchft_tpu_torch.communicator import join_parts

STEP = 5
SLOT = 4096  # the ring's slot in the "ring" cases: smaller than the large leaves


def _numpy_state(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((67, 129)).astype(ml_dtypes.bfloat16),  # 17,286 bytes
            "b": rng.standard_normal(1001).astype(np.float32),  # 4,004: one slot and a bit
            "big": rng.standard_normal(5003).astype(np.float32),  # 20,012: 5 slots, ragged
        },
        "q": rng.integers(-128, 128, size=(3, 1025)).astype(np.int8),  # 3,075: odd
        "mask": rng.random(777) < 0.5,  # bool, odd
        "empty": np.zeros((0, 5), np.float32),
        "opt": [rng.standard_normal(33).astype(ml_dtypes.bfloat16), np.array(7, np.int8)],
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


def _leaf_bytes(state) -> list:
    """Each array leaf's raw bytes, in the transports' leaf order."""
    if isinstance(state, torch.Tensor):
        return [state.contiguous().view(-1).view(torch.uint8).numpy().tobytes()]
    if isinstance(state, np.ndarray) or hasattr(state, "__array__"):
        return [np.ascontiguousarray(np.asarray(state)).reshape(-1).view(np.uint8).tobytes()]
    if isinstance(state, dict):
        return [b for v in state.values() for b in _leaf_bytes(v)]
    if isinstance(state, (list, tuple)):
        return [b for v in state for b in _leaf_bytes(v)]
    return []


def _staged_source(leaf):
    """A tensor leaf's bytes as a flat uint8 tensor, which the ring stages
    slot by slot as it does a CUDA leaf's."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous().view(-1).view(torch.uint8)
    return S.as_byte_view(S.materialize_leaf(leaf))


@pytest.fixture(params=["host", "ring"])
def staging(request, monkeypatch) -> str:
    if request.param == "ring":
        monkeypatch.setattr(S, "SEND_SLOT_BYTES", SLOT)
        monkeypatch.setattr(S, "SEND_RING_SLOTS", 2)
        monkeypatch.setattr(S, "_leaf_source", _staged_source)
        monkeypatch.setattr(comm_transport, "_leaf_source", _staged_source)
    return request.param


class _HeldBackWriter:
    """A stream whose every write waits before it copies the bytes."""

    def __init__(self) -> None:
        self.buf = bytearray()

    def write(self, data) -> int:
        time.sleep(0.001)
        self.buf += bytes(data)
        return len(data)


def _served(plan, start: int, stop: int) -> bytes:
    out = _HeldBackWriter()
    plan.write_range(start, stop, out)
    return bytes(out.buf)


def _plans():
    state = _numpy_state()
    jax_plan = jax_serialization.plan_pytree(state, snapshot=True)
    port_plan = S.plan_pytree(_torch_state(state), snapshot=True)
    jax_full, port_full = io.BytesIO(), _served(port_plan, 0, port_plan.total_len)
    jax_plan.write_range(0, jax_plan.total_len, jax_full)
    return jax_plan, port_plan, jax_full.getvalue(), port_full


def _skeleton_repr(header: bytes) -> str:
    """The header's skeleton, unpickled with either package's placeholder
    classes mapped onto the port's (``repr`` names the class alone)."""

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module: str, name: str):
            if module in ("torchft_tpu.checkpointing.serialization", S.__name__):
                return getattr(S, name)
            return super().find_class(module, name)

    skel_len = S.header_len_of(header[: len(S.MAGIC) + 4]) - len(S.MAGIC) - 8
    return repr(_Unpickler(io.BytesIO(header[len(S.MAGIC) + 4:][:skel_len])).load())


def test_full_stream_is_the_jax_packages(staging) -> None:
    jax_plan, port_plan, jax_full, port_full = _plans()
    hj, hp = len(jax_plan.header), len(port_plan.header)
    assert len(port_full) == port_plan.total_len and port_full[:hp] == port_plan.header
    assert port_full[hp:] == jax_full[hj:]
    assert port_plan.leaf_nbytes == jax_plan.leaf_nbytes
    assert 0 in port_plan.leaf_nbytes and max(port_plan.leaf_nbytes) > 4 * SLOT
    assert _skeleton_repr(port_plan.header) == _skeleton_repr(jax_plan.header)
    assert b"torchft_tpu_torch.checkpointing" in port_plan.header
    assert b"torchft_tpu_torch" not in jax_plan.header


@pytest.mark.parametrize("num_chunks", [1, 3, 7])
def test_every_range_is_the_jax_packages(staging, num_chunks) -> None:
    jax_plan, port_plan, jax_full, port_full = _plans()
    hj, hp = len(jax_plan.header), len(port_plan.header)
    # each package's chunks of its own stream, as its server cuts them
    size = -(-port_plan.total_len // num_chunks)
    for i in range(num_chunks):
        start, stop = i * size, min(port_plan.total_len, (i + 1) * size)
        assert _served(port_plan, start, stop) == port_full[start:stop]
    # the payload's ranges, byte for byte the JAX package's
    payload = port_plan.total_len - hp
    assert payload == jax_plan.total_len - hj
    size = -(-payload // num_chunks)
    for i in range(num_chunks):
        a, b = i * size, min(payload, (i + 1) * size)
        out = io.BytesIO()
        jax_plan.write_range(hj + a, hj + b, out)
        assert _served(port_plan, hp + a, hp + b) == out.getvalue() == jax_full[hj + a:hj + b]


def _get(url: str):
    with urlopen(url, timeout=30) as resp:
        return resp.read(), resp.headers


def _serve(transport_cls, state, num_chunks: int):
    t = transport_cls(timeout=30.0, num_chunks=num_chunks)
    t.send_checkpoint([1], STEP, state, 30.0)
    return t, f"http://127.0.0.1:{t.port}/checkpoint/{STEP}"


@pytest.mark.parametrize("num_chunks", [1, 3, 7])
def test_http_servers_serve_the_jax_packages_bytes(staging, num_chunks) -> None:
    state = _numpy_state()
    jax_t, jax_base = _serve(JaxHTTPTransport, state, num_chunks)
    port_t, port_base = _serve(HTTPTransport, _torch_state(state), num_chunks)
    try:
        jax_full, _ = _get(f"{jax_base}/full")
        port_full, headers = _get(f"{port_base}/full")
        hj = S.header_len_of(jax_full[:9])
        hp = S.header_len_of(port_full[:9])
        assert port_full[hp:] == jax_full[hj:]
        assert int(headers["X-Num-Chunks"]) == num_chunks
        assert int(headers["X-Total-Len"]) == len(port_full)
        chunks = [_get(f"{port_base}/{i}")[0] for i in range(num_chunks)]
        assert b"".join(chunks) == port_full
        jax_chunks = [_get(f"{jax_base}/{i}")[0] for i in range(num_chunks)]
        assert b"".join(jax_chunks) == jax_full
        # the striped index: the same units, shifted by the header's length
        jax_index, port_index = (json.loads(_get(f"{b}/index")[0]) for b in (jax_base, port_base))
        shift = hp - hj
        assert port_index["chunks"] == [[a + shift if a else 0, b + shift]
                                        for a, b in jax_index["chunks"]]
        assert port_index["total_len"] == jax_index["total_len"] + shift
    finally:
        jax_t.shutdown()
        port_t.shutdown()


class _JaxPickle:
    """``pickle`` for the JAX package's serialization module, its loads
    mapping the port's placeholder classes onto its own."""

    HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL
    dumps = staticmethod(pickle.dumps)

    @staticmethod
    def loads(data: bytes):
        class _Unpickler(pickle.Unpickler):
            def find_class(self, module: str, name: str):
                if module == S.__name__:
                    module = jax_serialization.__name__
                return super().find_class(module, name)

        return _Unpickler(io.BytesIO(data)).load()


@pytest.fixture()
def mapped_skeletons(monkeypatch) -> None:
    """Each package reads the other's skeleton as its own."""
    find_class = S._SkeletonUnpickler.find_class

    def _port_find_class(self, module: str, name: str):
        if module == jax_serialization.__name__:
            return getattr(S, name)
        return find_class(self, module, name)

    monkeypatch.setattr(S._SkeletonUnpickler, "find_class", _port_find_class)
    monkeypatch.setattr(jax_serialization, "pickle", _JaxPickle)


@pytest.mark.parametrize("num_chunks", [0, 1, 3, 7])
@pytest.mark.parametrize("healer", ["port", "jax"])
def test_http_heals_across_the_packages_bit_for_bit(staging, mapped_skeletons, healer,
                                                    num_chunks) -> None:
    state = _numpy_state()
    source_cls, source_state = ((JaxHTTPTransport, state) if healer == "port"
                                else (HTTPTransport, _torch_state(state)))
    healer_cls = HTTPTransport if healer == "port" else JaxHTTPTransport
    source, _ = _serve(source_cls, source_state, num_chunks)
    client = healer_cls(timeout=30.0, num_chunks=num_chunks)
    try:
        got = client.recv_checkpoint(0, f"http://127.0.0.1:{source.port}", STEP, 30.0)
    finally:
        source.shutdown()
        client.shutdown()
    assert _leaf_bytes(got) == _leaf_bytes(state)
    assert got["torchft"] == state["torchft"]
    if healer == "port":
        assert got["params"]["w"].dtype == torch.bfloat16 and got["mask"].dtype == torch.bool


def _small_state(kind: str) -> dict:
    if kind == "step_only":
        return {"torchft": {"step": STEP}}  # a 50-byte stream
    rng = np.random.default_rng(3)
    return {
        "w": rng.standard_normal(7).astype(np.float32),
        "h": rng.standard_normal(5).astype(ml_dtypes.bfloat16),
        "mask": rng.random(3) < 0.5,
        "torchft": {"step": STEP},
    }


@pytest.mark.parametrize("kind", ["step_only", "arrays"])
@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("num_chunks", [0, 1, 4, 7, 11, 12, 64])
def test_chunked_heal_of_a_small_state_is_the_jax_healers_c26(mapped_skeletons, num_chunks,
                                                              source, kind) -> None:
    state = _small_state(kind)
    source_cls, source_state = ((HTTPTransport, _torch_state(state)) if source == "port"
                                else (JaxHTTPTransport, state))
    server, _ = _serve(source_cls, source_state, num_chunks)
    healers = [HTTPTransport(timeout=30.0, num_chunks=HEAL_NUM_CHUNKS),
               JaxHTTPTransport(timeout=30.0, num_chunks=HEAL_NUM_CHUNKS)]
    try:
        url = f"http://127.0.0.1:{server.port}"
        got, want = (h.recv_checkpoint(0, url, STEP, 30.0) for h in healers)
    finally:
        server.shutdown()
        for h in healers:
            h.shutdown()
    assert _leaf_bytes(got) == _leaf_bytes(want) == _leaf_bytes(state)
    assert got["torchft"] == want["torchft"] == state["torchft"]
    if kind == "arrays":
        assert got["h"].dtype == torch.bfloat16 and got["mask"].dtype == torch.bool


class _Deferred:
    """A send whose bytes are read only when it is waited for."""

    def __init__(self, frames: list, index: int, read) -> None:
        self._frames, self._index, self._read = frames, index, read

    def wait(self, timeout=None):
        self._frames[self._index] = self._frames[self._index][:2] + (self._read(),)
        return len(self._frames[self._index][2])


class _HeldBackComm:
    """Records every frame a transport sends, reading its bytes only when
    the send is waited for: a striped chunk's slot, a per-array frame's
    parts (each released once read).  A striped serve loop's control
    receive reads ("done",)."""

    def __init__(self) -> None:
        self.frames: list = []

    def send_bytes(self, data, dst, tag=0):
        self.frames.append((dst, tag, None))
        view = memoryview(data).cast("B")
        return _Deferred(self.frames, len(self.frames) - 1, lambda: bytes(view))

    def send_frame_parts(self, parts, nbytes, dst, tag=0):
        self.frames.append((dst, tag, None))
        return _Deferred(self.frames, len(self.frames) - 1,
                         lambda: bytes(join_parts(parts, nbytes)))

    def recv_bytes(self, src, tag=0):
        return _Deferred([(None, None, None)], 0, lambda: pickle.dumps(("done",)))


class _Capture(_HeldBackComm):
    """The JAX package's frames, read as they are sent."""

    def send_bytes(self, data, dst, tag=0):
        blob = bytes(memoryview(data).cast("B"))
        self.frames.append((dst, tag, blob))
        return _Deferred(self.frames, len(self.frames) - 1, lambda: blob)

    def recv_bytes(self, src, tag=0):
        return _Deferred([(None, None, None)], 0, lambda: pickle.dumps(("done",)))


@pytest.mark.parametrize("striped", [False, True], ids=["per_array", "striped"])
def test_comm_frames_are_the_jax_packages(staging, monkeypatch, striped) -> None:
    monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", str(1024 / (1 << 20)))  # 1 KiB chunks
    state = _numpy_state()
    frames = {}
    for key, cls, comm, st in (("jax", JaxCommTransport, _Capture(), state),
                               ("port", CommTransport, _HeldBackComm(), _torch_state(state))):
        t = cls(comm, timeout=10.0)
        if striped:
            t.send_checkpoint_striped([1], STEP, st, 10.0, source_index=1, num_sources=2)
        else:
            t.send_checkpoint([1], STEP, st, 10.0)
        frames[key] = comm.frames
    (_, _, jax_meta), *jax_rest = frames["jax"]
    (_, _, port_meta), *port_rest = frames["port"]
    assert [(d, t) for d, t, _ in frames["port"]] == [(d, t) for d, t, _ in frames["jax"]]
    assert len(jax_rest) > 4 and [b for *_, b in port_rest] == [b for *_, b in jax_rest]
    jmeta, pmeta = _JaxPickle.loads(jax_meta), _JaxPickle.loads(port_meta)
    if striped:
        assert pmeta["array_meta"] == jmeta["array_meta"] and pmeta["chunks"] == jmeta["chunks"]
    else:
        assert pmeta[1] == jmeta[1]
        assert [d for d, _ in pmeta[1]] == ["bfloat16", "float32", "float32", "int8", "bool",
                                            "float32", "bfloat16", "int8"]


def test_the_ring_refills_a_slot_only_once_it_is_released() -> None:
    """A consumer holding a chunk keeps its bytes however far the copier
    could run ahead; a released slot is refilled with a later chunk."""
    source = torch.arange(64, dtype=torch.uint8)
    ring = S.StagingRing(slots=2, slot_bytes=8)
    chunks = ring.chunks([(source, 0, 64)])
    view0, release0 = next(chunks)
    view1, release1 = next(chunks)
    time.sleep(0.05)  # room for a copier that does not wait for releases
    assert bytes(view0) == bytes(range(0, 8)) and bytes(view1) == bytes(range(8, 16))
    release0()
    view2, release2 = next(chunks)
    assert bytes(view2) == bytes(range(16, 24))
    assert bytes(view0) == bytes(range(16, 24))  # slot 0 reused, after its release
    release1()
    release2()
    rest = []
    for view, release in chunks:
        rest.append(bytes(view))
        release()
    assert b"".join(rest) == bytes(range(24, 64))


def test_the_ring_passes_host_pieces_through_and_stops_its_copier() -> None:
    source = torch.arange(40, dtype=torch.uint8)
    host = memoryview(b"header")
    ring = S.StagingRing(slots=2, slot_bytes=16)
    out = []
    for view, release in ring.chunks([(host, 1, 5), (source, 3, 40), (host, 0, 0)]):
        out.append(bytes(view))
        release()
    assert out[0] == b"eade" and b"".join(out[1:]) == bytes(range(3, 40))
    # a consumer that stops early stops the copier
    chunks = ring.chunks([(source, 0, 40)])
    next(chunks)
    assert any(t.name == "tpuft_heal_stage" for t in threading.enumerate())
    chunks.close()
    assert not any(t.name == "tpuft_heal_stage" for t in threading.enumerate())


@pytest.mark.parametrize("chunk", [SLOT, 1 << 20], ids=["chunks_cross_leaves", "one_chunk"])
def test_a_save_through_the_ring_is_the_host_paths(monkeypatch, chunk) -> None:
    """``save_pytree`` stages through the same ring: with every tensor leaf
    staged slot by slot, a writer that waits before it copies and the
    digest's threads reading each chunk, the file and the digest are the
    host path's."""
    from torchft_tpu_torch.utils.checkpoint import ChunkDigest

    state = _torch_state(_numpy_state())
    monkeypatch.setattr(S, "CHUNK_BYTES", chunk)
    monkeypatch.setattr(S, "RING_CHUNKS", 2)
    outs = []
    for source in (S._leaf_source, _staged_source):
        monkeypatch.setattr(S, "_leaf_source", source)
        out = _HeldBackWriter()
        with ChunkDigest(workers=2) as digest:
            busy = S.save_pytree(state, out, digest=digest)
            outs.append((bytes(out.buf), digest.hexdigest()))
        assert busy["write_s"] > 0
    assert outs[0] == outs[1]
    assert outs[0][0] == S.dumps_pytree(state)
