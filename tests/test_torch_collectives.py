"""The port's quantized collectives held against the JAX package's.

``allreduce_quantized``, ``reduce_scatter_quantized`` and
``allreduce_prequantized`` run at world sizes 2 and 3 over the port's TCP
communicator, and the JAX package's ``collectives`` run the same inputs over
its own; each result must be bit-identical.  The windowed pipeline is
covered with a small ``TORCHFT_QUANT_WINDOW_MB``, and the device reduce with
``TORCHFT_QUANT_DEVICE_REDUCE=1`` (on a host without a card it reaches the
reduce kernel's plain version).  A mixed quorum — port ranks and JAX ranks
in one ring — ends with equal bytes on every rank.

The JAX package runs its numpy host wire here, reduce included, which the
port follows: its optional C++ tier computes int8 reduce scales that differ
from numpy's in the last bits, and its jnp device reduce scales differ by
an ulp or two (``tests/test_torch_quant.py``).  A mixed quorum agrees
either way: each shard is reduced by one rank and allgathered.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List

import numpy as np
import pytest

import torchft_tpu.quantization as jq
from torchft_tpu import collectives as jcoll
from torchft_tpu.communicator import TCPCommunicator as JaxTCPCommunicator
from torchft_tpu.quantization import quantize_rowwise as jax_quantize
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch.communicator import TCPCommunicator
from torchft_tpu_torch.ops import quant as tops
from torchft_tpu_torch.quantization import quantize_rowwise
from torchft_tpu_torch.store import StoreServer

N = 5 * 1024 + 300  # ragged: the last row and the rank shards are padded


@pytest.fixture(autouse=True)
def numpy_jax_wire(monkeypatch):
    monkeypatch.setattr(jq, "_NATIVE", None)
    monkeypatch.setattr(jcoll, "_use_device_reduce", lambda shard_bytes: False)


@pytest.fixture()
def store():
    server = StoreServer("127.0.0.1:0")
    yield server
    server.shutdown()


def _run_ranks(store, comm_classes, fn: Callable, prefix: str) -> List[object]:
    """``fn(comm, rank)`` on one thread per rank; ``comm_classes[rank]``
    picks each rank's package."""
    ws = len(comm_classes)

    def _one(rank: int) -> object:
        comm = comm_classes[rank](timeout_s=30.0)
        comm.configure(
            f"127.0.0.1:{store.port}/{prefix}", replica_id=f"r{rank}", rank=rank, world_size=ws
        )
        try:
            return fn(comm, rank)
        finally:
            comm.shutdown()

    with ThreadPoolExecutor(max_workers=ws) as pool:
        return list(pool.map(_one, range(ws)))


def _inputs(ws: int) -> List[np.ndarray]:
    return [
        (np.random.default_rng(50 + r).standard_normal(N) * (r + 1)).astype(np.float32)
        for r in range(ws)
    ]


def _both(store, ws, port_fn, jax_fn, tag):
    port = _run_ranks(store, [TCPCommunicator] * ws, port_fn, f"p{tag}")
    ref = _run_ranks(store, [JaxTCPCommunicator] * ws, jax_fn, f"j{tag}")
    return port, ref


def _assert_bit_identical(port, ref) -> None:
    for got, want in zip(port, ref):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.fixture(params=["host-reduce", "device-reduce"])
def reduce_mode(request, monkeypatch):
    """Yields the calls the port made to the reduce kernel's plain version
    (the device path on a host without a card)."""
    device = request.param == "device-reduce"
    monkeypatch.setenv("TORCHFT_QUANT_DEVICE_REDUCE", "1" if device else "0")
    # 4 KiB windows: two rows each, so the 6-row payload walks 3 windows
    monkeypatch.setenv("TORCHFT_QUANT_WINDOW_MB", str(4096 / (1 << 20)))
    calls = []
    plain = tops.reduce_quantized_plain

    def spy(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(tops, "reduce_quantized_plain", spy)
    yield calls
    assert bool(calls) == device


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("ws", [2, 3])
def test_allreduce_quantized_matches_jax(store, reduce_mode, ws, kind) -> None:
    data = _inputs(ws)
    port, ref = _both(
        store, ws,
        lambda c, r: tcoll.allreduce_quantized(c, [data[r], data[r][:700].copy()], kind=kind).wait(),
        lambda c, r: jcoll.allreduce_quantized(c, [data[r], data[r][:700].copy()], kind=kind).wait(),
        f"ar{ws}{kind}",
    )
    for got, want in zip(port, ref):
        _assert_bit_identical(got, want)
    # a quantized sum: within a few int8 / fp8 steps of the true sum
    np.testing.assert_allclose(port[0][0], np.sum(data, axis=0), atol=0.15 * ws * ws)


@pytest.mark.parametrize("ws", [2, 3])
def test_reduce_scatter_quantized_matches_jax(store, reduce_mode, ws) -> None:
    data = _inputs(ws)
    port, ref = _both(
        store, ws,
        lambda c, r: tcoll.reduce_scatter_quantized(c, data[r]).wait(),
        lambda c, r: jcoll.reduce_scatter_quantized(c, data[r]).wait(),
        f"rs{ws}",
    )
    _assert_bit_identical(port, ref)


@pytest.mark.parametrize("ws", [2, 3])
def test_reduce_scatter_quantized_fp8_matches_jax(store, reduce_mode, ws) -> None:
    """The fp8 payload (e4m3 bit patterns in uint8 on the port's host)
    decodes to its values, not to its bytes, in the shard's sum."""
    data = _inputs(ws)
    port, ref = _both(
        store, ws,
        lambda c, r: tcoll.reduce_scatter_quantized(c, data[r], kind="fp8").wait(),
        lambda c, r: jcoll.reduce_scatter_quantized(c, data[r], kind="fp8").wait(),
        f"rs8{ws}",
    )
    _assert_bit_identical(port, ref)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("ws", [2, 3])
def test_allreduce_prequantized_matches_jax(store, reduce_mode, ws, kind) -> None:
    """Payloads quantized as the device path hands them over: rows padded
    to a multiple of 32 (the kernels' geometry)."""
    data = _inputs(ws)
    port_q = [quantize_rowwise(np.pad(d, (0, 32 * 1024 - N)), 1024, kind) for d in data]
    jax_q = [jax_quantize(np.pad(d, (0, 32 * 1024 - N)), 1024, kind) for d in data]
    port, ref = _both(
        store, ws,
        lambda c, r: tcoll.allreduce_prequantized(c, *port_q[r], N),
        lambda c, r: jcoll.allreduce_prequantized(c, *jax_q[r], N),
        f"pq{ws}{kind}",
    )
    _assert_bit_identical(port, ref)
    assert port[0].shape == (N,)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("layout", ["port-jax", "jax-port-port"])
def test_mixed_quorum_prequantized_gives_equal_bytes(store, monkeypatch, layout, kind) -> None:
    """Port and JAX ranks in one ring: the same wire bytes, so every rank
    ends with the same result."""
    monkeypatch.setenv("TORCHFT_QUANT_WINDOW_MB", str(4096 / (1 << 20)))
    classes = {"port": TCPCommunicator, "jax": JaxTCPCommunicator}
    ranks = [classes[name] for name in layout.split("-")]
    data = _inputs(len(ranks))

    def fn(comm, r):
        flat = np.pad(data[r], (0, 32 * 1024 - N))
        if isinstance(comm, TCPCommunicator):
            return tcoll.allreduce_prequantized(comm, *quantize_rowwise(flat, 1024, kind), N)
        return jcoll.allreduce_prequantized(comm, *jax_quantize(flat, 1024, kind), N)

    outs = _run_ranks(store, ranks, fn, f"mx{layout}{kind}")
    assert all(o.tobytes() == outs[0].tobytes() for o in outs)
    np.testing.assert_allclose(outs[0], np.sum(data, axis=0), atol=0.15 * len(ranks) ** 2)


def test_wire_kind_mismatch_is_detected(store) -> None:
    """An int8 rank and an fp8 rank fail loudly on the header's kind tag."""
    data = _inputs(2)

    def fn(comm, r):
        kind = "int8" if r == 0 else "fp8"
        q, s = quantize_rowwise(data[r], 1024, kind)
        with pytest.raises(Exception, match="kind mismatch"):
            tcoll.allreduce_prequantized(comm, q, s, N)
        return True

    assert all(_run_ranks(store, [TCPCommunicator] * 2, fn, "kind"))
