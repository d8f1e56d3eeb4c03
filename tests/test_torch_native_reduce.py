"""The int8 host reduce: the port's numpy path against the JAX package's
default C++ path (``native/quant.h:reduce_rowwise``).

The port reduces with numpy: it divides by the scale and keeps NaN.  The
JAX package takes its C++ tier whenever ``libtpuft.so`` loads; that path
multiplies by ``1/scale`` and builds with ``-march=native``, so its output
scales may differ from numpy's in the last bit.  A mixed quorum still
agrees rank to rank, because each shard is reduced by one rank and then
allgathered.  These tests pin both facts with the JAX package on its default
path (no numpy pin, unlike ``tests/test_torch_collectives.py``), and skip
where the C++ tier does not build.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torchft_tpu.native as jnative
import torchft_tpu.quantization as jq
from torchft_tpu import collectives as jcoll
from torchft_tpu.communicator import TCPCommunicator as JaxTCPCommunicator
from torchft_tpu_torch import collectives as tcoll
from torchft_tpu_torch import quantization as tq
from torchft_tpu_torch.communicator import TCPCommunicator
from torchft_tpu_torch.store import StoreServer

N = 40 * 1024 + 300  # ragged: the last row and the rank shards are padded


@pytest.fixture()
def native_reduce(monkeypatch):
    """The JAX package on its default host path, with its C++ reduce
    counted; skips where ``libtpuft.so`` does not build."""
    if not jnative.available():
        pytest.skip("the JAX package's C++ tier (native/libtpuft.so) is not available")
    monkeypatch.delenv("TORCHFT_QUANT_DEVICE_REDUCE", raising=False)
    monkeypatch.setattr(jq, "_NATIVE", jq._UNRESOLVED)
    calls = []
    reduce_native = jnative.reduce_rowwise_native

    def spy(*args, **kwargs):
        calls.append(1)
        return reduce_native(*args, **kwargs)

    monkeypatch.setattr(jnative, "reduce_rowwise_native", spy)
    return calls


@pytest.mark.parametrize("layout", ["port-jax", "jax-port-port", "jax-jax-port"])
def test_mixed_quorum_with_the_jax_cpp_reduce_gives_equal_bytes(native_reduce, layout) -> None:
    classes = {"port": TCPCommunicator, "jax": JaxTCPCommunicator}
    ranks = [classes[name] for name in layout.split("-")]
    ws = len(ranks)
    data = [
        (np.random.default_rng(70 + r).standard_normal(N) * (r + 1)).astype(np.float32)
        for r in range(ws)
    ]
    server = StoreServer("127.0.0.1:0")

    def one(rank: int) -> np.ndarray:
        comm = ranks[rank](timeout_s=30.0)
        comm.configure(f"127.0.0.1:{server.port}/cpp{layout}", replica_id=f"r{rank}", rank=rank,
                       world_size=ws)
        try:
            coll = tcoll if isinstance(comm, TCPCommunicator) else jcoll
            return coll.allreduce_quantized(comm, [data[rank]], kind="int8").wait()[0]
        finally:
            comm.shutdown()

    try:
        with ThreadPoolExecutor(max_workers=ws) as pool:
            outs = list(pool.map(one, range(ws)))
    finally:
        server.shutdown()
    assert native_reduce, "no JAX rank reduced on its C++ path"
    assert all(np.asarray(o).tobytes() == np.asarray(outs[0]).tobytes() for o in outs)
    np.testing.assert_allclose(outs[0], np.sum(data, axis=0), atol=0.15 * ws * ws)


def test_the_last_bit_difference_of_the_two_reduces_is_pinned(native_reduce) -> None:
    """w=2, one row of 8: equal payloads, and output scales one ulp apart —
    ``0x3FDC01B7`` on the port's numpy path, ``0x3FDC01B6`` on the JAX
    package's C++ path.  A change to either path fails here."""
    qs = np.array([[[38, -97, 87, -59, 104, -127, 108, -2]],
                   [[-127, -32, 6, 28, -100, -113, 20, -47]]], dtype=np.int8)
    scales = np.array([[0.84392703], [0.98326689]], dtype=np.float32)
    port_q, port_s = tq.reduce_quantized(qs, scales)
    jax_q, jax_s = jq.reduce_quantized(qs, scales)
    assert native_reduce, "the JAX package did not take its C++ path"
    assert port_q.tobytes() == jax_q.tobytes()
    assert port_q.tolist() == [[-54, -66, 46, -13, -6, -127, 64, -28]]
    assert port_s.view(np.uint32).tolist() == [0x3FDC01B7]
    assert jax_s.view(np.uint32).tolist() == [0x3FDC01B6]
