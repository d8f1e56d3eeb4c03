"""The port's data plane held against the JAX package's.

- The port's f32 gradient average over 2 thread replicas is bit-identical to
  ``torchft_tpu.ddp.allreduce_pytree`` on the same gradients, bucket
  boundaries included.
- bf16 gradients travel widened to f32 (the port's choice, see
  ``torchft_tpu_torch/ddp.py``): with 2 replicas the result equals the JAX
  package's ml_dtypes bf16 average exactly.
- A port Manager and a JAX Manager in one quorum allreduce to equal bytes:
  the copied wire still matches.
- bf16 tensors serialize without an extension dtype.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu import ddp as jddp
from torchft_tpu import manager as jmanager
from torchft_tpu.communicator import TCPCommunicator as JaxTCPCommunicator
from torchft_tpu_torch import ddp as tddp
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch.checkpointing.serialization import dumps_pytree, loads_pytree
from torchft_tpu_torch.communicator import TCPCommunicator
from torchft_tpu_torch.lighthouse import LighthouseServer


@pytest.fixture()
def lighthouse():
    server = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=100,
        quorum_tick_ms=20, heartbeat_timeout_ms=2000,
    )
    yield server
    server.shutdown()


def _manager(pkg, comm_cls, idx, addr):
    return pkg.Manager(
        comm=comm_cls(timeout_s=20.0),
        load_state_dict=lambda s: None,
        state_dict=lambda: {},
        min_replica_size=2,
        replica_id=f"replica_{idx}",
        lighthouse_addr=addr,
        timeout=20.0,
        quorum_timeout=20.0,
        connect_timeout=20.0,
        # no step-0 heal: both replicas participate in the first quorum
        init_sync=False,
    )


def _run_pair(addr, bodies):
    """Run ``bodies[i](manager)`` for two replicas in one quorum; each body
    gets its own (package, communicator) pair."""
    barrier = threading.Barrier(2)

    def _one(i):
        pkg, comm_cls, body = bodies[i]
        manager = _manager(pkg, comm_cls, i, addr)
        try:
            manager.start_quorum()
            out = body(manager)
            assert manager.should_commit()
            barrier.wait(timeout=30)
            return out
        finally:
            manager.shutdown()

    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = [pool.submit(_one, i) for i in range(2)]
        return [f.result(timeout=60) for f in futures]


def _grads(idx, shapes, dtype):
    rng = np.random.default_rng(100 + idx)
    return [rng.standard_normal(s).astype(np.float32).astype(dtype) for s in shapes]


SHAPES = [(17, 5), (300,), (64, 64), (3,), (1000,)]


def _port_average(addr, arrays_per_replica, torch_dtype):
    def body_for(arrays):
        def body(manager):
            params = [torch.nn.Parameter(torch.zeros(a.shape, dtype=torch_dtype)) for a in arrays]
            for p, a in zip(params, arrays):
                p.grad = torch.tensor(a, dtype=torch_dtype)  # a copy: averaged in place
            tddp.allreduce_gradients(manager, params).wait()
            return [p.grad.clone() for p in params]

        return body

    return _run_pair(
        addr, [(tmanager, TCPCommunicator, body_for(a)) for a in arrays_per_replica]
    )


def _jax_average(addr, arrays_per_replica):
    def body_for(arrays):
        return lambda manager: jddp.allreduce_pytree(manager, list(arrays)).wait()

    return _run_pair(
        addr, [(jmanager, JaxTCPCommunicator, body_for(a)) for a in arrays_per_replica]
    )


@pytest.mark.parametrize("bucket_mb", [None, "0.004"], ids=["one-bucket", "many-buckets"])
def test_f32_average_is_bit_identical_to_jax(lighthouse, monkeypatch, bucket_mb) -> None:
    if bucket_mb is not None:
        monkeypatch.setenv("TORCHFT_BUCKET_CAP_MB", bucket_mb)
    grads = [_grads(i, SHAPES, np.float32) for i in range(2)]
    port = _port_average(lighthouse.local_address(), grads, torch.float32)
    ref = _jax_average(lighthouse.local_address(), grads)
    for replica in range(2):
        for got, want in zip(port[replica], ref[replica]):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    expected = [(a + b) / 2 for a, b in zip(*grads)]
    np.testing.assert_allclose(port[0][2].numpy(), expected[2], rtol=1e-6)


def test_bf16_average_equals_jax_at_two_replicas(lighthouse) -> None:
    """Widened to f32 on the wire, rounded back once: with two replicas this
    is exactly the JAX package's bf16 ring sum followed by its bf16 divide."""
    import ml_dtypes  # the JAX package's bf16; the port never imports it

    grads = [_grads(i, SHAPES, ml_dtypes.bfloat16) for i in range(2)]
    as_f32 = [[g.astype(np.float32) for g in gs] for gs in grads]
    port = _port_average(lighthouse.local_address(), as_f32, torch.bfloat16)
    ref = _jax_average(lighthouse.local_address(), grads)
    for got, want in zip(port[0], ref[0]):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(), np.asarray(want).view(np.int16)
        )


def test_mixed_quorum_allreduce_gives_equal_bytes(lighthouse) -> None:
    """One port replica and one JAX replica in one quorum: the copied
    control plane and ring speak the same bytes."""
    data = [np.random.default_rng(i).standard_normal(4099).astype(np.float32) for i in range(2)]
    outs = _run_pair(
        lighthouse.local_address(),
        [
            (tmanager, TCPCommunicator, lambda m: m.allreduce(data[0].copy()).wait()),
            (jmanager, JaxTCPCommunicator, lambda m: m.allreduce(data[1].copy()).wait()),
        ],
    )
    assert outs[0].tobytes() == outs[1].tobytes()
    np.testing.assert_allclose(outs[0], (data[0] + data[1]) / 2, rtol=1e-6)


def test_quantized_sync_is_not_ported_yet() -> None:
    with pytest.raises(NotImplementedError, match="later slice"):
        tddp.allreduce_gradients(object(), [], should_quantize=True)


def test_bucket_boundaries_match_jax() -> None:
    """The dtype grouping and greedy byte split of ``allreduce_pytree``."""
    nbytes = [40, 40, 8, 100, 16, 30]
    dtypes = ["f32", "f32", "bf16", "f32", "bf16", "f32"]
    assert tddp.bucket_groups(nbytes, dtypes, 80) == [[0, 1], [3], [5], [2, 4]]
    assert tddp.bucket_groups(nbytes, dtypes, 1 << 20) == [[0, 1, 3, 5], [2, 4]]


def test_bf16_tensors_serialize_by_bit_pattern() -> None:
    state = {
        "w": torch.randn(7, 3).to(torch.bfloat16),
        "step": torch.tensor(3, dtype=torch.int64),
        "mask": torch.tensor([True, False]),
        "np": np.arange(4, dtype=np.float32),
        "meta": [1, "x", (2.5, None)],
    }
    out = loads_pytree(dumps_pytree(state))
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16), state["w"].view(torch.int16))
    assert torch.equal(out["step"], state["step"]) and torch.equal(out["mask"], state["mask"])
    np.testing.assert_array_equal(out["np"].numpy(), state["np"])
    assert out["meta"] == state["meta"]

