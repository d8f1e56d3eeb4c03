"""The port's data plane held against the JAX package's.

- The port's f32 gradient average over 2 thread replicas is bit-identical to
  ``torchft_tpu.ddp.allreduce_pytree`` on the same gradients, bucket
  boundaries included.
- bf16 gradients travel as bf16 bytes (``torchft_tpu_torch/bf16.py``) and
  are added and divided as ml_dtypes does: the port's average is
  bit-identical to the JAX package's at 2 and at 3 replicas, and a mixed
  quorum (one port replica, one JAX replica) averages bf16 buckets to equal
  bytes.  A genuine ``uint16`` buffer still reduces as an integer.
- A port Manager and a JAX Manager in one quorum allreduce to equal bytes:
  the copied wire still matches.
- The quantized gradient sync runs and averages within the int8 wire's
  tolerance.
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


def _manager(pkg, comm_cls, idx, addr, replicas=2):
    return pkg.Manager(
        comm=comm_cls(timeout_s=20.0),
        load_state_dict=lambda s: None,
        state_dict=lambda: {},
        min_replica_size=replicas,
        replica_id=f"replica_{idx}",
        lighthouse_addr=addr,
        timeout=20.0,
        quorum_timeout=20.0,
        connect_timeout=20.0,
        # no step-0 heal: both replicas participate in the first quorum
        init_sync=False,
    )


def _run_pair(addr, bodies):
    """Run ``bodies[i](manager)`` for each replica in one quorum (the
    lighthouse must want ``len(bodies)`` replicas); each body gets its own
    (package, communicator) pair."""
    barrier = threading.Barrier(len(bodies))

    def _one(i):
        pkg, comm_cls, body = bodies[i]
        manager = _manager(pkg, comm_cls, i, addr, len(bodies))
        try:
            manager.start_quorum()
            out = body(manager)
            assert manager.should_commit()
            barrier.wait(timeout=30)
            return out
        finally:
            manager.shutdown()

    with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
        futures = [pool.submit(_one, i) for i in range(len(bodies))]
        return [f.result(timeout=60) for f in futures]


def _grads(idx, shapes, dtype):
    rng = np.random.default_rng(100 + idx)
    return [rng.standard_normal(s).astype(np.float32).astype(dtype) for s in shapes]


SHAPES = [(17, 5), (300,), (64, 64), (3,), (1000,)]


def _port_body(arrays, torch_dtype, should_quantize=False):
    def body(manager):
        params = [torch.nn.Parameter(torch.zeros(a.shape, dtype=torch_dtype)) for a in arrays]
        for p, a in zip(params, arrays):
            # a copy (bf16 from its f32 widening, exact): averaged in place
            p.grad = torch.tensor(np.asarray(a, dtype=np.float32), dtype=torch_dtype)
        tddp.allreduce_gradients(manager, params, should_quantize=should_quantize).wait()
        return [p.grad.clone() for p in params]

    return body


def _jax_body(arrays):
    return lambda manager: jddp.allreduce_pytree(manager, list(arrays)).wait()


def _port_average(addr, arrays_per_replica, torch_dtype):
    return _run_pair(
        addr,
        [(tmanager, TCPCommunicator, _port_body(a, torch_dtype)) for a in arrays_per_replica],
    )


def _jax_average(addr, arrays_per_replica):
    return _run_pair(
        addr, [(jmanager, JaxTCPCommunicator, _jax_body(a)) for a in arrays_per_replica]
    )


def _assert_bf16_equal(got: torch.Tensor, want) -> None:
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))


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
    """bf16 on the wire, summed and divided as ml_dtypes does: exactly the
    JAX package's bf16 ring sum followed by its bf16 divide."""
    import ml_dtypes  # the JAX package's bf16; the port never imports it

    grads = [_grads(i, SHAPES, ml_dtypes.bfloat16) for i in range(2)]
    port = _port_average(lighthouse.local_address(), grads, torch.bfloat16)
    ref = _jax_average(lighthouse.local_address(), grads)
    for got, want in zip(port[0], ref[0]):
        _assert_bf16_equal(got, want)


def test_bf16_average_is_bit_identical_to_jax_at_three_replicas() -> None:
    """Three replicas round the ring sum to bf16 at every hop: widening to
    f32 for the wire (rounding once) would differ from the JAX package by up
    to one bf16 ulp here."""
    import ml_dtypes

    server = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=3, join_timeout_ms=100,
        quorum_tick_ms=20, heartbeat_timeout_ms=2000,
    )
    try:
        grads = [_grads(i, SHAPES, ml_dtypes.bfloat16) for i in range(3)]
        grads[2][4][:] = np.float32(1.0 / 3.0)  # rounding ties at every hop
        port = _port_average(server.local_address(), grads, torch.bfloat16)
        ref = _jax_average(server.local_address(), grads)
    finally:
        server.shutdown()
    for replica in range(3):
        for got, want in zip(port[replica], ref[replica]):
            _assert_bf16_equal(got, want)
    # and the single-rounding f32 average is not what either computes
    exact = [sum(g[i].astype(np.float32) for g in grads) / 3 for i in range(len(SHAPES))]
    assert any(
        not np.array_equal(np.asarray(e.astype(ml_dtypes.bfloat16)).view(np.int16),
                           got.view(torch.int16).numpy())
        for e, got in zip(exact, port[0])
    )


def test_mixed_quorum_bf16_average_gives_equal_bytes(lighthouse) -> None:
    """A port replica (bf16 ``.grad`` tensors) and a JAX replica (ml_dtypes
    bf16 arrays) average in one quorum: frames of one size, equal bytes."""
    import ml_dtypes

    grads = [_grads(i, SHAPES, ml_dtypes.bfloat16) for i in range(2)]
    outs = _run_pair(
        lighthouse.local_address(),
        [
            (tmanager, TCPCommunicator, _port_body(grads[0], torch.bfloat16)),
            (jmanager, JaxTCPCommunicator, _jax_body(grads[1])),
        ],
    )
    for got, want in zip(*outs):
        _assert_bf16_equal(got, want)


def _bf16_operands():
    """Random bf16 over many decades plus the edges: ±0, ±inf, the largest
    finite value (its sum overflows), NaNs of both signs, rounding ties."""
    import ml_dtypes

    rng = np.random.default_rng(7)
    x = (rng.standard_normal(4096) * np.logspace(-30, 30, 4096)).astype(np.float32)
    y = (rng.standard_normal(4096) * np.logspace(30, -30, 4096)).astype(np.float32)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, 3.3895e38, -3.3895e38, np.nan, -np.nan,
                      1.0, 1.0 + 2.0 ** -8, 3.0, -np.nan], dtype=np.float32)
    x[: edges.size] = edges
    y[: edges.size] = edges[::-1]
    return x.astype(ml_dtypes.bfloat16), y.astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("op", ["add", "add-finite", "div", "scale", "round"])
def test_bf16_host_arithmetic_matches_ml_dtypes(op) -> None:
    """The ring's add, the Manager's divide, the capacity weight and the
    f32 → bf16 cast, bit for bit against ml_dtypes (NaN signs included)."""
    import ml_dtypes
    from torchft_tpu_torch import bf16

    x, y = _bf16_operands()
    if op == "add-finite":  # the one-pass path: no NaN or inf operand
        x, y = np.nan_to_num(x, posinf=0, neginf=0), np.nan_to_num(y, posinf=0, neginf=0)
    ours = x.copy().view(np.uint16).view(bf16.BF16)
    if op.startswith("add"):
        bf16.add_into(ours, np.ascontiguousarray(y).view(np.uint16).view(bf16.BF16))
        got, want = ours, x + y
    elif op == "div":
        got, want = bf16.div(ours, 3), (x / 3).astype(ml_dtypes.bfloat16)
    elif op == "scale":
        got, want = bf16.scale(ours, 0.7), (x * 0.7).astype(ml_dtypes.bfloat16)
    else:
        f = x.astype(np.float32) * np.float32(1.0 + 2.0 ** -9)  # ties and NaN payloads
        got, want = bf16.from_f32(f), f.astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(got.view(np.uint16), np.asarray(want).view(np.uint16))
    np.testing.assert_array_equal(bf16.to_f32(got), np.asarray(want).astype(np.float32))


def test_uint16_buffer_reduces_as_an_integer(lighthouse) -> None:
    """Only the bf16 marker dtype takes the bf16 arithmetic: a genuine
    uint16 buffer sums and floor-divides as integers."""
    data = [np.array([1, 3, 40000, 65535], dtype=np.uint16), np.array([2, 4, 20000, 1], np.uint16)]
    outs = _run_pair(
        lighthouse.local_address(),
        [(tmanager, TCPCommunicator, lambda m, i=i: m.allreduce(data[i].copy()).wait())
         for i in range(2)],
    )
    want = (data[0] + data[1]) // 2  # uint16 wrap-around, as the JAX package
    for out in outs:
        assert out.dtype == np.uint16
        np.testing.assert_array_equal(out, want)


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


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_sync_runs(lighthouse, monkeypatch, kind) -> None:
    """``allreduce_gradients(should_quantize=True)``: quantized by the
    kernel's plain version on CPU tensors, averaged over the quantized wire
    (on the reduce kernel's plain version, forced), copied back.  Both
    replicas end with equal gradients within one wire step per contribution
    (rowwise absmax/127 for int8; e4m3's 2^-3 relative step, absmax/16 at
    worst, for fp8) of the exact average."""
    monkeypatch.setenv("TORCHFT_QUANT_KIND", kind)
    monkeypatch.setenv("TORCHFT_QUANT_DEVICE_REDUCE", "1")
    grads = [_grads(i, SHAPES, np.float32) for i in range(2)]
    outs = _run_pair(
        lighthouse.local_address(),
        [(tmanager, TCPCommunicator, _port_body(g, torch.float32, should_quantize=True))
         for g in grads],
    )
    step = 1 / 127 if kind == "int8" else 1 / 16
    for i, (a, b) in enumerate(zip(*outs)):
        assert torch.equal(a, b)
        exact = (grads[0][i] + grads[1][i]) / 2
        bound = 2 * step * max(np.abs(grads[0][i]).max(), np.abs(grads[1][i]).max())
        np.testing.assert_allclose(a.numpy(), exact, atol=bound, rtol=0)


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

