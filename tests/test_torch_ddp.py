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

import json
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from unittest import mock

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


@pytest.mark.parametrize("call", ["average_gradients", "average_gradients_async"])
def test_ddp_facade_averages_like_jax(lighthouse, call) -> None:
    """``DistributedDataParallel``'s two calls give the JAX facade's f32
    average bit for bit (the async one once its work is waited on)."""
    grads = [_grads(i, SHAPES, np.float32) for i in range(2)]

    def body(arrays):
        def run(manager):
            tensors = [torch.from_numpy(a.copy()) for a in arrays]
            out = getattr(tddp.DistributedDataParallel(manager), call)(tensors)
            if call == "average_gradients_async":
                out.wait()
                out = tensors
            return [t.clone() for t in out]

        return run

    port = _run_pair(lighthouse.local_address(),
                     [(tmanager, TCPCommunicator, body(a)) for a in grads])
    ref = _jax_average(lighthouse.local_address(), grads)
    for replica in range(2):
        for got, want in zip(port[replica], ref[replica]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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



# --- the average on the card: the summed bucket divided into the leaves ---


def _with_specials(grads, idx):
    """NaNs of both signs and ±inf in two leaves of replica ``idx``'s
    gradients (its other leaves untouched): every replica's NaN and inf
    reach the sum, and a NaN's sign rides the ring's adds."""
    out = [g.copy() for g in grads]
    flat = out[1].reshape(-1)
    flat[idx * 3 : idx * 3 + 3] = np.array([np.nan, np.inf, -np.inf], np.float32).astype(flat.dtype)
    out[4].reshape(-1)[7 + idx] = -np.nan if idx % 2 else np.nan
    return out


def _port_bits_body(arrays):
    """:func:`_port_body` with each gradient built from the array's own
    bits (a cast through f32 would rewrite bf16 NaN payloads)."""

    def body(manager):
        grads = [torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)
                 if a.dtype.itemsize == 2 else torch.from_numpy(a.copy()) for a in arrays]
        params = [torch.nn.Parameter(torch.zeros_like(g)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = g
        tddp.allreduce_gradients(manager, params).wait()
        return [p.grad.clone() for p in params]

    return body


@pytest.mark.parametrize("replicas", [2, 3])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_card_average_is_bit_identical_to_jax_with_nan_and_inf(dtype, replicas) -> None:
    """The gradient path divides each summed bucket with ``ops.avg`` (its
    plain version on CPU tensors) and writes it into the ``.grad`` leaves:
    bit for bit the JAX package's ring sum and host divide, NaN payloads
    and ±inf included, at 2 and 3 replicas and with many buckets."""
    import ml_dtypes

    np_dtype, torch_dtype = ((ml_dtypes.bfloat16, torch.bfloat16) if dtype == "bf16"
                             else (np.float32, torch.float32))
    server = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=replicas, join_timeout_ms=100,
        quorum_tick_ms=20, heartbeat_timeout_ms=2000,
    )
    try:
        grads = [_with_specials(_grads(i, SHAPES, np_dtype), i) for i in range(replicas)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TORCHFT_BUCKET_CAP_MB", "0.004")
            port = _run_pair(server.local_address(),
                             [(tmanager, TCPCommunicator, _port_bits_body(a)) for a in grads])
            ref = _jax_average(server.local_address(), grads)
    finally:
        server.shutdown()
    for replica in range(replicas):
        for got, want in zip(port[replica], ref[replica]):
            assert got.dtype == torch_dtype
            bits = (torch.int16, np.int16) if dtype == "bf16" else (torch.int32, np.int32)
            np.testing.assert_array_equal(got.view(bits[0]).numpy(),
                                          np.asarray(want).view(bits[1]))
    assert torch.isnan(port[0][1]).any() and torch.isinf(port[0][1]).any()


def _gated(manager, gate):
    """``manager.allreduce`` whose Works complete only once ``gate`` is set
    (the ring itself runs at once): a composite that stays busy."""
    from torchft_tpu_torch.work import Work

    original = manager.allreduce

    def allreduce(*args, **kwargs):
        inner = original(*args, **kwargs)
        out = Future()

        def _release():
            gate.wait(timeout=30)
            try:
                out.set_result(inner.wait())
            except BaseException as e:  # noqa: BLE001
                out.set_exception(e)

        threading.Thread(target=_release, daemon=True).start()
        return Work(out)

    manager.allreduce = allreduce


@pytest.mark.parametrize("busy", [False, True], ids=["fenced", "still-reading"])
def test_second_step_does_not_overwrite_the_first_steps_buckets(lighthouse, busy) -> None:
    """Two gradient averages in a row on one Manager, the second staged
    after the first was fenced, or while the first composite still reads
    its buckets (its Works held open): the second step's host buckets
    share no memory with the first's while those are read, and both
    averages are exact."""
    grads = [[_grads(i, SHAPES, np.float32), _grads(i + 5, SHAPES, np.float32)]
             for i in range(2)]
    submit = tddp._submit_buckets

    def body(steps):
        def run(manager):
            params = [torch.nn.Parameter(torch.zeros(a.shape)) for a in steps[0]]
            outs = []
            gate = threading.Event()
            if busy:
                _gated(manager, gate)
            works = []
            for arrays in steps:
                for p, a in zip(params, arrays):
                    p.grad = torch.from_numpy(a.copy())
                works.append(tddp.allreduce_gradients(manager, params))
                if not busy:
                    works[-1].wait()
                    outs.append([p.grad.clone() for p in params])
                    if len(outs) == 1:
                        assert manager.should_commit()
                        manager.start_quorum()
            if busy:
                gate.set()
                outs = [[g.clone() for g in w.wait()] for w in works]
            return outs

        return run

    seen: dict = {}  # manager -> per step, the (start, end) of each host bucket

    def recording(manager, *args, **kwargs):
        out = submit(manager, *args, **kwargs)
        seen.setdefault(id(manager), []).append(
            [(h.data_ptr(), h.data_ptr() + h.numel() * h.element_size()) for h in out[2]])
        return out

    with mock.patch.object(tddp, "_submit_buckets", recording):
        results = _run_pair(lighthouse.local_address(),
                            [(tmanager, TCPCommunicator, body(g)) for g in grads])
    assert sorted(len(steps) for steps in seen.values()) == [2, 2]
    if busy:
        for first, second in seen.values():
            assert not any(a0 < b1 and b0 < a1 for a0, a1 in first for b0, b1 in second)
    for outs in results:
        for step, got in enumerate(outs):
            for leaf, g in enumerate(got):
                want = (grads[0][step][leaf] + grads[1][step][leaf]) / np.float32(2)
                np.testing.assert_array_equal(g.numpy(), want)


def _avg_operands():
    """bf16 sums over many decades with the edges: ±0, ±inf, the largest
    finite, NaNs of both signs, a NaN with a payload, subnormals."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) * np.logspace(-40, 38, 4096)).astype(np.float32)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, 3.3895e38, -3.3895e38, np.nan, -np.nan,
                      1e-39, -1e-40, 3.0, 1.0 + 2.0 ** -8], dtype=np.float32)
    x[: edges.size] = edges
    bits = x.view(np.uint32)
    bits[20] = 0x7FA00001  # a signaling NaN with a payload
    bits[21] = 0xFFC12345  # a quiet negative NaN with a payload
    return x


@pytest.mark.parametrize("divisor", [1, 2, 3, 7])
@pytest.mark.parametrize("src, dst", [("bf16", "bf16"), ("f32", "f32"), ("f32", "bf16")])
def test_average_into_plain_matches_the_host_divide(src, dst, divisor) -> None:
    """``ops.avg``'s plain version (the kernel's arithmetic) against the
    host's divide: ``bf16.div`` for bf16 sums (ml_dtypes' divide, NaN
    signs included), numpy's f32 division for f32 (its NaN made quiet,
    sign and payload kept), and that f32 quotient rounded as ml_dtypes
    rounds it for the int8 path's bf16 leaves."""
    import ml_dtypes
    from torchft_tpu_torch import bf16
    from torchft_tpu_torch.ops import avg

    x = _avg_operands()
    if src == "bf16":
        with np.errstate(invalid="ignore"):
            x = x.astype(ml_dtypes.bfloat16)
        src_t = torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)
        want = bf16.div(np.asarray(x).view(np.uint16).view(bf16.BF16), divisor).view(np.uint16)
    else:
        src_t = torch.from_numpy(x.copy())
        with np.errstate(invalid="ignore"):
            quotient = x / np.float32(divisor)
        want = (quotient if dst == "f32" else quotient.astype(ml_dtypes.bfloat16))
        want = np.asarray(want).view(np.uint32 if dst == "f32" else np.uint16)
    out = torch.empty(x.size, dtype=torch.bfloat16 if dst == "bf16" else torch.float32)
    avg.average_into(src_t, divisor, out)
    got = out.view(torch.int16 if dst == "bf16" else torch.int32).numpy()
    np.testing.assert_array_equal(got.view(want.dtype), want)
    assert avg.launches["avg"] == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("piece", [None, 1000], ids=["one-piece", "pieces-of-1000"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_int8_average_matches_the_host_wire_bit_for_bit(lighthouse, monkeypatch, kind,
                                                        piece) -> None:
    """The quantized gradient path dequantizes the reduced stream and
    divides it on the card (the plain versions here), piece by piece (rows
    from a multiple of 4, pieces that split leaves and rows): bit for bit
    the JAX package's host wire (``quantize_rowwise`` / ``reduce_quantized``
    / ``dequantize_rowwise`` on its numpy path, which the golden fixture
    pins) followed by its f32 divide and a round to each leaf's dtype."""
    import ml_dtypes

    import torchft_tpu.quantization as jq

    monkeypatch.setattr(jq, "_NATIVE", None)
    if piece is not None:
        monkeypatch.setattr(tddp, "_DEQUANT_PIECE", piece)
    monkeypatch.setenv("TORCHFT_QUANT_KIND", kind)
    with open(os.path.join(os.path.dirname(__file__), "fixtures", "quant_wire_golden.json")) as f:
        golden = json.load(f)
    rng = np.random.default_rng(42)
    fixture_input = (rng.normal(size=512) * np.logspace(-2, 2, 512)).astype(np.float32)
    q, s = jq.quantize_rowwise(fixture_input, row_size=128, kind=kind)
    assert np.asarray(q).view(np.uint8).reshape(-1).tolist() == golden[kind]["payload"]
    assert s.astype(float).tolist() == golden[kind]["scales"]

    dtypes = [torch.bfloat16, torch.float32, torch.bfloat16, torch.float32, torch.bfloat16]
    grads = [_grads(i, SHAPES, np.float32) for i in range(2)]
    grads[0][4][:512] = fixture_input

    def body(arrays):
        def run(manager):
            params = [torch.nn.Parameter(torch.zeros(a.shape, dtype=d))
                      for a, d in zip(arrays, dtypes)]
            for p, a, d in zip(params, arrays, dtypes):
                p.grad = torch.from_numpy(a.copy()).to(d)
            tddp.allreduce_gradients(manager, params, should_quantize=True).wait()
            return [p.grad.clone() for p in params]

        return run

    outs = _run_pair(lighthouse.local_address(),
                     [(tmanager, TCPCommunicator, body(g)) for g in grads])
    wire = []
    for arrays in grads:
        flat = np.concatenate([torch.from_numpy(a).to(d).float().numpy().reshape(-1)
                               for a, d in zip(arrays, dtypes)])
        wire.append(jq.quantize_rowwise(flat, row_size=1024, kind=kind))
    n = sum(a.size for a in grads[0])
    rq, rs = jq.reduce_quantized(np.stack([w[0] for w in wire]), np.stack([w[1] for w in wire]),
                                 kind)
    average = jq.dequantize_rowwise(rq, rs, n, np.float32) / np.float32(2)
    off = 0
    for leaf, (a, d) in enumerate(zip(grads[0], dtypes)):
        want = average[off : off + a.size].reshape(a.shape)
        off += a.size
        for replica in range(2):
            got = outs[replica][leaf]
            if d == torch.bfloat16:
                np.testing.assert_array_equal(
                    got.view(torch.int16).numpy(),
                    np.asarray(want.astype(ml_dtypes.bfloat16)).view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), want)


def test_float64_gradients_are_divided_on_the_host(lighthouse) -> None:
    """A dtype the avg kernel does not take (f64) rides the Manager's host
    divide and a copy back: bit for bit the JAX package's f64 average."""
    grads = [_grads(i, SHAPES, np.float64) for i in range(2)]

    def body(arrays):
        def run(manager):
            params = [torch.nn.Parameter(torch.zeros(a.shape, dtype=torch.float64)) for a in arrays]
            for p, a in zip(params, arrays):
                p.grad = torch.from_numpy(a.copy())
            tddp.allreduce_gradients(manager, params).wait()
            return [p.grad.clone() for p in params]

        return run

    port = _run_pair(lighthouse.local_address(),
                     [(tmanager, TCPCommunicator, body(a)) for a in grads])
    ref = _jax_average(lighthouse.local_address(), grads)
    for got, want in zip(port[0], ref[0]):
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
