"""The port's quantized wire held against the JAX package's, on the CPU.

- Host quantizer (``torchft_tpu_torch/quantization.py``) against
  ``torchft_tpu.quantization``: payload bytes and scales bit-equal, for
  int8 and fp8, ragged sizes, NaN/inf and zero rows, and against the golden
  fixture ``tests/fixtures/quant_wire_golden.json``.
- Each kernel's plain version (``torchft_tpu_torch/ops/quant.py``, taken for
  CPU tensors) against the JAX functions run as ``tests/test_pallas_quant.py``
  runs them: the jnp path and ``interpret=True`` Pallas.  Against the host
  numpy wire the plain versions are bit-exact (rtol 0).  Against jnp the
  scales hold rtol 1e-6, the tolerance the JAX tests use between jnp and
  the host wire, and the payload bytes are equal on every row whose scales
  agree bit for bit: XLA on the CPU rewrites ``absmax / 127`` as
  ``absmax * (1/127)`` and may fuse the reduce's multiply-add, so some
  scales differ from the IEEE division the host wire (and the CUDA
  kernels) compute by one or two ulps (measured: at most 2.1e-7 relative).

Rows holding NaN are compared with the JAX package's numpy path (its C++
int8 quantizer drops NaN from the absmax, which numpy and jnp do not).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchft_tpu.quantization as jq
from torchft_tpu.ops import pallas_quant as jpq
from torchft_tpu_torch import quantization as tq
from torchft_tpu_torch.ops import quant as tops

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "quant_wire_golden.json")
KINDS = ["int8", "fp8"]


@pytest.fixture()
def numpy_jax_wire(monkeypatch):
    """The JAX package's host wire on its numpy path (no C++ tier)."""
    monkeypatch.setattr(jq, "_NATIVE", None)


def _bits(q: np.ndarray) -> np.ndarray:
    return np.asarray(q).view(np.uint8)


def _f32_bits(s) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(s, dtype=np.float32)).reshape(-1).view(np.uint32)


def _data(seed: int, n: int, special: bool = False) -> np.ndarray:
    """Normal data over several decades; ``special`` adds a NaN row, ±inf
    rows and an all-zero row (n must then cover four rows of 1024)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.logspace(-3, 3, n)).astype(np.float32)
    if special:
        x[5] = np.nan
        x[1024 + 7] = np.inf
        x[2048 + 3] = -np.inf
        x[3072:4096] = 0.0
    return x


def _torch_wire(q: np.ndarray, kind: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(q).view(np.uint8))
    return t.view(torch.float8_e4m3fn) if kind == "fp8" else t.view(torch.int8)


def _plain_bits(q: torch.Tensor) -> np.ndarray:
    return q.view(torch.uint8).numpy()


# ---------------------------------------------------------------------------
# host wire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [5000, 64 * 1024, 1])
def test_host_quantizer_matches_jax(kind, n) -> None:
    x = _data(n, n)
    q, s = tq.quantize_rowwise(x, 1024, kind)
    jq_, js = jq.quantize_rowwise(x, 1024, kind)
    assert q.dtype == tq.wire_dtype(kind)
    np.testing.assert_array_equal(_bits(q), _bits(jq_))
    np.testing.assert_array_equal(_f32_bits(s), _f32_bits(js))
    out = tq.dequantize_rowwise(q, s, n, np.float32)
    np.testing.assert_array_equal(_f32_bits(out), _f32_bits(jq.dequantize_rowwise(jq_, js, n, np.float32)))


@pytest.mark.parametrize("kind", KINDS)
def test_host_quantizer_special_rows_match_jax_numpy(numpy_jax_wire, kind) -> None:
    x = _data(7, 4 * 1024 + 300, special=True)
    q, s = tq.quantize_rowwise(x, 1024, kind)
    jq_, js = jq.quantize_rowwise(x, 1024, kind)
    np.testing.assert_array_equal(_bits(q), _bits(jq_))
    np.testing.assert_array_equal(_f32_bits(s), _f32_bits(js))
    assert s[3] == 0 and not _bits(q)[3].any()  # the zero row: scale 0, q 0
    assert np.isnan(s[0]) and np.isinf(s[1]) and np.isinf(s[2])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("w", [2, 3])
def test_host_reduce_matches_jax(numpy_jax_wire, kind, w) -> None:
    contribs = [_data(10 + i, 8 * 1024 + 100) for i in range(w)]
    contribs[0][2048:3072] = -0.0  # a sum of -0 products is +0
    contribs[1][2048:3072] = -0.0
    ours = [tq.quantize_rowwise(c, 1024, kind) for c in contribs]
    theirs = [jq.quantize_rowwise(c, 1024, kind) for c in contribs]
    q, s = tq.reduce_quantized(np.stack([a for a, _ in ours]), np.stack([b for _, b in ours]), kind)
    jq_, js = jq.reduce_quantized(
        np.stack([a for a, _ in theirs]), np.stack([b for _, b in theirs]), kind
    )
    np.testing.assert_array_equal(_bits(q), _bits(jq_))
    np.testing.assert_array_equal(_f32_bits(s), _f32_bits(js))


def test_host_wire_matches_golden_fixture() -> None:
    """The fixture's input, as ``tests/test_pallas_quant.py`` builds it."""
    with open(FIXTURE) as f:
        golden = json.load(f)
    rng = np.random.default_rng(42)
    flat = (rng.normal(size=512) * np.logspace(-2, 2, 512)).astype(np.float32)
    for kind in KINDS:
        q, s = tq.quantize_rowwise(flat, row_size=128, kind=kind)
        assert _bits(q).reshape(-1).tolist() == golden[kind]["payload"], kind
        assert s.astype(float).tolist() == golden[kind]["scales"], kind


def test_quant_kind_validates(monkeypatch) -> None:
    monkeypatch.setenv("TORCHFT_QUANT_KIND", " FP8 ")
    assert tq.quant_kind() == "fp8"
    monkeypatch.setenv("TORCHFT_QUANT_KIND", "int4")
    with pytest.raises(ValueError, match="TORCHFT_QUANT_KIND"):
        tq.quant_kind()


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------


def _assert_like_jnp(q_plain, s_plain, q_jax, s_jax) -> None:
    """Scales within rtol 1e-6 of jnp (the JAX tests' own jnp-vs-host
    tolerance); payload bytes equal on every row whose scales agree bit
    for bit."""
    s_plain, s_jax = np.asarray(s_plain).reshape(-1), np.asarray(s_jax).reshape(-1)
    finite = np.isfinite(s_jax)
    np.testing.assert_allclose(s_plain[finite], s_jax[finite], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(np.isnan(s_plain), np.isnan(s_jax))
    same = _f32_bits(s_plain) == _f32_bits(s_jax)
    np.testing.assert_array_equal(_plain_bits(q_plain)[same], _bits(q_jax)[same])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,special", [(40 * 1024 + 517, False), (5 * 1024, True), (1000, False)],
                         ids=["ragged", "nan-inf-zero", "one-row"])
def test_plain_quantize_matches_jax(numpy_jax_wire, kind, n, special) -> None:
    x = _data(n, n, special)
    q, s = tops.quantize_rowwise_device(torch.from_numpy(x), kind=kind)
    rows = tops.padded_rows(n)
    assert tuple(q.shape) == (rows, 1024) and tuple(s.shape) == (rows, 1)
    assert rows % tops.BLOCK_ROWS == 0
    # bit-exact with the host wire, and the padding rows are zero
    hq, hs = jq.quantize_rowwise(x, 1024, kind)
    np.testing.assert_array_equal(_plain_bits(q)[: hq.shape[0]], _bits(hq))
    np.testing.assert_array_equal(_f32_bits(s[: hq.shape[0]]), _f32_bits(hs))
    assert not _plain_bits(q)[hq.shape[0]:].any() and not s[hq.shape[0]:].any()
    # the jnp path, and interpret-mode Pallas on a 32-row slice
    jq_, js = jpq.quantize_rowwise_device(jnp.asarray(x), kind=kind)
    _assert_like_jnp(q, s, jq_, js)
    head = x[: 32 * 1024] if n >= 32 * 1024 else x
    iq, is_ = jpq.quantize_rowwise_device(jnp.asarray(head), kind=kind, interpret=True)
    pq, ps = tops.quantize_rowwise_device(torch.from_numpy(head), kind=kind)
    _assert_like_jnp(pq, ps, iq, is_)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("w", [1, 2, 3, 8])
@pytest.mark.parametrize("special", [False, True], ids=["finite", "nan-inf-zero"])
def test_plain_reduce_matches_jax(numpy_jax_wire, kind, w, special) -> None:
    contribs = [_data(20 + i, 32 * 1024, special and i == 0) for i in range(w)]
    qs, scs = zip(*(jq.quantize_rowwise(c, 1024, kind) for c in contribs))
    qs_np, scs_np = np.stack(qs), np.stack(scs)
    q, s = tops.reduce_quantized_device(
        _torch_wire(qs_np, kind), torch.from_numpy(scs_np), kind=kind
    )
    hq, hs = jq.reduce_quantized(qs_np, scs_np, kind)
    np.testing.assert_array_equal(_plain_bits(q), _bits(hq))
    np.testing.assert_array_equal(_f32_bits(s), _f32_bits(hs))
    args = (jnp.asarray(qs_np), jnp.asarray(scs_np)[:, :, None])
    _assert_like_jnp(q, s, *jpq.reduce_quantized_device(*args, kind=kind))
    _assert_like_jnp(q, s, *jpq.reduce_quantized_device(*args, kind=kind, interpret=True))


@pytest.mark.parametrize("kind", KINDS)
def test_plain_dequantize_matches_jax(kind) -> None:
    n = 32 * 1024 - 300
    q, s = jpq.quantize_rowwise_device(jnp.asarray(_data(3, n)), kind=kind)
    q_np, s_np = np.asarray(q), np.asarray(s)
    out = tops.dequantize_rowwise_device(_torch_wire(q_np, kind), torch.from_numpy(s_np), n)
    assert out.dtype == torch.float32 and tuple(out.shape) == (n,)
    for interpret in (False, True):
        ref = jpq.dequantize_rowwise_device(q, s, n=n, interpret=interpret)
        np.testing.assert_array_equal(_f32_bits(out.numpy()), _f32_bits(ref))
    host = tq.dequantize_rowwise(_bits(q_np) if kind == "fp8" else q_np, s_np.reshape(-1), n,
                                 np.float32)
    np.testing.assert_array_equal(_f32_bits(out.numpy()), _f32_bits(host))


def test_wrappers_validate_and_count_nothing_on_the_cpu() -> None:
    tops.reset_launches()
    q, s = tops.quantize_int8_rowwise_device(torch.zeros(100))
    assert not q.any() and not s.any()  # zero input: scale 0, q 0
    assert torch.equal(tops.dequantize_int8_rowwise_device(q, s, 100), torch.zeros(100))
    assert tops.launches == {"quantize": 0, "reduce": 0, "dequantize": 0}
    with pytest.raises(ValueError, match="flat"):
        tops.quantize_rowwise_device(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="int8 or float8"):
        tops.dequantize_rowwise_device(q.float(), s, 100)
    with pytest.raises(ValueError, match="do not match"):
        tops.reduce_quantized_device(q[None], torch.zeros(3))
    with pytest.raises(ValueError, match="w=0"):
        tops.reduce_quantized_device(q[None][:0], s[None][:0])
