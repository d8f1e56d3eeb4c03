"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on the
machine with the card, which has none::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: bf16 kernels vs their plain versions on the same card, compared
in f32.  o, dq, dk and dv: elementwise 5e-3 absolute + 2e-2 relative (the
two sum in different orders, so their bf16 outputs may differ by one ulp,
2^-7 relative) and normwise relative error at most 1e-2.  lse is f32 on
both sides: 1e-3 absolute.  The quantize and dequantize kernels run the
same single IEEE operations in the same order as their plain versions, and
the reduce computes the same correctly rounded results by cheaper
operations where they provably agree, so all three are held exactly:
payload bytes equal, scales and f32 outputs bit-equal (NaN included).
"""

import pytest
import torch

from torchft_tpu_torch.models.llama import Llama, llama3_8b
from torchft_tpu_torch.ops import flash_attention as tfa
from torchft_tpu_torch.ops import quant as tq


def _assert_close(name, got, want) -> None:
    got, want = got.float(), want.float()
    if name == "lse":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-3, msg=name)
        return
    torch.testing.assert_close(got, want, rtol=2e-2, atol=5e-3, msg=name)
    assert (got - want).norm() <= 1e-2 * want.norm(), name


def _randn_bf16(gen, device):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    return randn


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,causal,Sq,Sk,H,KV,D", [
    (1, True, 1024, 1024, 32, 8, 128),
    (1, False, 500, 900, 8, 8, 64),
    (1, True, 130, 130, 4, 1, 64),
    # the forward's 3-D tensor maps: ragged rows zero-filled per head, B > 1
    (2, True, 1000, 1000, 8, 2, 128),
    # one 128-row tile, half of it past Sq and Sk
    (1, False, 64, 64, 1, 1, 128),
    # dk/dv: Sk not a multiple of its 128 keys, Sq not one of its 64 q rows,
    # every GQA group size (G = 8 is H=32, KV=4), Sq > Sk and Sq < Sk
    # without the mask, D = 64 at B = 2
    (1, True, 520, 520, 32, 4, 128),
    (1, True, 330, 330, 4, 2, 128),
    (1, False, 900, 500, 16, 8, 128),
    (1, False, 200, 700, 16, 16, 128),
    (2, True, 300, 300, 8, 8, 64),
    (2, False, 450, 260, 16, 2, 64),
])
def test_kernels_match_plain(cuda_device, B, causal, Sq, Sk, H, KV, D) -> None:
    randn = _randn_bf16(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    q, do, k, v = randn(B, H, Sq, D), randn(B, H, Sq, D), randn(B, KV, Sk, D), randn(B, KV, Sk, D)
    scale = D ** -0.5
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, scale, causal, 256, 256)
    o, lse = tfa.flash_fwd(q, k, v, scale, causal)
    delta = tfa.backward_delta(do, o_ref).contiguous()
    dq = tfa.flash_dq(q, k, v, lse_ref, do, delta, scale, causal)
    dk, dv = tfa.flash_dkv(q, k, v, lse_ref, do, delta, scale, causal)
    refs = (
        o_ref, lse_ref, tfa.flash_dq_plain(q, k, v, lse_ref, do, delta, scale, causal, 256, 256),
        *tfa.flash_dkv_plain(q, k, v, lse_ref, do, delta, scale, causal, 256, 256),
    )
    for name, got, want in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, dq, dk, dv), refs):
        _assert_close(name, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,Sq,Sk,H,KV", [(True, 1024, 1024, 32, 8), (False, 500, 900, 8, 2)])
def test_autograd_chain_matches_plain_chain(cuda_device, causal, Sq, Sk, H, KV) -> None:
    """The chain training runs — dq/dkv fed the forward kernel's own o and
    lse, with an lse cotangent — against the plain fwd → dq/dkv chain."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    randn = _randn_bf16(gen, cuda_device)
    D = 128
    q, do, k, v = randn(1, H, Sq, D), randn(1, H, Sq, D), randn(1, KV, Sk, D), randn(1, KV, Sk, D)
    dlse = torch.randn(1, H, Sq, generator=gen, device=cuda_device)
    scale = D ** -0.5
    qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
    o, lse = tfa._FlashAttention.apply(qa, ka, va, scale, causal, 64, 64)
    grads = torch.autograd.grad((o, lse), (qa, ka, va), (do, dlse))
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, scale, causal, 256, 256)
    delta = tfa.backward_delta(do, o_ref, dlse).contiguous()
    refs = (
        tfa.flash_dq_plain(q, k, v, lse_ref, do, delta, scale, causal, 256, 256),
        *tfa.flash_dkv_plain(q, k, v, lse_ref, do, delta, scale, causal, 256, 256),
    )
    names = ("o", "lse", "dq", "dk", "dv")
    for name, got, want in zip(names, (o, lse, *grads), (o_ref, lse_ref, *refs)):
        _assert_close(name, got, want)


@pytest.mark.cuda
def test_kernel_wrappers_count_launches_and_refuse_f32(cuda_device) -> None:
    q = torch.randn(1, 4, 128, 64, device=cuda_device, dtype=torch.bfloat16)
    k = torch.randn(1, 2, 128, 64, device=cuda_device, dtype=torch.bfloat16)
    tfa.reset_launches()
    tfa.flash_fwd(q, k, k, 0.125, True)
    assert tfa.launches["fwd"] == 1
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_fwd(q.float(), k.float(), k.float(), 0.125, True)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                      k[..., :32].contiguous(), 0.125, True)
    assert tfa.launches["fwd"] == 1


@pytest.mark.cuda
def test_forward_launches_the_sm90_kernel(cuda_device) -> None:
    """``flash_fwd`` on a CUDA tensor goes through ``tft_flash_fwd_sm90``
    (csrc/flash_fwd_sm90.cu), one launch per call, with no fallback."""
    q = torch.randn(2, 4, 256, 128, device=cuda_device, dtype=torch.bfloat16)
    k = torch.randn(2, 2, 256, 128, device=cuda_device, dtype=torch.bfloat16)
    tfa.reset_launches()
    o, lse = tfa.flash_fwd(q, k, k, 128 ** -0.5, True)
    torch.cuda.synchronize()
    assert tfa.launches == {"fwd": 1, "dq": 0, "dkv": 0}
    assert hasattr(tfa._lib(tfa.FWD_SOURCE), "tft_flash_fwd_sm90")
    assert not hasattr(tfa._lib(tfa.DQ_SOURCE), "tft_flash_fwd")
    assert o.shape == q.shape and lse.shape == (2, 4, 256) and torch.isfinite(lse).all()


@pytest.mark.cuda
def test_llama_on_cuda_runs_attention_on_the_kernels(cuda_device, monkeypatch) -> None:
    """At Llama-3-8B attention width, ``auto`` dispatch sends a CUDA model's
    attention to all three kernels, once per layer each."""
    import dataclasses

    monkeypatch.delenv("TORCHFT_FLASH", raising=False)
    cfg = dataclasses.replace(llama3_8b(), n_layers=1, vocab_size=1024, ffn_hidden=1024)
    model = Llama(cfg, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), device=cuda_device)
    tfa.reset_launches()
    model.loss(tokens, tokens.roll(-1, 1)).backward()
    assert tfa.launches == {"fwd": 1, "dq": 1, "dkv": 1}


def _bit_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and torch.equal(
        got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8)
    )


def _bwd_inputs(device, B, H, KV, S, D):
    """Causal backward operands, lse and delta from the forward kernel."""
    randn = _randn_bf16(torch.Generator(device=device).manual_seed(2), device)
    q, do, k, v = randn(B, H, S, D), randn(B, H, S, D), randn(B, KV, S, D), randn(B, KV, S, D)
    scale = D ** -0.5
    o, lse = tfa.flash_fwd(q, k, v, scale, True)
    return q, k, v, lse, do, tfa.backward_delta(do, o).contiguous(), scale


@pytest.mark.cuda
def test_dkv_is_deterministic(cuda_device) -> None:
    """The GQA group sum runs in a fixed order whichever block finishes
    last: five launches at the Llama-3-8B attention shapes give bit-identical
    dk and dv."""
    args = _bwd_inputs(cuda_device, 1, 32, 8, 2048, 128)
    first = tfa.flash_dkv(*args, True)
    for _ in range(4):
        again = tfa.flash_dkv(*args, True)
        assert _bit_equal(again[0], first[0]) and _bit_equal(again[1], first[1])


@pytest.mark.cuda
def test_dkv_launches_the_sm90_kernel(cuda_device) -> None:
    """``flash_dkv`` on a CUDA tensor goes through ``tft_flash_dkv_sm90``
    (csrc/flash_dkv_sm90.cu), one launch per call; the dq source has no
    dk/dv kernel."""
    args = _bwd_inputs(cuda_device, 2, 4, 2, 256, 128)
    tfa.reset_launches()
    dk, dv = tfa.flash_dkv(*args, True)
    torch.cuda.synchronize()
    assert tfa.launches == {"fwd": 0, "dq": 0, "dkv": 1}
    assert hasattr(tfa._lib(tfa.DKV_SOURCE), "tft_flash_dkv_sm90")
    assert not hasattr(tfa._lib(tfa.DQ_SOURCE), "tft_flash_dkv")
    assert dk.shape == dv.shape == (2, 2, 256, 128)
    assert torch.isfinite(dk.float()).all() and torch.isfinite(dv.float()).all()


@pytest.mark.cuda
def test_dq_is_deterministic(cuda_device) -> None:
    """Each block sums its own rows' dq over the k-tiles in registers, in a
    fixed order: five launches at the Llama-3-8B attention shapes give
    bit-identical dq."""
    args = _bwd_inputs(cuda_device, 1, 32, 8, 2048, 128)
    first = tfa.flash_dq(*args, True)
    for _ in range(4):
        assert _bit_equal(tfa.flash_dq(*args, True), first)


@pytest.mark.cuda
def test_dq_launches_the_sm90_kernel(cuda_device) -> None:
    """``flash_dq`` on a CUDA tensor goes through ``tft_flash_dq_sm90``
    (csrc/flash_dq_sm90.cu), one launch per call; the wmma entry point is
    gone."""
    args = _bwd_inputs(cuda_device, 2, 4, 2, 256, 128)
    tfa.reset_launches()
    dq = tfa.flash_dq(*args, True)
    torch.cuda.synchronize()
    assert tfa.launches == {"fwd": 0, "dq": 1, "dkv": 0}
    lib = tfa._lib(tfa.DQ_SOURCE)
    assert hasattr(lib, "tft_flash_dq_sm90") and not hasattr(lib, "tft_flash_dq")
    assert dq.shape == (2, 4, 256, 128) and torch.isfinite(dq.float()).all()


def _quant_input(gen, n, special, device):
    x = torch.randn(n, generator=gen, device=device) * torch.logspace(-3, 3, n, device=device)
    if special:  # a NaN row, ±inf rows and an all-zero row
        x[5] = float("nan")
        x[1024 + 7] = float("inf")
        x[2048 + 3] = float("-inf")
        x[3072:4096] = 0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("n,special", [(256 * 1024, False), (1000 * 1024 + 517, False),
                                       (5 * 1024, True), (3, False)])
def test_quant_kernels_match_plain(cuda_device, kind, n, special) -> None:
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = _quant_input(gen, n, special, cuda_device)
    tq.reset_launches()
    q, s = tq.quantize_rowwise_device(x, kind=kind)
    q_ref, s_ref = tq.quantize_rowwise_plain(x, kind=kind)
    assert q.shape[0] == tq.padded_rows(n) and q.shape[0] % tq.BLOCK_ROWS == 0
    assert _bit_equal(q, q_ref) and _bit_equal(s, s_ref)
    out = tq.dequantize_rowwise_device(q, s, n)
    assert _bit_equal(out, tq.dequantize_rowwise_plain(q, s, n))
    for w in (2, 3):
        parts = [tq.quantize_rowwise_plain(_quant_input(gen, n, special and c == 1, cuda_device),
                                           kind=kind) for c in range(w)]
        qs = torch.stack([p[0] for p in parts])
        scs = torch.stack([p[1] for p in parts])
        got = tq.reduce_quantized_device(qs, scs, kind=kind)
        want = tq.reduce_quantized_plain(qs, scs, kind=kind)
        assert _bit_equal(got[0], want[0]) and _bit_equal(got[1], want[1]), w
    torch.cuda.synchronize()
    assert tq.launches == {"quantize": 1, "reduce": 2, "dequantize": 1}


@pytest.mark.cuda
def test_quant_wrappers_refuse_what_the_kernels_do_not_take(cuda_device) -> None:
    with pytest.raises(ValueError, match="float32"):
        tq.quantize_rowwise_device(torch.zeros(10, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="rows of 1024"):
        tq.quantize_rowwise_device(torch.zeros(10, device=cuda_device), row_size=128)
    q, s = tq.quantize_rowwise_device(torch.zeros(10, device=cuda_device))
    with pytest.raises(ValueError, match="int8"):
        tq.reduce_quantized_device(q[None].view(torch.uint8), s[None], kind="int8")
    tq.reset_launches()
    with pytest.raises(ValueError, match="w=0"):
        tq.reduce_quantized_device(q[None][:0], s[None][:0], kind="int8")
    # a payload one byte into its buffer: the bulk copies need 16-byte alignment
    buf = torch.zeros(2 * 32 * 1024 + 1, dtype=torch.int8, device=cuda_device)
    misaligned = buf[1:].view(2, 32, 1024)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tq.reduce_quantized_device(misaligned, torch.ones(2, 32, 1, device=cuda_device))
    assert tq.launches["reduce"] == 0


def _reduce_operands(gen, w, rows, kind, special, device):
    """w contributions of ``rows`` rows, each quantized by the plain
    version from its own data.  ``special``: rows 0, 1, 2 (mod 4) hold a
    NaN, a +inf and a -inf in one contribution each, and rows 3 (mod 4) are
    zero in every contribution, so their sum is zero."""
    qs, scs = [], []
    for c in range(w):
        x = torch.randn(rows, 1024, generator=gen, device=device)
        x *= torch.logspace(-3, 3, 1024, device=device)
        if special:
            r = torch.arange(rows, device=device)
            x[r[r % 4 == 0], (7 * c) % 1024] = float("nan") if c == w // 2 else 1.0
            x[r[r % 4 == 1], 100 + c] = float("inf") if c == 0 else -2.0
            x[r[r % 4 == 2], 513] = float("-inf") if c == w - 1 else 3.0
            x[r[r % 4 == 3]] = 0.0
        q, s = tq.quantize_rowwise_plain(x.reshape(-1), kind=kind)
        qs.append(q[:rows])
        scs.append(s[:rows])
    return torch.stack(qs), torch.stack(scs)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
@pytest.mark.parametrize("special", [False, True], ids=["finite", "nan-inf-zero"])
@pytest.mark.parametrize("rows", [1, 7, 33, 1040, 2048])
# 17 contributions go round the ring of (at most 4) stages more than once
@pytest.mark.parametrize("w", [1, 2, 3, 8, 17])
def test_reduce_kernel_matches_plain(cuda_device, kind, special, rows, w) -> None:
    """The bulk-copy reduce equals its plain version bit for bit at every
    ring depth, on whole and cut tiles of 8 rows (rows % 4 != 0 too, where
    the scales cannot be bulk-copied), and two launches are bit-identical."""
    gen = torch.Generator(device=cuda_device).manual_seed(w * 10_000 + rows)
    qs, scs = _reduce_operands(gen, w, rows, kind, special, cuda_device)
    tq.reset_launches()
    got = tq.reduce_quantized_device(qs, scs, kind=kind)
    again = tq.reduce_quantized_device(qs, scs.reshape(w, rows), kind=kind)
    want = tq.reduce_quantized_plain(qs, scs, kind=kind)
    torch.cuda.synchronize()
    assert _bit_equal(got[0], want[0]) and _bit_equal(got[1], want[1])
    assert _bit_equal(again[0], got[0]) and _bit_equal(again[1], got[1])
    assert tq.launches == {"quantize": 0, "reduce": 2, "dequantize": 0}


def _tie_operands(kind, rows, device):
    """Two contributions whose sums lie exactly on the wire's rounding
    boundaries: the row's absmax makes its scale 1, so each quotient is the
    sum itself.  int8: b0 + b1/2, half-integers (rounded half to even);
    e4m3: a + h, h half the spacing of a's binade, midpoints between two
    e4m3 values."""
    gen = torch.Generator().manual_seed(11)
    if kind == "int8":
        a = torch.randint(-63, 64, (rows, 1024), generator=gen).float()
        h = torch.randint(-127, 128, (rows, 1024), generator=gen).float()
        a[:, 0], h[:, 0] = 127.0, 0.0
        scales = torch.tensor([1.0, 0.5])
    else:
        exp = torch.randint(-5, 8, (rows, 1024), generator=gen).float()
        mant = torch.randint(0, 7, (rows, 1024), generator=gen).float()  # 7: the next binade
        sign = torch.randint(0, 2, (rows, 1024), generator=gen).float() * 2 - 1
        a = sign * (1 + mant / 8) * 2.0 ** exp
        h = sign * 2.0 ** (exp - 4)
        a[:, 0], h[:, 0] = 448.0, 0.0
        scales = torch.tensor([1.0, 1.0])
    dtype = torch.int8 if kind == "int8" else torch.float8_e4m3fn
    qs = torch.stack([a, h]).to(dtype).to(device)
    assert torch.equal(qs.float().cpu(), torch.stack([a, h]))  # every value on the wire
    return qs, scales.reshape(2, 1, 1).expand(2, rows, 1).contiguous().to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_reduce_kernel_rounds_ties_as_the_division_does(cuda_device, kind) -> None:
    """Every quotient on a rounding boundary: the kernel's product path
    must hand each of them to the division and round half to even."""
    qs, scs = _tie_operands(kind, 64, cuda_device)
    got = tq.reduce_quantized_device(qs, scs, kind=kind)
    want = tq.reduce_quantized_plain(qs, scs, kind=kind)
    torch.cuda.synchronize()
    assert torch.equal(want[1].cpu(), torch.ones(64, 1))  # scale 1: the quotients are the sums
    assert _bit_equal(got[0], want[0]) and _bit_equal(got[1], want[1])


@pytest.mark.cuda
def test_reduce_launches_the_sm90_kernel(cuda_device) -> None:
    """The reduce runs csrc/quant_reduce_sm90.cu; the old kernel is gone
    from csrc/quant.cu."""
    assert hasattr(tq._lib(tq.REDUCE_SOURCE), "tft_reduce_quantized_sm90")
    assert not hasattr(tq._lib(tq.KERNEL_SOURCE), "tft_reduce_quantized")


def _avg_sum(n: int, src: torch.dtype, device) -> torch.Tensor:
    """A bucket SUM: normal values over many decades, then NaNs of both
    signs, with a payload and signaling, ±inf, the largest finite value,
    subnormals and rounding ties."""
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn(n, generator=gen, device=device)
    x *= torch.logspace(-40, 38, n, device=device)
    bits = x.view(torch.int32)
    bits[:8] = torch.tensor([0x7FC00000, -0x400000, 0x7FA00001, -0x3EDCBB, 0x7F800000,
                             -0x800000, 0x7F7FFFFF, 0x00000001], dtype=torch.int32, device=device)
    x[8:14] = torch.tensor([1e-39, -1e-40, 3.0, 1.0 + 2.0 ** -8, 0.0, -0.0], device=device)
    if src == torch.float32:
        return x
    return (bits >> 16).to(torch.int16).view(torch.bfloat16)


def _avg_host_bits(host: torch.Tensor, dst: torch.dtype, divisor: int):
    """The host's divide of the sum ``host`` (``bf16.div`` for bf16; numpy's
    f32 division, that quotient rounded by ``bf16.from_f32`` into a bf16
    leaf), as the bits the card must write."""
    import numpy as np

    from torchft_tpu_torch import bf16

    if host.dtype == torch.bfloat16:
        return bf16.div(bf16.from_tensor(host), divisor).view(np.uint16)
    with np.errstate(invalid="ignore"):
        quotient = host.numpy() / np.float32(divisor)
    return quotient.view(np.uint32) if dst == torch.float32 else (
        bf16.from_f32(quotient).view(np.uint16))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096 * 1024, (1 << 16) + 13], ids=["leaf", "ragged"])
@pytest.mark.parametrize("divisor", [2, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_avg_kernel_divides_in_place(cuda_device, dtype, divisor, n) -> None:
    """The avg kernel with the sum and the leaf one buffer, as the main
    path calls it: bit for bit against its plain version and the host's
    divide, NaN payloads included, at a 16-byte-aligned length and a ragged
    one."""
    import numpy as np

    from torchft_tpu_torch.ops import avg as tavg

    x = _avg_sum(n, dtype, cuda_device)
    plain = torch.empty_like(x)
    tavg.average_into_plain(x, divisor, plain)
    want = _avg_host_bits(x.cpu(), dtype, divisor)
    tavg.reset_launches()
    tavg.average_into(x, divisor, x)
    assert tavg.launches["avg"] == 1
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(x.view(bits), plain.view(bits))
    got = x.view(bits).cpu().numpy().view(want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("divisor", [2, 3])
@pytest.mark.parametrize("src, dst", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16)])
def test_avg_kernel_matches_the_host_divide(cuda_device, src, dst, divisor, offset) -> None:
    """The avg kernel on the card, bit for bit against the host's divide
    (``bf16.div`` for a bf16 sum, numpy's f32 division for an f32 one, that
    quotient rounded by ``bf16.from_f32`` into bf16) and against its plain
    version on the card, NaN payloads included; a ragged length, at an
    aligned start (16-byte loads) and at an odd one (element by element)."""
    import numpy as np

    from torchft_tpu_torch.ops import avg as tavg

    n = (1 << 16) + 13
    x = _avg_sum(n + offset, src, cuda_device)[offset:]
    out = torch.empty(n, dtype=dst, device=cuda_device)
    tavg.reset_launches()
    tavg.average_into(x, divisor, out)
    assert tavg.launches["avg"] == 1
    plain = torch.empty_like(out)
    tavg.average_into_plain(x, divisor, plain)
    want = _avg_host_bits(x.cpu(), dst, divisor)
    bits = torch.int16 if dst == torch.bfloat16 else torch.int32
    got = out.view(bits).cpu().numpy().view(want.dtype)
    np.testing.assert_array_equal(got, want)
    assert torch.equal(out.view(bits), plain.view(bits))
