"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports no JAX, so it also runs on the
machine with the card, which has none::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerance: bf16 kernels vs their plain versions on the same card, compared
in f32.  o, dq, dk and dv: elementwise 5e-3 absolute + 2e-2 relative (the
two sum in different orders, so their bf16 outputs may differ by one ulp,
2^-7 relative) and normwise relative error at most 1e-2.  lse is f32 on
both sides: 1e-3 absolute.
"""

import pytest
import torch

from torchft_tpu_torch.models.llama import Llama, llama3_8b
from torchft_tpu_torch.ops import flash_attention as tfa


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
@pytest.mark.parametrize("causal,Sq,Sk,H,KV,D", [
    (True, 1024, 1024, 32, 8, 128),
    (False, 500, 900, 8, 8, 64),
    (True, 130, 130, 4, 1, 64),
])
def test_kernels_match_plain(cuda_device, causal, Sq, Sk, H, KV, D) -> None:
    randn = _randn_bf16(torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    q, do, k, v = randn(1, H, Sq, D), randn(1, H, Sq, D), randn(1, KV, Sk, D), randn(1, KV, Sk, D)
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
