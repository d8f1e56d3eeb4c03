"""The port's flash attention (torchft_tpu_torch/ops/flash_attention.py)
held against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.  Both
get the same numpy inputs.  Tolerances: f32 on both sides, so only the
summation order differs — 2e-5 on outputs and lse (the JAX package's own
forward tolerance), 1e-4 on gradients (its own backward tolerance).  The
CUDA kernels are held against the plain versions on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.models.llama import Llama as JaxLlama
from torchft_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from torchft_tpu.ops import flash_attention as jfa
from torchft_tpu_torch.models.llama import naive_attention, use_flash
from torchft_tpu_torch.ops import flash_attention as tfa

# (causal, Sq, Sk, H, KV, D, block): GQA groups 1/2/4, S 128/256, D 64/128,
# causal and full, and one non-causal Sq != Sk case
CASES = [
    (True, 128, 128, 4, 4, 64, 64),
    (True, 256, 256, 4, 2, 64, 128),
    (True, 256, 256, 8, 2, 128, 128),
    (True, 128, 128, 2, 2, 128, 128),
    (False, 256, 256, 4, 2, 64, 128),
    (False, 128, 128, 4, 1, 128, 64),
    (False, 128, 256, 4, 2, 64, 64),
]
IDS = [f"{'causal' if c[0] else 'full'}-Sq{c[1]}-Sk{c[2]}-g{c[3] // c[4]}-D{c[5]}" for c in CASES]


def _inputs(B, Sq, Sk, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    dlse = rng.standard_normal((B, Sq, H)).astype(np.float32)
    return q, k, v, do, dlse


def _torch(*arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


@pytest.mark.parametrize("causal,Sq,Sk,H,KV,D,block", CASES, ids=IDS)
def test_forward_and_lse_match_jax(causal, Sq, Sk, H, KV, D, block) -> None:
    q, k, v, _, _ = _inputs(2, Sq, Sk, H, KV, D)
    o_j, lse_j = jfa.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=block, block_k=block, interpret=True,
    )
    o_t, lse_t = tfa.flash_attention_lse(
        *_torch(q, k, v), causal=causal, block_q=block, block_k=block
    )
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,Sq,Sk,H,KV,D,block", CASES, ids=IDS)
def test_backward_matches_jax_vjp(causal, Sq, Sk, H, KV, D, block) -> None:
    """dq/dk/dv of (o, lse) against ``jax.vjp`` with the same cotangents,
    the lse cotangent included (it folds into delta)."""
    q, k, v, do, dlse = _inputs(2, Sq, Sk, H, KV, D, seed=1)
    _, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention_lse(
            q, k, v, causal=causal, block_q=block, block_k=block, interpret=True
        ),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    grads_j = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    qt, kt, vt = _torch(q, k, v, grad=True)
    o, lse = tfa.flash_attention_lse(qt, kt, vt, causal=causal, block_q=block, block_k=block)
    grads_t = torch.autograd.grad((o, lse), (qt, kt, vt), _torch(do, dlse))
    for name, a, b in zip("qkv", grads_t, grads_j):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4, err_msg=f"d{name}"
        )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_plain_backward_matches_naive_autograd(causal, groups) -> None:
    """The plain dq/dkv against torch autograd through naive attention."""
    q, k, v, do, _ = _inputs(2, 256, 256, 4, 4 // groups, 64, seed=2)
    qt, kt, vt = _torch(q, k, v, grad=True)
    out = tfa.flash_attention(qt, kt, vt, causal=causal, block_q=128, block_k=64)
    g_flash = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    qn, kn, vn = _torch(q, k, v, grad=True)
    ref = naive_attention(qn, kn, vn, causal=causal)
    g_ref = torch.autograd.grad(ref, (qn, kn, vn), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=2e-5, atol=2e-5)
    for name, a, b in zip("qkv", g_flash, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize(
    "Sq,Sk,H,KV,causal,block",
    [
        (256, 256, 4, 3, True, 512),  # GQA: H % KV
        (256, 128, 4, 2, True, 512),  # causal needs Sq == Sk
        (320, 320, 4, 2, True, 256),  # not divisible by blocks
        (256, 320, 4, 2, False, 128),  # Sk not divisible
    ],
)
def test_validation_errors_match_jax(Sq, Sk, H, KV, causal, block) -> None:
    q, k, v, _, _ = _inputs(1, Sq, Sk, H, KV, 64)
    with pytest.raises(ValueError) as err_j:
        jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=block, block_k=block, interpret=True,
        )
    with pytest.raises(ValueError) as err_t:
        tfa.flash_attention(*_torch(q, k, v), causal=causal, block_q=block, block_k=block)
    assert str(err_t.value) == str(err_j.value)


@pytest.mark.parametrize("flash_env", [None, "0", "1"])
@pytest.mark.parametrize("block_env", [None, "128", "96", "bad", "-4"])
def test_dispatch_gate_matches_jax(monkeypatch, flash_env, block_env) -> None:
    """The port's Llama sends the same shapes to flash as the JAX model's
    ``_use_flash`` under the same env (auto on the CPU: naive in both)."""
    for name, value in (("TORCHFT_FLASH", flash_env), ("TORCHFT_FLASH_BLOCK_Q", block_env)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    cfg = JaxLlamaConfig(
        vocab_size=128, dim=64, n_layers=1, n_heads=4, n_kv_heads=2,
        ffn_hidden=128, max_seq_len=1024, dtype=jnp.float32,
    )
    jax_model = JaxLlama(cfg)
    for seq in (64, 100, 128, 130, 192, 256, 320, 384, 512, 640, 1024):
        assert use_flash(seq, torch.device("cpu")) == jax_model._use_flash(seq), seq


def test_block_sizes_do_not_change_math() -> None:
    q, k, v, _, _ = _inputs(1, 512, 512, 4, 2, 64)
    a = tfa.flash_attention(*_torch(q, k, v), block_q=128, block_k=256)
    b = tfa.flash_attention(*_torch(q, k, v), block_q=512, block_k=512)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing() -> None:
    tfa.reset_launches()
    q, k, v, do, _ = _inputs(1, 128, 128, 4, 2, 64)
    qt, kt, vt = _torch(q, k, v, grad=True)
    out = tfa.flash_attention(qt, kt, vt)
    out.backward(torch.from_numpy(do))
    assert tfa.launches == {"fwd": 0, "dq": 0, "dkv": 0}


def test_kernel_wrappers_refuse_what_the_kernel_does_not_take() -> None:
    """A tensor off the CPU goes to the kernel or raises: here a meta
    tensor (no card needed) must raise, never fall back."""
    q = torch.empty(1, 4, 128, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(1, 2, 128, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, k, k, 0.125, True)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_fwd(q[..., :48], k[..., :48], k[..., :48], 0.125, True)
    with pytest.raises(ValueError, match="Sq == Sk"):
        tfa.flash_fwd(q, k[:, :, :64], k[:, :, :64], 0.125, True)
