"""The port's Llama (torchft_tpu_torch/models/llama.py) held against the
JAX package's: parameter conversion both ways, and loss plus every gradient
against ``jax.value_and_grad(Llama.loss)`` at ``llama_debug`` size.

Tolerances: f32 on both sides, seq 128.  The loss agrees to 1e-5 relative;
gradients to rtol 2e-4 / atol 1e-5, the JAX package's own tolerance between
its flash and naive paths (summation order differs in every matmul).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchft_tpu.models import llama as jllama
from torchft_tpu_torch.models import llama as tllama


def _jax_params(cfg, seed=0):
    params = jllama.Llama(cfg).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(cfg, B=2, S=128, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S))
    return tokens, np.roll(tokens, -1, axis=1)


def test_presets_match_the_jax_package() -> None:
    for name in ("llama3_8b", "llama_debug"):
        j, t = getattr(jllama, name)(), getattr(tllama, name)()
        for field in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                      "ffn_hidden", "rope_theta", "norm_eps", "max_seq_len"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert t.head_dim == j.head_dim


def test_params_from_jax_round_trips() -> None:
    cfg = jllama.llama_debug()
    params = _jax_params(cfg)
    model = tllama.Llama(tllama.llama_debug(), device="cpu")
    model.load_state_dict(tllama.params_from_jax(params))
    back = tllama.params_to_numpy(model.state_dict(), cfg.n_layers)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_params_from_jax_takes_bf16_leaves_by_their_bit_pattern() -> None:
    cfg = dataclasses.replace(jllama.llama_debug(), dtype=jnp.bfloat16)
    params = _jax_params(cfg)
    assert params["embed"].dtype.name == "bfloat16"
    state = tllama.params_from_jax(params)
    assert state["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        state["embed"].float().numpy(), params["embed"].astype(np.float32)
    )
    np.testing.assert_array_equal(
        state["layers.1.wq.weight"].float().numpy(),
        params["layers"]["wq"][1].astype(np.float32).T,
    )
    model = tllama.Llama(
        dataclasses.replace(tllama.llama_debug(), dtype=torch.bfloat16), device="cpu"
    )
    model.load_state_dict(state)  # dtypes and shapes line up with the module


@pytest.mark.parametrize("flash", ["0", "1"], ids=["naive", "flash"])
def test_loss_and_grads_match_jax(monkeypatch, flash) -> None:
    monkeypatch.setenv("TORCHFT_FLASH", flash)
    cfg = jllama.llama_debug()
    params = _jax_params(cfg)
    tokens, targets = _batch(cfg)
    jmodel = jllama.Llama(cfg)
    assert jmodel._use_flash(tokens.shape[1]) == (flash == "1")
    loss_j, grads_j = jax.value_and_grad(jmodel.loss)(
        params, (jnp.asarray(tokens), jnp.asarray(targets))
    )

    model = tllama.Llama(tllama.llama_debug(), device="cpu")
    model.load_state_dict(tllama.params_from_jax(params))
    loss_t = model.loss(torch.from_numpy(tokens), torch.from_numpy(targets))
    loss_t.backward()
    grads_t = tllama.params_to_numpy(
        {name: p.grad for name, p in model.named_parameters()}, cfg.n_layers
    )

    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-5)
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(grads_j),
        jax.tree_util.tree_leaves_with_path(grads_t),
    ):
        np.testing.assert_allclose(b, np.asarray(a), rtol=2e-4, atol=1e-5, err_msg=str(path))


def test_flash_and_naive_paths_agree(monkeypatch) -> None:
    cfg = tllama.llama_debug()
    model = tllama.Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    tokens, targets = (torch.from_numpy(a) for a in _batch(cfg, S=256))
    losses = []
    for flash in ("0", "1"):
        monkeypatch.setenv("TORCHFT_FLASH", flash)
        with torch.no_grad():
            losses.append(float(model.loss(tokens, targets)))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_sequence_parallelism_is_refused() -> None:
    """Sequence parallelism without a mesh to ring over is refused when the
    model runs (with one, ``tests/test_torch_ring_attention.py``)."""
    cfg = dataclasses.replace(tllama.llama_debug(), sp_axis="sp")
    model = tllama.Llama(cfg, device="cpu")
    tokens = torch.zeros(1, 128, dtype=torch.int64)
    with pytest.raises(ValueError, match="needs a mesh"):
        model.loss(tokens, tokens)


def test_cuda_is_the_default_device() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tllama.Llama(tllama.llama_debug())
