"""Llama-3-family transformer as a torch ``nn.Module``.

The port of ``torchft_tpu/models/llama.py``, with the same math: RMSNorm
statistics in f32, split-half (not interleaved) RoPE, grouped-query
attention, a SiLU-gated FFN, f32 logits and a mean next-token
cross-entropy.  Weights live in ``cfg.dtype`` (bf16 by default) and the
norm weights in f32, as in the JAX ``init``.

Attention dispatches like the JAX model's ``_use_flash``: the fused flash
kernels (``ops/flash_attention.py``) when the shapes allow and
``TORCHFT_FLASH`` does not say 0, the naive path otherwise.  ``auto``
(unset) means the CUDA kernels on a CUDA device and the naive path on the
CPU; ``TORCHFT_FLASH=1`` forces flash, whose plain version runs on the CPU.

Sequence parallelism, remat and MoE are not part of the port yet.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_hidden: int = 14_336
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16
    # sequence parallelism (ring attention) is not ported; set -> raises
    sp_axis: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama_debug() -> LlamaConfig:
    """Tiny config for tests (the JAX package's ``llama_debug``)."""
    return LlamaConfig(
        vocab_size=512,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=128,
        max_seq_len=256,
        dtype=torch.float32,
    )


def flash_blocks(seq: int) -> Tuple[int, int]:
    """(block_q, block_k): ``TORCHFT_FLASH_BLOCK_Q/K`` (default 512) clamped
    to the sequence length; a malformed or non-positive override falls back
    to 512, exactly as the JAX model's ``_flash_blocks``."""

    def _env(name: str) -> int:
        try:
            v = int(os.environ.get(name, "512"))
        except ValueError:
            return 512
        return v if v > 0 else 512

    return (
        min(seq, _env("TORCHFT_FLASH_BLOCK_Q")),
        min(seq, _env("TORCHFT_FLASH_BLOCK_K")),
    )


def use_flash(seq: int, device: torch.device) -> bool:
    """The attention dispatch gate: ``TORCHFT_FLASH`` = 0 kills flash, 1
    forces it, unset = auto (CUDA only).  Flash needs seq ≥ 128, seq % 8
    == 0 and seq divisible by the resolved block sizes — the JAX gate, so
    the same shapes go to flash in both packages."""
    env = os.environ.get("TORCHFT_FLASH", "")
    if env == "0":
        return False
    block_q, block_k = flash_blocks(seq)
    if seq < 128 or seq % 8 or seq % block_q or seq % block_k:
        return False
    if env == "1":
        return True
    return device.type == "cuda"


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((x32 / rms) * weight).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]: rotate the split halves (x1, x2) by the angles."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def naive_attention(q, k, v, causal: bool = True) -> torch.Tensor:
    """Reference GQA attention, q [B,S,H,D], k/v [B,S,KV,D] → [B,S,H,D]:
    K/V repeated to H heads, the whole score matrix materialized."""
    groups = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(groups, dim=2)
    v = v.repeat_interleave(groups, dim=2)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        seq = q.shape[1]
        mask = torch.tril(torch.ones(seq, seq, dtype=torch.bool, device=q.device))
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device: torch.device) -> None:
        super().__init__()
        hd, dt = cfg.head_dim, cfg.dtype

        def linear(fan_in: int, fan_out: int) -> nn.Linear:
            return nn.Linear(fan_in, fan_out, bias=False, device=device, dtype=dt)

        self.cfg = cfg
        self.wq = linear(cfg.dim, cfg.n_heads * hd)
        self.wk = linear(cfg.dim, cfg.n_kv_heads * hd)
        self.wv = linear(cfg.dim, cfg.n_kv_heads * hd)
        self.wo = linear(cfg.n_heads * hd, cfg.dim)
        self.w_gate = linear(cfg.dim, cfg.ffn_hidden)
        self.w_up = linear(cfg.dim, cfg.ffn_hidden)
        self.w_down = linear(cfg.ffn_hidden, cfg.dim)
        self.attn_norm = nn.Parameter(torch.ones(cfg.dim, device=device))
        self.mlp_norm = nn.Parameter(torch.ones(cfg.dim, device=device))

    def _attention(self, q, k, v) -> torch.Tensor:
        seq = q.shape[1]
        if use_flash(seq, q.device):
            from torchft_tpu_torch.ops.flash_attention import flash_attention

            block_q, block_k = flash_blocks(seq)
            return flash_attention(q, k, v, causal=True, block_q=block_q, block_k=block_k)
        return naive_attention(q, k, v, causal=True)

    def forward(self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.head_dim
        cos, sin = rope
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = apply_rope(self.wq(h).view(B, S, cfg.n_heads, hd), cos, sin)
        k = apply_rope(self.wk(h).view(B, S, cfg.n_kv_heads, hd), cos, sin)
        v = self.wv(h).view(B, S, cfg.n_kv_heads, hd)
        x = x + self.wo(self._attention(q, k, v).reshape(B, S, cfg.n_heads * hd))
        h = rms_norm(x, self.mlp_norm, cfg.norm_eps)
        return x + self.w_down(F.silu(self.w_gate(h)) * self.w_up(h))


class Llama(nn.Module):
    """tokens [B, S] → logits [B, S, vocab] (f32); :meth:`loss` is the mean
    next-token cross-entropy of ``(tokens, targets)``."""

    def __init__(
        self,
        config: LlamaConfig,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if config.sp_axis is not None:
            raise NotImplementedError(
                "sequence parallelism lands in a later slice of the port"
            )
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Llama: CUDA requested but not available (pass device='cpu')")
        self.config = config
        cfg = config
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.dim, device=device, dtype=cfg.dtype)
        )
        self.layers = nn.ModuleList(LlamaLayer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, device=device))
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, device=device, dtype=cfg.dtype)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 1/fan_in) weights (the JAX ``init``'s distribution — not its
        numbers: ``jax.random`` and torch generators differ), unit norms."""
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
                continue
            fan_in = p.shape[1]  # embed: [vocab, dim]; nn.Linear: [out, in]
            w = torch.empty(p.shape, device=p.device, dtype=torch.float32)
            w.normal_(generator=generator).div_(float(np.sqrt(fan_in)))
            p.copy_(w)

    def rope(self, seq: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        half = cfg.head_dim // 2
        freqs = 1.0 / (
            cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half)
        )
        angles = torch.arange(seq, device=device, dtype=torch.float32)[None, :, None] * freqs
        return torch.cos(angles), torch.sin(angles)  # [1, S, half]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = F.embedding(tokens, self.embed).to(cfg.dtype)
        rope = self.rope(tokens.shape[1], tokens.device)
        for layer in self.layers:
            x = layer(x, rope)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.lm_head(x).float()

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logits = self(tokens)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))


# ---------------------------------------------------------------------------
# conversion from / to the JAX package's parameter pytree (numpy leaves)
# ---------------------------------------------------------------------------

_LINEAR = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """numpy leaf → tensor; a bfloat16 leaf (an extension dtype named
    ``bfloat16``) is reinterpreted through its 16-bit pattern, so no
    extension-dtype package is needed here."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``Llama.init`` pytree (numpy leaves) as this module's
    ``state_dict``: the leading ``n_layers`` dim of each stacked layer leaf
    is unstacked, and ``[in, out]`` matrices become ``nn.Linear``'s
    ``[out, in]``."""
    out = {"embed": _to_tensor(tree["embed"]), "final_norm": _to_tensor(tree["final_norm"])}
    out["lm_head.weight"] = _to_tensor(tree["lm_head"]).t().contiguous()
    layers = tree["layers"]
    for name, stacked in layers.items():
        for i in range(stacked.shape[0]):
            t = _to_tensor(stacked[i])
            if name in _LINEAR:
                out[f"layers.{i}.{name}.weight"] = t.t().contiguous()
            elif name in _NORMS:
                out[f"layers.{i}.{name}"] = t
            else:
                raise ValueError(f"unknown Llama layer parameter {name!r}")
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:  # numpy has no bf16: widen exactly to f32
        t = t.float()
    return t.numpy()


def params_to_numpy(state: Dict[str, torch.Tensor], n_layers: int) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax` (any ``state_dict`` or gradient
    dict keyed like one) into the JAX pytree layout with numpy leaves;
    bf16 leaves widen to f32."""
    layers: Dict[str, np.ndarray] = {}
    for name in _LINEAR + _NORMS:
        key = "weight" if name in _LINEAR else None
        per_layer = []
        for i in range(n_layers):
            t = state[f"layers.{i}.{name}.{key}" if key else f"layers.{i}.{name}"]
            per_layer.append(_to_numpy(t.t() if key else t))
        layers[name] = np.stack(per_layer)
    return {
        "embed": _to_numpy(state["embed"]),
        "layers": layers,
        "final_norm": _to_numpy(state["final_norm"]),
        "lm_head": _to_numpy(state["lm_head.weight"].t()),
    }
