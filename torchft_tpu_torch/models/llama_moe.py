"""Llama with Mixture-of-Experts FFN layers (expert-parallel).

The port of ``torchft_tpu/models/llama_moe.py``: a Mixtral-style variant of
:mod:`~torchft_tpu_torch.models.llama` whose layers keep the attention half
(``LlamaLayer.attn_block``) and replace the dense SwiGLU FFN with a top-1
switch MoE (:mod:`~torchft_tpu_torch.parallel.moe`), its experts split over
the ``ep`` mesh axis by ``parallel/hsdp.py:shard_model``.  Attention,
embeddings and the head keep the dense model's Megatron layout; the MoE's
router and experts are replicated over fsdp and tp, as in the JAX
``param_specs``.  The MoE's output (f32, the combine's promotion) is cast
to ``cfg.dtype`` before the residual, as the JAX ``apply`` does.  Like the
JAX model, it applies no rematerialization.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict

import torch
from torch import nn

from torchft_tpu_torch.models import llama as _llama
from torchft_tpu_torch.models.llama import Llama, LlamaConfig, LlamaLayer
from torchft_tpu_torch.parallel.moe import MoE, MoEConfig


@dataclass(frozen=True)
class LlamaMoEConfig(LlamaConfig):
    num_experts: int = 8
    capacity_factor: float = 1.5
    ep_axis: str = "ep"


def llama_moe_debug(ep_axis: str = "ep") -> LlamaMoEConfig:
    return LlamaMoEConfig(
        vocab_size=512,
        dim=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        ffn_hidden=128,
        max_seq_len=256,
        dtype=torch.float32,
        num_experts=4,
        capacity_factor=4.0,
        ep_axis=ep_axis,
    )


def llama3_8b_moe() -> LlamaMoEConfig:
    """Llama-3-8B's widths with the config's own MoE defaults (8 experts,
    capacity factor 1.5)."""
    return LlamaMoEConfig()


class LlamaMoELayer(LlamaLayer):
    """A Llama layer whose FFN half is a switch MoE (``self.moe``)."""

    def __init__(self, cfg: LlamaMoEConfig, device: torch.device) -> None:
        super().__init__(cfg, device, include_ffn=False)
        self.moe = MoE(
            MoEConfig(dim=cfg.dim, ffn_hidden=cfg.ffn_hidden, num_experts=cfg.num_experts,
                      capacity_factor=cfg.capacity_factor, dtype=cfg.dtype),
            device=device,
        )

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        return self.moe(h).to(self.cfg.dtype)

    def forward(self, x, rope, sp_group: Any = None) -> torch.Tensor:
        return self.ffn_block(self.attn_block(x, rope, sp_group))  # no remat, as in JAX


class LlamaMoE(Llama):
    """Llama backbone with a switch MoE in every layer."""

    dense_ffn = False

    def make_layer(self, cfg: LlamaConfig, device: torch.device) -> nn.Module:
        return LlamaMoELayer(cfg, device)

    def fan_in(self, name: str, p: torch.Tensor) -> int:
        return MoE.fan_in(name, p) if ".moe." in name else super().fan_in(name, p)

    def moe_layers(self):
        return [layer.moe for layer in self.blocks()]

    def num_params(self) -> int:
        cfg: LlamaMoEConfig = self.config  # type: ignore[assignment]
        moe = cfg.dim * cfg.num_experts + cfg.num_experts * cfg.dim * cfg.ffn_hidden * 2
        return self._embed_params() + cfg.n_layers * (self._attn_params_per_layer() + moe)


def config_to_json(cfg: LlamaConfig) -> Dict[str, Any]:
    """A ``LlamaConfig`` or ``LlamaMoEConfig`` as JSON-able fields (the
    dtype by name), for another process to rebuild."""
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return out


def config_from_json(d: Dict[str, Any]) -> LlamaConfig:
    cls = LlamaMoEConfig if "num_experts" in d else LlamaConfig
    return cls(**{**d, "dtype": getattr(torch, d["dtype"])})


# ---------------------------------------------------------------------------
# conversion from / to the JAX package's parameter pytree (numpy leaves)
# ---------------------------------------------------------------------------

_MOE = ("router", "w_up", "w_down")


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ``LlamaMoE.init`` pytree (numpy leaves) as this module's
    ``state_dict``: the backbone as :func:`models.llama.params_from_jax`
    maps it, and ``moe_layers[i]``'s router, w_up and w_down (the JAX
    layouts, unchanged) as ``layers.i.moe.*``."""
    out = _llama.params_from_jax({k: v for k, v in tree.items() if k != "moe_layers"})
    for i, leaves in enumerate(tree["moe_layers"]):
        for name in _MOE:
            out[f"layers.{i}.moe.{name}"] = _llama._to_tensor(leaves[name])
    return out


def params_to_numpy(state: Dict[str, torch.Tensor], n_layers: int) -> Dict[str, Any]:
    """Inverse of :func:`params_from_jax` (any ``state_dict`` or gradient
    dict keyed like one); bf16 leaves widen to f32."""
    out = _llama.params_to_numpy(state, n_layers)
    out["moe_layers"] = [
        {name: _llama._to_numpy(state[f"layers.{i}.moe.{name}"]) for name in _MOE}
        for i in range(n_layers)
    ]
    return out
