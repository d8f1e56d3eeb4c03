"""Llama-3-family transformer as a torch ``nn.Module``.

The port of ``torchft_tpu/models/llama.py``, with the same math: RMSNorm
statistics in f32, split-half (not interleaved) RoPE, grouped-query
attention, a SiLU-gated FFN, f32 logits and a mean next-token
cross-entropy.  Weights live in ``cfg.dtype`` (bf16 by default) and the
norm weights in f32, as in the JAX ``init``.

Attention on a CUDA device always runs the fused flash kernels
(``ops/flash_attention.py``), which take any sequence length and raise on
what they do not take; nothing there falls back to plain attention.  On the
CPU it dispatches like the JAX model's ``_use_flash``: the naive path
unless ``TORCHFT_FLASH=1`` forces flash (its plain version) on the shapes
the JAX gate lets through.

Sharding inside a replica group (``parallel/hsdp.py``): :meth:`Llama.param_specs`
is the JAX model's Megatron layout as a tensor-parallel plan over the
mesh's ``tp`` axis (wq/wk/wv and gate/up column-parallel, wo/w_down
row-parallel, the embedding and the head split over the vocabulary, the
norms replicated), and :meth:`Llama.batch_specs` splits the batch over
(dp, fsdp) and, under sequence parallelism, the sequence over sp.  Under
tensor parallelism each rank's attention runs on its
local heads (``n_heads/tp`` and ``n_kv_heads/tp``) through the same flash
kernels; when the heads do not divide by tp the attention projections stay
whole on every rank and the same kernels run on all the heads.  (The JAX
model takes its naive path there because its sharded flash entry needs
heads that divide; the port calls the bare kernels, which have no such
limit.)

Sequence parallelism (``config.sp_axis``): the model is given a mesh
(``Llama(mesh=...)``, or :func:`~torchft_tpu_torch.parallel.hsdp.shard_model`
attaches its own), each rank's forward sees its block of the sequence,
RoPE takes the block's global positions, and attention is ring attention
(``parallel/ring_attention.py``) over the mesh's sp process group, on the
flash kernels (always on a CUDA device).

Rematerialization (``config.remat`` / ``config.remat_mode``, the JAX
names): "layer" recomputes each whole layer in the backward pass, "attn"
its attention half, "ffn" its FFN half, "none" nothing; each is a
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` around that
part of :class:`LlamaLayer`.  A recomputed attention half launches the
flash forward again.  ``LlamaLayer(include_ffn=False)`` builds a layer
without its dense FFN, for a subclass with its own (``models/llama_moe.py``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

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
    # sequence parallelism: the mesh axis the sequence is split over (ring
    # attention); None keeps the whole sequence on each rank
    sp_axis: Optional[str] = None
    # rematerialization: ``remat=True`` is per-layer ("layer" mode);
    # ``remat_mode`` names the policy: "none" saves everything, "attn"
    # recomputes the attention half, "ffn" the FFN half, "layer" whole
    # layers (only the residual stream at layer boundaries is saved)
    remat: bool = False
    remat_mode: Optional[str] = None  # None: "layer" if remat else "none"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def effective_remat_mode(self) -> str:
        mode = self.remat_mode or ("layer" if self.remat else "none")
        if mode not in REMAT_MODES:
            raise ValueError(f"unknown remat_mode {mode!r}")
        return mode


REMAT_MODES = ("none", "attn", "ffn", "layer")


def llama3_8b() -> LlamaConfig:
    return LlamaConfig()


def llama3_70b() -> LlamaConfig:
    return LlamaConfig(dim=8192, n_layers=80, n_heads=64, n_kv_heads=8, ffn_hidden=28_672)


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
    """The attention dispatch gate.  On a CUDA device: True, always — the
    kernels tile by their own and mask ragged tails, so no sequence length
    sends the card to plain attention, and ``TORCHFT_FLASH=0`` raises.  On
    the CPU: the JAX gate, true only where ``TORCHFT_FLASH=1`` forces flash
    and seq ≥ 128, seq % 8 == 0 and seq divides by the resolved block sizes,
    so the same shapes go to flash in both packages."""
    env = os.environ.get("TORCHFT_FLASH", "")
    if device.type == "cuda":
        if env == "0":
            raise ValueError(
                "TORCHFT_FLASH=0 asks for plain attention, which runs only on the CPU; "
                "on a CUDA device attention runs the flash kernels"
            )
        return True
    block_q, block_k = flash_blocks(seq)
    if seq < 128 or seq % 8 or seq % block_q or seq % block_k:
        return False
    return env == "1"


def kernel_blocks(seq: int, device: torch.device) -> Tuple[int, int]:
    """(block_q, block_k) handed to the flash wrapper: :func:`flash_blocks`
    on the CPU, where they tile the plain version; the whole length on a
    CUDA device, whose kernels take their own tiles, so that the wrapper's
    divisibility check refuses no length the kernels take."""
    return (seq, seq) if device.type == "cuda" else flash_blocks(seq)


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


def _checkpoint(fn, *args):
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False)


class LlamaLayer(nn.Module):
    """One pre-norm layer: the attention half (:meth:`attn_block`) and the
    FFN half (:meth:`ffn_block`), each with its residual, as the JAX
    model's ``_attn_block`` and ``_ffn_block``.  ``include_ffn=False``
    builds no dense FFN (a subclass supplies :meth:`ffn`)."""

    def __init__(self, cfg: LlamaConfig, device: torch.device, include_ffn: bool = True) -> None:
        super().__init__()
        hd, dt = cfg.head_dim, cfg.dtype

        def linear(fan_in: int, fan_out: int) -> nn.Linear:
            return nn.Linear(fan_in, fan_out, bias=False, device=device, dtype=dt)

        self.cfg = cfg
        # the attention dispatch of the JAX pipeline (``pipeline.py``) on the
        # CPU: plain attention whatever TORCHFT_FLASH says (a CUDA device
        # always runs the kernels)
        self.cpu_flash = True
        self.wq = linear(cfg.dim, cfg.n_heads * hd)
        self.wk = linear(cfg.dim, cfg.n_kv_heads * hd)
        self.wv = linear(cfg.dim, cfg.n_kv_heads * hd)
        self.wo = linear(cfg.n_heads * hd, cfg.dim)
        if include_ffn:
            self.w_gate = linear(cfg.dim, cfg.ffn_hidden)
            self.w_up = linear(cfg.dim, cfg.ffn_hidden)
            self.w_down = linear(cfg.ffn_hidden, cfg.dim)
        self.attn_norm = nn.Parameter(torch.ones(cfg.dim, device=device))
        self.mlp_norm = nn.Parameter(torch.ones(cfg.dim, device=device))

    def _attention(self, q, k, v, sp_group: Any = None) -> torch.Tensor:
        if sp_group is not None:
            from torchft_tpu_torch.parallel.ring_attention import ring_attention

            return ring_attention(q, k, v, sp_group)
        seq = q.shape[1]
        if use_flash(seq, q.device) and (self.cpu_flash or q.device.type == "cuda"):
            from torchft_tpu_torch.ops.flash_attention import flash_attention

            block_q, block_k = kernel_blocks(seq, q.device)
            return flash_attention(q, k, v, causal=True, block_q=block_q, block_k=block_k)
        return naive_attention(q, k, v, causal=True)

    def attn_block(
        self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor], sp_group: Any = None
    ) -> torch.Tensor:
        """x + attention(rms_norm(x)): RoPE, grouped-query attention over
        this rank's heads (all of them unless tensor-parallel)."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.head_dim
        cos, sin = rope
        h = rms_norm(x, self.attn_norm, cfg.norm_eps)
        q = apply_rope(self.wq(h).view(B, S, -1, hd), cos, sin)
        k = apply_rope(self.wk(h).view(B, S, -1, hd), cos, sin)
        v = self.wv(h).view(B, S, -1, hd)
        return x + self.wo(self._attention(q, k, v, sp_group).reshape(B, S, -1))

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        """The FFN on the normed input: SiLU-gated."""
        return self.w_down(F.silu(self.w_gate(h)) * self.w_up(h))

    def ffn_block(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.ffn(rms_norm(x, self.mlp_norm, self.cfg.norm_eps))

    def _body(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              sp_group: Any) -> torch.Tensor:
        mode = self.cfg.effective_remat_mode
        rope = (cos, sin)
        if mode == "attn":
            x = _checkpoint(self.attn_block, x, rope, sp_group)
        else:
            x = self.attn_block(x, rope, sp_group)
        return _checkpoint(self.ffn_block, x) if mode == "ffn" else self.ffn_block(x)

    def forward(
        self, x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor], sp_group: Any = None
    ) -> torch.Tensor:
        """``sp_group``: the sequence-parallel process group (ring
        attention), or None."""
        if self.cfg.effective_remat_mode == "layer":
            return _checkpoint(self._body, x, *rope, sp_group)
        return self._body(x, *rope, sp_group)


class Llama(nn.Module):
    """tokens [B, S] → logits [B, S, vocab] (f32); :meth:`loss` is the mean
    next-token cross-entropy of ``(tokens, targets)``.  Under
    ``config.sp_axis`` the tokens are this rank's sequence block and
    ``mesh`` (a ``DeviceMesh`` with that axis) is required to run."""

    def __init__(
        self,
        config: LlamaConfig,
        device: Any = "cuda",
        generator: Optional[torch.Generator] = None,
        mesh: Any = None,
    ) -> None:
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Llama: CUDA requested but not available (pass device='cpu')")
        self.config = config
        self.mesh = mesh
        cfg = config
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.dim, device=device, dtype=cfg.dtype)
        )
        self.layers = nn.ModuleList(self.make_layer(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.dim, device=device))
        self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False, device=device, dtype=cfg.dtype)
        self.reset_parameters(generator)

    # whether the layers carry the dense SwiGLU FFN (w_gate, w_up, w_down)
    dense_ffn = True

    def make_layer(self, cfg: LlamaConfig, device: torch.device) -> nn.Module:
        return LlamaLayer(cfg, device)

    def blocks(self) -> List[nn.Module]:
        """The layers this module holds, in order."""
        return list(self.layers)

    def fan_in(self, name: str, p: torch.Tensor) -> int:
        """The fan-in of parameter ``name`` (embed: [vocab, dim]; an
        ``nn.Linear`` weight: [out, in])."""
        return p.shape[1]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """N(0, 1/fan_in) weights (the JAX ``init``'s distribution — not its
        numbers: ``jax.random`` and torch generators differ), unit norms."""
        for name, p in self.named_parameters():
            if name.endswith("norm"):
                p.fill_(1.0)
                continue
            fan_in = self.fan_in(name, p)
            w = torch.empty(p.shape, device=p.device, dtype=torch.float32)
            w.normal_(generator=generator).div_(float(np.sqrt(fan_in)))
            p.copy_(w)

    def rope(
        self, seq: int, device: torch.device, start: int = 0
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """cos and sin [1, seq, head_dim/2] at positions start..start+seq."""
        cfg = self.config
        half = cfg.head_dim // 2
        freqs = 1.0 / (
            cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half)
        )
        positions = torch.arange(start, start + seq, device=device, dtype=torch.float32)
        angles = positions[None, :, None] * freqs
        return torch.cos(angles), torch.sin(angles)

    def param_specs(self, tp: int) -> Dict[str, Any]:
        """The JAX ``param_specs`` Megatron layout as a
        ``parallelize_module`` plan over a ``tp``-way axis: column-parallel
        (output dim split) wq/wk/wv and gate/up, row-parallel (input dim
        split) wo/w_down, the head column-parallel over the vocabulary with
        its logits gathered; ``embed`` (vocabulary rows split) is a bare
        parameter and is placed by :meth:`shard_embed`.  The norms are not
        in the plan: replicated.  When the heads do not divide by ``tp``,
        the attention projections stay whole and attention runs on all the
        heads."""
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

        cfg = self.config
        plan: Dict[str, Any] = {"lm_head": ColwiseParallel(output_layouts=Replicate())}
        linears: Dict[str, Any] = {}
        if self.dense_ffn:
            linears.update(w_gate=ColwiseParallel(), w_up=ColwiseParallel(), w_down=RowwiseParallel())
        if self.heads_shard(tp):
            linears.update(wq=ColwiseParallel(), wk=ColwiseParallel(), wv=ColwiseParallel(),
                           wo=RowwiseParallel())
        for name, style in linears.items():
            plan[f"layers.*.{name}"] = style
        return plan

    def heads_shard(self, tp: int) -> bool:
        """Whether attention can run on ``tp``-way local heads."""
        return self.config.n_heads % tp == 0 and self.config.n_kv_heads % tp == 0

    def batch_specs(self) -> Tuple[Any, Any]:
        """(tokens, targets) specs: the batch splits over (dp, fsdp) — each
        fsdp rank processes its own batch slice — and the sequence over sp
        when ``config.sp_axis`` is set; both are replicated over tp."""
        spec = (("dp", "fsdp"), self.config.sp_axis)
        return spec, spec

    def sp_group(self) -> Any:
        """The sequence-parallel process group of the model's mesh, or None
        without sequence parallelism."""
        axis = self.config.sp_axis
        if axis is None:
            return None
        if self.mesh is None:
            raise ValueError(f"sequence parallelism over {axis!r} needs a mesh (Llama(mesh=...))")
        return self.mesh[axis].get_group()

    def shard_embed(self, tp_mesh: Any) -> None:
        """Split the embedding's vocabulary rows over ``tp_mesh`` (the JAX
        spec's ``P("tp", ...)``); :meth:`forward` looks tokens up in the
        shards and sums the partial rows."""
        from torch.distributed.tensor import Shard, distribute_tensor

        self.embed = nn.Parameter(distribute_tensor(self.embed.detach(), tp_mesh, [Shard(0)]))

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor, Replicate

        w = self.embed
        if isinstance(w, DTensor):  # vocabulary-parallel (shard_embed)
            t = DTensor.from_local(tokens, w.device_mesh, [Replicate()], run_check=False)
            return F.embedding(t, w).full_tensor()
        return F.embedding(tokens, w)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self._embed(tokens).to(cfg.dtype)
        seq = tokens.shape[1]
        sp_group = self.sp_group()
        # under sp the tokens are block i of the sequence: global positions
        start = 0 if sp_group is None else seq * self.mesh[cfg.sp_axis].get_local_rank()
        rope = self.rope(seq, tokens.device, start)
        for layer in self.blocks():
            x = layer(x, rope, sp_group)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self.lm_head(x).float()

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        logits = self(tokens)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))

    def _attn_params_per_layer(self) -> int:
        cfg = self.config
        hd = cfg.head_dim
        return (
            cfg.dim * cfg.n_heads * hd  # wq
            + 2 * cfg.dim * cfg.n_kv_heads * hd  # wk, wv
            + cfg.n_heads * hd * cfg.dim  # wo
            + 2 * cfg.dim  # norms
        )

    def _embed_params(self) -> int:
        cfg = self.config
        return cfg.vocab_size * cfg.dim * 2 + cfg.dim  # embed + lm_head + final norm

    def num_params(self) -> int:
        """The parameter count of the whole model (the JAX ``num_params``),
        from the config alone."""
        cfg = self.config
        per_layer = self._attn_params_per_layer() + 3 * cfg.dim * cfg.ffn_hidden
        return self._embed_params() + cfg.n_layers * per_layer


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
    bf16 leaves widen to f32.  A layer leaf missing from ``state`` (the
    dense FFN of a layer built without it) is left out."""
    layers: Dict[str, np.ndarray] = {}
    for name in _LINEAR + _NORMS:
        key = "weight" if name in _LINEAR else None
        if (f"layers.0.{name}.{key}" if key else f"layers.0.{name}") not in state:
            continue
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
