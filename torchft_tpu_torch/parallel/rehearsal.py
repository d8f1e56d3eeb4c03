"""Scale rehearsal: check a pod-scale layout of the port without the cards.

The port of ``torchft_tpu/parallel/rehearsal.py``.  The JAX package traces
and SPMD-lowers the real train step over an ``AbstractMesh`` with no
devices; the port does the same over a ``DeviceMesh`` of N ranks with no
devices.  For one (model, optimizer, mesh, batch, sequence) :func:`rehearse`
checks:

1. **What the port's layout cannot take** (``divisibility_errors``).  The
   batch must divide by dp·fsdp and the sequence by sp; the layers by pp
   (a ``PipelinedLlama``), the experts by ep (a ``LlamaMoE``), and each
   tensor-parallel split by tp: the FFN (column-parallel w_gate / w_up,
   row-parallel w_down) and the vocabulary (the embedding and the head).
   Heads that do not divide by tp are no error: the attention projections
   stay whole (ROADMAP §C5).  FSDP2 pads an uneven dim 0, so no FSDP split
   is an error.  Unlike the JAX package, pp > 1 on a model that is not
   pipelined and ep > 1 on one without experts are errors
   (``hsdp.shard_model`` refuses them; the JAX specs replicate over them).
2. **Memory per card** (``bytes_per_device``), arithmetic only, so that
   ``plan_surviving`` can rehearse many layouts: the parameters each rank
   holds after the TP plan and FSDP2 (rank 0's shard, FSDP2's padding
   included), the gradients as many, the optimizer's state as a probe of
   ``optimizer`` says (AdamW: two moments in the parameter's dtype and a
   step count per parameter), and the JAX package's activation estimate
   (:func:`activation_estimate`, its remat table unchanged), against the
   card's memory (:data:`CHIP_HBM_BYTES`).  ``ok`` needs under 80%.  Under
   sp > 1 FSDP2 shards the parameters over fsdp·sp, where the JAX package
   replicates them over sp.
3. **Lowering** (``lower=True``): in a subprocess (one process holds one
   default process group), a ``fake`` process group of N ranks
   (``FakeStore``) and a CPU ``DeviceMesh`` over it; the model is built on
   ``meta``, sharded by ``shard_model``, made real under
   ``FakeTensorMode`` (``to_empty``: FSDP2 refuses meta parameters), and
   one ``make_grad_step`` (forward and backward) and one optimizer step
   run.  The local shapes it sees must add up to the arithmetic's bytes;
   a mismatch is an error.  Attention traces its plain version there (the
   kernels launch only on a card; :func:`quant_kernel_reports` launches
   them).

``python -m torchft_tpu_torch.parallel.rehearsal`` prints the table of the
JAX package's three baseline configurations against the H100, lowered,
and, on a machine with a card, :func:`quant_kernel_reports`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# Memory per card (bytes): NVIDIA's data sheet for the H100 80GB.
CHIP_HBM_BYTES: Dict[str, float] = {"h100": 80e9}
# the share of the card's memory a layout may fill and still be ok
HBM_FIT = 0.8

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass
class RehearsalReport:
    name: str
    mesh_axes: Dict[str, int]
    n_devices: int
    chip: str
    ok: bool
    divisibility_errors: List[str] = field(default_factory=list)
    bytes_per_device: Dict[str, float] = field(default_factory=dict)
    hbm_bytes: float = 0.0
    hbm_frac: float = 0.0
    lowered_grad: bool = False
    lowered_update: bool = False
    remat: str = "none"
    error: Optional[str] = None

    def summary(self) -> str:
        gb = {k: f"{v / 1e9:.1f}" for k, v in self.bytes_per_device.items()}
        status = "OK" if self.ok else "FAIL"
        return (
            f"{self.name}: {status} mesh={self.mesh_axes} "
            f"({self.n_devices} {self.chip} cards) "
            f"GB/device: params={gb.get('params')} grads={gb.get('grads')} "
            f"opt={gb.get('opt_state')} acts~={gb.get('activations_est')} "
            f"total={gb.get('total')} of {self.hbm_bytes / 1e9:.0f} "
            f"({self.hbm_frac:.0%})"
            + (f" error={self.error}" if self.error else "")
            + (f" divisibility={self.divisibility_errors}" if self.divisibility_errors else "")
        )


# ---------------------------------------------------------------------------
# the model as the rehearsal sees it: its class and config, built on meta
# ---------------------------------------------------------------------------

_KINDS = ("Llama", "LlamaMoE", "PipelinedLlama")


def _model_spec(model: Any) -> Dict[str, Any]:
    """What rebuilds ``model`` in another process: its class, config and
    pipeline settings."""
    from torchft_tpu_torch.models.llama_moe import config_to_json

    kind = type(model).__name__
    if kind not in _KINDS:
        raise TypeError(f"rehearse takes a Llama, LlamaMoE or PipelinedLlama, not {kind}")
    spec: Dict[str, Any] = {"kind": kind, "cfg": config_to_json(model.config)}
    if kind == "PipelinedLlama":
        spec.update(pp=model.num_stages, microbatches=model.num_microbatches)
    return spec


def _build_meta(spec: Dict[str, Any]) -> Any:
    from torchft_tpu_torch.models.llama import Llama
    from torchft_tpu_torch.models.llama_moe import LlamaMoE, config_from_json
    from torchft_tpu_torch.parallel.pipeline import PipelinedLlama

    cfg = config_from_json(spec["cfg"])
    if spec["kind"] == "PipelinedLlama":
        return PipelinedLlama(cfg, "meta", pp=spec["pp"], num_microbatches=spec["microbatches"])
    return (LlamaMoE if spec["kind"] == "LlamaMoE" else Llama)(cfg, "meta")


def _optimizer_spec(optimizer: Callable) -> Dict[str, Any]:
    """A ``torch.optim`` optimizer as its class name and defaults, read off
    one built over a probe parameter."""
    opt = optimizer([torch.nn.Parameter(torch.zeros(1))])
    return {"name": type(opt).__name__, "defaults": dict(opt.defaults)}


def _optimizer_from(spec: Dict[str, Any]) -> Callable:
    import inspect

    cls = getattr(torch.optim, spec["name"])
    accepted = inspect.signature(cls).parameters
    kwargs = {k: v for k, v in spec["defaults"].items() if k in accepted}

    def make(params):
        return cls(params, **kwargs)

    return make


def _opt_state_layout(optimizer: Callable, dtype: torch.dtype) -> Tuple[float, int]:
    """(bytes of state per byte of a parameter of ``dtype``, bytes of state
    that do not scale with it): one step on a probe parameter, each state
    tensor shaped like the parameter counted as mirroring it."""
    p = torch.nn.Parameter(torch.zeros(8, dtype=dtype))
    p.grad = torch.zeros_like(p)
    opt = optimizer([p])
    opt.step()
    per_byte, fixed = 0.0, 0
    for v in opt.state[p].values():
        if not isinstance(v, torch.Tensor):
            continue
        if v.shape == p.shape:
            per_byte += v.element_size() / p.element_size()
        else:
            fixed += v.numel() * v.element_size()
    return per_byte, fixed


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------


def _axes(mesh_axes: Dict[str, int]) -> Dict[str, int]:
    out = {name: 1 for name in ("pp", "dp", "fsdp", "ep", "sp", "tp")}
    unknown = set(mesh_axes) - set(out)
    if unknown:
        raise ValueError(f"unknown mesh axes {sorted(unknown)}")
    out.update(mesh_axes)
    return out


def _local_shape(name: str, shape: Tuple[int, ...], model: Any, ax: Dict[str, int],
                 errors: List[str]) -> Tuple[int, ...]:
    """Rank 0's shape of parameter ``name`` under the port's layout: the TP
    plan of ``Llama.param_specs`` (and the vocabulary split of
    ``shard_embed``), the experts split over ep, then FSDP2's split of dim
    0 over fsdp·sp (padded: the first rank holds the rounded-up share),
    except for the parameters it leaves whole (``hsdp.whole_params``)."""
    tp, ep = ax["tp"], ax["ep"]
    local = list(shape)
    leaf = name.split(".")[-2] if name.endswith(".weight") else name.split(".")[-1]

    def split(dim: int, n: int, what: str) -> None:
        if n == 1:
            return
        if local[dim] % n:
            errors.append(f"{name}: dim {dim} ({local[dim]}) not divisible by {what}={n}")
        local[dim] = -(-local[dim] // n)

    if ".moe." in name:
        if leaf in ("w_up", "w_down"):
            split(0, ep, "ep")
        return tuple(local)
    if name.endswith("norm"):
        return tuple(local)
    if leaf in ("embed", "lm_head", "w_gate", "w_up"):
        split(0, tp, "tp")
    elif leaf == "w_down":
        split(1, tp, "tp")
    elif leaf in ("wq", "wk", "wv") and model.heads_shard(tp):
        split(0, tp, "tp")
    elif leaf == "wo" and model.heads_shard(tp):
        split(1, tp, "tp")
    shard = ax["fsdp"] * ax["sp"]
    local[0] = -(-local[0] // shard)
    return tuple(local)


def _layout_bytes(model: Any, ax: Dict[str, int],
                  errors: List[str]) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name → (rank 0's local shape, dtype) for the parameters a rank of
    stage 0 holds."""
    cfg = model.config
    pp = ax["pp"]
    per_stage = cfg.n_layers // pp if cfg.n_layers % pp == 0 else cfg.n_layers
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers" and int(parts[1]) >= per_stage:
            continue  # another stage's layer
        out[name] = (_local_shape(name, tuple(p.shape), model, ax, errors), p.dtype)
    return out


def activation_estimate(config: Any, batch: int, seq: int, mesh_axes: Dict[str, int]) -> float:
    """Rough activation bytes per card for the train step (the JAX
    package's ``_activation_estimate``, unchanged).

    With per-layer remat the backward keeps the residual stream at every
    layer boundary (``n_layers × B_loc × S_loc × dim``, bf16) and one
    layer's recompute working set (qkv/o projections and FFN
    intermediates); without remat every layer's intermediates stay live.
    Logits (``B_loc × S_loc × vocab_loc``, f32) dominate the loss head.
    Assumes flash attention (no materialized score matrices).  An estimate:
    under 80% of the card counts as fitting."""
    bp = mesh_axes.get("dp", 1) * mesh_axes.get("fsdp", 1)
    sp = mesh_axes.get("sp", 1)
    tp = mesh_axes.get("tp", 1)
    b_loc = max(1, batch // bp)
    s_loc = max(1, seq // sp)
    bf16 = 2
    L = config.n_layers
    boundaries = L * b_loc * s_loc * config.dim * bf16
    qkv = 4 * b_loc * s_loc * (config.n_heads // tp) * config.head_dim * bf16
    ffn = 3 * b_loc * s_loc * (config.ffn_hidden // tp) * bf16
    logits = b_loc * s_loc * (config.vocab_size // tp) * 4
    live = {
        "none": L * (qkv + ffn),
        "layer": 2 * (qkv + ffn),
        "attn": L * ffn + 2 * qkv,  # attention side recomputed
        "ffn": L * qkv + 2 * ffn,  # FFN side recomputed
    }[config.effective_remat_mode]
    return float(boundaries + live + logits)


def _nbytes(shape: Tuple[int, ...], dtype: torch.dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def rehearse(
    model: Any,
    optimizer: Optional[Callable] = None,
    mesh_axes: Optional[Dict[str, int]] = None,
    batch: int = 8,
    seq: int = 2048,
    name: str = "config",
    chip: str = "h100",
    lower: bool = True,
) -> RehearsalReport:
    """Check one (model, optimizer, mesh, workload) layout with no cards.
    ``model`` is a ``Llama``, ``LlamaMoE`` or ``PipelinedLlama`` (build it
    on ``device="meta"``; only its class and config are read);
    ``optimizer`` builds a ``torch.optim`` optimizer from parameters
    (default ``hsdp.adamw()``)."""
    return _rehearse_many([(model, optimizer, mesh_axes or {}, batch, seq, name, chip)], lower)[0]


def _arithmetic(model, optimizer, mesh_axes, batch, seq, name, chip) -> Tuple[RehearsalReport, Dict]:
    from torchft_tpu_torch.parallel.hsdp import adamw

    optimizer = optimizer or adamw()
    ax = _axes(mesh_axes)
    spec = _model_spec(model)
    meta = _build_meta(spec)
    cfg = meta.config
    report = RehearsalReport(
        name=name, mesh_axes=dict(mesh_axes), n_devices=math.prod(ax.values()), chip=chip,
        ok=False, hbm_bytes=CHIP_HBM_BYTES[chip], remat=cfg.effective_remat_mode,
    )
    errors = report.divisibility_errors
    bp = ax["dp"] * ax["fsdp"]
    if batch % bp:
        errors.append(f"batch {batch} % dp*fsdp {bp}")
    if seq % ax["sp"]:
        errors.append(f"seq {seq} % sp {ax['sp']}")
    if ax["pp"] > 1:
        if spec["kind"] != "PipelinedLlama":
            errors.append(f"pp={ax['pp']} needs a PipelinedLlama, not a {spec['kind']}")
        if cfg.n_layers % ax["pp"]:
            errors.append(f"n_layers {cfg.n_layers} % pp {ax['pp']}")
    if spec["kind"] == "PipelinedLlama" and batch % bp == 0 and (batch // bp) % spec["microbatches"]:
        errors.append(f"rows per rank {batch // bp} % microbatches {spec['microbatches']}")
    if ax["ep"] > 1:
        if spec["kind"] != "LlamaMoE":
            errors.append(f"ep={ax['ep']} needs a LlamaMoE, not a {spec['kind']}")
        elif (batch // max(bp, 1)) * (seq // ax["sp"]) % ax["ep"]:
            errors.append(f"tokens per rank do not split over ep {ax['ep']}")
    layout = _layout_bytes(meta, ax, errors)
    params_b = float(sum(_nbytes(shape, dt) for shape, dt in layout.values()))
    opt_b = 0.0
    for dtype in {dt for _, dt in layout.values()}:
        per_byte, fixed = _opt_state_layout(optimizer, dtype)
        same = [(s, d) for s, d in layout.values() if d == dtype]
        opt_b += per_byte * sum(_nbytes(s, d) for s, d in same) + fixed * len(same)
    acts_b = activation_estimate(cfg, batch, seq, mesh_axes)
    total = params_b * 2 + opt_b + acts_b  # gradients mirror the parameters
    report.bytes_per_device = {
        "params": params_b, "grads": params_b, "opt_state": opt_b,
        "activations_est": acts_b, "total": total,
    }
    report.hbm_frac = total / report.hbm_bytes
    job = dict(model=spec, optimizer=_optimizer_spec(optimizer), mesh_axes=ax, batch=batch,
               seq=seq)
    return report, job


def _rehearse_many(configs: List[tuple], lower: bool) -> List[RehearsalReport]:
    reports, jobs = [], []
    for cfg in configs:
        report, job = _arithmetic(*cfg)
        reports.append(report)
        jobs.append(job if lower and not report.divisibility_errors else None)
    todo = [(r, j) for r, j in zip(reports, jobs) if j is not None]
    if todo:
        for (report, _), seen in zip(todo, _lower_in_subprocess([j for _, j in todo])):
            report.lowered_grad = seen.get("lowered_grad", False)
            report.lowered_update = seen.get("lowered_update", False)
            report.error = seen.get("error")
            if report.error is None:
                for key in ("params", "opt_state"):
                    want, got = report.bytes_per_device[key], seen[f"{key}_bytes"]
                    if want != got:
                        report.error = (f"the arithmetic's {key} bytes ({want:.0f}) differ from "
                                        f"the lowering's local shapes ({got:.0f})")
    for report in reports:
        report.ok = bool(
            not report.divisibility_errors
            and not report.error
            and report.hbm_frac < HBM_FIT
            and (not lower or (report.lowered_grad and report.lowered_update))
        )
    return reports


# ---------------------------------------------------------------------------
# lowering: the real grad and update steps over a fake process group
# ---------------------------------------------------------------------------


def _lower_in_subprocess(jobs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Run :func:`_lower_one` on each job in one fresh interpreter (each
    job its own fake process group)."""
    with tempfile.TemporaryDirectory(prefix="rehearsal_") as tmp:
        path = os.path.join(tmp, "jobs.json")
        with open(path, "w") as f:
            json.dump(jobs, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        proc = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.parallel.rehearsal",
                               "--lower-jobs", path], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"the rehearsal's lowering process failed:\n{proc.stderr[-4000:]}")
        with open(path + ".out") as f:
            return json.load(f)


def _lower_one(job: Dict[str, Any]) -> Dict[str, Any]:
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from torchft_tpu_torch.parallel.hsdp import make_grad_step, shard_model, sharded_opt_init
    from torchft_tpu_torch.parallel.mesh import make_mesh

    ax = job["mesh_axes"]
    out: Dict[str, Any] = {"lowered_grad": False, "lowered_update": False, "error": None}
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(ax.values()))
    try:
        mesh = make_mesh(device_type="cpu", **ax)
        model = _build_meta(job["model"])
        if model.config.sp_axis is None and ax["sp"] > 1:
            model = _build_meta({**job["model"], "cfg": {**job["model"]["cfg"], "sp_axis": "sp"}})
        shard_model(model, mesh)

        def local(t):
            return t.to_local() if isinstance(t, DTensor) else t

        with FakeTensorMode(allow_non_fake_inputs=True):
            model.to_empty(device="cpu")
            tokens = torch.zeros(job["batch"], job["seq"], dtype=torch.long)
            make_grad_step(model, mesh)(tokens, tokens)
            out["lowered_grad"] = True
            opt = sharded_opt_init(_optimizer_from(job["optimizer"])(model.parameters()))
            opt.step()
            out["lowered_update"] = True
            out["params_bytes"] = float(sum(local(p).numel() * p.element_size()
                                            for p in model.parameters()))
            out["opt_state_bytes"] = float(sum(
                local(v).numel() * v.element_size()
                for state in opt.state.values() for v in state.values()
                if isinstance(v, torch.Tensor)))
    except Exception as e:  # noqa: BLE001 — the report is the output
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# the baseline configurations and the kernels on the card
# ---------------------------------------------------------------------------

# (name, preset, mesh axes per replica group, batch per group): the JAX
# package's BASELINE configs 2, 3 and 5 (``torchft_tpu/parallel/rehearsal.py``
# ``baseline_reports``), at sequence 8192 with per-layer remat, one card per
# rank; their widths and meshes are the JAX package's, the card the H100
BASELINES = (
    ("config2_8b_ddp_8xh100_4groups", "llama3_8b", {"dp": 1, "fsdp": 8, "tp": 1}, 8),
    ("config3_8b_hsdp_16xh100_4groups", "llama3_8b", {"dp": 1, "fsdp": 8, "tp": 2}, 16),
    ("config5_70b_hsdp_64xh100_4groups", "llama3_70b", {"dp": 1, "fsdp": 16, "tp": 4}, 16),
)
BASELINE_SEQ = 8192


def baseline_reports(lower: bool = True, chip: str = "h100") -> List[RehearsalReport]:
    """The JAX package's baseline configs 2, 3 and 5 against the H100: 8B
    at fsdp = 8 (batch 8), 8B at fsdp = 8 × tp = 2 (batch 16), 70B at
    fsdp = 16 × tp = 4 (batch 16), sequence 8192, remat "layer", AdamW;
    lowered in one subprocess when ``lower``."""
    from torchft_tpu_torch.models.llama import Llama, llama3_70b, llama3_8b

    presets = {"llama3_8b": llama3_8b, "llama3_70b": llama3_70b}
    configs = [
        (Llama(dataclasses.replace(presets[preset](), remat=True), "meta"), None, axes, batch,
         BASELINE_SEQ, name, chip)
        for name, preset, axes, batch in BASELINES
    ]
    return _rehearse_many(configs, lower)


def _flash_cases() -> List[Tuple[str, int, int]]:
    """(config name, heads, KV heads) each rank of a baseline config runs."""
    from torchft_tpu_torch.models.llama import llama3_70b, llama3_8b

    presets = {"llama3_8b": llama3_8b(), "llama3_70b": llama3_70b()}
    return [(name, presets[p].n_heads // axes["tp"], presets[p].n_kv_heads // axes["tp"])
            for name, p, axes, _ in BASELINES]


FLASH_SEQ = 1024  # the sequence of the flash launches of quant_kernel_reports
# each flash kernel against its plain version on the same inputs (bf16
# outputs compared in f32): elementwise |err| <= ATOL + RTOL·|plain| and
# normwise <= NORM_RTOL; the f32 lse within LSE_ATOL (chip_smoke.py's bounds)
FLASH_ATOL, FLASH_RTOL, FLASH_NORM_RTOL, FLASH_LSE_ATOL = 5e-3, 2e-2, 1e-2, 1e-3


def _flash_agrees(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if name == "lse":
        bad = not bool(torch.isfinite(got).all()) or bool((err > FLASH_LSE_ATOL).any())
    else:
        norm_rel = float(err.norm() / want.norm().clamp_min(1e-30))
        bad = (not bool(torch.isfinite(got).all())
               or bool((err > FLASH_ATOL + FLASH_RTOL * want.abs()).any())
               or norm_rel > FLASH_NORM_RTOL)
    if bad:
        raise AssertionError(f"flash {name} differs from its plain version: max |err| "
                             f"{float(err.max()):.4g}")
    return float(err.max())


def quant_kernel_reports() -> List[Dict[str, Any]]:
    """Launch each kernel of the card once and hold it against its plain
    version (the counterpart of the JAX package's TPU lowering of its
    Pallas kernels): quantize, reduce and dequantize for int8 and fp8 at
    one block's shape (``BLOCK_ROWS`` rows of ``ROW_SIZE``), exact; and the
    flash forward, dq and dk/dv at each baseline config's per-rank heads
    (head dim 128, bf16, causal, S = :data:`FLASH_SEQ`).  Each row says
    ``launched: True``; a kernel that does not build, launch or agree
    raises, and so does a machine without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("quant_kernel_reports launches the CUDA kernels: no CUDA device")
    from torchft_tpu_torch.ops import cuda_build
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import quant as qk

    cuda_build.build([*fa.KERNEL_SOURCES, *qk.KERNEL_SOURCES])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows: List[Dict[str, Any]] = []

    def same(a: torch.Tensor, b: torch.Tensor) -> bool:
        return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

    n = qk.BLOCK_ROWS * qk.ROW_SIZE
    for kind in (qk.INT8, qk.FP8):
        x = torch.randn(n, device=dev, generator=gen)
        q, s = qk.quantize_rowwise_device(x, kind=kind)
        want = qk.quantize_rowwise_plain(x, kind=kind)
        checks = {"quantize": same(q, want[0]) and same(s, want[1])}
        qs, ss = torch.stack([q, q]), torch.stack([s, s])
        r = qk.reduce_quantized_device(qs, ss, kind)
        want = qk.reduce_quantized_plain(qs, ss, kind)
        checks["reduce"] = same(r[0], want[0]) and same(r[1], want[1])
        checks["dequantize"] = same(qk.dequantize_rowwise_device(q, s, n),
                                    qk.dequantize_rowwise_plain(q, s, n))
        for kernel, exact in checks.items():
            if not exact:
                raise AssertionError(f"{kernel} [{kind}] differs from its plain version")
            rows.append({"kernel": kernel, "kind": kind, "launched": True, "exact": True})
    scale = 1.0 / math.sqrt(128)
    block = min(512, FLASH_SEQ)  # the plain version's tiles
    for config, heads, kv in _flash_cases():
        def randn(h: int) -> torch.Tensor:  # heads-major, as the kernels take them
            return torch.randn(1, h, FLASH_SEQ, 128, device=dev, generator=gen).to(torch.bfloat16)

        q, do, k, v = randn(heads), randn(heads), randn(kv), randn(kv)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, scale, True, block, block)
        delta = fa.backward_delta(do, o_ref).contiguous()
        dq_ref = fa.flash_dq_plain(q, k, v, lse_ref, do, delta, scale, True, block, block)
        dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, lse_ref, do, delta, scale, True, block, block)
        o, lse = fa.flash_fwd(q, k, v, scale, True)
        dq = fa.flash_dq(q, k, v, lse_ref, do, delta, scale, True)
        dk, dv = fa.flash_dkv(q, k, v, lse_ref, do, delta, scale, True)
        torch.cuda.synchronize()
        errs = [_flash_agrees(name, got, want) for name, got, want in (
            ("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref), ("dk", dk, dk_ref),
            ("dv", dv, dv_ref))]
        rows.append({"kernel": "flash", "config": config, "heads": heads, "kv_heads": kv,
                     "launched": True, "max_abs_err": max(errs)})
    return rows


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lower-jobs", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.lower_jobs:
        with open(args.lower_jobs) as f:
            jobs = json.load(f)
        with open(args.lower_jobs + ".out", "w") as f:
            json.dump([_lower_one(job) for job in jobs], f)
        return
    for r in baseline_reports():
        print(r.summary(), flush=True)
    if not torch.cuda.is_available():
        print("kernels: not launched (no CUDA device; quant_kernel_reports needs one)")
        return
    for row in quant_kernel_reports():
        what = f"[{row['kind']}]" if "kind" in row else f"at {row['config']}"
        print(f"kernel {row['kernel']} {what}: launched, agrees with its plain version", flush=True)


if __name__ == "__main__":
    main()
