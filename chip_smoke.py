#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``torchft_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``torchft_tpu_torch/csrc/``, then:

1. kernel phase — holds each flash-attention kernel (fwd, dq, dkv) against
   its plain PyTorch version on the card at the Llama-3-8B attention shapes
   (B=1, S=2048, H=32, KV=8, D=128, bf16, causal) and at two more cases (a
   non-causal Sq != Sk case with ragged tiles, and a GQA groups=1 case at
   D=64), and times kernel, plain version and the
   ``F.scaled_dot_product_attention`` yardstick;
2. train phase — the port's main path: two replica groups as threads
   (each its own Manager, TCPCommunicator and HTTPTransport) train Llama at
   Llama-3-8B width cut to 2 layers, bf16, B=1, S=2048, for 5 steps; replica
   1 is killed before step 2, restarts and heals from replica 0.  Every loss
   must be finite, both replicas must end at the same step with equal
   parameter hashes, and every flash kernel must have launched.

Any failure raises, so the exit code is non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import torch

# Kernel vs plain version on the same card, compared in f32.  bf16 outputs
# (o, dq, dk, dv): elementwise |err| <= ATOL + RTOL·|plain| (two roundings of
# nearly equal f32 sums to bf16 differ by at most one ulp, 2^-7·|plain|) and
# normwise ||err|| / ||plain|| <= NORM_RTOL.  lse is f32: |err| <= LSE_ATOL.
ATOL, RTOL, NORM_RTOL, LSE_ATOL = 5e-3, 2e-2, 1e-2, 1e-3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ITERS = 10  # timed launches per kernel (plain versions: 2)
STEPS = 5  # train steps; replica 1 is killed before step 2
LAYERS = 2  # Llama-3-8B depth cut from 32 so two replicas fit one card
SOURCE = "torchft_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "fwd": "torchft_tpu/ops/flash_attention.py:48",
    "dq": "torchft_tpu/ops/flash_attention.py:213",
    "dkv": "torchft_tpu/ops/flash_attention.py:243",
}
MAIN_CASE = dict(name="llama3_8b", B=1, H=32, KV=8, Sq=2048, Sk=2048, D=128, causal=True)
CASES = [
    MAIN_CASE,
    dict(name="full_rect_ragged", B=1, H=32, KV=8, Sq=1000, Sk=1800, D=128, causal=False),
    dict(name="gqa1_d64", B=2, H=8, KV=8, Sq=1024, Sk=1024, D=64, causal=True),
]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pairs(case) -> int:
    """(q, k) pairs the attention needs: the lower triangle when causal."""
    Sq, Sk = case["Sq"], case["Sk"]
    per_head = Sq * (Sq + 1) // 2 if case["causal"] else Sq * Sk
    return case["B"] * case["H"] * per_head


def _bound(case, kernel: str):
    """(bound_ms, bound_by): the larger of bytes moved (inputs read once,
    outputs written once) at the HBM rate and bf16 FLOPs at the tensor-core
    peak.  FLOPs per (q, k) pair and head dim: fwd 4 (q·k, p·v); dq 6
    (q·k, do·v, ds·k); dkv 8 (q·k, do·v, pᵀ·do, dsᵀ·q)."""
    B, H, KV, Sq, Sk, D = (case[k] for k in ("B", "H", "KV", "Sq", "Sk", "D"))
    q_bytes = B * H * Sq * D * 2
    kv_bytes = B * KV * Sk * D * 2
    row_bytes = B * H * Sq * 4
    if kernel == "fwd":
        nbytes, flops = 2 * q_bytes + 2 * kv_bytes + row_bytes, 4
    elif kernel == "dq":
        nbytes, flops = 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 6
    else:
        nbytes, flops = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 8
    flops *= _pairs(case) * D
    t_bytes, t_flops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_flops) * 1e3, ("operations" if t_flops >= t_bytes else "bytes")


def _max_err(name: str, got: torch.Tensor, want: torch.Tensor, errs: dict) -> float:
    """Hold a kernel output against its plain version (module tolerances);
    record its normwise error under ``name`` and return max |err|."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    norm_rel = (err.norm() / want.norm().clamp_min(1e-30)).item()
    if name.endswith("lse"):
        bad, tol = (err > LSE_ATOL).any(), f"{LSE_ATOL}"
    else:
        bad = (err > ATOL + RTOL * want.abs()).any() or norm_rel > NORM_RTOL
        tol = f"{ATOL} + {RTOL}·|plain| and normwise {NORM_RTOL}"
    if bad:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version, max |err| "
            f"{err.max().item():.4g}, normwise {norm_rel:.3g} (tolerance {tol})"
        )
    errs[name] = dict(max_abs=err.max().item(), norm_rel=norm_rel)
    return err.max().item()


def kernel_phase(fa, iters: int) -> dict:
    """Per case and kernel: max |kernel − plain|, kernel / plain / library
    ms, bound.  Launches made here are comparisons and are reset before the
    train phase."""
    import torch.nn.functional as F

    out = {}
    for case in CASES:
        B, H, KV, Sq, Sk, D, causal = (
            case[k] for k in ("B", "H", "KV", "Sq", "Sk", "D", "causal")
        )
        gen = torch.Generator(device="cuda").manual_seed(0)

        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

        q, do = randn(B, H, Sq, D), randn(B, H, Sq, D)
        k, v = randn(B, KV, Sk, D), randn(B, KV, Sk, D)
        dlse = torch.randn(B, H, Sq, generator=gen, device="cuda")
        scale = 1.0 / math.sqrt(D)
        bq, bk = min(512, Sq), min(512, Sk)  # the plain version's tiles

        # each kernel on the same inputs as its plain version
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, scale, causal, bq, bk)
        o, lse = fa.flash_fwd(q, k, v, scale, causal)
        delta = fa.backward_delta(do, o_ref).contiguous()
        dq_ref = fa.flash_dq_plain(q, k, v, lse_ref, do, delta, scale, causal, bq, bk)
        dk_ref, dv_ref = fa.flash_dkv_plain(q, k, v, lse_ref, do, delta, scale, causal, bq, bk)
        dq = fa.flash_dq(q, k, v, lse_ref, do, delta, scale, causal)
        dk, dv = fa.flash_dkv(q, k, v, lse_ref, do, delta, scale, causal)

        # the chain training runs: autograd through the kernels' own o and
        # lse (and an lse cotangent) against the plain fwd -> dq/dkv chain
        qa, ka, va = (t.detach().requires_grad_() for t in (q, k, v))
        o_c, lse_c = fa._FlashAttention.apply(qa, ka, va, scale, causal, bq, bk)
        dq_c, dk_c, dv_c = torch.autograd.grad((o_c, lse_c), (qa, ka, va), (do, dlse))
        delta_c = fa.backward_delta(do, o_ref, dlse).contiguous()
        dq_cref = fa.flash_dq_plain(q, k, v, lse_ref, do, delta_c, scale, causal, bq, bk)
        dk_cref, dv_cref = fa.flash_dkv_plain(
            q, k, v, lse_ref, do, delta_c, scale, causal, bq, bk)
        torch.cuda.synchronize()
        detail: dict = {}

        def err(name, got, want):
            return _max_err(f"{case['name']} {name}", got, want, detail)

        errs = {
            "fwd": max(err("fwd o", o, o_ref), err("fwd lse", lse, lse_ref)),
            "dq": max(err("dq", dq, dq_ref), err("chain dq", dq_c, dq_cref)),
            "dkv": max(err("dk", dk, dk_ref), err("dv", dv, dv_ref),
                       err("chain dk", dk_c, dk_cref), err("chain dv", dv_c, dv_cref)),
        }
        print(f"kernel errors: {json.dumps(detail)}", flush=True)

        # the library yardstick: one SDPA call forward, one backward
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        lib_fwd = _time_ms(
            lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True),
            iters,
        )
        o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)
        lib_bwd = _time_ms(
            lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do, retain_graph=True), iters
        )
        timings = {
            "fwd": (
                _time_ms(lambda: fa.flash_fwd(q, k, v, scale, causal), iters),
                _time_ms(lambda: fa.flash_fwd_plain(q, k, v, scale, causal, bq, bk), 2, 1),
                lib_fwd,
            ),
            "dq": (
                _time_ms(lambda: fa.flash_dq(q, k, v, lse_ref, do, delta, scale, causal), iters),
                _time_ms(lambda: fa.flash_dq_plain(
                    q, k, v, lse_ref, do, delta, scale, causal, bq, bk), 2, 1),
                lib_bwd,
            ),
            "dkv": (
                _time_ms(lambda: fa.flash_dkv(q, k, v, lse_ref, do, delta, scale, causal), iters),
                _time_ms(lambda: fa.flash_dkv_plain(
                    q, k, v, lse_ref, do, delta, scale, causal, bq, bk), 2, 1),
                lib_bwd,
            ),
        }
        rows = {}
        for name in ("fwd", "dq", "dkv"):
            ms, plain_ms, lib_ms = timings[name]
            bound_ms, bound_by = _bound(case, name)
            rows[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
        out[case["name"]] = rows
        print(f"kernel case {case['name']}: {json.dumps(rows)}", flush=True)
    return out


def train_phase(train_ddp, fa, card: str) -> dict:
    """The port's main path: 2 replica threads at Llama-3-8B width with a
    kill and heal; the launch counts cover exactly this run."""
    steps, layers = STEPS, LAYERS
    cfg = train_ddp.model_config("llama3_8b", layers)
    device = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    results = train_ddp.run_fleet(
        cfg, device, replicas=2, steps=steps, batch=1, seq=2048, kill_at=(1, 2)
    )
    wall_s = time.perf_counter() - t0
    launches = dict(fa.launches)
    for i, r in enumerate(results):
        if not all(math.isfinite(x) for x in r.losses):
            raise AssertionError(f"replica {i}: non-finite loss in {r.losses}")
        if r.final_step != steps:
            raise AssertionError(f"replica {i} ended at step {r.final_step}, not {steps}")
    if results[1].restarts != 1:
        raise AssertionError(f"replica 1 restarted {results[1].restarts} times, expected 1")
    shas = {r.params_sha256 for r in results}
    if len(shas) != 1:
        raise AssertionError(f"replicas diverged: parameter sha256 {shas}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"flash kernel {name} never launched on the main path")
    # steady steps: replica 0's last three iterations, after the heal round
    steady = sorted(results[0].step_s[-3:])
    step_s = steady[len(steady) // 2]
    last = results[0].phase_s[-3:]
    phases = {
        name: sorted(p[name] for p in last)[len(last) // 2]
        for name in ("compute", "allreduce", "commit")
    }
    return dict(
        card=card,
        model="llama3_8b width, %d layers, bf16" % layers,
        params=sum(t.numel() for t in results[0].state.values()),
        steps=steps,
        losses=[r.losses for r in results],
        params_sha256=shas.pop(),
        step_s_replica0=results[0].step_s,
        # the restarted incarnation: its first iteration holds the heal
        step_s_replica1=results[1].step_s,
        step_ms_median_last3=step_s * 1e3,
        phase_ms_median_last3={k: v * 1e3 for k, v in phases.items()},
        phase_s_replica0=results[0].phase_s,
        tokens_per_s_per_replica=2048 / step_s,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        wall_s=wall_s,
        launches=launches,
    )


def main() -> int:
    parser = argparse.ArgumentParser(description="on-card smoke test of torchft_tpu_torch")
    parser.add_argument("--out", default=None, help="also write the results as JSON here")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port itself; in a directory without it this import fails
    from torchft_tpu_torch import train_ddp
    from torchft_tpu_torch.ops import cuda_build
    from torchft_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    t0 = time.perf_counter()
    cuda_build.build([fa.KERNEL_SOURCE])
    build_s = time.perf_counter() - t0
    print(f"built {fa.KERNEL_SOURCE}.cu in {build_s:.1f} s", flush=True)
    for line in cuda_build.build_log(fa.KERNEL_SOURCE).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    kernels = kernel_phase(fa, ITERS)
    results = {"card": card, "build_s": build_s, "kernels": kernels}
    train = train_phase(train_ddp, fa, card)
    launches = train["launches"]
    results["train"] = train
    print(f"train: {json.dumps(train)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    main_rows = kernels[MAIN_CASE["name"]]
    line = {"kernels": [
        dict(name=f"flash_{name}", route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=launches[name], **main_rows[name])
        for name in ("fwd", "dq", "dkv")
    ]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)  # nvidia-smi's own line: name, power limit
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
