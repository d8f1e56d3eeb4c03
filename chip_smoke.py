#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``torchft_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``torchft_tpu_torch/csrc/`` (one
``nvcc`` per source, in parallel), then:

1. flash kernel phase — holds each flash-attention kernel (fwd, dq, dkv)
   against its plain PyTorch version on the card at the Llama-3-8B
   attention shapes (B=1, S=2048, H=32, KV=8, D=128, bf16, causal) and at
   three more cases (a non-causal Sq != Sk case with ragged tiles, a GQA
   groups=1 case at D=64, and a causal B=2 case whose S=1000 ends inside a
   tile of every head), and times kernel, plain version and the
   ``F.scaled_dot_product_attention`` yardstick; on the main case it checks
   that two dq launches give bit-identical dq and two dkv launches
   bit-identical dk and dv, and prints the forward's, dq's and dkv's
   achieved TFLOP/s and share of their bounds;
2. quant kernel phase — holds the rowwise quantize, fused reduce and
   dequantize kernels against their plain versions exactly (payload bytes
   equal, scales and f32 outputs bit-equal), for int8 and fp8, at the main
   path's shapes (quantize: the 1,486,901,248 gradients of the train
   phases' model; reduce: one 4 MiB pipeline window, [2, 2048, 1024]; the
   public round trip quantize → dequantize at the same size) and at a
   ragged case, a w=3 case, a case with NaN, ±inf and zero rows and a wide
   case (one 64 MiB window, [2, 32768, 1024]); two reduce launches must be
   bit-identical; times kernel, plain version and, for dequantize, one
   ``torch.mul``.  The reduce's ``ms`` is its device time with a cold L2: a
   CUDA graph of wrapper calls that rotate over copies of the inputs
   larger than the L2, replayed between CUDA events, so neither the
   wrapper's host cost nor a warm cache is in it; ``call_ms`` is the time
   of one eager wrapper call, as the pipeline makes it;
3. native hand-off check — builds the port's C++ runtime
   (``torchft_tpu_torch/csrc/native/``, g++, timed) and checks that a pinned
   host tensor, bf16 included, reaches it as a view of its own memory and
   that a tensor on the card is refused;
4. float train phases — the port's main path: two replica groups as threads
   (each its own Manager, manager sidecar, communicator and HTTPTransport)
   train Llama at Llama-3-8B width cut to 2 layers, bf16, B=1, S=2048, for 4
   steps; replica 1 is killed before step 2, restarts and heals from
   replica 0.  The fleet runs once with every plane on the C++ tier
   (``tier="cpp"``, named, never resolved: a failed native build fails the
   run) and once on the Python tier.  Every loss must be finite, both
   replicas must end at the same step with equal parameter hashes, every
   replica must have run the named tier's lighthouse, sidecar and
   communicator, and every flash kernel must have launched;
5. quantized train phases — the same two fleets with
   ``should_quantize=True`` (int8 wire): gradients quantized on the card,
   the windowed quantized pipeline with its per-window reduce on the card.
   The same checks, and the quantize and reduce kernels must have launched.

6. DiLoCo and LocalSGD phases, every plane on the C++ tier, at the same
   width, depth, batch and sequence, 2 replicas, inner AdamW, outer
   ``OuterSGD(0.7, momentum=0.9, nesterov=True)``:
   ``diloco_cpp`` — Streaming DiLoCo with the sharded outer sync,
   ``sync_every=8``, 2 fragments, ``fragment_sync_delay=2``, alpha 0, until
   4 committed outer steps; replica 1 is killed before its inner step 5,
   restarts and heals at its next quorum; ``diloco_quantized_cpp`` — the
   same over the int8 wire; ``localsgd_cpp`` — LocalSGD, ``sync_every=4``,
   until 2 committed syncs, no fault.  Checks: every loss finite; both
   replicas at the same committed step; (DiLoCo) replica 1 restarted once
   and its heal carried every ``StreamingDiLoCoFragment_*`` state; per
   fragment the backup's sha256 is equal across replicas and differs from
   the initial weights; the fragment synced last has equal live parameters
   across replicas; (LocalSGD) equal parameter hashes; the C++ tier's
   planes ran; the flash kernels launched in each phase.  Each prints the
   median inner step, the seconds per outer sync from ``outer_shard_wall_s``
   and its scatter / update / gather split, the heal's seconds and bytes,
   the peak device memory, the peak host RSS over the phase and tokens/s
   per replica over the phase.

Per sync, the C++ tier's parameter hash must equal the Python tier's.  The
DDP train phases run with ``obs.spans`` on; each prints the ``commit`` split
(seconds per steady step in ``manager::quorum_rpc``, ``comm::op``,
``manager::fence`` and ``manager::should_commit``) and the heal's seconds
and bytes.  Any failure raises, so the exit code is non-zero.  The last line
of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time

import torch

# Kernel vs plain version on the same card, compared in f32.  bf16 outputs
# (o, dq, dk, dv): elementwise |err| <= ATOL + RTOL·|plain| (two roundings of
# nearly equal f32 sums to bf16 differ by at most one ulp, 2^-7·|plain|) and
# normwise ||err|| / ||plain|| <= NORM_RTOL.  lse is f32: |err| <= LSE_ATOL.
ATOL, RTOL, NORM_RTOL, LSE_ATOL = 5e-3, 2e-2, 1e-2, 1e-3
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
ITERS = 10  # timed launches per kernel (plain versions: 2)
STEPS = 4  # DDP train steps; replica 1 is killed before step 2
# (results key, should_quantize, tier) of each train phase, in run order;
# the kernels line takes its launches from the C++ tier's phases
TRAIN_PHASES = (
    ("train_cpp", False, "cpp"),
    ("train_python", False, "python"),
    ("train_quantized_cpp", True, "cpp"),
    ("train_quantized_python", True, "python"),
)
PLANES = {
    "cpp": dict(lighthouse="CppLighthouseServer", manager_server="CppManagerServer",
                communicator="CppCommunicator"),
    "python": dict(lighthouse="LighthouseServer", manager_server="ManagerServer",
                   communicator="TCPCommunicator"),
}
# the spans that split ``commit``: the quorum RPC, each collective on the
# communicator's op thread, the vote's fence on the pending works, the vote
SPLIT_SPANS = ("manager::quorum_rpc", "comm::op", "manager::fence", "manager::should_commit")
# (results key, run_diloco_fleet keywords) of each DiLoCo / LocalSGD phase,
# all on the C++ tier: bench.py's phase D schedule, its int8 twin, LocalSGD
DILOCO = dict(algo="diloco", sync_every=8, num_fragments=2, fragment_sync_delay=2,
              outer_steps=4, kill_at=(1, 5))
DILOCO_PHASES = (
    ("diloco_cpp", dict(DILOCO, should_quantize=False)),
    ("diloco_quantized_cpp", dict(DILOCO, should_quantize=True)),
    ("localsgd_cpp", dict(algo="localsgd", sync_every=4, num_fragments=1,
                          fragment_sync_delay=0, outer_steps=2, should_quantize=False)),
)
SPAN_CAP = 200_000  # the quantized phase records ~1,400 comm ops a step
LAYERS = 2  # Llama-3-8B depth cut from 32 so two replicas fit one card
# Every kernel of the main path: its CUDA source, and the ``def`` of the
# Pallas TPU kernel it replaces (file:line in the JAX package).
KERNELS = {
    "flash_fwd": ("torchft_tpu_torch/csrc/flash_fwd_sm90.cu",
                  "torchft_tpu/ops/flash_attention.py:48"),
    "flash_dq": ("torchft_tpu_torch/csrc/flash_dq_sm90.cu",
                 "torchft_tpu/ops/flash_attention.py:213"),
    "flash_dkv": ("torchft_tpu_torch/csrc/flash_dkv_sm90.cu",
                  "torchft_tpu/ops/flash_attention.py:243"),
    "quant_quantize": ("torchft_tpu_torch/csrc/quant.cu", "torchft_tpu/ops/pallas_quant.py:79"),
    "quant_reduce": ("torchft_tpu_torch/csrc/quant_reduce_sm90.cu",
                     "torchft_tpu/ops/pallas_quant.py:189"),
    "quant_dequantize": ("torchft_tpu_torch/csrc/quant.cu",
                         "torchft_tpu/ops/pallas_quant.py:86"),
}
QUANT_ITERS = 100  # timed launches per quant case below the main size
# Quant cases: ``n`` gradients through quantize and the round trip, and one
# reduce of ``w`` contributions of ``rows`` rows.  "main" is the train
# phases' shapes: every gradient of the 2-layer model, and one 4 MiB window
# (4096 rows) of the pipeline split over 2 ranks; its last window holds
# 1040 rows per rank, the "ragged" reduce.  "wide" is one window at
# TORCHFT_QUANT_WINDOW_MB=64, where bytes, not launch latency, set the time.
MAIN_QUANT = dict(name="main", n=1_486_901_248, w=2, rows=2048, special=False)
QUANT_CASES = [
    MAIN_QUANT,
    dict(name="ragged", n=1000 * 1024 + 517, w=2, rows=1040, special=False),
    dict(name="w3", n=2048 * 1024 - 1, w=3, rows=2048, special=False),
    dict(name="nan_inf_zero", n=64 * 1024, w=2, rows=64, special=True),
    dict(name="wide", n=32768 * 1024, w=2, rows=32768, special=False),
]
L2_BYTES = 50e6  # H100 L2 cache
# The reduce's device time: between two uses of one buffer the rotation
# touches at least COLD_BYTES, so every launch finds its operands out of
# the L2; the graph holds REDUCE_GRAPH_LAUNCHES launches (a multiple of the
# sets) and is replayed REDUCE_GRAPH_REPLAYS times between the events.
COLD_BYTES = 2 * L2_BYTES
REDUCE_GRAPH_LAUNCHES = 16
REDUCE_GRAPH_REPLAYS = 10
MAIN_CASE = dict(name="llama3_8b", B=1, H=32, KV=8, Sq=2048, Sk=2048, D=128, causal=True)
CASES = [
    MAIN_CASE,
    dict(name="full_rect_ragged", B=1, H=32, KV=8, Sq=1000, Sk=1800, D=128, causal=False),
    dict(name="gqa1_d64", B=2, H=8, KV=8, Sq=1024, Sk=1024, D=64, causal=True),
    dict(name="causal_ragged_b2", B=2, H=8, KV=2, Sq=1000, Sk=1000, D=128, causal=True),
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


def _work(case, kernel: str):
    """(bytes, FLOPs) a flash kernel must move and do: inputs read once,
    outputs written once; FLOPs per (q, k) pair and head dim: fwd 4 (q·k,
    p·v); dq 6 (q·k, do·v, ds·k); dkv 8 (q·k, do·v, pᵀ·do, dsᵀ·q)."""
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
    return nbytes, flops * _pairs(case) * D


def _bound(case, kernel: str):
    """(bound_ms, bound_by): the larger of the bytes at the HBM rate and
    the bf16 FLOPs at the tensor-core peak."""
    nbytes, flops = _work(case, kernel)
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
        if case is MAIN_CASE:
            # dq: each block sums its own rows in registers; dkv: the GQA
            # group sum runs in a fixed order, whichever block ends last
            dq_again = fa.flash_dq(q, k, v, lse_ref, do, delta, scale, causal)
            again = fa.flash_dkv(q, k, v, lse_ref, do, delta, scale, causal)
            for name, a, b in (("dq", dq, dq_again), ("dk", dk, again[0]), ("dv", dv, again[1])):
                if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
                    raise AssertionError(f"{name} is not deterministic: two launches differ")

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
    main = out[MAIN_CASE["name"]]
    for name, yardstick, design in (
        ("fwd", "SDPA forward", ""),
        ("dq", "SDPA whole backward", ""),
        ("dkv", "SDPA whole backward",
         "; M3: one block per q-head, the last of each GQA group summing it"),
    ):
        row = main[name]
        tflops = _work(MAIN_CASE, name)[1] / (row["ms"] * 1e-3) / 1e12
        print(f"flash_{name} on {MAIN_CASE['name']}: {row['ms']:.4f} ms, {tflops:.1f} TFLOP/s of "
              f"causal work, {100 * row['bound_ms'] / row['ms']:.1f}% of its bound "
              f"({row['bound_ms']:.4f} ms); {yardstick} {row['library_ms']:.4f} ms{design}",
              flush=True)
    return out


def _quant_input(n: int, special: bool, seed: int) -> torch.Tensor:
    """f32 [n] on the card over six decades; ``special`` puts NaN, +inf and
    -inf in rows 0-2 and zeros in row 3."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=gen, device="cuda")
    x *= torch.logspace(-3, 3, 1024, device="cuda").repeat(-(-n // 1024))[:n]
    if special:
        x[5], x[1024 + 7], x[2048 + 3] = float("nan"), float("inf"), float("-inf")
        x[3072:4096] = 0.0
    return x


def _exact(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold a quant kernel's output against its plain version bit for bit
    (NaN included); returns max |kernel − plain| over the values (0)."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    gb, wb = got.contiguous().view(torch.uint8), want.contiguous().view(torch.uint8)
    if not torch.equal(gb, wb):
        bad = int((gb != wb).sum())
        err = (got.float() - want.float()).abs().nan_to_num(float("inf")).max().item()
        raise AssertionError(
            f"{name}: kernel differs from its plain version in {bad} bytes, max |err| {err} "
            "(tolerance: exact)"
        )
    return 0.0


def _quant_bound(kernel: str, case) -> tuple:
    """(bound_ms, bound_by): bytes moved (each input read once, each output
    written once) at the HBM rate against f32 operations (quantize: abs,
    max, divide, round, clamp per element; reduce: a multiply and an add
    per contribution, then the requantize; dequantize: one multiply) at the
    f32 peak."""
    n, w, rows = case["n"], case["w"], case["rows"]
    if kernel == "quantize":
        prow = -(-max(1, -(-n // 1024)) // 32) * 32
        nbytes, ops = 4 * n + prow * 1024 + 4 * prow, 5 * n
    elif kernel == "reduce":
        nbytes, ops = (w + 1) * rows * (1024 + 4), (2 * w + 5) * rows * 1024
    else:
        drows = -(-n // 1024)
        nbytes, ops = drows * (1024 + 4) + 4 * n, n
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _rotation(w: int, rows: int) -> tuple:
    """(sets, launches, bytes) of the reduce's cold-L2 timing: ``sets``
    distinct copies of the inputs ([w, rows, 1024] payload, [w, rows]
    scales), used in turn by ``launches`` graph launches that each write an
    output of their own ([rows, 1024] + [rows]); ``bytes`` is what the
    launches touch between two uses of one input set."""
    set_bytes = (w + 1) * rows * (1024 + 4)
    sets = max(2, -(-int(COLD_BYTES) // set_bytes))
    launches = -(-REDUCE_GRAPH_LAUNCHES // sets) * sets
    return sets, launches, sets * set_bytes


def _reduce_inputs(qk, case, kind: str) -> tuple:
    """The reduce's w contributions of ``rows`` rows, each quantized from
    its own seed (the second holds NaN, ±inf and zero rows when
    ``special``): (qs [w, rows, 1024], scales [w, rows, 1])."""
    w, rows = case["w"], case["rows"]
    parts = [qk.quantize_rowwise_plain(
        _quant_input(rows * 1024, case["special"] and c == 1, 1 + c), kind=kind)
        for c in range(w)]
    return torch.stack([p[0][:rows] for p in parts]), torch.stack([p[1][:rows] for p in parts])


def _reduce_device_ms(qk, qs, scs, kind: str, want: tuple) -> tuple:
    """Device ms of one reduce launch with a cold L2, and its rotation
    (sets, bytes).  The wrapper's calls are captured once in a CUDA graph
    (their host cost is paid at capture) and the graph is replayed between
    CUDA events.  Every captured launch's output is held exactly against
    ``want``, the plain version's."""
    sets, launches, nbytes = _rotation(qs.shape[0], qs.shape[1])
    copies = [(qs.clone(), scs.clone()) for _ in range(sets)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # a warm-up off the capture stream
        qk.reduce_quantized_device(*copies[0], kind=kind)
    torch.cuda.current_stream().wait_stream(side)
    graph, outs = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(graph):
        for i in range(launches):
            outs.append(qk.reduce_quantized_device(*copies[i % sets], kind=kind))
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REDUCE_GRAPH_REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (REDUCE_GRAPH_REPLAYS * launches)
    for i, (q, s) in enumerate(outs):
        _exact(f"graph launch {i} q", q, want[0])
        _exact(f"graph launch {i} scales", s, want[1])
    del graph, outs, copies
    torch.cuda.empty_cache()
    return ms, sets, nbytes


def quant_phase(qk, iters: int) -> dict:
    """Per case and wire kind: each quant kernel held exactly against its
    plain version, with kernel / plain / library ms and the bound.  The
    launches made here are comparisons and are reset before the train
    phases."""
    out = {}
    for case in QUANT_CASES:
        big = case is MAIN_QUANT
        reps = iters if big else QUANT_ITERS
        for kind in ("int8", "fp8"):
            n = case["n"]
            x = _quant_input(n, case["special"], 0)
            q, s = qk.quantize_rowwise_device(x, kind=kind)
            q_ref, s_ref = qk.quantize_rowwise_plain(x, kind=kind)
            errs = {"quantize": max(_exact(f"{case['name']} {kind} quantize q", q, q_ref),
                                    _exact(f"{case['name']} {kind} quantize scales", s, s_ref))}
            del q_ref, s_ref
            # the public round trip: the dequantize kernel on the kernel's payload
            back = qk.dequantize_rowwise_device(q, s, n)
            errs["dequantize"] = _exact(f"{case['name']} {kind} dequantize", back,
                                        qk.dequantize_rowwise_plain(q, s, n))
            if kind == "int8":
                # each value comes back within half a step (its row's scale),
                # plus the two f32 roundings (|x| <= 127 steps): 1e-4 steps
                step = s.reshape(-1).repeat_interleave(1024)[:n]
                held = torch.isfinite(x) & torch.isfinite(step)
                if not ((back - x).abs() <= step * (0.5 + 1e-4))[held].all():
                    raise AssertionError(f"{case['name']} int8 round trip is off by over half a step")
                del step, held
            del back
            timings = {
                "quantize": (_time_ms(lambda: qk.quantize_rowwise_device(x, kind=kind), reps),
                             _time_ms(lambda: qk.quantize_rowwise_plain(x, kind=kind), 2, 1), None),
                "dequantize": (
                    _time_ms(lambda: qk.dequantize_rowwise_device(q, s, n), reps),
                    _time_ms(lambda: qk.dequantize_rowwise_plain(q, s, n), 2, 1),
                    # one library call for the same function: int8 · f32 → f32
                    _time_ms(lambda: torch.mul(q, s), reps) if kind == "int8" else None,
                ),
            }
            del x, q, s
            torch.cuda.empty_cache()
            qs, scs = _reduce_inputs(qk, case, kind)
            red = qk.reduce_quantized_device(qs, scs, kind=kind)
            again = qk.reduce_quantized_device(qs, scs, kind=kind)
            red_ref = qk.reduce_quantized_plain(qs, scs, kind=kind)
            label = f"{case['name']} {kind} reduce"
            errs["reduce"] = max(_exact(f"{label} q", red[0], red_ref[0]),
                                 _exact(f"{label} scales", red[1], red_ref[1]))
            _exact(f"{label}: two launches, q", again[0], red[0])
            _exact(f"{label}: two launches, scales", again[1], red[1])
            reduce_ms, sets, rotated = _reduce_device_ms(qk, qs, scs, kind, red_ref)
            timings["reduce"] = (
                reduce_ms,
                _time_ms(lambda: qk.reduce_quantized_plain(qs, scs, kind=kind), 10, 2),
                None,
            )
            rows_out = {}
            for name in ("quantize", "reduce", "dequantize"):
                ms, plain_ms, lib_ms = timings[name]
                bound_ms, bound_by = _quant_bound(name, case)
                rows_out[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)
            rows_out["reduce"].update(
                call_ms=_time_ms(lambda: qk.reduce_quantized_device(qs, scs, kind=kind),
                                 QUANT_ITERS),
                rotated_mb=rotated / 1e6, rotated_sets=sets,
                pct_of_bound=100 * rows_out["reduce"]["bound_ms"] / reduce_ms,
            )
            out[f"{case['name']} {kind}"] = rows_out
            print(f"quant case {case['name']} {kind}: {json.dumps(rows_out)}", flush=True)
            del qs, scs, red, again, red_ref
            torch.cuda.empty_cache()
    return out


def commit_split(spans, windows, replicas: int) -> list:
    """Per iteration window ``(start, end)``: the seconds in each of
    :data:`SPLIT_SPANS` that started inside it, summed over the fleet and
    divided by ``replicas`` (the per-replica mean: the spans carry no
    replica, and the replicas step in lockstep)."""
    out = []
    for start, end in windows:
        row = dict.fromkeys(SPLIT_SPANS, 0.0)
        for rec in spans:
            if rec["name"] in row and start <= rec["t"] < end:
                row[rec["name"]] += rec["dur"] / replicas
        out.append(row)
    return out


def check_cross_tier(results: dict) -> dict:
    """Per sync, the C++ tier's parameter sha256 must equal the Python
    tier's; returns {sync: {tier: sha256}}."""
    hashes: dict = {}
    for key, quantized, tier in TRAIN_PHASES:
        sync = "quantized" if quantized else "float"
        hashes.setdefault(sync, {})[tier] = results[key]["params_sha256"]
    for sync, by_tier in hashes.items():
        if len(set(by_tier.values())) != 1:
            raise AssertionError(f"{sync} sync: the tiers end with different parameters {by_tier}")
    return hashes


def native_phase(native) -> dict:
    """Build the C++ runtime (timed) and check the hand-off of host
    tensors: a pinned tensor, bf16 included, reaches it as a view of its own
    memory, and a tensor on the card is refused."""
    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    if not native.available():
        raise AssertionError(f"the native runtime does not load: {native._lib_error}")
    for dtype in (torch.float32, torch.bfloat16):
        host = torch.empty(1 << 20, dtype=dtype, pin_memory=True)
        view = native.as_host_array(host)
        if view.ctypes.data != host.data_ptr() or view.nbytes != host.nbytes:
            raise AssertionError(f"a pinned {dtype} tensor was copied on its way to the C++ tier")
    try:
        native.as_host_array(torch.empty(4, device="cuda"))
    except native.CommunicatorError:
        pass
    else:
        raise AssertionError("the C++ tier took a tensor on the card")
    return dict(library=str(path), build_s=build_s)


def train_phase(train_ddp, fa, qk, spans, card: str, should_quantize: bool, tier: str) -> dict:
    """The port's main path: 2 replica threads at Llama-3-8B width with a
    kill and heal, averaging gradients in f32/bf16 or through the int8
    quantized wire, every plane on ``tier``; the launch counts and the
    spans cover exactly this run."""
    steps, layers = STEPS, LAYERS
    cfg = train_ddp.model_config("llama3_8b", layers)
    device = torch.device("cuda")
    # the previous phase's replicas sit in reference cycles (a manager's
    # closures hold its model): free them before this fleet allocates
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spans.clear()
    fa.reset_launches()
    qk.reset_launches()
    t0 = time.perf_counter()
    results = train_ddp.run_fleet(
        cfg, device, replicas=2, steps=steps, batch=1, seq=2048, kill_at=(1, 2),
        should_quantize=should_quantize, tier=tier,
    )
    wall_s = time.perf_counter() - t0
    launches = {**fa.launches, **qk.launches}
    split = commit_split(spans.snapshot(), results[0].step_windows, len(results))
    for i, r in enumerate(results):
        if not all(math.isfinite(x) for x in r.losses):
            raise AssertionError(f"replica {i}: non-finite loss in {r.losses}")
        if r.final_step != steps:
            raise AssertionError(f"replica {i} ended at step {r.final_step}, not {steps}")
    if results[1].restarts != 1:
        raise AssertionError(f"replica 1 restarted {results[1].restarts} times, expected 1")
    for i, r in enumerate(results):
        if r.planes != PLANES[tier]:
            raise AssertionError(f"replica {i} ran {r.planes}, not the {tier} tier")
    heal = results[1].heal
    if heal is None or heal.bytes_total <= 0:
        raise AssertionError("replica 1 restarted but recorded no heal")
    shas = {r.params_sha256 for r in results}
    if len(shas) != 1:
        raise AssertionError(f"replicas diverged: parameter sha256 {shas}")
    # dequantize is public API only: the pipeline dequantizes on the host
    required = ("fwd", "dq", "dkv") + (("quantize", "reduce") if should_quantize else ())
    for name in required:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    # steady steps: replica 0's last three iterations, after the heal round
    steady = sorted(results[0].step_s[-3:])
    step_s = steady[len(steady) // 2]
    last = results[0].phase_s[-3:]
    phases = {
        name: sorted(p[name] for p in last)[len(last) // 2]
        for name in ("compute", "allreduce", "commit")
    }
    steady_split = split[-3:]
    return dict(
        card=card,
        tier=tier,
        planes=results[0].planes,
        sync="quantized int8" if should_quantize else "float (bf16 and f32 buckets)",
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
        # seconds per replica in each span, per iteration of replica 0
        commit_split_s=split,
        commit_split_ms_median_last3={
            name: sorted(row[name] for row in steady_split)[len(steady_split) // 2] * 1e3
            for name in SPLIT_SPANS
        },
        heal=dict(seconds=heal.duration_s, bytes=heal.bytes_total, sources=heal.num_sources),
        tokens_per_s_per_replica=2048 / step_s,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        wall_s=wall_s,
        launches=launches,
    )


class HostRss:
    """Peak resident set of this process while the block runs, and at its
    start (what earlier phases left resident), sampled from
    ``/proc/self/statm`` every 0.2 s (``getrusage``'s high-water mark is the
    process's whole life, so it is reported beside it)."""

    @staticmethod
    def now() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def __enter__(self) -> "HostRss":
        self.start_bytes = self.peak_bytes = self.now()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self) -> None:
        while True:
            self.peak_bytes = max(self.peak_bytes, self.now())
            if self._stop.wait(0.2):
                return

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def diloco_phase(train_diloco, train_ddp, fa, qk, card: str, fleet: dict) -> dict:
    """DiLoCo or LocalSGD at Llama-3-8B width with 2 replicas, every plane
    on the C++ tier; raises on any failed check.  The launch counts cover
    exactly this run."""
    import resource

    cfg = train_ddp.model_config("llama3_8b", LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    qk.reset_launches()
    t0 = time.perf_counter()
    with HostRss() as rss:
        results = train_diloco.run_diloco_fleet(
            cfg, torch.device("cuda"), replicas=2, batch=1, seq=2048, tier="cpp", **fleet)
    wall_s = time.perf_counter() - t0
    launches = {**fa.launches, **qk.launches}
    diloco = fleet["algo"] == "diloco"
    for i, r in enumerate(results):
        if not r.losses or not all(math.isfinite(x) for x in r.losses):
            raise AssertionError(f"replica {i}: non-finite loss in {r.losses}")
        if r.final_step != fleet["outer_steps"]:
            raise AssertionError(f"replica {i} ended at step {r.final_step}, "
                                 f"not {fleet['outer_steps']}")
        if r.planes != PLANES["cpp"]:
            raise AssertionError(f"replica {i} ran {r.planes}, not the cpp tier")
    heal = None
    if diloco:
        if [r.restarts for r in results] != [0, 1]:
            raise AssertionError(f"restarts {[r.restarts for r in results]}, expected [0, 1]")
        heal = results[1].heal
        if heal is None or heal.bytes_total <= 0 or min(results[1].fragment_heals) < 1:
            raise AssertionError(f"replica 1's heal carried no fragment state: heal {heal}, "
                                 f"fragment heals {results[1].fragment_heals}")
        for f in range(fleet["num_fragments"]):
            backups = {r.fragment_sha256[f] for r in results}
            if len(backups) != 1:
                raise AssertionError(f"fragment {f}: backups differ across replicas {backups}")
            if backups == {results[0].initial_fragment_sha256[f]}:
                raise AssertionError(f"fragment {f}: the backup is still the initial weights")
        last = (results[0].final_step - 1) % fleet["num_fragments"]
        live = {r.fragment_live_sha256[last] for r in results}
        if len(live) != 1:
            raise AssertionError(f"fragment {last}, synced last: live parameters differ {live}")
    elif len({r.params_sha256 for r in results}) != 1:
        raise AssertionError(f"LocalSGD replicas diverged: {[r.params_sha256 for r in results]}")
    for name in ("fwd", "dq", "dkv"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the {fleet['algo']} phase")
    r0 = results[0]
    shard = [t for t in r0.outer_shard if "outer_shard_wall_s" in t]
    split = {k: _median(t[f"outer_shard_{k}_s"] for t in shard)
             for k in ("wall", "scatter", "update", "gather")} if shard else None
    return dict(
        card=card,
        tier="cpp",
        fleet=fleet,
        model="llama3_8b width, %d layers, bf16" % LAYERS,
        final_step=r0.final_step,
        inner_steps=[r.inner_steps for r in results],
        losses=[r.losses for r in results],
        fragment_sha256=r0.fragment_sha256,
        params_sha256=[r.params_sha256 for r in results],
        restarts=[r.restarts for r in results],
        fragment_heals=[r.fragment_heals for r in results],
        inner_step_s_replica0=r0.inner_step_s,
        inner_step_ms_median=_median(r0.inner_step_s) * 1e3,
        wrapper_step_s_replica0=r0.wrapper_step_s,
        # host seconds the train loop spent in wrapper.step() per committed sync
        sync_s_per_commit=sum(r0.wrapper_step_s) / r0.final_step,
        outer_shard_replica0=r0.outer_shard,
        outer_shard_s_median=split,
        heal=None if heal is None else dict(
            seconds=heal.duration_s, bytes=heal.bytes_total, sources=heal.num_sources),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_host_rss_gb=rss.peak_bytes / 1e9,
        start_host_rss_gb=rss.start_bytes / 1e9,
        ru_maxrss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
        tokens_per_s_per_replica=r0.inner_steps * 2048 / wall_s,
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
    from torchft_tpu_torch import native, train_ddp, train_diloco
    from torchft_tpu_torch.obs import spans
    from torchft_tpu_torch.ops import cuda_build
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import quant as qk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)

    t0 = time.perf_counter()
    sources = [*fa.KERNEL_SOURCES, *qk.KERNEL_SOURCES]
    cuda_build.build(sources)
    build_s = time.perf_counter() - t0
    print(f"built {', '.join(s + '.cu' for s in sources)} in {build_s:.1f} s", flush=True)
    for source in sources:
        for line in cuda_build.build_log(source).splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "Performance")):
                print(f"ptxas {source}: {line.strip()}", flush=True)

    kernels = kernel_phase(fa, ITERS)
    quant = quant_phase(qk, ITERS)
    handoff = native_phase(native)
    print(f"native runtime: built {handoff['library']} in {handoff['build_s']:.1f} s (g++); "
          "pinned f32/bf16 tensors hand off as views, a tensor on the card is refused",
          flush=True)
    results = {"card": card, "build_s": build_s, "native": handoff, "kernels": kernels,
               "quant": quant}
    spans.configure(True, cap=SPAN_CAP)
    for key, quantized, tier in TRAIN_PHASES:
        results[key] = train_phase(train_ddp, fa, qk, spans, card, quantized, tier)
        print(f"{key}: {json.dumps(results[key])}", flush=True)
        t = results[key]
        print(f"{key} ({tier} tier, {t['sync']}): step {t['step_ms_median_last3']:.1f} ms, "
              f"phases {json.dumps(t['phase_ms_median_last3'])}, commit split (ms per replica) "
              f"{json.dumps(t['commit_split_ms_median_last3'])}; heal {t['heal']['seconds']:.3f} s "
              f"for {t['heal']['bytes']} bytes; wall {t['wall_s']:.1f} s", flush=True)
    spans.configure(False)
    hashes = check_cross_tier(results)
    for sync, by_tier in hashes.items():
        print(f"{sync} sync parameter sha256: cpp {by_tier['cpp']}, python {by_tier['python']} "
              "(equal)", flush=True)
    for key, fleet in DILOCO_PHASES:
        results[key] = t = diloco_phase(train_diloco, train_ddp, fa, qk, card, fleet)
        print(f"{key}: {json.dumps(t)}", flush=True)
        heal = (f"heal {t['heal']['seconds']:.3f} s for {t['heal']['bytes']} bytes"
                if t["heal"] else "no heal")
        print(f"{key} (cpp tier): inner step {t['inner_step_ms_median']:.1f} ms (median), "
              f"train loop held {t['sync_s_per_commit']:.3f} s per committed sync, outer sync "
              "(s, median) "
              f"{json.dumps(t['outer_shard_s_median'])}; {heal}; peak device "
              f"{t['max_memory_allocated_gb']:.1f} GB, peak host RSS {t['peak_host_rss_gb']:.1f} GB "
              f"({t['start_host_rss_gb']:.1f} GB at its start); "
              f"{t['tokens_per_s_per_replica']:.1f} tokens/s per replica; wall {t['wall_s']:.1f} s",
              flush=True)
    float_t, quant_t = results["train_cpp"], results["train_quantized_cpp"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    # flash kernels: launches of the float phase (the quantized phase runs
    # them as often); quant kernels: launches of the quantized phase
    main_rows = kernels[MAIN_CASE["name"]]
    quant_rows = quant[f"{MAIN_QUANT['name']} int8"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        dict(name=f"{prefix}_{name}", route="cuda", source=KERNELS[f"{prefix}_{name}"][0],
             replaces=KERNELS[f"{prefix}_{name}"][1], launches=phase["launches"][name],
             **{k: rows[name][k] for k in keys})
        for prefix, names, phase, rows in (
            ("flash", ("fwd", "dq", "dkv"), float_t, main_rows),
            ("quant", ("quantize", "reduce", "dequantize"), quant_t, quant_rows),
        )
        for name in names
    ]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)  # nvidia-smi's own line: name, power limit
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
