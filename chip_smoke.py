#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``torchft_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100::

    python3 chip_smoke.py

It first runs the port's device probe (``utils/probe.py``): a subprocess
that must execute a small matmul on the card and read it back within
:data:`PROBE_TIMEOUT_S`, retried for :data:`PROBE_WINDOW_S`; if the card does
not execute, the run fails with :class:`CardProbeError` before anything is
built.  It then builds the port's CUDA kernels from
``torchft_tpu_torch/csrc/`` (one ``nvcc`` per source, in parallel), then:

1. flash kernel phase — holds each flash-attention kernel (fwd, dq, dkv)
   against its plain PyTorch version on the card at the Llama-3-8B
   attention shapes (B=1, S=2048, H=32, KV=8, D=128, bf16, causal) and at
   four more cases (a non-causal Sq != Sk case with ragged tiles, a GQA
   groups=1 case at D=64, a causal B=2 case whose S=1000 ends inside a
   tile of every head, and a causal S=100 shorter than one tile), and times kernel, plain version and the
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
   of one eager wrapper call, as the pipeline makes it; then the avg kernel
   (``avg_phase``, ``ops/avg.py``): the AVG divide of a summed bucket into
   a ``.grad`` leaf, held exactly against its plain version at the float
   path's whole gradient (bf16) and the int8 path's (its f32 sum into bf16),
   an f32 case, and cases of NaN payloads, ±inf and subnormals also held
   against the host's divide; timed beside one ``torch.div``; and divided
   in place (the sum is the leaf), as the main path divides, at a leaf's
   aligned length and a ragged one, bf16 and f32; then the outer kernel
   (``outer_phase``, ``ops/outer.py``): DiLoCo's sharded outer update — the
   chunk's contributions summed from +0, scaled by 1/P, the Nesterov trace
   and the delta — held bit for bit against its plain version on the card
   at one owner's shard of the 1-layer fragment (2 owners) with -0, ±inf,
   NaN payloads and subnormals, the trace updated in place, and against the
   host's numpy on the front of each case (NaN bits aside); timed at the
   shard's first pipeline chunk, the main path's launch, beside its plain
   version and the eager torch sequence; a ragged w=3 case with plain
   momentum and a no-momentum case; what this host's numpy does where the
   kernel follows it (a sum of -0s, the int8 chunk sum's einsum); the
   pseudo-gradient's copy to its host buffer, pageable against pinned, in
   turns; and fragment 0 of the 1-layer model less its embedding through
   two whole sharded syncs on a one-replica quorum (``outer_sync_check``;
   the second steps the trace the first committed on the card; each sync
   at least two pipeline chunks), on the card path and on the host path
   from the same inner steps: backups, live parameters and traces bit for
   bit;
3. ring phase (``ring_phase``) — sequence parallelism's ring attention
   at Llama-3-8B attention width (H=32, KV=8, D=128, bf16), B=1, S=8192
   split over sp=4 ranks held in one process (blocks of 2048): the ring's
   block schedule and lse merge over the flash kernels (a causal diagonal
   block and full earlier blocks per rank), forward and backward, held
   against whole-sequence causal ``flash_attention`` at S=8192 (the
   kernels too) and against the same ring on the kernels' plain versions;
   its launches counted by mask (4 causal and 6 non-causal forwards, 10 dq
   and 10 dkv); the same checks on blocks of 640 tokens (S=2560), a length
   the CPU's flash gate refuses and the card's kernels take; the ring timed
   against whole-sequence flash, with its peak device memory; then the
   model's attention gate on the card (``card_gate_check``): a one-layer
   model at 8B attention width at S = 16, 100 and 640 launches each flash
   kernel once;
4. native hand-off check — the port's C++ runtime
   (``torchft_tpu_torch/csrc/native/``, built by g++ beside the CUDA build,
   timed) loads, a pinned host tensor, bf16 included, reaches it as a view
   of its own memory, and a tensor on the card is refused;
5. float train phases — the port's main path: two replica groups as threads
   (each its own Manager, manager sidecar, communicator and checkpoint
   transport) train Llama at Llama-3-8B width cut to 2 layers, bf16, B=1,
   S=2048, for 3 steps (4 before the fleet phases joined); replica 1 is
   killed before step 2, restarts and
   heals from replica 0 over the communicator (``CommTransport``).  The fleet runs once with every plane on the C++ tier
   (``tier="cpp"``, named, never resolved: a failed native build fails the
   run) and once on the Python tier.  Each bucket's ring returns its SUM
   into the bucket's pinned host buffer; the card divides it into the
   ``.grad`` leaves (the avg kernel).  Every loss must be finite, both
   replicas must end at the same step with equal parameter hashes, every
   replica must have run the named tier's lighthouse, sidecar and
   communicator, and every flash kernel and the avg kernel must have
   launched;
6. quantized train phases — the same fleet with ``should_quantize=True``
   (int8 wire) and three replica groups (:data:`TRAIN_REPLICAS`), on the
   C++ tier and on the Python tier (``train_quantized_python``, driven
   again): gradients quantized on the card, the windowed quantized pipeline
   with its per-window reduce on the card, the reduced stream dequantized
   and divided on the card; both heal over HTTP, so one run holds both
   transports to the same state.  On the Python tier replica 1 heals
   striped from replicas 0 and 2 (the heal of every fleet of three or more
   groups); the C++ sidecar advertises one source.  The same checks, and
   the quantize, reduce, dequantize and avg kernels must have launched.
   Every train phase's heal must move the replica's whole state: over the
   communicator exactly its array payload bytes, over HTTP those and its
   stream's framing; it must come from :data:`TRAIN_HEAL_SOURCES`'s number
   of sources, each serving bytes, together the heal's, none failed and no
   chunk stolen; and each sync's final hash must be
   :data:`EXPECTED_SHA256`'s (a heal is bit-exact, whatever carries it), on
   every group and both tiers.

7. DiLoCo and LocalSGD phases, every plane on the C++ tier, at the same
   width, depth, batch and sequence, 2 replicas, inner AdamW, outer
   ``OuterSGD(0.7, momentum=0.9, nesterov=True)``:
   ``diloco_cpp`` — Streaming DiLoCo with the sharded outer sync,
   ``sync_every=8``, 2 fragments, ``fragment_sync_delay=2``, alpha 0, until
   3 committed outer steps; replica 1 is killed before its inner step 5,
   restarts and heals at its next quorum, then syncs fragment 1 and
   fragment 0; ``diloco_stream_cpp`` — the same under the streamed outer
   sync (``TORCHFT_STREAM_SYNC=1``: each fragment's sync is submitted 2
   inner steps before its sync step and resolved at a barrier 1 inner step
   after it), replica 1 killed right after it submitted fragment 1's
   streamed sync; beside ``diloco_cpp``'s checks (``check_stream``): every
   incarnation streamed, every commit decision came at a stream barrier,
   and the sync in flight at the kill committed nowhere (the survivor's
   vote on it failed, the victim died before its barrier); it prints its
   numbers beside ``diloco_cpp``'s; ``diloco_quantized_cpp`` —
   ``diloco_cpp`` over the int8 wire, its 3 outer steps, its kill and its
   heal over HTTP driven again, held to ``diloco_cpp``'s checks; its outer
   sync quantizes its pseudo-gradient and each delta and dequantizes the
   gathered deltas on the card, so the quantize and dequantize kernels
   must have launched;
   ``localsgd_cpp`` — a job loss and its restore
   from a durable checkpoint (``jobloss_phase``): LocalSGD,
   ``sync_every=4``, runs to 1 committed sync, after which the participating
   rank 0 writes the model, its AdamW moments and the Manager's step to
   disk (``run_diloco_fleet(ckpt_dir=...)``, in ``build/``, removed at the
   end; a filesystem short of room for two steps fails by name first); the
   fleet and its lighthouse are torn down, and a second fleet with a fresh
   lighthouse restores the checkpoint and runs to committed step 2, where it
   saves again.  Its checks (``check_job_loss``, beside the ones below on
   each fleet): one save, at step 1; on both restored replicas the model
   and optimizer state's content hash (``utils.checkpoint.ChunkDigest``)
   at restore equals the saved bytes' and the Manager's step is the saved
   step; no heal after the restore; the directory holds steps 1 and 2;
   each flash kernel launched in the restored fleet.  It prints the
   checkpoint's bytes, the save's seconds (host copy, write, fsync), the
   load's, kill to the restored fleet's first committed sync, peak device
   memory and host RSS.
   Checks of every phase: every loss finite; both
   replicas at the same committed step; (DiLoCo with a kill) replica 1
   restarted once and its heal carried every ``StreamingDiLoCoFragment_*``
   state, and it synced every fragment after the heal; (without one) no
   replica restarted or healed; per
   fragment the backup's sha256 is equal across replicas and differs from
   the initial weights if a sync of it committed, else equals them; the fragment synced last has equal live parameters
   across replicas; (LocalSGD) equal parameter hashes; the C++ tier's
   planes ran; the flash kernels launched in each phase.  Each prints the
   median inner step, the seconds per outer sync from ``outer_shard_wall_s``
   and its scatter / update / gather split, the seconds per replica per
   committed sync in each span of :data:`DILOCO_SPANS` (the
   pseudo-gradient on the card and its copy into the wire's host buffer,
   the pipeline and its chunk spans, the vote, the new global parameters,
   the writes of the live ones), the
   heal's seconds and bytes, the seconds per replica in each span of
   :data:`HEAL_SPANS` (the heal's send and receive, the fragments' state
   crossing card -> host and back, the reshard's export, exchange and
   rebuild),
   the peak device memory, the peak host RSS over the phase and tokens/s
   per replica over the phase.  The DiLoCo fleets sync on the card path:
   the backups, the owners' outer state and the delta stay in device
   memory, the outer kernel steps each chunk, and it must have launched.
   All run 1 layer deep
   (:data:`DILOCO_LAYERS`; the width stays), as does ``spare_python``, so
   the command stays inside its limit with phases 10–14.

   ``spare_python`` — ``diloco_cpp``'s schedule to 2 committed outer steps
   with a hot spare, every plane on the Python tier (the C++ sidecar
   refuses the spare role), 1 layer: 2 actives and 1 spare
   (``run_diloco_fleet(spares=1)``); replica
   1 is killed before its inner step 5 and stays dead, and the lighthouse
   promotes the spare in its place.  Checks (``check_spare``): no replica
   restarted, the spare promoted once, in one membership edit, with no heal
   anywhere; the spare's chunk store reached a fresh fraction of 1.0; every
   fragment's backup equal on replica 0 and the spare, the last-synced
   fragment's live parameters too; the spare at ``outer_steps`` with finite
   losses; each flash kernel launched after the promotion.  Prints the
   promotion (``promote_s``, its warm lag, kill to adopted quorum, kill to
   the spare's first committed sync), the warm bytes, chunks and deltas,
   peak device memory and host RSS, and ``diloco_cpp``'s cold heal beside
   it (another tier; no gain is claimed).  A fragment's delta (2.97 GB)
   is over the outer-delta feed's 48 MiB frame budget, so this spare warms
   on the chunk store alone.  ``spare_drills`` — ``gray_failure_drill``'s
   ``spare_promote`` and ``kill_spare`` modes with their state on the card,
   held to the JAX tests' assertions, then the feed on a Llama narrow
   enough to carry it (killed after a committed sync): the spare must
   apply at least one committed delta (``check_spare(min_deltas=1)``).

8. ``cnn_cpp`` — ``train_ddp --model cnn``: the upstream example's toy CNN
   with Adam on ``synthetic_cifar`` (its defaults: 2048 samples, batch 32,
   lr 1e-3), each replica reading its ``DistributedSampler`` shard, 2
   replicas on the C++ tier for 20 steps; replica 1 is killed before step
   5 and heals.  Checks: every loss finite, replica 0's loss falls (mean of
   its last three steps under the mean of its first three), both replicas
   end with equal parameter hashes, replica 1 restarted once with a heal.
   Prints the median step and the heal's seconds and bytes.
9. ``hsdp_cpp`` — ``train_hsdp``: Llama-3-8B width at 2 layers, bf16,
   B=1, S=2048, AdamW, 2 replica groups, each one process on the card at
   fsdp = tp = 1 (NCCL world 1; FSDP2 wraps every layer and the root), the
   C++ tier, 3 steps; group 1 is killed before step 2 and heals its
   sharded state over the communicator.  Checks: every loss finite, both
   groups at step 4 with equal parameter hashes (the expected one), every
   ``param.grad`` a DTensor, group 1 restarted once with a heal of its
   whole state, each flash kernel launched in every process.  Prints the step wall time split into compute / allreduce /
   commit, ``last_quorum_timings``, the heal's seconds and bytes, each
   process's peak device memory, and whether the final hash equals the
   float C++ DDP phase's (a finding, not a check).
10. ``pipeline_phase`` — ``PipelinedLlama`` at Llama-3-8B width, 2 layers
   over pp = 2 stages (one layer a stage), both stages on the card through
   the engine's in-process hop, B=4, S=2048, 4 microbatches, every layer
   recomputed (``remat_mode="layer"``), held against the plain ``Llama``
   with the same weights and no remat: loss within 1e-2 relative, each
   gradient within 2e-2 normwise (both bf16, on different paths); the
   flash launches must be the schedule's (live ticks only: 8 dq, 8 dkv,
   and 16 forwards with the recomputes).  Prints the pipelined and plain
   step's ms and the peak device memory above the weights.
11. ``moe_hsdp_cpp`` — ``train_hsdp`` over ``llama3_8b_moe`` cut to 1 layer
   (8 experts, capacity factor 1.5, 2,032,185,344 parameters), 2 replica
   groups each one process on the card at ep = fsdp = tp = 1, the C++
   tier, 3 steps, no kill (a kill and heal of its 12.19 GB state would take
   the command past its 1200 s limit; ``hsdp_cpp`` heals the same path).  ``hsdp_cpp``'s
   checks but the heal's, and every router and expert parameter has a
   gradient on every step; prints the tokens past each expert's capacity
   (384 slots for 2048 tokens a step; a finding, not a check), the step
   split, the state's bytes and each process's peak device memory.
12. ``rehearsal_phase`` — ``parallel/rehearsal.py`` on the card: the
   baseline table (8B at fsdp = 8, 8B at fsdp = 8 × tp = 2, 70B at
   fsdp = 16 × tp = 4, S=8192) beside this card's ``total_memory``;
   ``quant_kernel_reports`` (each quant kernel for int8 and fp8, and the
   flash kernels at each config's per-rank heads, held against their
   plain versions); and the rehearsal's arithmetic for ``hsdp_cpp``'s and
   ``moe_hsdp_cpp``'s layouts beside the peaks those phases measured (a
   finding, not a check).

13. ``baby_cpp`` (right after the three train phases) — ``train_cpp``'s
   fleet and schedule with every replica's data plane a
   ``BabyCommunicator(backend="cpp")``: the C++ ring in a killable child
   process, payloads at or above ``TORCHFT_BABY_SHM_MIN`` through shared
   memory.  ``train_phase``'s checks, the final hash
   :data:`EXPECTED_SHA256`'s (the child runs the same ring on the same
   bytes), every child a process of its own, the killed replica's child
   gone before its restart spawns a new one, shared-memory ops counted, no
   child left alive.  Prints the step, phases and ``commit`` split beside
   ``train_cpp``'s from the same run (what the process hop costs; no gain is
   claimed), the ops by path, the largest allreduce and arena, and
   ``/dev/shm``'s size.
14. ``supervised_cpp`` (after the train phases' hash checks) — the
   deployment path: the port's ``ReplicaSupervisor`` runs one
   ``python -m torchft_tpu_torch.train_ddp`` process per replica group (8B
   width, 2 layers, 3 steps, the C++ tier, heal over comm) against a C++
   lighthouse with ``bench.py``'s fleet settings, group 1 with a warm
   standby parked behind its active process.  Once group 1 has committed a
   step, ``chaos.ProcessReplica`` SIGKILLs its active process; the
   supervisor promotes the standby, which joins, heals the whole state and
   trains to the end.  Checks (``check_supervised``): both groups exit 0 at
   step 3 with equal parameter hashes; group 1 promoted once, from the
   parked standby, with no cold restart; the promoted process healed its
   state's payload bytes; every process that reported launched each flash
   kernel (group 0, the killed active, the standby when parked and at the
   end); no fleet process left alive.  Prints cold start, park, kill to
   adopted quorum and to first commit, the heal, each process's peak
   device memory and the wall time.  The hash is not held to
   :data:`EXPECTED_SHA256` (a signal at an arbitrary moment changes which
   steps commit with one participant).

15. ``chaos_deadlock`` (beside ``hsdp_cpp`` and ``pipeline_phase``, in a
   process of its own) —
   ``python -m torchft_tpu_torch.chaos_drill --failure deadlock``: two
   ``train_ddp`` processes under the port's supervisor train ``cnn_cpp``'s
   CNN on the card on the C++ tier for 160 steps paced 0.5 s (0.4 s of
   work planned past the pace); group 1 is frozen with SIGSTOP past the
   per-op timeout the drill derives from that step and evicted; it thaws, exits on its lapsed
   should_commit RPC deadline, and is restarted by its supervisor and
   heals (or rejoins in place and heals).  Checks
   (``check_chaos_deadlock``): one deadlock injected; the victim's next
   commit after its freeze; both groups end at step 160 with equal hashes;
   the victim healed past step 0; no worker left alive.  Prints the
   timing, the heal, the step it healed at and the survivor's steps left
   then, and the wall time; a drill that failed raises with the drill's
   own last lines.

Each sync's C++-tier parameter hash must equal its Python tier's.  The
DDP train phases run with ``obs.spans`` on; each prints the ``commit`` split
(seconds per steady step in ``manager::quorum_rpc``, ``comm::op``,
``manager::fence`` and ``manager::should_commit``), the host tail of the
gradient average (:data:`HOST_SPANS`) and the seconds of the step outside
``compute`` that no span covers (``unspanned_s``), and the heal's seconds
and bytes.  Every phase that heals (the train phases, the DiLoCo phases,
``hsdp_cpp``, ``supervised_cpp`` and ``baby_cpp``; ``spare_python`` beside
``diloco_cpp``'s cold heal) prints its heal's bytes, GB/s and split
(``heal_split_s``: seconds in each span of :data:`HEAL_SPANS` per replica;
the worker processes of ``hsdp_cpp`` and ``supervised_cpp`` record spans
under ``TORCHFT_FLIGHT_SPANS=1`` and report their totals).  Any failure
raises, so the exit code is non-zero.  The last line
of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

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
# DDP and HSDP train steps; replica 1 is killed before step 2 (4 until the
# fleet phases joined: the command stays inside its limit with them)
STEPS = 3
# (results key, should_quantize, tier) of each train phase, in run order;
# the kernels line takes its launches from the C++ tier's phases.  Each
# sync runs on both tiers
TRAIN_PHASES = (
    ("train_cpp", False, "cpp"),
    ("train_python", False, "python"),
    ("train_quantized_cpp", True, "cpp"),
    ("train_quantized_python", True, "python"),
)
# heal transport of each train phase: the float phases heal over the
# communicator (CommTransport), the quantized ones over HTTP, so one run
# compares both transports on the same state
TRAIN_HEAL_TRANSPORT = {"train_cpp": "comm", "train_python": "comm",
                        "train_quantized_cpp": "http", "train_quantized_python": "http"}
# replica groups of each train phase, and the sources replica 1's heal
# takes: the int8 phases train three groups, so on the Python tier the
# killed one heals striped from the two others (every up-to-date group is
# a source, manager_server.py); the C++ sidecar advertises one source in
# both packages.  The float phases keep two groups
TRAIN_REPLICAS = {"train_cpp": 2, "train_python": 2,
                  "train_quantized_cpp": 3, "train_quantized_python": 3}
TRAIN_HEAL_SOURCES = {"train_cpp": 1, "train_python": 1,
                      "train_quantized_cpp": 1, "train_quantized_python": 2}
HSDP_HEAL_TRANSPORT = "comm"
# the final parameter sha256 of each DDP sync and of hsdp_cpp, as every
# earlier run of this script at STEPS gave them (PERF.md): a heal is
# bit-exact, whatever carries it, so any change is a fault.  At 4 steps
# (before the fleet phases joined) they were c894c076..., fd116fce... and
# 8dcd35ec...; the int8 sync's at two groups (before it trained three)
# 54b70f3a5945b0df771ee59fdafd37d5c0d9c769f0743275e0ad5ba312851c48
EXPECTED_SHA256 = {
    "float": "963bb6894370d0036e34d8acafa3d7be5566419a0f4df4f417fb575dff1ec943",
    "quantized": "73db8d6fcbaeab71498209bdd191c77af9d80680e10d62106b4d005fe58fa794",
    "hsdp": "c93b8cb0340484ee02a44812d83efbfe5d5653893648b8deb6cf008a6d426bbc",
}
PLANES = {
    "cpp": dict(lighthouse="CppLighthouseServer", manager_server="CppManagerServer",
                communicator="CppCommunicator"),
    "python": dict(lighthouse="LighthouseServer", manager_server="ManagerServer",
                   communicator="TCPCommunicator"),
}
# the spans that split ``commit``: the quorum RPC, each collective on the
# communicator's op thread, the vote's fence on the pending works, the vote
SPLIT_SPANS = ("manager::quorum_rpc", "comm::op", "manager::fence", "manager::should_commit")
# the spans that split the host tail of the gradient average: on the train
# thread (the ``allreduce`` phase) the wait for the quorum started before
# the forward (ddp::quorum_wait), staging each bucket (ddp::stage: the
# concatenation, the pinned buffer, the device-to-host copy and its wait;
# the int8 path: flatten, quantize and copy the payload) and submitting its
# ring (ddp::submit); behind the vote's fence, the int8 pipeline
# (quant::pipeline, its host dequantize quant::dequantize within), the AVG
# divide (manager::avg), the gather of each bucket's average (ddp::gather)
# and the copy back into the .grad tensors (ddp::copy_back)
HOST_SPANS = ("ddp::quorum_wait", "ddp::stage", "ddp::submit", "quant::pipeline",
              "quant::dequantize", "manager::avg", "ddp::gather", "ddp::copy_back")
# which of them run on the train thread, and which make up the pipeline the
# fence waits for, per sync (a ring's comm::op holds the float pipeline's
# wire; the int8 pipeline's ops run inside quant::pipeline)
TRAIN_THREAD_SPANS = ("ddp::quorum_wait", "ddp::stage", "ddp::submit")
FENCED_SPANS = {False: ("comm::op", "manager::avg", "ddp::gather", "ddp::copy_back"),
                True: ("quant::pipeline", "manager::avg", "ddp::gather", "ddp::copy_back")}
# the spans of the DiLoCo outer sync (local_sgd.py, collectives.py), summed
# per committed sync: the copy of the pseudo-gradient into the wire's host
# buffer, the reshard, the pseudo-gradient (backup - live, on the card), the
# submit and the wait of the pipeline (or its streamed twins), the quorum,
# the vote, the new global parameters and the writes of the live ones.
# Inside the pipeline (on its own thread): the int8 contribution's
# quantize, the waits for each chunk's alltoall, the gathered contributions
# to the card (on int8 dequantized there), the host's sum (host path), the
# update (on the card the kernel's launch), the delta to the wire (on the
# card its copy back, which waits for the kernel; on int8 its quantize), the
# waits for each allgather and the allgathered deltas into the delta
DILOCO_SPANS = ("diloco::host_copy", "diloco::reshard", "diloco::pseudograd", "diloco::prepare",
                "stream::submit", "outer_shard::pipeline", "diloco::perform", "stream::barrier",
                "manager::quorum_rpc", "manager::fence", "manager::should_commit",
                "diloco::apply", "diloco::write", "outer_shard::contribution",
                "outer_shard::scatter_wait", "outer_shard::to_card", "outer_shard::sum",
                "outer_shard::chunk_update", "outer_shard::to_wire", "outer_shard::gather_wait",
                "outer_shard::from_wire")
# the spans of a heal and the reshard after it, summed per replica over the
# phase (over every thread: the serving threads of parallel range requests
# add up): the checkpoint's send (which holds the fragments' save_state:
# the owner's shard card -> host) and, inside it, the sender's copies from
# the card to the host (heal::send_copy) and its socket or comm writes
# (heal::send_write, the waits on them); the receive and, inside it, the
# receiver's landing buffers (heal::recv_land: their allocation, and the
# first touch where it is done apart) and its reads into them
# (heal::recv_read); the apply at should_commit (manager::heal_apply: the
# copy back to the card), which holds the fragments' load_state (the
# backups host -> card); the reshard's export of the shard (card -> host),
# its exchange (the wait for the healed peer and the allgathers) and its
# rebuild (the shard host -> card)
HEAL_SPANS = ("manager::heal_send", "heal::send_copy", "heal::send_write", "manager::heal_recv",
              "heal::recv_land", "heal::recv_read", "manager::heal_apply", "diloco::save_state",
              "diloco::load_state", "outer_shard::export", "outer_shard::exchange",
              "outer_shard::rebuild")
# (results key, run_diloco_fleet keywords) of each DiLoCo / LocalSGD phase,
# all on the C++ tier: bench.py's phase D schedule, the same streamed, and
# LocalSGD (3 committed outer steps, and LocalSGD 1 sync, since the CNN and
# HSDP phases joined the script; 4 and 2 before: the command stays inside
# its 1200 s limit).  Three is the fewest at which the restarted replica
# syncs every fragment after its heal: fragment 1 at outer step 2,
# fragment 0 at step 3.
DILOCO = dict(algo="diloco", sync_every=8, num_fragments=2, fragment_sync_delay=2,
              outer_steps=3, kill_at=(1, 5))
# diloco_stream_cpp: DILOCO under the streamed outer sync (STREAM_ENV): at a
# per-fragment cadence of 4 with delay 2 the stall is 1 inner step
# (stream_stall_for(4, 2)).  Replica 1 is killed before its inner step 6,
# right after the wrapper step that submitted fragment 1's streamed sync,
# so the kill lands between that submit and its barrier (3 inner steps
# later), as the stream drill's does
STREAM_ENV = {"TORCHFT_STREAM_SYNC": "1"}
STREAM_KILL_AT = (1, 6)
# diloco_quantized_cpp: DILOCO over the int8 wire, its kill and its heal
# over HTTP included
DILOCO_QUANTIZED = dict(DILOCO, should_quantize=True)
DILOCO_PHASES = (
    ("diloco_cpp", dict(DILOCO, should_quantize=False)),
    ("diloco_stream_cpp", dict(DILOCO, should_quantize=False, kill_at=STREAM_KILL_AT)),
    ("diloco_quantized_cpp", DILOCO_QUANTIZED),
    ("localsgd_cpp", dict(algo="localsgd", sync_every=4, num_fragments=1,
                          fragment_sync_delay=0, outer_steps=1, should_quantize=False)),
)
# the knobs each DiLoCo phase runs under (the others: none)
DILOCO_ENV = {"diloco_stream_cpp": STREAM_ENV}
# localsgd_cpp is a job loss (jobloss_phase): its fleet runs to
# outer_steps and saves a durable checkpoint, and a second fleet restores it
# and runs one committed sync more.  A checkpoint holds the bf16 weights and
# both bf16 AdamW moments: 6 bytes a parameter (7.6 GB at 1 layer)
JOBLOSS_BYTES_PER_PARAM = 6
# the card must execute a matmul (utils/probe.py, in a subprocess) before
# anything is built: each attempt times out after PROBE_TIMEOUT_S, and the
# attempts stop after PROBE_WINDOW_S
PROBE_TIMEOUT_S, PROBE_WINDOW_S = 60.0, 120.0
# the DiLoCo and spare phases cut to 1 layer (the width stays) so the
# command stays inside its 1200 s limit with the pipeline, MoE and
# rehearsal phases; diloco_cpp and spare_python share a depth, so the cold
# heal printed beside the promotion moves the same state
DILOCO_LAYERS = {"diloco_cpp": 1, "diloco_stream_cpp": 1, "diloco_quantized_cpp": 1,
                 "localsgd_cpp": 1, "spare_python": 1}
# spare_python: DILOCO's schedule with one hot spare, every plane on the
# Python tier (the C++ manager sidecar refuses the spare role): 2 actives
# and the spare as threads of this process; replica 1 is killed before its
# inner step 5 and stays dead, and the lighthouse promotes the spare in its
# place.  SPARE_ENV sets existing knobs for the phase: the fleet holds at the
# kill step while the spare warms, so its chunk fetch runs unpaced and one
# refresh pass may take the whole snapshot.  Two committed outer steps
# (three until the fleet phases joined): the promoted spare syncs each
# fragment once with the survivor.
SPARE_PHASE = dict(DILOCO, should_quantize=False, spares=1, outer_steps=2)
SPARE_ENV = {"TORCHFT_SPARE_WARM_PACE_MS": "0", "TORCHFT_SPARE_WARM_BUDGET_S": "600"}
# spare_drills: gray_failure_drill's spare modes at the JAX tests' sizes,
# then the outer-delta feed on the card.  The feed refuses a delta over its
# 48 MiB frame budget, and each fragment of the 8B-width phase is 2.97 GB,
# so the feed runs on a Llama narrow enough to carry it (head dim 64, bf16,
# 1.6M parameters): killed before inner step 9, after a committed sync the
# spare takes from the feed (TORCHFT_SPARE_WARM_REFRESH_S=60 keeps the
# survivors from restaging first).
SPARE_DELTA_CFG = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
                       ffn_hidden=512, max_seq_len=256)
SPARE_DELTA_FLEET = dict(DILOCO, should_quantize=False, spares=1, outer_steps=4, kill_at=(1, 9),
                         batch=2, seq=128, lr=1e-3)
SPARE_DELTA_ENV = {"TORCHFT_SPARE_WARM_REFRESH_S": "60"}
# run_fleet keywords of cnn_cpp (examples/train_ddp.py's defaults) and
# run_hsdp_fleet keywords of hsdp_cpp; both on the C++ tier
CNN_PHASE = dict(replicas=2, steps=20, batch=32, lr=1e-3, kill_at=(1, 5))
# chaos_deadlock: the chaos drill's CLI (chaos_deadlock_cmd), a deadlock on
# two train_ddp processes training cnn_cpp's model on the card (the C++
# tier, and the timing the drill derives from a 0.5 s pace and 0.4 s of
# work: a 5 s per-op timeout, a 12 s freeze).  On the
# card the thawed member exits with its should_commit RPC's deadline
# lapsed and its supervisor restarts it (30-41 s from the thaw to its
# first commit on H100 hosts, more on a slower or busier host), and the
# survivor must still train then: a lone survivor steps at about its
# pace, and 160 steps paced 0.5 s keep it training ~77 s past the
# eviction, room for a restart of 70 s (100 steps left 7-14 s to spare
# and lost the race on a slower host), with a pace near the paired step
# (~0.55 s) so the run's length does not hang on how the member returns
CHAOS_DEADLOCK = dict(replicas=2, failure="deadlock", victim=1, steps=160, step_time=0.5,
                      step_work=0.4)
# the CLI's worker flags: the CNN keeps its preset (--layers 0)
CHAOS_WORKER = ["--device", "cuda", "--model", "cnn", "--layers", "0"]
# it runs beside hsdp_cpp and pipeline_phase (start_chaos_deadlock), whose
# numbers no other phase is held against, at the cost of a fraction of one
# core; alone, at 100 steps, it took 76-88 s
CHAOS_DEADLOCK_TIMEOUT_S = 600.0
HSDP_PHASE = dict(groups=2, fsdp=1, tp=1, steps=STEPS, batch=1, seq=2048, lr=1e-4, kill_at=(1, 2))
# pipeline_phase: PipelinedLlama at Llama-3-8B width, 2 layers over 2
# stages (one a stage) in one process, every layer recomputed ("layer"),
# held against the plain Llama with the same weights and no remat: loss
# within PIPE_LOSS_RTOL (relative), each gradient within PIPE_GRAD_RTOL
# normwise (both arms bf16, on different paths)
PIPELINE_CASE = dict(layers=2, pp=2, batch=4, seq=2048, microbatches=4, remat_mode="layer")
PIPE_LOSS_RTOL, PIPE_GRAD_RTOL = 1e-2, 2e-2
PIPE_TIMED_STEPS = 3
# moe_hsdp_cpp: train_hsdp over llama3_8b_moe (8 experts, capacity factor
# 1.5) cut to MOE_LAYERS, 2 groups of one process at ep = fsdp = tp = 1,
# the C++ tier, 3 steps, no kill: the kill and heal of a 2.03B-parameter
# state (~40 s) would take the command past its 1200 s limit, and hsdp_cpp
# heals the same code path
MOE_LAYERS = 1
MOE_PHASE = dict(groups=2, fsdp=1, tp=1, ep=1, steps=3, batch=1, seq=2048, lr=1e-4)
SPAN_CAP = 200_000  # the quantized phase records ~1,400 comm ops a step
LAYERS = 2  # Llama-3-8B depth cut from 32 so the replicas (2, or 3 int8) fit one card
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
# the port's kernels that replace host code of the JAX package, not a
# Pallas kernel: (CUDA source, the host function it replaces)
PORT_KERNELS = {
    "ddp_avg": ("torchft_tpu_torch/csrc/avg.cu", "torchft_tpu/manager.py:1831"),
    # DiLoCo's outer update: the host chunk sum and scale of the sharded
    # sync (torchft_tpu/collectives.py) and the optax step of its owner's
    # shard, the update callback _cb
    "diloco_outer": ("torchft_tpu_torch/csrc/outer.cu", "torchft_tpu/local_sgd.py:295"),
}
# avg_phase cases: a bucket SUM of ``n`` elements divided by ``divisor``
# into a leaf.  "main" is the float path's whole gradient (bf16 into bf16,
# 2 replicas), "int8" the int8 path's (its f32 sum into bf16 leaves),
# "f32" the f32 buckets' and "special" NaNs of both signs and with
# payloads, ±inf, subnormals and ties at 3 replicas, also held against the
# host's divide (``bf16.div``, numpy's f32 division)
AVG_CASES = (
    dict(name="main", n=1_486_901_248, src=torch.bfloat16, dst=torch.bfloat16, divisor=2),
    dict(name="int8", n=1_486_901_248, src=torch.float32, dst=torch.bfloat16, divisor=2),
    dict(name="f32", n=1 << 24, src=torch.float32, dst=torch.float32, divisor=3),
    dict(name="special", n=(1 << 20) + 7, src=torch.bfloat16, dst=torch.bfloat16, divisor=3),
    dict(name="special f32", n=(1 << 20) + 7, src=torch.float32, dst=torch.float32, divisor=3),
)
# The main path divides each leaf in place (src is dst): one leaf of the 8B
# MLP (16-byte aligned throughout) and a ragged length with the special
# values, bf16 and f32, held bit for bit against the plain version (the
# special ones against the host's divide too)
AVG_IN_PLACE_CASES = (
    dict(name="leaf in place", n=4096 * 14336, src=torch.bfloat16, dst=torch.bfloat16, divisor=2),
    dict(name="special in place", n=(1 << 20) + 7, src=torch.bfloat16, dst=torch.bfloat16,
         divisor=3),
    dict(name="leaf f32 in place", n=4096 * 14336, src=torch.float32, dst=torch.float32,
         divisor=3),
    dict(name="special f32 in place", n=(1 << 20) + 7, src=torch.float32, dst=torch.float32,
         divisor=3),
)
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
# ring_phase: Llama-3-8B attention width, S = 8192 over sp = 4 ranks in one
# process (blocks of 2048, the train phases' sequence)
RING_CASE = dict(B=1, S=8192, H=32, KV=8, D=128, sp=4)
# and on blocks of 640 tokens, a length the CPU's (JAX) flash gate refuses:
# on the card the ring runs the kernels at any block length
RING_RAGGED_CASE = dict(B=1, S=2560, H=32, KV=8, D=128, sp=4)
# the ring (kernels) against whole-sequence flash: they round differently
# (the ring merges up to 4 bf16 partial outputs in f32, and autograd sums a
# block's gradient partials in bf16), so elementwise |err| <=
# RING_ATOL_REL·max|whole| + RTOL·|whole| and normwise <= NORM_RTOL
RING_ATOL_REL = 1 / 64
CASES = [
    MAIN_CASE,
    dict(name="full_rect_ragged", B=1, H=32, KV=8, Sq=1000, Sk=1800, D=128, causal=False),
    dict(name="gqa1_d64", B=2, H=8, KV=8, Sq=1024, Sk=1024, D=64, causal=True),
    dict(name="causal_ragged_b2", B=2, H=8, KV=2, Sq=1000, Sk=1000, D=128, causal=True),
    dict(name="causal_short", B=1, H=32, KV=8, Sq=100, Sk=100, D=128, causal=True),
]


class CardProbeError(RuntimeError):
    """The card did not execute the probe's matmul within its window: the
    run stops before building anything, and never goes on on the CPU."""


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


def ring_launches_expected(sp: int) -> dict:
    """Kernel launches of one forward and backward of the ring over ``sp``
    ranks, by mask: rank r attends its diagonal block causally and the r
    earlier blocks fully, and each block's backward launches dq and dkv
    once (sp = 4: 4 causal and 6 full of each)."""
    counts = {"causal": sp, "full": sp * (sp - 1) // 2}
    return {name: dict(counts) for name in ("fwd", "dq", "dkv")}


def check_ring_launches(launches: dict, causal_launches: dict, sp: int) -> dict:
    """The ring's launches by kernel and mask (``fa.launches`` and
    ``fa.causal_launches`` read right after its run); raises unless they
    are :func:`ring_launches_expected`."""
    got = {name: {"causal": causal_launches[name], "full": launches[name] - causal_launches[name]}
           for name in ("fwd", "dq", "dkv")}
    if got != ring_launches_expected(sp):
        raise AssertionError(f"ring launches {got}, expected {ring_launches_expected(sp)}")
    return got


def _ring_run(ring, q, k, v, do, sp: int, attend):
    """The ring over ``sp`` blocks in one process, forward and backward
    with cotangent ``do``: (o, dq, dk, dv), whole-sequence tensors."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    blocks = [t.chunk(sp, dim=1) for t in (q, k, v)]
    o = torch.cat(ring.ring_attention_blocks(*blocks, attend=attend), dim=1)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def _whole_run(fa, q, k, v, do):
    """Whole-sequence causal flash attention, forward and backward."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o = fa.flash_attention(q, k, v, causal=True)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def plain_attend(fa):
    """The ring's block attention on the kernels' plain versions (the same
    autograd chain as the kernels', on any device), tiled by the largest
    divisor of the block length up to 512."""

    def attend(q, k, v, causal):
        tiles = (math.gcd(q.shape[1], 512), math.gcd(k.shape[1], 512))
        scale, bq, bk = fa._validate(q, k, causal, None, *tiles)
        o, lse = fa._FlashAttention.apply(
            fa._heads_major(q), fa._heads_major(k), fa._heads_major(v), scale, causal, bq, bk,
            fa.PLAIN)
        return o.transpose(1, 2), lse.transpose(1, 2)

    return attend


def _ring_err(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """max |err|, its share of max |want| and the normwise error of the
    ring against whole-sequence flash; ``ok`` under the ring tolerance."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = want.abs().max().clamp_min(1e-30)
    norm_rel = (err.norm() / want.norm().clamp_min(1e-30)).item()
    ok = bool(torch.isfinite(got).all()) and not (
        (err > RING_ATOL_REL * top + RTOL * want.abs()).any().item() or norm_rel > NORM_RTOL)
    return dict(max_abs=err.max().item(), max_rel_to_top=(err.max() / top).item(),
                norm_rel=norm_rel, ok=ok)


def ring_check(fa, ring, case: dict, device: torch.device) -> dict:
    """Ring attention over ``case["sp"]`` single-process ranks on the flash
    wrappers (the kernels on the card), forward and backward: its launches
    by mask (counted from 0 over exactly this run), its peak device memory,
    and its o, dq, dk, dv held against whole-sequence causal flash (the
    ring tolerance) and against the same ring on the plain versions (the
    kernel tolerances).  Raises on a failed comparison, after printing all
    of them."""
    B, S, H, KV, D, sp = (case[k] for k in ("B", "S", "H", "KV", "D", "sp"))
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)

    q, do = randn(B, S, H, D), randn(B, S, H, D)
    k, v = randn(B, S, KV, D), randn(B, S, KV, D)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    fa.reset_launches()
    got = _ring_run(ring, q, k, v, do, sp, ring.flash_attend)
    if cuda:
        torch.cuda.synchronize()
    launches, causal = dict(fa.launches), dict(fa.causal_launches)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9 if cuda else None
    whole = _whole_run(fa, q, k, v, do)
    plain = _ring_run(ring, q, k, v, do, sp, plain_attend(fa))
    names = ("o", "dq", "dk", "dv")
    vs_whole = {n: _ring_err(n, g, w) for n, g, w in zip(names, got, whole)}
    print(f"ring (S={S}, sp={sp}) vs whole-sequence flash: {json.dumps(vs_whole)}", flush=True)
    vs_plain: dict = {}
    for n, g, w in zip(names, got, plain):
        _max_err(f"ring {n}", g, w, vs_plain)
    print(f"ring (S={S}, sp={sp}) vs its plain versions: {json.dumps(vs_plain)}", flush=True)
    bad = [n for n, e in vs_whole.items() if not e["ok"]]
    if bad:
        raise AssertionError(
            f"ring {bad} disagree with whole-sequence flash (tolerance {RING_ATOL_REL}·max|whole| "
            f"+ {RTOL}·|whole|, normwise {NORM_RTOL}): {json.dumps(vs_whole)}")
    return dict(case=case, launches=launches, causal_launches=causal, vs_whole=vs_whole,
                vs_plain=vs_plain, peak_device_gb=peak_gb,
                max_abs_err=max(e["max_abs"] for e in vs_plain.values()))


def ring_phase(fa, ring, iters: int) -> dict:
    """:func:`ring_check` at :data:`RING_CASE` on the card, the launch
    counts checked, and the ring (kernels) timed against whole-sequence
    flash, forward alone and forward with backward, and the plain ring."""
    case = RING_CASE
    device = torch.device("cuda")
    out = ring_check(fa, ring, case, device)
    out["ring_launches"] = check_ring_launches(out["launches"], out["causal_launches"], case["sp"])
    ragged = ring_check(fa, ring, RING_RAGGED_CASE, device)
    check_ring_launches(ragged["launches"], ragged["causal_launches"], RING_RAGGED_CASE["sp"])
    out["ragged"] = {k: ragged[k] for k in ("case", "launches", "vs_whole", "vs_plain")}
    gen = torch.Generator(device=device).manual_seed(1)
    B, S, H, KV, D, sp = (case[k] for k in ("B", "S", "H", "KV", "D", "sp"))
    q, do = (torch.randn(B, S, H, D, generator=gen, device=device).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, KV, D, generator=gen, device=device).bfloat16() for _ in range(2))

    def ring_fwd():
        with torch.no_grad():
            ring.ring_attention_blocks(*(t.chunk(sp, dim=1) for t in (q, k, v)))

    def whole_fwd():
        with torch.no_grad():
            fa.flash_attention(q, k, v, causal=True)

    # the ring attends the same (q, k) pairs as whole-sequence causal flash
    # (its diagonal blocks' triangles and its full blocks), so they share
    # the bound; each kernel's bound as _bound counts it
    whole = dict(B=B, H=H, KV=KV, Sq=S, Sk=S, D=D, causal=True)
    bounds = {name: _bound(whole, name)[0] for name in ("fwd", "dq", "dkv")}
    out.update(
        bound_fwd_ms=bounds["fwd"],
        bound_fwd_bwd_ms=sum(bounds.values()),
        ring_fwd_ms=_time_ms(ring_fwd, iters),
        whole_fwd_ms=_time_ms(whole_fwd, iters),
        ring_fwd_bwd_ms=_time_ms(lambda: _ring_run(ring, q, k, v, do, sp, ring.flash_attend), iters),
        whole_fwd_bwd_ms=_time_ms(lambda: _whole_run(fa, q, k, v, do), iters),
        plain_ring_fwd_bwd_ms=_time_ms(
            lambda: _ring_run(ring, q, k, v, do, sp, plain_attend(fa)), 2, 1),
    )
    return out


# card_gate_check: sequence lengths the CPU's (JAX) flash gate refuses
GATE_SEQS = (16, 100, 640)


def card_gate_check(fa, train_ddp) -> dict:
    """The model's attention gate on the card: a one-layer model at
    Llama-3-8B attention width (vocab and FFN cut to 1024) takes a loss and
    its backward at each of :data:`GATE_SEQS`, and must launch each flash
    kernel once (never plain attention) with a finite loss; the kernels'
    numbers at such lengths are held by ``causal_short`` and the ragged
    ring.  Raises otherwise."""
    import dataclasses

    from torchft_tpu_torch.models.llama import Llama

    cfg = dataclasses.replace(train_ddp.model_config("llama3_8b", 1), vocab_size=1024,
                              ffn_hidden=1024)
    model = Llama(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
    for seq in GATE_SEQS:
        tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=gen, device="cuda")
        fa.reset_launches()
        loss = model.loss(tokens, tokens.roll(-1, 1))
        loss.backward()
        torch.cuda.synchronize()
        launches = dict(fa.launches)
        if launches != {"fwd": 1, "dq": 1, "dkv": 1} or not torch.isfinite(loss):
            raise AssertionError(f"the model at S={seq} on the card launched {launches} "
                                 f"(loss {loss.item()}), not each flash kernel once")
        out[seq] = dict(launches=launches, loss=loss.item())
    del model
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


def _avg_input(case) -> torch.Tensor:
    """A bucket SUM on the card in the case's dtype: normal values over
    many decades; the special cases add NaNs (both signs, a payload, a
    signaling one), ±inf, the largest finite value and subnormals."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    n = case["n"]
    x = torch.randn(n, generator=gen, device="cuda")
    x *= torch.logspace(-38, 38, 4096, device="cuda").repeat(-(-n // 4096))[:n]
    if case["name"].startswith("special"):
        bits = x.view(torch.int32)
        bits[:8] = torch.tensor([0x7FC00000, -0x400000, 0x7FA00001, -0x3EDCBB, 0x7F800000,
                                 -0x800000, 0x7F7FFFFF, 0x00000001], device="cuda",
                                dtype=torch.int32)
        x[8:16] = torch.tensor([1e-39, -1e-40, 3.0, 1.0 + 2.0 ** -8, 0.0, -0.0, 5e-45, 1.5],
                               device="cuda")
    return x.to(case["src"]) if case["src"] == torch.float32 else (
        (x.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16))


def _avg_host(case, src: torch.Tensor) -> torch.Tensor:
    """The host's divide of ``src`` (bf16.div; numpy's f32 division), as
    the bits the card must write."""
    import numpy as np

    from torchft_tpu_torch import bf16

    host = src.cpu()
    if case["src"] == torch.bfloat16:
        out = bf16.div(bf16.from_tensor(host), case["divisor"])
        return torch.from_numpy(out.view(np.int16).copy()).view(torch.bfloat16)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(host.numpy() / np.float32(case["divisor"]))


def avg_phase(avg, iters: int) -> dict:
    """Per case: the avg kernel held bit for bit against its plain version
    on the card (and, for the special cases, the host's divide), with
    kernel / plain / library ms (one ``torch.div`` by a tensor divisor,
    which rounds a NaN to the card's own) and the bound: bytes (the sum
    read once, the leaf written once) against one f32 division an element.
    Then :data:`AVG_IN_PLACE_CASES`, divided in place as the main path
    divides, held and not timed.  The launches made here are comparisons
    and are reset before the train phases."""
    out = {}
    for case in AVG_CASES:
        src = _avg_input(case)
        dst = torch.empty(case["n"], dtype=case["dst"], device="cuda")
        want = torch.empty_like(dst)
        divisor = case["divisor"]
        avg.average_into(src, divisor, dst)
        avg.average_into_plain(src, divisor, want)
        err = _exact(f"avg {case['name']}", dst, want)
        if case["name"].startswith("special"):
            err = max(err, _exact(f"avg {case['name']} against the host", dst.cpu(),
                                  _avg_host(case, src)))
        d_tensor = torch.full((), float(divisor), device="cuda")
        ms = _time_ms(lambda: avg.average_into(src, divisor, dst), iters)
        plain_ms = _time_ms(lambda: avg.average_into_plain(src, divisor, want), 2, 1)
        library_ms = _time_ms(lambda: torch.div(src, d_tensor), iters)
        nbytes = case["n"] * (src.element_size() + dst.element_size())
        t_bytes, t_ops = nbytes / PEAK_BYTES, case["n"] / PEAK_F32_FLOPS
        out[case["name"]] = row = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(t_bytes, t_ops) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            n=case["n"], src=str(case["src"]), dst=str(case["dst"]), divisor=divisor,
            pct_of_bound=100 * max(t_bytes, t_ops) * 1e3 / ms,
        )
        print(f"avg case {case['name']}: {json.dumps(row)}", flush=True)
        del src, dst, want
        torch.cuda.empty_cache()
    for case in AVG_IN_PLACE_CASES:
        src = _avg_input(case)
        want = torch.empty_like(src)
        avg.average_into_plain(src, case["divisor"], want)
        host = _avg_host(case, src) if case["name"].startswith("special") else None
        avg.average_into(src, case["divisor"], src)
        err = _exact(f"avg {case['name']}", src, want)
        if host is not None:
            err = max(err, _exact(f"avg {case['name']} against the host", src.cpu(), host))
        out[case["name"]] = row = dict(max_abs_err=err, n=case["n"], src=str(case["src"]),
                                       divisor=case["divisor"])
        print(f"avg case {case['name']}: {json.dumps(row)}", flush=True)
        del src, want
        torch.cuda.empty_cache()
    return out


# outer_phase: the outer kernel (``ops/outer.py``) at one owner's shard of
# the 1-layer DiLoCo fragment (2 owners, float wire) with the special values
# (held, in place, bit for bit) and at the shard's first pipeline chunk, the
# main path's launch (held and timed); a ragged w = 3 case with plain
# momentum and a no-momentum case (held).  The update is the phases' own:
# OuterSGD(0.7, momentum=0.9, nesterov=True)
OUTER_RULE = dict(lr=0.7, momentum=0.9, nesterov=True)
OUTER_CASES = (
    dict(name="shard", w=2, n="shard", special=True, in_place=True, **OUTER_RULE),
    dict(name="chunk", w=2, n="chunk", special=False, in_place=True, **OUTER_RULE),
    dict(name="ragged w3 momentum", w=3, n=(1 << 20) + 7, special=True, in_place=False,
         lr=0.7, momentum=0.9, nesterov=False),
    dict(name="sgd", w=2, n=1 << 20, special=True, in_place=False, lr=0.7, momentum=0.0,
         nesterov=False),
)
# the pseudo-gradient's copy into its host buffer: pageable against pinned,
# in turns, at one fragment's size, a piece at a time as the sync copies it
COPY_AB_ORDER = ("pageable", "pinned", "pinned", "pageable")


def diloco_fragments(train_ddp, layers: int) -> list:
    """The DiLoCo phases' fragments of Llama-3-8B width at ``layers``: per
    fragment its (name, shape, dtype) in order, from a model on the meta
    device (nothing is allocated)."""
    from torchft_tpu_torch.local_sgd import partition_parameters
    from torchft_tpu_torch.models.llama import Llama

    model = Llama(train_ddp.model_config("llama3_8b", layers), device="meta")
    named = dict(model.named_parameters())
    return [[(name, tuple(named[name].shape), named[name].dtype) for name in group]
            for group in partition_parameters(model, DILOCO["num_fragments"])]


def outer_shapes(fragment: list) -> dict:
    """The fragment's elements, one owner's shard at 2 owners on the float
    wire, and that shard's first pipeline chunk (the main path's launch)."""
    from torchft_tpu_torch import wire
    from torchft_tpu_torch.collectives import _outer_chunk_ranges, outer_shard_layout

    n = sum(math.prod(shape) for _, shape, _ in fragment)
    _padded, per, unit = outer_shard_layout(n, 2, False)
    c0, c1 = _outer_chunk_ranges(per, unit, 2, max_chunks=wire.OUTER_SHARD_TAG_SPAN // 2)[0]
    return dict(fragment=n, shard=per, chunk=c1 - c0)


def _outer_inputs(case, n: int, seed: int) -> tuple:
    """w contributions and a trace on the card: normal values over many
    decades; the special cases add -0.0 everywhere, ±inf, inf - inf, NaN
    payloads and subnormals at the front."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = case["w"]
    c = torch.randn(w, n, generator=gen, device="cuda")
    t = torch.randn(n, generator=gen, device="cuda")
    decades = torch.logspace(-30, 30, 4096, device="cuda").repeat(-(-n // 4096))[:n]
    c *= decades
    t *= decades.flip(0)
    if case["special"]:
        c[:, 0], t[0] = -0.0, -0.0
        c[0, 1], c[w - 1, 2] = float("inf"), float("-inf")
        c[0, 3] = float("inf")
        c.view(torch.int32)[w - 1, 4] = 0x7FC00123
        t.view(torch.int32)[5] = 0x7FA00007
        c.view(torch.int32)[:, 6:10] = torch.tensor([1, -0x7FFFFFFD, 0x007FFFFF, 0x10],
                                                    dtype=torch.int32, device="cuda")
        t.view(torch.int32)[6:10] = torch.tensor([5, 0x00200000, -0x80000000, 1],
                                                 dtype=torch.int32, device="cuda")
    return c, t


def _outer_library(contribs, scale: float, trace, lr: float, momentum: float):
    """The same function as a PyTorch user writes it in eager torch: the
    reduction, then in-place products and sums (``add`` with ``alpha``)."""
    g = contribs.sum(0).mul_(scale)
    if not momentum:
        return g.mul_(-lr)
    t = trace.mul(momentum).add_(g)
    return g.add(t, alpha=momentum).mul_(-lr)


def outer_numpy_checks() -> dict:
    """What this host's numpy does where the outer kernel must follow it:
    whether a sum over axis 0 of -0s is -0 (it starts from +0 in numpy
    2.0.2), and the int8 chunk sum's einsum against separately rounded
    products and sums, and against a fused second term, on 65,536 elements."""
    import numpy as np

    zeros = np.sum(np.full((2, 64), -0.0, np.float32), axis=0)
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (2, 64, 1024)).astype(np.float32)
    s = (rng.random((2, 64)) * 0.01).astype(np.float32)
    e = np.einsum("wrc,wr->rc", q, s)
    p = q * s[:, :, None]
    separate = (np.float32(0) + p[0]) + p[1]
    fused = (p[0].astype(np.float64) + q[1].astype(np.float64) * s[1][:, None]).astype(np.float32)
    return dict(numpy=np.__version__, sum_of_negative_zeros_negative=bool(np.signbit(zeros).any()),
                einsum_differs_from_mul_then_add=int((e != separate).sum()),
                einsum_differs_from_fused_second_term=int((e != fused).sum()), elements=e.size)


def copy_ab(n: int) -> dict:
    """GB/s of the pseudo-gradient's device-to-host copy of ``n`` f32, a
    ``_WIDEN_PIECE`` at a time as the sync copies it, into a pageable numpy
    buffer and into a pinned one, in turns (:data:`COPY_AB_ORDER`), both
    touched once first."""
    import numpy as np

    from torchft_tpu_torch.local_sgd import _WIDEN_PIECE

    src = torch.randn(n, device="cuda")
    hosts = {"pageable": torch.from_numpy(np.zeros(n, np.float32)),
             "pinned": torch.zeros(n, dtype=torch.float32, pin_memory=True)}
    out: dict = {k: [] for k in hosts}
    for kind in ("pageable", "pinned") + COPY_AB_ORDER:
        dst = hosts[kind]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, n, _WIDEN_PIECE):
            dst[lo : lo + _WIDEN_PIECE].copy_(src[lo : lo + _WIDEN_PIECE])
        out[kind].append(n * 4 / (time.perf_counter() - t0) / 1e9)
    if not torch.equal(hosts["pinned"], hosts["pageable"]):
        raise AssertionError("copy_ab: the two host copies differ")
    del src, hosts
    torch.cuda.empty_cache()
    # the first of each is the warm-up
    return {f"{k}_gb_per_s": v[1:] for k, v in out.items()}


def outer_phase(outer, train_ddp, iters: int) -> dict:
    """Per case of :data:`OUTER_CASES`: the outer kernel held bit for bit
    against its plain version on the card (in place where the case says:
    the new trace written over the trace), and against the host's numpy
    (``OuterSGD.update`` after the chunk sum) on a slice, NaN bits aside;
    the main path's chunk timed with kernel / plain / library ms and the
    bound: bytes (the contributions and the trace read once, the trace and
    the delta written once) against its f32 operations.  Then the numpy
    checks and the copy A/B.  The launches made here are comparisons and
    are reset before the train phases."""
    import numpy as np

    from torchft_tpu_torch.optim import OuterSGD

    shapes = outer_shapes(diloco_fragments(train_ddp, DILOCO_LAYERS["diloco_cpp"])[0])
    out = {"shapes": shapes}
    for seed, case in enumerate(OUTER_CASES):
        n = shapes[case["n"]] if isinstance(case["n"], str) else case["n"]
        w, lr, m, nesterov = case["w"], case["lr"], case["momentum"], case["nesterov"]
        scale = 1.0 / w
        c, t = _outer_inputs(case, n, seed)
        results = {}
        for name, fn in (("kernel", outer.outer_update), ("plain", outer.outer_update_plain)):
            delta = torch.empty(n, device="cuda")
            trace = t.clone()
            new_trace = trace if case["in_place"] else torch.empty(n, device="cuda")
            fn(c, scale, delta, lr, m, nesterov, trace if m else None, new_trace if m else None)
            results[name] = (delta, new_trace if m else None)
            del trace
        torch.cuda.synchronize()
        err = _exact(f"outer {case['name']} delta", results["kernel"][0], results["plain"][0])
        if m:
            err = max(err, _exact(f"outer {case['name']} trace", results["kernel"][1],
                                  results["plain"][1]))
        # the host's arithmetic on the front of the case (specials included)
        k = min(n, 1 << 16)
        cs, ts = c[:, :k].cpu().numpy(), t[:k].cpu().numpy()
        with np.errstate(all="ignore"):
            acc = np.sum(np.stack(list(cs)), axis=0) if w > 1 else cs[0].copy()
            acc *= scale
            want, _state = OuterSGD(lr, m, nesterov).update(acc, [ts] if m else [])
        got = results["kernel"][0][:k].cpu().numpy()
        keep = ~np.isnan(want)
        if not (np.isnan(got[~keep]).all() and
                (got[keep].view(np.uint32) == want[keep].view(np.uint32)).all()):
            raise AssertionError(f"outer {case['name']}: the kernel differs from the host's numpy")
        row = dict(max_abs_err=err, n=n, w=w, momentum=m, nesterov=nesterov,
                   in_place=case["in_place"], host_slice=k)
        if case["n"] == "chunk":
            delta, trace = torch.empty(n, device="cuda"), t.clone()
            new_trace = torch.empty(n, device="cuda")
            row["ms"] = _time_ms(lambda: outer.outer_update(c, scale, delta, lr, m, nesterov,
                                                            trace, new_trace), iters)
            row["plain_ms"] = _time_ms(lambda: outer.outer_update_plain(
                c, scale, delta, lr, m, nesterov, trace, new_trace), 2, 1)
            row["library_ms"] = _time_ms(lambda: _outer_library(c, scale, trace, lr, m), iters)
            row["library"] = "eager torch: sum, mul_, mul, add_, add(alpha=), mul_"
            nbytes = (w + 3) * 4 * n
            ops = (w + 6) * n
            t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_FLOPS
            row.update(bound_ms=max(t_bytes, t_ops) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       pct_of_bound=100 * max(t_bytes, t_ops) * 1e3 / row["ms"])
        elif case["n"] == "shard":
            delta, trace = results["kernel"][0], results["kernel"][1]
            row["shard_ms"] = _time_ms(lambda: outer.outer_update(c, scale, delta, lr, m, nesterov,
                                                                  trace, trace), 3, 1)
            row["shard_bound_ms"] = (w + 3) * 4 * n / PEAK_BYTES * 1e3
        out[case["name"]] = row
        print(f"outer case {case['name']}: {json.dumps(row)}", flush=True)
        del c, t, results
        torch.cuda.empty_cache()
    out["numpy"] = outer_numpy_checks()
    print(f"outer numpy on this host: {json.dumps(out['numpy'])}", flush=True)
    out["copy_ab"] = copy_ab(shapes["fragment"])
    print(f"outer copy A/B (GB/s): {json.dumps(out['copy_ab'])}", flush=True)
    return out


class _SoloClient:
    """A one-replica quorum for :func:`outer_sync_check`'s Managers: every
    quorum is rank 0 of 1, every vote is the replica's own."""

    def __init__(self) -> None:
        from torchft_tpu_torch.wire import ManagerQuorumResult

        self._result = ManagerQuorumResult(
            quorum_id=1, replica_rank=0, replica_world_size=1, store_address="127.0.0.1:0",
            max_step=0, max_replica_rank=0, max_world_size=1, replica_ids=["rep_0"])

    def _quorum(self, **kwargs):
        return self._result

    def should_commit(self, group_rank, step, should_commit, timeout) -> bool:
        return should_commit

    def _checkpoint_metadata(self, rank, timeout) -> str:
        return "solo"

    def close(self) -> None:
        pass


def _solo_manager():
    from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
    from torchft_tpu_torch.communicator import DummyCommunicator
    from torchft_tpu_torch.manager import Manager

    class _NoHeal(CheckpointTransport):
        def metadata(self) -> str:
            return "solo://"

        def send_checkpoint(self, dst_ranks, step, state_dict, timeout) -> None:
            pass

        def recv_checkpoint(self, src_rank, metadata, step, timeout):
            raise AssertionError("a one-replica quorum never heals")

    return Manager(comm=DummyCommunicator(), load_state_dict=None, state_dict=None,
                   min_replica_size=1, use_async_quorum=False, checkpoint_transport=_NoHeal(),
                   _manager_client=_SoloClient(), rank=0, world_size=1)


# two syncs: the second steps the trace the first staged and committed on
# the card, which the sync's own stream writes
OUTER_SYNC_STEPS = 2
# the check's fragment: fragment 0 of the 1-layer DiLoCo phases less its
# embedding (525,336,576 of its 684,732,416 elements), whose host reference
# took most of the check's 33-44 s; outer_phase holds the kernel at a whole
# shard of the full fragment.  Each sync still runs this many pipeline
# chunks at least (one outer launch each)
OUTER_SYNC_SKIP = ("embed",)
OUTER_SYNC_MIN_CHUNKS = 2


def outer_sync_fragment(train_ddp) -> list:
    """(name, shape, dtype) of each leaf :func:`outer_sync_check` syncs."""
    return [leaf for leaf in diloco_fragments(train_ddp, DILOCO_LAYERS["diloco_cpp"])[0]
            if leaf[0] not in OUTER_SYNC_SKIP]


def outer_sync_check(train_ddp, outer) -> dict:
    """Fragment 0 of the 1-layer DiLoCo phases less its embedding
    (:func:`outer_sync_fragment`: its other parameters at their shapes and
    dtypes, random from a seed) through :data:`OUTER_SYNC_STEPS` whole
    sharded syncs on a one-replica quorum — the pseudo-gradient, the outer
    update and the apply — on the card (the card path: the backup, the
    shard's trace and the delta in device memory, the outer kernel) and on
    the host (the same module on the CPU: host numpy), each inner step the
    same on both: the backups, the live parameters and the traces must be
    equal bit for bit.  Raises if not, or if a card sync ran fewer than
    :data:`OUTER_SYNC_MIN_CHUNKS` pipeline chunks (outer launches)."""
    from torch import nn

    from torchft_tpu_torch.local_sgd import DiLoCo, _host_leaves
    from torchft_tpu_torch.optim import OuterSGD
    from torchft_tpu_torch.train_diloco import OUTER_LR, OUTER_MOMENTUM

    fragment = outer_sync_fragment(train_ddp)
    gen = torch.Generator(device="cuda").manual_seed(11)
    card, host = nn.Module(), nn.Module()
    for i, (_name, shape, dtype) in enumerate(fragment):
        value = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dtype)
        card.register_parameter(f"p{i}", nn.Parameter(value))
        host.register_parameter(f"p{i}", nn.Parameter(value.cpu()))
    wrappers = [DiLoCo(_solo_manager(), m, OuterSGD(OUTER_LR, OUTER_MOMENTUM, nesterov=True),
                       sync_every=1) for m in (card, host)]
    outer.reset_launches()
    seconds = {"card": 0.0, "host": 0.0}
    chunks = []  # outer launches of each card sync: one a pipeline chunk
    for step in range(OUTER_SYNC_STEPS):
        with torch.no_grad():
            for p, q in zip(card.parameters(), host.parameters()):
                p.sub_((torch.randn(p.shape, generator=gen, device="cuda") * 1e-3).to(p.dtype))
                q.copy_(p)
        for key, wrapper in zip(("card", "host"), wrappers):
            before = outer.launches["outer"]
            t0 = time.perf_counter()
            if wrapper.step() is not True:
                raise AssertionError(f"outer sync check: the {key} sync {step} did not commit")
            torch.cuda.synchronize()
            seconds[key] += time.perf_counter() - t0
            if key == "card":
                chunks.append(outer.launches["outer"] - before)
    launches = outer.launches["outer"]
    if min(chunks) < OUTER_SYNC_MIN_CHUNKS:
        raise AssertionError(f"outer sync check: the card syncs ran {chunks} pipeline chunks, "
                             f"fewer than {OUTER_SYNC_MIN_CHUNKS}")
    cf, hf = wrappers[0].fragments[0], wrappers[1].fragments[0]
    pairs = [("backup", a, b) for a, b in zip(cf.backup, hf.backup)]
    pairs += [("live", a.detach(), b.detach()) for a, b in zip(card.parameters(), host.parameters())]
    pairs += [("trace", torch.from_numpy(a), torch.from_numpy(b)) for a, b in
              zip(_host_leaves(cf._shard._state_leaves), _host_leaves(hf._shard._state_leaves))]
    for what, a, b in pairs:
        if not torch.equal(a.cpu().contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)):
            raise AssertionError(f"outer sync check: the card's {what} differs from the host's")
    elements = sum(p.numel() for p in card.parameters())
    for wrapper in wrappers:
        wrapper._manager.shutdown()
    del wrappers, card, host, cf, hf, pairs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(elements=elements, syncs=OUTER_SYNC_STEPS, launches=launches,
                chunks_per_sync=chunks, card_s=seconds["card"], host_s=seconds["host"])


def commit_split(spans, windows, replicas: int, names=SPLIT_SPANS) -> list:
    """Per iteration window ``(start, end)``: the seconds in each span of
    ``names`` that started inside it, summed over the fleet and divided by
    ``replicas`` (the per-replica mean: the spans carry no replica, and the
    replicas step in lockstep)."""
    out = []
    for start, end in windows:
        row = dict.fromkeys(names, 0.0)
        for rec in spans:
            if rec["name"] in row and start <= rec["t"] < end:
                row[rec["name"]] += rec["dur"] / replicas
        out.append(row)
    return out


def unspanned_s(phase: dict, row: dict, quantized: bool) -> float:
    """Seconds of one iteration outside ``compute`` that no span covers:
    the ``allreduce`` and ``commit`` phases less the train thread's spans
    (:data:`TRAIN_THREAD_SPANS`, the fence, the vote), plus the part of the
    fence that the pipeline it waits for (:data:`FENCED_SPANS`) does not
    cover.  ``phase`` is the iteration's phases, ``row`` its spans (both per
    replica)."""
    outside = phase["allreduce"] + phase["commit"]
    thread = (sum(row[name] for name in TRAIN_THREAD_SPANS) + row["manager::fence"]
              + row["manager::should_commit"])
    fenced = sum(row[name] for name in FENCED_SPANS[quantized])
    return outside - thread + max(0.0, row["manager::fence"] - fenced)


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


def _timed_build(native, out: dict) -> None:
    """``native.build()``, its seconds into ``out["build_s"]``; a failure
    is left for :func:`native_phase`'s own build call to raise."""
    t0 = time.perf_counter()
    try:
        native.build()
    except Exception:  # noqa: BLE001 — native_phase raises it with g++'s output
        pass
    out["build_s"] = time.perf_counter() - t0


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


def check_heal(bytes_total: int | None, state_bytes: int, transport: str, where: str) -> None:
    """A heal moved the replica's whole state: over the communicator
    exactly its array payload bytes, over HTTP those and its stream's
    framing (the pickled skeleton and 8 bytes a leaf).  ``bytes_total`` is
    the heal's, None where none was recorded."""
    if not bytes_total or bytes_total <= 0:
        raise AssertionError(f"{where} restarted but recorded no heal")
    if transport == "comm" and bytes_total != state_bytes:
        raise AssertionError(f"{where} healed {bytes_total} bytes over comm, "
                             f"not its state's {state_bytes}")
    if transport == "http" and bytes_total <= state_bytes:
        raise AssertionError(f"{where} healed {bytes_total} bytes over HTTP, "
                             f"not its state's {state_bytes} and the framing")


def heal_split(recorded: list, replicas: int) -> dict:
    """Seconds per replica over a phase in each span of :data:`HEAL_SPANS`,
    from ``obs.spans.snapshot()``."""
    return {name: sum(rec["dur"] for rec in recorded if rec["name"] == name) / replicas
            for name in HEAL_SPANS}


def heal_split_of(totals: list) -> dict:
    """Seconds per replica in each span of :data:`HEAL_SPANS` from worker
    processes' span totals (``obs.spans.totals``), one dict a replica."""
    return {name: sum(t.get(name, 0.0) for t in totals) / len(totals) for name in HEAL_SPANS}


def split_line(split: dict | None) -> str:
    """A heal split for a printed line: the spans that recorded time."""
    return json.dumps({k: round(v, 3) for k, v in (split or {}).items() if v})


def check_heal_sources(heal, sources: int, where: str) -> None:
    """A heal took ``sources`` sources, each serving bytes, together
    exactly the heal's, with no source failed and no chunk stolen."""
    if heal is None:
        raise AssertionError(f"{where} restarted but recorded no heal")
    served = heal.per_source_bytes
    if heal.num_sources != sources or len(served) != sources:
        raise AssertionError(f"{where} healed from {heal.num_sources} sources ({served}), "
                             f"not {sources}")
    if any(n <= 0 for n in served.values()):
        raise AssertionError(f"{where}: a heal source served no bytes ({served})")
    if sum(served.values()) != heal.bytes_total:
        raise AssertionError(f"{where}: the sources served {sum(served.values())} bytes, the "
                             f"heal moved {heal.bytes_total}")
    if heal.failed_sources or heal.stolen_chunks:
        raise AssertionError(f"{where}: heal sources {heal.failed_sources} failed, "
                             f"{heal.stolen_chunks} chunks stolen")


def check_expected_hashes(hashes: dict) -> None:
    """Each final parameter sha256 against :data:`EXPECTED_SHA256`."""
    for key, sha in hashes.items():
        if sha != EXPECTED_SHA256[key]:
            raise AssertionError(f"{key}: final parameter sha256 {sha}, expected "
                                 f"{EXPECTED_SHA256[key]}")


def train_phase(train_ddp, fa, qk, avg, spans, card: str, should_quantize: bool, tier: str,
                heal_transport: str, make_comm=None, planes: dict | None = None,
                replicas: int = 2, sources: int = 1) -> dict:
    """The port's main path: ``replicas`` replica threads at Llama-3-8B
    width with a kill of replica 1 and its heal from ``sources`` sources
    over ``heal_transport``, averaging gradients in f32/bf16 or through the
    int8 quantized wire, every plane on ``tier``; the launch counts and the
    spans cover exactly this run.  ``make_comm`` replaces each
    incarnation's communicator (``run_fleet``'s), and ``planes`` the plane
    classes every replica must have run (default: ``tier``'s)."""
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
    avg.reset_launches()
    t0 = time.perf_counter()
    with HostRss() as rss:
        results = train_ddp.run_fleet(
            cfg, device, replicas=replicas, steps=steps, batch=1, seq=2048, kill_at=(1, 2),
            should_quantize=should_quantize, tier=tier, heal_transport=heal_transport,
            make_comm=make_comm,
        )
    wall_s = time.perf_counter() - t0
    launches = {**fa.launches, **qk.launches, **avg.launches}
    recorded = spans.snapshot()
    split = commit_split(recorded, results[0].step_windows, len(results), SPLIT_SPANS + HOST_SPANS)
    for i, r in enumerate(results):
        if not all(math.isfinite(x) for x in r.losses):
            raise AssertionError(f"replica {i}: non-finite loss in {r.losses}")
        if r.final_step != steps:
            raise AssertionError(f"replica {i} ended at step {r.final_step}, not {steps}")
    restarts = [r.restarts for r in results]
    if restarts != [int(i == 1) for i in range(replicas)]:
        raise AssertionError(f"restarts {restarts}: replica 1 must restart once, no other")
    for i, r in enumerate(results):
        if r.planes != (planes or PLANES[tier]):
            raise AssertionError(f"replica {i} ran {r.planes}, not {planes or PLANES[tier]}")
    heal = results[1].heal
    check_heal(None if heal is None else heal.bytes_total, results[1].state_bytes, heal_transport,
               "replica 1")
    check_heal_sources(heal, sources, "replica 1")
    shas = {r.params_sha256 for r in results}
    if len(shas) != 1:
        raise AssertionError(f"replicas diverged: parameter sha256 {shas}")
    # the card divides every bucket (avg); the int8 path also quantizes,
    # reduces each window and dequantizes the reduced stream on the card
    required = ("fwd", "dq", "dkv", "avg") + (
        ("quantize", "reduce", "dequantize") if should_quantize else ())
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
    unspanned = sorted(unspanned_s(p, row, should_quantize) for p, row in zip(last, steady_split))
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
        host_split_ms_median_last3={
            name: sorted(row[name] for row in steady_split)[len(steady_split) // 2] * 1e3
            for name in HOST_SPANS
        },
        # per steady iteration, what no span covers outside compute
        unspanned_ms_median_last3=unspanned[len(unspanned) // 2] * 1e3,
        replicas=replicas,
        heal=dict(seconds=heal.duration_s, bytes=heal.bytes_total, sources=heal.num_sources,
                  per_source_bytes=list(heal.per_source_bytes.values()),
                  gb_per_s=heal.bytes_per_sec / 1e9, transport=heal_transport,
                  state_bytes=results[1].state_bytes),
        # seconds per replica over the phase in each heal span
        heal_split_s=heal_split(recorded, len(results)),
        tokens_per_s_per_replica=2048 / step_s,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_host_rss_gb=rss.peak_bytes / 1e9,
        start_host_rss_gb=rss.start_bytes / 1e9,
        wall_s=wall_s,
        launches=launches,
    )


def host_mem_total_gb() -> float:
    """The host's ``MemTotal`` (``/proc/meminfo``), in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def release_host_memory() -> None:
    """Hand freed host memory back to the system before a phase: PyTorch's
    cache of pinned blocks and glibc's free arenas (what earlier phases
    left resident), so the phase's peak is its own."""
    import ctypes
    import ctypes.util

    gc.collect()
    empty_pinned = getattr(torch._C, "_host_emptyCache", None)  # CUDA builds only
    if empty_pinned is not None:
        empty_pinned()
    libc = ctypes.util.find_library("c")
    if libc:
        ctypes.CDLL(libc).malloc_trim(0)


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


def check_post_heal_syncs(healed, num_fragments: int) -> list:
    """The fragments the restarted replica ``healed`` synced after its heal,
    in order (the sync that commits from step s syncs fragment s mod
    ``num_fragments``; a decision that did not commit synced nothing);
    raises unless every fragment is among them."""
    synced = [step % num_fragments for step, committed in healed.sync_decisions if committed]
    if set(synced) != set(range(num_fragments)):
        raise AssertionError(f"after its heal the restarted replica synced fragments {synced}, "
                             f"not all {num_fragments}")
    return synced


def check_restarts(results, killed: bool):
    """A two-replica DiLoCo fleet: with a kill, replica 1 restarted once and
    its heal carried fragment state; without one, no replica restarted or
    healed.  Returns replica 1's heal; raises on the first check that
    fails."""
    restarts = [r.restarts for r in results]
    if restarts != [0, int(killed)]:
        raise AssertionError(f"restarts {restarts}, expected {[0, int(killed)]}")
    heal = results[1].heal
    if not killed and any(r.heal is not None for r in results):
        raise AssertionError("a replica healed in a fleet without a kill")
    if killed and (heal is None or heal.bytes_total <= 0 or min(results[1].fragment_heals) < 1):
        raise AssertionError(f"replica 1's heal carried no fragment state: heal {heal}, "
                             f"fragment heals {results[1].fragment_heals}")
    return heal


def check_backups(results, num_fragments: int) -> None:
    """Each fragment's backup is equal across replicas; it moved from the
    initial weights if replica 0 committed a sync of that fragment (the
    sync that commits from step s syncs fragment s mod ``num_fragments``),
    and is still the initial weights if not.  Raises on the first that
    fails."""
    synced = {step % num_fragments for step, committed in results[0].sync_decisions if committed}
    for f in range(num_fragments):
        backups = {r.fragment_sha256[f] for r in results}
        if len(backups) != 1:
            raise AssertionError(f"fragment {f}: backups differ across replicas {backups}")
        initial = backups == {results[0].initial_fragment_sha256[f]}
        if initial and f in synced:
            raise AssertionError(f"fragment {f}: the backup is still the initial weights")
        if not initial and f not in synced:
            raise AssertionError(f"fragment {f}: never synced, yet its backup moved")


def check_stream(results, fleet: dict) -> dict:
    """diloco_stream_cpp: raises unless every incarnation of every replica
    streamed its outer sync; every commit decision of each replica's last
    incarnation came at a stream barrier (as many barriers as decisions)
    and the ones that committed took it from its first decision's step to
    its final one; the victim (``kill_at[0]``) was killed once, and no other
    replica, with a fragment's sync submitted and not resolved; and that
    sync committed nowhere: the victim died before its barrier, and each
    survivor's first decision at the kill's step did not commit.  Returns
    the kill and each replica's decisions and barriers."""
    victim = fleet["kill_at"][0]
    for i, r in enumerate(results):
        if not r.streaming or not all(r.streaming):
            raise AssertionError(f"replica {i} streamed {r.streaming}, not on every incarnation")
        if not r.sync_decisions or sum(r.stream_barriers) != len(r.sync_decisions):
            raise AssertionError(f"replica {i}: {len(r.sync_decisions)} commit decisions, "
                                 f"{r.stream_barriers} stream barriers")
        commits = sum(committed for _, committed in r.sync_decisions)
        if commits != r.final_step - r.sync_decisions[0][0]:
            raise AssertionError(f"replica {i}: decisions {r.sync_decisions} do not account for "
                                 f"its final step {r.final_step}")
        if (i == victim) != bool(r.kills):
            raise AssertionError(f"replica {i} was killed {r.kills}")
    kills = results[victim].kills
    if len(kills) != 1 or not kills[0]["in_flight"]:
        raise AssertionError(f"replica {victim}'s kills {kills}: not one with a sync in flight")
    kill = kills[0]
    for i, r in enumerate(results):
        at_kill = [committed for step, committed in r.sync_decisions if step == kill["step"]]
        if i != victim and (not at_kill or at_kill[0]):
            raise AssertionError(f"replica {i}'s decisions at step {kill['step']}, {at_kill}: the "
                                 "sync in flight at the kill committed")
    return dict(kill=kill, sync_decisions=[r.sync_decisions for r in results],
                stream_barriers=[r.stream_barriers for r in results])


def diloco_phase(train_diloco, train_ddp, fa, qk, card: str, fleet: dict,
                 layers: int = LAYERS, ckpt_dir: str | None = None,
                 env: dict | None = None, spans=None) -> dict:
    """DiLoCo or LocalSGD at Llama-3-8B width and ``layers`` deep with 2
    replicas, every plane on the C++ tier, under the knobs ``env``; raises
    on any failed check.  The launch counts cover exactly this run.  With
    ``ckpt_dir`` (LocalSGD) the fleet restores from and saves durable
    checkpoints there, and the result carries each replica's restore,
    saves, first commit and whether it healed.  Under
    :data:`STREAM_ENV` the fleet is held to :func:`check_stream` too.  With
    ``spans`` (``obs.spans``, on) the result carries the seconds per
    replica per committed sync in each of :data:`DILOCO_SPANS`."""
    import resource

    cfg = train_ddp.model_config("llama3_8b", layers)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from torchft_tpu_torch.ops import avg, outer

    fa.reset_launches()
    qk.reset_launches()
    avg.reset_launches()
    outer.reset_launches()
    if spans is not None:
        spans.clear()
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, env or {}), HostRss() as rss:
        results = train_diloco.run_diloco_fleet(
            cfg, torch.device("cuda"), replicas=2, batch=1, seq=2048, ckpt_dir=ckpt_dir,
            tier="cpp", **fleet)
    wall_s = time.perf_counter() - t0
    launches = {**fa.launches, **qk.launches, **outer.launches, **avg.launches}
    diloco = fleet["algo"] == "diloco"
    for i, r in enumerate(results):
        if not r.losses or not all(math.isfinite(x) for x in r.losses):
            raise AssertionError(f"replica {i}: non-finite loss in {r.losses}")
        if r.final_step != fleet["outer_steps"]:
            raise AssertionError(f"replica {i} ended at step {r.final_step}, "
                                 f"not {fleet['outer_steps']}")
        if r.planes != PLANES["cpp"]:
            raise AssertionError(f"replica {i} ran {r.planes}, not the cpp tier")
    heal = post_heal = stream = None
    killed = fleet.get("kill_at") is not None
    if diloco:
        heal = check_restarts(results, killed)
        check_backups(results, fleet["num_fragments"])
        if killed:
            post_heal = check_post_heal_syncs(results[1], fleet["num_fragments"])
        if env == STREAM_ENV:
            stream = check_stream(results, fleet)
        last = (results[0].final_step - 1) % fleet["num_fragments"]
        live = {r.fragment_live_sha256[last] for r in results}
        if len(live) != 1:
            raise AssertionError(f"fragment {last}, synced last: live parameters differ {live}")
    elif len({r.params_sha256 for r in results}) != 1:
        raise AssertionError(f"LocalSGD replicas diverged: {[r.params_sha256 for r in results]}")
    for name in ("fwd", "dq", "dkv") + (("outer",) if diloco else ()):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the {fleet['algo']} phase")
    # the int8 outer sync quantizes and dequantizes on the card
    for name in ("quantize", "dequantize") if fleet.get("should_quantize") else ():
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the int8 outer sync")
    r0 = results[0]
    sync_split = healed_split = None
    if spans is not None:
        recorded = spans.snapshot()
        sync_split = {name: sum(rec["dur"] for rec in recorded if rec["name"] == name)
                      / len(results) / r0.final_step for name in DILOCO_SPANS}
        healed_split = heal_split(recorded, len(results))
    shard = [t for t in r0.outer_shard if "outer_shard_wall_s" in t]
    split = {k: _median(t[f"outer_shard_{k}_s"] for t in shard)
             for k in ("wall", "scatter", "update", "gather")} if shard else None
    durable = {} if ckpt_dir is None else dict(
        restored=[r.restored for r in results],
        saves=[r.saves for r in results],
        first_commit_ts=[r.first_commit_ts for r in results],
        healed=[r.heal is not None for r in results],
    )
    return dict(
        card=card,
        tier="cpp",
        fleet=fleet,
        env=env or {},
        model="llama3_8b width, %d layers, bf16" % layers,
        final_step=r0.final_step,
        inner_steps=[r.inner_steps for r in results],
        losses=[r.losses for r in results],
        fragment_sha256=r0.fragment_sha256,
        params_sha256=[r.params_sha256 for r in results],
        restarts=[r.restarts for r in results],
        fragment_heals=[r.fragment_heals for r in results],
        post_heal_sync_fragments=post_heal,
        stream=stream,
        inner_step_s_replica0=r0.inner_step_s,
        inner_step_ms_median=_median(r0.inner_step_s) * 1e3,
        wrapper_step_s_replica0=r0.wrapper_step_s,
        # host seconds the train loop spent in wrapper.step() per committed sync
        sync_s_per_commit=sum(r0.wrapper_step_s) / r0.final_step,
        outer_shard_replica0=r0.outer_shard,
        outer_shard_s_median=split,
        # seconds per replica per committed sync in each span
        sync_split_s=sync_split,
        # seconds per replica over the phase in each heal span
        heal_split_s=healed_split,
        heal=None if heal is None else dict(
            seconds=heal.duration_s, bytes=heal.bytes_total, sources=heal.num_sources,
            gb_per_s=heal.bytes_per_sec / 1e9),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_host_rss_gb=rss.peak_bytes / 1e9,
        start_host_rss_gb=rss.start_bytes / 1e9,
        ru_maxrss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
        tokens_per_s_per_replica=r0.inner_steps * 2048 / wall_s,
        wall_s=wall_s,
        launches=launches,
        **durable,
    )


def check_job_loss(first: dict, restored: dict, ckpt_steps: list) -> dict:
    """The job-loss ``localsgd_cpp``: ``first`` ran to its last committed
    sync and saved; ``restored`` (a second fleet) restored and ran one
    committed sync more (``diloco_phase``'s results, which hold the steps,
    finite losses, equal final hashes and flash launches).  Raises unless
    exactly one replica of the first fleet saved, once, at its last step;
    both restored replicas loaded that step, their Manager at it, with model
    and optimizer state bit-equal to what was saved (their digests); no restored
    replica healed; the restored fleet saved its own last step; and the
    directory holds those two steps.  Returns the first fleet's save."""
    saves = [sv for per in first["saves"] for sv in per]
    if len(saves) != 1 or saves[0]["step"] != first["final_step"]:
        raise AssertionError(f"the first fleet saved {[sv['step'] for sv in saves]}, "
                             f"not step {first['final_step']} once")
    saved = saves[0]
    if any(r is not None for r in first["restored"]):
        raise AssertionError(f"the first fleet restored {first['restored']} from an empty dir")
    for i, r in enumerate(restored["restored"]):
        if r is None or r["step"] != saved["step"] or r["manager_step"] != saved["step"]:
            raise AssertionError(f"replica {i} restored {r}, not step {saved['step']}")
        if r["digest"] != saved["digest"]:
            raise AssertionError(f"replica {i}: state digest at restore {r['digest']} differs "
                                 f"from the saved {saved['digest']}")
    if any(restored["healed"]):
        raise AssertionError(f"a restored replica healed ({restored['healed']}): the restore "
                             "did not put both at the saved step")
    last = [sv["step"] for per in restored["saves"] for sv in per]
    if last != [restored["final_step"]]:
        raise AssertionError(f"the restored fleet saved steps {last}, not "
                             f"[{restored['final_step']}]")
    if sorted(ckpt_steps) != [saved["step"], restored["final_step"]]:
        raise AssertionError(f"the checkpoint dir holds steps {ckpt_steps}, not "
                             f"{[saved['step'], restored['final_step']]}")
    return saved


def jobloss_phase(train_diloco, train_ddp, fa, qk, card: str, fleet: dict, layers: int) -> dict:
    """``localsgd_cpp`` as a job loss: the fleet runs to its last committed
    sync and the participating rank 0 writes a durable checkpoint; the
    fleet and its lighthouse are torn down (every replica, Manager, sidecar
    and communicator); a second fleet with a fresh lighthouse restores it
    and runs one committed sync more.  The checkpoint lives on the
    checkout's disk (``build/``, never ``/dev/shm``: it must be durable) in
    a directory removed at the end; a filesystem without room for two steps
    fails by name before the first fleet.  Raises on any failed check
    (``diloco_phase``'s on each fleet, then :func:`check_job_loss`)."""
    from torchft_tpu_torch.models.llama import Llama
    from torchft_tpu_torch.utils.checkpoint import InsufficientSpaceError, _all_steps

    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="jobloss_ckpt_", dir=base)
    try:
        params = Llama(train_ddp.model_config("llama3_8b", layers), device="meta").num_params()
        need = 2 * JOBLOSS_BYTES_PER_PARAM * params
        free = shutil.disk_usage(ckpt_dir).free
        if free < need:
            raise InsufficientSpaceError(
                f"job-loss phase: two checkpoints of {params} parameters need ~{need} bytes, "
                f"{ckpt_dir} has {free} free")
        first = diloco_phase(train_diloco, train_ddp, fa, qk, card, fleet, layers, ckpt_dir)
        kill_ts = time.monotonic()  # the first fleet is gone: the job is lost
        release_host_memory()
        again = dict(fleet, outer_steps=fleet["outer_steps"] + 1)
        restored = diloco_phase(train_diloco, train_ddp, fa, qk, card, again, layers, ckpt_dir)
        ckpt_steps = _all_steps(ckpt_dir)
        saved = check_job_loss(first, restored, ckpt_steps)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    loads = restored["restored"]
    kill_to_first_commit = min(restored["first_commit_ts"]) - kill_ts
    return dict(
        first_fleet=first,
        restored_fleet=restored,
        params=params,
        free_disk_bytes=free,
        ckpt_steps=sorted(ckpt_steps),
        ckpt_bytes=saved["bytes"],
        bytes_per_param=saved["bytes"] / params,
        save=dict(step=saved["step"], seconds=saved["save_s"], host_copy_s=saved["host_copy_s"],
                  write_s=saved["write_s"], fsync_s=saved["fsync_s"],
                  digest=saved["digest"]),
        restored_save=[sv for per in restored["saves"] for sv in per][0],
        load_s=[r["read_s"] for r in loads],
        apply_s=[r["apply_s"] for r in loads],
        restore_digest_s=[r["digest_s"] for r in loads],
        kill_to_first_commit_s=kill_to_first_commit,
        # less the slower replica's restore digest, which is the check's
        # own work (the two replicas hash in parallel, before training)
        kill_to_first_commit_less_check_s=kill_to_first_commit - max(
            r["digest_s"] for r in loads),
        max_memory_allocated_gb=max(first["max_memory_allocated_gb"],
                                    restored["max_memory_allocated_gb"]),
        peak_host_rss_gb=max(first["peak_host_rss_gb"], restored["peak_host_rss_gb"]),
        launches=restored["launches"],
        wall_s=first["wall_s"] + restored["wall_s"],
    )


def jobloss_line(key: str, t: dict) -> str:
    """The job-loss phase's summary line."""
    sv = t["save"]
    return (f"{key} (cpp tier, job loss): checkpoint of step {sv['step']}, "
            f"{t['ckpt_bytes']} bytes ({t['bytes_per_param']:.3f} a parameter), saved in "
            f"{sv['seconds']:.3f} s with the check's digest hashed alongside (host copy "
            f"{sv['host_copy_s']:.3f}, write {sv['write_s']:.3f}, overlapping; fsync "
            f"{sv['fsync_s']:.3f}); loaded in {json.dumps(t['load_s'])} s, copied to the card "
            f"in {json.dumps(t['apply_s'])} s, hashed for the check in "
            f"{json.dumps(t['restore_digest_s'])} s; kill to the restored fleet's first "
            f"committed sync {t['kill_to_first_commit_s']:.3f} s, "
            f"{t['kill_to_first_commit_less_check_s']:.3f} s less the check's restore digest; "
            f"restored digests equal the saved "
            f"{sv['digest'][:16]}, no heal, steps {t['ckpt_steps']} on disk; flash launches in "
            f"the restored fleet {json.dumps(t['launches'])}; peak device "
            f"{t['max_memory_allocated_gb']:.1f} GB, peak host RSS {t['peak_host_rss_gb']:.1f} GB; "
            f"wall {t['wall_s']:.1f} s")


def check_spare(results, fleet: dict, launches: dict, min_deltas: int = 0) -> dict:
    """A fleet with one hot spare (``run_diloco_fleet(spares=1)``): raises
    unless replica ``kill_at[0]`` died and stayed dead, the lighthouse
    promoted the spare once, in one membership edit, with no heal anywhere
    (the spare stood at the commit front); the spare loaded a complete warm
    snapshot (fresh fraction 1.0) and applied at least ``min_deltas``
    committed deltas; every fragment's backup is equal on replica 0 and the
    spare (and moved off the initial weights), and so are the live
    parameters of the fragment synced last; the promoted spare ends at
    ``outer_steps`` with finite losses; and each flash kernel launched after
    the promotion (``launches`` at the end less the spare's count at its
    promotion).  Returns those launches."""
    victim = fleet["kill_at"][0]
    actives, spare = results[:-1], results[-1]
    info = spare.spare or {}
    if [r.restarts for r in results] != [0] * len(results):
        raise AssertionError(f"a replica restarted (restarts {[r.restarts for r in results]}): "
                             "a cold heal in place of the promotion")
    if [r.killed for r in actives] != [i == victim for i in range(len(actives))]:
        raise AssertionError(f"killed {[r.killed for r in actives]}: replica {victim} must die")
    if not info.get("promoted") or info.get("promotions_total") != 1:
        raise AssertionError(f"the spare was not promoted exactly once: {info}")
    healed = [i for i, r in enumerate(results) if r.heal is not None]
    if healed or info.get("promote_warm_lag_steps") != 0:
        raise AssertionError(f"replicas {healed} healed (spare lag "
                             f"{info.get('promote_warm_lag_steps')}): the promotion was not warm")
    ids = results[0].quorum_ids
    edits = sum(a != b for a, b in zip(ids, ids[1:]))
    if edits != 1:
        raise AssertionError(f"replica 0 saw {edits} membership edits (quorum ids {ids}), not one")
    if info.get("warm_fresh_fraction_max") != 1.0:
        raise AssertionError(f"the spare's chunk store never reached a fresh fraction of 1.0: {info}")
    if info.get("warm_deltas_applied", 0.0) < min_deltas:
        raise AssertionError(f"the spare applied {info.get('warm_deltas_applied', 0.0)} committed "
                             f"deltas, fewer than {min_deltas}")
    for f in range(fleet["num_fragments"]):
        if results[0].fragment_sha256[f] != spare.fragment_sha256[f]:
            raise AssertionError(f"fragment {f}: backups differ on replica 0 and the spare")
        if results[0].fragment_sha256[f] == results[0].initial_fragment_sha256[f]:
            raise AssertionError(f"fragment {f}: the backup is still the initial weights")
    last = (results[0].final_step - 1) % fleet["num_fragments"]
    if results[0].fragment_live_sha256[last] != spare.fragment_live_sha256[last]:
        raise AssertionError(f"fragment {last}, synced last: live parameters differ")
    for r in (results[0], spare):
        if r.final_step != fleet["outer_steps"]:
            raise AssertionError(f"a survivor ended at step {r.final_step}, not {fleet['outer_steps']}")
        if not r.losses or not all(math.isfinite(x) for x in r.losses):
            raise AssertionError(f"non-finite loss in {r.losses}")
    after = {k: launches[k] - info.get("launches_at_promotion", {}).get(k, 0)
             for k in ("fwd", "dq", "dkv")}
    if min(after.values()) <= 0:
        raise AssertionError(f"flash kernels after the promotion: {after}")
    return after


def check_spare_drills(promote: dict, kill: dict) -> None:
    """The JAX tests' assertions on the two spare drills."""
    if promote["promotions_total"] < 1 or promote["quorum_reconfigs"] != 1:
        raise AssertionError(f"spare_promote: {promote}")
    if not promote["promotion_latency_s"] > 0:
        raise AssertionError(f"spare_promote latency: {promote}")
    if kill["quorum_reconfigs"] != 0 or kill["promotions_total"] != 0:
        raise AssertionError(f"kill_spare: {kill}")


def _spare_summary(results) -> dict:
    spare = results[-1]
    info = dict(spare.spare)
    return dict(
        spare=info,
        promote_s=info.get("promotion_adopt_s"),
        promote_warm_lag_steps=info.get("promote_warm_lag_steps"),
        kill_to_adopt_s=info.get("kill_to_adopt_s"),
        kill_to_first_commit_s=info.get("kill_to_first_commit_s"),
        warm_bytes_fetched=info.get("warm_bytes_fetched"),
        warm_chunks_fetched=info.get("warm_chunks_fetched"),
        warm_deltas_applied=info.get("warm_deltas_applied", 0.0),
        fragment_sha256=results[0].fragment_sha256,
        quorum_ids=[r.quorum_ids for r in results],
        losses=[r.losses for r in results],
        inner_steps=[r.inner_steps for r in results],
        planes=[r.planes for r in results],
    )


def spare_phase(train_diloco, train_ddp, fa, qk, card: str, cold_heal: dict) -> dict:
    """spare_python: DILOCO's schedule at Llama-3-8B width with 2 actives
    and 1 hot spare on the Python tier; raises on any failed check.  The
    launch counts cover exactly this run; ``cold_heal`` is this run's
    ``diloco_cpp`` heal, printed beside the promotion for comparison only
    (another tier)."""
    import resource

    layers = DILOCO_LAYERS.get("spare_python", LAYERS)
    cfg = train_ddp.model_config("llama3_8b", layers)
    before_release = HostRss.now()
    release_host_memory()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from torchft_tpu_torch.ops import avg, outer

    fa.reset_launches()
    qk.reset_launches()
    avg.reset_launches()
    outer.reset_launches()
    fleet = dict(SPARE_PHASE)
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, SPARE_ENV), HostRss() as rss:
        results = train_diloco.run_diloco_fleet(
            cfg, torch.device("cuda"), replicas=2, batch=1, seq=2048, tier="python", **fleet)
    wall_s = time.perf_counter() - t0
    launches = {**fa.launches, **qk.launches, **outer.launches, **avg.launches}
    after = check_spare(results, fleet, launches)
    if launches["outer"] <= 0:
        raise AssertionError("the outer kernel never launched in the spare's fleet")
    for r in results:
        if r.planes != PLANES["python"]:
            raise AssertionError(f"a replica ran {r.planes}, not the python tier")
    return dict(
        card=card, tier="python", fleet=fleet, env=SPARE_ENV,
        model="llama3_8b width, %d layers, bf16" % layers,
        **_spare_summary(results),
        launches=launches,
        launches_after_promotion=after,
        diloco_cpp_cold_heal=cold_heal,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        peak_host_rss_gb=rss.peak_bytes / 1e9,
        start_host_rss_gb=rss.start_bytes / 1e9,
        host_rss_before_release_gb=before_release / 1e9,
        ru_maxrss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
        wall_s=wall_s,
    )


def spare_drills_phase(drill, train_diloco, fa, card: str) -> dict:
    """spare_drills: ``gray_failure_drill``'s spare modes with the replicas'
    state on the card, then the outer-delta feed into a spare's fragments on
    the card (SPARE_DELTA_FLEET); raises on any failed check."""
    from torchft_tpu_torch.models.llama import LlamaConfig

    t0 = time.perf_counter()
    promote = drill.gray_failure_drill(mode="spare_promote", num_replicas=2, steps=8, device="cuda")
    kill = drill.gray_failure_drill(mode="kill_spare", num_replicas=2, steps=8, device="cuda")
    check_spare_drills(promote, kill)
    drills_s = time.perf_counter() - t0
    fa.reset_launches()
    fleet = dict(SPARE_DELTA_FLEET)
    t0 = time.perf_counter()
    with mock.patch.dict(os.environ, SPARE_DELTA_ENV):
        results = train_diloco.run_diloco_fleet(
            LlamaConfig(**SPARE_DELTA_CFG), torch.device("cuda"), tier="python", **fleet)
    fleet_s = time.perf_counter() - t0
    after = check_spare(results, fleet, dict(fa.launches), min_deltas=1)
    return dict(
        card=card, spare_promote=promote, kill_spare=kill, drills_s=drills_s,
        delta_fleet=dict(cfg=SPARE_DELTA_CFG, fleet=fleet, env=SPARE_DELTA_ENV,
                         **_spare_summary(results), launches_after_promotion=after,
                         wall_s=fleet_s),
    )


def check_cnn(results, steps: int) -> None:
    """cnn_cpp's checks; raises on the first that fails."""
    for i, r in enumerate(results):
        if not r.losses or not all(math.isfinite(x) for x in r.losses):
            raise AssertionError(f"cnn replica {i}: non-finite loss in {r.losses}")
        if r.final_step != steps:
            raise AssertionError(f"cnn replica {i} ended at step {r.final_step}, not {steps}")
    first, last = results[0].losses[:3], results[0].losses[-3:]
    if not sum(last) / len(last) < sum(first) / len(first):
        raise AssertionError(f"cnn: the loss did not fall: {results[0].losses}")
    if [r.restarts for r in results] != [0, 1]:
        raise AssertionError(f"cnn restarts {[r.restarts for r in results]}, expected [0, 1]")
    if results[1].heal is None or results[1].heal.bytes_total <= 0:
        raise AssertionError("cnn replica 1 restarted but recorded no heal")
    if len({r.params_sha256 for r in results}) != 1:
        raise AssertionError(f"cnn replicas diverged: {[r.params_sha256 for r in results]}")


def cnn_phase(train_ddp, card: str) -> dict:
    """train_ddp --model cnn: 2 replica threads on the C++ tier with a kill
    and heal; raises on any failed check."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fleet = dict(CNN_PHASE)
    results = train_ddp.run_fleet(train_ddp.CNNConfig(), torch.device("cuda"), tier="cpp", **fleet)
    wall_s = time.perf_counter() - t0
    check_cnn(results, fleet["steps"])
    for i, r in enumerate(results):
        if r.planes != PLANES["cpp"]:
            raise AssertionError(f"cnn replica {i} ran {r.planes}, not the cpp tier")
    heal = results[1].heal
    return dict(
        card=card, tier="cpp", fleet=fleet, model="SimpleCNN, synthetic_cifar(2048)",
        losses=[r.losses for r in results], params_sha256=results[0].params_sha256,
        step_s_replica0=results[0].step_s,
        step_ms_median=_median(results[0].step_s[-10:]) * 1e3,
        heal=dict(seconds=heal.duration_s, bytes=heal.bytes_total, sources=heal.num_sources),
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        wall_s=wall_s,
    )


def drill_heal_steps(log: str) -> list:
    """The steps a drill worker's log shows it healing at (the fleet's
    ``max_step`` it fetched)."""
    return [int(n) for n in re.findall(
        r"healing required, fetching checkpoint metadata from \S+ max_step=(\d+)", log)]


def check_chaos_deadlock(result: dict, steps: int, victim: int) -> None:
    """chaos_deadlock: raises unless the drill injected one deadlock into
    group ``victim``; its next commit came after the freeze thawed; every
    group printed a FINAL line at ``steps`` (``run_drill`` holds their
    hashes equal); the frozen member healed from its peer at a step past 0
    (its log); and no worker process is left alive."""
    name = f"rg{victim}"
    if result["events"] != [("deadlock", name)]:
        raise AssertionError(f"the drill injected {result['events']}, not one deadlock into {name}")
    if not result["inject_to_commit_s"] > result["timing"]["freeze_s"]:
        raise AssertionError(f"{name} committed {result['inject_to_commit_s']:.1f} s after the "
                             f"injection, inside its {result['timing']['freeze_s']} s freeze")
    finals = result["finals"]
    if {gid: f.get("step") for gid, f in finals.items()} != {
            gid: str(steps) for gid in finals}:
        raise AssertionError(f"the groups' FINAL lines {finals}, not all at step {steps}")
    with open(result["logs"][victim]) as f:
        heal_steps = drill_heal_steps(f.read())
    # the step-0 sync heals every group but one; the frozen member's heal
    # after it thawed is one at a later step
    if not heal_steps or max(heal_steps) <= 0 or int(finals[victim].get("heal_bytes", 0)) <= 0:
        raise AssertionError(f"{name} rejoined without a heal: heals at steps {heal_steps}, "
                             f"FINAL {finals[victim]}")
    alive = [f["pid"] for f in finals.values() if pid_alive(int(f["pid"]))]
    if alive:
        raise AssertionError(f"worker processes {alive} outlived the drill")


def chaos_deadlock_cmd() -> list:
    """``python -m torchft_tpu_torch.chaos_drill`` with CHAOS_DEADLOCK's
    arguments and CHAOS_WORKER's workers."""
    d = CHAOS_DEADLOCK
    return [sys.executable, "-m", "torchft_tpu_torch.chaos_drill", "--replicas",
            str(d["replicas"]), "--failure", d["failure"], "--victim", str(d["victim"]),
            "--steps", str(d["steps"]), "--step-time", str(d["step_time"]),
            "--step-work", str(d["step_work"]), *CHAOS_WORKER]


def start_chaos_deadlock() -> dict:
    """Start chaos_deadlock's drill (:func:`chaos_deadlock_cmd`) in a
    process of its own, its output and its workers' logs in a directory
    under ``build/`` (its ``TMPDIR``); :func:`chaos_deadlock_phase` waits
    for it and checks it.  The drill's workers train the CNN at a 0.5 s
    pace, so it runs beside another phase at the cost of a fraction of
    one core."""
    root = os.path.dirname(os.path.abspath(__file__))
    base = os.path.join(root, "build")
    os.makedirs(base, exist_ok=True)
    logdir = tempfile.mkdtemp(prefix="chaos_deadlock_", dir=base)
    path = [root, os.environ.get("PYTHONPATH")]
    env = dict(os.environ, TMPDIR=logdir, PYTHONPATH=os.pathsep.join(p for p in path if p))
    with open(os.path.join(logdir, "drill.out"), "w") as out:
        # a session of its own: stop_chaos_deadlock signals the drill and the
        # workers its supervisor started, as one process group
        proc = subprocess.Popen(chaos_deadlock_cmd(), stdout=out, stderr=subprocess.STDOUT,
                                env=env, cwd=root, start_new_session=True)
    return dict(proc=proc, logdir=logdir, t0=time.perf_counter())


def stop_chaos_deadlock(started: dict) -> None:
    """Stop the drill :func:`start_chaos_deadlock` started, and its workers,
    if it still runs: SIGTERM to its process group, SIGKILL after 10 s."""
    import signal

    proc = started["proc"]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        if proc.poll() is not None:
            return
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            return
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def _drill_result(text: str) -> dict:
    """The drill CLI's ``drill numbers: {...}`` line, its per-group keys
    back to ints; raises if it printed none, with the drill's last lines
    (its ``DrillFailed`` message among them)."""
    lines = [line for line in text.splitlines() if line.startswith("drill numbers: ")]
    if "DRILL PASSED" not in text or not lines:
        tail = [line[:300] for line in text.splitlines()[-5:]]
        raise AssertionError("the chaos drill did not pass: " + " | ".join(tail))
    result = json.loads(lines[-1].removeprefix("drill numbers: "))
    for key in ("logs", "finals"):
        result[key] = {int(gid): v for gid, v in result[key].items()}
    result["events"] = [tuple(e) for e in result["events"]]
    return result


def chaos_deadlock_phase(started: dict, card: str) -> dict:
    """chaos_deadlock: waits for the drill :func:`start_chaos_deadlock`
    started (at most CHAOS_DEADLOCK_TIMEOUT_S) and raises on any failed
    check (:func:`check_chaos_deadlock`), printing the ends of the drill's
    output and of its workers' logs; its directory is removed once every
    check passed."""
    proc, logdir = started["proc"], started["logdir"]
    try:
        proc.wait(timeout=CHAOS_DEADLOCK_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        stop_chaos_deadlock(started)
    wall_s = time.perf_counter() - started["t0"]
    try:
        with open(os.path.join(logdir, "drill.out")) as f:
            result = _drill_result(f.read())
        check_chaos_deadlock(result, CHAOS_DEADLOCK["steps"], CHAOS_DEADLOCK["victim"])
    except Exception:
        for folder, _, names in os.walk(logdir):
            for name in sorted(names):
                with open(os.path.join(folder, name)) as f:
                    tail = f.read().splitlines()[-40:]
                print(f"chaos_deadlock {name} (rc {proc.returncode}):\n"
                      + "\n".join(line[:300] for line in tail), flush=True)
        raise
    with open(result["logs"][CHAOS_DEADLOCK["victim"]]) as f:
        log = f.read()
    # each incarnation of the victim's group prints one FIRST_COMMIT
    victim_restarts = log.count("FIRST_COMMIT ") - 1
    heal_step = max(drill_heal_steps(log))
    shutil.rmtree(logdir, ignore_errors=True)
    finals = result["finals"]
    return dict(
        card=card, command=chaos_deadlock_cmd()[1:],
        timing=result["timing"],
        inject_to_commit_s=result["inject_to_commit_s"], params_sha=result["params_sha"],
        victim_restarts=victim_restarts,
        # the survivor's steps still to train when the victim healed: the
        # drill's margin over the victim's restart
        heal_step=heal_step, steps_left_at_heal=CHAOS_DEADLOCK["steps"] - heal_step,
        heal=dict(seconds=float(finals[CHAOS_DEADLOCK["victim"]]["heal_s"]),
                  bytes=int(finals[CHAOS_DEADLOCK["victim"]]["heal_bytes"])),
        peak_device_gb={gid: f.get("peak_device_gb") for gid, f in finals.items()},
        launches=[json.loads(f["launches"]) for _, f in sorted(finals.items())],
        drill_wall_s=result["wall_s"], wall_s=wall_s,
    )


def check_hsdp(fleet, steps: int, killed: bool = True) -> None:
    """hsdp_cpp's checks over ``run_hsdp_fleet``'s result (per group, per
    rank); with ``killed`` group 1 must have restarted once and healed, else
    no group restarted.  Raises on the first that fails."""
    ranks = [r for group in fleet for r in group]
    for r in ranks:
        where = f"hsdp group {r['group']} rank {r['rank']}"
        if not r["losses"] or not all(math.isfinite(x) for x in r["losses"]):
            raise AssertionError(f"{where}: non-finite loss in {r['losses']}")
        if r["final_step"] != steps:
            raise AssertionError(f"{where} ended at step {r['final_step']}, not {steps}")
        if not r["grad_is_dtensor"]:
            raise AssertionError(f"{where}: a gradient is not a DTensor; the sharded path did not run")
        for name in ("fwd", "dq", "dkv"):
            if r["launches"].get(name, 0) <= 0:
                raise AssertionError(f"{where}: kernel {name} never launched")
    restarts = [0, 1] if killed else [0, 0]
    if [g[0]["incarnation"] for g in fleet] != restarts:
        raise AssertionError(
            f"hsdp restarts {[g[0]['incarnation'] for g in fleet]}, expected {restarts}")
    if killed and any(not r["heal"] or r["heal"]["bytes"] <= 0 for r in fleet[1]):
        raise AssertionError("hsdp group 1 restarted but recorded no heal")
    if len({r["params_sha256"] for r in ranks}) != 1:
        raise AssertionError(f"hsdp groups diverged: {[r['params_sha256'] for r in ranks]}")


def hsdp_phase(train_hsdp, train_ddp, card: str, ddp_sha256: str) -> dict:
    """train_hsdp: 2 replica groups, each one process on the card (FSDP2 at
    NCCL world 1), a kill and a sharded heal; raises on any failed check.
    The launch counts are the processes' own, over exactly this run."""
    cfg = train_ddp.model_config("llama3_8b", LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet = dict(HSDP_PHASE)
    # the rank processes record spans and report the heal's split
    with mock.patch.dict(os.environ, {"TORCHFT_FLIGHT_SPANS": "1"}):
        groups = train_hsdp.run_hsdp_fleet(cfg, torch.device("cuda"), tier="cpp", timeout=300.0,
                                           heal_transport=HSDP_HEAL_TRANSPORT, **fleet)
    wall_s = time.perf_counter() - t0
    check_hsdp(groups, fleet["steps"])
    r0, healed = groups[0][0], groups[1][0]
    check_heal((healed["heal"] or {}).get("bytes"), healed["state_bytes"],
               healed["heal_transport"], "hsdp group 1")
    last = r0["phase_s"][-3:]
    return dict(
        card=card, tier="cpp", fleet=fleet, model="llama3_8b width, %d layers, bf16" % LAYERS,
        losses=[g[0]["losses"] for g in groups],
        params_sha256=r0["params_sha256"],
        equals_train_cpp_sha256=r0["params_sha256"] == ddp_sha256,
        step_s_group0=r0["step_s"],
        step_ms_median_last3=_median(r0["step_s"][-3:]) * 1e3,
        phase_ms_median_last3={
            k: _median(p[k] for p in last) * 1e3 for k in ("compute", "allreduce", "commit")},
        phase_s_group0=r0["phase_s"],
        last_quorum_timings=[g[0]["last_quorum_timings"] for g in groups],
        heal=dict(healed["heal"], transport=healed["heal_transport"],
                  state_bytes=healed["state_bytes"],
                  gb_per_s=healed["heal"]["bytes"] / healed["heal"]["seconds"] / 1e9),
        # seconds per group in each heal span, from each group's last process
        heal_split_s=heal_split_of([g[0]["heal_split_s"] for g in groups]),
        max_memory_allocated_gb=[r["max_memory_allocated_gb"] for g in groups for r in g],
        launches=[r["launches"] for g in groups for r in g],
        planes=[r["planes"] for g in groups for r in g],
        wall_s=wall_s,
    )


def pipeline_launches_expected(layers: int, microbatches: int, remat_mode: str) -> dict:
    """Flash launches of one pipelined step: every stage runs only its live
    ticks, so each layer attends each microbatch once forward and once
    backward; a recomputed attention half ("layer", "attn") launches its
    forward again in the backward pass."""
    per = layers * microbatches
    return {"fwd": per * (2 if remat_mode in ("layer", "attn") else 1), "dq": per, "dkv": per}


def check_pipeline(loss: float, plain_loss: float, rel_errs: dict, launches: dict,
                   expected: dict) -> None:
    """pipeline_phase's checks; raises on the first that fails."""
    if not (math.isfinite(loss) and math.isfinite(plain_loss)):
        raise AssertionError(f"pipeline: non-finite loss {loss} (plain {plain_loss})")
    if abs(loss - plain_loss) > PIPE_LOSS_RTOL * abs(plain_loss):
        raise AssertionError(f"pipeline: loss {loss} against the plain model's {plain_loss}")
    bad = {n: e for n, e in rel_errs.items() if not e <= PIPE_GRAD_RTOL}
    if bad:
        raise AssertionError(f"pipeline: gradients off the plain model's (normwise): {bad}")
    if launches != expected:
        raise AssertionError(f"pipeline: flash launches {launches}, the schedule gives {expected}")


def _step_ms(model, tokens, targets, steps: int) -> float:
    """Median wall ms of a forward and backward, fenced by synchronizes."""
    times = []
    for _ in range(steps):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.loss(tokens, targets).backward()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def pipeline_phase(fa, train_ddp, card: str) -> dict:
    """PipelinedLlama with both stages on the card (the engine's in-process
    hop) against the plain Llama on the same weights and batch; raises on
    any failed check.  The launch counts cover exactly the pipelined step."""
    import dataclasses

    from torchft_tpu_torch.models.llama import Llama
    from torchft_tpu_torch.parallel.pipeline import PipelinedLlama

    c = PIPELINE_CASE
    gc.collect()
    torch.cuda.empty_cache()
    cfg = train_ddp.model_config("llama3_8b", c["layers"])
    plain = Llama(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    piped = PipelinedLlama(dataclasses.replace(cfg, remat_mode=c["remat_mode"]), device="cuda",
                           pp=c["pp"], num_microbatches=c["microbatches"])
    piped.load_state_dict(plain.state_dict())
    gen = torch.Generator("cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]), generator=gen, device="cuda")
    targets = tokens.roll(-1, 1)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    loss = piped.loss(tokens, targets)
    loss.backward()
    torch.cuda.synchronize()
    launches = dict(fa.launches)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    plain_loss = plain.loss(tokens, targets)
    plain_loss.backward()
    grads = dict(plain.named_parameters())
    rel_errs = {n: float((p.grad.float() - grads[n].grad.float()).norm()
                         / grads[n].grad.float().norm().clamp_min(1e-30))
                for n, p in piped.named_parameters()}
    expected = pipeline_launches_expected(c["layers"], c["microbatches"], c["remat_mode"])
    check_pipeline(loss.item(), plain_loss.item(), rel_errs, launches, expected)
    piped_ms = _step_ms(piped, tokens, targets, PIPE_TIMED_STEPS)
    plain_ms = _step_ms(plain, tokens, targets, PIPE_TIMED_STEPS)
    del plain, piped
    return dict(
        card=card, case=c, model="llama3_8b width, %d layers, bf16" % c["layers"],
        loss=loss.item(), plain_loss=plain_loss.item(), max_grad_rel_err=max(rel_errs.values()),
        launches=launches, launches_expected=expected, step_ms=piped_ms, plain_step_ms=plain_ms,
        peak_device_gb_above_weights=peak_gb,
    )


def check_moe_hsdp(fleet, steps: int, layers: int) -> None:
    """moe_hsdp_cpp's checks: hsdp_cpp's without the kill, and every rank
    holds each layer's router and experts, none without a gradient on any
    step."""
    check_hsdp(fleet, steps, killed=False)
    for group in fleet:
        for r in group:
            where = f"moe group {r['group']} rank {r['rank']}"
            if r["moe_params"] != 3 * layers:
                raise AssertionError(f"{where}: {r['moe_params']} MoE parameters, not {3 * layers}")
            if not r["missing_moe_grads"] or any(r["missing_moe_grads"]):
                raise AssertionError(f"{where}: MoE parameters without a gradient per step "
                                     f"{r['missing_moe_grads']}")


def moe_hsdp_phase(train_hsdp, card: str) -> dict:
    """train_hsdp over Llama-3-8B-MoE cut to MOE_LAYERS: 2 replica groups,
    each one process on the card; raises on any failed check.  The launch
    counts are the processes' own."""
    cfg = train_hsdp.model_config("llama3_8b_moe", MOE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fleet = dict(MOE_PHASE)
    groups = train_hsdp.run_hsdp_fleet(cfg, torch.device("cuda"), tier="cpp", timeout=300.0,
                                       **fleet)
    wall_s = time.perf_counter() - t0
    check_moe_hsdp(groups, fleet["steps"], MOE_LAYERS)
    r0 = groups[0][0]
    tokens = fleet["batch"] * fleet["seq"]
    last = r0["phase_s"][-2:]
    return dict(
        card=card, tier="cpp", fleet=fleet,
        model="llama3_8b_moe: 8B width, %d layers, %d experts, capacity factor %s, bf16"
        % (MOE_LAYERS, cfg.num_experts, cfg.capacity_factor),
        tokens_per_step=tokens,
        capacity_per_expert=max(1, int(cfg.capacity_factor * tokens / cfg.num_experts)),
        dropped_tokens_per_step=[g[0]["moe_dropped"] for g in groups],
        losses=[g[0]["losses"] for g in groups],
        params_sha256=r0["params_sha256"],
        step_s_group0=r0["step_s"],
        phase_ms_median_last2={
            k: _median(p[k] for p in last) * 1e3 for k in ("compute", "allreduce", "commit")},
        state_bytes=r0["state_bytes"],
        max_memory_allocated_gb=[r["max_memory_allocated_gb"] for g in groups for r in g],
        launches=[r["launches"] for g in groups for r in g],
        wall_s=wall_s,
    )


# rehearsal_phase: launches of quant_kernel_reports, per kernel (3 flash
# cases of fwd, dq, dkv; int8 and fp8 of quantize, reduce, dequantize)
REHEARSAL_LAUNCHES = {"fwd": 3, "dq": 3, "dkv": 3, "quantize": 2, "reduce": 2, "dequantize": 2}


def rehearsal_phase(fa, qk, card: str, hsdp: dict, moe: dict) -> dict:
    """The scale rehearsal on the card: the baseline table against this
    card's memory, every kernel launched at the baseline configs' shapes
    (``quant_kernel_reports``), and the rehearsal's arithmetic for
    hsdp_cpp's and moe_hsdp_cpp's own layouts beside the peaks those phases
    measured (a finding, not a check).  Raises if a kernel does not launch
    or agree."""
    from torchft_tpu_torch.models.llama import Llama
    from torchft_tpu_torch.models.llama_moe import LlamaMoE
    from torchft_tpu_torch import train_hsdp
    from torchft_tpu_torch.parallel import rehearsal

    t0 = time.perf_counter()
    total_memory = torch.cuda.get_device_properties(0).total_memory
    table = [dict(name=r.name, ok=r.ok, mesh_axes=r.mesh_axes, hbm_frac=r.hbm_frac,
                  total_gb=r.bytes_per_device["total"] / 1e9,
                  frac_of_this_card=r.bytes_per_device["total"] / total_memory)
             for r in rehearsal.baseline_reports(lower=False)]
    fa.reset_launches()
    qk.reset_launches()
    rows = rehearsal.quant_kernel_reports()
    launches = {**fa.launches, **qk.launches}
    if launches != REHEARSAL_LAUNCHES:
        raise AssertionError(f"rehearsal kernels launched {launches}, not {REHEARSAL_LAUNCHES}")
    own = {}
    for key, model, phase in (
        ("hsdp_cpp", Llama(train_hsdp.model_config("llama3_8b", LAYERS), "meta"), hsdp),
        ("moe_hsdp_cpp", LlamaMoE(train_hsdp.model_config("llama3_8b_moe", MOE_LAYERS), "meta"),
         moe),
    ):
        r = rehearsal.rehearse(model, None, {"fsdp": 1}, batch=phase["fleet"]["batch"],
                               seq=phase["fleet"]["seq"], name=key, lower=False)
        own[key] = dict(ok=r.ok, predicted_gb={k: v / 1e9 for k, v in r.bytes_per_device.items()},
                        measured_peak_gb=phase["max_memory_allocated_gb"])
    return dict(card=card, total_memory=total_memory, hbm_bytes=rehearsal.CHIP_HBM_BYTES["h100"],
                baselines=table, kernels=rows, launches=launches, own_layouts=own,
                wall_s=time.perf_counter() - t0)


# supervised_cpp: the deployment path.  The port's ReplicaSupervisor runs
# one `python -m torchft_tpu_torch.train_ddp` process per replica group
# against a C++ lighthouse with bench.py's fleet settings (min_replicas 1,
# a 1 s join window, 50 ms ticks); group 1 keeps a warm standby parked
# behind its active process.  Each worker holds its commits until both
# groups are in the quorum (--min-replicas 2), so the survivor waits for
# the promoted standby and heals it instead of finishing alone.
SUPERVISED_STEPS = 3
SUPERVISED_LIGHTHOUSE = dict(min_replicas=1, join_timeout_ms=1000, quorum_tick_ms=50)
SUPERVISED_KILL_AFTER = 1  # group 1's active dies once it has committed this many steps
SUPERVISED_DEADLINE_S = 600.0
SUPERVISED_CMD = ("-m", "torchft_tpu_torch.train_ddp", "--model", "llama3_8b", "--layers",
                  str(LAYERS), "--steps", str(SUPERVISED_STEPS), "--heal-transport", "comm",
                  "--min-replicas", "2")
FLEET_LINE_KINDS = ("STANDBY", "FIRST_COMMIT", "FINAL")


def parse_fleet_log(text: str) -> list:
    """The ``STANDBY``, ``FIRST_COMMIT`` and ``FINAL`` lines of a replica
    group's log (``train_ddp``'s, ``KIND key=value ...``), in order, as
    dicts with their ``kind``; ``launches`` parsed from its JSON."""
    out = []
    for line in text.splitlines():
        kind, _, rest = line.strip().partition(" ")
        if kind not in FLEET_LINE_KINDS:
            continue
        rec = {"kind": kind}
        for token in rest.split():
            key, sep, value = token.partition("=")
            if sep:
                rec[key] = json.loads(value) if key == "launches" else value
        out.append(rec)
    return out


def pid_alive(pid: int) -> bool:
    """A live (not zombie) process ``pid``, read from ``/proc``."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except OSError:
        return False
    return stat[stat.rindex(")") + 2] != "Z"


def child_pids(module: str) -> set:
    """Pids of this process's children whose command line names
    ``module``."""
    me, out = os.getpid(), set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        if int(stat[stat.rindex(")") + 2:].split()[1]) == me and module in cmd:
            out.add(int(entry))
    return out


def check_supervised(logs: dict, events: list, fleet_pids: set, steps: int) -> dict:
    """supervised_cpp's checks over each group's parsed log lines
    (``logs[g]``), the supervisor's log messages and every fleet pid seen;
    returns group 0's and the promoted standby's FINAL records.  Raises on
    the first that fails."""
    finals = {g: [r for r in recs if r["kind"] == "FINAL"] for g, recs in logs.items()}
    for g, recs in finals.items():
        if len(recs) != 1:
            raise AssertionError(f"group {g} printed {len(recs)} FINAL lines, expected 1")
        if int(recs[0]["step"]) != steps:
            raise AssertionError(f"group {g} ended at step {recs[0]['step']}, not {steps}")
    g0, g1 = finals[0][0], finals[1][0]
    if g0["params_sha"] != g1["params_sha"]:
        raise AssertionError(f"groups diverged: {g0['params_sha']} != {g1['params_sha']}")
    promoted = [e for e in events if "promoted warm standby" in e]
    cold = [e for e in events if "restarting" in e]
    if len(promoted) != 1 or "group 1" not in promoted[0] or cold:
        raise AssertionError(f"expected one promotion of group 1's standby and no cold restart: "
                             f"{promoted + cold}")
    if "standby_park_s" not in g1:
        raise AssertionError("group 1 finished in a process that was never a parked standby")
    standby = [r for r in logs[1] if r["kind"] == "STANDBY" and r["pid"] == g1["pid"]]
    if len(standby) != 1:
        raise AssertionError(f"the promoted process {g1['pid']} did not park once as a standby")
    if "heal_bytes" not in g1:
        raise AssertionError("the promoted standby recorded no heal")
    check_heal(int(g1["heal_bytes"]), int(g1["state_bytes"]), "comm", "the promoted standby")
    # every process that reported launched each flash kernel: group 0, the
    # killed active (at its first commit), the promoted standby (parked and
    # at the end) and a fresh standby if it parked before the stop
    reporting = {}
    for recs in logs.values():
        for r in recs:
            reporting.setdefault(r["pid"], []).append(r)
            for name in ("fwd", "dq", "dkv"):
                if r["launches"].get(name, 0) <= 0:
                    raise AssertionError(f"process {r['pid']} ({r['kind']}): kernel {name} "
                                         f"never launched: {r['launches']}")
    killed = [pid for pid, recs in reporting.items()
              if pid not in (g0["pid"], g1["pid"]) and any(r["kind"] == "FIRST_COMMIT" for r in recs)]
    if len(killed) != 1:
        raise AssertionError(f"expected one killed active that committed before its kill: {killed}")
    alive = sorted(pid for pid in fleet_pids | {int(p) for p in reporting} if pid_alive(pid))
    if alive:
        raise AssertionError(f"fleet processes left alive: {alive}")
    return dict(group0=g0, promoted=g1, killed_pid=int(killed[0]), standby=standby[0],
                processes=sorted(int(p) for p in reporting))


def _gb(value: str) -> float | None:
    return None if value == "none" else float(value)


def supervised_phase(card: str) -> dict:
    """supervised_cpp: two replica-group processes under the port's
    ``ReplicaSupervisor``, group 1 with a warm standby; group 1's active
    process is SIGKILLed (``chaos.ProcessReplica``) once it has committed
    a step, the supervisor promotes the parked standby, which joins, heals
    the whole state from group 0 over the communicator and trains with it
    to the end.  Raises on any failed check (:func:`check_supervised`).

    The final hash is not held to :data:`EXPECTED_SHA256`: a signal at an
    arbitrary moment changes which steps commit with one participant (the
    survivor's solo rounds), so only the groups' equality is checked."""
    import logging
    from torchft_tpu_torch import chaos, launcher
    from torchft_tpu_torch.lighthouse import LighthouseClient
    from torchft_tpu_torch.tier import make_lighthouse

    gc.collect()
    torch.cuda.empty_cache()
    workdir = tempfile.mkdtemp(prefix="supervised_cpp_")
    root = os.path.dirname(os.path.abspath(__file__))
    # TORCHFT_FLIGHT_SPANS: each FINAL line carries its heal's split
    env = {"PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])),
           "TORCHFT_TIER": "cpp", "TORCHFT_FLIGHT_SPANS": "1"}
    logs = {g: os.path.join(workdir, f"group{g}.log") for g in (0, 1)}
    specs = [launcher.ReplicaSpec(replica_group_id=g, cmd=[sys.executable, *SUPERVISED_CMD],
                                  env=dict(env), log_path=logs[g], standby=g == 1)
             for g in (0, 1)]
    events: list = []

    class _Events(logging.Handler):
        def emit(self, record: logging.LogRecord) -> None:
            events.append(record.getMessage())

    sup_logger = logging.getLogger("torchft_tpu_torch.launcher")
    handler = _Events(level=logging.INFO)
    sup_logger.addHandler(handler)
    sup_logger.setLevel(logging.INFO)
    lighthouse = make_lighthouse(bind="127.0.0.1:0", tier="cpp", **SUPERVISED_LIGHTHOUSE)
    addr = lighthouse.local_address()
    client = LighthouseClient(addr, connect_timeout=10.0)
    sup = launcher.ReplicaSupervisor(specs, addr, restart_delay_s=0.5)
    rc: list = []
    fleet_pids: set = set()
    t_spawn = time.time()
    runner = threading.Thread(target=lambda: rc.append(sup.run()), daemon=True)
    runner.start()
    deadline = time.monotonic() + SUPERVISED_DEADLINE_S

    def _group1(status: dict) -> list:
        return [p for p in status["participants"] if p["replica_id"].startswith("train_ddp_1:")]

    def _wait(pred, what: str):
        while time.monotonic() < deadline:
            fleet_pids.update(child_pids("torchft_tpu_torch.train_ddp"))
            got = pred()
            if got:
                return got
            if not runner.is_alive():
                break
            time.sleep(0.05)
        raise AssertionError(f"supervised_cpp: timed out waiting for {what}")

    def _log(g: int) -> list:
        try:
            with open(logs[g], errors="replace") as f:
                return parse_fleet_log(f.read())
        except FileNotFoundError:  # the supervisor has not spawned it yet
            return []

    try:
        # the kill waits for the standby to park and for group 1's active
        # to have committed SUPERVISED_KILL_AFTER steps
        _wait(lambda: any(r["kind"] == "STANDBY" for r in _log(1)), "group 1's standby to park")
        victim = _wait(lambda: [p for p in _group1(client.status())
                                if p["step"] >= SUPERVISED_KILL_AFTER],
                       f"group 1 to commit {SUPERVISED_KILL_AFTER} step")[0]
        qid_at_kill = client.status()["quorum_id"]
        t_kill = time.time()
        chaos.ProcessReplica("supervised_group1", sup, 1).inject(chaos.Failure.KILL)

        def _promoted_in_quorum() -> list:
            status = client.status()
            if status["quorum_id"] <= qid_at_kill:
                return []
            return [p for p in _group1(status) if p["replica_id"] != victim["replica_id"]]

        adopted = _wait(_promoted_in_quorum, "the promoted standby's quorum")[0]
        t_adopt = time.time()
        _wait(lambda: not runner.is_alive(), "both groups to finish")
    finally:
        sup.stop()
        runner.join(timeout=30)
        client.close()
        lighthouse.shutdown()
        sup_logger.removeHandler(handler)
        fleet_pids.update(child_pids("torchft_tpu_torch.train_ddp"))
    wall_s = time.time() - t_spawn
    parsed = {g: _log(g) for g in (0, 1)}
    try:
        if rc != [0]:
            raise AssertionError(f"the supervisor returned {rc}, not 0")
        facts = check_supervised(parsed, events, fleet_pids, SUPERVISED_STEPS)
    except AssertionError:
        for g, path in logs.items():
            with open(path, errors="replace") as f:
                print(f"--- group {g} log (tail)\n" + "\n".join(f.read().splitlines()[-60:]),
                      file=sys.stderr, flush=True)
        raise
    g0, g1 = facts["group0"], facts["promoted"]
    return dict(
        card=card, tier="cpp", model="llama3_8b width, %d layers, bf16" % LAYERS,
        steps=SUPERVISED_STEPS, params_sha=g0["params_sha"],
        cold_start_s=float(g0["first_commit_t"]) - t_spawn,
        standby_park_s=float(g1["standby_park_s"]),
        kill_to_adopt_s=t_adopt - t_kill,
        kill_to_first_commit_s=float(g1["first_commit_t"]) - t_kill,
        heal=dict(seconds=float(g1["heal_s"]), bytes=int(g1["heal_bytes"]),
                  state_bytes=int(g1["state_bytes"]), transport="comm",
                  gb_per_s=int(g1["heal_bytes"]) / float(g1["heal_s"]) / 1e9),
        # seconds per process in each heal span (group 0, the promoted standby)
        heal_split_s=heal_split_of([json.loads(g["heal_split"]) for g in (g0, g1)]),
        peak_device_gb={"group0": _gb(g0["peak_device_gb"]),
                        "promoted_standby": _gb(g1["peak_device_gb"]),
                        "standby_parked": _gb(facts["standby"]["peak_device_gb"])},
        launches={"group0": g0["launches"], "promoted_standby": g1["launches"]},
        processes=len(fleet_pids), supervisor_events=events, adopted_quorum=adopted,
        wall_s=wall_s,
    )


# baby_cpp: the float C++ train phase's fleet with each replica's data plane
# a BabyCommunicator(backend="cpp") child (payloads at or above
# TORCHFT_BABY_SHM_MIN through shared memory)
BABY_PLANES = dict(PLANES["cpp"], communicator="BabyCommunicator")


def check_baby(stats: list, parent_pid: int, restart: dict) -> None:
    """baby_cpp's checks over every baby's ``stats()`` (in creation order)
    and what the restarted replica's factory call saw (``restart``: the
    shut-down babies' child pids still alive then, and the new child's
    pid).  Raises on the first that fails."""
    pids = [pid for s in stats for pid in s["child_pids"]]
    if not pids or parent_pid in pids or len(set(pids)) != len(pids):
        raise AssertionError(f"baby children {pids}: each must be its own process, not {parent_pid}")
    if restart.get("dead_babies", 0) < 1:
        raise AssertionError("the killed replica's baby was not shut down before its restart")
    if restart.get("alive_old_children"):
        raise AssertionError(f"the killed replica's old children live on: {restart['alive_old_children']}")
    if sum(s["shm_ops"] for s in stats) <= 0:
        raise AssertionError("no payload crossed to a baby through shared memory")
    left = [s["live_pid"] for s in stats if s["live_pid"] is not None]
    if left or any(pid_alive(pid) for pid in pids):
        raise AssertionError(f"baby children left alive: {left or pids}")


def baby_phase(train_ddp, baby, fa, qk, avg, spans, card: str) -> dict:
    """baby_cpp: train_cpp's fleet and schedule with every replica's data
    plane a ``BabyCommunicator(backend="cpp")``: all of train_phase's
    checks, the final hash :data:`EXPECTED_SHA256`'s (the child runs the
    same ring on the same bytes), then :func:`check_baby`."""
    babies: list = []
    restart: dict = {}
    lock = threading.Lock()

    def make_comm(timeout_s: float):
        with lock:
            if len(babies) >= 2:  # an incarnation after a kill
                dead = [b for b in babies if b.stats()["live_pid"] is None]
                restart["dead_babies"] = len(dead)
                restart["alive_old_children"] = [
                    pid for b in dead for pid in b.stats()["child_pids"] if pid_alive(pid)]
            comm = baby.BabyCommunicator(timeout_s=timeout_s, backend="cpp")
            babies.append(comm)
            return comm

    shm = shutil.disk_usage("/dev/shm")
    t = train_phase(train_ddp, fa, qk, avg, spans, card, False, "cpp", "comm", make_comm=make_comm,
                    planes=BABY_PLANES)
    check_expected_hashes({"float": t["params_sha256"]})
    stats = [b.stats() for b in babies]
    check_baby(stats, os.getpid(), restart)
    t.update(
        babies=stats, restart=restart,
        shm_ops=sum(s["shm_ops"] for s in stats), pickled_ops=sum(s["pickled_ops"] for s in stats),
        largest_arena_bytes=max(s["largest_arena_bytes"] for s in stats),
        largest_allreduce_bytes=max(s["largest_shm_op_bytes"].get("allreduce_shm", 0)
                                    for s in stats),
        dev_shm_bytes=dict(total=shm.total, free_at_start=shm.free),
        shm_min_bytes=baby._SHM_MIN,
    )
    return t


def main() -> int:
    parser = argparse.ArgumentParser(description="on-card smoke test of torchft_tpu_torch")
    parser.add_argument("--out", default=None, help="also write the results as JSON here")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port itself; in a directory without it this import fails
    from torchft_tpu_torch import baby, drill, native, train_ddp, train_diloco, train_hsdp
    from torchft_tpu_torch.obs import spans
    from torchft_tpu_torch.ops import avg, cuda_build, outer
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import quant as qk
    from torchft_tpu_torch.parallel import ring_attention as ring
    from torchft_tpu_torch.utils import probe

    t0 = time.perf_counter()
    if not probe.backend_executes_with_retries(
            PROBE_WINDOW_S, PROBE_TIMEOUT_S, log=lambda m: print(f"probe: {m}", flush=True)):
        raise CardProbeError(f"the card did not execute a matmul within {PROBE_WINDOW_S:.0f} s")
    print(f"probe: the card executes ({time.perf_counter() - t0:.1f} s)", flush=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}",
          flush=True)
    print(f"host memory: {host_mem_total_gb():.1f} GB (MemTotal)", flush=True)

    # g++ builds the native tier beside nvcc; native_phase checks it later
    native_build: dict = {}
    native_thread = threading.Thread(target=_timed_build, args=(native, native_build))
    native_thread.start()
    t0 = time.perf_counter()
    sources = [*fa.KERNEL_SOURCES, *qk.KERNEL_SOURCES, *avg.KERNEL_SOURCES, *outer.KERNEL_SOURCES]
    cuda_build.build(sources)
    build_s = time.perf_counter() - t0
    print(f"built {', '.join(s + '.cu' for s in sources)} in {build_s:.1f} s", flush=True)
    for source in sources:
        for line in cuda_build.build_log(source).splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "Performance")):
                print(f"ptxas {source}: {line.strip()}", flush=True)

    kernels = kernel_phase(fa, ITERS)
    quant = quant_phase(qk, ITERS)
    avg_t = avg_phase(avg, ITERS)
    outer_t = outer_phase(outer, train_ddp, ITERS)
    outer_t["sync_check"] = t = outer_sync_check(train_ddp, outer)
    print(f"outer sync check: {t['syncs']} whole sharded sync(s) of a {t['elements']}-element "
          f"fragment (fragment 0 less {', '.join(OUTER_SYNC_SKIP)}) on the card bit for bit the "
          f"host's ({t['launches']} outer launches, pipeline chunks per sync "
          f"{t['chunks_per_sync']}; card {t['card_s']:.2f} s, host {t['host_s']:.2f} s)",
          flush=True)
    ring_t = ring_phase(fa, ring, ITERS)
    print(f"ring_phase: {json.dumps(ring_t)}", flush=True)
    print(f"ring_phase (sp={RING_CASE['sp']} in one process, S={RING_CASE['S']}): launches "
          f"{json.dumps(ring_t['ring_launches'])}; fwd {ring_t['ring_fwd_ms']:.3f} ms against "
          f"whole-sequence flash {ring_t['whole_fwd_ms']:.3f} ms; fwd+bwd "
          f"{ring_t['ring_fwd_bwd_ms']:.3f} ms against {ring_t['whole_fwd_bwd_ms']:.3f} ms "
          f"(plain ring {ring_t['plain_ring_fwd_bwd_ms']:.1f} ms); bound fwd "
          f"{ring_t['bound_fwd_ms']:.4f} ms, fwd+bwd {ring_t['bound_fwd_bwd_ms']:.4f} ms; peak device "
          f"{ring_t['peak_device_gb']:.3f} GB", flush=True)
    gate = card_gate_check(fa, train_ddp)
    print(f"card gate: the model at S = {', '.join(map(str, GATE_SEQS))} launched each flash "
          f"kernel once: {json.dumps(gate)}", flush=True)
    native_thread.join()
    handoff = native_phase(native)  # raises with g++'s output if the build failed
    handoff["build_s"] = native_build["build_s"]
    print(f"native runtime: built {handoff['library']} in {handoff['build_s']:.1f} s (g++, "
          "beside the CUDA build); "
          "pinned f32/bf16 tensors hand off as views, a tensor on the card is refused",
          flush=True)
    results = {"card": card, "build_s": build_s, "native": handoff, "kernels": kernels,
               "quant": quant, "avg": avg_t, "outer": outer_t, "ring": ring_t, "card_gate": gate}
    spans.configure(True, cap=SPAN_CAP)
    for key, quantized, tier in TRAIN_PHASES:
        results[key] = train_phase(train_ddp, fa, qk, avg, spans, card, quantized, tier,
                                   replicas=TRAIN_REPLICAS[key], sources=TRAIN_HEAL_SOURCES[key],
                                   heal_transport=TRAIN_HEAL_TRANSPORT[key])
        print(f"{key}: {json.dumps(results[key])}", flush=True)
        t = results[key]
        h = t["heal"]
        print(f"{key} ({tier} tier, {t['sync']}, {t['replicas']} groups): step "
              f"{t['step_ms_median_last3']:.1f} ms, "
              f"phases {json.dumps(t['phase_ms_median_last3'])}, commit split (ms per replica) "
              f"{json.dumps(t['commit_split_ms_median_last3'])}, host tail (ms per replica) "
              f"{json.dumps(t['host_split_ms_median_last3'])}, in no span "
              f"{t['unspanned_ms_median_last3']:.1f} ms; heal over {h['transport']} from "
              f"{h['sources']} source(s), bytes per source {h['per_source_bytes']}, "
              f"{h['seconds']:.3f} s for {h['bytes']} bytes ({h['gb_per_s']:.3f} GB/s; state "
              f"{h['state_bytes']} bytes), heal split (s per replica) "
              f"{split_line(t['heal_split_s'])}; peak device {t['max_memory_allocated_gb']:.2f} "
              f"GB, peak host RSS {t['peak_host_rss_gb']:.1f} GB (at its start "
              f"{t['start_host_rss_gb']:.1f}); wall {t['wall_s']:.1f} s", flush=True)
    results["baby_cpp"] = t = baby_phase(train_ddp, baby, fa, qk, avg, spans, card)
    print(f"baby_cpp: {json.dumps(t)}", flush=True)
    ref = results["train_cpp"]
    print(f"baby_cpp (cpp tier, BabyCommunicator children): hash as expected; step "
          f"{t['step_ms_median_last3']:.1f} ms (train_cpp {ref['step_ms_median_last3']:.1f}), "
          f"phases {json.dumps(t['phase_ms_median_last3'])} (train_cpp "
          f"{json.dumps(ref['phase_ms_median_last3'])}), commit split (ms per replica) "
          f"{json.dumps(t['commit_split_ms_median_last3'])} (train_cpp "
          f"{json.dumps(ref['commit_split_ms_median_last3'])}); {t['shm_ops']} shm ops, "
          f"{t['pickled_ops']} pickled, largest allreduce {t['largest_allreduce_bytes']} bytes, "
          f"largest arena {t['largest_arena_bytes']} bytes, /dev/shm "
          f"{t['dev_shm_bytes']['total']} bytes; heal {t['heal']['seconds']:.3f} s for "
          f"{t['heal']['bytes']} bytes ({t['heal']['gb_per_s']:.3f} GB/s), split (s per replica) "
          f"{split_line(t['heal_split_s'])}; wall {t['wall_s']:.1f} s", flush=True)
    hashes = check_cross_tier(results)
    if len({results[key]["heal"]["state_bytes"] for key, _, _ in TRAIN_PHASES}) != 1:
        raise AssertionError("the train phases healed states of different sizes")
    check_expected_hashes({sync: by_tier["cpp"] for sync, by_tier in hashes.items()})
    for sync, by_tier in hashes.items():
        tiers = ", ".join(f"{tier} {sha}" for tier, sha in by_tier.items())
        print(f"{sync} sync parameter sha256: {tiers} ({'equal, and ' * (len(by_tier) > 1)}"
              "as expected)", flush=True)
    results["supervised_cpp"] = t = supervised_phase(card)
    # a finding, not a check: the survivor commits nothing alone, so the
    # supervised fleet trains train_cpp's steps on the same batches
    t["equals_train_cpp_sha256"] = results["train_cpp"]["params_sha256"].startswith(t["params_sha"])
    print(f"supervised_cpp: {json.dumps(t)}", flush=True)
    print(f"supervised_cpp (cpp tier, {t['processes']} processes): group 1's active SIGKILLed, its "
          f"warm standby promoted; cold start {t['cold_start_s']:.1f} s, standby parked "
          f"{t['standby_park_s']:.1f} s, kill to adopted quorum {t['kill_to_adopt_s']:.3f} s, kill "
          f"to first commit {t['kill_to_first_commit_s']:.3f} s; heal {t['heal']['seconds']:.3f} s "
          f"for {t['heal']['bytes']} bytes ({t['heal']['gb_per_s']:.3f} GB/s), split (s per "
          f"process) {split_line(t['heal_split_s'])}; peak device GB "
          f"{json.dumps(t['peak_device_gb'])}; "
          f"equal hashes {t['params_sha']} ({'equal to' if t['equals_train_cpp_sha256'] else 'not'} "
          f"train_cpp's); wall {t['wall_s']:.1f} s", flush=True)
    for key, fleet in DILOCO_PHASES:
        if key == "localsgd_cpp":
            results[key] = t = jobloss_phase(train_diloco, train_ddp, fa, qk, card, fleet,
                                             DILOCO_LAYERS[key])
            print(f"{key}: {json.dumps(t)}", flush=True)
            print(jobloss_line(key, t), flush=True)
            continue
        results[key] = t = diloco_phase(train_diloco, train_ddp, fa, qk, card, fleet,
                                        DILOCO_LAYERS.get(key, LAYERS), env=DILOCO_ENV.get(key),
                                        spans=spans)
        print(f"{key}: {json.dumps(t)}", flush=True)
        heal = (f"heal {t['heal']['seconds']:.3f} s for {t['heal']['bytes']} bytes "
                f"({t['heal']['gb_per_s']:.3f} GB/s)" if t["heal"] else "no heal")
        print(f"{key} (cpp tier, {t['model']}): inner step {t['inner_step_ms_median']:.1f} ms (median), "
              f"train loop held {t['sync_s_per_commit']:.3f} s per committed sync, outer sync "
              "(s, median) "
              f"{json.dumps(t['outer_shard_s_median'])}, split (s per replica per committed "
              f"sync) {json.dumps(t['sync_split_s'])}; {heal}, split (s per replica) "
              f"{split_line(t['heal_split_s'])}; peak device "
              f"{t['max_memory_allocated_gb']:.1f} GB, peak host RSS {t['peak_host_rss_gb']:.1f} GB "
              f"({t['start_host_rss_gb']:.1f} GB at its start); "
              f"{t['tokens_per_s_per_replica']:.1f} tokens/s per replica; wall {t['wall_s']:.1f} s",
              flush=True)
        if t["stream"]:
            ref, st = results["diloco_cpp"], t["stream"]
            print(f"{key} (TORCHFT_STREAM_SYNC=1): every sync at a stream barrier "
                  f"{json.dumps(st['stream_barriers'])}; replica 1 killed with fragment "
                  f"{st['kill']['in_flight']} in flight at step {st['kill']['step']}, which "
                  f"committed nowhere (decisions {json.dumps(st['sync_decisions'])}); beside "
                  f"diloco_cpp: inner step {t['inner_step_ms_median']:.1f} ms "
                  f"({ref['inner_step_ms_median']:.1f}), held {t['sync_s_per_commit']:.3f} s per "
                  f"committed sync ({ref['sync_s_per_commit']:.3f}), outer sync "
                  f"{t['outer_shard_s_median']['wall']:.3f} s "
                  f"({ref['outer_shard_s_median']['wall']:.3f}), heal {t['heal']['seconds']:.3f} s "
                  f"for {t['heal']['bytes']} bytes ({ref['heal']['seconds']:.3f} s for "
                  f"{ref['heal']['bytes']}), peak device {t['max_memory_allocated_gb']:.1f} GB "
                  f"({ref['max_memory_allocated_gb']:.1f}), peak host RSS "
                  f"{t['peak_host_rss_gb']:.1f} GB ({ref['peak_host_rss_gb']:.1f}), "
                  f"{t['tokens_per_s_per_replica']:.1f} tokens/s per replica "
                  f"({ref['tokens_per_s_per_replica']:.1f})", flush=True)
    spans.configure(False)
    results["spare_python"] = t = spare_phase(
        train_diloco, train_ddp, fa, qk, card,
        dict(results["diloco_cpp"]["heal"], heal_split_s=results["diloco_cpp"]["heal_split_s"]))
    print(f"spare_python: {json.dumps(t)}", flush=True)
    print(f"spare_python (python tier, 2 actives + 1 spare): replica 1 killed, the spare promoted "
          f"once in one membership edit, no heal; promote_s {t['promote_s']:.3f} s at warm lag "
          f"{t['promote_warm_lag_steps']:.0f}; kill to adopted quorum {t['kill_to_adopt_s']:.3f} s, "
          f"to the spare's first committed sync {t['kill_to_first_commit_s']:.3f} s; warm "
          f"{t['warm_bytes_fetched']:.0f} bytes in {t['warm_chunks_fetched']:.0f} chunks, "
          f"{t['warm_deltas_applied']:.0f} deltas applied; flash launches after the promotion "
          f"{json.dumps(t['launches_after_promotion'])}; peak device "
          f"{t['max_memory_allocated_gb']:.1f} GB, peak host RSS {t['peak_host_rss_gb']:.1f} GB "
          f"({t['start_host_rss_gb']:.1f} GB at its start, "
          f"{t['host_rss_before_release_gb']:.1f} GB before freed memory went back); "
          f"wall {t['wall_s']:.1f} s; for "
          f"comparison only (C++ tier), diloco_cpp's cold heal {t['diloco_cpp_cold_heal']['seconds']:.3f} s "
          f"for {t['diloco_cpp_cold_heal']['bytes']} bytes "
          f"({t['diloco_cpp_cold_heal']['gb_per_s']:.3f} GB/s), split (s per replica) "
          f"{split_line(t['diloco_cpp_cold_heal']['heal_split_s'])}", flush=True)
    results["spare_drills"] = t = spare_drills_phase(drill, train_diloco, fa, card)
    print(f"spare_drills: {json.dumps(t)}", flush=True)
    d = t["delta_fleet"]
    print(f"spare_drills: spare_promote promotion_latency_s {t['spare_promote']['promotion_latency_s']} "
          f"(quorum_reconfigs {t['spare_promote']['quorum_reconfigs']}), kill_spare quorum_reconfigs "
          f"{t['kill_spare']['quorum_reconfigs']}, {t['drills_s']:.1f} s; delta feed: "
          f"{d['warm_deltas_applied']:.0f} deltas applied on the card, promoted at warm lag "
          f"{d['promote_warm_lag_steps']:.0f}, kill to adopted quorum {d['kill_to_adopt_s']:.3f} s, "
          f"wall {d['wall_s']:.1f} s", flush=True)
    results["cnn_cpp"] = t = cnn_phase(train_ddp, card)
    print(f"cnn_cpp: {json.dumps(t)}", flush=True)
    print(f"cnn_cpp (cpp tier): step {t['step_ms_median']:.1f} ms (median of the last 10), "
          f"loss {t['losses'][0][0]:.4f} -> {t['losses'][0][-1]:.4f}; heal "
          f"{t['heal']['seconds']:.3f} s for {t['heal']['bytes']} bytes; wall {t['wall_s']:.1f} s",
          flush=True)
    chaos = start_chaos_deadlock()  # beside hsdp_cpp and the pipeline, collected after them
    try:
        results["hsdp_cpp"] = t = hsdp_phase(
            train_hsdp, train_ddp, card, results["train_cpp"]["params_sha256"])
        check_expected_hashes({"hsdp": t["params_sha256"]})
        results["pipeline"] = t = pipeline_phase(fa, train_ddp, card)
        results["chaos_deadlock"] = c = chaos_deadlock_phase(chaos, card)
    finally:
        stop_chaos_deadlock(chaos)  # a no-op once it has been collected
    print(f"chaos_deadlock: {json.dumps(c)}", flush=True)
    print(f"chaos_deadlock (cpp tier, {' '.join(c['command'])}; beside hsdp_cpp and the "
          f"pipeline): rg1 frozen {c['timing']['freeze_s']:g} s past a "
          f"{c['timing']['comm_timeout_s']:g} s per-op timeout (a "
          f"{c['timing']['step_s']:g} s step planned), evicted, thawed, restarted by its "
          f"supervisor {c['victim_restarts']} time(s) and healed {c['heal']['bytes']} "
          f"bytes in {c['heal']['seconds']:.3f} s at step {c['heal_step']} (the survivor "
          f"{c['steps_left_at_heal']} steps from its end); injection to its next commit "
          f"{c['inject_to_commit_s']:.1f} s; equal hashes {c['params_sha']}; wall "
          f"{c['wall_s']:.1f} s", flush=True)
    t = results["hsdp_cpp"]
    print(f"hsdp_cpp: {json.dumps(t)}", flush=True)
    print(f"hsdp_cpp (cpp tier, FSDP2 at world 1 per group): step "
          f"{t['step_ms_median_last3']:.1f} ms, phases {json.dumps(t['phase_ms_median_last3'])}; "
          f"heal over {t['heal']['transport']} {t['heal']['seconds']:.3f} s for "
          f"{t['heal']['bytes']} bytes ({t['heal']['gb_per_s']:.3f} GB/s), split (s per group) "
          f"{split_line(t['heal_split_s'])}; peak device GB per "
          f"process {json.dumps(t['max_memory_allocated_gb'])}; last_quorum_timings "
          f"{json.dumps(t['last_quorum_timings'])}; final hash "
          f"{'equals' if t['equals_train_cpp_sha256'] else 'differs from'} train_cpp's; "
          f"wall {t['wall_s']:.1f} s", flush=True)
    t = results["pipeline"]
    print(f"pipeline_phase: {json.dumps(t)}", flush=True)
    print(f"pipeline_phase (PipelinedLlama, pp={PIPELINE_CASE['pp']} in one process, "
          f"M={PIPELINE_CASE['microbatches']}, remat {PIPELINE_CASE['remat_mode']}): loss "
          f"{t['loss']:.6f} against the plain model's {t['plain_loss']:.6f}, gradients within "
          f"{t['max_grad_rel_err']:.2e} normwise; flash launches {json.dumps(t['launches'])} "
          f"(the schedule's); step {t['step_ms']:.1f} ms against the plain step "
          f"{t['plain_step_ms']:.1f} ms; peak device {t['peak_device_gb_above_weights']:.2f} GB "
          "above the weights", flush=True)
    results["moe_hsdp_cpp"] = t = moe_hsdp_phase(train_hsdp, card)
    print(f"moe_hsdp_cpp: {json.dumps(t)}", flush=True)
    print(f"moe_hsdp_cpp (cpp tier, {t['model']}): phases "
          f"{json.dumps(t['phase_ms_median_last2'])}; state {t['state_bytes']} bytes; "
          f"tokens past capacity "
          f"{t['capacity_per_expert']} per step of {t['tokens_per_step']} (per group, per step) "
          f"{json.dumps(t['dropped_tokens_per_step'])}; peak device GB per process "
          f"{json.dumps(t['max_memory_allocated_gb'])}; wall {t['wall_s']:.1f} s", flush=True)
    results["rehearsal"] = t = rehearsal_phase(fa, qk, card, results["hsdp_cpp"],
                                               results["moe_hsdp_cpp"])
    print(f"rehearsal_phase: {json.dumps(t)}", flush=True)
    for row in t["baselines"]:
        print(f"rehearsal {row['name']}: {'OK' if row['ok'] else 'FAIL'} {json.dumps(row['mesh_axes'])} "
              f"{row['total_gb']:.1f} GB a card, {row['hbm_frac']:.1%} of {t['hbm_bytes'] / 1e9:.0f} GB "
              f"({row['frac_of_this_card']:.1%} of this card's {t['total_memory']} bytes)", flush=True)
    for key, own in t["own_layouts"].items():
        print(f"rehearsal of {key}'s layout: predicted {own['predicted_gb']['total']:.2f} GB a card, "
              f"measured peaks {json.dumps(own['measured_peak_gb'])} GB", flush=True)
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
    # the port's own kernel: the float phase's launches (the int8 phase
    # launches it as often), timed on the float path's whole gradient
    line["kernels"].append(dict(
        name="ddp_avg", route="cuda", source=PORT_KERNELS["ddp_avg"][0],
        replaces=PORT_KERNELS["ddp_avg"][1], launches=float_t["launches"]["avg"],
        **{k: avg_t["main"][k] for k in keys}))
    # the ring path's launches of each flash kernel, by mask, and the spare
    # path's (spare_python, every replica).  Each path's count of a kernel
    # is what that run counted; null where the path does not count that
    # kernel (the pipeline counts flash only, the rehearsal flash and quant)
    for row in line["kernels"][:3]:
        row["ring_launches"] = ring_t["ring_launches"][row["name"].removeprefix("flash_")]
    for row in line["kernels"]:
        name = row["name"].split("_", 1)[1]
        row["spare_launches"] = results["spare_python"]["launches"].get(name)
        # the pipeline (one process), each MoE HSDP process, the
        # rehearsal's launches at the baseline configs' shapes
        row["pipeline_launches"] = results["pipeline"]["launches"].get(name)
        row["moe_hsdp_launches"] = [n.get(name) for n in results["moe_hsdp_cpp"]["launches"]]
        row["rehearsal_launches"] = results["rehearsal"]["launches"].get(name)
        # the baby data plane's fleet, and each supervised process that
        # finished (group 0, the promoted standby)
        row["baby_launches"] = results["baby_cpp"]["launches"][name]
        row["supervised_launches"] = [
            n.get(name) for n in results["supervised_cpp"]["launches"].values()]
        # the fleet restored from the durable checkpoint
        row["jobloss_launches"] = results["localsgd_cpp"]["launches"].get(name)
        # the streamed DiLoCo fleet, and each chaos drill worker's FINAL
        # launches (the CNN's f32 gradients go through the avg kernel)
        row["stream_launches"] = results["diloco_stream_cpp"]["launches"].get(name)
        # the paths driven again: the int8 sync on the Python tier, and the
        # int8 DiLoCo fleet (its outer sync quantizes and dequantizes on
        # the card)
        row["quantized_python_launches"] = results["train_quantized_python"]["launches"][name]
        row["diloco_quantized_launches"] = results["diloco_quantized_cpp"]["launches"].get(name)
        row["chaos_deadlock_launches"] = [
            n.get(name) for n in results["chaos_deadlock"]["launches"]]
    # DiLoCo's outer kernel: diloco_cpp's launches, timed at its first
    # pipeline chunk; each other path's count where it counts the kernel
    # (the DiLoCo fleets, the spare's, the job loss's LocalSGD), else null
    row = dict(name="diloco_outer", route="cuda", source=PORT_KERNELS["diloco_outer"][0],
               replaces=PORT_KERNELS["diloco_outer"][1],
               launches=results["diloco_cpp"]["launches"]["outer"],
               **{k: outer_t["chunk"][k] for k in keys})
    for field, path in (("spare_launches", "spare_python"), ("pipeline_launches", "pipeline"),
                        ("rehearsal_launches", "rehearsal"), ("baby_launches", "baby_cpp"),
                        ("jobloss_launches", "localsgd_cpp"),
                        ("stream_launches", "diloco_stream_cpp"),
                        ("quantized_python_launches", "train_quantized_python"),
                        ("diloco_quantized_launches", "diloco_quantized_cpp")):
        row[field] = results[path]["launches"].get("outer")
    row["moe_hsdp_launches"] = [n.get("outer") for n in results["moe_hsdp_cpp"]["launches"]]
    row["supervised_launches"] = [
        n.get("outer") for n in results["supervised_cpp"]["launches"].values()]
    row["chaos_deadlock_launches"] = [n.get("outer") for n in results["chaos_deadlock"]["launches"]]
    line["kernels"].append(row)
    print(json.dumps(line), flush=True)
    print(card, flush=True)  # nvidia-smi's own line: name, power limit
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
