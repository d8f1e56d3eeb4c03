"""The heal-carrying phases of ``chip_smoke.py`` on one checkout, with spans on.

Runs ``chip_smoke.train_phase`` / ``diloco_phase`` for the phases named in
``--phases`` (default: ``train_cpp`` over comm, ``train_quantized_cpp`` over
HTTP, ``diloco_cpp`` over HTTP) from the checkout at ``--root``, and writes
each phase's heal (seconds, bytes, GB/s), its ``heal_split_s`` (seconds per
replica in each span of ``chip_smoke.HEAL_SPANS``), its wall and its peak
device memory as JSON.  With ``--memory-trace`` a thread samples
``torch.cuda.memory_allocated()`` every 5 ms and each phase also reports
when its peak happened and which spans were open then.

To compare two checkouts on one card, unpack the parent with ``git archive``
into a directory ``.gitignore`` lists and run, in one call, parent, change,
change, parent::

    python3 scripts/heal_ab.py --root build/parent --label parent1 --out parent1.json
    python3 scripts/heal_ab.py --root . --label change1 --out change1.json

A checkout without the heal's spans reports zeros for them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time


def _peak_context(samples: list, recorded: list) -> dict:
    """When the sampled peak happened and the spans open around it."""
    peak_t, peak = max(samples, key=lambda s: s[1])
    open_spans: dict = {}
    for rec in recorded:
        if rec["t"] <= peak_t + 0.05 and rec["t"] + rec["dur"] >= peak_t - 0.3:
            open_spans[rec["name"]] = open_spans.get(rec["name"], 0) + 1
    return dict(sampled_peak_gb=peak / 1e9, spans_at_peak=open_spans)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--root", default=".", help="the checkout to run")
    parser.add_argument("--label", default="run")
    parser.add_argument("--out", required=True, help="the JSON to write")
    parser.add_argument("--phases", default="train_cpp,train_quantized_cpp,diloco_cpp")
    parser.add_argument("--memory-trace", action="store_true")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        print("heal_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torchft_tpu_torch import native, train_ddp, train_diloco
    from torchft_tpu_torch.obs import spans
    from torchft_tpu_torch.ops import avg, cuda_build, outer
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import quant as qk

    cuda_build.build([*fa.KERNEL_SOURCES, *qk.KERNEL_SOURCES, *avg.KERNEL_SOURCES,
                      *outer.KERNEL_SOURCES])
    native.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    spans.configure(True, cap=cs.SPAN_CAP)
    want = args.phases.split(",")
    phases = [(key, "train", (quantized, tier)) for key, quantized, tier in cs.TRAIN_PHASES]
    phases += [(key, "diloco", fleet) for key, fleet in cs.DILOCO_PHASES if key != "localsgd_cpp"]
    out: dict = {"label": args.label, "card": card}
    for key, kind, spec in phases:
        if key not in want:
            continue
        samples: list = []
        stop = threading.Event()

        def _sample() -> None:
            while not stop.is_set():
                samples.append((time.monotonic(), torch.cuda.memory_allocated()))
                time.sleep(0.005)

        sampler = threading.Thread(target=_sample, daemon=True)
        if args.memory_trace:
            sampler.start()
        if kind == "train":
            t = cs.train_phase(train_ddp, fa, qk, avg, spans, card, *spec,
                               cs.TRAIN_HEAL_TRANSPORT[key])
        else:
            t = cs.diloco_phase(train_diloco, train_ddp, fa, qk, card, spec,
                                cs.DILOCO_LAYERS.get(key, cs.LAYERS), env=cs.DILOCO_ENV.get(key),
                                spans=spans)
        stop.set()
        row = {k: t.get(k) for k in ("heal", "heal_split_s", "wall_s", "max_memory_allocated_gb",
                                     "peak_host_rss_gb", "sync_s_per_commit")}
        if args.memory_trace:
            sampler.join()
            row.update(_peak_context(samples, spans.snapshot()))
        out[key] = row
        print(f"[{args.label}] {key}: {json.dumps(row)}", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
