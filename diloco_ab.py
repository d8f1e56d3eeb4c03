#!/usr/bin/env python3
"""DiLoCo's fleet phases of one checkout, for a same-card comparison.

    python3 diloco_ab.py --root DIR --label NAME [--out FILE]

Imports ``torchft_tpu_torch`` and ``chip_smoke.py`` from the checkout at DIR
(an older commit unpacked with ``git archive`` works as well), builds every
kernel source its ``torchft_tpu_torch.ops`` modules list and its C++ tier, and runs that checkout's ``diloco_cpp`` and
``diloco_stream_cpp`` phases (spans on) and its ``spare_python`` phase, each
with the checkout's own checks: 2 replicas at Llama-3-8B width, 1 layer,
on the card.  Prints one line per phase (wall seconds, seconds held per
committed sync, the outer sync's split, the heal, peak device memory and
host RSS) and writes them all as JSON to FILE.  To compare two checkouts on
one card, run them in turns in one command (A, B, B, A), each in a process
of its own.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pkgutil
import subprocess
import sys
import threading

KEYS = ("wall_s", "sync_s_per_commit", "outer_shard_s_median", "sync_split_s", "heal",
        "max_memory_allocated_gb", "peak_host_rss_gb", "inner_step_ms_median", "launches")
SPARE_KEYS = ("wall_s", "kill_to_adopt_s", "kill_to_first_commit_s", "max_memory_allocated_gb",
              "peak_host_rss_gb", "launches")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", required=True, help="checkout to measure")
    parser.add_argument("--label", required=True, help="name of this run in the output")
    parser.add_argument("--out", default=None, help="also write the results as JSON here")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.out) if args.out else None
    sys.path.insert(0, root)
    os.chdir(root)

    import torch

    if not torch.cuda.is_available():
        print("diloco_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from torchft_tpu_torch import native, train_ddp, train_diloco
    from torchft_tpu_torch.obs import spans
    from torchft_tpu_torch import ops
    from torchft_tpu_torch.ops import cuda_build
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import quant as qk

    sources = [src for m in pkgutil.iter_modules(ops.__path__) for src in
               getattr(importlib.import_module(f"{ops.__name__}.{m.name}"), "KERNEL_SOURCES", ())]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    built: dict = {}
    thread = threading.Thread(target=cs._timed_build, args=(native, built))
    thread.start()
    cuda_build.build(sources)
    thread.join()
    cs.native_phase(native)

    results = {"label": args.label, "root": root, "card": card}
    spans.configure(True, cap=cs.SPAN_CAP)
    for key, fleet in cs.DILOCO_PHASES:
        if key not in ("diloco_cpp", "diloco_stream_cpp"):
            continue
        t = cs.diloco_phase(train_diloco, train_ddp, fa, qk, card, fleet,
                            cs.DILOCO_LAYERS.get(key, cs.LAYERS), env=cs.DILOCO_ENV.get(key),
                            spans=spans)
        results[key] = {k: t[k] for k in KEYS}
        print(args.label, key, json.dumps(results[key]), flush=True)
    spans.configure(False)
    t = cs.spare_phase(train_diloco, train_ddp, fa, qk, card, results["diloco_cpp"]["heal"])
    results["spare_python"] = {k: t[k] for k in SPARE_KEYS}
    print(args.label, "spare_python", json.dumps(results["spare_python"]), flush=True)
    print(card, flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
