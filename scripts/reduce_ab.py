#!/usr/bin/env python3
"""Device time of the port's quantized reduce kernel in one checkout.

    python3 scripts/reduce_ab.py [--root DIR] [--out FILE]

Imports ``torchft_tpu_torch`` from the checkout at DIR (default: this one;
an older commit unpacked with ``git archive`` works as well) and, for the
main pipeline window [2, 2048, 1024] and the wide one [2, 32768, 1024], int8
and fp8, holds its ``reduce_quantized_device`` bit for bit against the plain
version and times it with ``chip_smoke.py``'s method: the device time with a
cold L2 (a replayed CUDA graph of launches rotating over copies of the
inputs larger than the L2) and the time of one eager wrapper call.  The
method and the inputs always come from this checkout's ``chip_smoke.py``,
so two kernels are measured the same way.  To compare two checkouts on one
card, run them in turns in one command (A, B, B, A).  Prints one JSON line
with the card's name and power limit; needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
CASES = ("main", "wide")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=str(REPO), help="checkout whose kernel is timed")
    parser.add_argument("--out", default=None, help="also append the JSON line to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("reduce_ab: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from torchft_tpu_torch.ops import quant as qk

    if not Path(qk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {qk.__file__}, not the checkout at {root}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    out = {"root": str(root), "card": card, "cases": {}}
    for case in (c for c in cs.QUANT_CASES if c["name"] in CASES):
        for kind in ("int8", "fp8"):
            qs, scs = cs._reduce_inputs(qk, case, kind)
            want = qk.reduce_quantized_plain(qs, scs, kind=kind)
            got = qk.reduce_quantized_device(qs, scs, kind=kind)
            cs._exact(f"{case['name']} {kind} q", got[0], want[0])
            cs._exact(f"{case['name']} {kind} scales", got[1], want[1])
            ms, sets, rotated = cs._reduce_device_ms(qk, qs, scs, kind, want)
            call_ms = cs._time_ms(lambda: qk.reduce_quantized_device(qs, scs, kind=kind),
                                  cs.QUANT_ITERS)
            bound_ms, bound_by = cs._quant_bound("reduce", case)
            out["cases"][f"{case['name']} {kind}"] = dict(
                ms=ms, call_ms=call_ms, bound_ms=bound_ms, bound_by=bound_by,
                pct_of_bound=100 * bound_ms / ms, rotated_mb=rotated / 1e6, rotated_sets=sets,
            )
            del qs, scs, want, got
            torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
