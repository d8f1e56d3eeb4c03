"""The striped (multi-source) HTTP heal alone, beside the one-source chunked heal.

Two sources stage one state (four bf16 leaves, ``--gb`` GB in all) on the
card or on the host, with their striped chunk index at 4 MiB and at 64 MiB;
one healer then receives it in turns, striped from both sources
(``HTTPTransport.recv_checkpoint_striped``) and chunked from the first
(``recv_checkpoint`` over ``HEAL_NUM_CHUNKS`` parallel ranges), twice each.
No fleet and no training run beside it, so the transport's own rate shows,
with the heal's spans (``heal::send_copy``, ``heal::send_write``,
``heal::recv_read``, seconds summed over threads).

Run it from the repository root on a machine with a CUDA card::

    PYTHONPATH=. python3 scripts/striped_heal_probe.py

``--devices cpu`` runs the host-state cases alone (also without a card).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from torchft_tpu_torch.checkpointing.http_transport import HEAL_NUM_CHUNKS, HTTPTransport
from torchft_tpu_torch.obs import spans

STEP = 1


def _state(device: str, gb: float) -> dict:
    n = int(gb * 1e9) // 2 // 4
    g = torch.Generator(device="cpu").manual_seed(0)
    return {f"w{i}": torch.randn(n, generator=g).to(torch.bfloat16).to(device) for i in range(4)}


def probe(device: str, gb: float, chunk_mb: int) -> None:
    state = _state(device, gb)
    sources = [HTTPTransport(timeout=120.0, num_chunks=HEAL_NUM_CHUNKS,
                             heal_chunk_bytes=chunk_mb << 20) for _ in range(2)]
    healer = HTTPTransport(timeout=120.0, num_chunks=HEAL_NUM_CHUNKS)
    try:
        for s in sources:
            s.send_checkpoint([1], STEP, state, 120.0)
        listed = [(i, f"http://127.0.0.1:{s.port}") for i, s in enumerate(sources)]
        for _ in range(2):
            for kind in ("striped", "chunked"):
                spans.clear()
                t0 = time.monotonic()
                if kind == "striped":
                    healer.recv_checkpoint_striped(listed, STEP, 120.0)
                else:
                    healer.recv_checkpoint(0, listed[0][1], STEP, 120.0)
                seconds = time.monotonic() - t0
                nbytes = healer.last_heal_metrics.bytes_total
                split = {k: round(v, 2) for k, v in spans.totals(("heal::",)).items()}
                print(f"{device} chunk {chunk_mb} MiB {kind}: {seconds:.3f} s "
                      f"{nbytes / seconds / 1e9:.3f} GB/s spans {split}", flush=True)
    finally:
        for t in (*sources, healer):
            t.shutdown()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gb", type=float, default=4.0, help="the state's size")
    parser.add_argument("--devices", default="cuda,cpu", help="where the sources stage it")
    args = parser.parse_args()
    devices = args.devices.split(",")
    if "cuda" in devices:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], check=True, capture_output=True,
                             text=True).stdout.strip(), flush=True)
    spans.configure(True, cap=1_000_000)
    for device in devices:
        for chunk_mb in (4, 64):
            probe(device, args.gb, chunk_mb)
        if device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
