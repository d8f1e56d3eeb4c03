"""Host rates that bound a heal's transfer, measured on the machine that holds the card.

A heal moves a replica's state from the card of the sender to host memory,
over a socket to the receiver's host memory, and at ``should_commit`` back
to the receiver's card.  This script times each of those pieces alone, so a
heal's split (``chip_smoke.HEAL_SPANS``) can be read against what the host
can do:

- ``first_touch``: writing a fresh pageable buffer (every page faulted in)
  against writing the same buffer again; ``first_touch_ways``: four threads
  faulting one in, ``MAP_POPULATE`` and ``MADV_HUGEPAGE``;
- ``pinned_alloc``: a fresh pinned buffer against one PyTorch's caching host
  allocator hands back;
- ``d2h`` / ``h2d``: card to host and back, into fresh pageable, touched
  pageable and pinned memory;
- ``tcp``: loopback TCP from a touched buffer into a touched or a fresh one,
  over 1, 2, 4 and 8 parallel connections (into fresh memory: 1, 4 and 8).

Run it from the repository root on a machine with a CUDA card::

    python3 scripts/heal_probe.py --out heal_probe.json

It prints one JSON object (GB/s unless named ``_s``).
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import threading
import time

import torch

GIB = 1 << 30


def _gbps(nbytes: int, seconds: float) -> float:
    return nbytes / seconds / 1e9


def first_touch(nbytes: int) -> dict:
    t0 = time.perf_counter()
    buf = torch.empty(nbytes, dtype=torch.uint8)
    alloc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf.fill_(1)
    fresh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf.fill_(2)
    warm_s = time.perf_counter() - t0
    return dict(bytes=nbytes, alloc_s=alloc_s, fresh_gbps=_gbps(nbytes, fresh_s),
                warm_gbps=_gbps(nbytes, warm_s))


def first_touch_ways(nbytes: int, threads: int) -> dict:
    """A fresh buffer faulted in by ``threads`` threads at once, by an
    ``mmap`` with ``MAP_POPULATE``, and after ``madvise(MADV_HUGEPAGE)``."""
    import mmap

    out = {}
    buf = torch.empty(nbytes, dtype=torch.uint8)
    part = nbytes // threads
    workers = [threading.Thread(target=buf[i * part:(i + 1) * part].fill_, args=(1,))
               for i in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    out[f"threads_{threads}_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    del buf
    t0 = time.perf_counter()
    m = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE)
    out["map_populate_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    t = torch.frombuffer(m, dtype=torch.uint8)
    t0 = time.perf_counter()
    t.fill_(1)
    out["map_populate_then_write_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    del t
    m.close()
    m = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    m.madvise(mmap.MADV_HUGEPAGE)
    t = torch.frombuffer(m, dtype=torch.uint8)
    t0 = time.perf_counter()
    t.fill_(1)
    out["hugepage_advised_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    del t
    m.close()
    return out


def pinned_alloc(nbytes: int) -> dict:
    t0 = time.perf_counter()
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    fresh_s = time.perf_counter() - t0
    del buf
    t0 = time.perf_counter()
    buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    cached_s = time.perf_counter() - t0
    del buf
    return dict(bytes=nbytes, fresh_s=fresh_s, fresh_gbps=_gbps(nbytes, fresh_s),
                cached_s=cached_s)


def copies(nbytes: int, chunk: int) -> dict:
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda").fill_(3)
    torch.cuda.synchronize()
    out = {}
    t0 = time.perf_counter()
    host = dev.cpu()
    out["d2h_fresh_pageable_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    t0 = time.perf_counter()
    host.copy_(dev)
    out["d2h_touched_pageable_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(dev)
    t0 = time.perf_counter()
    pinned.copy_(dev)
    out["d2h_pinned_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    ring = [torch.empty(chunk, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    t0 = time.perf_counter()
    for i, off in enumerate(range(0, nbytes, chunk)):
        ring[i % 2].copy_(dev[off:off + chunk])
    out["d2h_pinned_chunks_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    out["chunk_bytes"] = chunk
    t0 = time.perf_counter()
    dev.copy_(host)
    torch.cuda.synchronize()
    out["h2d_pageable_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    t0 = time.perf_counter()
    dev.copy_(pinned)
    torch.cuda.synchronize()
    out["h2d_pinned_gbps"] = _gbps(nbytes, time.perf_counter() - t0)
    return out


def _tcp(nbytes: int, streams: int, fresh_dst: bool) -> float:
    """Seconds to move ``nbytes`` over ``streams`` loopback connections."""
    part = nbytes // streams
    src = torch.ones(part, dtype=torch.uint8).numpy()
    dsts = [None if fresh_dst else torch.zeros(part, dtype=torch.uint8).numpy()
            for _ in range(streams)]
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(streams)
    port = lsock.getsockname()[1]
    conns = []

    def _accept() -> None:
        for _ in range(streams):
            conns.append(lsock.accept()[0])

    acceptor = threading.Thread(target=_accept)
    acceptor.start()
    clients = [socket.create_connection(("127.0.0.1", port)) for _ in range(streams)]
    acceptor.join()

    def _send(sock: socket.socket) -> None:
        view = memoryview(src)
        for off in range(0, part, 1 << 20):
            sock.sendall(view[off:off + (1 << 20)])

    def _recv(sock: socket.socket, i: int) -> None:
        dst = dsts[i] if dsts[i] is not None else torch.empty(part, dtype=torch.uint8).numpy()
        view = memoryview(dst)
        off = 0
        while off < part:
            off += sock.recv_into(view[off:])

    threads = [threading.Thread(target=_send, args=(c,)) for c in clients]
    threads += [threading.Thread(target=_recv, args=(c, i)) for i, c in enumerate(conns)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    for c in clients + conns + [lsock]:
        c.close()
    return seconds


def tcp(nbytes: int) -> dict:
    out = {}
    for streams in (1, 2, 4, 8):
        out[f"touched_{streams}_gbps"] = _gbps(nbytes, _tcp(nbytes, streams, False))
    for streams in (1, 4, 8):
        out[f"fresh_{streams}_gbps"] = _gbps(nbytes, _tcp(nbytes, streams, True))
    out["bytes"] = nbytes
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("heal_probe: no CUDA device")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    result = dict(card=card, first_touch=first_touch(2 * GIB),
                  first_touch_ways=first_touch_ways(2 * GIB, 4), pinned_alloc=pinned_alloc(GIB),
                  pinned_alloc_64mib=pinned_alloc(64 << 20), copies=copies(GIB, 64 << 20),
                  tcp=tcp(2 * GIB))
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
