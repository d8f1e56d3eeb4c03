"""HTTP checkpoint transport: per-replica HTTP server streaming live weights.

Twin of the reference transport (``torchft/checkpointing/http_transport.py``):
every worker runs a threading HTTP server; ``metadata()`` is its URL; healing
peers fetch ``/checkpoint/{step}/full`` (or ``/checkpoint/{step}/{i}`` chunks
in parallel); the RWLock freezes the state dict while it is being serialized
so the train loop can't mutate weights mid-transfer
(``http_transport.py:181-202``).

Divergence from the reference: staging stores a serialization *plan* (the
tree skeleton + snapshots of the leaves), and each serving thread streams
its byte range to the socket while a copier thread brings the CUDA leaves
in it to the host through a ring of reused pinned buffers of the request's
own (``serialization.StagingRing``; the reference's incremental-save
analog, ``_serialization.py:14-39``).  Peak extra host RSS during a heal
send is a ring per request, not 1-2× the model or a leaf.  Tensors are
snapshotted on their device (``clone()``) at staging time, so the
optimizer's in-place update can't change them while a peer is still
fetching; a chunked or striped fetch lands each range in place in the
arrays of the received state (``serialization.StreamLanding``), which
arrive as CPU tensors for the caller to ``copy_`` into its live tensors.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import socket
import threading
import time
from collections import deque
from email.message import Message
from http.client import HTTPConnection
from io import BufferedWriter, RawIOBase
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple, TypeVar
from urllib.parse import urlsplit
from urllib.request import urlopen

from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing.serialization import (
    MAGIC,
    PytreePlan,
    StreamLanding,
    header_len_of,
    load_pytree,
    plan_pytree,
)
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport
from torchft_tpu_torch.obs.spans import span as obs_span
from torchft_tpu_torch.observability import HealMetrics

logger = logging.getLogger(__name__)

T = TypeVar("T")

# Per-request stall bound during a striped heal: a source that stops
# answering is declared dead after this long and its chunks are stolen by
# the surviving sources (the overall heal deadline still applies).
HEAL_SOURCE_TIMEOUT_ENV = "TORCHFT_HEAL_SOURCE_TIMEOUT_S"


def _heal_source_timeout(overall: float) -> float:
    raw = os.environ.get(HEAL_SOURCE_TIMEOUT_ENV)
    per_source = float(raw) if raw else 30.0
    return max(0.1, min(per_source, overall))


class _RawSocketWriter(RawIOBase):
    """Adapts the handler's socket file to io.BufferedWriter."""

    def __init__(self, wfile) -> None:
        super().__init__()
        self._wfile = wfile

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        # honor the RawIOBase short-write contract: BufferedWriter retries
        # any remainder only if we report what was actually written
        return self._wfile.write(b)


class _ChaosWriter(RawIOBase):
    """Serving-path fault injector: counts bytes served across the whole
    transport and, when the armed hook trips, kills the server (the chaos
    drill's "heal source dies mid-transfer") and aborts this response."""

    def __init__(self, inner: RawIOBase, transport: "HTTPTransport") -> None:
        super().__init__()
        self._inner = inner
        self._transport = transport

    def writable(self) -> bool:
        return True

    def write(self, b) -> int:
        transport = self._transport
        hook = transport.chaos_serve_hook
        with transport._bytes_served_lock:
            transport._bytes_served += len(b)
            served = transport._bytes_served
        if hook is not None and hook(served):
            # shut down off-thread: shutdown() joins the serve loop, and this
            # handler must die NOW with a torn connection, mid-payload
            threading.Thread(
                target=transport.shutdown, name="tpuft_chaos_kill", daemon=True
            ).start()
            raise ConnectionError("chaos: heal source killed mid-transfer")
        return self._inner.write(b)


def _fetch_header(base: str, timeout: float) -> Tuple[bytes, Message]:
    """The stream's header from the server at ``base`` (its first
    ``len(MAGIC) + 4`` bytes give its length, then the rest), and the
    headers of the first response."""
    prefix = len(MAGIC) + 4
    with urlopen(f"{base}/range/0/{prefix}", timeout=timeout) as resp:
        headers = resp.headers
        head = resp.read()
    with urlopen(f"{base}/range/{prefix}/{header_len_of(head)}", timeout=timeout) as resp:
        return head + resp.read(), headers


def _take_chunks(chunks: deque, workers: int) -> List[Tuple[int, int]]:
    """Consecutive chunks off the front of a striped heal's queue, fetched
    as one range: a ``1 / (2 * workers)`` share of what is left (guided
    self-scheduling), so a heal makes few requests (each costs the
    interpreter a request's parse on both ends) and its streams still end
    together on the last single chunks."""
    want = max(1, len(chunks) // (2 * workers))
    jobs = [chunks.popleft()] if chunks else []
    while chunks and len(jobs) < want and chunks[0][0] == jobs[-1][1]:
        jobs.append(chunks.popleft())
    return jobs


def _landing(header: bytes, total_len: int) -> StreamLanding:
    """A :class:`StreamLanding` for ``header``, which must describe the
    ``total_len`` bytes the server says it serves."""
    landing = StreamLanding(header)
    if landing.total_len != total_len:
        raise ValueError(f"checkpoint header describes {landing.total_len} bytes, the "
                         f"server serves {total_len}")
    return landing


# the Manager's HTTPTransport serves its state in this many chunks and a
# healer fetches them over as many parallel connections: one loopback
# stream into fresh host memory ran at 1.24 GB/s, four at 2.31 (H100 80GB
# HBM3 host, 700.00 W; scripts/heal_probe.py), and a JAX-package server
# (num_chunks 0) is fetched as its one chunk
HEAL_NUM_CHUNKS = 4


class HTTPTransport(CheckpointTransport[T]):
    """Serve/fetch live checkpoints over HTTP.

    Args:
        timeout: default deadline for fetches.
        num_chunks: >0 splits the serialized state into N byte-ranges fetched
            by parallel threads (``http_transport.py:219-241``); 0 streams
            one ``full`` payload.
    """

    def __init__(
        self,
        timeout: float = 60.0,
        num_chunks: int = 0,
        heal_chunk_bytes: Optional[int] = None,
    ) -> None:
        self._timeout = timeout
        self._num_chunks = num_chunks
        self._heal_chunk_bytes = heal_chunk_bytes
        self._lock = RWLock(timeout=timeout)
        self._staged: Optional[Dict[str, object]] = None  # step, chunks
        self._allowed = threading.Event()
        # striped-heal bookkeeping: metrics of the most recent striped recv,
        # and a chaos hook (``chaos.arm_heal_source_kill``) that can make
        # this source die mid-serve to drill mid-heal failover
        self.last_heal_metrics: Optional[HealMetrics] = None
        self.chaos_serve_hook: Optional[Callable[[int], bool]] = None
        # count only striped (range) serving toward the chaos trip wire:
        # killing a single-source /full transfer has no survivor to fail
        # over to, which tests a different (fatal) scenario
        self.chaos_striped_only = False
        self._bytes_served = 0
        self._bytes_served_lock = threading.Lock()

        transport = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # a response's headers and its short body or tail would
            # otherwise wait on Nagle for the healer's delayed ACK (~40 ms a
            # small request on loopback: the index, the header's ranges)
            disable_nagle_algorithm = True

            def log_message(self, fmt: str, *args: object) -> None:
                logger.debug("http_transport: " + fmt, *args)

            def do_GET(self) -> None:
                parts = [p for p in self.path.split("/") if p]
                # /checkpoint/{step}/{full|index|i} or
                # /checkpoint/{step}/range/{start}/{stop}
                if (
                    len(parts) not in (3, 5)
                    or parts[0] != "checkpoint"
                    or (len(parts) == 5 and parts[2] != "range")
                ):
                    self.send_error(404, "unknown path")
                    return
                # Wait for a checkpoint to be staged rather than 404ing a
                # peer that raced ahead (the quorum guarantees it's coming).
                if not transport._allowed.wait(timeout=transport._timeout):
                    self.send_error(503, "no checkpoint staged")
                    return
                # the lock is only held to grab the plan reference — the
                # plan's leaves are self-contained snapshots, so streaming
                # happens lock-free and a concurrent disallow_checkpoint
                # (write lock, taken in the commit path) never waits on a
                # slow healer's socket
                with transport._lock.r_lock():
                    staged = transport._staged
                    plan: Optional[PytreePlan] = (
                        staged["plan"] if staged is not None else None  # type: ignore[assignment,index]
                    )
                    staged_step = staged["step"] if staged is not None else None
                if plan is None:
                    self.send_error(503, "no checkpoint staged")
                    return
                step = int(parts[1])
                if staged_step != step:
                    self.send_error(
                        404,
                        f"staged step {staged_step} != requested {step}",
                    )
                    return
                if parts[2] == "index":
                    # chunk-addressable index for striped healers: stable
                    # boundaries at array-payload granularity, identical on
                    # every peer serving the same step
                    body = json.dumps(
                        {
                            "total_len": plan.total_len,
                            "header_digest": plan.header_digest(),
                            "chunks": plan.chunk_ranges(
                                transport._heal_chunk_bytes
                            ),
                        }
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.send_header("X-Total-Len", str(plan.total_len))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                num_chunks = max(1, transport._num_chunks)
                chunk_size = -(-plan.total_len // num_chunks)
                if parts[2] == "range":
                    start, stop = int(parts[3]), int(parts[4])
                    if not 0 <= start <= stop <= plan.total_len:
                        self.send_error(
                            416, f"bad range [{start}, {stop}) of {plan.total_len}"
                        )
                        return
                elif parts[2] == "full":
                    start, stop = 0, plan.total_len
                else:
                    idx = int(parts[2])
                    if idx >= num_chunks:
                        self.send_error(404, f"no chunk {idx}")
                        return
                    start = idx * chunk_size
                    stop = min(plan.total_len, start + chunk_size)
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(stop - start))
                self.send_header("X-Num-Chunks", str(num_chunks))
                self.send_header("X-Total-Len", str(plan.total_len))
                self.send_header("X-Header-Digest", plan.header_digest())
                self.end_headers()
                # streams leaf by leaf: only leaves overlapping [start, stop)
                # are ever materialized on host.  The handler's wfile is an
                # unbuffered socket writer; batching the plan's small frame
                # headers with the payloads into 1 MB writes avoids
                # per-frame syscalls
                raw = _RawSocketWriter(self.wfile)
                if transport.chaos_serve_hook is not None and (
                    not transport.chaos_striped_only or parts[2] == "range"
                ):
                    raw = _ChaosWriter(raw, transport)
                buffered = BufferedWriter(raw, buffer_size=1 << 20)
                plan.write_range(start, stop, buffered)
                buffered.flush()

        class _Server(ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        # dual-stack like the reference's checkpoint server
        # (torchft/http.py:11-13): bind [::] with v6only off where the
        # kernel allows, so v4 and v6 healers both reach us
        v6_server = None
        try:
            _Server.address_family = socket.AF_INET6
            v6_server = _Server(("::", 0), _Handler, bind_and_activate=False)
            v6_server.socket.setsockopt(
                socket.IPPROTO_IPV6, socket.IPV6_V6ONLY, 0
            )
            v6_server.server_bind()
            v6_server.server_activate()
            self._server = v6_server
        except OSError:
            if v6_server is not None:
                v6_server.server_close()
            _Server.address_family = socket.AF_INET
            self._server = _Server(("0.0.0.0", 0), _Handler)
        self._port: int = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="tpuft_http_transport",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._port

    def metadata(self) -> str:
        return f"http://{socket.gethostname()}:{self._port}"

    def send_checkpoint(
        self, dst_ranks: List[int], step: int, state_dict: T, timeout: float
    ) -> None:
        """Stage a streaming plan under the write lock; serving threads
        materialize leaves lazily (bytes are generated per-request, never
        staged)."""
        plan = plan_pytree(state_dict, snapshot=True)
        with self._lock.w_lock(timeout=timeout):
            self._staged = {"step": step, "plan": plan}
        self._allowed.set()

    def disallow_checkpoint(self) -> None:
        self._allowed.clear()
        with self._lock.w_lock():
            self._staged = None

    def recv_checkpoint(
        self,
        src_rank: int,
        metadata: str,
        step: int,
        timeout: float,
        leaf_hook=None,
    ) -> T:
        """Fetch and deserialize a peer's live checkpoint.

        With num_chunks=0 it streams ``/full``: array payloads are read
        straight off the socket into preallocated arrays, and ``leaf_hook``
        (e.g. a ``copy_`` into the healing replica's live tensor) maps
        each leaf on arrival so its host copy dies immediately.  With
        num_chunks > 0 (the Manager's :data:`HEAL_NUM_CHUNKS`) the server's
        chunks are fetched in parallel, each straight into the arrays, and
        ``leaf_hook`` maps the leaves once all have landed."""
        base = f"{metadata}/checkpoint/{step}"
        t0 = time.monotonic()
        if self._num_chunks == 0:
            with urlopen(f"{base}/full", timeout=timeout) as resp:
                state = load_pytree(resp, leaf_hook=leaf_hook)
                self._single_source_metrics(step, metadata, int(resp.headers["X-Total-Len"]), t0)
                return state  # type: ignore[return-value]

        # chunked mode: the header first (its first bytes give its length),
        # then the server's chunks fetched in parallel, each landing in
        # place in the state's arrays (serialization.StreamLanding)
        header, headers = _fetch_header(base, timeout)
        num_chunks = int(headers.get("X-Num-Chunks", "1"))
        total_len = int(headers["X-Total-Len"])
        landing = _landing(header, total_len)
        chunk_size = -(-total_len // max(1, num_chunks))
        done = [False] * num_chunks
        errors: List[BaseException] = []

        def _fetch(i: int) -> None:
            try:
                # the server cuts its chunks so; where they outnumber the
                # stream's bytes, the last ones start past its end and are
                # empty, as the reference's slice of its buffer is
                start = min(total_len, i * chunk_size)
                stop = min(total_len, start + chunk_size)
                with urlopen(f"{base}/{i}", timeout=timeout) as r, obs_span("heal::recv_read"):
                    landing.read_range(r, start, stop)
                done[i] = True
            except BaseException as e:  # noqa: BLE001 — re-raised on the caller
                errors.append(e)

        threads = [
            threading.Thread(target=_fetch, args=(i,), name=f"tpuft_heal_fetch_{i}", daemon=True)
            for i in range(num_chunks)
        ]
        deadline = time.monotonic() + timeout
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if errors:
            # a real fetch failure (404/refused) must not masquerade as a
            # timeout
            raise errors[0]
        if not all(done):
            raise TimeoutError("chunked checkpoint fetch timed out")
        state = landing.finish(leaf_hook)
        self._single_source_metrics(step, metadata, total_len, t0)
        return state  # type: ignore[return-value]

    def _single_source_metrics(self, step: int, source: str, nbytes: int, t0: float) -> None:
        """``last_heal_metrics`` of a heal from one source (the striped
        path fills its own)."""
        self.last_heal_metrics = HealMetrics(
            step=step,
            num_sources=1,
            bytes_total=nbytes,
            duration_s=time.monotonic() - t0,
            per_source_bytes={source: nbytes},
        )

    def recv_checkpoint_striped(
        self,
        sources: List[Tuple[int, Optional[str]]],
        step: int,
        timeout: float,
        leaf_hook=None,
    ) -> T:
        """Striped multi-source heal: fetch disjoint chunk ranges of the
        serialized checkpoint from every source concurrently, each landing in
        place in the state's arrays (``serialization.StreamLanding``, as the
        chunked single-source heal does): no buffer of the whole stream and
        no second parse.

        The chunk index and the header come from the first source that
        answers both.  Workers, each on one kept-alive connection to its
        source, the same number a source and at least ``HEAL_NUM_CHUNKS``
        in all, then take shares of consecutive chunks off a shared queue,
        one range request a share (:func:`_take_chunks`; natural work
        stealing: a fast source simply takes more shares).  A source that
        errors or stalls past the per-request bound is declared dead, its
        workers stop, each in-flight share of it is requeued whole for the
        survivors (which rewrite the whole range), and the heal degrades all
        the way down to today's single-peer transfer before failing."""
        live = [(rank, meta) for rank, meta in sources if meta]
        if len(live) <= 1:
            return super().recv_checkpoint_striped(
                sources, step, timeout, leaf_hook=leaf_hook
            )

        deadline = time.monotonic() + timeout
        per_req_timeout = _heal_source_timeout(timeout)
        t0 = time.monotonic()

        index: Optional[dict] = None
        landing: Optional[StreamLanding] = None
        failed: List[str] = []
        for rank, meta in list(live):
            try:
                base = f"{meta}/checkpoint/{step}"
                with urlopen(f"{base}/index", timeout=per_req_timeout) as resp:
                    index = json.loads(resp.read())
                header, _ = _fetch_header(base, per_req_timeout)
                digest = index.get("header_digest")
                if digest and hashlib.sha256(header).hexdigest() != digest:
                    raise ValueError(f"source {meta} serves a header that is not its index's")
                landing = _landing(header, int(index["total_len"]))
                break
            except Exception as e:  # noqa: BLE001 — source-level failover
                logger.warning("striped heal: index or header fetch from %s failed: %s", meta, e)
                failed.append(meta)
                live.remove((rank, meta))
        if index is None or landing is None:
            raise ConnectionError(
                f"striped heal: no source answered the chunk index and header ({failed})"
            )

        total_len = landing.total_len
        chunks: deque = deque(tuple(c) for c in index["chunks"])
        num_chunks = len(chunks)

        lock = threading.Lock()
        state = {"done": 0, "stolen": 0}
        per_source_bytes: Dict[str, int] = {meta: 0 for _, meta in live}
        errors: List[BaseException] = []
        dead: set = set()
        # at least as many streams as a chunked heal opens (HEAL_NUM_CHUNKS),
        # the same number from each source
        streams = [meta for _, meta in live] * -(-HEAL_NUM_CHUNKS // len(live))

        def _worker(meta: str) -> None:
            # one kept-alive connection a worker: a range is a request on it,
            # not a new connection and a new serving thread
            url = urlsplit(meta)
            path = f"{url.path}/checkpoint/{step}/range"
            conn: Optional[HTTPConnection] = None
            try:
                while True:
                    with lock:
                        if state["done"] >= num_chunks or meta in dead:
                            return
                        jobs = _take_chunks(chunks, len(streams))
                    if not jobs:
                        # the remaining chunk(s) are in flight on ANOTHER
                        # worker — whose source may yet die and requeue
                        # them; staying available is what makes "survives
                        # losing P-1 sources" true for the last chunk too
                        if time.monotonic() > deadline:
                            return
                        time.sleep(0.02)
                        continue
                    start, stop = jobs[0][0], jobs[-1][1]
                    try:
                        if time.monotonic() > deadline:
                            raise TimeoutError("striped heal deadline exceeded")
                        if conn is None:
                            conn = HTTPConnection(url.hostname, url.port, timeout=per_req_timeout)
                        conn.request("GET", f"{path}/{start}/{stop}")
                        r = conn.getresponse()
                        if r.status != 200:
                            raise ConnectionError(f"source {meta} answered {r.status} {r.reason}")
                        if int(r.headers["X-Total-Len"]) != total_len:
                            raise ValueError(
                                f"source {meta} serves a different checkpoint "
                                f"({r.headers['X-Total-Len']} != {total_len} bytes)"
                            )
                        if digest and r.headers.get("X-Header-Digest") not in (
                            None,
                            digest,
                        ):
                            raise ValueError(
                                f"source {meta} skeleton digest mismatch"
                            )
                        with obs_span("heal::recv_read"):
                            landing.read_range(r, start, stop)
                        with lock:
                            state["done"] += len(jobs)
                            per_source_bytes[meta] += stop - start
                    except BaseException as e:  # noqa: BLE001 — reassign + record
                        with lock:
                            chunks.extendleft(reversed(jobs))
                            state["stolen"] += len(jobs)
                            if meta not in dead:
                                dead.add(meta)
                                failed.append(meta)
                            errors.append(e)
                        logger.warning(
                            "striped heal: source %s died mid-heal (%s); "
                            "reassigning its chunks",
                            meta,
                            e,
                        )
                        return
            finally:
                if conn is not None:
                    conn.close()

        threads = [
            threading.Thread(
                target=_worker, args=(meta,), name=f"tpuft_heal_{i}", daemon=True
            )
            for i, meta in enumerate(streams)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        if state["done"] != num_chunks:
            if errors:
                raise errors[0]
            raise TimeoutError(
                f"striped heal fetched {state['done']}/{num_chunks} chunks "
                f"before the deadline"
            )

        out = landing.finish(leaf_hook)
        self.last_heal_metrics = HealMetrics(
            step=step,
            num_sources=len(sources),
            bytes_total=total_len,
            duration_s=time.monotonic() - t0,
            per_source_bytes={
                m: n for m, n in per_source_bytes.items() if n
            },
            failed_sources=failed,
            stolen_chunks=state["stolen"],
        )
        return out  # type: ignore[return-value]

    def shutdown(self, wait: bool = True) -> None:
        self._server.shutdown()
        self._server.server_close()
