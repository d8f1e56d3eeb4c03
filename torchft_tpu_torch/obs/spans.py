"""Per-step trace spans with Chrome trace-event export.

A span is a named wall-clock window recorded into a process-global bounded
buffer; nested calls on one thread render as a flame because Chrome's
``"X"`` (complete) events nest by ``(tid, ts, dur)`` containment — no
parent bookkeeping needed.  The instrumented protocol tree::

    step
    └─ quorum_rpc            (manager._async_quorum)
       └─ comm_configure     (manager._adopt_quorum)
    └─ comm_op               (communicator op thread, one per collective)
       └─ lane_window        (striped exchange: one per lane part batch)
    └─ outer_shard_chunk     (collectives.outer_sharded_sync pipeline)
    └─ heal_send / heal_recv (checkpoint transfers)

Spans are OFF by default (``TORCHFT_FLIGHT_SPANS=1`` opts in; the bench's
``obs_overhead_frac`` gate measures recorder+spans enabled at <= 1% step
time).  When disabled, :func:`span` returns a shared no-op context manager
— one truthiness check on the hot path.

Export: :func:`export_chrome_trace` writes ``{"traceEvents": [...]}`` JSON
loadable in Perfetto / chrome://tracing; ``scripts/flight_merge.py`` merges
several replicas' span files and flight dumps into one fleet timeline.

The buffer is process-global (thread-plane drills mix their replicas'
spans onto distinct tids, which is exactly what a one-process fleet is);
per-replica separation comes from one process per replica in production.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import collections

from torchft_tpu_torch import knobs

SPANS_ENV = "TORCHFT_FLIGHT_SPANS"

# None = resolve from env on first use; configure() pins it for the process
_enabled: Optional[bool] = None
_spans: "collections.deque" = collections.deque(maxlen=8192)
_lock = threading.Lock()


def spans_enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = knobs.get_bool(SPANS_ENV, False)
    return _enabled


def configure(enabled: Optional[bool], cap: Optional[int] = None) -> None:
    """Pin span collection on/off for the process (``None`` re-reads the
    env on next use).  ``cap`` resizes the buffer (drops collected spans)."""
    global _enabled, _spans
    _enabled = enabled
    if cap is not None:
        with _lock:
            _spans = collections.deque(maxlen=max(1, cap))


def clear() -> None:
    with _lock:
        _spans.clear()


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> None:
        return None


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]) -> None:
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0

    def __enter__(self) -> "_Span":
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc: object) -> None:
        t1 = time.monotonic()
        _spans.append(  # deque append: GIL-atomic, no lock on the hot path
            (self.name, self.t0, t1 - self.t0, threading.get_ident(), self.attrs)
        )


def span(name: str, **attrs: Any):
    """Context manager recording one named wall-clock window.  Free (a
    shared no-op object) when spans are disabled."""
    if not spans_enabled():
        return _NULL
    return _Span(name, attrs or None)


def device_fence(device: Any) -> Callable[[], float]:
    """A clock for phase splits on ``device`` (a ``torch.device``): each
    call waits for the work queued on a CUDA device, then returns
    ``time.perf_counter()``, so a window's wall time covers its kernels."""

    def fence() -> float:
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        return time.perf_counter()

    return fence


def snapshot() -> List[Dict[str, Any]]:
    """Collected spans as dicts, oldest first (non-destructive)."""
    out = []
    for name, t0, dur, tid, attrs in list(_spans):
        rec: Dict[str, Any] = {
            "name": name,
            "t": round(t0, 6),
            "dur": round(dur, 6),
            "tid": tid,
        }
        if attrs:
            rec["attrs"] = attrs
        out.append(rec)
    return out


# the heal's spans (manager::heal_send / heal_recv / heal_apply and the
# transports' heal::*), which a worker process reports as totals
HEAL_PREFIXES = ("manager::heal_", "heal::")
# the buffer of a worker process that records spans: room for a few steps'
# collectives after its heal
WORKER_CAP = 1 << 18


def totals(prefixes: Tuple[str, ...] = ()) -> Dict[str, float]:
    """Seconds summed per span name over the collected spans (summed over
    threads), those whose name starts with one of ``prefixes`` if given."""
    out: Dict[str, float] = {}
    for name, _t0, dur, _tid, _attrs in list(_spans):
        if not prefixes or name.startswith(prefixes):
            out[name] = out.get(name, 0.0) + dur
    return out


def export_chrome_trace(path: str, replica_id: str = "") -> int:
    """Write the collected spans as Chrome trace-event JSON (``"X"``
    complete events, microsecond units) at ``path``.  Returns the span
    count.  The file is Perfetto-loadable standalone; the fleet view comes
    from ``scripts/flight_merge.py``."""
    events: List[Dict[str, Any]] = []
    pid = abs(hash(replica_id)) % 100000 if replica_id else 1
    if replica_id:
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": replica_id},
            }
        )
    spans = snapshot()
    for rec in spans:
        event = {
            "name": rec["name"],
            "ph": "X",
            "ts": round(rec["t"] * 1e6, 1),
            "dur": round(rec["dur"] * 1e6, 1),
            "pid": pid,
            "tid": rec["tid"],
        }
        if "attrs" in rec:
            event["args"] = rec["attrs"]
        events.append(event)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(spans)
