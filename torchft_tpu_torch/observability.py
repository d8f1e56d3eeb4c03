"""Observability: structured event logs + per-quorum profiler traces.

Reference analogs:

- ``torchft/otel.py``: opt-in structured loggers ``torchft_quorums`` /
  ``torchft_commits`` / ``torchft_errors`` with job/replica/rank/quorum/step
  attributes, exported over OTLP.  The Manager already emits to those logger
  names; this module attaches exporters.  OTLP is used when the
  ``opentelemetry`` SDK is importable; otherwise events are emitted as JSON
  lines (console or ``TORCHFT_LOG_DIR`` files) — same schema, greppable.
- ``torch.profiler.record_function`` spans on every protocol phase
  (``manager.py:410`` etc.) → :func:`record_function`, the same
  ``torch.profiler`` range.
- Per-quorum NCCL flight-recorder dirs (``manager.py:815-824``) →
  :class:`QuorumTracer`: with ``TORCHFT_TRACE_DIR`` set, each quorum epoch
  gets its own ``torch.profiler`` trace directory ``quorum_{id}/``, so the
  post-mortem for a failed epoch is isolated exactly like an FR dump.

Everything is opt-in via env (``TORCHFT_USE_OTEL``, ``TORCHFT_LOG_DIR``,
``TORCHFT_TRACE_DIR``); the default is zero overhead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import sys
import threading
import time
from typing import Iterator, Optional

USE_OTEL_ENV = "TORCHFT_USE_OTEL"
LOG_DIR_ENV = "TORCHFT_LOG_DIR"
TRACE_DIR_ENV = "TORCHFT_TRACE_DIR"

STRUCTURED_LOGGERS = (
    "torchft_quorums",
    "torchft_commits",
    "torchft_errors",
    "torchft_heals",
    # flight-recorder dump announcements (obs/flight.py): one record per
    # dump with the trigger reason, event counts and the artifact path
    "torchft_flight",
)

_ATTR_KEYS = (
    "job_id",
    "replica_id",
    "rank",
    "quorum_id",
    "step",
    "commit_result",
    "error",
    # data-plane lane counters (torchft_quorums; per-epoch, from
    # Communicator.lane_stats() at quorum change — multi-lane ring striping)
    "comm_lanes",
    "comm_lane_tx_bytes",
    "comm_lane_rx_bytes",
    "comm_lane_stalls",
    # gray-failure counters (torchft_quorums; in-epoch lane recovery +
    # fault injection of the outgoing epoch)
    "comm_lane_reconnects",
    "comm_lane_failovers",
    "comm_injected_faults",
    # hierarchical-topology counters (torchft_quorums; host grouping +
    # shared-memory transport bytes of the outgoing epoch)
    "comm_topo_hosts",
    "comm_topo_local_world",
    "comm_shm_bytes",
    # sharded-outer-sync pipeline timings (torchft_quorums; most recent
    # DiLoCo sharded sync of the outgoing epoch — scatter/update/gather
    # wall shares and how much of the outer update the pipeline hid)
    "outer_shard_scatter_s",
    "outer_shard_update_s",
    "outer_shard_gather_s",
    "outer_shard_wall_s",
    "outer_shard_overlap_ratio",
    # coordination-plane counters (torchft_quorums; how this replica's
    # heartbeats routed — zone aggregator vs direct lighthouse — and how
    # often it fell back on aggregator death)
    "coord_beats_via_agg",
    "coord_beats_direct",
    "coord_agg_fallbacks",
    # heal-path counters (torchft_heals; striped checkpoint recovery)
    "heal_bytes",
    "heal_duration_s",
    "heal_bytes_per_sec",
    "heal_num_sources",
    "heal_failed_sources",
    "heal_stolen_chunks",
    "heal_per_source_bytes",
    # flight-recorder dump facts (torchft_flight; obs/flight.py dump())
    "flight_reason",
    "flight_events",
    "flight_native_events",
    "flight_path",
)

_initialized = False
_init_lock = threading.Lock()


class _JsonLinesFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        event = {
            "ts": round(time.time(), 3),
            "event": record.name,
        }
        for key in _ATTR_KEYS:
            if hasattr(record, key):
                event[key] = getattr(record, key)
        return json.dumps(event)


def init_structured_logging(force: bool = False) -> bool:
    """Attach exporters to the structured loggers (idempotent).

    Returns True when exporters were attached (env opted in or ``force``).
    """
    global _initialized
    with _init_lock:
        if _initialized:
            return True
        opted_in = force or os.environ.get(USE_OTEL_ENV, "").lower() in (
            "1",
            "true",
        ) or bool(os.environ.get(LOG_DIR_ENV))
        if not opted_in:
            return False

        handlers: list[logging.Handler] = []
        log_dir = os.environ.get(LOG_DIR_ENV)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

        try:  # OTLP when the SDK exists (not baked into this environment)
            from opentelemetry._logs import set_logger_provider  # type: ignore[import-not-found]
            from opentelemetry.exporter.otlp.proto.grpc._log_exporter import (  # type: ignore[import-not-found]
                OTLPLogExporter,
            )
            from opentelemetry.sdk._logs import (  # type: ignore[import-not-found]
                LoggerProvider,
                LoggingHandler,
            )
            from opentelemetry.sdk._logs.export import (  # type: ignore[import-not-found]
                BatchLogRecordProcessor,
            )

            provider = LoggerProvider()
            provider.add_log_record_processor(
                BatchLogRecordProcessor(OTLPLogExporter())
            )
            set_logger_provider(provider)
            handlers.append(LoggingHandler(logger_provider=provider))
        except ImportError:
            pass

        for name in STRUCTURED_LOGGERS:
            logger = logging.getLogger(name)
            logger.setLevel(logging.INFO)
            logger.propagate = False
            if log_dir:
                fh = logging.FileHandler(os.path.join(log_dir, f"{name}.jsonl"))
                fh.setFormatter(_JsonLinesFormatter())
                logger.addHandler(fh)
            else:
                sh = logging.StreamHandler(sys.stderr)
                sh.setFormatter(_JsonLinesFormatter())
                logger.addHandler(sh)
            for h in handlers:
                logger.addHandler(h)
        _initialized = True
        return True


@dataclasses.dataclass
class HealMetrics:
    """Throughput/latency facts of one checkpoint heal, filled by the
    transport (``last_heal_metrics``) and logged by the manager to the
    ``torchft_heals`` structured logger.

    ``per_source_bytes`` is keyed by source id (replica rank or metadata
    URL); ``failed_sources`` lists sources that died or errored mid-heal;
    ``stolen_chunks`` counts chunk reassignments to a surviving source."""

    step: int = 0
    num_sources: int = 1
    bytes_total: int = 0
    duration_s: float = 0.0
    per_source_bytes: dict = dataclasses.field(default_factory=dict)
    failed_sources: list = dataclasses.field(default_factory=list)
    stolen_chunks: int = 0

    @property
    def bytes_per_sec(self) -> float:
        return self.bytes_total / self.duration_s if self.duration_s > 0 else 0.0

    def as_log_extra(self) -> dict:
        return {
            "step": self.step,
            "heal_bytes": self.bytes_total,
            "heal_duration_s": round(self.duration_s, 4),
            "heal_bytes_per_sec": round(self.bytes_per_sec, 1),
            "heal_num_sources": self.num_sources,
            "heal_failed_sources": list(self.failed_sources),
            "heal_stolen_chunks": self.stolen_chunks,
            "heal_per_source_bytes": dict(self.per_source_bytes),
        }


def log_heal(
    metrics: HealMetrics,
    replica_id: str = "",
    rank: int = 0,
    quorum_id: int = -1,
) -> None:
    """Emit one heal record to ``torchft_heals`` (JSON lines / OTLP when
    structured logging is opted in; free otherwise)."""
    extra = metrics.as_log_extra()
    extra.update(
        job_id=os.environ.get("JOB_ID", "unknown"),
        replica_id=replica_id,
        rank=rank,
        quorum_id=quorum_id,
    )
    logging.getLogger("torchft_heals").info("", extra=extra)


def traced(name: str):
    """Decorator form of :func:`record_function` for whole protocol verbs."""

    def _wrap(fn):
        import functools

        @functools.wraps(fn)
        def _inner(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)

        return _inner

    return _wrap


@contextlib.contextmanager
def record_function(name: str) -> Iterator[None]:
    """Protocol-phase span: shows up in ``torch.profiler`` traces as a named
    ``record_function`` range; near free when no trace is being captured."""
    import torch.profiler

    with torch.profiler.record_function(name):
        yield


class QuorumTracer:
    """Per-quorum-epoch ``torch.profiler`` traces (flight-recorder analog).

    With ``TORCHFT_TRACE_DIR`` set, call ``on_quorum_change(quorum_id)`` from
    the manager at each reconfiguration: the previous epoch's profile is
    stopped and exported as a Chrome trace under ``{dir}/quorum_{id}``, and
    a fresh one starts for the new epoch.
    """

    def __init__(self, base_dir: Optional[str] = None) -> None:
        self._base_dir = base_dir or os.environ.get(TRACE_DIR_ENV)
        self._prof = None
        self._path = ""
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self._base_dir)

    def _stop_locked(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(os.path.join(self._path, "trace.json"))

    def on_quorum_change(self, quorum_id: int) -> None:
        if not self.enabled:
            return
        import torch
        import torch.profiler

        with self._lock:
            self._stop_locked()
            self._path = os.path.join(self._base_dir, f"quorum_{quorum_id}")
            os.makedirs(self._path, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def stop(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._stop_locked()
