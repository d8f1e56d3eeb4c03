"""Unified observability plane: flight recorder, trace spans, /metrics.

Three pillars riding one event substrate (see ``docs/operations.md`` §17):

- :mod:`.flight` — a lock-cheap per-replica ring of typed, monotonic-
  stamped events keyed by ``(step, quorum_id, comm_epoch)``, dumped on
  comm-epoch poison, the Manager error funnel, SIGUSR2, and atexit; the
  native tier's C-side ring merges in via ``tpuft_comm_flight_drain``.
- :mod:`.spans` — context-manager trace spans nested under the step,
  exported as Chrome trace-event JSON; ``scripts/flight_merge.py`` aligns
  multiple replicas into one Perfetto-loadable fleet timeline.
- :mod:`.metrics` — the central metric-name registry behind the
  Prometheus-text ``/metrics`` endpoints on the lighthouse (TTL-cached
  snapshot, zero new lock traffic) and every ManagerServer.
"""

from torchft_tpu_torch.obs.flight import (  # noqa: F401
    FlightEvent,
    FlightRecorder,
    default_recorder,
    dump_all,
    flight_dir,
)
from torchft_tpu_torch.obs.metrics import (  # noqa: F401
    REGISTRY as METRICS_REGISTRY,
    metric_sample,
    parse_prometheus_text,
    render as render_metrics,
)
from torchft_tpu_torch.obs.spans import (  # noqa: F401
    export_chrome_trace,
    span,
    spans_enabled,
)
