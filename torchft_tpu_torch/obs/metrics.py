"""Central metric-name registry + Prometheus text-format rendering.

Every name served on a ``/metrics`` endpoint (the lighthouse's and every
ManagerServer's) is declared here EXACTLY ONCE — the port's ftlint
(``python -m torchft_tpu_torch.analysis``) ``metrics-registry`` checker
enforces that each declared name is legal
Prometheus (``[a-z_:][a-z0-9_:]*``, counters end in ``_total``), unique,
documented in ``docs/torch_operations.md`` §2, and that every
``metric_sample("...")`` call site in the package names a declared metric.
:func:`metric_sample` also enforces it at runtime, so an undeclared name
can never reach a scrape.

Naming: ``torchft_lh_*`` = lighthouse (fleet view, served from the
TTL-cached status snapshot — zero new lock traffic), ``torchft_mgr_*`` =
per-replica ManagerServer gauges (the same registry that feeds
``last_quorum_timings``).

:func:`parse_prometheus_text` is the strict parser the CI scrape smoke
test runs against both endpoints.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

_NAME_RE = re.compile(r"^[a-z_:][a-z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


@dataclass(frozen=True)
class Metric:
    name: str
    kind: str  # "gauge" | "counter"
    doc: str


REGISTRY: Dict[str, Metric] = {}


def _m(name: str, kind: str, doc: str) -> None:
    if name in REGISTRY:
        raise ValueError(f"duplicate metric declaration: {name}")
    if not _NAME_RE.match(name):
        raise ValueError(f"illegal Prometheus metric name: {name}")
    if kind not in ("gauge", "counter"):
        raise ValueError(f"unknown metric kind {kind!r} for {name}")
    if kind == "counter" and not name.endswith("_total"):
        raise ValueError(f"counter {name} must end in _total")
    REGISTRY[name] = Metric(name=name, kind=kind, doc=doc)


# --- lighthouse (fleet view; served from the TTL-cached /status snapshot) ---
_m("torchft_lh_quorum_id", "gauge", "Current quorum id (bumps on membership change / commit failure)")
_m("torchft_lh_max_step", "gauge", "Commit front: max step across the previous quorum's participants")
_m("torchft_lh_participants", "gauge", "Participants in the previous quorum")
_m("torchft_lh_heartbeating", "gauge", "Replicas with a registered heartbeat (actives + spares)")
_m("torchft_lh_spares", "gauge", "Registered hot spares (never counted toward membership)")
_m("torchft_lh_lagging_replicas", "gauge", "Participants behind the commit front (will heal next quorum)")
_m("torchft_lh_heal_sources", "gauge", "Up-to-date participants able to serve a striped heal")
_m("torchft_lh_promotions_total", "counter", "Spare promotions issued by the lighthouse")
_m("torchft_lh_evictions_total", "counter", "Straggler (slow-NIC) evictions issued")
_m("torchft_lh_degraded_evictions_total", "counter", "Evictions of replicas wounded below the capacity floor")
_m("torchft_lh_swaps_total", "counter", "Wounded-replica-for-warm-spare swaps issued")
_m("torchft_lh_status_rebuilds_total", "counter", "Status/metrics snapshot rebuilds (state-lock acquires; the scrape-storm regression gate)")
_m("torchft_lh_heartbeat_age_seconds", "gauge", "Seconds since each replica's last heartbeat")
_m("torchft_lh_replica_step", "gauge", "Last registered step per participant")
_m("torchft_lh_replica_capacity", "gauge", "Degraded-mode capacity fraction per participant (1 = full width)")
_m("torchft_lh_stall_rate", "gauge", "EWMA data-plane stall rate per replica (events/s, from heartbeat CommHealth)")
_m("torchft_lh_replica_flagged", "gauge", "1 when the straggler detector currently flags the replica")
_m("torchft_lh_spare_warm_lag_steps", "gauge", "Warm-watermark lag behind the commit front per spare")
_m("torchft_lh_rpc_inbound_total", "counter", "Inbound RPC frames by message type")
_m("torchft_lh_aggregated_members", "gauge", "Members whose last beat arrived via a zone aggregator")
_m("torchft_lh_agg_flush_age_seconds", "gauge", "Seconds since each zone aggregator's last flush")

# --- per-replica ManagerServer ---------------------------------------------
_m("torchft_mgr_step", "gauge", "This replica's committed step")
_m("torchft_mgr_quorum_id", "gauge", "Quorum id this replica last adopted")
_m("torchft_mgr_capacity", "gauge", "Degraded-mode capacity fraction this replica advertises")
_m("torchft_mgr_batches_committed_total", "counter", "Global batches committed (sum of participants over committed steps)")
_m("torchft_mgr_commit_failures", "gauge", "Consecutive failed commit votes (resets on commit)")
_m("torchft_mgr_quorum_rpc_seconds", "gauge", "Quorum RPC wall time of the most recent round")
_m("torchft_mgr_configure_seconds", "gauge", "Communicator reconfigure wall time of the most recent membership change")
_m("torchft_mgr_heal_send_seconds", "gauge", "Checkpoint-serve wall time of the most recent heal this replica sourced")
_m("torchft_mgr_heal_recv_seconds", "gauge", "Checkpoint-fetch wall time of the most recent heal this replica ran")
_m("torchft_mgr_heal_bytes_per_sec", "gauge", "Throughput of the most recent striped heal fetch")
_m("torchft_mgr_ring_lanes", "gauge", "TCP lanes per peer of the current data-plane epoch")
_m("torchft_mgr_outer_shard_overlap_ratio", "gauge", "Fraction of the last sharded outer update hidden under wire time")
_m("torchft_mgr_beats_via_agg_total", "counter", "Heartbeats routed through a zone aggregator")
_m("torchft_mgr_beats_direct_total", "counter", "Heartbeats sent directly to the lighthouse")
_m("torchft_mgr_agg_fallbacks_total", "counter", "Aggregator-unreachable fallbacks to direct beats")
_m("torchft_mgr_comm_tx_bytes_total", "counter", "Cumulative data-plane payload bytes sent (all epochs)")
_m("torchft_mgr_comm_rx_bytes_total", "counter", "Cumulative data-plane payload bytes received (all epochs)")
_m("torchft_mgr_comm_stalls_total", "counter", "Cumulative data-plane stall events (pacer denials / would-block)")
_m("torchft_mgr_comm_reconnects_total", "counter", "Cumulative in-epoch lane reconnects")
_m("torchft_mgr_comm_failovers_total", "counter", "Cumulative in-epoch lane failovers")
_m("torchft_mgr_comm_faults_total", "counter", "Cumulative injected data-plane faults (chaos)")
_m("torchft_mgr_flight_events", "gauge", "Events currently held in this replica's flight-recorder ring")
_m("torchft_mgr_flight_dumps_total", "counter", "Flight-recorder dumps written by this replica")


@dataclass(frozen=True)
class Sample:
    name: str
    value: float
    labels: Tuple[Tuple[str, str], ...] = ()


def metric_sample(
    name: str, value: object, labels: Optional[Mapping[str, str]] = None
) -> Optional[Sample]:
    """Build one sample of a DECLARED metric (raises KeyError on an
    undeclared name — the runtime half of the registry contract).  Returns
    None for a None/unparseable value so optional gauges drop out of the
    scrape instead of serving garbage."""
    if name not in REGISTRY:
        raise KeyError(
            f"{name} is not declared in torchft_tpu/obs/metrics.py — every "
            "/metrics name must be registered exactly once"
        )
    if value is None:
        return None
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    items: Tuple[Tuple[str, str], ...] = ()
    if labels:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"illegal Prometheus label name: {k}")
        items = tuple(sorted((k, str(v2)) for k, v2 in labels.items()))
    return Sample(name=name, value=v, labels=items)


def _escape_label(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def render(samples: List[Optional[Sample]]) -> str:
    """Prometheus text exposition (version 0.0.4): samples grouped by
    metric with one ``# HELP`` / ``# TYPE`` header each, None entries
    (optional gauges with no value yet) dropped."""
    by_name: Dict[str, List[Sample]] = {}
    order: List[str] = []
    for s in samples:
        if s is None:
            continue
        if s.name not in by_name:
            by_name[s.name] = []
            order.append(s.name)
        by_name[s.name].append(s)
    lines: List[str] = []
    for name in order:
        metric = REGISTRY[name]
        lines.append(f"# HELP {name} {metric.doc}")
        lines.append(f"# TYPE {name} {metric.kind}")
        for s in by_name[name]:
            if s.labels:
                label_str = ",".join(
                    f'{k}="{_escape_label(v)}"' for k, v in s.labels
                )
                lines.append(f"{name}{{{label_str}}} {_format_value(s.value)}")
            else:
                lines.append(f"{name} {_format_value(s.value)}")
    return "\n".join(lines) + "\n" if lines else ""


# -- strict parser (the CI scrape smoke test) --------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-z_:][a-z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|\.\d+|Inf|NaN))$"
)
_LABEL_PAIR_RE = re.compile(
    r'^(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"$'
)


def parse_prometheus_text(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Strictly parse Prometheus text exposition: every non-comment line
    must be a well-formed sample, every sampled metric must carry HELP and
    TYPE headers that PRECEDE its first sample, and names/labels must be
    legal.  Raises ``ValueError`` on any violation; returns
    ``{name: [(labels, value), ...]}``."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    helped: Dict[str, bool] = {}
    typed: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {lineno}: malformed HELP: {line!r}")
            helped[parts[2]] = True
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if (
                len(parts) < 4
                or not _NAME_RE.match(parts[2])
                or parts[3] not in ("gauge", "counter", "histogram", "summary", "untyped")
            ):
                raise ValueError(f"line {lineno}: malformed TYPE: {line!r}")
            typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue  # plain comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name = m.group("name")
        if name not in helped or name not in typed:
            raise ValueError(
                f"line {lineno}: sample {name} not preceded by HELP+TYPE"
            )
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw is not None:
            if raw.strip():
                for pair in _split_label_pairs(raw, lineno):
                    pm = _LABEL_PAIR_RE.match(pair)
                    if not pm:
                        raise ValueError(
                            f"line {lineno}: malformed label pair {pair!r}"
                        )
                    labels[pm.group("k")] = (
                        pm.group("v")
                        .replace("\\n", "\n")
                        .replace('\\"', '"')
                        .replace("\\\\", "\\")
                    )
        out.setdefault(name, []).append((labels, float(m.group("value"))))
    return out


def _split_label_pairs(raw: str, lineno: int) -> List[str]:
    """Split ``k1="v1",k2="v2"`` respecting escaped quotes inside values."""
    pairs: List[str] = []
    depth_in_string = False
    start = 0
    i = 0
    while i < len(raw):
        c = raw[i]
        if c == "\\" and depth_in_string:
            i += 2
            continue
        if c == '"':
            depth_in_string = not depth_in_string
        elif c == "," and not depth_in_string:
            pairs.append(raw[start:i])
            start = i + 1
        i += 1
    if depth_in_string:
        raise ValueError(f"line {lineno}: unterminated label value")
    pairs.append(raw[start:])
    return [p for p in pairs if p]


def operations_md_table() -> str:
    """The docs/torch_operations.md §2 metric-reference table, generated from
    this registry (the ftlint metrics-registry checker cross-checks it)."""
    lines = [
        "| Metric | Type | What it reports |",
        "|---|---|---|",
    ]
    for metric in sorted(REGISTRY.values(), key=lambda m: m.name):
        lines.append(f"| `{metric.name}` | {metric.kind} | {metric.doc} |")
    return "\n".join(lines)


if __name__ == "__main__":  # pragma: no cover - doc regeneration helper
    print(operations_md_table())
