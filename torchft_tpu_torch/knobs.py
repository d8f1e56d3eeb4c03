"""Canonical registry of every ``TORCHFT_*`` / ``TPUFT_*`` environment knob.

The stack's knob surface grew to ~100 distinct environment variables,
each read ad-hoc at its point of use.  This module is the single
source of truth the port's ``ftlint`` knob checker
(``python -m torchft_tpu_torch.analysis``) enforces: every knob-shaped name
appearing anywhere in the port's source and ``chip_smoke.py`` must be
declared here, and the knob reference table in ``docs/torch_operations.md``
must agree with this registry in both directions (run
``python -m torchft_tpu_torch.knobs`` to emit it).

Declaring a knob here does NOT change how it is read — modules with
bespoke parse semantics (fault-program specs, ``auto`` tri-states, custom
error text) keep their own readers.  Modules with plain scalar reads go
through the live accessors below (``get_str`` / ``get_int`` / ``get_float``
/ ``get_bool``), which read ``os.environ`` at call time (never cached, so
tests that monkeypatch the environment keep working) and name the knob in
their parse errors.

To add a knob: declare it below (name, type, default, one-line doc), use
an accessor (or a bespoke reader) at the point of use, and refresh the
``docs/torch_operations.md`` knob table.  ``ftlint`` fails the build on any
undeclared knob and on registry/docs drift.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = [
    "Knob",
    "REGISTRY",
    "get_raw",
    "get_str",
    "get_int",
    "get_float",
    "get_bool",
    "operations_md_table",
]


@dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "str" | "int" | "float" | "bool"
    default: str  # human-rendered default (may be "auto", "unset", ...)
    doc: str
    scope: str = "runtime"  # "runtime" | "bench" | "launcher"


REGISTRY: Dict[str, Knob] = {}


def _k(name: str, type: str, default: str, doc: str, scope: str = "runtime") -> None:
    if name in REGISTRY:
        raise ValueError(f"duplicate knob declaration: {name}")
    REGISTRY[name] = Knob(name=name, type=type, default=default, doc=doc, scope=scope)


# --- control plane ----------------------------------------------------------
_k("TORCHFT_LIGHTHOUSE", "str", "unset",
   "Lighthouse address (host:port) a manager registers with; required for multi-replica runs")
_k("TORCHFT_MANAGER_PORT", "int", "0",
   "Bind port for the manager server (0 = ephemeral)")
_k("TORCHFT_TIMEOUT_SEC", "float", "per-ctor (60)",
   "Per-op data-plane timeout; peers abort a ring after this long")
_k("TORCHFT_QUORUM_TIMEOUT_SEC", "float", "per-ctor (900)",
   "Quorum RPC deadline (covers rendezvous of the whole fleet)")
_k("TORCHFT_CONNECT_TIMEOUT_SEC", "float", "per-ctor (60)",
   "Control-plane dial deadline (lighthouse/manager/store)")
_k("TORCHFT_QUORUM_RETRIES", "int", "0",
   "Consecutive failed-quorum retries before the manager raises")
_k("TORCHFT_CONNECT_RETRIES", "int", "3",
   "Dial attempts with jittered exponential backoff inside the connect deadline")
_k("TORCHFT_WIRE_COMPAT", "int", "5 (current)",
   "Pin the control-plane wire version during rolling upgrades (1..5; 4 pins pre-v5 bytes, 3 disables the v4 coordination plane)")
_k("TORCHFT_WATCHDOG_TIMEOUT_SEC", "float", "0 (off)",
   "Futures watchdog: log+dump stacks when an op exceeds this bound")
_k("TORCHFT_TIER", "str", "auto",
   "Control-plane tier: cpp | python | auto (cpp when the native build loads)")
# --- hierarchical coordination plane (wire v4) ------------------------------
_k("TORCHFT_AGG_ADDR", "str", "unset",
   "Zone aggregator address (host:port) this manager routes heartbeats through; unset = beat the lighthouse directly")
_k("TORCHFT_AGG_FLUSH_MS", "float", "100",
   "Aggregator upstream flush cadence: one batched LH_AGG_BEAT RPC per tick")
_k("TORCHFT_AGG_TIMEOUT_S", "float", "1.0",
   "Lighthouse-side flush age after which an aggregator counts dead (reporting gap, not member death)")
_k("TORCHFT_AGG_GRACE_S", "float", "heartbeat timeout",
   "Extra member-liveness grace while the member's aggregator is dead (covers the fall-back-to-direct window); explicit 0 disables")
_k("TORCHFT_AGG_RETRY_S", "float", "2.0",
   "Member-side cooloff before retrying a failed aggregator (beats go direct meanwhile)")
_k("TORCHFT_STATUS_TTL_S", "float", "0.5",
   "Lighthouse /status(.json) snapshot TTL: status polls rebuild (and take the state lock) at most once per TTL")
# --- observability ----------------------------------------------------------
_k("TORCHFT_USE_OTEL", "bool", "0",
   "Opt into the OpenTelemetry metrics exporter when the SDK is installed")
_k("TORCHFT_LOG_DIR", "str", "unset",
   "Directory for JSONL metrics logs (torchft_quorums / torchft_heals); enables logging when set")
_k("TORCHFT_TRACE_DIR", "str", "unset",
   "Directory for per-epoch chrome-trace dumps (off when unset)")
_k("TORCHFT_FLIGHT_EVENTS", "int", "4096",
   "Flight-recorder ring capacity (typed events per replica); 0 disables recording entirely")
_k("TORCHFT_FLIGHT_DIR", "str", "unset",
   "Directory flight dumps land in as flight_{replica_id}.jsonl (poison / error-funnel / SIGUSR2 / atexit / shutdown triggers); unset disables file dumps")
_k("TORCHFT_FLIGHT_SPANS", "bool", "0",
   "Collect per-step trace spans (quorum rpc, collectives, lane windows, heal) for Chrome-trace export")
_k("TORCHFT_FLIGHT_DUMP_MIN_S", "float", "1.0",
   "Rate limit between automatic flight dumps (a poison storm must not turn into an fsync storm)")
_k("TORCHFT_METRICS", "bool", "1",
   "Serve the Prometheus-text /metrics endpoint on the lighthouse and every ManagerServer")
_k("TORCHFT_METRICS_TTL_S", "float", "0.5",
   "ManagerServer /metrics snapshot TTL: scrape storms rebuild the sample set at most once per TTL")
# --- data plane: lanes / framing / topology ---------------------------------
_k("TORCHFT_RING_LANES", "str", "auto",
   "TCP lanes per peer for striped collectives (auto = profile-derived; must be uniform)")
_k("TORCHFT_RING_FRAME_KB", "str", "auto",
   "Stripe floor per lane frame in KiB (auto = RTT*BW-derived)")
_k("TORCHFT_HIERARCHICAL", "str", "auto",
   "Topology-aware dispatch: auto | 0 | 1 (auto engages at >=2 hosts with a multi-member host)")
_k("TORCHFT_HOST_ID", "str", "advertised host",
   "Override host identity for same-IP host grouping")
_k("TORCHFT_SHM_SLOT_MB", "float", "8",
   "Per-slot size of the intra-host shared-memory segment (MiB, 64-byte aligned)")
_k("TORCHFT_LANE_RETRIES", "int", "2",
   "In-epoch re-dial attempts for a reset lane before failover to surviving lanes")
_k("TORCHFT_LANE_BACKOFF_MS", "float", "50",
   "Base backoff between in-epoch lane re-dials (jittered exponential)")
_k("TORCHFT_BUCKET_CAP_MB", "float", "32",
   "Gradient bucket split size for DDP allreduce (must be uniform across replicas)")
_k("TORCHFT_BABY_SHM_MIN", "int", "262144",
   "Minimum payload bytes routed via the baby-process shared-memory ring")
# --- data plane: quantization ----------------------------------------------
_k("TORCHFT_QUANT_KIND", "str", "int8",
   "Wire quantization kind for quantized collectives")
_k("TORCHFT_QUANT_WINDOW_MB", "float", "4",
   "Pipelined quantized-collective window size (MiB)")
_k("TORCHFT_QUANT_DEVICE_REDUCE", "str", "auto",
   "Force on/off the quant kernels in the host pipelines (windowed reduce, outer-sync quantize/dequantize)")
# --- net emulation / fault injection ----------------------------------------
_k("TORCHFT_NET_EMU", "str", "off",
   "Named link-emulation profile for the data plane: wan_1g | dcn_10g")
_k("TORCHFT_NET_GBPS", "float", "profile",
   "Override the emulated link rate (Gbit/s)")
_k("TORCHFT_NET_RTT_MS", "float", "profile",
   "Override the emulated round-trip time (ms)")
_k("TORCHFT_NET_CWND_KB", "float", "256",
   "Per-stream congestion-window cap under emulation (KiB)")
_k("TORCHFT_NET_FAULTS", "str", "unset",
   "Fault program: loss:P,reset:P,reset_once:N,stall:P:MS,partition:A+B|self (see operations.md #10)")
_k("TORCHFT_NET_FAULT_SEED", "int", "unset",
   "Seed for reproducible fault-program draws")
# --- healing ----------------------------------------------------------------
_k("TORCHFT_HEAL_STRIPED", "bool", "1",
   "Striped multi-source heal (0 pins the legacy single-peer heal)")
_k("TORCHFT_HEAL_CHUNK_MB", "float", "4",
   "Target chunk size for striped heal transfers (MiB)")
_k("TORCHFT_HEAL_MAX_SOURCES", "int", "0 (all)",
   "Cap on concurrent heal sources (0 = every up-to-date peer)")
_k("TORCHFT_HEAL_SOURCE_TIMEOUT_S", "float", "30",
   "Per-request stall bound before a heal source is declared dead and its chunks stolen")
# --- eviction policy --------------------------------------------------------
_k("TORCHFT_EVICT_SLOW", "bool", "0",
   "Exclude flagged comm-health stragglers from the next quorum")
_k("TORCHFT_EVICT_RATIO", "float", "4.0",
   "Stall-rate multiple over the fleet median that flags a replica")
_k("TORCHFT_EVICT_MIN_STALL_RATE", "float", "20.0",
   "Absolute stall-rate floor below which nobody is flagged")
_k("TORCHFT_EVICT_PERSIST", "int", "3",
   "Consecutive flagged quorum rounds before eviction")
# --- sharded outer optimizer ------------------------------------------------
_k("TORCHFT_OUTER_SHARD", "str", "auto",
   "ZeRO-1-style sharded outer sync: auto | 0 | 1 (0 = legacy replicated path)")
_k("TORCHFT_OUTER_CHUNK_MB", "float", "16",
   "Pipelined outer-sync chunk size (MiB, capped at 64 chunks)")
# --- streamed outer sync (zero-overhead DiLoCo fragments) -------------------
_k("TORCHFT_STREAM_SYNC", "str", "auto",
   "Stream DiLoCo fragment outer syncs under inner compute: auto / 0 / 1 (0 = legacy blocking sync, byte-identical; auto engages only when TORCHFT_STREAM_MAX_STALENESS >= 1 and the cadence has room; 1 forces with a derived staleness bar)")
_k("TORCHFT_STREAM_MAX_STALENESS", "int", "0 (off)",
   "Bounded-staleness bar in inner steps: a streamed fragment delta applies exactly this many steps after its sync point (clamped to per-fragment sync_every - delay - 1; identical on every replica)")
# --- degraded mode (in-replica device loss, wire v5) ------------------------
_k("TORCHFT_DEGRADED_MIN_FRAC", "float", "0 (never)",
   "Capacity floor: evict a replica wounded below this fraction (never below min_replicas/majority)")
_k("TORCHFT_DEGRADED_SWAP", "bool", "1",
   "Swap a wounded replica for a warm full-width spare in one membership edit (promotion preferred over degradation)")
_k("TORCHFT_CHAOS_DEVICE_LOSS", "int", "unset",
   "Chaos (process plane): hide N devices at startup so the replica comes up wounded and re-lowers")
# --- hot spares -------------------------------------------------------------
_k("TORCHFT_SPARE_PROMOTE", "bool", "1",
   "Allow the lighthouse to promote a warmed spare when an active dies")
_k("TORCHFT_SPARE_MAX_LAG", "int", "unset (any)",
   "Max warm-step staleness for a spare to be promotion-eligible")
_k("TORCHFT_SPARE_WARM_REFRESH_S", "float", "1.0",
   "Min seconds between warm-snapshot restagings on an active with spares registered")
_k("TORCHFT_SPARE_WARM_PACE_MS", "float", "5",
   "Spare-side pause between warm chunk fetches (idle priority)")
_k("TORCHFT_SPARE_WARM_BUDGET_S", "float", "2.0",
   "Per-round time budget a spare spends fetching warm chunks")
_k("TORCHFT_SPARE_DELTA_BUF_MB", "float", "128",
   "Bounded outer-delta feed ring an active publishes for spares (MiB)")
# --- attention / model kernels ----------------------------------------------
_k("TORCHFT_FLASH", "str", "auto",
   "On the CPU force (1) the flash path's plain version where the shapes allow; "
   "a CUDA device always runs the flash kernels, and 0 raises there")
_k("TORCHFT_FLASH_PLATFORM", "str", "jax backend",
   "Override the platform the flash kernel lowers for (tpu | cpu interpret)")
_k("TORCHFT_FLASH_BLOCK_Q", "int", "512",
   "Flash-attention query block size")
_k("TORCHFT_FLASH_BLOCK_K", "int", "512",
   "Flash-attention key/value block size")
# --- launcher / scheduler ---------------------------------------------------
_k("TPUFT_GROUP_RANK", "int", "0",
   "This replica group's global rank (set by the launcher/scheduler)", "launcher")
_k("TPUFT_GROUP_WORLD_SIZE", "int", "1",
   "Total replica groups in the job (set by the launcher/scheduler)", "launcher")
_k("TPUFT_STANDBY_GATE", "str", "unset",
   "Gate file a standby blocks on before starting (hot-standby launch path)", "launcher")
# --- bench harness (bench.py / scripts) -------------------------------------
_k("TPUFT_BENCH_PLATFORM", "str", "auto",
   "Force the bench backend (cpu | tpu)", "bench")
_k("TPUFT_BENCH_WORKER_PLATFORM", "str", "inherit",
   "Backend for bench fleet worker processes", "bench")
_k("TPUFT_BENCH_MODE", "str", "ddp",
   "Bench training mode (ddp | localsgd | diloco)", "bench")
_k("TPUFT_BENCH_OUT", "str", "<repo>/bench_out.json",
   "Bench artifact output path", "bench")
_k("TPUFT_BENCH_EVENTS_DIR", "str", "unset",
   "Directory fleet workers write lifecycle events to", "bench")
_k("TPUFT_BENCH_STEPS", "int", "8 cpu / 30 tpu",
   "Phase-A measured steps", "bench")
_k("TPUFT_BENCH_TARGET_STEPS", "int", "derived",
   "Fleet worker step target (set for workers by the parent)", "bench")
_k("TPUFT_BENCH_DIM", "int", "256 cpu / 2048 tpu",
   "Bench model hidden dim", "bench")
_k("TPUFT_BENCH_LAYERS", "int", "4 cpu / 16 tpu",
   "Bench model layer count", "bench")
_k("TPUFT_BENCH_SEQ", "int", "256 cpu / 2048 tpu",
   "Bench sequence length", "bench")
_k("TPUFT_BENCH_BATCH", "int", "4 cpu / 8 tpu",
   "Bench per-step batch size", "bench")
_k("TPUFT_BENCH_HEAD_DIM", "int", "64 cpu / 128 tpu",
   "Bench attention head dim", "bench")
_k("TPUFT_BENCH_REMAT", "bool", "0 cpu / 1 tpu",
   "Enable remat in the bench model", "bench")
_k("TPUFT_BENCH_REMAT_MODE", "str", "unset",
   "Remat policy override for the bench model", "bench")
_k("TPUFT_BENCH_REPLICAS", "int", "3",
   "Fleet phase replica-group count", "bench")
_k("TPUFT_BENCH_STANDBY", "int", "1",
   "Hot standbys kept during the fleet phase", "bench")
_k("TPUFT_BENCH_ALL_STANDBY", "bool", "0",
   "Relaunch every killed replica as a standby", "bench")
_k("TPUFT_BENCH_FLEET_STEPS", "int", "48 cpu / 100 tpu",
   "Fleet phase step count", "bench")
_k("TPUFT_BENCH_FLEET_DIM", "int", "256",
   "Fleet phase model hidden dim", "bench")
_k("TPUFT_BENCH_FLEET_LAYERS", "int", "4",
   "Fleet phase model layer count", "bench")
_k("TPUFT_BENCH_FLEET_SEQ", "int", "256 cpu / 512 tpu",
   "Fleet phase sequence length", "bench")
_k("TPUFT_BENCH_FLEET_BATCH", "int", "4 cpu / 8 tpu",
   "Fleet phase batch size", "bench")
_k("TPUFT_BENCH_KILL_EVERY", "int", "14 cpu / 25 tpu",
   "Fleet phase: kill one replica every N steps", "bench")
_k("TPUFT_BENCH_JOIN_MS", "float", "1000",
   "Fleet phase relaunch join pause (ms)", "bench")
_k("TPUFT_BENCH_HEAL_TRANSPORT", "str", "comm",
   "Heal transport for the fleet phase (comm | http)", "bench")
_k("TPUFT_BENCH_DILOCO_STEPS", "int", "48 cpu / 96 tpu",
   "DiLoCo phase step count", "bench")
_k("TPUFT_BENCH_DILOCO_SYNC", "int", "8",
   "DiLoCo outer-sync cadence (steps)", "bench")
_k("TPUFT_BENCH_DILOCO_DELAY", "int", "2",
   "DiLoCo delayed-apply depth", "bench")
_k("TPUFT_BENCH_DILOCO_FRAGMENTS", "int", "2",
   "DiLoCo streaming fragment count", "bench")
_k("TPUFT_BENCH_DILOCO_KILLS", "int", "3",
   "DiLoCo chaos-leg kill count", "bench")
_k("TPUFT_BENCH_DILOCO_QUANT", "str", "auto",
   "DiLoCo quantized-wire legs: auto | 0 | 1", "bench")
_k("TPUFT_BENCH_DILOCO_QUANT_WIRE", "bool", "0",
   "Worker-side flag: quantize the outer-sync wire", "bench")
_k("TPUFT_BENCH_SKIP_FLEET", "bool", "0",
   "Skip the fleet (kill/heal) bench phase", "bench")
_k("TPUFT_BENCH_SKIP_DILOCO", "bool", "0",
   "Skip the DiLoCo bench phase", "bench")
_k("TPUFT_BENCH_SKIP_SPARE", "bool", "0",
   "Skip the hot-spare promotion bench phase", "bench")
_k("TPUFT_BENCH_SKIP_COORD", "bool", "0",
   "Skip the coordination-plane scale phase", "bench")
_k("TPUFT_BENCH_SKIP_DEGRADED", "bool", "0",
   "Skip the degraded-mode (device-loss) bench phase", "bench")
_k("TPUFT_BENCH_SKIP_STREAM", "bool", "0",
   "Skip the streamed-outer-sync DiLoCo bench leg (diloco_faultfree_streaming)", "bench")
_k("TPUFT_BENCH_SKIP_OBS", "bool", "0",
   "Skip the observability-overhead bench phase", "bench")
_k("TPUFT_BENCH_OBS_STEPS", "int", "40",
   "Measured steps per leg of the observability-overhead phase", "bench")
_k("TPUFT_BENCH_COORD_REPLICAS", "int", "120 cpu / 500 tpu",
   "Simulated replicas driven by the coordination scale phase", "bench")
_k("TPUFT_BENCH_PROBE_TIMEOUT_S", "float", "180",
   "Backend-executes probe deadline", "bench")
_k("TPUFT_BENCH_PROBE_WINDOW_S", "float", "900",
   "Total window spent re-probing a wedged backend at startup", "bench")
_k("TPUFT_BENCH_REPROBE_WINDOW_S", "float", "60",
   "Mid-run recovery: window spent re-probing after a wedge", "bench")
_k("TPUFT_BENCH_REPROBE_BUDGET_S", "float", "1500",
   "Mid-run recovery: budget for the phase-A recapture subprocess", "bench")
_k("TPUFT_BENCH_PHASE_FLOOR_S", "float", "1500",
   "Minimum per-phase share of the remaining budget", "bench")
_k("TPUFT_BENCH_TOTAL_BUDGET_S", "float", "2100",
   "Soft wall-clock budget for the whole bench run", "bench")
_k("TPUFT_BENCH_HARD_DEADLINE_S", "float", "budget+1200",
   "Hard watchdog: emit a partial artifact and exit 0 at this age", "bench")
_k("TPUFT_PEAK_TFLOPS", "float", "auto",
   "Override the per-chip peak TFLOP/s used for MFU math", "bench")
_k("TPUFT_SWEEP_OUT", "str", "unset",
   "mfu_sweep artifact output path", "bench")


def _parse_error(name: str, raw: str, expected: str) -> ValueError:
    return ValueError(f"unparseable {name}={raw!r} (expected {expected})")


def _lookup(name: str) -> Knob:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"{name} is not a registered knob — declare it in torchft_tpu/knobs.py"
        ) from None


def get_raw(name: str) -> Optional[str]:
    """The raw environment value of a registered knob (None when unset).

    Reads ``os.environ`` at call time — values are never cached, so tests
    that monkeypatch the environment see their overrides immediately."""
    _lookup(name)
    return os.environ.get(name)


def get_str(name: str, default: str = "") -> str:
    raw = get_raw(name)
    return raw if raw else default


def get_int(name: str, default: int = 0) -> int:
    raw = get_raw(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise _parse_error(name, raw, "int") from None


def get_float(name: str, default: float = 0.0) -> float:
    raw = get_raw(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        raise _parse_error(name, raw, "float") from None


def get_bool(name: str, default: bool = False) -> bool:
    """Truthiness parse shared by every boolean knob: explicit off values
    ("0", "false", "off") are false, any other non-empty value is true."""
    raw = get_raw(name)
    if raw is None or raw == "":
        return default
    return raw.strip().lower() not in ("0", "false", "off")


def operations_md_table() -> str:
    """The ``docs/torch_operations.md`` knob-reference table, generated from this
    registry so the two can never drift (ftlint cross-checks both ways)."""
    lines = [
        "| Knob | Type | Default | What it does |",
        "|---|---|---|---|",
    ]
    for knob in sorted(REGISTRY.values(), key=lambda k: (k.scope, k.name)):
        default = knob.default.replace("|", "\\|")
        doc = knob.doc.replace("|", "\\|")
        lines.append(f"| `{knob.name}` | {knob.type} | {default} | {doc} |")
    return "\n".join(lines)


if __name__ == "__main__":  # pragma: no cover - doc regeneration helper
    print(operations_md_table())
