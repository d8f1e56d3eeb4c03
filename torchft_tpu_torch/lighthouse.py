"""Lighthouse: global membership / quorum service.

One lighthouse runs per job.  Replica groups register participation via the
blocking ``quorum`` RPC and send periodic heartbeats; the lighthouse computes
a quorum each tick and broadcasts it to every parked requester.  This is the
behavioral twin of the reference's Rust lighthouse (``src/lighthouse.rs``):

- ``quorum_compute`` (``src/lighthouse.rs:141-269``): filter participants by
  heartbeat freshness; take the *fast quorum* when every previous-quorum
  member is back; otherwise require ``min_replicas``, a majority of all
  heartbeating replicas (anti split-brain), and wait ``join_timeout_ms`` for
  healthy stragglers before issuing a smaller quorum. ``shrink_only``
  restricts candidates to previous members.
- Tick loop every ``quorum_tick_ms`` (``src/lighthouse.rs:345-352``);
  ``quorum_id`` bumps on membership change or on any member reporting commit
  failures (``src/lighthouse.rs:307-325``); participants are cleared after a
  quorum is issued so each round re-registers.
- The ``quorum`` RPC registers the requester (implicit heartbeat), runs a
  proactive tick, then parks until a quorum *containing the requester*
  arrives, re-registering if a quorum excludes it
  (``src/lighthouse.rs:484-551``); the server honors the client's deadline
  like the reference honors ``grpc-timeout`` (``src/timeout.rs``).
- The same listener also answers plain HTTP: ``/`` and ``/status`` render a
  dashboard and ``/replica/{id}/kill`` forwards a Kill RPC to that replica's
  manager (``src/lighthouse.rs:370-388,454-479``).  We sniff the first bytes
  of each connection to route HTTP vs framed RPC on one port.
"""

from __future__ import annotations

import argparse
import html
import json
import logging
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from torchft_tpu_torch import knobs
from torchft_tpu_torch.obs import metrics as obs_metrics
from torchft_tpu_torch.obs.flight import FlightEvent, FlightRecorder
from torchft_tpu_torch.wire import (
    ROLE_ACTIVE,
    ROLE_SPARE,
    WIRE_COMPAT_ENV,
    AggBeat,
    CommHealth,
    ErrCode,
    MsgType,
    Quorum,
    QuorumDelta,
    QuorumMember,
    Reader,
    RpcClient,
    WireError,
    Writer,
    apply_quorum_delta,
    configure_server_socket,
    create_listener,
    connect,
    make_quorum_delta,
    manager_quorum_wire_version,
    quorum_digest,
    raise_if_error,
    read_http_path,
    recv_frame,
    send_error,
    send_frame,
    send_http_response,
)

logger = logging.getLogger(__name__)

# Straggler detection / eviction knobs.  Heartbeats carry a cumulative
# comm-health summary (wire.CommHealth); the lighthouse differences
# consecutive beats into EWMA rates and flags a replica whose stall rate is
# a persistent outlier vs its peers.  With TORCHFT_EVICT_SLOW=1 a flagged
# replica is excluded from the next quorum (never below min_replicas or
# the anti-split-brain majority), so the fleet sheds a gray node
# proactively instead of timing out on it every step.
EVICT_SLOW_ENV = "TORCHFT_EVICT_SLOW"
# flag when stall_rate > ratio x median(peer stall rates) ...
EVICT_RATIO_ENV = "TORCHFT_EVICT_RATIO"  # default 4.0
# ... AND above this absolute floor (events/s) — so an idle fleet where
# everyone is near zero never flags anybody
EVICT_MIN_STALL_RATE_ENV = "TORCHFT_EVICT_MIN_STALL_RATE"  # default 20.0
# consecutive outlier evaluations (one per heartbeat) before flagging
EVICT_PERSIST_ENV = "TORCHFT_EVICT_PERSIST"  # default 3


def _evict_slow_enabled() -> bool:
    return os.environ.get(EVICT_SLOW_ENV, "0").lower() in ("1", "true", "on")


# Hot-spare promotion (wire v3 SPARE role).  A spare registers via the
# quorum RPC with role=SPARE: it heartbeats and receives every quorum
# broadcast (riding the version-gated ``spares`` tail) but never counts
# toward min_replicas or the anti-split-brain majority and never enters the
# participant list — so a spare joining, warming, or DYING never bumps
# quorum_id or reconfigures the active fleet.  When an active member of the
# previous quorum stops heartbeating, the lighthouse promotes the freshest
# healthy spare (max reported warm step, ties to the lowest replica_id) in
# the SAME quorum computation that would have shrunk the fleet: the spare
# moves into the candidate set and the resulting membership edit is the one
# quorum_id bump the failure was always going to cost.
SPARE_PROMOTE_ENV = "TORCHFT_SPARE_PROMOTE"
# a spare lagging the fleet by more than this many steps is too cold to
# promote (it would stall the quorum on a bulk heal anyway; let the fleet
# shrink and the spare keep warming)
SPARE_MAX_LAG_ENV = "TORCHFT_SPARE_MAX_LAG"  # default: unlimited
# Spare liveness is judged on a LAXER bound than active death detection:
# a sub-second heartbeat_timeout sized for fast failure detection also
# means one scheduler-starved beat from the spare (whose process spends
# its time warming, not spinning on the control plane) would make it
# ineligible at exactly the promotion instant — and a missed promotion is
# PERMANENT once the shrunk quorum becomes prev (dead members of the old
# prev are no longer anyone's to replace).  A spare this stale may be
# dead; the cost of wrongly promoting one is a single wedged round (the
# fleet sheds it at the next heartbeat verdict), while the cost of
# wrongly skipping one is the full cold heal-in the spare existed to
# avoid.  Registration pruning stays at 4x.
_SPARE_FRESH_FACTOR = 3.0


def _spare_promote_enabled() -> bool:
    return knobs.get_bool(SPARE_PROMOTE_ENV, True)


# Degraded-mode policy (wire v5).  A replica that lost in-replica devices
# re-lowers onto the survivors and advertises a capacity fraction instead
# of dying; the lighthouse treats that fraction as a first-class policy
# input with a three-rung ladder:
#
#   wound  — the fleet keeps the wounded replica (reduced data shard,
#            weighted outer reduce); zero membership edits.
#   swap   — promotion preferred over degradation: when a full-width warm
#            spare is registered, the wounded replica trades places with
#            it in ONE membership edit (same quorum computation, like
#            hold-the-shrink).  The swapped-out replica stays excluded
#            while it remains degraded and is re-admitted the moment it
#            re-registers at full capacity.
#   evict  — a replica wounded below TORCHFT_DEGRADED_MIN_FRAC is shed
#            from the quorum (never below min_replicas or the
#            anti-split-brain majority: a limping replica still beats no
#            quorum).  0 (the default) disables floor eviction.
DEGRADED_MIN_FRAC_ENV = "TORCHFT_DEGRADED_MIN_FRAC"
DEGRADED_SWAP_ENV = "TORCHFT_DEGRADED_SWAP"


def _degraded_min_frac() -> float:
    return knobs.get_float(DEGRADED_MIN_FRAC_ENV, 0.0)


def _degraded_swap_enabled() -> bool:
    return knobs.get_bool(DEGRADED_SWAP_ENV, True)


# Hierarchical coordination plane (wire v4).  Zone aggregators batch member
# heartbeats into one upstream RPC per flush tick (LH_AGG_BEAT_REQ); the
# lighthouse remembers which aggregator last reported each member.  When an
# aggregator goes quiet, its members' beat staleness is a REPORTING gap,
# not evidence of member death: each affected member gets a bounded extra
# grace window (during which its manager's heartbeat loop falls back to
# direct beats) before the normal heartbeat verdict applies.  An aggregator
# is judged dead on a much tighter bound than members (it flushes every
# ~100 ms), so the gap is known well before any member heartbeat expires.
AGG_TIMEOUT_S_ENV = "TORCHFT_AGG_TIMEOUT_S"  # default 1.0
AGG_GRACE_S_ENV = "TORCHFT_AGG_GRACE_S"  # default: heartbeat timeout
# /status(.json) snapshot TTL: status polls are served from a cached
# snapshot rebuilt at most once per TTL, so a dashboard fleet polling at
# high QPS never contends on the quorum state lock.
STATUS_TTL_S_ENV = "TORCHFT_STATUS_TTL_S"  # default 0.5
# recently-issued quorums kept for delta-coded broadcasts (by digest)
_RECENT_QUORUMS_MAX = 8
_PAYLOAD_CACHE_MAX = 64


def _agg_freshness_knobs(hb_timeout_s: float) -> Tuple[float, float]:
    """(aggregator dead-after age, member grace while its agg is dead).

    Unset grace defaults to one heartbeat timeout; an EXPLICIT 0 disables
    the reporting-gap excuse entirely (agg-routed members judged as
    strictly as direct ones) — unset and 0 must stay distinguishable."""
    agg_timeout = knobs.get_float(AGG_TIMEOUT_S_ENV, 1.0)
    raw_grace = knobs.get_raw(AGG_GRACE_S_ENV)
    if raw_grace is None or raw_grace == "":
        grace = hb_timeout_s
    else:
        grace = knobs.get_float(AGG_GRACE_S_ENV, hb_timeout_s)
    return agg_timeout, grace


def _beat_fresh(
    state: "_State",
    rid: str,
    now: float,
    bound_s: float,
    agg_timeout_s: float,
    grace_s: float,
) -> bool:
    """Member liveness with the aggregator reporting-gap excuse: fresh
    within ``bound_s`` as before; a member whose last beat arrived via an
    aggregator that is itself dead gets ``grace_s`` extra (its beats
    stopped because the REPORTER died — the member's manager falls back to
    direct beats within a heartbeat interval or two).  A stale member
    whose aggregator is alive is genuinely quiet and gets no excuse."""
    ts = state.heartbeats.get(rid)
    if ts is None:
        return False
    age = now - ts
    if age < bound_s:
        return True
    agg = state.via_agg.get(rid)
    if agg is None or grace_s <= 0:
        return False
    agg_ts = state.agg_last.get(agg)
    if agg_ts is not None and now - agg_ts <= agg_timeout_s:
        return False  # reporting path alive: the member itself went quiet
    return age < bound_s + grace_s


def _spare_max_lag() -> Optional[int]:
    raw = os.environ.get(SPARE_MAX_LAG_ENV)
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError as e:
        raise ValueError(
            f"unparseable {SPARE_MAX_LAG_ENV}={raw!r} (expected int)"
        ) from e


def _evict_knobs() -> Tuple[float, float, int]:
    try:
        ratio = float(os.environ.get(EVICT_RATIO_ENV, "") or 4.0)
        min_rate = float(os.environ.get(EVICT_MIN_STALL_RATE_ENV, "") or 20.0)
        persist = int(os.environ.get(EVICT_PERSIST_ENV, "") or 3)
    except ValueError as e:
        raise ValueError(
            f"unparseable eviction knob: {EVICT_RATIO_ENV}="
            f"{os.environ.get(EVICT_RATIO_ENV)!r} "
            f"{EVICT_MIN_STALL_RATE_ENV}="
            f"{os.environ.get(EVICT_MIN_STALL_RATE_ENV)!r} "
            f"{EVICT_PERSIST_ENV}={os.environ.get(EVICT_PERSIST_ENV)!r}"
        ) from e
    return ratio, min_rate, max(1, persist)


@dataclass
class LighthouseConfig:
    """CLI-visible knobs (``src/lighthouse.rs:94-131``)."""

    min_replicas: int
    bind: str = "0.0.0.0:0"
    join_timeout_ms: int = 60_000
    quorum_tick_ms: int = 100
    heartbeat_timeout_ms: int = 5_000


@dataclass
class _MemberDetails:
    joined: float
    member: QuorumMember


@dataclass
class _ReplicaHealth:
    """Per-replica comm-health aggregate differenced from heartbeats."""

    last: Optional[CommHealth] = None
    last_ts: float = 0.0
    stall_rate: float = 0.0  # EWMA, events/s
    reconnect_rate: float = 0.0  # EWMA, events/s
    tx_rate: float = 0.0  # EWMA, bytes/s
    reconnects: int = 0  # cumulative, straight from the last beat
    failovers: int = 0
    flag_streak: int = 0
    flagged: bool = False


@dataclass
class _State:
    participants: Dict[str, _MemberDetails] = field(default_factory=dict)
    heartbeats: Dict[str, float] = field(default_factory=dict)
    prev_quorum: Optional[Quorum] = None
    quorum_id: int = 0
    health: Dict[str, _ReplicaHealth] = field(default_factory=dict)
    evicted_now: List[str] = field(default_factory=list)
    evicted_prev: set = field(default_factory=set)
    evictions_total: int = 0
    # hot spares: registered SPARE-role members, kept OUT of participants
    # (and out of every membership count) until promoted.  ``spare_ids``
    # remembers which heartbeating replica ids are spares so majority math
    # never counts them; ``promoted`` pins ids the lighthouse flipped to
    # active until the replica itself re-registers with role=ACTIVE.
    spares: Dict[str, _MemberDetails] = field(default_factory=dict)
    spare_ids: set = field(default_factory=set)
    promoted: set = field(default_factory=set)
    promoted_now: List[str] = field(default_factory=list)
    promotions_total: int = 0
    # hold-the-shrink anchors: when each prev member was FIRST observed
    # absent-but-heartbeat-fresh (the window must run from the member's
    # own disappearance — anchoring on the survivors' park time can expire
    # BEFORE the missing member's heartbeat does, issuing the shrink while
    # the member still counts healthy and permanently missing the
    # promotion once the shrunk quorum becomes prev)
    hold_since: Dict[str, float] = field(default_factory=dict)
    # hierarchical coordination plane (wire v4): which aggregator last
    # reported each member (cleared when the member beats direct), and
    # each aggregator's last flush time — the inputs to the aggregator
    # reporting-gap grace in ``_beat_fresh``
    via_agg: Dict[str, str] = field(default_factory=dict)
    agg_last: Dict[str, float] = field(default_factory=dict)
    # rate limit for the note_health stale-entry prune (an O(members)
    # sweep per beat would be O(N^2)/s at fleet scale)
    health_pruned_ts: float = 0.0
    # degraded-mode (wire v5): wounded replicas a full-width spare swapped
    # out — excluded from quorums while they remain degraded, re-admitted
    # when they re-register at full capacity; plus the floor-eviction
    # accounting twins of evicted_now/evicted_prev/evictions_total
    degraded_swapped: set = field(default_factory=set)
    degraded_evicted_now: List[str] = field(default_factory=list)
    degraded_evicted_prev: set = field(default_factory=set)
    degraded_evictions_total: int = 0
    swaps_total: int = 0
    # wounded replicas swapped out THIS computation (reset alongside
    # promoted_now) — the flight recorder's DEGRADED_SWAP feed
    swapped_now: List[str] = field(default_factory=list)


# health entries stop counting as straggler-median "reporters" after this
# many seconds without a beat, and are dropped entirely at 4x — a departed
# replica's frozen rate must not skew the peer median (or satisfy the
# >= 3-reporters guard) forever, and replica-id churn must not grow the map
# unboundedly
_HEALTH_STALE_S = 15.0


def note_health(state: _State, replica_id: str, health: CommHealth, now: float) -> None:
    """Fold one heartbeat's cumulative comm-health counters into the
    replica's EWMA rates, then re-evaluate the outlier flags.  Pure on
    ``state`` (caller holds the server lock); driven directly by tests."""
    if now - state.health_pruned_ts > _HEALTH_STALE_S or now < state.health_pruned_ts:
        state.health_pruned_ts = now
        for rid in [
            r
            for r, rh in state.health.items()
            if now - rh.last_ts > 4 * _HEALTH_STALE_S
        ]:
            del state.health[rid]
    h = state.health.setdefault(replica_id, _ReplicaHealth())
    if h.last is not None and now > h.last_ts:
        dt = now - h.last_ts
        alpha = min(1.0, dt / 5.0)  # ~5 s horizon
        stall_rate = max(0, health.stalls - h.last.stalls) / dt
        reconnect_rate = max(0, health.reconnects - h.last.reconnects) / dt
        tx_rate = max(0, health.tx_bytes - h.last.tx_bytes) / dt
        h.stall_rate += alpha * (stall_rate - h.stall_rate)
        h.reconnect_rate += alpha * (reconnect_rate - h.reconnect_rate)
        h.tx_rate += alpha * (tx_rate - h.tx_rate)
    h.last = health
    h.last_ts = now
    h.reconnects = health.reconnects
    h.failovers = health.failovers
    _evaluate_stragglers(state, replica_id, now)


def _evaluate_stragglers(state: _State, updated_id: str, now: float) -> None:
    """Flag ``updated_id`` when its stall rate is a persistent outlier vs
    its peers.  Needs >= 3 FRESH reporting replicas (with 2 there is no
    majority to say which side is 'normal'; a departed replica's frozen
    rate must not stand in as a reporter)."""
    ratio, min_rate, persist = _evict_knobs()
    rates = {
        rid: rh.stall_rate
        for rid, rh in state.health.items()
        if rh.last and now - rh.last_ts <= _HEALTH_STALE_S
    }
    h = state.health[updated_id]
    if len(rates) < 3:
        h.flag_streak, h.flagged = 0, False
        return
    others = sorted(r for rid, r in rates.items() if rid != updated_id)
    median = others[len(others) // 2]
    if h.stall_rate > max(ratio * median, min_rate):
        h.flag_streak += 1
    else:
        h.flag_streak = 0
        h.flagged = False
    if h.flag_streak >= persist and not h.flagged:
        h.flagged = True
        logger.warning(
            "straggler flagged: %s stall_rate=%.1f/s vs peer median %.1f/s",
            updated_id,
            h.stall_rate,
            median,
        )


def _note_warm_step(state: "_State", replica_id: str, warm_step: int) -> None:
    """Fold a beat-carried spare warm watermark into the registration
    record (wire v4): promotion eligibility and the /status spare table
    stay fresh at heartbeat cadence instead of quorum-RPC re-registration
    cadence.  Monotonic — a scheduler-starved stale beat never regresses
    the watermark.  Caller holds the server lock.

    COPY-on-write, never in place: the registered member object is shared
    by reference with every issued quorum that carried it (prev_quorum and
    the delta-base ring), whose digests were stamped at issue time — an
    in-place step bump would silently drift their content out from under
    those digests and break every delta computed against them."""
    details = state.spares.get(replica_id)
    if details is not None and warm_step > details.member.step:
        import dataclasses

        details.member = dataclasses.replace(details.member, step=warm_step)


def _note_capacity(state: "_State", replica_id: str, capacity: float) -> None:
    """Fold a beat-carried degraded-capacity fraction (wire v5) into the
    registration record, so the wound→swap→evict ladder reacts at beat
    cadence instead of waiting for the next quorum-RPC registration.
    Copy-on-write for the same reason as :func:`_note_warm_step` — the
    registered member object is shared by reference with issued quorums
    whose digests were stamped at issue time.  The function is total (a
    full-capacity report lifts the swapped-out exclusion too), but note
    the live beat encoder only ever carries DEGRADED fractions — healed
    re-admission in practice rides the full-capacity quorum registration
    (:meth:`LighthouseServer._register`), which happens every round.
    Caller holds the server lock."""
    capacity = min(1.0, max(0.0, capacity))
    details = state.participants.get(replica_id)
    if details is not None and details.member.capacity != capacity:
        import dataclasses

        details.member = dataclasses.replace(details.member, capacity=capacity)
    if capacity >= 1.0:
        state.degraded_swapped.discard(replica_id)


def _promote_spares(
    now: float, state: _State, cfg: LighthouseConfig, healthy_replicas: set
) -> None:
    """Hot-spare promotion: when a previous-quorum member stopped
    heartbeating, move the freshest healthy spare(s) into the participant
    set — the same membership edit the death was always going to cost,
    minus the shrink.  Mutates ``state`` (tick path only; ``_status`` calls
    ``quorum_compute`` with ``allow_promote=False``)."""
    state.promoted_now = []
    state.swapped_now = []
    if not _spare_promote_enabled() or state.prev_quorum is None:
        return
    if any(d.member.shrink_only for d in state.participants.values()):
        # a shrink_only round restricts membership to prev members — a
        # promotion would smuggle a new member into exactly the quorum the
        # caller asked to only ever shrink
        return
    hb_timeout_s = cfg.heartbeat_timeout_ms / 1000.0
    agg_timeout_s, grace_s = _agg_freshness_knobs(hb_timeout_s)
    prev = state.prev_quorum.participants
    prev_ids = {m.replica_id for m in prev}
    dead_prev = {
        m.replica_id for m in prev if m.replica_id not in healthy_replicas
    }
    # promotions from EARLIER ticks that are already standing in for the
    # same deaths: a promoted spare stays in ``participants`` (and in
    # ``promoted``) until the quorum issues, but ``dead_prev`` is
    # recomputed from the unchanged prev_quorum every tick — without this
    # offset each tick would burn another spare on the same dead member
    # and the replacement quorum would GROW past the old world size.
    already_replacing = sum(
        1
        for rid in state.participants
        if rid in state.promoted and rid not in prev_ids
    )
    slots = len(dead_prev) - already_replacing
    if not state.spares:
        return
    eligible = [
        d
        for rid, d in state.spares.items()
        if _beat_fresh(
            state,
            rid,
            now,
            _SPARE_FRESH_FACTOR * hb_timeout_s,
            agg_timeout_s,
            grace_s,
        )
    ]
    max_lag = _spare_max_lag()
    if max_lag is not None:
        prev_max_step = max((m.step for m in prev), default=0)
        eligible = [
            d for d in eligible if d.member.step >= prev_max_step - max_lag
        ]
    # freshest first (max warm step), ties to the lowest replica_id
    eligible.sort(key=lambda d: (-d.member.step, d.member.replica_id))
    for details in eligible[: max(0, slots)]:
        rid = details.member.replica_id
        state.spares.pop(rid)
        state.spare_ids.discard(rid)
        state.promoted.add(rid)
        state.participants[rid] = _MemberDetails(
            joined=now, member=details.member
        )
        healthy_replicas.add(rid)
        state.promoted_now.append(rid)
        state.promotions_total += 1
        logger.warning(
            "promoting spare %s (warm step %d) to replace dead %s",
            rid,
            details.member.step,
            ", ".join(sorted(dead_prev)),
        )
    # Swap rung of the degraded ladder: promotion preferred over
    # degradation.  With warm spares left over after death replacement, a
    # WOUNDED participant (capacity < 1, alive and registered) trades
    # places with a full-width spare in this same computation — wounded
    # out + spare in is ONE membership edit, exactly like hold-the-shrink
    # turns a death into one edit.  The swapped-out replica stays
    # excluded from future quorums (quorum_compute's degraded filter)
    # while it remains degraded, and is re-admitted the moment it
    # re-registers at full capacity.
    if not _degraded_swap_enabled():
        return
    remaining = [d for d in eligible if d.member.replica_id in state.spares]
    wounded = sorted(
        (
            d
            for rid, d in state.participants.items()
            if d.member.capacity < 1.0
            and rid in healthy_replicas
            and rid not in state.promoted
            # already swapped out: the excluded replica keeps re-registering
            # while degraded — swapping it AGAIN would burn a second spare
            # on the same wound and grow the quorum by one per round
            and rid not in state.degraded_swapped
        ),
        # most-wounded first, ties to the lowest replica_id
        key=lambda d: (d.member.capacity, d.member.replica_id),
    )
    for details, victim in zip(remaining, wounded):
        rid = details.member.replica_id
        wid = victim.member.replica_id
        state.spares.pop(rid)
        state.spare_ids.discard(rid)
        state.promoted.add(rid)
        state.participants.pop(wid, None)
        state.degraded_swapped.add(wid)
        state.participants[rid] = _MemberDetails(
            joined=now, member=details.member
        )
        healthy_replicas.add(rid)
        state.promoted_now.append(rid)
        state.swapped_now.append(wid)
        state.promotions_total += 1
        state.swaps_total += 1
        logger.warning(
            "swapping wounded %s (capacity %.2f) for full-width spare %s "
            "(warm step %d) — one membership edit",
            wid,
            victim.member.capacity,
            rid,
            details.member.step,
        )


def quorum_compute(
    now: float,
    state: _State,
    cfg: LighthouseConfig,
    allow_promote: bool = True,
) -> Tuple[Optional[List[QuorumMember]], str]:
    """Decide whether a quorum can be issued right now.

    Pure function mirroring ``quorum_compute`` (``src/lighthouse.rs:141-269``)
    so the full Rust unit-test matrix applies directly.  Registered spares
    never count toward ``min_replicas`` or the anti-split-brain majority;
    ``allow_promote`` gates the one mutation (spare → participant) so a
    status read stays side-effect free.
    """
    hb_timeout_s = cfg.heartbeat_timeout_ms / 1000.0
    agg_timeout_s, grace_s = _agg_freshness_knobs(hb_timeout_s)
    healthy_replicas = {
        rid
        for rid in state.heartbeats
        if rid not in state.spare_ids
        and _beat_fresh(state, rid, now, hb_timeout_s, agg_timeout_s, grace_s)
    }
    if allow_promote:
        _promote_spares(now, state, cfg, healthy_replicas)
    healthy_participants = {
        rid: d for rid, d in state.participants.items() if rid in healthy_replicas
    }

    candidates = sorted(
        (d.member for d in healthy_participants.values()), key=lambda m: m.replica_id
    )
    shrink_only = any(d.member.shrink_only for d in healthy_participants.values())

    # straggler eviction (TORCHFT_EVICT_SLOW): exclude persistently-flagged
    # gray replicas from the candidate set — BEFORE the fast-quorum path,
    # so even a fully-healthy-looking round sheds the straggler — but never
    # below min_replicas or the anti-split-brain majority (a gray node is
    # still better than no quorum)
    state.evicted_now = []
    if _evict_slow_enabled():
        flagged = {rid for rid, rh in state.health.items() if rh.flagged}
        keep = [m for m in candidates if m.replica_id not in flagged]
        if (
            len(keep) < len(candidates)
            and len(keep) >= cfg.min_replicas
            and len(keep) > len(healthy_replicas) // 2
        ):
            state.evicted_now = sorted(
                m.replica_id for m in candidates if m.replica_id in flagged
            )
            candidates = keep

    # degraded-mode ladder, rungs 2 and 3 (see DEGRADED_MIN_FRAC_ENV):
    # swapped-out wounded replicas stay excluded while degraded, and a
    # replica wounded below the capacity floor is evicted — both behind
    # the same never-below-min_replicas/majority guard as straggler
    # eviction.  Runs BEFORE the fast-quorum path so a wounded-but-
    # healthy-looking round still sheds/swaps.
    state.degraded_evicted_now = []
    min_frac = _degraded_min_frac()
    swapped_out = {
        m.replica_id
        for m in candidates
        if m.capacity < 1.0 and m.replica_id in state.degraded_swapped
    }
    floor_evict = {
        m.replica_id
        for m in candidates
        if min_frac > 0.0
        and m.capacity < min_frac
        and m.replica_id not in swapped_out
    }
    if swapped_out or floor_evict:
        drop = swapped_out | floor_evict
        keep = [m for m in candidates if m.replica_id not in drop]
        if (
            len(keep) >= cfg.min_replicas
            and len(keep) > len(healthy_replicas) // 2
        ):
            state.degraded_evicted_now = sorted(floor_evict)
            candidates = keep

    metadata = (
        f"[{len(healthy_participants)}/{len(state.participants)} participants healthy]"
        f"[{len(healthy_replicas)} heartbeating][shrink_only={shrink_only}]"
        + (
            f"[evicting slow: {', '.join(state.evicted_now)}]"
            if state.evicted_now
            else ""
        )
        + (
            f"[promoting spare: {', '.join(state.promoted_now)}]"
            if state.promoted_now
            else ""
        )
        + (f"[{len(state.spares)} spares]" if state.spares else "")
        + (
            f"[evicting degraded below {min_frac}: "
            f"{', '.join(state.degraded_evicted_now)}]"
            if state.degraded_evicted_now
            else ""
        )
        + (
            f"[swapped-out degraded excluded: {', '.join(sorted(swapped_out))}]"
            if swapped_out
            else ""
        )
    )

    if state.prev_quorum is not None:
        prev_ids = {m.replica_id for m in state.prev_quorum.participants}
        if shrink_only:
            candidates = [m for m in candidates if m.replica_id in prev_ids]
        # Fast quorum: every member of the previous quorum is healthy and has
        # re-registered — no need to wait for stragglers.
        if all(rid in healthy_participants for rid in prev_ids):
            return candidates, f"Fast quorum found! {metadata}"

    if len(healthy_participants) < cfg.min_replicas:
        return (
            None,
            f"New quorum not ready, only have {len(healthy_participants)} "
            f"participants, need min_replicas {cfg.min_replicas} {metadata}",
        )

    # Anti split-brain: a quorum must represent a strict majority of every
    # replica the lighthouse believes is alive.
    if len(healthy_participants) <= len(healthy_replicas) // 2:
        return (
            None,
            f"New quorum not ready, only have {len(healthy_participants)} "
            f"participants, need at least half of {len(healthy_replicas)} "
            f"healthy workers {metadata}",
        )

    all_healthy_joined = len(healthy_participants) == len(healthy_replicas)
    first_joined = min(
        (d.joined for d in healthy_participants.values()), default=now
    )
    if (
        not all_healthy_joined
        and now - first_joined < cfg.join_timeout_ms / 1000.0
    ):
        return (
            None,
            f"Valid quorum with {len(healthy_participants)} participants, "
            f"waiting for {len(healthy_replicas) - len(healthy_participants)} "
            f"healthy but not participating stragglers due to join timeout "
            f"{metadata}",
        )

    # Hold-the-shrink: a freshly-dead prev member still has a fresh
    # heartbeat for up to heartbeat_timeout, so the join-timeout path above
    # would issue a SHRUNK quorum first — and promotion (which replaces
    # dead members of prev_quorum) could then never fire.  While a warm
    # spare is registered and a prev member is absent-but-heartbeat-fresh,
    # defer the shrink until the heartbeat verdict lands: either the member
    # re-registers (fast quorum) or its heartbeat expires and the promotion
    # above replaces it in the same computation.  Bounded by join+heartbeat
    # timeouts so a wedged replica that keeps heartbeating but never
    # re-registers is still shed, just one heartbeat window later.
    if (
        allow_promote
        and _spare_promote_enabled()
        and not shrink_only
        and state.spares
        and state.prev_quorum
    ):
        missing_fresh = sorted(
            rid
            for rid in (m.replica_id for m in state.prev_quorum.participants)
            if rid not in healthy_participants and rid in healthy_replicas
        )
        # the hold window runs per missing member from ITS first observed
        # absence (a re-registered or heartbeat-expired member drops out
        # of missing_fresh and its anchor is pruned); a wedged member that
        # keeps beating but never re-registers escapes the hold after the
        # bounded window, so the shrink is delayed, never denied
        for rid in list(state.hold_since):
            if rid not in missing_fresh:
                del state.hold_since[rid]
        # same laxer liveness bound promotion eligibility uses: the hold
        # must never wait for a verdict the promotion would then refuse
        spare_fresh = any(
            _beat_fresh(
                state,
                rid,
                now,
                _SPARE_FRESH_FACTOR * hb_timeout_s,
                agg_timeout_s,
                grace_s,
            )
            for rid in state.spares
        )
        hold_window_s = (
            cfg.join_timeout_ms + cfg.heartbeat_timeout_ms
        ) / 1000.0
        held = [
            rid
            for rid in missing_fresh
            if spare_fresh
            and now - state.hold_since.setdefault(rid, now) < hold_window_s
        ]
        if held:
            return None, (
                f"Holding shrink: prev member(s) {', '.join(held)} "
                f"absent but heartbeat-fresh with a warm spare registered — "
                f"waiting for the heartbeat verdict (rejoin or promotion) "
                f"{metadata}"
            )

    return candidates, f"Valid quorum found {metadata}"


def _quorum_changed(a: List[QuorumMember], b: List[QuorumMember]) -> bool:
    return [m.replica_id for m in a] != [m.replica_id for m in b]


class LighthouseServer:
    """Threaded lighthouse server.

    The reference runs this as a tokio service inside either the standalone
    ``torchft_lighthouse`` binary or the training process via pyo3
    (``src/lib.rs:609-671``); here it is a daemon-threaded object you
    construct and ``shutdown()``.
    """

    def __init__(
        self,
        bind: str = "0.0.0.0:0",
        min_replicas: int = 1,
        join_timeout_ms: int = 100,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5_000,
    ) -> None:
        # NB: the pyo3 binding defaults join_timeout_ms to 100 for tests
        # (src/lib.rs:609-671); the CLI default is 60s.
        self._cfg = LighthouseConfig(
            min_replicas=min_replicas,
            bind=bind,
            join_timeout_ms=join_timeout_ms,
            quorum_tick_ms=quorum_tick_ms,
            heartbeat_timeout_ms=heartbeat_timeout_ms,
        )
        self._state = _State()
        self._lock = threading.Condition()
        self._generation = 0  # bumped on every broadcast quorum
        self._change_reason: Optional[str] = None
        self._shutdown = False
        # rate limit for the proactive tick quorum requests run: at fleet
        # scale a registration storm would otherwise run one O(members)
        # quorum_compute PER request (O(N^2) per round); the background
        # tick loop bounds the added latency to one tick interval
        self._last_tick_ts = 0.0
        # delta-coded broadcasts (wire v4): recently issued quorums by
        # content digest (the delta bases requesters may advertise) and a
        # small cache of encoded response payloads — one delta/full build
        # per (base, new) pair per round instead of one per parked waiter
        self._recent_quorums: Dict[int, Quorum] = {}
        self._payload_cache: Dict[tuple, tuple] = {}
        self._payload_lock = threading.Lock()
        # cached /status snapshot: (built_ts, snapshot dict, json bytes);
        # rebuilt at most once per TORCHFT_STATUS_TTL_S so status polls
        # never contend on the quorum state lock.  status_lock_acquires
        # counts actual rebuilds (the regression gate for status storms).
        self._status_cache: Tuple[float, Optional[dict], bytes] = (
            float("-inf"),
            None,
            b"",
        )
        self._status_cache_lock = threading.Lock()
        self.status_lock_acquires = 0
        # /metrics rides the SAME TTL-cached snapshot; the rendered text is
        # cached per snapshot build, so a scrape storm costs neither a
        # state-lock acquire nor a re-render
        self._metrics_cache: Tuple[float, bytes] = (float("-inf"), b"")
        self._metrics_cache_lock = threading.Lock()
        # coordination-plane flight recorder: quorum issues, promotions,
        # swaps and evictions land here (replica_id "lighthouse" in merged
        # fleet timelines)
        self._flight = FlightRecorder(replica_id="lighthouse")
        # inbound RPC counters by MsgType (the aggregation win is measured
        # here: agg flushes replace per-member heartbeat RPCs)
        self._inbound_counts: Dict[int, int] = {}
        self._inbound_counts_lock = threading.Lock()
        # parked quorum waiters (token → member), re-registered atomically
        # when a quorum excludes them — see _tick_locked
        self._parked: Dict[object, QuorumMember] = {}
        # live client connections, severed at shutdown — a "dead" lighthouse
        # must look dead to connected managers (kill/restart chaos relies on
        # it; the reference's process exit severs everything for free)
        self._conns: set = set()
        self._conns_lock = threading.Lock()

        self._sock = create_listener(bind, backlog=512)
        self._port: int = self._sock.getsockname()[1]

        self._accept_thread = threading.Thread(
            target=self._serve, name="tpuft_lighthouse_accept", daemon=True
        )
        self._accept_thread.start()
        self._tick_thread = threading.Thread(
            target=self._run_ticks, name="tpuft_lighthouse_tick", daemon=True
        )
        self._tick_thread.start()
        logger.info("Lighthouse listening on %s", self.address())

    # -- public surface ----------------------------------------------------

    @property
    def port(self) -> int:
        return self._port

    def address(self) -> str:
        return f"{socket.gethostname()}:{self._port}"

    def local_address(self) -> str:
        return f"127.0.0.1:{self._port}"

    def shutdown(self) -> None:
        self._shutdown = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        with self._lock:
            self._lock.notify_all()

    # -- tick loop ---------------------------------------------------------

    def _run_ticks(self) -> None:
        while not self._shutdown:
            time.sleep(self._cfg.quorum_tick_ms / 1000.0)
            with self._lock:
                self._tick_locked()

    def _log_if_changed(self, reason: str) -> None:
        if reason != self._change_reason:
            logger.info("Quorum status: %s", reason)
            self._change_reason = reason

    def _tick_locked(self) -> None:
        """One quorum decision round (``src/lighthouse.rs:292-343``)."""
        self._last_tick_ts = time.monotonic()
        participants, reason = quorum_compute(time.monotonic(), self._state, self._cfg)
        self._log_if_changed(reason)
        if participants is None:
            return

        commit_failure_ids = [
            m.replica_id for m in participants if m.commit_failures > 0
        ]
        state = self._state
        # eviction accounting is transition-based: a replica entering the
        # evicted set of an ISSUED quorum counts once per continuous
        # eviction episode, independent of membership-change ordering
        newly_shed = [
            r for r in state.evicted_now if r not in state.evicted_prev
        ]
        state.evicted_prev = set(state.evicted_now)
        if newly_shed:
            state.evictions_total += len(newly_shed)
            logger.warning(
                "quorum sheds slow replica(s): %s", ", ".join(newly_shed)
            )
        # degraded floor evictions: same transition-based accounting
        newly_floor_shed = [
            r
            for r in state.degraded_evicted_now
            if r not in state.degraded_evicted_prev
        ]
        state.degraded_evicted_prev = set(state.degraded_evicted_now)
        if newly_floor_shed:
            state.degraded_evictions_total += len(newly_floor_shed)
            logger.warning(
                "quorum evicts replica(s) wounded below the capacity "
                "floor: %s",
                ", ".join(newly_floor_shed),
            )
        if state.prev_quorum is None or _quorum_changed(
            participants, state.prev_quorum.participants
        ):
            state.quorum_id += 1
            logger.info("Detected quorum change, bumping quorum_id to %d", state.quorum_id)
        elif commit_failure_ids:
            state.quorum_id += 1
            logger.info(
                "Detected commit failures in [%s], bumping quorum_id to %d",
                ", ".join(commit_failure_ids),
                state.quorum_id,
            )

        hb_timeout_s = self._cfg.heartbeat_timeout_ms / 1000.0
        agg_timeout_s, grace_s = _agg_freshness_knobs(hb_timeout_s)
        now = time.monotonic()
        quorum = Quorum(
            quorum_id=state.quorum_id,
            participants=list(participants),
            created=time.time(),
            # registered healthy spares ride the version-gated tail: every
            # member (and each spare itself) learns the spare set without
            # the spares ever counting as membership
            spares=sorted(
                (
                    d.member
                    for rid, d in state.spares.items()
                    if _beat_fresh(
                        state,
                        rid,
                        now,
                        _SPARE_FRESH_FACTOR * hb_timeout_s,
                        agg_timeout_s,
                        grace_s,
                    )
                ),
                key=lambda m: m.replica_id,
            ),
        )
        state.prev_quorum = quorum
        state.participants.clear()
        state.hold_since.clear()  # fresh prev quorum, fresh hold anchors
        # flight feed: the coordination plane's side of the fleet timeline
        # (record() is a lock-free deque append — safe under the big lock)
        issue_step = max((m.step for m in quorum.participants), default=-1)
        self._flight.set_context(step=issue_step, quorum_id=state.quorum_id)
        self._flight.record(
            FlightEvent.QUORUM_ISSUE,
            world=len(quorum.participants),
            spares=len(quorum.spares),
        )
        for rid in state.promoted_now:
            self._flight.record(FlightEvent.SPARE_PROMOTE, replica=rid)
        for rid in state.swapped_now:
            self._flight.record(FlightEvent.DEGRADED_SWAP, replica=rid)
        for rid in newly_shed:
            self._flight.record(FlightEvent.EVICT_SLOW, replica=rid)
        for rid in newly_floor_shed:
            self._flight.record(FlightEvent.DEGRADED_EVICT, replica=rid)
        # delta-base ring: waiters advertising this quorum's digest on
        # later rounds receive membership deltas instead of full snapshots
        digest = quorum_digest(quorum)
        quorum._digest = digest
        self._recent_quorums[digest] = quorum
        while len(self._recent_quorums) > _RECENT_QUORUMS_MAX:
            self._recent_quorums.pop(next(iter(self._recent_quorums)))
        # spare registrations are STICKY (unlike participants): a spare
        # spends most of its time warming, not parked on a quorum RPC, and
        # promotion must find it registered the instant an active dies.
        # Dead spares are pruned on heartbeat age instead.
        for rid in [
            rid
            for rid in state.spares
            if now - state.heartbeats.get(rid, float("-inf"))
            > 4 * hb_timeout_s
        ]:
            del state.spares[rid]
            state.spare_ids.discard(rid)
        # Atomically re-register parked waiters the new quorum excluded.
        # The reference re-registers from the waiter's own loop
        # (src/lighthouse.rs:534-543), which can livelock when fast-stepping
        # members re-request (and proactively tick) before an excluded
        # waiter's thread wakes; doing it here closes that race.
        included = {m.replica_id for m in quorum.participants}
        for member in self._parked.values():
            if member.replica_id not in included:
                # NOT an implicit heartbeat: a replica that died while its
                # request was parked must age out on the normal heartbeat
                # timeout, not stay "alive" until its request deadline
                self._register(member, refresh_heartbeat=False)
        self._generation += 1
        self._lock.notify_all()

    # -- connection handling ----------------------------------------------

    def _serve(self) -> None:
        while not self._shutdown:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            configure_server_socket(conn)
            with self._conns_lock:
                if self._shutdown:
                    conn.close()
                    continue
                self._conns.add(conn)
            threading.Thread(
                target=self._handle_conn,
                args=(conn,),
                name="tpuft_lighthouse_conn",
                daemon=True,
            ).start()

    def _handle_conn(self, conn: socket.socket) -> None:
        try:
            # Peek enough bytes to distinguish HTTP from framed RPC; a slow
            # sender may deliver the first bytes across several segments.
            conn.settimeout(10.0)
            head = b""
            sniff_deadline = time.monotonic() + 10.0
            while len(head) < 4:
                head = conn.recv(4, socket.MSG_PEEK)
                if not head or time.monotonic() > sniff_deadline:
                    if len(head) < 4:
                        return
                if len(head) < 4:
                    time.sleep(0.01)
            conn.settimeout(None)
            if head[:3] in (b"GET", b"POS", b"HEA"):
                self._handle_http(conn)
                return
            while True:
                msg_type, r = recv_frame(conn)
                with self._inbound_counts_lock:
                    self._inbound_counts[msg_type] = (
                        self._inbound_counts.get(msg_type, 0) + 1
                    )
                if msg_type == MsgType.LH_QUORUM_REQ:
                    self._handle_quorum(conn, r)
                elif msg_type == MsgType.LH_HEARTBEAT_REQ:
                    replica_id = r.string()
                    # optional comm-health tail (flag byte + CommHealth);
                    # absent on legacy clients
                    health = None
                    if not r.done() and r.u8():
                        health = CommHealth.decode(r)
                    # optional v4 spare warm-step tail (flag byte + i64)
                    warm_step = None
                    if not r.done() and r.u8():
                        warm_step = r.i64()
                    # optional v5 degraded-capacity tail (flag byte + f64)
                    capacity = None
                    if not r.done() and r.u8():
                        capacity = r.f64()
                    with self._lock:
                        now = time.monotonic()
                        state = self._state
                        state.heartbeats[replica_id] = now
                        # a direct beat resets the reporting path: this
                        # member's liveness is judged without agg grace
                        state.via_agg.pop(replica_id, None)
                        if health is not None:
                            note_health(state, replica_id, health, now)
                        if warm_step is not None:
                            _note_warm_step(state, replica_id, warm_step)
                        if capacity is not None:
                            _note_capacity(state, replica_id, capacity)
                    send_frame(conn, MsgType.LH_HEARTBEAT_RESP)
                elif msg_type == MsgType.LH_AGG_BEAT_REQ:
                    # one aggregator flush: every member beat it batched
                    # since the last flush lands under ONE lock acquisition
                    agg = AggBeat.decode(r)
                    with self._lock:
                        now = time.monotonic()
                        state = self._state
                        state.agg_last[agg.agg_id] = now
                        for beat in agg.beats:
                            state.heartbeats[beat.replica_id] = now
                            state.via_agg[beat.replica_id] = agg.agg_id
                            if beat.health is not None:
                                note_health(
                                    state, beat.replica_id, beat.health, now
                                )
                            if beat.role == ROLE_SPARE and beat.warm_step >= 0:
                                _note_warm_step(
                                    state, beat.replica_id, beat.warm_step
                                )
                    send_frame(conn, MsgType.LH_AGG_BEAT_RESP)
                elif msg_type == MsgType.LH_STATUS_REQ:
                    # serve the CACHED pre-serialized snapshot: blob() is
                    # wire-identical to string() (u32 length + utf-8
                    # bytes), so the client's r.string() reads it while
                    # this path pays zero per-poll json.dumps — the same
                    # O(members) cost the TTL cache amortizes for HTTP
                    send_frame(
                        conn,
                        MsgType.LH_STATUS_RESP,
                        Writer().blob(self._status_json()).payload(),
                    )
                else:
                    send_error(conn, ErrCode.INVALID, f"bad lighthouse op {msg_type}")
        except (ConnectionError, OSError, WireError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _register(
        self, requester: QuorumMember, refresh_heartbeat: bool = True
    ) -> None:
        now = time.monotonic()
        state = self._state
        rid = requester.replica_id
        if refresh_heartbeat:
            state.heartbeats[rid] = now  # implicit heartbeat
        if requester.role == ROLE_SPARE and rid not in state.promoted:
            state.spares[rid] = _MemberDetails(joined=now, member=requester)
            state.spare_ids.add(rid)
            state.participants.pop(rid, None)
            return
        if requester.role != ROLE_SPARE:
            # an explicit active registration acknowledges a promotion (or
            # was never a spare); either way this id now counts as active
            state.promoted.discard(rid)
            state.spare_ids.discard(rid)
        if requester.capacity >= 1.0:
            # a full-capacity registration lifts the swapped-out exclusion:
            # the wounded replica healed (or restarted full-width) and is
            # an ordinary candidate again
            state.degraded_swapped.discard(rid)
        state.spares.pop(rid, None)
        state.participants[rid] = _MemberDetails(joined=now, member=requester)

    def _handle_quorum(self, conn: socket.socket, r: Reader) -> None:
        requester = QuorumMember.decode(r)
        timeout_ms = r.u64()
        # v3 role tail (absent on legacy clients); v4 adds the delta base:
        # the digest of the last quorum this requester decoded, so the
        # response can be a membership delta instead of the full list
        base_digest: Optional[int] = None
        if not r.done():
            tail_version = r.u32()
            if tail_version >= 3:
                requester.role = r.u8()
            if tail_version >= 4 and r.boolean():
                r.i64()  # base quorum_id (diagnostic only)
                base_digest = r.u64()
            if tail_version >= 5:
                requester.capacity = min(1.0, max(0.0, r.f64()))
        deadline = time.monotonic() + timeout_ms / 1000.0
        logger.info("Received quorum request for replica %s", requester.replica_id)

        token = object()
        failure: Optional[Tuple[ErrCode, str]] = None
        promoted_fast = False
        with self._lock:
            # Promotion fast-path: a spare the tick loop promoted INTO the
            # standing quorum was (by design) probably warming, not parked,
            # when that quorum was issued — parking it for the NEXT quorum
            # would deadlock against actives already blocked in mesh
            # rendezvous waiting for it.  Hand it the standing quorum now.
            # The ``promoted`` pin is REQUIRED alongside prev membership:
            # a crashed active relaunched by its supervisor as role=spare
            # under the same replica_id also matches prev.participants, and
            # handing THAT cold process the standing quorum would let it
            # join collectives on fresh state (heal=False when the prev
            # member's step equals max_step) — it must park and re-enter
            # as an ordinary warming spare instead.
            if requester.role == ROLE_SPARE:
                prev = self._state.prev_quorum
                if (
                    prev is not None
                    and requester.replica_id in self._state.promoted
                    and any(
                        p.replica_id == requester.replica_id
                        for p in prev.participants
                    )
                ):
                    quorum = prev
                    promoted_fast = True
            if promoted_fast:
                # a heartbeat, not a registration: this spare-role request
                # (a round left in flight from before the promotion) must
                # not join the NEXT round as a participant at its stale
                # warm step — the first active to ask would be handed a
                # quorum at once that heals the promoted replica, whose
                # own active request then waits for a quorum that never
                # comes
                self._state.heartbeats[requester.replica_id] = time.monotonic()
            else:
                self._register(requester)
        if promoted_fast:
            conn.settimeout(30.0)
            try:
                self._send_quorum_resp(conn, quorum, base_digest)
            finally:
                conn.settimeout(None)
            return
        with self._lock:
            self._parked[token] = requester
            gen = self._generation
            try:
                # proactive tick, rate-limited: a fleet-scale registration
                # storm must not run one O(members) quorum_compute per
                # request — the background tick loop (and the requests that
                # do win the rate gate) bound added latency to ~one tick
                if (
                    time.monotonic() - self._last_tick_ts
                    >= 0.5 * self._cfg.quorum_tick_ms / 1000.0
                ):
                    self._tick_locked()
                while True:
                    if self._generation > gen:
                        gen = self._generation
                        quorum = self._state.prev_quorum
                        assert quorum is not None
                        # spares receive EVERY issued quorum (their live view
                        # of membership + max_step); a promoted spare shows
                        # up in participants and learns it from the result
                        if requester.role == ROLE_SPARE or any(
                            p.replica_id == requester.replica_id
                            for p in quorum.participants
                        ):
                            break
                        # Quorum formed without us; _tick_locked already
                        # re-registered us atomically — just keep waiting.
                        logger.info(
                            "Replica %s not in quorum, retrying",
                            requester.replica_id,
                        )
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._shutdown:
                        failure = (
                            ErrCode.SHUTDOWN if self._shutdown else ErrCode.TIMEOUT,
                            f"quorum request for {requester.replica_id!r} "
                            f"{'aborted by shutdown' if self._shutdown else 'timed out'}",
                        )
                        break
                    self._lock.wait(min(remaining, 0.1))
            finally:
                del self._parked[token]

        # socket IO strictly outside the server lock: one dead/slow client's
        # full TCP buffer must never wedge the lighthouse
        conn.settimeout(30.0)
        try:
            if failure is not None:
                send_error(conn, failure[0], failure[1])
                return
            self._send_quorum_resp(conn, quorum, base_digest)
        finally:
            conn.settimeout(None)

    def _quorum_payload(
        self, quorum: Quorum, base_digest: Optional[int]
    ) -> Tuple[int, bytes]:
        """(msg_type, payload) answering one quorum request: a membership
        delta when the requester advertised a base this server still holds
        (and the pin allows v4), else the full snapshot.  Encoded payloads
        are cached per (base, new, version) so a thousand parked waiters
        cost one encode, not a thousand."""
        wire_version = manager_quorum_wire_version()
        new_digest = getattr(quorum, "_digest", None)
        if new_digest is None:
            new_digest = quorum_digest(quorum)
        # quorum_id/created ride the payload but not the digest (a
        # commit-failure round bumps quorum_id with identical membership),
        # so they must be part of the cache key
        issue = (quorum.quorum_id, quorum.created)
        if base_digest is not None and wire_version >= 4:
            base = self._recent_quorums.get(base_digest)
            if base is not None:
                key = ("delta", wire_version, base_digest, new_digest, issue)
                with self._payload_lock:
                    hit = self._payload_cache.get(key)
                if hit is not None:
                    return hit
                w = Writer()
                make_quorum_delta(base, quorum).encode(w)
                resp = (int(MsgType.LH_QUORUM_DELTA_RESP), w.payload())
                with self._payload_lock:
                    if len(self._payload_cache) > _PAYLOAD_CACHE_MAX:
                        self._payload_cache.clear()
                    self._payload_cache[key] = resp
                return resp
        key = ("full", wire_version, new_digest, issue)
        with self._payload_lock:
            hit = self._payload_cache.get(key)
        if hit is not None:
            return hit
        w = Writer()
        quorum.encode(w)
        resp = (int(MsgType.LH_QUORUM_RESP), w.payload())
        with self._payload_lock:
            if len(self._payload_cache) > _PAYLOAD_CACHE_MAX:
                self._payload_cache.clear()
            self._payload_cache[key] = resp
        return resp

    def _send_quorum_resp(
        self, conn: socket.socket, quorum: Quorum, base_digest: Optional[int]
    ) -> None:
        msg_type, payload = self._quorum_payload(quorum, base_digest)
        send_frame(conn, msg_type, payload)

    # -- status / dashboard -------------------------------------------------

    def _status(self) -> dict:
        return self._status_snapshot()[0]

    def _status_json(self) -> bytes:
        return self._status_snapshot()[1]

    def _status_snapshot(self) -> Tuple[dict, bytes]:
        """Serve status from the TTL-cached snapshot: a status storm (the
        dashboard fleet) acquires the quorum state lock at most once per
        ``TORCHFT_STATUS_TTL_S``, and concurrent polls serialize on the
        cache lock, not the quorum loop."""
        ttl = knobs.get_float(STATUS_TTL_S_ENV, 0.5)
        now = time.monotonic()
        with self._status_cache_lock:
            built_ts, snap, raw = self._status_cache
            if snap is not None and now - built_ts < ttl:
                return snap, raw
            snap = self._status_rebuild()
            raw = json.dumps(snap, indent=2).encode()
            self._status_cache = (now, snap, raw)
            return snap, raw

    def _status_rebuild(self) -> dict:
        with self._lock:
            self.status_lock_acquires += 1
            now = time.monotonic()
            # quorum_compute writes state.evicted_now (the tick loop's
            # eviction-accounting channel); a status read must stay
            # side-effect free, so snapshot/restore it and disable the
            # spare-promotion mutation
            saved_evicted = list(self._state.evicted_now)
            _, reason = quorum_compute(
                now, self._state, self._cfg, allow_promote=False
            )
            self._state.evicted_now = saved_evicted
            prev = self._state.prev_quorum
            max_step = (
                max((p.step for p in prev.participants), default=-1) if prev else -1
            )
            # heal-path facts: who is behind (will recover on its next
            # quorum) and how many up-to-date peers can serve a striped heal
            lagging = [
                p.replica_id
                for p in (prev.participants if prev else [])
                if p.step < max_step
            ]
            return {
                # the rebuild's own clock: rate math over cached snapshots
                # must difference counters against THIS, not the caller's
                # poll time (a cached snapshot is up to one TTL stale)
                "now_monotonic": round(now, 3),
                "quorum_id": self._state.quorum_id,
                "quorum_status": reason,
                "max_step": max_step,
                "lagging_replicas": lagging,
                "num_heal_sources": (
                    len(prev.participants) - len(lagging) if prev else 0
                ),
                "num_participants": len(prev.participants) if prev else -1,
                "participants": [
                    {
                        "replica_id": p.replica_id,
                        "address": p.address,
                        "store_address": p.store_address,
                        "step": p.step,
                        "world_size": p.world_size,
                        # degraded-mode capacity column: 1.0 = full width;
                        # a dashboard spots wounded replicas at a glance
                        "capacity": p.capacity,
                    }
                    for p in (prev.participants if prev else [])
                ],
                "heartbeats": {
                    rid: now - ts for rid, ts in self._state.heartbeats.items()
                },
                # gray-failure health column: per-replica comm-health rates
                # (from heartbeat CommHealth summaries) + straggler flags
                "health": {
                    rid: {
                        "stall_rate": round(h.stall_rate, 1),
                        "reconnect_rate": round(h.reconnect_rate, 3),
                        "tx_rate": round(h.tx_rate, 1),
                        "lane_reconnects": h.reconnects,
                        "lane_failovers": h.failovers,
                        "flagged": h.flagged,
                    }
                    for rid, h in self._state.health.items()
                    if h.last is not None
                },
                "evict_slow_enabled": _evict_slow_enabled(),
                "evicted_replicas": list(self._state.evicted_now),
                "evictions_total": self._state.evictions_total,
                # hot-spare table: who is parked warm, how far each shadow
                # lags the commit front, and how many promotions have fired.
                # A spare's "step" is the warm watermark it reported with
                # its last registration — warm_lag_steps is the promotion
                # cost in fragment deltas.
                "spare_promote_enabled": _spare_promote_enabled(),
                "spares": [
                    {
                        "replica_id": d.member.replica_id,
                        "address": d.member.address,
                        "warm_step": d.member.step,
                        "warm_lag_steps": max(0, max_step - d.member.step)
                        if max_step >= 0
                        else None,
                        "heartbeat_age_s": round(
                            now
                            - self._state.heartbeats.get(
                                d.member.replica_id, now
                            ),
                            2,
                        ),
                    }
                    for _rid, d in sorted(self._state.spares.items())
                ],
                "promotions_total": self._state.promotions_total,
                # degraded-mode ladder facts: who is wounded (and how
                # deep), who a spare swapped out, and the floor/eviction
                # policy counters — served from this same TTL-cached
                # snapshot, so the dashboard fleet adds no lock traffic
                "degraded_replicas": [
                    {"replica_id": p.replica_id, "capacity": p.capacity}
                    for p in (prev.participants if prev else [])
                    if p.capacity < 1.0
                ],
                "degraded_swapped_out": sorted(self._state.degraded_swapped),
                "degraded_min_frac": _degraded_min_frac(),
                "degraded_swap_enabled": _degraded_swap_enabled(),
                "degraded_evictions_total": (
                    self._state.degraded_evictions_total
                ),
                "swaps_total": self._state.swaps_total,
                # hierarchical coordination plane: aggregator flush ages +
                # which members currently report via an aggregator, and the
                # inbound RPC counters the aggregation win is measured by
                "aggregators": {
                    agg_id: round(now - ts, 2)
                    for agg_id, ts in sorted(self._state.agg_last.items())
                },
                "aggregated_members": len(self._state.via_agg),
                "rpc_counts": self._inbound_counts_by_name(),
                "status_rebuilds": self.status_lock_acquires,
            }

    def _inbound_counts_by_name(self) -> Dict[str, int]:
        with self._inbound_counts_lock:
            counts = dict(self._inbound_counts)
        out: Dict[str, int] = {}
        for mt, n in sorted(counts.items()):
            try:
                name = MsgType(mt).name
            except ValueError:
                name = f"0x{mt:x}"
            out[name] = n
        return out

    def _metrics_text(self) -> bytes:
        """Prometheus text built from the SAME TTL-cached status snapshot
        (`_status_snapshot`): a scrape storm acquires the quorum state lock
        at most once per ``TORCHFT_STATUS_TTL_S`` — identical contract to
        /status(.json) — and the rendered text is cached per snapshot
        build, keyed on the rebuild's own clock stamp."""
        snap, _raw = self._status_snapshot()
        key = snap["now_monotonic"]
        with self._metrics_cache_lock:
            cached_key, cached = self._metrics_cache
            if cached and cached_key == key:
                return cached
            rendered = self._render_metrics(snap).encode()
            self._metrics_cache = (key, rendered)
            return rendered

    @staticmethod
    def _render_metrics(snap: dict) -> str:
        sample = obs_metrics.metric_sample
        samples = [
            sample("torchft_lh_quorum_id", snap["quorum_id"]),
            sample("torchft_lh_max_step", snap["max_step"]),
            sample("torchft_lh_participants", snap["num_participants"]),
            sample("torchft_lh_heartbeating", len(snap["heartbeats"])),
            sample("torchft_lh_spares", len(snap["spares"])),
            sample(
                "torchft_lh_lagging_replicas", len(snap["lagging_replicas"])
            ),
            sample("torchft_lh_heal_sources", snap["num_heal_sources"]),
            sample("torchft_lh_promotions_total", snap["promotions_total"]),
            sample("torchft_lh_evictions_total", snap["evictions_total"]),
            sample(
                "torchft_lh_degraded_evictions_total",
                snap["degraded_evictions_total"],
            ),
            sample("torchft_lh_swaps_total", snap["swaps_total"]),
            sample(
                "torchft_lh_status_rebuilds_total", snap["status_rebuilds"]
            ),
            sample(
                "torchft_lh_aggregated_members", snap["aggregated_members"]
            ),
        ]
        for rid, age in sorted(snap["heartbeats"].items()):
            samples.append(
                sample(
                    "torchft_lh_heartbeat_age_seconds",
                    age,
                    {"replica_id": rid},
                )
            )
        for p in snap["participants"]:
            labels = {"replica_id": p["replica_id"]}
            samples.append(sample("torchft_lh_replica_step", p["step"], labels))
            samples.append(
                sample("torchft_lh_replica_capacity", p["capacity"], labels)
            )
        for rid, h in sorted(snap["health"].items()):
            labels = {"replica_id": rid}
            samples.append(
                sample("torchft_lh_stall_rate", h["stall_rate"], labels)
            )
            samples.append(
                sample(
                    "torchft_lh_replica_flagged",
                    1 if h["flagged"] else 0,
                    labels,
                )
            )
        for sp in snap["spares"]:
            samples.append(
                sample(
                    "torchft_lh_spare_warm_lag_steps",
                    sp["warm_lag_steps"],
                    {"replica_id": sp["replica_id"]},
                )
            )
        for msg_type, count in snap["rpc_counts"].items():
            samples.append(
                sample(
                    "torchft_lh_rpc_inbound_total",
                    count,
                    {"msg_type": msg_type},
                )
            )
        for agg_id, age in snap["aggregators"].items():
            samples.append(
                sample(
                    "torchft_lh_agg_flush_age_seconds",
                    age,
                    {"agg_id": agg_id},
                )
            )
        return obs_metrics.render(samples)

    def _handle_http(self, conn: socket.socket) -> None:
        """Minimal dashboard (``templates/status.html`` analog)."""
        path = read_http_path(conn)
        if path is None:
            return

        if path.startswith("/replica/") and path.endswith("/kill"):
            replica_id = path[len("/replica/") : -len("/kill")]
            ok, msg = self._kill_replica(replica_id)
            body = json.dumps({"ok": ok, "msg": msg}).encode()
            status = "200 OK" if ok else "404 Not Found"
            ctype = "application/json"
        elif path == "/status.json":
            body = self._status_json()
            status, ctype = "200 OK", "application/json"
        elif path == "/metrics":
            if knobs.get_bool("TORCHFT_METRICS", True):
                body = self._metrics_text()
                status = "200 OK"
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                body = b"metrics disabled\n"
                status, ctype = "404 Not Found", "text/plain"
        else:
            body = self._render_status_html().encode()
            status, ctype = "200 OK", "text/html; charset=utf-8"
        send_http_response(conn, status, ctype, body)

    def _kill_replica(self, replica_id: str) -> Tuple[bool, str]:
        """Dashboard kill button → Kill RPC at the replica's manager
        (``src/lighthouse.rs:454-479``)."""
        with self._lock:
            prev = self._state.prev_quorum
            addr = next(
                (
                    m.address
                    for m in (prev.participants if prev else [])
                    if m.replica_id == replica_id
                ),
                None,
            )
        if addr is None:
            return False, "failed to find replica"
        try:
            sock = connect(addr, timeout=10.0)
            send_frame(sock, MsgType.MGR_KILL_REQ, Writer().string("killed from dashboard").payload())
            sock.close()
            return True, f"kill sent to {replica_id}"
        except OSError as e:
            return False, f"kill failed: {e}"

    def _render_status_html(self) -> str:
        s = self._status()
        cards = "".join(
            f"<div class='card'><b>{html.escape(p['replica_id'])}</b>"
            f"<br>step {p['step']} · ws {p['world_size']}"
            + (
                f" · <b>capacity {p['capacity']:.2f}</b>"
                if p.get("capacity", 1.0) < 1.0
                else ""
            )
            + f"<br><code>{html.escape(p['address'])}</code>"
            f"<br><a href='/replica/{html.escape(p['replica_id'])}/kill'>kill</a></div>"
            for p in s["participants"]
        )
        beats = "".join(
            f"<li><code>{html.escape(rid)}</code>: {age:.1f}s ago</li>"
            for rid, age in sorted(s["heartbeats"].items())
        )
        health_rows = "".join(
            f"<tr><td><code>{html.escape(rid)}</code></td>"
            f"<td>{h['stall_rate']}</td><td>{h['lane_reconnects']}</td>"
            f"<td>{h['lane_failovers']}</td>"
            f"<td>{'FLAGGED' if h['flagged'] else 'ok'}</td></tr>"
            for rid, h in sorted(s["health"].items())
        )
        health_tbl = (
            "<h2>comm health</h2><table border=1 cellpadding=4>"
            "<tr><th>replica</th><th>stall rate /s</th><th>reconnects</th>"
            "<th>failovers</th><th>status</th></tr>"
            f"{health_rows}</table>"
            f"<p>evict_slow={'on' if s['evict_slow_enabled'] else 'off'}"
            f" · evicted now={html.escape(', '.join(s['evicted_replicas']) or 'none')}"
            f" · evictions_total={s['evictions_total']}</p>"
            if health_rows
            else ""
        )
        spare_rows = "".join(
            f"<tr><td><code>{html.escape(sp['replica_id'])}</code></td>"
            f"<td>{sp['warm_step']}</td><td>{sp['warm_lag_steps']}</td>"
            f"<td>{sp['heartbeat_age_s']}s</td>"
            f"<td><code>{html.escape(sp['address'])}</code></td></tr>"
            for sp in s["spares"]
        )
        spare_tbl = (
            "<h2>hot spares</h2><table border=1 cellpadding=4>"
            "<tr><th>spare</th><th>warm step</th><th>lag (steps)</th>"
            "<th>beat</th><th>address</th></tr>"
            f"{spare_rows}</table>"
            f"<p>spare_promote="
            f"{'on' if s['spare_promote_enabled'] else 'off'}"
            f" · promotions_total={s['promotions_total']}</p>"
            if spare_rows or s["promotions_total"]
            else ""
        )
        return (
            "<html><head><title>torchft_tpu lighthouse</title><style>"
            "body{font-family:monospace;margin:2em}.card{border:1px solid #999;"
            "display:inline-block;padding:1em;margin:.5em}</style></head><body>"
            f"<h1>torchft_tpu lighthouse</h1>"
            f"<p>quorum_id={s['quorum_id']} · status: {html.escape(s['quorum_status'])}</p>"
            f"<p>max_step={s['max_step']} · participants={s['num_participants']}"
            f" · heal sources={s['num_heal_sources']}"
            f" · lagging={html.escape(', '.join(s['lagging_replicas']) or 'none')}</p>"
            f"{cards}{health_tbl}{spare_tbl}"
            f"<h2>heartbeats</h2><ul>{beats}</ul></body></html>"
        )


class LighthouseClient(RpcClient):
    """Client for :class:`LighthouseServer` (pyo3 analog ``src/lib.rs:486-594``).

    Under wire v4 the client caches the last quorum it decoded and
    advertises its digest on every request; the server answers with a
    membership delta (``LH_QUORUM_DELTA_RESP``) when it still holds that
    base, and with the full snapshot otherwise — so steady-state broadcast
    bytes are O(changes), not O(members).  ``delta_responses`` /
    ``full_responses`` count which path each round took (harness +
    observability input)."""

    def __init__(self, addr: str, connect_timeout: float = 60.0) -> None:
        super().__init__(addr, connect_timeout=connect_timeout)
        # delta-coded broadcast cache: mutated only inside quorum(), which
        # callers serialize like every other rpc on this client
        self._quorum_cache: Optional[Quorum] = None
        self._quorum_cache_digest = 0
        self.delta_responses = 0
        self.full_responses = 0

    def quorum(
        self,
        replica_id: str,
        timeout: float,
        address: str = "",
        store_address: str = "",
        step: int = 0,
        world_size: int = 1,
        shrink_only: bool = False,
        commit_failures: int = 0,
        data: Optional[dict] = None,
        role: int = ROLE_ACTIVE,
        capacity: float = 1.0,
    ) -> Quorum:
        """Block until a quorum containing this replica is issued (or, for
        ``role=ROLE_SPARE``, until ANY quorum is issued — the spare's live
        view of membership and the commit front).

        ``data`` is an arbitrary JSON-serializable dict carried opaquely in
        the member record (``src/lib.rs:430-451``).
        """
        member = QuorumMember(
            replica_id=replica_id,
            address=address,
            store_address=store_address,
            step=step,
            world_size=world_size,
            shrink_only=shrink_only,
            commit_failures=commit_failures,
            data=json.dumps(data) if data else "",
            role=role,
        )
        w = Writer()
        member.encode(w)
        w.u64(int(timeout * 1000))
        wire_version = manager_quorum_wire_version()
        if role != ROLE_ACTIVE and wire_version < 3:
            # never degrade silently: dropping the role tail would
            # register this spare as a full ACTIVE (counted toward
            # min_replicas/majority) on the lighthouse
            raise ValueError(
                f"role={role} requires quorum wire v3 "
                f"({WIRE_COMPAT_ENV} pins an older version)"
            )
        base = self._quorum_cache if wire_version >= 4 else None
        has_capacity_tail = wire_version >= 5 and capacity != 1.0
        if wire_version >= 4:
            # v4 tail: role + the delta base this client can apply edits
            # to.  A v3 (or older) server reads the role and ignores the
            # rest; it can only ever answer with a full snapshot.  v5
            # appends the degraded-capacity fraction, emitted only when
            # this replica is actually wounded — a full-capacity request
            # stays byte-identical to v4 (a full-capacity registration is
            # also how a healed replica advertises its restoration).
            w.u32(5 if has_capacity_tail else 4)
            w.u8(role)
            w.boolean(base is not None)
            if base is not None:
                w.i64(base.quorum_id)
                w.u64(self._quorum_cache_digest)
            if has_capacity_tail:
                w.f64(capacity)
        elif role != ROLE_ACTIVE:
            # version-gated v3 tail: active members stay byte-identical to
            # v2 (a legacy or native-tier lighthouse never sees spare
            # frames)
            w.u32(3)
            w.u8(role)
        msg_type, r = self.call(MsgType.LH_QUORUM_REQ, w.payload(), timeout)
        raise_if_error(msg_type, r)
        if msg_type == MsgType.LH_QUORUM_DELTA_RESP:
            delta = QuorumDelta.decode(r)
            try:
                quorum = apply_quorum_delta(
                    base, delta, base_digest=self._quorum_cache_digest
                )
            except WireError:
                # divergent base: clear the cache so the retry advertises
                # no base and receives a full snapshot
                self._quorum_cache = None
                raise
            self.delta_responses += 1
        else:
            quorum = Quorum.decode(r)
            self.full_responses += 1
        if wire_version >= 4:
            self._quorum_cache = quorum
            self._quorum_cache_digest = quorum_digest(quorum)
        return quorum

    def heartbeat(
        self,
        replica_id: str,
        timeout: float = 5.0,
        health: Optional[CommHealth] = None,
        warm_step: Optional[int] = None,
        capacity: Optional[float] = None,
    ) -> None:
        """Heartbeat, optionally carrying a cumulative comm-health summary
        (straggler detection input), a spare warm-step watermark under wire
        v4 (keeps the lighthouse's promotion-eligibility view fresh at beat
        cadence), and a degraded-capacity fraction under wire v5 (keeps
        the wound→swap→evict ladder fresh at beat cadence; emitted only
        when degraded, so full-capacity beats stay byte-identical to v4).
        Idempotent: one reconnect-retry rides out a lighthouse connection
        blip instead of crashing the sender."""
        w = Writer().string(replica_id)
        send_warm = warm_step is not None and manager_quorum_wire_version() >= 4
        send_cap = (
            capacity is not None
            and capacity != 1.0
            and manager_quorum_wire_version() >= 5
        )
        if health is not None or send_warm or send_cap:
            w.u8(1 if health is not None else 0)
            if health is not None:
                health.encode(w)
        if send_warm or send_cap:
            w.u8(1 if send_warm else 0)
            if send_warm:
                w.i64(warm_step)
        if send_cap:
            w.u8(1)
            w.f64(capacity)
        msg_type, r = self.call(
            MsgType.LH_HEARTBEAT_REQ, w.payload(), timeout, idempotent=True
        )
        raise_if_error(msg_type, r)

    def status(self, timeout: float = 5.0) -> dict:
        msg_type, r = self.call(
            MsgType.LH_STATUS_REQ, b"", timeout, idempotent=True
        )
        raise_if_error(msg_type, r)
        return json.loads(r.string())


def lighthouse_main(argv: Optional[List[str]] = None) -> None:
    """CLI entry point (``src/bin/lighthouse.rs``)."""
    parser = argparse.ArgumentParser("torchft_tpu_lighthouse")
    parser.add_argument("--bind", default="0.0.0.0:29510")
    parser.add_argument("--min_replicas", type=int, required=True)
    parser.add_argument("--join_timeout_ms", type=int, default=60_000)
    parser.add_argument("--quorum_tick_ms", type=int, default=100)
    parser.add_argument("--heartbeat_timeout_ms", type=int, default=5_000)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = LighthouseServer(
        bind=args.bind,
        min_replicas=args.min_replicas,
        join_timeout_ms=args.join_timeout_ms,
        quorum_tick_ms=args.quorum_tick_ms,
        heartbeat_timeout_ms=args.heartbeat_timeout_ms,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    lighthouse_main()
