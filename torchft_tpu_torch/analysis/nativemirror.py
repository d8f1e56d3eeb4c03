"""Native-mirror checker: the C++ tier's hand-mirrored constants.

The port's ``csrc/native/comm.h`` and ``csrc/native/wire.h`` deliberately
re-implement the Python tier's wire math (``lane_parts``, ``outer_shard_parts``,
``HostTopology``, the lane-hello flag, the 64-byte stripe alignment, the
frame cap, the message-type enums) so the two tiers stay byte-compatible
on the wire.  Nothing enforces the mirror — this checker does, by parsing
the headers textually (no C++ toolchain needed at lint time) and comparing
every shared constant against its live Python counterpart:

- ``kMaxFrameBytes``        == ``wire.MAX_FRAME_BYTES``
- ``MsgType`` / ``ErrCode`` values (every native entry must exist in
  Python under the same value; ``ERROR_FRAME`` maps to ``ERROR``)
- ``kLaneHelloFlag``        == ``communicator._LANE_HELLO_FLAG``
- stripe alignment: ``lane_parts``'s ``/ 64 * 64`` cut and
  ``outer_shard_parts``'s ``unit % 64`` / ``unit = 64`` default
  == ``communicator._STRIPE_ALIGN``
- ``kMinStripeBytes``       == ``communicator._MIN_STRIPE_BYTES``
- ``kMaxAutoLanes``         == ``communicator._MAX_AUTO_LANES``
- ``kRingReduceTagBase``    == ``wire.RING_REDUCE_TAG_BASE``
- pacer knob names: ``comm.h`` must reference every ``TORCHFT_NET_*`` env
  knob the Python ``_NetEmu`` reads (same pacing model on both tiers), and
  its ``kNetEmuProfiles`` table must match ``communicator._NET_EMU_PROFILES``
  name-for-name and value-for-value in both directions
- per-lane counter names: ``comm.h`` must define the ``lane_tx_bytes`` /
  ``lane_rx_bytes`` / ``lane_stalls`` counters and ``native.py`` must
  export the same ``lane_stats()`` keys the Python tier does, so
  ``manager.last_quorum_timings`` stays tier-agnostic
- flight-recorder event ids: every ``kFlight<Name> = N`` constant in
  ``comm.h`` must match ``obs.flight.FlightEvent.<NAME>`` (CamelCase →
  UPPER_SNAKE) value-for-value, the C ring must exist
  (``tpuft_comm_flight_drain`` + the configure/abort record sites), and
  the binding must mirror the ring slot count
- the ``outer_shard_parts`` padding formula matches the canonical
  ceil-to-unit form, and mirrored symbols (``HostTopology`` with its
  ``worth_it`` auto criterion, ``lane_parts``, ``outer_shard_parts``)
  exist at all.

``kMaxIovSegs`` (the most payload segments one ``sendmsg``/``recvmsg``
carries) has no Python counterpart to hold it against: the binding hands
the C side whole buffer lists and the batching into syscalls happens in C
alone, so the port's binding declares no mirror of it and this checker
does not look for one (the JAX package's ``native.py`` keeps an unused
``_MAX_IOV_SEGS`` for its checker's sake).
"""

from __future__ import annotations

import os
import re
from typing import List

from torchft_tpu_torch.analysis.core import Finding

CHECKER = "native-mirror"

_COMM_H = os.path.join("torchft_tpu_torch", "csrc", "native", "comm.h")
_WIRE_H = os.path.join("torchft_tpu_torch", "csrc", "native", "wire.h")
_BINDING = os.path.join("torchft_tpu_torch", "native.py")

# the env knobs the Python _NetEmu pacer reads; the native pacer must read
# the same set or cross-tier benches shape only one side of the wire
_PACER_KNOBS = (
    "TORCHFT_NET_EMU",
    "TORCHFT_NET_GBPS",
    "TORCHFT_NET_RTT_MS",
    "TORCHFT_NET_CWND_KB",
)

# the tier-agnostic lane_stats() core keys (TCPCommunicator.lane_stats);
# the native binding must export the same names
_LANE_STAT_KEYS = (
    "lanes",
    "stripe_floor_bytes",
    "lane_tx_bytes",
    "lane_rx_bytes",
    "lane_stalls",
)


def _finding(rel: str, line: int, symbol: str, message: str) -> Finding:
    return Finding(
        checker=CHECKER, file=rel, line=line, symbol=symbol, message=message
    )


def _line_of(text: str, pattern: str) -> int:
    m = re.search(pattern, text)
    return text[: m.start()].count("\n") + 1 if m else 1


def check_wire_header(text: str, rel: str = _WIRE_H) -> List[Finding]:
    from torchft_tpu_torch import wire as pywire

    findings: List[Finding] = []

    m = re.search(r"kMaxFrameBytes\s*=\s*(\d+)ull\s*\*\s*1024\s*\*\s*1024", text)
    if not m:
        findings.append(
            _finding(rel, 1, "kMaxFrameBytes", "kMaxFrameBytes not found in wire.h")
        )
    elif int(m.group(1)) * 1024 * 1024 != pywire.MAX_FRAME_BYTES:
        findings.append(
            _finding(
                rel,
                _line_of(text, r"kMaxFrameBytes"),
                "kMaxFrameBytes",
                f"kMaxFrameBytes = {int(m.group(1))} MiB but Python "
                f"wire.MAX_FRAME_BYTES = {pywire.MAX_FRAME_BYTES} bytes",
            )
        )

    name_map = {"ERROR_FRAME": "ERROR"}
    for cname, value_str in re.findall(
        r"^\s*([A-Z][A-Z0-9_]+)\s*=\s*(0x[0-9A-Fa-f]+|\d+)\s*,", text, re.M
    ):
        value = int(value_str, 0)
        if cname.startswith("ERR_"):
            pyname = cname[len("ERR_"):]
            table = {e.name: e.value for e in pywire.ErrCode}
        else:
            pyname = name_map.get(cname, cname)
            table = {e.name: e.value for e in pywire.MsgType}
        if pyname not in table:
            findings.append(
                _finding(
                    rel,
                    _line_of(text, re.escape(cname)),
                    cname,
                    f"native enum {cname} has no Python counterpart "
                    f"({pyname} not in wire.MsgType/ErrCode)",
                )
            )
        elif table[pyname] != value:
            findings.append(
                _finding(
                    rel,
                    _line_of(text, re.escape(cname)),
                    cname,
                    f"native {cname} = {value:#x} but Python "
                    f"{pyname} = {table[pyname]:#x}",
                )
            )
    return findings


def check_comm_header(text: str, rel: str = _COMM_H) -> List[Finding]:
    from torchft_tpu_torch import communicator as pycomm

    findings: List[Finding] = []

    # mirrored symbols must exist at all
    for symbol, pattern in (
        ("HostTopology", r"struct\s+HostTopology"),
        ("HostTopology.worth_it", r"bool\s+worth_it\s*\("),
        ("lane_parts", r"\blane_parts\s*\("),
        ("outer_shard_parts", r"\bouter_shard_parts\s*\("),
        ("kLaneHelloFlag", r"kLaneHelloFlag"),
    ):
        if not re.search(pattern, text):
            findings.append(
                _finding(
                    rel,
                    1,
                    symbol,
                    f"mirrored symbol {symbol} not found in comm.h — the "
                    f"native tier no longer mirrors the Python wire math",
                )
            )

    # lane hello flag
    m = re.search(r"kLaneHelloFlag\s*=\s*uint64_t\(1\)\s*<<\s*(\d+)", text)
    if m and (1 << int(m.group(1))) != pycomm._LANE_HELLO_FLAG:
        findings.append(
            _finding(
                rel,
                _line_of(text, r"kLaneHelloFlag"),
                "kLaneHelloFlag",
                f"kLaneHelloFlag = 1<<{m.group(1)} but Python "
                f"_LANE_HELLO_FLAG = {pycomm._LANE_HELLO_FLAG:#x}",
            )
        )

    align = pycomm._STRIPE_ALIGN

    # lane_parts 64-byte cut:  cut = (i * nbytes / k) / 64 * 64
    m = re.search(r"\(i \* nbytes / k\)\s*/\s*(\d+)\s*\*\s*(\d+)", text)
    if m and (int(m.group(1)) != align or int(m.group(2)) != align):
        findings.append(
            _finding(
                rel,
                _line_of(text, r"\(i \* nbytes / k\)"),
                "lane_parts.align",
                f"lane_parts aligns cuts to {m.group(1)} bytes but Python "
                f"_STRIPE_ALIGN = {align}",
            )
        )

    # outer_shard_parts: unit check + default + padding formula
    m = re.search(r"unit\s*%\s*(\d+)\s*!=\s*0", text)
    if m and int(m.group(1)) != align:
        findings.append(
            _finding(
                rel,
                _line_of(text, r"unit\s*%"),
                "outer_shard_parts.unit",
                f"outer_shard_parts requires unit %% {m.group(1)} == 0 but "
                f"Python requires a multiple of {align}",
            )
        )
    m = re.search(r"size_t\s+unit\s*=\s*(\d+)", text)
    if m and int(m.group(1)) != align:
        findings.append(
            _finding(
                rel,
                _line_of(text, r"size_t\s+unit\s*="),
                "outer_shard_parts.default_unit",
                f"outer_shard_parts default unit = {m.group(1)} but Python "
                f"default is _STRIPE_ALIGN = {align}",
            )
        )
    if re.search(r"\bouter_shard_parts\s*\(", text) and not re.search(
        r"share\s*=\s*\(nbytes \+ parts \* unit - 1\)\s*/\s*\(parts \* unit\)\s*\*\s*unit",
        text,
    ):
        findings.append(
            _finding(
                rel,
                _line_of(text, r"outer_shard_parts"),
                "outer_shard_parts.formula",
                "outer_shard_parts share formula drifted from the canonical "
                "ceil(nbytes / (parts*unit)) * unit — Python "
                "communicator.outer_shard_parts computes "
                "-(-nbytes // (parts * unit)) * unit",
            )
        )

    # default stripe floor (kMinStripeBytes) + auto-lane cap (kMaxAutoLanes)
    m = re.search(r"kMinStripeBytes\s*=\s*size_t\((\d+)\)\s*<<\s*(\d+)", text)
    if m:
        native_floor = int(m.group(1)) << int(m.group(2))
        if native_floor != pycomm._MIN_STRIPE_BYTES:
            findings.append(
                _finding(
                    rel,
                    _line_of(text, r"kMinStripeBytes"),
                    "kMinStripeBytes",
                    f"native kMinStripeBytes = {native_floor} but Python "
                    f"_MIN_STRIPE_BYTES = {pycomm._MIN_STRIPE_BYTES}",
                )
            )
    m = re.search(r"kMaxAutoLanes\s*=\s*(\d+)", text)
    if m and int(m.group(1)) != pycomm._MAX_AUTO_LANES:
        findings.append(
            _finding(
                rel,
                _line_of(text, r"kMaxAutoLanes"),
                "kMaxAutoLanes",
                f"native kMaxAutoLanes = {m.group(1)} but Python "
                f"_MAX_AUTO_LANES = {pycomm._MAX_AUTO_LANES}",
            )
        )

    # explicit reduce_scatter tag window — a drift here frames the ring at
    # the wrong tags against a Python peer (silent cross-tier corruption)
    m = re.search(r"kRingReduceTagBase\s*=\s*(\d+)", text)
    from torchft_tpu_torch import wire as pywire

    if not m:
        findings.append(
            _finding(
                rel,
                1,
                "kRingReduceTagBase",
                "kRingReduceTagBase not found in comm.h — the native "
                "reduce_scatter no longer mirrors wire.RING_REDUCE_TAG_BASE",
            )
        )
    elif int(m.group(1)) != pywire.RING_REDUCE_TAG_BASE:
        findings.append(
            _finding(
                rel,
                _line_of(text, r"kRingReduceTagBase"),
                "kRingReduceTagBase",
                f"native kRingReduceTagBase = {m.group(1)} but Python "
                f"wire.RING_REDUCE_TAG_BASE = {pywire.RING_REDUCE_TAG_BASE}",
            )
        )

    # pacer knob names: the native Pacer must read the same env surface
    for knob in _PACER_KNOBS:
        if knob not in text:
            findings.append(
                _finding(
                    rel,
                    1,
                    f"pacer.{knob}",
                    f"native pacer does not reference {knob} — the Python "
                    "_NetEmu reads it, so cross-tier benches would shape "
                    "only one side of the wire",
                )
            )

    # pacer profile table: names and (gbps, rtt_ms) values both directions
    native_profiles = {
        name: (float(g), float(r))
        for name, g, r in re.findall(
            r'\{"(\w+)",\s*([\d.]+),\s*([\d.]+)\}', text
        )
    }
    py_profiles = {
        name: (float(g), float(r))
        for name, (g, r) in pycomm._NET_EMU_PROFILES.items()
    }
    if native_profiles:
        for name, vals in py_profiles.items():
            if name not in native_profiles:
                findings.append(
                    _finding(
                        rel,
                        _line_of(text, r"kNetEmuProfiles"),
                        f"pacer.profile.{name}",
                        f"Python _NET_EMU_PROFILES has {name!r} but the "
                        "native kNetEmuProfiles table does not",
                    )
                )
            elif native_profiles[name] != vals:
                findings.append(
                    _finding(
                        rel,
                        _line_of(text, re.escape(name)),
                        f"pacer.profile.{name}",
                        f"native profile {name} = {native_profiles[name]} "
                        f"but Python = {vals}",
                    )
                )
        for name in native_profiles:
            if name not in py_profiles:
                findings.append(
                    _finding(
                        rel,
                        _line_of(text, re.escape(name)),
                        f"pacer.profile.{name}",
                        f"native kNetEmuProfiles has {name!r} but Python "
                        "_NET_EMU_PROFILES does not",
                    )
                )
    elif "kNetEmuProfiles" not in text:
        findings.append(
            _finding(
                rel,
                1,
                "kNetEmuProfiles",
                "kNetEmuProfiles table not found in comm.h — the native "
                "pacer no longer mirrors the Python profile set",
            )
        )

    # per-lane counters: the members feeding the tier-agnostic lane_stats
    for counter in ("lane_tx_bytes", "lane_rx_bytes", "lane_stalls"):
        if counter not in text:
            findings.append(
                _finding(
                    rel,
                    1,
                    f"counter.{counter}",
                    f"native comm.h defines no {counter} counter — the "
                    "tier-agnostic lane_stats surface is broken",
                )
            )

    findings.extend(check_flight_events(text, rel))
    return findings


def _camel_to_upper_snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).upper()


def check_flight_events(text: str, rel: str = _COMM_H) -> List[Finding]:
    """The C-side flight ring's event-id mirror: every ``kFlight<Name>``
    constant must match ``obs.flight.FlightEvent.<NAME>`` value-for-value,
    and the ring itself (drain + record sites) must exist."""
    from torchft_tpu_torch.obs.flight import FlightEvent

    findings: List[Finding] = []
    py_events = {e.name: e.value for e in FlightEvent}
    native_ids = re.findall(
        r"kFlight([A-Za-z0-9]+)\s*=\s*(\d+)\s*;", text
    )
    event_ids = [
        (cname, value)
        for cname, value in native_ids
        if cname not in ("RingSlots",)
    ]
    if not event_ids:
        findings.append(
            _finding(
                rel,
                1,
                "kFlightEvents",
                "no kFlight* event ids found in comm.h — the native tier "
                "no longer mirrors the obs/flight.py event enum",
            )
        )
    for cname, value_str in event_ids:
        pyname = _camel_to_upper_snake(cname)
        value = int(value_str)
        if pyname not in py_events:
            findings.append(
                _finding(
                    rel,
                    _line_of(text, rf"kFlight{cname}"),
                    f"kFlight{cname}",
                    f"native flight event kFlight{cname} has no Python "
                    f"counterpart (FlightEvent.{pyname} missing)",
                )
            )
        elif py_events[pyname] != value:
            findings.append(
                _finding(
                    rel,
                    _line_of(text, rf"kFlight{cname}"),
                    f"kFlight{cname}",
                    f"native kFlight{cname} = {value} but Python "
                    f"FlightEvent.{pyname} = {py_events[pyname]}",
                )
            )
    for symbol, pattern in (
        ("flight_drain", r"\bflight_drain\s*\("),
        ("flight_record.configure", r"flight_record\(kFlightCommConfigure"),
        ("flight_record.abort", r"flight_record\(kFlightCommAbort"),
    ):
        if not re.search(pattern, text):
            findings.append(
                _finding(
                    rel,
                    1,
                    symbol,
                    f"flight-ring symbol {symbol} not found in comm.h — "
                    "the native epoch lifecycle is no longer recorded",
                )
            )
    return findings


def check_binding(text: str, rel: str = _BINDING) -> List[Finding]:
    """The ctypes binding's mirrored surface: lane_stats key parity with
    the Python tier and the flight ring's drain and slot count."""
    findings: List[Finding] = []
    for key in _LANE_STAT_KEYS:
        if f'"{key}"' not in text:
            findings.append(
                _finding(
                    rel,
                    _line_of(text, r"def lane_stats"),
                    f"lane_stats.{key}",
                    f"native.py lane_stats() does not export {key!r} — "
                    "TCPCommunicator.lane_stats() does, so "
                    "manager.last_quorum_timings would lose it on the "
                    "native tier",
                )
            )
    # flight-ring binding: the C-side ring must actually drain into dumps
    if "tpuft_comm_flight_drain" not in text:
        findings.append(
            _finding(
                rel,
                1,
                "tpuft_comm_flight_drain",
                "native.py never calls tpuft_comm_flight_drain — the "
                "C-side flight ring would never merge into Python dumps",
            )
        )
    if not re.search(r"#\s*mirror of comm\.h kFlightRingSlots", text):
        findings.append(
            _finding(
                rel,
                _line_of(text, r"def flight_drain"),
                "flight_drain.cap",
                "flight_drain's drain capacity is not annotated as the "
                "kFlightRingSlots mirror — a comm.h resize would silently "
                "truncate drains",
            )
        )
    return findings


def check_flight_ring_slots(
    comm_text: str, binding_text: str, rel: str = _BINDING
) -> List[Finding]:
    """Cross-file value check: the binding's drain capacity must EQUAL
    comm.h's kFlightRingSlots — a comment alone would let a ring resize
    silently truncate drains."""
    native = re.search(r"kFlightRingSlots\s*=\s*(\d+)", comm_text)
    binding = re.search(
        r"cap\s*=\s*(\d+)\s*#\s*mirror of comm\.h kFlightRingSlots",
        binding_text,
    )
    if not native or not binding:
        return []  # absence findings come from the per-file checks
    if int(native.group(1)) != int(binding.group(1)):
        return [
            _finding(
                rel,
                _line_of(binding_text, r"def flight_drain"),
                "flight_drain.cap",
                f"flight_drain drains at most {binding.group(1)} events "
                f"but comm.h kFlightRingSlots = {native.group(1)} — a "
                f"full native ring would silently truncate at dump time",
            )
        ]
    return []


def check(root: str) -> List[Finding]:
    findings: List[Finding] = []
    texts: dict = {}
    for rel, fn in (
        (_WIRE_H, check_wire_header),
        (_COMM_H, check_comm_header),
        (_BINDING, check_binding),
    ):
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            findings.append(
                _finding(
                    rel.replace(os.sep, "/"),
                    1,
                    "header",
                    f"{rel} missing — cannot verify the native mirror",
                )
            )
            continue
        with open(path) as f:
            texts[rel] = f.read()
        findings.extend(fn(texts[rel], rel.replace(os.sep, "/")))
    if _COMM_H in texts and _BINDING in texts:
        findings.extend(
            check_flight_ring_slots(
                texts[_COMM_H],
                texts[_BINDING],
                _BINDING.replace(os.sep, "/"),
            )
        )
    return findings
