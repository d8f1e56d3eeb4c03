"""The port's hierarchical coordination plane (``torchft_tpu_torch.coord``)
beside the JAX package's: ``tests/test_coord.py``'s cases on the port's
copies (wire v4 codecs, the delta-coded broadcast, the ZoneAggregator, the
aggregator-death grace, the manager beat routing through
``TORCHFT_AGG_ADDR`` and its fallbacks, the scale harness at 200
replicas), each codec's bytes against the JAX package's, and fleets that
mix the packages: a port member beating through a JAX aggregator into a
port lighthouse and the reverse, with the frames on the wire equal byte
for byte.  The 500-replica run and ``coord_churn_drill`` are slow-marked,
as their JAX twins are.
"""

import socket
import threading
import time

import pytest

from torchft_tpu import wire as jwire
from torchft_tpu.coord.aggregator import AggMemberClient as JaxAggMemberClient
from torchft_tpu.coord.aggregator import ZoneAggregator as JaxZoneAggregator
from torchft_tpu.lighthouse import LighthouseServer as JaxLighthouseServer
from torchft_tpu_torch.coord.aggregator import AggMemberClient, ZoneAggregator
from torchft_tpu_torch.lighthouse import (
    LighthouseClient,
    LighthouseConfig,
    LighthouseServer,
    _MemberDetails,
    _State,
    quorum_compute,
)
from torchft_tpu_torch.manager_server import ManagerServer
from torchft_tpu_torch.wire import (
    ROLE_SPARE,
    AggBeat,
    CommHealth,
    MemberBeat,
    MsgType,
    Quorum,
    QuorumDelta,
    QuorumMember,
    Reader,
    WireError,
    Writer,
    apply_quorum_delta,
    make_quorum_delta,
    quorum_digest,
    recv_frame,
    send_frame,
)


def _member(rid: str, step: int = 1, mod=None, **kw):
    """A QuorumMember of the port's wire, or of ``mod``'s (a wire module)."""
    cls = QuorumMember if mod is None else mod.QuorumMember
    return cls(
        replica_id=rid,
        address=f"addr_{rid}",
        store_address=f"store_{rid}",
        step=step,
        world_size=1,
        **kw,
    )


def _encoded(obj) -> bytes:
    w = Writer()
    obj.encode(w)
    return w.payload()


def _jax_encoded(obj) -> bytes:
    w = jwire.Writer()
    obj.encode(w)
    return w.payload()


def _wait(pred, timeout_s: float = 8.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def _lighthouse(cls=LighthouseServer):
    return cls(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=1, quorum_tick_ms=10)


def _dead_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


class TestWireV4Codecs:
    """The port's codecs round-trip, and encode the JAX package's bytes."""

    def test_member_beat_roundtrip(self) -> None:
        for health, jhealth in ((None, None), (CommHealth(stalls=7, tx_bytes=123),
                                               jwire.CommHealth(stalls=7, tx_bytes=123))):
            beat = MemberBeat(replica_id="r0", role=ROLE_SPARE, warm_step=42, health=health)
            out = MemberBeat.decode(Reader(_encoded(beat)))
            assert out == beat
            jbeat = jwire.MemberBeat(replica_id="r0", role=jwire.ROLE_SPARE, warm_step=42,
                                     health=jhealth)
            assert _encoded(beat) == _jax_encoded(jbeat)

    def test_agg_beat_roundtrip(self) -> None:
        agg = AggBeat(
            agg_id="zone_a",
            beats=[
                MemberBeat(replica_id="r0"),
                MemberBeat(replica_id="r1", role=ROLE_SPARE, warm_step=3,
                           health=CommHealth(reconnects=2)),
            ],
        )
        assert AggBeat.decode(Reader(_encoded(agg))) == agg
        jagg = jwire.AggBeat(
            agg_id="zone_a",
            beats=[
                jwire.MemberBeat(replica_id="r0"),
                jwire.MemberBeat(replica_id="r1", role=jwire.ROLE_SPARE, warm_step=3,
                                 health=jwire.CommHealth(reconnects=2)),
            ],
        )
        assert _encoded(agg) == _jax_encoded(jagg)

    def test_quorum_delta_roundtrip(self) -> None:
        kw = dict(quorum_id=7, created=123.5, base_digest=0xDEAD, new_digest=0xBEEF,
                  removed=["gone"], step_updates=[(0, 10, 0), (2, 11, 1)],
                  spare_removed=["old_spare"])
        delta = QuorumDelta(upserts=[_member("new", step=9)],
                            spare_upserts=[_member("sp", step=8)], **kw)
        out = QuorumDelta.decode(Reader(_encoded(delta)))
        assert out.quorum_id == 7
        assert out.removed == ["gone"]
        assert out.step_updates == [(0, 10, 0), (2, 11, 1)]
        assert out.upserts == delta.upserts
        # spare upserts decode with the SPARE role pinned
        assert all(s.role == ROLE_SPARE for s in out.spare_upserts)
        jdelta = jwire.QuorumDelta(upserts=[_member("new", step=9, mod=jwire)],
                                   spare_upserts=[_member("sp", step=8, mod=jwire)], **kw)
        assert _encoded(delta) == _jax_encoded(jdelta)

    def test_make_apply_delta(self) -> None:
        def quorums(mod):
            base = mod.Quorum(
                quorum_id=3, created=100.0,
                participants=[_member(r, step=5, mod=mod) for r in ("a", "b", "c")],
                spares=[_member("sp0", step=4, mod=mod)],
            )
            new = mod.Quorum(
                quorum_id=4, created=101.0,
                participants=[_member(r, step=6, mod=mod) for r in ("a", "c", "d")],
                spares=[_member("sp1", step=5, mod=mod)],
            )
            return base, new

        import torchft_tpu_torch.wire as pwire

        base, new = quorums(pwire)
        delta = make_quorum_delta(base, new)
        assert delta.removed == ["b"]
        assert [m.replica_id for m in delta.upserts] == ["d"]
        assert sorted(delta.step_updates) == [(0, 6, 0), (2, 6, 0)]
        assert delta.spare_removed == ["sp0"]
        assert [s.replica_id for s in delta.spare_upserts] == ["sp1"]
        applied = apply_quorum_delta(base, delta)
        assert quorum_digest(applied) == quorum_digest(new)
        assert applied.quorum_id == 4
        assert [p.replica_id for p in applied.participants] == ["a", "c", "d"]
        assert all(p.step == 6 for p in applied.participants)
        jbase, jnew = quorums(jwire)
        jdelta = jwire.make_quorum_delta(jbase, jnew)
        assert _encoded(delta) == _jax_encoded(jdelta)
        assert quorum_digest(new) == jwire.quorum_digest(jnew)

    def test_apply_delta_rejects_divergent_base(self) -> None:
        base = Quorum(quorum_id=1, participants=[_member("a")])
        other = Quorum(quorum_id=1, participants=[_member("z")])
        new = Quorum(quorum_id=2, participants=[_member("a", step=2)])
        delta = make_quorum_delta(base, new)
        with pytest.raises(WireError):
            apply_quorum_delta(other, delta)
        with pytest.raises(WireError):
            apply_quorum_delta(None, delta)

    def test_digest_ignores_role_and_issue_facts(self) -> None:
        a = Quorum(quorum_id=1, created=5.0, participants=[_member("a")])
        b = Quorum(quorum_id=9, created=6.0, participants=[_member("a")])
        b.participants[0].role = ROLE_SPARE  # promoted-spare server view
        assert quorum_digest(a) == quorum_digest(b)
        c = Quorum(quorum_id=1, created=5.0, participants=[_member("a", step=2)])
        assert quorum_digest(a) != quorum_digest(c)


class TestDeltaBroadcastE2E:
    def test_second_round_rides_a_delta(self) -> None:
        server = _lighthouse()
        try:
            client = LighthouseClient(server.local_address(), connect_timeout=5.0)
            q1 = client.quorum(replica_id="a", timeout=5.0, step=1)
            assert client.full_responses == 1
            assert q1.participants[0].step == 1
            q2 = client.quorum(replica_id="a", timeout=5.0, step=2)
            assert client.delta_responses == 1
            assert q2.participants[0].step == 2
            assert q2.quorum_id == q1.quorum_id
            client.close()
        finally:
            server.shutdown()

    def test_wire_compat3_pins_full_snapshots(self, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_WIRE_COMPAT", "3")
        server = _lighthouse()
        try:
            client = LighthouseClient(server.local_address(), connect_timeout=5.0)
            for step in (1, 2, 3):
                q = client.quorum(replica_id="a", timeout=5.0, step=step)
                assert q.participants[0].step == step
            assert client.delta_responses == 0
            assert client._quorum_cache is None
            client.close()
        finally:
            server.shutdown()

    def test_legacy_v3_request_frame_still_served(self) -> None:
        server = _lighthouse()
        try:
            w = Writer()
            _member("legacy", step=3).encode(w)
            w.u64(5000)
            sock = socket.create_connection(("127.0.0.1", server.port), 5.0)
            try:
                send_frame(sock, MsgType.LH_QUORUM_REQ, w.payload())
                msg_type, r = recv_frame(sock)
                assert msg_type == MsgType.LH_QUORUM_RESP
                assert Quorum.decode(r).participants[0].replica_id == "legacy"
            finally:
                sock.close()
        finally:
            server.shutdown()


class TestZoneAggregator:
    def test_batched_beats_reach_lighthouse(self) -> None:
        server = _lighthouse()
        agg = None
        try:
            agg = ZoneAggregator(server.local_address(), bind="127.0.0.1:0", agg_id="zone_t",
                                 flush_interval_s=0.05)
            member = AggMemberClient(agg.local_address(), connect_timeout=5.0)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                member.beat("m0", health=CommHealth(stalls=1))
                member.beat("m1")
                with server._lock:
                    beats = dict(server._state.heartbeats)
                    via = dict(server._state.via_agg)
                if {"m0", "m1"} <= set(beats):
                    break
                time.sleep(0.05)
            assert {"m0", "m1"} <= set(beats)
            assert via.get("m0") == "zone_t" and via.get("m1") == "zone_t"
            with server._lock:
                assert "m0" in server._state.health
            member.close()
        finally:
            if agg is not None:
                agg.shutdown()
            server.shutdown()

    def test_direct_beat_clears_agg_routing(self) -> None:
        server = _lighthouse()
        try:
            with server._lock:
                server._state.heartbeats["m0"] = time.monotonic()
                server._state.via_agg["m0"] = "zone_x"
            client = LighthouseClient(server.local_address(), connect_timeout=5.0)
            client.heartbeat("m0")
            with server._lock:
                assert "m0" not in server._state.via_agg
            client.close()
        finally:
            server.shutdown()

    def test_warm_step_rides_the_aggregate(self) -> None:
        server = _lighthouse()
        agg = None
        try:
            spare = _member("sp0", step=2)
            spare.role = ROLE_SPARE
            with server._lock:
                server._state.spares["sp0"] = _MemberDetails(joined=0.0, member=spare)
                server._state.spare_ids.add("sp0")
            agg = ZoneAggregator(server.local_address(), bind="127.0.0.1:0", agg_id="zone_w",
                                 flush_interval_s=0.05)
            member = AggMemberClient(agg.local_address(), connect_timeout=5.0)
            deadline = time.monotonic() + 5.0
            warm = -1
            while time.monotonic() < deadline:
                member.beat("sp0", role=ROLE_SPARE, warm_step=17)
                with server._lock:
                    warm = server._state.spares["sp0"].member.step
                if warm == 17:
                    break
                time.sleep(0.05)
            assert warm == 17
            member.beat("sp0", role=ROLE_SPARE, warm_step=5)  # never regresses
            time.sleep(0.2)
            with server._lock:
                assert server._state.spares["sp0"].member.step == 17
            member.close()
        finally:
            if agg is not None:
                agg.shutdown()
            server.shutdown()

    def test_upstream_restart_counter(self) -> None:
        server = _lighthouse()
        agg = ZoneAggregator(server.local_address(), bind="127.0.0.1:0", agg_id="zone_r",
                             flush_interval_s=0.05)
        member = AggMemberClient(agg.local_address(), connect_timeout=5.0)
        try:
            assert _wait(lambda: member.beat("m0")["upstream_ok"], 5.0)
            assert member.beat("m0")["lh_restarts"] == 0
            addr, port = server.local_address(), server.port
            server.shutdown()
            assert _wait(lambda: not member.beat("m0")["upstream_ok"], 5.0)
            deadline = time.monotonic() + 10.0
            while True:  # the old listener's release can race this rebind
                try:
                    server = LighthouseServer(bind=f"127.0.0.1:{port}", min_replicas=1,
                                              join_timeout_ms=1, quorum_tick_ms=10)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.2)
            assert server.local_address() == addr

            def _restarted() -> bool:
                resp = member.beat("m0")
                return resp["upstream_ok"] and resp["lh_restarts"] >= 1

            assert _wait(_restarted, 5.0)
        finally:
            member.close()
            agg.shutdown()
            server.shutdown()


class TestAggDeathReportingGap:
    def _state_with(self, now: float, age: float, agg_age) -> _State:
        state = _State()
        state.participants["a"] = _MemberDetails(joined=now, member=_member("a"))
        state.heartbeats["a"] = now - age
        state.via_agg["a"] = "zone_0"
        if agg_age is not None:
            state.agg_last["zone_0"] = now - agg_age
        return state

    def _cfg(self) -> LighthouseConfig:
        return LighthouseConfig(min_replicas=1, join_timeout_ms=0, heartbeat_timeout_ms=5_000)

    def test_dead_agg_grants_grace(self, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_AGG_TIMEOUT_S", "1.0")
        monkeypatch.setenv("TORCHFT_AGG_GRACE_S", "5.0")
        now = 1000.0
        met, reason = quorum_compute(now, self._state_with(now, 7.0, 3.0), self._cfg())
        assert met is not None and len(met) == 1, reason
        met, _ = quorum_compute(now, self._state_with(now, 11.0, 8.0), self._cfg())
        assert met is None or len(met) == 0

    def test_live_agg_grants_no_excuse(self, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_AGG_TIMEOUT_S", "1.0")
        monkeypatch.setenv("TORCHFT_AGG_GRACE_S", "5.0")
        now = 1000.0
        met, _ = quorum_compute(now, self._state_with(now, 7.0, 0.2), self._cfg())
        assert met is None or len(met) == 0

    def test_direct_member_unaffected(self) -> None:
        now = 1000.0
        state = self._state_with(now, 7.0, 3.0)
        del state.via_agg["a"]
        met, _ = quorum_compute(now, state, self._cfg())
        assert met is None or len(met) == 0

    def test_explicit_zero_grace_disables_excuse(self, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_AGG_TIMEOUT_S", "1.0")
        monkeypatch.setenv("TORCHFT_AGG_GRACE_S", "0")
        now = 1000.0
        met, _ = quorum_compute(now, self._state_with(now, 7.0, 3.0), self._cfg())
        assert met is None or len(met) == 0


class TestManagerBeatRouting:
    """``TORCHFT_AGG_ADDR`` routes a port manager's beats through an
    aggregator (the port refused the setting before this slice)."""

    def test_beats_route_via_aggregator(self, monkeypatch) -> None:
        lighthouse = _lighthouse()
        agg = ZoneAggregator(lighthouse.local_address(), bind="127.0.0.1:0", agg_id="zone_m",
                             flush_interval_s=0.05)
        monkeypatch.setenv("TORCHFT_AGG_ADDR", agg.local_address())
        server = ManagerServer(replica_id="mgr0", lighthouse_addr=lighthouse.local_address(),
                               bind="127.0.0.1:0", heartbeat_interval=0.05)
        try:
            assert _wait(lambda: "mgr0" in lighthouse._state.heartbeats
                         and lighthouse._state.via_agg.get("mgr0") == "zone_m")
            assert server.coord_stats()["coord_beats_via_agg"] > 0
        finally:
            server.shutdown()
            agg.shutdown()
            lighthouse.shutdown()

    def test_fallback_when_agg_upstream_is_dead(self, monkeypatch) -> None:
        lighthouse = _lighthouse()
        monkeypatch.setenv("TORCHFT_CONNECT_RETRIES", "0")
        agg = ZoneAggregator(f"127.0.0.1:{_dead_port()}", bind="127.0.0.1:0",
                             agg_id="zone_deadend", flush_interval_s=0.05)
        monkeypatch.setenv("TORCHFT_AGG_ADDR", agg.local_address())
        server = ManagerServer(replica_id="mgr2", lighthouse_addr=lighthouse.local_address(),
                               bind="127.0.0.1:0", heartbeat_interval=0.05)
        try:
            assert _wait(lambda: "mgr2" in lighthouse._state.heartbeats)
            stats = server.coord_stats()
            assert stats["coord_beats_direct"] > 0
            assert stats["coord_beats_via_agg"] > 0
        finally:
            server.shutdown()
            agg.shutdown()
            lighthouse.shutdown()

    def test_fallback_to_direct_on_dead_aggregator(self, monkeypatch) -> None:
        lighthouse = _lighthouse()
        monkeypatch.setenv("TORCHFT_AGG_ADDR", f"127.0.0.1:{_dead_port()}")
        monkeypatch.setenv("TORCHFT_AGG_RETRY_S", "0.5")
        monkeypatch.setenv("TORCHFT_CONNECT_RETRIES", "0")
        server = ManagerServer(replica_id="mgr1", lighthouse_addr=lighthouse.local_address(),
                               bind="127.0.0.1:0", heartbeat_interval=0.05)
        try:
            assert _wait(lambda: "mgr1" in lighthouse._state.heartbeats)
            stats = server.coord_stats()
            assert stats["coord_agg_fallbacks"] >= 1
            assert stats["coord_beats_direct"] > 0
            assert "mgr1" not in lighthouse._state.via_agg
        finally:
            server.shutdown()
            lighthouse.shutdown()


class _FrameTap:
    """A listener that records the first frame of each connection and
    answers it with ``reply`` (a (msg_type, payload) pair)."""

    def __init__(self, reply) -> None:
        self.frames = []
        self._reply = reply
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.addr = f"127.0.0.1:{self._sock.getsockname()[1]}"
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with conn:
                try:
                    msg_type, r = jwire.recv_frame(conn)
                    self.frames.append((int(msg_type), bytes(r._view[r._off:])))
                    jwire.send_frame(conn, self._reply[0], self._reply[1])
                except (OSError, jwire.WireError):
                    pass

    def close(self) -> None:
        self._sock.close()


class TestMixedPackages:
    """Beats cross the packages: the member and aggregator frames are the
    same bytes whichever package sends them."""

    def test_member_beat_frames_are_equal(self) -> None:
        reply = (jwire.MsgType.AGG_BEAT_RESP, jwire.Writer().boolean(True).u64(0).payload())
        tap = _FrameTap(reply)
        try:
            health_p, health_j = CommHealth(stalls=3), jwire.CommHealth(stalls=3)
            for client, health, role in (
                (AggMemberClient(tap.addr, connect_timeout=5.0), health_p, ROLE_SPARE),
                (JaxAggMemberClient(tap.addr, connect_timeout=5.0), health_j, jwire.ROLE_SPARE),
            ):
                assert client.beat("m0", role=role, warm_step=9, health=health) == {
                    "upstream_ok": True, "lh_restarts": 0}
                client.close()
            assert len(tap.frames) == 2
            assert tap.frames[0] == tap.frames[1]
            assert tap.frames[0][0] == int(jwire.MsgType.AGG_BEAT_REQ)
        finally:
            tap.close()

    def test_aggregator_flush_frames_are_equal(self) -> None:
        reply = (jwire.MsgType.LH_AGG_BEAT_RESP, b"")
        taps = [_FrameTap(reply), _FrameTap(reply)]
        aggs = []
        try:
            for cls, tap in ((ZoneAggregator, taps[0]), (JaxZoneAggregator, taps[1])):
                agg = cls(tap.addr, bind="127.0.0.1:0", agg_id="zone_x", flush_interval_s=3600.0)
                aggs.append(agg)
                member = JaxAggMemberClient(agg.local_address(), connect_timeout=5.0)
                member.beat("m0", warm_step=4)
                member.beat("m1", health=jwire.CommHealth(reconnects=1))
                member.close()
                agg._flush_once()
            assert taps[0].frames and taps[0].frames[0] == taps[1].frames[0]
            assert taps[0].frames[0][0] == int(jwire.MsgType.LH_AGG_BEAT_REQ)
        finally:
            for agg in aggs:
                agg.shutdown()
            for tap in taps:
                tap.close()

    def test_port_member_through_jax_aggregator_into_port_lighthouse(self) -> None:
        lighthouse = _lighthouse()
        agg = JaxZoneAggregator(lighthouse.local_address(), bind="127.0.0.1:0", agg_id="zone_j",
                                flush_interval_s=0.05)
        member = AggMemberClient(agg.local_address(), connect_timeout=5.0)
        try:
            def _arrived() -> bool:
                member.beat("pm0", health=CommHealth(stalls=2))
                with lighthouse._lock:
                    return lighthouse._state.via_agg.get("pm0") == "zone_j"

            assert _wait(_arrived)
            with lighthouse._lock:
                assert "pm0" in lighthouse._state.heartbeats
                assert "pm0" in lighthouse._state.health
        finally:
            member.close()
            agg.shutdown()
            lighthouse.shutdown()

    def test_jax_member_through_port_aggregator_into_jax_lighthouse(self) -> None:
        lighthouse = _lighthouse(JaxLighthouseServer)
        agg = ZoneAggregator(lighthouse.local_address(), bind="127.0.0.1:0", agg_id="zone_q",
                             flush_interval_s=0.05)
        member = JaxAggMemberClient(agg.local_address(), connect_timeout=5.0)
        try:
            def _arrived() -> bool:
                member.beat("jm0", health=jwire.CommHealth(stalls=2))
                with lighthouse._lock:
                    return lighthouse._state.via_agg.get("jm0") == "zone_q"

            assert _wait(_arrived)
            with lighthouse._lock:
                assert "jm0" in lighthouse._state.heartbeats
                assert "jm0" in lighthouse._state.health
        finally:
            member.close()
            agg.shutdown()
            lighthouse.shutdown()

    def test_port_manager_through_port_aggregator_into_jax_lighthouse(self, monkeypatch) -> None:
        lighthouse = _lighthouse(JaxLighthouseServer)
        agg = ZoneAggregator(lighthouse.local_address(), bind="127.0.0.1:0", agg_id="zone_p",
                             flush_interval_s=0.05)
        monkeypatch.setenv("TORCHFT_AGG_ADDR", agg.local_address())
        server = ManagerServer(replica_id="mgr_p", lighthouse_addr=lighthouse.local_address(),
                               bind="127.0.0.1:0", heartbeat_interval=0.05)
        try:
            assert _wait(lambda: "mgr_p" in lighthouse._state.heartbeats
                         and lighthouse._state.via_agg.get("mgr_p") == "zone_p")
            assert server.coord_stats()["coord_beats_via_agg"] > 0
        finally:
            server.shutdown()
            agg.shutdown()
            lighthouse.shutdown()


class TestScaleHarness:
    def test_scale_smoke_200(self) -> None:
        """≈200 simulated replicas, 2 aggregators, kill/rejoin/promote
        churn and an aggregator bounce, under a hard time budget, with the
        JAX smoke's assertions."""
        from torchft_tpu_torch.coord.scale import run_scale_harness

        t0 = time.monotonic()
        report = run_scale_harness(num_replicas=200, num_aggregators=2, num_spares=2, kills=2,
                                   rejoins=1, agg_bounce=True, deadline_s=110.0)
        wall = time.monotonic() - t0
        assert wall < 110.0, f"smoke blew its budget: {wall:.0f}s"
        assert report["spurious_membership_edits"] == 0, report
        assert report["agg_bounce_edits"] == 0, report
        assert report["promotions_total"] >= 2, report
        assert report["promoted_spares"] >= 2, report
        assert report["rpc_reduction_vs_direct"] >= 10.0, report
        assert report["p99_quorum_latency_s"] is not None, report
        assert report["quorum_rounds_observed"] > 200, report

    def test_subprocess_lighthouse_is_the_ports(self) -> None:
        """The harness's subprocess lighthouse runs the port's server (its
        ``-c`` script names no module of the JAX package)."""
        from torchft_tpu_torch.coord import scale

        lh = scale._Lighthouse(min_replicas=1, join_timeout_ms=100, tick_ms=50,
                               hb_timeout_ms=5000, subprocess_mode=True)
        try:
            assert "torchft_tpu_torch.lighthouse" in scale._LH_SCRIPT
            assert "from torchft_tpu." not in scale._LH_SCRIPT
            status = LighthouseClient(lh.addr, connect_timeout=5.0).status()
            assert "quorum_id" in status
            assert lh.cpu_seconds() is not None
        finally:
            lh.shutdown()

    @pytest.mark.slow
    def test_scale_500(self) -> None:
        from torchft_tpu_torch.coord.scale import run_scale_harness

        report = run_scale_harness(num_replicas=500, num_aggregators=2, num_spares=4, kills=2,
                                   rejoins=1, agg_bounce=True, deadline_s=180.0)
        assert report["spurious_membership_edits"] == 0, report
        assert report["agg_bounce_edits"] == 0, report
        assert report["promotions_total"] >= 2, report
        assert report["rpc_reduction_vs_direct"] >= 10.0, report
        assert report["p99_quorum_latency_s"] is not None, report
        assert report["lighthouse_cpu_frac"] is not None, report

    @pytest.mark.slow
    def test_coord_churn_drill(self) -> None:
        from torchft_tpu_torch.drill import coord_churn_drill

        report = coord_churn_drill(num_replicas=60, num_spares=2, kills=1)
        assert report["promotions_total"] >= 1
