"""The port's hot spares (``torchft_tpu_torch/spare.py``) against the JAX
package's (``torchft_tpu/spare.py``), on the CPU:

- ``WarmChunkStore`` over a port ``ManagerServer``: a full fetch round
  trip; concurrent index requests share one crc pass; a moved snapshot is
  refused; nothing staged is NOT_FOUND; after a
  restage only the moved leaf's chunks are refetched; a chunk whose crc
  does not match its index is dropped; the cache resets when the tree
  changes; a fetch cut off at its deadline resumes from another source
  after the first one died; ``min_step`` skips a snapshot the spare holds.
- The delta feed: the server's cursor and bounded ring; a ``SpareAgent``
  applies entries in order, a gap demotes its shadow, an oversized delta
  is refused at publish.
- The role guards, the C++ sidecar's refusal of the spare role included.
- ``diloco_delta_apply`` against the JAX function on the same fragment
  state and delta bytes, f32 and bf16 leaves: bit-identical backups and
  live parameters.
- A mixed fleet: a port spare reads a JAX active's warm index and chunks
  byte for byte (one wire) and refuses the JAX-written snapshot at load
  with the port loader's named error (ROADMAP §C2).
"""

import time
import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from torchft_tpu import local_sgd as jlocal
from torchft_tpu import manager_server as jms
from torchft_tpu import spare as jspare
from torchft_tpu.checkpointing.serialization import array_chunk_ranges
from torchft_tpu.checkpointing.serialization import plan_pytree as jplan_pytree
from torchft_tpu.communicator import DummyCommunicator as JaxDummyCommunicator
from torchft_tpu.manager import Manager as JaxManager
from torchft_tpu_torch.checkpointing.serialization import plan_pytree
from torchft_tpu_torch.communicator import DummyCommunicator
from torchft_tpu_torch.lighthouse import LighthouseClient, LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.manager_server import _WARM_RANGE_MAX_BYTES, ManagerClient, ManagerServer
from torchft_tpu_torch.optim import OuterSGD
from torchft_tpu_torch.spare import SpareAgent, WarmChunkStore, diloco_delta_apply
from torchft_tpu_torch.wire import ROLE_SPARE, WireError


@pytest.fixture()
def lighthouse():
    server = LighthouseServer(
        bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100, quorum_tick_ms=10
    )
    yield server
    server.shutdown()


def _server(lighthouse, replica_id="warm_src", warm_fn=None) -> ManagerServer:
    return ManagerServer(
        replica_id=replica_id,
        lighthouse_addr=lighthouse.local_address(),
        hostname="127.0.0.1",
        bind="127.0.0.1:0",
        store_addr=f"store_{replica_id}",
        world_size=1,
        warm_fn=warm_fn,
    )


def _state(step: int, b_value: float = 1.0) -> dict:
    return {
        "user": {
            "default": {
                "a": torch.arange(50_000, dtype=torch.float32),
                "b": torch.full((30_000,), b_value, dtype=torch.float32),
            }
        },
        "torchft": {"step": step, "batches_committed": step},
    }


# ---------------------------------------------------------------------------
# warm channel (b): the crc-watermarked chunk store
# ---------------------------------------------------------------------------


class TestWarmChunkStore:
    def test_full_fetch_round_trip_then_only_moved_chunks(self, lighthouse, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", "0.0625")  # 64 KiB chunks
        state = _state(5)
        staged = [(5, plan_pytree(state, snapshot=True))]
        server = _server(lighthouse, warm_fn=lambda: staged[0])
        try:
            client = ManagerClient(f"127.0.0.1:{server.port}")
            index = client.warm_index()
            assert index["step"] == 5
            assert len(index["chunk_hashes"]) > 2  # genuinely chunked
            store = WarmChunkStore()
            got = store.refresh(client, deadline=time.monotonic() + 30.0, pace_s=0)
            assert got is not None
            step, loaded = got
            assert step == 5
            assert torch.equal(loaded["user"]["default"]["a"], state["user"]["default"]["a"])
            assert loaded["torchft"]["step"] == 5
            assert store.last_fresh_fraction == 1.0
            fetched_once = store.chunks_fetched
            assert fetched_once == len(index["chunk_hashes"])

            # a second pass against the SAME staging: every watermark
            # matches, no chunk moves
            got = store.refresh(client, deadline=time.monotonic() + 30.0, pace_s=0)
            assert got is not None and store.chunks_fetched == fetched_once

            # move ONE leaf and restage: only its chunks are refetched
            state = _state(6, b_value=2.0)
            staged[0] = (6, plan_pytree(state, snapshot=True))
            got = store.refresh(client, deadline=time.monotonic() + 30.0, pace_s=0)
            assert got is not None and got[0] == 6
            assert torch.equal(got[1]["user"]["default"]["b"], state["user"]["default"]["b"])
            refetched = store.chunks_fetched - fetched_once
            b_chunks = -(-30_000 * 4 // (64 << 10))
            assert refetched == b_chunks, "the watermark diff must fetch only the moved leaf's chunks"
            client.close()
        finally:
            server.shutdown()

    def test_min_step_skips_a_snapshot_the_spare_holds(self, lighthouse) -> None:
        staged = (5, plan_pytree(_state(5), snapshot=True))
        server = _server(lighthouse, warm_fn=lambda: staged)
        try:
            client = ManagerClient(f"127.0.0.1:{server.port}")
            store = WarmChunkStore()
            assert store.refresh(client, deadline=time.monotonic() + 30.0, pace_s=0, min_step=5) is None
            assert store.last_fresh_fraction == 1.0  # fetched, not deserialized
            got = store.refresh(client, deadline=time.monotonic() + 30.0, pace_s=0, min_step=4)
            assert got is not None and got[0] == 5
            client.close()
        finally:
            server.shutdown()

    def test_concurrent_index_requests_share_one_crc_pass(self, lighthouse) -> None:
        """A second index request that arrives while the first computes the
        crc table waits for it (no second pass over the leaves)."""
        import threading

        plan = plan_pytree(_state(5), snapshot=True)
        materialized = []
        materialize = plan._materialize

        def slow(i):
            materialized.append(i)
            time.sleep(0.2)
            return materialize(i)

        plan._materialize = slow
        server = _server(lighthouse, warm_fn=lambda: (5, plan))
        try:
            indexes = []

            def ask():
                client = ManagerClient(f"127.0.0.1:{server.port}")
                indexes.append(client.warm_index())
                client.close()

            threads = [threading.Thread(target=ask) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert len(indexes) == 2 and indexes[0] == indexes[1]
            assert materialized == [0, 1]  # one pass: each leaf once
        finally:
            server.shutdown()

    def test_warm_range_refuses_a_moved_snapshot(self, lighthouse) -> None:
        staged = [(5, plan_pytree({"x": torch.ones(8)}))]
        server = _server(lighthouse, warm_fn=lambda: staged[0])
        try:
            client = ManagerClient(f"127.0.0.1:{server.port}")
            index = client.warm_index()
            staged[0] = (6, plan_pytree({"x": torch.ones(8)}))
            with pytest.raises(WireError):
                client.warm_range(index["step"], 0, 8)
            client.close()
        finally:
            server.shutdown()

    def test_warm_index_not_found_when_nothing_staged(self, lighthouse) -> None:
        server = _server(lighthouse, warm_fn=lambda: None)
        try:
            client = ManagerClient(f"127.0.0.1:{server.port}")
            with pytest.raises(WireError):
                client.warm_index()
            client.close()
        finally:
            server.shutdown()

    def test_crc_mismatch_is_dropped_then_refetched(self, lighthouse, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", "0.0625")
        staged = (5, plan_pytree(_state(5), snapshot=True))
        server = _server(lighthouse, warm_fn=lambda: staged)

        class _Corrupting:
            """Flips one byte of the first chunk range it serves."""

            def __init__(self, inner):
                self.inner = inner
                self.corrupted = False

            def warm_index(self):
                return self.inner.warm_index()

            def warm_range(self, step, start, stop):
                data = self.inner.warm_range(step, start, stop)
                if start > 0 and not self.corrupted:
                    self.corrupted = True
                    return bytes([data[0] ^ 0xFF]) + data[1:]
                return data

        try:
            client = ManagerClient(f"127.0.0.1:{server.port}")
            n_chunks = len(client.warm_index()["chunk_hashes"])
            store = WarmChunkStore()
            assert store.refresh(_Corrupting(client), deadline=time.monotonic() + 30.0, pace_s=0) is None
            assert store.chunks_fetched == n_chunks - 1
            assert store.last_fresh_fraction == pytest.approx((n_chunks - 1) / n_chunks)
            got = store.refresh(client, deadline=time.monotonic() + 30.0, pace_s=0)
            assert got is not None and store.chunks_fetched == n_chunks
            client.close()
        finally:
            server.shutdown()

    def test_cache_resets_when_the_tree_changes(self, lighthouse) -> None:
        staged = [(5, plan_pytree(_state(5), snapshot=True))]
        server = _server(lighthouse, warm_fn=lambda: staged[0])
        try:
            client = ManagerClient(f"127.0.0.1:{server.port}")
            store = WarmChunkStore()
            assert store.refresh(client, deadline=time.monotonic() + 30.0, pace_s=0) is not None
            first = store.chunks_fetched
            grown = _state(6)
            grown["user"]["default"]["c"] = torch.zeros(10, dtype=torch.float32)
            staged[0] = (6, plan_pytree(grown, snapshot=True))
            got = store.refresh(client, deadline=time.monotonic() + 30.0, pace_s=0)
            assert got is not None and "c" in got[1]["user"]["default"]
            # every chunk of the new tree was fetched, unchanged leaves too
            assert store.chunks_fetched - first == len(client.warm_index()["chunk_hashes"])
            client.close()
        finally:
            server.shutdown()

    def test_resumes_from_another_source_after_the_first_dies(self, lighthouse, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", "0.0625")
        state = _state(5)
        servers = [
            _server(lighthouse, replica_id=f"src{i}", warm_fn=lambda: (5, plan_pytree(state, snapshot=True)))
            for i in range(2)
        ]
        try:
            first = ManagerClient(f"127.0.0.1:{servers[0].port}")
            n_chunks = len(first.warm_index()["chunk_hashes"])
            store = WarmChunkStore()
            # the pass runs out of budget after a few chunks (pace 50 ms,
            # deadline 120 ms) ...
            assert store.refresh(first, deadline=time.monotonic() + 0.12, pace_s=0.05) is None
            partial = store.chunks_fetched
            assert 0 < partial < n_chunks
            # ... its source dies, and the next source serves the rest only
            first.close()
            servers[0].shutdown()
            second = ManagerClient(f"127.0.0.1:{servers[1].port}")
            got = store.refresh(second, deadline=time.monotonic() + 30.0, pace_s=0)
            assert got is not None
            assert store.chunks_fetched == n_chunks
            assert torch.equal(got[1]["user"]["default"]["a"], state["user"]["default"]["a"])
            second.close()
        finally:
            for s in servers:
                s.shutdown()


# ---------------------------------------------------------------------------
# warm channel (a): the outer-delta feed
# ---------------------------------------------------------------------------


def _spare_manager() -> Manager:
    return Manager(
        comm=DummyCommunicator(),
        load_state_dict=None,
        state_dict=None,
        min_replica_size=1,
        role="spare",
        _manager_client=object(),  # mocked control plane
    )


class TestDeltaFeed:
    def test_server_cursor_and_ring_bound(self, lighthouse, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_SPARE_DELTA_BUF_MB", "1")
        server = _server(lighthouse)
        try:
            client = ManagerClient(f"127.0.0.1:{server.port}")
            server.publish_delta(1, 0, b"a" * 10)
            server.publish_delta(2, 0, b"b" * 10)
            server.publish_delta(2, 1, b"c" * 10)
            got = client.deltas(1, 0)
            assert [(s, f) for s, f, _ in got] == [(2, 0), (2, 1)]
            assert got[0][2] == b"b" * 10
            assert client.deltas(2, 1) == []
            # the ring is bounded: a slow spare never grows an active's memory
            for step in range(3, 3 + 80):
                server.publish_delta(step, 0, b"x" * 65536)
            got = client.deltas(0, 0)
            assert len(got) <= 64
            assert got[0][0] > 2
            client.close()
        finally:
            server.shutdown()

    def _agent(self, server):
        applied = []
        agent = SpareAgent(_spare_manager(), delta_apply=lambda s, f, p: applied.append((s, f, p)))
        agent._addresses = [f"127.0.0.1:{server.port}"]
        agent._loaded_once = True
        agent._shadow_fresh = True
        agent.warm_step = 1
        agent._delta_cursor = (1, 1 << 60)
        return agent, applied

    def test_applies_in_order_and_advances_warm_step(self, lighthouse) -> None:
        server = _server(lighthouse, replica_id="delta_src")
        try:
            agent, applied = self._agent(server)
            server.publish_delta(2, 0, b"d2")
            server.publish_delta(3, 0, b"d3")
            agent._poll_deltas()
            assert applied == [(2, 0, b"d2"), (3, 0, b"d3")]
            assert agent.warm_step == 3
            assert agent._manager.current_step() == 3
            assert agent._shadow_fresh
            assert agent.metrics["warm_deltas_applied"] == 2.0
            agent.close()
        finally:
            server.shutdown()

    def test_gap_demotes_the_shadow(self, lighthouse) -> None:
        server = _server(lighthouse, replica_id="delta_src2")
        try:
            agent, applied = self._agent(server)
            server.publish_delta(4, 0, b"d4")  # hole: steps 2-3 missing
            agent._poll_deltas()
            assert applied == []
            assert not agent._shadow_fresh  # the chunk store must re-converge
            assert agent.warm_step == 1
            agent.close()
        finally:
            server.shutdown()

    def test_oversized_delta_refused_at_publish(self, lighthouse) -> None:
        """An entry that can never ride a wire frame is refused at publish:
        serving it would fail the spare's recv on every poll.  A fragment of
        the chip's Llama-3-8B-width DiLoCo phase (2.97 GB of f32) is such an
        entry; so is anything over 48 MiB."""
        server = _server(lighthouse, replica_id="delta_src3")
        try:
            server.publish_delta(2, 0, b"\0" * (_WARM_RANGE_MAX_BYTES + 1))
            assert server._deltas == []  # refused, not enqueued
            server.publish_delta(3, 0, b"d3")  # the feed still works after
            agent, applied = self._agent(server)
            agent._poll_deltas()
            # step 3 arrives as a GAP (step 2 was dropped): the shadow
            # demotes to chunk-store warming rather than wedging
            assert applied == []
            assert not agent._shadow_fresh
            agent.close()
        finally:
            server.shutdown()

    def test_frame_budget_is_the_jax_packages(self) -> None:
        assert _WARM_RANGE_MAX_BYTES == jms._WARM_RANGE_MAX_BYTES == 48 << 20


# ---------------------------------------------------------------------------
# role guards
# ---------------------------------------------------------------------------


class TestRoleGuards:
    def test_manager_rejects_unknown_role(self) -> None:
        with pytest.raises(ValueError, match="role"):
            Manager(comm=DummyCommunicator(), load_state_dict=None, state_dict=None,
                    min_replica_size=1, role="observer")

    def test_cpp_manager_server_refuses_spare_role(self) -> None:
        from torchft_tpu_torch.native import CppManagerServer

        with pytest.raises(ValueError, match="SPARE"):
            CppManagerServer(replica_id="x", lighthouse_addr="127.0.0.1:1", hostname="h",
                             bind="127.0.0.1:0", store_addr="s", world_size=1, role=ROLE_SPARE)

    def test_spare_manager_with_the_cpp_sidecar_raises(self, lighthouse) -> None:
        from torchft_tpu_torch.native import CppManagerServer

        with pytest.raises(ValueError, match="SPARE"):
            Manager(comm=DummyCommunicator(), load_state_dict=None, state_dict=None,
                    min_replica_size=1, role="spare", lighthouse_addr=lighthouse.local_address(),
                    server_cls=CppManagerServer, connect_timeout=5.0)

    def test_warm_staging_rate_limited_before_first_landing(self, monkeypatch) -> None:
        monkeypatch.setenv("TORCHFT_SPARE_WARM_REFRESH_S", "30")
        manager = Manager(comm=DummyCommunicator(), load_state_dict=None, state_dict=None,
                          min_replica_size=1, _manager_client=object())
        submits = []
        manager._manager_server = object()  # advertise a server
        manager._spare_replica_ids = ["spare_x"]
        monkeypatch.setattr(
            manager, "_executor",
            type("E", (), {"submit": lambda self, fn, *a: submits.append(fn)})(),
        )
        manager._maybe_stage_warm()  # first round submits
        manager._maybe_stage_warm()  # nothing staged yet: must NOT submit again
        manager._maybe_stage_warm()
        assert len(submits) == 1

    def test_spare_role_refused_under_pinned_wire_compat(self, monkeypatch, lighthouse) -> None:
        monkeypatch.setenv("TORCHFT_WIRE_COMPAT", "2")
        with pytest.raises(ValueError, match="wire v3"):
            Manager(comm=DummyCommunicator(), load_state_dict=None, state_dict=None,
                    min_replica_size=1, role="spare", _manager_client=object())
        client = LighthouseClient(lighthouse.local_address(), connect_timeout=5.0)
        try:
            with pytest.raises(ValueError, match="wire v3"):
                client.quorum(replica_id="x", timeout=0.1, address="a", store_address="s",
                              step=0, world_size=1, role=ROLE_SPARE)
        finally:
            client.close()

    def test_spare_agent_requires_spare_manager(self) -> None:
        manager = Manager(comm=DummyCommunicator(), load_state_dict=None, state_dict=None,
                          min_replica_size=1, _manager_client=object())
        with pytest.raises(ValueError, match="spare"):
            SpareAgent(manager)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_late_spare_round_does_not_rejoin_the_next_quorum_c13(package) -> None:
    """ROADMAP §C13: a spare-role round left in flight from before the
    promotion reaches the lighthouse after the promotion quorum issued.  It
    takes the promotion fast path (the standing quorum, at once).  In the
    port that is all it does; the JAX lighthouse also registers it as a
    participant of the next round at its stale warm step, so the first
    active to ask is handed a quorum at once that lists the promoted replica
    behind it (a heal), while the promoted replica's own request waits."""
    import time as _time

    from torchft_tpu import lighthouse as jlighthouse
    from torchft_tpu import wire as jwire
    from torchft_tpu_torch import lighthouse as plighthouse
    from torchft_tpu_torch import wire as pwire

    lh, wire = (plighthouse, pwire) if package == "port" else (jlighthouse, jwire)

    def member(name: str, step: int) -> object:
        return wire.QuorumMember(replica_id=name, address=f"addr_{name}",
                                 store_address=f"store_{name}", step=step, world_size=1)

    server = lh.LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                                 quorum_tick_ms=10)
    client = lh.LighthouseClient(server.local_address(), connect_timeout=5.0)
    try:
        with server._lock:
            server._state.prev_quorum = wire.Quorum(
                quorum_id=3, participants=[member("active", 6), member("spare", 6)])
            server._state.promoted.add("spare")
            now = _time.monotonic()
            server._state.heartbeats.update({"active": now + 3600, "spare": now + 3600})
        late = client.quorum(replica_id="spare", timeout=5.0, address="addr_spare",
                             store_address="store_spare", step=5, world_size=1,
                             role=wire.ROLE_SPARE)
        assert late.quorum_id == 3  # the standing quorum, at once
        with server._lock:
            registered = "spare" in server._state.participants
        assert registered is (package == "jax")
        t0 = _time.monotonic()
        try:
            nxt = client.quorum(replica_id="active", timeout=0.5, address="addr_active",
                                store_address="store_active", step=7, world_size=1)
        except TimeoutError:
            nxt = None
        if package == "jax":
            steps = {m.replica_id: m.step for m in nxt.participants}
            assert steps == {"active": 7, "spare": 5} and _time.monotonic() - t0 < 0.5
        else:
            # the active waits for the promoted replica's own request
            assert nxt is None
    finally:
        client.close()
        server.shutdown()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_queued_spare_round_is_not_sent_after_the_promotion_c13(lighthouse, package) -> None:
    """ROADMAP §C13, the manager server's half: a manager server forwards
    one quorum round at a time, so a spare round can wait behind the round
    that carried its promotion.  The port drops it once the role changed;
    the JAX manager server sends it with the live role (now ACTIVE) and the
    round's stale step, an active registration at a step the replica left."""
    from torchft_tpu import wire as jwire
    from torchft_tpu_torch import wire as pwire

    wire, cls = (pwire, ManagerServer) if package == "port" else (jwire, jms.ManagerServer)
    server = cls(replica_id="promoted", lighthouse_addr=lighthouse.local_address(),
                 hostname="127.0.0.1", bind="127.0.0.1:0", store_addr="store_promoted",
                 world_size=1, role=wire.ROLE_SPARE)
    sent = []

    class _Lighthouse:
        def quorum(self, **kw):
            sent.append(kw)
            return wire.Quorum(quorum_id=9, participants=[])

        def close(self):
            pass

    try:
        server._lh_quorum_client = _Lighthouse()
        server.role = wire.ROLE_ACTIVE  # the promotion landed meanwhile
        gen = server._quorum_gen
        queued = wire.QuorumMember(replica_id="promoted", address="a", store_address="s",
                                   step=1, world_size=1, role=wire.ROLE_SPARE)
        if package == "port":
            server._run_quorum(queued, 5.0, server._rounds_started)
        else:
            server._run_quorum(queued, 5.0)
        if package == "port":
            assert sent == [] and server._quorum_gen == gen
        else:
            assert [(kw["role"], kw["step"]) for kw in sent] == [(wire.ROLE_ACTIVE, 1)]
    finally:
        server._lh_quorum_client = None
        server.shutdown()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_rank_takes_only_its_own_rounds_outcome_c13(lighthouse, package) -> None:
    """ROADMAP §C13: the manager server forwards one round at a time, so a
    round whose rank gave up (a spare's 2 s park) can settle after the next
    rank parked.  The port hands that rank its own round's quorum; the JAX
    manager server wakes it with the older round's outcome (here the
    failure), so its own round's quorum reaches no one."""
    import threading

    from torchft_tpu import wire as jwire
    from torchft_tpu_torch import wire as pwire

    wire, cls = (pwire, ManagerServer) if package == "port" else (jwire, jms.ManagerServer)
    server = cls(replica_id="r", lighthouse_addr=lighthouse.local_address(),
                 hostname="127.0.0.1", bind="127.0.0.1:0", store_addr="store_r", world_size=1)
    release = threading.Event()
    calls = []

    class _Lighthouse:
        def quorum(self, **kw):
            calls.append(kw)
            if len(calls) == 1:
                release.wait(10)
                raise TimeoutError("round 0 timed out at the lighthouse")
            return wire.Quorum(quorum_id=1, participants=[wire.QuorumMember(
                replica_id="r", address=kw["address"], store_address=kw["store_address"],
                step=kw["step"], world_size=1)])

        def close(self):
            pass

    server._lh_quorum_client = _Lighthouse()
    addr = f"127.0.0.1:{server.port}"
    try:
        client_cls = ManagerClient if package == "port" else jms.ManagerClient
        with pytest.raises(TimeoutError):
            client_cls(addr)._quorum(group_rank=0, step=3, checkpoint_metadata="",
                                     shrink_only=False, timeout=0.3, init_sync=False)
        got = []

        def park():
            try:
                got.append(client_cls(addr)._quorum(group_rank=0, step=3, checkpoint_metadata="",
                                                    shrink_only=False, timeout=5.0,
                                                    init_sync=False))
            except Exception as e:  # noqa: BLE001 — the outcome under test
                got.append(e)

        t = threading.Thread(target=park)
        t.start()
        time.sleep(0.3)  # the second rank parks; its round waits behind round 0
        release.set()
        t.join(timeout=10)
        assert len(got) == 1
        if package == "port":
            assert not isinstance(got[0], Exception) and got[0].replica_world_size == 1
        else:
            assert isinstance(got[0], Exception) and "round 0 timed out" in str(got[0])
    finally:
        release.set()
        server._lh_quorum_client = None
        server.shutdown()


def test_spare_warms_when_its_quorum_round_fails_c12(lighthouse) -> None:
    """ROADMAP §C12: while the fleet is idle (the actives hold, no quorum
    forms), a spare's parked round ends either in the client's timeout or
    in the manager server's own error frame, "lighthouse quorum failed";
    which comes first is a race.  The port's spare warms on its cached
    sources either way; the JAX package's warms only on the timeout."""
    from types import SimpleNamespace

    from torchft_tpu import wire as jwire
    from torchft_tpu_torch.wire import ErrCode

    failure = "lighthouse quorum failed after 0 retries: quorum request for 'spare' timed out"
    staged = (5, plan_pytree(_state(5), snapshot=True))
    server = _server(lighthouse, replica_id="idle_src", warm_fn=lambda: staged)

    def _round(manager, error):
        def _quorum(**_kw):
            raise error

        manager._client = SimpleNamespace(_quorum=_quorum)
        manager._checkpoint_transport = SimpleNamespace(metadata=lambda: "")
        return manager

    try:
        port = SpareAgent(_round(_spare_manager(), WireError(ErrCode.UNKNOWN, failure)))
        port._addresses = [f"127.0.0.1:{server.port}"]
        assert port.step() is False
        assert port.warm_step == 5 and port.metrics["warm_fresh_fraction"] == 1.0
        port.close()

        jmanager = JaxManager(comm=JaxDummyCommunicator(), load_state_dict=None, state_dict=None,
                              min_replica_size=1, role="spare", _manager_client=object())
        jax_agent = jspare.SpareAgent(_round(jmanager, jwire.WireError(jwire.ErrCode.UNKNOWN,
                                                                       failure)))
        jax_agent._addresses = [f"127.0.0.1:{server.port}"]
        assert jax_agent.step() is False
        assert jax_agent.warm_step == -1 and jax_agent._store.chunks_fetched == 0
    finally:
        server.shutdown()


# ---------------------------------------------------------------------------
# diloco_delta_apply against the JAX package's
# ---------------------------------------------------------------------------


class _TwoLeaves(torch.nn.Module):
    def __init__(self, a: np.ndarray, b: np.ndarray) -> None:
        super().__init__()
        self.a = torch.nn.Parameter(torch.from_numpy(a.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16))


@pytest.mark.parametrize("frag_of", ["one_fragment", "two_fragments"])
def test_delta_apply_is_bit_identical_to_the_jax_package(frag_of) -> None:
    """The same fragment state (an f32 and a bf16 leaf) and the same delta
    bytes through both packages' ``diloco_delta_apply``: the backups and the
    live parameters come out bit for bit equal, twice in a row."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 5)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(ml_dtypes.bfloat16)
    n_frags = 1 if frag_of == "one_fragment" else 2

    jax_manager = JaxManager(comm=JaxDummyCommunicator(), load_state_dict=None, state_dict=None,
                             min_replica_size=1, use_async_quorum=False, _manager_client=object())
    jdiloco = jlocal.DiLoCo(jax_manager, {"params": {"a": jnp.asarray(a), "b": jnp.asarray(b)}}, optax.sgd(0.7), sync_every=2 * n_frags,
                            num_fragments=n_frags)
    manager = Manager(comm=DummyCommunicator(), load_state_dict=None, state_dict=None,
                      min_replica_size=1, use_async_quorum=False, _manager_client=object())
    model = _TwoLeaves(a, np.asarray(b, dtype=np.float32))
    diloco = DiLoCo(manager, model, OuterSGD(0.7), sync_every=2 * n_frags, num_fragments=n_frags)
    assert [f.names for f in diloco.fragments] == ([["a", "b"]] if n_frags == 1 else [["a"], ["b"]])

    japply, apply = jspare.diloco_delta_apply(jdiloco), diloco_delta_apply(diloco)
    for step in (1, 2):
        for frag in range(n_frags):
            n = diloco.fragments[frag]._n
            assert n == jdiloco._fragments[frag]._n
            payload = rng.normal(scale=0.01, size=n).astype(np.float32).tobytes()
            japply(step, frag, payload)
            apply(step, frag, payload)
            for jb, tb in zip(jdiloco._fragments[frag].backup, diloco.fragments[frag].backup):
                jb = np.asarray(jb)
                got = tb.view(torch.int16).numpy() if tb.dtype == torch.bfloat16 else tb.numpy()
                want = jb.view(np.int16) if jb.dtype == ml_dtypes.bfloat16 else jb
                np.testing.assert_array_equal(got, want)
    for name, p in model.named_parameters():
        want = np.asarray(jdiloco._holder["params"][name])
        got = p.detach()
        if got.dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_delta_apply_refuses_a_delta_of_the_wrong_size() -> None:
    manager = Manager(comm=DummyCommunicator(), load_state_dict=None, state_dict=None,
                      min_replica_size=1, use_async_quorum=False, _manager_client=object())
    diloco = DiLoCo(manager, _TwoLeaves(np.zeros(4, np.float32), np.zeros(2, np.float32)),
                    OuterSGD(0.7), sync_every=2)
    with pytest.raises(ValueError, match="expected 6"):
        diloco_delta_apply(diloco)(1, 0, np.zeros(5, np.float32).tobytes())


# ---------------------------------------------------------------------------
# a mixed fleet: a port spare beside a JAX active
# ---------------------------------------------------------------------------


def test_port_spare_reads_a_jax_active_then_refuses_its_snapshot_c2(lighthouse, monkeypatch) -> None:
    """One wire: a port client reads a JAX manager server's warm index and
    chunk table exactly as a JAX client does, and its chunk store fetches
    every chunk (crc-checked).  The snapshot is the JAX package's, so the
    port's loader refuses it by name (ROADMAP §C2: a heal — or a warm load —
    across the packages is not supported)."""
    monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", "0.0625")
    state = {
        "user": {"default": {"a": np.arange(50_000, dtype=np.float32)}},
        "torchft": {"step": 5, "batches_committed": 5},
    }
    staged = (5, jplan_pytree(state, snapshot=True))
    server = jms.ManagerServer(
        replica_id="jax_active", lighthouse_addr=lighthouse.local_address(), hostname="127.0.0.1",
        bind="127.0.0.1:0", store_addr="s", world_size=1, warm_fn=lambda: staged,
    )
    try:
        jclient = jms.ManagerClient(f"127.0.0.1:{server.port}")
        client = ManagerClient(f"127.0.0.1:{server.port}")
        index = client.warm_index()
        assert index == jclient.warm_index()
        table = array_chunk_ranges(index["leaf_nbytes"], index["chunk_target_bytes"])
        for i, (ai, lo, hi) in enumerate(table):
            off = index["header_len"] + 8 * (ai + 1) + lo
            data = client.warm_range(5, off, off + hi - lo)
            assert data == jclient.warm_range(5, off, off + hi - lo)
            assert zlib.crc32(data) == index["chunk_hashes"][i]
        store = WarmChunkStore()
        with pytest.raises(ValueError, match="heal across packages is not supported"):
            store.refresh(client, deadline=time.monotonic() + 30.0, pace_s=0)
        assert store.last_fresh_fraction == 1.0  # every chunk landed first
        jclient.close()
        client.close()
    finally:
        server.shutdown()
