"""The port's streamed DiLoCo outer sync (``TORCHFT_STREAM_SYNC``) held
against the JAX package's (``tests/test_stream_sync.py`` is the twin).

- The staleness planner equals the JAX package's over a grid of knob
  settings; the rotating STREAM_OUTER tag windows stay in their span.
- Scheduler semantics against a stub control plane: the delta applies
  exactly ``stall`` inner steps after the sync point, from the
  pseudogradient captured then; a failed barrier vote resets to the
  backup; FRAG_SUBMIT precedes FRAG_COMMIT with the same step; staggered
  fragments; leaving the context drains a pending barrier; LocalSGD
  streams the whole model.
- The Manager's stream fence: a half-streamed sync never commits.
- ``TORCHFT_STREAM_SYNC=0`` reproduces the golden fixture and is
  bit-identical to an unset knob.
- Threads as replicas: a streamed run of two replicas ends bit-identical,
  float and int8.
"""

import concurrent.futures
import json
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torchft_tpu import local_sgd as jlocal
from torchft_tpu_torch import wire
from torchft_tpu_torch.local_sgd import (
    DEFAULT_STREAM_STALENESS,
    STREAM_MAX_STALENESS_ENV,
    STREAM_SYNC_ENV,
    DiLoCo,
    LocalSGD,
    stream_stall_for,
)
from torchft_tpu_torch.obs.flight import FlightEvent
from torchft_tpu_torch.optim import OuterSGD
from torchft_tpu_torch.work import DummyWork, Work

from tests.test_torch_local_sgd import (
    FIXTURE_PATH,
    Params,
    StubClient,
    _diloco_replica,
    _regression_trajectory,
    quorum_result,
    solo_manager,
    stub_manager,
)


class TestStallPlanner:
    @pytest.mark.parametrize("mode", [None, "0", "1", "auto"])
    @pytest.mark.parametrize("bar", [None, "1", "3", "100"])
    def test_equals_jax(self, monkeypatch, mode, bar) -> None:
        for name, value in ((STREAM_SYNC_ENV, mode), (STREAM_MAX_STALENESS_ENV, bar)):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        for per_frag, delay in ((8, 2), (4, 2), (1, 0), (16, 0), (4, 0), (8, 0)):
            assert stream_stall_for(per_frag, delay) == jlocal.stream_stall_for(per_frag, delay)

    def test_auto_with_bar_engages_clamped(self, monkeypatch) -> None:
        monkeypatch.delenv(STREAM_SYNC_ENV, raising=False)
        monkeypatch.setenv(STREAM_MAX_STALENESS_ENV, "3")
        assert stream_stall_for(8, 2) == 3
        assert stream_stall_for(4, 2) == 1  # clamped before the next prepare

    def test_forced_derives_default_bar(self, monkeypatch) -> None:
        monkeypatch.setenv(STREAM_SYNC_ENV, "1")
        monkeypatch.delenv(STREAM_MAX_STALENESS_ENV, raising=False)
        assert stream_stall_for(16, 0) == DEFAULT_STREAM_STALENESS
        assert stream_stall_for(4, 0) == 3

    def test_forced_without_room_falls_back_loudly(self, monkeypatch, caplog) -> None:
        monkeypatch.setenv(STREAM_SYNC_ENV, "1")
        with caplog.at_level(logging.WARNING, logger="torchft_tpu_torch.local_sgd"):
            assert stream_stall_for(1, 0) == 0
        assert "no staleness room" in caplog.text

    def test_unparseable_mode_is_loud(self, monkeypatch) -> None:
        monkeypatch.setenv(STREAM_SYNC_ENV, "maybe")
        with pytest.raises(ValueError, match="TORCHFT_STREAM_SYNC"):
            stream_stall_for(8, 0)


class TestTagWindows:
    def test_windows_rotate_and_stay_in_span(self) -> None:
        seen = set()
        for frag in range(8):
            base, span = wire.stream_frag_tag_window(frag)
            assert span == wire.STREAM_FRAG_WINDOW_SPAN
            assert wire.STREAM_OUTER_TAG_BASE <= base
            assert base + span <= wire.STREAM_OUTER_TAG_BASE + wire.STREAM_OUTER_TAG_SPAN
            seen.add(base)
        assert len(seen) == wire.STREAM_FRAG_WINDOWS

    def test_pipeline_depth_capped_to_window(self) -> None:
        from torchft_tpu_torch.collectives import _outer_chunk_ranges

        _, span = wire.stream_frag_tag_window(0)
        assert len(_outer_chunk_ranges(10_000_000, 16, 1, max_chunks=span // 2)) <= span // 2


def _streamed(monkeypatch, stall=1, sync_every=3, arrays=None, **kw):
    monkeypatch.setenv(STREAM_SYNC_ENV, "1")
    monkeypatch.setenv(STREAM_MAX_STALENESS_ENV, str(stall))
    manager = solo_manager(8)
    model = Params(arrays or {"w": np.full(4, 10.0, np.float32)})
    diloco = DiLoCo(manager, model, OuterSGD(kw.pop("lr", 0.5)), sync_every=sync_every, **kw)
    assert diloco.streaming()
    return manager, model, diloco


def _inner(model, by=1.0):
    model.set({k: v - by for k, v in model.values().items()})


class TestSchedulerSemantics:
    def test_delta_applies_at_staleness_bar(self, monkeypatch) -> None:
        """sync_every=3, stall=1: pseudograd captured at the sync step,
        delta applied one inner step into the next round."""
        _manager, model, diloco = _streamed(monkeypatch)
        results = []
        for _ in range(4):
            _inner(model)
            results.append(diloco.step())
        assert results == [None, None, None, True]
        # pseudograd at sync step = 10 - 7 = 3; global = 10 - 0.5*3 = 8.5
        np.testing.assert_allclose(model.values()["w"], np.full(4, 8.5))

    def test_failed_barrier_vote_resets_to_backup(self, monkeypatch) -> None:
        manager, model, diloco = _streamed(monkeypatch)
        manager._client.commit_responses.append(False)
        results = []
        for _ in range(4):
            _inner(model)
            results.append(diloco.step())
        assert results == [None, None, None, False]
        np.testing.assert_allclose(model.values()["w"], np.full(4, 10.0))

    def test_frag_pair_shares_submit_step(self, monkeypatch) -> None:
        """FRAG_SUBMIT precedes its FRAG_COMMIT, and both carry the
        submit-time step."""
        manager, model, diloco = _streamed(monkeypatch)
        for _ in range(4):
            _inner(model)
            diloco.step()
        frag = [e for e in list(manager._flight._events)
                if e[2] in (int(FlightEvent.FRAG_SUBMIT), int(FlightEvent.FRAG_COMMIT))]
        assert [e[2] for e in frag] == [int(FlightEvent.FRAG_SUBMIT), int(FlightEvent.FRAG_COMMIT)]
        assert frag[0][3] == frag[1][3]

    def test_streamed_fragments_staggered(self, monkeypatch) -> None:
        """Two fragments, sync_every=6 → per-fragment cadence 3, stall 1:
        commits land one step after each sync step."""
        _manager, model, diloco = _streamed(
            monkeypatch, sync_every=6, num_fragments=2, lr=1.0,
            arrays={"a": np.full(4, 10.0, np.float32), "b": np.full(4, 20.0, np.float32)},
        )
        results = []
        for _ in range(8):
            _inner(model)
            results.append(diloco.step())
        assert [i for i, r in enumerate(results) if r is True] == [3, 6]

    def test_exit_drains_pending_stream_barrier(self, monkeypatch) -> None:
        manager, model, diloco = _streamed(monkeypatch)
        with diloco:
            for _ in range(3):  # stops ON the sync step: submit, no barrier
                _inner(model)
                diloco.step()
            assert diloco._stream_pending_frag is not None
        assert diloco._stream_pending_frag is None
        with manager._pending_works_lock:
            assert manager._stream_pending == {}
        np.testing.assert_allclose(model.values()["w"], np.full(4, 8.5))

    def test_localsgd_streams_whole_model(self, monkeypatch) -> None:
        monkeypatch.setenv(STREAM_SYNC_ENV, "1")
        monkeypatch.setenv(STREAM_MAX_STALENESS_ENV, "1")
        client = StubClient()
        client.quorum_results += [quorum_result(max_world_size=2) for _ in range(4)]
        model = Params({"w": np.full(3, 4.0, np.float32)})
        local_sgd = LocalSGD(stub_manager(client), model, sync_every=2)
        # step 2 submits; step 3 is the barrier: the committed average is of
        # the SYNC-step params (4 → 2 over 2 participants), and it
        # overwrites the stall step's inner progress
        assert local_sgd.step() is None
        assert local_sgd.step() is None
        _inner(model)
        assert local_sgd.step() is True
        np.testing.assert_allclose(model.values()["w"], np.full(3, 2.0))


class TestStreamFence:
    def test_unresolved_stream_forces_vote_false(self) -> None:
        manager = solo_manager(1)
        manager.start_quorum()
        hung: concurrent.futures.Future = concurrent.futures.Future()
        manager.stream_submitted(0, Work(hung))
        assert manager.stream_unresolved() == [0]
        assert manager.should_commit() is False
        assert "half-streamed" in str(manager.errored())
        hung.set_result(None)

    def test_resolved_stream_votes_normally(self) -> None:
        manager = solo_manager(1)
        manager.start_quorum()
        manager.stream_submitted(0, DummyWork(np.zeros(2)))
        assert manager.stream_unresolved() == []
        assert manager.should_commit() is True

    def test_start_quorum_drops_abandoned_resolved_streams(self) -> None:
        manager = solo_manager(2)
        manager.start_quorum()
        manager.stream_submitted(1, DummyWork(None))
        manager.start_quorum()
        with manager._pending_works_lock:
            assert manager._stream_pending == {}


class TestGoldenBlockingPin:
    def test_stream_off_is_bit_identical_to_unset(self, monkeypatch) -> None:
        monkeypatch.delenv(STREAM_SYNC_ENV, raising=False)
        monkeypatch.delenv(STREAM_MAX_STALENESS_ENV, raising=False)
        baseline = _regression_trajectory()
        monkeypatch.setenv(STREAM_SYNC_ENV, "0")
        monkeypatch.setenv(STREAM_MAX_STALENESS_ENV, "2")  # =0 pins the blocking schedule
        assert np.array_equal(np.array(baseline), np.array(_regression_trajectory()))

    def test_stream_off_matches_golden_fixture(self, monkeypatch) -> None:
        monkeypatch.setenv(STREAM_SYNC_ENV, "0")
        with open(FIXTURE_PATH) as f:
            expected = json.load(f)
        np.testing.assert_allclose(np.array(_regression_trajectory()), np.array(expected),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_streamed_two_replicas_bit_identical(monkeypatch, quant) -> None:
    """2 replicas, streamed sharded sync (sync_every=4, stall 2): the
    barrier position is deterministic, so replicas end bit-identical."""
    from torchft_tpu_torch.lighthouse import LighthouseServer

    monkeypatch.setenv(STREAM_SYNC_ENV, "1")
    monkeypatch.setenv(STREAM_MAX_STALENESS_ENV, "2")
    server = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=200,
                              quorum_tick_ms=20, heartbeat_timeout_ms=1000)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = [pool.submit(_diloco_replica, i, server.local_address(), 3, 4, quant)
                       for i in range(2)]
            w0, w1 = [f.result(timeout=120.0) for f in futures]
    finally:
        server.shutdown()
    np.testing.assert_array_equal(w0, w1)
    assert w0[0] < 1.0
