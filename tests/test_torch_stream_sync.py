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
- ``chip_smoke.py``'s ``diloco_stream_cpp`` at ``llama_debug`` size: a
  streamed ``run_diloco_fleet`` of two replicas on the C++ tier (and the
  same on the Python tier), replica 1 killed right after it submitted a
  fragment's streamed sync, passes the card phase's checks: every sync at
  a stream barrier, the sync in flight at the kill committed nowhere, the
  restarted replica healed and synced every fragment, equal backups.  The
  two tiers end bit-identical, so the C++ communicator carries the
  rotating stream tag windows as the Python one does.
- The kill mid-fragment against the JAX package: its stream drill's
  replica and the port's, two replicas in lock step, the victim killed
  right after a streamed submit and a replacement healed in: the same
  commit decisions on every replica (the sync in flight at the kill
  committed on neither) and the same committed fragment backups, bit for
  bit.
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


STREAM_TIERS = ("cpp", "python")


@pytest.fixture(scope="module")
def streamed_fleets():
    """``diloco_stream_cpp``'s fleet (chip_smoke.py) at ``llama_debug`` size
    on each tier: {tier: results}.  The C++ tier skips only where the
    port's native library does not build."""
    import os
    import sys
    from pathlib import Path
    from unittest import mock

    import torch

    from torchft_tpu_torch import native, train_ddp, train_diloco

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    fleet = dict(chip_smoke.DILOCO_PHASES)["diloco_stream_cpp"]
    out = {"chip_smoke": chip_smoke, "fleet": fleet}
    for tier in STREAM_TIERS:
        if tier == "cpp" and not native.available():
            out[tier] = f"the port's native library does not build: {native._lib_error}"
            continue
        with mock.patch.dict(os.environ, chip_smoke.STREAM_ENV):
            out[tier] = train_diloco.run_diloco_fleet(
                train_ddp.model_config("llama_debug"), torch.device("cpu"), replicas=2,
                batch=2, seq=128, lr=1e-3, timeout=30.0, tier=tier, **fleet)
    return out


def _fleet_or_skip(streamed_fleets, tier):
    results = streamed_fleets[tier]
    if isinstance(results, str):
        pytest.skip(results)
    return results


@pytest.mark.parametrize("tier", STREAM_TIERS)
def test_streamed_fleet_survives_a_kill_mid_fragment(streamed_fleets, tier) -> None:
    results = _fleet_or_skip(streamed_fleets, tier)
    chip_smoke, fleet = streamed_fleets["chip_smoke"], streamed_fleets["fleet"]
    communicator = "CppCommunicator" if tier == "cpp" else "TCPCommunicator"
    assert [r.planes["communicator"] for r in results] == [communicator] * 2
    assert [r.restarts for r in results] == [0, 1]
    assert [r.final_step for r in results] == [fleet["outer_steps"]] * 2
    got = chip_smoke.check_stream(results, fleet)
    # fragment 1's sync, submitted at step 1 right before the kill
    assert got["kill"] == dict(inner_step=fleet["kill_at"][1], step=1, in_flight=[1])
    assert results[0].sync_decisions == [(0, True), (1, False), (1, True), (2, True)]
    assert results[1].heal is not None and results[1].fragment_heals == [1, 1]
    assert chip_smoke.check_post_heal_syncs(results[1], fleet["num_fragments"]) == [1, 0]
    assert results[0].fragment_sha256 == results[1].fragment_sha256
    assert results[0].fragment_sha256 != results[0].initial_fragment_sha256
    chip_smoke.check_backups(results, fleet["num_fragments"])
    last = (fleet["outer_steps"] - 1) % fleet["num_fragments"]
    assert results[0].fragment_live_sha256[last] == results[1].fragment_live_sha256[last]


def test_streamed_fleet_tiers_end_bit_identical(streamed_fleets) -> None:
    """The same streamed run with the same kill on each tier: equal
    fragment backups and live parameters, so the C++ tier's chunk exchange
    framed in the stream tag windows carries the bytes the Python one does."""
    cpp, python = (_fleet_or_skip(streamed_fleets, tier) for tier in STREAM_TIERS)
    for a, b in zip(cpp, python):
        assert a.fragment_sha256 == b.fragment_sha256
        assert a.fragment_live_sha256 == b.fragment_live_sha256
        assert a.sync_decisions == b.sync_decisions


# ---------------------------------------------------------------------------
# the kill mid-fragment, held against the JAX package: its stream drill's
# replica (torchft_tpu/drill.py ``_stream_drill``) in lock step
# ---------------------------------------------------------------------------

# the fleet ends once every replica committed this outer step
LOCKSTEP_TARGET = 4
LOCKSTEP_ELEMS = 150_000  # the stream drill's leaf size: a sync is mid-wire at the kill


class _LockstepReplica:
    """One replica of the stream drill (two leaves, so two fragments;
    ``sync_every=4``; outer SGD 0.7, momentum 0.9, Nesterov) on package
    ``pkg`` ("jax" or "port"), with a lighthouse that needs both replicas,
    so the two replicas step in lock step.  Its inner step subtracts
    ``(idx + 1) / 128`` from every parameter (exact in f32).  With
    ``kill`` it dies as the drill's victim does, right after its first
    streamed submit past a committed sync: its communicator aborted, its
    Manager shut down."""

    def __init__(self, pkg: str, idx: int, addr: str, life: int = 0, kill: bool = False) -> None:
        self.pkg, self.idx, self.kill = pkg, idx, kill
        self.decisions = []
        self.healed = self.killed = False
        kw = dict(min_replica_size=2, use_async_quorum=False, lighthouse_addr=addr,
                  replica_id=f"lockstep_{idx}" + "r" * life, timeout=30.0, quorum_timeout=30.0,
                  connect_timeout=30.0)
        init = {"a": np.full(LOCKSTEP_ELEMS, 1.0, np.float32),
                "b": np.full(LOCKSTEP_ELEMS, 2.0, np.float32)}
        if pkg == "jax":
            import optax

            from torchft_tpu.communicator import TCPCommunicator as JaxTCP
            from torchft_tpu.local_sgd import DiLoCo as JaxDiLoCo
            from torchft_tpu.manager import Manager as JaxManager

            self.holder = {"params": init}
            self.comm = JaxTCP(timeout_s=30.0)
            self.manager = JaxManager(comm=self.comm, load_state_dict=self._load_jax,
                                      state_dict=lambda: dict(self.holder), **kw)
            self.diloco = JaxDiLoCo(self.manager, self.holder,
                                    optax.sgd(0.7, momentum=0.9, nesterov=True),
                                    sync_every=4, num_fragments=2)
            self.fragments = self.diloco._fragments
        else:
            import torch

            from torchft_tpu_torch.communicator import TCPCommunicator
            from torchft_tpu_torch.manager import Manager

            from tests.test_torch_local_sgd import Params

            self.model = Params(init)
            self.comm = TCPCommunicator(timeout_s=30.0)

            def load(sd) -> None:
                self.model.set({n: np.asarray(torch.as_tensor(t)) for n, t in
                                sd["params"].items()})
                self.healed = True

            self.manager = Manager(comm=self.comm, load_state_dict=load, state_dict=lambda: {
                "params": {n: p.detach().clone() for n, p in self.model.named_parameters()}}, **kw)
            self.diloco = DiLoCo(self.manager, self.model,
                                 OuterSGD(0.7, momentum=0.9, nesterov=True),
                                 sync_every=4, num_fragments=2)
            self.fragments = self.diloco.fragments
        assert self.diloco.streaming()

    def _load_jax(self, sd) -> None:
        self.holder.update(sd)
        self.healed = True

    def _inner_step(self) -> None:
        delta = (self.idx + 1) / 128
        if self.pkg == "jax":
            self.holder["params"] = {k: v - np.float32(delta)
                                     for k, v in self.holder["params"].items()}
        else:
            self.model.set({k: v - np.float32(delta) for k, v in self.model.values().items()})

    def loop(self) -> None:
        try:
            while self.manager.current_step() < LOCKSTEP_TARGET:
                self._inner_step()
                step = self.manager.current_step()
                try:
                    committed = self.diloco.step()
                except Exception:  # noqa: BLE001 — a failed round, not a crash
                    committed = False
                if committed is not None:
                    self.decisions.append((step, bool(committed)))
                if (self.kill and any(c for _, c in self.decisions)
                        and self.diloco._stream_pending_frag is not None):
                    self.killed = True
                    self.comm.abort("lockstep kill")
                    return
        finally:
            self.manager.shutdown()

    def backups(self) -> list:
        """Each fragment's committed backup, as f32 bytes."""
        out = []
        for frag in self.fragments:
            out.append(b"".join(np.asarray(getattr(x, "numpy", lambda: x)(), np.float32).tobytes()
                                for x in frag.backup))
        return out


def _lockstep_kill_mid_fragment(pkg: str, monkeypatch) -> dict:
    """Two replicas in lock step, replica 1 killed right after a streamed
    submit, its replacement started once it died: each replica's commit
    decisions (the step each was taken at) and fragment backups."""
    import threading

    if pkg == "jax":
        from torchft_tpu.lighthouse import LighthouseServer
    else:
        from torchft_tpu_torch.lighthouse import LighthouseServer
    monkeypatch.setenv(STREAM_SYNC_ENV, "1")
    monkeypatch.setenv(STREAM_MAX_STALENESS_ENV, "1")
    server = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=300,
                              quorum_tick_ms=20, heartbeat_timeout_ms=800)
    try:
        addr = server.local_address()
        survivor = _LockstepReplica(pkg, 0, addr)
        victim = _LockstepReplica(pkg, 1, addr, kill=True)
        threads = [threading.Thread(target=r.loop, daemon=True) for r in (survivor, victim)]
        for t in threads:
            t.start()
        threads[1].join(timeout=120.0)
        assert victim.killed, f"{pkg}: the victim never died mid-fragment"
        replacement = _LockstepReplica(pkg, 1, addr, life=1)
        threads.append(threading.Thread(target=replacement.loop, daemon=True))
        threads[-1].start()
        for t in (threads[0], threads[2]):
            t.join(timeout=180.0)
        assert not any(t.is_alive() for t in threads), f"{pkg}: the fleet did not finish"
    finally:
        server.shutdown()
    return dict(decisions=[survivor.decisions, victim.decisions, replacement.decisions],
                healed=replacement.healed, steps=[survivor.manager.current_step(),
                                                  replacement.manager.current_step()],
                backups=[survivor.backups(), replacement.backups()])


def test_kill_mid_fragment_matches_the_jax_package(monkeypatch) -> None:
    """The JAX package's stream drill replica and the port's, in lock step
    with the same kill: the same sync decisions on every replica (the sync
    in flight at the kill committed on neither package), the replacement
    healed, and the same committed fragment backups, bit for bit."""
    jax_run = _lockstep_kill_mid_fragment("jax", monkeypatch)
    port = _lockstep_kill_mid_fragment("port", monkeypatch)
    for run in (jax_run, port):
        survivor, victim, _ = run["decisions"]
        killed_at = victim[-1][0] + 1  # the step whose sync was in flight
        assert (killed_at, False) in survivor, run["decisions"]
        assert run["healed"] and run["steps"] == [LOCKSTEP_TARGET] * 2
        assert run["backups"][0] == run["backups"][1]
    assert port["decisions"] == jax_run["decisions"]
    assert port["backups"] == jax_run["backups"]
