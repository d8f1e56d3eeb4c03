"""Chaos drills: real fleets in one process, failures injected mid-run.

The port of ``torchft_tpu/drill.py``'s :func:`gray_failure_drill` and the
drills it dispatches to (``_spare_drill``, ``_device_loss_drill``,
``_stream_drill``): one in-process lighthouse, one ``Manager`` +
``TCPCommunicator`` per replica (threads), a plain allreduce or DiLoCo loop,
and a typed failure delivered through :class:`~torchft_tpu_torch.chaos.
ChaosController`.  Each drill asserts its contract internally and returns
the JAX drill's report keys.

Each replica's state is a torch tensor on ``device`` (``cuda`` unless the
caller passes ``device="cpu"``; with no card a CUDA request raises).  The
replica dimension runs host-side, as everywhere in the port: a gradient
leaves the card as a host array for ``Manager.allreduce`` and the average
comes back onto it.  The gradients and data are the JAX drill's, made with
numpy from the same seeds.

:func:`joint_ft_spmd_drill` composes FT across replica groups with HSDP
inside each, on ``train_hsdp.run_hsdp_fleet``'s rank processes;
:func:`postmortem_drill` reconstructs a fault's causal chain from the
merged flight dumps on either tier; :func:`coord_churn_drill` holds the
coordination plane's invariants through churn at fleet scale
(:mod:`~torchft_tpu_torch.coord.scale`, host only).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("drill: CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def _host(t: torch.Tensor) -> np.ndarray:
    """A fresh f32 host array of ``t`` for ``Manager.allreduce``."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _on(avg: Any, dev: torch.device) -> torch.Tensor:
    """An allreduce result back on the drill's device, as f32."""
    return torch.from_numpy(np.asarray(avg, dtype=np.float32)).to(dev)


def _restore_env(saved: Dict[str, Optional[str]]) -> None:
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def gray_failure_drill(
    num_replicas: int = 3,
    steps: int = 12,
    mode: str = "net_flaky",
    fault_spec: Optional[str] = None,
    lanes: int = 2,
    payload_elems: int = 300_000,
    arm_at_step: int = 3,
    timeout_s: float = 20.0,
    evict_persist: int = 2,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Gray-failure chaos drill: a real fleet (lighthouse + one Manager +
    TCPCommunicator per replica, threads in one process) stepping a plain
    allreduce loop while a typed gray failure is armed mid-run via
    :class:`~torchft_tpu_torch.chaos.ChaosController`.

    Modes (one :class:`~torchft_tpu_torch.chaos.Failure` class each):

    - ``net_flaky``: EVERY replica's link turns flaky (frame loss +
      occasional connection resets) after ``arm_at_step`` commits.  The
      fleet must finish all ``steps`` with ZERO quorum reconfigurations —
      recovery stays in-epoch — and nonzero lane reconnects.
    - ``slow_nic``: one replica's NIC turns persistently slow.  With
      ``TORCHFT_EVICT_SLOW=1`` (set by the drill) the lighthouse must flag
      it from heartbeat comm-health and shed it from the quorum; the
      surviving fleet's step time must recover.
    - ``partition``: one replica is cut off (data-plane partition mask +
      paused heartbeats).  The MAJORITY side must form a quorum without it
      (anti split-brain keeps the minority down).
    - ``spare_promote``: a hot spare (wire-v3 SPARE role) warms beside
      ``num_replicas`` actives; one active is killed and the lighthouse
      must promote the spare in the SAME membership edit — the report
      carries ``promotion_latency_s`` (kill → promoted spare's first
      commit, the drill's ``mean_heal_in_s``) and ``warm_lag_steps``.
    - ``kill_spare``: the spare is killed MID-WARM; the active fleet must
      finish every step with ZERO quorum reconfigurations and bit-identical
      params — a dying spare never poisons or stalls the fleet.
    - ``device_loss``: one replica loses an IN-replica device mid-run and
      must NOT die: it re-lowers onto the survivors
      (``parallel.degraded``), advertises the reduced capacity (wire v5),
      rescales its data shard, and the fleet keeps committing with ZERO
      full-replica evictions and ZERO reconfigs; final params are
      bit-identical across the fleet and allclose to an unwounded run at
      equal total samples.
    - ``device_loss_swap``: same wound with a warm full-width spare
      registered — the lighthouse must trade the wounded replica for the
      spare in EXACTLY ONE membership edit; the report carries
      ``wound_to_swap_s``.
    - ``device_loss_kill_mid_relower``: the wounded replica dies BETWEEN
      ``begin_relower`` and ``complete_relower``; the drill proves the
      half-relowered replica never voted commit and the survivors carry
      on.
    - ``stream_kill_mid_fragment``: a streamed-DiLoCo fleet
      (``TORCHFT_STREAM_SYNC=1``) loses one replica WHILE a fragment's
      outer sync is streaming under inner compute; the half-streamed sync
      must be FULLY discarded and, after the replacement heals in, the
      fleet commits streamed syncs again with ZERO divergence.

    ``device`` holds every replica's state (``cuda`` by default).  Returns
    summary facts (also asserted internally)."""
    from torchft_tpu_torch.chaos import ChaosController, Failure, ThreadReplica
    from torchft_tpu_torch.communicator import TCPCommunicator
    from torchft_tpu_torch.lighthouse import LighthouseServer
    from torchft_tpu_torch.manager import Manager

    dev = _resolve_device(device)
    if mode == "stream_kill_mid_fragment":
        return _stream_drill(
            num_replicas=num_replicas,
            steps=steps,
            arm_at_step=arm_at_step,
            timeout_s=timeout_s,
            dev=dev,
        )

    if mode in (
        "device_loss",
        "device_loss_swap",
        "device_loss_kill_mid_relower",
    ):
        return _device_loss_drill(
            mode=mode,
            num_replicas=num_replicas,
            steps=steps,
            arm_at_step=arm_at_step,
            timeout_s=timeout_s,
            dev=dev,
        )

    if mode in ("spare_promote", "kill_spare"):
        # hot-spare chaos rides the same drill surface (and report keys)
        # but a very different fleet shape — stateful replicas plus a
        # warming spare — so it runs its own scaffolding
        return _spare_drill(
            mode=mode,
            num_replicas=num_replicas,
            steps=steps,
            payload_elems=payload_elems,
            arm_at_step=arm_at_step,
            timeout_s=timeout_s,
            dev=dev,
        )

    assert mode in ("net_flaky", "slow_nic", "partition"), mode
    assert num_replicas >= 3, "gray drills need a majority side"
    failure = {
        "net_flaky": Failure.NET_FLAKY,
        "slow_nic": Failure.SLOW_NIC,
        "partition": Failure.PARTITION,
    }[mode]

    saved_env = {
        k: os.environ.get(k)
        for k in (
            "TORCHFT_RING_LANES",
            "TORCHFT_EVICT_SLOW",
            "TORCHFT_EVICT_PERSIST",
            "TORCHFT_EVICT_MIN_STALL_RATE",
        )
    }
    os.environ["TORCHFT_RING_LANES"] = str(lanes)
    if mode == "slow_nic":
        os.environ["TORCHFT_EVICT_SLOW"] = "1"
        os.environ["TORCHFT_EVICT_PERSIST"] = str(evict_persist)

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=num_replicas - 1,
        join_timeout_ms=300,
        quorum_tick_ms=20,
        heartbeat_timeout_ms=1500,
    )

    class _Replica:
        def __init__(self, idx: int) -> None:
            self.idx = idx
            self.comm = TCPCommunicator(timeout_s=timeout_s)
            self.manager = Manager(
                comm=self.comm,
                load_state_dict=None,
                state_dict=None,
                min_replica_size=num_replicas - 1,
                replica_id=f"gray_{idx}",
                lighthouse_addr=lighthouse.local_address(),
                timeout=timeout_s,
                quorum_timeout=timeout_s,
                connect_timeout=timeout_s,
            )
            self.commits = 0
            self.reconfigs_after_arm = 0
            self.qid_at_arm: Optional[int] = None
            self.step_times: List[float] = []
            self.excluded = False

    rng = np.random.default_rng(7)
    grad = torch.from_numpy(rng.normal(size=payload_elems).astype(np.float32)).to(dev)
    replicas = [_Replica(i) for i in range(num_replicas)]
    victim_idx = num_replicas - 1
    armed = threading.Event()
    stop = threading.Event()
    chaos = ChaosController(
        [ThreadReplica(f"gray_{r.idx}", r) for r in replicas]
    )

    def replica_main(rep: _Replica) -> None:
        # replicas step until the main thread calls the drill over — an
        # early solo exit would itself shrink the quorum and masquerade as
        # a gray-failure reconfiguration
        while not stop.is_set():
            t0 = time.monotonic()
            try:
                rep.manager.start_quorum()
                work = rep.manager.allreduce(_host(grad))
                work.wait(timeout=timeout_s)
                ok = rep.manager.should_commit()
            except Exception:  # noqa: BLE001 — a gray step is a failed vote
                ok = False
            if ok and not stop.is_set():
                rep.commits += 1
                rep.step_times.append(time.monotonic() - t0)
                if (
                    armed.is_set()
                    and rep.qid_at_arm is not None
                    and rep.manager._quorum_id != rep.qid_at_arm
                ):
                    rep.reconfigs_after_arm += 1
                    rep.qid_at_arm = rep.manager._quorum_id
            elif armed.is_set() and rep.idx == victim_idx and mode != "net_flaky":
                # the shed/partitioned victim stops burning quorum RPCs once
                # the fleet has visibly moved on without it
                status = lighthouse._status()
                ids = [p["replica_id"] for p in status["participants"]]
                if all(not i.startswith(f"gray_{victim_idx}") for i in ids):
                    rep.excluded = True
                    return

    threads = [
        threading.Thread(target=replica_main, args=(r,), daemon=True)
        for r in replicas
    ]
    result: Dict[str, Any] = {}
    try:
        for t in threads:
            t.start()
        # let the fleet form and commit a few clean steps, then arm
        deadline = time.monotonic() + 120.0
        while (
            min(r.commits for r in replicas) < arm_at_step
            and time.monotonic() < deadline
        ):
            time.sleep(0.05)
        assert min(r.commits for r in replicas) >= arm_at_step, (
            "fleet never reached the arming step"
        )
        # snapshot the steady-state quorum id BEFORE arming: any bump past
        # this point is a reconfiguration the gray failure caused
        for r in replicas:
            r.qid_at_arm = r.manager._quorum_id
        spec_kw = {"spec": fault_spec} if fault_spec is not None else {}
        if mode == "net_flaky":
            # every link turns flaky at once — the hardest in-epoch case
            for handle in chaos.replicas:
                chaos.inject(failure, victim=handle, **spec_kw)
        else:
            chaos.inject(failure, victim=chaos.replicas[victim_idx], **spec_kw)
        armed.set()

        if mode == "net_flaky":
            deadline = time.monotonic() + 240.0
            while (
                min(r.commits for r in replicas) < steps
                and time.monotonic() < deadline
            ):
                time.sleep(0.05)
            stop.set()
            for t in threads:
                t.join(timeout=2 * timeout_s + 10.0)
            assert all(r.commits >= steps for r in replicas), (
                f"fleet stalled under {mode}: "
                f"{[r.commits for r in replicas]}"
            )
            reconfigs = sum(r.reconfigs_after_arm for r in replicas)
            health = [r.manager._comm_health() for r in replicas]
            reconnects = sum(h.reconnects for h in health)
            faults = sum(h.faults for h in health)
            assert reconfigs == 0, (
                f"{reconfigs} quorum reconfigurations under net_flaky "
                "(recovery must stay in-epoch)"
            )
            assert faults > 0, "fault program never fired"
            result.update(
                quorum_reconfigs=reconfigs,
                lane_reconnects=reconnects,
                faults_injected=faults,
            )
        else:
            # survivors must finish; the victim must end up excluded (per
            # the lighthouse's own quorum view)
            survivors = [r for r in replicas if r.idx != victim_idx]
            deadline = time.monotonic() + 240.0
            victim_out = False
            while (
                min(r.commits for r in survivors) < steps or not victim_out
            ) and time.monotonic() < deadline:
                time.sleep(0.2)
                ids = [
                    p["replica_id"]
                    for p in lighthouse._status()["participants"]
                ]
                victim_out = bool(ids) and all(
                    not i.startswith(f"gray_{victim_idx}") for i in ids
                )
            stop.set()
            for t in threads:
                t.join(timeout=2 * timeout_s + 10.0)
            assert all(r.commits >= steps for r in survivors), (
                f"survivors stalled under {mode}: "
                f"{[r.commits for r in survivors]}"
            )
            status = lighthouse._status()
            ids = [p["replica_id"] for p in status["participants"]]
            assert all(
                not i.startswith(f"gray_{victim_idx}") for i in ids
            ), f"victim still in quorum under {mode}: {ids}"
            if mode == "slow_nic":
                assert status["evictions_total"] >= 1, status
                # step time must RECOVER once the straggler is shed: the
                # last post-eviction steps vs the pre-arm baseline
                base = [
                    float(np.median(r.step_times[:arm_at_step]))
                    for r in survivors
                ]
                tail = [
                    float(np.median(r.step_times[-5:])) for r in survivors
                ]
                result.update(
                    step_time_clean_s=float(np.mean(base)),
                    step_time_recovered_s=float(np.mean(tail)),
                )
            result.update(
                victim_excluded=True,
                evictions_total=status["evictions_total"],
            )
        result["commits"] = [r.commits for r in replicas]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
        for r in replicas:
            try:
                r.manager.shutdown()
            except Exception:  # noqa: BLE001
                pass
        lighthouse.shutdown()
        _restore_env(saved_env)
    return result


def _spare_drill(
    mode: str,
    num_replicas: int = 3,
    steps: int = 12,
    payload_elems: int = 50_000,
    arm_at_step: int = 3,
    timeout_s: float = 20.0,
    dev: torch.device = torch.device("cpu"),
) -> Dict[str, Any]:
    """Hot-spare chaos: ``num_replicas`` stateful actives + 1 warming spare
    (see :func:`gray_failure_drill` for the mode contracts)."""
    from torchft_tpu_torch.chaos import ChaosController, Failure, ThreadReplica
    from torchft_tpu_torch.communicator import TCPCommunicator
    from torchft_tpu_torch.lighthouse import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.spare import SpareAgent

    assert mode in ("spare_promote", "kill_spare"), mode
    assert num_replicas >= 2, "spare drills need a surviving majority"

    saved_env = {
        k: os.environ.get(k)
        for k in ("TORCHFT_SPARE_WARM_REFRESH_S", "TORCHFT_SPARE_PROMOTE")
    }
    # restage the warm snapshot every committed step: the drill's steps are
    # fast, and a spare warm to the commit front is the promotion case the
    # drill measures
    os.environ["TORCHFT_SPARE_WARM_REFRESH_S"] = "0"
    # promotion stays OFF until the fleet is armed: the drill's tight
    # heartbeat window (300 ms) means a busy host can miss an active's beat
    # during the startup scramble, and promoting the still-cold spare over
    # a LIVE replica wedges rendezvous.  The lighthouse reads the knob per
    # quorum computation, so flipping it after arming takes effect at once.
    os.environ["TORCHFT_SPARE_PROMOTE"] = "0"

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=num_replicas - 1,
        join_timeout_ms=300,
        quorum_tick_ms=10,
        # death detection dominates promotion latency: the sub-second
        # promotion needs a tight heartbeat window
        heartbeat_timeout_ms=300,
    )

    class _Rep:
        def __init__(self, idx: int, role: str = "active") -> None:
            self.idx = idx
            self.role = role
            self.params = torch.zeros(payload_elems, dtype=torch.float32, device=dev)
            self.comm = TCPCommunicator(timeout_s=timeout_s)
            self.manager = Manager(
                comm=self.comm,
                load_state_dict=self._load,
                state_dict=self._save,
                min_replica_size=num_replicas - 1,
                replica_id=f"spare_drill_{role}_{idx}",
                lighthouse_addr=lighthouse.local_address(),
                timeout=timeout_s,
                quorum_timeout=timeout_s,
                connect_timeout=timeout_s,
                role=role,
            )
            self.commits = 0
            self.reconfigs_after_arm = 0
            self.qid_at_arm: Optional[int] = None
            self.kill_flag = threading.Event()
            self.first_commit_after_kill_ts: Optional[float] = None
            # the committed averages, in order (each a constant vector: its
            # first element)
            self.averages: List[float] = []

        def _save(self) -> Dict[str, Any]:
            return {"params": self.params.clone()}

        def _load(self, sd: Dict[str, Any]) -> None:
            self.params = torch.as_tensor(sd["params"]).to(dev, torch.float32, copy=True)

        def active_loop(self, stop: threading.Event) -> None:
            # distinct per-replica gradients: final bit-identity across the
            # fleet is only possible if everyone applied the same averages
            grad = torch.full((payload_elems,), float(self.idx + 1), dtype=torch.float32, device=dev)
            while not stop.is_set() and self.manager.current_step() < steps:
                if (
                    not warm_gate.is_set()
                    and self.manager.current_step() >= arm_at_step + 2
                ):
                    # don't burn through the step budget before the spare
                    # has warmed (it would end the drill with nothing to
                    # promote)
                    warm_gate.wait(timeout=120.0)
                if self.kill_flag.is_set():
                    # hard death: heartbeats stop, peers' collectives fail.
                    # kill_ts is the moment death actually lands (the flag
                    # is polled at step boundaries)
                    kill_ts[0] = kill_ts[0] or time.monotonic()
                    self.manager.shutdown()
                    return
                try:
                    self.manager.start_quorum()
                    work = self.manager.allreduce(_host(grad))
                    avg = work.wait(timeout=timeout_s)
                    ok = self.manager.should_commit()
                except Exception:  # noqa: BLE001 — a failed step, not a crash
                    ok = False
                if ok and not stop.is_set():
                    self.params += _on(avg, dev)
                    self.averages.append(float(np.asarray(avg).reshape(-1)[0]))
                    self.commits += 1
                    if self.first_commit_after_kill_ts is None and kill_ts[0]:
                        self.first_commit_after_kill_ts = time.monotonic()
                    if (
                        self.qid_at_arm is not None
                        and self.manager._quorum_id != self.qid_at_arm
                    ):
                        self.reconfigs_after_arm += 1
                        self.qid_at_arm = self.manager._quorum_id

    kill_ts: List[float] = [0.0]
    stop = threading.Event()
    warm_gate = threading.Event()
    actives = [_Rep(i) for i in range(num_replicas)]
    spare = _Rep(num_replicas, role="spare")
    agent = SpareAgent(spare.manager)
    promoted = threading.Event()

    def spare_loop() -> None:
        while not stop.is_set() and not spare.kill_flag.is_set():
            if agent.step(park_timeout_s=1.0):
                promoted.set()
                spare.active_loop(stop)
                return
        if spare.kill_flag.is_set():
            # die mid-warm: sever everything at once (heartbeats included)
            spare.manager.shutdown()

    threads = [
        threading.Thread(target=r.active_loop, args=(stop,), daemon=True)
        for r in actives
    ]
    spare_thread = threading.Thread(target=spare_loop, daemon=True)
    victim = actives[num_replicas - 1]
    chaos = ChaosController(
        [ThreadReplica(f"rep_{r.idx}", r) for r in actives]
        + [ThreadReplica("spare", spare)]
    )
    result: Dict[str, Any] = {}
    try:
        for t in threads:
            t.start()
        spare_thread.start()
        # arm gate: fleet committing AND the spare demonstrably warm
        deadline = time.monotonic() + 120.0
        while (
            min(r.commits for r in actives) < arm_at_step
            or agent.warm_step < 1
        ) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert min(r.commits for r in actives) >= arm_at_step, (
            "fleet never reached the arming step"
        )
        assert agent.warm_step >= 1, "spare never warmed"
        for r in actives:
            r.qid_at_arm = r.manager._quorum_id
        warm_lag_at_arm = float(agent.metrics.get("warm_lag_steps", 0.0))
        # armed: the spare is demonstrably warm, so promotion is now safe
        # (and in kill_spare mode its absence is what the drill asserts —
        # a dead spare must never be promoted)
        os.environ["TORCHFT_SPARE_PROMOTE"] = "1"
        warm_gate.set()

        if mode == "spare_promote":
            chaos.inject(Failure.KILL, victim=chaos.replicas[victim.idx])
            kill_deadline = time.monotonic() + 60.0
            while not kill_ts[0] and time.monotonic() < kill_deadline:
                time.sleep(0.01)
            assert kill_ts[0], "victim never died"
            survivors = [r for r in actives if r is not victim] + [spare]
            assert promoted.wait(timeout=60.0), "spare was never promoted"
            deadline = time.monotonic() + 240.0
            while (
                min(r.manager.current_step() for r in survivors) < steps
                and time.monotonic() < deadline
            ):
                time.sleep(0.05)
            stop.set()
            for t in threads + [spare_thread]:
                t.join(timeout=2 * timeout_s + 10.0)
            assert all(
                r.manager.current_step() >= steps for r in survivors
            ), f"fleet stalled after promotion: {[r.commits for r in survivors]}"
            assert spare.first_commit_after_kill_ts is not None
            status = lighthouse._status()
            assert status["promotions_total"] >= 1, status
            # the ONE membership edit the death was always going to cost
            # (dead active out + spare in, same quorum computation)
            survivors_reconf = [r for r in actives if r is not victim]
            assert all(r.reconfigs_after_arm == 1 for r in survivors_reconf), (
                f"expected exactly one membership edit: "
                f"{[r.reconfigs_after_arm for r in survivors_reconf]}"
            )
            promotion_latency = spare.first_commit_after_kill_ts - kill_ts[0]
            result.update(
                promotion_latency_s=round(promotion_latency, 3),
                mean_heal_in_s=round(promotion_latency, 3),
                warm_lag_steps=float(
                    agent.metrics.get("promote_warm_lag_steps", 0.0)
                ),
                promotion_adopt_s=agent.metrics.get("promotion_adopt_s"),
                promotions_total=status["promotions_total"],
                # per-survivor (asserted identical above): the ONE
                # membership edit, not a sum over observers
                quorum_reconfigs=survivors_reconf[0].reconfigs_after_arm,
            )
            fleet = survivors
        else:  # kill_spare
            chaos.inject(Failure.SPARE, victim=chaos.replicas[-1])
            kill_ts[0] = time.monotonic()
            deadline = time.monotonic() + 240.0
            while (
                min(r.manager.current_step() for r in actives) < steps
                and time.monotonic() < deadline
            ):
                time.sleep(0.05)
            stop.set()
            for t in threads + [spare_thread]:
                t.join(timeout=2 * timeout_s + 10.0)
            assert all(
                r.manager.current_step() >= steps for r in actives
            ), f"fleet stalled after spare death: {[r.commits for r in actives]}"
            reconfigs = sum(r.reconfigs_after_arm for r in actives)
            assert reconfigs == 0, (
                f"{reconfigs} quorum reconfigurations after killing the "
                "spare (a spare's death must never touch the active fleet)"
            )
            assert not promoted.is_set(), "dead spare was promoted"
            result.update(
                quorum_reconfigs=0,
                warm_lag_steps=warm_lag_at_arm,
                promotions_total=lighthouse._status()["promotions_total"],
            )
            fleet = list(actives)

        # bit-identity: every surviving replica holds the same params —
        # neither the promotion handshake nor a dying spare forked state
        ref = fleet[0].params
        for other in fleet[1:]:
            assert torch.equal(ref, other.params), (
                "fleet params diverged "
                f"({fleet[0].idx} vs {other.idx})"
            )
        LAST_SPARE_FLEET[mode] = dict(
            params=[r.params.detach().cpu() for r in fleet],
            averages=list(fleet[0].averages),
        )
        result.update(
            commits=[r.commits for r in fleet],
            warm_bytes_fetched=float(
                agent.metrics.get("warm_bytes_fetched", 0.0)
            ),
            warm_deltas_applied=float(
                agent.metrics.get("warm_deltas_applied", 0.0)
            ),
        )
    finally:
        stop.set()
        warm_gate.set()
        spare.kill_flag.set()
        for t in threads + [spare_thread]:
            t.join(timeout=5.0)
        agent.close()
        for r in actives + [spare]:
            try:
                r.manager.shutdown()
            except Exception:  # noqa: BLE001
                pass
        lighthouse.shutdown()
        _restore_env(saved_env)
    return result


# The last spare drill of each mode: the surviving fleet's final params
# (host copies; the actives, then the promoted spare) and the averages the
# first of them committed, for a caller that holds them against another
# implementation's arithmetic.
LAST_SPARE_FLEET: Dict[str, Dict[str, list]] = {}


def _device_loss_drill(
    mode: str,
    num_replicas: int = 3,
    steps: int = 12,
    arm_at_step: int = 3,
    timeout_s: float = 20.0,
    devices_per_replica: int = 4,
    dim: int = 32,
    lr: float = 0.1,
    dev: torch.device = torch.device("cpu"),
) -> Dict[str, Any]:
    """Degraded-mode chaos (see :func:`gray_failure_drill` for the mode
    contracts): an IN-replica device dies and the replica must keep
    contributing at reduced capacity instead of failing whole.

    Each replica simulates ``devices_per_replica`` virtual devices and
    trains a shared linear objective over a capacity-rescaled data shard
    (``data.DistributedSampler(capacities=...)`` driven by the quorum's
    wire-v5 capacity vector); gradients average through the Manager's
    capacity-WEIGHTED path.  Because capacity-proportional shards
    partition the same sample set an unwounded fleet covers, the weighted
    average IS the global average — the wounded run must land allclose to
    the analytic unwounded trajectory at equal total samples, and
    bit-identical across the fleet."""
    from torchft_tpu_torch.chaos import ChaosController, Failure, ThreadReplica
    from torchft_tpu_torch.communicator import TCPCommunicator
    from torchft_tpu_torch.data import DistributedSampler
    from torchft_tpu_torch.lighthouse import LighthouseServer
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.parallel.degraded import plan_surviving
    from torchft_tpu_torch.spare import SpareAgent

    assert mode in (
        "device_loss",
        "device_loss_swap",
        "device_loss_kill_mid_relower",
    ), mode
    assert num_replicas >= 3, "device-loss drills need a surviving majority"
    with_spare = mode == "device_loss_swap"
    mid_kill = mode == "device_loss_kill_mid_relower"

    # dataset: divisible by every shard count in play so the legacy and
    # capacity partitions trim identically; nonzero mean so the reference
    # trajectory is a real signal, not noise
    n_samples = num_replicas * 240
    data_rng = np.random.default_rng(11)
    X = data_rng.normal(loc=1.0, size=(n_samples, dim)).astype(np.float32)
    X_dev = torch.from_numpy(X).to(dev)

    saved_env = {
        k: os.environ.get(k)
        for k in (
            "TORCHFT_SPARE_WARM_REFRESH_S",
            "TORCHFT_SPARE_PROMOTE",
            "TORCHFT_DEGRADED_SWAP",
        )
    }
    if with_spare:
        os.environ["TORCHFT_SPARE_WARM_REFRESH_S"] = "0"
        # promotion (and thus the swap) stays off until the fleet is armed
        # — same startup-scramble hazard _spare_drill documents
        os.environ["TORCHFT_SPARE_PROMOTE"] = "0"
        os.environ["TORCHFT_DEGRADED_SWAP"] = "1"

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=num_replicas - 1,
        join_timeout_ms=300,
        quorum_tick_ms=10,
        heartbeat_timeout_ms=1000 if mid_kill else 1500,
    )

    wound_ts: List[float] = [0.0]
    promoted_ts: List[float] = [0.0]
    mid_commit: List[Optional[bool]] = [None]
    stop = threading.Event()
    # The replicas' step budget, finalized by the MAIN thread only after
    # the wound has verifiably landed: with a fixed budget a fast fleet
    # could sprint from the arming step past the whole budget during one
    # poll sleep, before the wound lands, and no post-wound quorum would
    # ever issue.  The loops keep stepping until the main thread has SEEN
    # the relower and pins the target far enough out that several
    # post-wound rounds must commit.
    step_target: List[Optional[int]] = [None]
    warm_gate = threading.Event()
    promoted = threading.Event()
    if not with_spare:
        warm_gate.set()

    class _Rep:
        def __init__(self, idx: int, role: str = "active") -> None:
            self.idx = idx
            self.rid = f"degr_{role}_{idx}"
            self.role = role
            self.devices = devices_per_replica
            self.capacity = 1.0
            self.params = torch.zeros(dim, dtype=torch.float32, device=dev)
            self.comm = TCPCommunicator(timeout_s=timeout_s)
            self.manager = Manager(
                comm=self.comm,
                load_state_dict=self._load,
                state_dict=self._save,
                min_replica_size=num_replicas - 1,
                replica_id=self.rid,
                lighthouse_addr=lighthouse.local_address(),
                timeout=timeout_s,
                quorum_timeout=timeout_s,
                connect_timeout=timeout_s,
                role=role,
                # every replica starts from the same zeros, so the
                # init-sync force-heal round would only distort the
                # analytic reference trajectory
                init_sync=False,
            )
            self.commits = 0
            self.reconfigs_after_arm = 0
            self.qid_at_arm: Optional[int] = None
            self.step_times: List[float] = []
            self.wounded = False
            self.excluded = False
            self.kill_flag = threading.Event()
            # chaos hooks (ThreadReplica DEVICE_LOSS support)
            self.device_loss_flag = threading.Event()
            self.device_loss_count = 1
            self.device_loss_mid_relower = False

        def _save(self) -> Dict[str, Any]:
            return {"params": self.params.clone()}

        def _load(self, sd: Dict[str, Any]) -> None:
            self.params = torch.as_tensor(sd["params"]).to(dev, torch.float32, copy=True)

        def _grad(self) -> torch.Tensor:
            """This replica's shard gradient under the CURRENT quorum:
            rank/world/capacities all come from the quorum result, so the
            partition (and the capacity rescale) is identical on every
            replica — including across a swap, where ranks shift."""
            rank = self.manager.participating_rank()
            world = self.manager.num_participants()
            if rank is None or world < 1:
                return torch.zeros(dim, dtype=torch.float32, device=dev)
            caps = self.manager.participant_capacities()
            sampler = DistributedSampler(
                n_samples,
                replica_rank=rank,
                num_replica_groups=world,
                shuffle=True,
                seed=5,
                capacities=caps if len(caps) == world else None,
            )
            sampler.set_epoch(self.manager.current_step())
            idxs = sampler.indices()
            if not idxs:
                return torch.zeros(dim, dtype=torch.float32, device=dev)
            return X_dev[torch.as_tensor(idxs, device=dev)].mean(dim=0)

        def _relower(self) -> None:
            """Consume an armed device loss at a step boundary: fence the
            vote, plan the surviving layout, and advertise the new
            capacity."""
            self.wounded = True
            wound_ts[0] = wound_ts[0] or time.monotonic()
            self.manager.begin_relower()
            if self.device_loss_mid_relower:
                # the kill-mid-relower chaos case: run one step INSIDE the
                # fence — the vote must come back False — then die hard
                try:
                    self.manager.start_quorum()
                    work = self.manager.allreduce(_host(self._grad()))
                    work.wait(timeout=timeout_s)
                    mid_commit[0] = self.manager.should_commit()
                except Exception:  # noqa: BLE001 — a failed step is a no
                    mid_commit[0] = False
                self.manager.shutdown()
                return
            survivors = max(1, self.devices - self.device_loss_count)
            plan = plan_surviving(survivors, original_devices=self.devices)
            self.capacity = plan.capacity
            self.manager.complete_relower(plan.capacity)

        def active_loop(self, stop: threading.Event) -> None:
            while not stop.is_set() and (
                step_target[0] is None
                or self.manager.current_step() < step_target[0]
            ):
                if (
                    not warm_gate.is_set()
                    and self.manager.current_step() >= arm_at_step + 2
                ):
                    # don't burn the step budget before the spare warms
                    warm_gate.wait(timeout=120.0)
                if self.device_loss_flag.is_set() and not self.wounded:
                    self._relower()
                    if self.device_loss_mid_relower:
                        return
                t0 = time.monotonic()
                try:
                    self.manager.start_quorum()
                    work = self.manager.allreduce(_host(self._grad()))
                    avg = work.wait(timeout=timeout_s)
                    ok = self.manager.should_commit()
                except Exception:  # noqa: BLE001 — a failed step, not a crash
                    ok = False
                if ok and not stop.is_set():
                    self.params -= lr * _on(avg, dev)
                    self.commits += 1
                    self.step_times.append(time.monotonic() - t0)
                    if (
                        self.qid_at_arm is not None
                        and self.manager._quorum_id != self.qid_at_arm
                    ):
                        self.reconfigs_after_arm += 1
                        self.qid_at_arm = self.manager._quorum_id
                elif self.wounded and with_spare and not stop.is_set():
                    # swapped out?  stop burning quorum RPCs once the
                    # lighthouse has visibly moved on without us
                    try:
                        status = lighthouse._status()
                    except Exception:  # noqa: BLE001
                        continue
                    ids = [p["replica_id"] for p in status["participants"]]
                    if ids and all(not i.startswith(self.rid) for i in ids):
                        self.excluded = True
                        return

    actives = [_Rep(i) for i in range(num_replicas)]
    spare = _Rep(num_replicas, role="spare") if with_spare else None
    agent = SpareAgent(spare.manager) if spare is not None else None

    def spare_loop() -> None:
        assert spare is not None and agent is not None
        while not stop.is_set() and not spare.kill_flag.is_set():
            if agent.step(park_timeout_s=1.0):
                promoted_ts[0] = time.monotonic()
                promoted.set()
                spare.active_loop(stop)
                return

    victim = actives[num_replicas - 1]
    chaos = ChaosController(
        [ThreadReplica(r.rid, r) for r in actives]
        + ([ThreadReplica("spare", spare)] if spare is not None else [])
    )
    threads = [
        threading.Thread(target=r.active_loop, args=(stop,), daemon=True)
        for r in actives
    ]
    spare_thread = (
        threading.Thread(target=spare_loop, daemon=True) if spare else None
    )
    join_list = threads + ([spare_thread] if spare_thread is not None else [])
    result: Dict[str, Any] = {}
    try:
        for t in join_list:
            t.start()
        deadline = time.monotonic() + 120.0
        while (
            min(r.commits for r in actives) < arm_at_step
            or (agent is not None and agent.warm_step < 1)
        ) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert min(r.commits for r in actives) >= arm_at_step, (
            "fleet never reached the arming step"
        )
        if agent is not None:
            assert agent.warm_step >= 1, "spare never warmed"
            os.environ["TORCHFT_SPARE_PROMOTE"] = "1"
        for r in actives:
            r.qid_at_arm = r.manager._quorum_id
        pre_wound_times = {r.idx: list(r.step_times) for r in actives}
        warm_gate.set()
        chaos.inject(
            Failure.DEVICE_LOSS,
            victim=chaos.replicas[victim.idx],
            devices=1,
            mid_relower=mid_kill,
        )
        # the wound must LAND before the step budget is pinned: the victim
        # consumes the armed loss at its next loop-top, and (mid-kill
        # aside) advertises its reduced capacity on the registration right
        # after complete_relower
        deadline = time.monotonic() + 60.0
        while (
            not victim.wounded or (not mid_kill and victim.capacity >= 1.0)
        ) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert victim.wounded, "victim never consumed the armed device loss"
        if not mid_kill:
            assert victim.capacity < 1.0, "victim relower never completed"
        # pin the budget: at least ``steps`` total, and at least a few
        # rounds past the wound so the victim's capacity registration is
        # carried by quorums the whole fleet commits
        target = max(steps, max(r.manager.current_step() for r in actives) + 3)
        step_target[0] = target

        if mode == "device_loss":
            deadline = time.monotonic() + 240.0
            while (
                min(r.commits for r in actives) < target
                and time.monotonic() < deadline
            ):
                time.sleep(0.05)
            stop.set()
            for t in threads:
                t.join(timeout=2 * timeout_s + 10.0)
            assert all(r.commits >= target for r in actives), (
                f"fleet stalled after device loss: "
                f"{[r.commits for r in actives]}"
            )
            # ZERO full-replica evictions and ZERO membership edits: the
            # wound is absorbed in place
            reconfigs = sum(r.reconfigs_after_arm for r in actives)
            assert reconfigs == 0, (
                f"{reconfigs} quorum reconfigurations after device loss "
                "(the wound must be absorbed without a membership edit)"
            )
            status = lighthouse._status()
            assert status["evictions_total"] == 0, status
            assert status["degraded_evictions_total"] == 0, status
            wounded_rows = {
                d["replica_id"]: d["capacity"]
                for d in status["degraded_replicas"]
            }
            assert any(
                rid.startswith(victim.rid) for rid in wounded_rows
            ), f"lighthouse never saw the wound: {status}"
            fleet = list(actives)
            # step-time ratio, wounded against clean
            base = [
                float(np.median(pre_wound_times[r.idx]))
                for r in actives
                if pre_wound_times[r.idx]
            ]
            tail = [
                float(np.median(r.step_times[-4:]))
                for r in actives
                if len(r.step_times) >= 4
            ]
            if base and tail:
                result["degraded_step_time_ratio"] = round(
                    float(np.mean(tail)) / max(1e-9, float(np.mean(base))), 3
                )
            result.update(
                capacity_observed=min(wounded_rows.values()),
                quorum_reconfigs=0,
                evictions_total=0,
            )
        elif with_spare:
            assert promoted.wait(timeout=60.0), (
                "wounded replica was never swapped for the spare"
            )
            survivors = [r for r in actives if r is not victim]
            fleet = survivors + [spare]
            deadline = time.monotonic() + 240.0
            while (
                min(r.manager.current_step() for r in fleet) < target
                and time.monotonic() < deadline
            ):
                time.sleep(0.05)
            stop.set()
            for t in join_list:
                t.join(timeout=2 * timeout_s + 10.0)
            assert all(
                r.manager.current_step() >= target for r in fleet
            ), f"fleet stalled after swap: {[r.commits for r in fleet]}"
            status = lighthouse._status()
            assert status["swaps_total"] >= 1, status
            ids = [p["replica_id"] for p in status["participants"]]
            assert all(not i.startswith(victim.rid) for i in ids), (
                f"wounded replica still in quorum after swap: {ids}"
            )
            # the ONE membership edit: wounded out + spare in, same
            # quorum computation
            assert all(r.reconfigs_after_arm == 1 for r in survivors), (
                f"expected exactly one membership edit: "
                f"{[r.reconfigs_after_arm for r in survivors]}"
            )
            result.update(
                wound_to_swap_s=round(promoted_ts[0] - wound_ts[0], 3),
                swaps_total=status["swaps_total"],
                promotions_total=status["promotions_total"],
                quorum_reconfigs=survivors[0].reconfigs_after_arm,
                victim_excluded=True,
            )
        else:  # device_loss_kill_mid_relower
            survivors = [r for r in actives if r is not victim]
            fleet = survivors
            deadline = time.monotonic() + 240.0
            # wait for the victim's FENCED vote too, not just the
            # survivors' step budget
            while (
                min(r.commits for r in survivors) < target
                or mid_commit[0] is None
            ) and time.monotonic() < deadline:
                time.sleep(0.05)
            stop.set()
            for t in threads:
                t.join(timeout=2 * timeout_s + 10.0)
            assert all(r.commits >= target for r in survivors), (
                f"survivors stalled after mid-relower death: "
                f"{[r.commits for r in survivors]}"
            )
            # the core proof: the half-relowered replica's one vote inside
            # the begin_relower/complete_relower window came back False
            assert mid_commit[0] is False, (
                f"half-relowered replica voted commit={mid_commit[0]}"
            )
            result.update(
                mid_relower_commit=False,
                quorum_reconfigs=sum(r.reconfigs_after_arm for r in survivors),
            )

        # bit-identity: the capacity-weighted outer reduce fans the same
        # averaged bytes to every replica — params must never fork
        ref_params = fleet[0].params
        for other in fleet[1:]:
            assert torch.equal(ref_params, other.params), (
                f"fleet params diverged ({fleet[0].rid} vs {other.rid})"
            )
        if mode == "device_loss":
            # convergence: allclose vs the analytic unwounded run at equal
            # total samples (every replica committed exactly ``target``
            # rounds); rtol = atol = 2e-2 covers the largest-remainder
            # rounding of the capacity shards
            expected = -lr * target * X.mean(axis=0)
            np.testing.assert_allclose(
                fleet[0].params.cpu().numpy(), expected, rtol=2e-2, atol=2e-2
            )
            result["converged"] = True
        result["commits"] = [r.commits for r in fleet]
    finally:
        stop.set()
        warm_gate.set()
        if spare is not None:
            spare.kill_flag.set()
        for t in join_list:
            t.join(timeout=5.0)
        if agent is not None:
            agent.close()
        for r in actives + ([spare] if spare is not None else []):
            try:
                r.manager.shutdown()
            except Exception:  # noqa: BLE001
                pass
        lighthouse.shutdown()
        _restore_env(saved_env)
    return result


class _TwoLeaves(torch.nn.Module):
    """The stream drill's model: two leaves, so DiLoCo splits it into two
    fragments."""

    def __init__(self, n: int, dev: torch.device) -> None:
        super().__init__()
        self.a = torch.nn.Parameter(torch.full((n,), 1.0, dtype=torch.float32, device=dev))
        self.b = torch.nn.Parameter(torch.full((n,), 2.0, dtype=torch.float32, device=dev))


def _load_flight_merge():
    """``scripts/flight_merge.py`` (stdlib only, not part of the package),
    loaded from the checkout as the JAX drill loads it."""
    import sys

    scripts_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"
    )
    if scripts_dir not in sys.path:
        sys.path.insert(0, scripts_dir)
    import flight_merge

    return flight_merge


def _stream_drill(
    num_replicas: int = 3,
    steps: int = 10,
    arm_at_step: int = 2,
    timeout_s: float = 20.0,
    payload_elems: int = 150_000,
    dev: torch.device = torch.device("cpu"),
) -> Dict[str, Any]:
    """Streamed-DiLoCo chaos (``stream_kill_mid_fragment`` — see
    :func:`gray_failure_drill` for the mode contract): kill one replica
    WHILE a fragment's outer sync is streaming under inner compute, prove
    the half-streamed sync is fully discarded, then heal a replacement in
    and prove zero divergence.

    ``steps`` counts COMMITTED outer syncs on the anchor.  The victim dies
    right after its streamed submit (the collectives are still on the
    wire), so the survivors' in-flight chunk exchanges poison, their
    barrier vote comes back False, and ``FRAG_SUBMIT → FRAG_ABORT`` lands
    on every survivor's own seq-ordered flight ring."""
    import glob
    import tempfile

    from torchft_tpu_torch.communicator import TCPCommunicator
    from torchft_tpu_torch.lighthouse import LighthouseServer
    from torchft_tpu_torch.local_sgd import DiLoCo
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.obs import spans as obs_spans
    from torchft_tpu_torch.obs.flight import FlightEvent
    from torchft_tpu_torch.optim import OuterSGD

    flight_merge = _load_flight_merge()
    assert num_replicas >= 3, "stream drills need a surviving majority"

    tmp_ctx = tempfile.TemporaryDirectory(prefix="tpuft_stream_")
    saved_env = {
        k: os.environ.get(k)
        for k in (
            "TORCHFT_STREAM_SYNC",
            "TORCHFT_STREAM_MAX_STALENESS",
            "TORCHFT_FLIGHT_DIR",
        )
    }
    # per-fragment cadence 2, delay 0 → staleness room 1: the sync step
    # streams and the delta applies one inner step later
    os.environ["TORCHFT_STREAM_SYNC"] = "1"
    os.environ["TORCHFT_STREAM_MAX_STALENESS"] = "1"
    os.environ["TORCHFT_FLIGHT_DIR"] = tmp_ctx.name
    # per-fragment trace spans on for the drill: the submit/barrier span
    # pair is asserted below next to the FRAG_* flight events
    obs_spans.configure(True)
    obs_spans.clear()

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=num_replicas - 1,
        join_timeout_ms=300,
        quorum_tick_ms=20,
        heartbeat_timeout_ms=800,
    )
    stop = threading.Event()
    killed_ts: List[float] = [0.0]
    # committed-step bound every replica exits at, set once the drill's
    # phases are done: loops leaving at the SAME outer round is what makes
    # the final committed-state compare exact
    final_target: List[Optional[int]] = [None]

    class _Rep:
        def __init__(self, idx: int, life: int = 0) -> None:
            self.idx = idx
            self.life = life
            # two leaves → two fragments, so a streamed sync is always
            # mid-wire when the victim dies right after submit
            self.model = _TwoLeaves(payload_elems, dev)
            self.healed = False
            self.comm = TCPCommunicator(timeout_s=timeout_s)
            self.manager = Manager(
                comm=self.comm,
                load_state_dict=self._load,
                state_dict=self._save,
                min_replica_size=num_replicas - 1,
                use_async_quorum=False,
                replica_id=f"stream_{idx}" + ("r" * life),
                lighthouse_addr=lighthouse.local_address(),
                timeout=timeout_s,
                quorum_timeout=timeout_s,
                connect_timeout=timeout_s,
            )
            self.diloco = DiLoCo(
                self.manager,
                self.model,
                OuterSGD(0.7, momentum=0.9, nesterov=True),
                sync_every=4,
                num_fragments=2,
            )
            assert self.diloco.streaming(), "drill requires streamed mode"
            self.commits = 0
            self.aborts = 0
            self.kill_flag = threading.Event()

        def _save(self) -> Dict[str, Any]:
            return {"params": {n: p.detach().clone() for n, p in self.model.named_parameters()}}

        def _load(self, sd: Dict[str, Any]) -> None:
            named = dict(self.model.named_parameters())
            with torch.no_grad():
                for n, t in sd["params"].items():
                    named[n].copy_(torch.as_tensor(t))
            self.healed = True

        def loop(self) -> None:
            while not stop.is_set() and (
                final_target[0] is None
                or self.manager.current_step() < final_target[0]
            ):
                # a token of "inner compute" per step: pacing keeps failed
                # rounds from spinning so hot that the survivors'
                # quorum-join windows never overlap
                time.sleep(0.002)
                with torch.no_grad():
                    for p in self.model.parameters():
                        p.sub_(0.01 * (self.idx + 1))
                try:
                    committed = self.diloco.step()
                except Exception:  # noqa: BLE001 — a failed round, not a crash
                    committed = False
                if committed is True:
                    self.commits += 1
                elif committed is False:
                    self.aborts += 1
                    time.sleep(0.05)  # failed round: back off before retrying
                if (
                    self.kill_flag.is_set()
                    and self.diloco._stream_pending_frag is not None
                ):
                    # die MID-FRAGMENT: the streamed submit just happened;
                    # severing the comm NOW guarantees the peers' streamed
                    # chunk exchanges die half-fed (a graceful shutdown
                    # would let the loopback collective finish first)
                    killed_ts[0] = time.monotonic()
                    try:
                        self.comm.abort("stream drill kill")
                    except Exception:  # noqa: BLE001 — dying anyway
                        pass
                    self.manager.shutdown()
                    return

    replicas = [_Rep(i) for i in range(num_replicas)]
    victim = replicas[num_replicas - 1]
    threads = [threading.Thread(target=r.loop, daemon=True) for r in replicas]
    report: Dict[str, Any] = {}
    victim2: Optional[_Rep] = None
    victim2_thread: Optional[threading.Thread] = None
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120.0
        while (
            min(r.commits for r in replicas) < arm_at_step
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        assert min(r.commits for r in replicas) >= arm_at_step, (
            "fleet never reached the arming step"
        )
        survivors = [r for r in replicas if r is not victim]
        aborts_at_kill = [r.aborts for r in survivors]
        victim.kill_flag.set()
        deadline = time.monotonic() + 60.0
        while not killed_ts[0] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert killed_ts[0], "victim never died mid-fragment"

        # the half-streamed round must be DISCARDED on every survivor
        deadline = time.monotonic() + 120.0
        while (
            any(r.aborts <= a0 for r, a0 in zip(survivors, aborts_at_kill))
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        assert all(r.aborts > a0 for r, a0 in zip(survivors, aborts_at_kill)), (
            "survivors never discarded the half-streamed sync: "
            f"aborts {[r.aborts for r in survivors]} (at kill "
            f"{aborts_at_kill}), commits {[r.commits for r in survivors]}"
        )

        # replacement heals in and the fleet commits streamed syncs again
        victim2 = _Rep(victim.idx, life=1)
        victim2_thread = threading.Thread(target=victim2.loop, daemon=True)
        victim2_thread.start()
        deadline = time.monotonic() + 180.0
        fleet = survivors + [victim2]
        while (
            not (
                victim2.healed
                and victim2.commits >= 2
                and min(r.commits for r in fleet) >= steps
            )
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        assert victim2.healed, "replacement never healed"
        assert victim2.commits >= 2, (
            f"replacement never committed with the fleet ({victim2.commits})"
        )
        assert all(r.commits >= steps for r in fleet), (
            f"fleet stalled: {[r.commits for r in fleet]}"
        )
        # coordinated finish: every loop exits right after committing the
        # same outer round, so the committed state lines up exactly
        final_target[0] = max(r.manager.current_step() for r in fleet) + 2
        deadline = time.monotonic() + 120.0
        while (
            min(r.manager.current_step() for r in fleet) < final_target[0]
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        stop.set()
        for t in threads + [victim2_thread]:
            t.join(timeout=2 * timeout_s + 10.0)

        # ZERO divergence: the discarded sync left no trace — every
        # surviving replica (the healed replacement included) holds
        # bit-identical COMMITTED state (the per-fragment backups; live
        # leaves legitimately differ by in-flight local inner progress)
        for fi in range(2):
            ref = fleet[0].diloco.fragments[fi].backup
            for other in fleet[1:]:
                theirs = other.diloco.fragments[fi].backup
                for a, b in zip(ref, theirs):
                    assert torch.equal(a, b), (
                        f"committed state diverged on fragment {fi} "
                        f"({fleet[0].idx} vs {other.idx})"
                    )

        # flight evidence on the merged fleet timeline: every survivor's
        # own seq-ordered ring carries the fragment lifecycle — a
        # FRAG_SUBMIT → FRAG_ABORT pair for the killed round, and a later
        # FRAG_SUBMIT → FRAG_COMMIT once the replacement healed in
        for r in fleet:
            r.manager._flight.dump("drill_end")
        merged = flight_merge.merge_flight_dumps(
            sorted(glob.glob(os.path.join(tmp_ctx.name, "flight_*.jsonl")))
        )
        events = merged["events"]
        report["events_merged"] = len(events)
        report["replicas_merged"] = len(merged["replicas"])
        for r in survivors:
            own = [
                e
                for e in events
                if e.get("replica_id", "").startswith(f"stream_{r.idx}:")
            ]
            own.sort(key=lambda e: e.get("seq", 0))
            types = [e.get("ev") for e in own]
            assert int(FlightEvent.FRAG_SUBMIT) in types, (
                f"survivor {r.idx}: no FRAG_SUBMIT recorded"
            )
            abort_at = _first_index(types, int(FlightEvent.FRAG_ABORT))
            assert abort_at is not None, (
                f"survivor {r.idx}: half-streamed sync never recorded "
                "FRAG_ABORT"
            )
            submit_before = _first_index(
                types[:abort_at], int(FlightEvent.FRAG_SUBMIT)
            )
            assert submit_before is not None, (
                f"survivor {r.idx}: FRAG_ABORT without a prior FRAG_SUBMIT"
            )
            commit_after = _first_index(
                types[abort_at:], int(FlightEvent.FRAG_COMMIT)
            )
            assert commit_after is not None, (
                f"survivor {r.idx}: no streamed FRAG_COMMIT after the "
                "abort — the fleet never resumed streaming"
            )
        # per-fragment trace spans: every streamed round records a
        # stream::submit / stream::barrier pair tagged with its fragment
        # index (both fragments of the two-leaf model must appear)
        span_frags: Dict[str, set] = {
            "stream::submit": set(),
            "stream::barrier": set(),
        }
        for rec in obs_spans.snapshot():
            if rec["name"] in span_frags:
                frag = (rec.get("attrs") or {}).get("frag")
                if frag is not None:
                    span_frags[rec["name"]].add(frag)
        for name, frags in span_frags.items():
            assert frags >= {0, 1}, (
                f"{name} spans missing fragments: saw {sorted(frags)}, "
                "need both fragments of the streamed model"
            )
        report["stream_span_frags"] = {k: sorted(v) for k, v in span_frags.items()}
        report.update(
            commits=[r.commits for r in fleet],
            aborts=[r.aborts for r in survivors],
            bit_identical=True,
            healed=True,
        )
    finally:
        obs_spans.configure(None)
        obs_spans.clear()
        stop.set()
        victim.kill_flag.set()
        join_list = threads + ([victim2_thread] if victim2_thread is not None else [])
        for t in join_list:
            t.join(timeout=5.0)
        for r in replicas + ([victim2] if victim2 is not None else []):
            try:
                r.manager.shutdown()
            except Exception:  # noqa: BLE001
                pass
        lighthouse.shutdown()
        _restore_env(saved_env)
        tmp_ctx.cleanup()
    return report


def _first_index(seq: List[Any], value: Any) -> Optional[int]:
    try:
        return seq.index(value)
    except ValueError:
        return None


def joint_ft_spmd_drill(
    n_devices: int,
    num_replicas: int = 2,
    num_steps: int = 6,
    kill_replica: Optional[int] = 1,
    kill_at_step: int = 2,
    timeout_s: float = 60.0,
    quantize_outer: bool = False,
    heal_source_chaos: bool = False,
    device: str = "cuda",
) -> Dict[str, Any]:
    """FT across replica groups composed with HSDP inside each: the port of
    the JAX drill, on the port's own fleet (``train_hsdp.run_hsdp_fleet``).

    ``num_replicas`` replica groups of ``n_devices // num_replicas`` rank
    processes each (fsdp = 2 when that divides, the rest tp; FSDP2 and TP
    over gloo on the CPU, NCCL on the card) train ``llama_debug`` on the
    Python tier against a lighthouse that needs every group.  With
    ``kill_replica``, every rank of that group dies at the top of step
    ``kill_at_step`` and its restart heals its sharded state from the live
    groups.  ``quantize_outer`` runs the outer ring over the int8 wire.
    ``heal_source_chaos`` (a kill and >= 3 groups, so the rejoiner heals
    striped from 2+ sources) arms the next group's checkpoint transports
    to die after serving 16 KiB of that striped heal
    (:func:`~torchft_tpu_torch.chaos.arm_heal_source_kill`), over 64 KiB
    heal chunks; the heal must finish from the other source.

    Asserts that every group ends with bit-identical parameters, and for a
    kill that the victim restarted and healed.  Returns ``{"restarts": int,
    "healed": bool, "final_states": [{name: ndarray}, ...],
    "heal_source_killed": bool, "heal_timings": {...}}`` as the JAX drill
    does."""
    import shutil
    import tempfile

    from torchft_tpu_torch.models.llama import llama_debug
    from torchft_tpu_torch.train_hsdp import run_hsdp_fleet

    if heal_source_chaos and (kill_replica is None or num_replicas < 3):
        raise ValueError("heal_source_chaos needs a kill and >= 3 replicas (2+ sources)")
    per_replica = n_devices // num_replicas
    if per_replica < 1:
        raise ValueError(f"{n_devices} devices cannot hold {num_replicas} replica groups")
    fsdp = 2 if per_replica % 2 == 0 else 1
    tp = per_replica // fsdp
    chaos_source = (kill_replica + 1) % num_replicas if heal_source_chaos else None
    saved_env = {"TORCHFT_HEAL_CHUNK_MB": os.environ.get("TORCHFT_HEAL_CHUNK_MB")}
    if heal_source_chaos:
        # small chunks on every source, so the kill lands with most of the
        # transfer left to steal (the env's floor: 64 KiB)
        os.environ["TORCHFT_HEAL_CHUNK_MB"] = "0.0625"
    workdir = tempfile.mkdtemp(prefix="joint_ft_spmd_")
    try:
        groups = run_hsdp_fleet(
            llama_debug(), _resolve_device(device), groups=num_replicas, fsdp=fsdp, tp=tp,
            steps=num_steps, batch=2 * fsdp, seq=32, lr=1e-3,
            kill_at=None if kill_replica is None else (kill_replica, kill_at_step),
            quantize_outer=quantize_outer, tier="python", timeout=timeout_s,
            dump_params=True, workdir=workdir, chaos_source=chaos_source,
        )
        final_states = []
        for g in groups:
            rank0 = next(r for r in g if r["rank"] == 0)
            path = os.path.join(
                workdir, f"group{rank0['group']}_rank0_inc{rank0['incarnation']}.json.pt")
            saved = torch.load(path)
            final_states.append({n: t.float().numpy() for n, t in saved.items()})
    finally:
        _restore_env(saved_env)
        shutil.rmtree(workdir, ignore_errors=True)

    shas = {r["params_sha256"] for g in groups for r in g}
    assert len(shas) == 1, f"replica groups diverged: {shas}"
    restarts = sum(g[0]["incarnation"] for g in groups)
    healed = False
    heal_timings: Dict[str, float] = {}
    if kill_replica is not None:
        victim = groups[kill_replica]
        healed = victim[0]["incarnation"] >= 1 and all(
            r["heal"] and r["heal"]["bytes"] > 0 for r in victim)
        assert restarts >= 1, "kill was never injected"
        assert healed, "restarted replica group never completed a healed run"
        heal = victim[0]["heal"]
        heal_timings = dict(
            heal_num_sources=float(heal["sources"]),
            heal_bytes=float(heal["bytes"]),
            heal_bytes_per_sec=heal["bytes"] / heal["seconds"] if heal["seconds"] > 0 else 0.0,
            heal_stolen_chunks=float(heal["stolen_chunks"]),
        )
    killed_source = chaos_source is not None and any(
        r["heal_source_killed"] for r in groups[chaos_source])
    if heal_source_chaos:
        assert killed_source, "heal-source kill never fired"
    return {
        "restarts": restarts,
        "healed": healed,
        "final_states": final_states,
        "heal_source_killed": killed_source,
        "heal_timings": heal_timings,
    }


def postmortem_drill(
    num_replicas: int = 3,
    steps: int = 10,
    arm_at_step: int = 3,
    # modest per-op timeout: after the kill, one survivor's collective can
    # stall on a live-but-silent lane until the op watchdog fires, so this
    # bounds the poison→shrink leg of the drill's wall clock
    timeout_s: float = 6.0,
    tier: str = "python",
    payload_elems: int = 200_000,
    fault_spec: str = "loss:0.02,reset:0.01",
    lanes: int = 2,
    out_dir: Optional[str] = None,
    device: str = "cuda",
) -> Dict[str, Any]:
    """Chaos postmortem drill: the flight-recorder acceptance gate (the
    port of the JAX drill; each replica's parameters are a tensor on
    ``device``).

    A real fleet (lighthouse + one Manager per replica, threads in one
    process) commits steps while the drill injects a gray failure and a
    kill, then the SURVIVORS' flight dumps (plus the victim's shutdown
    dump, the restarted victim's heal dump, and the lighthouse's
    coordination dump) are merged by ``scripts/flight_merge.py`` and the
    causal chain is asserted IN ORDER on the aligned fleet timeline:

    ``python`` tier: ``CHAOS_INJECT`` (NET_FLAKY armed fleet-wide) → lane
    distress (``LANE_RECONNECT`` events, or injected-fault/stall counters
    riding the poison event) → ``COMM_POISON`` on a survivor (the kill
    severs the victim's sockets mid-collective) → ``QUORUM_ADOPT`` of the
    shrunk quorum, correlated by identical ``(quorum_id, step)`` across
    survivors → heal phases (``HEAL_RECV_END`` on the restarted victim,
    ``HEAL_SEND_BEGIN`` on a survivor).

    ``cpp`` tier: the native data plane has no fault injection, so the
    chain starts at the kill — ``CHAOS_INJECT(kill)`` → poison → shrink →
    heal — and additionally asserts the merged dump contains NATIVE ring
    events (``COMM_CONFIGURE`` drained over ``tpuft_comm_flight_drain``).

    Returns the chain timestamps and merge facts (asserts internally)."""
    import glob
    import tempfile

    from torchft_tpu_torch.chaos import ChaosController, Failure, ThreadReplica
    from torchft_tpu_torch.lighthouse import LighthouseServer
    from torchft_tpu_torch.manager import Manager

    flight_merge = _load_flight_merge()
    dev = _resolve_device(device)
    assert tier in ("python", "cpp"), tier
    assert num_replicas >= 3, "postmortem drills need a surviving majority"
    if tier == "cpp":
        from torchft_tpu_torch import native

        if not native.available():
            raise RuntimeError("native tier unavailable")

        def make_comm():
            return native.CppCommunicator(timeout_s=timeout_s)
    else:
        from torchft_tpu_torch.communicator import TCPCommunicator

        def make_comm():
            return TCPCommunicator(timeout_s=timeout_s)

    tmp_ctx = None
    if out_dir is None:
        tmp_ctx = tempfile.TemporaryDirectory(prefix="tpuft_flight_")
        out_dir = tmp_ctx.name
    saved_env = {
        k: os.environ.get(k)
        for k in ("TORCHFT_FLIGHT_DIR", "TORCHFT_RING_LANES", "TORCHFT_NET_FAULT_SEED")
    }
    os.environ["TORCHFT_FLIGHT_DIR"] = out_dir
    os.environ["TORCHFT_NET_FAULT_SEED"] = "11"
    if tier == "python":
        os.environ["TORCHFT_RING_LANES"] = str(lanes)

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=num_replicas - 1,
        join_timeout_ms=300,
        quorum_tick_ms=20,
        heartbeat_timeout_ms=1500,
    )
    rng = np.random.default_rng(5)
    grad = torch.from_numpy(rng.normal(size=payload_elems).astype(np.float32)).to(dev)
    stop = threading.Event()

    class _Rep:
        def __init__(self, idx: int, life: int = 0) -> None:
            self.idx = idx
            self.life = life
            self.params = torch.zeros(payload_elems, dtype=torch.float32, device=dev)
            self.comm = make_comm()
            self.manager = Manager(
                comm=self.comm,
                load_state_dict=self._load,
                state_dict=self._save,
                min_replica_size=num_replicas - 1,
                replica_id=f"pm_{idx}" + ("r" * life),
                lighthouse_addr=lighthouse.local_address(),
                timeout=timeout_s,
                quorum_timeout=timeout_s,
                connect_timeout=timeout_s,
                init_sync=False,
            )
            self.commits = 0
            self.kill_flag = threading.Event()
            self.healed = False

        def _save(self) -> Dict[str, Any]:
            return {"params": self.params.clone()}

        def _load(self, sd: Dict[str, Any]) -> None:
            self.params = sd["params"].to(dev, torch.float32).clone()
            self.healed = True

        def loop(self) -> None:
            # no per-replica step bound: the MAIN thread ends the drill via
            # ``stop`` once the rejoined victim has healed and committed —
            # a fixed bound would let fast survivors exit (and stop
            # issuing the quorum RPCs the rejoiner's heal needs) before
            # the rejoin lands
            while not stop.is_set():
                try:
                    self.manager.start_quorum()
                    if self.kill_flag.is_set():
                        # die AFTER joining the round's quorum: the peers'
                        # collective is then in flight against this
                        # replica's sockets, so severing them poisons the
                        # survivors' epoch — the postmortem's poison link.
                        # The shutdown dump preserves this incarnation's
                        # ring.
                        try:
                            self.manager.wait_quorum()
                        except Exception:  # noqa: BLE001 — dying anyway
                            pass
                        self.manager.shutdown()
                        return
                    work = self.manager.allreduce(_host(grad))
                    avg = work.wait(timeout=timeout_s)
                    ok = self.manager.should_commit()
                except Exception:  # noqa: BLE001 — a failed step, not a crash
                    ok = False
                if ok and not stop.is_set():
                    self.params += _on(avg, dev)
                    self.commits += 1

    replicas = [_Rep(i) for i in range(num_replicas)]
    victim = replicas[num_replicas - 1]
    chaos = ChaosController([ThreadReplica(f"pm_{r.idx}", r) for r in replicas])
    threads = [threading.Thread(target=r.loop, daemon=True) for r in replicas]
    report: Dict[str, Any] = {"tier": tier, "flight_dir": out_dir}
    victim2: Optional[_Rep] = None
    victim2_thread: Optional[threading.Thread] = None
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120.0
        while min(r.commits for r in replicas) < arm_at_step and time.monotonic() < deadline:
            time.sleep(0.05)
        assert min(r.commits for r in replicas) >= arm_at_step, (
            "fleet never reached the arming step"
        )

        if tier == "python":
            # phase 1: flaky links fleet-wide; recovery stays in-epoch but
            # leaves fault/stall/reconnect evidence in every recorder
            for handle in chaos.replicas:
                chaos.inject(Failure.NET_FLAKY, victim=handle, spec=fault_spec)
            flaky_target = min(steps, arm_at_step + 2)
            deadline = time.monotonic() + 120.0
            while (
                min(r.commits for r in replicas) < flaky_target
                and time.monotonic() < deadline
            ):
                time.sleep(0.05)
            assert min(r.commits for r in replicas) >= flaky_target, (
                "fleet stalled under the flaky link"
            )

        # phase 2: kill the victim mid-run — survivors poison, the quorum
        # shrinks, and the restarted incarnation must heal back in
        survivors = [r for r in replicas if r is not victim]
        commits_at_kill = min(r.commits for r in survivors)
        chaos.inject(Failure.KILL, victim=chaos.replicas[victim.idx])
        deadline = time.monotonic() + 180.0
        while (
            min(r.commits for r in survivors) < commits_at_kill + 2
            and time.monotonic() < deadline
        ):
            time.sleep(0.05)
        assert min(r.commits for r in survivors) >= commits_at_kill + 2, (
            "survivors never resumed after the kill"
        )

        # phase 3: the victim's replacement rejoins behind the fleet and
        # heals (HEAL_RECV on it, HEAL_SEND on a survivor)
        victim2 = _Rep(victim.idx, life=1)
        victim2_thread = threading.Thread(target=victim2.loop, daemon=True)
        victim2_thread.start()
        deadline = time.monotonic() + 180.0
        fleet = survivors + [victim2]
        # the drill is over once the rejoiner has HEALED and committed at
        # least twice with the fleet (and everyone has cleared the step
        # target) — the main thread is the only exit path
        while (
            not (
                victim2.healed
                and victim2.commits >= 2
                and min(r.manager.current_step() for r in fleet) >= steps
            )
            and time.monotonic() < deadline
        ):
            time.sleep(0.05)
        stop.set()
        for t in threads + [victim2_thread]:
            t.join(timeout=2 * timeout_s + 10.0)
        assert victim2.healed, "restarted victim never healed"
        assert victim2.commits >= 2, (
            f"restarted victim never committed with the fleet ({victim2.commits} commits)"
        )
        assert all(r.manager.current_step() >= steps for r in fleet), (
            f"fleet stalled: {[r.manager.current_step() for r in fleet]}"
        )

        # final dumps: every live recorder's complete ring + the
        # lighthouse's coordination feed (QUORUM_ISSUE anchors)
        for r in fleet:
            r.manager._flight.dump("drill_end")
        lighthouse._flight.dump("drill_end")

        merged = flight_merge.merge_flight_dumps(
            sorted(glob.glob(os.path.join(out_dir, "flight_*.jsonl")))
        )
        events = merged["events"]
        report["replicas_merged"] = len(merged["replicas"])
        report["events_merged"] = len(events)
        report["anchors"] = merged["anchors"]
        assert len(merged["replicas"]) >= num_replicas + 1, merged["replicas"]
        assert merged["anchors"] > 0, "no shared (quorum_id, step) anchors"

        survivor_prefixes = [f"pm_{r.idx}" for r in survivors]

        def _events_of(prefix: str) -> List[Dict[str, Any]]:
            # one replica's events in ITS OWN recording order (seq is
            # strictly monotonic per recorder incarnation).  Replica ids
            # are "{prefix}:{uuid}/{rank}", so match on the ":" boundary
            own = [e for e in events if e.get("replica_id", "").startswith(prefix + ":")]
            own.sort(key=lambda e: e.get("seq", 0))
            return own

        # -- the causal chain: existence and (quorum_id, step) correlation
        # from the merged timeline, ORDER per replica on its own ring
        injects = [e for e in events if e["name"] == "CHAOS_INJECT"]
        assert injects, "no CHAOS_INJECT recorded"
        report["t_inject"] = min(e["t_aligned"] for e in injects)

        if tier == "python":
            distress = [
                e
                for e in events
                if e["name"] in ("LANE_RECONNECT", "LANE_FAILOVER")
                or (
                    e["name"] == "COMM_POISON"
                    and (e.get("faults_injected", 0) or e.get("stalls", 0))
                )
            ]
            assert distress, (
                "no lane-distress evidence (reconnects / injected faults / "
                "stalls) after the injection"
            )
            report["t_distress"] = min(e["t_aligned"] for e in distress)

        # every survivor adopted a shrunk quorum, and they all adopted the
        # SAME (quorum_id, step)
        shrink_by_survivor: Dict[str, List[Dict[str, Any]]] = {}
        for prefix in survivor_prefixes:
            shrinks = [
                e
                for e in _events_of(prefix)
                if e["name"] == "QUORUM_ADOPT" and e.get("world") == num_replicas - 1
            ]
            assert shrinks, f"{prefix} never adopted the shrunk quorum"
            shrink_by_survivor[prefix] = shrinks
        shared_keys = set.intersection(
            *(
                {(e["quorum_id"], e["step"]) for e in shrinks}
                for shrinks in shrink_by_survivor.values()
            )
        )
        assert shared_keys, (
            "shrunk-quorum adoption not correlated across survivors: "
            f"{ {p: [(e['quorum_id'], e['step']) for e in s] for p, s in shrink_by_survivor.items()} }"
        )
        report["shrink_key"] = sorted(shared_keys)[0]

        def _shrink_index(own: List[Dict[str, Any]]) -> Optional[int]:
            return next(
                (
                    i
                    for i, e in enumerate(own)
                    if e["name"] == "QUORUM_ADOPT" and (e["quorum_id"], e["step"]) in shared_keys
                ),
                None,
            )

        # at least one survivor's OWN ring shows poison strictly before its
        # shrunk-quorum adoption
        ordered_chain = []
        t_poisons = []
        for prefix in survivor_prefixes:
            own = _events_of(prefix)
            names = [e["name"] for e in own]
            poisons = [e for e in own if e["name"] == "COMM_POISON"]
            t_poisons += [e["t_aligned"] for e in poisons]
            if not poisons:
                continue
            shrink_idx = _shrink_index(own)
            if shrink_idx is not None and names.index("COMM_POISON") < shrink_idx:
                ordered_chain.append(prefix)
        assert t_poisons, "no survivor COMM_POISON after the kill"
        assert ordered_chain, "no survivor's own ring shows poison -> shrunk-quorum adoption"
        report["t_poison"] = min(t_poisons)
        report["t_shrink"] = min(
            e["t_aligned"] for shrinks in shrink_by_survivor.values() for e in shrinks
        )

        # heal: the restarted victim fetched, and a survivor served AFTER
        # its shrunk-quorum adoption (its own ring's order)
        recv_ends = [e for e in _events_of(f"pm_{victim.idx}r") if e["name"] == "HEAL_RECV_END"]
        assert recv_ends, "restarted victim recorded no HEAL_RECV_END"
        report["t_heal"] = recv_ends[0]["t_aligned"]
        served = False
        for prefix in survivor_prefixes:
            own = _events_of(prefix)
            shrink_idx = _shrink_index(own)
            if shrink_idx is not None and any(
                e["name"] == "HEAL_SEND_BEGIN" for e in own[shrink_idx + 1 :]
            ):
                served = True
                break
        assert served, "no survivor recorded HEAL_SEND_BEGIN after the shrunk quorum"

        if tier == "cpp":
            native_events = [
                e for e in events if e.get("native") and e["name"] == "COMM_CONFIGURE"
            ]
            assert native_events, "no native C-ring events merged into the dumps"
            report["native_events"] = len(native_events)
        report["chain_ok"] = True
    finally:
        stop.set()
        for t in threads + ([victim2_thread] if victim2_thread is not None else []):
            t.join(timeout=5.0)
        for r in replicas + ([victim2] if victim2 is not None else []):
            try:
                r.manager.shutdown()
            except Exception:  # noqa: BLE001
                pass
        lighthouse.shutdown()
        _restore_env(saved_env)
        if tmp_ctx is not None:
            tmp_ctx.cleanup()
    return report


def coord_churn_drill(
    num_replicas: int = 60,
    num_aggregators: int = 2,
    num_spares: int = 2,
    kills: int = 1,
    rejoins: int = 1,
    deadline_s: float = 120.0,
) -> Dict[str, Any]:
    """Coordination-plane churn drill: a thin assertion wrapper over the
    :mod:`torchft_tpu_torch.coord.scale` harness at drill-friendly scale
    (host only: the coordination plane holds no tensors).

    Drives a subprocess lighthouse + zone aggregators + a simulated fleet
    (with a spare pool and a mixed direct/aggregated membership) through
    kill/rejoin/promote churn AND an aggregator crash/restart, asserting:

    - zero spurious membership edits (observed ``quorum_id`` bumps equal
      the churn plan's kills + rejoins — an aggregator bounce contributes
      none: aggregator death is a reporting gap, not a member death);
    - every kill with a warm spare registered lands as a promotion;
    - the aggregated steady state reaches the lighthouse with fewer beat
      RPCs than the all-direct calibration window.
    """
    from torchft_tpu_torch.coord.scale import run_scale_harness

    report = run_scale_harness(
        num_replicas=num_replicas,
        num_aggregators=num_aggregators,
        num_spares=num_spares,
        kills=kills,
        rejoins=rejoins,
        agg_bounce=True,
        deadline_s=deadline_s,
    )
    assert report["spurious_membership_edits"] == 0, report
    assert report["agg_bounce_edits"] == 0, report
    assert report["promotions_total"] >= min(kills, num_spares), report
    reduction = report.get("rpc_reduction_vs_direct")
    assert reduction is not None and reduction > 1.0, report
    return report
