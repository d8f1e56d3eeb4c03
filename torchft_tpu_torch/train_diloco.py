"""Fault-tolerant LocalSGD and Streaming DiLoCo training of Llama-3.

The twin of ``examples/train_diloco.py``, ``examples/train_localsgd.py``
and ``bench.py``'s DiLoCo worker: each replica group trains on its own with
an inner AdamW step (forward and backward on the flash kernels) and, every
``--sync-every`` inner steps, synchronizes with the others — DiLoCo through
averaged pseudogradients and an outer Nesterov SGD, fragment by fragment,
with the ZeRO-1 sharded outer sync (``TORCHFT_OUTER_SHARD``, on unless set
to 0); LocalSGD by averaging the parameters.  A restarted replica heals from
a peer's live weights, the fragments' backups and outer state included.
The planes run on the tier ``tier.py`` resolves.  One process per replica
group::

    python -m torchft_tpu_torch.lighthouse --min_replicas 2 --bind 0.0.0.0:29520 &
    TORCHFT_LIGHTHOUSE=localhost:29520 REPLICA_GROUP_ID=0 \\
        python -m torchft_tpu_torch.train_diloco --layers 2 &
    TORCHFT_LIGHTHOUSE=localhost:29520 REPLICA_GROUP_ID=1 \\
        python -m torchft_tpu_torch.train_diloco --layers 2 &

``--algo localsgd`` runs LocalSGD; with ``--ckpt-dir DIR`` it restores the
newest durable checkpoint in ``DIR`` at start (model, AdamW moments and the
Manager's step) and, after each committed sync, the participating rank 0
writes one (:mod:`.utils.checkpoint`), so the job survives the loss of every
replica.  ``--heal-transport comm`` heals over
the replica's communicator (``CommTransport``) instead of HTTP.
``--device`` defaults to ``cuda``; pass ``--device cpu`` (with ``--model
llama_debug``) to run without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.llama import Llama, LlamaConfig
from torchft_tpu_torch.obs.spans import device_fence
from torchft_tpu_torch.observability import HealMetrics
from torchft_tpu_torch.optim import OuterSGD
from torchft_tpu_torch.tier import default_tier, make_communicator, make_lighthouse, manager_server_cls
from torchft_tpu_torch.train_ddp import (
    HEAL_TRANSPORTS,
    LLAMA_MODELS,
    Batch,
    InjectedKill,
    build,
    heal_transport_for,
    model_config,
    params_sha256,
    resolve_device,
    state_fns,
    synthetic_batches,
)
from torchft_tpu_torch.utils.checkpoint import (
    ChunkDigest,
    load_latest,
    save_checkpoint,
    state_digest,
)

logger = logging.getLogger("train_diloco")

ALGOS = ("diloco", "localsgd")
# the outer optimizer of bench.py's phase D and examples/train_diloco.py
OUTER_LR, OUTER_MOMENTUM = 0.7, 0.9
# the lighthouse's promotion switch (read per quorum computation), held off
# until a spare stands warm at the commit front
SPARE_PROMOTE_ENV = "TORCHFT_SPARE_PROMOTE"
# seconds between a holding survivor's warm staging attempts: a staging of
# the 8B-width state takes seconds, and one that failed is retried
STAGE_RETRY_S = 10.0
# a run stops after this many inner steps per committed sync it asked for,
# even if the syncs did not commit (bench.py's cap)
INNER_STEP_CAP = 5


class DurableCheckpointError(ValueError):
    """Durable checkpoints asked of DiLoCo: they carry the model, the inner
    optimizer and the Manager's step, not DiLoCo's fragment backups and
    outer momenta, so a restored DiLoCo job would run on with wrong outer
    state.  LocalSGD's whole state is in them."""


def check_ckpt_algo(algo: str, ckpt_dir: Optional[str]) -> None:
    """Raise :class:`DurableCheckpointError` for a ``ckpt_dir`` under any
    algorithm but LocalSGD."""
    if ckpt_dir is not None and algo != "localsgd":
        raise DurableCheckpointError(
            f"durable checkpoints (ckpt_dir={ckpt_dir!r}) need algo='localsgd', not "
            f"{algo!r}: DiLoCo's fragment backups and outer momenta are not in them"
        )


def restore_durable(ckpt_dir: str, load, manager: Manager) -> Optional[Dict[str, Any]]:
    """Restore the newest readable checkpoint in ``ckpt_dir`` (the model and
    optimizer through ``load``, then the Manager's step); returns its step
    and the seconds to read it (``read_s``) and to copy it into the live
    tensors (``apply_s``), or None when there is none."""
    t0 = time.perf_counter()
    found = load_latest(ckpt_dir)
    if found is None:
        return None
    step, state = found
    t1 = time.perf_counter()
    load(state)
    manager.load_state_dict(state["torchft"])
    apply_s = time.perf_counter() - t1
    logger.info("restored durable checkpoint at step %d", step)
    return dict(step=step, read_s=t1 - t0, apply_s=apply_s)


def save_durable(ckpt_dir: str, save, manager: Manager, digest: Any = None) -> Dict[str, Any]:
    """Write the model, the optimizer and the Manager's state as the
    checkpoint of the committed step; returns its step, bytes and seconds
    (``save_s`` in all, split as :func:`~.utils.checkpoint.save_checkpoint`
    splits them)."""
    step = manager.current_step()
    timings: Dict[str, Any] = {}
    t0 = time.perf_counter()
    save_checkpoint(ckpt_dir, step, {**save(), "torchft": manager.state_dict()},
                    timings=timings, digest=digest)
    timings.update(step=step, save_s=time.perf_counter() - t0)
    logger.info("saved durable checkpoint of step %d (%d bytes, %.1f s)",
                step, timings["bytes"], timings["save_s"])
    return timings


def make_wrapper(
    algo: str,
    manager: Manager,
    model: Llama,
    sync_every: int,
    num_fragments: int = 1,
    fragment_sync_delay: int = 0,
    fragment_update_alpha: float = 0.0,
    should_quantize: bool = False,
):
    """``DiLoCo`` with the outer Nesterov SGD, or ``LocalSGD``."""
    if algo == "localsgd":
        return LocalSGD(manager, model, sync_every)
    if algo != "diloco":
        raise ValueError(f"algo must be one of {ALGOS}, got {algo!r}")
    return DiLoCo(
        manager,
        model,
        OuterSGD(OUTER_LR, momentum=OUTER_MOMENTUM, nesterov=True),
        sync_every=sync_every,
        num_fragments=num_fragments,
        fragment_sync_delay=fragment_sync_delay,
        fragment_update_alpha=fragment_update_alpha,
        should_quantize=should_quantize,
    )


def inner_steps_per_sync(algo: str, sync_every: int, num_fragments: int) -> int:
    """Inner steps between two committed syncs: DiLoCo syncs one fragment
    every ``sync_every / num_fragments`` steps."""
    return sync_every // num_fragments if algo == "diloco" else sync_every


def inner_step(
    model: Llama, inner: torch.optim.Optimizer, batch: Batch, guard=None
) -> torch.Tensor:
    """One inner AdamW step on ``batch`` (inside ``guard``, DiLoCo's
    ``pre_step``); returns the loss."""
    with guard if guard is not None else contextlib.nullcontext():
        inner.zero_grad(set_to_none=True)
        loss = model.loss(*batch)
        loss.backward()
        inner.step()
    return loss.detach()


@dataclasses.dataclass
class DiLoCoReplicaResult:
    # the inner losses of the last incarnation
    losses: List[float]
    # the manager's committed step (committed outer syncs)
    final_step: int
    # sha256 of each fragment's backup (DiLoCo), and of its live parameters
    fragment_sha256: List[str]
    fragment_live_sha256: List[str]
    # sha256 of each fragment's parameters at initialization (the seed's)
    initial_fragment_sha256: List[str]
    params_sha256: str
    restarts: int
    # the last incarnation's heal, if it healed (bytes and seconds), and how
    # many healing checkpoints each fragment's state was loaded from
    heal: Optional[HealMetrics]
    fragment_heals: List[int]
    # wall seconds of each inner step of the last incarnation, fenced with a
    # device synchronize (the sync's own work is not in them)
    inner_step_s: List[float]
    # wall seconds of each ``wrapper.step()`` of the last incarnation, fenced
    # like the inner steps: the sync work that holds the train loop (the
    # quorum, the pseudogradient, the wait for the outer sync, the apply)
    wrapper_step_s: List[float]
    # ``last_quorum_timings``' ``outer_shard_*`` at each commit decision
    outer_shard: List[Dict[str, float]]
    # inner steps the last incarnation ran
    inner_steps: int
    # class names of the planes: "lighthouse", "manager_server", "communicator"
    planes: Dict[str, str]
    # the quorum id at each commit decision of the last incarnation: a
    # change between two decisions is one membership edit
    quorum_ids: List[int] = dataclasses.field(default_factory=list)
    # True for a replica killed with a spare registered: it stays dead
    killed: bool = False
    # a spare's record (None for an active): its ``SpareAgent.metrics``,
    # whether it was promoted, the highest fresh fraction its chunk store
    # reached, and, once promoted, the seconds from the kill to the
    # adopted promotion quorum and to its first committed sync, the
    # lighthouse's ``promotions_total`` and the flash kernels' launch
    # counts at the promotion
    spare: Optional[Dict[str, Any]] = None
    # with ``ckpt_dir``: the last incarnation's restore (``restore_durable``'s
    # record, ``digest``, the content hash of its model and optimizer state
    # just after it, and ``manager_step``, the Manager's step then; None
    # when it found no checkpoint) and its saves (``save_durable``'s
    # records, each with the ``digest`` of what it wrote)
    restored: Optional[Dict[str, Any]] = None
    saves: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # ``time.monotonic()`` of the last incarnation's first committed sync
    first_commit_ts: Optional[float] = None
    # each commit decision of the last incarnation: (the Manager's step just
    # before it, committed); a decision that did not commit leaves the step
    sync_decisions: List[Tuple[int, bool]] = dataclasses.field(default_factory=list)
    # streamed syncs each fragment of the last incarnation resolved at its
    # bounded-staleness barrier (TORCHFT_STREAM_SYNC; 0 on the blocking path)
    stream_barriers: List[int] = dataclasses.field(default_factory=list)
    # per incarnation, whether its wrapper streamed the outer sync
    streaming: List[bool] = dataclasses.field(default_factory=list)
    # each injected kill of this replica: its inner step, the Manager's step
    # then, and the fragments whose sync was submitted and not yet resolved
    kills: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Run:
    """What one incarnation's train loop recorded so far."""

    losses: List[float] = dataclasses.field(default_factory=list)
    inner_s: List[float] = dataclasses.field(default_factory=list)
    wrapper_s: List[float] = dataclasses.field(default_factory=list)
    outer_shard: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    quorum_ids: List[int] = dataclasses.field(default_factory=list)
    decisions: List[Tuple[int, bool]] = dataclasses.field(default_factory=list)
    steps: int = 0
    first_commit_ts: Optional[float] = None
    restored: Optional[Dict[str, Any]] = None
    saves: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


def run_diloco_fleet(
    cfg: LlamaConfig,
    device: torch.device,
    *,
    algo: str = "diloco",
    replicas: int = 2,
    sync_every: int = 8,
    num_fragments: int = 2,
    fragment_sync_delay: int = 2,
    fragment_update_alpha: float = 0.0,
    outer_steps: int = 4,
    should_quantize: bool = False,
    kill_at: Optional[Tuple[int, int]] = None,
    tier: Optional[str] = None,
    batch: int = 1,
    seq: int = 2048,
    seed: int = 0,
    lr: float = 1e-4,
    timeout: float = 300.0,
    init_state: Optional[dict] = None,
    heal_transport: str = "http",
    spares: int = 0,
    ckpt_dir: Optional[str] = None,
) -> List[DiLoCoReplicaResult]:
    """Train ``replicas`` replica groups as threads of this process with
    DiLoCo (``algo="diloco"``) or LocalSGD (``"localsgd"``), each with its
    own Manager (``use_async_quorum=False``), manager sidecar, communicator
    and checkpoint transport (``heal_transport``: "http" or "comm"), against an in-process lighthouse that needs every
    replica for a quorum; ``tier`` names the tier of all three planes (None:
    as :mod:`.tier` resolves it).  The inner step is AdamW (inside DiLoCo's
    ``pre_step``); the run ends when the committed step reaches
    ``outer_steps``, or after :data:`INNER_STEP_CAP` times the inner steps
    that needs.  ``kill_at=(replica, inner_step)`` kills that replica once
    before that inner step; it restarts with a fresh model and heals from a
    live peer at its next quorum.  The replicas start from one seed, so no
    step-0 sync runs (``init_sync=False``); ``init_state`` replaces the
    seeded init.

    ``spares`` (DiLoCo on the Python tier; the C++ sidecar refuses the
    role) adds that many hot spares: each a ``Manager(role="spare")``
    driving ``SpareAgent(manager, delta_apply=diloco_delta_apply(diloco))``
    until it is promoted, then the same train loop, from mid-``start_quorum``
    of its first active step.  The actives wait for the spares' first
    registration before their first step.  With ``kill_at`` the killed
    replica stays dead and the lighthouse promotes a spare in its place:
    at the kill's inner step every active holds, the survivors stage a warm
    snapshot of the commit front, and promotion stays off
    (``TORCHFT_SPARE_PROMOTE=0``) until a spare has loaded a complete
    snapshot (its chunk store's fresh fraction reached 1.0) and stands at
    that front.  The results list the actives, then the spares.

    ``ckpt_dir`` (LocalSGD only: :class:`DurableCheckpointError` otherwise)
    gives the job durable checkpoints, as ``--ckpt-dir`` does: each
    incarnation restores the newest one before it trains, and after each
    committed sync the participating rank 0 writes one.  Two calls with one
    ``ckpt_dir`` are a job loss and its restore.  Each result records the
    restore and the saves with the content hash of the model and optimizer
    state (``utils.checkpoint.state_digest``): at a save, of the bytes
    written; at a restore, of the live state just after it."""
    check_ckpt_algo(algo, ckpt_dir)
    if spares and (algo != "diloco" or (tier or default_tier()) != "python"):
        raise ValueError(
            "spares need algo='diloco' on the Python tier (the C++ manager "
            "sidecar refuses the spare role)"
        )
    per_sync = inner_steps_per_sync(algo, sync_every, num_fragments)
    cap = INNER_STEP_CAP * outer_steps * per_sync
    lighthouse = make_lighthouse(
        bind="127.0.0.1:0",
        min_replicas=replicas,
        join_timeout_ms=100,
        quorum_tick_ms=20,
        heartbeat_timeout_ms=5_000,
        tier=tier,
    )
    server_cls = manager_server_cls(tier)
    kill_lock = threading.Lock()
    pending_kill = [kill_at]
    # hot spares: registered once every spare has parked on the lighthouse;
    # front is the commit front the actives hold at (the kill's inner
    # step); armed once a spare stands warm at it (promotion allowed)
    registered = [threading.Event() for _ in range(spares)]
    front: List[Optional[int]] = [None]
    armed = threading.Event()
    actives_done = threading.Event()
    kill_ts: List[Optional[float]] = [None]
    saved_promote = os.environ.get(SPARE_PROMOTE_ENV)
    if spares:
        os.environ[SPARE_PROMOTE_ENV] = "0"

    def _make(idx: int, role: str):
        model, inner = build(cfg, device, seed, lr)
        if init_state is not None:
            model.load_state_dict(init_state)
        save, load = state_fns(model, inner)
        comm = make_communicator(timeout_s=timeout, tier=tier)
        manager = Manager(
            comm=comm,
            checkpoint_transport=heal_transport_for(heal_transport, comm),
            load_state_dict=load,
            state_dict=save,
            min_replica_size=replicas,
            use_async_quorum=False,
            replica_id=f"replica_{idx}",
            lighthouse_addr=lighthouse.local_address(),
            timeout=timeout,
            quorum_timeout=timeout,
            connect_timeout=timeout,
            init_sync=False,
            server_cls=server_cls,
            role=role,
        )
        wrapper = make_wrapper(
            algo, manager, model, sync_every, num_fragments, fragment_sync_delay,
            fragment_update_alpha, should_quantize,
        )
        return model, inner, manager, wrapper, save, load

    def _restore(manager, save, load, run: _Run) -> None:
        if ckpt_dir is None:
            return
        run.restored = restore_durable(ckpt_dir, load, manager)
        if run.restored is not None:
            t0 = time.perf_counter()  # the check's own seconds, apart from the restore's
            digest = state_digest(save())
            run.restored.update(digest=digest, digest_s=time.perf_counter() - t0,
                                manager_step=manager.current_step())

    def _save(manager, save, run: _Run) -> None:
        with ChunkDigest() as digest:
            run.saves.append(dict(save_durable(ckpt_dir, save, manager, digest),
                                  digest=digest.hexdigest()))

    def _train(idx, model, inner, manager, wrapper, run: _Run, before_step=None,
               save=None) -> None:
        batches = synthetic_batches(cfg, batch, seq, idx, 4, device)
        fence = device_fence(device)
        guard = wrapper.pre_step if algo == "diloco" else None
        with wrapper:
            while manager.current_step() < outer_steps and run.steps < cap:
                if before_step is not None:
                    before_step(run.steps)
                t0 = fence()
                loss = inner_step(model, inner, batches[run.steps % len(batches)],
                                  guard() if guard else None)
                t1 = fence()
                run.inner_s.append(t1 - t0)
                run.losses.append(float(loss))
                run.steps += 1
                step_before = manager.current_step()
                committed = wrapper.step()
                run.wrapper_s.append(fence() - t1)
                if committed is not None:
                    run.decisions.append((step_before, bool(committed)))
                    run.outer_shard.append({
                        k: v for k, v in manager.last_quorum_timings.items()
                        if k.startswith("outer_shard_")
                    })
                    run.quorum_ids.append(manager._quorum_id)
                    if committed and run.first_commit_ts is None:
                        run.first_commit_ts = time.monotonic()
                    logger.info(
                        "replica %d inner step %d: sync committed=%s step=%d loss %.4f",
                        idx, run.steps, committed, manager.current_step(), run.losses[-1],
                    )
                    # one writer per checkpoint dir: the participating rank 0
                    if ckpt_dir and committed and manager.participating_rank() == 0:
                        _save(manager, save, run)

    def _result(model, manager, wrapper, run: _Run, restarts: int, initial, **extra):
        frags = getattr(wrapper, "fragments", [])
        return DiLoCoReplicaResult(
            losses=run.losses,
            final_step=manager.current_step(),
            fragment_sha256=[f.backup_sha256() for f in frags],
            fragment_live_sha256=[f.live_sha256() for f in frags],
            initial_fragment_sha256=initial,
            params_sha256=params_sha256(model),
            restarts=restarts,
            heal=getattr(manager._checkpoint_transport, "last_heal_metrics", None),
            fragment_heals=[f.heals for f in frags],
            inner_step_s=run.inner_s,
            wrapper_step_s=run.wrapper_s,
            outer_shard=run.outer_shard,
            inner_steps=run.steps,
            planes={
                "lighthouse": type(lighthouse).__name__,
                "manager_server": type(manager._manager_server).__name__,
                "communicator": type(manager._comm).__name__,
            },
            quorum_ids=run.quorum_ids,
            restored=run.restored,
            saves=run.saves,
            first_commit_ts=run.first_commit_ts,
            sync_decisions=run.decisions,
            stream_barriers=[f.stream_barriers for f in frags],
            **extra,
        )

    def _replica(idx: int) -> DiLoCoReplicaResult:
        for event in registered:
            if not event.wait(timeout):
                raise TimeoutError("a spare never registered with the lighthouse")
        restarts = 0
        streaming: List[bool] = []
        kills: List[Dict[str, Any]] = []
        while True:
            model, inner, manager, wrapper, save, load = _make(idx, "active")
            streaming.append(wrapper._stream_stall > 0)
            initial = [f.backup_sha256() for f in getattr(wrapper, "fragments", [])]
            run = _Run()
            _restore(manager, save, load, run)

            def before_step(steps: int) -> None:
                if spares and kill_at is not None and steps == kill_at[1] and not armed.is_set():
                    # hold at the commit front until a spare stands warm at
                    # it; the survivors stage the snapshot it loads
                    front[0] = manager.current_step()
                    deadline = time.monotonic() + timeout
                    while True:
                        if idx != kill_at[0]:
                            # no-op once the front is staged; a retry only
                            # after a staging failed (it never blocks)
                            manager._maybe_stage_warm()
                        if armed.wait(STAGE_RETRY_S):
                            break
                        if time.monotonic() > deadline:
                            raise TimeoutError("no spare warmed to the commit front")
                with kill_lock:
                    if pending_kill[0] == (idx, steps):
                        pending_kill[0] = None
                        raise InjectedKill(f"replica {idx} killed before inner step {steps}")

            try:
                _train(idx, model, inner, manager, wrapper, run, before_step, save)
            except InjectedKill:
                # a dead process stops heartbeating and its sockets close
                # at once: abort the data plane (a streamed sync on the
                # wire dies half-fed), tear the manager down and (without
                # a spare) start over with a fresh model
                kills.append(dict(inner_step=run.steps, step=manager.current_step(), in_flight=[
                    i for i, f in enumerate(getattr(wrapper, "fragments", [])) if f._work is not None]))
                manager._comm.abort(f"replica {idx} killed")
                if spares:
                    kill_ts[0] = time.monotonic()
                    manager.shutdown()
                    return _result(model, manager, wrapper, run, restarts, initial, killed=True,
                                   streaming=streaming, kills=kills)
                restarts += 1
                manager.shutdown()
                del manager, model, inner, wrapper, save, load
                gc.collect()
                continue
            result = _result(model, manager, wrapper, run, restarts, initial,
                             streaming=streaming, kills=kills)
            manager.shutdown()
            return result

    def _spare(j: int) -> DiLoCoReplicaResult:
        from torchft_tpu_torch.ops import flash_attention
        from torchft_tpu_torch.spare import SpareAgent, diloco_delta_apply

        idx = replicas + j
        model, inner, manager, wrapper, _, _ = _make(idx, "spare")
        initial = [f.backup_sha256() for f in wrapper.fragments]
        agent = SpareAgent(manager, delta_apply=diloco_delta_apply(wrapper))
        fresh_max = 0.0
        deadline = time.monotonic() + timeout * (cap + 2)
        try:
            while not agent.step():
                registered[j].set()
                fresh_max = max(fresh_max, agent.metrics.get("warm_fresh_fraction", 0.0))
                logger.info(
                    "spare %d warming: step %d, fresh %.3f, %d bytes in %d chunks, %d deltas",
                    idx, agent.warm_step, agent.metrics.get("warm_fresh_fraction", 0.0),
                    agent.metrics.get("warm_bytes_fetched", 0), agent.metrics.get(
                        "warm_chunks_fetched", 0), agent.metrics.get("warm_deltas_applied", 0),
                )
                if (
                    front[0] is not None
                    and agent._loaded_once
                    and agent.warm_step >= front[0]
                    and not armed.is_set()
                ):
                    os.environ[SPARE_PROMOTE_ENV] = "1"
                    armed.set()
                if actives_done.is_set() or time.monotonic() > deadline:
                    info = dict(agent.metrics, promoted=False, warm_fresh_fraction_max=fresh_max)
                    return _result(model, manager, wrapper, _Run(), 0, initial, spare=info)
            adopt_ts = time.monotonic()
            launches = dict(flash_attention.launches)
            metrics = agent.metrics
        finally:
            # a promoted spare warms no more: drop its chunk cache
            agent.close()
        run = _Run()
        _train(idx, model, inner, manager, wrapper, run)
        info = dict(
            metrics,
            promoted=True,
            warm_fresh_fraction_max=fresh_max,
            kill_to_adopt_s=None if kill_ts[0] is None else adopt_ts - kill_ts[0],
            kill_to_first_commit_s=(
                None if kill_ts[0] is None or run.first_commit_ts is None
                else run.first_commit_ts - kill_ts[0]
            ),
            promotions_total=lighthouse._status().get("promotions_total"),
            launches_at_promotion=launches,
        )
        result = _result(model, manager, wrapper, run, 0, initial, spare=info)
        manager.shutdown()
        return result

    def _active(idx: int) -> DiLoCoReplicaResult:
        try:
            return _replica(idx)
        except BaseException:
            armed.set()  # release the others' holds
            raise

    try:
        with ThreadPoolExecutor(max_workers=replicas + spares) as pool:
            futures = [pool.submit(_active, i) for i in range(replicas)]
            spare_futures = [pool.submit(_spare, j) for j in range(spares)]
            results = [f.result(timeout=timeout * (cap + 2)) for f in futures]
            actives_done.set()
            return results + [f.result(timeout=timeout * (cap + 2)) for f in spare_futures]
    finally:
        actives_done.set()
        armed.set()
        if spares:
            if saved_promote is None:
                os.environ.pop(SPARE_PROMOTE_ENV, None)
            else:
                os.environ[SPARE_PROMOTE_ENV] = saved_promote
        lighthouse.shutdown()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--algo", choices=ALGOS, default="diloco")
    parser.add_argument("--model", choices=sorted(LLAMA_MODELS), default="llama3_8b")
    parser.add_argument("--layers", type=int, default=None, help="cut the preset's depth")
    parser.add_argument("--total-syncs", type=int, default=10, help="committed syncs to run")
    parser.add_argument("--sync-every", type=int, default=8)
    parser.add_argument("--num-fragments", type=int, default=2)
    parser.add_argument("--fragment-sync-delay", type=int, default=1)
    parser.add_argument("--fragment-update-alpha", type=float, default=0.0)
    parser.add_argument(
        "--quantize", action="store_true",
        help="1-byte pseudogradient sync (int8 default, fp8 via TORCHFT_QUANT_KIND)",
    )
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--seq-len", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument(
        "--replica-group-id", type=int, default=int(os.environ.get("REPLICA_GROUP_ID", 0))
    )
    parser.add_argument("--min-replicas", type=int, default=2)
    parser.add_argument("--comm-timeout", type=float, default=60.0)
    parser.add_argument("--heal-transport", choices=HEAL_TRANSPORTS, default="http",
                        help="heal over HTTP or over the communicator (CommTransport)")
    parser.add_argument("--ckpt-dir", default=None,
                        help="durable checkpoints here (--algo localsgd only): restore the "
                             "newest at start, write one after each committed sync")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    check_ckpt_algo(args.algo, args.ckpt_dir)

    device = resolve_device(args.device)
    cfg = model_config(args.model, args.layers)
    model, inner = build(cfg, device, args.seed, args.lr)
    save, load = state_fns(model, inner)
    comm = make_communicator(timeout_s=args.comm_timeout)
    manager = Manager(
        comm=comm,
        checkpoint_transport=heal_transport_for(args.heal_transport, comm),
        load_state_dict=load,
        state_dict=save,
        min_replica_size=args.min_replicas,
        use_async_quorum=False,  # DiLoCo requires a synchronous quorum
        replica_id=f"train_{args.algo}_{args.replica_group_id}",
        server_cls=manager_server_cls(default_tier()),
        timeout=args.comm_timeout,
        quorum_timeout=2 * args.comm_timeout,
    )
    wrapper = make_wrapper(
        args.algo, manager, model, args.sync_every, args.num_fragments,
        args.fragment_sync_delay, args.fragment_update_alpha, args.quantize,
    )
    if args.ckpt_dir:
        restore_durable(args.ckpt_dir, load, manager)
    batches = synthetic_batches(cfg, args.batch_size, args.seq_len, args.replica_group_id, 4, device)
    guard = wrapper.pre_step if args.algo == "diloco" else None
    per_sync = inner_steps_per_sync(args.algo, args.sync_every, args.num_fragments)
    cap = INNER_STEP_CAP * args.total_syncs * per_sync
    steps, t0 = 0, time.perf_counter()
    with wrapper:
        while manager.current_step() < args.total_syncs and steps < cap:
            loss = inner_step(model, inner, batches[steps % len(batches)], guard() if guard else None)
            steps += 1
            committed = wrapper.step()
            if committed is not None:
                logger.info(
                    "sync at inner step %d committed=%s step=%d loss %.4f",
                    steps, committed, manager.current_step(), float(loss),
                )
                # one writer per checkpoint dir: the participating rank 0
                if args.ckpt_dir and committed and manager.participating_rank() == 0:
                    save_durable(args.ckpt_dir, save, manager)
    logger.info("%d inner steps in %.1f s", steps, time.perf_counter() - t0)
    print(f"FINAL step={manager.current_step()} params_sha={params_sha256(model)[:16]}")
    manager.shutdown()


if __name__ == "__main__":
    main()
