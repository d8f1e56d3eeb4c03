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

``--algo localsgd`` runs LocalSGD.  ``--device`` defaults to ``cuda``; pass
``--device cpu`` (with ``--model llama_debug``) to run without a card.
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
from typing import Dict, List, Optional, Tuple

import torch

from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.llama import Llama, LlamaConfig
from torchft_tpu_torch.observability import HealMetrics
from torchft_tpu_torch.optim import OuterSGD
from torchft_tpu_torch.tier import default_tier, make_communicator, make_lighthouse, manager_server_cls
from torchft_tpu_torch.train_ddp import (
    MODELS,
    Batch,
    InjectedKill,
    _fence,
    build,
    model_config,
    params_sha256,
    resolve_device,
    state_fns,
    synthetic_batches,
)

logger = logging.getLogger("train_diloco")

ALGOS = ("diloco", "localsgd")
# the outer optimizer of bench.py's phase D and examples/train_diloco.py
OUTER_LR, OUTER_MOMENTUM = 0.7, 0.9
# a run stops after this many inner steps per committed sync it asked for,
# even if the syncs did not commit (bench.py's cap)
INNER_STEP_CAP = 5


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
) -> List[DiLoCoReplicaResult]:
    """Train ``replicas`` replica groups as threads of this process with
    DiLoCo (``algo="diloco"``) or LocalSGD (``"localsgd"``), each with its
    own Manager (``use_async_quorum=False``), manager sidecar, communicator
    and HTTPTransport, against an in-process lighthouse that needs every
    replica for a quorum; ``tier`` names the tier of all three planes (None:
    as :mod:`.tier` resolves it).  The inner step is AdamW (inside DiLoCo's
    ``pre_step``); the run ends when the committed step reaches
    ``outer_steps``, or after :data:`INNER_STEP_CAP` times the inner steps
    that needs.  ``kill_at=(replica, inner_step)`` kills that replica once
    before that inner step; it restarts with a fresh model and heals from a
    live peer at its next quorum.  The replicas start from one seed, so no
    step-0 sync runs (``init_sync=False``); ``init_state`` replaces the
    seeded init."""
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

    def _replica(idx: int) -> DiLoCoReplicaResult:
        batches = synthetic_batches(cfg, batch, seq, idx, 4, device)
        fence = _fence(device)
        restarts = 0
        while True:
            model, inner = build(cfg, device, seed, lr)
            if init_state is not None:
                model.load_state_dict(init_state)
            save, load = state_fns(model, inner)
            manager = Manager(
                comm=make_communicator(timeout_s=timeout, tier=tier),
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
            )
            wrapper = make_wrapper(
                algo, manager, model, sync_every, num_fragments, fragment_sync_delay,
                fragment_update_alpha, should_quantize,
            )
            frags = getattr(wrapper, "fragments", [])
            initial = [f.backup_sha256() for f in frags]
            guard = wrapper.pre_step if algo == "diloco" else None
            losses: List[float] = []
            inner_s: List[float] = []
            wrapper_s: List[float] = []
            outer_shard: List[Dict[str, float]] = []
            steps = 0
            try:
                with wrapper:
                    while manager.current_step() < outer_steps and steps < cap:
                        with kill_lock:
                            if pending_kill[0] == (idx, steps):
                                pending_kill[0] = None
                                raise InjectedKill(f"replica {idx} killed before inner step {steps}")
                        t0 = fence()
                        loss = inner_step(model, inner, batches[steps % len(batches)],
                                          guard() if guard else None)
                        t1 = fence()
                        inner_s.append(t1 - t0)
                        losses.append(float(loss))
                        steps += 1
                        committed = wrapper.step()
                        wrapper_s.append(fence() - t1)
                        if committed is not None:
                            outer_shard.append({
                                k: v for k, v in manager.last_quorum_timings.items()
                                if k.startswith("outer_shard_")
                            })
                            logger.info(
                                "replica %d inner step %d: sync committed=%s step=%d loss %.4f",
                                idx, steps, committed, manager.current_step(), losses[-1],
                            )
            except InjectedKill:
                # a dead process stops heartbeating at once: tear the
                # manager down and start over with a fresh model
                restarts += 1
                manager.shutdown()
                del manager, model, inner, save, load, wrapper, frags, guard
                gc.collect()
                continue
            result = DiLoCoReplicaResult(
                losses=losses,
                final_step=manager.current_step(),
                fragment_sha256=[f.backup_sha256() for f in frags],
                fragment_live_sha256=[f.live_sha256() for f in frags],
                initial_fragment_sha256=initial,
                params_sha256=params_sha256(model),
                restarts=restarts,
                heal=getattr(manager._checkpoint_transport, "last_heal_metrics", None),
                fragment_heals=[f.heals for f in frags],
                inner_step_s=inner_s,
                wrapper_step_s=wrapper_s,
                outer_shard=outer_shard,
                inner_steps=steps,
                planes={
                    "lighthouse": type(lighthouse).__name__,
                    "manager_server": type(manager._manager_server).__name__,
                    "communicator": type(manager._comm).__name__,
                },
            )
            manager.shutdown()
            return result

    try:
        with ThreadPoolExecutor(max_workers=replicas) as pool:
            futures = [pool.submit(_replica, i) for i in range(replicas)]
            return [f.result(timeout=timeout * (cap + 2)) for f in futures]
    finally:
        lighthouse.shutdown()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--algo", choices=ALGOS, default="diloco")
    parser.add_argument("--model", choices=sorted(MODELS), default="llama3_8b")
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
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")

    device = resolve_device(args.device)
    cfg = model_config(args.model, args.layers)
    model, inner = build(cfg, device, args.seed, args.lr)
    save, load = state_fns(model, inner)
    manager = Manager(
        comm=make_communicator(timeout_s=args.comm_timeout),
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
    logger.info("%d inner steps in %.1f s", steps, time.perf_counter() - t0)
    print(f"FINAL step={manager.current_step()} params_sha={params_sha256(model)[:16]}")
    manager.shutdown()


if __name__ == "__main__":
    main()
