"""Fault-tolerant data-parallel training of Llama-3 (the port's main path).

The twin of ``examples/train_ddp.py`` and of ``bench.py``'s DDP worker: an
ordinary torch train loop where fault tolerance is two extra verbs —
``opt.zero_grad()`` and ``opt.step()`` — plus a gradient allreduce.  Each
step runs ``start_quorum``, forward and backward (flash attention on the
CUDA kernels), the replica-dim gradient average over the host TCP ring, and
an AdamW step gated by ``should_commit``; a restarted replica heals from a
peer's live weights.  Run one process per replica group::

    python -m torchft_tpu_torch.lighthouse --min_replicas 1 --bind 0.0.0.0:29510 &
    TORCHFT_LIGHTHOUSE=localhost:29510 REPLICA_GROUP_ID=0 \\
        python -m torchft_tpu_torch.train_ddp --layers 2 &
    TORCHFT_LIGHTHOUSE=localhost:29510 REPLICA_GROUP_ID=1 \\
        python -m torchft_tpu_torch.train_ddp --layers 2 &

``--device`` defaults to ``cuda``; pass ``--device cpu`` (with
``--model llama_debug``) to run without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.llama import Llama, LlamaConfig, llama3_8b, llama_debug
from torchft_tpu_torch.optim import OptimizerWrapper

logger = logging.getLogger("train_ddp")

MODELS = {"llama3_8b": llama3_8b, "llama_debug": llama_debug}
Batch = Tuple[torch.Tensor, torch.Tensor]


def model_config(name: str, layers: Optional[int] = None) -> LlamaConfig:
    """A preset at its published width; ``layers`` cuts the depth."""
    cfg = MODELS[name]()
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_ddp: CUDA is not available; pass --device cpu to run on the CPU")
    return dev


def build(cfg: LlamaConfig, device: torch.device, seed: int, lr: float) -> Tuple[Llama, torch.optim.AdamW]:
    """Model from ``seed`` and AdamW with optax's ``adamw`` defaults (torch's
    default weight decay of 1e-2 differs from optax's 1e-4)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Llama(cfg, device=device, generator=gen)
    opt = torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )
    return model, opt


def synthetic_batches(
    cfg: LlamaConfig, batch: int, seq: int, replica: int, n: int, device: torch.device
) -> List[Batch]:
    """``n`` distinct (tokens, targets) batches per replica from a numpy
    seed, targets the tokens shifted by one."""
    rng = np.random.default_rng(1000 + replica)
    out = []
    for _ in range(n):
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(batch, seq)))
        out.append((tokens.to(device), torch.roll(tokens, -1, dims=1).to(device)))
    return out


def params_sha256(model: torch.nn.Module) -> str:
    """Content hash of the parameters, to compare replicas bit for bit."""
    digest = hashlib.sha256()
    for name, p in model.state_dict().items():
        digest.update(name.encode())
        digest.update(p.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def state_fns(model: torch.nn.Module, opt: torch.optim.Optimizer):
    """(state_dict, load_state_dict) for the Manager's heal path: a healed
    leaf lands with ``copy_`` in the live tensor on its device."""

    def save() -> dict:
        return {"model": model.state_dict(), "optim": opt.state_dict()}

    def load(state: dict) -> None:
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["optim"])

    return save, load


def train_loop(
    manager: Manager,
    model: Llama,
    opt: OptimizerWrapper,
    batches: List[Batch],
    steps: int,
    on_step: Optional[Callable[[int], None]] = None,
    phases: Optional[List[Dict[str, float]]] = None,
) -> List[float]:
    """Run until the manager's committed step reaches ``steps``; returns
    each iteration's loss.  ``on_step(step)`` runs before each iteration
    (fault injection, pacing).  With ``phases`` given, each iteration
    appends its wall seconds per phase, fenced with device synchronizes:
    ``compute`` (forward + backward, the quorum overlapping it),
    ``allreduce`` (bucketing, copies to host, ring submission) and
    ``commit`` (the vote, which waits for the rings and the copy-back, and
    the optimizer step)."""
    losses: List[float] = []
    fence = _fence(batches[0][0].device) if phases is not None else None
    while manager.current_step() < steps:
        step = manager.current_step()
        if on_step is not None:
            on_step(step)
        tokens, targets = batches[step % len(batches)]
        marks = [fence()] if fence else []
        opt.zero_grad()  # quorum overlaps the forward pass
        loss = model.loss(tokens, targets)
        loss.backward()
        if fence:
            marks.append(fence())
        allreduce_gradients(manager, model)
        if fence:
            marks.append(fence())
        committed = opt.step()
        if fence:
            marks.append(fence())
            phases.append(dict(zip(("compute", "allreduce", "commit"), np.diff(marks).tolist())))
        losses.append(float(loss.detach()))
        logger.info(
            "step %d loss %.4f committed=%s participants=%d",
            step, losses[-1], committed, manager.num_participants(),
        )
    return losses


def _fence(device: torch.device) -> Callable[[], float]:
    def fence() -> float:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    return fence


class InjectedKill(Exception):
    """Raised by :func:`run_fleet`'s fault hook: the replica "dies"."""


@dataclasses.dataclass
class ReplicaResult:
    losses: List[float]
    final_step: int
    params_sha256: str
    restarts: int
    # wall seconds of each train-loop iteration of the last incarnation,
    # fenced with a device synchronize
    step_s: List[float]
    # per-iteration phase seconds of the last incarnation (see train_loop)
    phase_s: List[Dict[str, float]]
    # the final ``model.state_dict()`` (references, not copies)
    state: dict


def run_fleet(
    cfg: LlamaConfig,
    device: torch.device,
    *,
    replicas: int = 2,
    steps: int = 5,
    batch: int = 1,
    seq: int = 2048,
    seed: int = 0,
    lr: float = 1e-4,
    kill_at: Optional[Tuple[int, int]] = None,
    init_state: Optional[dict] = None,
    timeout: float = 300.0,
) -> List[ReplicaResult]:
    """Train ``replicas`` replica groups as threads of this process, each
    with its own Manager, TCPCommunicator and HTTPTransport, against an
    in-process lighthouse that needs every replica for a quorum.
    ``kill_at=(replica, step)`` kills that replica once before that step;
    it restarts with a fresh model and heals from a live peer.
    ``init_state`` (a ``state_dict``) replaces the seeded init."""
    from torchft_tpu_torch.communicator import TCPCommunicator
    from torchft_tpu_torch.lighthouse import LighthouseServer

    lighthouse = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=replicas,
        join_timeout_ms=100,
        quorum_tick_ms=20,
        heartbeat_timeout_ms=5_000,
    )
    kill_lock = threading.Lock()
    pending_kill = [kill_at]

    def _replica(idx: int) -> ReplicaResult:
        batches = synthetic_batches(cfg, batch, seq, idx, 4, device)
        restarts = 0
        while True:
            model, inner = build(cfg, device, seed, lr)
            if init_state is not None:
                model.load_state_dict(init_state)
            save, load = state_fns(model, inner)
            manager = Manager(
                comm=TCPCommunicator(timeout_s=timeout),
                load_state_dict=load,
                state_dict=save,
                min_replica_size=replicas,
                replica_id=f"replica_{idx}",
                lighthouse_addr=lighthouse.local_address(),
                timeout=timeout,
                quorum_timeout=timeout,
                connect_timeout=timeout,
            )
            marks: List[float] = []
            phases: List[Dict[str, float]] = []
            fence = _fence(device)

            def _hook(step: int) -> None:
                marks.append(fence())
                with kill_lock:
                    if pending_kill[0] == (idx, step):
                        pending_kill[0] = None
                        raise InjectedKill(f"replica {idx} killed at step {step}")

            try:
                losses = train_loop(
                    manager, model, OptimizerWrapper(manager, inner), batches, steps,
                    _hook, phases,
                )
            except InjectedKill:
                # a dead process stops heartbeating at once: tear the
                # manager down and start over with a fresh model
                restarts += 1
                manager.shutdown()
                # free the dead incarnation before building the next one
                # (the manager's closures hold the model in a cycle)
                del manager, model, inner, save, load
                gc.collect()
                continue
            marks.append(fence())
            result = ReplicaResult(
                losses=losses,
                final_step=manager.current_step(),
                params_sha256=params_sha256(model),
                restarts=restarts,
                step_s=np.diff(marks).tolist(),
                phase_s=phases,
                state=model.state_dict(),
            )
            manager.shutdown()
            return result

    try:
        with ThreadPoolExecutor(max_workers=replicas) as pool:
            futures = [pool.submit(_replica, i) for i in range(replicas)]
            return [f.result(timeout=timeout * (steps + 2)) for f in futures]
    finally:
        lighthouse.shutdown()


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="llama3_8b")
    parser.add_argument("--layers", type=int, default=None, help="cut the preset's depth")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--seq-len", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument(
        "--replica-group-id", type=int, default=int(os.environ.get("REPLICA_GROUP_ID", 0))
    )
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument(
        "--comm-timeout",
        type=float,
        default=60.0,
        help="per-op timeout; a wedged peer is evicted after this",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")

    device = resolve_device(args.device)
    cfg = model_config(args.model, args.layers)
    model, inner = build(cfg, device, args.seed, args.lr)
    save, load = state_fns(model, inner)
    manager = Manager(
        load_state_dict=load,
        state_dict=save,
        min_replica_size=args.min_replicas,
        replica_id=f"train_ddp_{args.replica_group_id}",
        timeout=args.comm_timeout,
    )
    opt = OptimizerWrapper(manager, inner)
    batches = synthetic_batches(
        cfg, args.batch_size, args.seq_len, args.replica_group_id, 4, device
    )
    t0 = time.perf_counter()
    train_loop(manager, model, opt, batches, args.steps)
    logger.info("trained %d steps in %.1f s", manager.current_step(), time.perf_counter() - t0)
    print(f"FINAL step={manager.current_step()} params_sha={params_sha256(model)[:16]}")
    manager.shutdown()


if __name__ == "__main__":
    main()
