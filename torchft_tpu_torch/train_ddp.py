"""Fault-tolerant data-parallel training of Llama-3 (the port's main path).

The twin of ``examples/train_ddp.py`` and of ``bench.py``'s DDP worker: an
ordinary torch train loop where fault tolerance is two extra verbs —
``opt.zero_grad()`` and ``opt.step()`` — plus a gradient allreduce.  Each
step runs ``start_quorum``, forward and backward (flash attention on the
CUDA kernels), the replica-dim gradient average over the host TCP ring, and
an AdamW step gated by ``should_commit``; a restarted replica heals from a
peer's live weights.  The lighthouse, the manager sidecar and the ring run
on the C++ tier wherever the port's native library builds, else on the
Python tier (``TORCHFT_TIER=cpp|python|auto``, see :mod:`.tier`).  Run one
process per replica group::

    python -m torchft_tpu_torch.lighthouse --min_replicas 1 --bind 0.0.0.0:29510 &
    TORCHFT_LIGHTHOUSE=localhost:29510 REPLICA_GROUP_ID=0 \\
        python -m torchft_tpu_torch.train_ddp --layers 2 &
    TORCHFT_LIGHTHOUSE=localhost:29510 REPLICA_GROUP_ID=1 \\
        python -m torchft_tpu_torch.train_ddp --layers 2 &

``--device`` defaults to ``cuda``; pass ``--device cpu`` (with
``--model llama_debug``) to run without a card.

``--heal-transport comm`` heals over the replica's own communicator
(``CommTransport``, as ``bench.py`` does) instead of HTTP.

``--model cnn`` runs the upstream example's model instead
(``examples/train_ddp.py``): the toy CNN (``models/cnn.py``) with Adam on
the synthetic CIFAR-shaped dataset, each replica reading its shard through
``data.DistributedSampler`` (``NUM_REPLICA_GROUPS`` groups).

Under the launcher's warm standby (``TPUFT_STANDBY_GATE=<file>`` in the
environment, ``launcher.ReplicaSupervisor``) the process builds its model,
runs one forward and backward (the kernels load and launch), frees the
gradients and parks until the gate file appears; only then does it build
its ``Manager``, so a parked standby never touches the quorum.  It is the
counterpart of ``bench.py``'s fleet worker, which the JAX package's
launcher promotes the same way.  Three lines report to a supervisor's log,
each ``<KIND> key=value ...``: ``STANDBY`` when the standby parks (its
flash launch counts and peak device memory so far), ``FIRST_COMMIT`` at
the process's first committed step (its wall-clock time and launches),
and ``FINAL`` at the end: the step, the parameter hash, the flash launch
counts, the peak device memory, the heal's seconds and bytes (after a
heal), the state's array payload bytes, the time of the first committed
step, the pid and, for a promoted standby, its seconds parked and the
time of its promotion.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from torchft_tpu_torch.checkpointing.serialization import plan_pytree
from torchft_tpu_torch.communicator import Communicator
from torchft_tpu_torch.data import DistributedSampler, batch_indices
from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models.cnn import SimpleCNN
from torchft_tpu_torch.models.llama import Llama, LlamaConfig, llama3_8b, llama3_70b, llama_debug
from torchft_tpu_torch.models.llama_moe import LlamaMoE, LlamaMoEConfig
from torchft_tpu_torch.obs import spans
from torchft_tpu_torch.obs.spans import device_fence
from torchft_tpu_torch.observability import HealMetrics
from torchft_tpu_torch.ops import avg as avg_ops
from torchft_tpu_torch.ops import flash_attention as fa
from torchft_tpu_torch.ops import quant as qk
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.tier import (
    default_tier,
    make_communicator,
    make_lighthouse,
    manager_server_cls,
)

logger = logging.getLogger("train_ddp")

HEAL_TRANSPORTS = ("http", "comm")

@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """The upstream example's workload: ``SimpleCNN`` on ``dataset_size``
    synthetic CIFAR-shaped samples (``synthetic_cifar``'s seed)."""

    num_classes: int = 10
    in_channels: int = 3
    image_hw: Tuple[int, int] = (32, 32)
    dataset_size: int = 2048
    data_seed: int = 0


LLAMA_MODELS = {"llama3_8b": llama3_8b, "llama3_70b": llama3_70b, "llama_debug": llama_debug}
MODELS = {**LLAMA_MODELS, "cnn": CNNConfig}
Batch = Tuple[torch.Tensor, torch.Tensor]
Config = Union[LlamaConfig, CNNConfig]


def model_config(name: str, layers: Optional[int] = None) -> Config:
    """A preset at its published width; ``layers`` cuts a Llama's depth."""
    cfg = MODELS[name]()
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def synthetic_cifar(n: int = 2048, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic CIFAR-10-shaped dataset, NHWC f32 images and
    int32 labels (``examples/train_ddp.py``'s, the same bytes)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    return x, y


def cifar_batches(
    cfg: CNNConfig, batch: int, replica: int, replicas: int, device: torch.device
) -> List[Batch]:
    """This replica's batches of the synthetic dataset, in the sampler's
    order (``DistributedSampler`` + ``batch_indices``, as the example
    reads them), images as NCHW tensors."""
    x, y = synthetic_cifar(cfg.dataset_size, cfg.data_seed)
    sampler = DistributedSampler(len(x), replica_rank=replica, num_replica_groups=replicas,
                                 shuffle=True)
    return [
        (torch.from_numpy(x[idxs]).permute(0, 3, 1, 2).contiguous().to(device),
         torch.from_numpy(y[idxs]).long().to(device))
        for idxs in batch_indices(sampler, batch)
    ]


def make_batches(
    cfg: Config, batch: int, seq: int, replica: int, replicas: int, device: torch.device
) -> List[Batch]:
    """The batches a replica cycles through: the CNN's sampler shard, or
    four synthetic Llama batches."""
    if isinstance(cfg, CNNConfig):
        return cifar_batches(cfg, batch, replica, replicas, device)
    return synthetic_batches(cfg, batch, seq, replica, 4, device)


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_ddp: CUDA is not available; pass --device cpu to run on the CPU")
    return dev


def build(cfg: Config, device: torch.device, seed: int, lr: float) -> Tuple[torch.nn.Module, torch.optim.Optimizer]:
    """Model from ``seed`` and its optimizer: for Llama AdamW with optax's
    ``adamw`` defaults (torch's default weight decay of 1e-2 differs from
    optax's 1e-4), for the CNN Adam with ``optax.adam``'s, as the
    example."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if isinstance(cfg, CNNConfig):
        cnn = SimpleCNN(cfg.num_classes, cfg.in_channels, cfg.image_hw, device=device, generator=gen)
        return cnn, torch.optim.Adam(cnn.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    model = (LlamaMoE if isinstance(cfg, LlamaMoEConfig) else Llama)(cfg, device=device, generator=gen)
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


def heal_transport_for(name: str, comm: Any) -> Optional[Any]:
    """The Manager's ``checkpoint_transport`` for ``--heal-transport``:
    ``CommTransport`` over ``comm`` (the Manager's own communicator) for
    "comm", None (the Manager's default ``HTTPTransport``) for "http"."""
    if name not in HEAL_TRANSPORTS:
        raise ValueError(f"heal transport {name!r} is not one of {HEAL_TRANSPORTS}")
    if name == "http":
        return None
    from torchft_tpu_torch.checkpointing.comm_transport import CommTransport

    return CommTransport(comm, timeout=60.0)


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
    model: torch.nn.Module,
    opt: OptimizerWrapper,
    batches: List[Batch],
    steps: int,
    on_step: Optional[Callable[[int], None]] = None,
    phases: Optional[List[Dict[str, float]]] = None,
    should_quantize: bool = False,
    on_commit: Optional[Callable[[int], None]] = None,
) -> List[float]:
    """Run until the manager's committed step reaches ``steps``; returns
    each iteration's loss.  ``on_step(step)`` runs before each iteration
    (fault injection, pacing), ``on_commit(step)`` after each iteration
    this process committed (a heal's jump is not a commit).  With ``phases`` given, each iteration
    appends its wall seconds per phase, fenced with device synchronizes:
    ``compute`` (forward + backward, the quorum overlapping it),
    ``allreduce`` (bucketing, copies to host, ring submission) and
    ``commit`` (the vote, which waits for the rings and the copy-back, and
    the optimizer step).  ``should_quantize`` averages the gradients
    through the quantized wire (``TORCHFT_QUANT_KIND``, int8 by default):
    quantized on the card, then the windowed quantized pipeline."""
    losses: List[float] = []
    fence = device_fence(batches[0][0].device) if phases is not None else None
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
        allreduce_gradients(manager, model, should_quantize=should_quantize)
        if fence:
            marks.append(fence())
        committed = opt.step()
        if fence:
            marks.append(fence())
            phases.append(dict(zip(("compute", "allreduce", "commit"), np.diff(marks).tolist())))
        losses.append(float(loss.detach()))
        if committed and on_commit is not None:
            on_commit(manager.current_step())
        logger.info(
            "step %d loss %.4f committed=%s participants=%d",
            step, losses[-1], committed, manager.num_participants(),
        )
    return losses


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
    # (start, end) ``time.monotonic()`` of each train-loop iteration of the
    # last incarnation, the clock of ``obs.spans``
    step_windows: List[Tuple[float, float]]
    # class names of the planes the last incarnation ran on:
    # "lighthouse", "manager_server", "communicator"
    planes: Dict[str, str]
    # the last incarnation's heal, if it healed (bytes and seconds)
    heal: Optional[HealMetrics]
    # the array payload bytes of the replica's checkpoint state (what a
    # heal moves, before a transport's framing)
    state_bytes: int


def run_fleet(
    cfg: Config,
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
    should_quantize: bool = False,
    tier: Optional[str] = None,
    heal_transport: str = "http",
    make_comm: Optional[Callable[[float], Communicator]] = None,
) -> List[ReplicaResult]:
    """Train ``replicas`` replica groups as threads of this process, each
    with its own Manager, manager sidecar, communicator and checkpoint
    transport (``heal_transport``: "http" or "comm", see
    :func:`heal_transport_for`), against an in-process lighthouse that
    needs every replica for a quorum.
    ``tier`` ("cpp" or "python") names the tier of all three planes; None
    resolves it as :mod:`.tier` does (``TORCHFT_TIER``, else cpp wherever
    the native library builds).  ``kill_at=(replica, step)`` kills that
    replica once before that step; it restarts with a fresh model and heals
    from a live peer.  ``init_state`` (a ``state_dict``) replaces the seeded
    init; ``should_quantize`` is passed to :func:`train_loop`.  ``cfg``
    names the workload: a Llama, or the CNN (:class:`CNNConfig`, whose
    replicas read their sampler shards of ``batch`` samples).  ``make_comm``
    (``timeout_s -> Communicator``) builds each incarnation's data plane in
    place of ``tier``'s communicator (a ``BabyCommunicator``, say)."""
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

    def _replica(idx: int) -> ReplicaResult:
        batches = make_batches(cfg, batch, seq, idx, replicas, device)
        restarts = 0
        while True:
            model, inner = build(cfg, device, seed, lr)
            if init_state is not None:
                model.load_state_dict(init_state)
            save, load = state_fns(model, inner)
            comm = (make_comm(timeout) if make_comm is not None
                    else make_communicator(timeout_s=timeout, tier=tier))
            manager = Manager(
                comm=comm,
                checkpoint_transport=heal_transport_for(heal_transport, comm),
                load_state_dict=load,
                state_dict=save,
                min_replica_size=replicas,
                replica_id=f"replica_{idx}",
                lighthouse_addr=lighthouse.local_address(),
                timeout=timeout,
                quorum_timeout=timeout,
                connect_timeout=timeout,
                server_cls=server_cls,
            )
            marks: List[float] = []
            mono: List[float] = []
            phases: List[Dict[str, float]] = []
            fence = device_fence(device)

            def _hook(step: int) -> None:
                marks.append(fence())
                mono.append(time.monotonic())
                with kill_lock:
                    if pending_kill[0] == (idx, step):
                        pending_kill[0] = None
                        raise InjectedKill(f"replica {idx} killed at step {step}")

            try:
                losses: Optional[List[float]] = train_loop(
                    manager, model, OptimizerWrapper(manager, inner), batches, steps,
                    _hook, phases, should_quantize,
                )
            except InjectedKill:
                losses = None
            if losses is None:
                # a dead process stops heartbeating at once: tear the
                # manager down and start over with a fresh model
                restarts += 1
                manager.shutdown()
                # free the dead incarnation before building the next one
                # (the manager's closures hold the model in a cycle), out of
                # the except block, whose traceback still holds the frames
                del manager, model, inner, save, load
                gc.collect()
                continue
            marks.append(fence())
            mono.append(time.monotonic())
            result = ReplicaResult(
                losses=losses,
                final_step=manager.current_step(),
                params_sha256=params_sha256(model),
                restarts=restarts,
                step_s=np.diff(marks).tolist(),
                phase_s=phases,
                state=model.state_dict(),
                step_windows=list(zip(mono[:-1], mono[1:])),
                planes={
                    "lighthouse": type(lighthouse).__name__,
                    "manager_server": type(manager._manager_server).__name__,
                    "communicator": type(manager._comm).__name__,
                },
                heal=getattr(manager._checkpoint_transport, "last_heal_metrics", None),
                state_bytes=sum(plan_pytree(save()).leaf_nbytes),
            )
            manager.shutdown()
            return result

    try:
        with ThreadPoolExecutor(max_workers=replicas) as pool:
            futures = [pool.submit(_replica, i) for i in range(replicas)]
            return [f.result(timeout=timeout * (steps + 2)) for f in futures]
    finally:
        lighthouse.shutdown()


def park_standby(model: torch.nn.Module, batch: Batch, gate: str) -> float:
    """A warm standby's start: one forward and backward on ``batch`` (the
    kernels load and launch), the gradients and the allocator's cache
    freed, so the parked process holds its weights; then wait for the
    ``gate`` file.  Builds no optimizer state and no Manager.  Returns the
    seconds parked."""
    tokens, targets = batch
    model.loss(tokens, targets).backward()
    device_fence(tokens.device)()
    model.zero_grad(set_to_none=True)
    if tokens.is_cuda:
        torch.cuda.empty_cache()
    print(f"STANDBY pid={os.getpid()} t={time.time():.3f} "
          f"launches={_compact(_launches())} peak_device_gb={_peak_device_gb(tokens.device)}",
          flush=True)
    t0 = time.monotonic()
    while not os.path.exists(gate):
        time.sleep(0.05)
    return time.monotonic() - t0


def _launches() -> Dict[str, int]:
    """This process's launches of each kernel: flash attention, the quant
    kernels and the gradient average."""
    return {**fa.launches, **qk.launches, **avg_ops.launches}


def _compact(obj: Any) -> str:
    return json.dumps(obj, separators=(",", ":"))


def _peak_device_gb(device: torch.device) -> str:
    if device.type != "cuda":
        return "none"
    return f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f}"


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=sorted(MODELS), default="llama3_8b")
    parser.add_argument("--layers", type=int, default=None, help="cut the preset's depth")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=None,
                        help="per replica (default 1; cnn: 32)")
    parser.add_argument("--seq-len", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=None, help="default 1e-4; cnn: 1e-3")
    parser.add_argument(
        "--num-replica-groups", type=int, default=int(os.environ.get("NUM_REPLICA_GROUPS", 2)),
        help="cnn: the shards the sampler splits the dataset into")
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
    parser.add_argument("--heal-transport", choices=HEAL_TRANSPORTS, default="http",
                        help="heal over HTTP or over the communicator (CommTransport)")
    parser.add_argument("--step-time", type=float, default=0.0,
                        help="seconds to sleep before each step (paces chaos-test scenarios)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    if spans.spans_enabled():  # TORCHFT_FLIGHT_SPANS=1: FINAL carries the heal's split
        spans.configure(True, cap=spans.WORKER_CAP)

    device = resolve_device(args.device)
    cfg = model_config(args.model, args.layers)
    cnn = isinstance(cfg, CNNConfig)
    batch = args.batch_size or (32 if cnn else 1)
    lr = args.lr or (1e-3 if cnn else 1e-4)
    model, inner = build(cfg, device, args.seed, lr)
    batches = make_batches(
        cfg, batch, args.seq_len, args.replica_group_id, args.num_replica_groups, device
    )
    gate = os.environ.get("TPUFT_STANDBY_GATE")
    final = {}
    if gate:
        final["standby_park_s"] = f"{park_standby(model, batches[0], gate):.3f}"
        final["promoted_t"] = f"{time.time():.3f}"
        logger.info("standby promoted after %s s parked", final["standby_park_s"])
    save, load = state_fns(model, inner)
    tier = default_tier()  # the C++ plane when the native library loads
    # the comm's tier resolves separately (data_plane_tier): auto
    # downgrades to python under forced-hierarchical topologies
    comm = make_communicator(timeout_s=args.comm_timeout)
    manager = Manager(
        comm=comm,
        checkpoint_transport=heal_transport_for(args.heal_transport, comm),
        load_state_dict=load,
        state_dict=save,
        min_replica_size=args.min_replicas,
        replica_id=f"train_ddp_{args.replica_group_id}",
        server_cls=manager_server_cls(tier),
        timeout=args.comm_timeout,
    )
    opt = OptimizerWrapper(manager, inner)

    def _first_commit(step: int) -> None:
        if "first_commit_t" not in final:
            final["first_commit_t"] = f"{time.time():.3f}"
            print(f"FIRST_COMMIT pid={os.getpid()} step={step} t={final['first_commit_t']} "
                  f"launches={_compact(_launches())}", flush=True)

    def _pace(step: int) -> None:
        time.sleep(args.step_time)

    t0 = time.perf_counter()
    train_loop(manager, model, opt, batches, args.steps,
               on_step=_pace if args.step_time > 0 else None, on_commit=_first_commit)
    logger.info("trained %d steps in %.1f s", manager.current_step(), time.perf_counter() - t0)
    heal = getattr(manager._checkpoint_transport, "last_heal_metrics", None)
    if heal is not None:
        final["heal_s"] = f"{heal.duration_s:.3f}"
        final["heal_bytes"] = str(heal.bytes_total)
    if spans.spans_enabled():
        final["heal_split"] = _compact(spans.totals(spans.HEAL_PREFIXES))
    final["state_bytes"] = str(sum(plan_pytree(save()).leaf_nbytes))
    final["launches"] = _compact(_launches())
    final["peak_device_gb"] = _peak_device_gb(device)
    final["pid"] = str(os.getpid())
    print(f"FINAL step={manager.current_step()} params_sha={params_sha256(model)[:16]} "
          + " ".join(f"{k}={v}" for k, v in final.items()), flush=True)
    manager.shutdown()


if __name__ == "__main__":
    main()
