"""Fault-tolerant HSDP training of Llama-3: FSDP2, tensor and sequence
parallelism inside each replica group, fault-tolerant DDP across groups.

The counterpart of ``examples/train_hsdp.py`` (the JAX package's BASELINE
config 3), in torchft's process layout: every rank of a replica group is
its own process with its own ``torch.distributed`` world (the group's:
NCCL on the card, gloo on the CPU) and its own Manager (``rank`` =
group rank), and rank r of every group averages its local gradient shards
with rank r of the others (:class:`~.parallel.hsdp.HSDPTrainer`).  One
card holds one rank of a communicator, so on one H100 each replica group
is one rank (fsdp = tp = sp = 1); the multi-rank layouts run on the CPU
over gloo.  ``--sp N`` splits the sequence over N ranks (ring attention,
FSDP2 over fsdp·sp), ``--pp N`` the layers over N pipeline stages
(``PipelinedLlama``, ``--microbatches M``, default 4·N), ``--ep N`` the
experts of a Mixture-of-Experts model (``--model llama3_8b_moe`` or
``llama_moe_debug``; ``--layers`` cuts its depth) over N ranks;
``--remat {none,attn,ffn,layer}`` picks the rematerialization.
``--heal-transport comm`` heals each rank over its own communicator
(``CommTransport``) instead of HTTP.  Run one replica group (all its
ranks) per command::

    python -m torchft_tpu_torch.lighthouse --min_replicas 2 --bind 0.0.0.0:29530 &
    TORCHFT_LIGHTHOUSE=localhost:29530 REPLICA_GROUP_ID=0 \\
        python -m torchft_tpu_torch.train_hsdp --layers 2 &
    TORCHFT_LIGHTHOUSE=localhost:29530 REPLICA_GROUP_ID=1 \\
        python -m torchft_tpu_torch.train_hsdp --layers 2 &

or a whole fleet with its own lighthouse: ``--groups 2``.  ``--device``
defaults to ``cuda``; ``--device cpu --model llama_debug --seq-len 128
--fsdp 2 --tp 2`` (or ``--fsdp 2 --sp 2``) runs four gloo ranks a group
without a card.
``TORCHFT_CHAOS_DEVICE_LOSS=N`` starts the group with its last N ranks
lost: the survivors plan a degraded layout (``parallel.degraded``) and
advertise its capacity, which needs the Python control plane
(``TORCHFT_TIER=python``).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import hashlib
import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from torchft_tpu_torch.models.llama import REMAT_MODES, LlamaConfig
from torchft_tpu_torch.models.llama_moe import (
    LlamaMoEConfig, config_from_json, config_to_json, llama3_8b_moe, llama_moe_debug)
from torchft_tpu_torch.train_ddp import HEAL_TRANSPORTS, LLAMA_MODELS

logger = logging.getLogger("train_hsdp")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# exit code of a rank killed by the fleet's fault injection
KILLED_EXIT = 17


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the presets train_hsdp trains: the Llama-3 family and its MoE variants
HSDP_MODELS = {**LLAMA_MODELS, "llama3_8b_moe": llama3_8b_moe, "llama_moe_debug": llama_moe_debug}


def model_config(name: str, layers: Optional[int] = None, remat: Optional[str] = None) -> LlamaConfig:
    """A preset at its published width; ``layers`` cuts its depth,
    ``remat`` sets its ``remat_mode``."""
    cfg = HSDP_MODELS[name]()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, remat_mode=remat) if remat else cfg


def build_model(cfg: LlamaConfig, device: torch.device, seed: int, pp: int = 1,
                microbatches: Optional[int] = None) -> torch.nn.Module:
    """The model a rank trains, from ``seed``: a ``PipelinedLlama`` of
    ``pp`` stages when pp > 1, else ``train_ddp.build``'s (``Llama`` or
    ``LlamaMoE``)."""
    from torchft_tpu_torch.train_ddp import build

    if pp == 1:
        return build(cfg, device, seed, 0.0)[0]
    if isinstance(cfg, LlamaMoEConfig):
        raise ValueError("pipeline parallelism takes a dense Llama, not a MoE model")
    from torchft_tpu_torch.parallel.pipeline import PipelinedLlama

    gen = torch.Generator(device=device).manual_seed(seed)
    return PipelinedLlama(cfg, device, gen, pp=pp, num_microbatches=microbatches)


@dataclasses.dataclass
class RankSpec:
    """Everything one rank process needs (JSON on its command line)."""

    cfg: Dict[str, Any]
    group: int
    rank: int
    world: int  # ranks this group started with (after startup device loss)
    dp: int
    fsdp: int
    tp: int
    sp: int
    pp: int
    ep: int
    microbatches: Optional[int]
    steps: int
    batch: int
    seq: int
    seed: int
    lr: float
    device: str
    tier: Optional[str]
    lighthouse: str
    store_port: int  # the group's store (multi-rank groups), 0: the Manager owns one
    dist_port: int
    min_replicas: int
    timeout: float
    quantize_outer: bool
    heal_transport: str = "http"
    kill_step: int = -1  # os._exit(KILLED_EXIT) at the top of this step
    # arm the checkpoint transport to die after serving 16 KiB of a striped
    # heal (chaos.arm_heal_source_kill)
    chaos_source: bool = False
    incarnation: int = 0
    result: str = ""  # JSON result path ("" prints the FINAL line only)
    dump_params: bool = False  # rank 0 also saves the whole parameters (.pt)


def _update(digest: Any, t: torch.Tensor) -> None:
    digest.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy())


def _sha256(tensors) -> str:
    digest = hashlib.sha256()
    for t in tensors:
        _update(digest, t)
    return digest.hexdigest()


def _rank_main(spec: RankSpec) -> None:
    """One rank of one replica group: its process group, mesh, Manager and
    HSDP train loop; writes its result JSON."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from torchft_tpu_torch.checkpointing.serialization import plan_pytree
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.ops import avg as avg_ops
    from torchft_tpu_torch.ops import flash_attention as fa
    from torchft_tpu_torch.ops import quant as qk
    from torchft_tpu_torch.parallel.degraded import plan_surviving, startup_surviving_devices
    from torchft_tpu_torch.parallel.hsdp import HSDPTrainer, adamw
    from torchft_tpu_torch.parallel.mesh import make_mesh
    from torchft_tpu_torch.tier import make_communicator, manager_server_cls
    from torchft_tpu_torch.obs import spans
    from torchft_tpu_torch.obs.spans import device_fence
    from torchft_tpu_torch.train_ddp import heal_transport_for, resolve_device, synthetic_batches

    if spans.spans_enabled():  # TORCHFT_FLIGHT_SPANS=1: the result carries the heal's split
        spans.configure(True, cap=spans.WORKER_CAP)

    device = resolve_device(spec.device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    else:
        torch.set_num_threads(max(1, min(4, (os.cpu_count() or 2) // max(1, spec.world))))
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{spec.dist_port}",
        rank=spec.rank,
        world_size=spec.world,
        timeout=datetime.timedelta(seconds=spec.timeout),
    )
    wanted = spec.dp * spec.fsdp * spec.tp * spec.sp * spec.pp * spec.ep
    ranks = startup_surviving_devices(range(wanted))
    if len(ranks) != spec.world:
        raise RuntimeError(f"{spec.world} ranks started for {len(ranks)} surviving of {wanted}")
    plan = None
    if len(ranks) < wanted:
        plan = plan_surviving(len(ranks), original_devices=wanted)
        logger.warning("coming up degraded: %s (capacity %.3f)", plan.mesh_axes, plan.capacity)
        mesh = make_mesh(ranks=ranks, **plan.mesh_axes)
    else:
        mesh = make_mesh(dp=spec.dp, fsdp=spec.fsdp, tp=spec.tp, sp=spec.sp, pp=spec.pp,
                         ep=spec.ep)
    cfg = config_from_json(spec.cfg)
    if spec.sp > 1:
        cfg = dataclasses.replace(cfg, sp_axis="sp")

    def model_fn():
        return build_model(cfg, device, spec.seed, spec.pp, spec.microbatches)

    comm = make_communicator(timeout_s=spec.timeout, tier=spec.tier)
    manager = Manager(
        comm=comm,
        checkpoint_transport=heal_transport_for(spec.heal_transport, comm),
        min_replica_size=spec.min_replicas,
        replica_id=f"train_hsdp_{spec.group}",
        lighthouse_addr=spec.lighthouse,
        rank=spec.rank,
        world_size=spec.world,
        store_addr="127.0.0.1" if spec.store_port else None,
        store_port=spec.store_port or None,
        timeout=spec.timeout,
        quorum_timeout=spec.timeout,
        connect_timeout=spec.timeout,
        server_cls=manager_server_cls(spec.tier),
        # every group starts from the same seeded weights; an init-time heal
        # would pick its source per group rank (spreading the load), so the
        # ranks of one group would average different participants at step 0
        # and the parameters replicated over tp or dp would drift apart
        init_sync=False,
    )
    if plan is not None:
        # the C++ sidecar advertises no capacity and refuses here: degraded
        # runs pin TORCHFT_TIER=python
        manager.complete_relower(plan.capacity)
    source_killed = None
    if spec.chaos_source:
        from torchft_tpu_torch.chaos import arm_heal_source_kill

        source_killed = arm_heal_source_kill(
            manager._checkpoint_transport, after_bytes=1 << 14, striped_only=True)
    trainer = HSDPTrainer(
        model_fn(), adamw(spec.lr), mesh, manager, quantize_outer=spec.quantize_outer,
        model_fn=model_fn,
    )
    batches = synthetic_batches(cfg, spec.batch, spec.seq, spec.group, 4, device)
    fence = device_fence(device)
    losses: List[float] = []
    participants: List[int] = []
    phases: List[Dict[str, float]] = []
    marks: List[float] = []
    grad_dtensor = None
    # the MoE's experts and router: how many lack a gradient after each
    # step, and the tokens past capacity in each step's forward
    moe_params = [p for n, p in trainer.params.items() if ".moe." in n]
    missing_moe_grads: List[int] = []
    moe_dropped: List[int] = []
    while manager.current_step() < spec.steps:
        step = manager.current_step()
        if step == spec.kill_step:
            logger.warning("group %d rank %d killed at step %d", spec.group, spec.rank, step)
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(KILLED_EXIT)
        marks.append(fence())
        tokens, targets = batches[step % len(batches)]
        loss, committed = trainer.train_step(tokens, targets, phases)
        if grad_dtensor is None:
            # the sharded path ran: every gradient of a sharded parameter
            # is a DTensor (the norms stay whole, hsdp.whole_params)
            sharded = [p for p in trainer.params.values() if isinstance(p, DTensor)]
            grad_dtensor = bool(sharded) and all(isinstance(p.grad, DTensor) for p in sharded)
        losses.append(loss)
        if moe_params:
            missing_moe_grads.append(sum(p.grad is None for p in moe_params))
            moe_dropped.append(sum(int(m.last_dropped) for m in trainer.model.moe_layers()))
        participants.append(manager.num_participants())
        logger.info(
            "group %d rank %d step %d loss %.4f committed=%s participants=%d",
            spec.group, spec.rank, step, loss, committed, participants[-1],
        )
    marks.append(fence())

    # the whole parameters in state_dict order (every rank gathers)
    full = {n: (t.full_tensor() if isinstance(t, DTensor) else t).detach()
            for n, t in trainer.params.items()}
    digest = hashlib.sha256()
    for name, t in full.items():
        digest.update(name.encode())
        _update(digest, t)
    # this rank's shards of the parameters and of AdamW's state; a
    # one-rank group's shards are its whole tensors, which the full hash
    # covers, so it skips them (gigabytes at the card's model size)
    local = [p.to_local() if isinstance(p, DTensor) else p for p in trainer.params.values()]
    moments = [
        v.to_local() if isinstance(v, DTensor) else v
        for s in trainer.opt_state().values() for v in s.values()
    ]
    multi_rank = spec.world > 1
    heal = getattr(manager._checkpoint_transport, "last_heal_metrics", None)
    # the array payload bytes a heal of this rank moves (its local shards
    # and the whole norms, with AdamW's state)
    state_bytes = sum(plan_pytree(trainer._save_state()).leaf_nbytes)
    result = dict(
        group=spec.group,
        rank=spec.rank,
        incarnation=spec.incarnation,
        final_step=manager.current_step(),
        losses=losses,
        participants=participants,
        params_sha256=digest.hexdigest(),
        local_params_sha256=_sha256(local) if multi_rank else None,
        local_opt_sha256=_sha256(moments) if multi_rank else None,
        grad_is_dtensor=bool(grad_dtensor),
        mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        capacity=manager.capacity,
        step_s=[b - a for a, b in zip(marks, marks[1:])],
        phase_s=phases,
        heal=None if heal is None else dict(
            seconds=heal.duration_s, bytes=heal.bytes_total, sources=heal.num_sources,
            stolen_chunks=heal.stolen_chunks),
        heal_source_killed=source_killed is not None and source_killed.is_set(),
        heal_transport=spec.heal_transport,
        # seconds in each heal span (obs.spans), None with spans off
        heal_split_s=spans.totals(spans.HEAL_PREFIXES) if spans.spans_enabled() else None,
        state_bytes=state_bytes,
        last_quorum_timings=dict(manager.last_quorum_timings),
        planes=dict(
            manager_server=type(manager._manager_server).__name__
            if manager._manager_server is not None else None,
            communicator=type(manager._comm).__name__,
        ),
        launches={**fa.launches, **qk.launches, **avg_ops.launches},
        moe_params=len(moe_params),
        missing_moe_grads=missing_moe_grads,
        moe_dropped=moe_dropped,
        max_memory_allocated_gb=(
            torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None),
    )
    if spec.dump_params and spec.rank == 0:
        torch.save({n: t.cpu() for n, t in full.items()}, spec.result + ".pt")
    if spec.result:
        with open(spec.result, "w") as f:
            json.dump(result, f)
    if spec.rank == 0:
        print(f"FINAL group={spec.group} step={result['final_step']} "
              f"params_sha={result['params_sha256'][:16]}", flush=True)
    manager.shutdown()
    dist.destroy_process_group()


class _Group:
    """The processes of one replica group's current incarnation."""

    def __init__(self, idx: int, specs: List[RankSpec], workdir: str, env: Dict[str, str]) -> None:
        from torchft_tpu_torch.store import StoreServer

        self.idx = idx
        self.incarnation = specs[0].incarnation
        self.store = StoreServer("127.0.0.1:0") if len(specs) > 1 else None
        self.procs: List[subprocess.Popen] = []
        self.logs: List[str] = []
        for spec in specs:
            spec.store_port = self.store.port if self.store is not None else 0
            log = os.path.join(workdir, f"group{idx}_rank{spec.rank}_inc{spec.incarnation}.log")
            self.logs.append(log)
            with open(log, "w") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "torchft_tpu_torch.train_hsdp", "--rank-spec",
                     json.dumps(dataclasses.asdict(spec))],
                    cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
                ))

    def poll(self) -> Optional[List[int]]:
        """Every rank's exit code once all have exited, else None."""
        codes = [p.poll() for p in self.procs]
        return None if any(c is None for c in codes) else codes

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        self.close()

    def close(self) -> None:
        if self.store is not None:
            self.store.shutdown()
            self.store = None

    def tail(self, n: int = 40) -> str:
        out = []
        for log in self.logs:
            with open(log, errors="replace") as f:
                lines = f.read().splitlines()
            out.append(f"--- {os.path.basename(log)}\n" + "\n".join(lines[-n:]))
        return "\n".join(out)


def run_hsdp_fleet(
    cfg: LlamaConfig,
    device: torch.device,
    *,
    groups: int = 2,
    dp: int = 1,
    fsdp: int = 1,
    tp: int = 1,
    sp: int = 1,
    pp: int = 1,
    ep: int = 1,
    microbatches: Optional[int] = None,
    steps: int = 4,
    batch: Optional[int] = None,
    seq: int = 2048,
    seed: int = 0,
    lr: float = 1e-4,
    kill_at: Optional[Tuple[int, int]] = None,
    quantize_outer: bool = False,
    heal_transport: str = "http",
    tier: Optional[str] = None,
    timeout: float = 300.0,
    device_loss: Optional[Dict[int, int]] = None,
    dump_params: bool = False,
    workdir: Optional[str] = None,
    lighthouse_addr: Optional[str] = None,
    group_ids: Optional[List[int]] = None,
    min_replicas: Optional[int] = None,
    chaos_source: Optional[int] = None,
) -> List[List[Dict[str, Any]]]:
    """Train ``groups`` replica groups, each ``dp·fsdp·tp·sp·pp·ep`` rank processes,
    against an in-process lighthouse that needs every group for a quorum
    (or the one at ``lighthouse_addr``, with ``group_ids`` the groups of
    the fleet this call runs and ``min_replicas`` its quorum size).
    AdamW takes optax's defaults with ``lr``.  ``kill_at=(group, step)``
    kills every rank of that group once, at the top of that step; the group
    restarts with fresh models and heals its sharded state rank by rank
    from a live group.  ``device_loss={group: n}`` starts that group with
    its last n ranks lost (degraded).  ``batch`` (the global batch of a
    group, default dp·fsdp, times the microbatches under pp) must divide
    by dp·fsdp, and ``seq`` by ``sp`` (the sequence-parallel ranks).
    ``pp`` > 1 pipelines a dense Llama over that many stages
    (``microbatches``, default 4·pp); ``ep`` > 1 splits a MoE model's
    experts.  ``heal_transport`` ("http" or "comm")
    names each rank's checkpoint transport; the ranks of group
    ``chaos_source`` arm theirs to die partway through serving a striped
    heal (``chaos.arm_heal_source_kill``; ``heal_source_killed`` in their
    results).  Returns, per group,
    the result dict of each rank of its last incarnation (with
    ``incarnation``: the restarts).  Every rank process is stopped before
    this returns; a rank that fails fails the fleet with its log."""
    from torchft_tpu_torch.tier import make_lighthouse

    wanted = dp * fsdp * tp * sp * pp * ep
    if pp > 1:
        microbatches = microbatches or 4 * pp
    batch = batch if batch is not None else dp * fsdp * (microbatches if pp > 1 else 1)
    group_ids = list(group_ids) if group_ids is not None else list(range(groups))
    min_replicas = min_replicas or groups
    lighthouse = None
    if lighthouse_addr is None:
        lighthouse = make_lighthouse(
            bind="127.0.0.1:0", min_replicas=min_replicas, join_timeout_ms=100, quorum_tick_ms=20,
            heartbeat_timeout_ms=5_000, tier=tier,
        )
        lighthouse_addr = lighthouse.local_address()
    own_dir = workdir is None
    workdir = workdir or tempfile.mkdtemp(prefix="train_hsdp_")
    device_loss = device_loss or {}
    running: Dict[int, _Group] = {}
    pending_kill = kill_at

    def _start(g: int, incarnation: int) -> _Group:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        env["TORCHFT_CHAOS_DEVICE_LOSS"] = str(device_loss.get(g, 0))
        # the ranks startup_surviving_devices leaves in the group's processes
        world = max(1, wanted - device_loss.get(g, 0))
        dist_port = _free_port()
        kill_step = pending_kill[1] if pending_kill and pending_kill[0] == g and incarnation == 0 else -1
        specs = [
            RankSpec(
                cfg=config_to_json(cfg), group=g, rank=r, world=world, dp=dp, fsdp=fsdp, tp=tp,
                sp=sp, pp=pp, ep=ep, microbatches=microbatches, steps=steps, batch=batch, seq=seq, seed=seed, lr=lr,
                device=str(device),
                tier=tier, lighthouse=lighthouse_addr, store_port=0, dist_port=dist_port,
                min_replicas=min_replicas, timeout=timeout, quantize_outer=quantize_outer,
                heal_transport=heal_transport, kill_step=kill_step, incarnation=incarnation,
                chaos_source=g == chaos_source,
                result=os.path.join(workdir, f"group{g}_rank{r}_inc{incarnation}.json"),
                dump_params=dump_params,
            )
            for r in range(world)
        ]
        return _Group(g, specs, workdir, env)

    results: Dict[int, List[Dict[str, Any]]] = {}
    deadline = time.monotonic() + timeout * (steps + 4)
    try:
        for g in group_ids:
            running[g] = _start(g, 0)
        while running:
            if time.monotonic() > deadline:
                raise TimeoutError("HSDP fleet timed out:\n" + "\n".join(
                    grp.tail() for grp in running.values()))
            for g, grp in list(running.items()):
                codes = grp.poll()
                if codes is None:
                    continue
                grp.close()
                del running[g]
                if all(c == KILLED_EXIT for c in codes) and grp.incarnation == 0:
                    running[g] = _start(g, 1)
                    continue
                if any(c != 0 for c in codes):
                    raise RuntimeError(
                        f"replica group {g} exited with {codes}:\n{grp.tail()}")
                out = []
                for log in grp.logs:
                    with open(log[: -len(".log")] + ".json") as f:
                        out.append(json.load(f))
                results[g] = out
            time.sleep(0.1)
    finally:
        for grp in running.values():
            grp.kill()
        if lighthouse is not None:
            lighthouse.shutdown()
        if own_dir and not dump_params:
            import shutil

            shutil.rmtree(workdir, ignore_errors=True)
    return [results[g] for g in group_ids]


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rank-spec", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--model", choices=sorted(HSDP_MODELS), default="llama3_8b")
    parser.add_argument("--layers", type=int, default=None, help="cut the preset's depth")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=None,
                        help="global batch of a group (default dp·fsdp)")
    parser.add_argument("--seq-len", type=int, default=2048)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fsdp", type=int, default=1)
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--dp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1,
                        help="split the sequence over this many ranks (ring attention)")
    parser.add_argument("--pp", type=int, default=1,
                        help="pipeline the layers over this many stages (GPipe)")
    parser.add_argument("--microbatches", type=int, default=None,
                        help="microbatches of the pipeline (default 4·pp)")
    parser.add_argument("--ep", type=int, default=1,
                        help="split a MoE model's experts over this many ranks")
    parser.add_argument("--remat", choices=REMAT_MODES, default=None,
                        help="rematerialize layers, their attention or FFN halves")
    parser.add_argument("--quantize-outer", action="store_true",
                        help="1-byte wire for the replica-dim gradient ring (int8 default, "
                        "fp8 via TORCHFT_QUANT_KIND)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--groups", type=int, default=None,
                        help="run this many replica groups with their own lighthouse")
    parser.add_argument(
        "--replica-group-id", type=int, default=int(os.environ.get("REPLICA_GROUP_ID", 0)))
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument("--comm-timeout", type=float, default=120.0)
    parser.add_argument("--heal-transport", choices=HEAL_TRANSPORTS, default="http",
                        help="heal over HTTP or over the communicator (CommTransport)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    if args.rank_spec is not None:
        _rank_main(RankSpec(**json.loads(args.rank_spec)))
        return

    from torchft_tpu_torch.train_ddp import resolve_device

    device = resolve_device(args.device)
    cfg = model_config(args.model, args.layers, args.remat)
    common = dict(dp=args.dp, fsdp=args.fsdp, tp=args.tp, sp=args.sp, pp=args.pp, ep=args.ep,
                  microbatches=args.microbatches, steps=args.steps,
                  batch=args.batch_size, seq=args.seq_len, seed=args.seed, lr=args.lr,
                  quantize_outer=args.quantize_outer, heal_transport=args.heal_transport,
                  timeout=args.comm_timeout)
    if args.groups:
        fleet = run_hsdp_fleet(cfg, device, groups=args.groups, **common)
    else:
        # this command's replica group against the fleet's lighthouse
        fleet = run_hsdp_fleet(
            cfg, device, group_ids=[args.replica_group_id], min_replicas=args.min_replicas,
            lighthouse_addr=os.environ["TORCHFT_LIGHTHOUSE"], **common,
        )
    for ranks in fleet:
        r = ranks[0]
        print(f"FINAL group={r['group']} step={r['final_step']} "
              f"params_sha={r['params_sha256'][:16]}", flush=True)


if __name__ == "__main__":
    main()
