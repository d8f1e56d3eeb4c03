"""LocalSGD and (Streaming) DiLoCo: communication-reduced fault-tolerant DP.

The port of ``torchft_tpu/local_sgd.py``:

- :class:`LocalSGD`: train locally for ``sync_every`` steps, then average
  the *parameters* across replicas and commit.
- :class:`DiLoCo`: keep a host backup of the globally-synced parameters;
  every ``sync_every`` steps compute **pseudogradients** (backup − local),
  average them across replicas (optionally over the 1-byte quantized wire),
  step an **outer optimizer** on the backup, and mix local and global by
  ``fragment_update_alpha``.  The model is split into fragments whose syncs
  are staggered and overlapped with training (Streaming DiLoCo's τ =
  ``fragment_sync_delay``).

PyTorch idiom, where the JAX package uses pytrees and optax:

- the wrappers take the ``nn.Module``, not a ``holder`` dict, and fragments
  are lists of parameter names (:func:`partition_parameters`, over
  ``named_parameters()`` order by bytes);
- where the JAX package puts a new leaf into the holder, the port writes the
  live parameter **in place** (``copy_`` under ``no_grad``), so the inner
  optimizer's state stays bound to the same ``Parameter``;
- backups live beside the parameters, on their device, in their dtype.  On
  the card the sharded sync keeps every full-size array there: the
  pseudo-gradient is computed on the card a piece at a time and crosses to
  the host only as the bytes the wire sends, the owner's outer state
  (:class:`_OuterShard`) is a device tensor stepped by the outer kernel
  (``ops/outer.py``) chunk by chunk, and the delta comes back into device
  memory, where ``backup + delta`` is applied.  On the CPU the same sync
  runs host numpy (``collectives.outer_sharded_sync``, the JAX package's
  arithmetic), and the replicated path steps
  :class:`~torchft_tpu_torch.optim.OuterSGD` per leaf wherever the leaves
  live.

Degraded fleets: when the quorum carries wounded replicas the outer reduce
becomes capacity-weighted inside the Manager; nothing here changes.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import logging
import pickle
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from torchft_tpu_torch import knobs, wire
from torchft_tpu_torch.collectives import outer_shard_layout
from torchft_tpu_torch.ddp import _host_array, _host_tensor, allreduce_tensors
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.obs.spans import span as obs_span
from torchft_tpu_torch.optim import OuterSGD

logger = logging.getLogger(__name__)

# Sharded outer optimizer (ZeRO-1 over the replica dimension):
#   auto/1 — the outer sync runs as a chunk-pipelined
#            reduce_scatter → sharded outer update → allgather(delta):
#            each replica holds only its shard of the outer optimizer
#            state, updates it the moment its reduce-scatter chunk lands,
#            and the updates fan back out as deltas applied identically
#            everywhere.  Membership changes reshard.
#   0      — the replicated path: allreduce the full pseudo-gradient, every
#            replica runs the identical full outer update.
OUTER_SHARD_ENV = "TORCHFT_OUTER_SHARD"

# reshard-exchange collective tags (allgather wire tags, allocated in
# wire.USER_TAG_ALLOCATIONS)
_RESHARD_LEN_TAG = wire.RESHARD_LEN_TAG
_RESHARD_BLOB_TAG = wire.RESHARD_BLOB_TAG


def _tri_state_mode(env_name: str) -> str:
    """Parse an auto/0/1 mode knob (live-read: the drills flip these
    mid-process)."""
    raw = knobs.get_str(env_name, "auto").strip().lower()
    if raw in ("", "auto"):
        return "auto"
    if raw in ("1", "true", "on"):
        return "1"
    if raw in ("0", "false", "off"):
        return "0"
    raise ValueError(f"unparseable {env_name}={raw!r} (auto|0|1)")


def _outer_shard_mode() -> str:
    return _tri_state_mode(OUTER_SHARD_ENV)


# Streamed outer sync (zero-overhead DiLoCo fragments):
#   auto — stream when the operator set a staleness budget
#          (TORCHFT_STREAM_MAX_STALENESS >= 1) and the sync cadence has
#          room for it; otherwise the blocking schedule.
#   1    — force streaming with a derived default bar when none is set;
#          falls back (loudly) to blocking when the cadence has no room.
#   0    — the blocking path, byte-for-byte (golden-fixture pinned).
STREAM_SYNC_ENV = "TORCHFT_STREAM_SYNC"
STREAM_MAX_STALENESS_ENV = "TORCHFT_STREAM_MAX_STALENESS"
DEFAULT_STREAM_STALENESS = 4


def _stream_mode() -> str:
    return _tri_state_mode(STREAM_SYNC_ENV)


def stream_stall_for(per_frag_sync: int, delay: int) -> int:
    """The effective bounded-staleness bar, in inner steps, for one
    fragment's streamed sync — 0 means streaming is off (blocking path).

    The bar is clamped to the schedule's room: the barrier must fire
    strictly before the NEXT fragment's prepare point (``per_frag_sync -
    delay`` steps into the next round) so at most one streamed sync is
    ever in flight.  A pure function of env + the (uniform, ctor-validated)
    cadence, so every replica derives the identical schedule."""
    mode = _stream_mode()
    if mode == "0":
        return 0
    room = per_frag_sync - delay - 1
    bar = knobs.get_int(STREAM_MAX_STALENESS_ENV, 0)
    if mode == "auto":
        return min(bar, room) if bar >= 1 and room >= 1 else 0
    # mode == "1": forced — derive a bar when none is set
    if room < 1:
        logger.warning(
            "%s=1 but the sync cadence has no staleness room "
            "(per-fragment sync_every=%d, delay=%d): falling back to the "
            "blocking outer sync",
            STREAM_SYNC_ENV,
            per_frag_sync,
            delay,
        )
        return 0
    return min(bar if bar >= 1 else DEFAULT_STREAM_STALENESS, room)


class _OuterShard:
    """This owner's shard of one fragment's outer optimizer state.

    The flat f32 element space of the fragment is split into deterministic
    equal shards (``collectives.outer_shard_layout``); this object holds the
    :class:`OuterSGD` state of ONE shard — f32 numpy leaves on the host, f32
    tensors on ``device`` when one is given (the card path) — serves
    per-chunk slices to the pipelined sync (``update_cb``), stages the
    updated state until the commit vote, and re-partitions on membership
    change.  The reshard blob and :meth:`save_state` always carry f32 numpy
    leaves (so a blob pickled by a JAX rank loads here and the other way
    round): device leaves are exported from the card, one copy each, and
    rebuilt state is loaded back onto it.

    Resharding: whenever the quorum id moved since the layout was built,
    every replica contributes its (meta, state-shard) over two allgathers
    (lengths, then padded pickles) and reassembles the new shard from
    whichever contributions cover each element range.  Ranges owned by a
    replica that died are re-initialized fresh; a healed replica contributes
    the shard it received in the checkpoint."""

    def __init__(
        self, outer: OuterSGD, n: int, should_quantize: bool,
        device: Optional[torch.device] = None,
    ) -> None:
        self._outer = outer
        self._n = n
        self._quant = should_quantize
        self._device = device
        # (quorum_id, gsize, gidx, per, owns) of the current layout
        self.meta: Optional[Dict[str, Any]] = None
        self._state_leaves: Optional[List[_Leaf]] = None
        self._staged: Optional[List[_Leaf]] = None
        # (meta, leaves) recovered from a healing checkpoint, contributed at
        # the next reshard (our own rank may differ from the source's)
        self._loaded: List[Tuple[Dict[str, Any], List[np.ndarray]]] = []

    def _fresh_leaves(self, per: int) -> List[_Leaf]:
        """Fresh (zero) state leaves of ``per`` elements where the state
        lives: host numpy, or tensors made on the device."""
        if self._device is None:
            return [np.array(l, dtype=np.float32)
                    for l in self._outer.init(np.zeros(per, np.float32))]
        return [torch.zeros(per, dtype=torch.float32, device=self._device)
                for _ in self._outer.init(np.zeros(0, np.float32))]

    def maybe_reshard(self, manager: Manager) -> None:
        """(Re)build this owner's shard for the current quorum.  Gated on
        the quorum id alone — a shared fact, so every replica enters (or
        skips) the collective exchange in lock-step."""
        qid = manager._quorum_id
        if self.meta is not None and self.meta["q"] == qid:
            return
        gsize, gidx, owns = manager.outer_shard_group()
        _padded, per, _unit = outer_shard_layout(self._n, gsize, self._quant)
        meta = {"q": qid, "gsize": gsize, "gidx": gidx, "per": per, "n": self._n, "owns": owns}
        with obs_span("outer_shard::export"):
            contribs = self._export_contribs()
        comm = manager._comm
        if comm.size() > 1 and not getattr(comm, "is_passthrough", False):
            with obs_span("outer_shard::exchange"):
                blob = pickle.dumps(contribs)
                try:
                    lens = comm.allgather(
                        np.array([len(blob)], dtype=np.int64), tag=_RESHARD_LEN_TAG
                    ).wait()
                    maxlen = max(int(np.asarray(l).reshape(-1)[0]) for l in lens)
                    padded_blob = np.empty(max(1, maxlen), dtype=np.uint8)
                    padded_blob[: len(blob)] = np.frombuffer(blob, dtype=np.uint8)
                    padded_blob[len(blob) :] = 0
                    del blob
                    blobs = comm.allgather(padded_blob, tag=_RESHARD_BLOB_TAG).wait()
                    contribs = []
                    for l, b in zip(lens, blobs):
                        size = int(np.asarray(l).reshape(-1)[0])
                        try:
                            # straight from the gathered buffer: a blob holds
                            # the outer state (GBs at 8B width), and each copy
                            # of it costs fresh host pages
                            contribs.extend(pickle.loads(np.ascontiguousarray(b[:size], np.uint8)))
                        except Exception:  # noqa: BLE001 — skip a bad peer blob
                            logger.warning("outer-shard reshard: bad peer blob")
                except Exception as e:  # noqa: BLE001 — the sync right after
                    # this surfaces comm errors; the reshard falls back to the
                    # locally-held contributions (peers' shards re-init fresh)
                    logger.warning("outer-shard reshard exchange failed: %s", e)
                    contribs = self._export_contribs()
        with obs_span("outer_shard::rebuild"):
            self._rebuild(contribs, meta)

    def _export_contribs(self) -> List[Tuple[Dict[str, Any], List[np.ndarray]]]:
        out = list(self._loaded)
        if self.meta is not None and self._state_leaves is not None:
            out.append((dict(self.meta), _host_leaves(self._state_leaves)))
        return out

    def _rebuild(
        self,
        contribs: List[Tuple[Dict[str, Any], List[np.ndarray]]],
        meta: Dict[str, Any],
    ) -> None:
        self._loaded = []
        self._staged = None
        self.meta = meta
        if not meta["owns"]:
            self._state_leaves = None
            return
        per = meta["per"]
        leaves = self._fresh_leaves(per)
        my_lo, my_hi = meta["gidx"] * per, meta["gidx"] * per + per
        for cmeta, cleaves in contribs:
            if cmeta.get("n") != self._n or not cmeta.get("owns", True):
                continue
            cper = cmeta["per"]
            c_lo = cmeta["gidx"] * cper
            lo, hi = max(my_lo, c_lo), min(my_hi, c_lo + cper)
            if lo >= hi or len(cleaves) != len(leaves):
                continue
            for mine, theirs in zip(leaves, cleaves):
                theirs = np.asarray(theirs)
                if theirs.shape != (cper,):
                    continue
                part = theirs[lo - c_lo : hi - c_lo]
                if torch.is_tensor(mine):
                    # each contribution's range crosses to the card once
                    mine[lo - my_lo : hi - my_lo].copy_(torch.from_numpy(part))
                else:
                    mine[lo - my_lo : hi - my_lo] = part
        self._state_leaves = leaves

    def make_update_cb(self) -> "_ShardUpdate":
        """Per-chunk outer update for the pipelined sync over a copy of this
        shard's state, which is staged (adopted only on commit)."""
        assert self.meta is not None and self.meta["owns"]
        assert self._state_leaves is not None
        old = self._state_leaves
        self._staged = [l.clone() if torch.is_tensor(l) else l.copy() for l in old]
        return _ShardUpdate(self._outer, old, self._staged, self.meta["gidx"] * self.meta["per"])

    def commit_stage(self) -> None:
        if self._staged is not None:
            self._state_leaves = self._staged
        self._staged = None

    def abort_stage(self) -> None:
        self._staged = None

    def save_state(self) -> Optional[Dict[str, Any]]:
        if self.meta is None:
            return None
        leaves = self._state_leaves
        return {"meta": dict(self.meta), "leaves": None if leaves is None else _host_leaves(leaves)}

    def load_state(self, state: Optional[Dict[str, Any]]) -> None:
        """A healed checkpoint carries the SOURCE's shard; hold it as a
        reshard contribution (the heal always rides a quorum change, so the
        next sync reshards and routes every range to its new owner).  The
        transport delivers array leaves as tensors: they are kept as f32
        numpy, the reshard blob's format."""
        if not state or state.get("leaves") is None:
            return
        leaves = [np.asarray(l, dtype=np.float32) for l in state["leaves"]]
        self._loaded.append((dict(state["meta"]), leaves))
        self.meta = None  # force reshard at the next sync


# a leaf of the outer state: f32 numpy on the host, an f32 tensor on the card
_Leaf = Union[np.ndarray, torch.Tensor]


def _host_leaves(leaves: Sequence[_Leaf]) -> List[np.ndarray]:
    """Outer-state leaves as f32 numpy, the blob's format (a device leaf
    copied back once)."""
    return [l.cpu().numpy() if torch.is_tensor(l) else l for l in leaves]


class _ShardUpdate:
    """One sync's per-chunk outer update of an owner's shard: reads the
    state as it was (``old``; chunks slice the ORIGINAL state) and writes
    the new state into ``staged``.

    State on the host takes the host contract: ``update(lo, hi, avg)`` with
    the averaged f32 chunk returns the host delta.  State on a device takes
    the card contract: :meth:`on_card` with the chunk's gathered
    contributions there, which the outer kernel (``ops.outer``) sums,
    scales and steps the shard with in one pass, writing the delta into
    ``out``."""

    def __init__(self, outer: OuterSGD, old: List[_Leaf], staged: List[_Leaf], base: int) -> None:
        self._outer = outer
        self._old = old
        self._staged = staged
        self._base = base

    def __call__(self, lo: int, hi: int, avg: np.ndarray) -> np.ndarray:
        s, e = lo - self._base, hi - self._base
        updates, new_state = self._outer.update(avg, [l[s:e] for l in self._old])
        for j, leaf in enumerate(new_state):
            self._staged[j][s:e] = leaf
        return np.asarray(updates, dtype=np.float32)

    def on_card(self, lo: int, hi: int, contribs: torch.Tensor, scale: float,
                out: torch.Tensor) -> None:
        from torchft_tpu_torch.ops.outer import outer_update

        s, e = lo - self._base, hi - self._base
        outer = self._outer
        trace, new_trace = (self._old[0][s:e], self._staged[0][s:e]) if self._old else (None, None)
        outer_update(contribs, scale, out, outer.lr, outer.momentum, outer.nesterov,
                     trace, new_trace)


def partition_parameters(model: nn.Module, num_fragments: int) -> List[List[str]]:
    """Split ``model``'s parameters, in ``named_parameters()`` order, into
    ``num_fragments`` contiguous groups of roughly equal byte size (the JAX
    package's ``partition_leaves``); returns the names of each group."""
    named = list(model.named_parameters())
    if len(named) < num_fragments:
        raise ValueError(f"cannot split {len(named)} parameters into {num_fragments} fragments")
    sizes = [p.numel() * p.element_size() for _, p in named]
    target = sum(sizes) / max(num_fragments, 1)
    groups: List[List[str]] = [[] for _ in range(num_fragments)]
    acc, g = 0.0, 0
    for i, ((name, _p), size) in enumerate(zip(named, sizes)):
        groups[g].append(name)
        acc += size
        # advance AFTER placing, based on accumulated bytes including this
        # parameter, and never leave fewer parameters than remaining groups
        remaining_params = len(named) - (i + 1)
        remaining_groups = num_fragments - (g + 1)
        if g < num_fragments - 1 and (
            acc >= target * (g + 1) or remaining_params <= remaining_groups
        ):
            g += 1
    assert all(groups), "internal error: empty fragment"
    return groups


def fragments_from_jax(
    jax_params: Dict[str, Any], jax_fragments: List[List[int]], n_layers: int
) -> List[List[str]]:
    """The JAX package's fragments of a Llama pytree (``partition_leaves``
    groups of indices into its ``tree_leaves`` order) as lists of this
    package's ``Llama`` parameter names, so both packages sync the same
    parameters.  A stacked layer leaf becomes its ``n_layers`` per-layer
    parameters (``models.llama.params_from_jax``).  The element order inside
    a fragment differs (the port unstacks and transposes), so the mapping
    names the same parameters, not the same wire layout."""
    from torchft_tpu_torch.models.llama import _LINEAR, _NORMS

    def leaf_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, ...]]:
        if isinstance(tree, dict):
            for key in sorted(tree):  # a dict flattens in sorted-key order
                yield from leaf_paths(tree[key], prefix + (key,))
        else:
            yield prefix

    def port_names(path: Tuple[str, ...]) -> List[str]:
        if path == ("lm_head",):
            return ["lm_head.weight"]
        if len(path) == 1:
            return [path[0]]
        _layers, name = path
        if name in _LINEAR:
            return [f"layers.{i}.{name}.weight" for i in range(n_layers)]
        if name in _NORMS:
            return [f"layers.{i}.{name}" for i in range(n_layers)]
        raise ValueError(f"unknown Llama parameter {path!r}")

    paths = list(leaf_paths(jax_params))
    return [[name for i in group for name in port_names(paths[i])] for group in jax_fragments]


def _sync_device(device: torch.device) -> Optional[torch.device]:
    """Where a fragment on ``device`` runs its sharded sync's arithmetic:
    on the card, the card (``collectives.outer_sharded_sync``'s card path);
    on the CPU, None — the host numpy path."""
    return device if device.type == "cuda" else None


@functools.lru_cache(maxsize=None)
def _host_bf16_nan() -> int:
    """The bits torch's CPU cast writes into bf16 for every NaN, whatever
    its sign and payload, read from the cast itself (its vectorized x86
    path writes 0xffff, c10's scalar rounding 0x7fc0); CUDA's cast writes
    its canonical 0x7fff instead."""
    return int(torch.full((64,), float("nan")).to(torch.bfloat16).view(torch.int16)[0])


def _round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 ``x`` rounded to ``dtype`` as the host rounds it: on the card a
    bf16 NaN is rewritten to the host cast's bits, so a replica applies the
    same bits on either."""
    y = x.to(dtype)
    if dtype != torch.bfloat16 or x.device.type == "cpu":
        return y
    nan = torch.tensor(_host_bf16_nan(), dtype=torch.int16).view(torch.bfloat16).to(x.device)
    return torch.where(torch.isnan(x), nan, y)


def _write_params(params: Sequence[nn.Parameter], values: Sequence[torch.Tensor]) -> None:
    """Write ``values`` into the live parameters in place (casting and
    moving to each parameter's dtype and device)."""
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(v.reshape(p.shape))


def tensors_sha256(tensors: Sequence[torch.Tensor]) -> str:
    """Content hash of ``tensors`` (their bytes, in order), to compare
    replicas bit for bit."""
    digest = hashlib.sha256()
    for t in tensors:
        digest.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


class LocalSGD:
    """Parameter-averaging LocalSGD.

    Usage::

        local_sgd = LocalSGD(manager, model, sync_every=32)
        with local_sgd:
            for batch in data:
                ...inner optimizer step on model...
                local_sgd.step()
    """

    def __init__(self, manager: Manager, model: nn.Module, sync_every: int) -> None:
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        self._manager = manager
        self._params = list(model.parameters())
        self._sync_every = sync_every
        self._local_step = 0
        # streamed sync (TORCHFT_STREAM_SYNC): LocalSGD is one whole-model
        # "fragment" — the parameter average streams under the next inner
        # steps and applies at the bounded-staleness barrier (inner progress
        # during the stall is overwritten by the committed average)
        self._stream_stall = stream_stall_for(sync_every, 0)
        self._stream_work = None

    def __enter__(self) -> "LocalSGD":
        return self

    def __exit__(self, *exc: object) -> bool:
        # drain a streamed sync submitted within the final stall window:
        # abandoning it would end the run one committed average short and
        # leave an open quorum + a dangling stream-fence entry
        if self._stream_work is not None:
            self._apply_streamed()
        return False

    def step(self) -> Optional[bool]:
        """Call after every inner optimizer step; returns the commit decision
        on sync steps (at the staleness barrier when streaming), None
        otherwise."""
        self._local_step += 1
        committed: Optional[bool] = None
        if self._stream_work is not None and self._local_step >= self._stream_stall:
            committed = self._apply_streamed()
        if self._local_step < self._sync_every:
            return committed
        self._local_step = 0
        if self._stream_stall > 0:
            self._manager.start_quorum()
            with obs_span("stream::submit", frag=0):
                # stream=0 registers the composite work in the Manager's
                # stream-fence registry
                self._stream_work = allreduce_tensors(self._manager, self._params, stream=0)
            return committed
        return self.sync()

    def _apply_streamed(self) -> bool:
        """Bounded-staleness barrier of a streamed parameter average: wait
        the collective, vote, and adopt the committed average."""
        work, self._stream_work = self._stream_work, None
        with obs_span("stream::barrier", frag=0):
            averaged = work.wait()
        committed = self._manager.should_commit()
        self._manager.stream_resolved(0, committed)
        if committed:
            _write_params(self._params, averaged)
        return committed

    def sync(self) -> bool:
        """Average the parameters across replicas and commit: the average
        rides ``ddp.allreduce_tensors``'s buckets and is written into the
        live parameters only on a committed vote."""
        self._manager.start_quorum()
        averaged = allreduce_tensors(self._manager, self._params).wait()
        committed = self._manager.should_commit()
        if committed:
            _write_params(self._params, averaged)
        return committed


class _Fragment:
    """One streaming fragment: backup parameters, pseudogradients, outer
    optimizer state, alpha mixing."""

    def __init__(
        self,
        manager: Manager,
        params: List[Tuple[str, nn.Parameter]],
        index: int,
        outer: OuterSGD,
        should_quantize: bool,
        fragment_update_alpha: float,
        scratch: "_FlatScratch",
    ) -> None:
        self._manager = manager
        self.names = [name for name, _p in params]
        self._params = [p for _name, p in params]
        self._index = index
        self._outer = outer
        self._should_quantize = should_quantize
        self._alpha = fragment_update_alpha
        self._work = None
        self._sharded_inflight = False
        # True while a TORCHFT_STREAM_SYNC submit is in flight: the work
        # lives in the Manager's stream-fence registry and perform_sync
        # reports the FRAG_COMMIT/FRAG_ABORT outcome when it resolves
        self._stream_inflight = False
        # healing checkpoints this fragment's state was loaded from, and
        # streamed syncs resolved at their bounded-staleness barrier
        self.heals = 0
        self.stream_barriers = 0

        # the last globally-synced values, beside the parameters (on the
        # card, in device memory) in their dtypes
        self.backup: List[torch.Tensor] = [p.detach().clone() for p in self._params]
        self._device = self._params[0].device
        # (flat offset, size, shape, dtype) of each parameter over the
        # fragment's f32 element space
        self._leaf_meta: List[Tuple[int, int, torch.Size, torch.dtype]] = []
        off = 0
        for p in self._params:
            self._leaf_meta.append((off, p.numel(), p.shape, p.dtype))
            off += p.numel()
        self._n = off
        # the padded f32 pseudo-gradient buffer, shared by the fragments
        self._scratch = scratch

        # full replicated outer state exists ONLY on the replicated path
        # (one trace per leaf, in the leaf's dtype, as optax's) — in
        # sharded mode each owner's slice lives in _OuterShard (the ZeRO-1
        # memory division)
        self.outer_state: Optional[List[torch.Tensor]] = (
            outer.init_leaves(self.backup) if _outer_shard_mode() == "0" else None
        )
        self._shard = _OuterShard(outer, self._n, should_quantize, _sync_device(self._device))

        # fragment state rides the healing checkpoint
        manager.register_state_dict_fn(
            f"StreamingDiLoCoFragment_{index}", self._load_state, self._save_state
        )

    def _save_state(self) -> Dict[str, Any]:
        # the owner's shard crosses card -> host here; the backups go to the
        # transport as they lie
        with obs_span("diloco::save_state", frag=self._index):
            return {
                "backup": self.backup,
                "outer_state": self.outer_state,
                "outer_shard": self._shard.save_state(),
            }

    def _load_state(self, state: Dict[str, Any]) -> None:
        with obs_span("diloco::load_state", frag=self._index):
            self.backup = [torch.as_tensor(b).to(self._device) for b in state["backup"]]
            outer_state = state.get("outer_state")
            self.outer_state = (
                None if outer_state is None
                else [torch.as_tensor(l).to(self._device) for l in outer_state]
            )
            self._shard.load_state(state.get("outer_shard"))
        self.heals += 1

    def backup_sha256(self) -> str:
        return tensors_sha256(self.backup)

    def live_sha256(self) -> str:
        return tensors_sha256(self._params)

    def _sharded(self) -> bool:
        return _outer_shard_mode() != "0"

    def prepare_sync(self, stream: bool = False) -> None:
        """pseudogradient = backup − local, then async average.  With
        ``stream=True`` the submit rides the Manager's stream-fence registry
        (and, on the sharded path, the fragment's rotating STREAM_OUTER tag
        window): inner compute continues against pre-sync params and the
        caller applies the delta at its bounded-staleness barrier via
        :meth:`perform_sync`."""
        assert self._work is None, "fragment already has an allreduce in flight"
        self._stream_inflight = stream
        with obs_span("stream::submit" if stream else "diloco::prepare", frag=self._index):
            if self._sharded():
                self._prepare_sync_sharded(stream)
                return
            with obs_span("diloco::host_copy", frag=self._index):
                psg = [_host_array((b - p.detach()).cpu()) for b, p in zip(self.backup, self._params)]
            # in_place: pseudograds are freshly computed for this call and
            # only the returned average is read afterwards
            self._work = self._manager.allreduce(
                psg,
                should_quantize=self._should_quantize,
                in_place=True,
                stream=self._index if stream else None,
            )

    def _prepare_sync_sharded(self, stream: bool) -> None:
        """Sharded outer sync: assemble the flat f32 pseudo-gradient,
        (re)build this owner's shard for the current quorum, and hand the
        per-chunk outer update to the pipelined reduce_scatter→update→
        allgather (on the card, its card path)."""
        with obs_span("diloco::reshard", frag=self._index):
            self._shard.maybe_reshard(self._manager)
        meta = self._shard.meta
        gsize = meta["gsize"] if meta is not None else 1
        padded, _per, _unit = outer_shard_layout(self._n, max(1, gsize), self._should_quantize)
        device = _sync_device(self._device)
        psg = self._scratch.take(padded, pinned=device is not None and device.type == "cuda")
        psg_t = torch.from_numpy(psg)
        for (off, size, _shape, _dtype), b, p in zip(self._leaf_meta, self.backup, self._params):
            seg, back, live = psg_t[off : off + size], b.reshape(-1), p.detach().reshape(-1)
            # backup - live in f32 where both live, one piece at a time (the
            # card never holds a leaf in f32), each piece copied straight
            # into the buffer the wire reads.  The copy waits for the work
            # queued before it on this stream (the inner step that wrote
            # the parameters) and returns once done, so the next inner step
            # cannot overwrite what it reads
            for lo in range(0, size, _WIDEN_PIECE):
                hi = min(lo + _WIDEN_PIECE, size)
                with obs_span("diloco::pseudograd", frag=self._index):
                    piece = back[lo:hi].float() - live[lo:hi].float()
                with obs_span("diloco::host_copy", frag=self._index):
                    seg[lo:hi].copy_(piece)
        psg[self._n :] = 0.0

        update_cb = (
            self._shard.make_update_cb() if meta is not None and meta["owns"] else _no_shard_cb
        )
        self._sharded_inflight = True
        self._work = self._manager.outer_shard_allreduce(
            psg[: self._n],
            update_cb,
            should_quantize=self._should_quantize,
            stream=self._index if stream else None,
            device=device,
        )

    def perform_sync(self) -> bool:
        """Wait for the result, vote, and apply the outer step.  On a
        streamed sync this is the bounded-staleness barrier: the vote runs
        only after the work resolved (the Manager's stream fence would
        otherwise force it False)."""
        assert self._work is not None, "prepare_sync must run first"
        streamed = self._stream_inflight
        with obs_span("stream::barrier" if streamed else "diloco::perform", frag=self._index):
            result = self._work.wait()
        self._work = None
        sharded = self._sharded_inflight
        self._sharded_inflight = False
        self._stream_inflight = False

        committed = self._manager.should_commit()
        if streamed:
            self.stream_barriers += 1
            self._manager.stream_resolved(self._index, committed)

        if committed and sharded and result is not None:
            # delta = the allgathered sharded outer update, identical bytes
            # on every replica
            with obs_span("diloco::apply", frag=self._index):
                global_params = self.global_from_delta(result)
            self._apply_global(global_params)
            self._shard.commit_stage()
            # hot spares: the committed delta (identical bytes on every
            # replica) feeds parked spares' shadows
            self._manager.publish_staged_outer_delta(self._index)
        elif committed and not sharded:
            # optax.sgd + apply_updates on the leaves, each in its dtype
            averaged = [
                _host_tensor(a).reshape(b.shape).to(self._device)
                for a, b in zip(result, self.backup)
            ]
            if self.outer_state is None:
                self.outer_state = self._outer.init_leaves(self.backup)
            updates, self.outer_state = self._outer.update_leaves(averaged, self.outer_state)
            self._apply_global([b + u for b, u in zip(self.backup, updates)])
        else:
            # failed sync: reset to the last globally-consistent state so we
            # never overtrain on unsynced data
            if sharded:
                self._shard.abort_stage()
            with obs_span("diloco::write", frag=self._index):
                _write_params(self._params, self.backup)
        return committed

    def global_from_delta(self, delta: Union[np.ndarray, torch.Tensor]) -> List[torch.Tensor]:
        """The new global values, backup + ``delta`` (flat f32 over the
        fragment) summed in f32 and rounded once to each leaf's dtype, on the
        backup's device, a piece at a time in the delta's own buffer (this
        sync's, read by nothing else afterwards)."""
        delta = torch.as_tensor(delta)
        if delta.device != self._device:
            delta = delta.to(self._device)
        elif delta.is_cuda:
            # the sync's own stream wrote it: keep its memory from being
            # reused there while this stream still reads it
            delta.record_stream(torch.cuda.current_stream(delta.device))
        out = []
        for (off, size, shape, dtype), b in zip(self._leaf_meta, self.backup):
            g, back = torch.empty(size, dtype=dtype, device=b.device), b.reshape(-1)
            for lo in range(0, size, _WIDEN_PIECE):
                hi = min(lo + _WIDEN_PIECE, size)
                g[lo:hi].copy_(_round_to(delta[off + lo : off + hi].add_(back[lo:hi]), dtype))
            out.append(g.reshape(shape))
        return out

    def _apply_global(self, global_params: List[torch.Tensor]) -> None:
        """model = (1−α)·global + α·local, computed in f32 and rounded once
        to each parameter's dtype (the JAX package's host arithmetic: numpy
        promotes ``float · bf16`` to f32), where the parameters live."""
        if self._alpha == 0.0:
            mixed = global_params
        else:
            mixed = [
                _round_to(g.float() * (1.0 - self._alpha) + p.detach().float() * self._alpha,
                          p.dtype)
                for g, p in zip(global_params, self._params)
            ]
        with obs_span("diloco::write", frag=self._index):
            _write_params(self._params, mixed)
        self.backup = global_params


# elements of a leaf widened to f32 at a time for the pseudo-gradient and
# the apply: the card holds one piece (256 MiB), not a leaf in f32
_WIDEN_PIECE = 1 << 26


class _FlatScratch:
    """The padded f32 pseudo-gradient buffer of the sharded sync, shared by
    a DiLoCo's fragments and grown to the largest: at most one fragment's
    sync is in flight (the next prepare runs after the previous perform, or
    after its streamed barrier), and the pipeline has copied it by then.
    ``pinned`` (the card path) takes it in page-locked memory, which the
    card's copies fill at DMA rate."""

    def __init__(self) -> None:
        self._buf: Optional[np.ndarray] = None
        self._pinned: Optional[torch.Tensor] = None

    def take(self, padded: int, pinned: bool = False) -> np.ndarray:
        if self._buf is None or self._buf.size < padded or (self._pinned is not None) != pinned:
            self._buf = self._pinned = None
            if pinned:
                self._pinned = torch.zeros(padded, dtype=torch.float32, pin_memory=True)
                self._buf = self._pinned.numpy()
            else:
                self._buf = np.zeros(padded, dtype=np.float32)
        return self._buf[:padded]


def _no_shard_cb(lo: int, hi: int, avg: np.ndarray) -> np.ndarray:
    raise AssertionError("outer update callback invoked on a replica that owns no shard")


class DiLoCo:
    """(Streaming) DiLoCo.

    Usage::

        manager = Manager(..., use_async_quorum=False)
        diloco = DiLoCo(manager, model, OuterSGD(0.7, momentum=0.9, nesterov=True),
                        sync_every=20, num_fragments=2)
        with diloco:
            for batch in data:
                with diloco.pre_step():
                    ...inner optimizer step on model...
                diloco.step()
    """

    def __init__(
        self,
        manager: Manager,
        model: nn.Module,
        outer: Union[OuterSGD, List[OuterSGD]],
        sync_every: int,
        num_fragments: int = 1,
        fragments: Optional[List[List[str]]] = None,
        should_quantize: bool = False,
        fragment_sync_delay: int = 0,
        fragment_update_alpha: float = 0.0,
    ) -> None:
        if manager._use_async_quorum:
            raise ValueError(
                "DiLoCo requires synchronous quorum: construct the Manager "
                "with use_async_quorum=False"
            )
        if fragments is None:
            fragments = partition_parameters(model, num_fragments)
        n = len(fragments)
        if sync_every < n:
            raise ValueError("Only 1 fragment can be synchronized at a time")
        if sync_every % n != 0:
            raise ValueError("sync_every must be divisible by the fragment count")
        self._sync_every = sync_every // n
        if fragment_sync_delay >= self._sync_every:
            raise ValueError("Fragment must be synced before it is reduced again")
        if not 0.0 <= fragment_update_alpha <= 1.0:
            raise ValueError("fragment_update_alpha must be between 0 and 1")

        self._manager = manager
        self._local_step = 0
        self._fragment_sync_delay = fragment_sync_delay
        # streamed outer sync: the effective bounded-staleness bar (0 =
        # blocking schedule), resolved ONCE at construction — the schedule
        # must be identical on every replica and stable for the run
        self._stream_stall = stream_stall_for(self._sync_every, fragment_sync_delay)
        # the fragment whose streamed sync is awaiting its barrier (at most
        # one: the bar is clamped below the next prepare point)
        self._stream_pending_frag: Optional[int] = None

        outers = outer if isinstance(outer, list) else [outer] * n
        if len(outers) != n:
            raise ValueError("need one outer optimizer per fragment")
        named = dict(model.named_parameters())
        scratch = _FlatScratch()
        self.fragments = [
            _Fragment(
                manager,
                [(name, named[name]) for name in names],
                i,
                outers[i],
                should_quantize,
                fragment_update_alpha,
                scratch,
            )
            for i, names in enumerate(fragments)
        ]

    def __enter__(self) -> "DiLoCo":
        return self

    def __exit__(self, *exc: object) -> bool:
        # drain a streamed sync whose sync step already passed but whose
        # staleness barrier hasn't fired (a fragment merely PREPARED is
        # abandoned exactly like the blocking schedule abandons it)
        if self._stream_pending_frag is not None:
            frag = self._stream_pending_frag
            self._stream_pending_frag = None
            self.fragments[frag].perform_sync()
        return False

    def _current_fragment(self) -> int:
        """All replicas must prepare/sync fragments in the same order to
        avoid cross-replica deadlock."""
        return self._manager.current_step() % len(self.fragments)

    def pre_step(self) -> contextlib.AbstractContextManager:
        """Guard the model against concurrent checkpoint reads while the
        inner optimizer mutates it.  A context manager, so the lock is
        released even when the inner step raises::

            with diloco.pre_step():
                ...inner optimizer step...
            diloco.step()
        """
        manager = self._manager

        @contextlib.contextmanager
        def _guard():
            manager.disallow_state_dict_read()
            try:
                yield
            finally:
                manager.allow_state_dict_read()

        return _guard()

    def streaming(self) -> bool:
        """True when the streamed scheduler is engaged (TORCHFT_STREAM_SYNC
        resolved against this cadence at construction)."""
        return self._stream_stall > 0

    def step(self) -> Optional[bool]:
        """Call after every inner optimizer step; returns the commit decision
        on sync steps, None otherwise.

        Streamed schedule (``TORCHFT_STREAM_SYNC``): the sync step does not
        block — the fragment's reduce_scatter → sharded update → allgather
        keeps draining on its background path while inner compute continues
        against pre-sync params, and the identical wire-format delta applies
        ``stall`` inner steps later at the bounded-staleness barrier (where
        the commit decision is returned).  The barrier position is a pure
        function of the cadence, so replicas stay bit-identical."""
        self._manager.allow_state_dict_read()
        self._local_step += 1

        committed: Optional[bool] = None
        if self._stream_pending_frag is not None and self._local_step >= self._stream_stall:
            # bounded-staleness barrier: resolve the streamed fragment
            # BEFORE this round's prepare can open a new quorum
            frag = self._stream_pending_frag
            self._stream_pending_frag = None
            logger.info(
                "Stream barrier fragment=%d step=%d manager_step=%d",
                frag, self._local_step, self._manager.current_step(),
            )
            committed = self.fragments[frag].perform_sync()

        if self._local_step == self._sync_every - self._fragment_sync_delay:
            # quorum + overlap the pseudogradient allreduce with the next τ
            # inner steps
            self._manager.start_quorum()
            fragment = self._current_fragment()
            logger.info("Preparing fragment=%d step=%d", fragment, self._local_step)
            self.fragments[fragment].prepare_sync(stream=self.streaming())
            if self._fragment_sync_delay > 0:
                return committed

        if self._local_step < self._sync_every:
            return committed

        assert self._local_step == self._sync_every, (
            f"local_step={self._local_step} overran sync_every={self._sync_every}"
        )
        fragment = self._current_fragment()
        if self.streaming():
            # the sync step streams: hand the fragment to the stall window
            # and keep training — perform_sync runs at the barrier above
            self._stream_pending_frag = fragment
            self._local_step = 0
            return committed
        logger.info(
            "Syncing fragment=%d step=%d manager_step=%d",
            fragment, self._local_step, self._manager.current_step(),
        )
        committed = self.fragments[fragment].perform_sync()
        self._local_step = 0
        return committed
