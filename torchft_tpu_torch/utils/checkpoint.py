"""Durable (disk) checkpointing for fault-tolerant jobs.

Live peer-to-peer healing covers *replica* loss; durable checkpoints cover
*job* loss, and per the reference's doctrine they must include the Manager's
own state so step counts stay consistent on restore
(``torchft/manager.py:158-160``, ``train_ddp.py:200-207``).  This helper
bundles user state + ``manager.state_dict()`` into one atomic step directory
(``step_<n>/state.tftc``) written by the port's ``save_pytree``: tensors
on the card are staged to host in chunks, through a pinned ring, as they
are written, and every array leaf comes back as a CPU tensor on load — the
caller's ``load_state_dict`` copies each into the live tensor on its
device, as a heal does.

Usage::

    if committed and manager.participating_rank() == 0:
        save_checkpoint(ckpt_dir, manager.current_step(),
                        {**save(), "torchft": manager.state_dict()})

    # on job restart
    step = latest_step(ckpt_dir)
    if step is not None:
        state = load_checkpoint(ckpt_dir, step)
        load(state)  # model.load_state_dict / opt.load_state_dict
        manager.load_state_dict(state["torchft"])

:func:`load_latest` falls back past torn or corrupt step dirs, but a step
dir written by the JAX package raises
:class:`~torchft_tpu_torch.checkpointing.serialization.ForeignSnapshotError`
rather than being skipped: restoring an older step, or nothing, in its place
would silently rewind the job.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import tempfile
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

from torchft_tpu_torch.checkpointing.serialization import (
    CHUNK_BYTES,
    ForeignSnapshotError,
    load_pytree,
    plan_pytree,
    save_pytree,
)

_STEP_RE = re.compile(r"^step_(\d+)$")


class ChunkDigest:
    """A content hash that scales with cores: the sha256 of the sequence
    of sha256 digests of every :data:`CHUNK_BYTES` chunk of the bytes given
    to :meth:`submit` (a chunk never spans two submissions; ``save_pytree``
    submits its staging chunks, of the same size), the chunks hashed in
    parallel.  Equal inputs in equal submissions give equal
    digests on any number of threads; one sha256 stream hashes ~1.1 GB/s
    on the host of an H100 machine, too slow for a multi-GB state on the
    save path.  Use it as a context manager: it owns its threads."""

    def __init__(self, workers: Optional[int] = None) -> None:
        self._pool = ThreadPoolExecutor(workers or min(8, os.cpu_count() or 1),
                                        thread_name_prefix="ckpt_digest")
        self._digests: List[Future] = []

    def submit(self, data: Any) -> List[Future]:
        """Queue ``data``'s chunks; returns their futures (``data`` must
        stay unchanged until they are done)."""
        view = memoryview(data).cast("B")
        futs = [self._pool.submit(_sha256, view[i:i + CHUNK_BYTES])
                for i in range(0, len(view), CHUNK_BYTES)]
        self._digests += futs
        return futs

    def hexdigest(self) -> str:
        return hashlib.sha256(b"".join(f.result() for f in self._digests)).hexdigest()

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "ChunkDigest":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _sha256(chunk: memoryview) -> bytes:
    return hashlib.sha256(chunk).digest()


def state_digest(state: Any) -> str:
    """:class:`ChunkDigest` of every array leaf of ``state``, in the order a
    checkpoint writes them (``save_pytree`` with no stream): what
    :func:`save_checkpoint` computes of what it writes, so a restored state
    is held to the saved one bit for bit."""
    with ChunkDigest() as digest:
        save_pytree(state, digest=digest)
        return digest.hexdigest()


class InsufficientSpaceError(OSError):
    """The checkpoint directory's filesystem has less free space than the
    snapshot needs; raised before anything is written."""


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step}")


def save_checkpoint(
    base_dir: str,
    step: int,
    state: Any,
    keep: int = 3,
    timings: Optional[dict] = None,
    digest: Optional[ChunkDigest] = None,
) -> str:
    """Atomically persist ``state`` for ``step``; prunes to ``keep`` newest.

    Raises :class:`InsufficientSpaceError` when the filesystem cannot hold
    the snapshot.  ``digest``, if given, takes every array leaf's bytes as
    they are written (so it ends as :func:`state_digest` of ``state``).
    ``timings``, if given, receives ``bytes`` and the busy seconds of the
    device-to-host copies (``host_copy_s``) and of the writes
    (``write_s``), which overlap each other and the digest (``save_pytree``),
    and of the fsyncs of the file and directory (``fsync_s``)."""
    os.makedirs(base_dir, exist_ok=True)
    nbytes = plan_pytree(state).total_len
    free = shutil.disk_usage(base_dir).free
    if free < nbytes:
        raise InsufficientSpaceError(
            f"checkpoint of step {step} needs {nbytes} bytes, but {base_dir} has {free} free"
        )
    final = _step_dir(base_dir, step)
    tmp = tempfile.mkdtemp(prefix=f".step_{step}_", dir=base_dir)
    fsync_s = 0.0
    try:
        with open(os.path.join(tmp, "state.tftc"), "wb") as f:
            busy = save_pytree(state, f, digest)
            # durable means surviving power loss: flush the file and the
            # directory entries before the rename is considered committed
            t0 = time.perf_counter()
            f.flush()
            os.fsync(f.fileno())
            fsync_s += time.perf_counter() - t0
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on the same filesystem
        t0 = time.perf_counter()
        dir_fd = os.open(base_dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        fsync_s += time.perf_counter() - t0
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if timings is not None:
        timings.update(busy, bytes=nbytes, fsync_s=fsync_s)

    if keep > 0:
        steps = sorted(_all_steps(base_dir))
        for old in steps[:-keep]:
            shutil.rmtree(_step_dir(base_dir, old), ignore_errors=True)
    return final


def _all_steps(base_dir: str) -> list:
    out = []
    try:
        entries = os.listdir(base_dir)
    except FileNotFoundError:
        return out
    for entry in entries:
        match = _STEP_RE.match(entry)
        if match and os.path.exists(
            os.path.join(base_dir, entry, "state.tftc")
        ):
            out.append(int(match.group(1)))
    return out


def latest_step(base_dir: str) -> Optional[int]:
    steps = _all_steps(base_dir)
    return max(steps) if steps else None


def load_checkpoint(base_dir: str, step: int) -> Any:
    """The state saved for ``step``, every array leaf a CPU tensor."""
    with open(os.path.join(_step_dir(base_dir, step), "state.tftc"), "rb") as f:
        return load_pytree(f)


def load_latest(base_dir: str) -> Optional[tuple]:
    """(step, state) of the newest *readable* checkpoint; None when nothing
    restorable exists.  A step dir whose load raises any ``Exception`` is
    torn or corrupt and skipped for the next older one, as the JAX
    package's ``load_latest`` does: a truncated file, and a damaged
    skeleton, which can fail as anything from ``UnpicklingError`` to
    ``ModuleNotFoundError``.  One refusal passes through:
    :class:`ForeignSnapshotError`, a step dir the JAX package wrote, which
    is readable but not the port's to restore."""
    for step in sorted(_all_steps(base_dir), reverse=True):
        try:
            return step, load_checkpoint(base_dir, step)
        except ForeignSnapshotError:
            raise
        except Exception:  # noqa: BLE001 — torn or corrupt; try the next older
            continue
    return None
