"""BabyCommunicator: the data plane in a killable subprocess.

Twin of the reference's Baby process groups
(``torchft/process_group.py:1356-2118``): the real communicator runs in a
**spawned subprocess**, so comms wedged beyond what ``abort()`` can unblock
(kernel-stuck sockets, a hung native runtime) are recovered by killing the
child — the training process survives.  Requests travel over a command pipe;
results return over a future pipe serviced by a listener thread
(``process_group.py:1697-1730``).

The port of ``torchft_tpu/baby.py``.  Differences from the reference: no
CUDA stream replication is needed (the data plane is host numpy: the
gradient buckets reach it in host memory).  Array payloads at or above
``TORCHFT_BABY_SHM_MIN`` bytes (default 256 KiB) cross the process
boundary through **shared memory** — the pipe carries only a segment name
plus dtype/shape metadata, mirroring the reference's move-to-shm before
the pickle hop (``torchft/process_group.py:1425-1436``) — so the
isolation tier works at multi-GB gradient scale.  Small payloads and
byte-blob ops still pickle (the copy is cheaper than an arena round-trip).

In the port the arenas' metadata carries each array's ``np.dtype`` itself,
not its ``dtype.str``: a bf16 bucket is a :data:`~torchft_tpu_torch.bf16.BF16`
array, a structured dtype whose ``str`` (``|V2``) would reach the child as
raw void bytes.  ``backend="cpp"`` runs the port's own C++ runtime
(:mod:`torchft_tpu_torch.native`).  :meth:`BabyCommunicator.stats` counts
the ops each path carried, the largest arena and the children spawned.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import os
import threading
from concurrent.futures import Future
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from torchft_tpu_torch.communicator import (
    Buffers,
    Communicator,
    CommunicatorAborted,
    CommunicatorError,
    ReduceOp,
)
from torchft_tpu_torch.multiprocessing import MonitoredPipe
from torchft_tpu_torch.work import Work

logger = logging.getLogger(__name__)

# arrays at/above this ship via shared memory instead of pickle
_SHM_MIN = int(os.environ.get("TORCHFT_BABY_SHM_MIN", str(256 << 10)))
_ALIGN = 64


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


# (dtype, shape, byte offset into the arena)
_Meta = Tuple[np.dtype, Tuple[int, ...], int]


def _pack_metas(arrays: List[np.ndarray]) -> Tuple[List[_Meta], int]:
    metas: List[_Meta] = []
    off = 0
    for a in arrays:
        metas.append((a.dtype, tuple(a.shape), off))
        off += _aligned(a.nbytes)
    return metas, off


def _copy(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[...] = src`` (same byte size): a byte copy where both are
    contiguous.  numpy copies a structured dtype (the port's bf16) field by
    field, ~25x slower than memcpy and holding the GIL."""
    if dst.flags.c_contiguous and src.flags.c_contiguous and dst.nbytes == src.nbytes:
        dst.reshape(-1).view(np.uint8)[:] = src.reshape(-1).view(np.uint8)
    else:
        np.copyto(dst, src.reshape(dst.shape))


def _fresh(src: np.ndarray) -> np.ndarray:
    out = np.empty(src.shape, src.dtype)
    _copy(out, src)
    return out


def _views(buf: memoryview, metas: List[_Meta]) -> List[np.ndarray]:
    out = []
    for dtype, shape, off in metas:
        dt = np.dtype(dtype)
        n = int(np.prod(shape, dtype=np.int64))
        out.append(
            np.frombuffer(buf, dtype=dt, count=n, offset=off).reshape(shape)
        )
    return out


class _ShmAttachCache:
    """Child-side attachment cache: arenas are reused across ops, so attach
    once per name.

    The parent owns each segment's lifecycle.  A spawned child shares the
    parent's resource tracker, so its attach registers a name the tracker
    already holds (a no-op) and it must not unregister it: that would drop
    the parent's registration, and the parent's unlink would then make the
    tracker print a ``KeyError`` traceback for every arena (the JAX
    package's child unregisters, cpython #82300; ROADMAP §C17).
    """

    def __init__(self) -> None:
        self._cache: Dict[str, shared_memory.SharedMemory] = {}

    def get(self, name: str) -> shared_memory.SharedMemory:
        shm = self._cache.get(name)
        if shm is None:
            shm = shared_memory.SharedMemory(name=name)
            self._cache[name] = shm
        return shm

    def close(self) -> None:
        for shm in self._cache.values():
            try:
                shm.close()
            except (OSError, BufferError):
                # BufferError: numpy views of shm.buf created in the worker
                # loop may still be alive at shutdown; the mapping dies with
                # the process either way
                pass
        self._cache.clear()


def _worker_main(cmd_pipe, out_pipe, backend: str, timeout_s: float) -> None:
    """Child process: owns the real communicator, executes shipped ops."""
    try:
        if backend == "cpp":
            from torchft_tpu_torch.native import CppCommunicator

            comm: Communicator = CppCommunicator(timeout_s=timeout_s)
        else:
            from torchft_tpu_torch.communicator import TCPCommunicator

            comm = TCPCommunicator(timeout_s=timeout_s)
    except Exception as e:  # noqa: BLE001
        out_pipe.send((-1, RuntimeError(f"baby worker init failed: {e}")))
        return

    shms = _ShmAttachCache()
    while True:
        try:
            msg = cmd_pipe.recv()
        except (EOFError, OSError):
            break
        if msg is None:
            break
        op_id, op, args = msg
        try:
            if op == "configure":
                comm.configure(**args)
                result = None
            elif op in ("allreduce_shm", "broadcast_shm"):
                # payload lives in the parent's arena: operate on views
                # in-place so results land back in the same segment and the
                # reply is metadata only
                shm = shms.get(args["shm"])
                views = _views(shm.buf, args["metas"])
                if op == "allreduce_shm":
                    got = comm.allreduce(
                        views, args["op"], in_place=True
                    ).wait(timeout=timeout_s)
                else:
                    got = comm.broadcast(views, args["root"]).wait(
                        timeout=timeout_s
                    )
                if isinstance(got, np.ndarray):
                    got = [got]
                for view, res in zip(views, got):
                    if res is not view:
                        _copy(view, np.asarray(res))
                result = {"shm": args["shm"]}
            elif op == "reduce_scatter_shm":
                shm = shms.get(args["shm"])
                (view,) = _views(shm.buf, args["metas"])
                shard = comm.reduce_scatter(view, args["op"]).wait(
                    timeout=timeout_s
                )
                shard = np.asarray(shard)
                # the shard is smaller than the input: write it at offset 0
                flat = np.frombuffer(
                    shm.buf, dtype=shard.dtype, count=shard.size
                )
                _copy(flat, shard)
                result = {
                    "shm": args["shm"],
                    "meta": (shard.dtype, tuple(shard.shape), 0),
                }
            elif op == "allreduce":
                result = comm.allreduce(args["buffers"], args["op"]).wait(
                    timeout=timeout_s
                )
            elif op == "broadcast":
                result = comm.broadcast(args["buffers"], args["root"]).wait(
                    timeout=timeout_s
                )
            elif op == "send_bytes":
                result = comm.send_bytes(args["data"], args["dst"], args["tag"]).wait(
                    timeout=timeout_s
                )
            elif op == "send_bytes_shm":
                shm = shms.get(args["shm"])
                view = np.frombuffer(shm.buf, np.uint8, count=args["n"])
                result = comm.send_bytes(view, args["dst"], args["tag"]).wait(
                    timeout=timeout_s
                )
            elif op == "recv_bytes":
                result = comm.recv_bytes(args["src"], args["tag"]).wait(
                    timeout=timeout_s
                )
            elif op == "recv_bytes_shm":
                shm = shms.get(args["shm"])
                view = np.frombuffer(shm.buf, np.uint8, count=args["cap"])
                n = comm.recv_bytes_into(args["src"], view, args["tag"]).wait(
                    timeout=timeout_s
                )
                result = {"shm": args["shm"], "n": n}
            elif op == "reduce_scatter":
                result = comm.reduce_scatter(args["data"], args["op"]).wait(
                    timeout=timeout_s
                )
            elif op == "barrier":
                result = comm.barrier().wait(timeout=timeout_s)
            else:
                raise CommunicatorError(f"unknown baby op {op}")
            out_pipe.send((op_id, result))
        except Exception as e:  # noqa: BLE001 — ship to the parent
            # preserve the framework's error types across the pipe so the
            # caller's handling doesn't depend on payload size (the shm
            # paths raise in the child, the pickle paths in the parent)
            if isinstance(e, (CommunicatorError, CommunicatorAborted)):
                shipped: Exception = e
            else:
                shipped = RuntimeError(str(e))
            try:
                out_pipe.send((op_id, shipped))
            except (OSError, ValueError):
                break
    shms.close()
    comm.shutdown()


class _ArenaPool:
    """Parent-side shared-memory arenas, reused across ops.

    Sizes round up to powers of two so a steady training loop (same bucket
    sizes every step) allocates once and recycles; the parent owns unlink.
    """

    def __init__(self) -> None:
        self._free: Dict[int, List[shared_memory.SharedMemory]] = {}
        self._lock = threading.Lock()
        self._live: Dict[str, shared_memory.SharedMemory] = {}
        self._destroyed = False
        self.largest = 0  # bytes of the largest arena created

    @property
    def destroyed(self) -> bool:
        return self._destroyed

    def acquire(self, nbytes: int) -> shared_memory.SharedMemory:
        size = 1 << max(12, (nbytes - 1).bit_length())
        with self._lock:
            if self._destroyed:
                # a straggler op racing past shutdown() would otherwise
                # create a fresh segment nothing ever unlinks
                raise CommunicatorAborted("shutdown")
            bucket = self._free.get(size)
            if bucket:
                return bucket.pop()
        shm = shared_memory.SharedMemory(create=True, size=size)
        with self._lock:
            if self._destroyed:
                shm.close()
                shm.unlink()
                raise CommunicatorAborted("shutdown")
            self._live[shm.name] = shm
            self.largest = max(self.largest, size)
        return shm

    def release(self, shm: shared_memory.SharedMemory) -> None:
        with self._lock:
            if shm.name not in self._live:
                return  # destroyed concurrently (abort path)
            self._free.setdefault(shm.size, []).append(shm)

    def destroy(self) -> None:
        with self._lock:
            self._destroyed = True
            live = list(self._live.values())
            self._live.clear()
            self._free.clear()
        for shm in live:
            # unlink FIRST: it always succeeds and frees the name even while
            # a landing callback still holds a numpy view over shm.buf —
            # close() would raise BufferError ('cannot close exported
            # pointers exist') in exactly that shutdown race
            try:
                shm.unlink()
            except OSError:  # pragma: no cover - already gone
                pass
            try:
                shm.close()
            except (OSError, BufferError):
                pass


class BabyCommunicator(Communicator):
    """Runs a TCP or C++ communicator inside a spawned subprocess.

    ``abort()`` escalates to killing the child (the whole point: recovery
    from wedges no in-process abort can reach); the next ``configure()``
    respawns it.
    """

    def __init__(self, timeout_s: float = 60.0, backend: str = "tcp") -> None:
        self._timeout_s = timeout_s
        self._backend = backend
        self._ctx = mp.get_context("spawn")
        self._proc: Optional[mp.process.BaseProcess] = None
        self._cmd: Optional[MonitoredPipe] = None
        self._futures: Dict[int, Future] = {}
        self._lock = threading.Lock()
        self._next_op = 0
        self._rank = 0
        self._world_size = 1
        self._errored: Optional[Exception] = None
        self._arenas = _ArenaPool()
        # data ops by path, and every child's pid, for stats()
        self._ops = {"shm": 0, "pickled": 0}
        self._largest_shm_op: Dict[str, int] = {}  # payload bytes, by op
        self._child_pids: List[int] = []
        self._largest_arena = 0

    # -- child lifecycle ----------------------------------------------------

    def _spawn(self) -> None:
        parent_cmd, child_cmd = self._ctx.Pipe()
        child_out, parent_out = self._ctx.Pipe(duplex=False)
        self._proc = self._ctx.Process(
            target=_worker_main,
            args=(child_cmd, parent_out, self._backend, self._timeout_s),
            daemon=True,
        )
        self._proc.start()
        with self._lock:
            self._child_pids.append(self._proc.pid)
        child_cmd.close()
        parent_out.close()
        self._cmd = MonitoredPipe(parent_cmd)
        out = MonitoredPipe(child_out)
        threading.Thread(
            target=self._listen,
            args=(out, self._proc),
            name="tpuft_baby_listener",
            daemon=True,
        ).start()

    def _listen(self, out: MonitoredPipe, proc) -> None:
        """Deliver results from the child to waiting futures
        (``process_group.py:1697-1730``)."""
        while True:
            try:
                op_id, result = out.recv(timeout=60.0)
            except TimeoutError:
                # idle pipe is NOT death — a healthy communicator can sit
                # quiet between steps indefinitely
                if proc.is_alive():
                    continue
                self._fail_all("baby communicator child died")
                return
            except (EOFError, OSError):
                self._fail_all("baby communicator child died")
                return
            if op_id == -1:
                # child init failure: surface the real cause everywhere
                err = (
                    result
                    if isinstance(result, Exception)
                    else RuntimeError(str(result))
                )
                # first-error-wins must be atomic: the caller thread resets
                # _errored at epoch boundaries, so an unlocked `x = x or e`
                # here could resurrect a cleared error or drop this one
                with self._lock:
                    self._errored = self._errored or err
                self._fail_all(str(err))
                return
            with self._lock:
                fut = self._futures.pop(op_id, None)
            if fut is None:
                continue
            if isinstance(result, Exception):
                with self._lock:  # same first-error-wins atomicity as above
                    self._errored = self._errored or result
                fut.set_exception(result)
            else:
                fut.set_result(result)

    def _fail_all(self, reason: str) -> None:
        with self._lock:
            futures = list(self._futures.values())
            self._futures.clear()
        for fut in futures:
            if not fut.done():
                fut.set_exception(CommunicatorAborted(reason))

    def _submit(self, op: str, args: dict) -> Work:
        with self._lock:
            if self._errored is not None:
                fut: Future = Future()
                fut.set_exception(self._errored)
                return Work(fut)
            if self._cmd is None:
                fut = Future()
                fut.set_exception(CommunicatorError("not configured"))
                return Work(fut)
            op_id = self._next_op
            self._next_op += 1
            fut = Future()
            self._futures[op_id] = fut
            try:
                # The pipe write must stay ordered with op-id allocation
                # (the baby matches ops to futures by arrival order);
                # commands are tens of bytes, so the pipe buffer only fills
                # if the baby is already dead, and abort() severs the pipe.
                # ftlint: ignore[blocking-under-lock] — ordered tiny pipe write
                self._cmd.send((op_id, op, args))
            except (OSError, ValueError) as e:
                self._futures.pop(op_id, None)
                fut.set_exception(CommunicatorError(f"baby pipe send failed: {e}"))
        return Work(fut)

    def _count(self, path: str, op: str = "", nbytes: int = 0) -> None:
        with self._lock:
            self._ops[path] += 1
            if path == "shm":
                self._largest_shm_op[op] = max(self._largest_shm_op.get(op, 0), nbytes)

    def stats(self) -> Dict[str, object]:
        """Data ops carried through shared memory (``shm_ops``) and
        pickled over the pipe (``pickled_ops``), the largest payload of
        each shared-memory op and the largest arena, in bytes, the pid of
        every child spawned so far (one per ``configure``) and the live
        child's (None when there is none)."""
        with self._lock:
            proc = self._proc
            return {
                "shm_ops": self._ops["shm"],
                "pickled_ops": self._ops["pickled"],
                "largest_shm_op_bytes": dict(self._largest_shm_op),
                "largest_arena_bytes": max(self._largest_arena, self._arenas.largest),
                "child_pids": list(self._child_pids),
                "live_pid": proc.pid if proc is not None else None,
            }

    # -- Communicator surface -----------------------------------------------

    def configure(
        self,
        store_addr: str,
        replica_id: str,
        rank: int,
        world_size: int,
        quorum_id: int = 0,
        group_rank: int = 0,
        group_world_size: int = 1,
        global_ranks: Sequence[int] = (),
    ) -> None:
        self.abort("superseded by reconfigure")
        with self._lock:
            self._errored = None
            if self._arenas.destroyed:
                # a shutdown()-then-configure() revival must not inherit the
                # destroyed flag: _guard_landing would misreport every later
                # genuine landing error as CommunicatorAborted
                self._largest_arena = max(self._largest_arena, self._arenas.largest)
                self._arenas = _ArenaPool()
        self._spawn()
        self._rank = rank
        self._world_size = world_size
        work = self._submit(
            "configure",
            dict(store_addr=store_addr, replica_id=replica_id, rank=rank, world_size=world_size),
        )
        err = work.exception(timeout=self._timeout_s + 10.0)
        if err is not None:
            raise CommunicatorError(f"baby configure failed: {err}") from err

    @staticmethod
    def _as_list(buffers: Buffers) -> Tuple[List[np.ndarray], bool]:
        """(array list, was-a-single-ndarray) — the Communicator contract
        returns a bare ndarray for bare-ndarray input."""
        if isinstance(buffers, np.ndarray):
            return [buffers], True
        return [np.asarray(b) for b in buffers], False

    def _shm_arrays_op(
        self,
        op: str,
        arrays: List[np.ndarray],
        extra: dict,
        in_place: bool,
        single: bool,
    ) -> Work:
        """Ship array payloads through a shared-memory arena: the pipe
        carries only (segment name, metas); the child reduces in-place in
        the segment; results land back into the caller's buffers (in_place)
        or fresh copies."""
        metas, total = _pack_metas(arrays)
        self._count("shm", op, sum(a.nbytes for a in arrays))
        pool = self._arenas
        try:
            shm = pool.acquire(total)
            for a, view in zip(arrays, _views(shm.buf, metas)):
                _copy(view, a)
        except (ValueError, TypeError, OSError) as exc:
            self._raise_if_destroyed(pool, exc)
            raise
        work = self._submit(op, dict(shm=shm.name, metas=metas, **extra))

        release_once = self._release_once(pool, shm)

        def _land(result: object):
            if isinstance(result, dict) and "meta" in result:
                # reduce_scatter: the child re-described the (smaller) shard
                (out,) = _views(shm.buf, [result["meta"]])
                out = _fresh(out)
                release_once()
                return out
            views = _views(shm.buf, metas)
            if in_place:
                for a, v in zip(arrays, views):
                    _copy(a, v)
                out_list = arrays
            else:
                out_list = [_fresh(v) for v in views]
            # release BEFORE the result is delivered: a waiter that submits
            # its next op the instant wait() returns must find this arena in
            # the free list (done-callbacks run after waiters wake)
            release_once()
            return out_list[0] if single else out_list

        landed = work.then(self._guard_landing(pool, _land))
        # failure path (and belt-and-braces): never leak the arena
        landed.future().add_done_callback(lambda _f: release_once())
        return landed

    def _guard_landing(self, pool: _ArenaPool, fn: Callable) -> Callable:
        """Wrap a shm-landing callback: a result racing ``shutdown()`` can
        find the arena pool already destroyed, and ``_views`` on a
        closed/unlinked mapping raises an opaque ValueError — surface the
        abort the shutdown intended instead.

        The caller passes the pool its op actually acquired from: a
        concurrent shutdown-then-configure swaps ``self._arenas`` for a
        fresh pool, and re-reading the live attribute here would see
        ``destroyed=False`` and leak the raw ValueError."""

        def _wrapped(result):
            try:
                return fn(result)
            except (ValueError, TypeError, OSError) as exc:
                self._raise_if_destroyed(pool, exc)
                raise

        return _wrapped

    def _raise_if_destroyed(self, pool: _ArenaPool, exc: BaseException) -> None:
        """Map an shm-access error racing ``shutdown()`` to the abort it
        really is.  ValueError: released memoryview (mid-destroy window);
        TypeError: ``shm.buf`` is None after ``close()`` completed;
        OSError: unlinked mapping."""
        if pool.destroyed:
            reason = str(self._errored) if self._errored else "shutdown"
            raise CommunicatorAborted(reason) from exc

    def _release_once(self, pool: _ArenaPool, shm) -> Callable[[], None]:
        """Release against the pool the op ACQUIRED from (same invariant as
        :meth:`_guard_landing`): after a shutdown-then-configure pool swap,
        releasing a stale segment into the fresh pool could recycle an
        unlinked mapping under a name the kernel has since reused."""
        released = threading.Event()

        def _release() -> None:
            if not released.is_set():
                released.set()
                pool.release(shm)

        return _release

    def allreduce(
        self,
        buffers: Buffers,
        op: ReduceOp = ReduceOp.SUM,
        in_place: bool = False,
    ) -> Work:
        arrays, single = self._as_list(buffers)
        if sum(a.nbytes for a in arrays) >= _SHM_MIN:
            return self._shm_arrays_op(
                "allreduce_shm", arrays, dict(op=op), in_place, single
            )
        # small payloads: the pickle copy is cheaper than an arena trip.
        # in_place must mean the same thing at every size: land the
        # pickled results back in the caller's buffers
        self._count("pickled")
        work = self._submit("allreduce", dict(buffers=buffers, op=op))
        if not in_place:
            return work

        def _land_in_place(result):
            out = [result] if isinstance(result, np.ndarray) else result
            for a, r in zip(arrays, out):
                np.copyto(a, np.asarray(r).reshape(a.shape))
            return arrays[0] if single else arrays

        return work.then(_land_in_place)

    def broadcast(self, buffers: Buffers, root: int = 0) -> Work:
        arrays, single = self._as_list(buffers)
        if sum(a.nbytes for a in arrays) >= _SHM_MIN:
            # fresh copies, like the direct tiers (a non-root caller's
            # input must not be silently overwritten)
            return self._shm_arrays_op(
                "broadcast_shm",
                arrays,
                dict(root=root),
                in_place=False,
                single=single,
            )
        self._count("pickled")
        return self._submit("broadcast", dict(buffers=buffers, root=root))

    def reduce_scatter(self, data: np.ndarray, op: ReduceOp = ReduceOp.SUM) -> Work:
        arr = np.asarray(data)
        if arr.nbytes >= _SHM_MIN:
            return self._shm_arrays_op(
                "reduce_scatter_shm",
                [arr],
                dict(op=op),
                in_place=False,
                single=True,
            )
        self._count("pickled")
        return self._submit("reduce_scatter", dict(data=data, op=op))

    def send_bytes(self, data, dst: int, tag: int = 0) -> Work:
        if isinstance(data, bytes):
            view = data
        elif isinstance(data, np.ndarray):
            view = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
        else:
            try:
                view = memoryview(data).cast("B")
            except (ValueError, TypeError):
                view = bytes(data)  # non-contiguous buffer-likes
        n = len(view)
        if n >= _SHM_MIN:
            self._count("shm", "send_bytes_shm", n)
            pool = self._arenas
            try:
                shm = pool.acquire(n)
                np.frombuffer(shm.buf, np.uint8, count=n)[:] = np.frombuffer(
                    view, dtype=np.uint8
                )
            except (ValueError, TypeError, OSError) as exc:
                self._raise_if_destroyed(pool, exc)
                raise
            work = self._submit(
                "send_bytes_shm", dict(shm=shm.name, n=n, dst=dst, tag=tag)
            )
            work.future().add_done_callback(
                lambda _f: pool.release(shm)
            )
            return work
        if not isinstance(view, bytes):
            view = bytes(view)
        self._count("pickled")
        return self._submit("send_bytes", dict(data=view, dst=dst, tag=tag))

    def recv_bytes(self, src: int, tag: int = 0) -> Work:
        self._count("pickled")
        return self._submit("recv_bytes", dict(src=src, tag=tag))

    def recv_bytes_into(self, src: int, out, tag: int = 0) -> Work:
        if out.nbytes >= _SHM_MIN:
            # the child receives straight into the shared segment; the
            # parent pays one copy into the caller's buffer (the pickle
            # path pays serialize + deserialize + copy)
            self._count("shm", "recv_bytes_shm", out.nbytes)
            pool = self._arenas
            shm = pool.acquire(out.nbytes)
            release_once = self._release_once(pool, shm)
            work = self._submit(
                "recv_bytes_shm",
                dict(shm=shm.name, cap=out.nbytes, src=src, tag=tag),
            )

            def _land_shm(result: dict) -> int:
                n = result["n"]
                out.reshape(-1).view(np.uint8)[:n] = np.frombuffer(
                    shm.buf, np.uint8, count=n
                )
                release_once()
                return n

            landed = work.then(self._guard_landing(pool, _land_shm))
            landed.future().add_done_callback(lambda _f: release_once())
            return landed
        self._count("pickled")
        work = self._submit("recv_bytes", dict(src=src, tag=tag))

        def _land(blob: object) -> int:
            data = memoryview(blob)  # type: ignore[arg-type]
            if len(data) > out.nbytes:
                raise CommunicatorError(
                    f"recv buffer too small: payload {len(data)} > cap {out.nbytes}"
                )
            out.reshape(-1).view(np.uint8)[: len(data)] = np.frombuffer(
                data, dtype=np.uint8
            )
            return len(data)

        return work.then(_land)

    def barrier(self) -> Work:
        return self._submit("barrier", dict())

    def abort(self, reason: str = "aborted") -> None:
        """Kill the child — recovery even from wedges abort can't unblock."""
        with self._lock:
            proc, self._proc = self._proc, None
            cmd, self._cmd = self._cmd, None
            if self._errored is None and proc is not None:
                self._errored = CommunicatorAborted(reason)
            futures = list(self._futures.values())
            self._futures.clear()
        if cmd is not None:
            cmd.close()
        if proc is not None:
            proc.terminate()
            proc.join(timeout=5.0)
            if proc.is_alive():
                proc.kill()
        for fut in futures:
            if not fut.done():
                fut.set_exception(CommunicatorAborted(reason))

    def errored(self) -> Optional[Exception]:
        return self._errored

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._world_size

    def set_timeout(self, timeout_s: float) -> None:
        self._timeout_s = timeout_s

    def shutdown(self) -> None:
        self.abort("shutdown")
        self._arenas.destroy()
