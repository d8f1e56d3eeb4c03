"""ctypes bindings for the port's C++ runtime (``csrc/native/``).

The port's copy of ``torchft_tpu/native.py``.  The C++ servers speak the
exact wire protocol of the Python implementations, so the Python clients
(``RpcClient`` subclasses) work against either, and a rank of either
package, on either tier, shares one ring with the others — the classes here
mirror the Python servers' construction surface and are drop-in
replacements.

The library is built from the port's own sources, ``csrc/native/*.{h,cc}``,
by ``g++`` at first use (never at import) into
``build/torchft_tpu_torch/libtpuft_torch-<hash>.so`` at the repository
root, keyed on the sources, the flags and the CPU that ``-march=native``
resolves to.  A file lock in that directory lets one process build while
the others wait.  If the toolchain or build fails, ``available()`` returns
False and ``tier``'s ``auto`` falls back to the pure-Python
implementations; constructing a C++ class then raises with the build error.

The library is loaded ``RTLD_LOCAL`` (ctypes' default) under its own file
name, so it binds its own symbols even in a process that also loads the
JAX package's ``libtpuft.so``; each copy then keeps its own state, the
``TORCHFT_NET_EMU`` link bucket included (one bucket per library, not per
process).  The host quantization entry points of the JAX package's library
are left out: the port's quantized wire reduces with numpy
(``quantization.py``).

Host buffers are numpy arrays or CPU torch tensors.  bf16 is the port's
:data:`bf16.BF16` (dtype code 4 on the wire, as ml_dtypes' bfloat16 is for
the JAX package); a CUDA tensor is refused, never copied to the host
quietly.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import queue
import subprocess
import threading
from concurrent.futures import Future
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch import bf16
from torchft_tpu_torch.communicator import (
    Buffers,
    Communicator,
    CommunicatorAborted,
    CommunicatorError,
    ReduceOp,
    _avg_in_place,
    closing_parts,
)
from torchft_tpu_torch.futures import TimerHandle, schedule_timeout
from torchft_tpu_torch.obs.flight import FlightEvent, FlightRecorder
from torchft_tpu_torch.obs.spans import span as obs_span
from torchft_tpu_torch.ops.cuda_build import BUILD_DIR
from torchft_tpu_torch.work import Work

logger = logging.getLogger(__name__)

SOURCE_DIR = Path(__file__).resolve().parent / "csrc" / "native"
LIB_NAME = "libtpuft_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-march=native", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None
_lib_lock = threading.Lock()

_DTYPE_CODES = {
    "float32": 0,
    "float64": 1,
    "int32": 2,
    "int64": 3,
    "uint8": 5,
    "int8": 6,
}
_BF16_CODE = 4
_OP_CODES = {ReduceOp.SUM: 0, ReduceOp.AVG: 0, ReduceOp.MAX: 1, ReduceOp.MIN: 2}


def _cpu_target() -> str:
    """The ``-march`` that ``-march=native`` resolves to on this host, so a
    library built for one CPU is never loaded on another."""
    out = subprocess.run(
        ["g++", "-march=native", "-Q", "--help=target"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return " ".join(
        line.split()[-1] for line in out.splitlines() if line.strip().startswith("-march=")
    )


def _artifact() -> Path:
    """Build path of the library, keyed on every source, the flags and the
    CPU target."""
    digest = hashlib.sha256()
    for src in sorted(SOURCE_DIR.iterdir()):
        if src.suffix in (".h", ".cc"):
            digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode() + b"\0" + _cpu_target().encode())
    return BUILD_DIR / f"{LIB_NAME}-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built, and return its path.  One
    process builds while the others wait on a lock in the build directory;
    the artifact appears atomically.  Raises with g++'s output on failure."""
    out = _artifact()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{LIB_NAME}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, str(SOURCE_DIR / "api.cc"), "-o", str(tmp)]
        logger.info("building the native runtime: %s", " ".join(cmd))
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed for {SOURCE_DIR / 'api.cc'} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_error
    with _lib_lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            path = build()
            lib = ctypes.CDLL(str(path))  # RTLD_LOCAL: binds its own symbols
        except Exception as e:  # noqa: BLE001
            _lib_error = str(e)
            logger.warning("native runtime unavailable: %s", e)
            return None

        lib.tpuft_last_error.restype = ctypes.c_char_p
        lib.tpuft_store_new.restype = ctypes.c_void_p
        lib.tpuft_store_new.argtypes = [ctypes.c_char_p]
        lib.tpuft_store_port.argtypes = [ctypes.c_void_p]
        lib.tpuft_store_free.argtypes = [ctypes.c_void_p]
        lib.tpuft_lighthouse_new.restype = ctypes.c_void_p
        lib.tpuft_lighthouse_new.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        lib.tpuft_lighthouse_port.argtypes = [ctypes.c_void_p]
        lib.tpuft_lighthouse_free.argtypes = [ctypes.c_void_p]
        lib.tpuft_manager_new.restype = ctypes.c_void_p
        lib.tpuft_manager_new.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_int64,
        ]
        lib.tpuft_manager_port.argtypes = [ctypes.c_void_p]
        lib.tpuft_manager_free.argtypes = [ctypes.c_void_p]
        lib.tpuft_comm_new.restype = ctypes.c_void_p
        lib.tpuft_comm_new.argtypes = [ctypes.c_double]
        lib.tpuft_comm_configure.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.tpuft_comm_allreduce.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.tpuft_comm_allreduce_iov.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.tpuft_comm_alltoall_ptrs.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        lib.tpuft_comm_lane_stats.restype = ctypes.c_uint64
        lib.tpuft_comm_lane_stats.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tpuft_comm_reduce_scatter.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tpuft_comm_broadcast.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_int64,
        ]
        lib.tpuft_comm_send.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_int64,
            ctypes.c_uint64,
        ]
        lib.tpuft_comm_send_part.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_int64,
            ctypes.c_uint64,
            ctypes.c_uint64,
            ctypes.c_int,
        ]
        lib.tpuft_comm_recv_alloc.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tpuft_buffer_free.argtypes = [ctypes.c_void_p]
        lib.tpuft_comm_recv_into.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_uint64,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.tpuft_comm_alltoall.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        lib.tpuft_comm_allgather.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_uint64,
        ]
        lib.tpuft_comm_flight_drain.restype = ctypes.c_uint64
        lib.tpuft_comm_flight_drain.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_uint64,
        ]
        lib.tpuft_comm_barrier.argtypes = [ctypes.c_void_p]
        lib.tpuft_comm_abort.argtypes = [ctypes.c_void_p]
        lib.tpuft_comm_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    """The loaded library; raises with the build or load error otherwise
    (an explicit C++ tier never falls back quietly)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_lib_error}")
    return lib


def _dtype_code(arr: np.ndarray) -> Optional[int]:
    """The library's dtype code of a host array: :data:`bf16.BF16` is bf16;
    a plain ``uint16`` array is not (the library has no 16-bit integer
    reduce)."""
    if bf16.is_bf16(arr):
        return _BF16_CODE
    return _DTYPE_CODES.get(arr.dtype.name)


def _data_ptr(arr: np.ndarray) -> ctypes.c_void_p:
    """C pointer to a contiguous array's data."""
    return arr.ctypes.data_as(ctypes.c_void_p)


def as_host_array(data) -> np.ndarray:
    """Zero-copy numpy view of any host buffer.  numpy arrays pass through;
    a CPU torch tensor comes back as a view of its memory (bf16 as
    :data:`bf16.BF16`, which ``np.from_dlpack`` and ``np.asarray`` cannot
    give), pinned memory included; buffer-protocol objects (bytes,
    bytearray, memoryview) come back as uint8 views, and other
    dlpack-capable sources via ``np.from_dlpack``.  A CUDA tensor raises:
    the caller copies it to the host, never this function.  Only objects
    that support none of those are copied (``np.asarray`` fallback).  The
    native data plane reads frames straight out of (and, for writable
    views, lands receives straight into) the returned array's memory."""
    if isinstance(data, np.ndarray):
        return data
    if isinstance(data, torch.Tensor):
        if data.device.type != "cpu":
            raise CommunicatorError(
                f"the C++ tier takes host buffers; got a tensor on {data.device} "
                "(copy it to pinned host memory first)"
            )
        t = data.detach()
        return bf16.from_tensor(t) if t.dtype == torch.bfloat16 else t.numpy()
    if hasattr(data, "__dlpack__"):
        try:
            return np.from_dlpack(data)
        except (TypeError, AttributeError, RuntimeError, BufferError):
            pass
    try:
        # buffer protocol: bytes-like objects keep their exact bytes
        return np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    except TypeError:
        return np.asarray(data)


def _buffer_ptr(data) -> Tuple[ctypes.c_void_p, int, object]:
    """(pointer, nbytes, keepalive) into any contiguous host buffer with NO
    copy.  ``keepalive`` is the object that actually backs the pointer; the
    caller must pin it until the op is done (it is ``data`` itself unless a
    contiguity copy was required)."""
    arr = as_host_array(data)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    return _data_ptr(arr), int(arr.nbytes), (arr, data)


def _last_error(lib: ctypes.CDLL) -> str:
    return lib.tpuft_last_error().decode("utf-8", "replace")


# ---------------------------------------------------------------------------
# server wrappers (drop-in for the Python servers)
# ---------------------------------------------------------------------------


class CppStoreServer:
    """The C++ key-value store server (``csrc/native/store.h``), drop-in
    behind :class:`~torchft_tpu_torch.store.StoreClient`; the library builds
    at first use."""
    def __init__(self, bind: str = "0.0.0.0:0") -> None:
        lib = _require()
        self._lib = lib
        self._h = lib.tpuft_store_new(bind.encode())
        if not self._h:
            raise RuntimeError(f"store server failed: {_last_error(lib)}")

    @property
    def port(self) -> int:
        return self._lib.tpuft_store_port(self._h)

    def local_address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def address(self) -> str:
        import socket

        return f"{socket.gethostname()}:{self.port}"

    def shutdown(self) -> None:
        if self._h:
            self._lib.tpuft_store_free(self._h)
            self._h = None


class CppLighthouseServer:
    """The C++ lighthouse (``csrc/native/lighthouse.h``): global membership
    and quorums, drop-in behind
    :class:`~torchft_tpu_torch.lighthouse.LighthouseClient`."""
    def __init__(
        self,
        bind: str = "0.0.0.0:0",
        min_replicas: int = 1,
        join_timeout_ms: int = 100,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
    ) -> None:
        lib = _require()
        self._lib = lib
        self._h = lib.tpuft_lighthouse_new(
            bind.encode(),
            min_replicas,
            join_timeout_ms,
            quorum_tick_ms,
            heartbeat_timeout_ms,
        )
        if not self._h:
            raise RuntimeError(f"lighthouse failed: {_last_error(lib)}")

    @property
    def port(self) -> int:
        return self._lib.tpuft_lighthouse_port(self._h)

    def local_address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def address(self) -> str:
        import socket

        return f"{socket.gethostname()}:{self.port}"

    def shutdown(self) -> None:
        if self._h:
            self._lib.tpuft_lighthouse_free(self._h)
            self._h = None


class CppManagerServer:
    """The C++ manager sidecar (``csrc/native/manager.h``): a replica
    group's quorum and commit barrier, drop-in behind
    :class:`~torchft_tpu_torch.manager_server.ManagerClient`."""
    def __init__(
        self,
        replica_id: str,
        lighthouse_addr: str,
        hostname: str = "",
        bind: str = "0.0.0.0:0",
        store_addr: str = "",
        world_size: int = 1,
        heartbeat_interval: float = 0.1,
        connect_timeout: float = 10.0,
        quorum_retries: int = 0,
        health_fn: Optional[object] = None,
        role: int = 0,
        warm_fn: Optional[object] = None,
        warm_step_fn: Optional[object] = None,
        capacity_fn: Optional[object] = None,
        metrics_fn: Optional[object] = None,
    ) -> None:
        import socket

        # health_fn (comm-health heartbeat summaries for straggler
        # detection) is accepted for construction parity with the Python
        # ManagerServer but unused: the C++ sidecar sends legacy
        # heartbeats, which the lighthouse treats as "no health report".
        # warm_fn (spare warm-snapshot serving) and warm_step_fn (the
        # beat-carried spare warm watermark) likewise: the C++ sidecar
        # cannot host a spare or feed one — spare roles require the Python
        # tier (Manager(role="spare") refuses a native server_cls).
        # capacity_fn (the wire-v5 degraded-capacity fraction) likewise:
        # the C++ sidecar always registers full-width — a degraded-mode
        # replica needs the Python control plane (Manager refuses to
        # complete a re-lower on a native server_cls; docs/operations.md
        # §16 has the fallback matrix entry).
        # metrics_fn (/metrics gauges) likewise: the C++ sidecar serves no
        # HTTP endpoint — scrape the lighthouse for fleet-level facts.
        del health_fn, warm_fn, warm_step_fn, capacity_fn, metrics_fn
        if role != 0:
            raise ValueError(
                "CppManagerServer does not support the SPARE role; use the "
                "Python tier for spare replicas"
            )
        lib = _require()
        self._lib = lib
        self.role = role  # attribute parity with ManagerServer
        self._hostname = hostname or socket.gethostname()
        self._h = lib.tpuft_manager_new(
            replica_id.encode(),
            lighthouse_addr.encode(),
            self._hostname.encode(),
            bind.encode(),
            store_addr.encode(),
            world_size,
            heartbeat_interval,
            connect_timeout,
            quorum_retries,
        )
        if not self._h:
            raise RuntimeError(f"manager server failed: {_last_error(lib)}")

    @property
    def port(self) -> int:
        return self._lib.tpuft_manager_port(self._h)

    def address(self) -> str:
        return f"{self._hostname}:{self.port}"

    def shutdown(self) -> None:
        if self._h:
            self._lib.tpuft_manager_free(self._h)
            self._h = None


def _is_single(buffers: Buffers) -> bool:
    """One buffer (an array or a tensor), as opposed to a sequence of them."""
    return isinstance(buffers, (np.ndarray, torch.Tensor))


# ---------------------------------------------------------------------------
# CppCommunicator
# ---------------------------------------------------------------------------


class CppCommunicator(Communicator):
    """Data-plane communicator backed by the C++ runtime.

    Same semantics as :class:`torchft_tpu_torch.communicator.TCPCommunicator`
    (repeatable configure, abort-poisons, per-op userspace timeouts) with the
    wire IO and reductions in native code.  ctypes releases the GIL during
    foreign calls, so the op thread never stalls Python.
    """

    def __init__(self, timeout_s: float = 60.0) -> None:
        lib = _require()
        self._lib = lib
        self._timeout_s = timeout_s
        self._h = lib.tpuft_comm_new(ctypes.c_double(timeout_s))
        self._rank = 0
        self._world_size = 1
        self._errored: Optional[Exception] = None
        self._lock = threading.Lock()
        self._epoch = 0
        self._ops: "queue.Queue[Optional[Tuple[Callable[[], object], Future]]]" = queue.Queue()
        self._op_thread: Optional[threading.Thread] = None
        # ops currently EXECUTING (the queue no longer holds them) — the
        # busy() probe's other half; own lock because overlapping old/new
        # epoch op threads can race the += / -= pair (same doctrine as
        # TCPCommunicator._inflight_ops)
        self._inflight_ops = 0
        self._inflight_lock = threading.Lock()
        # flight recorder attachment point (set by the owning Manager):
        # epoch lifecycle records Python-side, and the C-side fixed-slot
        # ring drains into every dump via tpuft_comm_flight_drain
        self.flight: Optional[FlightRecorder] = None
        self._flight_registered = False

    # -- lifecycle ---------------------------------------------------------

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
        with self._lock:
            self._teardown_locked("superseded by reconfigure")
            self._epoch += 1
            epoch = self._epoch
            self._errored = None
            self._rank = rank
            self._world_size = world_size
        # the C configure blocks on rendezvous; run outside the lock
        rc = self._lib.tpuft_comm_configure(
            self._h, store_addr.encode(), rank, world_size
        )
        if rc != 0:
            err = CommunicatorError(
                f"configure failed: {_last_error(self._lib)}"
            )
            with self._lock:
                self._errored = err
            raise err
        with self._lock:
            if self._epoch != epoch:
                raise CommunicatorAborted("configure superseded")
            self._ops = queue.Queue()
            self._op_thread = threading.Thread(
                target=self._run_ops,
                args=(self._ops, epoch),
                name=f"tpuft_cppcomm_ops_{epoch}",
                daemon=True,
            )
            self._op_thread.start()
        if self.flight is not None:
            self.flight.set_comm_epoch(epoch)
            self.flight.record(
                FlightEvent.COMM_CONFIGURE,
                comm_epoch=epoch,
                quorum_id=quorum_id,
                rank=rank,
                world=world_size,
                tier="cpp",
            )
            if not self._flight_registered:
                # the C ring drains into every dump from here on
                self.flight.register_native_source(self)
                self._flight_registered = True
        logger.info(
            "cpp communicator configured: replica_id=%s rank=%d/%d quorum_id=%d",
            replica_id,
            rank,
            world_size,
            quorum_id,
        )

    def _teardown_locked(self, reason: str) -> None:
        # No join here: the op thread's error path takes self._lock, so
        # joining under the lock would deadlock.  The in-flight C op
        # observes the abort and errors out; the C layer parks superseded
        # fds in a graveyard until destruction, so the late-returning op can
        # never touch a recycled fd.
        if self._h:
            self._lib.tpuft_comm_abort(self._h)  # unblocks in-flight op
        try:
            while True:
                item = self._ops.get_nowait()
                if item is not None:
                    item[1].set_exception(CommunicatorAborted(reason))
        except queue.Empty:
            pass
        if self._op_thread is not None:
            self._ops.put(None)
            self._op_thread = None

    def abort(self, reason: str = "aborted") -> None:
        with self._lock:
            newly_poisoned = self._errored is None
            if self._errored is None:
                self._errored = CommunicatorAborted(reason)
            self._teardown_locked(reason)
            self._epoch += 1
        self._flight_poison(reason, newly_poisoned)
        logger.warning("cpp communicator aborted: %s", reason)

    def _flight_poison(self, reason: str, newly_poisoned: bool) -> None:
        """Record the epoch teardown (+ poison/dump when an error actually
        latched) — outside every lock, since a dump does file IO."""
        flight = self.flight
        if flight is None:
            return
        flight.record(FlightEvent.COMM_ABORT, reason=reason, tier="cpp")
        if newly_poisoned and reason != "shutdown":
            flight.record(
                FlightEvent.COMM_POISON, reason=reason, tier="cpp"
            )
            flight.maybe_dump("comm_poison")

    def _abort_if_epoch(self, epoch: int, reason: str) -> None:
        def _do() -> None:
            with self._lock:
                if self._epoch != epoch:
                    return
                newly_poisoned = self._errored is None
                if self._errored is None:
                    self._errored = CommunicatorAborted(reason)
                self._teardown_locked(reason)
                self._epoch += 1
            self._flight_poison(reason, newly_poisoned)
            logger.warning("cpp communicator aborted: %s", reason)

        threading.Thread(target=_do, name="tpuft_cppcomm_abort", daemon=True).start()

    def errored(self) -> Optional[Exception]:
        return self._errored

    def shutdown(self) -> None:
        with self._lock:
            thread = self._op_thread
            self._teardown_locked("shutdown")
            if self._errored is None:
                self._errored = CommunicatorAborted("shutdown")
            self._epoch += 1
        # join OUTSIDE the lock (the op thread's error path takes it); the C
        # object must not be freed while an op thread is inside a C call
        if thread is not None:
            thread.join(timeout=15.0)
        with self._lock:
            if self._h and (thread is None or not thread.is_alive()):
                self._lib.tpuft_comm_free(self._h)
                self._h = None

    def rank(self) -> int:
        return self._rank

    def size(self) -> int:
        return self._world_size

    def set_timeout(self, timeout_s: float) -> None:
        self._timeout_s = timeout_s

    def busy(self) -> bool:
        """True while an op is executing or queued in the current epoch —
        the idle-priority yield probe (see TCPCommunicator.busy).  The
        queue alone is not enough: ``_run_ops`` dequeues BEFORE running,
        so a multi-second in-flight collective leaves the queue empty."""
        if self._inflight_ops > 0:
            return True
        ops = self._ops
        return ops is not None and not ops.empty()

    def _op_started(self) -> None:
        """Enter the in-flight window of :meth:`busy` — counter under its
        own lock; see TCPCommunicator._op_started (same doctrine, pinned by
        the same contention regression test)."""
        with self._inflight_lock:
            self._inflight_ops += 1

    def _op_finished(self) -> None:
        with self._inflight_lock:
            self._inflight_ops -= 1

    def lane_stats(self) -> Dict[str, object]:
        """Per-lane observability of the current epoch, tier-agnostic with
        :meth:`TCPCommunicator.lane_stats`: lane count, stripe floor,
        payload bytes sent/received per lane, and stall events (pacer
        denials / kernel would-block).  The gray-failure counters the
        Python tier additionally exports (reconnects/failovers/injected
        faults) report 0 — the native tier has no fault injection or
        in-epoch lane recovery yet.  Empty when unconfigured or
        single-member."""
        with self._lock:
            if self._h is None or self._world_size <= 1:
                return {}
            cap = 64
            tx = (ctypes.c_uint64 * cap)()
            rx = (ctypes.c_uint64 * cap)()
            stalls = (ctypes.c_uint64 * cap)()
            floor = ctypes.c_uint64()
            lanes = int(
                self._lib.tpuft_comm_lane_stats(
                    self._h, tx, rx, stalls, cap, ctypes.byref(floor)
                )
            )
        if lanes <= 0:
            return {}
        n = min(lanes, cap)
        return {
            "lanes": lanes,
            "stripe_floor_bytes": int(floor.value),
            "lane_tx_bytes": [int(tx[i]) for i in range(n)],
            "lane_rx_bytes": [int(rx[i]) for i in range(n)],
            "lane_stalls": [int(stalls[i]) for i in range(n)],
            "lane_reconnects": 0,
            "lane_failovers": 0,
            "faults_injected": 0,
            "dead_lanes": 0,
        }

    def flight_drain(self) -> List[Dict[str, object]]:
        """Consume the C-side flight ring (``tpuft_comm_flight_drain``)
        into event dicts shaped like the Python recorder's, marked
        ``native``; repeated drains never duplicate events."""
        with self._lock:
            if self._h is None:
                return []
            cap = 256  # mirror of comm.h kFlightRingSlots
            seqs = (ctypes.c_uint64 * cap)()
            ts = (ctypes.c_double * cap)()
            evs = (ctypes.c_uint32 * cap)()
            a = (ctypes.c_int64 * cap)()
            b = (ctypes.c_int64 * cap)()
            n = int(
                self._lib.tpuft_comm_flight_drain(
                    self._h, seqs, ts, evs, a, b, cap
                )
            )
        out: List[Dict[str, object]] = []
        for i in range(n):
            ev = int(evs[i])
            out.append(
                {
                    "seq": int(seqs[i]),
                    "t": round(float(ts[i]), 6),
                    "ev": ev,
                    "name": (
                        FlightEvent(ev).name
                        if ev in FlightEvent._value2member_map_
                        else f"EV_{ev}"
                    ),
                    "a": int(a[i]),
                    "b": int(b[i]),
                    "native": True,
                }
            )
        return out

    # -- op machinery ------------------------------------------------------

    def _run_ops(self, ops: "queue.Queue", epoch: int) -> None:
        while True:
            item = ops.get()
            if item is None:
                return
            fn, fut = item
            if not fut.set_running_or_notify_cancel():
                continue
            timeout_s = self._timeout_s
            handle: TimerHandle = schedule_timeout(
                timeout_s,
                lambda: self._abort_if_epoch(
                    epoch, f"op timed out after {timeout_s}s"
                ),
            )
            self._op_started()
            try:
                with obs_span("comm::op", epoch=epoch, tier="cpp"):
                    result = fn()
            except BaseException as e:  # noqa: BLE001
                latched = False
                with self._lock:
                    if self._epoch == epoch and self._errored is None:
                        self._errored = (
                            e if isinstance(e, Exception) else RuntimeError(str(e))
                        )
                        latched = True
                if latched:
                    self._flight_poison(str(e), True)
                fut.set_exception(e)
            else:
                fut.set_result(result)
            finally:
                self._op_finished()
                handle.cancel()

    def _submit(self, fn: Callable[[], object]) -> Work:
        with self._lock:
            if self._errored is not None:
                fut: Future = Future()
                fut.set_exception(self._errored)
                return Work(fut)
            if self._op_thread is None:
                fut = Future()
                fut.set_exception(CommunicatorError("communicator not configured"))
                return Work(fut)
            fut = Future()
            self._ops.put((fn, fut))
            return Work(fut)

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise CommunicatorError(f"{what} failed: {_last_error(self._lib)}")

    # -- collectives -------------------------------------------------------

    @staticmethod
    def _as_list(buffers: Buffers) -> List[np.ndarray]:
        """Host views of the input buffers — numpy passes through, CPU
        torch tensors (bf16 included) and buffer-protocol sources come back
        as zero-copy views (:func:`as_host_array`)."""
        if _is_single(buffers):
            return [as_host_array(buffers)]
        return [as_host_array(b) for b in buffers]

    def allreduce(
        self,
        buffers: Buffers,
        op: ReduceOp = ReduceOp.SUM,
        in_place: bool = False,
    ) -> Work:
        arrays = self._as_list(buffers)
        single = _is_single(buffers)
        ws = self._world_size

        def _run() -> object:
            out: List[np.ndarray] = [None] * len(arrays)  # type: ignore[list-item]
            # one native call per dtype (each dtype needs its own reduce
            # loop); the arrays of a group ride ONE ring as scattered iovec
            # segments — the round-1 binding np.concatenate'd them into a
            # staging buffer and sliced the result back out, a full extra
            # payload copy each way
            by_code: Dict[int, List[int]] = {}
            for i, a in enumerate(arrays):
                code = _dtype_code(a)
                if code is None:
                    raise CommunicatorError(f"unsupported dtype {a.dtype.name}")
                by_code.setdefault(code, []).append(i)
            for code, idxs in by_code.items():
                flats: List[np.ndarray] = []
                for i in idxs:
                    a = arrays[i]
                    if (
                        in_place
                        and a.flags.c_contiguous
                        and a.flags.writeable
                    ):
                        # zero-copy: the native ring reduces straight into
                        # the caller's buffer (returned aliased)
                        flat = a.reshape(-1)
                    else:
                        # the native op is in-place; copy this one array to
                        # preserve the caller's buffer (also the landing
                        # spot for read-only dlpack views)
                        flat = np.array(a, copy=True).reshape(-1)
                    flats.append(flat)
                    out[i] = flat
                total = sum(int(f.nbytes) for f in flats)
                if total > 0:
                    n = len(flats)
                    ptrs = (ctypes.c_void_p * n)(
                        *(_data_ptr(f) for f in flats)
                    )
                    lens = (ctypes.c_uint64 * n)(
                        *(int(f.nbytes) for f in flats)
                    )
                    self._check(
                        self._lib.tpuft_comm_allreduce_iov(
                            self._h, ptrs, lens, n, code, _OP_CODES[op]
                        ),
                        "allreduce",
                    )
                if op == ReduceOp.AVG:
                    for f in flats:
                        _avg_in_place(f, ws)
                for i in idxs:
                    out[i] = out[i].reshape(arrays[i].shape)
            return out[0] if single else out

        return self._submit(_run)

    def reduce_scatter(
        self, data: np.ndarray, op: ReduceOp = ReduceOp.SUM
    ) -> Work:
        arr = as_host_array(data)
        ws = self._world_size

        def _run() -> object:
            code = _dtype_code(arr)
            if code is None:
                raise CommunicatorError(f"unsupported dtype {arr.dtype.name}")
            # the native op reduces in place; work on a copy so the caller's
            # buffer survives
            flat = np.array(arr, copy=True).reshape(-1)
            n = flat.size
            base, extra = divmod(n, ws)
            own_elems = base + (1 if self._rank < extra else 0)
            out = np.empty(own_elems, dtype=flat.dtype)
            got = ctypes.c_uint64()
            self._check(
                self._lib.tpuft_comm_reduce_scatter(
                    self._h,
                    _data_ptr(flat),
                    flat.nbytes,
                    code,
                    _OP_CODES[op],
                    _data_ptr(out),
                    out.nbytes,
                    ctypes.byref(got),
                ),
                "reduce_scatter",
            )
            assert got.value == out.nbytes, "reduce_scatter size mismatch"
            if op == ReduceOp.AVG:
                _avg_in_place(out, ws)
            return out

        return self._submit(_run)

    def broadcast(self, buffers: Buffers, root: int = 0) -> Work:
        arrays = [np.ascontiguousarray(a) for a in self._as_list(buffers)]
        single = _is_single(buffers)

        def _run() -> object:
            out = []
            for a in arrays:
                buf = np.array(a, copy=True)
                view = buf.reshape(-1).view(np.uint8)
                self._check(
                    self._lib.tpuft_comm_broadcast(
                        self._h,
                        view.ctypes.data_as(ctypes.c_void_p),
                        view.nbytes,
                        root,
                    ),
                    "broadcast",
                )
                out.append(buf)
            return out[0] if single else out

        return self._submit(_run)

    def send_bytes(self, data, dst: int, tag: int = 0) -> Work:
        """Send any contiguous buffer (bytes, memoryview, numpy array)
        WITHOUT copying: the C call reads straight from the object's buffer
        (the closure keeps it alive until the op completes)."""
        ptr, nbytes, keepalive = _buffer_ptr(data)

        def _run(_keep=keepalive) -> object:
            # _keep pins the backing buffer for the C call's lifetime
            self._check(
                self._lib.tpuft_comm_send(self._h, ptr, nbytes, dst, tag),
                "send",
            )
            return nbytes

        return self._submit(_run)

    def send_frame_parts(self, parts, nbytes: int, dst: int, tag: int = 0) -> Work:
        """One frame of ``nbytes`` written as its parts arrive (see
        :meth:`Communicator.send_frame_parts`), in one op: the first part
        carries the frame's header, the rest their bytes alone."""

        def _run() -> object:
            sent, first = 0, True
            with closing_parts(parts) as each:
                for view, release in each:
                    ptr, n, _keep = _buffer_ptr(view)
                    self._check(
                        self._lib.tpuft_comm_send_part(
                            self._h, ptr, n, dst, tag, nbytes, int(first)),
                        "send",
                    )
                    release()
                    sent, first = sent + n, False
            if first:  # an empty payload: the header alone
                self._check(
                    self._lib.tpuft_comm_send_part(self._h, None, 0, dst, tag, nbytes, 1), "send")
            if sent != nbytes:
                raise CommunicatorError(f"frame parts carried {sent} bytes, not {nbytes}")
            return nbytes

        return self._submit(_run)

    def recv_bytes(self, src: int, tag: int = 0) -> Work:
        def _run() -> object:
            out = ctypes.POINTER(ctypes.c_uint8)()
            n = ctypes.c_uint64()
            self._check(
                self._lib.tpuft_comm_recv_alloc(
                    self._h, src, tag, ctypes.byref(out), ctypes.byref(n)
                ),
                "recv",
            )
            try:
                return ctypes.string_at(out, n.value)
            finally:
                self._lib.tpuft_buffer_free(out)

        return self._submit(_run)

    def recv_bytes_into(self, src: int, out: np.ndarray, tag: int = 0) -> Work:
        out = as_host_array(out)
        assert out.flags.c_contiguous and out.flags.writeable

        def _run() -> object:
            n = ctypes.c_uint64()
            self._check(
                self._lib.tpuft_comm_recv_into(
                    self._h,
                    src,
                    tag,
                    out.ctypes.data_as(ctypes.c_void_p),
                    out.nbytes,
                    ctypes.byref(n),
                ),
                "recv_into",
            )
            return int(n.value)

        return self._submit(_run)

    def alltoall(self, chunks: List[np.ndarray], tag: int = 0) -> Work:
        arrays = [
            np.ascontiguousarray(as_host_array(c)) for c in chunks
        ]

        def _run() -> object:
            ws = self._world_size
            if ws == 1:
                return [arrays[0]]
            assert len(arrays) == ws
            chunk_bytes = arrays[0].nbytes
            assert all(a.nbytes == chunk_bytes for a in arrays), (
                "cpp alltoall requires equal-size chunks"
            )
            # one pointer per destination chunk: frames leave straight from
            # the callers' buffers (the round-1 binding packed them into a
            # staging concatenation first); receives land in one buffer
            # handed back as per-source views
            ptrs = (ctypes.c_void_p * ws)(*(_data_ptr(a) for a in arrays))
            out = np.empty(ws * chunk_bytes, dtype=np.uint8)
            self._check(
                self._lib.tpuft_comm_alltoall_ptrs(
                    self._h,
                    ptrs,
                    out.ctypes.data_as(ctypes.c_void_p),
                    chunk_bytes,
                    tag,
                ),
                "alltoall",
            )
            return [
                out[p * chunk_bytes : (p + 1) * chunk_bytes]
                .view(arrays[0].dtype)
                .reshape(arrays[0].shape)
                for p in range(ws)
            ]

        return self._submit(_run)

    def allgather(self, data: np.ndarray, tag: int = 0) -> Work:
        array = np.ascontiguousarray(as_host_array(data))

        def _run() -> object:
            ws = self._world_size
            if ws == 1:
                return [array]
            chunk_bytes = array.nbytes
            out = np.empty(ws * chunk_bytes, dtype=np.uint8)
            self._check(
                self._lib.tpuft_comm_allgather(
                    self._h,
                    array.reshape(-1).view(np.uint8).ctypes.data_as(ctypes.c_void_p),
                    out.ctypes.data_as(ctypes.c_void_p),
                    chunk_bytes,
                    tag,
                ),
                "allgather",
            )
            return [
                out[p * chunk_bytes : (p + 1) * chunk_bytes]
                .view(array.dtype)
                .reshape(array.shape)
                for p in range(ws)
            ]

        return self._submit(_run)

    def barrier(self) -> Work:
        def _run() -> object:
            self._check(self._lib.tpuft_comm_barrier(self._h), "barrier")
            return None

        return self._submit(_run)
