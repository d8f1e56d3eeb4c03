"""Async work handles for host-side collectives.

The reference returns c10d ``Work`` objects from every collective and layers
lazy future chaining on top (``torchft/work.py:15-26``,
``torchft/manager.py:1080-1363``).  On TPU there are no user-visible device
streams — XLA dispatch is already async — so the host-side communicator's
``Work`` is a thin wrapper over a ``concurrent.futures.Future`` with value
mapping (``then``) used for AVG normalization and error funneling.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Callable, Optional


class Work:
    """Handle for an in-flight collective.

    ``wait()`` blocks for completion and returns the op's value (the reduced
    arrays for allreduce and friends).  ``then(fn)`` returns a new Work whose
    value is ``fn(value)`` — the analog of the reference's lazy managed-future
    callbacks (``torchft/manager.py:1256-1307``) minus stream bookkeeping.
    """

    def __init__(self, future: "Future[Any]") -> None:
        self._future = future

    def wait(self, timeout: Optional[float] = None) -> Any:
        return self._future.result(timeout=timeout)

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        return self._future.exception(timeout=timeout)

    def done(self) -> bool:
        return self._future.done()

    def future(self) -> "Future[Any]":
        return self._future

    def then(self, fn: Callable[[Any], Any]) -> "Work":
        out: Future[Any] = Future()

        def _chain(f: "Future[Any]") -> None:
            err = f.exception()
            if err is not None:
                out.set_exception(err)
                return
            try:
                out.set_result(fn(f.result()))
            except BaseException as e:  # noqa: BLE001 - funnel into the future
                out.set_exception(e)

        self._future.add_done_callback(_chain)
        return Work(out)


class DummyWork(Work):
    """Already-completed work with a preset value.

    Returned after recorded errors and by the dummy communicator so the train
    loop never sees an exception from a collective
    (``torchft/work.py:15-26``, ``torchft/manager.py:435-436``).
    """

    def __init__(self, value: Any = None) -> None:
        fut: Future[Any] = Future()
        fut.set_result(value)
        super().__init__(fut)


def completed_future(value: Any = None) -> "Future[Any]":
    fut: Future[Any] = Future()
    fut.set_result(value)
    return fut


def failed_work(err: BaseException) -> Work:
    fut: Future[Any] = Future()
    fut.set_exception(err)
    return Work(fut)


class Event:
    """Host-side completion event (stand-in for CUDA events in the reference's
    recovery-stream synchronization, ``torchft/manager.py:880-892``)."""

    def __init__(self) -> None:
        self._event = threading.Event()

    def record(self) -> None:
        self._event.set()

    def synchronize(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout=timeout)
