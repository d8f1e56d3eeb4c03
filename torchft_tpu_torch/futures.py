"""Userspace timeout engine.

The reference routes every async op through a singleton ``_TimeoutManager``
(background asyncio loop + watchdog thread, ``torchft/futures.py:50-277``) so
that collective timeouts are *userspace and per-operation, never
process-fatal* (SURVEY.md §5.8 requirement 5).  torchft_tpu keeps the same
doctrine with a single deadline-servicing thread: ops register a deadline and
a callback (typically ``communicator.abort``); firing the callback unblocks
the wedged op, which then surfaces as a recorded error, not a crash.

A watchdog guards the timer thread itself: if the timer thread stops
servicing deadlines (the analog of the reference's wedged event loop,
``torchft/futures.py:102-125``) the watchdog hard-exits the process so the
scheduler can reschedule the replica.  Controlled by
``TORCHFT_WATCHDOG_TIMEOUT_SEC`` (0 disables; disabled by default under
pytest).
"""

from __future__ import annotations

import heapq
import itertools
import logging
import os
import sys
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Optional

logger = logging.getLogger(__name__)

WATCHDOG_TIMEOUT_SEC_ENV = "TORCHFT_WATCHDOG_TIMEOUT_SEC"


class TimerHandle:
    __slots__ = ("_cancelled", "_fired")

    def __init__(self) -> None:
        self._cancelled = False
        self._fired = False

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def fired(self) -> bool:
        return self._fired


class _TimerThread:
    """Single background thread servicing monotonic deadlines."""

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, TimerHandle, Callable[[], None]]] = []
        self._counter = itertools.count()
        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._last_tick = time.monotonic()
        self._watchdog: Optional[threading.Thread] = None

    def _ensure_started(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._run, name="tpuft_timers", daemon=True
        )
        self._thread.start()
        watchdog_sec = float(os.environ.get(WATCHDOG_TIMEOUT_SEC_ENV, "0") or 0)
        if watchdog_sec > 0 and self._watchdog is None:
            self._watchdog = threading.Thread(
                target=self._run_watchdog,
                args=(watchdog_sec,),
                name="tpuft_watchdog",
                daemon=True,
            )
            self._watchdog.start()

    def schedule(self, delay_s: float, callback: Callable[[], None]) -> TimerHandle:
        handle = TimerHandle()
        deadline = time.monotonic() + delay_s
        with self._cond:
            self._ensure_started()
            heapq.heappush(self._heap, (deadline, next(self._counter), handle, callback))
            self._cond.notify()
        return handle

    def _run(self) -> None:
        while True:
            with self._cond:
                self._last_tick = time.monotonic()
                while not self._heap:
                    self._cond.wait(timeout=1.0)
                    self._last_tick = time.monotonic()
                deadline, _, handle, callback = self._heap[0]
                now = time.monotonic()
                if deadline > now:
                    self._cond.wait(timeout=min(deadline - now, 1.0))
                    continue
                heapq.heappop(self._heap)
            if handle._cancelled:
                continue
            handle._fired = True
            try:
                callback()
            except Exception:  # noqa: BLE001
                logger.exception("timer callback raised")

    def _run_watchdog(self, timeout_s: float) -> None:
        while True:
            time.sleep(timeout_s / 2)
            with self._cond:
                stalled = (
                    bool(self._heap)
                    and time.monotonic() - self._last_tick > timeout_s
                )
            if stalled:
                logger.error(
                    "timer thread wedged for >%ss; exiting so the scheduler can "
                    "restart this replica",
                    timeout_s,
                )
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(1)


_TIMERS = _TimerThread()


def schedule_timeout(delay_s: float, callback: Callable[[], None]) -> TimerHandle:
    """Run ``callback`` after ``delay_s`` unless cancelled first."""
    return _TIMERS.schedule(delay_s, callback)


def future_timeout(fut: "Future[Any]", timeout_s: float) -> "Future[Any]":
    """Return a future that mirrors ``fut`` but fails with ``TimeoutError``
    after ``timeout_s`` (``torchft/futures.py:280-292``)."""
    out: Future[Any] = Future()

    def _on_timeout() -> None:
        if out.done():
            return  # lost the race against fut completing; benign
        try:
            out.set_exception(TimeoutError(f"future timed out after {timeout_s}s"))
        except Exception:  # noqa: BLE001 - resolved between check and set
            pass

    handle = schedule_timeout(timeout_s, _on_timeout)

    def _chain(f: "Future[Any]") -> None:
        handle.cancel()
        if out.done():
            return
        try:
            if f.cancelled():
                out.cancel()
                # cancel() on an un-started Future resolves it; if something
                # already set it running, surface cancellation as an error
                if not out.done():
                    out.set_exception(TimeoutError("source future was cancelled"))
                return
            err = f.exception()
            if err is not None:
                out.set_exception(err)
            else:
                out.set_result(f.result())
        except Exception:  # noqa: BLE001 - future already resolved by timeout
            pass

    fut.add_done_callback(_chain)
    return out


def future_wait(fut: "Future[Any]", timeout_s: float) -> Any:
    """Block on ``fut`` with a deadline (``torchft/futures.py:295-322``)."""
    return fut.result(timeout=timeout_s)


class context_timeout:
    """``with context_timeout(cb, t):`` — arm ``cb`` unless the body finishes
    within ``t`` seconds (``torchft/futures.py:340-354``)."""

    def __init__(self, callback: Callable[[], None], timeout_s: float) -> None:
        self._callback = callback
        self._timeout_s = timeout_s
        self._handle: Optional[TimerHandle] = None

    def __enter__(self) -> "context_timeout":
        self._handle = schedule_timeout(self._timeout_s, self._callback)
        return self

    def __exit__(self, *exc: object) -> None:
        assert self._handle is not None
        self._handle.cancel()
