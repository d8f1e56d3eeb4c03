"""Readers-writer lock with timeouts.

Guards the live state dict while it is being served to healing peers, the
same role as the reference's two-mutex RWLock
(``torchft/checkpointing/_rwlock.py:46-136``): many concurrent checkpoint
readers, one exclusive writer (the train loop mutating weights), and every
acquire bounded by a timeout so a stuck peer can never wedge training.

This implementation is a single condition variable over reader/writer counts
(writer-preferring, so a steady stream of readers can't starve the train
loop).
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class RWLock:
    def __init__(self, timeout: float = 60.0) -> None:
        self._timeout = timeout
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def _acquire(self, as_writer: bool, timeout: Optional[float]) -> None:
        budget = self._timeout if timeout is None else timeout
        deadline = time.monotonic() + budget
        with self._cond:
            if as_writer:
                self._writers_waiting += 1
                try:
                    while self._writer or self._readers > 0:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise TimeoutError(
                                f"could not acquire write lock in {budget}s"
                            )
                        # a timed-out wait falls through to re-check the
                        # guard once more before the deadline check raises —
                        # a notify racing the deadline must not lose
                        self._cond.wait(remaining)
                    self._writer = True
                finally:
                    self._writers_waiting -= 1
                    if not self._writer:
                        # timed out: wake readers parked on writers_waiting>0
                        self._cond.notify_all()
            else:
                while self._writer or self._writers_waiting > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(f"could not acquire read lock in {budget}s")
                    self._cond.wait(remaining)
                self._readers += 1

    def r_lock(self, timeout: Optional[float] = None) -> "_Guard":
        self._acquire(as_writer=False, timeout=timeout)
        return _Guard(self, writer=False)

    def w_lock(self, timeout: Optional[float] = None) -> "_Guard":
        self._acquire(as_writer=True, timeout=timeout)
        return _Guard(self, writer=True)

    def r_release(self) -> None:
        with self._cond:
            assert self._readers > 0, "release without acquire"
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def w_release(self) -> None:
        with self._cond:
            assert self._writer, "release without acquire"
            self._writer = False
            self._cond.notify_all()


class _Guard:
    def __init__(self, lock: RWLock, writer: bool) -> None:
        self._lock = lock
        self._writer = writer

    def __enter__(self) -> "_Guard":
        return self

    def __exit__(self, *exc: object) -> None:
        if self._writer:
            self._lock.w_release()
        else:
            self._lock.r_release()
