"""Multiprocessing plumbing: a pipe with recv deadlines + shipped exceptions.

Twin of the reference's ``_MonitoredPipe`` (``torchft/multiprocessing.py:16-38``):
``recv(timeout)`` raises ``TimeoutError`` when the peer is silent and
re-raises exceptions the peer shipped as values — the substrate for running
communicators in a killable subprocess (:mod:`torchft_tpu_torch.baby`).
"""

from __future__ import annotations

import multiprocessing.connection
from typing import Any


class MonitoredPipe:
    def __init__(self, pipe: "multiprocessing.connection.Connection") -> None:
        self._pipe = pipe

    def send(self, obj: Any) -> None:
        self._pipe.send(obj)

    def recv(self, timeout: float) -> Any:
        if not self._pipe.poll(timeout):
            raise TimeoutError(f"pipe recv timed out after {timeout}s")
        out = self._pipe.recv()
        if isinstance(out, Exception):
            raise out
        return out

    def close(self) -> None:
        self._pipe.close()

    def closed(self) -> bool:
        return self._pipe.closed
