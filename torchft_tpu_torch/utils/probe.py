"""Device health probe: does the named device initialize AND execute?

A wedged device can hang any in-process call on it forever, so the probe
(a) runs in a subprocess with a timeout, and (b) round-trips one small
matmul to host rather than just enumerating devices.  ``chip_smoke.py``
runs it before anything else and fails by name when the card does not
execute: it never carries on on the CPU.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Optional

_PROBE_SRC = (
    "import sys, torch; "
    "x = torch.ones((8, 8), device=sys.argv[1]); "
    "assert float((x @ x)[0, 0].cpu()) == 8.0"
)

_CACHE: dict = {}


def backend_executes(
    timeout_s: float = 180.0, use_cache: bool = True, device: str = "cuda"
) -> bool:
    """True when ``device`` initializes AND executes a matmul.  The result
    is memoized per process and device (it depends only on the machine's
    state, and a wedged probe costs the full timeout every time)."""
    if use_cache and device in _CACHE:
        return _CACHE[device]
    try:
        probe = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC, device],
            timeout=timeout_s,
            capture_output=True,
        )
        ok = probe.returncode == 0
    except subprocess.TimeoutExpired:
        ok = False
    _CACHE[device] = ok
    return ok


def backend_executes_with_retries(
    window_s: float,
    timeout_s: float = 180.0,
    log=None,
    device: str = "cuda",
) -> bool:
    """Retry :func:`backend_executes` within a bounded window — a device can
    wedge transiently, and a single failed probe must not silently
    downgrade a long measurement run to the CPU."""
    deadline = time.time() + window_s
    attempt = 0
    while True:
        attempt += 1
        t0 = time.time()
        if backend_executes(timeout_s, use_cache=False, device=device):
            _CACHE[device] = True
            if attempt > 1 and log:
                log(f"backend probe succeeded on attempt {attempt}")
            return True
        if time.time() >= deadline:
            _CACHE[device] = False
            return False
        wait: Optional[float] = min(
            30.0, max(5.0, deadline - time.time())
        )
        if log:
            log(
                f"backend probe attempt {attempt} failed after "
                f"{time.time() - t0:.0f}s; retrying in {wait:.0f}s "
                f"({deadline - time.time():.0f}s left in retry window)"
            )
        if time.time() + wait >= deadline:
            wait = max(0.0, deadline - time.time())
        time.sleep(wait)
