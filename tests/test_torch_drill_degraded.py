"""The port's degraded-mode and streamed-DiLoCo chaos drills
(``torchft_tpu_torch/drill.py``: ``device_loss``, ``device_loss_swap``,
``device_loss_kill_mid_relower``, ``stream_kill_mid_fragment``) on the CPU
at the JAX tests' sizes (``tests/test_degraded.py``,
``tests/test_stream_sync.py``), each beside the JAX drill: the same report
keys and the JAX tests' assertions.  ``device_loss`` holds its final
params allclose to the analytic unwounded trajectory inside the drill
(rtol = atol = 2e-2, the JAX drill's tolerance), and reports
``converged`` only once that held.
"""

import numpy as np
import pytest

from torchft_tpu import drill as jdrill
from torchft_tpu_torch import drill


def _both(**kw):
    want = jdrill.gray_failure_drill(**kw)
    got = drill.gray_failure_drill(**kw, device="cpu")
    assert set(got) == set(want)
    return got


def test_device_loss_drill() -> None:
    report = _both(mode="device_loss", num_replicas=3, steps=8)
    assert report["quorum_reconfigs"] == 0
    assert report["evictions_total"] == 0
    assert report["capacity_observed"] == pytest.approx(0.75)
    assert report["converged"] is True
    assert all(c >= 8 for c in report["commits"])


def test_device_loss_swap_drill() -> None:
    report = _both(mode="device_loss_swap", num_replicas=3, steps=8)
    assert report["swaps_total"] >= 1
    assert report["quorum_reconfigs"] == 1  # the ONE membership edit
    assert report["victim_excluded"] is True
    assert report["wound_to_swap_s"] < 30.0


def test_kill_mid_relower_drill() -> None:
    report = _both(mode="device_loss_kill_mid_relower", num_replicas=3, steps=8)
    assert report["mid_relower_commit"] is False


def test_stream_kill_mid_fragment_drill() -> None:
    report = _both(mode="stream_kill_mid_fragment", num_replicas=3, steps=6)
    assert report["bit_identical"] is True
    assert report["healed"] is True
    assert all(a >= 1 for a in report["aborts"])
    assert all(c >= 6 for c in report["commits"])
