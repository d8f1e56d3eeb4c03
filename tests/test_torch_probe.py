"""The port's device probe (``torchft_tpu_torch/utils/probe.py``) against the
JAX package's (``torchft_tpu/utils/probe.py``): a CPU probe passes in both,
a probe of a device this machine lacks fails, a source that hangs returns
False within its timeout, and the retry window ends."""

import time

import pytest

from torchft_tpu.utils import probe as jax_probe
from torchft_tpu_torch.utils import probe


def test_cpu_probe_passes_in_both_packages(monkeypatch) -> None:
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert probe.backend_executes(timeout_s=120.0, use_cache=False, device="cpu")
    assert jax_probe.backend_executes(timeout_s=120.0, use_cache=False)
    assert probe.backend_executes(timeout_s=0.001, device="cpu")  # memoized per device


def test_a_missing_card_fails_the_probe() -> None:
    """On a host without CUDA the probe of ``cuda`` (the default) is
    False: whoever asked for the card never goes on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert not probe.backend_executes(timeout_s=120.0, use_cache=False)


@pytest.mark.parametrize("module", [probe, jax_probe], ids=["port", "jax"])
def test_a_hanging_source_returns_false_within_its_timeout(module, monkeypatch) -> None:
    monkeypatch.setattr(module, "_PROBE_SRC", "import time; time.sleep(60)")
    monkeypatch.setattr(module, "_CACHE", {})
    t0 = time.monotonic()
    assert not module.backend_executes(timeout_s=1.0, use_cache=False)
    assert time.monotonic() - t0 < 10.0


def test_the_retry_window_ends(monkeypatch) -> None:
    calls, logs = [], []

    def never(timeout_s, use_cache=True, device="cuda"):
        calls.append((timeout_s, use_cache, device))
        return False

    monkeypatch.setattr(probe, "backend_executes", never)
    monkeypatch.setattr(probe, "_CACHE", {})
    t0 = time.monotonic()
    assert not probe.backend_executes_with_retries(0.5, timeout_s=2.0, log=logs.append)
    assert time.monotonic() - t0 < 5.0
    assert len(calls) >= 2 and all(c == (2.0, False, "cuda") for c in calls)
    assert probe._CACHE == {"cuda": False}
    assert any("retry window" in m for m in logs)


def test_a_later_attempt_that_succeeds_ends_the_window(monkeypatch) -> None:
    answers = iter([False, True])
    monkeypatch.setattr(probe, "backend_executes", lambda *a, **k: next(answers))
    monkeypatch.setattr(probe, "_CACHE", {})
    logs: list = []
    assert probe.backend_executes_with_retries(5.0, timeout_s=1.0, log=logs.append, device="cpu")
    assert probe._CACHE == {"cpu": True}
    assert logs[-1] == "backend probe succeeded on attempt 2"
