"""``train_diloco.run_diloco_fleet(spares=1)`` on the CPU at
``llama_debug`` size: 2 active DiLoCo replicas and 1 hot spare as threads,
every plane on the Python tier, ``chip_smoke.py``'s ``spare_python``
schedule (sync every 8, 2 fragments, delay 2, replica 1 killed before its
inner step 5).  The killed replica stays dead; the lighthouse promotes the
spare in one membership edit, with no heal (it stood at the commit front);
the fleet ends with equal fragment backups — all of it held by
``chip_smoke.check_spare``, the phase's own check.  A kill after a
committed sync (inner step 9, ``TORCHFT_SPARE_WARM_REFRESH_S=60`` so the
survivors do not restage first) brings the spare to the front through the
outer-delta feed instead.  Without a spare the schedule still restarts and
heals the killed replica; a spare on the C++ tier is refused.
"""

import sys
from pathlib import Path

import pytest
import torch

from torchft_tpu_torch import train_ddp, train_diloco

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = dict(seq=128, batch=2, lr=1e-3, timeout=30.0, tier="python")


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    return chip_smoke


def _fleet(fleet: dict):
    return train_diloco.run_diloco_fleet(train_ddp.model_config("llama_debug"), CPU, **SMALL,
                                         **fleet)


def _launches_after_promotion(results) -> dict:
    # the CPU runs the kernels' plain versions, which count no launch
    at = results[-1].spare["launches_at_promotion"]
    return {k: v + 1 for k, v in at.items()}


def test_spare_promoted_in_place_of_the_killed_replica(chip_smoke) -> None:
    fleet = dict(chip_smoke.SPARE_PHASE)
    results = _fleet(fleet)
    chip_smoke.check_spare(results, fleet, _launches_after_promotion(results))
    info = results[-1].spare
    assert info["kill_to_adopt_s"] > 0 and info["kill_to_first_commit_s"] >= info["kill_to_adopt_s"]
    assert info["warm_bytes_fetched"] > 0 and info["promotion_adopt_s"] >= 0
    assert results[1].final_step == 1  # it died after the first committed sync


def test_spare_reaches_the_front_through_the_delta_feed(chip_smoke, monkeypatch) -> None:
    monkeypatch.setenv("TORCHFT_SPARE_WARM_REFRESH_S", "60")
    fleet = {k: v for k, v in chip_smoke.SPARE_DELTA_FLEET.items()
             if k not in ("batch", "seq", "lr")}
    results = _fleet(fleet)
    chip_smoke.check_spare(results, fleet, _launches_after_promotion(results), min_deltas=1)


def test_spares_need_the_python_tier() -> None:
    with pytest.raises(ValueError, match="Python tier"):
        train_diloco.run_diloco_fleet(train_ddp.model_config("llama_debug"), CPU, tier="cpp",
                                      spares=1)
