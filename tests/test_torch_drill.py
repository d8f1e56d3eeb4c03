"""The port's chaos drills (``torchft_tpu_torch/drill.py``) on the CPU, at
the sizes the JAX package's tests drive ``torchft_tpu.drill`` with
(``tests/test_spare.py``, ``tests/test_gray_failures.py``), with every
replica's state a torch tensor on ``device="cpu"``: the hot-spare modes and
the gray-failure modes.  Each non-slow case runs the JAX drill beside the
port's and holds the port's report to the JAX report's keys and to the JAX
tests' assertions.  The spare drills' final params must be bit-identical
across the surviving fleet and equal to the JAX drill's arithmetic for the
same gradients (``params += avg`` in numpy f32 over the averages the fleet
committed, each one the gradients give for some membership).  ``slow_nic`` and ``partition`` are marked slow, as in
the JAX tests.
"""

import numpy as np
import pytest
import torch

from torchft_tpu import drill as jdrill
from torchft_tpu_torch import drill


def _check_fleet(mode: str, participants_grads) -> None:
    """The surviving fleet ends bit-identical, every committed average is
    one the JAX drill's gradients give for some membership, and the final
    params are the JAX drill's update (``params += avg`` in numpy f32) over
    those averages."""
    fleet = drill.LAST_SPARE_FLEET[mode]
    params = fleet["params"]
    assert len(params) == 2 and all(torch.equal(params[0], p) for p in params[1:])
    assert set(fleet["averages"]) <= participants_grads
    want = np.zeros(params[0].numel(), dtype=np.float32)
    for avg in fleet["averages"]:
        want += np.full(want.size, avg, dtype=np.float32)
    np.testing.assert_array_equal(params[0].numpy(), want)


# replica i contributes i + 1; a healing replica contributes zeros and an
# async-quorum heal round averages over the replicas that did not heal:
# actives 0 and 1 give 1.5 (0.5 in the init-sync round), replica 0 and the
# spare (index 2) give 2.0, replica 0 alone while the spare heals gives 1.0
AVERAGES = {0.5, 1.0, 1.5, 2.0}


def test_spare_promote_drill_matches_the_jax_drill() -> None:
    want = jdrill.gray_failure_drill(mode="spare_promote", num_replicas=2, steps=8)
    report = drill.gray_failure_drill(mode="spare_promote", num_replicas=2, steps=8, device="cpu")
    assert set(report) == set(want)
    assert report["promotions_total"] >= 1
    assert report["quorum_reconfigs"] == 1
    assert report["promotion_latency_s"] > 0
    _check_fleet("spare_promote", AVERAGES)
    assert 2.0 in drill.LAST_SPARE_FLEET["spare_promote"]["averages"]


def test_kill_spare_drill_matches_the_jax_drill() -> None:
    want = jdrill.gray_failure_drill(mode="kill_spare", num_replicas=2, steps=8)
    report = drill.gray_failure_drill(mode="kill_spare", num_replicas=2, steps=8, device="cpu")
    assert set(report) == set(want)
    assert report["quorum_reconfigs"] == 0
    assert report["promotions_total"] == 0
    assert report["commits"][0] == report["commits"][1]
    _check_fleet("kill_spare", {0.5, 1.5})


NET_FLAKY = dict(num_replicas=3, steps=6, mode="net_flaky", fault_spec="loss:0.05,reset:0.02",
                 lanes=2, payload_elems=300_000, arm_at_step=2, timeout_s=20.0)


def test_net_flaky_fleet_recovers_in_epoch() -> None:
    want = jdrill.gray_failure_drill(**NET_FLAKY)
    res = drill.gray_failure_drill(**NET_FLAKY, device="cpu")
    assert set(res) == set(want)
    assert res["quorum_reconfigs"] == 0
    assert res["faults_injected"] > 0


@pytest.mark.slow
def test_slow_nic_replica_is_evicted() -> None:
    res = drill.gray_failure_drill(num_replicas=3, steps=8, mode="slow_nic", lanes=2,
                                   payload_elems=300_000, arm_at_step=2, timeout_s=15.0,
                                   evict_persist=2, device="cpu")
    assert res["victim_excluded"] and res["evictions_total"] >= 1
    # fleet step time recovers once the straggler is shed
    assert res["step_time_recovered_s"] <= 1.2 * res["step_time_clean_s"]


@pytest.mark.slow
def test_partitioned_replica_is_shed_by_majority() -> None:
    res = drill.gray_failure_drill(num_replicas=3, steps=6, mode="partition", lanes=2,
                                   payload_elems=200_000, arm_at_step=2, timeout_s=8.0,
                                   device="cpu")
    assert res["victim_excluded"]


def test_a_cuda_drill_without_a_card_raises(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drill.gray_failure_drill(mode="kill_spare", num_replicas=2, steps=8)


def test_package_exports_the_jax_packages_chaos_names() -> None:
    import torchft_tpu
    import torchft_tpu_torch
    from torchft_tpu_torch import chaos

    for name in ("ChaosController", "Failure", "gray_failure_drill"):
        assert name in torchft_tpu.__all__ and name in torchft_tpu_torch.__all__
    assert torchft_tpu_torch.ChaosController is chaos.ChaosController
    assert torchft_tpu_torch.gray_failure_drill is drill.gray_failure_drill
