"""The port's last three drills (``torchft_tpu_torch.drill``), held to the
JAX tests' facts (``tests/test_drill.py``, ``tests/test_postmortem.py``,
``tests/test_coord.py``):

- ``joint_ft_spmd_drill``: FT across replica groups composed with HSDP
  inside each (``llama_debug``, fsdp = 2 over gloo, rank processes of
  ``train_hsdp.run_hsdp_fleet``): a kill and heal, the int8 outer ring, and
  a striped heal whose source dies partway (3 groups; slow-marked, as its
  JAX twin is);
- ``postmortem_drill`` on both tiers: the flight-recorder chain from the
  merged dumps;
- ``coord_churn_drill`` at a drill scale (the JAX file's 60-replica run is
  slow-marked there and in ``tests/test_torch_coord.py``).
"""

import numpy as np
import pytest

from torchft_tpu_torch import native
from torchft_tpu_torch.drill import coord_churn_drill, joint_ft_spmd_drill, postmortem_drill


def _equal_states(states) -> None:
    ref = states[0]
    for other in states[1:]:
        assert ref.keys() == other.keys()
        for name in ref:
            np.testing.assert_array_equal(ref[name], other[name], err_msg=name)


def test_joint_ft_spmd_kill_heal() -> None:
    facts = joint_ft_spmd_drill(n_devices=4, num_replicas=2, num_steps=6, kill_replica=1,
                                kill_at_step=2, device="cpu")
    assert facts["restarts"] == 1
    assert facts["healed"]
    assert not facts["heal_source_killed"]
    assert facts["heal_timings"]["heal_num_sources"] == 1.0
    assert facts["heal_timings"]["heal_bytes"] > 0
    assert len(facts["final_states"]) == 2
    _equal_states(facts["final_states"])


def test_joint_ft_spmd_quantized_outer_ring() -> None:
    """HSDP with the int8 outer ring: every group applies the identical
    requantized averaged stream, so the groups end bit-identical."""
    facts = joint_ft_spmd_drill(n_devices=4, num_replicas=2, num_steps=5, kill_replica=None,
                                quantize_outer=True, device="cpu")
    assert facts["restarts"] == 0
    assert not facts["healed"] and facts["heal_timings"] == {}
    _equal_states(facts["final_states"])


def test_joint_ft_spmd_refuses_chaos_without_sources() -> None:
    with pytest.raises(ValueError, match=">= 3 replicas"):
        joint_ft_spmd_drill(n_devices=4, num_replicas=2, heal_source_chaos=True, device="cpu")


@pytest.mark.slow
def test_joint_ft_spmd_striped_heal_with_source_kill() -> None:
    """3 groups, one killed: the rejoiner heals striped from the 2
    survivors while one survivor's transport dies after 16 KiB; the heal
    completes from the other source and the groups end bit-identical."""
    facts = joint_ft_spmd_drill(n_devices=6, num_replicas=3, num_steps=6, kill_replica=1,
                                kill_at_step=2, heal_source_chaos=True, device="cpu")
    assert facts["restarts"] == 1
    assert facts["healed"]
    assert facts["heal_source_killed"]
    assert facts["heal_timings"].get("heal_num_sources") == 2.0
    assert facts["heal_timings"].get("heal_bytes", 0) > 0
    _equal_states(facts["final_states"])


def test_postmortem_chain_python_tier() -> None:
    report = postmortem_drill(tier="python", device="cpu")
    assert report["chain_ok"]
    for key in ("t_inject", "t_distress", "t_poison", "t_shrink", "t_heal"):
        assert key in report, report
    assert report["t_inject"] < report["t_heal"]
    assert report["shrink_key"][0] >= 1  # a real quorum_id bump
    # survivors + restarted victim + original victim + lighthouse
    assert report["replicas_merged"] >= 4
    assert report["anchors"] > 0


def test_postmortem_chain_cpp_tier() -> None:
    assert native.available(), native._lib_error
    report = postmortem_drill(tier="cpp", device="cpu")
    assert report["chain_ok"]
    for key in ("t_inject", "t_poison", "t_shrink", "t_heal"):
        assert key in report, report
    assert report["t_inject"] < report["t_heal"]
    assert report["native_events"] > 0


def test_postmortem_drill_runs_on_the_card_by_default() -> None:
    """Like every entry point of the port, the drill holds its state on
    ``cuda`` unless told otherwise, and says so where there is no card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        postmortem_drill()


def test_coord_churn_drill_at_drill_scale() -> None:
    report = coord_churn_drill(num_replicas=30, num_spares=2, kills=1, deadline_s=90.0)
    assert report["promotions_total"] >= 1
    assert report["spurious_membership_edits"] == 0
    assert report["agg_bounce_edits"] == 0
