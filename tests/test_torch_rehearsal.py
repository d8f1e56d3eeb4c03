"""The port's scale rehearsal (``torchft_tpu_torch/parallel/rehearsal.py``)
held against the JAX package's (``torchft_tpu/parallel/rehearsal.py``,
``tests/test_rehearsal.py``).

- Bytes per card (``lower=False``): parameters, gradients, optimizer state,
  the activation estimate and their total equal the JAX rehearsal's within
  a relative 1e-3 for the JAX package's three baseline configurations and
  the debug model (the port's AdamW keeps a 4-byte step per parameter
  where optax keeps one count); the ``ok`` verdicts agree, each package at
  its own card's memory (H100 80 GB, v5p 95 GB).
- What neither layout can take is caught: tp = 12 on the 8B (its FFN of
  14336 does not split 12 ways; the 32 heads do not either, which the port
  takes by keeping attention whole), a batch that does not divide by
  dp·fsdp, and the 8B replicated on one card.  What only the port cannot
  take: pp > 1 on a model that is not pipelined, ep > 1 on one without
  experts, experts that do not divide by ep.
- Lowering (``lower=True``): one subprocess traces all three H100 baseline
  configs (the real grad step and AdamW step over a fake process group of
  8, 16 and 64 ranks), another the debug model at dp = fsdp = tp = 2, the
  MoE at fsdp = 2 × ep = 2 and the pipeline at pp = 2 × fsdp = 2; each
  lowering's local shapes add up to the arithmetic's bytes.
- ``quant_kernel_reports`` raises without a card; the ``cuda``-marked
  test runs it on one (``python -m pytest --noconftest -m cuda
  tests/test_torch_rehearsal.py``).
"""

import dataclasses

import pytest
import torch

KEYS = ("params", "grads", "opt_state", "activations_est", "total")


def _jax_debug_report():
    import optax

    from torchft_tpu.models.llama import Llama, llama_debug
    from torchft_tpu.parallel.rehearsal import rehearse

    return rehearse(Llama(llama_debug()), optax.adamw(1e-3), {"dp": 2, "fsdp": 2, "tp": 2},
                    batch=8, seq=256, name="debug", lower=False)


def _port_debug_report(**kw):
    from torchft_tpu_torch.models.llama import Llama, llama_debug
    from torchft_tpu_torch.parallel.rehearsal import rehearse

    return rehearse(Llama(llama_debug(), "meta"), None, {"dp": 2, "fsdp": 2, "tp": 2}, batch=8,
                    seq=256, name="debug", **kw)


def test_bytes_per_card_equal_jax_on_the_baselines_and_the_debug_model() -> None:
    from torchft_tpu.parallel.rehearsal import baseline_reports as jax_baselines
    from torchft_tpu_torch.parallel.rehearsal import baseline_reports

    pairs = list(zip(baseline_reports(lower=False), jax_baselines(lower=False)))
    pairs.append((_port_debug_report(lower=False), _jax_debug_report()))
    for port, jax_report in pairs:
        assert port.mesh_axes == jax_report.mesh_axes and port.remat == jax_report.remat
        for key in KEYS:
            assert port.bytes_per_device[key] == pytest.approx(
                jax_report.bytes_per_device[key], rel=1e-3), (port.name, key)
        # each at its own card's memory
        assert port.hbm_bytes == 80e9 and jax_report.hbm_bytes == 95e9
        assert port.ok == jax_report.ok, (port.summary(), jax_report.summary())


def test_bad_tp_is_caught_in_the_ffn_not_the_heads() -> None:
    import optax

    from torchft_tpu.models.llama import Llama as JaxLlama, llama3_8b as jax_8b
    from torchft_tpu.parallel.rehearsal import rehearse as jax_rehearse
    from torchft_tpu_torch.models.llama import Llama, llama3_8b
    from torchft_tpu_torch.parallel.rehearsal import rehearse

    axes = {"dp": 1, "fsdp": 2, "tp": 12}
    r = rehearse(Llama(llama3_8b(), "meta"), None, axes, batch=8, seq=8192, name="bad_tp",
                 lower=False)
    j = jax_rehearse(JaxLlama(jax_8b()), optax.adamw(1e-3), axes, batch=8, seq=8192,
                     name="bad_tp", lower=False)
    assert not r.ok and not j.ok and r.divisibility_errors and j.divisibility_errors
    failed = {e.split(":")[0].split(".")[-2] for e in r.divisibility_errors}
    assert failed == {"w_gate", "w_up", "w_down"}, r.divisibility_errors


def test_batch_must_divide_the_data_axes() -> None:
    from torchft_tpu_torch.models.llama import Llama, llama_debug
    from torchft_tpu_torch.parallel.rehearsal import rehearse

    r = rehearse(Llama(llama_debug(), "meta"), None, {"dp": 2, "fsdp": 2, "tp": 1}, batch=6,
                 seq=256, name="bad_batch", lower=False)
    assert not r.ok and any("batch" in e for e in r.divisibility_errors)


def test_overflow_of_the_card_is_caught() -> None:
    from torchft_tpu_torch.models.llama import Llama, llama3_8b
    from torchft_tpu_torch.parallel.rehearsal import rehearse

    r = rehearse(Llama(llama3_8b(), "meta"), None, {"dp": 1, "fsdp": 1, "tp": 1}, batch=8,
                 seq=8192, name="too_big", lower=False)
    assert not r.ok and not r.divisibility_errors and r.hbm_frac > 1.0


@pytest.mark.parametrize("case", ["pp_on_llama", "ep_on_llama", "experts_over_ep"])
def test_what_only_the_port_cannot_take(case) -> None:
    from torchft_tpu_torch.models.llama import Llama, llama_debug
    from torchft_tpu_torch.models.llama_moe import LlamaMoE, llama_moe_debug
    from torchft_tpu_torch.parallel.rehearsal import rehearse

    model, axes, needle = {
        "pp_on_llama": (Llama(llama_debug(), "meta"), {"pp": 2}, "needs a PipelinedLlama"),
        "ep_on_llama": (Llama(llama_debug(), "meta"), {"ep": 2}, "needs a LlamaMoE"),
        "experts_over_ep": (LlamaMoE(llama_moe_debug(), "meta"), {"ep": 3}, "ep=3"),
    }[case]
    r = rehearse(model, None, axes, batch=6, seq=96, lower=False)
    assert not r.ok and any(needle in e for e in r.divisibility_errors), r.divisibility_errors


def test_one_subprocess_lowers_the_three_h100_baselines() -> None:
    from torchft_tpu_torch.parallel.rehearsal import baseline_reports

    reports = {r.name: r for r in baseline_reports(lower=True)}
    assert len(reports) == 3
    for name, r in reports.items():
        assert r.ok and r.lowered_grad and r.lowered_update, r.summary()
        assert r.error is None and r.hbm_frac < 0.8 and r.bytes_per_device["total"] > 1e9
    per_card = {n: r.bytes_per_device["params"] for n, r in reports.items()}
    assert max(per_card, key=per_card.get).startswith("config5_70b")


def test_the_debug_moe_and_pipeline_lower() -> None:
    from torchft_tpu_torch.models.llama import Llama, llama_debug
    from torchft_tpu_torch.models.llama_moe import LlamaMoE, llama_moe_debug
    from torchft_tpu_torch.parallel.pipeline import PipelinedLlama
    from torchft_tpu_torch.parallel.rehearsal import _rehearse_many

    configs = [
        (Llama(llama_debug(), "meta"), None, {"dp": 2, "fsdp": 2, "tp": 2}, 8, 256, "debug", "h100"),
        (LlamaMoE(llama_moe_debug(), "meta"), None, {"fsdp": 2, "ep": 2}, 8, 256, "moe", "h100"),
        (PipelinedLlama(llama_debug(), "meta", pp=2, num_microbatches=2), None,
         {"pp": 2, "fsdp": 2}, 8, 256, "pipeline", "h100"),
    ]
    for r in _rehearse_many(configs, lower=True):
        assert r.ok and r.lowered_grad and r.lowered_update, r.summary()


def test_remat_is_the_configs_and_the_70b_preset_is_jaxs() -> None:
    from torchft_tpu.models.llama import Llama as JaxLlama, llama3_70b as jax_70b
    from torchft_tpu_torch.models.llama import Llama, llama3_70b
    from torchft_tpu_torch.parallel.rehearsal import rehearse

    cfg = dataclasses.replace(llama3_70b(), remat_mode="attn")
    r = rehearse(Llama(cfg, "meta"), None, {"fsdp": 16, "tp": 4}, batch=16, seq=8192,
                 lower=False)
    assert r.remat == "attn"
    assert Llama(llama3_70b(), "meta").num_params() == JaxLlama(jax_70b()).num_params()


def test_quant_kernel_reports_raises_without_a_card() -> None:
    from torchft_tpu_torch.parallel.rehearsal import quant_kernel_reports

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quant_kernel_reports()


@pytest.mark.cuda
def test_quant_kernel_reports_on_the_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from torchft_tpu_torch.parallel.rehearsal import quant_kernel_reports

    rows = quant_kernel_reports()
    assert {(r["kernel"], r["kind"]) for r in rows if "kind" in r} == {
        (k, w) for k in ("quantize", "reduce", "dequantize") for w in ("int8", "fp8")}
    flash = [r for r in rows if r["kernel"] == "flash"]
    assert [(r["heads"], r["kv_heads"]) for r in flash] == [(32, 8), (16, 4), (16, 2)]
    assert all(r["launched"] for r in rows)
