"""The port's pipeline parallelism (``torchft_tpu_torch/parallel/pipeline.py``)
and rematerialization (``models/llama.py``) held against the JAX package's,
on the CPU over gloo, each rank its own process; this file is also the
rank script.  f32 throughout.

- The engine (``pipeline_spmd``) on a toy stack of 8 ``tanh(h @ W)``
  layers, 4 microbatches: over 4 gloo ranks (one stage each) and with
  every stage in one process, output and the gradients of W and x against
  a plain loop over the layers and the output against the JAX
  ``pipeline_spmd`` on ``make_mesh(pp=4)``: rtol 1e-5, atol 1e-6.
- ``PipelinedLlama`` (4 layers, ``tests/test_pipeline.py``'s widths),
  sharded by ``shard_model`` at pp = 2, pp = 2 × tp = 2, pp = 2 × fsdp = 2,
  pp = 2 with ``remat=True`` and pp = 2 × sp = 2: loss and every
  parameter's gradient against the JAX ``Llama`` (dense, no pipeline) at
  the port's seeded weights, loss rtol 1e-5, gradients rtol 2e-4 / atol
  1e-5 (the JAX pipeline tests' own tolerances; the JAX pp × sp test
  allows rtol 1e-3 on the loss, 5e-3 / 5e-5 on gradients).  Each pp rank
  keeps only its stage's layers.
- The same model with every stage in one process (what the card runs)
  against the port's plain ``Llama``, and the validation errors raised as
  JAX raises them.
- Remat: each of the four modes gives the loss and gradients of "none"
  (``tests/test_llama_parallel.py``'s cases), and the config's mode
  resolves as the JAX config's.
- Fault-tolerant HSDP over ``PipelinedLlama`` at pp = 2: two replica
  groups of two ranks, group 1 killed and healed rank by rank, the loss
  falls and both groups end bit-identical.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED, TOKENS_SEED = 0, 1
LOSS_RTOL, RTOL, ATOL = 1e-5, 2e-4, 1e-5
TOY_L, TOY_D, TOY_B, TOY_M = 8, 16, 8, 4
# name: (mesh axes, ranks (None: all 4), batch, microbatches, remat, sp)
LAYOUTS = {
    "pp2": (dict(pp=2), [0, 1], 8, 4, False, False),
    "pp2_tp2": (dict(pp=2, tp=2), None, 8, 4, False, False),
    "pp2_fsdp2": (dict(pp=2, fsdp=2), None, 8, 4, False, False),
    "pp2_remat": (dict(pp=2), [0, 1], 8, 2, True, False),
    "pp2_sp2": (dict(pp=2, sp=2), None, 4, 2, False, True),
}
SEQ = 32


def _cfg(n_layers: int = 4):
    from torchft_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=512, dim=64, n_layers=n_layers, n_heads=4, n_kv_heads=2,
                       ffn_hidden=128, max_seq_len=64, dtype=torch.float32)


def _tokens(batch: int, vocab: int = 512):
    rng = np.random.default_rng(TOKENS_SEED)
    tokens = rng.integers(0, vocab, size=(batch, SEQ))
    return tokens, np.roll(tokens, -1, axis=1)


def _toy():
    rng = np.random.default_rng(SEED)
    stack = (rng.standard_normal((TOY_L, TOY_D, TOY_D)) * 0.3).astype(np.float32)
    x = rng.standard_normal((TOY_B, 4, TOY_D)).astype(np.float32)
    return stack, x


def _toy_stage_fn(ws, per: int):
    def stage_fn(j, h):
        for w in ws[j * per:(j + 1) * per]:
            h = torch.tanh(h @ w)
        return h

    return stage_fn


def _seeded(cfg):
    from torchft_tpu_torch.models.llama import Llama

    return Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))


def assert_close(got, want, rtol=RTOL, atol=ATOL, err_msg: str = "") -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=err_msg)


# ---------------------------------------------------------------------------
# the rank processes (run as a script)
# ---------------------------------------------------------------------------


def _worker(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from torchft_tpu_torch.parallel.hsdp import make_grad_step, shard_model
    from torchft_tpu_torch.parallel.mesh import make_mesh
    from torchft_tpu_torch.parallel.pipeline import PipelinedLlama, pipeline_spmd

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)

    # the toy engine, one stage per rank
    stack, x = _toy()
    mesh = make_mesh(pp=4)
    per = TOY_L // 4
    ws = [torch.from_numpy(w).requires_grad_(rank * per <= i < (rank + 1) * per)
          for i, w in enumerate(stack)]
    xt = torch.from_numpy(x).requires_grad_()
    y = pipeline_spmd(_toy_stage_fn(ws, per), xt, num_stages=4, num_microbatches=TOY_M,
                      group=mesh["pp"].get_group())
    torch.sin(y).sum().backward()
    torch.save({"y": y.detach(), "dx": xt.grad,
                "dw": {i: w.grad for i, w in enumerate(ws) if w.grad is not None}},
               os.path.join(out_dir, f"toy_rank{rank}.pt"))

    cfg = _cfg()
    for name, (axes, ranks, batch, m, remat, sp) in LAYOUTS.items():
        mesh = make_mesh(ranks=ranks, **axes)
        if mesh.get_coordinate() is None:
            continue
        c = dataclasses.replace(cfg, sp_axis="sp") if sp else cfg
        model = PipelinedLlama(c, device="cpu", pp=2, num_microbatches=m, remat=remat)
        model.load_state_dict(_seeded(cfg).state_dict())
        shard_model(model, mesh)
        tokens, targets = (torch.from_numpy(a) for a in _tokens(batch))
        loss = make_grad_step(model, mesh)(tokens, targets)
        grads = {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad).detach()
                 for n, p in model.named_parameters()}
        torch.save({"loss": float(loss), "grads": grads, "stage": model.stage,
                    "layers": sorted(int(k) for k in model.layers)},
                   os.path.join(out_dir, f"{name}_rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank processes' results, with the JAX package's on the same
    inputs, computed while the ranks run."""
    from torchft_tpu_torch.train_hsdp import _free_port

    out = tmp_path_factory.mktemp("pipeline")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("TORCHFT_FLASH", None)
    procs = [
        subprocess.Popen([sys.executable, __file__, str(r), str(port), str(out)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)
    ]
    try:
        jax_toy = _jax_toy()
        jax_llama = {batch: _jax_llama(batch) for batch in {v[2] for v in LAYOUTS.values()}}
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return out, jax_toy, jax_llama


def _jax_toy():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from torchft_tpu.parallel.mesh import make_mesh
    from torchft_tpu.parallel.pipeline import pipeline_spmd

    stack, x = _toy()
    mesh = make_mesh(pp=4, devices=jax.devices()[:4])

    def stage_fn(local, h):
        def body(carry, w):
            return jnp.tanh(carry @ w), None

        return jax.lax.scan(body, h, local)[0]

    with mesh:
        out = jax.jit(lambda s, h: pipeline_spmd(stage_fn, s, h, mesh=mesh, num_microbatches=TOY_M))(
            jax.device_put(stack, NamedSharding(mesh, P("pp"))), x)
    return np.asarray(out)


def _jax_llama(batch: int):
    """Loss and gradients of the JAX dense ``Llama`` at the port's seeded
    weights."""
    import jax

    from torchft_tpu.models.llama import Llama as JaxLlama, LlamaConfig as JaxConfig
    from torchft_tpu_torch.models.llama import params_to_numpy

    cfg = _cfg()
    params = params_to_numpy(_seeded(cfg).state_dict(), cfg.n_layers)
    jmodel = JaxLlama(JaxConfig(vocab_size=512, dim=64, n_layers=4, n_heads=4, n_kv_heads=2,
                                ffn_hidden=128, max_seq_len=64, dtype=np.float32))
    tokens, targets = (a.astype(np.int32) for a in _tokens(batch))
    loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(params, (tokens, targets))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _plain_toy():
    stack, x = _toy()
    ws = [torch.from_numpy(w).requires_grad_() for w in stack]
    xt = torch.from_numpy(x).requires_grad_()
    y = _toy_stage_fn(ws, TOY_L)(0, xt)
    torch.sin(y).sum().backward()
    return y.detach(), xt.grad, [w.grad for w in ws]


def test_engine_over_gloo_matches_a_plain_loop_and_jax(runs) -> None:
    out, jax_toy, _ = runs
    y, dx, dw = _plain_toy()
    ranks = [torch.load(out / f"toy_rank{r}.pt") for r in range(4)]
    for r in ranks:  # the last stage's output reaches every stage
        assert_close(r["y"], y, rtol=1e-5, atol=1e-6)
        assert_close(r["y"], jax_toy, rtol=1e-5, atol=1e-6)
    assert_close(ranks[0]["dx"], dx, rtol=1e-5, atol=1e-6)
    held = {i: g for r in ranks for i, g in r["dw"].items()}
    assert sorted(held) == list(range(TOY_L))
    for i, g in held.items():
        assert_close(g, dw[i], rtol=1e-5, atol=1e-6, err_msg=f"W{i}")


@pytest.mark.parametrize("remat", [False, True])
def test_engine_in_one_process_matches_a_plain_loop(remat) -> None:
    from torchft_tpu_torch.parallel.pipeline import pipeline_spmd

    y0, dx0, dw0 = _plain_toy()
    stack, x = _toy()
    ws = [torch.from_numpy(w).requires_grad_() for w in stack]
    xt = torch.from_numpy(x).requires_grad_()
    y = pipeline_spmd(_toy_stage_fn(ws, TOY_L // 4), xt, num_stages=4, num_microbatches=TOY_M,
                      remat=remat)
    torch.sin(y).sum().backward()
    # the microbatches' gradient partials sum in another order
    assert_close(y.detach(), y0, rtol=1e-5, atol=1e-6)
    assert_close(xt.grad, dx0, rtol=1e-5, atol=1e-6)
    for w, g in zip(ws, dw0):
        assert_close(w.grad, g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipelined_llama_matches_the_jax_llama(runs, layout) -> None:
    from torchft_tpu_torch.models.llama import params_to_numpy

    out, _, jax_llama = runs
    axes, ranks, batch, _m, _remat, _sp = LAYOUTS[layout]
    jloss, jgrads = jax_llama[batch]
    results = [torch.load(out / f"{layout}_rank{r}.pt") for r in (ranks or range(4))]
    grads = {}
    for r in results:
        assert_close(r["loss"], jloss, rtol=LOSS_RTOL, atol=0)
        grads.update(r["grads"])
    got = params_to_numpy(grads, 4)
    for key in ("embed", "final_norm", "lm_head"):
        assert_close(got[key], jgrads[key], err_msg=key)
    for key, want in jgrads["layers"].items():
        assert_close(got["layers"][key], want, err_msg=key)
    # every rank of a stage holds that stage's layers and no other
    for r in results:
        assert r["layers"] == [2 * r["stage"], 2 * r["stage"] + 1]


def test_every_stage_in_one_process_matches_the_plain_llama() -> None:
    from torchft_tpu_torch.parallel.pipeline import PipelinedLlama

    cfg = _cfg()
    base = _seeded(cfg)
    tokens, targets = (torch.from_numpy(a) for a in _tokens(8))
    loss0 = base.loss(tokens, targets)
    loss0.backward()
    for remat in (False, True):
        model = PipelinedLlama(cfg, device="cpu", pp=2, num_microbatches=4, remat=remat)
        model.load_state_dict(base.state_dict())
        loss = model.loss(tokens, targets)
        loss.backward()
        assert float(loss) == pytest.approx(float(loss0), rel=1e-6)
        want = dict(base.named_parameters())
        for n, p in model.named_parameters():
            assert_close(p.grad, want[n].grad, rtol=1e-5, atol=1e-7, err_msg=n)


def test_validation_errors_as_jax() -> None:
    from torchft_tpu_torch.parallel.pipeline import PipelinedLlama

    with pytest.raises(ValueError, match="not divisible"):
        PipelinedLlama(_cfg(n_layers=3), device="cpu", pp=2)
    model = PipelinedLlama(_cfg(), device="cpu", pp=2, num_microbatches=3)
    assert PipelinedLlama(_cfg(), device="cpu", pp=2).num_microbatches == 8  # 4·pp
    tokens, targets = (torch.from_numpy(a) for a in _tokens(8))
    with pytest.raises(ValueError, match="not divisible"):
        model.loss(tokens, targets)


@pytest.mark.parametrize("mode", ["attn", "ffn", "layer"])
def test_remat_modes_match_none(mode) -> None:
    from torchft_tpu_torch.models.llama import Llama, llama_debug

    tokens, targets = (torch.from_numpy(a) for a in _tokens(2))
    results = {}
    for m in ("none", mode):
        model = Llama(dataclasses.replace(llama_debug(), remat_mode=m), device="cpu",
                      generator=torch.Generator().manual_seed(SEED))
        loss = model.loss(tokens, targets)
        loss.backward()
        results[m] = (float(loss), {n: p.grad for n, p in model.named_parameters()})
    assert results[mode][0] == pytest.approx(results["none"][0], rel=1e-6)
    for n, g in results["none"][1].items():
        assert_close(results[mode][1][n], g, rtol=1e-5, atol=1e-6, err_msg=f"{mode}: {n}")


def test_remat_config_resolves_as_jax() -> None:
    from torchft_tpu.models.llama import llama_debug as jax_debug
    from torchft_tpu_torch.models.llama import llama3_70b, llama_debug

    for kw in ({}, {"remat": True}, {"remat_mode": "attn"}, {"remat": True, "remat_mode": "ffn"}):
        assert (dataclasses.replace(llama_debug(), **kw).effective_remat_mode
                == dataclasses.replace(jax_debug(), **kw).effective_remat_mode)
    with pytest.raises(ValueError, match="unknown remat_mode"):
        dataclasses.replace(llama_debug(), remat_mode="bogus").effective_remat_mode
    c = llama3_70b()
    assert (c.dim, c.n_layers, c.n_heads, c.n_kv_heads, c.ffn_hidden) == (8192, 80, 64, 8, 28672)


def test_ft_hsdp_trains_a_pipelined_llama_and_heals_bit_exact() -> None:
    """``HSDPTrainer`` under ``train_hsdp`` over PipelinedLlama at pp = 2:
    two groups of two ranks, group 1 killed before step 2 and healed rank
    by rank; the loss on a batch falls when it comes round again, and
    every rank of both groups ends with the
    same parameters as its peer."""
    from torchft_tpu_torch.models.llama import llama_debug
    from torchft_tpu_torch.train_hsdp import run_hsdp_fleet

    fleet = run_hsdp_fleet(llama_debug(), torch.device("cpu"), groups=2, pp=2, microbatches=2,
                           steps=5, batch=2, seq=64, lr=3e-3, kill_at=(1, 2), tier="python",
                           timeout=60.0)
    assert [g[0]["incarnation"] for g in fleet] == [0, 1]
    for rank in range(2):
        assert fleet[0][rank]["params_sha256"] == fleet[1][rank]["params_sha256"]
        assert fleet[0][rank]["local_params_sha256"] == fleet[1][rank]["local_params_sha256"]
        assert fleet[1][rank]["heal"] and fleet[1][rank]["heal"]["bytes"] > 0
    # a group cycles through 4 batches: its last step (4) sees step 0's again
    losses = fleet[0][0]["losses"]
    assert losses[-1] < losses[0]
    # the two stages hold different layers
    assert fleet[0][0]["params_sha256"] != fleet[0][1]["params_sha256"]


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
