"""The port's ``LlamaMoE`` (``torchft_tpu_torch/models/llama_moe.py``) held
against the JAX package's (``torchft_tpu/models/llama_moe.py``), f32, the
JAX weights carried across by ``params_from_jax``; this file is also the
rank script of its mesh case.

- ``llama_moe_debug`` (4 experts, capacity factor 4.0) and the same at
  capacity factor 0.5 (tokens dropped): logits, loss and every parameter's
  gradient against the JAX model's, loss rtol 1e-5, gradients rtol 2e-4 /
  atol 1e-5; ``num_params`` as JAX counts it and as the module holds.
- Sharded by ``shard_model`` at fsdp = 2 × ep = 2 over gloo (four rank
  processes; the experts split over ep, everything else FSDP2 over fsdp):
  with no token past capacity (factor 4.0) the loss and gradients equal
  the JAX dense model's.  With overflow (factor 0.5) they equal the JAX
  model on a 2-device ep mesh run on each fsdp rank's rows apart and
  averaged, and differ from the JAX model on a fsdp = 2 × ep = 2 mesh:
  the port's capacity group is T_local/ep tokens, the JAX shard_map's
  T_global/ep (ROADMAP §C).  ``hsdp.placement_groups`` puts FSDP2's
  DTensors, the experts' ep DTensors and the plain tensors in groups of
  their own, so a foreach AdamW (the card's default) steps over them.
- Fault-tolerant HSDP at ep = 2: two replica groups of two ranks, group 1
  killed and healed rank by rank; every expert has a gradient on every
  step, the loss falls, and both groups end bit-identical.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, RTOL, ATOL = 1e-5, 2e-4, 1e-5
BATCH, SEQ = 2, 32
FACTORS = (4.0, 0.5)


def _tokens(vocab: int = 512):
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, vocab, size=(BATCH, SEQ))
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_params(cf: float):
    import jax

    from torchft_tpu.models.llama_moe import LlamaMoE, llama_moe_debug

    model = LlamaMoE(dataclasses.replace(llama_moe_debug(), capacity_factor=cf))
    return model, jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(0)))


def _port(params, cf: float):
    from torchft_tpu_torch.models.llama_moe import LlamaMoE, llama_moe_debug, params_from_jax

    model = LlamaMoE(dataclasses.replace(llama_moe_debug(), capacity_factor=cf), device="cpu")
    model.load_state_dict(params_from_jax(params))
    return model


def _jax_loss_grads(model, params, rows=slice(None), mesh=None):
    import jax

    tokens, targets = (a[rows].astype(np.int32) for a in _tokens())
    fn = jax.jit(jax.value_and_grad(model.loss))
    if mesh is None:
        loss, grads = fn(params, (tokens, targets))
    else:
        with mesh:
            loss, grads = fn(params, (tokens, targets))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def assert_close(got, want, err_msg: str = "") -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=err_msg)


def assert_grads(grads, jgrads) -> None:
    from torchft_tpu_torch.models.llama_moe import params_to_numpy

    got = params_to_numpy(grads, 2)
    for key in ("embed", "final_norm", "lm_head"):
        assert_close(got[key], jgrads[key], key)
    for key, want in jgrads["layers"].items():
        assert_close(got["layers"][key], want, key)
    for i, layer in enumerate(jgrads["moe_layers"]):
        for key, want in layer.items():
            assert_close(got["moe_layers"][i][key], want, f"moe {i} {key}")


@pytest.mark.parametrize("cf", FACTORS)
def test_dense_model_matches_jax(cf) -> None:
    jmodel, params = _jax_params(cf)
    model = _port(params, cf)
    tokens, targets = (torch.from_numpy(a) for a in _tokens())
    logits = model(tokens)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jmodel.apply(params, tokens.numpy())),
                               rtol=RTOL, atol=ATOL)
    loss = model.loss(tokens, targets)
    loss.backward()
    jloss, jgrads = _jax_loss_grads(jmodel, params)
    assert float(loss) == pytest.approx(jloss, rel=LOSS_RTOL)
    assert_grads({n: p.grad for n, p in model.named_parameters()}, jgrads)
    dropped = sum(int(m.last_dropped) for m in model.moe_layers())
    assert (dropped > 0) == (cf < 1.0)


def test_num_params_counts_as_jax() -> None:
    jmodel, params = _jax_params(4.0)
    model = _port(params, 4.0)
    assert model.num_params() == jmodel.num_params() == sum(p.numel() for p in model.parameters())
    from torchft_tpu_torch.models.llama_moe import LlamaMoE, llama3_8b_moe

    big = LlamaMoE(dataclasses.replace(llama3_8b_moe(), n_layers=1), device="meta")
    assert big.num_params() == 2_032_185_344 == sum(p.numel() for p in big.parameters())


# ---------------------------------------------------------------------------
# fsdp = 2 × ep = 2: the rank processes (run as a script)
# ---------------------------------------------------------------------------


def _worker(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from torchft_tpu_torch.parallel.hsdp import make_grad_step, placement_groups, shard_model
    from torchft_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    params = dict(np.load(os.path.join(out_dir, "params.npz"), allow_pickle=True))["tree"].item()
    for cf in FACTORS:
        mesh = make_mesh(fsdp=2, ep=2)
        model = shard_model(_port(params, cf), mesh)
        tokens, targets = (torch.from_numpy(a) for a in _tokens())
        loss = make_grad_step(model, mesh)(tokens, targets)
        grads = {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad).detach()
                 for n, p in model.named_parameters()}
        placements = {n: [str(x) for x in p.placements] for n, p in model.named_parameters()
                      if isinstance(p, DTensor) and n.startswith("layers.0.")}
        # the card's AdamW runs foreach kernels, one placement per call: FSDP2's
        # DTensors, the experts' ep DTensors and the plain router and norms
        groups = placement_groups(model.parameters())
        torch.optim.AdamW(groups, foreach=True).step()
        kinds = sorted(str(getattr(g["params"][0], "device_mesh", None) is not None
                           and g["params"][0].device_mesh.mesh_dim_names) for g in groups)
        torch.save({"loss": float(loss), "grads": grads, "placements": placements,
                    "optimizer_groups": kinds},
                   os.path.join(out_dir, f"cf{cf}_rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    import jax
    from jax.sharding import Mesh

    from torchft_tpu.models.llama_moe import LlamaMoE, llama_moe_debug
    from torchft_tpu.parallel.mesh import make_mesh
    from torchft_tpu_torch.train_hsdp import _free_port

    out = tmp_path_factory.mktemp("llama_moe_mesh")
    _, params = _jax_params(4.0)  # the init does not depend on the capacity factor
    np.savez(out / "params.npz", tree=np.asarray(params, dtype=object))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [
        subprocess.Popen([sys.executable, __file__, str(r), str(port), str(out)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)
    ]
    try:
        ref = {}
        for cf in FACTORS:
            cfg = dataclasses.replace(llama_moe_debug(), capacity_factor=cf)
            ref[("dense", cf)] = _jax_loss_grads(LlamaMoE(cfg), params)
            # the JAX EP model on each fsdp rank's rows apart (ep = 2 only)
            ep_mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 1, 2), ("fsdp", "tp", "ep"))
            ep_model = LlamaMoE(cfg, mesh=ep_mesh)
            ref[("per_rank_rows", cf)] = [_jax_loss_grads(ep_model, _on(params, ep_model, ep_mesh),
                                                          rows=slice(r, r + 1), mesh=ep_mesh)
                                          for r in range(2)]
            mesh = make_mesh(fsdp=2, ep=2, devices=jax.devices()[:4])
            model = LlamaMoE(cfg, mesh=mesh)
            ref[("fsdp2_ep2", cf)] = _jax_loss_grads(model, _on(params, model, mesh), mesh=mesh)
    finally:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return out, ref


def _on(params, model, mesh):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.tree_util.tree_map(lambda leaf, spec: jax.device_put(leaf, NamedSharding(mesh, spec)),
                                  params, model.param_specs(), is_leaf=lambda v: isinstance(v, P))


def test_fsdp2_ep2_without_overflow_matches_the_jax_dense_model(mesh_runs) -> None:
    out, ref = mesh_runs
    jloss, jgrads = ref[("dense", 4.0)]
    for r in range(4):
        got = torch.load(out / f"cf4.0_rank{r}.pt")
        assert got["loss"] == pytest.approx(jloss, rel=LOSS_RTOL)
        assert_grads(got["grads"], jgrads)
        # experts split over ep, attention FSDP2-sharded over fsdp
        assert got["placements"]["layers.0.moe.w_up"] == ["S(0)"]
        assert got["placements"]["layers.0.wq.weight"] == ["S(0)"]
        assert "layers.0.moe.router" not in got["placements"]
        # a foreach AdamW step took one placement per parameter group
        assert got["optimizer_groups"] == ["('ep',)", "('fsdp',)", "False"]


def test_capacity_groups_are_per_rank_rows_under_overflow(mesh_runs) -> None:
    """The deliberate departure: with tokens past capacity at fsdp = 2 the
    port routes each fsdp rank's rows apart (T_local/ep tokens a group),
    which the JAX EP model gives on each rank's rows apart, averaged; the
    JAX fsdp = 2 × ep = 2 model groups T_global/ep tokens and differs."""
    import jax

    out, ref = mesh_runs
    halves = ref[("per_rank_rows", 0.5)]
    jloss = np.mean([h[0] for h in halves])
    jgrads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, halves[0][1], halves[1][1])
    for r in range(4):
        got = torch.load(out / f"cf0.5_rank{r}.pt")
        assert got["loss"] == pytest.approx(jloss, rel=LOSS_RTOL)
        assert_grads(got["grads"], jgrads)
        assert abs(got["loss"] - ref[("fsdp2_ep2", 0.5)][0]) > 1e-4
    # without overflow all three agree
    assert ref[("fsdp2_ep2", 4.0)][0] == pytest.approx(ref[("dense", 4.0)][0], rel=1e-5)


def test_ft_hsdp_trains_llama_moe_at_ep2_and_heals_bit_exact() -> None:
    from torchft_tpu_torch.models.llama_moe import llama_moe_debug
    from torchft_tpu_torch.train_hsdp import run_hsdp_fleet

    fleet = run_hsdp_fleet(llama_moe_debug(), torch.device("cpu"), groups=2, ep=2, steps=5,
                           batch=1, seq=64, lr=3e-3, kill_at=(1, 2), tier="python", timeout=60.0)
    assert [g[0]["incarnation"] for g in fleet] == [0, 1]
    for rank in range(2):
        assert fleet[0][rank]["params_sha256"] == fleet[1][rank]["params_sha256"]
        assert fleet[0][rank]["local_params_sha256"] == fleet[1][rank]["local_params_sha256"]
        assert fleet[1][rank]["heal"] and fleet[1][rank]["heal"]["bytes"] > 0
    for g in fleet:
        for r in g:
            assert r["moe_params"] == 6 and not any(r["missing_moe_grads"])
    # a group cycles through 4 batches: its last step (4) sees step 0's again
    losses = fleet[0][0]["losses"]
    assert losses[-1] < losses[0]


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
