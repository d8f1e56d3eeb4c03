"""The port's switch MoE (``torchft_tpu_torch/parallel/moe.py``) held against
the JAX package's (``torchft_tpu/parallel/moe.py``) on the same weights and
inputs, f32; this file is also the rank script of its expert-parallel
cases.

- The dense path against ``MoE._apply_dense``: output and the gradients of
  ``sum(out · w)`` (a fixed numpy cotangent w) with respect to the router,
  w_up, w_down and x, rtol 2e-4 / atol 1e-5, at capacity factor 2.0 (no
  token dropped) and 1.0 (tokens dropped: the residual carries them); the
  dispatch mask of ``route`` bit-equal to the JAX ``_route``'s, and a tie
  in the router's probabilities going to the first expert, as
  ``jnp.argmax``.
- The expert-parallel path at ep = 2 over gloo (two rank processes, the
  experts split by ``split_experts``) against the JAX ``MoE`` on a
  2-device CPU mesh (``_apply_ep_local`` inside its shard_map), at
  capacity factor 8.0 and 1.0: the per-block capacity groups are the same
  in both (the JAX mesh has no fsdp axis), so even dropped tokens agree.
  Output on every rank, gradients of the router (equal on every rank) and
  of each rank's experts: rtol 2e-4 / atol 1e-5.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, FFN, E, T = 16, 32, 4, 32
RTOL, ATOL = 2e-4, 1e-5
CAPACITY_FACTORS = (2.0, 1.0)
EP_CASES = (8.0, 1.0)


def _inputs(num_experts: int = E):
    rng = np.random.default_rng(0)
    params = {
        "router": (rng.standard_normal((DIM, num_experts)) / np.sqrt(DIM)).astype(np.float32),
        "w_up": (rng.standard_normal((num_experts, DIM, FFN)) / np.sqrt(DIM)).astype(np.float32),
        "w_down": (rng.standard_normal((num_experts, FFN, DIM)) / np.sqrt(FFN)).astype(np.float32),
    }
    x = rng.standard_normal((1, T, DIM)).astype(np.float32)
    w = rng.standard_normal((1, T, DIM)).astype(np.float32)
    return params, x, w


def _port_moe(params, cf: float, num_experts: int = E):
    from torchft_tpu_torch.parallel.moe import MoE, MoEConfig

    moe = MoE(MoEConfig(dim=DIM, ffn_hidden=FFN, num_experts=num_experts, capacity_factor=cf),
              device="cpu")
    moe.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    return moe


def _port_run(moe, x, w):
    xt = torch.from_numpy(x).requires_grad_()
    out = moe(xt)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach(), xt.grad


def _jax_run(params, x, w, cf: float, num_experts: int = E, mesh=None):
    import jax
    import jax.numpy as jnp

    from torchft_tpu.parallel.moe import MoE, MoEConfig

    moe = MoE(MoEConfig(dim=DIM, ffn_hidden=FFN, num_experts=num_experts, capacity_factor=cf),
              mesh=mesh)

    def f(p, xx):
        return jnp.sum(moe.apply(p, xx) * w)

    if mesh is None:
        out = moe.apply(params, x)
        grads = jax.grad(f, argnums=(0, 1))(params, x)
    else:
        with mesh:
            out = jax.jit(moe.apply)(params, x)
            grads = jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


def assert_close(got, want, err_msg: str = "") -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=err_msg)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_dense_path_matches_jax(cf) -> None:
    params, x, w = _inputs()
    moe = _port_moe(params, cf)
    out, dx = _port_run(moe, x, w)
    jout, (jgrads, jdx) = _jax_run(params, x, w, cf)
    assert_close(out, jout)
    assert_close(dx, jdx, "x")
    for name in ("router", "w_up", "w_down"):
        assert_close(getattr(moe, name).grad, jgrads[name], name)
    dropped = int(moe.last_dropped)
    assert (dropped > 0) == (cf == 1.0), dropped


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_dispatch_mask_is_bit_equal_to_jax(cf) -> None:
    import jax.numpy as jnp

    from torchft_tpu.parallel.moe import MoE as JaxMoE, MoEConfig as JaxConfig
    from torchft_tpu_torch.parallel.moe import capacity, route

    params, x, _ = _inputs()
    flat = x.reshape(T, DIM)
    cap = capacity(cf, T, E)
    jmoe = JaxMoE(JaxConfig(dim=DIM, ffn_hidden=FFN, num_experts=E, capacity_factor=cf))
    jdispatch, jcombine = jmoe._route({k: jnp.asarray(v) for k, v in params.items()},
                                      jnp.asarray(flat), cap)
    dispatch, combine, keep = route(torch.from_numpy(params["router"]), torch.from_numpy(flat), cap)
    assert dispatch.shape == (E, cap, T) and dispatch.dtype == torch.float32
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jdispatch))
    assert_close(combine, jcombine)
    assert int((~keep).sum()) == T - int(np.asarray(jdispatch).sum())


def test_a_tie_goes_to_the_first_expert() -> None:
    from torchft_tpu_torch.parallel.moe import route

    router = torch.zeros(DIM, E)  # every expert equally likely
    dispatch, _, keep = route(router, torch.ones(3, DIM), cap=4)
    assert bool(keep.all()) and dispatch[0].sum() == 3 and dispatch[1:].sum() == 0


def test_moe_defaults_to_the_card() -> None:
    from torchft_tpu_torch.parallel.moe import MoE, MoEConfig

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MoE(MoEConfig(dim=DIM, ffn_hidden=FFN, num_experts=E))


# ---------------------------------------------------------------------------
# expert parallelism: the rank processes (run as a script)
# ---------------------------------------------------------------------------

EP_EXPERTS = 8


def _worker(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from torchft_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    mesh = make_mesh(ep=2)
    params, x, w = _inputs(EP_EXPERTS)
    for cf in EP_CASES:
        moe = _port_moe(params, cf, EP_EXPERTS)
        moe.split_experts(mesh["ep"])
        out, dx = _port_run(moe, x, w)
        torch.save({"out": out, "dx": dx, "router": moe.router.grad,
                    "w_up": moe.w_up.grad.to_local(), "w_down": moe.w_down.grad.to_local(),
                    "local_experts": moe.w_up.to_local().shape[0],
                    "dropped": int(moe.last_dropped)},
                   os.path.join(out_dir, f"ep_cf{cf}_rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    import jax
    from jax.sharding import Mesh

    from torchft_tpu_torch.train_hsdp import _free_port

    out = tmp_path_factory.mktemp("moe_ep")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [
        subprocess.Popen([sys.executable, __file__, str(r), str(port), str(out)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    try:
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("ep",))
        params, x, w = _inputs(EP_EXPERTS)
        jax_runs = {cf: _jax_run(params, x, w, cf, EP_EXPERTS, mesh=mesh) for cf in EP_CASES}
    finally:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return out, jax_runs


@pytest.mark.parametrize("cf", EP_CASES)
def test_expert_parallel_path_matches_jax_ep(ep_runs, cf) -> None:
    out, jax_runs = ep_runs
    jout, (jgrads, jdx) = jax_runs[cf]
    ranks = [torch.load(out / f"ep_cf{cf}_rank{r}.pt") for r in range(2)]
    half = EP_EXPERTS // 2
    for r, got in enumerate(ranks):
        assert got["local_experts"] == half
        assert_close(got["out"], jout, f"out rank {r}")
        assert_close(got["dx"], jdx, f"x rank {r}")
        assert_close(got["router"], jgrads["router"], f"router rank {r}")
        for name in ("w_up", "w_down"):
            assert_close(got[name], jgrads[name][r * half:(r + 1) * half], f"{name} rank {r}")
    assert (sum(r["dropped"] for r in ranks) > 0) == (cf == 1.0)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
