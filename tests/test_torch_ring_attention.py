"""The port's sequence parallelism (``torchft_tpu_torch/parallel/ring_attention.py``,
``Llama(sp_axis=...)``, the sp axis of ``parallel/hsdp.py``) held against
the JAX package's, on the CPU over gloo, each rank its own process; this
file is also the rank script.

- Ring attention at sp = 4 and sp = 2 (S_blk = 128), on the flash branch
  (``TORCHFT_FLASH=1``: the kernels' plain versions here, interpret-mode
  Pallas in JAX, as ``tests/test_flash_attention.py`` runs it) and on the
  online-softmax branch (``TORCHFT_FLASH=0``): output and q/k/v gradients
  of ``sum(sin(o))`` against JAX ``ring_attention_sharded`` on the CPU
  mesh.  f32; o within rtol 1e-5 / atol 1e-5, gradients within rtol 1e-4
  / atol 1e-5 (tighter than the JAX package's own ring tests, 2e-4 and
  1e-3).
- The single-process schedule (``ring_attention_blocks``, what the card
  runs) against the distributed ring: the same blocks, within rtol 1e-6 /
  atol 1e-6 (the same arithmetic in the same order).
- ``llama_debug`` with ``sp_axis`` at sp = 4 and at sp = 2 × tp = 2
  (sequence 64: blocks under 128, the online-softmax branch), and at sp = 4
  on sequence 512 under ``TORCHFT_FLASH=1`` (blocks of 128: the flash ring
  inside the layers, with RoPE's global offsets, against interpret-mode
  Pallas in JAX), sharded by ``shard_model`` (FSDP2 over the flattened
  fsdp·sp axis): loss and every parameter's gradient against the JAX model
  at ``make_mesh(sp=4)``, the weights carried by ``params_from_jax``'s
  inverse: loss within 1e-5, gradients within rtol 1e-4 / atol 1e-6 times
  each gradient's largest magnitude (the JAX package's sp test allows rtol
  5e-3 / atol 5e-5).
- One ``train_hsdp`` step at fsdp = 2 × sp = 2: four rank processes, every
  gradient of a sharded parameter a DTensor, the loss the dense model's.
- The card's gate: on a CUDA device every block length goes to the flash
  kernels (never the online-softmax branch), with block sizes the
  wrapper's check takes, and ``TORCHFT_FLASH=0`` raises.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
B, H, KV, D, S_BLK = 1, 4, 2, 64, 128
RING = [(4, "flash"), (4, "online"), (2, "flash"), (2, "online")]
# name: (mesh axes, sequence length, TORCHFT_FLASH)
LAYOUTS = {
    "sp4": (dict(sp=4), 64, None),
    "sp2_tp2": (dict(sp=2, tp=2), 64, None),
    "sp4_flash": (dict(sp=4), 512, "1"),
}
LLAMA_BATCH, TOKENS_SEED = 2, 7


def _qkv(S: int):
    rng = np.random.default_rng(SEED)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))


def _tokens(vocab: int, seq: int):
    rng = np.random.default_rng(TOKENS_SEED)
    tokens = rng.integers(0, vocab, size=(LLAMA_BATCH, seq))
    return tokens, np.roll(tokens, -1, axis=1)


# ---------------------------------------------------------------------------
# the rank processes (run as a script)
# ---------------------------------------------------------------------------


def _worker(rank: int, port: int, out_dir: str) -> None:
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from torchft_tpu_torch.models.llama import Llama, llama_debug
    from torchft_tpu_torch.parallel.hsdp import make_grad_step, shard_model
    from torchft_tpu_torch.parallel.mesh import make_mesh
    from torchft_tpu_torch.parallel.ring_attention import ring_attention

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)

    for sp, branch in RING:
        mesh = make_mesh(sp=sp, ranks=range(sp))
        if mesh.get_coordinate() is None:
            continue
        os.environ["TORCHFT_FLASH"] = "1" if branch == "flash" else "0"
        blk = slice(rank * S_BLK, (rank + 1) * S_BLK)
        q, k, v = (torch.from_numpy(a[:, blk]).requires_grad_() for a in _qkv(sp * S_BLK))
        o = ring_attention(q, k, v, mesh["sp"].get_group())
        torch.sin(o).sum().backward()
        torch.save({"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad},
                   os.path.join(out_dir, f"ring_sp{sp}_{branch}_rank{rank}.pt"))
    os.environ.pop("TORCHFT_FLASH", None)

    cfg = dataclasses.replace(llama_debug(), sp_axis="sp")
    for name, (axes, seq, flash) in LAYOUTS.items():
        os.environ.pop("TORCHFT_FLASH", None)
        if flash is not None:
            os.environ["TORCHFT_FLASH"] = flash
        tokens, targets = (torch.from_numpy(a) for a in _tokens(cfg.vocab_size, seq))
        mesh = make_mesh(**axes)
        model = shard_model(Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED)),
                            mesh)
        params = dict(model.named_parameters())
        loss = make_grad_step(model, mesh)(tokens, targets)
        grads = {n: (p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad).detach()
                 for n, p in params.items()}
        if rank == 0:
            torch.save({"loss": float(loss), "grads": grads}, os.path.join(out_dir, f"{name}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The rank processes' results, with the JAX package's on the same
    inputs, computed while the ranks run."""
    from torchft_tpu_torch.train_hsdp import _free_port

    out = tmp_path_factory.mktemp("ring")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("TORCHFT_FLASH", None)
    procs = [
        subprocess.Popen([sys.executable, __file__, str(r), str(port), str(out)], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)
    ]
    try:
        jax_ring = {(sp, branch): _jax_ring(sp, branch) for sp, branch in RING}
        jax_llama = {key: _jax_llama(*key) for key in {(seq, flash) for _, seq, flash in
                                                        LAYOUTS.values()}}
    finally:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return out, jax_ring, jax_llama


def _jax_ring(sp: int, branch: str):
    """o and the q/k/v gradients of sum(sin(o)) through JAX
    ``ring_attention_sharded`` on ``make_mesh(sp=sp)``."""
    import jax
    import jax.numpy as jnp

    from torchft_tpu.parallel.mesh import make_mesh
    from torchft_tpu.parallel.ring_attention import ring_attention_sharded

    mesh = make_mesh(sp=sp, devices=jax.devices()[:sp])
    old = os.environ.get("TORCHFT_FLASH")
    os.environ["TORCHFT_FLASH"] = "1" if branch == "flash" else "0"
    try:
        q, k, v = (jnp.asarray(a) for a in _qkv(sp * S_BLK))
        with mesh:
            o, vjp = jax.vjp(jax.jit(lambda q, k, v: ring_attention_sharded(q, k, v, mesh=mesh)),
                             q, k, v)
            grads = vjp(jnp.cos(o))
    finally:
        if old is None:
            os.environ.pop("TORCHFT_FLASH", None)
        else:
            os.environ["TORCHFT_FLASH"] = old
    return [np.asarray(x) for x in (o, *grads)]


def _jax_llama(seq: int, flash):
    """Loss and gradients of the JAX Llama with ``sp_axis="sp"`` on
    ``make_mesh(sp=4)`` (``tests/test_llama_parallel.py``'s set-up), at the
    port's seeded parameters, on ``seq`` tokens under ``TORCHFT_FLASH=flash``
    (None: unset)."""
    import jax

    from torchft_tpu.models.llama import Llama as JaxLlama, llama_debug as jax_debug
    from torchft_tpu.parallel.hsdp import fsdp_shardings
    from torchft_tpu.parallel.mesh import make_mesh
    from torchft_tpu_torch.models.llama import Llama, llama_debug, params_to_numpy

    cfg = llama_debug()
    model = Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    params = params_to_numpy(model.state_dict(), cfg.n_layers)
    mesh = make_mesh(sp=4, devices=jax.devices()[:4])
    jmodel = JaxLlama(jax_debug(sp_axis="sp"), mesh=mesh)
    params_sh, batch_sh = fsdp_shardings(jmodel, mesh)
    params_s = jax.tree_util.tree_map(jax.device_put, params, params_sh)
    batch = tuple(jax.device_put(b.astype(np.int32), sh)
                  for b, sh in zip(_tokens(cfg.vocab_size, seq), batch_sh))
    old = os.environ.pop("TORCHFT_FLASH", None)
    if flash is not None:
        os.environ["TORCHFT_FLASH"] = flash
    try:
        with mesh:
            loss, grads = jax.jit(jax.value_and_grad(jmodel.loss))(params_s, batch)
    finally:
        os.environ.pop("TORCHFT_FLASH", None)
        if old is not None:
            os.environ["TORCHFT_FLASH"] = old
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _gathered(out, sp: int, branch: str):
    parts = [torch.load(out / f"ring_sp{sp}_{branch}_rank{r}.pt") for r in range(sp)]
    return {k: torch.cat([p[k] for p in parts], dim=1).numpy() for k in ("o", "dq", "dk", "dv")}


@pytest.mark.parametrize("sp,branch", RING, ids=[f"sp{s}_{b}" for s, b in RING])
def test_ring_matches_jax_ring_attention_sharded(runs, sp, branch) -> None:
    out, jax_ring, _ = runs
    got = _gathered(out, sp, branch)
    want = dict(zip(("o", "dq", "dk", "dv"), jax_ring[(sp, branch)]))
    np.testing.assert_allclose(got["o"], want["o"], rtol=1e-5, atol=1e-5, err_msg="o")
    for name in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("sp", [4, 2])
def test_single_process_schedule_matches_the_distributed_ring(runs, monkeypatch, sp) -> None:
    """The blocks of every rank in one process (``ring_attention_blocks``,
    the flash branch, as ``chip_smoke.py`` runs it on one card) give the
    distributed ring's outputs and gradients."""
    from torchft_tpu_torch.parallel.ring_attention import ring_attention_blocks, schedule

    out, _, _ = runs
    monkeypatch.setenv("TORCHFT_FLASH", "1")
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(sp * S_BLK))
    blocks = [t.split(S_BLK, dim=1) for t in (q, k, v)]
    o = torch.cat(ring_attention_blocks(*blocks), dim=1)
    torch.sin(o).sum().backward()
    got = {"o": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
           "dv": v.grad.numpy()}
    want = _gathered(out, sp, "flash")
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=1e-6, err_msg=name)
    kinds = [kind for r in range(sp) for kind in schedule(r, sp)]
    assert (kinds.count("causal"), kinds.count("full")) == (sp, sp * (sp - 1) // 2)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sp_llama_loss_and_grads_match_jax(runs, layout) -> None:
    from torchft_tpu_torch.models.llama import llama_debug, params_to_numpy

    out, _, jax_llama = runs
    _, seq, flash = LAYOUTS[layout]
    jloss, jgrads = jax_llama[(seq, flash)]
    got = torch.load(out / f"{layout}.pt")
    assert abs(got["loss"] - jloss) < 1e-5
    grads = params_to_numpy(got["grads"], llama_debug().n_layers)
    flat = [(k, grads[k], jgrads[k]) for k in ("embed", "final_norm", "lm_head")]
    flat += [(k, grads["layers"][k], w) for k, w in jgrads["layers"].items()]
    for key, g, want in flat:
        atol = 1e-6 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g, want, rtol=1e-4, atol=atol, err_msg=key)


def test_train_hsdp_step_at_fsdp2_sp2() -> None:
    """One step of ``train_hsdp`` at fsdp = 2 × sp = 2: four rank
    processes, FSDP2 over the flattened fsdp·sp axis, ring attention over
    sp; the committed loss is the dense model's on the same batch."""
    from torchft_tpu_torch.models.llama import Llama, llama_debug
    from torchft_tpu_torch.train_ddp import synthetic_batches
    from torchft_tpu_torch.train_hsdp import run_hsdp_fleet

    cfg = llama_debug()
    (ranks,) = run_hsdp_fleet(cfg, torch.device("cpu"), groups=1, fsdp=2, sp=2, steps=1,
                              batch=2, seq=128, lr=1e-3, tier="python", timeout=60.0)
    assert [r["mesh"]["sp"] for r in ranks] == [2] * 4
    assert all(r["final_step"] == 1 and r["grad_is_dtensor"] for r in ranks)
    assert len({r["params_sha256"] for r in ranks}) == 1
    tokens, targets = synthetic_batches(cfg, 2, 128, 0, 4, torch.device("cpu"))[0]
    dense = Llama(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        want = float(dense.loss(tokens, targets))
    assert all(abs(r["losses"][0] - want) < 1e-5 for r in ranks)


@pytest.mark.parametrize("seq", [16, 100, 640, 1000, 2048])
def test_card_gate_sends_every_block_length_to_the_kernels(monkeypatch, seq) -> None:
    """On a CUDA device ``use_flash`` (the model's gate, which
    ``ring_attention`` shares) says flash at every block length, those the
    CPU's JAX gate refuses included, so a CUDA ring never takes the
    online-softmax branch; ``kernel_blocks`` gives the wrapper block sizes
    its divisibility check takes; ``TORCHFT_FLASH=0`` raises there."""
    from torchft_tpu_torch.models.llama import flash_blocks, kernel_blocks, use_flash
    from torchft_tpu_torch.ops.flash_attention import _validate

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("TORCHFT_FLASH", raising=False)
        else:
            monkeypatch.setenv("TORCHFT_FLASH", env)
        assert use_flash(seq, cuda)
    assert use_flash(seq, cpu) == (seq == 2048)  # TORCHFT_FLASH=1: the JAX gate
    assert kernel_blocks(seq, cuda) == (seq, seq)
    assert kernel_blocks(seq, cpu) == flash_blocks(seq)
    q, k = torch.zeros(1, seq, 4, 64), torch.zeros(1, seq, 2, 64)
    for causal in (True, False):
        assert _validate(q, k, causal, None, *kernel_blocks(seq, cuda))[1:] == (seq, seq)
    monkeypatch.setenv("TORCHFT_FLASH", "0")
    with pytest.raises(ValueError, match="only on the CPU"):
        use_flash(seq, cuda)
    assert not use_flash(seq, cpu)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
