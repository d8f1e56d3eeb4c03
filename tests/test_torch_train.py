"""The port's train loop (torchft_tpu_torch/train_ddp.py) end to end on the
CPU at ``llama_debug`` size: replica groups as threads of one process, each
with its own Manager, manager sidecar, communicator and HTTPTransport, on
the tier ``tier.py`` resolves (the C++ tier wherever it builds).

- A healthy 2-replica run ends with equal parameter hashes.
- A recovery run (replica 1 killed before step 2, restarted, healed from
  replica 0) ends with equal parameter hashes.
- The same run in each package, from the converted JAX init on the same
  batches, ends with allclose parameters (two groups; and three, group 1
  killed before step 2 and healed striped from the two others): f32 and
  AdamW with optax's defaults on both sides.  Three steps at lr 1e-3 move
  parameters by up to 3e-3; summation-order differences left at most 7e-6
  between the packages here, and the 1e-4 absolute tolerance leaves room
  for another CPU's rounding while staying well below one step's movement.
- The quantized gradient sync (``should_quantize=True``, int8 and fp8):
  a recovery run ends with equal parameter hashes and finite losses, and a
  2-replica quantized average of the same gradients in each package agrees
  within the int8 wire's tolerance (stated at the test).
"""

import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu import manager as jmanager
from torchft_tpu.communicator import TCPCommunicator as JaxTCPCommunicator
from torchft_tpu.ddp import ft_allreduce
from torchft_tpu.lighthouse import LighthouseServer as JaxLighthouseServer
from torchft_tpu.models import llama as jllama
from torchft_tpu.optim import OptimizerWrapper as JaxOptimizerWrapper
from torchft_tpu_torch import manager as tmanager
from torchft_tpu_torch import train_ddp
from torchft_tpu_torch.communicator import TCPCommunicator
from torchft_tpu_torch.ddp import allreduce_gradients
from torchft_tpu_torch.lighthouse import LighthouseServer
from torchft_tpu_torch.models import llama as tllama
from torchft_tpu_torch.optim import OptimizerWrapper

CPU = torch.device("cpu")


def _check_fleet(results, steps):
    for r in results:
        assert r.final_step == steps
        assert all(math.isfinite(x) for x in r.losses)
    assert len({r.params_sha256 for r in results}) == 1


@pytest.mark.parametrize("kill_at", [None, (1, 2)], ids=["healthy", "recovery"])
def test_fleet_ends_bit_identical(kill_at) -> None:
    cfg = train_ddp.model_config("llama_debug")
    results = train_ddp.run_fleet(
        cfg, CPU, steps=5, seq=128, batch=2, lr=1e-3, kill_at=kill_at, timeout=30.0
    )
    _check_fleet(results, 5)
    assert results[1].restarts == (0 if kill_at is None else 1)
    assert results[0].restarts == 0


def _jax_fleet(params0, cfg, steps, lr, batch, seq, groups=2, kill_at=None):
    """The JAX package's DDP loop (examples/train_ddp.py) on the port's
    batches: ``groups`` threads, one lighthouse.  ``kill_at=(group, step)``
    kills that group once before that step, as ``run_fleet`` does: its
    manager shuts down and it starts over from ``params0`` with a new one,
    which heals from the live groups."""
    lighthouse = JaxLighthouseServer(
        bind="127.0.0.1:0", min_replicas=groups, join_timeout_ms=100,
        quorum_tick_ms=20, heartbeat_timeout_ms=5000,
    )
    model = jllama.Llama(cfg)
    grad_fn = jax.jit(jax.value_and_grad(model.loss))
    pending_kill = [kill_at]

    def replica(idx):
        batches = [
            (jnp.asarray(t.numpy()), jnp.asarray(y.numpy()))
            for t, y in train_ddp.synthetic_batches(
                tllama.llama_debug(), batch, seq, idx, 4, CPU
            )
        ]
        tx = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
        while True:
            params = jax.tree_util.tree_map(jnp.asarray, params0)
            holder = {"params": params, "opt_state": tx.init(params)}
            manager = jmanager.Manager(
                comm=JaxTCPCommunicator(timeout_s=30.0),
                load_state_dict=holder.update,
                state_dict=lambda holder=holder: dict(holder),
                min_replica_size=groups,
                replica_id=f"replica_{idx}",
                lighthouse_addr=lighthouse.local_address(),
                timeout=30.0, quorum_timeout=30.0, connect_timeout=30.0,
            )
            opt = JaxOptimizerWrapper(manager, tx)
            try:
                while manager.current_step() < steps:
                    if pending_kill[0] == (idx, manager.current_step()):
                        pending_kill[0] = None
                        break
                    tokens_targets = batches[manager.current_step() % len(batches)]
                    opt.start_step()
                    _, grads = grad_fn(holder["params"], tokens_targets)
                    opt.step(holder, ft_allreduce(manager, grads))
                else:
                    return jax.tree_util.tree_map(np.asarray, holder["params"])
            finally:
                manager.shutdown()

    try:
        with ThreadPoolExecutor(max_workers=groups) as pool:
            futures = [pool.submit(replica, i) for i in range(groups)]
            finals = [f.result(timeout=120) for f in futures]
    finally:
        lighthouse.shutdown()
    assert pending_kill[0] is None, f"the kill at {kill_at} never fired"
    return finals


def _assert_allclose_to_jax(port_state, jax_params, cfg) -> None:
    port_final = tllama.params_to_numpy(port_state, cfg.n_layers)
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(jax_params),
        jax.tree_util.tree_leaves_with_path(port_final),
    ):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=str(path))


def test_same_run_in_both_packages_ends_allclose() -> None:
    cfg = jllama.llama_debug()
    steps, lr, batch, seq = 3, 1e-3, 2, 128
    params0 = jax.tree_util.tree_map(np.asarray, jllama.Llama(cfg).init(jax.random.PRNGKey(0)))
    jax_final = _jax_fleet(params0, cfg, steps, lr, batch, seq)

    results = train_ddp.run_fleet(
        tllama.llama_debug(), CPU, steps=steps, seq=seq, batch=batch, lr=lr,
        init_state=tllama.params_from_jax(params0), timeout=30.0,
    )
    _check_fleet(results, steps)
    port_final = tllama.params_to_numpy(results[0].state, cfg.n_layers)
    assert not np.allclose(port_final["embed"], params0["embed"])  # it trained
    _assert_allclose_to_jax(results[0].state, jax_final[0], cfg)


def test_three_groups_with_a_striped_heal_end_allclose_to_jax() -> None:
    """Three groups, group 1 killed before step 2: on the Python tier of
    each package it heals striped from groups 0 and 2 over HTTP, and the
    fleets end allclose, as two groups do."""
    cfg = jllama.llama_debug()
    steps, lr, batch, seq = 3, 1e-3, 2, 128
    params0 = jax.tree_util.tree_map(np.asarray, jllama.Llama(cfg).init(jax.random.PRNGKey(0)))
    jax_final = _jax_fleet(params0, cfg, steps, lr, batch, seq, groups=3, kill_at=(1, 2))
    results = train_ddp.run_fleet(
        tllama.llama_debug(), CPU, replicas=3, steps=steps, seq=seq, batch=batch, lr=lr,
        kill_at=(1, 2), init_state=tllama.params_from_jax(params0), timeout=30.0,
        tier="python", heal_transport="http",
    )
    _check_fleet(results, steps)
    assert results[1].restarts == 1 and results[1].heal.num_sources == 2
    for got in jax_final:
        _assert_allclose_to_jax(results[0].state, got, cfg)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantized_fleet_heals_and_ends_bit_identical(monkeypatch, kind) -> None:
    monkeypatch.setenv("TORCHFT_QUANT_KIND", kind)
    cfg = train_ddp.model_config("llama_debug")
    results = train_ddp.run_fleet(
        cfg, CPU, steps=5, seq=128, batch=2, lr=1e-3, kill_at=(1, 2), timeout=30.0,
        should_quantize=True,
    )
    _check_fleet(results, 5)
    assert results[1].restarts == 1 and results[0].restarts == 0


def _both_packages_quantized_average(params0, cfg, batches):
    """Each replica's gradients of one step on its batch, then the 2-replica
    quantized average in each package: returns (port avg, JAX avg, the
    replicas' f32 gradients) as JAX-layout numpy trees."""
    model = jllama.Llama(cfg)
    grad_fn = jax.jit(jax.grad(model.loss))
    jax_grads = [
        jax.tree_util.tree_map(np.asarray, grad_fn(params0, (jnp.asarray(t.numpy()), jnp.asarray(y.numpy()))))
        for t, y in batches
    ]

    def run(pkg, comm_cls, lighthouse_cls, body):
        lighthouse = lighthouse_cls(
            bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=100,
            quorum_tick_ms=20, heartbeat_timeout_ms=5000,
        )

        def replica(idx):
            manager = pkg.Manager(
                comm=comm_cls(timeout_s=30.0), load_state_dict=lambda s: None,
                state_dict=lambda: {}, min_replica_size=2, replica_id=f"replica_{idx}",
                lighthouse_addr=lighthouse.local_address(), timeout=30.0,
                quorum_timeout=30.0, connect_timeout=30.0, init_sync=False,
            )
            try:
                manager.start_quorum()
                return body(manager, idx)
            finally:
                manager.shutdown()

        try:
            with ThreadPoolExecutor(max_workers=2) as pool:
                return [f.result(timeout=120) for f in [pool.submit(replica, i) for i in range(2)]]
        finally:
            lighthouse.shutdown()

    def port_body(manager, idx):
        torch_model = tllama.Llama(tllama.llama_debug(), device=CPU)
        torch_model.load_state_dict(tllama.params_from_jax(params0))
        torch_model.loss(*batches[idx]).backward()
        allreduce_gradients(manager, torch_model, should_quantize=True).wait()
        grads = {name: p.grad for name, p in torch_model.named_parameters()}
        return tllama.params_to_numpy(grads, cfg.n_layers)

    def jax_body(manager, idx):
        avg = ft_allreduce(manager, jax.tree_util.tree_map(jnp.asarray, jax_grads[idx]), True)
        return jax.tree_util.tree_map(np.asarray, avg)

    port = run(tmanager, TCPCommunicator, LighthouseServer, port_body)
    ref = run(jmanager, JaxTCPCommunicator, JaxLighthouseServer, jax_body)
    return port, ref, jax_grads


def test_quantized_step_matches_jax_within_int8_tolerance() -> None:
    """Rowwise int8 carries each value to within half a step (scale =
    row absmax / 127) of itself, twice on the way (quantize, then the
    requantize of the sum); rows of the flat buffer span parameters, so the
    step is bounded with the largest gradient A over both replicas:
    each package's average lies within 2·A/127 of the exact one, and the two
    within 4·A/127 of each other.  (The packages flatten the parameters in
    different orders, so their rows, and their scales, differ.)"""
    cfg = jllama.llama_debug()
    params0 = jax.tree_util.tree_map(np.asarray, jllama.Llama(cfg).init(jax.random.PRNGKey(0)))
    batches = [train_ddp.synthetic_batches(tllama.llama_debug(), 2, 128, i, 1, CPU)[0]
               for i in range(2)]
    port, ref, grads = _both_packages_quantized_average(params0, cfg, batches)
    leaves = lambda tree: [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]
    A = max(np.abs(g).max() for tree in grads for g in leaves(tree))
    exact = [(a + b) / 2 for a, b in zip(leaves(grads[0]), leaves(grads[1]))]
    diffs = []
    for p0, p1, r0, e in zip(leaves(port[0]), leaves(port[1]), leaves(ref[0]), exact):
        np.testing.assert_array_equal(p0, p1)  # both port replicas agree
        assert np.abs(p0 - e).max() <= 2 * A / 127
        assert np.abs(r0 - e).max() <= 2 * A / 127
        diffs.append(np.abs(p0 - r0).reshape(-1))
    assert np.concatenate(diffs).max() <= 4 * A / 127


class _FakeManager:
    def __init__(self, vote: bool) -> None:
        self.vote = vote
        self.quorums = 0

    def start_quorum(self) -> None:
        self.quorums += 1

    def should_commit(self) -> bool:
        return self.vote


@pytest.mark.parametrize("vote", [True, False], ids=["commit", "discard"])
def test_optimizer_step_is_gated_by_the_vote(vote) -> None:
    w = torch.nn.Parameter(torch.ones(3))
    manager = _FakeManager(vote)
    opt = OptimizerWrapper(manager, torch.optim.SGD([w], lr=0.5))
    opt.zero_grad()
    assert manager.quorums == 1 and w.grad is None
    (w * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    assert opt.step() is vote
    expected = [0.5, 0.0, -0.5] if vote else [1.0, 1.0, 1.0]
    assert w.detach().tolist() == expected


def test_train_ddp_cli_runs_on_the_cpu(monkeypatch, capsys) -> None:
    lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1)
    monkeypatch.setenv("TORCHFT_LIGHTHOUSE", lighthouse.local_address())
    try:
        train_ddp.main([
            "--model", "llama_debug", "--device", "cpu", "--steps", "2",
            "--seq-len", "128", "--batch-size", "2",
        ])
    finally:
        lighthouse.shutdown()
    assert "FINAL step=2" in capsys.readouterr().out


def test_quorum_tracer_writes_a_torch_profile_per_epoch(tmp_path) -> None:
    """``TORCHFT_TRACE_DIR`` epochs: ``jax.profiler`` became
    ``torch.profiler``; each quorum change closes the previous epoch's
    trace and ``record_function`` spans land in it."""
    from torchft_tpu_torch.observability import QuorumTracer, record_function

    tracer = QuorumTracer(base_dir=str(tmp_path))
    tracer.on_quorum_change(1)
    with record_function("torchft::test::span"):
        torch.ones(8).sum()
    tracer.on_quorum_change(2)
    tracer.stop()
    first = (tmp_path / "quorum_1" / "trace.json").read_text()
    assert "torchft::test::span" in first
    assert (tmp_path / "quorum_2" / "trace.json").exists()
