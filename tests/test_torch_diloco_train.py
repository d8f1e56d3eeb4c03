"""The port's DiLoCo / LocalSGD entry point (``torchft_tpu_torch/train_diloco.py``)
end to end on the CPU at ``llama_debug`` size: replica groups as threads of
one process, each with its own Manager, manager sidecar, communicator and
HTTPTransport, on the tier ``tier.py`` resolves.

- DiLoCo (bench.py's phase D schedule: sync_every 8, 2 fragments, delay 2)
  with replica 1 killed before its inner step 5: it restarts, heals with
  every fragment's state, and both replicas end at the same committed step
  with equal fragment backups (which moved off the initial weights) and
  equal live parameters in the fragment synced last; float and int8.
- LocalSGD ends with equal parameter hashes.
- The same DiLoCo schedule in each package (2 replicas, 3 syncs of sync_every 4, 2
  fragments, delay 1, AdamW inner at lr 1e-3, outer Nesterov SGD), from the
  converted JAX init, the same batches and the same fragments
  (``local_sgd.fragments_from_jax``), ends allclose at
  ``test_same_run_in_both_packages_ends_allclose``'s tolerance (atol 1e-4
  against inner steps of up to 1e-3).
- The replicated int8 outer path (``TORCHFT_OUTER_SHARD=0``) with
  ``TORCHFT_QUANT_DEVICE_REDUCE=1`` reaches the reduce kernel's wrapper,
  which runs its plain version on CPU tensors.
- The CLI runs both algorithms on the CPU.
"""

import math
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu import local_sgd as jlocal
from torchft_tpu import manager as jmanager
from torchft_tpu.communicator import TCPCommunicator as JaxTCPCommunicator
from torchft_tpu.lighthouse import LighthouseServer as JaxLighthouseServer
from torchft_tpu.models import llama as jllama
from torchft_tpu_torch import train_ddp, train_diloco
from torchft_tpu_torch.communicator import TCPCommunicator
from torchft_tpu_torch.lighthouse import LighthouseServer
from torchft_tpu_torch.local_sgd import DiLoCo, fragments_from_jax
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import llama as tllama
from torchft_tpu_torch.optim import OuterSGD

CPU = torch.device("cpu")
SMALL = dict(seq=128, batch=2, lr=1e-3, timeout=30.0)


def _fleet(**kw):
    return train_diloco.run_diloco_fleet(train_ddp.model_config("llama_debug"), CPU, **SMALL, **kw)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_diloco_fleet_heals_and_ends_with_equal_backups(quant) -> None:
    results = _fleet(algo="diloco", sync_every=8, num_fragments=2, fragment_sync_delay=2,
                     outer_steps=4, should_quantize=quant, kill_at=(1, 5))
    assert [r.restarts for r in results] == [0, 1]
    assert [r.final_step for r in results] == [4, 4]
    assert all(math.isfinite(x) for r in results for x in r.losses)
    assert results[1].fragment_heals == [1, 1] and results[1].heal.bytes_total > 0
    for f in range(2):
        assert results[0].fragment_sha256[f] == results[1].fragment_sha256[f]
        assert results[0].fragment_sha256[f] != results[0].initial_fragment_sha256[f]
    last = (4 - 1) % 2
    assert results[0].fragment_live_sha256[last] == results[1].fragment_live_sha256[last]
    # the other fragment trained on each replica's own batches since its sync
    assert results[0].fragment_live_sha256[1 - last] != results[1].fragment_live_sha256[1 - last]
    assert all(t["outer_shard_wall_s"] > 0 for t in results[0].outer_shard)


def test_localsgd_fleet_ends_bit_identical() -> None:
    results = _fleet(algo="localsgd", sync_every=4, num_fragments=1, fragment_sync_delay=0,
                     outer_steps=2)
    assert [r.final_step for r in results] == [2, 2]
    assert [r.inner_steps for r in results] == [8, 8]
    assert results[0].params_sha256 == results[1].params_sha256


def test_replicated_int8_outer_path_reaches_the_reduce_wrapper(monkeypatch) -> None:
    from torchft_tpu_torch.ops import quant as qk

    monkeypatch.setenv("TORCHFT_OUTER_SHARD", "0")
    monkeypatch.setenv("TORCHFT_QUANT_DEVICE_REDUCE", "1")
    calls = []
    lock = threading.Lock()
    wrapper = qk.reduce_quantized_device

    def counting(qs, scales, kind="int8"):
        assert not qs.is_cuda  # the plain version, on CPU tensors
        with lock:
            calls.append(qs.shape)
        return wrapper(qs, scales, kind=kind)

    monkeypatch.setattr(qk, "reduce_quantized_device", counting)
    results = _fleet(algo="diloco", sync_every=4, num_fragments=2, fragment_sync_delay=1,
                     outer_steps=2, should_quantize=True)
    assert calls and all(shape[0] == 2 for shape in calls)
    assert [r.final_step for r in results] == [2, 2]
    assert results[0].fragment_sha256 == results[1].fragment_sha256
    assert all(not t for t in results[0].outer_shard)  # no sharded sync ran


# ---------------------------------------------------------------------------
# the same schedule in both packages
# ---------------------------------------------------------------------------

SYNC_EVERY, FRAGMENTS, DELAY, OUTER_STEPS = 4, 2, 1, 3
STEPS, LR, BATCH, SEQ = 6, 1e-3, 2, 128


def _batches(idx):
    return train_ddp.synthetic_batches(tllama.llama_debug(), BATCH, SEQ, idx, 4, CPU)


def _two_replicas(lighthouse, body):
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = [pool.submit(body, i) for i in range(2)]
            return [f.result(timeout=120) for f in futures]
    finally:
        lighthouse.shutdown()


def _jax_diloco(params0, groups):
    cfg = jllama.llama_debug()
    lighthouse = JaxLighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=100,
                                     quorum_tick_ms=20, heartbeat_timeout_ms=5000)
    tx = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    grad_fn = jax.grad(jllama.Llama(cfg).loss)

    @jax.jit
    def inner_step(params, inner_state, batch):
        updates, inner_state = tx.update(grad_fn(params, batch), inner_state, params)
        return optax.apply_updates(params, updates), inner_state

    def replica(idx):
        batches = [(jnp.asarray(t.numpy()), jnp.asarray(y.numpy())) for t, y in _batches(idx)]
        params = jax.tree_util.tree_map(jnp.asarray, params0)
        holder = {"params": params}
        inner_state = tx.init(params)
        manager = jmanager.Manager(
            comm=JaxTCPCommunicator(timeout_s=30.0), load_state_dict=lambda s: None,
            state_dict=lambda: {}, min_replica_size=2, use_async_quorum=False,
            replica_id=f"replica_{idx}", lighthouse_addr=lighthouse.local_address(),
            timeout=30.0, quorum_timeout=30.0, connect_timeout=30.0, init_sync=False,
        )
        diloco = jlocal.DiLoCo(manager, holder, optax.sgd(0.7, momentum=0.9, nesterov=True),
                               sync_every=SYNC_EVERY, fragments=groups,
                               fragment_sync_delay=DELAY)
        try:
            for step in range(STEPS):
                holder["params"], inner_state = inner_step(
                    holder["params"], inner_state, batches[step % len(batches)])
                diloco.step()
            assert manager.current_step() == OUTER_STEPS
            return jax.tree_util.tree_map(np.asarray, holder["params"])
        finally:
            manager.shutdown()

    return _two_replicas(lighthouse, replica)


def _port_diloco(params0, fragments):
    lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=100,
                                  quorum_tick_ms=20, heartbeat_timeout_ms=5000)

    def replica(idx):
        batches = _batches(idx)
        model, inner = train_ddp.build(tllama.llama_debug(), CPU, 0, LR)
        model.load_state_dict(tllama.params_from_jax(params0))
        manager = Manager(
            comm=TCPCommunicator(timeout_s=30.0), load_state_dict=lambda s: None,
            state_dict=lambda: {}, min_replica_size=2, use_async_quorum=False,
            replica_id=f"replica_{idx}", lighthouse_addr=lighthouse.local_address(),
            timeout=30.0, quorum_timeout=30.0, connect_timeout=30.0, init_sync=False,
        )
        diloco = DiLoCo(manager, model, OuterSGD(0.7, momentum=0.9, nesterov=True),
                        sync_every=SYNC_EVERY, fragments=fragments, fragment_sync_delay=DELAY)
        try:
            for step in range(STEPS):
                train_diloco.inner_step(model, inner, batches[step % len(batches)],
                                        diloco.pre_step())
                diloco.step()
            assert manager.current_step() == OUTER_STEPS
            return tllama.params_to_numpy(model.state_dict(), tllama.llama_debug().n_layers)
        finally:
            manager.shutdown()

    return _two_replicas(lighthouse, replica)


def test_same_diloco_schedule_in_both_packages_ends_allclose() -> None:
    cfg = jllama.llama_debug()
    params0 = jax.tree_util.tree_map(np.asarray, jllama.Llama(cfg).init(jax.random.PRNGKey(0)))
    groups = jlocal.partition_leaves(params0, FRAGMENTS)
    ref = _jax_diloco(params0, groups)
    port = _port_diloco(params0, fragments_from_jax(params0, groups, cfg.n_layers))
    assert not np.allclose(port[0]["embed"], params0["embed"])  # it trained
    for replica in range(2):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ref[replica]),
                                     jax.tree_util.tree_leaves_with_path(port[replica])):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("algo", ["diloco", "localsgd"])
def test_train_diloco_cli_runs_on_the_cpu(monkeypatch, capsys, algo) -> None:
    lighthouse = LighthouseServer(bind="127.0.0.1:0", min_replicas=1)
    monkeypatch.setenv("TORCHFT_LIGHTHOUSE", lighthouse.local_address())
    try:
        train_diloco.main([
            "--algo", algo, "--model", "llama_debug", "--device", "cpu", "--total-syncs", "2",
            "--sync-every", "4", "--seq-len", "128", "--batch-size", "2", "--min-replicas", "1",
        ])
    finally:
        lighthouse.shutdown()
    assert "FINAL step=2" in capsys.readouterr().out
