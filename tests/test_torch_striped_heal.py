"""The port's striped (multi-source) HTTP heal, held against the JAX
package's (``tests/test_striped_heal.py::TestHTTPStriped``), on numpy states
from a seed.

- Three sources of either package, chunk index at 16 KiB: the port's
  striped result is bit for bit the port's single-source result and the JAX
  healer's striped result, with the leaves' dtypes (bf16, bool) kept; its
  ``HealMetrics`` count 3 sources, per-source bytes that sum to the stream
  and no failed source.
- A ``None`` placeholder beside one live source falls back to one source.
- A source killed mid-heal (``chaos.arm_heal_source_kill``): the survivor
  steals its chunks and rewrites the torn range; the result is bit for bit.
- All sources dead: the heal raises within its timeout.
- A source that serves another checkpoint (another size, or the same size
  under another skeleton) is dropped, and the survivor finishes.
- The receive lands in place: ``tracemalloc``'s peak over a striped heal of
  a 40 MB state stays under an eighth of the stream (the landing arrays are
  torch's, which ``tracemalloc`` does not see; a ``bytearray`` of the stream
  it does).
- Fleets of three ``llama_debug`` groups on the CPU, healing over HTTP, float
  and int8: on the Python tier the killed replica heals from the two others,
  each serving bytes; on the C++ tier (its sidecar advertises one source,
  in both packages) from one; every group ends on one hash, the same as the
  run under ``TORCHFT_HEAL_STRIPED=0``.
"""

import io
import pickle
import time
import tracemalloc

import ml_dtypes
import numpy as np
import pytest
import torch

import torchft_tpu.checkpointing.serialization as jax_serialization
from torchft_tpu.checkpointing.http_transport import HTTPTransport as JaxHTTPTransport
from torchft_tpu_torch import train_ddp
from torchft_tpu_torch.chaos import arm_heal_source_kill
from torchft_tpu_torch.checkpointing import serialization as S
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport

STEP = 7
CPU = torch.device("cpu")


def _state(seed: int = 0, names=("w", "b")) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "params": {
            names[0]: rng.standard_normal((257, 129)).astype(np.float32),
            names[1]: rng.standard_normal((67, 129)).astype(ml_dtypes.bfloat16),
        },
        "opt": [rng.integers(-128, 128, size=(3, 1025)).astype(np.int8),
                rng.standard_normal(4099).astype(np.float32)],
        "mask": rng.random(777) < 0.5,
        "torchft": {"step": STEP, "batches_committed": 3},
    }


def _torch_state(state):
    if isinstance(state, np.ndarray):
        if state.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(state.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(state.copy())
    if isinstance(state, dict):
        return {k: _torch_state(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_torch_state(v) for v in state]
    return state


def _leaf_bytes(state) -> list:
    if isinstance(state, torch.Tensor):
        return [state.contiguous().view(-1).view(torch.uint8).numpy().tobytes()]
    if isinstance(state, np.ndarray) or hasattr(state, "__array__"):
        return [np.ascontiguousarray(np.asarray(state)).reshape(-1).view(np.uint8).tobytes()]
    if isinstance(state, dict):
        return [b for v in state.values() for b in _leaf_bytes(v)]
    if isinstance(state, (list, tuple)):
        return [b for v in state for b in _leaf_bytes(v)]
    return []


class _JaxPickle:
    """``pickle`` for the JAX package's serialization module, its loads
    mapping the port's placeholder classes onto its own."""

    HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL
    dumps = staticmethod(pickle.dumps)

    @staticmethod
    def loads(data: bytes):
        class _Unpickler(pickle.Unpickler):
            def find_class(self, module: str, name: str):
                if module == S.__name__:
                    module = jax_serialization.__name__
                return super().find_class(module, name)

        return _Unpickler(io.BytesIO(data)).load()


@pytest.fixture()
def mapped_skeletons(monkeypatch) -> None:
    """Each package reads the other's skeleton as its own (they refuse it
    by name otherwise, ``tests/test_torch_snapshot_isolation.py``)."""
    find_class = S._SkeletonUnpickler.find_class

    def _port_find_class(self, module: str, name: str):
        if module == jax_serialization.__name__:
            return getattr(S, name)
        return find_class(self, module, name)

    monkeypatch.setattr(S._SkeletonUnpickler, "find_class", _port_find_class)
    monkeypatch.setattr(jax_serialization, "pickle", _JaxPickle)


def _sources(package: str, states: list, **kw) -> list:
    """One serving transport of ``package`` per state, each staged at STEP."""
    out = []
    for state in states:
        if package == "port":
            t = HTTPTransport(timeout=30.0, **kw)
            state = _torch_state(state)
        else:
            t = JaxHTTPTransport(timeout=30.0, **kw)
        t.send_checkpoint([9], STEP, state, 30.0)
        out.append(t)
    return out


def _url(t) -> str:
    return f"http://127.0.0.1:{t.port}"


def _shutdown(*transports) -> None:
    for t in transports:
        t.shutdown()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_three_sources_heal_bit_for_bit_the_single_source_and_jax_healers(
        mapped_skeletons, package) -> None:
    state = _state()
    sources = _sources(package, [state] * 3, heal_chunk_bytes=1 << 14)
    listed = [(i, _url(s)) for i, s in enumerate(sources)]
    receiver, jax_receiver = HTTPTransport(timeout=30.0), JaxHTTPTransport(timeout=30.0)
    try:
        single = receiver.recv_checkpoint(0, listed[0][1], STEP, 30.0)
        striped = receiver.recv_checkpoint_striped(listed, STEP, 30.0)
        m = receiver.last_heal_metrics
        jax_striped = jax_receiver.recv_checkpoint_striped(listed, STEP, 30.0)
    finally:
        _shutdown(receiver, jax_receiver, *sources)
    assert _leaf_bytes(striped) == _leaf_bytes(single) == _leaf_bytes(jax_striped)
    assert _leaf_bytes(striped) == _leaf_bytes(state)
    assert striped["torchft"] == state["torchft"]
    assert striped["params"]["b"].dtype == torch.bfloat16 and striped["mask"].dtype == torch.bool
    assert m is not None and m.num_sources == 3
    assert sum(m.per_source_bytes.values()) == m.bytes_total
    assert len(m.per_source_bytes) >= 2  # the work spread
    assert m.failed_sources == [] and m.stolen_chunks == 0


def test_a_placeholder_beside_one_live_source_falls_back_to_one_source() -> None:
    state = _state()
    (source,) = _sources("port", [state])
    receiver = HTTPTransport(timeout=30.0)
    try:
        got = receiver.recv_checkpoint_striped([(3, None), (0, _url(source))], STEP, 30.0)
    finally:
        _shutdown(receiver, source)
    assert _leaf_bytes(got) == _leaf_bytes(state)
    m = receiver.last_heal_metrics
    assert m.num_sources == 1 and m.per_source_bytes == {_url(source): m.bytes_total}


def test_a_source_killed_mid_heal_heals_bit_for_bit() -> None:
    state = _state()
    sources = _sources("port", [state] * 2, heal_chunk_bytes=1 << 13)
    fired = arm_heal_source_kill(sources[1], after_bytes=1 << 14)
    receiver = HTTPTransport(timeout=30.0)
    try:
        got = receiver.recv_checkpoint_striped([(i, _url(s)) for i, s in enumerate(sources)],
                                               STEP, 30.0)
    finally:
        _shutdown(receiver, *sources)
    assert fired.is_set(), "the chaos kill never fired"
    assert _leaf_bytes(got) == _leaf_bytes(state)
    m = receiver.last_heal_metrics
    assert m.failed_sources == [_url(sources[1])]
    assert m.stolen_chunks >= 1
    assert sum(m.per_source_bytes.values()) == m.bytes_total


def test_all_sources_dead_raises_within_its_timeout() -> None:
    sources = _sources("port", [_state()] * 2)
    listed = [(i, _url(s)) for i, s in enumerate(sources)]
    _shutdown(*sources)
    receiver = HTTPTransport(timeout=3.0)
    t0 = time.monotonic()
    try:
        with pytest.raises(ConnectionError, match="no source answered"):
            receiver.recv_checkpoint_striped(listed, STEP, 3.0)
    finally:
        receiver.shutdown()
    assert time.monotonic() - t0 < 3.0 + 2.0


@pytest.mark.parametrize("other", [
    _state(seed=1, names=("w", "b")) | {"extra": np.zeros(5, np.float32)},  # another size
    _state(seed=0, names=("u", "c")),  # the same size under another skeleton
], ids=["other_size", "other_skeleton"])
def test_a_source_serving_another_checkpoint_is_dropped(other) -> None:
    state = _state()
    sources = _sources("port", [state, other], heal_chunk_bytes=1 << 14)
    receiver = HTTPTransport(timeout=30.0)
    try:
        got = receiver.recv_checkpoint_striped([(i, _url(s)) for i, s in enumerate(sources)],
                                               STEP, 30.0)
    finally:
        _shutdown(receiver, *sources)
    assert _leaf_bytes(got) == _leaf_bytes(state)
    m = receiver.last_heal_metrics
    assert m.failed_sources == [_url(sources[1])]
    assert m.per_source_bytes == {_url(sources[0]): m.bytes_total}


def test_the_striped_receive_holds_no_buffer_of_the_whole_stream() -> None:
    rng = np.random.default_rng(5)
    state = {"w": rng.standard_normal(10_000_000).astype(np.float32), "torchft": {"step": STEP}}
    sources = _sources("port", [state] * 2, heal_chunk_bytes=1 << 20)
    receiver = HTTPTransport(timeout=60.0)
    stream = S.plan_pytree(_torch_state(state)).total_len
    tracemalloc.start()
    try:
        got = receiver.recv_checkpoint_striped([(i, _url(s)) for i, s in enumerate(sources)],
                                               STEP, 60.0)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
        _shutdown(receiver, *sources)
    assert stream >= 32 << 20
    assert peak < stream / 8, f"{peak} bytes traced over a {stream}-byte striped heal"
    assert _leaf_bytes(got) == _leaf_bytes(state)
    assert len(receiver.last_heal_metrics.per_source_bytes) == 2


def _fleet(tier: str, quantized: bool) -> list:
    return train_ddp.run_fleet(
        train_ddp.model_config("llama_debug"), CPU, replicas=3, steps=4, seq=64, batch=2,
        lr=1e-3, kill_at=(1, 2), timeout=60.0, should_quantize=quantized, tier=tier,
        heal_transport="http",
    )


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("tier", ["python", "cpp"])
def test_three_group_fleet_heals_from_every_other_group(monkeypatch, tier, quantized) -> None:
    # 64 KiB chunks: the debug model's state spreads over many of them
    monkeypatch.setenv("TORCHFT_HEAL_CHUNK_MB", "0.0625")
    results = _fleet(tier, quantized)
    heal = results[1].heal
    assert [r.restarts for r in results] == [0, 1, 0]
    assert all(r.final_step == 4 for r in results)
    assert heal is not None and heal.failed_sources == [] and heal.stolen_chunks == 0
    assert heal.num_sources == (2 if tier == "python" else 1)
    assert len(heal.per_source_bytes) == heal.num_sources
    assert all(n > 0 for n in heal.per_source_bytes.values())
    assert sum(heal.per_source_bytes.values()) == heal.bytes_total
    shas = {r.params_sha256 for r in results}
    assert len(shas) == 1
    monkeypatch.setenv("TORCHFT_HEAL_STRIPED", "0")
    single = _fleet(tier, quantized)
    assert single[1].heal.num_sources == 1
    assert {r.params_sha256 for r in single} == shas
