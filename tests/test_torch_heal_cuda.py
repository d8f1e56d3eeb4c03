"""The heal's card path: a state on the card sent through the pinned
staging rings, held bit for bit against the host path (the same state on
the CPU) for ``HTTPTransport`` (``/full``, the parallel chunks, each
landing in place, and a striped heal from two sources) and
``CommTransport`` (per-array frames written in parts, and a striped heal
from two sources) on both tiers.

Marked ``cuda`` and skipped without a card.  It imports nothing of JAX, so
it runs on the card's machine with::

    python -m pytest --noconftest -m cuda tests/test_torch_heal_cuda.py
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from torchft_tpu_torch import native
from torchft_tpu_torch.checkpointing import serialization as S
from torchft_tpu_torch.checkpointing.comm_transport import CommTransport
from torchft_tpu_torch.checkpointing.http_transport import HEAL_NUM_CHUNKS, HTTPTransport
from torchft_tpu_torch.communicator import TCPCommunicator
from torchft_tpu_torch.store import StoreServer

STEP = 7


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(device) -> dict:
    g = torch.Generator(device="cpu").manual_seed(0)
    host = {
        "params": {
            # 2.5 ring slots (the last one short), bf16
            "big": torch.randn(int(2.5 * S.SEND_SLOT_BYTES) // 2, generator=g).to(torch.bfloat16),
            "w": torch.randn(1001, 17, generator=g),
            "q": torch.randint(-128, 128, (3, 1025), generator=g).to(torch.int8),
            "mask": torch.rand(777, generator=g) < 0.5,
            "empty": torch.empty(0, 5),
        },
        "torchft": {"step": STEP, "batches_committed": 2},
    }
    return host if device.type == "cpu" else _to(host, device)


def _to(obj, device):
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    return obj.to(device) if isinstance(obj, torch.Tensor) else obj


def _leaf_bytes(state) -> list:
    if isinstance(state, torch.Tensor):
        return [state.cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()]
    if isinstance(state, dict):
        return [b for v in state.values() for b in _leaf_bytes(v)]
    return []


@pytest.mark.cuda
def test_card_plan_serves_the_host_plans_bytes(cuda_device) -> None:
    import io

    plans = [S.plan_pytree(_state(d), snapshot=True) for d in (torch.device("cpu"), cuda_device)]
    outs = []
    for plan in plans:
        out = io.BytesIO()
        plan.write_range(0, plan.total_len, out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    # a range that starts and ends inside the big leaf's slots
    a, b = len(plans[1].header) + 100, len(plans[1].header) + 2 * S.SEND_SLOT_BYTES + 7
    out = io.BytesIO()
    plans[1].write_range(a, b, out)
    assert out.getvalue() == outs[0][a:b]


@pytest.mark.cuda
def test_the_ring_stages_a_card_leaf_in_pinned_slots(cuda_device) -> None:
    src = torch.arange(3 * 1024, dtype=torch.int32, device=cuda_device).view(torch.uint8)
    ring = S.StagingRing(slots=2, slot_bytes=4096)
    out = []
    for view, release in ring.chunks([(src, 0, src.numel())]):
        out.append(bytes(view))
        release()
    assert b"".join(out) == src.cpu().numpy().tobytes()
    assert all(buf is not None and buf.is_pinned() for buf in ring._bufs)


@pytest.mark.cuda
@pytest.mark.parametrize("num_chunks", [0, HEAL_NUM_CHUNKS])
def test_http_heal_of_a_card_state_is_the_host_paths(cuda_device, num_chunks) -> None:
    got = {}
    for key, device in (("host", torch.device("cpu")), ("card", cuda_device)):
        source = HTTPTransport(timeout=60.0, num_chunks=num_chunks)
        client = HTTPTransport(timeout=60.0, num_chunks=num_chunks)
        try:
            source.send_checkpoint([1], STEP, _state(device), 60.0)
            got[key] = client.recv_checkpoint(0, f"http://127.0.0.1:{source.port}", STEP, 60.0)
        finally:
            source.shutdown()
            client.shutdown()
    assert _leaf_bytes(got["card"]) == _leaf_bytes(got["host"]) == _leaf_bytes(_state(cuda_device))
    assert got["card"]["params"]["mask"].dtype == torch.bool


@pytest.mark.cuda
def test_striped_http_heal_of_card_states_is_the_host_paths(cuda_device) -> None:
    """Two sources staging the state on the card, healed striped (the
    chunk index at 4 KiB, so ranges cross the ring's slots) into the
    landing arrays: bit for bit the host path's single-source heal."""
    host = HTTPTransport(timeout=60.0)
    sources = [HTTPTransport(timeout=60.0, heal_chunk_bytes=4096) for _ in range(2)]
    client = HTTPTransport(timeout=60.0)
    try:
        host.send_checkpoint([1], STEP, _state(torch.device("cpu")), 60.0)
        for t in sources:
            t.send_checkpoint([1], STEP, _state(cuda_device), 60.0)
        want = client.recv_checkpoint(0, f"http://127.0.0.1:{host.port}", STEP, 60.0)
        got = client.recv_checkpoint_striped(
            [(i, f"http://127.0.0.1:{t.port}") for i, t in enumerate(sources)], STEP, 60.0)
    finally:
        for t in (host, client, *sources):
            t.shutdown()
    assert _leaf_bytes(got) == _leaf_bytes(want) == _leaf_bytes(_state(cuda_device))
    m = client.last_heal_metrics
    assert m.num_sources == 2 and sum(m.per_source_bytes.values()) == m.bytes_total
    assert not m.failed_sources


TIERS = {
    "python": lambda: TCPCommunicator(timeout_s=60.0),
    "cpp": lambda: native.CppCommunicator(timeout_s=60.0),
}


def _group(tier: str, fns) -> list:
    store = StoreServer("127.0.0.1:0")
    comms = [TIERS[tier]() for _ in fns]

    def _run(rank: int):
        comms[rank].configure(f"127.0.0.1:{store.port}/hc_{tier}", replica_id=f"r{rank}",
                              rank=rank, world_size=len(fns))
        try:
            return fns[rank](comms[rank])
        finally:
            comms[rank].shutdown()

    try:
        with ThreadPoolExecutor(max_workers=len(fns)) as pool:
            return [f.result(timeout=120) for f in [pool.submit(_run, r) for r in range(len(fns))]]
    finally:
        store.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("striped", [False, True], ids=["per_array", "striped"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_comm_heal_of_a_card_state_is_the_host_paths(cuda_device, tier, striped) -> None:
    got = {}
    for key, device in (("host", torch.device("cpu")), ("card", cuda_device)):
        state = _state(device)
        sources = [0, 1] if striped else [0]

        def _send(comm, index):
            t = CommTransport(comm)
            if striped:
                t.send_checkpoint_striped([len(sources)], STEP, state, 60.0, source_index=index,
                                          num_sources=len(sources))
            else:
                t.send_checkpoint([len(sources)], STEP, state, 60.0)

        def _recv(comm):
            return CommTransport(comm).recv_checkpoint_striped(
                [(r, "<comm>") for r in sources], STEP, 60.0)

        fns = [lambda c, i=i: _send(c, i) for i in range(len(sources))] + [_recv]
        got[key] = _group(tier, fns)[-1]
    assert _leaf_bytes(got["card"]) == _leaf_bytes(got["host"]) == _leaf_bytes(_state(cuda_device))
