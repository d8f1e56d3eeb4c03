"""Durable checkpoints of a state on the card: the pinned staging ring of
``utils/checkpoint.py`` writes the same file, and takes the same digest,
as the host path does for the state's CPU copy, across chunk boundaries
and ring reuse, and a save restores bit for bit into tensors on the card.

Marked ``cuda`` and skipped without a card.  It imports nothing of JAX, so
it runs on the card's machine with::

    python -m pytest --noconftest -m cuda tests/test_torch_checkpoint_cuda.py
"""

import pytest
import torch

from torchft_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(device) -> dict:
    g = torch.Generator(device="cpu").manual_seed(0)
    return {
        "model": {
            # 2.5 chunks of 64 MiB (the last one short), then leaves that fit one
            "big": torch.randn(int(2.5 * ckpt.CHUNK_BYTES) // 2, generator=g).to(torch.bfloat16),
            "w": torch.randn(1000, 17, generator=g),
            "empty": torch.empty(0),
        },
        "optim": {"m": [torch.randn(33, generator=g).to(torch.bfloat16) for _ in range(20)]},
        "torchft": {"step": 3, "batches_committed": 6},
    } if device.type == "cpu" else _to(_state(torch.device("cpu")), device)


def _to(obj, device):
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to(v, device) for v in obj]
    return obj.to(device) if isinstance(obj, torch.Tensor) else obj


@pytest.mark.cuda
def test_card_state_saves_and_digests_as_its_host_copy(cuda_device, tmp_path) -> None:
    host, card = _state(torch.device("cpu")), _state(cuda_device)
    with ckpt.ChunkDigest() as d_host, ckpt.ChunkDigest() as d_card:
        ckpt.save_checkpoint(str(tmp_path / "host"), 3, host, digest=d_host)
        ckpt.save_checkpoint(str(tmp_path / "card"), 3, card, digest=d_card)
        assert d_host.hexdigest() == d_card.hexdigest() == ckpt.state_digest(card)
    files = [(tmp_path / d / "step_3" / "state.tftc").read_bytes() for d in ("host", "card")]
    assert files[0] == files[1]
    loaded = ckpt.load_checkpoint(str(tmp_path / "card"), 3)
    restored = _to(loaded, cuda_device)
    assert ckpt.state_digest(restored) == ckpt.state_digest(card)
    assert torch.equal(restored["model"]["big"], card["model"]["big"])
