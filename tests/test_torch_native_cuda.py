"""The C++ tier's hand-off of tensors on a machine with a card: pinned host
tensors (f32 and bf16) reach it as views of their own memory, and an
allreduce of them lands in that memory; a tensor on the card is refused.

Marked ``cuda`` and skipped without a card.  It imports nothing of JAX, so
it runs on the card's machine with::

    python -m pytest --noconftest -m cuda tests/test_torch_native_cuda.py
"""

from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from torchft_tpu_torch import native
from torchft_tpu_torch.communicator import CommunicatorError, ReduceOp


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert native.available(), native._lib_error
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pinned_tensors_reduce_in_their_own_memory(cuda_device, dtype) -> None:
    store = native.CppStoreServer("127.0.0.1:0")

    def rank(r: int) -> torch.Tensor:
        host = torch.full((4096,), float(r + 1), dtype=dtype, pin_memory=True)
        assert native.as_host_array(host).ctypes.data == host.data_ptr()
        comm = native.CppCommunicator(timeout_s=30.0)
        comm.configure(f"127.0.0.1:{store.port}/pinned", replica_id=f"r{r}", rank=r,
                       world_size=2)
        try:
            out = comm.allreduce([host], ReduceOp.SUM, in_place=True).wait(timeout=30.0)
            assert out[0].ctypes.data == host.data_ptr()
            return host
        finally:
            comm.shutdown()

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            hosts = list(pool.map(rank, range(2)))
    finally:
        store.shutdown()
    for host in hosts:
        assert host.is_pinned()
        assert torch.equal(host, torch.full((4096,), 3.0, dtype=dtype))


@pytest.mark.cuda
def test_a_tensor_on_the_card_is_refused(cuda_device) -> None:
    with pytest.raises(CommunicatorError, match="host buffers"):
        native.as_host_array(torch.empty(4, device=cuda_device))
