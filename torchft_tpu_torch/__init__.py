"""torchft_tpu_torch: the PyTorch/CUDA port of torchft_tpu.

A per-step fault-tolerance framework for data-parallel training, ported
from JAX on a TPU to PyTorch on an NVIDIA H100.  It keeps the JAX package's
coordination plane byte for byte (lighthouse, manager server, store, wire
protocol, Python TCP communicator), so a port replica and a JAX replica
speak one protocol, and ports what touches tensors: the ``Manager``'s heal
path (torch tensors stream as checkpoint leaves), gradient averaging over
``.grad`` tensors, a ``torch.optim`` wrapper, the Llama-3 model, and the
flash-attention kernels, hand-written in CUDA for Hopper.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The train loop is ``python -m torchft_tpu_torch.train_ddp``.
"""

__version__ = "0.1.0"

_LAZY = {
    # FT state machine + train-loop API
    "Manager": ("torchft_tpu_torch.manager", "Manager"),
    "WorldSizeMode": ("torchft_tpu_torch.manager", "WorldSizeMode"),
    "OptimizerWrapper": ("torchft_tpu_torch.optim", "OptimizerWrapper"),
    "allreduce_gradients": ("torchft_tpu_torch.ddp", "allreduce_gradients"),
    # data plane
    "Communicator": ("torchft_tpu_torch.communicator", "Communicator"),
    "TCPCommunicator": ("torchft_tpu_torch.communicator", "TCPCommunicator"),
    "ReduceOp": ("torchft_tpu_torch.communicator", "ReduceOp"),
    # control plane
    "LighthouseServer": ("torchft_tpu_torch.lighthouse", "LighthouseServer"),
    "LighthouseClient": ("torchft_tpu_torch.lighthouse", "LighthouseClient"),
    "ManagerServer": ("torchft_tpu_torch.manager_server", "ManagerServer"),
    "ManagerClient": ("torchft_tpu_torch.manager_server", "ManagerClient"),
    # checkpointing
    "CheckpointTransport": ("torchft_tpu_torch.checkpointing.transport", "CheckpointTransport"),
    "HTTPTransport": ("torchft_tpu_torch.checkpointing.http_transport", "HTTPTransport"),
    # model and kernels
    "Llama": ("torchft_tpu_torch.models.llama", "Llama"),
    "flash_attention": ("torchft_tpu_torch.ops.flash_attention", "flash_attention"),
}

__all__ = list(_LAZY)


def __getattr__(name: str):  # lazy so importing the package stays cheap
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
