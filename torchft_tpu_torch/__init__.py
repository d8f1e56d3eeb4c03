"""torchft_tpu_torch: the PyTorch/CUDA port of torchft_tpu.

A per-step fault-tolerance framework for data-parallel training, ported
from JAX on a TPU to PyTorch on an NVIDIA H100.  It keeps the JAX package's
coordination plane byte for byte (lighthouse, manager server, store, wire
protocol, Python TCP communicator), so a port replica and a JAX replica
speak one protocol, and ports what touches tensors: the ``Manager``'s heal
path (torch tensors stream as checkpoint leaves), gradient averaging over
``.grad`` tensors (float, or quantized to int8/fp8 on the card), a
``torch.optim`` wrapper, ``LocalSGD`` and (Streaming) ``DiLoCo`` with the
sharded outer sync, the Llama-3 model, and the flash-attention and
quantized-wire kernels, hand-written in CUDA for Hopper.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The train loops are ``python -m torchft_tpu_torch.train_ddp`` and
``python -m torchft_tpu_torch.train_diloco``.
"""

__version__ = "0.1.0"

_LAZY = {
    # FT state machine + train-loop API
    "Manager": ("torchft_tpu_torch.manager", "Manager"),
    "WorldSizeMode": ("torchft_tpu_torch.manager", "WorldSizeMode"),
    "OptimizerWrapper": ("torchft_tpu_torch.optim", "OptimizerWrapper"),
    "allreduce_gradients": ("torchft_tpu_torch.ddp", "allreduce_gradients"),
    "LocalSGD": ("torchft_tpu_torch.local_sgd", "LocalSGD"),
    "DiLoCo": ("torchft_tpu_torch.local_sgd", "DiLoCo"),
    "OuterSGD": ("torchft_tpu_torch.optim", "OuterSGD"),
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
