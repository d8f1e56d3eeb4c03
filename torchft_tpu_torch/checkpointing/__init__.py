"""Live peer-to-peer checkpoint transports (reference: ``torchft/checkpointing/``)."""

_LAZY = {
    "CheckpointTransport": ("torchft_tpu_torch.checkpointing.transport", "CheckpointTransport"),
    "HTTPTransport": ("torchft_tpu_torch.checkpointing.http_transport", "HTTPTransport"),
    "CommTransport": ("torchft_tpu_torch.checkpointing.comm_transport", "CommTransport"),
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
