"""Utilities: durable checkpointing, the backend probe."""

_LAZY = {
    "save_checkpoint": ("torchft_tpu_torch.utils.checkpoint", "save_checkpoint"),
    "load_checkpoint": ("torchft_tpu_torch.utils.checkpoint", "load_checkpoint"),
    "latest_step": ("torchft_tpu_torch.utils.checkpoint", "latest_step"),
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
