"""Models of the port: the Llama-3 family (``models/llama.py``), its
Mixture-of-Experts variant (``models/llama_moe.py``) and the upstream
example's CNN (``models/cnn.py``)."""

_LAZY = {
    "Llama": ("torchft_tpu_torch.models.llama", "Llama"),
    "LlamaConfig": ("torchft_tpu_torch.models.llama", "LlamaConfig"),
    "LlamaMoE": ("torchft_tpu_torch.models.llama_moe", "LlamaMoE"),
    "LlamaMoEConfig": ("torchft_tpu_torch.models.llama_moe", "LlamaMoEConfig"),
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
