"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ops/flash_attention.py``, ``ops/quant.py``), and their build
(``ops/cuda_build.py``)."""

_LAZY = {
    name: ("torchft_tpu_torch.ops.quant", name)
    for name in (
        "quantize_int8_rowwise_device",
        "dequantize_int8_rowwise_device",
        "quantize_rowwise_device",
        "dequantize_rowwise_device",
        "reduce_quantized_device",
    )
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
