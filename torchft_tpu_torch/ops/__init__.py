"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ops/flash_attention.py``), and their build (``ops/cuda_build.py``)."""
