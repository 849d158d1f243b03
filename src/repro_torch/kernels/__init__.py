"""Hand-written Hopper kernels of the serving path, each with its plain
PyTorch version (``ref.py``) and a wrapper (``ops.py``) that runs the plain
version for CPU tensors and launches the CUDA kernel for CUDA tensors."""
