"""Hand-written CUDA kernels of the serving path and their plain
PyTorch versions. A wrapper launches its kernel for CUDA tensors and
runs the plain version only for CPU tensors."""
