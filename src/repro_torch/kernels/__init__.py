"""Hand-written CUDA kernels of the port, one package per TPU kernel family."""
