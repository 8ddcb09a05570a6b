"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel (``csrc``) or raises."""
