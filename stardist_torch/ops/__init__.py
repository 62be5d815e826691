"""Tensor operations of the port; the kernel wrappers launch the CUDA kernels on CUDA tensors."""
