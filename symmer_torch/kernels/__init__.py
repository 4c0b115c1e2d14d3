"""Symplectic kernels: vendored host layer, plain torch core, CUDA kernels."""
