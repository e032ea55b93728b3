"""Kernels (CUDA sources in ``csrc/``) with their plain PyTorch versions."""
