"""Blockwise-int8 kernels (CUDA for Hopper) and their plain PyTorch versions."""
