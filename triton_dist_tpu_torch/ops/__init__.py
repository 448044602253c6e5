"""Kernels of the port: each wrapper beside its plain PyTorch version."""
