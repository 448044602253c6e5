"""PyTorch + CUDA port of ``triton_dist_tpu`` for NVIDIA Hopper (H100).

A standalone package: it imports ``torch`` and never ``jax`` nor anything
of ``triton_dist_tpu`` (whose ``__init__`` imports jax). Module names
mirror the JAX package; the JAX package stays the reference every part
of this one is tested against (``tests/test_torch_*.py``).

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"`` explicitly; with no card and no explicit device it
raises (``runtime.device.default_device``). Each TPU Pallas kernel on a
ported path is a hand-written Hopper kernel under ``csrc/``, built with
``nvcc`` at first CUDA use (``ops._build``).
"""

from triton_dist_tpu_torch.runtime.device import default_device

__all__ = ["default_device"]
