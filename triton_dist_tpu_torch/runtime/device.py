"""Device selection: explicit, CUDA by default, never a silent CPU fallback."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``device=None`` means the CUDA card, and raises ``RuntimeError`` when
    no card is present: a run that asked for nothing must not quietly
    measure PyTorch's CPU kernels. Any explicit device (``"cpu"``,
    ``"cuda:0"``, a ``torch.device``) is returned as a ``torch.device``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda")
