"""Where the port's entry points run: on the card unless the caller asks
for the CPU."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA, and raises where CUDA is not available (there
    is no fallback to the CPU); anything else is passed to
    ``torch.device``.  ``device="cpu"`` runs every op's plain PyTorch
    version."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device=\"cpu\" to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
