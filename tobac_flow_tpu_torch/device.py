"""Where the port's entry points run: on the card unless the caller asks
for the CPU; and how their stages are timed."""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function

__all__ = ["resolve_device", "stage"]


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


@contextmanager
def stage(name, stats, device):
    """Run the body inside the profiler range ``stage.{name}``.  With a
    ``stats`` dict, also record the stage's seconds as ``{name}_s`` (the
    device synchronised at its end) and its start and end on the Unix
    clock in ns (``time.time_ns``, the profiler's clock) as
    ``{name}_span_ns``."""
    t0, start_ns = time.perf_counter(), time.time_ns()
    with record_function(f"stage.{name}"):
        yield
        if stats is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            stats[f"{name}_s"] = time.perf_counter() - t0
            stats[f"{name}_span_ns"] = (start_ns, time.time_ns())
