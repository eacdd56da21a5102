"""Where the port's entry points run: on the card unless the caller asks
for the CPU; how their stages are timed; and how much device memory a
stage may still take."""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function

__all__ = ["resolve_device", "stage", "memory_budget", "peak_memory", "reset_peak_memory"]

# share of the card's memory that a budget leaves free: the caching
# allocator's fragmentation, the CUDA context and library workspaces
MEMORY_MARGIN = 0.15

# the high-water mark of each CUDA device before ``stage``'s last reset of
# the allocator's peak statistics, and the peaks of the stages still open
_CARRIED = {}
_OPEN = []


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


def memory_budget(device, need=0) -> int | None:
    """Bytes that a stage may still allocate on ``device``: the card's free
    memory less ``MEMORY_MARGIN`` of its total.  Where that is under
    ``need``, PyTorch's caching allocator first returns its unused blocks
    to the card (a cached block that a live tensor shares cannot be
    returned, and is not counted).  ``None`` on the CPU, where no stage is
    sized by memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    margin = int(MEMORY_MARGIN * total)
    if free - margin < need:
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(device)
    return max(0, free - margin)


def _index(device):
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def reset_peak_memory(device) -> None:
    """Start a new high-water mark of ``device``'s allocated memory."""
    torch.cuda.reset_peak_memory_stats(device)
    _CARRIED[_index(device)] = 0


def peak_memory(device) -> int:
    """The most memory allocated on ``device`` since
    :func:`reset_peak_memory`, across the resets that ``stage`` makes to
    measure its own peaks (``torch.cuda.max_memory_allocated`` alone sees
    only the time since the last stage began)."""
    return max(torch.cuda.max_memory_allocated(device), _CARRIED.get(_index(device), 0))


def _carry(device):
    """Fold the allocator's peak so far into the open stages' and the
    device's high-water marks; returns it."""
    peak = torch.cuda.max_memory_allocated(device)
    idx = _index(device)
    _CARRIED[idx] = max(_CARRIED.get(idx, 0), peak)
    for frame in _OPEN:
        frame[0] = max(frame[0], peak)
    return peak


@contextmanager
def stage(name, stats, device):
    """Run the body inside the profiler range ``stage.{name}``.  With a
    ``stats`` dict, also record the stage's seconds as ``{name}_s`` (the
    device synchronised at its end) and its start and end on the Unix
    clock in ns (``time.time_ns``, the profiler's clock) as
    ``{name}_span_ns``; on CUDA also the memory allocated at its start,
    ``{name}_start_bytes``, and the most allocated during it,
    ``{name}_peak_bytes``."""
    cuda = stats is not None and device.type == "cuda"
    if cuda:
        _carry(device)
        start_bytes = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        frame = [0]
        _OPEN.append(frame)
    t0, start_ns = time.perf_counter(), time.time_ns()
    try:
        with record_function(f"stage.{name}"):
            yield
            if stats is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                stats[f"{name}_s"] = time.perf_counter() - t0
                stats[f"{name}_span_ns"] = (start_ns, time.time_ns())
    finally:
        if cuda:
            _OPEN[:] = [f for f in _OPEN if f is not frame]
            peak = _carry(device)
            stats[f"{name}_start_bytes"] = start_bytes
            stats[f"{name}_peak_bytes"] = max(frame[0], peak)
