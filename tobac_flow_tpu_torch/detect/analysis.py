"""Per-label filters (counterpart of the parts of
``tobac_flow_tpu/detect/analysis.py`` the detection chain uses).  The
per-pixel reductions run on the label tensor's device; the per-label
tables come back to the host as numpy arrays over labels 1..max."""

from __future__ import annotations

import torch

__all__ = ["find_object_lengths", "mask_labels"]


def _per_label(labels, values, reduce, empty):
    """``reduce`` ("amin", "amax") of ``values`` over each label 1..max,
    ``empty`` where a label has no pixel."""
    n = int(labels.max()) if labels.numel() else 0
    if n <= 0:
        return torch.empty(0, dtype=values.dtype).numpy()
    fg = labels > 0
    out = torch.full((n + 1,), empty, dtype=values.dtype, device=labels.device)
    out.scatter_reduce_(0, labels[fg].long(), values[fg], reduce, include_self=False)
    return out[1:].cpu().numpy()


def find_object_lengths(labels, axis: int = 0):
    """Extent of each label 1..max along ``axis`` (usually time)."""
    view = [1] * labels.dim()
    view[axis] = labels.shape[axis]
    index = torch.arange(labels.shape[axis], device=labels.device).view(view)
    index = index.expand(labels.shape)
    lo = _per_label(labels, index, "amin", 0)
    hi = _per_label(labels, index, "amax", -1)
    return (hi >= lo) * (hi - lo + 1)


def mask_labels(labels, mask):
    """Bool per label 1..max: does the label overlap the mask?"""
    if tuple(labels.shape) != tuple(mask.shape):
        raise ValueError("Labels and mask parameters must have the same shape")
    return _per_label(labels, (mask != 0).to(torch.uint8), "amax", 0).astype(bool)
