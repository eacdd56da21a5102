"""Grouped statistics (counterpart of the parts of
``tobac_flow_tpu/utils/stats.py`` that ``run_detection`` uses), as
reductions over label tensors on their device."""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.utils.labels import LabelSegments

__all__ = ["find_overlap_mode", "n_unique_along_axis"]


def find_overlap_mode(labels, other, index, background=0, min_count=1):
    """For each label value in ``index``: the most common nonzero value of
    ``other`` over the label's pixels, the smallest of those tied (as
    ``np.unique`` and ``argmax`` give), where it covers at least
    ``min_count`` pixels; ``background`` otherwise.  ``labels`` and
    ``other`` are non-negative integer tensors of one shape on one device.

    One histogram over the (label, value) pairs of the labelled pixels,
    then an argmax per label; returns numpy int64 over ``index``."""
    seg = LabelSegments(labels)
    values = seg.gather(other).long()
    hit = values != 0
    rows, values = seg.bins[hit], values[hit]
    width = int(values.max()) + 1 if values.numel() else 1
    pairs, counts = torch.unique(rows * width + values, return_counts=True)
    rows, values = pairs // width, pairs % width
    best = torch.zeros(seg.n + 1, dtype=counts.dtype, device=counts.device)
    best.scatter_reduce_(0, rows, counts, "amax")
    tied = counts == best[rows]
    mode = torch.full((seg.n + 1,), width, dtype=torch.int64, device=counts.device)
    mode.scatter_reduce_(0, rows[tied], values[tied], "amin")
    mode = torch.where(best >= max(min_count, 1), mode, background)
    return seg.at(mode, index, background).astype(np.int64)


def n_unique_along_axis(a, axis=0):
    """Number of distinct values along ``axis`` of a tensor, less one
    where a zero is among them (the reference's count)."""
    b = torch.sort(torch.movedim(a, axis, 0), dim=0).values
    return (b[1:] != b[:-1]).sum(dim=0) + (
        torch.count_nonzero(a, dim=axis) == a.shape[axis]
    ).long()
