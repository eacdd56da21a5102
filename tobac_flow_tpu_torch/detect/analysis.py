"""Per-label filters and statistics (counterpart of
``tobac_flow_tpu/detect/analysis.py``).  The per-pixel reductions run on
the label tensor's device; the per-label tables come back to the host as
numpy arrays over labels 1..max, and the ``filter_labels_by_*`` family
renumbers the labels it keeps 1..n in order on the labels' device.  Those
filters keep an object of at least ``min_length`` steps, as the reference
has them (the detection functions keep longer than ``min_length``)."""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.data.ncdataset import DataArray, as_tensor
from tobac_flow_tpu_torch.device import (
    LABEL_STATS_BYTES_PER_PX, LABEL_TABLE_BYTES_PER_PX, chunk_plan, time_chunks,
)
from tobac_flow_tpu_torch.utils.labels import LabelSegments, SegmentChunks, remap_labels

__all__ = [
    "find_object_lengths", "mask_labels", "filter_labels_by_length", "filter_labels_by_mask",
    "filter_labels_by_length_and_mask", "filter_labels_by_multimask",
    "filter_labels_by_length_and_multimask", "filter_labels_by_length_and_multimask_legacy",
    "get_stats_for_labels", "get_label_stats", "n_unique_along_axis",
    "weighted_statistics_on_labels",
]


def find_object_lengths(labels, axis: int = 0, budget_bytes=None):
    """Extent of each label 1..max along ``axis`` (usually time; along
    time, a chunk of frames at a time)."""
    if axis != 0:
        seg = LabelSegments(labels)
        view = [1] * labels.dim()
        view[axis] = labels.shape[axis]
        index = seg.gather(torch.arange(labels.shape[axis], device=labels.device).view(view))
        lo = seg.reduce(index, "amin", empty=0)[1:]
        hi = seg.reduce(index, "amax", empty=-1)[1:]
        return ((hi >= lo) * (hi - lo + 1)).cpu().numpy()
    lo = hi = None
    view = (-1,) + (1,) * (labels.dim() - 1)
    for s, e, seg in SegmentChunks(labels, "find_object_lengths", budget_bytes,
                                   bytes_per_px=LABEL_TABLE_BYTES_PER_PX):
        index = seg.gather(torch.arange(s, e, device=labels.device).view(view))
        first = seg.reduce(index, "amin", empty=labels.shape[0])
        last = seg.reduce(index, "amax", empty=-1)
        lo = first if lo is None else torch.minimum(lo, first)
        hi = last if hi is None else torch.maximum(hi, last)
    if lo is None:
        return np.zeros(0, dtype=np.int64)
    lo, hi = lo[1:], hi[1:]
    return ((hi >= lo) * (hi - lo + 1)).cpu().numpy()


def mask_labels(labels, mask, budget_bytes=None):
    """Bool per label 1..max: does the label overlap the mask? (A chunk of
    frames at a time; ``mask`` may wait on the host.)"""
    if tuple(labels.shape) != tuple(mask.shape):
        raise ValueError("Labels and mask parameters must have the same shape")
    hit = None
    segs = SegmentChunks(labels, "mask_labels", budget_bytes,
                         bytes_per_px=LABEL_TABLE_BYTES_PER_PX)
    for s, e, seg in segs:
        part = seg.reduce(seg.gather((segs.take(mask, s, e) != 0).to(torch.uint8)), "amax")
        hit = part if hit is None else torch.maximum(hit, part)
    if hit is None:
        return np.zeros(0, dtype=bool)
    return hit[1:].cpu().numpy().astype(bool)


def _labels(labels):
    return as_tensor(labels) if isinstance(labels, DataArray) else torch.as_tensor(labels)


def _masks_hit(labels, masks, budget_bytes):
    if not isinstance(masks, list):
        raise ValueError("masks input must be a list of masks to process")
    return np.logical_and.reduce(
        [mask_labels(labels, as_tensor(m) if isinstance(m, DataArray) else m,
                     budget_bytes=budget_bytes) for m in masks])


def filter_labels_by_length(labels, min_length, budget_bytes=None):
    """Labels of at least ``min_length`` steps, renumbered in order."""
    labels = _labels(labels)
    keep = find_object_lengths(labels, budget_bytes=budget_bytes) >= min_length
    return remap_labels(labels, keep, budget_bytes=budget_bytes)


def filter_labels_by_mask(labels, mask, budget_bytes=None):
    """Labels that overlap ``mask``, renumbered in order."""
    labels = _labels(labels)
    return remap_labels(labels, _masks_hit(labels, [mask], budget_bytes),
                        budget_bytes=budget_bytes)


def filter_labels_by_length_and_mask(labels, mask, min_length, budget_bytes=None):
    """Labels of at least ``min_length`` steps that overlap ``mask``."""
    labels = _labels(labels)
    keep = (find_object_lengths(labels, budget_bytes=budget_bytes) >= min_length) & (
        _masks_hit(labels, [mask], budget_bytes))
    return remap_labels(labels, keep, budget_bytes=budget_bytes)


def filter_labels_by_multimask(labels, masks, budget_bytes=None):
    """Labels that overlap every mask of the list ``masks``."""
    labels = _labels(labels)
    return remap_labels(labels, _masks_hit(labels, masks, budget_bytes),
                        budget_bytes=budget_bytes)


def filter_labels_by_length_and_multimask(labels, masks, min_length, budget_bytes=None):
    """Labels of at least ``min_length`` steps that overlap every mask of
    the list ``masks``."""
    labels = _labels(labels)
    hit = _masks_hit(labels, masks, budget_bytes)
    keep = (find_object_lengths(labels, budget_bytes=budget_bytes) >= min_length) & hit
    return remap_labels(labels, keep, budget_bytes=budget_bytes)


# the reference keeps its in-place *_legacy variant with the same outputs
filter_labels_by_length_and_multimask_legacy = filter_labels_by_length_and_multimask


def get_stats_for_labels(labels, da, dim=None, dtype=None, budget_bytes=None):
    """Mean, std, max and min of ``da`` over each label 1..max, NaN values
    left out (NaN where a label has no value), as DataArrays named
    ``{dim}_{da.name}_{stat}`` (``dim`` by default the labels' name before
    ``_label``).  Sums accumulate in float64 on the labels' device
    (:class:`SegmentChunks`, the std in a second pass about the mean); the
    results are cast to ``dtype`` (``da``'s by default)."""
    if not dim:
        dim = labels.name.split("_label")[0]
    if dtype is None:
        dtype = da.dtype
    name = getattr(da, "name", None)
    long_name = da.attrs.get("long_name", name) if hasattr(da, "attrs") else name
    units = da.attrs.get("units", "") if hasattr(da, "attrs") else ""
    segs = SegmentChunks(_labels(labels), "label_statistics", budget_bytes)
    field = as_tensor(da) if isinstance(da, DataArray) else torch.as_tensor(da)
    nan = float("nan")
    total = count = hi = lo = None
    for s, e, seg in segs:
        x = seg.gather(segs.take(field, s, e))
        valid = ~torch.isnan(x)
        parts = (seg.sum(x, valid), seg.sum(valid, dtype=torch.float64),
                 seg.reduce(x, "amax", valid, empty=nan), seg.reduce(x, "amin", valid, empty=nan))
        if total is None:
            total, count, hi, lo = parts
        else:
            total, count = total + parts[0], count + parts[1]
            hi, lo = torch.fmax(hi, parts[2]), torch.fmin(lo, parts[3])
    if total is None:
        stats = [torch.zeros(1, dtype=torch.float64)] * 4
    else:
        mean = total / count
        ss = None
        for s, e, seg in segs:
            x = seg.gather(segs.take(field, s, e))
            dev = x.double() - mean[seg.bins]
            part = seg.sum(dev * dev, ~torch.isnan(x))
            ss = part if ss is None else ss + part
        stats = [mean, torch.sqrt(ss / count), hi, lo]
    return tuple(
        DataArray(values[1:].cpu().numpy().astype(dtype), dims=(dim,),
                  name=f"{dim}_{name}_{stat}",
                  attrs={"long_name": f"{stat} of {long_name} for each {dim}", "units": units})
        for stat, values in zip(["mean", "std", "max", "min"], stats))


def n_unique_along_axis(a, axis=0):
    """Number of unique non-zero values along an axis of a tensor."""
    s = torch.sort(torch.movedim(a, axis, 0), dim=0).values
    changes = torch.cat([s[:1] != 0, s[1:] != s[:-1]]) & (s != 0)
    return changes.sum(dim=0)


def get_label_stats(da, ds, budget_bytes=None):
    """Spatial and temporal coverage of a label DataArray, added to ``ds``
    as the reference names them, on the labels' device: per pixel the
    share of frames labelled and the number of distinct labels over time
    (over blocks of rows, each with every frame), per frame the share of
    pixels labelled and the number of distinct labels (over time chunks);
    both sized by ``device.chunk_plan`` from ``LABEL_STATS_BYTES_PER_PX``
    within ``budget_bytes`` (``None``: ``device.memory_budget``, whole on
    the CPU).  A volume that waits on the host moves a block at a time."""
    vals = as_tensor(da)
    t_size, h, w = vals.shape
    dev = vals.device
    long_name = da.attrs.get("long_name", da.name)
    fraction = torch.empty((h, w), dtype=torch.float32, device=dev)
    unique = torch.empty((h, w), dtype=torch.int32, device=dev)
    rows = chunk_plan("label_stats_rows", (h, t_size, w), LABEL_STATS_BYTES_PER_PX, dev,
                      budget_bytes)
    for r0, r1, _, _ in time_chunks(h, rows):
        block = vals[:, r0:r1].to(dev)
        fraction[r0:r1] = ((block != 0).sum(0).double() / t_size).float()
        unique[r0:r1] = n_unique_along_axis(block, 0).int()
        del block
    temporal_fraction = torch.empty(t_size, dtype=torch.float32, device=dev)
    temporal_unique = torch.empty(t_size, dtype=torch.int32, device=dev)
    frames = chunk_plan("label_stats_frames", tuple(vals.shape), LABEL_STATS_BYTES_PER_PX, dev,
                        budget_bytes)
    for s, e, _, _ in time_chunks(t_size, frames):
        chunk = vals[s:e].to(dev).reshape(e - s, -1)
        temporal_fraction[s:e] = ((chunk != 0).sum(1).double() / (h * w)).float()
        temporal_unique[s:e] = n_unique_along_axis(chunk, 1).int()
        del chunk
    ds[f"{da.name}_fraction"] = DataArray(
        fraction, dims=("y", "x"),
        attrs={"long_name": f"Fractional coverage of {long_name}", "units": ""},
    )
    ds[f"{da.name}_unique_count"] = DataArray(
        unique, dims=("y", "x"),
        attrs={"long_name": f"Number of unique {long_name}", "units": ""},
    )
    ds[f"{da.name}_temporal_fraction"] = DataArray(
        temporal_fraction, dims=("t",),
        attrs={"long_name": f"Fractional coverage of {long_name} over time", "units": ""},
    )
    ds[f"{da.name}_temporal_unique_count"] = DataArray(
        temporal_unique, dims=("t",),
        attrs={"long_name": f"Number of unique {long_name} over time", "units": ""},
    )


def weighted_statistics_on_labels(labels, da, weights, name=None, dim=None, dtype=None,
                                  budget_bytes=None):
    """Weighted mean, std, max and min of ``da`` over each label 1..max,
    with the reference's semantics for non-negative weights (pixel areas,
    or ones): mean and std drop NaN values and are NaN where the remaining
    weights sum to zero or hold a NaN; max and min are taken over the
    non-NaN values of positive weight, NaN where there is none.  Sums
    accumulate in float64 on the labels' device, over time chunks where
    the volume calls for them (:class:`SegmentChunks`; the std takes a
    second pass, about the mean); the results are cast to ``dtype``
    (``da``'s by default)."""
    if not dim:
        dim = labels.name.split("_label")[0]
    if dtype is None:
        dtype = da.dtype
    long_name = da.attrs.get("long_name", da.name) if hasattr(da, "attrs") else da.name
    units = da.attrs.get("units", "") if hasattr(da, "attrs") else ""

    segs = SegmentChunks(as_tensor(labels), "weighted_statistics", budget_bytes)
    field, weights = as_tensor(da), as_tensor(weights)
    nan = float("nan")

    def pixels(s, e, seg):
        x = seg.gather(segs.take(field, s, e))
        w = seg.gather(segs.take(weights, s, e))
        return x, w, ~torch.isnan(x)

    sw = swx = hi = lo = None
    for s, e, seg in segs:
        x, w, valid = pixels(s, e, seg)
        x64, w64 = x.double(), w.double()
        parts = (seg.sum(w64, valid), seg.sum(w64 * x64, valid),
                 seg.reduce(x, "amax", valid & (w > 0), empty=nan),
                 seg.reduce(x, "amin", valid & (w > 0), empty=nan))
        if sw is None:
            sw, swx, hi, lo = parts
        else:
            sw, swx = sw + parts[0], swx + parts[1]
            hi, lo = torch.fmax(hi, parts[2]), torch.fmin(lo, parts[3])
    mean = torch.where(sw != 0, swx / sw, torch.nan)
    ss = None
    for s, e, seg in segs:
        x, w, valid = pixels(s, e, seg)
        dev = x.double() - mean[seg.bins]
        part = seg.sum(w.double() * (dev * dev), valid)
        ss = part if ss is None else ss + part
    stats = [mean, torch.sqrt(ss / sw), hi, lo]
    out = []
    for stat, values in zip(["mean", "std", "max", "min"], stats):
        out.append(
            DataArray(
                values[1:].cpu().numpy().astype(dtype),
                dims=(dim,),
                name=f"{name}_{da.name}_{stat}",
                attrs={"long_name": f"{stat} of {long_name} for each {dim}", "units": units},
            )
        )
    return tuple(out)
