"""Per-label filters and statistics (counterpart of the parts of
``tobac_flow_tpu/detect/analysis.py`` that ``run_detection`` uses).  The
per-pixel reductions run on the label tensor's device; the per-label
tables come back to the host as numpy arrays over labels 1..max."""

from __future__ import annotations

import torch

from tobac_flow_tpu_torch.data.ncdataset import DataArray, as_tensor
from tobac_flow_tpu_torch.utils.labels import LabelSegments

__all__ = [
    "find_object_lengths", "get_label_stats", "mask_labels", "n_unique_along_axis",
    "weighted_statistics_on_labels",
]


def find_object_lengths(labels, axis: int = 0):
    """Extent of each label 1..max along ``axis`` (usually time)."""
    seg = LabelSegments(labels)
    view = [1] * labels.dim()
    view[axis] = labels.shape[axis]
    index = seg.gather(torch.arange(labels.shape[axis], device=labels.device).view(view))
    lo = seg.reduce(index, "amin", empty=0)[1:]
    hi = seg.reduce(index, "amax", empty=-1)[1:]
    return ((hi >= lo) * (hi - lo + 1)).cpu().numpy()


def mask_labels(labels, mask):
    """Bool per label 1..max: does the label overlap the mask?"""
    if tuple(labels.shape) != tuple(mask.shape):
        raise ValueError("Labels and mask parameters must have the same shape")
    seg = LabelSegments(labels)
    hit = seg.reduce(seg.gather((mask != 0).to(torch.uint8)), "amax")
    return hit[1:].cpu().numpy().astype(bool)


def n_unique_along_axis(a, axis=0):
    """Number of unique non-zero values along an axis of a tensor."""
    s = torch.sort(torch.movedim(a, axis, 0), dim=0).values
    changes = torch.cat([s[:1] != 0, s[1:] != s[:-1]]) & (s != 0)
    return changes.sum(dim=0)


def get_label_stats(da, ds):
    """Spatial and temporal coverage of a label DataArray, added to ``ds``
    as the reference names them; the fields stay on the labels' device."""
    vals = as_tensor(da)
    t_size = vals.shape[0]
    long_name = da.attrs.get("long_name", da.name)
    nonzero = vals != 0
    ds[f"{da.name}_fraction"] = DataArray(
        (nonzero.sum(0).double() / t_size).float(),
        dims=("y", "x"),
        attrs={"long_name": f"Fractional coverage of {long_name}", "units": ""},
    )
    ds[f"{da.name}_unique_count"] = DataArray(
        n_unique_along_axis(vals, 0).int(),
        dims=("y", "x"),
        attrs={"long_name": f"Number of unique {long_name}", "units": ""},
    )
    ds[f"{da.name}_temporal_fraction"] = DataArray(
        (nonzero.sum((1, 2)).double() / (vals.shape[1] * vals.shape[2])).float(),
        dims=("t",),
        attrs={"long_name": f"Fractional coverage of {long_name} over time", "units": ""},
    )
    ds[f"{da.name}_temporal_unique_count"] = DataArray(
        n_unique_along_axis(vals.reshape(t_size, -1), 1).int(),
        dims=("t",),
        attrs={"long_name": f"Number of unique {long_name} over time", "units": ""},
    )


def weighted_statistics_on_labels(labels, da, weights, name=None, dim=None, dtype=None):
    """Weighted mean, std, max and min of ``da`` over each label 1..max,
    with the reference's semantics for non-negative weights (pixel areas,
    or ones): mean and std drop NaN values and are NaN where the remaining
    weights sum to zero or hold a NaN; max and min are taken over the
    non-NaN values of positive weight, NaN where there is none.  Sums
    accumulate in float64 on the labels' device; the results are cast to
    ``dtype`` (``da``'s by default)."""
    if not dim:
        dim = labels.name.split("_label")[0]
    if dtype is None:
        dtype = da.dtype
    long_name = da.attrs.get("long_name", da.name) if hasattr(da, "attrs") else da.name
    units = da.attrs.get("units", "") if hasattr(da, "attrs") else ""

    seg = LabelSegments(as_tensor(labels))
    x = seg.gather(as_tensor(da))
    w = seg.gather(as_tensor(weights))
    valid = ~torch.isnan(x)
    x64, w64 = x.double(), w.double()
    sw = seg.sum(w64, valid)
    mean = torch.where(sw != 0, seg.sum(w64 * x64, valid) / sw, torch.nan)
    std = torch.sqrt(seg.sum(w64 * (x64 - mean[seg.bins]) ** 2, valid) / sw)
    keep = valid & (w > 0)
    stats = [mean, std, seg.reduce(x, "amax", keep, empty=float("nan")),
             seg.reduce(x, "amin", keep, empty=float("nan"))]
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
