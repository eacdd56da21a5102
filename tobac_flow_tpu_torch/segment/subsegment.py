"""Morphological subsegmentation of labelled regions on the device
(counterpart of ``tobac_flow_tpu/segment/subsegment.py``).

Each per-frame region is approximated as a circle and shrunk by
``shrink_factor`` × its radius (its distance transform over the radius);
objects the shrinking misses come back from the distance field's local
maxima (one point per plateau, its first raster pixel); the region is
then split between the markers by the in-plane watershed of the negated
distance field.  Every step runs on the device, over the whole stack or
over time chunks where the device budget asks for them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tobac_flow_tpu_torch.device import (
    SUBSEGMENT_BYTES_PER_PX, chunk_plan, resolve_device, time_chunks,
)
from tobac_flow_tpu_torch.ops.ccl import flat_label
from tobac_flow_tpu_torch.ops.morphology import _sqrt, distance_transform_edt, peak_local_max_mask
from tobac_flow_tpu_torch.ops.watershed import watershed

__all__ = ["subsegment_labels"]

# the watershed's in-plane 4-neighbourhood: no temporal taps
_IN_PLANE = np.zeros((3, 3, 3), dtype=bool)
_IN_PLANE[1, 1, :] = True
_IN_PLANE[1, :, 1] = True


def _first_points(plateau):
    """One pixel per plateau label of ``plateau``: its first in raster
    (volume-raveled) order."""
    flat = plateau.reshape(-1).long()
    n = int(flat.max()) + 1 if flat.numel() else 1
    first = torch.full((n,), flat.numel(), dtype=torch.int64, device=flat.device)
    first.scatter_reduce_(0, flat, torch.arange(flat.numel(), device=flat.device), "amin")
    points = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    points[first[1:]] = True
    return points.view(plateau.shape)


def _subsegment(mask, shrink_factor, peak_min_distance, budget_bytes):
    """The sub-labels of a boolean (T, H, W) mask on its device, int32,
    numbered from 1, and their count."""
    labels = flat_label(mask, budget_bytes=budget_bytes)

    # distance to the region's edge over each region's circular radius
    dist = distance_transform_edt(labels, sampling=(1e9, 1, 1))
    counts = torch.bincount(labels.reshape(-1).long())
    radius = _sqrt(counts.clamp(min=1).to(torch.float64) / math.pi)
    dist_norm = dist / radius[labels.long()]
    del dist, counts, radius

    shrunk = dist_norm > shrink_factor
    # skimage's peak_local_max returns isolated points: keeping whole
    # plateaus would bridge separate shrunk markers through flat ridges
    maxima = peak_local_max_mask(dist_norm, min_distance=peak_min_distance,
                                 threshold_abs=1e-8)
    points = _first_points(flat_label(maxima, budget_bytes=budget_bytes))
    del maxima
    markers = flat_label(shrunk | points, budget_bytes=budget_bytes)
    del shrunk, points
    n = int(markers.max()) if markers.numel() else 0
    inside = labels != 0
    del labels
    markers = torch.where(inside, markers, -1).to(torch.int32)

    zero_flow = torch.zeros(inside.shape + (2,), dtype=torch.float32, device=mask.device)
    out = watershed(zero_flow, zero_flow, (-dist_norm).to(torch.float32), markers,
                    mask=inside, connectivity=_IN_PLANE, budget_bytes=budget_bytes,
                    device=mask.device)
    return torch.where(out < 0, 0, out).to(torch.int32), n


def subsegment_labels(input_mask, shrink_factor: float = 0.1, peak_min_distance: int = 5,
                      device=None, budget_bytes=None):
    """Split each per-frame region of ``input_mask`` (T, H, W; an array or
    tensor) into morphological sub-labels, int32 on ``device`` (the mask's
    device when it is a tensor, else see :func:`resolve_device`).  Every
    step is per frame: over ``budget_bytes`` (``SUBSEGMENT_BYTES_PER_PX``
    a pixel; see ``device.chunk_plan``) the frames run in time chunks,
    each chunk's sub-labels numbered on from the last chunk's, which gives
    the whole volume's labels."""
    if device is None and isinstance(input_mask, torch.Tensor):
        dev = input_mask.device
    else:
        dev = resolve_device(device)
    mask = torch.as_tensor(input_mask)
    t = mask.shape[0]
    chunk = chunk_plan("subsegment_labels", mask.shape, SUBSEGMENT_BYTES_PER_PX, dev,
                       budget_bytes, 0, 4)
    if chunk >= t:
        return _subsegment(mask.to(dev) != 0, shrink_factor, peak_min_distance,
                           budget_bytes)[0]
    out = torch.empty(mask.shape, dtype=torch.int32, device=dev)
    count = 0
    for s, e, _, _ in time_chunks(t, chunk):
        part, n = _subsegment(mask[s:e].to(dev) != 0, shrink_factor, peak_min_distance,
                              budget_bytes)
        out[s:e] = torch.where(part > 0, part + count, 0)
        count += n
        del part
    return out
