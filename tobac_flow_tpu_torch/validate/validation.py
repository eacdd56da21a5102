"""Validation of detected objects against GLM lightning flashes
(counterpart of ``tobac_flow_tpu/validate/validation.py``): the distance
of each pixel to the nearest marker within a window of frames, POD and
FAR of the objects against the flashes, the domain and time-gap edge
filter, and the core and anvil entry points that write per-object flash
distances and the scores into the dataset.

Everything runs on ``device`` (CUDA unless the caller passes
``device="cpu"``): each frame's exact distance transform
(``ops.morphology.distance_transform_edt``, equal bit for bit to the
reference's), the minimum over the frames within the time margin, the
flash sums and the per-object minima and flags (segment reductions over
the labels).  The marker distance runs in time chunks, each read with
``time_margin`` halo frames, where a volume would exceed the device
budget (``budget_bytes``; ``None`` means ``device.memory_budget``, no
chunks on the CPU); the per-object passes run in chunks likewise.  The
two distance grids that :func:`validate_markers` returns stay on the
device; the per-object tables and scores are host numpy and floats.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.data.ncdataset import DataArray, as_tensor
from tobac_flow_tpu_torch.device import (
    LABEL_TABLE_BYTES_PER_PX, VALIDATE_BYTES_PER_PX, resolve_device, run_chunked, stage,
)
from tobac_flow_tpu_torch.ops.morphology import distance_transform_edt
from tobac_flow_tpu_torch.utils.labels import SegmentChunks, _bins_at

__all__ = [
    "get_marker_distance",
    "get_marker_distance_cylinder",
    "get_marker_distance_ellipse",
    "validate_markers",
    "get_edge_filter",
    "validate_cores",
    "validate_anvils",
    "get_min_dist_for_objects",
    "validate_cores_with_anvils",
    "validate_anvils_with_cores",
    "validate_anvil_markers",
]

_FRAMES = (1e9, 1.0, 1.0)  # the transform's spacing that keeps frames apart


def _windowed_distance(markers, reach, aspect=None):
    """Each frame's distance to its markers (``inf`` in a frame without
    one), then per pixel the minimum over the frames within ``reach``,
    each ``aspect`` a frame further off where given."""
    held = (markers != 0).flatten(1).any(1)
    frame = distance_transform_edt(markers == 0, _FRAMES)
    frame[~held] = torch.inf
    out = frame.clone()
    for o in range(1, min(int(reach), frame.shape[0] - 1) + 1):
        before, after = frame[:-o], frame[o:]
        if aspect is not None:
            before, after = before + o * aspect, after + o * aspect
        torch.minimum(out[o:], before, out=out[o:])
        torch.minimum(out[:-o], after, out=out[:-o])
    return (out,)


def _marker_distance(markers, reach, aspect, device, budget_bytes):
    markers = as_tensor(markers)
    return run_chunked("marker_distance", lambda m: _windowed_distance(m, reach, aspect),
                       (markers,), resolve_device(device), budget_bytes,
                       VALIDATE_BYTES_PER_PX, int(reach), 8)[0]


def get_marker_distance(labels, time_range=1, device=None, budget_bytes=None):
    """Distance (float64) of each pixel to the nearest marker (a nonzero
    value of ``labels``) within ±``time_range`` frames, clipped at the
    volume's ends; ``inf`` where no frame of the window holds one."""
    return _marker_distance(labels, time_range, None, device, budget_bytes)


def get_marker_distance_cylinder(markers, time_margin=3, device=None, budget_bytes=None):
    """Cylindrical marker distance: each frame's 2D distance, the minimum
    over the frames within the time margin."""
    return get_marker_distance(markers, time_margin, device, budget_bytes)


def get_marker_distance_ellipse(markers, time_margin=3, aspect=1.0, device=None,
                                budget_bytes=None):
    """Marker distance with an ellipsoidal space/time metric: each frame's
    2D distance plus ``aspect`` per frame away, the minimum over the frames
    within the time margin."""
    return _marker_distance(markers, time_margin, float(aspect), device, budget_bytes)


def _sum_dtype(dtype):
    """numpy's dtype of ``np.nansum`` over a flash grid of ``dtype``
    times a boolean."""
    grid = torch.empty(0, dtype=dtype).numpy()
    return np.nansum(grid * np.zeros(0, bool)).dtype


def _flash_sum(grid, keep):
    """``np.nansum(grid[keep])`` exactly where the grid holds counts: an
    integer grid in int64, a float grid in float64 without its NaNs."""
    if grid.is_floating_point():
        return torch.where(keep & ~torch.isnan(grid), grid.double(), 0.0).sum().item()
    return int(torch.where(keep, grid.long(), 0).sum())


def _object_tables(labels, distance, edge_filter, device, budget_bytes):
    """Per label 1..n of ``labels``: present (numpy bool), the least
    ``distance`` and whether any pixel is in ``edge_filter`` (tensors over
    bins 0..n), in time chunks where the budget calls for them."""
    seg = SegmentChunks(as_tensor(labels), "validate_objects", budget_bytes, device,
                        LABEL_TABLE_BYTES_PER_PX)
    least = torch.full((seg.n + 1,), torch.inf, dtype=torch.float64, device=device)
    inside = torch.zeros(seg.n + 1, dtype=torch.uint8, device=device)
    counts = torch.zeros(seg.n + 1, dtype=torch.int64, device=device)
    for s, e, part in seg:
        dist = part.gather(seg.take(distance, s, e))
        torch.minimum(least, part.reduce(dist, "amin", empty=torch.inf), out=least)
        flags = part.gather(seg.take(edge_filter, s, e)).to(torch.uint8)
        torch.maximum(inside, part.reduce(flags, "amax", empty=0), out=inside)
        counts += part.counts
    return counts.cpu().numpy() > 0, least, inside.bool()


def _validate(labels, glm_grid, edge_filter, n_glm_in_margin, margin, time_margin, device,
              budget_bytes, stats=None):
    dev = resolve_device(device)
    glm = as_tensor(glm_grid, dev)
    edge = as_tensor(edge_filter, dev).bool()
    with stage("marker_distance", stats, dev):
        marker_distance = get_marker_distance_cylinder(labels, time_margin, dev, budget_bytes)
    if n_glm_in_margin is None:
        n_glm_in_margin = int(_flash_sum(glm, edge))

    # the flashes within the margin of an object
    if n_glm_in_margin > 0:
        hits = _flash_sum(glm, (glm > 0) & edge & (marker_distance <= margin))
        pod = float(np.asarray(hits, dtype=_sum_dtype(glm.dtype))[()] / n_glm_in_margin)
    else:
        pod = np.nan

    # the objects farther than the margin from any flash
    with stage("flash_distance", stats, dev):
        flash_dist_grid = get_marker_distance_cylinder(glm, time_margin, dev, budget_bytes)
    with stage("objects", stats, dev):
        present, least, inside = _object_tables(labels, flash_dist_grid, edge, dev,
                                                budget_bytes)
    in_margin = inside.cpu().numpy() & present
    n_marker_in_margin = int(in_margin.sum())
    if n_marker_in_margin:
        far_objects = int(((least.cpu().numpy() > margin) & in_margin).sum())
        far = float(far_objects / n_marker_in_margin)
    else:
        far = np.nan
    return (marker_distance, flash_dist_grid, pod, far, n_marker_in_margin, n_glm_in_margin,
            present, least)


def validate_markers(labels, glm_grid, glm_distance, edge_filter, n_glm_in_margin=None,
                     margin=10, time_margin=3, device=None, budget_bytes=None, stats=None):
    """POD and FAR of the objects of ``labels`` against the gridded flashes
    (POD: the flashes within ``margin`` pixels of an object over all
    flashes inside ``edge_filter``; FAR: the objects inside the filter
    farther than ``margin`` from every flash over those objects; NaN where
    there are none).  ``glm_distance`` is accepted and ignored, as the
    reference does.  Returns (marker_distance, glm_distance_to_marker,
    pod, far, n_marker_in_margin, n_glm_in_margin), the two grids float64
    tensors on ``device``.  With a ``stats`` dict, its steps
    (``marker_distance``, ``flash_distance``, ``objects``) are timed in
    ``device.stage``."""
    return _validate(labels, glm_grid, edge_filter, n_glm_in_margin, margin, time_margin,
                     device, budget_bytes, stats)[:6]


def get_edge_filter(ds_or_shape, t_coord=None, margin=10, max_time_gap=900, glm_cover=None,
                    device=None):
    """Mask (bool, on ``device``; for a dataset by default on its core
    labels' device where they are a tensor, else on CUDA) that excludes the spatial margin (``margin=0`` excludes
    everything, as the reference's ``[-0:]`` does), the first and last
    frames, the frames each side of a time gap over ``max_time_gap``
    seconds, and where ``glm_cover`` is false."""
    if hasattr(ds_or_shape, "coords"):
        shape = tuple(ds_or_shape["core_label"].shape)
        t_coord = ds_or_shape.coords["t"]
        device = _dataset_device(ds_or_shape, "core_label", device)
    else:
        shape = tuple(ds_or_shape)
    filt = torch.ones(shape, dtype=torch.bool, device=resolve_device(device))
    m = int(margin)
    filt[:, :m] = False
    filt[:, -m:] = False
    filt[:, :, :m] = False
    filt[:, :, -m:] = False
    filt[0] = False
    filt[-1] = False
    if t_coord is not None:
        times = np.asarray(getattr(t_coord, "values", t_coord))
        gaps = np.where(np.diff(times).astype("timedelta64[s]").astype(int) > max_time_gap)[0]
        for g in gaps:
            filt[g] = False
            filt[min(g + 1, shape[0] - 1)] = False
    if glm_cover is not None:
        filt &= as_tensor(glm_cover, filt.device).bool()
    return filt


def _dataset_device(dataset, name, device):
    return resolve_device(device if device is not None or not isinstance(
        dataset[name].data, torch.Tensor) else dataset[name].data.device)


def _validate_objects(dataset, label_name, dim, prefix, glm_grid, margin, time_margin, device,
                      budget_bytes, stats):
    dev = _dataset_device(dataset, label_name, device)
    labels = dataset[label_name]
    edge_filter = get_edge_filter(labels.shape, dataset.coords["t"], margin=margin, device=dev)
    out = _validate(labels, glm_grid, edge_filter, None, margin, time_margin, dev, budget_bytes,
                    stats)
    _, _, pod, far, n_markers, n_glm, present, least = out
    obj_dist = _bins_at(present, least, np.asarray(dataset.coords[dim]), np.inf)
    dataset[f"{prefix}_glm_distance"] = DataArray(
        np.atleast_1d(obj_dist).astype(np.float64), dims=(dim,), name=f"{prefix}_glm_distance",
        attrs={"long_name": f"distance from {prefix} to nearest GLM flash"},
    )
    dataset.attrs[f"{prefix}_pod"] = pod
    dataset.attrs[f"{prefix}_far"] = far
    dataset.attrs[f"{prefix}_n_in_margin"] = n_markers
    dataset.attrs["n_glm_in_margin"] = n_glm
    return pod, far


def validate_cores(dataset, glm_grid, margin=10, time_margin=3, device=None, budget_bytes=None,
                   stats=None):
    """POD and FAR of the cores, and each core's distance to the nearest
    flash (``core_glm_distance``), into ``dataset``; ``stats`` as
    :func:`validate_markers` takes it."""
    return _validate_objects(dataset, "core_label", "core", "core", glm_grid, margin,
                             time_margin, device, budget_bytes, stats)


def validate_anvils(dataset, glm_grid, margin=10, time_margin=3, thick=True, device=None,
                    budget_bytes=None, stats=None):
    """POD and FAR of the thick (or thin) anvils, and each anvil's distance
    to the nearest flash, into ``dataset``."""
    name = "thick_anvil_label" if thick else "thin_anvil_label"
    prefix = "thick_anvil" if thick else "thin_anvil"
    return _validate_objects(dataset, name, "anvil", prefix, glm_grid, margin, time_margin,
                             device, budget_bytes, stats)


def get_min_dist_for_objects(distance_grid, labels, index=None, device=None, budget_bytes=None):
    """The least ``distance_grid`` value within each object of ``labels``
    (``inf`` for a label without pixels), at ``index`` (by default the
    labels present): (distances, index) as numpy."""
    dev = resolve_device(device)
    present, least, _ = _object_tables(labels, distance_grid,
                                       torch.zeros((), dtype=torch.bool), dev, budget_bytes)
    if index is None:
        index = np.flatnonzero(present).astype(torch.empty(0, dtype=as_tensor(labels).dtype)
                                               .numpy().dtype)
    return np.atleast_1d(_bins_at(present, least, index, np.inf)), np.asarray(index)


def validate_cores_with_anvils(dataset, glm_grid, margin=10, time_margin=3, device=None,
                               budget_bytes=None, stats=None):
    """Core POD and FAR where only flashes (and cores) inside thick anvils
    count."""
    dev = _dataset_device(dataset, "core_label", device)
    anvil_mask = as_tensor(dataset["thick_anvil_label"], dev) != 0
    edge = get_edge_filter(dataset["core_label"].shape, dataset.coords["t"], margin=margin,
                           device=dev)
    edge &= anvil_mask
    del anvil_mask
    out = validate_markers(dataset["core_label"], glm_grid, None, edge, margin=margin,
                           time_margin=time_margin, device=dev, budget_bytes=budget_bytes,
                           stats=stats)
    dataset.attrs["core_with_anvil_pod"] = out[2]
    dataset.attrs["core_with_anvil_far"] = out[3]
    return out[2], out[3]


def validate_anvils_with_cores(dataset, glm_grid, margin=10, time_margin=3, device=None,
                               budget_bytes=None, stats=None):
    """Thick-anvil POD and FAR over the anvils that have a linked core."""
    dev = _dataset_device(dataset, "thick_anvil_label", device)
    labels = as_tensor(dataset["thick_anvil_label"], dev)
    if "core_anvil_index" in dataset:
        with_core = torch.unique(as_tensor(dataset["core_anvil_index"], dev))
        keep = torch.isin(labels, with_core[with_core != 0])
        labels = torch.where(keep, labels, 0)
        del keep
    edge = get_edge_filter(labels.shape, dataset.coords["t"], margin=margin, device=dev)
    out = validate_markers(labels, glm_grid, None, edge, margin=margin, time_margin=time_margin,
                           device=dev, budget_bytes=budget_bytes, stats=stats)
    dataset.attrs["anvil_with_core_pod"] = out[2]
    dataset.attrs["anvil_with_core_far"] = out[3]
    return out[2], out[3]


def validate_anvil_markers(dataset, glm_grid, margin=10, time_margin=3, device=None,
                           budget_bytes=None, stats=None):
    """POD and FAR of the anvil markers (the watershed's seeds)."""
    if "anvil_marker_label" not in dataset:
        raise KeyError("dataset has no anvil_marker_label (save_anvil_markers)")
    dev = _dataset_device(dataset, "anvil_marker_label", device)
    edge = get_edge_filter(dataset["anvil_marker_label"].shape, dataset.coords["t"],
                           margin=margin, device=dev)
    out = validate_markers(dataset["anvil_marker_label"], glm_grid, None, edge, margin=margin,
                           time_margin=time_margin, device=dev, budget_bytes=budget_bytes,
                           stats=stats)
    return out[2], out[3]
