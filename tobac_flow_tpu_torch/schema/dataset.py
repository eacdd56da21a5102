"""Output-dataset schema: label coordinates, linking indices, flags and
per-object properties (counterpart of the parts of
``tobac_flow_tpu/schema/dataset.py`` that ``run_detection`` calls, with
its names, dims, dtypes and attrs).

The label volumes and fields stay where the dataset holds them (tensors
on the card, or numpy on the CPU); every per-label quantity is a
reduction over them on that device (``utils.labels.LabelSegments``,
``utils.stats.find_overlap_mode``), and only the per-label vectors come
back to the host, where the coordinates and the small per-object tables
are numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, as_tensor
from tobac_flow_tpu_torch.ops.morphology import binary_dilation
from tobac_flow_tpu_torch.utils.datetime_utils import get_datetime_from_coord
from tobac_flow_tpu_torch.utils.labels import (
    LabelSegments, remap_labels, slice_labels, unique_labels,
)
from tobac_flow_tpu_torch.utils.stats import find_overlap_mode

__all__ = [
    "add_step_labels",
    "add_label_coords",
    "link_cores_and_anvils",
    "link_step_labels",
    "find_edge_labels",
    "flag_edge_labels",
    "flag_nan_adjacent_labels",
    "calculate_label_properties",
]


def _add(ds, name, data, dims, long_name="", units="", dtype=None):
    """A variable with the reference's attrs; ``dtype`` casts numpy data
    (a tensor is stored as it is)."""
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
        if dtype is not None:
            data = data.astype(dtype)
    ds[name] = DataArray(
        data, dims=dims, name=name, attrs={"long_name": long_name, "units": units}
    )


def _contains(label_values, *volumes):
    """Bool per value of ``label_values``: is it a nonzero label of any of
    the tensors ``volumes``?"""
    found = unique_labels(torch.cat([v.reshape(-1) for v in volumes]))
    return np.isin(label_values, found)


# -- step labels / label coords ----------------------------------------------


def add_step_labels(dataset: Dataset) -> None:
    """Per-step labels for cores and anvils."""
    for src, name, long_name in [
        ("core_label", "core_step_label", "labels for detected cores at each time step"),
        (
            "thick_anvil_label",
            "thick_anvil_step_label",
            "labels for detected thick anvil regions at each time step",
        ),
        (
            "thin_anvil_label",
            "thin_anvil_step_label",
            "labels for detected thin anvil regions at each time step",
        ),
    ]:
        _add(
            dataset,
            name,
            slice_labels(as_tensor(dataset[src])).to(torch.int32),
            ("t", "y", "x"),
            long_name=long_name,
        )


def add_label_coords(dataset: Dataset) -> Dataset:
    """Add the label values present as coordinates (int32)."""

    def uniq(*names):
        vals = [unique_labels(as_tensor(dataset[n])) for n in names if n in dataset]
        vals = np.unique(np.concatenate(vals).astype(np.int64)) if vals else np.empty(0)
        return vals[vals != 0].astype(np.int32)

    dataset.coords["core"] = uniq("core_label")
    dataset.coords["anvil"] = uniq("thick_anvil_label", "thin_anvil_label")
    if "core_step_label" in dataset:
        dataset.coords["core_step"] = uniq("core_step_label")
    if "thick_anvil_step_label" in dataset:
        dataset.coords["thick_anvil_step"] = uniq("thick_anvil_step_label")
    if "thin_anvil_step_label" in dataset:
        dataset.coords["thin_anvil_step"] = uniq("thin_anvil_step_label")
    return dataset


# -- core <-> anvil linking ---------------------------------------------------


def link_cores_and_anvils(
    dataset: Dataset, atol: int = 5, add_cores_to_anvils: bool = True
) -> None:
    """Each core's anvil: the thick anvil covering most of its pixels (the
    smallest label of those tied), where that is at least ``atol`` pixels,
    else 0.  With ``add_cores_to_anvils`` each linked core's pixels take
    its anvil's label in both anvil volumes, in place."""
    cores = dataset.coords["core"]
    core_label = as_tensor(dataset["core_label"])
    core_anvil_index = find_overlap_mode(
        core_label, as_tensor(dataset["thick_anvil_label"]), cores, min_count=atol
    )
    _add(
        dataset,
        "core_anvil_index",
        core_anvil_index,
        ("core",),
        long_name="anvil index for each core",
        dtype=np.int32,
    )

    if add_cores_to_anvils and cores.size:
        remapped = remap_labels(core_label, locations=cores, new_labels=core_anvil_index)
        wh = remapped != 0
        for name in ("thick_anvil_label", "thin_anvil_label"):
            anvil = as_tensor(dataset[name])
            anvil[wh] = remapped[wh].to(anvil.dtype)

    anvils = dataset.coords["anvil"]
    pos = core_anvil_index[core_anvil_index > 0].astype(np.int64)
    counts = np.bincount(
        pos, minlength=(int(anvils.max()) + 1 if anvils.size else 1)
    )
    anvil_core_count = counts[np.asarray(anvils, dtype=np.int64)]
    _add(
        dataset,
        "anvil_core_count",
        anvil_core_count,
        ("anvil",),
        long_name="number of cores associated with anvil",
        dtype=np.int32,
    )


def link_step_labels(dataset: Dataset) -> None:
    """Each step's object: the label covering most of its pixels (the
    smallest of those tied), 0 where none does."""
    for step_label, label, step_dim, name, long_name in [
        (
            "core_step_label",
            "core_label",
            "core_step",
            "core_step_core_index",
            "core index for each core time step",
        ),
        (
            "thick_anvil_step_label",
            "thick_anvil_label",
            "thick_anvil_step",
            "thick_anvil_step_anvil_index",
            "anvil index for each thick anvil time step",
        ),
        (
            "thin_anvil_step_label",
            "thin_anvil_label",
            "thin_anvil_step",
            "thin_anvil_step_anvil_index",
            "anvil index for each thin anvil time step",
        ),
    ]:
        idx = find_overlap_mode(
            as_tensor(dataset[step_label]), as_tensor(dataset[label]),
            dataset.coords[step_dim],
        )
        _add(dataset, name, idx, (step_dim,), long_name=long_name, dtype=np.int32)


# -- edge / NaN flags ---------------------------------------------------------


def find_edge_labels(
    labels, label_values, t_coord, start_date=None, end_date=None, max_time_gap=900
):
    """Edge, start and end flags per label value: labels on the first or
    last row or column of any frame; labels in the frames at or before
    ``start_date`` (the first frame without one) and at or after
    ``end_date`` (the last), and on either side of a time gap over
    ``max_time_gap`` seconds."""
    vals = as_tensor(labels)
    label_values = np.asarray(label_values)
    edge_flag = _contains(
        label_values, vals[:, 0], vals[:, -1], vals[:, :, 0], vals[:, :, -1]
    )

    times = np.asarray(getattr(t_coord, "values", t_coord))
    pytimes = get_datetime_from_coord(times)
    if start_date is not None and pytimes[0] < start_date:
        n_start = int(np.searchsorted(times, np.datetime64(start_date), side="right"))
        start_frames = [vals[:n_start]]
    else:
        start_frames = [vals[0]]
    if end_date is not None and pytimes[-1] > end_date:
        n_end = int(np.searchsorted(times, np.datetime64(end_date), side="left"))
        end_frames = [vals[n_end:]]
    else:
        end_frames = [vals[-1]]

    gaps = np.where(np.diff(times).astype("timedelta64[s]").astype(int) > max_time_gap)[0]
    if gaps.size:
        gaps = torch.as_tensor(gaps, device=vals.device)
        start_frames.append(vals[gaps])
        end_frames.append(vals[gaps + 1])

    return edge_flag, _contains(label_values, *start_frames), _contains(label_values, *end_frames)


def flag_edge_labels(dataset: Dataset, start_date=None, end_date=None, max_time_gap=900):
    """Domain-edge, start, end and time-gap flags for cores and anvils."""
    t = dataset.coords["t"]
    for label_name, dim, prefix in [
        ("core_label", "core", "core"),
        ("thick_anvil_label", "anvil", "thick_anvil"),
        ("thin_anvil_label", "anvil", "thin_anvil"),
    ]:
        edge, start, end = find_edge_labels(
            dataset[label_name], dataset.coords[dim], t, start_date, end_date,
            max_time_gap,
        )
        what = prefix.replace("_", " ") + "s"
        _add(
            dataset, f"{prefix}_edge_label_flag", edge, (dim,),
            long_name=f"flag for {what} intersecting the domain edge", dtype=bool,
        )
        _add(
            dataset, f"{prefix}_start_label_flag", start, (dim,),
            long_name=f"flag for {what} intersecting the domain start time", dtype=bool,
        )
        _add(
            dataset, f"{prefix}_end_label_flag", end, (dim,),
            long_name=f"flag for {what} intersecting the domain end time", dtype=bool,
        )


def flag_nan_adjacent_labels(dataset: Dataset, da) -> None:
    """Flag labels within one pixel (3×3×3) of a NaN of ``da``."""
    core = as_tensor(dataset["core_label"])
    nan = torch.isnan(as_tensor(da, core.device))
    flags = {
        "core_nan_flag": np.zeros(dataset.coords["core"].size, bool),
        "thick_anvil_nan_flag": np.zeros(dataset.coords["anvil"].size, bool),
        "thin_anvil_nan_flag": np.zeros(dataset.coords["anvil"].size, bool),
    }
    if bool(nan.any()):
        wh_nan = binary_dilation(nan, structure=np.ones((3, 3, 3)))
        for flag_name, label_name, dim in [
            ("core_nan_flag", "core_label", "core"),
            ("thick_anvil_nan_flag", "thick_anvil_label", "anvil"),
            ("thin_anvil_nan_flag", "thin_anvil_label", "anvil"),
        ]:
            flags[flag_name] = _contains(
                dataset.coords[dim], as_tensor(dataset[label_name])[wh_nan]
            )
    for flag_name, dim, what in [
        ("core_nan_flag", "core", "cores"),
        ("thick_anvil_nan_flag", "anvil", "thick anvils"),
        ("thin_anvil_nan_flag", "anvil", "thin anvils"),
    ]:
        _add(
            dataset, flag_name, flags[flag_name], (dim,),
            long_name=f"flag for {what} intersecting missing values", dtype=bool,
        )


# -- per-object properties ----------------------------------------------------


def _label_times(seg, index, t_coord):
    """First and last time of each label in ``index`` (NaT for a label
    without pixels), from the min and max over its pixels of the frames'
    times."""
    times = np.asarray(getattr(t_coord, "values", t_coord))
    ticks = seg.gather(torch.as_tensor(times.view(np.int64)).view(-1, 1, 1))
    nat = np.iinfo(np.int64).min
    return tuple(
        seg.at(seg.reduce(ticks, how), index, nat).astype(np.int64).view(times.dtype)
        for how in ("amin", "amax")
    )


def _weighted_mean(seg, field, areas, index):
    """Per-label mean of ``field`` weighted by ``areas`` (NaN where the
    weights do not sum to a positive value or the label has no pixel)."""
    w = seg.gather(areas)
    sw = seg.sum(w)
    mean = torch.where(sw > 0, seg.sum(w * seg.gather(field).double()) / sw, torch.nan)
    return seg.at(mean, index, np.nan)


def _object_properties(dataset, label_name, dim, prefix, areas, t_coord):
    seg = LabelSegments(as_tensor(dataset[label_name]))
    index = dataset.coords[dim]
    _add(
        dataset, f"{prefix}_pixel_count", seg.at(seg.counts, index, 0), (dim,),
        long_name=f"total number of pixels for {prefix}", dtype=np.int64,
    )
    total_area = seg.sum(torch.nan_to_num(seg.gather(areas), nan=0.0))
    _add(
        dataset, f"{prefix}_total_area", seg.at(total_area, index, 0.0), (dim,),
        long_name=f"total area of {prefix}", units="km^2", dtype=np.float64,
    )
    start_t, end_t = _label_times(seg, index, t_coord)
    _add(
        dataset, f"{prefix}_start_t", start_t, (dim,),
        long_name=f"initial detection time of {prefix}",
    )
    _add(
        dataset, f"{prefix}_end_t", end_t, (dim,),
        long_name=f"final detection time of {prefix}",
    )
    _add(
        dataset, f"{prefix}_lifetime", end_t - start_t, (dim,),
        long_name=f"total lifetime of {prefix}",
    )


def _step_properties(dataset, step_label_name, step_dim, prefix, areas, t_coord, lat, lon):
    labels = as_tensor(dataset[step_label_name])
    seg = LabelSegments(labels)
    index = dataset.coords[step_dim]
    _add(
        dataset, f"{prefix}_pixel_count", seg.at(seg.counts, index, 0), (step_dim,),
        long_name=f"number of pixels for {prefix}", dtype=np.int64,
    )
    area = seg.sum(torch.nan_to_num(seg.gather(areas), nan=0.0))
    _add(
        dataset, f"{prefix}_area", seg.at(area, index, 0.0), (step_dim,),
        long_name=f"area of {prefix}", units="km^2", dtype=np.float64,
    )
    step_t, _ = _label_times(seg, index, t_coord)
    _add(
        dataset, f"{prefix}_t", step_t, (step_dim,),
        long_name=f"time of {prefix}",
    )
    # positions are the weighted means of the pixels' column and row indices
    _, h, w = labels.shape
    for field, name in [
        (torch.arange(w, device=labels.device), "x"),
        (torch.arange(h, device=labels.device).view(h, 1), "y"),
    ]:
        _add(
            dataset, f"{prefix}_{name}", _weighted_mean(seg, field, areas, index),
            (step_dim,), long_name=f"{name} location of {prefix}", units="",
            dtype=np.float64,
        )
    if lat is not None and lon is not None:
        for field, name in [(lat, "lat"), (lon, "lon")]:
            _add(
                dataset, f"{prefix}_{name}", _weighted_mean(seg, field, areas, index),
                (step_dim,), long_name=f"{name} location of {prefix}", dtype=np.float64,
            )


def _first_step(step_obj, key, objs):
    """For each object of ``objs``, the position of its first step in
    ascending ``key`` order (the first step of those tied), as ``argmax``
    and ``argmin`` pick it; -1 where it has none."""
    if step_obj.size == 0:
        return np.full(objs.size, -1)
    order = np.lexsort((np.arange(step_obj.size), key, step_obj))
    sorted_obj = step_obj[order]
    pos = np.minimum(np.searchsorted(sorted_obj, objs), step_obj.size - 1)
    return np.where(sorted_obj[pos] == objs, order[pos], -1)


def calculate_label_properties(dataset: Dataset) -> None:
    """Pixel counts, areas, times, lifetimes and per-step positions for
    cores and anvils; each object's step of largest area and its start
    position (``core_start_*`` and, for thick anvils, ``anvil_start_*``).
    Areas are the dataset's ``area`` or ones."""
    core = as_tensor(dataset["core_label"])
    dev = core.device
    if "area" in dataset:
        areas = as_tensor(dataset["area"], dev).double()
    else:
        areas = torch.ones((), dtype=torch.float64, device=dev)
    lat = as_tensor(dataset["lat"], dev) if "lat" in dataset else None
    lon = as_tensor(dataset["lon"], dev) if "lon" in dataset else None
    t_coord = dataset.coords["t"]

    for label_name, dim, prefix in [
        ("core_label", "core", "core"),
        ("thick_anvil_label", "anvil", "thick_anvil"),
        ("thin_anvil_label", "anvil", "thin_anvil"),
    ]:
        if dataset.coords[dim].size:
            _object_properties(dataset, label_name, dim, prefix, areas, t_coord)
    for step_name, step_dim, prefix in [
        ("core_step_label", "core_step", "core_step"),
        ("thick_anvil_step_label", "thick_anvil_step", "thick_anvil_step"),
        ("thin_anvil_step_label", "thin_anvil_step", "thin_anvil_step"),
    ]:
        if step_name in dataset and dataset.coords[step_dim].size:
            _step_properties(dataset, step_name, step_dim, prefix, areas, t_coord, lat, lon)

    # max-area step per object (core_max_area, core_max_area_t, ...)
    for prefix, step_prefix, dim, link in [
        ("core", "core_step", "core", "core_step_core_index"),
        ("thick_anvil", "thick_anvil_step", "anvil", "thick_anvil_step_anvil_index"),
        ("thin_anvil", "thin_anvil_step", "anvil", "thin_anvil_step_anvil_index"),
    ]:
        if f"{step_prefix}_area" not in dataset or link not in dataset:
            continue
        step_area = dataset[f"{step_prefix}_area"].values
        step_t = dataset[f"{step_prefix}_t"].values
        step_obj = dataset[link].values.astype(np.int64)
        objs = dataset.coords[dim].astype(np.int64)
        j = _first_step(step_obj, -step_area, objs)
        _add(
            dataset, f"{prefix}_max_area", np.where(j >= 0, step_area[j], 0.0), (dim,),
            long_name=f"maximum area of {prefix}", units="km^2", dtype=np.float64,
        )
        _add(
            dataset, f"{prefix}_max_area_t",
            np.where(j >= 0, step_t[j], np.datetime64("NaT")).astype(step_t.dtype), (dim,),
            long_name=f"time of maximum area of {prefix}",
        )
        # start positions: location of the earliest step of each object
        if prefix == "thin_anvil":  # the reference has core_start_* and anvil_start_*
            continue
        start_prefix = "anvil" if prefix == "thick_anvil" else prefix
        pos_names = ["x", "y"] + (["lat", "lon"] if f"{step_prefix}_lat" in dataset else [])
        j = _first_step(step_obj, step_t.view(np.int64), objs)
        for pos in pos_names:
            step_pos = dataset[f"{step_prefix}_{pos}"].values
            _add(
                dataset, f"{start_prefix}_start_{pos}",
                np.where(j >= 0, step_pos[j], np.nan), (dim,),
                long_name=f"initial {pos} location of {start_prefix}", dtype=np.float64,
            )
