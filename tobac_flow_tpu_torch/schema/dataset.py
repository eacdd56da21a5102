"""Output-dataset schema: label coordinates, linking indices, flags and
per-object properties (counterpart of the parts of
``tobac_flow_tpu/schema/dataset.py`` that ``run_detection`` and the GOES
ingest call, with its names, dims, dtypes and attrs).

The label volumes and fields stay where the dataset holds them (tensors
on the card, or numpy on the CPU); every per-label quantity is a
reduction over them on that device (``utils.labels.LabelSegments``,
``utils.stats.find_overlap_mode``), and only the per-label vectors come
back to the host, where the coordinates and the small per-object tables
are numpy.  Each pass over a volume runs in time chunks where the volume
calls for them (``budget_bytes``; ``None`` means ``device.memory_budget``,
no chunks on the CPU): per-label counts, sums, minima and maxima
accumulate across the chunks, numberings carry on from chunk to chunk,
and the NaN flags read one halo frame each side.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.data.abi import get_abi_lat_lon, get_abi_pixel_area
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, as_tensor
from tobac_flow_tpu_torch.device import (
    NAN_FLAG_BYTES_PER_PX, OUTPUT_BYTES_PER_PX, chunk_plan, time_chunks,
)
from tobac_flow_tpu_torch.ops.morphology import binary_dilation
from tobac_flow_tpu_torch.utils.datetime_utils import get_datetime_from_coord
from tobac_flow_tpu_torch.utils.labels import (
    SegmentChunks, remap_table, slice_labels, unique_labels,
)
from tobac_flow_tpu_torch.utils.stats import find_overlap_mode

__all__ = [
    "create_new_goes_ds",
    "add_step_labels",
    "add_label_coords",
    "link_cores_and_anvils",
    "link_step_labels",
    "find_edge_labels",
    "flag_edge_labels",
    "flag_nan_adjacent_labels",
    "calculate_label_properties",
    "get_bulk_stats",
    "get_spatial_stats",
    "get_temporal_stats",
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


# -- bulk, spatial and temporal statistics of a field -------------------------


def _reduce(x, stat, skip_nan=True):
    """``stat`` ("mean", "std", "median", "max" or "min") of a tensor over
    its last axis, in float64, as numpy's ``nan*`` functions give it
    (``skip_nan``; std with ddof 0) or, for the median alone, as
    ``np.median``, NaN wherever a NaN is among the values.  The median
    sorts (NaN last) and averages the two middle values."""
    n = x.shape[-1]
    nan = torch.isnan(x) if x.is_floating_point() else torch.zeros_like(x, dtype=torch.bool)
    k = (~nan).sum(-1)
    x64 = x.double()
    if stat in ("mean", "std"):
        mean = torch.where(nan, 0.0, x64).sum(-1) / k
        if stat == "mean":
            return mean
        dev = torch.where(nan, 0.0, (x64 - mean.unsqueeze(-1)) ** 2)
        return torch.sqrt(dev.sum(-1) / k)
    if stat in ("max", "min"):
        fill = -torch.inf if stat == "max" else torch.inf
        kept = torch.where(nan, fill, x64)
        out = kept.amax(-1) if stat == "max" else kept.amin(-1)
        return torch.where(k > 0, out, torch.nan)
    ordered = torch.sort(x64, dim=-1).values
    count = k if skip_nan else torch.full_like(k, n)
    lo = ((count - 1) // 2).clamp(min=0).unsqueeze(-1)
    hi = (count // 2).clamp(max=max(n - 1, 0)).unsqueeze(-1)
    median = (ordered.gather(-1, lo) + ordered.gather(-1, hi)).squeeze(-1) / 2
    empty = count == 0 if skip_nan else nan.any(-1) | (count == 0)
    return torch.where(empty, torch.nan, median)


def _stat_block(ds, da, values, dims, suffix_fmt, skip_nan_median):
    """The five statistics of ``values`` (``da``'s data, its reduced axes
    last) added to ``ds`` in ``da``'s dtype, where ``da`` lies."""
    long_name = da.attrs.get("long_name", da.name)
    units = da.attrs.get("units", "")
    for stat in ("mean", "std", "median", "max", "min"):
        out = _reduce(values, stat, skip_nan_median or stat != "median")
        _add(
            ds, suffix_fmt.format(name=da.name, stat=stat), out.to(values.dtype), dims,
            long_name=f"{stat} of {long_name}", units=units,
        )


def get_bulk_stats(ds, da):
    """Mean, std, median (``np.median``: NaN where a value is NaN), max and
    min of the whole field."""
    _stat_block(ds, da, as_tensor(da).reshape(-1), (), "{name}_{stat}", False)


def get_spatial_stats(ds, da):
    """The NaN-skipping statistics of each frame, over (y, x)."""
    x = as_tensor(da)
    _stat_block(ds, da, x.reshape(x.shape[0], -1), ("t",), "{name}_spatial_{stat}", True)


def get_temporal_stats(ds, da):
    """The NaN-skipping statistics of each pixel, over t."""
    _stat_block(ds, da, torch.movedim(as_tensor(da), 0, -1), ("y", "x"),
                "{name}_temporal_{stat}", True)


def create_new_goes_ds(goes_ds):
    """A fresh output dataset carrying the source grid's coords, projection
    and the float32 lat, lon and pixel area (km²) derived from it."""
    new_ds = Dataset(
        coords={
            k: goes_ds.coords[k]
            for k in ("t", "y", "x", "y_image", "x_image")
            if k in goes_ds.coords
        }
    )
    if "goes_imager_projection" in goes_ds:
        new_ds["goes_imager_projection"] = goes_ds["goes_imager_projection"]
        lat, lon = get_abi_lat_lon(new_ds)
        _add(new_ds, "lat", lat, ("y", "x"), long_name="latitude", dtype=np.float32)
        _add(new_ds, "lon", lon, ("y", "x"), long_name="longitude", dtype=np.float32)
        _add(
            new_ds, "area", get_abi_pixel_area(new_ds), ("y", "x"),
            long_name="pixel area", units="km^2", dtype=np.float32,
        )
    return new_ds


# -- step labels / label coords ----------------------------------------------


def add_step_labels(dataset: Dataset, budget_bytes=None) -> None:
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
            slice_labels(as_tensor(dataset[src]), budget_bytes).to(torch.int32),
            ("t", "y", "x"),
            long_name=long_name,
        )


def add_label_coords(dataset: Dataset, budget_bytes=None) -> Dataset:
    """Add the label values present as coordinates (int32)."""

    def uniq(*names):
        vals = [unique_labels(as_tensor(dataset[n]), budget_bytes) for n in names
                if n in dataset]
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
    dataset: Dataset, atol: int = 5, add_cores_to_anvils: bool = True, budget_bytes=None
) -> None:
    """Each core's anvil: the thick anvil covering most of its pixels (the
    smallest label of those tied), where that is at least ``atol`` pixels,
    else 0.  With ``add_cores_to_anvils`` each linked core's pixels take
    its anvil's label in both anvil volumes, in place."""
    cores = dataset.coords["core"]
    core_label = as_tensor(dataset["core_label"])
    core_anvil_index = find_overlap_mode(
        core_label, as_tensor(dataset["thick_anvil_label"]), cores, min_count=atol,
        budget_bytes=budget_bytes,
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
        lut = remap_table(core_label, locations=cores, new_labels=core_anvil_index)
        anvils = [as_tensor(dataset[name]) for name in ("thick_anvil_label", "thin_anvil_label")]
        chunk = chunk_plan("link_cores_and_anvils", core_label.shape, OUTPUT_BYTES_PER_PX,
                           core_label.device, budget_bytes)
        for s, e, _, _ in time_chunks(core_label.shape[0], chunk):
            remapped = lut[core_label[s:e].long()]
            wh = remapped != 0
            for anvil in anvils:
                anvil[s:e][wh.to(anvil.device)] = remapped[wh].to(anvil.device, anvil.dtype)
            del remapped, wh

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


def link_step_labels(dataset: Dataset, budget_bytes=None) -> None:
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
            dataset.coords[step_dim], budget_bytes=budget_bytes,
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


def flag_nan_adjacent_labels(dataset: Dataset, da, budget_bytes=None) -> None:
    """Flag labels within one pixel (3×3×3) of a NaN of ``da`` (a chunk of
    frames at a time, each read with a halo frame each side)."""
    core = as_tensor(dataset["core_label"])
    field = as_tensor(da)
    names = [("core_nan_flag", "core_label", "core"),
             ("thick_anvil_nan_flag", "thick_anvil_label", "anvil"),
             ("thin_anvil_nan_flag", "thin_anvil_label", "anvil")]
    volumes = [as_tensor(dataset[label_name]) for _, label_name, _ in names]
    found = [[] for _ in names]
    chunk = chunk_plan("flag_nan_adjacent_labels", core.shape, NAN_FLAG_BYTES_PER_PX,
                       core.device, budget_bytes, 1)
    for s, e, lo, hi in time_chunks(core.shape[0], chunk, 1):
        nan = torch.isnan(field[lo:hi].to(core.device))
        if not bool(nan.any()):
            continue
        wh_nan = binary_dilation(nan, structure=np.ones((3, 3, 3)))[s - lo:e - lo]
        for hits, vol in zip(found, volumes):
            hits.append(unique_labels(vol[s:e].to(core.device)[wh_nan]))
        del nan, wh_nan
    for (flag_name, _, dim), hits in zip(names, found):
        values = dataset.coords[dim]
        flags = np.isin(values, np.concatenate(hits)) if hits else np.zeros(values.size, bool)
        what = {"core_nan_flag": "cores", "thick_anvil_nan_flag": "thick anvils",
                "thin_anvil_nan_flag": "thin anvils"}[flag_name]
        _add(
            dataset, flag_name, flags, (dim,),
            long_name=f"flag for {what} intersecting missing values", dtype=bool,
        )


# -- per-object properties ----------------------------------------------------


def _accumulate(segs, fn):
    """The per-label results of ``fn(s, e, seg)`` (a tuple of bins per
    label, each with how it folds: "sum", "amin" or "amax") folded over
    the chunks of ``segs``."""
    folds = {"sum": torch.add, "amin": torch.minimum, "amax": torch.maximum}
    total = None
    for s, e, seg in segs:
        parts = fn(s, e, seg)
        total = ([p for p, _ in parts] if total is None
                 else [folds[how](t, p) for t, (p, how) in zip(total, parts)])
    return total


def _label_times(segs, index, t_coord):
    """First and last time of each label in ``index`` (NaT for a label
    without pixels), from the min and max over its pixels of the frames'
    times."""
    times = np.asarray(getattr(t_coord, "values", t_coord))
    ticks = torch.as_tensor(times.view(np.int64)).view(-1, 1, 1)
    nat = np.iinfo(np.int64).min

    def per_chunk(s, e, seg):
        tick = seg.gather(segs.take(ticks, s, e))
        return ((seg.reduce(tick, "amin", empty=np.iinfo(np.int64).max), "amin"),
                (seg.reduce(tick, "amax", empty=nat), "amax"))

    first, last = _accumulate(segs, per_chunk)
    return tuple(segs.at(v, index, nat).astype(np.int64).view(times.dtype)
                 for v in (first, last))


def _area_sums(segs, areas, fields=()):
    """Per-label sums of the pixel areas and of the areas times each of
    ``fields``, in float64."""
    def per_chunk(s, e, seg):
        w = seg.gather(segs.take(areas, s, e))
        out = [(seg.sum(torch.nan_to_num(w, nan=0.0)), "sum")]
        for field in fields:
            out.append((seg.sum(w * seg.gather(segs.take(field, s, e)).double()), "sum"))
            out.append((seg.sum(w), "sum"))
        return out

    return _accumulate(segs, per_chunk)


def _weighted_means(segs, areas, fields, index):
    """Per-label means of ``fields`` weighted by ``areas`` (NaN where the
    weights do not sum to a positive value or the label has no pixel)."""
    sums = _area_sums(segs, areas, fields)[1:]
    return [segs.at(torch.where(sw > 0, swf / sw, torch.nan), index, np.nan)
            for swf, sw in zip(sums[::2], sums[1::2])]


def _object_properties(dataset, label_name, dim, prefix, areas, t_coord, budget_bytes):
    segs = SegmentChunks(as_tensor(dataset[label_name]), "label_properties", budget_bytes)
    index = dataset.coords[dim]
    _add(
        dataset, f"{prefix}_pixel_count", segs.at(segs.counts, index, 0), (dim,),
        long_name=f"total number of pixels for {prefix}", dtype=np.int64,
    )
    total_area = _area_sums(segs, areas)[0]
    _add(
        dataset, f"{prefix}_total_area", segs.at(total_area, index, 0.0), (dim,),
        long_name=f"total area of {prefix}", units="km^2", dtype=np.float64,
    )
    start_t, end_t = _label_times(segs, index, t_coord)
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


def _step_properties(dataset, step_label_name, step_dim, prefix, areas, t_coord, lat, lon,
                     budget_bytes):
    labels = as_tensor(dataset[step_label_name])
    segs = SegmentChunks(labels, "label_properties", budget_bytes)
    index = dataset.coords[step_dim]
    _add(
        dataset, f"{prefix}_pixel_count", segs.at(segs.counts, index, 0), (step_dim,),
        long_name=f"number of pixels for {prefix}", dtype=np.int64,
    )
    area = _area_sums(segs, areas)[0]
    _add(
        dataset, f"{prefix}_area", segs.at(area, index, 0.0), (step_dim,),
        long_name=f"area of {prefix}", units="km^2", dtype=np.float64,
    )
    step_t, _ = _label_times(segs, index, t_coord)
    _add(
        dataset, f"{prefix}_t", step_t, (step_dim,),
        long_name=f"time of {prefix}",
    )
    # positions are the weighted means of the pixels' column and row indices
    _, h, w = labels.shape
    fields = [(torch.arange(w, device=segs.device), "x"),
              (torch.arange(h, device=segs.device).view(h, 1), "y")]
    if lat is not None and lon is not None:
        fields += [(lat, "lat"), (lon, "lon")]
    means = _weighted_means(segs, areas, [f for f, _ in fields], index)
    for mean, (_, name) in zip(means, fields):
        _add(
            dataset, f"{prefix}_{name}", mean, (step_dim,),
            long_name=f"{name} location of {prefix}", dtype=np.float64,
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


def calculate_label_properties(dataset: Dataset, budget_bytes=None) -> None:
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
            _object_properties(dataset, label_name, dim, prefix, areas, t_coord, budget_bytes)
    for step_name, step_dim, prefix in [
        ("core_step_label", "core_step", "core_step"),
        ("thick_anvil_step_label", "thick_anvil_step", "thick_anvil_step"),
        ("thin_anvil_step_label", "thin_anvil_step", "thin_anvil_step"),
    ]:
        if step_name in dataset and dataset.coords[step_dim].size:
            _step_properties(dataset, step_name, step_dim, prefix, areas, t_coord, lat, lon,
                             budget_bytes)

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
