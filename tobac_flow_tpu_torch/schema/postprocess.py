"""Per-object statistics and validity flags (counterpart of
``tobac_flow_tpu/schema/postprocess.py``, with its names, dims, dtypes
and values): cloud radiative effects, weighted per-label statistics with
uncertainties and weighted flag proportions, start, end and average
positions, areas and rates per core and anvil, and the validity flags.

The per-pixel statistics (``weighted_label_stats``, the proportions) run
on the label volume's device, in time chunks where the volume calls for
them (``budget_bytes``; ``None`` means ``device.memory_budget``, no chunks
on the CPU): float64 segment sums over ``utils.labels.SegmentChunks``, the
std in a second pass about the mean, and each label's first minimum and
maximum in raster order kept across the chunks.  The weights may be (H, W)
or (T, H, W); (H, W) weights broadcast over each chunk without a copy per
frame.  The per-object aggregates reduce the step tables on ``device``
(CUDA unless the caller asks for the CPU) through the segment operations
of ``utils.stats``.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.data.ncdataset import DataArray, as_tensor
from tobac_flow_tpu_torch.device import POSTPROCESS_BYTES_PER_PX, resolve_device
from tobac_flow_tpu_torch.utils.geo import get_mean_object_azimuth_and_speed
from tobac_flow_tpu_torch.utils.labels import SegmentChunks, _bins_at, apply_func_to_labels
from tobac_flow_tpu_torch.utils.stats import (
    Groups,
    argmax_groupby,
    argmin_groupby,
    combined_mean_groupby,
    combined_std_groupby,
    cooling_rate_groupby,
    counts_groupby,
    growth_rate_groupby,
    idxmax_cooling_rate_groupby,
    idxmax_growth_rate_groupby,
    idxmax_groupby,
    idxmin_groupby,
    weighted_average_groupby,
    weighted_average_uncertainty_groupby,
)

__all__ = [
    "get_cre",
    "add_cre_to_dataset",
    "weighted_label_stats",
    "add_weighted_stats_to_dataset",
    "get_weighted_proportions_da",
    "add_weighted_proportions_to_dataset",
    "process_core_properties",
    "process_thick_anvil_properties",
    "process_thin_anvil_properties",
    "add_validity_flags",
]


def _v(a):
    a = getattr(a, "values", a)
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _da(values, dim, name, attrs=None):
    return DataArray(np.asarray(values), dims=(dim,), name=name, attrs=attrs or {})


def _lookup(values_by_key, keys, query, default=np.nan):
    """Values at the positions of ``query`` within ``keys`` (xarray's
    ``.loc``).  As the reference's, ``default`` replaces a missing key's
    value only where the values are floats: a missing key among times
    takes the value at its clipped sorted position."""
    keys = np.asarray(keys)
    query = np.asarray(query)
    order = np.argsort(keys)
    pos = np.searchsorted(keys, query, sorter=order)
    pos = np.clip(pos, 0, keys.size - 1)
    found = keys[order[pos]] == query
    vals = np.asarray(values_by_key)[order[pos]]
    if np.issubdtype(vals.dtype, np.floating):
        vals = np.where(found, vals, default)
    return vals


# -- cloud radiative effect ---------------------------------------------------


def get_cre(flux, clear_flux):
    """CRE = all-sky minus clear-sky flux (where the fluxes lie)."""
    cre = flux - clear_flux
    cre.attrs = dict(flux.attrs)
    cre.attrs["long_name"] = cre.attrs.get("long_name", flux.name) + " cloud radiative effect"
    if "standard_name" in cre.attrs:
        cre.attrs["standard_name"] += "_cloud_radiative_effect"
    if "valid_max" in cre.attrs:
        cre.attrs["valid_min"] = -cre.attrs["valid_max"]
    cre.name = f"{flux.name}_cre"
    return cre


def add_cre_to_dataset(dataset):
    for var in ("toa_swup", "toa_lwup", "boa_swdn", "boa_swup", "boa_lwdn", "boa_lwup"):
        dataset[f"{var}_cre"] = get_cre(dataset[var], dataset[f"{var}_clr"])

    def flux_attrs(long_name, standard_name):
        return {"long_name": long_name, "standard_name": standard_name, "units": "W m-2",
                "valid_min": -1500.0, "valid_max": 1500.0}

    toa_net = dataset["toa_swdn"] - (dataset["toa_swup"] + dataset["toa_lwup"])
    toa_net.attrs = flux_attrs("top of atmosphere net radiation", "toa_net_flux")
    dataset["toa_net"] = toa_net
    toa_net_cre = -(dataset["toa_swup_cre"] + dataset["toa_lwup_cre"])
    toa_net_cre.attrs = flux_attrs(
        "top of atmosphere net cloud radiative effect", "toa_net_cloud_radiative_effect",
    )
    dataset["toa_net_cre"] = toa_net_cre
    boa_net = (
        dataset["boa_swdn"] + dataset["boa_lwdn"]
        - (dataset["boa_swup"] + dataset["boa_lwup"])
    )
    boa_net.attrs = flux_attrs("bottom of atmosphere net radiation", "boa_net_flux")
    dataset["boa_net"] = boa_net
    boa_net_cre = (
        dataset["boa_swdn_cre"] + dataset["boa_lwdn_cre"]
        - (dataset["boa_swup_cre"] + dataset["boa_lwup_cre"])
    )
    boa_net_cre.attrs = flux_attrs(
        "bottom of atmosphere net cloud radiative effect", "boa_net_cloud_radiative_effect",
    )
    dataset["boa_net_cre"] = boa_net_cre
    return dataset


# -- weighted per-label statistics -------------------------------------------


def _extreme_errors(seg, x, e, keep, how, fill):
    """Per label of ``seg``: ``how`` ("amin", "amax") of ``x`` over the
    pixels ``keep`` flags and the error ``e`` at the first such pixel in
    raster order."""
    best = seg.reduce(x, how, keep, empty=fill)
    at = keep & (x == best[seg.bins])
    pos = torch.arange(x.numel(), device=x.device)
    first = seg.reduce(pos, "amin", at, empty=x.numel())
    err = e[first.clamp(max=max(x.numel() - 1, 0))] if x.numel() else torch.full_like(best,
                                                                                   torch.nan)
    return best, err


def _merge_extreme(cur, new, how):
    """Fold a later chunk's (extremum, error) per label into the earlier
    chunks': a strictly better extremum wins, a tie keeps the earlier
    pixel."""
    if cur is None:
        return new
    better = new[0] < cur[0] if how == "amin" else new[0] > cur[0]
    return (torch.where(better, new[0], cur[0]), torch.where(better, new[1], cur[1]))


def _label_stats(labels, field, weights, errors, budget_bytes):
    """Per label 1..n of ``labels`` (a tensor, where the pass runs): the
    weighted statistics of ``field``'s finite values, as the reference's
    ``weighted_stats`` (and, with ``errors``, ``weighted_uncertainties``)
    give them: float64 tensors over bins 0..n, and whether each label has a
    finite value; None for an empty volume."""
    segs = SegmentChunks(labels, "weighted_label_stats", budget_bytes,
                         bytes_per_px=POSTPROCESS_BYTES_PER_PX)

    def pixels(s, e, seg):
        x = seg.gather(segs.take(field, s, e)).double()
        w = seg.gather(segs.take(weights, s, e)).double()
        return x, w, torch.isfinite(x)

    sums = lo = hi = None
    for s, e, seg in segs:
        x, w, fin = pixels(s, e, seg)
        err = seg.gather(segs.take(errors, s, e)).double() if errors is not None else x
        parts = [seg.sum(fin, fin, torch.int64), seg.sum(w, fin), seg.sum(w * x, fin),
                 seg.sum(w * w, fin), seg.sum((w * w) * (err * err), fin)]
        sums = parts if sums is None else [a + b for a, b in zip(sums, parts)]
        lo = _merge_extreme(lo, _extreme_errors(seg, x, err, fin, "amin", torch.inf), "amin")
        hi = _merge_extreme(hi, _extreme_errors(seg, x, err, fin, "amax", -torch.inf), "amax")
        del x, w, fin, err
    if sums is None:
        return None
    n, sw, swx, sww, swwee = sums
    valid = (n > 0) & (sw > 0)
    mean = swx / sw
    ss = None
    for s, e, seg in segs:
        x, w, fin = pixels(s, e, seg)
        dev = x - mean[seg.bins]
        part = seg.sum(w * (dev * dev), fin)
        ss = part if ss is None else ss + part
        del x, w, fin
    correction = 1 - sww / (sw * sw)
    std = torch.where(correction > 0, torch.sqrt(ss / sw / correction), torch.nan)
    nan = torch.tensor(torch.nan, dtype=torch.float64, device=mean.device)
    out = [torch.where(valid, v, nan) for v in (mean, std, lo[0], hi[0])]
    if errors is not None:
        uncertainty = torch.sqrt(swwee) / sw
        spread = std / torch.sqrt(n.double())
        combined = torch.sqrt(spread * spread + uncertainty * uncertainty)
        out += [torch.where(valid, v, nan) for v in (uncertainty, combined, lo[1], hi[1])]
    return out, (n > 0).cpu().numpy()


def weighted_label_stats(
    labels, weights, dataset, var, coord, dim, dim_name=None, attrs=None,
    uncertainty=False, budget_bytes=None,
):
    """Weighted mean, unbiased std, min and max (with ``uncertainty``, also
    the mean's uncertainty, its combined error and the errors at the first
    minimum and maximum) of ``dataset[var]`` per label of ``coord``, over
    each label's finite values (min and max whatever their weight), NaN
    where none is left or the weights do not sum to a positive value:
    float64 DataArrays named ``{dim_name}_{var}_{stat}``.  On the labels'
    device (``weights`` (H, W) or (T, H, W))."""
    if dim_name is None:
        dim_name = dim
    index = np.asarray(getattr(coord, "values", coord))
    names = ["mean", "std", "min", "max"]
    if uncertainty:
        names += ["mean_uncertainty", "mean_combined_error", "min_error", "max_error"]
    errors = as_tensor(dataset[f"{var}_uncertainty"]) if uncertainty else None
    found = _label_stats(as_tensor(labels), as_tensor(dataset[var]), as_tensor(weights),
                         errors, budget_bytes)
    # a label without a finite value (or without pixels) is NaN throughout
    return tuple(
        _da(_bins_at(found[1], found[0][i], index, np.nan) if found is not None
            else np.full(index.size, np.nan), dim, f"{dim_name}_{var}_{stat}")
        for i, stat in enumerate(names)
    )


def add_weighted_stats_to_dataset(
    dcc_dataset, field_dataset, weights, var, dim, dim_name=None, index=None,
    labels=None, budget_bytes=None,
):
    if dim_name is None:
        dim_name = dim
    if index is None:
        index = dcc_dataset.coords[dim]
    if labels is None:
        labels = dcc_dataset[f"{dim_name}_label"]
    stats = weighted_label_stats(
        labels, weights, field_dataset, var, index, dim, dim_name=dim_name,
        uncertainty=(f"{var}_uncertainty" in field_dataset.data_vars),
        budget_bytes=budget_bytes,
    )
    for da in stats:
        dcc_dataset[da.name] = da
    return dcc_dataset


def get_weighted_proportions_da(flag_da, weights, labels, dim, dim_name=None, index=None,
                                budget_bytes=None):
    """Per label, the share of its weights (NaN-summed over all of its
    pixels) at each of ``flag_da``'s ``flag_values``, NaN without a
    positive weight sum; on the labels' device, a chunk of frames at a
    time."""
    if dim_name is None:
        dim_name = dim
    lab = as_tensor(labels)
    if index is None:
        index = np.arange(1, int(lab.max()) + 1)
    index = np.asarray(getattr(index, "values", index))
    flag_values = np.asarray(
        [int(n) for n in str(flag_da.attrs["flag_values"]).replace("b", "").split()]
    )
    flags, w_all = as_tensor(flag_da), as_tensor(weights)
    segs = SegmentChunks(lab, "weighted_proportions", budget_bytes,
                         bytes_per_px=POSTPROCESS_BYTES_PER_PX)
    total = hits = None
    for s, e, seg in segs:
        data = seg.gather(segs.take(flags, s, e))
        w = seg.gather(segs.take(w_all, s, e)).double()
        w = torch.where(torch.isnan(w), 0.0, w)
        parts = [seg.sum(w)] + [seg.sum(torch.where(data == f, w, 0.0)) for f in flag_values]
        total = parts[0] if total is None else total + parts[0]
        hits = parts[1:] if hits is None else [a + b for a, b in zip(hits, parts[1:])]
        del data, w
    if index.size == 0:
        proportions = np.empty(0)
    elif total is None:
        proportions = np.full((flag_values.size, index.size), np.nan).squeeze()
    else:
        every = np.ones(total.numel(), dtype=bool)  # a label without pixels has no weight
        proportions = np.stack([_bins_at(every, torch.where(total > 0, h / total, torch.nan),
                                         index, np.nan) for h in hits]).squeeze()
    proportions = np.atleast_2d(np.asarray(proportions, dtype=float))
    out = DataArray(
        proportions.T,
        dims=(dim, flag_da.name),
        name=f"{dim_name}_{flag_da.name}_proportion",
    )
    out.coords[dim] = index
    out.coords[flag_da.name] = flag_values
    return out


def add_weighted_proportions_to_dataset(
    dcc_dataset, flag_da, weights, dim, dim_name=None, index=None, labels=None,
    budget_bytes=None,
):
    if dim_name is None:
        dim_name = dim
    if index is None:
        index = dcc_dataset.coords[dim]
    if labels is None:
        labels = dcc_dataset[f"{dim_name}_label"]
    da = get_weighted_proportions_da(
        flag_da, weights, labels, dim, dim_name=dim_name, index=index,
        budget_bytes=budget_bytes,
    )
    dcc_dataset[da.name] = da
    return dcc_dataset


# -- per-object property aggregation ------------------------------------------


def _process_object(
    dataset, dim, obj_prefix, step_prefix, link_name, time_steps=3,
    propagation_prefix=None, device=None,
):
    """Start, end and average positions, areas and rate statistics for one
    object family, and each per-step statistic aggregated to its objects
    (the common core of ``process_{core,thick_anvil,thin_anvil}_properties``;
    ``propagation_prefix`` names the propagation direction and speed
    variables, None skips them)."""
    dev = resolve_device(device)
    objs = dataset.coords[dim]
    groups = _v(dataset[link_name])
    step_vals = dataset.coords[f"{step_prefix}"]
    step_t = _v(dataset[f"{step_prefix}_t"])
    step_area = _v(dataset[f"{step_prefix}_area"])
    grp = Groups(groups, objs, dev)

    has_latlon = f"{step_prefix}_lat" in dataset
    pos_names = ["x", "y"] + (["lat", "lon"] if has_latlon else [])

    start_step = argmin_groupby(step_vals, step_t, grp)
    end_step = argmax_groupby(step_vals, step_t, grp)
    dataset[f"{obj_prefix}_initial_{step_prefix}_index"] = _da(
        start_step, dim, f"{obj_prefix}_initial_{step_prefix}_index"
    )
    for pos in pos_names + ["t"]:
        vals = _v(dataset[f"{step_prefix}_{pos}"])
        dataset[f"{obj_prefix}_start_{pos}"] = _da(
            _lookup(vals, step_vals, start_step), dim, f"{obj_prefix}_start_{pos}"
        )
        dataset[f"{obj_prefix}_end_{pos}"] = _da(
            _lookup(vals, step_vals, end_step), dim, f"{obj_prefix}_end_{pos}"
        )
    dataset[f"{obj_prefix}_lifetime"] = _da(
        _v(dataset[f"{obj_prefix}_end_t"]) - _v(dataset[f"{obj_prefix}_start_t"]),
        dim,
        f"{obj_prefix}_lifetime",
    )

    for pos in pos_names:
        dataset[f"{obj_prefix}_average_{pos}"] = _da(
            weighted_average_groupby(_v(dataset[f"{step_prefix}_{pos}"]), step_area, grp),
            dim,
            f"{obj_prefix}_average_{pos}",
        )
    area = grp.values(step_area).double()
    total = grp.sum(area)
    dataset[f"{obj_prefix}_average_area"] = _da(
        grp.out(total / grp.size, np.float64), dim, f"{obj_prefix}_average_area",
    )
    dataset[f"{obj_prefix}_total_area"] = _da(
        grp.out(total, np.float64), dim, f"{obj_prefix}_total_area",
    )
    dataset[f"{obj_prefix}_max_area"] = _da(
        grp.out(grp.extreme(area, "amax"), step_area), dim, f"{obj_prefix}_max_area",
    )
    dataset[f"{obj_prefix}_max_area_t"] = _da(
        argmax_groupby(step_t, step_area, grp), dim, f"{obj_prefix}_max_area_t",
    )
    dataset[f"{obj_prefix}_max_area_{step_prefix}_index"] = _da(
        argmax_groupby(step_vals, step_area, grp), dim,
        f"{obj_prefix}_max_area_{step_prefix}_index",
    )

    # per-field extrema and (cores only) rates: bt, ctt and ctt_corrected
    # take their minimum and cooling rates, cth and cth_corrected their
    # maximum and growth rates
    rates = obj_prefix == "core"
    for field, kind in (
        ("bt", "min"),
        ("ctt", "min"),
        ("ctt_corrected", "min"),
        ("cth", "max"),
        ("cth_corrected", "max"),
    ):
        var = f"{step_prefix}_{field}_mean"
        if var not in dataset:
            continue
        vals = _v(dataset[var])
        pick_t = argmin_groupby if kind == "min" else argmax_groupby
        pick_i = idxmin_groupby if kind == "min" else idxmax_groupby
        dataset[f"{obj_prefix}_{kind}_{field}_t"] = _da(
            pick_t(step_t, vals, grp), dim, f"{obj_prefix}_{kind}_{field}_t",
        )
        dataset[f"{obj_prefix}_{kind}_{field}_{step_prefix}_index"] = _da(
            pick_i(vals, np.asarray(step_vals), grp), dim,
            f"{obj_prefix}_{kind}_{field}_{step_prefix}_index",
        )
        if not rates:
            continue
        if field == "bt":
            rate_name = f"{obj_prefix}_max_cooling_rate"
        elif kind == "min":
            rate_name = f"{obj_prefix}_{field}_cooling_rate"
        else:
            rate_name = f"{obj_prefix}_{field}_growth_rate"
        rate_fn = cooling_rate_groupby if kind == "min" else growth_rate_groupby
        idx_fn = (
            idxmax_cooling_rate_groupby if kind == "min" else idxmax_growth_rate_groupby
        )
        dataset[rate_name] = _da(rate_fn(vals, step_t, grp), dim, rate_name)
        dataset[f"{rate_name}_{step_prefix}_index"] = _da(
            idx_fn(vals, step_t, np.asarray(step_vals), grp), dim,
            f"{rate_name}_{step_prefix}_index",
        )

    if has_latlon and propagation_prefix is not None:
        azi_speed = apply_func_to_labels(
            groups,
            _v(dataset[f"{step_prefix}_lon"]),
            _v(dataset[f"{step_prefix}_lat"]),
            step_t,
            func=get_mean_object_azimuth_and_speed,
            index=objs,
            default=[np.nan, np.nan],
        )
        azi_speed = np.asarray(azi_speed, dtype=float)
        if azi_speed.ndim == 1:
            azi_speed = azi_speed.reshape(2, -1)
        dataset[f"{propagation_prefix}_propagation_direction"] = _da(
            azi_speed[0], dim, f"{propagation_prefix}_propagation_direction"
        )
        dataset[f"{propagation_prefix}_propagation_speed"] = _da(
            azi_speed[1], dim, f"{propagation_prefix}_propagation_speed"
        )

    # aggregate any per-step statistics up to the object level
    strip = len(step_prefix) + 1
    for var in list(dataset.data_vars):
        if dataset[var].dims != (step_prefix,):
            continue
        new_var = f"{obj_prefix}_{var[strip:]}"
        vals = _v(dataset[var])
        if var.endswith("_mean") and not var.endswith("_area_mean"):
            dataset[new_var] = _da(combined_mean_groupby(vals, step_area, grp), dim, new_var)
        elif var.endswith("_std"):
            mean_var = var[:-3] + "mean"
            if mean_var in dataset:
                dataset[new_var] = _da(
                    combined_std_groupby(vals, _v(dataset[mean_var]), step_area, grp),
                    dim, new_var,
                )
        elif var.endswith("_min") and new_var not in dataset:
            x = grp.values(vals)
            dataset[new_var] = _da(grp.out(grp.extreme(x, "amin"), vals), dim, new_var)
        elif var.endswith("_max") and new_var not in dataset:
            x = grp.values(vals)
            dataset[new_var] = _da(grp.out(grp.extreme(x, "amax"), vals), dim, new_var)
        elif var.endswith("_mean_uncertainty"):
            dataset[new_var] = _da(
                weighted_average_uncertainty_groupby(vals, step_area, grp), dim, new_var,
            )
    return dataset


def process_core_properties(dataset, time_steps=3, device=None):
    return _process_object(
        dataset, "core", "core", "core_step", "core_step_core_index", time_steps,
        propagation_prefix="core", device=device,
    )


def process_thick_anvil_properties(dataset, device=None):
    return _process_object(
        dataset, "anvil", "thick_anvil", "thick_anvil_step",
        "thick_anvil_step_anvil_index", propagation_prefix="anvil", device=device,
    )


def process_thin_anvil_properties(dataset, device=None):
    """As the reference, without propagation variables."""
    return _process_object(
        dataset, "anvil", "thin_anvil", "thin_anvil_step",
        "thin_anvil_step_anvil_index", device=device,
    )


# -- validity flags -----------------------------------------------------------


def add_validity_flags(dataset, device=None):
    """``core_has_anvil_flag``, ``core_anvil_removed``, ``anvil_core_count``,
    ``anvil_initial_core_index``, ``anvil_no_growth_flag``,
    ``anvil_no_initial_core_flag``, ``anvil_invalid_core_flag`` and the
    ``*_is_valid`` flags; ``core_anvil_index`` is zeroed in place for cores
    whose anvil is gone.  An anvil without a surviving core takes initial
    core 0, whose end and start times are, as in the reference, those of
    the smallest core (``_lookup`` applies its NaT default only to
    floats)."""
    dev = resolve_device(device)
    cores = dataset.coords["core"]
    anvils = dataset.coords["anvil"]
    core_anvil_index = _v(dataset["core_anvil_index"]).copy()

    has_anvil = np.isin(core_anvil_index, anvils)
    dataset["core_has_anvil_flag"] = _da(has_anvil, "core", "core_has_anvil_flag")
    dataset["core_anvil_removed"] = _da(
        np.logical_and(~has_anvil, core_anvil_index != 0), "core",
        "core_anvil_removed",
    )
    core_anvil_index[~has_anvil] = 0
    dataset["core_anvil_index"].values[...] = core_anvil_index

    by_anvil = Groups(core_anvil_index[has_anvil], anvils, dev)
    dataset["anvil_core_count"] = _da(
        counts_groupby(by_anvil), "anvil", "anvil_core_count",
    )
    initial_core = argmin_groupby(
        np.asarray(cores)[has_anvil], _v(dataset["core_start_t"])[has_anvil], by_anvil,
    )
    # anvils with no surviving core get index 0
    initial_core = np.where(np.isnan(initial_core.astype(float)), 0, initial_core)
    dataset["anvil_initial_core_index"] = _da(
        initial_core.astype(np.int32), "anvil", "anvil_initial_core_index"
    )

    init_core_end_t = _lookup(
        _v(dataset["core_end_t"]), cores, initial_core, default=np.datetime64("NaT"),
    )
    init_core_start_t = _lookup(
        _v(dataset["core_start_t"]), cores, initial_core, default=np.datetime64("NaT"),
    )
    dataset["anvil_no_growth_flag"] = _da(
        _v(dataset["thick_anvil_max_area_t"]) <= init_core_end_t, "anvil",
        "anvil_no_growth_flag",
    )
    dataset["anvil_no_initial_core_flag"] = _da(
        _v(dataset["thick_anvil_start_t"]) < init_core_start_t, "anvil",
        "anvil_no_initial_core_flag",
    )

    core_flags = [
        _v(dataset["core_edge_label_flag"]),
        _v(dataset["core_start_label_flag"]),
        _v(dataset["core_end_label_flag"]),
    ]
    if "core_nan_flag" in dataset:
        core_flags.append(_v(dataset["core_nan_flag"]))
    core_is_valid = ~np.logical_or.reduce(core_flags)
    dataset["core_is_valid"] = _da(core_is_valid, "core", "core_is_valid")

    by_core = Groups(core_anvil_index, anvils, dev)
    anvil_has_invalid = ~by_core.at(by_core.all(by_core.values(core_is_valid)))
    dataset["anvil_invalid_core_flag"] = _da(
        anvil_has_invalid, "anvil", "anvil_invalid_core_flag"
    )

    for prefix in ("thick_anvil", "thin_anvil"):
        flags = [
            anvil_has_invalid,
            _v(dataset["anvil_no_growth_flag"]),
            _v(dataset["anvil_no_initial_core_flag"]),
            _v(dataset[f"{prefix}_edge_label_flag"]),
            _v(dataset[f"{prefix}_start_label_flag"]),
            _v(dataset[f"{prefix}_end_label_flag"]),
        ]
        if f"{prefix}_nan_flag" in dataset:
            flags.append(_v(dataset[f"{prefix}_nan_flag"]))
        dataset[f"{prefix}_is_valid"] = _da(
            ~np.logical_or.reduce(flags), "anvil", f"{prefix}_is_valid"
        )
    return dataset
