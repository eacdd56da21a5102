"""Object-level filters (counterpart of ``tobac_flow_tpu/utils/filters.py``):
orphan-coordinate removal and the science filters on cores (cooling of at
least 8 K, largest time gap, shortest lifetime, largest area, NaN checks)
and anvils.

The per-object criteria are segment reductions of the step tables on
``device`` (CUDA unless the caller asks for the CPU; see
``utils.stats.Groups``), each group's steps in the table's order; times
are int64 nanoseconds there, and a criterion that compares a NaT is false,
as numpy's datetime comparisons are.  Selecting the surviving coordinates
is host bookkeeping on the tables.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch

from tobac_flow_tpu_torch.device import resolve_device
from tobac_flow_tpu_torch.utils.stats import NAT, Groups

__all__ = ["remove_orphan_coords", "filter_cores", "filter_anvils"]


def _v(a):
    a = getattr(a, "values", a)
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _ns(delta):
    """A timedelta as int64 nanoseconds."""
    return int(np.timedelta64(delta).astype("timedelta64[ns]").astype(np.int64))


def remove_orphan_coords(dataset):
    """Drop cores and anvils without steps (an anvil needs thick and thin
    steps) and steps whose object is gone."""
    wh_core = np.isin(dataset.coords["core"], _v(dataset["core_step_core_index"]))
    wh_anvil = np.logical_and(
        np.isin(dataset.coords["anvil"], _v(dataset["thick_anvil_step_anvil_index"])),
        np.isin(dataset.coords["anvil"], _v(dataset["thin_anvil_step_anvil_index"])),
    )
    dataset = dataset.sel(
        core=dataset.coords["core"][wh_core], anvil=dataset.coords["anvil"][wh_anvil]
    )
    return _keep_steps(dataset, ("core_step", "core"), ("thick_anvil_step", "anvil"),
                       ("thin_anvil_step", "anvil"))


def _keep_steps(dataset, *families):
    """Select the steps of each (step dim, object dim) family whose object
    is still in the dataset."""
    sel = {}
    for step, obj in families:
        index = _v(dataset[f"{step}_{obj}_index"])
        sel[step] = dataset.coords[step][np.isin(index, dataset.coords[obj])]
    return dataset.sel(**sel)


def _time_spans(grp, ticks):
    """Per slot of ``grp``: whether a step time is NaT, the lifetime (last
    minus first time, 0 without steps) and the largest gap between
    consecutive steps in time (0 for fewer than 2), in ns."""
    nat = ticks == NAT
    has_nat = grp.any(nat)
    first = grp.reduce(ticks, "amin", ~nat)
    last = grp.reduce(ticks, "amax", ~nat)
    lifetime = torch.where(grp.size > 0, last - first, 0)
    order = grp.time_sorted(ticks)
    slot, t = grp.slot[order], ticks[order]
    same = slot[1:] == slot[:-1]
    gaps = torch.zeros(grp.n + 1, dtype=torch.int64, device=grp.device)
    gaps = gaps.scatter_reduce_(0, slot[1:][same], (t[1:] - t[:-1])[same], "amax",
                                include_self=False)
    return has_nat, lifetime, gaps


def filter_cores(
    dataset,
    verbose=False,
    min_lifetime=timedelta(minutes=14),
    max_time_gap=timedelta(minutes=16),
    device=None,
):
    """Remove the cores that cool by less than 8 K from their first step to
    their last (in table order), have a gap over ``max_time_gap`` or a
    lifetime under ``min_lifetime``, reach an area over 1e4, or hold a NaN
    step BT and are NaN-flagged; then the steps of removed cores."""
    dev = resolve_device(device)
    cores = dataset.coords["core"]
    grp = Groups(_v(dataset["core_step_core_index"]), cores, dev)
    if verbose:
        print(f"Initial core count: {cores.size}")

    if "core_step_bt_mean" in dataset:
        bt = grp.values(_v(dataset["core_step_bt_mean"]))
        change = grp.pick(grp.first(), bt) - grp.pick(grp.last(), bt)
        invalid_bt = (grp.size > 0) & (change.double() < 8)
        any_nan = grp.at(grp.any(torch.isnan(bt)))
        if "core_nan_flag" in dataset:
            any_nan = np.logical_and(any_nan, _v(dataset["core_nan_flag"]))
        invalid_bt = grp.at(invalid_bt)
    else:
        invalid_bt = np.zeros(cores.size, bool)
        any_nan = np.zeros(cores.size, bool)

    has_nat, lifetime, gaps = _time_spans(grp, grp.values(_v(dataset["core_step_t"])).long())
    invalid_gap = grp.at(~has_nat & (gaps > _ns(max_time_gap)))
    invalid_lifetime = grp.at(~has_nat & (lifetime < _ns(min_lifetime)))
    max_area = grp.extreme(grp.values(_v(dataset["core_step_area"])).double(), "amax")
    invalid_area = grp.at(max_area > 1e4)

    invalid = np.logical_or.reduce(
        [invalid_bt, invalid_gap, invalid_lifetime, invalid_area, any_nan]
    )
    dataset = dataset.sel(core=cores[~invalid])
    if verbose:
        print(f"Final core count: {dataset.coords['core'].size}")
    return _keep_steps(dataset, ("core_step", "core"))


def filter_anvils(
    dataset,
    verbose=False,
    min_lifetime=timedelta(minutes=14),
    max_time_gap=timedelta(minutes=16),
    device=None,
):
    """Remove the anvils without a core, then those whose thin steps hold a
    NaN BT and are NaN-flagged, whose thick steps have a lifetime under
    ``min_lifetime`` or a gap over ``max_time_gap``, whose largest thick
    area is not above their cores' largest area, or which end no later
    than their cores (a NaT on either side compares false); then the steps
    of removed anvils."""
    dev = resolve_device(device)
    anvils = dataset.coords["anvil"]
    if verbose:
        print(f"Initial anvil count: {anvils.size}")

    has_core = np.isin(anvils, _v(dataset["core_anvil_index"]))
    dataset = _keep_steps(dataset.sel(anvil=anvils[has_core]), ("thick_anvil_step", "anvil"),
                          ("thin_anvil_step", "anvil"))
    anvils = dataset.coords["anvil"]
    thick = Groups(_v(dataset["thick_anvil_step_anvil_index"]), anvils, dev)

    if "thin_anvil_step_bt_mean" in dataset:
        thin = Groups(_v(dataset["thin_anvil_step_anvil_index"]), anvils, dev)
        any_nan = thin.at(thin.any(torch.isnan(thin.values(
            _v(dataset["thin_anvil_step_bt_mean"])))))
        if "thin_anvil_nan_flag" in dataset:
            any_nan = np.logical_and(any_nan, _v(dataset["thin_anvil_nan_flag"]))
    else:
        any_nan = np.zeros(anvils.size, bool)

    ticks = thick.values(_v(dataset["thick_anvil_step_t"])).long()
    has_nat, lifetime, gaps = _time_spans(thick, ticks)
    invalid_lifetime = thick.at(~has_nat & (lifetime < _ns(min_lifetime)))
    invalid_gap = thick.at(~has_nat & (gaps > _ns(max_time_gap)))

    anvil_max_area = thick.extreme(thick.values(_v(dataset["thick_anvil_step_area"])).double(),
                                   "amax")
    core_anvil_index = _v(dataset["core_anvil_index"])
    wh = np.isin(core_anvil_index, anvils)
    by_core = Groups(core_anvil_index[wh], anvils, dev)
    core_area = by_core.extreme(by_core.values(_v(dataset["core_max_area"])[wh]).double(),
                                "amax")
    core_area = torch.where(by_core.size > 0, core_area, torch.inf)
    invalid_area = thick.at(anvil_max_area) <= by_core.at(core_area)

    end_t = thick.extreme(ticks, "amax", ticks == NAT)
    end_t = torch.where(thick.size > 0, end_t, NAT)
    core_end = by_core.values(_v(dataset["core_end_t"])[wh]).long()
    core_end_t = by_core.extreme(core_end, "amax", core_end == NAT)
    core_end_t = torch.where(by_core.size > 0, core_end_t, NAT)
    end_t, core_end_t = thick.at(end_t), by_core.at(core_end_t)
    invalid_end = (end_t <= core_end_t) & (end_t != NAT) & (core_end_t != NAT)

    invalid = np.logical_or.reduce(
        [any_nan, invalid_lifetime, invalid_gap, invalid_area, invalid_end]
    )
    dataset = dataset.sel(anvil=anvils[~invalid])
    if verbose:
        print(f"Final anvil count: {dataset.coords['anvil'].size}")
    return _keep_steps(dataset, ("thick_anvil_step", "anvil"), ("thin_anvil_step", "anvil"))
