"""Weighted and grouped statistics (counterpart of
``tobac_flow_tpu/utils/stats.py``).

The single-sample statistics (``weighted_stats`` and its kin) take one
label's or one object's values as arrays or tensors and compute in float64
with torch.  The grouped statistics (the ``*_groupby`` family) reduce a
table of per-step values by an integer group id per step, for each id of
an index, as segment operations on the table's device (:class:`Groups`: a
stable sort by group, ``searchsorted`` bounds, ``scatter_reduce`` and
``index_put_``), where the reference calls a Python function once per
group.  Each returns numpy with the reference's values and dtypes: where an
id of the index has no element, its default, promoted with the other
values as ``np.asarray`` promotes a list of them.  Times are int64
nanoseconds on the device, and NaT is masked explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.utils.labels import SegmentChunks, bin_sums, sum_plan

__all__ = [
    "find_overlap_mode",
    "n_unique_along_axis",
    "weighted_average_and_std",
    "weighted_stats",
    "weighted_average_uncertainty",
    "weighted_uncertainties",
    "weighted_stats_and_uncertainties",
    "get_weighted_proportions",
    "calc_combined_mean",
    "calc_combined_std",
    "calc_max_cooling_rate",
    "calc_cooling_rate",
    "calc_growth_rate",
    "cooling_rate_groupby",
    "growth_rate_groupby",
    "idxmax_cooling_rate_groupby",
    "idxmax_growth_rate_groupby",
    "weighted_covariance",
    "weighted_correlation",
    "mse",
    "Groups",
    "groupby_apply",
    "combined_mean_groupby",
    "combined_std_groupby",
    "weighted_average_groupby",
    "weighted_average_uncertainty_groupby",
    "argmax_groupby",
    "argmin_groupby",
    "counts_groupby",
    "idxmin_groupby",
    "idxmax_groupby",
]

NAT = np.iinfo(np.int64).min  # NaT as int64 nanoseconds
NS_PER_MINUTE = 6e10


def find_overlap_mode(labels, other, index, background=0, min_count=1, budget_bytes=None):
    """For each label value in ``index``: the most common nonzero value of
    ``other`` over the label's pixels, the smallest of those tied (as
    ``np.unique`` and ``argmax`` give), where it covers at least
    ``min_count`` pixels; ``background`` otherwise.  ``labels`` and
    ``other`` are non-negative integer tensors of one shape.

    One histogram over the (label, value) pairs of the labelled pixels,
    summed over time chunks (see :class:`SegmentChunks`), then an argmax
    per label; returns numpy int64 over ``index``."""
    segs = SegmentChunks(labels, "find_overlap_mode", budget_bytes)
    width = int(other.max()) + 1 if other.numel() else 1
    keys, counts = [], []
    for s, e, seg in segs:
        values = seg.gather(segs.take(other, s, e)).long()
        hit = values != 0
        pairs, n = torch.unique(seg.bins[hit] * width + values[hit], return_counts=True)
        keys.append(pairs)
        counts.append(n)
        del values, hit
    pairs, inverse = torch.unique(torch.cat(keys), return_inverse=True)
    counts = torch.zeros(pairs.numel(), dtype=torch.int64, device=pairs.device).index_add_(
        0, inverse, torch.cat(counts))
    rows, values = pairs // width, pairs % width
    best = torch.zeros(segs.n + 1, dtype=counts.dtype, device=counts.device)
    best.scatter_reduce_(0, rows, counts, "amax")
    tied = counts == best[rows]
    mode = torch.full((segs.n + 1,), width, dtype=torch.int64, device=counts.device)
    mode.scatter_reduce_(0, rows[tied], values[tied], "amin")
    mode = torch.where(best >= max(min_count, 1), mode, background)
    return segs.at(mode, index, background).astype(np.int64)


def n_unique_along_axis(a, axis=0):
    """Number of distinct values along ``axis`` of a tensor, less one
    where a zero is among them (the reference's count)."""
    b = torch.sort(torch.movedim(a, axis, 0), dim=0).values
    return (b[1:] != b[:-1]).sum(dim=0) + (
        torch.count_nonzero(a, dim=axis) == a.shape[axis]
    ).long()


# -- statistics of one sample ---------------------------------------------------


def _f64(x, device=None):
    """``x`` (array, tensor or scalar) as a flat float64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).to(device or x.device, torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64).reshape(-1), device=device)


def _item(x):
    return np.float64(x.item()) if isinstance(x, torch.Tensor) else np.float64(x)


def weighted_average_and_std(data, weights, unbiased=True):
    """Weighted mean and std; unbiased, the std divides the variance by
    1 - sum(w^2) / sum(w)^2 and is NaN where that is not positive."""
    data = _f64(data)
    weights = _f64(weights, data.device)
    total = weights.sum()
    if total == 0:
        raise ZeroDivisionError("Weights sum to zero, can't be normalized")
    average = (data * weights).sum() / total
    variance = ((data - average) ** 2 * weights).sum() / total
    std = np.nan
    if unbiased:
        correction = 1 - (weights**2).sum() / total**2
        if correction > 0:
            std = torch.sqrt(variance / correction)
    else:
        std = torch.sqrt(variance)
    return _item(average), _item(std)


def _finite(data, *others, ignore_nan=True):
    data = _f64(data)
    others = [_f64(o, data.device) for o in others]
    if ignore_nan:
        keep = torch.isfinite(data)
        return [data[keep]] + [o[keep] for o in others]
    return [data] + others


def weighted_stats(data, weights, ignore_nan=True, default=np.nan):
    """Weighted mean, unbiased std, min and max of the finite values (all
    four ``default`` where none is left or the weights do not sum to a
    positive value)."""
    data, weights = _finite(data, weights, ignore_nan=ignore_nan)
    if data.numel() > 0 and weights.sum() > 0:
        average, std = weighted_average_and_std(data, weights)
        return average, std, _item(data.min()), _item(data.max())
    return default, default, default, default


def weighted_average_uncertainty(errors, weights):
    """sqrt(sum(w^2 e^2)) / sum(w), NaN without a positive weight sum."""
    errors, weights = _f64(errors), _f64(weights)
    if errors.numel() > 0 and weights.sum() > 0:
        return _item(torch.sqrt((weights**2 * errors**2).sum()) / weights.sum())
    return np.nan


def weighted_uncertainties(data, errors, weights, std, ignore_nan=True):
    """The mean's uncertainty, its error combined with std / sqrt(n), and
    the errors at the first minimum and first maximum of the finite
    values."""
    data, errors, weights = _finite(data, errors, weights, ignore_nan=ignore_nan)
    if data.numel() > 0 and weights.sum() > 0:
        uncertainty = weighted_average_uncertainty(errors, weights)
        combined = ((std / data.numel() ** 0.5) ** 2 + uncertainty**2) ** 0.5
        return (uncertainty, np.float64(combined), _item(errors[torch.argmin(data)]),
                _item(errors[torch.argmax(data)]))
    return np.nan, np.nan, np.nan, np.nan


def weighted_stats_and_uncertainties(data, errors, weights, ignore_nan=True):
    average, std, minimum, maximum = weighted_stats(data, weights, ignore_nan)
    uncertainty, combined, min_err, max_err = weighted_uncertainties(
        data, errors, weights, std, ignore_nan
    )
    return average, std, minimum, maximum, uncertainty, combined, min_err, max_err


def get_weighted_proportions(data, weights, flag_values):
    """Share of the weights (NaN-summed over every value) at each of
    ``flag_values``, NaN without a positive weight sum."""
    data = torch.as_tensor(np.asarray(data)).reshape(-1)
    weights = _f64(weights)
    flags = torch.as_tensor(np.asarray(list(flag_values)))
    hit = (data[:, None] == flags).double() * weights[:, None]
    total = torch.nansum(weights)
    if total > 0:
        return (torch.nansum(hit, 0) / total).numpy()
    return np.full(flags.numel(), np.nan)


def calc_combined_mean(step_mean, step_area):
    """Area-weighted mean of per-step means, over the steps where both are
    finite."""
    mean, area = _f64(step_mean), _f64(step_area)
    keep = torch.isfinite(mean) & torch.isfinite(area)
    if keep.any():
        return _item((mean[keep] * area[keep]).sum() / area[keep].sum())
    return np.nan


def calc_combined_std(step_std, step_mean, step_area):
    """The reference's combination of per-step stds about the combined
    mean: sqrt((sum(a std) + sum(a (mean - combined)^2)) / sum(a))."""
    combined = calc_combined_mean(step_mean, step_area)
    std, mean, area = _f64(step_std), _f64(step_mean), _f64(step_area)
    keep = torch.isfinite(std) & torch.isfinite(mean) & torch.isfinite(area)
    if keep.any():
        return _item(torch.sqrt(((area[keep] * std[keep]).sum()
                                 + (area[keep] * (mean[keep] - combined) ** 2).sum())
                                / area[keep].sum()))
    return np.nan


def _ticks(times):
    """Times (datetime64 array, or int64 ns tensor) as an int64 ns tensor."""
    if isinstance(times, torch.Tensor):
        return times.reshape(-1).long()
    times = np.asarray(times)
    if times.dtype.kind == "M":
        times = times.astype("datetime64[ns]").view(np.int64)
    return torch.as_tensor(times.astype(np.int64).reshape(-1))


def _time_order(ticks):
    """The stable order of int64 ns times with NaT last, as numpy sorts
    datetimes."""
    return torch.argsort(torch.where(ticks == NAT, torch.iinfo(torch.int64).max, ticks),
                         stable=True)


def calc_max_cooling_rate(step_bt, step_t, t_steps=1):
    """Largest drop of BT over ``t_steps`` time-sorted steps, per minute
    (time steps in whole seconds)."""
    ticks = _ticks(step_t)
    order = _time_order(ticks)
    bt, ticks = _f64(step_bt)[order], ticks[order]

    def minutes(dt):
        return torch.div(dt, 10**9, rounding_mode="floor").double() / 60

    if bt.numel() >= t_steps + 1:
        return _item(((bt[:-t_steps] - bt[t_steps:])
                      / minutes(ticks[t_steps:] - ticks[:-t_steps])).max())
    return _item((bt[0] - bt[-t_steps]) / minutes(ticks[0] - ticks[-t_steps]))


def _gradient(values, minutes, group, count):
    """``np.gradient(values, minutes)`` within each run of equal ``group``
    (sorted), with numpy's formulas: first-order one-sided at a run's ends,
    second-order in between, its uniform form where the run's spacings are
    all equal; NaN for a run of one."""
    n = values.numel()
    pos = torch.arange(n, device=values.device)
    starts = torch.zeros(n, dtype=torch.long, device=values.device)
    if n:
        new = torch.ones(n, dtype=torch.bool, device=values.device)
        new[1:] = group[1:] != group[:-1]
        starts = torch.cummax(torch.where(new, pos, 0), 0).values
    size = count[group]
    first, last = pos == starts, pos == starts + size - 1
    nxt, prv = torch.clamp(pos + 1, max=max(n - 1, 0)), torch.clamp(pos - 1, min=0)
    dx = minutes[nxt] - minutes  # spacing to the next step (not read at a run's end)
    dx0 = dx[starts]
    same = (last | (dx == dx0)).to(torch.uint8)
    uniform = torch.ones(count.numel(), dtype=torch.uint8, device=values.device)
    uniform = uniform.scatter_reduce(0, group, same, "amin")[group].bool()
    f, fp, fn = values, values[prv], values[nxt]
    dx1, dx2 = dx[prv], dx
    a = -(dx2) / (dx1 * (dx1 + dx2))
    b = (dx2 - dx1) / (dx1 * dx2)
    c = dx1 / (dx2 * (dx1 + dx2))
    inner = torch.where(uniform, (fn - fp) / (2.0 * dx0), a * fp + b * f + c * fn)
    grad = torch.where(first, (fn - f) / dx, torch.where(last, (f - fp) / dx1, inner))
    return torch.where(size < 2, torch.nan, grad)


def _rate_gradient(step_vals, step_t):
    """d(field)/dt per minute over the time-sorted steps, as
    ``np.gradient`` gives it ([nan] for fewer than 2 steps), and the time
    order."""
    ticks = _ticks(step_t)
    order = _time_order(ticks)
    vals = _f64(step_vals)[order]
    if vals.numel() < 2:
        return np.asarray([np.nan]), order.numpy()
    group = torch.zeros(vals.numel(), dtype=torch.long)
    grad = _gradient(vals, ticks[order].double() / NS_PER_MINUTE, group,
                     torch.tensor([vals.numel()]))
    return grad.numpy(), order.numpy()


def calc_cooling_rate(step_vals, step_t):
    """Maximum cooling (-min d/dt) rate per minute."""
    grad, _ = _rate_gradient(step_vals, step_t)
    return -np.nanmin(grad)


def calc_growth_rate(step_vals, step_t):
    """Maximum growth (max d/dt) rate per minute."""
    grad, _ = _rate_gradient(step_vals, step_t)
    return np.nanmax(grad)


def weighted_covariance(x, y, w):
    x, y, w = _f64(x), _f64(y), _f64(w)
    return _item((w * (x - (x * w).sum() / w.sum()) * (y - (y * w).sum() / w.sum())).sum()
                 / w.sum())


def weighted_correlation(x, y, w):
    return weighted_covariance(x, y, w) / np.sqrt(
        weighted_covariance(x, x, w) * weighted_covariance(y, y, w)
    )


def mse(a, b):
    d = _f64(a) - _f64(b)
    return _item(torch.nansum(d**2) / torch.isfinite(d).sum())


# -- grouped reductions over integer group ids -------------------------------


def _host(x):
    x = getattr(x, "values", x)
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Groups:
    """The elements of a table grouped by an integer id per element, for
    each id of ``index`` (by default the sorted nonzero ids present), on
    ``device`` (by default where ``groups`` lies, the host for numpy).

    The elements are sorted stably by id, so that each group keeps the
    table's order, and ``searchsorted`` bounds each group; each element
    carries the slot of its id among the index's distinct ids (the last
    slot, ``n``, for an id outside the index).  A reduction fills n + 1
    slots with ``scatter_reduce`` or ``index_put_`` and reads them back at
    each id of the index (duplicates alike); ``found`` says which ids have
    an element.  Values are given as numpy arrays or tensors; datetime64
    and timedelta64 values reduce as int64 ns, NaT masked."""

    def __init__(self, groups, index=None, device=None):
        if device is None:
            device = groups.device if isinstance(groups, torch.Tensor) else "cpu"
        self.device = torch.device(device)
        groups = _host(groups)
        self.dtype = groups.dtype
        g = torch.as_tensor(groups.astype(np.int64).reshape(-1), device=self.device)
        if index is None:
            index = np.unique(g[g != 0].cpu().numpy())
        self.index = _host(index).reshape(-1)
        idx = torch.as_tensor(self.index.astype(np.int64), device=self.device)
        uniq, self.inv = torch.unique(idx, sorted=True, return_inverse=True)
        self.n = uniq.numel()
        self.order = torch.argsort(g, stable=True)
        sorted_g = g[self.order]
        self.starts = torch.searchsorted(sorted_g, uniq)
        counts = torch.searchsorted(sorted_g, uniq, right=True) - self.starts
        slot = torch.searchsorted(uniq, g).clamp(max=max(self.n - 1, 0))
        inside = uniq[slot] == g if self.n else torch.zeros_like(g, dtype=torch.bool)
        self.slot = torch.where(inside, slot, self.n)
        self.size = torch.cat([counts, counts.new_zeros(1)])  # per slot
        self.found = (counts[self.inv] > 0).cpu().numpy()
        self.m = g.numel()
        self._plan = None

    # -- values in and out ---------------------------------------------------
    def values(self, x):
        """``x`` as a flat tensor on the device; datetimes and durations as
        int64 ns."""
        if isinstance(x, torch.Tensor):
            return x.reshape(-1).to(self.device)
        x = _host(x).reshape(-1)
        if x.dtype.kind in "mM":
            x = x.astype(x.dtype.kind == "M" and "datetime64[ns]" or "timedelta64[ns]")
            x = x.view(np.int64)
        return torch.as_tensor(x, device=self.device)

    def out(self, per_slot, like, default=np.nan, empty=None):
        """Per-slot results at the index's ids as numpy of ``like``'s dtype
        (an array, or a dtype), with ``default`` for an id without
        elements, promoted as ``np.asarray`` promotes the reference's list
        of results; an empty index gives ``empty``'s dtype (``like``'s by
        default)."""
        def dtype_of(x):
            return x.dtype if isinstance(x, np.ndarray) else np.dtype(x)

        dtype = dtype_of(like)
        if self.index.size == 0:
            return np.asarray([], dtype=dtype if empty is None else dtype_of(empty))
        vals = self.at(per_slot)
        if dtype.kind in "mM":
            vals = vals.astype(np.int64).view(f"{dtype.str[1]}8[ns]")
        vals = vals.astype(dtype)
        if self.found.all():
            return vals
        return np.asarray([v if f else default for v, f in zip(vals, self.found)])

    def at(self, per_slot):
        """Per-slot values at the index's ids, as numpy."""
        return per_slot[:self.n][self.inv].cpu().numpy()

    # -- reductions (per slot) -------------------------------------------------
    def count(self):
        return self.size

    def sum(self, x, keep=None, dtype=torch.float64):
        """Sums per slot (``bin_sums``: the same bits on every device)."""
        x = x.to(dtype)
        if keep is not None:
            x = torch.where(keep, x, torch.zeros((), dtype=dtype, device=self.device))
        if self._plan is None:  # every element, those outside the index in slot n
            self._plan = sum_plan(self.slot, self.n + 1)
        return bin_sums(x, self.slot, self.n + 1, self._plan)

    def reduce(self, x, how, keep=None, empty=0):
        """``how`` ("amin", "amax") of ``x`` per slot over the elements
        that ``keep`` flags (all by default)."""
        slot = self.slot
        if keep is not None:
            x, slot = x[keep], slot[keep]
        out = torch.full((self.n + 1,), empty, dtype=x.dtype, device=self.device)
        return out.scatter_reduce_(0, slot, x, how, include_self=False)

    def any(self, flags):
        return self.reduce(flags.to(torch.uint8), "amax", empty=0).bool()

    def all(self, flags):
        return self.reduce(flags.to(torch.uint8), "amin", empty=1).bool()

    def extreme(self, x, how, missing=None):
        """max or min ("amax", "amin") of ``x`` per slot, NaN (NaT for
        int64 ns times, ``missing`` flags them) where a value is NaN."""
        if missing is None:
            missing = torch.isnan(x) if x.is_floating_point() else torch.zeros_like(
                x, dtype=torch.bool)
        kept = self.reduce(x, how, ~missing)
        hole = torch.nan if x.is_floating_point() else NAT
        return torch.where(self.any(missing), torch.as_tensor(hole, dtype=x.dtype,
                                                              device=self.device), kept)

    def first(self, keep=None):
        """Position (in the table) of each slot's first element that
        ``keep`` flags; ``m`` where none."""
        pos = torch.arange(self.m, device=self.device)
        return self.reduce(pos, "amin", keep, empty=self.m)

    def last(self, keep=None):
        pos = torch.arange(self.m, device=self.device)
        return self.reduce(pos, "amax", keep, empty=-1)

    def arg(self, x, how, missing=None):
        """Position of each slot's first extremum of ``x`` ("amin" or
        "amax") in table order, the first NaN (NaT) where there is one, as
        ``np.argmin`` / ``np.argmax`` give; ``m`` for an empty slot."""
        if missing is None:
            missing = torch.isnan(x) if x.is_floating_point() else torch.zeros_like(
                x, dtype=torch.bool)
        best = self.reduce(x, how, ~missing)
        at = ~missing & (x == best[self.slot])
        return torch.where(self.any(missing), self.first(missing), self.first(at))

    def pick(self, pos, values):
        """``values`` (a tensor over the table) at per-slot positions
        ``pos`` (clamped where a slot is empty)."""
        if self.m == 0:
            return torch.zeros(pos.shape, dtype=values.dtype, device=self.device)
        return values[pos.clamp(0, max(self.m - 1, 0))]

    def time_sorted(self, ticks):
        """The table's positions sorted by slot, then by time (NaT last),
        stably: the order of each group's steps in time."""
        order = _time_order(ticks)
        return order[torch.argsort(self.slot[order], stable=True)]


def _groups(groups, index, device):
    return groups if isinstance(groups, Groups) else Groups(groups, index, device)


def groupby_apply(func, groups, *fields, index=None, default=np.nan):
    """``func(*field_slices)`` of each group's elements, in table order, for
    each id of ``index`` (default: sorted unique nonzero ids; ``groups``
    may also be a :class:`Groups`); the general
    form, whose ``func`` runs on the host once per group (the port's own
    statistics use the vectorised functions below)."""
    fields = [_host(f).reshape(-1) for f in fields]
    grp = _groups(groups, index, None)
    order = grp.order.cpu().numpy()
    starts = grp.starts[grp.inv].cpu().numpy()
    sizes = grp.size[:grp.n][grp.inv].cpu().numpy()
    out = []
    for s, n in zip(starts, sizes):
        if n:
            pos = order[s:s + n]
            out.append(func(*[f[pos] for f in fields]))
        else:
            out.append(default)
    if not out and fields:
        return np.asarray(out, dtype=fields[0].dtype)
    return np.asarray(out)


def combined_mean_groupby(means, area, groups, index=None, device=None):
    """:func:`calc_combined_mean` per group."""
    grp = _groups(groups, index, device)
    mean, area_t = grp.values(means).double(), grp.values(area).double()
    keep = torch.isfinite(mean) & torch.isfinite(area_t)
    out = grp.sum(mean * area_t, keep) / grp.sum(area_t, keep)
    out = torch.where(grp.sum(keep.double()) > 0, out, torch.nan)
    return grp.out(out, np.float64, empty=_host(means))


def _combined_std(grp, stds, means, area):
    std, mean, area_t = (grp.values(x).double() for x in (stds, means, area))
    keep_m = torch.isfinite(mean) & torch.isfinite(area_t)
    combined = grp.sum(mean * area_t, keep_m) / grp.sum(area_t, keep_m)
    keep = torch.isfinite(std) & keep_m
    dev = mean - combined[grp.slot]
    out = torch.sqrt((grp.sum(area_t * std, keep) + grp.sum(area_t * (dev * dev), keep))
                     / grp.sum(area_t, keep))
    return torch.where(grp.sum(keep.double()) > 0, out, torch.nan)


def combined_std_groupby(stds, means, area, groups, index=None, device=None):
    """:func:`calc_combined_std` per group."""
    grp = _groups(groups, index, device)
    return grp.out(_combined_std(grp, stds, means, area), np.float64, empty=_host(stds))


def weighted_average_groupby(field, area, groups, index=None, device=None):
    """``np.average(field, weights=area)`` per group (which raises where a
    group's weights sum to zero)."""
    grp = _groups(groups, index, device)
    f, a = grp.values(field).double(), grp.values(area).double()
    total = grp.sum(a)
    if bool(((total == 0) & (grp.size > 0)).any()):
        raise ZeroDivisionError("Weights sum to zero, can't be normalized")
    return grp.out(grp.sum(f * a) / total, np.float64, empty=_host(field))


def weighted_average_uncertainty_groupby(field, area, groups, index=None, device=None):
    """:func:`weighted_average_uncertainty` per group."""
    grp = _groups(groups, index, device)
    e, a = grp.values(field).double(), grp.values(area).double()
    total = grp.sum(a)
    out = torch.where(total > 0, torch.sqrt(grp.sum((a * a) * (e * e))) / total, torch.nan)
    return grp.out(out, np.float64, empty=_host(field))


def _arg_groupby(field, key, groups, index, device, how):
    grp = _groups(groups, index, device)
    key_t = grp.values(key)
    missing = key_t == NAT if _host(key).dtype.kind in "mM" else None
    pos = grp.arg(key_t, how, missing)
    return grp.out(grp.pick(pos, grp.values(field)), _host(field))


def argmax_groupby(field, find_max, groups, index=None, device=None):
    """``field`` at the first maximum of ``find_max`` in each group (at its
    first NaN where it has one, as ``np.argmax``)."""
    return _arg_groupby(field, find_max, groups, index, device, "amax")


def argmin_groupby(field, find_min, groups, index=None, device=None):
    return _arg_groupby(field, find_min, groups, index, device, "amin")


def counts_groupby(groups, index=None, device=None):
    grp = _groups(groups, index, device)
    return grp.out(grp.count(), np.int64, default=0, empty=grp.dtype)


def idxmin_groupby(field, coord, groups, index=None, device=None):
    """``coord`` at the first minimum of ``field`` in each group."""
    grp = _groups(groups, index, device)
    key = grp.values(field)
    missing = key == NAT if _host(field).dtype.kind in "mM" else None
    return grp.out(grp.pick(grp.arg(key, "amin", missing), grp.values(coord)), _host(coord),
                   empty=_host(field))


def idxmax_groupby(field, coord, groups, index=None, device=None):
    grp = _groups(groups, index, device)
    key = grp.values(field)
    missing = key == NAT if _host(field).dtype.kind in "mM" else None
    return grp.out(grp.pick(grp.arg(key, "amax", missing), grp.values(coord)), _host(coord),
                   empty=_host(field))


def _rates(grp, field, times):
    """Each element's d(field)/dt per minute within its group over the
    time-sorted steps (``np.gradient``; NaN in a group of one), in time
    order, with that order and the sorted slots."""
    ticks = grp.values(times).long()
    order = grp.time_sorted(ticks)
    slot = grp.slot[order]
    vals = grp.values(field).double()[order]
    return _gradient(vals, ticks[order].double() / NS_PER_MINUTE, slot, grp.size), order, slot


def _rate_extreme(field, times, groups, index, device, how):
    grp = _groups(groups, index, device)
    grad, _, slot = _rates(grp, field, times)
    keep = ~torch.isnan(grad)
    best = torch.full((grp.n + 1,), torch.nan, dtype=torch.float64, device=grp.device)
    best = best.scatter_reduce_(0, slot[keep], grad[keep], how, include_self=False)
    return grp, best


def cooling_rate_groupby(field, times, groups, index=None, device=None):
    """Per-object maximum cooling rate, -nanmin of d(field)/dt per minute."""
    grp, best = _rate_extreme(field, times, groups, index, device, "amin")
    return grp.out(-best, np.float64, empty=_host(field))


def growth_rate_groupby(field, times, groups, index=None, device=None):
    grp, best = _rate_extreme(field, times, groups, index, device, "amax")
    return grp.out(best, np.float64, empty=_host(field))


def _idx_rate(field, times, coord, groups, index, device, how):
    """``coord`` at the step where the rate peaks (the first in time order of
    the nanmin or nanmax of d/dt), or at the group's first step in table
    order where no rate is finite."""
    grp = _groups(groups, index, device)
    grad, order, slot = _rates(grp, field, times)
    keep = ~torch.isnan(grad)
    best = torch.full((grp.n + 1,), torch.nan, dtype=torch.float64, device=grp.device)
    best = best.scatter_reduce_(0, slot[keep], grad[keep], how, include_self=False)
    rank = torch.arange(order.numel(), device=grp.device)
    at = keep & (grad == best[slot])
    first_at = torch.full((grp.n + 1,), order.numel(), dtype=torch.long, device=grp.device)
    first_at = first_at.scatter_reduce_(0, slot[at], rank[at], "amin", include_self=False)
    finite = torch.zeros(grp.n + 1, dtype=torch.uint8, device=grp.device).scatter_reduce_(
        0, slot, torch.isfinite(grad).to(torch.uint8), "amax", include_self=False).bool()
    sorted_at = order[first_at.clamp(max=order.numel() - 1)] if order.numel() else first_at
    pos = torch.where(finite, sorted_at, grp.first())
    return grp.out(grp.pick(pos, grp.values(coord)), _host(coord), empty=_host(field))


def idxmax_cooling_rate_groupby(field, times, coord, groups, index=None, device=None):
    """Step id where the cooling rate peaks."""
    return _idx_rate(field, times, coord, groups, index, device, "amin")


def idxmax_growth_rate_groupby(field, times, coord, groups, index=None, device=None):
    return _idx_rate(field, times, coord, groups, index, device, "amax")
