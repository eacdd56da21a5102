"""The port's statistics and post-processing (``utils/stats.py``,
``utils/labels.py``, ``utils/filters.py``, ``schema/postprocess.py``,
``schema/dataset.py``'s bulk, spatial and temporal statistics and
``detect/analysis.get_label_stats``) against the JAX package's, on the
CPU.

The inputs are made from a numpy seed: random step tables, random label
volumes, and a storm scene (``storm_scene``: cores that cool, one that
barely does, two cores under one anvil, an anvil without a core and a
core without an anvil, a NaN patch, a 25-minute gap, pixel areas and
latitude and longitude) taken through the JAX package's detection schema,
label properties and per-step BT statistics, as ``relabel_postprocess``
leaves a file.  The port runs with ``device="cpu"``; the per-pixel passes
also under ``device.frames_budget``, which puts them into at least 3 time
chunks.  Tolerance: float64 to rtol 1e-12, float32 means and stds to
1e-5, everything else (integers, bools, times, float32 maxima, minima and
medians) identical, with the same dtypes.
"""

import warnings
from contextlib import contextmanager
from datetime import datetime, timedelta

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from chip_smoke import compare_datasets  # noqa: E402
from tobac_flow_tpu import schema as jschema  # noqa: E402
from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu.detect import analysis as janalysis  # noqa: E402
from tobac_flow_tpu.schema import postprocess as jpost  # noqa: E402
from tobac_flow_tpu.utils import filters as jfilters  # noqa: E402
from tobac_flow_tpu.utils import labels as jlabels  # noqa: E402
from tobac_flow_tpu.utils import stats as jstats  # noqa: E402
from tobac_flow_tpu_torch import device as port_device  # noqa: E402
from tobac_flow_tpu_torch import schema as tschema  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402
from tobac_flow_tpu_torch.detect import analysis  # noqa: E402
from tobac_flow_tpu_torch.schema import postprocess  # noqa: E402
from tobac_flow_tpu_torch.utils import filters, labels, stats  # noqa: E402

CHUNKED = port_device.frames_budget(4)  # 12 frames: at least 3 chunks of every pass
SHAPE = (12, 40, 56)
STEP = np.timedelta64(300, "s")


@contextmanager
def _quiet():
    """Numpy's warnings off (all-NaN slices, divisions by zero)."""
    with warnings.catch_warnings(), np.errstate(all="ignore"):
        warnings.simplefilter("ignore")
        yield


def same(want, got, name=""):
    """Equal dtype and shape; float64 to rtol 1e-12, the rest identical
    (NaN and NaT where ``want`` has them)."""
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype, (name, want.dtype, got.dtype)
    assert want.shape == got.shape, (name, want.shape, got.shape)
    if want.dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=name)
    elif want.dtype.kind == "O":
        assert all(a == b or (a != a and b != b) for a, b in zip(want, got)), name
    else:
        assert np.array_equal(want, got, equal_nan=want.dtype.kind in "fmM"), name


# -- single samples -------------------------------------------------------------

SAMPLES = {
    "plain": lambda r: (r.normal(230, 9, 40), r.uniform(0, 2, 40), r.uniform(1, 4, 40)),
    "nan_and_inf": lambda r: (np.r_[r.normal(230, 9, 30), np.nan, np.inf, -np.inf],
                              r.uniform(0, 2, 33), r.uniform(1, 4, 33)),
    "one_pixel": lambda r: (np.r_[231.5, np.nan], np.r_[0.5, 0.2], np.r_[3.0, 3.0]),
    "zero_weights": lambda r: (r.normal(230, 9, 5), r.uniform(0, 2, 5), np.zeros(5)),
    "nan_weight": lambda r: (r.normal(230, 9, 5), r.uniform(0, 2, 5), np.r_[1, 2, np.nan, 1, 1]),
    "all_nan": lambda r: (np.full(4, np.nan), r.uniform(0, 2, 4), r.uniform(1, 4, 4)),
    "tied_extrema": lambda r: (np.r_[3.0, 1.0, 5.0, 1.0, 5.0], np.r_[0.1, 0.2, 0.3, 0.4, 0.5],
                               np.r_[1.0, 0.0, 1.0, 2.0, 0.0]),
}


@pytest.mark.parametrize("case", sorted(SAMPLES))
def test_single_sample_statistics(case):
    """``weighted_stats`` and ``weighted_stats_and_uncertainties``: the
    unbiased std (NaN for one pixel), min and max over every finite value
    whatever its weight, all NaN without a finite value or a positive
    weight sum, the errors at the first extremum."""
    data, errors, weights = SAMPLES[case](np.random.default_rng(7))
    with np.errstate(all="ignore"):
        same(jstats.weighted_stats(data, weights), stats.weighted_stats(data, weights), case)
        same(jstats.weighted_stats_and_uncertainties(data, errors, weights),
             stats.weighted_stats_and_uncertainties(data, errors, weights), case)
        same(jstats.weighted_average_uncertainty(errors, weights),
             stats.weighted_average_uncertainty(errors, weights), case)
    if case == "one_pixel":
        assert np.isnan(stats.weighted_stats(data, weights)[1])


def test_single_sample_helpers():
    rng = np.random.default_rng(3)
    x, y, w = rng.normal(0, 1, 30), rng.normal(2, 1, 30), rng.uniform(0.1, 1, 30)
    flags = rng.integers(0, 4, 30)
    w_nan = w.copy()
    w_nan[3] = np.nan
    same(jstats.weighted_average_and_std(x, w), stats.weighted_average_and_std(x, w))
    same(jstats.weighted_average_and_std(x, w, unbiased=False),
         stats.weighted_average_and_std(x, w, unbiased=False))
    # divided by the NaN-sum of every weight, flagged or not
    same(jstats.get_weighted_proportions(flags, w_nan, [0, 1, 3, 7]),
         stats.get_weighted_proportions(flags, w_nan, [0, 1, 3, 7]))
    same(jstats.weighted_covariance(x, y, w), stats.weighted_covariance(x, y, w))
    same(jstats.weighted_correlation(x, y, w), stats.weighted_correlation(x, y, w))
    y[4] = np.nan
    same(jstats.mse(x, y), stats.mse(x, y))
    m, a = rng.normal(220, 3, 8).astype(np.float32), rng.uniform(1, 5, 8)
    s = rng.uniform(0, 2, 8).astype(np.float32)
    m[2], s[5] = np.nan, np.nan
    same(jstats.calc_combined_mean(m, a), stats.calc_combined_mean(m, a))
    same(jstats.calc_combined_std(s, m, a), stats.calc_combined_std(s, m, a))
    t = np.datetime64("2020-06-01", "ns") + rng.permutation(8) * STEP + rng.integers(
        0, 10**9, 8).astype("timedelta64[ns]")
    for pick, k in (([0, 1, 3, 4, 6, 7], 1), ([0, 1, 3, 4, 6, 7], 2), ([0, 1, 4], 3),
                    ([6, 7], 2), ([1], 1)):
        with _quiet():
            same(jstats.calc_max_cooling_rate(m[pick], t[pick], k),
                 stats.calc_max_cooling_rate(m[pick], t[pick], k))
    for vals, times in ((m, t), (m[:2], t[:2]), (m[:1], t[:1])):
        for name in ("calc_cooling_rate", "calc_growth_rate"):
            with _quiet():
                same(getattr(jstats, name)(vals, times), getattr(stats, name)(vals, times),
                     name)


# -- grouped reductions ------------------------------------------------------


def _table(seed, n=240, uniform=False):
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, 30, n).astype(np.int32)
    vals = rng.normal(225, 6, n).astype(np.float32)
    vals[rng.random(n) < 0.06] = np.nan
    area = rng.uniform(1, 10, n)
    if uniform:  # every group's steps 5 minutes apart, small changes
        groups = np.repeat(np.arange(1, n // 6 + 1), 6).astype(np.int32)[rng.permutation(n)]
        rank = np.zeros(n, np.int64)
        for g in np.unique(groups):
            rank[groups == g] = np.arange((groups == g).sum())
        t = np.datetime64("2020-06-01", "ns") + rank * STEP
        vals = (225 + rng.normal(0, 1e-3, n)).astype(np.float32)
    else:
        t = np.datetime64("2020-06-01", "ns") + rng.permutation(n) * STEP
    coord = (np.arange(n) * 3 + 1).astype(np.int32)
    return groups, vals, area, t, coord


INDEXES = {"default": None, "with_missing": np.arange(0, 36), "empty": np.arange(0),
           "one": np.array([5]), "duplicates": np.array([3, 3, 7])}
GROUPBY = {
    "combined_mean": lambda g, v, a, t, c: ("combined_mean_groupby", (v, a)),
    "combined_std": lambda g, v, a, t, c: ("combined_std_groupby", (np.abs(v - 225), v, a)),
    "weighted_average": lambda g, v, a, t, c: ("weighted_average_groupby", (v, a)),
    "average_uncertainty": lambda g, v, a, t, c: ("weighted_average_uncertainty_groupby",
                                                  (np.abs(v - 225), a)),
    "argmax": lambda g, v, a, t, c: ("argmax_groupby", (c, v)),
    "argmin_times": lambda g, v, a, t, c: ("argmin_groupby", (t, v)),
    "argmin_by_time": lambda g, v, a, t, c: ("argmin_groupby", (c, t)),
    "argmax_by_area": lambda g, v, a, t, c: ("argmax_groupby", (t, a)),
    "idxmin": lambda g, v, a, t, c: ("idxmin_groupby", (v, c)),
    "idxmax": lambda g, v, a, t, c: ("idxmax_groupby", (v, c)),
    "cooling_rate": lambda g, v, a, t, c: ("cooling_rate_groupby", (v, t)),
    "growth_rate": lambda g, v, a, t, c: ("growth_rate_groupby", (v, t)),
    "idx_cooling": lambda g, v, a, t, c: ("idxmax_cooling_rate_groupby", (v, t, c)),
    "idx_growth": lambda g, v, a, t, c: ("idxmax_growth_rate_groupby", (v, t, c)),
}


@pytest.mark.parametrize("index", sorted(INDEXES))
@pytest.mark.parametrize("uniform", [False, True])
def test_groupby_family(index, uniform):
    """Every grouped reduction, as segment operations on the tensors,
    against the reference's per-group functions: values, dtypes (an id
    without elements promotes its default with the values, a datetime
    with NaN to objects; an empty index takes the first field's dtype),
    NaN-first arg-extrema, ``np.gradient``'s uniform and non-uniform
    formulas, a group of one."""
    groups, vals, area, t, coord = _table(11, uniform=uniform)
    idx = INDEXES[index]
    for key, make in GROUPBY.items():
        name, args = make(groups, vals, area, t, coord)
        with _quiet():
            want = getattr(jstats, name)(*args, groups, index=idx)
        same(want, getattr(stats, name)(*args, groups, index=idx, device="cpu"), key)
    same(jstats.counts_groupby(groups, index=idx), stats.counts_groupby(groups, index=idx))
    same(jstats.groupby_apply(np.max, groups, vals, index=idx),
         stats.groupby_apply(np.max, groups, vals, index=idx), "groupby_apply")


def test_rate_gradient_formulas():
    """``_rate_gradient`` is ``np.gradient`` over the time-sorted steps in
    minutes: the uniform formula where the spacings are equal (whose
    rounding differs from the non-uniform one's), [nan] under 2 steps."""
    t = np.datetime64("2020-06-01", "ns") + np.array([2, 0, 1, 3]) * STEP
    v = np.array([220.0005, 220.0001, 220.0003, 220.0002])
    for times in (t, t + np.array([0, 0, 0, 7], "timedelta64[s]"), t[:2], t[:1]):
        want, want_order = jstats._rate_gradient(v[:times.size], times)
        got, got_order = stats._rate_gradient(v[:times.size], times)
        same(want, got)
        assert np.array_equal(want_order, got_order)


def test_groupby_keeps_table_order():
    """Within a group the steps keep the table's order, not time's: the
    first-minus-last BT change of ``filter_cores`` and the fallback step of
    ``idxmax_cooling_rate_groupby`` read the table's first step."""
    groups = np.array([1, 1, 1, 2, 2], np.int32)
    t = np.datetime64("2020-06-01", "ns") + np.array([2, 0, 1, 5, 4]) * STEP
    bt = np.array([250.0, 240.0, 230.0, np.nan, np.nan], np.float32)
    coord = np.array([10, 11, 12, 13, 14], np.int32)
    same(jstats.idxmax_cooling_rate_groupby(bt, t, coord, groups),
         stats.idxmax_cooling_rate_groupby(bt, t, coord, groups))
    assert stats.idxmax_cooling_rate_groupby(bt, t, coord, groups)[1] == 13


@pytest.mark.parametrize("m,n", [(0, 4), (1, 3), (5000, 1), (5000, 37), (20000, 600)])
def test_bin_sums(m, n):
    """The pairwise per-bin sums behind every per-label sum: the sums of
    ``np.bincount`` (empty bins 0), integers exact, and the same bits
    wherever each bin's values lie among the other bins'."""
    rng = np.random.default_rng(m + n)
    bins = torch.as_tensor(rng.integers(0, n, m))
    values = torch.as_tensor(rng.normal(225, 9, m))
    got = labels.bin_sums(values, bins, n)
    np.testing.assert_allclose(got.numpy(), np.bincount(bins.numpy(), values.numpy(), n),
                               rtol=1e-12, atol=1e-9)
    ones = labels.bin_sums(torch.ones(m, dtype=torch.int64), bins, n)
    assert ones.tolist() == np.bincount(bins.numpy(), minlength=n).tolist()
    order = torch.argsort(bins, stable=True)  # each bin's values in the same order
    assert torch.equal(labels.bin_sums(values, bins, n),
                       labels.bin_sums(values[order], bins[order], n))


# -- labels -------------------------------------------------------------------


def _random_labels(seed, shape=(9, 20, 24), top=12):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, top, shape).astype(np.int32)
    lab[lab > top - 3] = 0
    return lab


@pytest.mark.parametrize("index", [None, [1, 2, 3, 5, 40], [0, 4], []])
def test_apply_func_to_labels(index):
    lab = _random_labels(0)
    f = np.random.default_rng(1).normal(230, 9, lab.shape).astype(np.float32)
    for func, default, fields in ((np.nanmean, np.nan, (f,)),
                                  (lambda x: [x.min(), x.max()], None, (f,)),
                                  (lambda x, y: (x.sum(), y.size), [np.nan, np.nan], (f, lab))):
        want = jlabels.apply_func_to_labels(lab, *fields, func=func, index=index,
                                            default=default)
        got = labels.apply_func_to_labels(torch.as_tensor(lab), *fields, func=func,
                                          index=index, default=default)
        if index is not None and 40 in index and default is None:
            continue  # the reference stacks None there
        same(np.asarray(want, dtype=float), np.asarray(got, dtype=float))


def test_label_helpers():
    lab = _random_labels(2)
    steps = lab * 3 + np.arange(lab.shape[0])[:, None, None] % 2
    want = jlabels.get_step_labels_for_label(lab, steps)
    got = labels.get_step_labels_for_label(torch.as_tensor(lab), torch.as_tensor(steps))
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert (a is None) == (b is None)
        if a is not None:
            same(a, b)
    same(jlabels.relabel_objects(lab * 5), labels.relabel_objects(torch.as_tensor(lab * 5)).numpy())
    inplace = torch.as_tensor(lab * 5)
    labels.relabel_objects(inplace, inplace=True, budget_bytes=CHUNKED)
    same(jlabels.relabel_objects(lab * 5), inplace.numpy())
    bins = np.cumsum(np.bincount(lab.ravel()))
    for step, overlap, absolute in ((7, 0.0, 0), (3, 0.02, 2), (11, 0.5, 1)):
        locs = np.arange(0, lab.size, step)
        assert jlabels.find_overlapping_labels(lab, locs, bins, overlap, absolute) == \
            labels.find_overlapping_labels(torch.as_tensor(lab), locs, bins, overlap, absolute)
    assert labels.find_overlapping_labels(torch.as_tensor(lab), [], bins) == []


# -- the storm scene ------------------------------------------------------------

# (core, anvil, first frame, last frame, y, x, dy, dx, cooling K a frame)
STORMS = [
    (1, 1, 0, 6, 8, 6, 1, 2, 4.0),
    (2, 2, 1, 7, 26, 8, 0, 2, 0.5),  # cools by too little
    (3, 3, 2, 9, 10, 30, 1, 1, 3.0),  # spans the 25-minute gap
    (4, 3, 4, 8, 18, 34, 0, 1, 3.5),  # a second core under anvil 3
    (5, 0, 3, 6, 32, 44, 0, 0, 5.0),  # no anvil
    (0, 4, 5, 11, 30, 24, 0, 1, 0.0),  # an anvil without a core
    (6, 5, 6, 11, 6, 44, 1, 0, 6.0),  # the NaN patch, the end of the window
]


def storm_scene(seed=3):
    """Labels, BT, areas and lat/lon of ``STORMS`` on ``SHAPE``: 3x3
    cores growing inside 9x9 thick anvils (2 frames longer), inside thin
    anvils 3 pixels wider; BT cooling in each core; a NaN patch on core 6;
    a 25-minute gap after frame 8."""
    rng = np.random.default_rng(seed)
    t, h, w = SHAPE
    core = np.zeros(SHAPE, np.int32)
    thick = np.zeros(SHAPE, np.int32)
    thin = np.zeros(SHAPE, np.int32)
    bt = rng.normal(280, 2, SHAPE).astype(np.float32)
    for c, a, f0, f1, y, x, dy, dx, cool in STORMS:
        for f in range(f0, min(f1 + 2, t)):
            cy, cx = y + dy * (f - f0), x + dx * (f - f0)
            if a:
                thin[f, max(cy - 7, 0):cy + 8, max(cx - 7, 0):cx + 8] = np.where(
                    thin[f, max(cy - 7, 0):cy + 8, max(cx - 7, 0):cx + 8] == 0, a,
                    thin[f, max(cy - 7, 0):cy + 8, max(cx - 7, 0):cx + 8])
                thick[f, cy - 4:cy + 5, cx - 4:cx + 5] = a
                bt[f, cy - 4:cy + 5, cx - 4:cx + 5] -= 30
            if c and f <= f1:
                r = 1 + (f - f0) // 3
                core[f, cy - r:cy + r + 1, cx - r:cx + r + 1] = c
                bt[f, cy - r:cy + r + 1, cx - r:cx + r + 1] = 235 - cool * (f - f0) + rng.normal(
                    0, 0.3, (2 * r + 1, 2 * r + 1))
    bt[9, 4:12, 42:50] = np.nan
    minutes = np.r_[np.arange(9) * 5, 65 + np.arange(t - 9) * 5]
    times = np.datetime64("2020-06-01T00:00", "ns") + minutes * np.timedelta64(60, "s")
    area = rng.uniform(3.5, 4.5, (h, w))
    lat = np.linspace(25, 35, h * w).reshape(h, w)
    lon = np.linspace(-100, -88, h * w).reshape(w, h).T
    return dict(core_label=core, thick_anvil_label=thick, thin_anvil_label=thin, bt=bt,
                times=times, area=area, lat=lat, lon=lon)


def detected(nc, scene):
    coords = {"t": scene["times"], "y": np.arange(SHAPE[1]) * 2000.0,
              "x": np.arange(SHAPE[2]) * 2000.0}
    ds = nc.Dataset(coords=coords)
    for name in ("core_label", "thick_anvil_label", "thin_anvil_label"):
        ds[name] = nc.DataArray(scene[name].copy(), dims=("t", "y", "x"))
    for name in ("area", "lat", "lon"):
        ds[name] = nc.DataArray(scene[name], dims=("y", "x"))
    ds["bt"] = nc.DataArray(scene["bt"], dims=("t", "y", "x"), attrs={"long_name": "bt",
                                                                         "units": "K"})
    return ds


def reference_tables(scene):
    """The JAX package's detection schema, label properties and per-step BT
    statistics of the scene (what ``relabel_postprocess`` writes)."""
    ds = detected(jnc, scene)
    ds = jschema.add_label_coords(ds)
    jschema.link_cores_and_anvils(ds)
    jschema.add_step_labels(ds)
    ds = jschema.add_label_coords(ds)
    jschema.link_step_labels(ds)
    jschema.flag_edge_labels(ds, datetime(2020, 6, 1, 0, 0), datetime(2020, 6, 1, 2, 0))
    jschema.flag_nan_adjacent_labels(ds, ds["bt"])
    jschema.calculate_label_properties(ds)
    weights = np.repeat(ds["area"].values[np.newaxis], SHAPE[0], 0)
    for name in ("core_step", "thick_anvil_step", "thin_anvil_step"):
        for da in janalysis.weighted_statistics_on_labels(
                ds[f"{name}_label"], ds["bt"], weights, name=name, dim=name, dtype=np.float32):
            ds[da.name] = da
    return ds


def to_port(jds):
    """A JAX Dataset as the port's, every array copied."""
    out = tnc.Dataset(coords={k: np.copy(v) for k, v in jds.coords.items()},
                      attrs=dict(jds.attrs))
    for k, v in jds.data_vars.items():
        out.data_vars[k] = tnc.DataArray(np.copy(v.values), coords=dict(v.coords),
                                         dims=v.dims, name=k, attrs=dict(v.attrs))
    return out


def to_jax(tds):
    out = jnc.Dataset(coords={k: np.copy(v) for k, v in tds.coords.items()},
                      attrs=dict(tds.attrs))
    for k, v in tds.data_vars.items():
        out.data_vars[k] = jnc.DataArray(np.copy(v.values), coords=dict(v.coords),
                                         dims=v.dims, name=k, attrs=dict(v.attrs))
    return out


@pytest.fixture(scope="module")
def scene():
    return storm_scene()


@pytest.fixture(scope="module")
def tables(scene):
    with np.errstate(all="ignore"):
        return reference_tables(scene)


def fields(seed, shape=SHAPE):
    """Auxiliary fields from a seed: CTT and CTH with uncertainties (a NaN
    patch, infinities), a flag field, and the six fluxes with their
    clear-sky counterparts and the TOA downwelling flux."""
    rng = np.random.default_rng(seed)
    out = {"ctt": rng.normal(225, 12, shape).astype(np.float32),
           "cth": rng.normal(11000, 1500, shape).astype(np.float32),
           "flag": rng.integers(0, 4, shape).astype(np.int8)}
    out["ctt"][2, 5:14, 3:12] = np.nan
    out["ctt"][4, 10, 31] = np.inf
    out["ctt_uncertainty"] = rng.uniform(0.5, 3, shape).astype(np.float32)
    out["cth_uncertainty"] = rng.uniform(100, 900, shape).astype(np.float32)
    for var in ("toa_swup", "toa_lwup", "boa_swdn", "boa_swup", "boa_lwdn", "boa_lwup"):
        out[var] = rng.uniform(50, 900, shape).astype(np.float32)
        out[f"{var}_clr"] = rng.uniform(50, 900, shape).astype(np.float32)
    out["toa_swdn"] = rng.uniform(800, 1300, shape).astype(np.float32)
    return out


def field_dataset(nc, values):
    ds = nc.Dataset()
    for k, v in values.items():
        attrs = {"long_name": k, "units": "W m-2", "standard_name": k, "valid_max": 1500.0}
        if k == "flag":
            attrs = {"flag_values": "0b 1b 2b 3b", "long_name": "flag"}
        ds[k] = nc.DataArray(v, dims=("t", "y", "x"), name=k, attrs=attrs)
    return ds


def test_scene_reaches_every_branch(tables):
    assert list(tables["core_anvil_index"].values) == [1, 2, 3, 3, 0, 5]
    assert list(tables.coords["anvil"]) == [1, 2, 3, 4, 5]
    assert tables["core_nan_flag"].values.any()
    assert np.isnan(tables["core_step_bt_mean"].values).any()


@pytest.mark.parametrize("uncertainty", [False, True])
@pytest.mark.parametrize("weights", ["hw", "thw", "ones"])
@pytest.mark.parametrize("budget", ["whole", "chunked"])
def test_weighted_label_stats(tables, uncertainty, weights, budget):
    """Per label of every family: the float64 mean, unbiased std, min and
    max over the finite pixels, with the uncertainties; (H, W) weights as
    the reference's (T, H, W) repeat; chunked as whole."""
    vals = fields(5)
    area = tables["area"].values
    w = {"hw": area, "thw": np.repeat(area[None], SHAPE[0], 0), "ones": np.ones(SHAPE)}[weights]
    jf, tf = field_dataset(jnc, vals), field_dataset(tnc, vals)
    for dim, name in (("core", "core"), ("anvil", "thick_anvil"), ("core_step", "core_step")):
        index = np.r_[tables.coords[dim], 99]  # a label without pixels
        for var in ("ctt", "cth"):
            with _quiet():
                want = jpost.weighted_label_stats(tables[f"{name}_label"], w, jf, var, index,
                                                  dim, name, uncertainty=uncertainty)
            got = postprocess.weighted_label_stats(
                torch.as_tensor(tables[f"{name}_label"].values), torch.as_tensor(w), tf, var,
                index, dim, name, uncertainty=uncertainty,
                budget_bytes=None if budget == "whole" else CHUNKED)
            assert [a.name for a in want] == [b.name for b in got]
            for a, b in zip(want, got):
                assert a.dims == b.dims
                same(a.values, b.values, a.name)


def test_weighted_label_stats_traps():
    """One label per trap, against the reference: one finite pixel (std
    NaN), every weight zero, every value NaN, the minimum on a zero-weight
    pixel, tied extrema with different errors (the first in raster order),
    a NaN weight."""
    lab = np.zeros((2, 4, 5), np.int32)
    x = np.full(lab.shape, 230.0, np.float32)
    e = np.arange(lab.size, dtype=np.float32).reshape(lab.shape) / 10
    w = np.ones(lab.shape[1:])
    lab[0, 0, 0], lab[0, 0, 1] = 1, 1  # one finite pixel
    x[0, 0, 1] = np.nan
    lab[0, 1, :2] = 2  # zero weights
    w[1, :2] = 0.0
    lab[0, 2, :3] = 3  # all NaN
    x[0, 2, :3] = np.nan
    lab[1, 0, :4] = 4  # min at a zero-weight pixel, ties
    x[1, 0, :4] = [231.0, 229.0, 229.0, 231.0]
    w[0, 1] = 0.0
    lab[1, 3, :4] = 5  # a NaN weight
    w[3, 2] = np.nan
    jds, tds = jnc.Dataset(), tnc.Dataset()
    for ds, nc in ((jds, jnc), (tds, tnc)):
        ds["v"] = nc.DataArray(x, dims=("t", "y", "x"))
        ds["v_uncertainty"] = nc.DataArray(e, dims=("t", "y", "x"))
    index = np.arange(1, 6)
    with _quiet():
        want = jpost.weighted_label_stats(lab, w, jds, "v", index, "core", uncertainty=True)
    got = postprocess.weighted_label_stats(torch.as_tensor(lab), w, tds, "v", index, "core",
                                           uncertainty=True)
    for a, b in zip(want, got):
        same(a.values, b.values, a.name)
    std, low, min_error = got[1].values, got[2].values, got[6].values
    assert np.isnan(std[0]) and np.isnan(got[0].values[1:3]).all()
    assert low[3] == 229.0 and min_error[3] == e[1, 0, 1]


@pytest.mark.parametrize("budget", ["whole", "chunked"])
def test_weighted_proportions(tables, budget):
    vals = fields(6)
    area = tables["area"].values.copy()
    area[3, 4] = np.nan
    for dim, name in (("core", "core"), ("anvil", "thin_anvil"), ("thick_anvil_step",
                                                                  "thick_anvil_step")):
        for index in (tables.coords[dim], tables.coords[dim][:1], None):
            want = jpost.get_weighted_proportions_da(
                field_dataset(jnc, vals)["flag"], area, tables[f"{name}_label"], dim, name,
                index=index)
            got = postprocess.get_weighted_proportions_da(
                field_dataset(tnc, vals)["flag"], area,
                torch.as_tensor(tables[f"{name}_label"].values), dim, name, index=index,
                budget_bytes=None if budget == "whole" else CHUNKED)
            assert (want.name, want.dims) == (got.name, got.dims)
            same(want.values, got.values, want.name)
            for k in want.coords:
                same(want.coords[k], got.coords[k], k)


@pytest.mark.parametrize("budget", ["whole", "chunked"])
def test_get_label_stats(tables, budget):
    """Coverage and distinct labels per pixel (over row blocks) and per
    frame (over time chunks), equal to the reference's; under the forced
    budget each pass runs in at least 3 chunks."""
    for name in ("core_label", "thin_anvil_label", "core_step_label"):
        want, got = jnc.Dataset(), tnc.Dataset()
        janalysis.get_label_stats(tables[name], want)
        stats_log = {}
        with port_device.stage("label_stats", stats_log, torch.device("cpu")):
            analysis.get_label_stats(
                tnc.DataArray(torch.as_tensor(tables[name].values), dims=("t", "y", "x"),
                              name=name, attrs=dict(tables[name].attrs)), got,
                None if budget == "whole" else CHUNKED)
        compare_datasets(want, got, rtol32=0.0, rtol64=0.0)
        if budget == "chunked":
            assert stats_log["label_stats_chunks"] >= 3


@pytest.mark.parametrize("nan", [False, True])
def test_bulk_spatial_temporal_stats(tables, nan):
    """``np.median`` (NaN with a NaN, the two middles averaged) for the
    bulk median, ``nanmedian`` for the spatial and temporal ones, cast to
    the field's dtype."""
    bt = tables["bt"].values.copy()
    if not nan:
        bt = np.where(np.isnan(bt), 250.0, bt).astype(np.float32)
    bt[:, 0, :3] = np.nan  # a pixel's whole series, for the temporal stats
    for name in ("get_bulk_stats", "get_spatial_stats", "get_temporal_stats"):
        want, got = jnc.Dataset(), tnc.Dataset()
        with _quiet():
            getattr(jschema, name)(want, jnc.DataArray(bt, dims=("t", "y", "x"), name="bt",
                                                       attrs={"long_name": "BT", "units": "K"}))
        getattr(tschema, name)(got, tnc.DataArray(torch.as_tensor(bt), dims=("t", "y", "x"),
                                                  name="bt", attrs={"long_name": "BT",
                                                                    "units": "K"}))
        compare_datasets(want, got)
    even = np.array([[[1.0, 2.0], [4.0, 8.0]]], np.float32)
    got = tnc.Dataset()
    tschema.get_bulk_stats(got, tnc.DataArray(torch.as_tensor(even), dims=("t", "y", "x"),
                                              name="v"))
    assert got["v_median"].values == np.float32(3.0)


def test_cre(scene):
    vals = fields(8)
    want = jpost.add_cre_to_dataset(field_dataset(jnc, vals))
    got = postprocess.add_cre_to_dataset(field_dataset(tnc, {k: torch.as_tensor(v)
                                                             for k, v in vals.items()}))
    compare_datasets(want, got.load(), rtol32=0.0)


def _process(ds, module, **kw):
    ds = module.process_core_properties(ds, **kw)
    ds = module.process_thick_anvil_properties(ds, **kw)
    ds = module.process_thin_anvil_properties(ds, **kw)
    return module.add_validity_flags(ds, **kw)


@pytest.mark.parametrize("with_fields", [False, True])
def test_process_properties_and_flags(tables, with_fields):
    """The per-object properties, rates and validity flags of every
    family, from the reference's step tables (with CTT and CTH per-step
    statistics and uncertainties added), equal to the reference's; thin
    anvils carry no propagation variables."""
    jds, tds = to_jax(to_port(tables)), to_port(tables)
    if with_fields:
        vals = fields(9)
        w = tables["area"].values
        for var in ("ctt", "cth"):
            for dim, name in (("core", "core"), ("anvil", "thick_anvil"),
                              ("anvil", "thin_anvil"), ("core_step", "core_step"),
                              ("thick_anvil_step", "thick_anvil_step"),
                              ("thin_anvil_step", "thin_anvil_step")):
                with _quiet():
                    jpost.add_weighted_stats_to_dataset(jds, field_dataset(jnc, vals), w, var,
                                                        dim, dim_name=name)
                postprocess.add_weighted_stats_to_dataset(tds, field_dataset(tnc, vals), w,
                                                          var, dim, dim_name=name)
    with _quiet():
        want = _process(jds, jpost)
    got = _process(tds, postprocess, device="cpu")
    compare_datasets(want, got)
    assert list(want.data_vars) == list(got.data_vars)
    assert "core_propagation_speed" in got and "anvil_propagation_speed" in got
    assert not any(k.startswith("thin_anvil_propagation") for k in got.data_vars)
    assert got["core_is_valid"].values.any() and got["thick_anvil_is_valid"].values.dtype == bool


def test_validity_flags_lookup_quirk_and_in_place(tables):
    """An anvil whose initial core is 0 takes, as in the reference, the end
    and start times of the smallest core (``_lookup`` defaults only
    floats); ``add_validity_flags`` zeroes ``core_anvil_index`` in place
    for cores whose anvil is gone."""
    keys = np.array([3, 5], np.int32)
    times = np.datetime64("2020-06-01", "ns") + np.array([10, 20]) * STEP
    assert postprocess._lookup(times, keys, np.array([0]), default=np.datetime64("NaT"))[0] \
        == times[0] == jpost._lookup(times, keys, np.array([0]), default=np.datetime64("NaT"))[0]
    assert np.isnan(postprocess._lookup(np.array([1.0, 2.0]), keys, np.array([0]))[0])

    keep = tables.coords["anvil"][tables.coords["anvil"] != 3]  # cores 3, 4 lose theirs
    jds, tds = to_jax(to_port(tables)).sel(anvil=keep), to_port(tables).sel(anvil=keep)
    held_j, held_t = jds["core_anvil_index"].values, tds["core_anvil_index"].values
    with _quiet():
        jds = _process(jds, jpost)
    tds = _process(tds, postprocess, device="cpu")
    compare_datasets(jds, tds)
    assert list(held_t) == list(held_j) == [1, 2, 0, 0, 0, 5]
    assert tds["core_anvil_removed"].values.tolist() == [False, False, True, True, False, False]
    # anvil 4 has no core: its initial core is 0 and its times are core 1's
    assert tds["anvil_initial_core_index"].values[2] == 0


def test_filters(tables):
    """``remove_orphan_coords``, ``filter_cores`` (the BT change first step
    minus last in table order, gaps, lifetimes, areas, NaN) and
    ``filter_anvils`` (a core each, lifetimes, areas, end times with NaT
    masked) against the reference; steps shuffled in table order."""
    base = to_port(tables)
    order = np.random.default_rng(4).permutation(base.coords["core_step"].size)
    shuffled = base.isel(core_step=order)
    kept = []
    for ds in (base, shuffled):
        with _quiet():
            want = jpost.process_core_properties(jfilters.filter_cores(
                jfilters.remove_orphan_coords(to_jax(ds))))
            want = jfilters.filter_anvils(want)
        got = postprocess.process_core_properties(filters.filter_cores(
            filters.remove_orphan_coords(to_port(ds)), device="cpu"), device="cpu")
        got = filters.filter_anvils(got, device="cpu")
        compare_datasets(want, got)
        kept.append((got.coords["core"].tolist(), got.coords["anvil"].size))
    assert 0 < len(kept[0][0]) < base.coords["core"].size and kept[0][1] > 0
    assert kept[1][0] != kept[0][0]
    # NaT core end times compare false, as numpy's
    ds = postprocess.process_core_properties(filters.filter_cores(to_port(tables),
                                                                  device="cpu"), device="cpu")
    ds["core_end_t"].values[:] = np.datetime64("NaT")
    jds = to_jax(ds)
    with _quiet():
        want = jfilters.filter_anvils(jds)
    got = filters.filter_anvils(ds, device="cpu")
    same(want.coords["anvil"], got.coords["anvil"])
    for gap, life in ((timedelta(minutes=30), timedelta(minutes=5)),
                      (timedelta(minutes=5), timedelta(minutes=40))):
        want = jfilters.filter_cores(to_jax(to_port(tables)), max_time_gap=gap,
                                     min_lifetime=life)
        got = filters.filter_cores(to_port(tables), max_time_gap=gap, min_lifetime=life,
                                   device="cpu")
        same(want.coords["core"], got.coords["core"])


@pytest.mark.parametrize("entry", ["filter_cores", "process_core_properties",
                                   "add_validity_flags"])
def test_entry_points_run_on_cuda_by_default(tables, entry):
    """Without ``device`` the per-object entry points ask for CUDA, and
    raise where it is not available rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    call = {"filter_cores": filters.filter_cores,
            "process_core_properties": postprocess.process_core_properties,
            "add_validity_flags": postprocess.add_validity_flags}[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call(to_port(tables))
