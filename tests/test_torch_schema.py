"""The port's output stages of ``run_detection`` against the JAX
package's, teacher-forced: the same label volumes and fields, made from a
numpy seed, go through the reference's schema (in ``cli/common.py``'s
order), ``calculate_label_properties``, ``get_label_stats`` and
``weighted_statistics_on_labels``, and through the port's
``cli.common.prepare_output`` on the CPU.

The scene holds cores inside anvils, a core tied between two anvils
(``_find_max_overlap`` takes the smaller), a core under ``atol`` pixels of
anvil and one outside every anvil, an anvil only in the thin volume,
labels on each edge of the frame, a NaN patch in WVD that covers one core
whole, and a time gap over 900 s.  The second case adds a pixel-area
field with zero and NaN pixels and latitude and longitude, and start and
end dates inside the window.

Every variable and coordinate must match in name, dims, dtype and attrs.
Integers, bools, times, durations, maxima and minima must be identical;
float64 sums and means agree to rtol 1e-12; float32 field means and stds
to rtol 1e-5 (the reference sums them in float32 with numpy's pairwise
summation, the port in float64).  With a float32 area the reference's
area sums and lat/lon means are float32 sums too, held to rtol 1e-5.
"""

from datetime import datetime
from functools import partial

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from chip_smoke import compare_datasets  # noqa: E402
from tobac_flow_tpu import schema as jschema  # noqa: E402
from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu.detect.analysis import (  # noqa: E402
    get_label_stats as jax_label_stats,
    weighted_statistics_on_labels as jax_weighted_stats,
)
from tobac_flow_tpu.schema.dataset import _find_max_overlap  # noqa: E402
from tobac_flow_tpu.utils.labels import apply_func_to_labels, labeled_comprehension  # noqa: E402
from tobac_flow_tpu.utils.stats import find_overlap_mode as jax_overlap_mode  # noqa: E402
from tobac_flow_tpu_torch.cli.common import DetectionOptions, prepare_output  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402
from tobac_flow_tpu_torch.utils.labels import unique_labels  # noqa: E402
from tobac_flow_tpu_torch.utils.stats import find_overlap_mode, n_unique_along_axis  # noqa: E402

SHAPE = (6, 24, 32)
LABELS = ("core_label", "thick_anvil_label", "thin_anvil_label")
# variables that the reference sums in float32 when the area is float32
AREA_SUMS = ("core_total_area", "thick_anvil_total_area", "thin_anvil_total_area",
             "core_step_area", "thick_anvil_step_area", "thin_anvil_step_area",
             "core_max_area", "thick_anvil_max_area", "thin_anvil_max_area",
             "core_step_lat", "core_step_lon", "thick_anvil_step_lat",
             "thick_anvil_step_lon", "thin_anvil_step_lat", "thin_anvil_step_lon",
             "core_start_lat", "core_start_lon", "anvil_start_lat", "anvil_start_lon")


def _box(vol, label, frames, ys, xs):
    vol[frames[0]:frames[1], ys[0]:ys[1], xs[0]:xs[1]] = label


def _scene(with_area):
    rng = np.random.default_rng(5)
    t, h, w = SHAPE
    thick = np.zeros(SHAPE, np.int32)
    _box(thick, 1, (0, 4), (2, 10), (6, 16))  # holds core 1
    _box(thick, 2, (1, 6), (12, 20), (0, 8))  # on the left edge
    _box(thick, 3, (1, 6), (12, 20), (8, 14))  # core 2 ties between 2 and 3
    _box(thick, 4, (2, 6), (16, 24), (20, 32))  # bottom and right edges
    thin = thick.copy()
    grow = (thin == 0) & (np.roll(thick, 1, axis=2) == 1)
    thin[grow] = 1
    _box(thin, 5, (3, 6), (0, 3), (22, 28))  # only thin; top edge
    core = np.zeros(SHAPE, np.int32)
    _box(core, 1, (0, 3), (4, 7), (8, 12))
    _box(core, 2, (2, 4), (14, 17), (6, 10))  # 3 px wide: 6 px in anvil 2, 6 in 3
    _box(core, 3, (2, 3), (17, 19), (22, 24))  # 4 px of anvil 4 < atol
    _box(core, 4, (0, 2), (21, 23), (10, 13))  # outside every anvil
    _box(core, 5, (4, 6), (6, 8), (26, 28))  # all-NaN in WVD
    bt = rng.normal(230, 15, SHAPE).astype(np.float32)
    wvd = rng.normal(-2, 3, SHAPE).astype(np.float32)
    swd = rng.normal(1, 2, SHAPE).astype(np.float32)
    wvd[4:6, 5:9, 25:29] = np.nan  # covers core 5 whole
    times = (np.datetime64("2020-06-01T00:00", "ns")
             + np.array([0, 5, 10, 15, 35, 40]) * np.timedelta64(60, "s"))
    extra = {}
    if with_area:
        area = rng.uniform(3.5, 4.5, SHAPE[1:]).astype(np.float32)
        area[4:7, 8:12] = 0.0  # core 1 whole at zero weight
        area[13, 2] = np.nan
        extra = {"area": area,
                 "lat": np.linspace(20, 30, h * w).reshape(h, w).astype(np.float32),
                 "lon": np.linspace(-100, -90, h * w).reshape(w, h).T.astype(np.float32)}
    return dict(core_label=core, thick_anvil_label=thick, thin_anvil_label=thin, bt=bt,
                wvd=wvd, swd=swd, times=times, **extra)


def _dataset(nc, scene):
    coords = {"t": scene["times"], "y": np.arange(SHAPE[1]) * 2000.0,
              "x": np.arange(SHAPE[2]) * 2000.0}
    ds = nc.Dataset(coords=coords)
    for name in LABELS:
        ds[name] = nc.DataArray(scene[name].copy(), dims=("t", "y", "x"),
                                attrs={"long_name": name, "units": ""})
    for name in ("area", "lat", "lon"):
        if name in scene:
            ds[name] = nc.DataArray(scene[name], dims=("y", "x"),
                                    attrs={"long_name": name, "units": ""})
    fields = [nc.DataArray(scene[n], coords=coords, dims=("t", "y", "x"), name=n,
                           attrs={"long_name": n, "units": "K"})
              for n in ("bt", "wvd", "swd")]
    return ds, fields


def _reference(scene, start, end):
    """The reference's output stages, as ``cli/common.run_detection`` runs
    them (with ``save_spatial_props``)."""
    ds, (bt, wvd, swd) = _dataset(jnc, scene)
    ds = jschema.add_label_coords(ds)
    jschema.link_cores_and_anvils(ds)
    jschema.add_step_labels(ds)
    ds = jschema.add_label_coords(ds)
    jschema.link_step_labels(ds)
    jschema.flag_edge_labels(ds, start, end)
    jschema.flag_nan_adjacent_labels(ds, wvd)
    jschema.calculate_label_properties(ds)
    for name in LABELS:
        jax_label_stats(ds[name], ds)
    weights = (np.broadcast_to(ds["area"].values[np.newaxis], SHAPE) if "area" in ds
               else np.broadcast_to(np.ones((), np.float32), SHAPE))
    for field in (bt, wvd, swd):
        for label, name, dim in [
            ("core_label", "core", "core"), ("thick_anvil_label", "thick_anvil", "anvil"),
            ("thin_anvil_label", "thin_anvil", "anvil"),
            ("core_step_label", "core_step", "core_step"),
            ("thick_anvil_step_label", "thick_anvil_step", "thick_anvil_step"),
            ("thin_anvil_step_label", "thin_anvil_step", "thin_anvil_step"),
        ]:
            for da in jax_weighted_stats(ds[label], field, weights, name=name, dim=dim,
                                         dtype=np.float32):
                ds[da.name] = da
    return ds


CASES = {
    "no_area": (False, None, None),
    "area_latlon_dates": (True, datetime(2020, 6, 1, 0, 7), datetime(2020, 6, 1, 0, 37)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    with_area, start, end = CASES[request.param]
    scene = _scene(with_area)
    with np.errstate(all="ignore"):
        want = _reference(scene, start, end)
    ds, fields = _dataset(tnc, scene)
    got = prepare_output(ds, *fields, start, end,
                         DetectionOptions(save_spatial_props=True), device="cpu")
    return request.param, scene, want, got


def test_output_stages_match_reference(pair):
    case, _, want, got = pair
    worst = compare_datasets(want, got, loose=AREA_SUMS if case != "no_area" else ())
    print(f"{case}: largest relative error of the float32 means and stds {worst:.3g}")


def test_scene_reaches_every_branch(pair):
    """The cases hold what the scene is built for."""
    case, scene, want, _ = pair
    assert list(want["core_anvil_index"].values) == [1, 2, 0, 0, 0]
    assert (want["anvil_core_count"].values > 0).sum() == 2
    # cores are painted into both anvil volumes
    for name in ("thick_anvil_label", "thin_anvil_label"):
        painted = want[name].values != scene[name]
        assert painted.any() and (want[name].values[painted] > 0).all()
    assert list(want.coords["anvil"]) == [1, 2, 3, 4, 5]
    assert np.isnat(want["thick_anvil_start_t"].values[-1])
    assert want["core_nan_flag"].values[4]
    assert list(want["thin_anvil_edge_label_flag"].values) == [False, True, False, True, True]
    assert np.isnan(want["core_wvd_mean"].values[4])
    for flag in ("core_start_label_flag", "core_end_label_flag"):
        assert 0 < want[flag].values.sum() < 5
    if case != "no_area":
        assert np.isnan(want["core_bt_mean"].values[0])  # zero weight
        assert np.isnan(want["thick_anvil_step_x"].values).any()  # a NaN area pixel


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_overlap_mode_ties(seed):
    """The pair-mode reduction against the reference's per-label functions
    on volumes full of ties (a few values, few pixels a label): the step
    link's mode (``find_overlap_mode``) and the core link's
    (``_find_max_overlap``, whose ``atol`` is ``min_count``; 9 here, so
    that some labels' modes reach it and some do not)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 12, (3, 9, 11)).astype(np.int32)
    other = rng.integers(0, 3 + seed, labels.shape).astype(np.int32)
    index = np.arange(1, 15)  # 12..14 are absent: the background
    want = apply_func_to_labels(labels, other, func=jax_overlap_mode, index=index, default=0)
    got = find_overlap_mode(torch.from_numpy(labels), torch.from_numpy(other), index)
    assert np.array_equal(want, got)
    want = labeled_comprehension(
        other.ravel(), labels.ravel(),
        partial(_find_max_overlap, atol=9, max_label=int(labels.max())),
        index=index, dtype=np.int64, default=0,
    )
    got = find_overlap_mode(torch.from_numpy(labels), torch.from_numpy(other), index,
                            min_count=9)
    assert np.array_equal(want, got) and 0 < (got > 0).sum() < 12


def test_unique_labels_and_n_unique_along_axis():
    from tobac_flow_tpu.utils.labels import unique_labels as jax_unique
    from tobac_flow_tpu.utils.stats import n_unique_along_axis as jax_n_unique

    rng = np.random.default_rng(3)
    a = rng.integers(0, 6, (5, 7, 9)).astype(np.int32)
    assert np.array_equal(jax_unique(a), unique_labels(torch.from_numpy(a)))
    assert unique_labels(torch.from_numpy(a)).dtype == np.int32
    for axis in (0, 1, 2):
        want = jax_n_unique(a, axis)
        assert np.array_equal(want, n_unique_along_axis(torch.from_numpy(a), axis).numpy())
