"""The port's validation against GLM lightning (``validate/validation.py``)
and its exact distance transform (``ops.morphology.distance_transform_edt``)
against the JAX package's, on the CPU.

The inputs are made from a numpy seed: random masks for the transform
(2D and 3D, unit, per-frame, non-integer and integer spacings, a mask
without a zero pixel, one of all zeros, a row without a zero), and a
storm scene for validation (cores under thick anvils, an anvil without a
core, an object at the domain's edge, flashes on and near the objects and
false flashes elsewhere, a frame without flashes and a 25-minute gap).
The port runs with ``device="cpu"``; the marker distances and the
per-object passes also under ``device.frames_budget``, which puts them
into at least 3 time chunks.  Tolerance: none.  The distances are equal
bit for bit, POD, FAR and the counts exactly, with the reference's types.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu.ops.morphology import distance_transform_edt as jax_edt  # noqa: E402
from tobac_flow_tpu.validate import validation as jval  # noqa: E402
from tobac_flow_tpu_torch import device as port_device  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402
from tobac_flow_tpu_torch.ops.morphology import distance_transform_edt  # noqa: E402
from tobac_flow_tpu_torch.validate import validation as tval  # noqa: E402

CHUNKED = port_device.frames_budget(4)  # 12 frames: at least 3 chunks of every pass
SHAPE = (12, 40, 56)
STEP = np.timedelta64(300, "s")


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.view(np.int64).tolist() if a.dtype == np.float64 else a.tolist()


def _mask(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "sparse":
        return rng.random(shape) > 0.02
    if kind == "dense":
        return rng.random(shape) > 0.4
    if kind == "no_zero":
        return np.ones(shape, bool)
    if kind == "all_zero":
        return np.zeros(shape, bool)
    mask = rng.random(shape) > 0.05  # "row": a whole row without a zero
    mask[..., 3, :] = True
    return mask


SAMPLINGS = {"none": None, "frames": (1e9, 1.0, 1.0), "spacing": (1.7, 0.35, 1.3),
             "integer": (2.0, 3.0, 1.0)}


@pytest.mark.parametrize("kind", ["sparse", "dense", "no_zero", "all_zero", "row"])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("shape", [(23, 31), (5, 17, 26)], ids=["2d", "3d"])
def test_distance_transform_bit_equal(shape, sampling, kind):
    samp = SAMPLINGS[sampling]
    if samp is not None:
        samp = samp[-len(shape):]
    mask = _mask(shape, kind)
    want = jax_edt(mask, sampling=samp)
    got = distance_transform_edt(torch.from_numpy(mask), sampling=samp)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert _bits(got.numpy()) == _bits(want)
    if kind == "no_zero":
        assert (want == 1e15).all()


def test_distance_transform_of_labels_and_dataarray():
    """Any nonzero value is a non-zero pixel (labels, NaN), and a DataArray
    gives its data's transform."""
    vals = np.zeros((9, 12), np.float32)
    vals[2, 3], vals[7, 9], vals[4, 4] = 3.0, np.nan, -1.0
    want = jax_edt(vals == 0)
    got = distance_transform_edt(tnc.DataArray(torch.from_numpy(vals == 0), dims=("y", "x")))
    assert _bits(got.numpy()) == _bits(want)


def storm_scene(seed=0):
    """(times, core labels, thick anvil labels, thin anvil labels, anvil
    marker labels, int32 flash grid) of the validation scene."""
    rng = np.random.default_rng(seed)
    t, h, w = SHAPE
    times = np.datetime64("2020-06-01T12:00", "ns") + np.arange(t) * STEP
    times[8:] += np.timedelta64(1200, "s")  # a 25-minute gap after frame 7
    cores = np.zeros(SHAPE, np.int32)
    thick = np.zeros(SHAPE, np.int32)
    for k, (t0, t1, y, x) in enumerate([(1, 8, 10, 12), (3, 11, 24, 30), (5, 10, 8, 40)], 1):
        for i in range(t0, t1):
            cores[i, y:y + 4, x + i // 3:x + i // 3 + 4] = k
            thick[i, y - 4:y + 8, x + i // 3 - 4:x + i // 3 + 8] = k
    thick[2:6, 30:36, 2:10] = 4  # an anvil without a core
    cores[4:9, 0:3, 50:56] = 4  # a core at the domain's edge
    cores[2:7, 33:37, 44:48] = 5  # a core without flashes
    thin = np.where(thick > 0, thick, 0)
    thin[1:11, 20:23, 20:40] = np.where(thin[1:11, 20:23, 20:40] > 0,
                                        thin[1:11, 20:23, 20:40], 2)
    markers = np.where(cores > 0, thick, 0)
    glm = np.zeros(SHAPE, np.int32)
    for i in range(t):
        on = np.argwhere((cores[i] > 0) & (cores[i] < 4))
        if on.size and i != 6:  # no flash in frame 6
            for y, x in on[rng.integers(0, len(on), 3)]:
                glm[i, y, x] += rng.integers(1, 4)
        for _ in range(2):  # false flashes
            glm[i, rng.integers(0, h), rng.integers(0, w)] += 1
    glm[6] = 0
    return times, cores, thick, thin, markers, glm


@pytest.fixture(scope="module")
def scene():
    return storm_scene()


@pytest.mark.parametrize("how", ["whole", "chunked"])
def test_marker_distances(scene, how):
    _, cores, thick, *_ = scene
    budget = CHUNKED if how == "chunked" else None
    for labels in (cores, thick):
        for reach in (0, 1, 3):
            want = jval.get_marker_distance(labels, time_range=reach)
            got = tval.get_marker_distance(labels, reach, device="cpu", budget_bytes=budget)
            assert _bits(got.numpy()) == _bits(want)
            assert np.isfinite(want).any() and (reach or np.isinf(want).any())
        want = jval.get_marker_distance_cylinder(labels, time_margin=2)
        got = tval.get_marker_distance_cylinder(labels, 2, device="cpu", budget_bytes=budget)
        assert _bits(got.numpy()) == _bits(want)
        want = jval.get_marker_distance_ellipse(labels, time_margin=2, aspect=1.7)
        got = tval.get_marker_distance_ellipse(labels, 2, 1.7, device="cpu",
                                               budget_bytes=budget)
        assert _bits(got.numpy()) == _bits(want)


def test_marker_distance_chunks():
    """A forced budget runs the marker distance in at least 3 chunks (with
    its halos, a 4-frame chunk of a 3-frame margin reads 10 of the 12
    frames, which fit the budget whole: the chunks show at a 1-frame
    margin)."""
    plans = []
    port_device._PLANS.append(plans)
    try:
        tval.get_marker_distance(np.ones(SHAPE, np.int32), 1, device="cpu",
                                 budget_bytes=CHUNKED)
    finally:
        port_device._PLANS.remove(plans)
    assert [(w, t, c) for w, t, c in plans] == [("marker_distance", 12, 4)]


def _result(out):
    md, fd, *scores = out
    return _bits(np.asarray(md)), _bits(np.asarray(fd)), scores, [type(s) for s in scores]


@pytest.mark.parametrize("grid", ["int32", "float32", "none"])
@pytest.mark.parametrize("how", ["whole", "chunked"])
def test_validate_markers(scene, grid, how):
    times, cores, thick, *_, glm = scene
    if grid == "float32":
        glm = glm.astype(np.float32)
        glm[3, 0, 0] = np.nan  # a missing value read from a file
    elif grid == "none":
        glm = np.zeros_like(glm)
    budget = CHUNKED if how == "chunked" else None
    fars = []
    for labels, margin, time_margin in ((cores, 10, 3), (cores, 3, 1), (thick, 4, 1)):
        edge = jval.get_edge_filter(SHAPE, times, margin=3)
        want = jval.validate_markers(labels, glm, None, edge, margin=margin,
                                     time_margin=time_margin)
        got = tval.validate_markers(labels, glm, "ignored", torch.from_numpy(edge),
                                    margin=margin, time_margin=time_margin, device="cpu",
                                    budget_bytes=budget)
        assert _result(got) == _result(want)
        if grid == "none":
            assert np.isnan(want[2]) and want[5] == 0
        else:
            assert 0 < want[2] <= 1 and 0 <= want[3] < 1
            fars.append(want[3])
    assert grid == "none" or max(fars) > 0
    given = tval.validate_markers(cores, glm, None, edge, n_glm_in_margin=7, device="cpu")
    assert _result(given) == _result(jval.validate_markers(cores, glm, None, edge, 7))


@pytest.mark.parametrize("case", ["gaps", "margin0", "cover", "dataset"])
def test_edge_filter(scene, case):
    times, cores, *_ = scene
    cover = np.random.default_rng(3).random(SHAPE[1:]) > 0.3
    if case == "gaps":
        want = jval.get_edge_filter(SHAPE, times, margin=4, max_time_gap=900)
        got = tval.get_edge_filter(SHAPE, times, margin=4, max_time_gap=900, device="cpu")
        assert not want[7].any() and not want[8].any() and want[5].any()
    elif case == "margin0":
        want = jval.get_edge_filter(SHAPE, margin=0)
        got = tval.get_edge_filter(SHAPE, margin=0, device="cpu")
        assert not want.any()
    elif case == "cover":
        want = jval.get_edge_filter(SHAPE, times, margin=2, glm_cover=cover)
        got = tval.get_edge_filter(SHAPE, times, margin=2, glm_cover=cover, device="cpu")
    else:
        want = jval.get_edge_filter(_dataset(jnc, scene), margin=5)
        got = tval.get_edge_filter(_dataset(tnc, scene), margin=5, device="cpu")
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def _dataset(nc, scene, markers=True, index=True):
    times, cores, thick, thin, anvil_markers, _ = scene
    n_core, n_anvil = int(cores.max()), int(thick.max())
    ds = nc.Dataset(coords={"t": times, "core": np.arange(1, n_core + 2),
                            "anvil": np.arange(1, n_anvil + 1)})
    for name, vol in (("core_label", cores), ("thick_anvil_label", thick),
                      ("thin_anvil_label", thin)):
        ds[name] = nc.DataArray(vol.copy(), dims=("t", "y", "x"))
    if markers:
        ds["anvil_marker_label"] = nc.DataArray(anvil_markers.copy(), dims=("t", "y", "x"))
    if index:
        ds["core_anvil_index"] = nc.DataArray(np.array([1, 2, 3, 0, 0, 0], np.int32),
                                              dims=("core",))
    return ds


ENTRY_POINTS = {
    "cores": (lambda v, ds, g, **k: v.validate_cores(ds, g, margin=5, time_margin=2, **k)),
    "thick_anvils": (lambda v, ds, g, **k: v.validate_anvils(ds, g, margin=5, **k)),
    "thin_anvils": (lambda v, ds, g, **k: v.validate_anvils(ds, g, time_margin=1, thick=False,
                                                            **k)),
    "cores_with_anvils": (lambda v, ds, g, **k: v.validate_cores_with_anvils(ds, g, margin=6,
                                                                             **k)),
    "anvils_with_cores": (lambda v, ds, g, **k: v.validate_anvils_with_cores(ds, g, **k)),
    "anvil_markers": (lambda v, ds, g, **k: v.validate_anvil_markers(ds, g, margin=4, **k)),
}


@pytest.mark.parametrize("grid", ["int32", "float32"])
@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_dataset_entry_points(scene, entry, grid):
    """Each entry point returns the reference's (POD, FAR) and writes the
    same variables (values, dtypes, dims, attrs) and dataset attrs, whole
    and in forced chunks."""
    glm = scene[-1].astype(grid)
    fn = ENTRY_POINTS[entry]
    want_ds = _dataset(jnc, scene)
    want = fn(jval, want_ds, glm)
    for budget in (None, CHUNKED):
        got_ds = _dataset(tnc, scene)
        got = fn(tval, got_ds, glm, device="cpu", budget_bytes=budget)
        assert [type(x) for x in got] == [type(x) for x in want]
        assert np.array_equal(got, want, equal_nan=True), (got, want)
        assert got_ds.attrs == pytest.approx(want_ds.attrs, nan_ok=True, rel=0, abs=0)
        assert set(got_ds.data_vars) == set(want_ds.data_vars)
        for name, var in want_ds.data_vars.items():
            mine = got_ds[name]
            assert (mine.dims, mine.attrs, _bits(mine.values)) == (
                var.dims, var.attrs, _bits(var.values)), name
    if entry == "cores":
        assert np.isinf(want_ds["core_glm_distance"].values[-1])  # a label without pixels


def test_anvils_with_cores_without_index(scene):
    glm = scene[-1]
    want_ds, got_ds = _dataset(jnc, scene, index=False), _dataset(tnc, scene, index=False)
    want = jval.validate_anvils_with_cores(want_ds, glm)
    assert tval.validate_anvils_with_cores(got_ds, glm, device="cpu") == want
    assert got_ds.attrs == want_ds.attrs


def test_anvil_markers_need_their_labels(scene):
    ds = _dataset(tnc, scene, markers=False)
    with pytest.raises(KeyError, match="anvil_marker_label"):
        tval.validate_anvil_markers(ds, scene[-1], device="cpu")
    with pytest.raises(KeyError, match="anvil_marker_label"):
        jval.validate_anvil_markers(_dataset(jnc, scene, markers=False), scene[-1])


@pytest.mark.parametrize("index", ["present", "given"])
def test_min_dist_for_objects(scene, index):
    _, cores, *_ = scene
    grid = np.random.default_rng(5).random(SHAPE) * 50
    idx = None if index == "present" else np.array([2, 9, 1, 4])
    want = jval.get_min_dist_for_objects(grid, cores, idx)
    got = tval.get_min_dist_for_objects(grid, cores, idx, device="cpu", budget_bytes=CHUNKED)
    for a, b in zip(got, want):
        assert _bits(a) == _bits(b)


def test_entry_points_default_to_cuda(scene):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tval.validate_markers(scene[1], scene[-1], None, np.ones(SHAPE, bool))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tval.get_edge_filter(SHAPE)
    # a dataset read into numpy (as ``open_dataset`` gives it) goes to CUDA
    # too; one whose core labels are a CPU tensor stays on the CPU
    ds = _dataset(tnc, scene)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tval.get_edge_filter(ds)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tval.validate_cores(ds, scene[-1])
    ds["core_label"] = tnc.DataArray(torch.from_numpy(scene[1]), dims=("t", "y", "x"))
    assert tval.get_edge_filter(ds).device.type == "cpu"
