"""The port's GLM gridding (``data/glm.py``) against the JAX package's, on
the CPU: the parallax correction and scan angles (host float64, equal bit
for bit), ``regrid_glm``'s counts (equal), with flashes exactly on
interior edges, on the first and last edges, outside the grid, outside
the time bins, off the Earth's disk, and with y increasing or flipped;
and ``read_glm_flashes`` and ``create_gridded_flash_ds`` over LCFA-shaped
files that the test writes (through h5py, found offline by their
``_s<%Y%j%H%M%S>`` tokens).  The inputs are made from a numpy seed.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("h5py")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.data import abi as jabi  # noqa: E402
from tobac_flow_tpu.data import glm as jglm  # noqa: E402
from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu_torch.data import glm  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402

PROJECTION = {"semi_major_axis": 6378137.0, "semi_minor_axis": 6356752.31414,
              "perspective_point_height": 35786023.0, "longitude_of_projection_origin": -75.0}
T0 = np.datetime64("2020-06-01T12:00:00", "ns")
STEP = np.timedelta64(300, "s")


def grid_ds(nc, n_t=4, ny=30, nx=40, flip=True, origin=(0.02, 0.05)):
    """A fixed-grid dataset of ``nc``'s Dataset: scan angles 56 µrad
    apart, y decreasing (as ABI's) unless ``flip`` is false, ``n_t``
    time steps 5 minutes apart."""
    x = origin[0] + (np.arange(nx) - nx / 2) * 56e-6
    y = origin[1] + (np.arange(ny) - ny / 2) * 56e-6
    if flip:
        y = y[::-1].copy()
    ds = nc.Dataset(coords={"t": T0 + np.arange(n_t) * STEP, "y": y, "x": x})
    ds["goes_imager_projection"] = nc.DataArray(np.zeros((), np.int32), dims=(),
                                                attrs=dict(PROJECTION))
    return ds


def flashes(ds, n, seed=0, spill=3e-4):
    """``n`` seeded flashes over the grid of ``ds`` and ``spill`` radians
    past it, at times over its bins and a minute past them: (times, lats,
    lons)."""
    rng = np.random.default_rng(seed)
    x, y = ds.coords["x"], ds.coords["y"]
    xs = rng.uniform(x.min() - spill, x.max() + spill, n)
    ys = rng.uniform(y.min() - spill, y.max() + spill, n)
    lat, lon = jabi.ABIProjection(**PROJECTION).to_latlon(xs, ys)
    n_t = ds.coords["t"].size
    t0 = np.asarray(ds.coords["t"])[0]
    times = t0 - STEP / 2 + rng.integers(-60, n_t * 300 + 60, n).astype("timedelta64[s]")
    return times, lat, lon


def test_parallax_and_scan_angles():
    rng = np.random.default_rng(1)
    lat, lon = rng.uniform(-70, 70, 500), rng.uniform(-180, 40, 500)
    for sat_lon in (-75.0, -137.2):
        want = jglm.get_glm_parallax_offsets(lat, lon, sat_lon=sat_lon)
        got = glm.get_glm_parallax_offsets(lat, lon, sat_lon=sat_lon)
        assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(got, want))
    want_ds, got_ds = grid_ds(jnc), grid_ds(tnc)
    for name in ("get_corrected_glm_x_y", "get_uncorrected_glm_x_y"):
        want = getattr(jglm, name)(lat, lon, want_ds)
        got = getattr(glm, name)(lat, lon, got_ds)
        assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(got, want)), name
        assert np.isfinite(want[0]).any()


def _t_bins(ds):
    return glm._time_bins(np.asarray(ds.coords["t"]))


@pytest.mark.parametrize("flip", [True, False], ids=["y_flipped", "y_increasing"])
@pytest.mark.parametrize("parallax", [True, False], ids=["parallax", "no_parallax"])
def test_regrid_glm_counts(flip, parallax):
    want_ds, got_ds = grid_ds(jnc, flip=flip), grid_ds(tnc, flip=flip)
    times, lat, lon = flashes(want_ds, 3000, seed=int(flip) + 2 * int(parallax))
    lat[:5] = np.nan  # unreadable locations
    want = jglm.regrid_glm(times, lat, lon, want_ds, _t_bins(want_ds),
                           correct_parallax=parallax)
    got = glm.regrid_glm(times, lat, lon, got_ds, _t_bins(got_ds), correct_parallax=parallax,
                         device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < 3000 and (want.sum(axis=(1, 2)) > 0).all()


class _Flat:
    """A projection whose scan angles are the flashes' (lat, lon) as they
    are, to put flashes exactly on the bin edges."""
    lon0, h, req = -75.0, 42164160.0, 6378137.0

    def to_xy(self, lat, lon):
        return np.asarray(lon, np.float64), np.asarray(lat, np.float64)


@pytest.mark.parametrize("flip", [True, False], ids=["y_flipped", "y_increasing"])
def test_regrid_glm_edges(monkeypatch, flip):
    """Flashes exactly on interior edges go to the bin above, on the last
    edge to the last bin, on the first edge to the first; outside the
    edges, before the first time bin or at and after the last, they are
    dropped."""
    monkeypatch.setattr(jabi, "get_abi_proj", lambda ds: _Flat())
    monkeypatch.setattr(glm, "get_abi_proj", lambda ds: _Flat())
    want_ds, got_ds = grid_ds(jnc, ny=6, nx=8, flip=flip), grid_ds(tnc, ny=6, nx=8, flip=flip)
    x_edges = glm._edges(np.asarray(want_ds.coords["x"]))
    y_edges = np.sort(glm._edges(np.asarray(want_ds.coords["y"])))
    xs = np.concatenate([x_edges, x_edges[[0, -1]] + [-1e-9, 1e-9], x_edges[2:5]])
    ys = np.concatenate([y_edges[[1, 2, 3, 4, 5, 0, -1, 2, 3]], y_edges[[0, -1]]])
    xs, ys = np.meshgrid(xs, ys)
    t_bins = _t_bins(want_ds)
    times = np.stack([t_bins[0] - STEP, t_bins[0], t_bins[1], t_bins[2] + STEP / 3,
                      t_bins[-1], t_bins[-1] + STEP])
    n = xs.size
    times = np.repeat(times, n)
    lat, lon = np.tile(ys.ravel(), 6), np.tile(xs.ravel(), 6)
    want = jglm.regrid_glm(times, lat, lon, want_ds, t_bins, correct_parallax=False)
    got = glm.regrid_glm(times, lat, lon, got_ds, t_bins, correct_parallax=False, device="cpu")
    assert np.array_equal(got.numpy(), want)
    assert want[0].sum() > 0 and want[1].sum() == want[0].sum() < n


def test_regrid_glm_without_flashes():
    want_ds, got_ds = grid_ds(jnc), grid_ds(tnc)
    empty = (np.empty(0, "datetime64[ns]"), np.empty(0), np.empty(0))
    want = jglm.regrid_glm(*empty, want_ds, _t_bins(want_ds))
    got = glm.regrid_glm(*empty, got_ds, _t_bins(got_ds), device="cpu")
    assert got.shape == want.shape and not got.any() and got.dtype == torch.int32


def write_lcfa(directory, ds, seed=0, per_file=400, files=4):
    """LCFA-shaped files (flash lat, lon, energy and first-event times) of
    20 s each from the grid's first time, named with their ``_s`` and
    ``_e`` tokens, plus one unreadable file."""
    rng = np.random.default_rng(seed)
    times, lat, lon = flashes(ds, per_file * files, seed)
    start = np.asarray(ds.coords["t"])[0].astype("datetime64[ns]")
    for k in range(files):
        sl = slice(k * per_file, (k + 1) * per_file)
        s = start + k * np.timedelta64(80, "s")
        stamp = np.datetime_as_string(s, unit="s").replace("-", "").replace(":", "")
        tok = f"{stamp[:4]}{(s.astype('datetime64[D]') - s.astype('datetime64[Y]')).astype(int) + 1:03d}{stamp[9:15]}0"
        out = jnc.Dataset()
        out["flash_lat"] = jnc.DataArray(lat[sl].astype(np.float32), dims=("flash",))
        out["flash_lon"] = jnc.DataArray(lon[sl].astype(np.float32), dims=("flash",))
        if k != 2:  # one file without energies
            out["flash_energy"] = jnc.DataArray(rng.uniform(1e-15, 1e-13, per_file)
                                                .astype(np.float32), dims=("flash",))
        out["flash_time_offset_of_first_event"] = jnc.DataArray(times[sl], dims=("flash",))
        out.to_netcdf(str(directory / f"OR_GLM-L2-LCFA_G16_s{tok}_e{tok}_c{tok}.nc"))
    bad = directory / f"OR_GLM-L2-LCFA_G16_s{tok[:-3]}5000_e0_c0.nc"
    bad.write_bytes(b"not a netCDF file")


def test_read_and_grid_lcfa_files(tmp_path, monkeypatch):
    monkeypatch.setenv("TFT_OFFLINE", "1")
    want_ds, got_ds = grid_ds(jnc, n_t=6), grid_ds(tnc, n_t=6)
    write_lcfa(tmp_path, want_ds)
    files = sorted(tmp_path.iterdir())
    with pytest.warns(UserWarning, match="could not read"):
        want = jglm.read_glm_flashes(files)
    with pytest.warns(UserWarning, match="could not read"):
        got = glm.read_glm_flashes(files)
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want))
    assert want[0].size == 1600 and (want[3] == 1).sum() == 400
    start, end = (T0.astype("datetime64[s]").item(),
                  (T0 + 5 * STEP).astype("datetime64[s]").item())
    with pytest.warns(UserWarning, match="could not read"):
        want_grid = jglm.create_gridded_flash_ds(want_ds, start, end, glm_save_dir=tmp_path)
    with pytest.warns(UserWarning, match="could not read"):
        got_grid = glm.create_gridded_flash_ds(got_ds, start, end, glm_save_dir=tmp_path,
                                               device="cpu")
    assert os.environ["TFT_OFFLINE"] == "1"
    counts = got_grid["glm_flashes"]
    assert isinstance(counts.data, torch.Tensor) and counts.dims == ("t", "y", "x")
    assert np.array_equal(counts.values, want_grid["glm_flashes"].values)
    assert counts.attrs == want_grid["glm_flashes"].attrs
    assert set(got_grid.coords) == set(want_grid.coords)
    assert 0 < counts.values.sum() <= 1600


def test_regrid_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    ds = grid_ds(tnc)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        glm.regrid_glm(*flashes(ds, 5), ds, _t_bins(ds))
