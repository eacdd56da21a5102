"""The port's GOES ingest against the JAX package's, on the same inputs:
the ABI fixed-grid geometry and calibrations, the geodesic helpers, the
datetime helpers, the file discovery (prefixes, file-name dates, the
offline glob and, through a stand-in bucket, the blob listings), the
dataset helpers and ``create_new_goes_ds``, and ``goes_dataloader`` on
MCMIP files written here in the layout of the reference's own fixture
(``tests/test_goes_ingest_chain.py``): a DQF box, a flagged stripe row and
a 20-minute gap, filled with a NaN frame, or from a full-disk file cut at
the CONUS sector's offset.

The tolerance is identity: float64 host numpy with the same operations in
the same order, so every array must equal the reference's, NaN in the
same places, with the same dims, coordinates, names and attrs.  The
in-memory path that ``chip_smoke.py`` runs where h5py is absent must give
what the file path gives.
"""

import os
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("h5py")

from chip_smoke import (  # noqa: E402
    ABI_STEP, CONUS_X0, CONUS_Y0, GOES16_PROJECTION, GOES_DQF_FRAME, GOES_STRIPE_FRAME,
    GOES_T0, goes_flags, goes_frames, goes_ingest,
)
from tobac_flow_tpu.data import abi as jabi  # noqa: E402
from tobac_flow_tpu.data import dataloader as jdl  # noqa: E402
from tobac_flow_tpu.data import dataset_utils as jdu  # noqa: E402
from tobac_flow_tpu.data import io as jio  # noqa: E402
from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu.schema import dataset as jschema  # noqa: E402
from tobac_flow_tpu.utils import datetime_utils as jdt  # noqa: E402
from tobac_flow_tpu.utils import geo as jgeo  # noqa: E402
from tobac_flow_tpu_torch.data import abi as tabi  # noqa: E402
from tobac_flow_tpu_torch.data import dataloader as tdl  # noqa: E402
from tobac_flow_tpu_torch.data import dataset_utils as tdu  # noqa: E402
from tobac_flow_tpu_torch.data import io as tio  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402
from tobac_flow_tpu_torch.schema import dataset as tschema  # noqa: E402
from tobac_flow_tpu_torch.utils import datetime_utils as tdt  # noqa: E402
from tobac_flow_tpu_torch.utils import geo as tgeo  # noqa: E402

# the archive: 10 frames of 24x32 at 5-minute steps, frames 5-7 missing
# (a 20-minute gap over the 15-minute limit)
ARCHIVE = (10, 24, 32)
MISSING = (5, 6, 7)
ORIGIN = (1234, 738)  # top-left pixel in the CONUS sector
WINDOW = dict(x0=2, x1=30, y0=1, y1=23)


def assert_same(a, b):
    """Identical arrays (NaN in the same places), dtypes included, or
    identical nested tuples and lists of them."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def assert_same_da(want, got):
    assert (got.name, got.dims, got.attrs) == (want.name, want.dims, want.attrs)
    assert list(got.coords) == list(want.coords)
    for k, c in want.coords.items():
        assert_same(c, got.coords[k])
    assert_same(want.values, got.values)


def assert_same_ds(want, got):
    assert list(got.coords) == list(want.coords) and list(got.data_vars) == list(want.data_vars)
    assert got.attrs == want.attrs
    for k, c in want.coords.items():
        assert_same(c, got.coords[k])
    for k, v in want.data_vars.items():
        assert_same_da(v, got[k])


def abi_name(time, view="C"):
    """An ABI L2 MCMIP file name whose _s token holds ``time``."""
    stamp = time.astype("datetime64[s]").item().strftime("%Y%j%H%M%S")
    return f"OR_ABI-L2-MCMIP{view}-M6_G16_s{stamp}0.nc"


def write_mcmip(path, time, channels, dqfs, x, y):
    """One MCMIP file in the reference fixture's layout: CMI_* and DQF_*
    per channel on (y, x), the t, y and x coordinates and the projection
    variable with its attrs."""
    ds = tnc.Dataset(coords={"t": np.asarray([time], "datetime64[ns]"), "y": y, "x": x})
    for ch, vals in channels.items():
        ds[f"CMI_{ch}"] = tnc.DataArray(vals, dims=("y", "x"), attrs={"units": "K"})
        ds[f"DQF_{ch}"] = tnc.DataArray(dqfs[ch], dims=("y", "x"))
    ds["goes_imager_projection"] = tnc.DataArray(np.zeros((), np.int32), dims=(),
                                                 attrs=GOES16_PROJECTION)
    ds.to_netcdf(path)


def write_archive(directory, shape, missing, origin):
    """``chip_smoke.goes_frames(shape, missing, origin)`` written as one
    MCMIP file per frame into ``directory``."""
    times, frames, x, y = goes_frames(shape, missing, origin)
    for time, (channels, dqfs) in zip(times, frames):
        write_mcmip(Path(directory) / abi_name(time), time, channels, dqfs, x, y)
    return times, frames, x, y


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    directory = tmp_path_factory.mktemp("goes_data")
    return (directory, *write_archive(directory, ARCHIVE, MISSING, ORIGIN))


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    monkeypatch.setenv("TFT_OFFLINE", "1")


def conus_grid(step):
    """Scan angles of every ``step``-th pixel of the CONUS sector."""
    return (CONUS_X0 + np.arange(0, 2500, step) * ABI_STEP,
            CONUS_Y0 - np.arange(0, 1500, step) * ABI_STEP)


def full_disk_edge_grid():
    """Scan angles across the full disk's western limb, on and off it."""
    return np.linspace(-0.1530, -0.1400, 40), np.linspace(0.06, -0.06, 30)


def grid_dataset(pkg, x, y):
    ds = pkg.Dataset(coords={"x": x, "y": y})
    ds["goes_imager_projection"] = pkg.DataArray(np.zeros((), np.int32), dims=(),
                                                 attrs=GOES16_PROJECTION)
    return ds


@pytest.mark.parametrize("grid", ["conus", "full_disk_edge"])
def test_abi_geometry_identical(grid):
    x, y = conus_grid(25) if grid == "conus" else full_disk_edge_grid()
    jds, tds = grid_dataset(jnc, x, y), grid_dataset(tnc, x, y)
    lat, lon = tabi.get_abi_lat_lon(tds)
    area = tabi.get_abi_pixel_area(tds)
    assert_same(jabi.get_abi_lat_lon(jds), (lat, lon))
    assert_same(jabi.get_abi_pixel_lengths(jds), tabi.get_abi_pixel_lengths(tds))
    assert_same(jabi.get_abi_pixel_area(jds), area)
    assert_same(jabi.get_abi_sat_zenith(jds), tabi.get_abi_sat_zenith(tds))
    off = np.isnan(lat)
    # the CONUS sector's north-western corner lies beyond the limb, as does
    # the outer part of the edge grid
    assert 0 < off.sum() < off.size and np.isnan(area[off]).all()
    # back to scan angles on the disk; off it, NaN
    xx, yy = np.meshgrid(x, y)
    assert_same(jabi.get_abi_xy_from_latlon(jds, lat, lon), tabi.get_abi_xy_from_latlon(tds, lat, lon))
    back = tabi.get_abi_xy_from_latlon(tds, lat, lon)
    np.testing.assert_allclose(back[0][~off], xx[~off], atol=1e-9)
    np.testing.assert_allclose(back[1][~off], yy[~off], atol=1e-9)


def test_abi_projection_identical():
    jp, tp = jabi.ABIProjection(**GOES16_PROJECTION), tabi.ABIProjection(**GOES16_PROJECTION)
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-0.17, 0.17, 500), rng.uniform(-0.17, 0.17, 500)
    assert_same(jp.to_latlon(x, y), tp.to_latlon(x, y))
    lat, lon = rng.uniform(-80, 80, 500), rng.uniform(-180, 180, 500)
    assert_same(jp.to_xy(lat, lon), tp.to_xy(lat, lon))
    assert_same(jp.sat_zenith(lat, lon), tp.sat_zenith(lat, lon))
    assert np.isnan(tp.to_latlon(0.2, 0.0)[0]) and np.isnan(tp.to_xy(0.0, 105.0)[0])


def test_abi_calibration_and_composites_identical():
    rng = np.random.default_rng(1)
    rad = rng.uniform(1, 120, (6, 7))
    assert_same(*[(pkg.get_abi_ref(rad, 0.003),
                   pkg.get_abi_bt(rad, 10803.3, 1392.74, 0.0755, 0.99975)) for pkg in (jabi, tabi)])
    for band in (2, 13):
        dss = []
        for nc in (jnc, tnc):
            ds = nc.Dataset()
            ds["Rad"] = nc.DataArray(rad, dims=("y", "x"))
            ds["band_id"] = nc.DataArray(np.array([band]), dims=("band",))
            for k, v in zip(("kappa0", "planck_fk1", "planck_fk2", "planck_bc1", "planck_bc2"),
                            (0.003, 10803.3, 1392.74, 0.0755, 0.99975)):
                ds[k] = nc.DataArray(np.float64(v), dims=())
            dss.append(ds)
        assert_same(jabi.get_abi_da(dss[0]), tabi.get_abi_da(dss[1]))
    ref = rng.uniform(0, 1.1, (8, 8))
    bt = rng.uniform(190, 290, (8, 8))
    sza = rng.uniform(0, 95, (8, 8))
    assert_same(jabi.get_abi_rgb(ref, ref * 0.8, ref * 0.6), tabi.get_abi_rgb(ref, ref * 0.8, ref * 0.6))
    for s in (None, sza):
        assert_same(jabi.get_abi_deep_cloud_rgb(bt, ref, s), tabi.get_abi_deep_cloud_rgb(bt, ref, s))


def test_geo_identical():
    rng = np.random.default_rng(2)
    lon0, lat0 = rng.uniform(-120, -60, 50), rng.uniform(-50, 50, 50)
    lon1, lat1 = lon0 + rng.uniform(-2, 2, 50), lat0 + rng.uniform(-2, 2, 50)
    for name in ("haversine_distance", "initial_bearing"):
        assert_same(getattr(jgeo, name)(lon0, lat0, lon1, lat1),
                    getattr(tgeo, name)(lon0, lat0, lon1, lat1))
    times = np.datetime64("2020-06-21T11:00") + rng.integers(0, 86400, 50).astype("timedelta64[s]")
    for name in ("get_sza", "get_sza_and_azi"):
        assert_same(getattr(jgeo, name)(times, lat0, lon0), getattr(tgeo, name)(times, lat0, lon0))
    track = (np.cumsum(rng.uniform(0, 0.1, 6)) - 90, np.cumsum(rng.uniform(0, 0.1, 6)) + 30,
             np.datetime64("2020-06-01T00:00") + np.arange(6)[::-1] * np.timedelta64(300, "s"))
    assert_same(jgeo.get_mean_object_azimuth_and_speed(*track),
                tgeo.get_mean_object_azimuth_and_speed(*track))
    assert_same(jgeo.get_mean_object_azimuth_and_speed([1.0], [2.0], times[:1]),
                tgeo.get_mean_object_azimuth_and_speed([1.0], [2.0], times[:1]))
    assert_same(jgeo.get_satellite_viewing_angles(lat0, lon0),
                tgeo.get_satellite_viewing_angles(lat0, lon0))
    lon, lat = np.meshgrid(np.linspace(-100, -90, 7), np.linspace(20, 40, 5))
    lat[1, 2] = np.nan
    assert_same(jgeo.get_pixel_lengths(lat, lon), tgeo.get_pixel_lengths(lat, lon))
    assert_same(jgeo.get_pixel_area(lat, lon), tgeo.get_pixel_area(lat, lon))


def test_datetime_utils_identical():
    for name in ("detected_dccs_G16_S20200601000000_E20200602000000_X0000_0000.nc",
                 "x_S2020153000000_E2020153120000.nc"):
        assert jdt.get_dates_from_filename(name) == tdt.get_dates_from_filename(name)
    with pytest.raises(ValueError):
        tdt.get_dates_from_filename("plain_name.nc")
    t = np.datetime64("2020-06-01T00:00", "ns") + np.arange(10) * np.timedelta64(600, "s")
    for start, end in [(datetime(2020, 6, 1, 0, 20), datetime(2020, 6, 1, 1, 10)),
                       (datetime(2020, 6, 1, 0, 15), datetime(2020, 6, 1, 1, 0))]:
        out = []
        for nc, dt in ((jnc, jdt), (tnc, tdt)):
            ds = nc.Dataset(coords={"t": t})
            ds["v"] = nc.DataArray(np.arange(10.0), dims=("t",))
            out.append((dt.trim_file_start(ds, start)["v"].values,
                        dt.trim_file_end(ds, end)["v"].values,
                        dt.trim_file_start_and_end(ds, start, end)["v"].values,
                        dt.trim_file_start_and_end(ds, start, end).coords["t"]))
        assert_same(*out)


def test_io_prefixes_and_dates_identical():
    d = datetime(2018, 6, 19, 17)
    for kw in ({}, dict(product="ACHA", view="F", mode=6)):
        assert tio._abi_prefix(d, **kw) == jio._abi_prefix(d, **kw)
    assert tio._l1b_prefix(d, view="C", mode=6, channel=2) == jio._l1b_prefix(
        d, view="C", mode=6, channel=2)
    for name in ("OR_ABI-L2-MCMIPC-M3_G16_s20181701700204_e20181701702577_c2018170170.nc",
                 "not_a_goes_file.nc", "OR_GLM-L2-LCFA_G16_s20200010000000_e2020.nc"):
        assert tio.get_goes_date(name) == jio.get_goes_date(name)
    span = (datetime(2020, 1, 1, 10, 30), datetime(2020, 1, 1, 12, 10))
    assert list(tio._hours_in_range(*span)) == list(jio._hours_in_range(*span))


class FakeBlob:
    def __init__(self, name):
        self.name = name


class FakeBucket:
    """A bucket whose listing of a prefix gives a few blob names under it:
    ABI/GLM scans at minutes 0, 25 and 55 of the prefix's hour, NEXRAD
    volumes at hours 0, 11 and 23 of the prefix's day."""

    def list_blobs(self, prefix):
        if prefix.endswith("/"):  # NEXRAD: YYYY/MM/DD/SITE/
            y, m, d, site = prefix.split("/")[:4]
            return [FakeBlob(f"{prefix}{site}{y}{m}{d}_{h:02d}0000_V06") for h in (0, 11, 23)]
        year, doy, hour = prefix.split("/")[1:4]
        return [FakeBlob(f"{prefix}_G16_s{year}{doy}{hour}{m:02d}000_e0.nc") for m in (0, 25, 55)]


class FakeClient:
    def bucket(self, name):
        return FakeBucket()


def test_blob_listings_identical(monkeypatch):
    """The blob listings through a stand-in client (no network, no
    google-cloud-storage): the same blobs for the same query."""
    for mod in (jio, tio):
        monkeypatch.setattr(mod, "_client", FakeClient)
    start, end = datetime(2020, 6, 1, 10, 20), datetime(2020, 6, 1, 12, 30)
    queries = [("find_abi_blobs", (start, end), dict(mode=[3, 6])),
               ("find_abi_blobs", (start, None), dict(channel=2, view="F")),
               ("find_glm_blobs", (start, end), {}),
               ("find_nexrad_blobs", (datetime(2020, 6, 1, 5), datetime(2020, 6, 2, 12), "KTLX"),
                {})]
    for name, args, kw in queries:
        want = [b.name for b in getattr(jio, name)(*args, **kw)]
        assert want and [b.name for b in getattr(tio, name)(*args, **kw)] == want, name


def linked_archive(archive, directory):
    """A directory linking the archive's files."""
    directory.mkdir()
    for p in archive[0].glob("OR_ABI-L2-MCMIPC-*.nc"):
        os.symlink(p, directory / p.name)
    return directory


def test_offline_glob_finds_the_same_files(archive, tmp_path):
    directory = linked_archive(archive, tmp_path / "goes_data")
    (directory / "sub").mkdir()
    for name in ("OR_ABI-L2-MCMIPF-M6_G16_s20200010000000.nc", "OR_GLM-L2-LCFA_G16_s20201530012000_e0.nc",
                 "OR_ABI-L2-MCMIPC-M6_G16_sgarbage.nc"):
        (directory / "sub" / name).touch()
    start = datetime(2020, 6, 1, 0, 10)
    for kw in (dict(end_date=start + timedelta(minutes=30)), {}, dict(view="F"),
               dict(end_date=datetime(2020, 1, 2), view="F")):
        for s in (start, datetime(2020, 1, 1)):
            want = jio.find_abi_files(s, save_dir=directory, **kw)
            assert tio.find_abi_files(s, save_dir=directory, **kw) == want
    assert tio.find_glm_files(start, save_dir=directory) == jio.find_glm_files(
        start, save_dir=directory) != []
    files = tdl.find_goes_files(start, start + timedelta(minutes=15), n_pad_files=2,
                                save_dir=directory)
    assert files == jdl.find_goes_files(start, start + timedelta(minutes=15), n_pad_files=2,
                                        save_dir=directory)
    # 00:10-00:20, two before, and the two after the gap
    assert len(files) == 7


def test_dataset_utils_identical():
    coord = np.array([0.0, 1.0, 3.0, 6.0])
    assert_same(jdu.get_coord_bin_edges(coord), tdu.get_coord_bin_edges(coord))
    das = [du.add_cell_method(du.add_cell_method(du.create_dataarray(
        np.arange(4.0), ("core",), "v", coords={"core": coord}, long_name="a", units="K",
        dtype=np.float32, comment=None, source="x"), "mean", "t"), "max", "y")
        for du in (jdu, tdu)]
    assert_same_da(*das)
    dss = []
    for nc, du in ((jnc, jdu), (tnc, tdu)):
        ds = nc.Dataset(coords={"core": np.array([1, 2, 5]), "anvil": np.array([3, 4])})
        du.add_dataarray_to_ds(du.create_dataarray(np.array([7, 8, 9]), ("core",), "c"), ds)
        du.add_dataarray_to_ds(du.create_dataarray(np.array([1.5, 2.5]), ("anvil",), "a"), ds)
        du.add_compression_encoding(ds, 3)
        dss.append((du.sel_core(ds, 5), du.isel_core(ds, [0, 2]), du.sel_anvil(ds, [4, 3]),
                    du.isel_anvil(ds, slice(1, None))))
    for want, got in zip(*dss):
        assert_same_ds(want, got)


def test_create_new_goes_ds_identical():
    x, y = conus_grid(100)
    dss = []
    for nc, schema in ((jnc, jschema), (tnc, tschema)):
        src = grid_dataset(nc, x, y)
        src.coords["t"] = GOES_T0 + np.arange(3) * np.timedelta64(300, "s")
        dss.append(schema.create_new_goes_ds(src))
    assert_same_ds(*dss)
    assert {"lat", "lon", "area"} <= set(dss[1].data_vars)


def load(pkg, directory, **kw):
    start = GOES_T0.astype("datetime64[us]").item()
    return pkg.goes_dataloader(start, start + timedelta(minutes=5 * ARCHIVE[0]), n_pad_files=0,
                               save_dir=directory, satellite=16, view="C", **kw)


@pytest.mark.parametrize("window", [{}, WINDOW], ids=["whole", "window"])
def test_goes_dataloader_identical(archive, window):
    """Masked fields, the NaN gap frame, times, lat, lon and area: the
    port's loader gives the reference's, whole and in a window."""
    directory = archive[0]
    want, got = load(jdl, directory, return_new_ds=True, **window), load(
        tdl, directory, return_new_ds=True, **window)
    for w, g in zip(want[:3], got[:3]):
        assert_same_da(w, g)
    assert_same_ds(want[3], got[3])
    assert {"lat", "lon", "area"} <= set(got[3].data_vars)
    bt, wvd, swd = got[:3]
    assert bt.shape[0] == ARCHIVE[0] - len(MISSING) + 1
    assert np.isnan(bt.values[MISSING[0]]).all() and np.isfinite(bt.values[MISSING[0] - 1]).any()
    if not window:
        box, row = goes_flags(*ARCHIVE[1:])
        for f in (bt, wvd, swd):
            assert np.isnan(f.values[GOES_DQF_FRAME][box]).all()
            assert np.isnan(f.values[GOES_STRIPE_FRAME, row]).all()
            assert np.isfinite(f.values[GOES_STRIPE_FRAME, row + 2]).all()
    for w, g in zip(load(jdl, directory, **window), load(tdl, directory, **window)):
        assert_same_da(w, g)


def test_in_memory_ingest_equals_the_file_path(archive):
    """``chip_smoke.goes_ingest``, the port's mask, stack, gap fill and
    geometry on arrays in memory, gives what ``goes_dataloader`` gives from
    the files of the same frames."""
    directory, times, frames, x, y = archive
    fields, ds = goes_ingest(times, frames, x, y)
    loaded = load(tdl, directory, return_new_ds=True)
    # the writer's own record of a variable's dims, which an archive's file
    # does not hold
    del loaded[3]["goes_imager_projection"].attrs["_tft_dims"]
    for want, got in zip(loaded[:3], fields):
        assert_same_da(want, got)
    assert_same_ds(loaded[3], ds)
    unchanged = goes_frames(ARCHIVE, MISSING, ORIGIN)[1]
    for (c0, d0), (c1, d1) in zip(unchanged, frames):
        assert_same([c0[k] for k in sorted(c0)], [c1[k] for k in sorted(c1)])
        assert_same([d0[k] for k in sorted(d0)], [d1[k] for k in sorted(d1)])


def test_load_mcmip_identical_and_skips_unreadable(archive, tmp_path):
    directory = archive[0]
    files = sorted(directory.glob("OR_ABI-L2-MCMIPC-*.nc"))
    broken = tmp_path / "OR_ABI-L2-MCMIPC-M6_G16_s20200010000000.nc"
    broken.write_bytes(b"not a netCDF file")
    with pytest.warns(UserWarning, match="could not read"):
        got = tdl.load_mcmip([broken] + files[::-1], **WINDOW)
    want = jdl.load_mcmip(files, **WINDOW)
    for w, g in zip(want[:3], got[:3]):
        assert_same_da(w, g)
    assert got[3] == want[3] == {**GOES16_PROJECTION, "_tft_dims": ""}
    with pytest.raises(FileNotFoundError):
        tdl.load_mcmip([broken])


def test_fill_time_gap_full_disk_identical(archive, tmp_path):
    """A full-disk (F) file inside the gap, whose window at the CONUS
    sector's offset (x + 902, y + 422) holds the missing frame, fills it
    in both packages alike: no NaN frame is then needed."""
    directory = linked_archive(archive, tmp_path / "goes_data")
    (ox, oy), (h, w) = tdl.CONUS_OFFSET, ARCHIVE[1:]
    rng = np.random.default_rng(3)
    time = GOES_T0 + np.timedelta64(30, "m")
    shape = (oy + h + 2, ox + w + 2)
    channels = {c: np.full(shape, v, np.float32) for c, v in
                (("C08", 225.0), ("C10", 240.0), ("C13", 280.0), ("C15", 282.0))}
    channels["C13"][oy:oy + h, ox:ox + w] = rng.uniform(200, 290, (h, w))
    dqfs = {c: np.zeros(shape, np.float32) for c in channels}
    dqfs["C10"][oy + 3, ox:ox + w] = 1
    dqfs["C15"][oy + 5:oy + 9, ox + 4:ox + 9] = np.nan
    write_mcmip(directory / abi_name(time, "F"), time, channels, dqfs,
                np.arange(shape[1]) * ABI_STEP - 0.15, 0.15 - np.arange(shape[0]) * ABI_STEP)
    window = dict(x0=0, x1=w, y0=0, y1=h)
    want, got = load(jdl, directory, return_new_ds=True, **window), load(
        tdl, directory, return_new_ds=True, **window)
    for wa, ga in zip(want[:3], got[:3]):
        assert_same_da(wa, ga)
    assert_same_ds(want[3], got[3])
    bt, wvd = got[0].values, got[1].values
    assert bt.shape[0] == ARCHIVE[0] - len(MISSING) + 1
    assert np.array_equal(got[0].coords["t"][MISSING[0]], time)
    assert_same(bt[MISSING[0]], np.where(np.arange(h)[:, None] == 3, np.nan,
                                         channels["C13"][oy:oy + h, ox:ox + w]))
    assert np.isnan(wvd[MISSING[0], 3]).all() and np.isfinite(wvd[MISSING[0], 4]).all()
