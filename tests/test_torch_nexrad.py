"""The port's radar and flux gridding against the JAX package on the CPU:
the Level-II reader (``data/nexrad_level2.py``: crafted archives, bzip2
and uncompressed, a variable-length message 29 in the stream), the gates'
geometry and their parallax mapping to scan angles, the 2D and 3D
reflectivity histograms and the multi-site composite (``data/nexrad.py``),
the site table and filter, and the CLIs ``grid_nexrad``, ``grid_flux`` and
``grid_flux_native`` run on files that the test writes (through h5py).

Tolerances: bytes, masks, counts, site lists and the host float64 geometry
exact (bit for bit); the binned float64 sums to rtol 1e-12 (the port adds
each bin's values in a fixed pairwise tree, numpy in order); the float32
means to rtol 1e-5 (PERF.md §2's gate).  Inputs from a numpy seed;
archives written by ``chip_smoke.level2_archive``.
"""

import bz2
import io
import struct
import tarfile

import numpy as np
import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.data import nexrad as jnexrad  # noqa: E402
from tobac_flow_tpu.data import nexrad_level2 as jlevel2  # noqa: E402
from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu_torch.data import nexrad, nexrad_level2  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402

from chip_smoke import (  # noqa: E402
    _FILE_ATTRS, ABI_STEP, CONUS_X0, CONUS_Y0, GOES16_PROJECTION, RADAR_ALT_EDGES, level2_archive,
    level2_radial, radar_raw, radar_volume,
)

SITE = (35.333, -97.278, 384.0)
GRID_ORIGIN = (1226, 734)  # the CONUS sector's centre, as the GOES tests' small window


def _archive(seed=0, radials=12, gates=40):
    """A bzip2 archive of ``radials`` radials over two cuts, ragged (the
    second cut's radials are shorter), raw bytes from ``seed``."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(radials):
        el = 0.5 if i < radials // 2 else 2.4
        n = gates if el == 0.5 else gates // 2
        msgs.append(level2_radial(SITE, float(i * 360 / radials), el, radar_raw(rng, n),
                                  collect_ms=43_200_000 + 1000 * i))
    return level2_archive(msgs), msgs


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want, equal_nan=True), f"{int(np.sum(got != want))} differ"


def _msg29(body_len):
    size_hw = (16 + body_len) // 2
    return (b"\x00" * 12 + struct.pack(">HBBHHIHH", size_hw, 0, 29, 1, 18500, 0, 1, 1)
            + b"\x07" * body_len)


def _radials_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if k == "reflectivity":
                _same(np.ma.getmaskarray(g[k]), np.ma.getmaskarray(w[k]))
                _same(g[k].data, w[k].data)
            else:
                assert g[k] == w[k]


def test_decode_archives():
    buf, msgs = _archive()
    for data in (buf, buf[:24] + b"".join(msgs),  # uncompressed: the message stream as is
                 buf[:24] + msgs[0] + _msg29(1001) + b"".join(msgs[1:])):
        got, want = nexrad_level2.decode_archive_bytes(data), jlevel2.decode_archive_bytes(data)
        assert got[0] == want[0]
        _radials_equal(got[1], want[1])
    with pytest.raises(ValueError, match="AR2V"):
        nexrad_level2.decode_archive_bytes(b"X" * 40)


def test_read_archive():
    buf, _ = _archive(1)
    got, want = nexrad_level2.read_nexrad_archive(buf), jlevel2.read_nexrad_archive(buf)
    for g, w in zip(got[:-1], want[:-1]):
        _same(g, w)
    _same(np.ma.getmaskarray(got[-1]), np.ma.getmaskarray(want[-1]))
    _same(np.ma.filled(got[-1], np.nan), np.ma.filled(want[-1], np.nan))
    assert np.ma.getmaskarray(got[-1])[-1, -1] and not np.ma.getmaskarray(got[-1]).all()
    with pytest.raises(IOError):
        nexrad_level2.read_nexrad_archive(level2_archive([]))


def test_gate_geometry():
    rng = np.random.default_rng(2)
    az = rng.uniform(0, 360, (50, 1))
    el = rng.uniform(0, 20, (50, 1))
    r = rng.uniform(0, 460e3, (1, 60))
    for g, w in zip(nexrad_level2.gate_lat_lon_alt(*SITE, az, el, r),
                    jlevel2.gate_lat_lon_alt(*SITE, az, el, r)):
        _same(g, w)


def test_gates_from_tar(tmp_path):
    path = tmp_path / "KTLX20200826_120000.tar"
    with tarfile.open(path, "w") as tar:
        for name, data in (("a_V06.ar2v", _archive(3)[0]), ("b_V06.ar2v", _archive(4)[0]),
                           ("metadata.txt", b"not a radar file")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    for g, w in zip(nexrad.get_gates_from_tar(path), jnexrad.get_gates_from_tar(path)):
        _same(g, w)


def grid_ds(nc, h=40, w=60, flip=True):
    """A window of GOES-16's CONUS fixed grid (y decreasing unless
    ``flip`` is false) in ``nc``'s Dataset, with its projection."""
    x = CONUS_X0 + (GRID_ORIGIN[0] + np.arange(w)) * ABI_STEP
    y = CONUS_Y0 - (GRID_ORIGIN[1] + np.arange(h)) * ABI_STEP
    ds = nc.Dataset(coords={"y": y if flip else y[::-1].copy(), "x": x})
    ds["goes_imager_projection"] = nc.DataArray(np.zeros((), np.int32), dims=(),
                                                attrs=dict(GOES16_PROJECTION))
    return ds


def _centre(ds):
    from tobac_flow_tpu_torch.data.abi import get_abi_proj

    x, y = ds.coords["x"], ds.coords["y"]
    return get_abi_proj(ds).to_latlon(x[len(x) // 2], y[len(y) // 2])


def _site_gates(ds, seed, gates=120, radials=90):
    lat, lon = _centre(ds)
    return radar_volume((float(lat) + 0.05 * seed, float(lon) - 0.05 * seed, 300.0), seed,
                        cuts=(0.5, 4.0, 12.0), radials=radials, gates=gates)


def test_map_to_goes_and_sites():
    ds, jds = grid_ds(tnc), grid_ds(jnc)
    lat, lon, alt, _ = _site_gates(ds, 0)
    for g, w in zip(nexrad.map_nexrad_to_goes(lat, lon, alt, ds),
                    jnexrad.map_nexrad_to_goes(lat, lon, alt, jds)):
        _same(g, w)
    assert nexrad.NEXRAD_SITES == jnexrad.NEXRAD_SITES and len(nexrad.NEXRAD_SITES) == 160
    assert nexrad.get_nexrad_sitenames() == jnexrad.get_nexrad_sitenames()
    conus, jconus = grid_ds(tnc, 1500, 2500), grid_ds(jnc, 1500, 2500)
    conus.coords["x"] = conus.coords["x"] - GRID_ORIGIN[0] * ABI_STEP
    conus.coords["y"] = conus.coords["y"] + GRID_ORIGIN[1] * ABI_STEP
    jconus.coords["x"], jconus.coords["y"] = conus.coords["x"], conus.coords["y"]
    sites = nexrad.filter_nexrad_sites(conus)
    assert sites == jnexrad.filter_nexrad_sites(jconus) and len(sites) >= 4


@pytest.mark.parametrize("flip", [True, False], ids=["y_decreasing", "y_increasing"])
def test_histograms(flip):
    ds, jds = grid_ds(tnc, flip=flip), grid_ds(jnc, flip=flip)
    lat, lon, alt, refl = _site_gates(ds, 1)
    gx, gy = nexrad.map_nexrad_to_goes(lat, lon, alt, ds)
    # gates exactly on the bins' edges, on the last edge, outside, NaN
    x_edges, y_edges, _ = nexrad._grid_axes(ds)
    gx[:6] = x_edges[[0, 1, 5, -1, -1, 0]] + [0, 0, 0, 0, 1e-9, -1e-9]
    gy[:6] = y_edges[[3, 0, -1, 2, 2, 2]]
    gx[6], gy[7], refl[8] = np.nan, np.inf, -40.0
    counts, mean = nexrad.get_nexrad_hist(gx, gy, refl, ds, device="cpu")
    want = jnexrad.get_nexrad_hist(gx, gy, refl, jds)
    _same(counts, want[0])
    np.testing.assert_allclose(mean.numpy(), want[1], rtol=1e-5)
    _same(torch.isnan(mean), np.isnan(want[1]))
    assert 0 < int(counts.sum()) < np.isfinite(refl).sum()
    c3, m3 = nexrad.get_3d_nexrad_hist(gx, gy, alt, refl, ds, device="cpu")
    w3 = jnexrad.get_3d_nexrad_hist(gx, gy, alt, refl, jds)
    _same(c3, w3[0])
    np.testing.assert_allclose(m3.numpy(), w3[1], rtol=1e-5)
    assert (c3.sum((1, 2)) > 0).sum() >= 3
    # the float64 sums behind the means
    ok = np.isfinite(gx) & np.isfinite(gy) & np.isfinite(refl) & (refl >= -33)
    _, sums, _ = nexrad.histogram_mean((gy[ok], gx[ok]), (y_edges, x_edges), refl[ok], "cpu")
    want_sums = np.histogram2d(gy[ok], gx[ok], bins=[y_edges, x_edges], weights=refl[ok])[0]
    np.testing.assert_allclose(sums.numpy(), want_sums, rtol=1e-12, atol=0)


def test_regrid_nexrad_composite():
    ds, jds = grid_ds(tnc), grid_ds(jnc)
    sites = [_site_gates(ds, seed) for seed in (2, 3, 4)]
    counts, mean = nexrad.regrid_nexrad(sites, ds, device="cpu", min_refl=-20.0)
    want = jnexrad.regrid_nexrad(sites, jds, min_refl=-20.0)
    _same(counts, want[0])
    np.testing.assert_allclose(mean.numpy(), want[1], rtol=1e-5)
    _same(torch.isnan(mean), np.isnan(want[1]))


def test_radar_volume_decodes_as_written():
    """``chip_smoke.radar_volume``'s gates are the reader's gates of the
    same raw bytes and geometry (the archive holds the site's position in
    float32)."""
    raw = radar_raw(np.random.default_rng(5), (4, 30))
    buf = level2_archive([level2_radial(SITE, 0.25 + 0.5 * i, 0.5, raw[i]) for i in range(4)])
    _, alts, lats, lons, refs = nexrad_level2.read_nexrad_archive(buf)
    site = tuple(float(np.float32(v)) for v in SITE)
    lat, lon, alt, refl = radar_volume(site, 5, cuts=(0.5,), radials=4, gates=30)
    _same(lat.reshape(4, 30), lats)
    _same(alt.reshape(4, 30), alts)
    _same(refl.reshape(4, 30), np.ma.filled(refs.astype(np.float64), np.nan))


# -- the CLIs, on files ----------------------------------------------------------


def _write(ds, path):
    ds.to_netcdf(path)
    return str(path)


def _attrs_equal(got, want):
    """Equal attributes, leaving out HDF5's dimension-scale bookkeeping."""
    got, want = ({k: v for k, v in a.items() if k not in _FILE_ATTRS} for a in (got, want))
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(np.asarray(got[k]), np.asarray(v)), k


def _files_equal(got_path, want_path, rtol=1e-5):
    got, want = tnc.open_dataset(got_path), jnc.open_dataset(want_path)
    assert set(got.data_vars) == set(want.data_vars)
    for k in want.data_vars:
        g, w = np.asarray(got[k].values), np.asarray(want[k].values)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=k)
            assert np.array_equal(np.isnan(g), np.isnan(w)), k
        else:
            assert np.array_equal(g, w), k
        _attrs_equal(got[k].attrs, want[k].attrs)
    for k in want.coords:
        assert np.array_equal(np.asarray(got.coords[k]), np.asarray(want.coords[k])), k


def test_grid_nexrad_cli(tmp_path):
    pytest.importorskip("h5py")
    from tobac_flow_tpu.cli import grid_nexrad as jcli
    from tobac_flow_tpu_torch.cli import grid_nexrad

    target = _write(grid_ds(jnc), tmp_path / "target.nc")
    radar = tmp_path / "radar"
    radar.mkdir()
    lat, lon = _centre(grid_ds(tnc))
    site = (float(lat), float(lon), 300.0)
    rng = np.random.default_rng(6)
    sites = nexrad.filter_nexrad_sites(grid_ds(tnc))
    assert len(sites) >= 2  # files are read for the in-domain sites named in them
    with tarfile.open(radar / f"{sites[0]}_a.tar", "w") as tar:
        data = level2_archive([level2_radial(site, 3.0 * i, 0.5, radar_raw(rng, 200))
                               for i in range(120)])
        info = tarfile.TarInfo("KTLX_V06.ar2v")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    gates = jnc.Dataset(coords={"gate": np.arange(3000)})
    glat, glon, galt, grefl = _site_gates(grid_ds(tnc), 7, gates=100, radials=30)
    for name, v in (("gate_lat", glat), ("gate_lon", glon), ("gate_alt", galt),
                    ("gate_refl", grefl)):
        gates[name] = jnc.DataArray(v[:3000], dims=("gate",))
    _write(gates, radar / f"{sites[1]}_gates.nc")
    _write(gates, radar / "KTLX_gates.nc")  # off the window: left out
    want = jcli.main([target, "-nexrad", str(radar), "-sd", str(tmp_path / "jax")])
    got = grid_nexrad.main([target, "-nexrad", str(radar), "-sd", str(tmp_path / "port"),
                            "--device", "cpu"])
    assert got.name == want.name
    _files_equal(got, want)
    assert tnc.open_dataset(got)["nexrad_gate_count"].values.sum() > 0


def test_grid_flux_cli(tmp_path):
    pytest.importorskip("h5py")
    from tobac_flow_tpu.cli import grid_flux as jcli
    from tobac_flow_tpu_torch.cli import grid_flux

    target = _write(grid_ds(jnc), tmp_path / "target.nc")
    lat, lon = _centre(grid_ds(tnc))
    lats = float(lat) + np.linspace(-0.6, 0.6, 50)
    lons = float(lon) + np.linspace(-0.8, 0.8, 70)
    rng = np.random.default_rng(8)
    src = jnc.Dataset(coords={"t": np.datetime64("2020-06-01T12:00", "ns")
                              + np.arange(2) * np.timedelta64(1, "h"), "lat": lats, "lon": lons})
    src["lat"] = jnc.DataArray(lats, dims=("lat",))
    src["lon"] = jnc.DataArray(lons, dims=("lon",))
    flux = rng.uniform(0, 1000, (2, 50, 70)).astype(np.float32)
    flux[0, :5] = np.nan
    src["toa_swup"] = jnc.DataArray(flux, dims=("t", "lat", "lon"), attrs={"units": "W m-2"})
    src["toa_lwup"] = jnc.DataArray(flux[1], dims=("lat", "lon"), attrs={"units": "W m-2"})
    path = _write(src, tmp_path / "flux.nc")
    args = [target, "-src", path, "-vars", "toa_swup", "toa_lwup"]
    want = jcli.main(args + ["-sd", str(tmp_path / "jax")])
    got = grid_flux.main(args + ["-sd", str(tmp_path / "port"), "--device", "cpu"])
    assert got.name == want.name
    _files_equal(got, want)


def test_grid_flux_native_cli(tmp_path):
    pytest.importorskip("h5py")
    from tobac_flow_tpu.cli import grid_flux_native as jcli
    from tobac_flow_tpu_torch.cli import grid_flux_native

    rng = np.random.default_rng(0)
    n, files = 500, []
    for i in range(2):
        ds = jnc.Dataset(coords={"t": np.asarray([np.datetime64("2020-06-01T00:00")
                                                  + np.timedelta64(1 - i, "h")]),
                                 "pix": np.arange(n)})
        ds["lat"] = jnc.DataArray(rng.uniform(-60, 60, n), dims=("pix",), name="lat")
        ds["lon"] = jnc.DataArray(rng.uniform(-60, 60, n), dims=("pix",), name="lon")
        ds["lat"].values[:3] = [-90.0, 90.0, 12.0]  # on the first and last edges, and on one
        for var in grid_flux_native.FLUX_VARS:
            for name in (var, f"{var}_clr"):
                ds[name] = jnc.DataArray(rng.uniform(0, 1000, n).astype(np.float32),
                                         dims=("pix",), name=name)
        files.append(_write(ds, tmp_path / f"flux_{i}.nc"))
    want = jcli.main(["-sd", str(tmp_path / "jax")] + files)
    got = grid_flux_native.main(["-sd", str(tmp_path / "port"), "--device", "cpu"] + files)
    assert got.name == want.name
    _files_equal(got, want)
    g = tnc.open_dataset(got)
    assert g["toa_swup"].values.shape == (2, 180, 360) and "toa_net_cre" in g.data_vars


def test_level2_writer_matches_the_reference_tests_craft():
    """``chip_smoke``'s writer frames a radial as ``tests/test_nexrad_level2.py``
    does: the reference's reader decodes it to the same values."""
    raw = np.array([66, 70, 0, 1, 200], np.uint8)
    _, radials = jlevel2.decode_archive_bytes(level2_archive([level2_radial(SITE, 90.0, 0.5, raw)]))
    (r,) = radials
    assert (r["azimuth"], r["elevation"], r["first_gate"], r["gate_spacing"]) == (
        90.0, 0.5, 2125.0, 250.0)
    np.testing.assert_array_equal(np.ma.filled(r["reflectivity"], np.nan),
                                  [0.0, 2.0, np.nan, np.nan, 67.0])
    assert bz2.decompress(level2_archive([b"x"])[28:]) == b"x"
    assert RADAR_ALT_EDGES.size == 21
