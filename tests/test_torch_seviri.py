"""The port's SEVIRI ingest and maintenance CLIs against the JAX package's,
on the CPU: the 10-bit packing and the Planck pair, ``write_nat``'s bytes
(identical), ``decode_nat``, ``seviri_nat_dataloader`` and
``seviri_dataloader`` under both channel naming schemes (equal bit for
bit, with their coordinates and attrs, gap frames included),
``fix_seviri_dccs.fix_file`` on the recorded synthetic detection file
(and on a copy with a BT field and the file-name period that the flags
read), and ``seviri_cre_time_series`` on two post-processed files that
the test writes.  Files go through h5py.  Inputs are made from a numpy
seed.  Tolerance: the decoded fields and loaders identical; the repaired
file and the CRE series by ``chip_smoke.compare_datasets`` (float64 to
rtol 1e-12, float32 means and stds to 1e-5, the rest identical).
"""

import shutil
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("h5py")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from chip_smoke import compare_datasets  # noqa: E402
from tobac_flow_tpu.cli import fix_seviri_dccs as jax_fix  # noqa: E402
from tobac_flow_tpu.cli import seviri_cre_time_series as jax_cre  # noqa: E402
from tobac_flow_tpu.data import dataloader as jloader  # noqa: E402
from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu.data import seviri_nat as jnat  # noqa: E402
from tobac_flow_tpu_torch.cli import fix_seviri_dccs, seviri_cre_time_series  # noqa: E402
from tobac_flow_tpu_torch.data import dataloader  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402
from tobac_flow_tpu_torch.data import seviri_nat  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
SYN = "detected_dccs_SYN_S20200601_000000_X0048_Y0032.nc"
T0 = datetime(2020, 6, 1, 12, 0)
IR = ("WV_062", "WV_073", "IR_087", "IR_108", "IR_120")
BASE = {"WV_062": 235.0, "WV_073": 245.0, "IR_087": 275.0, "IR_108": 280.0, "IR_120": 272.0}


def channels(seed, h=20, w=28):
    rng = np.random.default_rng(seed)
    return {ch: (BASE[ch] + rng.normal(0, 6, (h, w))).astype(np.float32) for ch in IR}


def test_10bit_round_trip():
    rng = np.random.default_rng(1)
    for n in (101, 4, 7, 1):
        v = rng.integers(0, 1024, n).astype(np.uint16)
        packed = seviri_nat.pack_10bit(v)
        assert packed == jnat.pack_10bit(v)
        assert np.array_equal(seviri_nat.unpack_10bit(packed, n), v)
        assert np.array_equal(seviri_nat.unpack_10bit(packed, n), jnat.unpack_10bit(packed, n))


def test_planck_pair():
    t = np.linspace(180.0, 320.0, 29)
    for ch in seviri_nat.PLANCK_COEFFS:
        rad = seviri_nat.radiance_from_bt(t, ch)
        assert np.array_equal(rad, jnat.radiance_from_bt(t, ch))
        assert np.array_equal(seviri_nat.bt_from_radiance(rad, ch), jnat.bt_from_radiance(rad, ch))
        np.testing.assert_allclose(seviri_nat.bt_from_radiance(rad, ch), t, atol=1e-6)


@pytest.mark.parametrize("calibration", ["fitted", "shared"])
def test_write_nat_bytes_and_decode(tmp_path, calibration):
    fields = channels(2, 13, 19)  # a width that pads each line's samples
    kw = {"cal_slope": 0.08, "cal_offset": 0.5} if calibration == "shared" else {}
    want = jnat.write_nat(tmp_path / "want.nat", fields, T0, **kw)
    got = seviri_nat.write_nat(tmp_path / "got.nat", fields, T0, **kw)
    assert Path(got).read_bytes() == Path(want).read_bytes()
    w_fields, w_meta, w_time = jnat.decode_nat(want)
    g_fields, g_meta, g_time = seviri_nat.decode_nat(want)
    assert (g_meta, g_time) == (w_meta, w_time) and g_time == T0
    assert list(g_fields) == list(w_fields)
    for ch, v in w_fields.items():
        assert g_fields[ch].dtype == v.dtype and np.array_equal(g_fields[ch], v, equal_nan=True)
        if calibration == "fitted":  # the counts' quantisation bounds the error
            np.testing.assert_allclose(v, fields[ch], atol=0.25)


def test_decode_rejects_other_files(tmp_path):
    bad = tmp_path / "x.nat"
    bad.write_bytes(b"FormatName : OTHER\n".ljust(4096, b"\0"))
    with pytest.raises(ValueError, match="native"):
        seviri_nat.decode_nat(bad)
    with pytest.raises(ValueError, match="native"):
        jnat.decode_nat(bad)
    good = seviri_nat.write_nat(tmp_path / "g.nat", channels(0, 4, 8), T0)
    Path(good).write_bytes(Path(good).read_bytes()[:-10])
    with pytest.raises(ValueError, match="truncated"):
        seviri_nat.decode_nat(good)


def _same_arrays(got, want):
    for g, w in zip(got, want):
        assert g.dims == w.dims and g.name == w.name and g.attrs == w.attrs
        assert set(g.coords) == set(w.coords)
        assert all(np.array_equal(g.coords[k], w.coords[k]) for k in w.coords)
        assert g.values.dtype == w.values.dtype
        assert np.array_equal(g.values, w.values, equal_nan=True)


# 15-minute scans with the fourth (+45 min) missing: a 30-minute gap
OFFSETS = (0, 15, 30, 60, 75)


def _nat_files(tmp_path):
    return [str(jnat.write_nat(tmp_path / f"MSG4-{k}.nat", channels(k),
                               T0 + timedelta(minutes=off)))
            for k, off in enumerate(OFFSETS)]


@pytest.mark.parametrize("window", ["all", "cropped"])
def test_seviri_nat_dataloader(tmp_path, window):
    paths = _nat_files(tmp_path)
    kw = {} if window == "all" else dict(x0=3, x1=21, y0=2, y1=15)
    start, end = (None, None) if window == "all" else (T0 + timedelta(minutes=10),
                                                       T0 + timedelta(minutes=80))
    want = jnat.seviri_nat_dataloader(start, end, paths[::-1], **kw)
    got = seviri_nat.seviri_nat_dataloader(start, end, paths[::-1], **kw)
    _same_arrays(got, want)
    bt = got[0].values
    assert np.isnan(bt).all(axis=(1, 2)).sum() == 1  # the gap frame
    assert (got[2].values[~np.isnan(bt)] >= 0).all()


@pytest.mark.parametrize("names", ["channels", "orac"])
def test_seviri_dataloader(tmp_path, names):
    paths = []
    for k, off in enumerate(OFFSETS):
        fields = channels(10 + k)
        ds = jnc.Dataset(coords={"t": np.array([np.datetime64(T0 + timedelta(minutes=off),
                                                              "ns")])})
        if names == "orac":
            fields = {"ch5": fields["WV_062"], "ch6": fields["WV_073"],
                      "ch9": fields["IR_108"], "ch10": fields["IR_120"]}
        for ch, v in fields.items():
            ds[ch] = jnc.DataArray(v.astype(np.float64), dims=("y", "x"))
        paths.append(str(tmp_path / f"seviri_{k}.nc"))
        ds.to_netcdf(paths[-1])
    want = jloader.seviri_dataloader(None, None, paths[::-1], x0=1, x1=25, y0=0, y1=17)
    got = dataloader.seviri_dataloader(None, None, paths[::-1], x0=1, x1=25, y0=0, y1=17)
    _same_arrays(got, want)
    assert np.isnan(got[0].values).all(axis=(1, 2)).sum() == 1


@pytest.fixture(scope="module")
def fix_inputs(tmp_path_factory):
    """The recorded synthetic detection file, and a copy named with its
    period that holds a BT field with a NaN patch."""
    d = tmp_path_factory.mktemp("fix_inputs")
    plain = d / SYN
    shutil.copy(DATA / SYN, plain)
    ds = tnc.open_dataset(plain)
    bt = np.full(ds["core_label"].shape, 250.0, np.float32)
    bt[3, 5:12, 8:20] = np.nan
    ds["bt"] = tnc.DataArray(bt, dims=("t", "y", "x"))
    named = d / "detected_dccs_SYN_S20200601_000000_E20200601_003000.nc"
    ds.to_netcdf(str(named))
    return {"plain": plain, "named": named}


@pytest.mark.parametrize("case", ["plain", "named"])
def test_fix_file(fix_inputs, tmp_path, case):
    path = fix_inputs[case]
    want = jax_fix.fix_file(path, tmp_path / "jax")
    got = fix_seviri_dccs.main(["-sd", str(tmp_path / "port"), "--device", "cpu", str(path)])
    assert [p.name for p in got] == [want.name]
    w, g = jnc.open_dataset(str(want)), tnc.open_dataset(str(got[0]))
    compare_datasets(w, g)
    for var in ("core_step_label", "core_step_core_index", "core_edge_label_flag",
                "core_total_area", "core_anvil_index"):
        assert var in g.data_vars, var
    if case == "named":
        assert g["core_nan_flag"].values.any() or g["thick_anvil_nan_flag"].values.any()


def _postprocessed(path, seed, hours):
    rng = np.random.default_rng(seed)
    ds = tnc.Dataset()
    for prefix, n in (("core_step", 30), ("thick_anvil_step", 25), ("thin_anvil_step", 22)):
        t = np.datetime64("2020-06-01T10:00", "ns") + rng.integers(
            0, hours * 3600, n).astype("timedelta64[s]")
        ds.coords[prefix] = np.arange(1, n + 1)
        ds[f"{prefix}_t"] = tnc.DataArray(t, dims=(prefix,))
        ds[f"{prefix}_area"] = tnc.DataArray(rng.uniform(10, 900, n), dims=(prefix,))
        for var in ("toa_net_cre", "toa_swup_cre", "toa_lwup_cre"):
            if prefix == "thin_anvil_step" and var == "toa_lwup_cre":
                continue  # a variable one family lacks
            ds[f"{prefix}_{var}_mean"] = tnc.DataArray(rng.normal(-50, 80, n).astype(np.float32),
                                                       dims=(prefix,))
    ds.to_netcdf(str(path))
    return str(path)


def test_cre_time_series(tmp_path):
    files = [_postprocessed(tmp_path / "a.nc", 0, 5), _postprocessed(tmp_path / "b.nc", 1, 3)]
    want = jax_cre.main(files + ["-sd", str(tmp_path / "jax")])
    got = seviri_cre_time_series.main(files + ["-sd", str(tmp_path / "port"), "--device", "cpu"])
    assert got.name == want.name == "cre_time_series.nc"
    w, g = jnc.open_dataset(str(want)), tnc.open_dataset(str(got))
    compare_datasets(w, g)
    assert "thin_anvil_step_toa_lwup_cre_hourly" not in g.data_vars
    assert g["core_step_toa_net_cre_hourly"].values.size >= 5
