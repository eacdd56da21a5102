"""The port's statistics CLIs (``relabel_postprocess``,
``postprocess_dcc``, ``quick_fix`` and ``dcc_statistics``) against the
JAX package's, on the CPU: the same arguments and input files, each output
file held to the JAX CLI's.

Inputs: the four recorded JAX detection windows of
``tests/data/linking_windows.npz`` (``tests/test_torch_linking.py``), taken
through the JAX package's detection schema with pixel areas, latitude and
longitude from a seed, and linked by the JAX ``linking_parallel``; and,
for the statistics, which the recorded long-lived storm's single core
leaves nearly empty, three overlapping windows cut from the storm scene of
``tests/test_torch_postprocess.py``.  Auxiliary fields (CTT and CTH with
uncertainties, a flag field, fluxes) are made from a seed with numpy.
Tolerance: float64 to rtol 1e-12, float32 means and stds to 1e-5,
everything else identical (``chip_smoke.compare_datasets``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("h5py")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import LINKING_RECORD, compare_datasets, linking_record  # noqa: E402
from test_torch_postprocess import (  # noqa: E402
    _quiet, detected, field_dataset, fields, storm_scene,
)
from tobac_flow_tpu import schema as jschema  # noqa: E402
from tobac_flow_tpu.cli import dcc_statistics as jax_stats_cli  # noqa: E402
from tobac_flow_tpu.cli import linking_parallel as jax_linking_cli  # noqa: E402
from tobac_flow_tpu.cli import postprocess_dcc as jax_post_cli  # noqa: E402
from tobac_flow_tpu.cli import quick_fix as jax_fix_cli  # noqa: E402
from tobac_flow_tpu.cli import relabel_postprocess as jax_relabel_cli  # noqa: E402
from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu.detect.analysis import weighted_statistics_on_labels  # noqa: E402
from tobac_flow_tpu_torch.cli import (  # noqa: E402
    dcc_detect_seviri, dcc_detect_seviri_nat, dcc_statistics, dcc_validation, fix_seviri_dccs,
    grid_glm, postprocess_dcc, quick_fix, relabel_postprocess, seviri_cre_time_series,
)
from tobac_flow_tpu_torch.data.ncdataset import open_dataset as port_open  # noqa: E402
from tobac_flow_tpu_torch.utils.datetime_utils import get_dates_from_filename  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
LABELS = ("core_label", "thick_anvil_label", "thin_anvil_label")
STEPS = ("core_step", "thick_anvil_step", "thin_anvil_step")


def _schema(ds, start, end, step_offset=0):
    """The JAX package's detection schema on a dataset of label volumes
    and BT, in ``cli/common.run_detection``'s order; step labels numbered
    from ``step_offset`` + 1, as a linker numbers a later window's."""
    ds = jschema.add_label_coords(ds)
    jschema.link_cores_and_anvils(ds)
    jschema.add_step_labels(ds)
    for name in STEPS:
        vol = ds[f"{name}_label"].values
        vol[vol > 0] += step_offset
    ds = jschema.add_label_coords(ds)
    jschema.link_step_labels(ds)
    jschema.flag_edge_labels(ds, start, end)
    jschema.flag_nan_adjacent_labels(ds, ds["bt"])
    return ds


def _geo(ds, seed):
    rng = np.random.default_rng(seed)
    h, w = ds.coords["y"].size, ds.coords["x"].size
    ds["area"] = jnc.DataArray(rng.uniform(3.5, 4.5, (h, w)), dims=("y", "x"))
    ds["lat"] = jnc.DataArray(np.linspace(25, 35, h * w).reshape(h, w), dims=("y", "x"))
    ds["lon"] = jnc.DataArray(np.linspace(-100, -88, h * w).reshape(w, h).T, dims=("y", "x"))


def _field_file(path, shape, seed):
    field_dataset(jnc, fields(seed, shape)).to_netcdf(path)
    return path


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """The recorded windows as detection files (schema, areas, lat/lon,
    BT), their links file and a field file for each."""
    out = tmp_path_factory.mktemp("windows")
    rec = linking_record(DATA / LINKING_RECORD)
    files, field_files = [], []
    for i, (name, win) in enumerate(zip(rec["names"], rec["windows"])):
        ds = jnc.Dataset(coords=dict(win.coords))
        for var in LABELS + ("bt",):
            ds[var] = jnc.DataArray(np.copy(win[var].values), dims=("t", "y", "x"))
        start, end = get_dates_from_filename(name)
        with _quiet():
            ds = _schema(ds, start, end)
        _geo(ds, i)
        ds.to_netcdf(out / name)
        files.append(out / name)
        field_files.append(_field_file(out / f"fields_{i}.nc", ds["bt"].shape, 20 + i))
    links = jax_linking_cli.main(["-sd", str(out / "links")] + [str(f) for f in files])
    return files, Path(links), field_files


@pytest.fixture(scope="module")
def relabelled(windows, tmp_path_factory):
    """The JAX relabel_postprocess outputs of the recorded windows."""
    files, links, _ = windows
    out = tmp_path_factory.mktemp("jax_relabelled")
    with _quiet():
        return [Path(jax_relabel_cli.main([str(f), str(links), "-sd", str(out),
                                           "--save_spatial_props"])) for f in files]


@pytest.fixture(scope="module")
def storm_files(tmp_path_factory):
    """Three overlapping windows of the storm scene, whose labels are
    already one numbering (as linked files' are), with the JAX package's
    schema, label properties and per-step BT statistics: the files
    ``relabel_postprocess`` writes."""
    out = tmp_path_factory.mktemp("storm")
    scene = storm_scene()
    full = detected(jnc, scene)
    files = []
    for k, (lo, hi) in enumerate(((0, 6), (4, 10), (8, 12))):
        times = full.coords["t"][lo:hi]
        ds = jnc.Dataset(coords={"t": times, "y": full.coords["y"], "x": full.coords["x"]})
        for var in LABELS + ("bt",):
            ds[var] = jnc.DataArray(np.copy(full[var].values[lo:hi]), dims=("t", "y", "x"))
        for var in ("area", "lat", "lon"):
            ds[var] = full[var]
        with _quiet():
            ds = _schema(ds, None, None, step_offset=1000 * k)
            jschema.calculate_label_properties(ds)
            weights = np.repeat(ds["area"].values[np.newaxis], hi - lo, 0)
            for name in STEPS:
                for da in weighted_statistics_on_labels(ds[f"{name}_label"], ds["bt"], weights,
                                                        name=name, dim=name, dtype=np.float32):
                    ds[da.name] = da
        path = out / f"detected_dccs_SYN_S2020153{k:02d}0000_E2020153{k:02d}3000.nc"
        ds.drop_vars("bt").to_netcdf(path)
        files.append(path)
    return files


def _same_files(want, got):
    compare_datasets(jnc_open(want), port_open(got))


def jnc_open(path):
    return jnc.open_dataset(path)


@pytest.mark.parametrize("spatial", [False, True])
def test_relabel_postprocess(windows, tmp_path, spatial):
    """Relabel, label properties, the spatial properties where asked and
    the per-step BT statistics of each window, as the JAX CLI writes
    them."""
    files, links, _ = windows
    extra = ["--save_spatial_props"] if spatial else []
    for f in files:
        with _quiet():
            want = jax_relabel_cli.main([str(f), str(links), "-sd", str(tmp_path / "jax")]
                                        + extra)
        got = relabel_postprocess.main([str(f), str(links), "-sd", str(tmp_path / "port"),
                                        "--device", "cpu"] + extra)
        _same_files(want, got)
        assert "core_step_bt_mean" in port_open(got) and "bt" not in port_open(got)


def test_postprocess_dcc(relabelled, windows, tmp_path):
    """CTT and CTH with uncertainties and the TOA net CRE per label family,
    then the properties and flags, as the JAX CLI writes them."""
    args = ["-vars", "ctt", "cth", "toa_net_cre", "--cre"]
    # the last window holds no core, which the reference's properties need
    for f, fields_file in zip(relabelled[:3], windows[2]):
        with _quiet():
            want = jax_post_cli.main([str(f), "-fields", str(fields_file), "-sd",
                                      str(tmp_path / "jax")] + args)
        got = postprocess_dcc.main([str(f), "-fields", str(fields_file), "-sd",
                                    str(tmp_path / "port"), "--device", "cpu"] + args)
        _same_files(want, got)
        ds = port_open(got)
        assert "core_ctt_mean_combined_error" in ds and "thin_anvil_step_toa_net_cre_min" in ds


def test_postprocess_dcc_flags(relabelled, windows, tmp_path):
    """``-flags``: the weighted proportions of a flag field per label
    family, equal to the JAX package's ``add_weighted_proportions_to_dataset``
    on the JAX CLI's output."""
    from tobac_flow_tpu.schema.postprocess import add_weighted_proportions_to_dataset

    f, fields_file = relabelled[1], windows[2][1]
    got = port_open(postprocess_dcc.main([str(f), "-fields", str(fields_file), "-flags",
                                          "flag", "-sd", str(tmp_path), "--device", "cpu"]))
    want = jnc.open_dataset(f)
    flag = jnc.open_dataset(fields_file)["flag"]
    weights = np.repeat(want["area"].values[np.newaxis], want.coords["t"].size, 0)
    for dim, name in postprocess_dcc.FAMILIES:
        add_weighted_proportions_to_dataset(want, flag, weights, dim, dim_name=name)
        a, b = want[f"{name}_flag_proportion"], got[f"{name}_flag_proportion"]
        assert a.dims == b.dims
        np.testing.assert_allclose(b.values, a.values, rtol=1e-12, atol=0)


def test_quick_fix(windows, tmp_path):
    files, _, field_files = windows
    args = ["-vars", "ctt", "toa_swup", "missing"]
    for f, fields_file in zip(files[:2], field_files):
        with _quiet():
            want = jax_fix_cli.main([str(f), "-src", str(fields_file), "-sd",
                                     str(tmp_path / "jax")] + args)
        got = quick_fix.main([str(f), "-src", str(fields_file), "-sd", str(tmp_path / "port"),
                              "--device", "cpu"] + args)
        _same_files(want, got)


def test_dcc_statistics(storm_files, tmp_path):
    """Combine, filter, process and flag, as the JAX CLI writes it, over the
    storm windows, where cores and anvils survive the filters."""
    files = [str(f) for f in storm_files]
    with _quiet():
        want = jax_stats_cli.main(["-sd", str(tmp_path / "jax")] + files)
    got = dcc_statistics.main(["-sd", str(tmp_path / "port"), "--device", "cpu"] + files)
    _same_files(want, got)
    ds = port_open(got)
    assert ds.coords["core"].size and ds.coords["anvil"].size
    assert ds["core_is_valid"].values.any()


def test_dcc_statistics_without_surviving_cores(relabelled, tmp_path):
    """Over the recorded windows' relabelled files the one core fails the
    filters, and with it every anvil: the reference raises there
    (``filter_anvils`` compares its empty lifetimes, which keep the times'
    dtype, with a duration), the port returns the empty tables."""
    files = [str(f) for f in relabelled]
    with _quiet(), pytest.raises(TypeError, match="less"):
        jax_stats_cli.main(["-sd", str(tmp_path / "jax")] + files)
    ds = port_open(dcc_statistics.main(["-sd", str(tmp_path / "port"), "--device", "cpu"]
                                       + files))
    assert ds.coords["core"].size == 0 and ds.coords["anvil"].size == 0


def _combine_inputs(nc):
    """Two files' tables that overlap in cores 2 and 3 and anvil 1."""
    out = []
    for cores, anvils, edge, end, nan, cai, anvil_end in (
        ([1, 2, 3], [1], [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 0, 0], [0]),
        ([2, 3, 4], [1, 2], [1, 0, 1], [1, 1, 0], [0, 0, 1], [1, 2, 1], [1, 0]),
    ):
        ds = nc.Dataset(coords={"core": np.array(cores, np.int32),
                                "anvil": np.array(anvils, np.int32),
                                "core_step": np.array(cores, np.int32) * 10})
        for var, values in (("core_edge_label_flag", edge), ("core_end_label_flag", end),
                            ("core_nan_flag", nan)):
            ds[var] = nc.DataArray(np.array(values, bool), dims=("core",))
        ds["core_anvil_index"] = nc.DataArray(np.array(cai, np.int32), dims=("core",))
        ds["core_step_core_index"] = nc.DataArray(np.array(cores, np.int32), dims=("core_step",))
        ds["thick_anvil_end_label_flag"] = nc.DataArray(np.array(anvil_end, bool),
                                                        dims=("anvil",))
        out.append(ds)
    return out


def test_combine_datasets():
    """Overlapping labels keep the first file's values, with the edge and
    NaN flags ORed, the later file's end flag and an empty
    ``core_anvil_index`` filled from the later file, written in place into
    the first file's variables; new labels are appended."""
    from tobac_flow_tpu_torch.data import ncdataset as tnc

    want_in, got_in = _combine_inputs(jnc), _combine_inputs(tnc)
    want = jax_stats_cli.combine_datasets(want_in)
    got = dcc_statistics.combine_datasets(got_in)
    compare_datasets(want, got, rtol32=0.0, rtol64=0.0)
    assert got["core_edge_label_flag"].values.tolist() == [False, True, False, True]
    assert got["core_end_label_flag"].values.tolist() == [True, True, True, False]
    assert got["core_nan_flag"].values.tolist() == [False, True, False, True]
    assert got["core_anvil_index"].values.tolist() == [1, 1, 2, 1]
    assert got["thick_anvil_end_label_flag"].values.tolist() == [True, False]
    assert got_in[0]["core_anvil_index"].values.tolist() == [1, 1, 2]  # in place


CLIS = {"relabel_postprocess": (relabel_postprocess, ["F_S2020153000000_E2020153010000.nc",
                                                      "links.nc"]),
        "postprocess_dcc": (postprocess_dcc, ["F.nc", "-fields", "G.nc", "-vars", "ctt"]),
        "quick_fix": (quick_fix, ["F.nc", "-src", "G.nc", "-vars", "ctt"]),
        "dcc_statistics": (dcc_statistics, ["F.nc", "G.nc"]),
        "dcc_validation": (dcc_validation, ["F.nc", "-glm", "G.nc"]),
        "grid_glm": (grid_glm, ["F.nc", "-glm", "glm_dir"]),
        "dcc_detect_seviri_nat": (dcc_detect_seviri_nat, ["a.nat", "b.nat"]),
        "dcc_detect_seviri": (dcc_detect_seviri, ["F.nc", "G.nc"]),
        "fix_seviri_dccs": (fix_seviri_dccs, ["F.nc"]),
        "seviri_cre_time_series": (seviri_cre_time_series, ["F.nc"])}
# the passes and reads of the CLIs, none of which may run before the check
WORK = ("relabel_postprocess", "postprocess_dataset", "quick_fix", "dcc_statistics",
        "open_dataset", "validate_dataset", "gridded_flash_ds", "read_glm_flashes", "find_glm_files",
        "create_gridded_flash_ds", "detect_seviri_nat", "seviri_nat_dataloader",
        "seviri_dataloader", "run_detection", "fix_dataset", "fix_file", "cre_time_series")


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_raises_for_h5py_before_any_pass(tmp_path, monkeypatch, name):
    """Where h5py cannot be imported, each CLI raises naming it before it
    reads a file or runs a pass."""
    import builtins

    real_import = builtins.__import__

    def no_h5py(mod, *args, **kwargs):
        if mod == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(mod, *args, **kwargs)

    def no_pass(*args, **kwargs):
        raise AssertionError("a pass ran before the h5py check")

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    module, args = CLIS[name]
    for fn in WORK:
        if hasattr(module, fn):
            monkeypatch.setattr(module, fn, no_pass)
    with pytest.raises(ImportError, match="h5py"):
        module.main([str(tmp_path / a) if a.endswith(".nc") else a for a in args]
                    + ["-sd", str(tmp_path / "out"), "--device", "cpu"])
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", ["dcc_detect_seviri", "dcc_detect_seviri_nat", "dcc_validation",
                                  "fix_seviri_dccs", "grid_glm", "seviri_cre_time_series"])
def test_new_cli_runs_on_cuda_by_default(tmp_path, name):
    """Without ``--device`` each validation and SEVIRI CLI asks for CUDA
    before it reads a file, and raises where it is not available rather
    than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    module, args = CLIS[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        module.main([str(tmp_path / a) if a.endswith(".nc") else a for a in args]
                    + ["-sd", str(tmp_path / "out")])


def test_cli_runs_on_cuda_by_default(storm_files, tmp_path):
    """Without ``--device`` the CLI asks for CUDA, and raises where it is
    not available rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dcc_statistics.main(["-sd", str(tmp_path)] + [str(f) for f in storm_files])
