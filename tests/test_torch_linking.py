"""The port's cross-file linking (``tobac_flow_tpu_torch/track/`` and its
four CLIs) against the JAX package's, on the CPU.

The inputs are four detection windows of the JAX package, in
``tests/test_linking.py``'s layout (three overlapping windows, then one
after a time gap), recorded in ``tests/data/linking_windows.npz`` with
the JAX linkers' outputs on them.  The JAX detection takes minutes on one
core, so the windows are recorded by running this module from the repo
root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_linking.py

The JAX package's linking is numpy and runs live here; the record's
outputs are held to it, and ``chip_smoke.py`` holds the card to the
record.  The port runs with ``device="cpu"``, whole and under a budget
that puts every pass over a volume into time chunks
(``device.frames_budget``).  Tolerance: exact equality of every
variable, coordinate and attribute.
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

from chip_smoke import (  # noqa: E402
    LINKING_RECORD, LINK_CHUNK_FRAMES, compare_datasets, linking_record, most_chunks,
)
from tobac_flow_tpu.data.ncdataset import Dataset as JaxDataset  # noqa: E402
from tobac_flow_tpu.data.ncdataset import open_dataset as jax_open  # noqa: E402
from tobac_flow_tpu.track import file_linker as jax_file_linker  # noqa: E402
from tobac_flow_tpu.track import linking as jax_linking  # noqa: E402
from tobac_flow_tpu_torch import device as port_device  # noqa: E402
from tobac_flow_tpu_torch.data.ncdataset import open_dataset as port_open  # noqa: E402
from tobac_flow_tpu_torch.track import file_linker, linking  # noqa: E402
from tobac_flow_tpu_torch.track.store import MemoryStore  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
FORCED = port_device.frames_budget(LINK_CHUNK_FRAMES)
BUDGETS = {"whole": None, "chunked": FORCED}


@pytest.fixture(scope="module")
def record():
    return linking_record(DATA / LINKING_RECORD)


@pytest.fixture(scope="module")
def window_files(record, tmp_path_factory):
    """The recorded windows as detection files."""
    out = tmp_path_factory.mktemp("windows")
    files = []
    for name, ds in zip(record["names"], record["windows"]):
        ds.to_netcdf(out / name)
        files.append(out / name)
    return files


def _same(want, got):
    """``got`` holds ``want``'s variables, coordinates and attributes, all
    values identical."""
    compare_datasets(want, got, rtol32=0.0, rtol64=0.0)


def _same_files(want, got):
    assert [Path(p).name for p in want] == [Path(p).name for p in got]
    for a, b in zip(want, got):
        _same(port_open(a), port_open(b))


def _jax_outputs(files, out):
    file_out = jax_file_linker.FileLinker(files, out / "file").process_files()
    label = jax_file_linker.LabelLinker(files, output_path=out / "label")
    label.link_all()
    label_out = label.output_files()
    results = [jax_linking.find_overlap_between_files(a, b) for a, b in zip(files[:-1], files[1:])]
    links = jax_linking.process_linking_output(results)
    batch = [jax_linking.relabel_file(f, links) for f in files]
    return ([jax_open(p) for p in file_out], [jax_open(p) for p in label_out], batch, label)


@pytest.fixture(scope="module")
def jax_outputs(window_files, tmp_path_factory):
    return _jax_outputs(window_files, tmp_path_factory.mktemp("jax"))


def test_record_matches_the_jax_linkers(record, jax_outputs):
    """The record's outputs are the JAX linkers' outputs on its windows,
    and its windows have what the tests need: a core in the three
    overlapping windows, linked cores and anvils, a NaN patch that flags
    an object."""
    file_out, label_out, batch, _ = jax_outputs
    for key, live in (("file", file_out), ("label", label_out), ("batch", batch)):
        for want, got in zip(record[key], live):
            for name, values in want.items():
                assert np.array_equal(values, got[name].values if name in got.data_vars
                                      else got.coords[name]), (key, name)
    ids = [set(np.unique(ds["core_label"].values)) - {0} for ds in file_out]
    assert ids[0] & ids[1] & ids[2] and not ids[2] & ids[3]
    assert any(bool(ds["thick_anvil_nan_flag"].values.any()) for ds in file_out)
    for key in ("core", "anvil"):
        assert (getattr(jax_outputs[3], f"{key}_label_map")
                != np.arange(getattr(jax_outputs[3], f"{key}_label_map").size)).any(), key


def _random_pair(seed, shared):
    rng = np.random.default_rng(seed)
    t, h, w = 7, 6, 5
    times = np.datetime64("2020-06-01", "ns") + np.arange(t) * np.timedelta64(300, "s")
    a = rng.integers(0, 6, (t, h, w)).astype(np.int32)
    b = rng.integers(0, 9, (t, h, w)).astype(np.int32)
    # a block of shared frames where b copies a's labels, some shifted
    b[: min(shared, t)] = np.where(rng.random((min(shared, t), h, w)) < 0.7,
                                  a[t - min(shared, t):] + 2, b[: min(shared, t)])
    return a, times, b, times + (t - shared) * np.timedelta64(300, "s")


@pytest.mark.parametrize("shared", [0, 1, 2, 3, 5, 7])
@pytest.mark.parametrize("atol,rtol", [(5, 0.5), (1, 0.0), (4, 0.25), (0, 1.0)])
@pytest.mark.parametrize("budget", list(BUDGETS))
def test_find_overlap_between_labels(shared, atol, rtol, budget):
    a, ta, b, tb = _random_pair(shared * 10 + atol, shared)
    want = jax_linking.find_overlap_between_labels(a, ta, b, tb, atol=atol, rtol=rtol)
    got = linking.find_overlap_between_labels(a, ta, b, tb, atol=atol, rtol=rtol, device="cpu",
                                              budget_bytes=BUDGETS[budget])
    assert got[:2] == want[:2]
    for x, y in zip(got[2:], want[2:]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    if shared <= 2:
        assert got[2].size == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("atol,rtol", [(0, 0.0), (3, 0.3)])
def test_link_labels(seed, atol, rtol):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 12, (40, 30))
    b = np.where(rng.random((40, 30)) < 0.6, a * 3 % 17, rng.integers(0, 17, (40, 30)))
    want = jax_linking.link_labels(a, b, atol=atol, rtol=rtol)
    got = linking.link_labels(a, b, atol=atol, rtol=rtol, device="cpu")
    for x, y in zip(got, want):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_process_linking_output(seed):
    """Random overlap results, including a file with no labels and pairs
    with no edges; components numbered by first appearance."""
    rng = np.random.default_rng(seed)
    maxes = rng.integers(0, 9, 5)
    results = []
    for i in range(4):
        n = int(rng.integers(0, 6)) if maxes[i] and maxes[i + 1] else 0
        x = np.sort(rng.integers(1, maxes[i] + 1, n)) if n else np.empty(0, np.int64)
        y = rng.integers(1, maxes[i + 1] + 1, n) if n else np.empty(0, np.int64)
        pair = (int(maxes[i]), int(maxes[i + 1]), x.astype(np.int64), y.astype(np.int64))
        results.append({"filename_1": f"f{i}", "filename_2": f"f{i + 1}", "core": pair,
                        "anvil": pair[:2] + (y[:0], y[:0])})
    want = jax_linking.process_linking_output(results)
    got = linking.process_linking_output(results)
    for name in ("core_start", "anvil_start", "core_labels", "anvil_labels"):
        assert want[name].values.dtype == got[name].values.dtype
        assert np.array_equal(want[name].values, got[name].values), name
    for name in ("previous_filename", "next_filename"):
        assert list(want[name].values) == list(got[name].values)
    assert list(want.coords["filename"]) == list(got.coords["filename"])


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_batch_path(window_files, jax_outputs, budget):
    """``find_overlap_between_files`` → ``process_linking_output`` →
    ``relabel_file``: the JAX batch path's datasets and written files."""
    results = [linking.find_overlap_between_files(a, b, device="cpu",
                                                  budget_bytes=BUDGETS[budget])
               for a, b in zip(window_files[:-1], window_files[1:])]
    want_results = [jax_linking.find_overlap_between_files(a, b)
                    for a, b in zip(window_files[:-1], window_files[1:])]
    for got, want in zip(results, want_results):
        for key in ("core", "anvil"):
            assert got[key][:2] == want[key][:2]
            assert all(np.array_equal(x, y) for x, y in zip(got[key][2:], want[key][2:]))
    links = linking.process_linking_output(results)
    for f, want in zip(window_files, jax_outputs[2]):
        got = linking.relabel_file(f, links, device="cpu", budget_bytes=BUDGETS[budget])
        _same(want, got)


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_file_linker(window_files, jax_outputs, tmp_path, budget):
    """FileLinker's files equal the JAX FileLinker's, two datasets resident
    at most; under the forced budget every pass over a volume runs in at
    least 3 chunks."""
    linker = file_linker.FileLinker(window_files, tmp_path, device="cpu",
                                    budget_bytes=BUDGETS[budget])
    outputs = linker.process_files()
    assert linker.max_open_datasets <= 2
    for want, got in zip(jax_outputs[0], outputs):
        _same(want, port_open(got))
    if budget == "chunked":
        most = most_chunks(linker.passes)
        assert min(most.values()) >= 3, most


@pytest.mark.parametrize("budget", list(BUDGETS))
def test_label_linker(window_files, jax_outputs, tmp_path, budget):
    """LabelLinker's maps and files equal the JAX LabelLinker's (its
    defaults, atol 1 and rtol 0), two datasets resident at most."""
    linker = file_linker.LabelLinker(window_files, output_path=tmp_path, device="cpu",
                                     budget_bytes=BUDGETS[budget])
    linker.link_all()
    want = jax_outputs[3]
    assert np.array_equal(linker.core_label_map, want.core_label_map)
    assert np.array_equal(linker.anvil_label_map, want.anvil_label_map)
    outputs = linker.output_files()
    assert linker.max_open_datasets <= 2
    for want_ds, got in zip(jax_outputs[1], outputs):
        _same(want_ds, port_open(got))
    if budget == "chunked":
        most = most_chunks(linker.passes)
        assert min(most.values()) >= 3, most


@pytest.mark.parametrize("hops", [0, 1, 2, 3])
def test_label_linker_pointer_convergence(window_files, hops):
    """A chain of pointers converges within ``hops`` iterations, or raises,
    as the reference's does."""
    chain = np.array([0, 1, 1, 2, 3, 4, 5, 6], dtype=np.int64)
    outcomes = []
    for module, kw in ((jax_file_linker, {}), (file_linker, {"device": "cpu"})):
        linker = module.LabelLinker(window_files, max_convergence_iterations=hops, **kw)
        try:
            outcomes.append(linker._converge(chain.copy(), "core"))
        except ValueError as err:
            assert "failed to converge" in str(err)
            outcomes.append(None)
    assert (outcomes[0] is None) == (outcomes[1] is None)
    if outcomes[0] is not None:
        assert np.array_equal(outcomes[0], outcomes[1])


def test_linkers_in_memory(record):
    """Both linkers over in-memory datasets (``MemoryStore``, no files)
    give the record's outputs."""
    store = MemoryStore(dict(zip(record["names"], record["windows"])))
    out = file_linker.FileLinker(record["names"], device="cpu", store=store).process_files()
    for want, path in zip(record["file"], out):
        got = store.saved[str(path)]
        for name, values in want.items():
            assert np.array_equal(values, got[name].values if name in got.data_vars
                                  else got.coords[name]), name


@pytest.mark.parametrize("entry", ["find_overlap_between_labels", "link_labels",
                                   "relabel_dataset", "FileLinker", "LabelLinker"])
def test_entry_points_run_on_cuda_by_default(window_files, record, entry):
    """Without ``device`` every entry point asks for CUDA, and raises where
    it is not available rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the default runs on the card")
    a, b = record["windows"][:2]
    calls = {
        "find_overlap_between_labels": lambda: linking.find_overlap_between_labels(
            a["core_label"], a.coords["t"], b["core_label"], b.coords["t"]),
        "link_labels": lambda: linking.link_labels(a["core_label"], a["core_label"]),
        "relabel_dataset": lambda: linking.relabel_dataset(
            a, linking.process_linking_output([linking.find_overlap_between_files(
                *window_files[:2], device="cpu")]), window_files[0]),
        "FileLinker": lambda: file_linker.FileLinker(window_files),
        "LabelLinker": lambda: file_linker.LabelLinker(window_files),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()


CLIS = ["link_dcc_files", "link_dcc_files_label", "combine_dccs", "linking_parallel",
        "linking_parallel_threads", "relabel_linked_files"]


def _cli(name):
    from importlib import import_module

    base = name.replace("_label", "").replace("_threads", "")
    return (import_module(f"tobac_flow_tpu.cli.{base}"),
            import_module(f"tobac_flow_tpu_torch.cli.{base}"))


@pytest.mark.parametrize("name", CLIS)
def test_cli_writes_the_reference_files(window_files, tmp_path, name):
    """Each CLI writes the JAX CLI's files from the same arguments."""
    jax_cli, port_cli = _cli(name)
    files = [str(f) for f in window_files]
    extra = {"link_dcc_files_label": ["--linker", "label"],
             "linking_parallel_threads": ["-p", "2"]}.get(name, [])
    if name == "relabel_linked_files":
        from tobac_flow_tpu.cli import linking_parallel

        links = linking_parallel.main(["-sd", str(tmp_path / "links")] + files)
        extra = ["-links", str(links)]
    want = jax_cli.main(["-sd", str(tmp_path / "jax")] + extra[:0 if "-p" in extra else None]
                        + files)
    got = port_cli.main(["-sd", str(tmp_path / "port"), "--device", "cpu"] + extra + files)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    _same_files(want, got)


@pytest.mark.parametrize("name", ["link_dcc_files", "combine_dccs", "linking_parallel",
                                  "relabel_linked_files"])
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
    for module in (linking, file_linker):
        monkeypatch.setattr(module, "find_overlap_between_labels", no_pass)
    monkeypatch.setattr(file_linker.FileLinker, "__init__", no_pass)
    monkeypatch.setattr(file_linker.LabelLinker, "__init__", no_pass)
    monkeypatch.setattr(linking, "relabel_dataset", no_pass)
    _, port_cli = _cli(name)
    args = ["-sd", str(tmp_path), "--device", "cpu", str(tmp_path / "a_S2020153000000_E2020153010000.nc"),
            str(tmp_path / "b_S2020153010000_E2020153020000.nc")]
    if name == "relabel_linked_files":
        args = ["-links", str(tmp_path / "links.nc")] + args
    with pytest.raises(ImportError, match="h5py"):
        port_cli.main(args)
    assert not list(tmp_path.iterdir())


# -- recording ---------------------------------------------------------------


def record_windows(path):
    """Run the JAX detection over the layout's windows of
    ``test_linking._long_lived_scene``, add the BT (rounded to 0.1 K, as
    recorded) with a NaN patch over the storm in one window, and write the
    windows and the JAX linkers' outputs on them to ``path``."""
    import tempfile

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from chip_smoke import LINK_LAYOUT, LINK_NAN_PATCH, LINK_SCENE, linking_window_name
    from test_linking import _long_lived_scene
    from tobac_flow_tpu.cli.common import DetectionOptions, run_detection

    t, h, w = LINK_SCENE
    bt, wvd, swd = _long_lived_scene(t, h, w, seed=0)
    arrays = {"layout": np.asarray(LINK_LAYOUT), "scene": np.asarray(LINK_SCENE)}
    opts = DetectionOptions(save_label_props=False, save_field_props=False)
    for i, (t0, nt, _, _) in enumerate(LINK_LAYOUT):
        sl = slice(t0, t0 + nt)
        ds = JaxDataset(coords={"t": bt.coords["t"][sl], "y": bt.coords["y"],
                                "x": bt.coords["x"]})
        ds = run_detection(bt[sl], wvd[sl], swd[sl], ds, opts=opts)
        for name in ("core_label", "thick_anvil_label", "thin_anvil_label", "core_anvil_index"):
            arrays[f"w{i}_{name}"] = ds[name].values
        for name in ("core", "anvil"):
            arrays[f"w{i}_c_{name}"] = ds.coords[name]
        tenths = np.round(bt[sl].values.astype(np.float64) * 10).astype(np.int16)
        if i == LINK_NAN_PATCH[0]:
            frame, ys, xs = LINK_NAN_PATCH[1:]
            tenths[frame, ys[0]:ys[1], xs[0]:xs[1]] = np.iinfo(np.int16).min
        arrays[f"w{i}_bt_tenths"] = tenths
        print(i, ds["core_label"].values.max(), ds["thick_anvil_label"].values.max(), flush=True)
    np.savez_compressed(path, **arrays)
    rec = linking_record(path)
    with tempfile.TemporaryDirectory() as tmp:
        files = []
        for name, ds in zip(rec["names"], rec["windows"]):
            ds.to_netcdf(Path(tmp) / name)
            files.append(Path(tmp) / name)
        file_out, label_out, batch, _ = _jax_outputs(files, Path(tmp))
    for key, outs in (("file", file_out), ("label", label_out), ("batch", batch)):
        for i, ds in enumerate(outs):
            for name, var in ds.data_vars.items():
                if name != "bt":
                    arrays[f"{key}{i}_{name}"] = var.values
            for name, coord in ds.coords.items():
                if name not in ("t", "y", "x"):
                    arrays[f"{key}{i}_c_{name}"] = coord
    np.savez_compressed(path, **arrays)
    assert linking_window_name  # the names come from the layout
    print(f"wrote {path} ({Path(path).stat().st_size} bytes)")


if __name__ == "__main__":
    record_windows(DATA / LINKING_RECORD)
