"""The port's SEVIRI detection CLIs against the JAX package's, end to end
on the CPU: ``python -m tobac_flow_tpu_torch.cli.dcc_detect_seviri_nat
--device cpu`` over native archives and ``dcc_detect_seviri --device cpu``
over netCDF channel files must write the files that the JAX CLIs write
from the same scene, given the JAX CLIs' flows.

The scene is ``tests/test_dataloader.py``'s native-CLI scene (6 scans, 15
minutes apart, of 48x64: an advecting Gaussian anomaly in the five IR
channels) grown until every stage finds an object: its IR_108 cools by
40 K a scan at the centre instead of 8 (at 8, and at 12 to 24 K a scan
over 6 to 12 scans, no core lasts the four scans above 0.5 K/min that
``detect_cores`` asks for).  The native files hold 10-bit counts; the
netCDF files hold the fields as they are, so the two CLIs see different
fields (and SWD, where the native loader clips at 0).

The JAX CLIs take minutes on one core (their watershed compiles), so
their files and their flows are recorded in ``tests/data/seviri_cli/`` by
running this module from the repo root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_seviri_cli.py

Given the recorded flows, the port's files equal the JAX files: labels
identical, every other value as ``test_torch_schema.py`` holds the output
stages (float32 means and stds to rtol 1e-5, float64 to 1e-12, the rest
identical).
"""

import hashlib
import sys
from datetime import datetime, timedelta
from functools import partial
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("h5py")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import compare_datasets, manifest  # noqa: E402
from test_torch_schema import AREA_SUMS  # noqa: E402
from tobac_flow_tpu_torch.cli import dcc_detect_seviri, dcc_detect_seviri_nat  # noqa: E402
from tobac_flow_tpu_torch.core.flow import Flow  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402
from tobac_flow_tpu_torch.data.ncdataset import open_dataset  # noqa: E402
from tobac_flow_tpu_torch.data.seviri_nat import write_nat  # noqa: E402

RECORD = Path(__file__).resolve().parent / "data" / "seviri_cli"
NAME = "detected_dccs_SEVIRI_S20200601T120000.nc"
T0 = datetime(2020, 6, 1, 12, 0)
SCENE = (6, 48, 64)
COOLING = 40.0  # K a scan at the anomaly's centre (8 in the JAX package's test)
LABELS = ("core_label", "thick_anvil_label", "thin_anvil_label", "core_step_label",
          "thick_anvil_step_label", "thin_anvil_step_label")
CLIS = {"nat": dcc_detect_seviri_nat, "nc": dcc_detect_seviri}


def scene_fields(i, h, w):
    """The five IR channels of scan ``i``."""
    yy, xx = np.mgrid[0:h, 0:w]
    core = np.exp(-((xx - 16 - 2 * i) ** 2 + (yy - 20) ** 2) / 30.0)
    return {
        "WV_062": (235.0 + 12 * core).astype(np.float32),
        "WV_073": (245.0 - 2 * core).astype(np.float32),
        "IR_087": (275.0 - 20 * core).astype(np.float32),
        "IR_108": (280.0 - (20.0 + COOLING * i) * core).astype(np.float32),
        "IR_120": (272.0 - 18 * core).astype(np.float32),
    }


def write_scene(directory, kind, nc=tnc):
    """The scene's scans as native archives (``kind`` "nat") or netCDF
    channel files (``nc``'s Dataset) in ``directory``: their paths."""
    t, h, w = SCENE
    paths = []
    for i in range(t):
        fields, ti = scene_fields(i, h, w), T0 + timedelta(minutes=15 * i)
        if kind == "nat":
            paths.append(str(write_nat(Path(directory) / f"f{i}.nat", fields, ti)))
            continue
        ds = nc.Dataset(coords={"t": np.array([np.datetime64(ti, "ns")])})
        for ch, v in fields.items():
            ds[ch] = nc.DataArray(v, dims=("y", "x"))
        paths.append(str(Path(directory) / f"seviri_{i}.nc"))
        ds.to_netcdf(paths[-1])
    return paths


def cli_args(kind, paths, out):
    return ["-sd", str(out)] + paths if kind == "nat" else paths + ["-sd", str(out)]


def bt_hash(bt):
    return hashlib.sha256(np.ascontiguousarray(bt).tobytes()).hexdigest()


@pytest.mark.parametrize("kind", sorted(CLIS))
def test_cli_given_jax_flows_writes_the_reference_file(tmp_path, monkeypatch, kind):
    recorded = dict(np.load(RECORD / f"{kind}_flows.npz"))
    flow = Flow.from_numpy(recorded["fwd"], recorded["bwd"], device="cpu")
    seen = {}

    def given(bt):
        seen["bt"] = bt.values
        return flow

    module = CLIS[kind]
    # both CLIs detect through dcc_detect_seviri_nat.detect_fields
    monkeypatch.setattr(dcc_detect_seviri_nat, "DetectionOptions",
                        partial(dcc_detect_seviri_nat.DetectionOptions, flow_factory=given))
    (tmp_path / "in").mkdir()
    paths = write_scene(tmp_path / "in", kind)
    got = module.main(cli_args(kind, paths, tmp_path / "out") + ["--device", "cpu"])
    assert bt_hash(seen["bt"]) == str(recorded["bt_sha256"]), "the recording is stale"
    assert got.name == NAME and [p.name for p in got.parent.iterdir()] == [NAME]
    want, got = open_dataset(RECORD / kind / NAME), open_dataset(got)
    assert manifest(got) == manifest(want)
    for name in ("core", "anvil", "core_step", "thick_anvil_step", "thin_anvil_step"):
        assert want.coords[name].size > 0, name  # every stage found an object
    for name in LABELS:
        assert np.array_equal(want[name].values, got[name].values), name
    compare_datasets(want, got, loose=AREA_SUMS)


def test_nat_detection_in_memory_needs_no_h5py(tmp_path, monkeypatch):
    """``detect_seviri_nat`` decodes and detects where h5py cannot be
    imported, cropped to ``-x0..-y1``; the dataset it returns is the
    CLI's up to the file."""
    recorded = dict(np.load(RECORD / "nat_flows.npz"))
    flow = Flow.from_numpy(recorded["fwd"][:, 4:44, 2:62], recorded["bwd"][:, 4:44, 2:62],
                           device="cpu")
    monkeypatch.setattr(dcc_detect_seviri_nat, "DetectionOptions", partial(
        dcc_detect_seviri_nat.DetectionOptions, flow_factory=lambda bt: flow))
    paths = write_scene(tmp_path, "nat")
    monkeypatch.setitem(sys.modules, "h5py", None)
    ds, name = dcc_detect_seviri_nat.detect_seviri_nat(paths, x0=2, x1=62, y0=4, y1=44,
                                                       device="cpu")
    assert name == NAME and ds["core_label"].shape == (6, 40, 60)
    assert ds.coords["core"].size > 0 and ds.coords["anvil"].size > 0


if __name__ == "__main__":
    import tempfile

    from tobac_flow_tpu.cli import dcc_detect_seviri as jax_seviri
    from tobac_flow_tpu.cli import dcc_detect_seviri_nat as jax_nat
    from tobac_flow_tpu.core.flow import create_flow as jax_create_flow
    from tobac_flow_tpu.data import ncdataset as jax_nc

    for kind, cli in (("nat", jax_nat), ("nc", jax_seviri)):
        seen = {}

        def recording(bt):
            flow = jax_create_flow(bt, vr_steps=1, smoothing_passes=1, interp_method="cubic")
            seen.update(fwd=np.asarray(flow.forward_flow), bwd=np.asarray(flow.backward_flow),
                        bt=np.asarray(getattr(bt, "values", bt)))
            return flow

        options = cli.DetectionOptions
        cli.DetectionOptions = partial(options, flow_factory=recording)
        (RECORD / kind).mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory() as tmp:
            print("recorded", cli.main(cli_args(kind, write_scene(tmp, kind, jax_nc),
                                                RECORD / kind)))
        cli.DetectionOptions = options
        np.savez_compressed(RECORD / f"{kind}_flows.npz", fwd=seen["fwd"], bwd=seen["bwd"],
                            bt_sha256=bt_hash(seen["bt"]))
        print("recorded", RECORD / f"{kind}_flows.npz")
