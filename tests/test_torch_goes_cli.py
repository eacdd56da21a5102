"""The port's GOES detection CLI against the JAX package's, end to end:
``python -m tobac_flow_tpu_torch.cli.dcc_detect_goes --device cpu`` must
write the file that ``python -m tobac_flow_tpu.cli.dcc_detect_goes`` writes
from the same MCMIP archive with the same arguments.

The archive holds ``chip_smoke.goes_frames(GOES_SMALL, GOES_SMALL_MISSING,
GOES_SMALL_ORIGIN)`` as one file per frame: ``make_multistorm_scene``'s
fields at the CONUS sector's centre, a DQF box, a flagged row, and three
missing frames, which the ingest fills with one NaN frame.  It is the
smallest scene tried with a gap frame at which every stage finds an
object (13x32x48 less frames 8-10; with the gap in the middle of the scene
no core survives, with it at frames 5-7 or 6-8 no anvil does).

The JAX package's CLI takes minutes on one core (its watershed compiles),
so its file and its CLI-default flows are recorded in ``tests/data/`` by
running this module from the repo root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_goes_cli.py

- Free-running, both files hold the same variables with the same dims,
  dtypes, shapes and attrs, and the same coordinates; every label set has
  the reference's object count and a mean object IoU >= 0.99.
- Given JAX's recorded flows, the port's CLI writes the reference's file:
  labels identical, and every value as ``test_torch_schema.py`` holds the
  output stages (float32 means and stds and the float32 area sums to rtol
  1e-5, float64 to 1e-12, the rest identical).
- The port's CLI-default flow equals JAX's (zero) on the two pairs around
  the NaN frame, and is within the CPU tests' Farneback tolerance of it in
  the storm mask on every frame where JAX's own two flow functions agree
  to a tenth of that.
- Without h5py the CLI raises, naming it, before any file is read.
"""

import hashlib
import os
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("h5py")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import (  # noqa: E402
    GOES_SMALL, GOES_SMALL_MISSING, GOES_SMALL_ORIGIN, compare_datasets, manifest,
)
from test_torch_goes_ingest import write_archive  # noqa: E402
from test_torch_schema import AREA_SUMS  # noqa: E402
from tobac_flow_tpu_torch.cli import dcc_detect_goes  # noqa: E402
from tobac_flow_tpu_torch.core.flow import Flow, create_flow  # noqa: E402
from tobac_flow_tpu_torch.data.ncdataset import open_dataset  # noqa: E402
from tools.parity_detect import object_iou  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
NAME = "detected_dccs_G16_S20200601_000000_E20200601_010000_X0000_0000_Y0000_0000.nc"
FLOWS = DATA / "goes_cli_flows.npz"
LABELS = ("core_label", "thick_anvil_label", "thin_anvil_label", "core_step_label",
          "thick_anvil_step_label", "thin_anvil_step_label")
GAP = GOES_SMALL_MISSING[0]  # the NaN frame's index after the gap fill


def cli_args(archive, out):
    return ["2020-06-01", "-hours", str(GOES_SMALL[0] * 5 / 60), "-gd", str(archive),
            "-sd", str(out), "--n_pad_files", "0"]


def bt_hash(bt):
    return hashlib.sha256(np.ascontiguousarray(bt).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    os.environ["TFT_OFFLINE"] = "1"
    directory = tmp_path_factory.mktemp("goes_data")
    write_archive(directory, GOES_SMALL, GOES_SMALL_MISSING, GOES_SMALL_ORIGIN)
    return directory


@pytest.fixture(scope="module")
def recorded():
    return dict(np.load(FLOWS))


@pytest.fixture(scope="module")
def port_file(archive, tmp_path_factory):
    out = tmp_path_factory.mktemp("port")
    path = dcc_detect_goes.main(cli_args(archive, out) + ["--device", "cpu"])
    assert path.name == NAME and [p.name for p in out.iterdir()] == [NAME]
    return path


@pytest.fixture(scope="module")
def forced_file(archive, recorded, tmp_path_factory):
    """The port's CLI given JAX's recorded flows."""
    out = tmp_path_factory.mktemp("forced")
    flow = Flow.from_numpy(recorded["fwd"], recorded["bwd"], device="cpu")
    seen = {}

    def given(bt):
        seen["bt"] = bt.values
        return flow

    options = dcc_detect_goes.DetectionOptions
    dcc_detect_goes.DetectionOptions = partial(options, flow_factory=given)
    try:
        path = dcc_detect_goes.main(cli_args(archive, out) + ["--device", "cpu"])
    finally:
        dcc_detect_goes.DetectionOptions = options
    assert bt_hash(seen["bt"]) == str(recorded["bt_sha256"]), "the recording is stale"
    return path


def test_cli_writes_the_reference_file(port_file):
    want, got = open_dataset(DATA / NAME), open_dataset(port_file)
    assert manifest(got) == manifest(want)
    assert {"lat", "lon", "area"} <= set(got.data_vars)
    for name in ("core", "anvil", "core_step", "thick_anvil_step", "thin_anvil_step"):
        assert want.coords[name].size > 0, name
    assert np.isnan(got["area"].values).sum() == 0
    for name in LABELS:
        mean_iou, _, n_ref, n_port = object_iou(want[name].values, got[name].values)
        assert n_port == n_ref and mean_iou >= 0.99, (name, mean_iou, n_ref, n_port)


def test_cli_given_jax_flows_writes_the_reference_values(forced_file):
    want, got = open_dataset(DATA / NAME), open_dataset(forced_file)
    for name in LABELS:
        assert np.array_equal(want[name].values, got[name].values), name
    assert want["t"].values[GAP] == got["t"].values[GAP]
    compare_datasets(want, got, loose=AREA_SUMS)


def test_cli_default_flow_at_the_gap(archive, recorded):
    """The port's CLI-default flow against JAX's on the loaded fields (a
    NaN frame at GAP).  Both pairs around the NaN frame quantise to copies
    of their real frame, so both packages' flows there are zero: identical.
    Elsewhere the refined flow is chaotic where the field is noise: within
    the Farneback tolerance in the storm mask on every frame where JAX's
    own two flow functions agree to a tenth of it (on frames where they
    agree only just inside it, the port lands as close to JAX, p99 up to
    1.04e-2 against JAX's own 9.5e-3)."""
    from tobac_flow_tpu_torch.data.dataloader import goes_dataloader

    bt = goes_dataloader(*(dcc_detect_goes.parse_date(d) for d in (
        "2020-06-01 00:00", "2020-06-01 01:05")), n_pad_files=0, save_dir=archive)[0].values
    assert bt_hash(bt) == str(recorded["bt_sha256"]) and np.isnan(bt[GAP]).all()
    flow = create_flow(bt, vr_steps=1, smoothing_passes=1, interp_method="cubic", device="cpu")
    storm = np.nan_to_num(bt, nan=np.inf) < 250
    checked = 0
    for out, key, gap in ((flow.forward_flow, "fwd", (GAP - 1, GAP)),
                          (flow.backward_flow, "bwd", (GAP, GAP + 1))):
        out, want, again = out.numpy(), recorded[key], recorded[key + "_again"]
        assert out.shape == want.shape and np.abs(out).max() <= 20.0
        for t in range(bt.shape[0]):
            if t in gap:
                assert np.array_equal(out[t], want[t]) and not want[t].any(), (key, t)
            elif storm[t].any() and _within(again[t], want[t], storm[t], 0.1):
                assert _within(out[t], want[t], storm[t]), (key, t)
                checked += 1
    assert checked >= 3


def _within(out, want, mask, scale=1.0):
    """The CPU tests' Farneback tolerance inside ``mask``, its bounds on
    the differences times ``scale``."""
    diff = np.abs(out - want)[mask]
    return bool(np.percentile(diff, 99) <= 0.01 * scale and diff.max() <= 0.1 * scale
                and (np.round(out) == np.round(want))[mask].mean() >= 0.999)


def test_missing_h5py_raises_before_any_read(tmp_path, monkeypatch):
    from tobac_flow_tpu_torch.data import dataloader

    def no_read(*args, **kwargs):
        raise AssertionError("a file was read")

    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(dataloader, "open_dataset", no_read)
    monkeypatch.setattr(dcc_detect_goes, "goes_dataloader", no_read)
    with pytest.raises(ImportError, match="h5py"):
        dcc_detect_goes.main(cli_args(tmp_path / "goes_data", tmp_path / "out")
                             + ["--device", "cpu"])
    assert list(tmp_path.iterdir()) == []


if __name__ == "__main__":
    import tempfile

    from tobac_flow_tpu import pipeline as jax_pipeline
    from tobac_flow_tpu.cli import dcc_detect_goes as jax_cli
    from tobac_flow_tpu.core.flow import create_flow as jax_create_flow
    from tobac_flow_tpu.data.dataloader import goes_dataloader as jax_loader

    os.environ["TFT_OFFLINE"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        write_archive(tmp, GOES_SMALL, GOES_SMALL_MISSING, GOES_SMALL_ORIGIN)
        print("recorded", jax_cli.main(cli_args(tmp, DATA)))
        bt = jax_loader(*(jax_cli.parse_date(d) for d in ("2020-06-01 00:00", "2020-06-01 01:05")),
                        n_pad_files=0, save_dir=tmp)[0].values
    flow = jax_create_flow(bt, vr_steps=1, smoothing_passes=1, interp_method="cubic")
    again = jax_pipeline.device_flow(jax.numpy.asarray(bt), vr_steps=1, smoothing_passes=1,
                                     interp_method="cubic")
    np.savez_compressed(FLOWS, fwd=np.asarray(flow.forward_flow), bwd=np.asarray(flow.backward_flow),
                        fwd_again=np.asarray(again[0]), bwd_again=np.asarray(again[1]),
                        bt_sha256=bt_hash(bt))
    print("recorded", FLOWS)
