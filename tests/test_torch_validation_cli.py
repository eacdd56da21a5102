"""The port's validation CLIs against the JAX package's, end to end on the
CPU: ``python -m tobac_flow_tpu_torch.cli.dcc_validation --device cpu``
and ``grid_glm --device cpu`` must write the files that the JAX CLIs
write from the same inputs.

- ``dcc_validation`` on ``tests/test_cli_validation.py``'s detection file
  with its gridded flash file (float32), and on the recorded GOES
  detection file (``tests/data/detected_dccs_G16_...nc``, 11 frames of
  32x48 at the CONUS sector's centre) with a directory of LCFA-shaped
  flash files (``test_torch_glm.write_lcfa``, found offline), which the
  CLI grids itself, and with ``grid_glm``'s int32 file.
- ``grid_glm`` on the recorded GOES file with that directory.

Tolerance: none; every variable, coordinate and attribute is identical
(``chip_smoke.compare_datasets`` with zero tolerances).
"""

import sys
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("h5py")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from chip_smoke import compare_datasets  # noqa: E402
from test_cli_validation import _detection_file  # noqa: E402
from test_torch_glm import write_lcfa  # noqa: E402
from tobac_flow_tpu.cli import dcc_validation as jax_validation  # noqa: E402
from tobac_flow_tpu.cli import grid_glm as jax_grid  # noqa: E402
from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu_torch.cli import dcc_validation, grid_glm  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
G16 = "detected_dccs_G16_S20200601_000000_E20200601_010000_X0000_0000_Y0000_0000.nc"


def _same_files(want, got):
    assert Path(got).name == Path(want).name
    w, g = jnc.open_dataset(str(want)), tnc.open_dataset(str(got))
    compare_datasets(w, g, rtol32=0.0, rtol64=0.0)
    return g


def test_validation_cli_with_gridded_flashes(tmp_path):
    det = tmp_path / "detected_test_S20181701200000_E20181701230000_X0648.nc"
    t, h, w, times = _detection_file(det)
    glm = np.zeros((t, h, w), np.float32)
    glm[2, 24, 24] = 2.0  # flashes on the core
    glm[3, 10, 40] = 1.0  # and one far from every object
    glm_ds = jnc.Dataset(coords={"t": times})
    glm_ds["glm_flashes"] = jnc.DataArray(glm, dims=("t", "y", "x"))
    glm_file = tmp_path / "gridded_glm.nc"
    glm_ds.to_netcdf(str(glm_file))
    args = [str(det), "-glm", str(glm_file), "-margin", "5"]
    want = jax_validation.main(args + ["-sd", str(tmp_path / "jax")])
    got = dcc_validation.main(args + ["-sd", str(tmp_path / "port"), "--device", "cpu"])
    ds = _same_files(want, got)
    assert ds.attrs["core_pod"] == pytest.approx(2 / 3) and ds.attrs["core_far"] == 0.0
    assert ds["glm_flashes"].values.dtype == np.float32


@pytest.fixture(scope="module")
def goes_case(tmp_path_factory):
    """The recorded GOES detection file and a directory of LCFA-shaped
    flash files over its grid and period."""
    root = tmp_path_factory.mktemp("goes_validation")
    glm_dir = root / "glm"
    glm_dir.mkdir()
    write_lcfa(glm_dir, jnc.open_dataset(str(DATA / G16)), seed=4, per_file=600, files=8)
    return DATA / G16, glm_dir, root


def test_grid_glm_cli(goes_case, monkeypatch):
    monkeypatch.setenv("TFT_OFFLINE", "1")
    det, glm_dir, root = goes_case
    args = [str(det), "-glm", str(glm_dir)]
    with pytest.warns(UserWarning, match="could not read"):
        want = jax_grid.main(args + ["-sd", str(root / "grid_jax")])
    with pytest.warns(UserWarning, match="could not read"):
        got = grid_glm.main(args + ["-sd", str(root / "grid_port"), "--device", "cpu"])
    assert got.name.startswith("gridded_glm_")
    ds = _same_files(want, got)
    counts = ds["glm_flashes"].values
    assert counts.dtype == np.int32 and counts.sum() > 100


@pytest.mark.parametrize("glm", ["directory", "gridded_file"])
def test_validation_cli_on_goes_file(goes_case, monkeypatch, glm):
    monkeypatch.setenv("TFT_OFFLINE", "1")
    det, glm_dir, root = goes_case
    source = glm_dir
    if glm == "gridded_file":
        with pytest.warns(UserWarning, match="could not read"):
            source = grid_glm.main([str(det), "-glm", str(glm_dir), "-sd", str(root / glm),
                                    "--device", "cpu"])
    args = [str(det), "-glm", str(source), "-margin", "4", "-time_margin", "2"]
    # the directory holds an unreadable file, which the reader warns of
    with pytest.warns(UserWarning) if glm == "directory" else nullcontext():
        want = jax_validation.main(args + ["-sd", str(root / f"{glm}_jax")])
    with pytest.warns(UserWarning) if glm == "directory" else nullcontext():
        got = dcc_validation.main(args + ["-sd", str(root / f"{glm}_port"), "--device", "cpu"])
    ds = _same_files(want, got)
    for key in ("core_pod", "core_far", "thick_anvil_pod", "thick_anvil_far"):
        assert key in ds.attrs
    assert ds.attrs["n_glm_in_margin"] > 0

