"""The port's synthetic detection CLI against the JAX package's, end to
end: ``python -m tobac_flow_tpu_torch.cli.dcc_detect_synthetic`` must
write the file that ``python -m tobac_flow_tpu.cli.dcc_detect_synthetic``
writes with the same arguments.

The JAX package's CLI takes over three minutes on one core at any size
(its watershed compiles), so its file is recorded in ``tests/data/`` by
running this module from the repo root::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_cli.py

The port's CLI runs live here on the CPU, as a user runs it, with the
same arguments: the smallest size tried at which every stage finds an
object (8×32×48; at 7×48×64 and at 8×24×32 no core survives).

- Both files hold the same variables with the same dims, dtypes, shapes
  and attrs, and the same coordinates; every label set has the reference's
  object count and a mean object IoU ≥ 0.99, as ``test_torch_detect.py``
  holds the chain with each package's own flows.  (The output stages'
  values are held to the reference teacher-forced in
  ``test_torch_schema.py``.)
- Each package's ``open_dataset`` reads the other's file back with equal
  variables.
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("h5py")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from chip_smoke import manifest  # noqa: E402
from tobac_flow_tpu.data.ncdataset import open_dataset as jax_open  # noqa: E402
from tobac_flow_tpu_torch.cli import dcc_detect_synthetic  # noqa: E402
from tobac_flow_tpu_torch.data.ncdataset import open_dataset as port_open  # noqa: E402
from tools.parity_detect import object_iou  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
ARGS = ["-t", "8", "-y", "32", "-x", "48"]
NAME = "detected_dccs_SYN_S20200601_000000_X0048_Y0032.nc"
LABELS = ("core_label", "thick_anvil_label", "thin_anvil_label", "core_step_label",
          "thick_anvil_step_label", "thin_anvil_step_label")


@pytest.fixture(scope="module")
def port_file(tmp_path_factory):
    out = tmp_path_factory.mktemp("port")
    path = dcc_detect_synthetic.main(["-sd", str(out), "--device", "cpu"] + ARGS)
    assert path.name == NAME and [p.name for p in out.iterdir()] == [NAME]
    return path


def test_cli_writes_the_reference_file(port_file):
    want, got = port_open(DATA / NAME), port_open(port_file)
    assert manifest(got) == manifest(want)
    for name in ("core", "anvil", "core_step", "thick_anvil_step", "thin_anvil_step"):
        assert want.coords[name].size > 0, name
    for name in LABELS:
        mean_iou, _, n_ref, n_port = object_iou(want[name].values, got[name].values)
        assert n_port == n_ref and mean_iou >= 0.99, (name, mean_iou, n_ref, n_port)


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_open_dataset_reads_the_other_package(port_file, reader):
    """The reader's ``open_dataset`` gives the other package's file the
    variables, attrs and coordinates that the writer's own gives it."""
    read, own, path = ((jax_open, port_open, port_file) if reader == "jax"
                       else (port_open, jax_open, DATA / NAME))
    a, b = read(path), own(path)
    assert manifest(a) == manifest(b) and a.attrs == b.attrs
    for k in b.coords:
        assert np.array_equal(a.coords[k], b.coords[k]), k
    for k, v in b.data_vars.items():
        assert np.array_equal(a[k].values, v.values, equal_nan=v.dtype.kind in "fmM"), k


if __name__ == "__main__":
    from tobac_flow_tpu.cli import dcc_detect_synthetic as jax_cli

    print("recorded", jax_cli.main(["-sd", str(DATA)] + ARGS))
