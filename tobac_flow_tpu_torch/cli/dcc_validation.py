"""CLI: validate detected DCCs against GLM lightning (counterpart of
``tobac_flow_tpu/cli/dcc_validation.py``, with the same arguments and
file name, ``validated_*``, and ``--device``): takes a gridded flash file,
or grids the flashes of a GLM directory onto the detection grid, and
computes POD and FAR for the cores and the thick anvils, with each
object's distance to the nearest flash (on the CUDA card unless
``--device cpu``).

Usage: python -m tobac_flow_tpu_torch.cli.dcc_validation DETECTED.nc -glm GLM_DIR -sd OUT

Reading and writing the files needs h5py, which is checked before any
read; :func:`validate_dataset` validates a Dataset in memory.
"""

from __future__ import annotations

import argparse
import pathlib
from datetime import datetime

import numpy as np

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.glm import create_gridded_flash_ds
from tobac_flow_tpu_torch.data.ncdataset import DataArray, open_dataset, require_h5py
from tobac_flow_tpu_torch.device import resolve_device, stage
from tobac_flow_tpu_torch.validate import validate_anvils, validate_cores


def validate_dataset(dataset, glm_grid, margin=10, time_margin=3, device=None,
                     budget_bytes=None, stats=None):
    """The CLI's work: POD, FAR and per-object flash distances of the cores
    and the thick anvils of ``dataset`` against the gridded flashes
    ``glm_grid`` (array or tensor), on ``device`` (CUDA by default), each
    in ``device.stage`` (``validate_cores``, ``validate_anvils``); the
    grid is stored as ``glm_flashes``.  Returns ``dataset``."""
    dev = resolve_device(device)
    print(datetime.now(), "Validating cores", flush=True)
    with stage("validate_cores", stats, dev):
        pod, far = validate_cores(dataset, glm_grid, margin=margin, time_margin=time_margin,
                                  device=dev, budget_bytes=budget_bytes)
    print(f"core POD = {pod:.3f}, FAR = {far:.3f}", flush=True)
    print(datetime.now(), "Validating anvils", flush=True)
    with stage("validate_anvils", stats, dev):
        pod_a, far_a = validate_anvils(dataset, glm_grid, margin=margin,
                                       time_margin=time_margin, device=dev,
                                       budget_bytes=budget_bytes)
    print(f"anvil POD = {pod_a:.3f}, FAR = {far_a:.3f}", flush=True)
    dataset["glm_flashes"] = DataArray(
        glm_grid, dims=("t", "y", "x"), attrs={"long_name": "number of GLM flashes detected"},
    )
    return dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("file", help="Detection netCDF file")
    parser.add_argument("-glm", default=None,
                        help="GLM data directory (or pre-gridded flash netCDF)")
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("-margin", default=10, type=int)
    parser.add_argument("-time_margin", default=3, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("dcc_validation")
    device = resolve_device(args.device)

    dataset = open_dataset(args.file)
    glm_path = pathlib.Path(args.glm) if args.glm else None
    if glm_path is not None and glm_path.is_file():
        glm_grid = np.asarray(open_dataset(glm_path)["glm_flashes"].values)
    elif glm_path is not None:
        times = dataset.coords["t"]
        start = times[0].astype("datetime64[s]").item()
        end = times[-1].astype("datetime64[s]").item()
        glm_ds = create_gridded_flash_ds(dataset, start, end, glm_save_dir=glm_path,
                                         device=device)
        glm_grid = np.asarray(glm_ds["glm_flashes"].values)
    else:
        raise SystemExit("need -glm directory or gridded flash file")

    dataset = validate_dataset(dataset, glm_grid, args.margin, args.time_margin, device)
    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    out = save_dir / pathlib.Path(args.file).name.replace("detected_", "validated_")
    save_dataset(dataset, out)
    return out


if __name__ == "__main__":
    main()
