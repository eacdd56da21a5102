"""CLI: grid GLM lightning flashes onto a detection file's ABI grid
(counterpart of ``tobac_flow_tpu/cli/grid_glm.py``, with the same
arguments and file name, ``gridded_glm_*``, and ``--device``): finds the
GLM LCFA files of the file's period under ``-glm`` (``TFT_OFFLINE=1``
globs the directory alone), reads their flashes and counts them per
time step on the grid (on the CUDA card unless ``--device cpu``).

Usage: python -m tobac_flow_tpu_torch.cli.grid_glm DETECTED.nc -glm GLM_DIR -sd OUT

Reading and writing the files needs h5py, which is checked before any
read; ``data.glm.gridded_flash_ds`` grids flashes held in memory.
"""

from __future__ import annotations

import argparse
import pathlib

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.glm import gridded_flash_ds, read_glm_flashes
from tobac_flow_tpu_torch.data.io import find_glm_files
from tobac_flow_tpu_torch.data.ncdataset import open_dataset, require_h5py
from tobac_flow_tpu_torch.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("file", help="Detection (or geometry) netCDF file")
    parser.add_argument("-glm", default=".", help="GLM data directory")
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("--download", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("grid_glm")
    device = resolve_device(args.device)

    goes_ds = open_dataset(args.file)
    times = goes_ds.coords["t"]
    start = times[0].astype("datetime64[s]").item()
    end = times[-1].astype("datetime64[s]").item()
    files = find_glm_files(start, end, save_dir=args.glm, download_missing=args.download)
    flash_times, flash_lats, flash_lons, _ = read_glm_flashes(files)
    flash_ds = gridded_flash_ds(goes_ds, flash_times, flash_lats, flash_lons, device)
    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    out = save_dir / pathlib.Path(args.file).name.replace("detected_", "gridded_glm_")
    save_dataset(flash_ds, out)
    return out


if __name__ == "__main__":
    main()
