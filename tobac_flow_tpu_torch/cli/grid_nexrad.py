"""CLI: NEXRAD Level-II reflectivity regridded onto a detection file's ABI
grid (counterpart of ``tobac_flow_tpu/cli/grid_nexrad.py``, with the same
arguments and file name, and ``--device``): the in-domain radar sites,
their archives' gates (Level-II tar files, or netCDF files of
pre-extracted gates), parallax-mapped and composited.

Usage: python -m tobac_flow_tpu_torch.cli.grid_nexrad TARGET.nc -nexrad DATA_DIR -sd OUT
(on the card), or with ``--device cpu``.  Reading the target and writing
the output need h5py; ``grid_nexrad`` runs from memory without it.
"""

from __future__ import annotations

import argparse
import pathlib
import warnings

import numpy as np

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, open_dataset, require_h5py
from tobac_flow_tpu_torch.data.nexrad import (
    filter_nexrad_sites, get_gates_from_tar, regrid_nexrad,
)

__all__ = ["grid_nexrad", "main"]


def _load_gates(path):
    """Gate arrays (lat, lon, alt, refl) from a Level-II tar file, or from
    a netCDF file with gate_lat, gate_lon, gate_alt and gate_refl (read
    through h5py)."""
    path = pathlib.Path(path)
    if path.suffix in (".nc", ".nc4", ".h5"):
        require_h5py("grid_nexrad")
        ds = open_dataset(path)
        return tuple(np.asarray(ds[v].values, dtype=np.float64).ravel()
                     for v in ("gate_lat", "gate_lon", "gate_alt", "gate_refl"))
    return get_gates_from_tar(path)


def grid_nexrad(goes_ds, site_gates, min_refl=-33.0, device=None):
    """The sites' gates (a list of (lat, lon, alt, refl)) composited on the
    grid of ``goes_ds``: a Dataset over its x and y with
    ``nexrad_gate_count`` and ``nexrad_refl_mean`` (tensors on ``device``,
    CUDA unless the caller passes ``device="cpu"``)."""
    counts, mean = regrid_nexrad(site_gates, goes_ds, device=device, min_refl=min_refl)
    out = Dataset(coords={"x": goes_ds.coords["x"], "y": goes_ds.coords["y"]})
    if "goes_imager_projection" in goes_ds.data_vars:
        out["goes_imager_projection"] = goes_ds["goes_imager_projection"]
    out["nexrad_gate_count"] = DataArray(
        counts, dims=("y", "x"), attrs={"long_name": "number of radar gates"})
    out["nexrad_refl_mean"] = DataArray(
        mean, dims=("y", "x"), attrs={"long_name": "mean radar reflectivity", "units": "dBZ"})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("target", help="Target netCDF with ABI grid")
    parser.add_argument("-nexrad", required=True, help="NEXRAD archive directory")
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("-min_refl", default=-33.0, type=float)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("grid_nexrad")

    goes_ds = open_dataset(args.target)
    sites = filter_nexrad_sites(goes_ds)
    print("in-domain sites:", sites, flush=True)

    site_gates = []
    for f in sorted(pathlib.Path(args.nexrad).glob("*")):
        if not f.is_file():
            continue
        if sites and not any(s in f.name for s in sites):
            continue
        try:
            site_gates.append(_load_gates(f))
        except Exception as exc:
            warnings.warn(f"could not read {f}: {exc}")
    if not site_gates:
        raise SystemExit("no readable NEXRAD archives for the in-domain sites")

    out = grid_nexrad(goes_ds, site_gates, args.min_refl, args.device).load()
    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    save_path = save_dir / ("nexrad_regrid_" + pathlib.Path(args.target).stem + ".nc")
    save_dataset(out, save_path)
    return save_path


if __name__ == "__main__":
    main()
