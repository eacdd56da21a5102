"""CLI: flux files gridded onto a regular 1° lat/lon grid, with their cloud
radiative effects (counterpart of ``tobac_flow_tpu/cli/grid_flux_native.py``,
with the same arguments and file name, and ``--device``): each variable's
mean in each cell, binned on the card.

Usage: python -m tobac_flow_tpu_torch.cli.grid_flux_native -sd OUT flux_*.nc
(on the card, or with ``--device cpu``).  Reading and writing files need
h5py; ``grid_flux_native`` runs from memory without it.
"""

from __future__ import annotations

import argparse
import pathlib
from datetime import datetime

import numpy as np
import torch

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, open_dataset, require_h5py
from tobac_flow_tpu_torch.data.nexrad import histogram_mean
from tobac_flow_tpu_torch.device import resolve_device
from tobac_flow_tpu_torch.schema.postprocess import add_cre_to_dataset

__all__ = ["FLUX_VARS", "bin_to_latlon", "grid_flux_native", "main"]

FLUX_VARS = (
    "toa_swdn", "toa_swup", "toa_lwup",
    "boa_swdn", "boa_swup", "boa_lwdn", "boa_lwup",
)


def bin_to_latlon(values, lats, lons, lat_bins, lon_bins, device=None):
    """The mean of ``values`` in each lat/lon cell of the bins' edges
    (NaN where none falls): a float32 tensor on ``device``."""
    dev = resolve_device(device)
    v, la, lo = (torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dev)
                 for a in (values, lats, lons))
    ok = torch.isfinite(v) & torch.isfinite(la) & torch.isfinite(lo)
    return histogram_mean((la, lo), (lat_bins, lon_bins), v, dev, ok)[2]


def grid_flux_native(datasets, device=None):
    """The flux Datasets (each with lat, lon, a ``t`` coordinate and the
    fluxes of ``FLUX_VARS`` and their ``_clr`` pairs) gridded onto 1° cells
    and ordered by time: a Dataset over (t, lat, lon) of tensors on
    ``device`` (CUDA unless the caller passes ``device="cpu"``), with the
    cloud radiative effects where every all-sky and clear-sky pair is
    there."""
    dev = resolve_device(device)
    lon_bins = np.arange(-180.0, 181.0)
    lat_bins = np.arange(-90.0, 91.0)
    times, gridded = [], {}
    for ds in datasets:
        flat = np.asarray(ds["lat"].values, np.float64).ravel()
        flon = np.asarray(ds["lon"].values, np.float64).ravel()
        times.append(np.ravel(np.asarray(ds.coords["t"]))[0])
        for var in list(FLUX_VARS) + [f"{v}_clr" for v in FLUX_VARS]:
            if var in ds.data_vars:
                gridded.setdefault(var, []).append(bin_to_latlon(
                    np.asarray(ds[var].values, np.float64).ravel(), flat, flon, lat_bins,
                    lon_bins, dev))
    order = np.argsort(np.asarray(times))
    out = Dataset(coords={"t": np.asarray(times)[order], "lat": lat_bins[1:] - 0.5,
                          "lon": lon_bins[1:] - 0.5})
    for var, grids in gridded.items():
        out[var] = DataArray(torch.stack([grids[i] for i in order]), dims=("t", "lat", "lon"),
                             name=var, attrs={"units": "W m-2"})
    cre_ready = all(
        v in out.data_vars and f"{v}_clr" in out.data_vars
        for v in ("toa_swup", "toa_lwup", "boa_swdn", "boa_swup", "boa_lwdn", "boa_lwup")
    ) and "toa_swdn" in out.data_vars
    return add_cre_to_dataset(out) if cre_ready else out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sd", help="Directory to save output", default=".")
    parser.add_argument("files", nargs="+", type=str, help="Flux netCDF files")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("grid_flux_native")

    datasets = []
    for f in sorted(args.files):
        print(datetime.now(), "Gridding", f, flush=True)
        datasets.append(open_dataset(f))
    out = grid_flux_native(datasets, args.device).load()
    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    stamp = str(np.asarray(out.coords["t"])[0].astype("datetime64[s]"))
    stamp = stamp.replace("-", "").replace(":", "").replace("T", "_")
    save_path = save_dir / f"flux_regrid_S{stamp}.nc"
    save_dataset(out, save_path)
    return save_path


if __name__ == "__main__":
    main()
