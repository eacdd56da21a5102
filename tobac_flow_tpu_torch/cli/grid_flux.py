"""CLI: a flux or field on a lat/lon grid regridded onto a detection
file's ABI fixed grid (counterpart of ``tobac_flow_tpu/cli/grid_flux.py``,
with the same arguments and file name, and ``--device``): each source
cell projected to fixed-grid scan angles on the host (float64), then
averaged into the target pixels on the card.

Usage: python -m tobac_flow_tpu_torch.cli.grid_flux TARGET.nc -src FLUX.nc \\
    -vars toa_swup toa_lwup -sd OUT   (on the card, or with ``--device cpu``)
Reading and writing files need h5py; ``grid_flux`` runs from memory
without it.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.abi import get_abi_proj
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, open_dataset, require_h5py
from tobac_flow_tpu_torch.data.nexrad import _grid_axes, histogram_mean
from tobac_flow_tpu_torch.device import resolve_device

__all__ = ["regrid_latlon_to_abi", "grid_flux", "main"]


def _regrid_xy(values, gx, gy, goes_ds, device):
    """The mean of ``values`` at scan angles (gx, gy) in each pixel of the
    grid of ``goes_ds`` (NaN where none falls): (H, W) float32."""
    x_edges, y_edges, y_flip = _grid_axes(goes_ds)
    v = torch.from_numpy(np.ascontiguousarray(values, dtype=np.float64)).to(device)
    ok = torch.from_numpy(np.isfinite(gx) & np.isfinite(gy)).to(device) & torch.isfinite(v)
    _, _, mean = histogram_mean((gy, gx), (y_edges, x_edges), v, device, ok)
    return mean.flip(0) if y_flip else mean


def regrid_latlon_to_abi(values, lats, lons, goes_ds, device=None):
    """The mean of the lat/lon ``values`` in each pixel of the grid of
    ``goes_ds``: an (H, W) float32 tensor on ``device``."""
    gx, gy = get_abi_proj(goes_ds).to_xy(lats, lons)
    return _regrid_xy(values, gx, gy, goes_ds, resolve_device(device))


def grid_flux(goes_ds, src, variables, device=None):
    """``variables`` of the lat/lon Dataset ``src`` (2D, or (t, ...) a
    field per step) regridded onto the grid of ``goes_ds``: a Dataset of
    tensors on ``device`` (CUDA unless the caller passes ``device="cpu"``)."""
    dev = resolve_device(device)
    lats = np.asarray(src["lat"].values, dtype=np.float64)
    lons = np.asarray(src["lon"].values, dtype=np.float64)
    if lats.ndim == 1:
        lons, lats = np.meshgrid(lons, lats)
    gx, gy = get_abi_proj(goes_ds).to_xy(lats.ravel(), lons.ravel())
    out = Dataset(coords={"x": goes_ds.coords["x"], "y": goes_ds.coords["y"]})
    if "goes_imager_projection" in goes_ds.data_vars:
        out["goes_imager_projection"] = goes_ds["goes_imager_projection"]
    for var in variables:
        vals = np.asarray(src[var].values, dtype=np.float64)
        if vals.ndim == 2:
            out[var] = DataArray(_regrid_xy(vals.ravel(), gx, gy, goes_ds, dev),
                                 dims=("y", "x"), attrs=dict(src[var].attrs))
        else:  # (t, y, x)
            out.coords["t"] = np.asarray(src.coords["t"])
            out[var] = DataArray(
                torch.stack([_regrid_xy(v.ravel(), gx, gy, goes_ds, dev) for v in vals]),
                dims=("t", "y", "x"), attrs=dict(src[var].attrs))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("target", help="Target netCDF with ABI grid")
    parser.add_argument("-src", required=True, help="Source field netCDF (lat/lon)")
    parser.add_argument("-vars", nargs="+", required=True)
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("grid_flux")

    out = grid_flux(open_dataset(args.target), open_dataset(args.src), args.vars,
                    args.device).load()
    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    save_path = save_dir / ("gridded_flux_" + pathlib.Path(args.src).name)
    save_dataset(out, save_path)
    return save_path


if __name__ == "__main__":
    main()
