"""CLI: cloud-radiative-effect time series over detected objects
(counterpart of ``tobac_flow_tpu/cli/seviri_cre_time_series.py``, with
the same arguments and file, ``cre_time_series.nc``, and ``--device``):
from post-processed files carrying per-step CRE statistics, the
area-weighted hourly mean of each CRE variable per step family, the
per-group averages as segment reductions (``utils.stats``) on the CUDA
card unless ``--device cpu``.

Usage: python -m tobac_flow_tpu_torch.cli.seviri_cre_time_series POSTPROCESSED.nc -sd OUT

Reading and writing the files needs h5py, which is checked before any
read; :func:`cre_time_series` works on Datasets in memory.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, open_dataset, require_h5py
from tobac_flow_tpu_torch.device import resolve_device
from tobac_flow_tpu_torch.utils.stats import weighted_average_groupby

CRE_VARS = ["toa_net_cre", "toa_swup_cre", "toa_lwup_cre"]


def cre_time_series(datasets, variables=CRE_VARS, device=None):
    """The CLI's work: for each step family of each post-processed Dataset
    and each of ``variables`` whose ``*_mean`` it holds, the step means
    weighted by step area per hour, on ``device`` (CUDA by default); the
    series of all datasets merged and time-sorted into one Dataset."""
    dev = resolve_device(device)
    out = Dataset()
    series = {}
    for ds in datasets:
        for prefix in ("core_step", "thick_anvil_step", "thin_anvil_step"):
            if f"{prefix}_t" not in ds.data_vars:
                continue
            t = np.asarray(ds[f"{prefix}_t"].values)
            area = np.asarray(ds[f"{prefix}_area"].values)
            for var in variables:
                name = f"{prefix}_{var}_mean"
                if name not in ds.data_vars:
                    continue
                vals = np.asarray(ds[name].values)
                hours = t.astype("datetime64[h]")
                uniq = np.unique(hours)
                mean = weighted_average_groupby(vals, area, hours.astype(np.int64),
                                                index=uniq.astype(np.int64), device=dev)
                key = f"{prefix}_{var}_hourly"
                series.setdefault(key, []).append((uniq, np.asarray(mean, float)))

    for key, chunks in series.items():
        times = np.concatenate([c[0] for c in chunks])
        vals = np.concatenate([c[1] for c in chunks])
        order = np.argsort(times)
        dim = f"{key}_time"
        out.coords[dim] = times[order].astype("datetime64[ns]")
        out[key] = DataArray(vals[order], dims=(dim,), name=key)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("files", nargs="+", help="Postprocessed netCDF files")
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument(
        "-vars", nargs="*", default=CRE_VARS,
        help="CRE variables (per-step statistics expected as *_mean)",
    )
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("seviri_cre_time_series")
    device = resolve_device(args.device)

    out = cre_time_series((open_dataset(f) for f in args.files), args.vars, device)
    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    save_path = save_dir / "cre_time_series.nc"
    save_dataset(out, save_path)
    return save_path


if __name__ == "__main__":
    main()
