"""Where the linkers read and write their datasets: netCDF files through
h5py (``NetCDFStore``, what the CLIs use), or datasets held in memory
(``MemoryStore``), so that the linking arithmetic runs where h5py is
absent.  Both give the linkers each dataset anew at every ``open``, as a
file read does: the label volumes that they change in place are the
caller's own copies."""

from __future__ import annotations

import os
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, open_dataset

__all__ = ["NetCDFStore", "MemoryStore"]


class NetCDFStore:
    """Detection files on disk."""

    def exists(self, path) -> bool:
        return Path(path).exists()

    def makedirs(self, path) -> None:
        Path(path).mkdir(parents=True, exist_ok=True)

    def open(self, path) -> Dataset:
        return open_dataset(path)

    def save(self, ds, path) -> None:
        """A compressed netCDF write through a temporary file renamed into
        place."""
        path = Path(path)
        temp = path.with_suffix(".temp.nc")
        ds.to_netcdf(temp, compress=True, complevel=5)
        os.replace(temp, path)
        print(datetime.now(), "Saving to %s" % path, flush=True)


class MemoryStore:
    """Datasets by name (``{name: Dataset}``); ``saved`` holds what the
    linkers write, by name, its variables moved to the host as a file
    write moves them."""

    def __init__(self, datasets):
        self.datasets = {str(k): v for k, v in datasets.items()}
        self.saved = {}

    def exists(self, path) -> bool:
        return str(path) in self.datasets

    def makedirs(self, path) -> None:
        pass

    def open(self, path) -> Dataset:
        """A new Dataset over the stored one's variables; the integer
        volumes (which the linkers write in place) copied."""
        src = self.datasets[str(path)]
        out = Dataset(coords={k: np.copy(v) for k, v in src.coords.items()},
                      attrs=dict(src.attrs))
        for name, var in src.data_vars.items():
            data = var.data
            if var.dtype.kind in "iu":
                data = data.clone() if isinstance(data, torch.Tensor) else np.copy(data)
            out.data_vars[name] = DataArray(data, coords=dict(var.coords), dims=var.dims,
                                            name=name, attrs=dict(var.attrs))
        return out

    def save(self, ds, path) -> None:
        self.saved[str(path)] = ds.load()
