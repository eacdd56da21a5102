"""Dataset helper functions (counterpart of
``tobac_flow_tpu/data/dataset_utils.py``, on the port's containers):
DataArray construction with attributes, dataset insertion, coordinate bin
edges, attribute modifiers and core/anvil subsetters."""

from __future__ import annotations

import numpy as np

from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset

__all__ = [
    "create_dataarray",
    "add_dataarray_to_ds",
    "get_coord_bin_edges",
    "add_cell_method",
    "add_compression_encoding",
    "sel_core",
    "isel_core",
    "sel_anvil",
    "isel_anvil",
]


def create_dataarray(
    data, dims, name, coords=None, long_name=None, units=None, dtype=None, **attrs
):
    """Named DataArray with CF-ish attributes."""
    data = np.asarray(getattr(data, "values", data))
    if dtype is not None:
        data = data.astype(dtype)
    out_attrs = {}
    if long_name is not None:
        out_attrs["long_name"] = long_name
    if units is not None:
        out_attrs["units"] = units
    out_attrs.update({k: v for k, v in attrs.items() if v is not None})
    return DataArray(data, coords=coords, dims=dims, name=name, attrs=out_attrs)


def add_dataarray_to_ds(da, ds):
    """Insert a DataArray under its own name."""
    ds[da.name] = da
    return ds


def get_coord_bin_edges(coord):
    """Bin edges halfway between coordinate values, extrapolated at the ends."""
    c = np.asarray(getattr(coord, "values", coord), dtype=np.float64)
    mid = 0.5 * (c[1:] + c[:-1])
    return np.concatenate(
        [[c[0] - (c[1] - c[0]) / 2], mid, [c[-1] + (c[-1] - c[-2]) / 2]]
    )


def add_cell_method(da, method, dim):
    """Append a CF cell_methods entry."""
    existing = da.attrs.get("cell_methods", "")
    entry = f"{dim}: {method}"
    da.attrs["cell_methods"] = f"{existing} {entry}".strip()
    return da


def add_compression_encoding(ds, complevel=5):
    """Mark the dataset for compressed chunked output."""
    ds.attrs["_compression_level"] = complevel
    return ds


def sel_core(ds, cores):
    """Subset every core-dimensioned variable to the given core labels."""
    return ds.sel(core=np.atleast_1d(cores))


def isel_core(ds, idx):
    return ds.isel(core=idx)


def sel_anvil(ds, anvils):
    return ds.sel(anvil=np.atleast_1d(anvils))


def isel_anvil(ds, idx):
    return ds.isel(anvil=idx)
