"""Labelled-array containers with netCDF4 I/O (the port's own copy of
``tobac_flow_tpu/data/ncdataset.py``, with the same surface: ``.values``,
``.dims``, ``.coords``, ``.attrs``, arithmetic, ``sel``/``isel``,
``to_netcdf``/``open_dataset``).

A :class:`DataArray` may hold a torch tensor where it lies, on the card
for one: ``.data`` returns it as it is, and ``.values`` moves it to the
host as numpy once and keeps the numpy array.  ``Dataset.load`` does that
for every variable, and ``to_netcdf`` writes numpy.  Coordinates are
always numpy.  Files are netCDF4-compatible HDF5 written and read through
h5py (dimension scales, CF time encoding, gzip chunk compression), which
is imported only by ``to_netcdf`` and ``open_dataset``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["DataArray", "Dataset", "as_tensor", "open_dataset"]

_EPOCH = np.datetime64("1970-01-01T00:00:00", "ns")


def _is_time(arr):
    return np.issubdtype(np.asarray(arr).dtype, np.datetime64)


def as_tensor(x, device=None):
    """The data of a DataArray, a tensor or an array as a tensor, where it
    lies or on ``device``; numpy data is shared, not copied, on the CPU."""
    x = torch.as_tensor(x.data if isinstance(x, DataArray) else x)
    return x if device is None else x.to(device)


class DataArray:
    """A named array with dimensions, coordinates and attributes."""

    def __init__(self, data, coords=None, dims=None, name=None, attrs=None):
        if isinstance(data, DataArray):
            if dims is None:
                dims = data.dims
            data = data.data
        self.data = data
        if dims is None:
            dims = tuple(f"dim_{i}" for i in range(self.ndim))
        if len(dims) != self.ndim:
            raise ValueError("dims must match data dimensionality")
        self.dims = tuple(dims)
        self.coords = {}
        if coords:
            for k, v in coords.items():
                v = np.asarray(getattr(v, "values", v))
                self.coords[k] = v
        self.name = name
        self.attrs = dict(attrs or {})

    @property
    def data(self):
        """The array as it is held: a tensor on its device, or numpy."""
        return self._data

    @data.setter
    def data(self, data):
        self._data = data if isinstance(data, torch.Tensor) else np.asarray(data)

    @property
    def values(self):
        """The array as numpy; a tensor moves to the host here, once."""
        if isinstance(self._data, torch.Tensor):
            self._data = self._data.cpu().numpy()
        return self._data

    @values.setter
    def values(self, values):
        self._data = np.asarray(values)

    # -- conveniences ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def dtype(self):
        """The numpy dtype, also of a tensor."""
        if isinstance(self._data, torch.Tensor):
            return torch.empty((), dtype=self._data.dtype).numpy().dtype
        return self._data.dtype

    def to_numpy(self):
        return self.values

    def compute(self):
        return self

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def __len__(self):
        return len(self._data)

    def __getattr__(self, key):
        coords = self.__dict__.get("coords", {})
        if key in coords:
            return DataArray(coords[key], dims=(key,), name=key)
        raise AttributeError(key)

    def __repr__(self):
        return (
            f"<DataArray {self.name or ''} {tuple(self.dims)} {self.shape} "
            f"{self.dtype}>"
        )

    def copy(self):
        data = self._data.clone() if isinstance(self._data, torch.Tensor) else self._data.copy()
        return DataArray(
            data, coords=dict(self.coords), dims=self.dims,
            name=self.name, attrs=dict(self.attrs),
        )

    def rename(self, name):
        out = self.copy()
        out.name = name
        return out

    # -- indexing -------------------------------------------------------
    def isel(self, **sel):
        idx = [slice(None)] * self.ndim
        for dim, s in sel.items():
            idx[self.dims.index(dim)] = s
        return self[tuple(idx)]

    def __getitem__(self, items):
        if not isinstance(items, tuple):
            items = (items,)
        values = self._data[items]
        new_dims = []
        new_coords = dict(self.coords)
        it = list(items) + [slice(None)] * (self.ndim - len(items))
        for d, s in zip(self.dims, it):
            if isinstance(s, (int, np.integer)):
                new_coords.pop(d, None)
                continue
            new_dims.append(d)
            if d in new_coords:
                new_coords[d] = new_coords[d][s]
        return DataArray(
            values, coords=new_coords, dims=tuple(new_dims), name=self.name,
            attrs=dict(self.attrs),
        )

    # -- arithmetic (coords/attrs follow the left operand) --------------
    def _binop(self, other, op):
        other_v = other.data if isinstance(other, DataArray) else other
        return DataArray(
            op(self._data, other_v), coords=dict(self.coords), dims=self.dims,
            name=self.name, attrs=dict(self.attrs),
        )

    def __add__(self, o):
        return self._binop(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._binop(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._binop(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._binop(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._binop(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._binop(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._binop(o, lambda a, b: a / b)

    def __neg__(self):
        return self._binop(0, lambda a, b: -a)

    def __ge__(self, o):
        return self._binop(o, lambda a, b: a >= b)

    def __gt__(self, o):
        return self._binop(o, lambda a, b: a > b)

    def __le__(self, o):
        return self._binop(o, lambda a, b: a <= b)

    def __lt__(self, o):
        return self._binop(o, lambda a, b: a < b)

    def __ne__(self, o):  # noqa: D105
        return self._binop(o, lambda a, b: a != b)

    def __eq__(self, o):  # noqa: D105
        return self._binop(o, lambda a, b: a == b)

    def __hash__(self):
        return id(self)


class Dataset:
    """A collection of DataArrays sharing dimensions/coordinates."""

    def __init__(self, data_vars=None, coords=None, attrs=None):
        self.data_vars = {}
        self.coords = {}
        self.attrs = dict(attrs or {})
        if coords:
            for k, v in coords.items():
                self.coords[k] = np.asarray(getattr(v, "values", v))
        if data_vars:
            for k, v in data_vars.items():
                self[k] = v

    def __setitem__(self, key, value):
        if isinstance(value, tuple) and len(value) == 2:
            dims, data = value
            value = DataArray(data, dims=dims)
        if not isinstance(value, DataArray):
            value = DataArray(value)
        value = value.rename(key)
        # a 1-D variable named after its own dimension IS that dimension's
        # coordinate (xarray semantics) — writing it to data_vars too would
        # collide with the dimension scale in to_netcdf
        if value.ndim == 1 and value.dims == (key,):
            self.coords[key] = np.asarray(value.values)
            self.data_vars.pop(key, None)
            return
        # inherit dataset coords matching its dims
        for d in value.dims:
            if d in self.coords and d not in value.coords:
                value.coords[d] = self.coords[d]
        # adopt new coords
        for c, v in value.coords.items():
            if c not in self.coords and c in value.dims:
                self.coords[c] = v
        self.data_vars[key] = value

    def __getitem__(self, key):
        if key in self.data_vars:
            return self.data_vars[key]
        if key in self.coords:
            return DataArray(self.coords[key], dims=(key,), name=key)
        raise KeyError(key)

    def __contains__(self, key):
        return key in self.data_vars or key in self.coords

    def __iter__(self):
        return iter(self.data_vars)

    def __getattr__(self, key):
        dv = self.__dict__.get("data_vars", {})
        if key in dv:
            return dv[key]
        coords = self.__dict__.get("coords", {})
        if key in coords:
            return DataArray(coords[key], dims=(key,), name=key)
        raise AttributeError(key)

    def __repr__(self):
        lines = ["<Dataset>"]
        lines.append("Coordinates:")
        for k, v in self.coords.items():
            lines.append(f"  {k}: {v.shape} {v.dtype}")
        lines.append("Data variables:")
        for k, v in self.data_vars.items():
            lines.append(f"  {k}: {v.dims} {v.shape} {v.dtype}")
        return "\n".join(lines)

    def load(self):
        """Move every variable held as a tensor to the host as numpy;
        returns the dataset."""
        for v in self.data_vars.values():
            v.values
        return self

    def drop_vars(self, names):
        if isinstance(names, str):
            names = [names]
        for n in names:
            self.data_vars.pop(n, None)
        return self

    def isel(self, **sel):
        out = Dataset(attrs=dict(self.attrs))
        for k, v in self.coords.items():
            out.coords[k] = v[sel[k]] if k in sel else v
        for k, v in self.data_vars.items():
            out.data_vars[k] = v.isel(**{d: s for d, s in sel.items() if d in v.dims})
        return out

    def sel(self, **sel):
        """Subset by coordinate *values* along each named dimension (the
        xarray ``.sel`` subset the reference's filter utilities use)."""
        isel = {}
        for dim, values in sel.items():
            coord = self.coords[dim]
            values = np.asarray(getattr(values, "values", values))
            order = np.argsort(coord)
            pos = order[np.searchsorted(coord, values, sorter=order)]
            if not np.array_equal(coord[pos], values):
                raise KeyError(f"some values not found in coord {dim!r}")
            isel[dim] = pos
        return self.isel(**isel)

    # -- netCDF I/O ------------------------------------------------------
    def to_netcdf(self, path, compress=True, complevel=4):
        import h5py

        with h5py.File(path, "w") as f:
            f.attrs.update(
                {k: v for k, v in self.attrs.items() if v is not None}
            )
            dim_sizes = {}
            for v in self.data_vars.values():
                for d, s in zip(v.dims, v.shape):
                    dim_sizes[d] = s
            for c, vals in self.coords.items():
                dim_sizes.setdefault(c, len(vals))

            # coordinate variables double as netCDF dimension scales
            for d, size in dim_sizes.items():
                if d in self.coords:
                    vals = self.coords[d]
                    if vals.dtype.kind in "UO":
                        ds = f.create_dataset(
                            d,
                            data=np.asarray(
                                [str(v) for v in vals], dtype=h5py.string_dtype()
                            ),
                        )
                        ds.make_scale(d)
                        continue
                    if _is_time(vals):
                        data = (
                            (vals.astype("datetime64[ns]") - _EPOCH)
                            .astype("timedelta64[ns]")
                            .astype(np.int64)
                            / 1e9
                        )
                        ds = f.create_dataset(d, data=data)
                        ds.attrs["units"] = "seconds since 1970-01-01"
                        ds.attrs["calendar"] = "proleptic_gregorian"
                    else:
                        ds = f.create_dataset(d, data=vals)
                else:
                    ds = f.create_dataset(d, data=np.arange(size))
                ds.make_scale(d)

            for name, var in self.data_vars.items():
                vals = var.values
                kw = {}
                if compress and vals.ndim >= 2 and vals.size > 1024:
                    kw = dict(
                        compression="gzip",
                        compression_opts=complevel,
                        chunks=True,
                        shuffle=True,
                    )
                if _is_time(vals):
                    data = (
                        (vals.astype("datetime64[ns]") - _EPOCH)
                        .astype("timedelta64[ns]")
                        .astype(np.int64)
                        / 1e9
                    )
                    ds = f.create_dataset(name, data=data, **kw)
                    ds.attrs["units"] = "seconds since 1970-01-01"
                elif np.issubdtype(vals.dtype, np.timedelta64):
                    data = vals.astype("timedelta64[ns]").astype(np.int64) / 1e9
                    ds = f.create_dataset(name, data=data, **kw)
                    ds.attrs["units"] = "seconds"
                elif vals.dtype.kind in "UO":
                    import h5py as _h

                    ds = f.create_dataset(
                        name, data=np.asarray(vals, dtype=_h.string_dtype())
                    )
                else:
                    ds = f.create_dataset(name, data=vals, **kw)
                for i, d in enumerate(var.dims):
                    ds.dims[i].attach_scale(f[d])
                ds.attrs["_tft_dims"] = ",".join(var.dims)
                # don't let variable attrs clobber the CF time/duration encoding
                encoded_keys = (
                    {"units", "calendar"}
                    if (_is_time(vals) or np.issubdtype(vals.dtype, np.timedelta64))
                    else set()
                )
                for k, v in var.attrs.items():
                    if v is not None and k not in encoded_keys:
                        ds.attrs[k] = v


def open_dataset(path):
    """Read a netCDF4/HDF5 file written by :meth:`Dataset.to_netcdf` (or any
    netCDF4 file with dimension scales)."""
    import h5py

    ds = Dataset()
    with h5py.File(path, "r") as f:
        ds.attrs = {k: _from_h5attr(v) for k, v in f.attrs.items()}
        scales = {}
        variables = {}
        for name, obj in f.items():
            if not isinstance(obj, h5py.Dataset):
                continue
            if obj.attrs.get("CLASS") == b"DIMENSION_SCALE":
                scales[name] = obj
            else:
                variables[name] = obj

        def decode(obj):
            vals = obj[...]
            units = obj.attrs.get("units")
            if isinstance(units, bytes):
                units = units.decode()
            # CF packed-data decoding (scale_factor/add_offset/_FillValue),
            # as netCDF tools write it (e.g. GOES L1b/L2 products)
            scale = obj.attrs.get("scale_factor")
            offset = obj.attrs.get("add_offset")
            fill = obj.attrs.get("_FillValue")
            if scale is not None or offset is not None:
                vals = np.asarray(vals, dtype=np.float64)
                if fill is not None:
                    vals = np.where(vals == np.float64(np.asarray(fill)), np.nan, vals)
                vals = vals * (
                    np.float64(np.asarray(scale)) if scale is not None else 1.0
                ) + (np.float64(np.asarray(offset)) if offset is not None else 0.0)
                vals = vals.astype(np.float32)
            elif fill is not None and np.issubdtype(np.asarray(vals).dtype, np.floating):
                vals = np.where(vals == np.asarray(fill), np.nan, vals)
            if isinstance(units, str) and units.startswith("seconds since 1970"):
                vals = _EPOCH + (np.asarray(vals) * 1e9).astype("timedelta64[ns]")
            elif isinstance(units, str) and units.startswith("seconds since 2000-01-01 12:00"):
                # GOES-R J2000 epoch
                j2000 = np.datetime64("2000-01-01T12:00:00", "ns")
                vals = j2000 + (np.asarray(vals) * 1e9).astype("timedelta64[ns]")
            if vals.dtype.kind == "O":
                vals = np.asarray(
                    [x.decode() if isinstance(x, bytes) else x for x in vals.ravel()]
                ).reshape(vals.shape)
            return vals

        for name, obj in scales.items():
            ds.coords[name] = decode(obj)
        for name, obj in variables.items():
            tft_dims = obj.attrs.get("_tft_dims")
            if isinstance(tft_dims, bytes):
                tft_dims = tft_dims.decode()
            if tft_dims:
                dims = tft_dims.split(",")
            else:
                dims = []
                for i in range(obj.ndim):
                    try:
                        dlabels = [
                            s.name.split("/")[-1] for s in obj.dims[i].values()
                        ]
                    except RuntimeError:
                        dlabels = []
                    dims.append(dlabels[0] if dlabels else f"dim_{i}")
            arr = DataArray(decode(obj), dims=tuple(dims), name=name)
            arr.attrs = {k: _from_h5attr(v) for k, v in obj.attrs.items()}
            for d in dims:
                if d in ds.coords:
                    arr.coords[d] = ds.coords[d]
            ds.data_vars[name] = arr
    return ds


def _from_h5attr(v):
    if isinstance(v, bytes):
        return v.decode()
    return v
