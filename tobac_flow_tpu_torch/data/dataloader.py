"""GOES ABI ingest: the files of a window, channel arithmetic, quality
masking and time-gap filling (counterpart of the GOES half of
``tobac_flow_tpu/data/dataloader.py``, returning exactly what it returns).

bt = CMI_C13, wvd = C08 - C10 and swd = C13 - C15, each blanked (NaN) in
all three fields where any of them is not finite, any channel's DQF flags
the pixel, or a DQF row stands out as a stripe.  A time gap longer than
``time_gap`` is filled from full-disk scans where there are any, then
with one all-NaN frame at its midpoint.

The file reads (:func:`read_mcmip_frame`, through h5py) are kept apart
from the arithmetic, so that everything after them runs on arrays in
memory where h5py is absent: :func:`mask_mcmip_frame` (one frame's
channels and DQFs to its masked fields), :func:`stack_mcmip` (the frames
as time-sorted DataArrays), :func:`fill_time_gap_nan` and
:func:`goes_geometry` (the output dataset's projection, lat, lon and
pixel area).  Host numpy throughout: the fields go to the card in the
detection (``cli.common.run_detection``).

:func:`seviri_dataloader` reads SEVIRI fields from netCDF channel files
(through h5py) under either the channel names or ORAC's ``ch*`` names.
"""

from __future__ import annotations

import warnings
from datetime import timedelta

import numpy as np

from tobac_flow_tpu_torch.data import io
from tobac_flow_tpu_torch.data.abi import get_abi_lat_lon, get_abi_pixel_area
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, open_dataset
from tobac_flow_tpu_torch.utils.datetime_utils import get_datetime_from_coord

__all__ = [
    "CHANNELS",
    "goes_dataloader",
    "goes_geometry",
    "find_goes_files",
    "load_mcmip",
    "mask_mcmip_frame",
    "read_mcmip_frame",
    "stack_mcmip",
    "fill_time_gap_nan",
    "fill_time_gap_full_disk",
    "get_stripe_deviation",
    "seviri_dataloader",
]

CHANNELS = ("C08", "C10", "C13", "C15")
# the CONUS sector's offset (x, y) in the 2 km full-disk grid, and its size
CONUS_OFFSET = (902, 422)
CONUS_SHAPE = (1500, 2500)


def find_goes_files(start_date, end_date, n_pad_files=1, **io_kwargs):
    """ABI files for the window plus up to n_pad_files each side."""
    files = io.find_abi_files(start_date, end_date, **io_kwargs)
    if n_pad_files > 0:
        pad = timedelta(hours=int(np.ceil(n_pad_files / 12)))
        pre = io.find_abi_files(start_date - pad, start_date, **io_kwargs)
        post = io.find_abi_files(end_date, end_date + pad, **io_kwargs)
        files = list(pre)[-n_pad_files:] + list(files) + list(post)[:n_pad_files]
    return files


def get_stripe_deviation(dqf):
    """Per-row deviation score of a DQF field used to blank stripe
    artifacts: |mean over x of (DQF - column mean)/column std|, broadcast
    back over the frame."""
    y_mean = np.nanmean(dqf, axis=-2, keepdims=True)
    y_std = np.nanstd(dqf, axis=-2, keepdims=True)
    dev = np.abs(np.nanmean((dqf - y_mean) / (y_std + 1e-8), axis=-1))
    return dev[..., np.newaxis]


def read_mcmip_frame(path, x0=None, x1=None, y0=None, y1=None):
    """One MCMIP file's window: (time, channels, dqfs, x, y, proj_attrs).
    ``channels`` maps each of :data:`CHANNELS` to its float32 CMI array,
    ``dqfs`` each channel whose file has a DQF to that array; x and y are
    the window's scan angles (None where the file has none)."""
    ds = open_dataset(path)
    sl = (slice(y0, y1), slice(x0, x1))
    channels = {c: np.asarray(ds[f"CMI_{c}"].values)[sl].astype(np.float32)
                for c in CHANNELS}
    dqfs = {c: np.asarray(ds[f"DQF_{c}"].values)[sl]
            for c in CHANNELS if f"DQF_{c}" in ds.data_vars}
    t = np.asarray(ds.coords.get("t", ds["t"].values if "t" in ds else None))
    time = np.ravel(t)[0]
    x = ds.coords["x"][slice(x0, x1)] if "x" in ds.coords else None
    y = ds.coords["y"][slice(y0, y1)] if "y" in ds.coords else None
    proj_attrs = (
        dict(ds["goes_imager_projection"].attrs)
        if "goes_imager_projection" in ds.data_vars
        else {}
    )
    return time, channels, dqfs, x, y, proj_attrs


def mask_mcmip_frame(channels, dqfs):
    """One frame's (bt, wvd, swd), float32, from its channels and DQFs (as
    :func:`read_mcmip_frame` gives them): NaN in all three where any is not
    finite, any DQF is non-zero (NaN counting as zero), or a DQF row's
    stripe deviation exceeds 2.  The inputs are not changed."""
    c08, c10, c13, c15 = (np.asarray(channels[c], dtype=np.float32) for c in CHANNELS)
    flagged = np.zeros(c13.shape, dtype=bool)
    stripe = np.zeros(c13.shape, dtype=bool)
    for c in CHANNELS:
        if c in dqfs:
            d = np.nan_to_num(np.asarray(dqfs[c]), nan=0.0)
            flagged |= d != 0
            stripe |= np.broadcast_to(get_stripe_deviation(d) > 2, d.shape)
    bt = c13.copy()
    wvd = c08 - c10
    swd = c13 - c15
    bad = ~np.isfinite(bt) | ~np.isfinite(wvd) | ~np.isfinite(swd) | flagged | stripe
    for arr in (bt, wvd, swd):
        arr[bad] = np.nan
    return bt, wvd, swd


def stack_mcmip(times, frames, x=None, y=None):
    """The masked frames ((bt, wvd, swd) each, from :func:`mask_mcmip_frame`)
    with their ``times``, as the bt, wvd and swd DataArrays (t, y, x),
    sorted by time, on the x and y scan-angle coordinates."""
    order = np.argsort(np.asarray(times))
    coords = {"t": np.asarray(times)[order]}
    if y is not None:
        coords["y"] = y
    if x is not None:
        coords["x"] = x

    def da(i, name, long_name):
        return DataArray(
            np.stack([frames[j][i] for j in order]),
            coords=coords,
            dims=("t", "y", "x"),
            name=name,
            attrs={"long_name": long_name, "units": "K"},
        )

    bt = da(0, "bt", "ABI Cloud and Moisture Imagery brightness temperature")
    wvd = da(1, "wvd", "ABI Cloud and Moisture Imagery water vapour difference temperature")
    swd = da(2, "swd", "ABI Cloud and Moisture Imagery split window difference temperature")
    bt.attrs["_proj"] = ""
    return bt, wvd, swd


def load_mcmip(files, x0=None, x1=None, y0=None, y1=None):
    """Load a stack of MCMIP files into bt/wvd/swd DataArrays with DQF and
    stripe masking; also returns the first readable file's projection
    attrs.  A file that cannot be read is skipped with a warning."""
    print(f"Loading {len(files)} files", flush=True)
    times, frames = [], []
    x = y = None
    proj_attrs = {}
    for f in files:
        try:
            t, channels, dqfs, x_, y_, pa = read_mcmip_frame(f, x0, x1, y0, y1)
        except Exception as exc:
            warnings.warn(f"could not read {f}: {exc}")
            continue
        times.append(t)
        frames.append(mask_mcmip_frame(channels, dqfs))
        if x is None:
            x, y, proj_attrs = x_, y_, pa
    if not times:
        raise FileNotFoundError("no readable MCMIP files")
    return (*stack_mcmip(times, frames, x, y), proj_attrs)


def _gaps(times, time_gap):
    return np.where(np.diff(times).astype("timedelta64[s]") > np.timedelta64(time_gap))[0]


def fill_time_gap_nan(da, time_gap=timedelta(minutes=15)):
    """Insert an all-NaN frame at the midpoint of each time gap longer than
    ``time_gap``."""
    times = da.coords["t"]
    gaps = _gaps(times, time_gap)
    if not gaps.size:
        return da
    vals = da.values
    new_vals = []
    new_times = []
    last = 0
    for g in gaps:
        new_vals.append(vals[last : g + 1])
        new_times.append(times[last : g + 1])
        mid = times[g] + (times[g + 1] - times[g]) / 2
        print(f"Adding NaN slice at {mid}", flush=True)
        new_vals.append(np.full((1,) + vals.shape[1:], np.nan, vals.dtype))
        new_times.append(np.asarray([mid]))
        last = g + 1
    new_vals.append(vals[last:])
    new_times.append(times[last:])
    return DataArray(
        np.concatenate(new_vals),
        coords={**da.coords, "t": np.concatenate(new_times)},
        dims=da.dims,
        name=da.name,
        attrs=dict(da.attrs),
    )


def fill_time_gap_full_disk(
    bt,
    wvd,
    swd,
    start_date,
    end_date,
    time_gap=timedelta(minutes=15),
    x0=None,
    x1=None,
    y0=None,
    y1=None,
    **io_kwargs,
):
    """Fill CONUS time gaps from full-disk scans: the CONUS sector sits at
    a fixed offset (:data:`CONUS_OFFSET`) inside the 2 km full-disk grid,
    so a missing CONUS frame is cut from the full-disk files of the gap.
    A gap whose full-disk files cannot be read stays (with a warning)."""
    times = bt.coords["t"]
    dates = get_datetime_from_coord(times)
    gaps = _gaps(times, time_gap)
    if not gaps.size:
        return bt, wvd, swd

    (ox, oy), (ny, nx) = CONUS_OFFSET, CONUS_SHAPE
    fx0 = (x0 or 0) + ox
    fx1 = (x1 if x1 is not None else nx) + ox
    fy0 = (y0 or 0) + oy
    fy1 = (y1 if y1 is not None else ny) + oy

    io_kwargs = dict(io_kwargs)
    io_kwargs["view"] = "F"
    new_frames = {"bt": [], "wvd": [], "swd": []}
    new_times = []
    for g in gaps:
        print(
            f"Filling time gap between {dates[g].isoformat()} and "
            f"{dates[g + 1].isoformat()} from full disk",
            flush=True,
        )
        files = io.find_abi_files(dates[g], dates[g + 1], **io_kwargs)
        if not files:
            continue
        try:
            fbt, fwvd, fswd, _ = load_mcmip(files, x0=fx0, x1=fx1, y0=fy0, y1=fy1)
        except Exception as exc:
            warnings.warn(f"full-disk gap fill failed: {exc}")
            continue
        new_frames["bt"].append(fbt.values)
        new_frames["wvd"].append(fwvd.values)
        new_frames["swd"].append(fswd.values)
        new_times.append(fbt.coords["t"])

    if not new_times:
        return bt, wvd, swd

    def merge(da, frames):
        vals = np.concatenate([da.values] + frames)
        t = np.concatenate([da.coords["t"]] + new_times)
        order = np.argsort(t)
        return DataArray(
            vals[order], coords={**da.coords, "t": t[order]}, dims=da.dims,
            name=da.name, attrs=dict(da.attrs),
        )

    return (
        merge(bt, new_frames["bt"]),
        merge(wvd, new_frames["wvd"]),
        merge(swd, new_frames["swd"]),
    )


def goes_geometry(coords, proj_attrs, warn=False):
    """The detection's output dataset on the fields' ``coords``: with
    ``proj_attrs`` (the files' ``goes_imager_projection``), that variable
    and the float32 ``lat``, ``lon`` and pixel ``area`` (km²) of the x/y
    scan-angle grid, NaN off the disk.  Where they cannot be derived, this
    raises, or with ``warn`` leaves them out with a warning."""
    ds = Dataset(coords=dict(coords))
    if not proj_attrs:
        return ds
    ds["goes_imager_projection"] = DataArray(
        np.zeros((), dtype=np.int32), dims=(), attrs=proj_attrs
    )
    try:
        lat, lon = get_abi_lat_lon(ds)
        area = get_abi_pixel_area(ds)
    except Exception as exc:
        if not warn:
            raise
        warnings.warn(f"could not derive geometry: {exc}")
        return ds
    ds["lat"] = DataArray(
        lat.astype(np.float32), dims=("y", "x"), attrs={"long_name": "latitude"},
    )
    ds["lon"] = DataArray(
        lon.astype(np.float32), dims=("y", "x"), attrs={"long_name": "longitude"},
    )
    ds["area"] = DataArray(
        area.astype(np.float32), dims=("y", "x"),
        attrs={"long_name": "pixel area", "units": "km^2"},
    )
    return ds


def goes_dataloader(
    start_date,
    end_date,
    n_pad_files=12,
    x0=None,
    x1=None,
    y0=None,
    y1=None,
    time_gap=timedelta(minutes=15),
    return_new_ds=False,
    **io_kwargs,
):
    """Load bt/wvd/swd for a GOES window with padding, masking and gap
    filling; with ``return_new_ds`` also the output dataset of
    :func:`goes_geometry` (without lat, lon and area, with a warning, where
    they cannot be derived)."""
    files = find_goes_files(start_date, end_date, n_pad_files=n_pad_files, **io_kwargs)
    if not files:
        raise FileNotFoundError(
            f"no ABI files found between {start_date} and {end_date}"
        )
    bt, wvd, swd, proj_attrs = load_mcmip(files, x0=x0, x1=x1, y0=y0, y1=y1)

    if io_kwargs.get("view", "C") == "C":
        try:
            bt, wvd, swd = fill_time_gap_full_disk(
                bt, wvd, swd, start_date, end_date, time_gap,
                x0=x0, x1=x1, y0=y0, y1=y1,
                **{k: v for k, v in io_kwargs.items() if k != "view"},
            )
        except Exception as exc:
            warnings.warn(f"full-disk gap fill unavailable: {exc}")
    bt = fill_time_gap_nan(bt, time_gap)
    wvd = fill_time_gap_nan(wvd, time_gap)
    swd = fill_time_gap_nan(swd, time_gap)

    if return_new_ds:
        return bt, wvd, swd, goes_geometry(bt.coords, proj_attrs, warn=True)
    return bt, wvd, swd


def seviri_dataloader(
    start_date,
    end_date,
    file_paths,
    x0=None,
    x1=None,
    y0=None,
    y1=None,
    time_gap=timedelta(minutes=20),
):
    """SEVIRI bt/wvd/swd from netCDF channel files (one time step each):
    bt = IR_108 (or ``ch9``), wvd = WV_062 − WV_073 (``ch5`` − ``ch6``),
    swd = IR_087 − IR_120, or bt − ``ch10`` where those are absent; cropped
    to [y0:y1, x0:x1], time-sorted, with an all-NaN frame in each gap over
    ``time_gap``."""
    times, bts, wvds, swds = [], [], [], []
    coords = {}
    for f in sorted(file_paths):
        ds = open_dataset(f)
        sl = (slice(y0, y1), slice(x0, x1))

        def ch(*names):
            for n in names:
                if n in ds.data_vars:
                    return np.asarray(ds[n].values)[sl].astype(np.float32)
            raise KeyError(names)

        bt = ch("IR_108", "ch9")
        wvd = ch("WV_062", "ch5") - ch("WV_073", "ch6")
        try:
            swd = ch("IR_087") - ch("IR_120")
        except KeyError:
            swd = bt - ch("ch10")
        t = np.ravel(np.asarray(ds.coords.get("t")))[0]
        times.append(t)
        bts.append(bt)
        wvds.append(wvd)
        swds.append(swd)

    order = np.argsort(np.asarray(times))
    coords["t"] = np.asarray(times)[order]

    def da(stack, name):
        return DataArray(
            np.stack([stack[i] for i in order]),
            coords=coords,
            dims=("t", "y", "x"),
            name=name,
            attrs={"long_name": name, "units": "K"},
        )

    bt = fill_time_gap_nan(da(bts, "bt"), time_gap)
    wvd = fill_time_gap_nan(da(wvds, "wvd"), time_gap)
    swd = fill_time_gap_nan(da(swds, "swd"), time_gap)
    return bt, wvd, swd
