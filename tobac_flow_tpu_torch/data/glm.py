"""GLM lightning flashes gridded onto the ABI fixed grid (counterpart of
``tobac_flow_tpu/data/glm.py``): the parallax correction of flash
locations from the GLM lightning ellipsoid to the GRS80 surface along the
satellite's view ray, the flashes' fixed-grid scan angles, the LCFA file
reader, the per-time-bin flash counts on the grid (``regrid_glm``) and
the function that finds, reads and grids them.

The geometry is host float64 numpy with the reference's operations in
its order, so that the scan angles have its bits.  The binning runs on
``device`` (CUDA unless the caller passes ``device="cpu"``): each flash's
bin by ``searchsorted`` with ``np.histogramdd``'s rule (right-closed
search, a value equal to the last edge in the last bin, values outside
the edges dropped), then one ``bincount`` into (T, H, W) int32 counts,
equal to the reference's.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from tobac_flow_tpu_torch.data.abi import get_abi_proj
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, open_dataset
from tobac_flow_tpu_torch.device import resolve_device

__all__ = ["get_glm_parallax_offsets", "get_corrected_glm_x_y", "get_uncorrected_glm_x_y",
           "read_glm_flashes", "regrid_glm", "gridded_flash_ds", "create_gridded_flash_ds"]

# GLM lightning ellipsoid: the GLM L2 fixed grid assumes flashes at
# cloud-top height on an inflated ellipsoid
_GLM_EQ_RADIUS = 6.394140e6  # equatorial radius + 16 km
_GRS80_EQ = 6378137.0
_GRS80_POL = 6356752.31414
_GLM_POL_RADIUS = _GRS80_POL + (_GLM_EQ_RADIUS - _GRS80_EQ)


def _geodetic_to_ecef(lat, lon, eq_radius, pol_radius):
    lat = np.radians(lat)
    lon = np.radians(lon)
    e2 = 1 - (pol_radius**2 / eq_radius**2)
    n = eq_radius / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    x = n * np.cos(lat) * np.cos(lon)
    y = n * np.cos(lat) * np.sin(lon)
    z = n * (1 - e2) * np.sin(lat)
    return x, y, z


def _ecef_to_geodetic(x, y, z, eq_radius, pol_radius):
    # Bowring's method, one iteration (sufficient at these scales)
    e2 = 1 - (pol_radius**2 / eq_radius**2)
    ep2 = (eq_radius**2 - pol_radius**2) / pol_radius**2
    p = np.sqrt(x**2 + y**2)
    theta = np.arctan2(z * eq_radius, p * pol_radius)
    lat = np.arctan2(
        z + ep2 * pol_radius * np.sin(theta) ** 3,
        p - e2 * eq_radius * np.cos(theta) ** 3,
    )
    lon = np.arctan2(y, x)
    return np.degrees(lat), np.degrees(lon)


def get_glm_parallax_offsets(lat, lon, sat_lon=-75.0, sat_height=35786023.0):
    """Parallax-corrected (lat, lon) of GLM flashes: the L2 location on the
    lightning ellipsoid re-projected along the satellite ray onto the
    GRS80 surface."""
    fx, fy, fz = _geodetic_to_ecef(lat, lon, _GLM_EQ_RADIUS, _GLM_POL_RADIUS)
    sx, sy, sz = _geodetic_to_ecef(0.0, sat_lon, _GRS80_EQ + sat_height, _GRS80_POL + sat_height)
    # ray from the satellite through the flash, intersected with GRS80
    dx, dy, dz = fx - sx, fy - sy, fz - sz
    a = (dx**2 + dy**2) / _GRS80_EQ**2 + dz**2 / _GRS80_POL**2
    b = 2 * ((sx * dx + sy * dy) / _GRS80_EQ**2 + sz * dz / _GRS80_POL**2)
    c = (sx**2 + sy**2) / _GRS80_EQ**2 + sz**2 / _GRS80_POL**2 - 1.0
    disc = np.maximum(b**2 - 4 * a * c, 0.0)
    t = (-b - np.sqrt(disc)) / (2 * a)
    px, py, pz = sx + t * dx, sy + t * dy, sz + t * dz
    return _ecef_to_geodetic(px, py, pz, _GRS80_EQ, _GRS80_POL)


def get_corrected_glm_x_y(flash_lats, flash_lons, goes_ds):
    """Parallax-corrected fixed-grid scan angles of flashes."""
    proj = get_abi_proj(goes_ds)
    lat_c, lon_c = get_glm_parallax_offsets(
        flash_lats, flash_lons, sat_lon=proj.lon0, sat_height=proj.h - proj.req
    )
    return proj.to_xy(lat_c, lon_c)


def get_uncorrected_glm_x_y(flash_lats, flash_lons, goes_ds):
    """Fixed-grid scan angles without parallax correction."""
    return get_abi_proj(goes_ds).to_xy(flash_lats, flash_lons)


def read_glm_flashes(files):
    """Flash (time, lat, lon, energy) arrays from GLM L2 LCFA files (read
    through h5py); an unreadable file is skipped with a warning."""
    times, lats, lons, energies = [], [], [], []
    for f in files:
        try:
            ds = open_dataset(f)
            lats.append(np.asarray(ds["flash_lat"].values, dtype=np.float64))
            lons.append(np.asarray(ds["flash_lon"].values, dtype=np.float64))
            if "flash_energy" in ds.data_vars:
                energies.append(np.asarray(ds["flash_energy"].values, dtype=np.float64))
            else:
                energies.append(np.ones_like(lats[-1]))
            t = ds["flash_time_offset_of_first_event"]
            times.append(np.asarray(t.values).astype("datetime64[ns]"))
        except Exception as exc:
            warnings.warn(f"could not read {f}: {exc}")
    if not lats:
        return (np.empty(0, "datetime64[ns]"), np.empty(0), np.empty(0), np.empty(0))
    return (np.concatenate(times), np.concatenate(lats), np.concatenate(lons),
            np.concatenate(energies))


def _edges(c):
    mid = 0.5 * (c[1:] + c[:-1])
    first = c[0] - (c[1] - c[0]) / 2
    last = c[-1] + (c[-1] - c[-2]) / 2
    return np.concatenate([[first], mid, [last]])


def _bins(values, edges):
    """``np.histogramdd``'s bin of each value over increasing ``edges``
    (tensors on one device): the right-closed search, less one at the
    last edge; -1 outside the edges."""
    idx = torch.searchsorted(edges, values, right=True)
    idx = idx - (values == edges[-1]).long()
    return torch.where((idx >= 1) & (idx < edges.numel()), idx - 1, -1)


def regrid_glm(flash_times, flash_lats, flash_lons, goes_ds, t_bins, correct_parallax=True,
               device=None):
    """Flash counts on the grid of ``goes_ds`` (x/y scan-angle coords and
    ``goes_imager_projection`` metadata) per time bin of ``t_bins``: a
    (T, H, W) int32 tensor on ``device``."""
    dev = resolve_device(device)
    flash_lats = np.asarray(flash_lats)
    flash_lons = np.asarray(flash_lons)
    proj = get_abi_proj(goes_ds)
    if correct_parallax and flash_lats.size:
        flash_lats, flash_lons = get_glm_parallax_offsets(
            flash_lats, flash_lons, sat_lon=proj.lon0, sat_height=proj.h - proj.req
        )
    fx, fy = proj.to_xy(flash_lats, flash_lons) if flash_lats.size else (
        np.empty(0), np.empty(0))

    x = np.asarray(goes_ds.coords["x"], dtype=np.float64)
    y = np.asarray(goes_ds.coords["y"], dtype=np.float64)
    x_edges, y_edges = _edges(x), _edges(y)
    # y scan angles decrease northwards in ABI files; the bins need
    # increasing edges, and their rows reversed back
    y_flip = y_edges[0] > y_edges[-1]
    if y_flip:
        y_edges = y_edges[::-1].copy()

    n_t = len(t_bins) - 1
    counts = torch.zeros(n_t * y.size * x.size, dtype=torch.int64, device=dev)
    if flash_lats.size:
        tidx = np.searchsorted(t_bins, flash_times, side="right") - 1
        ok = (tidx >= 0) & (tidx < n_t) & np.isfinite(fx) & np.isfinite(fy)
        fx_t = torch.from_numpy(np.ascontiguousarray(fx[ok])).to(dev)
        fy_t = torch.from_numpy(np.ascontiguousarray(fy[ok])).to(dev)
        col = _bins(fx_t, torch.from_numpy(x_edges).to(dev))
        row = _bins(fy_t, torch.from_numpy(y_edges).to(dev))
        keep = (col >= 0) & (row >= 0)
        if y_flip:
            row = y.size - 1 - row
        t = torch.from_numpy(tidx[ok].astype(np.int64)).to(dev)
        flat = (t * y.size + row) * x.size + col
        counts = torch.bincount(flat[keep], minlength=counts.numel())
    return counts.view(n_t, y.size, x.size).to(torch.int32)


def _time_bins(times):
    half = np.diff(times) / 2
    return np.concatenate([
        [times[0] - (half[0] if half.size else np.timedelta64(150, "s"))],
        times[:-1] + half,
        [times[-1] + (half[-1] if half.size else np.timedelta64(150, "s"))],
    ])


def gridded_flash_ds(goes_ds, flash_times, flash_lats, flash_lons, device=None):
    """The flashes (times, lats, lons: arrays) gridded onto the grid of
    ``goes_ds`` at its time steps, with parallax correction: a Dataset
    with ``glm_flashes`` (a tensor on ``device``)."""
    times = np.asarray(goes_ds.coords["t"])
    counts = regrid_glm(flash_times, flash_lats, flash_lons, goes_ds, _time_bins(times),
                        device=device)
    out = Dataset(coords=dict(goes_ds.coords))
    out["glm_flashes"] = DataArray(
        counts, dims=("t", "y", "x"),
        attrs={"long_name": "number of GLM flashes detected", "units": ""},
    )
    return out


def create_gridded_flash_ds(goes_ds, start_date, end_date, glm_save_dir=".", io_kwargs=None,
                            device=None):
    """Find the GLM files of the period, read their flashes and grid them
    onto the grid of ``goes_ds`` at its time steps (:func:`gridded_flash_ds`)."""
    from tobac_flow_tpu_torch.data.io import find_glm_files

    files = find_glm_files(start_date, end_date, save_dir=glm_save_dir, **(io_kwargs or {}))
    flash_times, flash_lats, flash_lons, _ = read_glm_flashes(files)
    return gridded_flash_ds(goes_ds, flash_times, flash_lats, flash_lons, device)
