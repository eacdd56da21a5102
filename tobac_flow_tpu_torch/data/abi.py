"""GOES-R ABI fixed-grid geometry and L1b calibration (counterpart of
``tobac_flow_tpu/data/abi.py``): the GOES-R Product User Guide's fixed-grid
equations in float64 numpy, NaN off the disk, with the same operations in
the same order, so that lat, lon and pixel areas are identical; satellite
zenith, lat/lon to scan angles, radiance to reflectance or brightness
temperature, and the two RGB composites.  Host numpy: these run once per
grid, not per frame.
"""

from __future__ import annotations

import numpy as np

from tobac_flow_tpu_torch.utils.geo import get_pixel_lengths

__all__ = [
    "ABIProjection",
    "get_abi_proj",
    "get_abi_lat_lon",
    "get_abi_pixel_lengths",
    "get_abi_pixel_area",
    "get_abi_sat_zenith",
    "get_abi_xy_from_latlon",
    "get_abi_ref",
    "get_abi_bt",
    "get_abi_da",
    "get_abi_rgb",
    "get_abi_deep_cloud_rgb",
]


class ABIProjection:
    """Geostationary fixed-grid projection from file metadata."""

    def __init__(
        self,
        semi_major_axis=6378137.0,
        semi_minor_axis=6356752.31414,
        perspective_point_height=35786023.0,
        longitude_of_projection_origin=-75.0,
        **_,
    ):
        self.req = float(semi_major_axis)
        self.rpol = float(semi_minor_axis)
        self.h = float(perspective_point_height) + self.req
        self.lon0 = float(longitude_of_projection_origin)

    # -- scan angles -> geodetic ----------------------------------------
    def to_latlon(self, x, y):
        """Fixed-grid scan angles (radians) -> (lat, lon) degrees."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        req2 = self.req**2
        rpol2 = self.rpol**2
        sinx, cosx = np.sin(x), np.cos(x)
        siny, cosy = np.sin(y), np.cos(y)
        a = sinx**2 + cosx**2 * (cosy**2 + (req2 / rpol2) * siny**2)
        b = -2.0 * self.h * cosx * cosy
        c = self.h**2 - req2
        disc = b**2 - 4 * a * c
        with np.errstate(invalid="ignore"):
            rs = (-b - np.sqrt(disc)) / (2 * a)
            sx = rs * cosx * cosy
            sy = -rs * sinx
            sz = rs * cosx * siny
            lat = np.degrees(
                np.arctan((req2 / rpol2) * sz / np.sqrt((self.h - sx) ** 2 + sy**2))
            )
            lon = self.lon0 - np.degrees(np.arctan(sy / (self.h - sx)))
        off_disk = disc < 0
        lat = np.where(off_disk, np.nan, lat)
        lon = np.where(off_disk, np.nan, lon)
        return lat, lon

    # -- geodetic -> scan angles ----------------------------------------
    def to_xy(self, lat, lon):
        """(lat, lon) degrees -> fixed-grid scan angles (radians)."""
        lat = np.radians(np.asarray(lat, dtype=np.float64))
        lon = np.radians(np.asarray(lon, dtype=np.float64))
        lon0 = np.radians(self.lon0)
        e2 = 1.0 - (self.rpol**2 / self.req**2)
        phi_c = np.arctan((self.rpol**2 / self.req**2) * np.tan(lat))
        rc = self.rpol / np.sqrt(1.0 - e2 * np.cos(phi_c) ** 2)
        sx = self.h - rc * np.cos(phi_c) * np.cos(lon - lon0)
        sy = -rc * np.cos(phi_c) * np.sin(lon - lon0)
        sz = rc * np.sin(phi_c)
        # visibility check (point on the near side of the earth)
        visible = self.h * (self.h - sx) >= sy**2 + (self.req**2 / self.rpol**2) * sz**2
        x = np.where(visible, np.arcsin(-sy / np.sqrt(sx**2 + sy**2 + sz**2)), np.nan)
        y = np.where(visible, np.arctan(sz / sx), np.nan)
        return x, y

    def sat_zenith(self, lat, lon):
        """Satellite viewing zenith angle (degrees) at geodetic locations."""
        lat_r = np.radians(np.asarray(lat, dtype=np.float64))
        dlon = np.radians(np.asarray(lon, dtype=np.float64) - self.lon0)
        cos_beta = np.cos(lat_r) * np.cos(dlon)
        r = self.req  # spherical approximation for viewing geometry
        d = np.sqrt(self.h**2 + r**2 - 2 * self.h * r * cos_beta)
        sin_zen = np.clip(self.h * np.sqrt(1 - cos_beta**2) / d, -1, 1)
        zen = np.degrees(np.arcsin(sin_zen))
        # beyond-limb points view from below the horizon
        return np.where(cos_beta < r / self.h, 90 + (90 - zen), zen)


def _proj_params(dataset):
    gp = dataset["goes_imager_projection"]
    return {k: v for k, v in gp.attrs.items() if not k.startswith("_")}


def get_abi_proj(dataset) -> ABIProjection:
    """Build the projection from a dataset's goes_imager_projection metadata."""
    params = _proj_params(dataset)
    return ABIProjection(
        semi_major_axis=params.get("semi_major_axis", 6378137.0),
        semi_minor_axis=params.get("semi_minor_axis", 6356752.31414),
        perspective_point_height=params.get("perspective_point_height", 35786023.0),
        longitude_of_projection_origin=params.get(
            "longitude_of_projection_origin", -75.0
        ),
    )


def _scan_grids(dataset):
    x = np.asarray(getattr(dataset["x"], "values", dataset["x"]), dtype=np.float64)
    y = np.asarray(getattr(dataset["y"], "values", dataset["y"]), dtype=np.float64)
    return np.meshgrid(x, y)


def get_abi_lat_lon(dataset):
    """(lat, lon) grids for a dataset with x/y scan-angle coords."""
    proj = get_abi_proj(dataset)
    xx, yy = _scan_grids(dataset)
    return proj.to_latlon(xx, yy)


def get_abi_pixel_lengths(dataset):
    """Pixel x/y extents in km."""
    lat, lon = get_abi_lat_lon(dataset)
    return get_pixel_lengths(lat, lon)


def get_abi_pixel_area(dataset):
    """Pixel areas in km²."""
    dx, dy = get_abi_pixel_lengths(dataset)
    return dx * dy


def get_abi_sat_zenith(dataset):
    """Satellite zenith angle grid."""
    proj = get_abi_proj(dataset)
    lat, lon = get_abi_lat_lon(dataset)
    return proj.sat_zenith(lat, lon)


def get_abi_xy_from_latlon(dataset, lat, lon):
    """Geodetic -> fixed-grid scan angles."""
    return get_abi_proj(dataset).to_xy(lat, lon)


def get_abi_ref(rad_da, kappa0):
    """L1b radiance -> reflectance factor."""
    vals = np.asarray(getattr(rad_da, "values", rad_da), dtype=np.float64)
    return np.clip(vals * float(kappa0), 0.0, None).astype(np.float32)


def get_abi_bt(rad_da, fk1, fk2, bc1, bc2):
    """L1b radiance -> brightness temperature via the inverse Planck
    relation."""
    vals = np.asarray(getattr(rad_da, "values", rad_da), dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        bt = (float(fk2) / np.log(float(fk1) / vals + 1.0) - float(bc1)) / float(bc2)
    return bt.astype(np.float32)


def get_abi_da(l1b_ds):
    """Calibrate an L1b Rad dataset to reflectance (ch 1-6) or BT (ch 7-16)
    using its own planck/kappa coefficients."""
    band = int(np.asarray(getattr(l1b_ds["band_id"], "values", l1b_ds["band_id"])).ravel()[0])
    rad = l1b_ds["Rad"]
    if band < 7:
        k0 = float(np.asarray(getattr(l1b_ds["kappa0"], "values", l1b_ds["kappa0"])))
        return get_abi_ref(rad, k0)
    coeffs = [
        float(np.asarray(getattr(l1b_ds[k], "values", l1b_ds[k])))
        for k in ("planck_fk1", "planck_fk2", "planck_bc1", "planck_bc2")
    ]
    return get_abi_bt(rad, *coeffs)


def get_abi_rgb(ref_red, ref_green_veggie, ref_blue, gamma=2.2):
    """True-colour RGB with the synthetic green band."""
    r = np.clip(np.asarray(ref_red), 0, 1) ** (1.0 / gamma)
    v = np.clip(np.asarray(ref_green_veggie), 0, 1) ** (1.0 / gamma)
    b = np.clip(np.asarray(ref_blue), 0, 1) ** (1.0 / gamma)
    g = np.clip(0.45 * r + 0.1 * v + 0.45 * b, 0, 1)
    return np.stack([r, g, b], axis=-1)


def get_abi_deep_cloud_rgb(bt_c13, ref_c02, sza=None):
    """Deep-cloud RGB composite: red = inverted
    clean-IR BT, green = visible reflectance, blue = cold-bt enhancement."""
    bt = np.asarray(bt_c13, dtype=np.float64)
    red = np.clip((280.0 - bt) / (280.0 - 180.0), 0, 1)
    ref = np.clip(np.asarray(ref_c02, dtype=np.float64), 0, 1)
    if sza is not None:
        mu = np.cos(np.radians(np.asarray(sza)))
        ref = np.where(mu > 0.05, np.clip(ref / np.maximum(mu, 0.05), 0, 1), 0.0)
    green = ref ** (1 / 2.2)
    blue = np.clip((245.0 - bt) / (245.0 - 205.0), 0, 1)
    return np.stack([red, green, blue], axis=-1)
