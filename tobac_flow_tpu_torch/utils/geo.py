"""Geodesic helpers (counterpart of ``tobac_flow_tpu/utils/geo.py``, host
numpy in float64 with the same operations in the same order, so that the
results are identical): great-circle distance and bearing on the WGS84 mean
radius, an object's mean azimuth and speed, the solar zenith and azimuth,
satellite viewing angles, and pixel lengths and areas from lat/lon grids.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "haversine_distance",
    "initial_bearing",
    "get_mean_object_azimuth_and_speed",
    "get_sza",
    "get_sza_and_azi",
    "get_satellite_viewing_angles",
    "get_pixel_lengths",
    "get_pixel_area",
]

_R_EARTH = 6371008.8  # mean Earth radius [m]


def haversine_distance(lon0, lat0, lon1, lat1):
    """Great-circle distance in metres."""
    lon0, lat0, lon1, lat1 = map(np.radians, (lon0, lat0, lon1, lat1))
    dlat = lat1 - lat0
    dlon = lon1 - lon0
    a = np.sin(dlat / 2) ** 2 + np.cos(lat0) * np.cos(lat1) * np.sin(dlon / 2) ** 2
    return 2 * _R_EARTH * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def initial_bearing(lon0, lat0, lon1, lat1):
    """Initial bearing (degrees clockwise from north) from point 0 to 1."""
    lon0, lat0, lon1, lat1 = map(np.radians, (lon0, lat0, lon1, lat1))
    dlon = lon1 - lon0
    x = np.sin(dlon) * np.cos(lat1)
    y = np.cos(lat0) * np.sin(lat1) - np.sin(lat0) * np.cos(lat1) * np.cos(dlon)
    return (np.degrees(np.arctan2(x, y)) + 360.0) % 360.0


def get_mean_object_azimuth_and_speed(lons, lats, times):
    """Mean propagation direction (circular mean of step-to-step bearings,
    degrees from north) and speed (m/s) of an object track."""
    order = np.argsort(np.asarray(times))
    lons = np.asarray(lons, dtype=float)[order]
    lats = np.asarray(lats, dtype=float)[order]
    times = np.asarray(times)[order]
    if lons.size < 2:
        return [np.nan, np.nan]
    az = initial_bearing(lons[:-1], lats[:-1], lons[1:], lats[1:])
    dist = haversine_distance(lons[:-1], lats[:-1], lons[1:], lats[1:])
    dt = np.diff(times).astype("timedelta64[s]").astype(float)
    total_dt = np.sum(dt)
    speed = np.sum(dist) / total_dt if total_dt > 0 else np.nan
    # circular mean of azimuths
    rad = np.radians(az)
    mean_az = (np.degrees(np.arctan2(np.mean(np.sin(rad)), np.mean(np.cos(rad)))) + 360.0) % 360.0
    return [mean_az, speed]


def _solar_angles(datetimes, lat, lon):
    """(declination, hour angle, latitude) in radians and the cosine of the
    solar zenith angle, from a Fourier day-angle series."""
    datetimes = np.asarray(datetimes, dtype="datetime64[s]")
    doy = (
        (datetimes - datetimes.astype("datetime64[Y]")).astype("timedelta64[D]")
    ).astype(float)
    hours = (
        (datetimes - datetimes.astype("datetime64[D]")).astype("timedelta64[s]")
    ).astype(float) / 3600.0
    g = 2 * np.pi * (doy + hours / 24.0) / 365.25
    # solar declination (Spencer 1971 series)
    dec = (
        0.006918
        - 0.399912 * np.cos(g)
        + 0.070257 * np.sin(g)
        - 0.006758 * np.cos(2 * g)
        + 0.000907 * np.sin(2 * g)
        - 0.002697 * np.cos(3 * g)
        + 0.00148 * np.sin(3 * g)
    )
    # equation of time [minutes]
    eqt = 229.18 * (
        0.000075
        + 0.001868 * np.cos(g)
        - 0.032077 * np.sin(g)
        - 0.014615 * np.cos(2 * g)
        - 0.040849 * np.sin(2 * g)
    )
    tst = hours * 60.0 + eqt + 4.0 * np.asarray(lon)
    ha = np.radians(tst / 4.0 - 180.0)
    lat_r = np.radians(np.asarray(lat))
    cos_sza = np.sin(lat_r) * np.sin(dec) + np.cos(lat_r) * np.cos(dec) * np.cos(ha)
    return dec, ha, lat_r, cos_sza


def get_sza(datetimes, lat, lon):
    """Solar zenith angle (degrees)."""
    cos_sza = _solar_angles(datetimes, lat, lon)[3]
    return np.degrees(np.arccos(np.clip(cos_sza, -1, 1)))


def get_sza_and_azi(datetimes, lat, lon):
    """Solar zenith and azimuth angles (degrees; azimuth clockwise from
    north)."""
    dec, ha, lat_r, cos_sza = _solar_angles(datetimes, lat, lon)
    sza = np.degrees(np.arccos(np.clip(cos_sza, -1, 1)))
    sin_sza = np.sin(np.radians(sza))
    with np.errstate(invalid="ignore", divide="ignore"):
        cos_azi = (np.sin(dec) - np.sin(lat_r) * cos_sza) / (
            np.cos(lat_r) * np.where(sin_sza == 0, np.nan, sin_sza)
        )
    azi = np.degrees(np.arccos(np.clip(cos_azi, -1, 1)))
    azi = np.where(ha > 0, 360.0 - azi, azi)
    return sza, azi


def get_satellite_viewing_angles(lat, lon, sat_lon=-75.0, sat_height=35786023.0):
    """Satellite zenith and azimuth at ground locations."""
    from tobac_flow_tpu_torch.data.abi import ABIProjection

    proj = ABIProjection(
        longitude_of_projection_origin=sat_lon,
        perspective_point_height=sat_height,
    )
    zen = proj.sat_zenith(lat, lon)
    azi = initial_bearing(lon, lat, np.full_like(np.asarray(lon, float), sat_lon),
                          np.zeros_like(np.asarray(lat, float)))
    return zen, azi


def get_pixel_lengths(lat, lon):
    """Approximate pixel x/y lengths (km) from lat/lon grids."""
    dy = haversine_distance(lon[:-1, :], lat[:-1, :], lon[1:, :], lat[1:, :]) / 1e3
    dx = haversine_distance(lon[:, :-1], lat[:, :-1], lon[:, 1:], lat[:, 1:]) / 1e3
    dy = np.pad(dy, ((0, 1), (0, 0)), mode="edge")
    dx = np.pad(dx, ((0, 0), (0, 1)), mode="edge")
    return dx, dy


def get_pixel_area(lat, lon):
    """Approximate pixel areas (km²) from lat/lon grids."""
    dx, dy = get_pixel_lengths(lat, lon)
    return dx * dy
