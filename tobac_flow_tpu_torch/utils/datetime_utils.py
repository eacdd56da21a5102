"""Datetime helpers (counterpart of the parts of
``tobac_flow_tpu/utils/datetime_utils.py`` the detection chain uses)."""

from __future__ import annotations

from datetime import datetime

import numpy as np

__all__ = ["get_datetime_from_coord", "time_diff", "get_time_diff_from_coord"]


def get_datetime_from_coord(coord):
    """A time coordinate (datetime64 array) as python datetimes."""
    vals = np.asarray(getattr(coord, "values", coord))
    if np.issubdtype(vals.dtype, np.datetime64):
        vals = vals.astype("datetime64[us]").astype(datetime)
    return list(np.atleast_1d(vals))


def time_diff(datetime_list):
    """Centred finite differences of datetimes in fractional minutes
    (one-sided at the ends)."""
    n = len(datetime_list)
    if n < 2:
        raise ValueError("need at least two times")
    out = [(datetime_list[1] - datetime_list[0]).total_seconds() / 60]
    out += [
        (datetime_list[i + 2] - datetime_list[i]).total_seconds() / 120
        for i in range(n - 2)
    ]
    out += [(datetime_list[-1] - datetime_list[-2]).total_seconds() / 60]
    return out


def get_time_diff_from_coord(coord):
    return np.array(time_diff(get_datetime_from_coord(coord)))
