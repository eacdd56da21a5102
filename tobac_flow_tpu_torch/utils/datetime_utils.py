"""Datetime helpers (counterpart of
``tobac_flow_tpu/utils/datetime_utils.py``): time coordinates as python
datetimes, their centred differences, the ``_S``/``_E`` dates of an output
file's name, and trimming a dataset's padding frames."""

from __future__ import annotations

from datetime import datetime, timedelta
import re

import numpy as np

__all__ = [
    "get_datetime_from_coord",
    "time_diff",
    "get_time_diff_from_coord",
    "get_dates_from_filename",
    "trim_file_start",
    "trim_file_end",
    "trim_file_start_and_end",
]


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


_DATE_RE = re.compile(r"_S(\d{13}|\d{14})_E(\d{13}|\d{14})")


def get_dates_from_filename(filename):
    """The start and end datetimes of the _S<date>_E<date> tokens of a
    GOES-style output file's name."""
    m = _DATE_RE.search(str(filename))
    if not m:
        raise ValueError(f"no _S/_E date tokens in {filename!r}")

    def parse(tok):
        year = int(tok[:4])
        doy = int(tok[4:7])
        hour = int(tok[7:9])
        minute = int(tok[9:11])
        second = int(tok[11:13])
        return datetime(year, 1, 1) + timedelta(
            days=doy - 1, hours=hour, minutes=minute, seconds=second
        )

    return parse(m.group(1)), parse(m.group(2))


def _time_index(ds_time, when):
    """The first frame at or after ``when``: the start trim keeps it, and
    the end trim is exclusive, so a frame stamped exactly at the end date
    belongs to the next file."""
    times = np.asarray(getattr(ds_time, "values", ds_time))
    return int(np.searchsorted(times, np.datetime64(when), side="left"))


def trim_file_start(ds, start_date):
    """Drop leading padding frames before start_date."""
    return ds.isel(t=slice(_time_index(ds.t, start_date), None))


def trim_file_end(ds, end_date):
    """Drop trailing padding frames at/after end_date."""
    return ds.isel(t=slice(None, _time_index(ds.t, end_date)))


def trim_file_start_and_end(ds, start_date, end_date):
    return trim_file_end(trim_file_start(ds, start_date), end_date)
