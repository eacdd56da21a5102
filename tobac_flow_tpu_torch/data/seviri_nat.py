"""SEVIRI Level 1.5 native (.nat) archives (counterpart of
``tobac_flow_tpu/data/seviri_nat.py``, with the same bytes and values):
the essential pieces of the EUMETSAT MSG native archive format
(EUM/MSG/ICD/105) written and read directly, without satpy:

* the ASCII U-MARF main header — ``Key : value`` lines carrying the format
  name, the selected bands and the selected-rectangle geometry;
* per-line VISIR records (one per selected channel per image line): a small
  binary line header followed by the pixel counts packed 4-per-5-bytes as
  big-endian 10-bit samples;
* count → radiance calibration (``slope * count + offset``) and radiance →
  brightness temperature via the EUMETSAT effective-radiance analytic Planck
  relation ``T = (C2 νc / ln(1 + C1 νc³ / R) − β) / α`` with the published
  per-channel (νc, α, β) coefficients (Meteosat second generation IR
  channels).

``write_nat`` emits the same layout and doubles as the format document and
the test-fixture generator.  Host numpy and ``struct``, with no h5py: the
decoded fields go to the card in the detection
(``cli.common.run_detection``).

``seviri_nat_dataloader`` gives bt = IR_108 BT, wvd = WV_062 − WV_073 and
twd = max(IR_087 − IR_120, 0), with the 20-minute gap fill.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime, timedelta

import numpy as np

from tobac_flow_tpu_torch.data.dataloader import fill_time_gap_nan
from tobac_flow_tpu_torch.data.ncdataset import DataArray

__all__ = [
    "seviri_nat_dataloader",
    "decode_nat",
    "write_nat",
    "unpack_10bit",
    "pack_10bit",
    "bt_from_radiance",
    "radiance_from_bt",
]

# EUMETSAT effective-radiance Planck coefficients (νc [cm-1], α, β) for the
# MSG SEVIRI thermal channels ("The Conversion from Effective Radiances to
# Equivalent Brightness Temperatures", EUM/MET/TEN/11/0569; MSG-4 values).
PLANCK_COEFFS = {
    "IR_039": (2555.280, 0.9916, 2.9438),
    "WV_062": (1596.080, 0.9959, 2.0780),
    "WV_073": (1361.748, 0.9990, 0.4929),
    "IR_087": (1147.433, 0.9996, 0.1731),
    "IR_097": (1034.851, 0.9999, 0.0597),
    "IR_108": (931.122, 0.9983, 0.6256),
    "IR_120": (839.113, 0.9988, 0.4002),
    "IR_134": (748.585, 0.9981, 0.5635),
}

_C1 = 1.19104e-5  # mW m-2 sr-1 (cm-1)-4
_C2 = 1.43877  # K (cm-1)-1

# the twelve SEVIRI bands in transmission order
ALL_BANDS = (
    "VIS006", "VIS008", "IR_016", "IR_039", "WV_062", "WV_073",
    "IR_087", "IR_097", "IR_108", "IR_120", "IR_134", "HRV",
)

_HEADER_SIZE = 4096  # ASCII U-MARF main header, zero-padded
_LINE_HEADER = struct.Struct(">iiiBxxx")  # line no, days, ms-of-day, validity
_EPOCH = datetime(1958, 1, 1)  # TAI epoch of the CDS scan-time stamps
_DECODE_THREADS = 8  # files a loader decodes side by side


def bt_from_radiance(radiance, channel):
    """Equivalent brightness temperature [K] from effective radiance."""
    nu, alpha, beta = PLANCK_COEFFS[channel]
    r = np.maximum(np.asarray(radiance, dtype=np.float64), 1e-12)
    return ((_C2 * nu) / np.log1p(_C1 * nu**3 / r) - beta) / alpha


def radiance_from_bt(bt, channel):
    """Effective radiance from brightness temperature (writer side)."""
    nu, alpha, beta = PLANCK_COEFFS[channel]
    t = np.asarray(bt, dtype=np.float64)
    return _C1 * nu**3 / np.expm1(_C2 * nu / (alpha * t + beta))


def pack_10bit(values):
    """Pack uint16 samples (<1024) as big-endian 10-bit, 4 samples / 5 bytes."""
    v = np.asarray(values, dtype=np.uint16).ravel()
    pad = (-v.size) % 4
    if pad:
        v = np.concatenate([v, np.zeros(pad, np.uint16)])
    v = v.reshape(-1, 4).astype(np.uint64)
    word = (v[:, 0] << 30) | (v[:, 1] << 20) | (v[:, 2] << 10) | v[:, 3]
    out = np.empty((word.size, 5), np.uint8)
    for i in range(5):
        out[:, i] = (word >> (8 * (4 - i))) & 0xFF
    return out.tobytes()


def unpack_10bit(buf, count):
    """Inverse of :func:`pack_10bit`: the first ``count`` 10-bit samples."""
    b = np.frombuffer(buf, dtype=np.uint8).astype(np.uint64)
    b = b[: (len(b) // 5) * 5].reshape(-1, 5)
    word = (
        (b[:, 0] << 32) | (b[:, 1] << 24) | (b[:, 2] << 16)
        | (b[:, 3] << 8) | b[:, 4]
    )
    out = np.empty((word.size, 4), np.uint16)
    out[:, 0] = (word >> 30) & 0x3FF
    out[:, 1] = (word >> 20) & 0x3FF
    out[:, 2] = (word >> 10) & 0x3FF
    out[:, 3] = word & 0x3FF
    return out.ravel()[:count]


def _format_header(meta: dict) -> bytes:
    lines = [f"{k} : {v}" for k, v in meta.items()]
    text = ("\n".join(lines) + "\n").encode("ascii")
    if len(text) > _HEADER_SIZE:
        raise ValueError("header too large")
    return text.ljust(_HEADER_SIZE, b"\x00")


def parse_umarf_header(buf: bytes) -> dict:
    """Parse the ASCII ``Key : value`` main header block."""
    meta = {}
    for line in buf.rstrip(b"\x00").decode("ascii", "replace").splitlines():
        if ":" in line:
            k, _, v = line.partition(":")
            meta[k.strip()] = v.strip()
    return meta


def write_nat(
    path,
    bt_fields: dict,
    scan_time: datetime,
    cal_slope: float | None = None,
    cal_offset: float | None = None,
):
    """Write a native-format archive holding the given per-channel BT fields
    (all (H, W), Kelvin).  Counts are quantised through the inverse
    calibration + Planck chain, so decode(write(x)) ≈ x.  By default each
    channel's calibration gain is fitted to its own radiance range (as the
    ground segment assigns per-channel gains); pass explicit slope/offset to
    force one shared calibration."""
    channels = [b for b in ALL_BANDS if b in bt_fields]
    shapes = {np.asarray(v).shape for v in bt_fields.values()}
    if len(shapes) != 1:
        raise ValueError("all channels must share one shape")
    (h, w) = shapes.pop()

    meta = {
        "FormatName": "NATIVE",
        "SatelliteId": "324",
        "SelectedBandIDs": "".join(
            "X" if b in channels else "-" for b in ALL_BANDS
        ),
        "NumberLinesVISIR": str(h),
        "NumberColumnsVISIR": str(w),
        "NorthLineSelectedRectangle": str(h),
        "SouthLineSelectedRectangle": "1",
        "EastColumnSelectedRectangle": "1",
        "WestColumnSelectedRectangle": str(w),
        "SnapshotTime": scan_time.strftime("%Y%m%d%H%M%S"),
    }
    gains = {}
    for ch in channels:
        if cal_slope is not None:
            gains[ch] = (float(cal_slope), float(cal_offset or 0.0))
        else:
            rad = radiance_from_bt(np.asarray(bt_fields[ch]), ch)
            lo, hi = float(rad.min()), float(rad.max())
            margin = max((hi - lo) * 0.05, 1e-6)
            slope = (hi - lo + 2 * margin) / 1023.0
            gains[ch] = (slope, lo - margin)
        meta[f"CalSlope_{ch}"] = repr(gains[ch][0])
        meta[f"CalOffset_{ch}"] = repr(gains[ch][1])

    days = (scan_time - _EPOCH).days
    ms = int(
        (scan_time - _EPOCH - timedelta(days=days)).total_seconds() * 1000
    )
    # every line record of the file at once: line, scan time, validity and
    # each line's counts packed on their own, as the format lays them out
    records = np.zeros((h, len(channels)), _record_dtype(((w + 3) // 4) * 5))
    records["line"] = np.arange(1, h + 1)[:, None]
    records["days"], records["ms"], records["valid"] = days, ms, 1
    for c, ch in enumerate(channels):
        rad = radiance_from_bt(np.asarray(bt_fields[ch]), ch)
        slope, offset = gains[ch]
        counts = np.clip(np.round((rad - offset) / slope), 0, 1023).astype(np.uint16)
        records["data"][:, c] = _pack_lines(counts)
    with open(path, "wb") as f:
        f.write(_format_header(meta))
        f.write(records.tobytes())
    return path


def _pack_lines(counts):
    """Each row of (H, W) counts packed as :func:`pack_10bit` packs a line:
    (H, line bytes) uint8."""
    h, w = counts.shape
    v = np.zeros((h, -(-w // 4) * 4), np.uint64)
    v[:, :w] = counts
    v = v.reshape(h, -1, 4)
    word = (v[..., 0] << 30) | (v[..., 1] << 20) | (v[..., 2] << 10) | v[..., 3]
    out = np.empty(word.shape + (5,), np.uint8)
    for i in range(5):
        out[..., i] = (word >> (8 * (4 - i))) & 0xFF
    return out.reshape(h, -1)


def _record_dtype(line_bytes):
    """One VISIR line record: the line header, then the packed samples."""
    return np.dtype([("line", ">i4"), ("days", ">i4"), ("ms", ">i4"), ("valid", "u1"),
                     ("pad", "V3"), ("data", "u1", (line_bytes,))])


def decode_nat(path):
    """Decode a native archive into per-channel BT arrays (solar channels
    as radiance), every line record of a channel unpacked at once.

    Returns (fields: {channel: (H, W) float32 BT}, meta, scan_time).
    """
    with open(path, "rb") as f:
        meta = parse_umarf_header(f.read(_HEADER_SIZE))
        if meta.get("FormatName") != "NATIVE":
            raise ValueError(f"{path} is not a native-format archive")
        h = int(meta["NumberLinesVISIR"])
        w = int(meta["NumberColumnsVISIR"])
        selected = meta["SelectedBandIDs"]
        channels = [b for b, flag in zip(ALL_BANDS, selected) if flag == "X"]
        dtype = _record_dtype(((w + 3) // 4) * 5)
        buf = f.read(h * len(channels) * dtype.itemsize)
    if len(buf) < h * len(channels) * dtype.itemsize:
        raise ValueError(f"{path} is truncated")
    records = np.frombuffer(buf, dtype).reshape(h, len(channels))
    first = records[0, 0] if records.size else None
    scan_time = None if first is None else _EPOCH + timedelta(
        days=int(first["days"]), milliseconds=int(first["ms"]))

    fields = {}
    for c, ch in enumerate(channels):
        lines = records[:, c]
        valid = lines["valid"] != 0
        counts = np.empty((h, w), np.uint16)
        counts[lines["line"][valid] - 1] = unpack_10bit(
            lines["data"][valid].tobytes(), int(valid.sum()) * (dtype["data"].shape[0] // 5) * 4
        ).reshape(int(valid.sum()), -1)[:, :w]
        slope = float(meta.get(f"CalSlope_{ch}", 1.0))
        offset = float(meta.get(f"CalOffset_{ch}", 0.0))
        rad = counts.astype(np.float64) * slope + offset
        if ch in PLANCK_COEFFS:
            fields[ch] = bt_from_radiance(rad, ch).astype(np.float32)
        else:  # solar channels stay as radiance
            fields[ch] = rad.astype(np.float32)
    return fields, meta, scan_time


def seviri_nat_dataloader(
    start_date,
    end_date,
    file_paths,
    x0=None,
    x1=None,
    y0=None,
    y1=None,
    time_gap=timedelta(minutes=20),
):
    """(bt, wvd, twd) DataArrays (numpy) from native SEVIRI archives:
    bt = IR_108 BT, wvd = WV_062 − WV_073, twd = max(IR_087 − IR_120, 0),
    cropped to [y0:y1, x0:x1], with an all-NaN frame in each gap over
    ``time_gap``.  Files are decoded in threads side by side (numpy's
    unpacking and calibration release the GIL), each keeping only its
    crop."""
    times, bts, wvds, twds = [], [], [], []
    sl = (slice(y0, y1), slice(x0, x1))

    def scan(path):
        fields, _, scan_time = decode_nat(path)
        return (np.datetime64(scan_time, "ns"), fields["IR_108"][sl].copy(),
                fields["WV_062"][sl] - fields["WV_073"][sl],
                np.maximum(fields["IR_087"][sl] - fields["IR_120"][sl], 0))

    paths = sorted(file_paths)
    with ThreadPoolExecutor(max(1, min(_DECODE_THREADS, len(paths)))) as pool:
        scans = list(pool.map(scan, paths))
    for t, bt, wvd, twd in scans:
        if start_date is not None and t < np.datetime64(start_date, "ns"):
            continue
        if end_date is not None and t >= np.datetime64(end_date, "ns"):
            continue
        times.append(t)
        bts.append(bt)
        wvds.append(wvd)
        twds.append(twd)

    if not times:
        raise ValueError("no native files inside the requested window")
    order = np.argsort(np.asarray(times))
    coords = {"t": np.asarray(times)[order]}

    def da(stack, name):
        return DataArray(
            np.stack([stack[i] for i in order]).astype(np.float32),
            coords=coords,
            dims=("t", "y", "x"),
            name=name,
            attrs={"long_name": name, "units": "K"},
        )

    bt = fill_time_gap_nan(da(bts, "bt"), time_gap)
    wvd = fill_time_gap_nan(da(wvds, "wvd"), time_gap)
    twd = fill_time_gap_nan(da(twds, "twd"), time_gap)
    return bt, wvd, twd
