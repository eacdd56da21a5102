"""NEXRAD Level-II (Archive2 / AR2V) reflectivity decoder (counterpart of
``tobac_flow_tpu/data/nexrad_level2.py``), host numpy and ``struct``, for
the publicly documented ICD 2620002 format:

* 24-byte volume header (``AR2V00xx.`` + extension + date/time + ICAO),
* LDM records: big-endian int32 control word (compressed size, negative on
  the final record) followed by a bzip2 stream,
* decompressed streams of messages, each framed by a 12-byte CTM pad and a
  16-byte message header; **message type 31** (digital radar data) carries
  the radial: azimuth/elevation, a block-pointer table, the ``RVOL`` volume
  block (site lat/lon/height) and the ``DREF`` reflectivity moment
  (ngates, first-gate range, gate spacing, scale/offset, one byte or
  halfword per gate, decoded for the whole radial at once).

Gate geolocation follows the 4/3-effective-Earth beam model and an
azimuthal-equidistant inverse from the site, in float64 over every gate
of the volume at once, with the reference's operations in its order, so
that the gates' (lat, lon, alt) have its bits.
"""

from __future__ import annotations

import bz2
import struct
from datetime import datetime, timedelta, timezone

import numpy as np
from numpy import ma

__all__ = ["read_nexrad_archive", "decode_archive_bytes", "gate_lat_lon_alt"]

_MSG_HEADER = struct.Struct(">HBBHHIHH")  # size, channel, type, seq, date, ms*? ...
# message header: size (halfwords), RDA channel, message type, sequence id,
# julian date, milliseconds, number of segments, segment number
_MSG31_HEADER = struct.Struct(">4sIHHfBBHBBBBfBbH")
# id, collect_ms, collect_date, azimuth_number, azimuth_angle, compress_flag,
# spare, radial_length, azimuth_resolution, radial_spacing, elevation_number,
# cut_sector, elevation_angle, radial_blanking, azimuth_mode, block_count
_BLOCK_HEADER = struct.Struct(">1s3s")
_VOL_BLOCK = struct.Struct(">HBBffhhf")  # lrtup, vmaj, vmin, lat, lon, height, feedhorn, calib
_MOMENT_HEADER = struct.Struct(">IHHHHHBBff")
# reserved, ngates, first_gate (m), gate_spacing (m), thresh, snr_thresh,
# flags, word_size, scale, offset

_R_EARTH = 6370997.0  # pyart's aeqd default radius
_KE = 4.0 / 3.0  # effective-Earth beam-bending factor


def gate_lat_lon_alt(site_lat, site_lon, site_alt, azimuth_deg, elevation_deg, range_m):
    """Geolocate gates from antenna coordinates (4/3-Earth beam model +
    azimuthal-equidistant inverse; broadcasting over inputs)."""
    az = np.radians(np.asarray(azimuth_deg, dtype=np.float64))
    el = np.radians(np.asarray(elevation_deg, dtype=np.float64))
    r = np.asarray(range_m, dtype=np.float64)
    R = _R_EARTH * _KE
    z = np.sqrt(r**2 + R**2 + 2.0 * r * R * np.sin(el)) - R
    s = R * np.arcsin(np.clip(r * np.cos(el) / (R + z), -1.0, 1.0))
    x = s * np.sin(az)
    y = s * np.cos(az)
    rho = np.sqrt(x**2 + y**2)
    c = rho / _R_EARTH
    lat0 = np.radians(float(site_lat))
    lon0 = np.radians(float(site_lon))
    with np.errstate(invalid="ignore", divide="ignore"):
        lat = np.arcsin(
            np.cos(c) * np.sin(lat0)
            + np.where(rho > 0, y * np.sin(c) * np.cos(lat0) / np.where(rho > 0, rho, 1.0), 0.0)
        )
        lon = lon0 + np.arctan2(
            x * np.sin(c),
            rho * np.cos(c) * np.cos(lat0) - y * np.sin(c) * np.sin(lat0),
        )
    lat = np.where(rho > 0, lat, lat0)
    lon = np.where(rho > 0, lon, lon0)
    return np.degrees(lat), np.degrees(lon), z + float(site_alt)


def _iter_ldm_records(buf):
    """Yield decompressed LDM record payloads, or the raw message stream for
    an uncompressed archive.

    Compression is sniffed the way pyart does: bytes 4:6 of the post-header
    buffer hold ``BZ`` when LDM records are bzip2 blocks behind a 4-byte
    control word.  When absent, the WHOLE buffer is the message stream —
    its first 12 bytes are a CTM header, not a control word, so nothing may
    be skipped (dropping 4 bytes desyncs the 12-byte CTM framing, and a CTM
    starting with zero bytes would read as a zero control word)."""
    if buf[4:6] != b"BZ":
        yield buf
        return
    pos = 0
    n = len(buf)
    while pos + 4 <= n:
        (size,) = struct.unpack(">i", buf[pos : pos + 4])
        last = size < 0
        size = abs(size)
        if size == 0:
            break
        chunk = buf[pos + 4 : pos + 4 + size]
        if chunk[:3] == b"BZh":
            yield bz2.decompress(chunk)
        pos += 4 + size
        if last:
            break


def _parse_msg31(data):
    """Parse one message-31 radial; returns None when it has no DREF block."""
    hdr = _MSG31_HEADER.unpack_from(data, 0)
    (
        _radar_id, collect_ms, collect_date, _az_num, az_angle, _compress,
        _spare, _radial_len, _az_res, _spacing, _elev_num, _sector,
        el_angle, _blanking, _az_mode, block_count,
    ) = hdr
    ptrs = struct.unpack_from(f">{max(block_count, 0)}i", data, _MSG31_HEADER.size)

    site = None
    moment = None
    for p in ptrs:
        if p <= 0 or p + _BLOCK_HEADER.size > len(data):
            continue
        btype, bname = _BLOCK_HEADER.unpack_from(data, p)
        name = bname.decode("ascii", "replace")
        if btype == b"R" and name == "VOL":
            _, _, _, lat, lon, height, _feed, _cal = _VOL_BLOCK.unpack_from(
                data, p + _BLOCK_HEADER.size
            )
            site = (lat, lon, float(height))
        elif btype == b"D" and name == "REF":
            (
                _res, ngates, first_gate, gate_spacing, _thresh, _snr,
                _flags, word_size, scale, offset,
            ) = _MOMENT_HEADER.unpack_from(data, p + _BLOCK_HEADER.size)
            start = p + _BLOCK_HEADER.size + _MOMENT_HEADER.size
            if word_size == 16:
                raw = np.frombuffer(data, ">u2", count=ngates, offset=start)
            else:
                raw = np.frombuffer(data, "u1", count=ngates, offset=start)
            vals = ma.masked_array(raw.astype(np.float32), mask=raw < 2)
            if scale != 0:
                vals = (vals - offset) / scale
            moment = (float(first_gate), float(gate_spacing), vals)
    if moment is None:
        return None
    # collect_date: days since 1 Jan 1970 (day 1); collect_ms: ms past midnight
    when = datetime(1970, 1, 1, tzinfo=timezone.utc) + timedelta(
        days=collect_date - 1, milliseconds=collect_ms
    )
    return {
        "time": when.replace(tzinfo=None),
        "azimuth": float(az_angle),
        "elevation": float(el_angle),
        "site": site,
        "first_gate": moment[0],
        "gate_spacing": moment[1],
        "reflectivity": moment[2],
    }


def decode_archive_bytes(buf):
    """Decode a full AR2V archive byte string into per-radial dicts.

    Returns (volume_header_dict, [radial dicts]) — only message-31 radials
    that carry a reflectivity moment are kept (the reference loads archives
    with ``include_fields=["reflectivity"]``, ``nexrad.py:31-35``).
    """
    if len(buf) < 24:
        raise ValueError("truncated NEXRAD archive (no volume header)")
    tape, ext, vdate, vtime, icao = struct.unpack(">9s3siI4s", buf[:24])
    if not tape.startswith(b"AR2V"):
        raise ValueError(f"not an AR2V archive (header {tape!r})")
    header = {
        "version": tape.decode("ascii", "replace").rstrip("."),
        "extension": ext.decode("ascii", "replace"),
        "icao": icao.decode("ascii", "replace"),
        "date": vdate,
        "time_ms": vtime,
    }
    radials = []
    for record in _iter_ldm_records(buf[24:]):
        pos = 0
        n = len(record)
        while pos + 12 + _MSG_HEADER.size <= n:
            size_hw, _chan, mtype, _seq, _date, _ms, _nseg, _seg = _MSG_HEADER.unpack_from(
                record, pos + 12
            )
            if mtype == 31:
                start = pos + 12 + _MSG_HEADER.size
                end = pos + 12 + size_hw * 2
                if end > n:
                    break
                radial = _parse_msg31(record[start:end])
                if radial is not None:
                    radials.append(radial)
                pos = end
            elif mtype == 29:
                # message 29 (model data) is variable-length: honour the
                # size field (halfwords; 65535 flags an oversize message
                # whose byte length rides the segment fields, RDA/RPG ICD)
                if size_hw == 65535:
                    size_b = (_nseg << 16) | _seg
                else:
                    size_b = size_hw * 2
                pos += 12 + size_b
            else:
                # legacy messages (and inter-message zero padding) occupy
                # fixed 2432-byte frames
                pos += 2432
    return header, radials


def read_nexrad_archive(file_or_bytes):
    """Read an AR2V archive (path, file object or bytes) into gate arrays.

    Returns (times, alts, lats, lons, refs): times is (nrays,) datetime64,
    the rest are (nrays, max_ngates) with refs a masked array; a radial's
    gates past its own count hold the site's position and are masked."""
    if isinstance(file_or_bytes, (bytes, bytearray)):
        buf = bytes(file_or_bytes)
    elif hasattr(file_or_bytes, "read"):
        buf = file_or_bytes.read()
    else:
        with open(file_or_bytes, "rb") as f:
            buf = f.read()
    _, radials = decode_archive_bytes(buf)
    if not radials:
        raise IOError("archive contains no reflectivity radials")

    site = next((r["site"] for r in radials if r["site"] is not None), None)
    if site is None:
        raise IOError("archive contains no RVOL block (unknown site location)")
    site_lat, site_lon, site_alt = site

    nrays = len(radials)
    ngates = np.array([r["reflectivity"].size for r in radials])
    max_gates = int(ngates.max())
    inside = np.arange(max_gates)[None, :] < ngates[:, None]
    refs = ma.masked_all((nrays, max_gates), dtype=np.float32)
    for i, r in enumerate(radials):
        refs[i, :ngates[i]] = r["reflectivity"]
    first = np.array([r["first_gate"] for r in radials])[:, None]
    spacing = np.array([r["gate_spacing"] for r in radials])[:, None]
    rng = first + spacing * np.arange(max_gates)[None, :]
    glat, glon, galt = gate_lat_lon_alt(
        site_lat, site_lon, site_alt, np.array([r["azimuth"] for r in radials])[:, None],
        np.array([r["elevation"] for r in radials])[:, None], rng,
    )
    lats = np.where(inside, glat, np.float64(site_lat))
    lons = np.where(inside, glon, np.float64(site_lon))
    alts = np.where(inside, galt, np.float64(site_alt))
    times = np.array([np.datetime64(r["time"], "ms") for r in radials], dtype="datetime64[ms]")
    return times, alts, lats, lons, refs
