"""Discovery and checked download of GOES ABI, GLM and NEXRAD files
(counterpart of ``tobac_flow_tpu/data/io.py``, with the same prefixes,
file-name dates and local-first search).

A file is looked for in the public GCS bucket's listing first and found
on the local disk under the blob's name, downloaded when asked.  Where the
listing fails (no ``google-cloud-storage``, no network, or ``TFT_OFFLINE``
set), the local archive is globbed for the product's files instead.  The
GCS client is imported and made only when a listing runs; h5py is
imported only to validate a download.
"""

from __future__ import annotations

import os
import shutil
import warnings
from datetime import datetime, timedelta
from pathlib import Path

__all__ = [
    "GOES_BUCKETS",
    "find_abi_blobs",
    "find_abi_files",
    "find_glm_blobs",
    "find_glm_files",
    "find_nexrad_blobs",
    "download_blob",
    "get_goes_date",
]

GOES_BUCKETS = {16: "gcp-public-data-goes-16", 17: "gcp-public-data-goes-17"}
NEXRAD_BUCKET = "gcp-public-data-nexrad-l2"

# blobs known to be corrupt upstream
CORRUPT_BLOBS: set[str] = set()

_CLIENT = None


def _client():
    if os.environ.get("TFT_OFFLINE"):
        # skip cloud discovery entirely (local archives only): an airgapped
        # host would otherwise wait for a DNS/connect timeout per listing
        raise RuntimeError("TFT_OFFLINE set: cloud discovery disabled")
    global _CLIENT
    if _CLIENT is None:
        from google.cloud import storage

        try:
            _CLIENT = storage.Client()
        except Exception:
            _CLIENT = storage.Client.create_anonymous_client()
    return _CLIENT


def _hours_in_range(start_date, end_date):
    t = start_date.replace(minute=0, second=0, microsecond=0)
    while t < end_date:
        yield t
        t += timedelta(hours=1)


def _abi_prefix(date, product="MCMIP", view="C", mode=3):
    return (
        f"ABI-L2-{product}{view}/{date.year}/{date.timetuple().tm_yday:03d}/"
        f"{date.hour:02d}/OR_ABI-L2-{product}{view}-M{mode}"
    )


def _l1b_prefix(date, view="C", mode=3, channel=13):
    return (
        f"ABI-L1b-Rad{view}/{date.year}/{date.timetuple().tm_yday:03d}/"
        f"{date.hour:02d}/OR_ABI-L1b-Rad{view}-M{mode}C{channel:02d}"
    )


def _blob_start_time(name):
    try:
        tok = name.split("_s")[-1][:13]
        return datetime.strptime(tok, "%Y%j%H%M%S")
    except ValueError:
        return None


def get_goes_date(filename):
    """Scan start time parsed from a GOES filename's _s token."""
    return _blob_start_time(str(filename))


def _list_in_range(bucket, prefixes, start_date, end_date):
    """The blobs under ``prefixes`` whose _s time lies in [start, end),
    sorted by name; [] with a warning where a listing fails."""
    blobs = []
    for prefix in prefixes:
        try:
            found = list(bucket.list_blobs(prefix=prefix))
        except Exception as exc:  # offline / auth problems degrade
            warnings.warn(f"blob listing failed: {exc}")
            return []
        for b in found:
            t = _blob_start_time(b.name)
            if t is not None and start_date <= t < end_date and b.name not in CORRUPT_BLOBS:
                blobs.append(b)
    return sorted(blobs, key=lambda b: b.name)


def find_abi_blobs(
    start_date,
    end_date=None,
    satellite=16,
    product="MCMIP",
    view="C",
    mode=3,
    channel=None,
):
    """ABI blobs in the public bucket for a date range.  ``mode`` may be
    an int or a list of ints."""
    if end_date is None:
        end_date = start_date + timedelta(hours=1)
    modes = mode if isinstance(mode, (list, tuple)) else [mode]
    bucket = _client().bucket(GOES_BUCKETS[satellite])
    prefixes = [
        _l1b_prefix(hour, view=view, mode=m, channel=channel or 13)
        if product.startswith("Rad") or channel is not None
        else _abi_prefix(hour, product=product, view=view, mode=m)
        for hour in _hours_in_range(start_date, end_date)
        for m in modes
    ]
    return _list_in_range(bucket, prefixes, start_date, end_date)


def _validate_netcdf(path):
    """Cheap validity check: the file opens with h5py."""
    try:
        import h5py

        with h5py.File(path, "r"):
            return True
    except Exception:
        return False


def download_blob(
    blob,
    save_dir,
    replicate_path=True,
    check_download=True,
    n_attempts=3,
    min_free_bytes=2 << 30,
):
    """Checked, resumable download of one blob: verifies its size against
    the blob, validates the netCDF, guards free disk space and retries."""
    save_dir = Path(save_dir)
    dest = save_dir / blob.name if replicate_path else save_dir / Path(blob.name).name
    dest.parent.mkdir(parents=True, exist_ok=True)

    if dest.exists():
        blob.reload()
        if dest.stat().st_size == blob.size and (
            not check_download or _validate_netcdf(dest)
        ):
            return dest
        dest.unlink()

    free = shutil.disk_usage(dest.parent).free
    if free < min_free_bytes:
        raise OSError(f"insufficient disk space ({free} bytes free)")

    for attempt in range(n_attempts):
        try:
            blob.download_to_filename(str(dest))
            blob.reload()
            if dest.stat().st_size != blob.size:
                raise IOError("size mismatch after download")
            if check_download and not _validate_netcdf(dest):
                raise IOError("invalid netCDF after download")
            return dest
        except Exception as exc:
            if dest.exists():
                dest.unlink()
            if attempt == n_attempts - 1:
                raise
            warnings.warn(f"download attempt {attempt + 1} failed: {exc}")
    return None


def _local_files(find_blobs, pattern, start_date, end_date, save_dir, replicate_path,
                 check_download, n_attempts, download_missing):
    """The local files of the blobs ``find_blobs()`` lists, downloading the
    missing ones when asked; where it lists none (or fails), the files under
    ``save_dir`` matching ``pattern`` whose _s time lies in [start, end)."""
    save_dir = Path(save_dir)
    files = []
    try:
        blobs = find_blobs()
    except Exception:
        blobs = []
    if blobs:
        for blob in blobs:
            local = (
                save_dir / blob.name if replicate_path else save_dir / Path(blob.name).name
            )
            if local.exists():
                files.append(local)
            elif download_missing:
                try:
                    files.append(
                        download_blob(
                            blob,
                            save_dir,
                            replicate_path=replicate_path,
                            check_download=check_download,
                            n_attempts=n_attempts,
                        )
                    )
                except Exception as exc:
                    warnings.warn(f"could not download {blob.name}: {exc}")
    else:
        # fully offline: glob the local archive
        if end_date is None:
            end_date = start_date + timedelta(hours=1)
        for p in sorted(save_dir.rglob(pattern)):
            t = _blob_start_time(p.name)
            if t is not None and start_date <= t < end_date:
                files.append(p)
    return sorted(set(map(Path, filter(None, files))))


def find_abi_files(
    start_date,
    end_date=None,
    satellite=16,
    product="MCMIP",
    view="C",
    mode=3,
    channel=None,
    save_dir=".",
    replicate_path=True,
    check_download=True,
    n_attempts=3,
    download_missing=False,
    **kwargs,
):
    """Local-first ABI file discovery with optional download of missing
    files."""
    return _local_files(
        lambda: find_abi_blobs(start_date, end_date, satellite=satellite, product=product,
                               view=view, mode=mode, channel=channel),
        # one trailing *: "M*" + "*.nc" would form "**", which pathlib
        # rejects unless it is a whole path component
        f"OR_ABI-L2-{product}{view}-M*.nc",
        start_date, end_date, save_dir, replicate_path, check_download, n_attempts,
        download_missing,
    )


def find_glm_blobs(start_date, end_date=None, satellite=16):
    """GLM LCFA blobs in the public bucket for a date range."""
    if end_date is None:
        end_date = start_date + timedelta(hours=1)
    bucket = _client().bucket(GOES_BUCKETS[satellite])
    prefixes = [
        f"GLM-L2-LCFA/{hour.year}/{hour.timetuple().tm_yday:03d}/"
        f"{hour.hour:02d}/OR_GLM-L2-LCFA"
        for hour in _hours_in_range(start_date, end_date)
    ]
    return _list_in_range(bucket, prefixes, start_date, end_date)


def find_glm_files(
    start_date,
    end_date=None,
    satellite=16,
    save_dir=".",
    replicate_path=True,
    check_download=True,
    n_attempts=3,
    download_missing=False,
    **kwargs,
):
    """Local-first GLM file discovery."""
    return _local_files(
        lambda: find_glm_blobs(start_date, end_date, satellite=satellite),
        "OR_GLM-L2-LCFA*.nc",
        start_date, end_date, save_dir, replicate_path, check_download, n_attempts,
        download_missing,
    )


def _nexrad_time(name, site):
    """The scan time of a NEXRAD level-II blob's file name
    (``<SITE>YYYYMMDD_HHMMSS...``), or None."""
    try:
        return datetime.strptime(Path(name).name[len(site):len(site) + 15], "%Y%m%d_%H%M%S")
    except ValueError:
        return None


def find_nexrad_blobs(start_date, end_date, site):
    """NEXRAD level-II blobs of ``site`` in the public bucket for a date
    range."""
    bucket = _client().bucket(NEXRAD_BUCKET)
    blobs = []
    day = start_date.replace(hour=0, minute=0, second=0, microsecond=0)
    while day < end_date:
        prefix = f"{day.year}/{day.month:02d}/{day.day:02d}/{site}/"
        try:
            found = list(bucket.list_blobs(prefix=prefix))
        except Exception as exc:
            warnings.warn(f"blob listing failed: {exc}")
            return []
        for b in found:
            t = _nexrad_time(b.name, site)
            if t is not None and start_date <= t < end_date:
                blobs.append(b)
        day += timedelta(days=1)
    return sorted(blobs, key=lambda b: b.name)
