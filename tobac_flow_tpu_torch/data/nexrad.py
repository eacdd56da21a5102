"""NEXRAD Level-II reflectivity regridded onto the ABI fixed grid
(counterpart of ``tobac_flow_tpu/data/nexrad.py``): the gates of the
Level-II archives in a tar file, their parallax mapping to the satellite's
fixed-grid scan angles, the 2D and altitude-resolved 3D reflectivity
histograms on the grid, the multi-site composite, and the 160-site
WSR-88D table with the in-domain site filter.

The decoding (``data/nexrad_level2.py``), the site table and the gates'
geometry are host float64 numpy with the reference's operations in its
order, so that each gate's scan angles have its bits (the card's
double-precision ``tan``, ``sin`` and ``cos`` are not numpy's, and one ulp
moves a gate across a bin edge).  The binning runs on ``device`` (CUDA
unless the caller passes ``device="cpu"``): each gate's bin by
``searchsorted`` with ``np.histogramdd``'s rule (``data.glm._bins``),
the counts in one ``bincount``, the reflectivity sums in float64 through
``utils.labels.bin_sums`` (a fixed pairwise tree, so that the card's sums
have the CPU's bits), the composite of several sites by ``fmax``.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.data.abi import get_abi_proj
from tobac_flow_tpu_torch.data.glm import _bins
from tobac_flow_tpu_torch.device import resolve_device
from tobac_flow_tpu_torch.utils.labels import bin_sums

__all__ = [
    "get_gates_from_tar",
    "map_nexrad_to_goes",
    "get_nexrad_hist",
    "get_3d_nexrad_hist",
    "regrid_nexrad",
    "get_nexrad_sitenames",
    "get_nexrad_site_latlons",
    "filter_nexrad_sites",
    "histogram_mean",
]

# Public NWS WSR-88D network site locations (site: lat, lon), all 160
# operational radars incl. OCONUS (reference ``nexrad.py:234-572``; data
# from the NOAA/ROC site list)
NEXRAD_SITES = {
    "KABR": (45.4558, -98.4132), "KABX": (35.1498, -106.8240),
    "KAKQ": (36.9840, -77.0073), "KAMA": (35.2335, -101.7092),
    "KAMX": (25.6111, -80.4127), "KAPX": (44.9071, -84.7198),
    "KARX": (43.8228, -91.1916), "KATX": (48.1946, -122.4958),
    "KBBX": (39.4957, -121.6317), "KBGM": (42.1997, -75.9847),
    "KBHX": (40.4987, -124.2919), "KBIS": (46.7709, -100.7606),
    "KBLX": (45.8538, -108.6068), "KBMX": (33.1723, -86.7698),
    "KBOX": (41.9559, -71.1370), "KBRO": (25.9160, -97.4190),
    "KBUF": (42.9488, -78.7369), "KBYX": (24.5975, -81.7032),
    "KCAE": (33.9488, -81.1184), "KCBW": (46.0392, -67.8066),
    "KCBX": (43.4902, -116.2360), "KCCX": (40.9229, -78.0039),
    "KCLE": (41.4132, -81.8597), "KCLX": (32.6555, -81.0423),
    "KCRP": (27.7840, -97.5112), "KCXX": (44.5110, -73.1664),
    "KCYS": (41.1519, -104.8060), "KDAX": (38.5012, -121.6778),
    "KDDC": (37.7608, -99.9688), "KDFX": (29.2731, -100.2802),
    "KDGX": (32.2797, -89.9846), "KDIX": (39.9471, -74.4108),
    "KDLH": (46.8369, -92.2097), "KDMX": (41.7312, -93.7229),
    "KDOX": (38.8258, -75.4401), "KDTX": (42.7000, -83.4718),
    "KDVN": (41.6116, -90.5810), "KDYX": (32.5386, -99.2543),
    "KEAX": (38.8102, -94.2645), "KEMX": (31.8937, -110.6304),
    "KENX": (42.5866, -74.0640), "KEOX": (31.4606, -85.4592),
    "KEPZ": (31.8731, -106.6979), "KESX": (35.7013, -114.8918),
    "KEVX": (30.5650, -85.9216), "KEWX": (29.7040, -98.0285),
    "KEYX": (35.0979, -117.5609), "KFCX": (37.0242, -80.2737),
    "KFDR": (34.3620, -98.9767), "KFDX": (34.6342, -103.6186),
    "KFFC": (33.3636, -84.5659), "KFSD": (43.5877, -96.7294),
    "KFSX": (34.5744, -111.1984), "KFTG": (39.7866, -104.5458),
    "KFWS": (32.5730, -97.3032), "KGGW": (48.2065, -106.6253),
    "KGJX": (39.0620, -108.2137), "KGLD": (39.3668, -101.7004),
    "KGRB": (44.4985, -88.1111), "KGRK": (30.7218, -97.3830),
    "KGRR": (42.8939, -85.5449), "KGSP": (34.8833, -82.2201),
    "KGWX": (33.8968, -88.3294), "KGYX": (43.8914, -70.2566),
    "KHDX": (33.0769, -106.1201), "KHGX": (29.4719, -95.0789),
    "KHNX": (36.3142, -119.6321), "KHPX": (36.7369, -87.2854),
    "KHTX": (34.9305, -86.0837), "KICT": (37.6546, -97.4431),
    "KICX": (37.5908, -112.8622), "KILN": (39.4203, -83.8217),
    "KILX": (40.1505, -89.3368), "KIND": (39.7075, -86.2804),
    "KINX": (36.1751, -95.5643), "KIWA": (33.2891, -111.6700),
    "KIWX": (41.3586, -85.7000), "KJAX": (30.4847, -81.7019),
    "KJGX": (32.6755, -83.3509), "KJKL": (37.5908, -83.3130),
    "KLBB": (33.6541, -101.8141), "KLCH": (30.1254, -93.2161),
    "KLGX": (47.1168, -124.1063), "KLIX": (30.3367, -89.8257),
    "KLNX": (41.9580, -100.5760), "KLOT": (41.6044, -88.0844),
    "KLRX": (40.7397, -116.8026), "KLSX": (38.6987, -90.6829),
    "KLTX": (33.9892, -78.4291), "KLVX": (37.9753, -85.9438),
    "KLWX": (38.9754, -77.4778), "KLZK": (34.8365, -92.2622),
    "KMAF": (31.9434, -102.1894), "KMAX": (42.0811, -122.7173),
    "KMBX": (48.3930, -100.8644), "KMHX": (34.7759, -76.8763),
    "KMKX": (42.9678, -88.5506), "KMLB": (28.1132, -80.6541),
    "KMOB": (30.6795, -88.2398), "KMPX": (44.8488, -93.5655),
    "KMQT": (46.5311, -87.5487), "KMRX": (36.1685, -83.4018),
    "KMSX": (47.0413, -113.9864), "KMTX": (41.2628, -112.4480),
    "KMUX": (37.1552, -121.8985), "KMVX": (47.5279, -97.3257),
    "KMXX": (32.5367, -85.7898), "KNKX": (32.9190, -117.0418),
    "KNQA": (35.3448, -89.8735), "KOAX": (41.3203, -96.3668),
    "KOHX": (36.2472, -86.5625), "KOKX": (40.8655, -72.8639),
    "KOTX": (47.6804, -117.6268), "KPAH": (37.0684, -88.7720),
    "KPBZ": (40.5317, -80.2180), "KPDT": (45.6906, -118.8529),
    "KPOE": (31.1557, -92.9763), "KPUX": (38.4595, -104.1816),
    "KRAX": (35.6655, -78.4898), "KRGX": (39.7542, -119.4621),
    "KRIW": (43.0661, -108.4774), "KRLX": (38.3111, -81.7229),
    "KRTX": (45.7150, -122.9651), "KSFX": (43.1056, -112.6860),
    "KSGF": (37.2352, -93.4006), "KSHV": (32.4508, -93.8413),
    "KSJT": (31.3713, -100.4925), "KSOX": (33.8176, -117.6360),
    "KSRX": (35.2904, -94.3619), "KTBW": (27.7055, -82.4018),
    "KTFX": (47.4595, -111.3855), "KTLH": (30.3976, -84.3289),
    "KTLX": (35.3334, -97.2778), "KTWX": (38.9970, -96.2326),
    "KTYX": (43.7556, -75.6800), "KUDX": (44.1248, -102.8298),
    "KUEX": (40.3210, -98.4419), "KVAX": (30.8904, -83.0019),
    "KVBX": (34.8383, -120.3978), "KVNX": (36.7406, -98.1279),
    "KVTX": (34.4116, -119.1796), "KVWX": (38.2604, -87.7247),
    "KYUX": (32.4953, -114.6567), "LPLA": (38.7303, -27.3217),
    "PABC": (60.7920, -161.8765), "PACG": (56.8521, -135.5524),
    "PAEC": (64.5115, -165.2949), "PAHG": (60.6156, -151.2832),
    "PAIH": (59.4619, -146.3011), "PAKC": (58.6795, -156.6293),
    "PAPD": (65.0351, -147.5014), "PGUA": (13.4560, 144.8111),
    "PHKI": (21.8939, -159.5525), "PHKM": (20.1255, -155.7781),
    "PHMO": (21.1328, -157.1803), "PHWA": (19.0950, -155.5689),
    "RKJK": (35.9242, 126.6222), "RKSG": (37.2077, 127.2856),
    "RODN": (26.3078, 127.9034), "TJUA": (18.1156, -66.0781),
}


def get_nexrad_sitenames():
    """Known WSR-88D site identifiers, sorted."""
    return sorted(NEXRAD_SITES.keys())


def get_nexrad_site_latlons(sites=None):
    """(lats, lons) arrays for the given sites (all by default)."""
    if sites is None:
        sites = get_nexrad_sitenames()
    lats = np.array([NEXRAD_SITES[s][0] for s in sites])
    lons = np.array([NEXRAD_SITES[s][1] for s in sites])
    return lats, lons


def get_gates_from_tar(nexrad_archive):
    """(lat, lon, alt, reflectivity) gate arrays (float64, masked gates
    NaN) of every Level-II archive in a tar file, decoded by
    ``data/nexrad_level2``; a member that fails to decode is skipped."""
    import tarfile

    from tobac_flow_tpu_torch.data.nexrad_level2 import read_nexrad_archive

    lats, lons, alts, refls = [], [], [], []
    with tarfile.open(nexrad_archive) as tar:
        for member in tar.getmembers():
            if not member.isfile():
                continue
            try:
                _, alt, lat, lon, refl = read_nexrad_archive(tar.extractfile(member).read())
            except (IOError, ValueError):
                continue
            lats.append(lat.ravel())
            lons.append(lon.ravel())
            alts.append(alt.ravel())
            refls.append(np.ma.filled(refl.astype(np.float64), np.nan).ravel())
    if not lats:
        raise IOError(f"no decodable Level-II archives in {nexrad_archive}")
    return (np.concatenate(lats), np.concatenate(lons), np.concatenate(alts),
            np.concatenate(refls))


def map_nexrad_to_goes(nexrad_lat, nexrad_lon, nexrad_alt, goes_ds):
    """Radar gates (at altitude) parallax-mapped to the fixed-grid scan
    angles (x, y) at which the satellite sees them: each gate moved
    ``alt · tan(zenith)`` metres along the surface away from the
    sub-satellite point (host float64)."""
    proj = get_abi_proj(goes_ds)
    lat = np.asarray(nexrad_lat, dtype=np.float64)
    lon = np.asarray(nexrad_lon, dtype=np.float64)
    alt = np.asarray(nexrad_alt, dtype=np.float64)
    zen = np.radians(proj.sat_zenith(lat, lon))
    shift = alt * np.tan(zen)  # metres along the surface away from nadir
    dlat = lat - 0.0
    dlon = lon - proj.lon0
    norm = np.sqrt(dlat**2 + (dlon * np.cos(np.radians(lat))) ** 2) + 1e-12
    m_per_deg = 111.32e3
    lat_c = lat + shift * (dlat / norm) / m_per_deg
    lon_c = lon + shift * (dlon / norm) / (m_per_deg * np.cos(np.radians(lat)))
    return proj.to_xy(lat_c, lon_c)


def _grid_edges(coord):
    c = np.asarray(coord, dtype=np.float64)
    mid = 0.5 * (c[1:] + c[:-1])
    return np.concatenate([[c[0] - (c[1] - c[0]) / 2], mid, [c[-1] + (c[-1] - c[-2]) / 2]])


def _on(a, device):
    """A float64 tensor of ``a`` (array or tensor) on ``device``."""
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float64))
    return a.to(device, torch.float64)


def histogram_mean(samples, edges, weights, device=None, ok=None):
    """``np.histogramdd`` of the points ``samples`` (one array or tensor
    per axis) over the increasing ``edges`` of each axis, on ``device``:
    the counts (int64) and, per bin, the float64 sum of ``weights`` and
    their mean (float32, NaN in an empty bin), each a tensor of the bins'
    shape.  ``ok`` (a bool per point) picks the points first."""
    dev = resolve_device(device)
    edges = [np.ascontiguousarray(e, dtype=np.float64) for e in edges]
    shape = tuple(e.size - 1 for e in edges)
    weights = _on(weights, dev)
    keep = torch.ones(weights.shape, dtype=torch.bool, device=dev) if ok is None else (
        torch.as_tensor(ok).to(dev))
    flat = torch.zeros(weights.shape, dtype=torch.int64, device=dev)
    for v, e, n in zip(samples, edges, shape):
        b = _bins(_on(v, dev), torch.from_numpy(e).to(dev))
        keep = keep & (b >= 0)
        flat = flat * n + b
    flat, weights = flat[keep], weights[keep]
    size = int(np.prod(shape))
    counts = torch.bincount(flat, minlength=size)
    sums = bin_sums(weights, flat, size)
    mean = torch.where(counts > 0, sums / counts.clamp(min=1), torch.nan).to(torch.float32)
    return counts.view(shape), sums.view(shape), mean.view(shape)


def _gate_ok(refl, min_refl, *arrays):
    """Finite gates at or above ``min_refl``."""
    ok = torch.isfinite(refl) & (refl >= min_refl)
    for a in arrays:
        ok &= torch.isfinite(a)
    return ok


def _grid_axes(goes_ds):
    x_edges = _grid_edges(goes_ds.coords["x"])
    y_edges = _grid_edges(goes_ds.coords["y"])
    # y scan angles decrease northwards in ABI files: the bins need
    # increasing edges, and their rows reversed back
    y_flip = bool(y_edges[0] > y_edges[-1])
    return x_edges, (y_edges[::-1] if y_flip else y_edges), y_flip


def get_nexrad_hist(gate_x, gate_y, gate_refl, goes_ds, min_refl=-33.0, device=None):
    """(count, mean reflectivity) of the gates at or above ``min_refl`` on
    the grid of ``goes_ds``: (H, W) int32 and float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    x, y, refl = (_on(a, dev) for a in (gate_x, gate_y, gate_refl))
    x_edges, y_edges, y_flip = _grid_axes(goes_ds)
    counts, _, mean = histogram_mean(
        (y, x), (y_edges, x_edges), refl, dev,
        _gate_ok(refl, min_refl, x, y))
    if y_flip:
        counts, mean = counts.flip(0), mean.flip(0)
    return counts.to(torch.int32), mean


def get_3d_nexrad_hist(gate_x, gate_y, gate_alt, gate_refl, goes_ds, alt_edges=None,
                       min_refl=-33.0, device=None):
    """The altitude-resolved histogram: (count, mean reflectivity) of the
    gates at or above ``min_refl`` in (altitude bin, y, x), by default 20
    levels of 1 km from the ground to 20 km: (A, H, W) int32 and float32
    tensors on ``device``."""
    dev = resolve_device(device)
    if alt_edges is None:
        alt_edges = np.arange(0, 20001, 1000.0)
    x, y, alt, refl = (_on(a, dev) for a in (gate_x, gate_y, gate_alt, gate_refl))
    x_edges, y_edges, y_flip = _grid_axes(goes_ds)
    counts, _, mean = histogram_mean(
        (alt, y, x), (alt_edges, y_edges, x_edges), refl, dev,
        _gate_ok(refl, min_refl, x, y))
    if y_flip:
        counts, mean = counts.flip(1), mean.flip(1)
    return counts.to(torch.int32), mean


def regrid_nexrad(site_gates, goes_ds, device=None, **kwargs):
    """One gridded reflectivity field of several sites' gates (a list of
    (lat, lon, alt, refl) tuples): their counts summed and the largest of
    their mean reflectivities where sites overlap (``fmax``: NaN where no
    site has a gate).  Each site's gates are mapped on the host and binned
    on ``device``."""
    dev = resolve_device(device)
    merged_counts = merged_mean = None
    for lat, lon, alt, refl in site_gates:
        gx, gy = map_nexrad_to_goes(lat, lon, alt, goes_ds)
        counts, mean = get_nexrad_hist(gx, gy, refl, goes_ds, device=dev, **kwargs)
        if merged_counts is None:
            merged_counts, merged_mean = counts, mean
        else:
            merged_counts = merged_counts + counts
            merged_mean = torch.fmax(merged_mean, mean)
    return merged_counts, merged_mean


def filter_nexrad_sites(goes_ds, extend=0.005):
    """The sites whose location falls inside the dataset's fixed-grid
    extent, widened by ``extend`` radians (host float64)."""
    proj = get_abi_proj(goes_ds)
    x = np.asarray(goes_ds.coords["x"], dtype=np.float64)
    y = np.asarray(goes_ds.coords["y"], dtype=np.float64)
    x0, x1 = min(x[0], x[-1]) - extend, max(x[0], x[-1]) + extend
    y0, y1 = min(y[0], y[-1]) - extend, max(y[0], y[-1]) + extend
    sites = get_nexrad_sitenames()
    lats, lons = get_nexrad_site_latlons(sites)
    sx, sy = proj.to_xy(lats, lons)
    keep = (sx >= x0) & (sx <= x1) & (sy >= y0) & (sy <= y1)
    keep &= np.isfinite(sx) & np.isfinite(sy)
    return [s for s, k in zip(sites, keep) if k]
