"""The detection science on the tiles of a (t, x) mesh (counterpart of
``tobac_flow_tpu/parallel/science.py``).

Every rank runs these functions on its (T_l, H, W_l) tiles and they give
the single-device stages' results (``detect/fused.py``) under the same
flows: the combined curvature and peak filters, the flow-tracked growth
markers and the anvil watershed's inputs.  Most ops are local stencils,
made exact at the tile edges by an x halo exchanged before each stage and
by applying the domain's border rules at the global x coordinate.  Three
need more:

- the Gaussian's reflect border: at the domain's edges the tile's halo is
  overwritten with the mirror of its own interior (scipy's symmetric
  padding; the kernel's radius must not exceed the halo);
- the frame-border rules (the curvature's zeroed edge columns, the peak
  filter's 10-px ring) are applied at the global x coordinate;
- ``binary_fill_holes`` is an iterative flood across tiles (halo refresh,
  an ``all_reduce`` to detect the fixed point), exact because the
  reachability fixed point is unique.

The flow-displaced taps use ``ops.banded.warp_banded_exact_multi``, the
single-device warp.
"""

from __future__ import annotations

import math

import torch

from tobac_flow_tpu_torch.detect.fused import (
    _B3_OFFS, _COL_MAX_OFFS, _DISK_OFFS, _ROW_MAX_OFFS, _S2D_OFFS, _spatial_gauss_kernels,
)
from tobac_flow_tpu_torch.ops.banded import warp_banded_exact_multi
from tobac_flow_tpu_torch.ops.convolve import diff_func, nanmean0
from tobac_flow_tpu_torch.ops.morphology import _binary_morph, _grey_morph, _sepconv_reflect
from tobac_flow_tpu_torch.ops.sobel import sobel_magnitude
from tobac_flow_tpu_torch.parallel.halo import halo_exchange_t, halo_exchange_x
from tobac_flow_tpu_torch.utils.normalisation import linearise_field

__all__ = [
    "sharded_core_markers", "sharded_anvil_marker_mask", "sharded_anvil_prep",
    "sharded_anvil_post", "sharded_fill_holes",
]

_CROSS = ((0, -1), (-1, 0), (0, 0), (1, 0), (0, 1))  # (ox, oy), the in-plane cross's tap order
_SQUARE = tuple((ox, oy) for oy in (-1, 0, 1) for ox in (-1, 0, 1))


def _gx(mesh, ext_w, hx, wl):
    """Global x coordinate of every column of an hx-extended tile."""
    return mesh.x * wl - hx + torch.arange(ext_w, device=mesh.device)


def _mirror_global_edges(mesh, ext, hx):
    """The halo columns beyond the domain's edges overwritten with the
    symmetric reflection of the tile's interior (scipy's reflect)."""
    head, mid, tail = ext[..., :hx], ext[..., hx:ext.shape[-1] - hx], ext[..., -hx:]
    if mesh.x == 0:
        head = torch.flip(ext[..., hx:2 * hx], dims=(-1,))
    if mesh.x == mesh.n_x - 1:
        tail = torch.flip(ext[..., -2 * hx:-hx], dims=(-1,))
    return torch.cat([head, mid, tail], dim=-1)


def _crop(a, hx):
    return a[..., hx:a.shape[-1] - hx] if hx else a


def _shift2d(a, dy, dx, fill_y, fill_x):
    """``a[t, y + dy, x + dx]`` with separate constant fills at the y and
    x edges."""
    t, h, w = a.shape
    if dy:
        pad = torch.full((t, abs(dy), w), fill_y, dtype=a.dtype, device=a.device)
        a = torch.cat([a[:, dy:], pad], 1) if dy > 0 else torch.cat([pad, a[:, :dy]], 1)
    if dx:
        pad = torch.full((t, h, abs(dx)), fill_x, dtype=a.dtype, device=a.device)
        a = torch.cat([a[:, :, dx:], pad], 2) if dx > 0 else torch.cat([pad, a[:, :, :dx]], 2)
    return a


def sharded_fill_holes(mesh, mask, w_g, inner_iters=8, stats=None):
    """scipy's ``binary_fill_holes`` (in-plane) of an x-split mask tile:
    the complement flooded from the outside shell, ``inner_iters`` local
    steps per halo refresh, until no rank changes (at most
    ``(H + W) // inner_iters + 8`` refreshes, as the reference).  ``stats``
    gets ``fill_rounds`` added."""
    mask = mask != 0
    inv = ~mask
    t, h, wl = mask.shape
    k = int(inner_iters)
    max_outer = (h + w_g) // max(k, 1) + 8

    def shell(a):
        # the columns beyond the domain's edges are reachable complement
        if mesh.x == 0:
            a[..., :k] = True
        if mesh.x == mesh.n_x - 1:
            a[..., -k:] = True
        return a

    inv_e = shell(halo_exchange_x(mesh, inv, k, False))
    reach = torch.zeros_like(mask)
    changed, rounds = True, 0
    while changed and rounds < max_outer:
        r = shell(halo_exchange_x(mesh, reach, k, False))
        for _ in range(k):
            grown = r
            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                # the y edges are the domain's border: outside is reachable
                grown = grown | _shift2d(r, dy, dx, True, False)
            r = grown & inv_e
        new = _crop(r, k)
        changed = mesh.any(torch.any(new != reach))
        reach = new
        rounds += 1
    if stats is not None:
        stats["fill_rounds"] = stats.get("fill_rounds", 0) + rounds
    return mask | (inv & ~reach)


def _opening_sharded(mesh, mask):
    """``binary_opening`` with the in-plane cross, exact across tiles (a
    halo of 2 covers the erosion and dilation; beyond the domain is
    False)."""
    ext = halo_exchange_x(mesh, mask, 2, False)
    out = _binary_morph(_binary_morph(ext, _S2D_OFFS, 1, 0, "erode"), _S2D_OFFS, 1, 0, "dilate")
    return _crop(out, 2)


def _curvature_filter_sharded(mesh, field, hx, w_g, direction, stats=None):
    wl = field.shape[-1]
    ext = halo_exchange_x(mesh, field, hx, math.nan)
    sm = _sepconv_reflect(_mirror_global_edges(mesh, ext, hx), _spatial_gauss_kernels(2.0))
    x2 = torch.zeros_like(sm)
    x2[:, :, 1:-1] = sm[:, :, 2:] - 2 * sm[:, :, 1:-1] + sm[:, :, :-2]
    y2 = torch.zeros_like(sm)
    y2[:, 1:-1] = sm[:, 2:] - 2 * sm[:, 1:-1] + sm[:, :-2]
    gx = _gx(mesh, ext.shape[-1], hx, wl)
    x2 = torch.where((gx == 0) | (gx == w_g - 1), 0.0, x2)  # the zeroed frame-border columns
    if direction == "negative":
        cond = (x2 < 0.0) & (y2 < 0.0)
    else:
        cond = (x2 > 0.0) & (y2 > 0.0)
    return _opening_sharded(mesh, sharded_fill_holes(mesh, _crop(cond, hx), w_g, stats=stats))


def _peak_filter_sharded(mesh, field, hx, w_g, direction):
    wl = field.shape[-1]
    ext = halo_exchange_x(mesh, field, hx, math.nan)
    sm = _sepconv_reflect(_mirror_global_edges(mesh, ext, hx), _spatial_gauss_kernels(0.5))
    if direction == "positive":
        sm = -sm
    gx = _gx(mesh, ext.shape[-1], hx, wl)
    in_dom = (gx >= 0) & (gx < w_g)
    mx = torch.where(in_dom, sm, -math.inf)
    mx = _grey_morph(_grey_morph(mx, _ROW_MAX_OFFS, "max"), _COL_MAX_OFFS, "max")
    peaks = (sm >= mx) & (sm > 0.0) & in_dom
    d = 10
    border = torch.zeros_like(peaks)
    border[:, d:-d] = peaks[:, d:-d]
    peaks = border & (gx >= d) & (gx <= w_g - 1 - d)
    return _crop(_binary_morph(peaks, _DISK_OFFS, 1, 0, "dilate"), hx)


def _flows_ext(mesh, fwd, bwd, hx):
    return (halo_exchange_x(mesh, fwd, hx, 0.0, axis=-2),
            halo_exchange_x(mesh, bwd, hx, 0.0, axis=-2))


def _tracked_any_sharded(mesh, either, fwd, bwd, hx, radius):
    """The ±1-frame flow-tracked any() of a mask (the fused channel
    filter's nearest-tap convolve, fill 0)."""
    eh = halo_exchange_t(mesh, halo_exchange_x(mesh, either.to(torch.int32), hx, 0), 1, 0)
    fwd_e, bwd_e = _flows_ext(mesh, fwd, bwd, hx)
    prev_tap = _crop(warp_banded_exact_multi(eh[:-2], bwd_e, [(0, 0)], radius, "nearest", 0,
                                             radius_x=radius)[0], hx)
    next_tap = _crop(warp_banded_exact_multi(eh[2:], fwd_e, [(0, 0)], radius, "nearest", 0,
                                             radius_x=radius)[0], hx)
    return (prev_tap != 0) | (either != 0) | (next_tap != 0)


def _growth_rate_sharded(mesh, field, fwd, bwd, dt, hx, radius):
    """The fused growth rate on tiles: the cubic difference along the flow
    over ``dt``, then the in-plane cross's NaN mean."""
    ext = halo_exchange_x(mesh, field, hx, math.nan)
    fh = halo_exchange_t(mesh, ext, 1, math.nan)
    fwd_e, bwd_e = _flows_ext(mesh, fwd, bwd, hx)
    prev_tap = warp_banded_exact_multi(fh[:-2], bwd_e, [(0, 0)], radius, "cubic", math.nan,
                                       radius_x=radius)[0]
    next_tap = warp_banded_exact_multi(fh[2:], fwd_e, [(0, 0)], radius, "cubic", math.nan,
                                       radius_x=radius)[0]
    diff = diff_func((prev_tap, ext, next_tap))
    growth = torch.where(torch.isnan(ext), math.nan, diff) / dt
    taps = [_shift2d(growth, oy, ox, math.nan, math.nan) for ox, oy in _CROSS]
    sp = torch.where(torch.isnan(growth), math.nan, nanmean0(torch.stack(taps)))
    return _crop(sp, hx)


def sharded_core_markers(mesh, bt, wvd, swd, fwd, bwd, dt, hx, w_g, use_wvd=True,
                         wvd_threshold=0.25, bt_threshold=0.5, warp_radius=21, stats=None):
    """``detect_cores``' marker mask on (t, x) tiles (the fused
    ``core_markers``), exact across tiles; ``dt`` is (T_l, 1, 1) minutes.
    Returns the bool marker tile."""
    def channel(field, direction):
        either = (_curvature_filter_sharded(mesh, field, hx, w_g, direction, stats)
                  | _peak_filter_sharded(mesh, field, hx, w_g, direction))
        return _tracked_any_sharded(mesh, either, fwd, bwd, hx, warp_radius)

    combined = channel(bt, "positive")
    if use_wvd:
        combined = combined | channel(wvd, "negative")
    combined = _opening_sharded(mesh, sharded_fill_holes(mesh, combined, w_g, stats=stats))
    combined_filter = combined.to(torch.float32) * (1.0 - linearise_field(swd, 2.5, 7.5))
    growth = _growth_rate_sharded(mesh, -bt, fwd, bwd, dt, hx, warp_radius)
    merged = (growth * combined_filter) > bt_threshold
    if use_wvd:
        growth = _growth_rate_sharded(mesh, wvd, fwd, bwd, dt, hx, warp_radius)
        merged = merged | ((growth * combined_filter) > wvd_threshold)
    return _opening_sharded(mesh, merged)


def sharded_anvil_marker_mask(mesh, field, threshold):
    """``get_anvil_markers``' mask (threshold, then opening), exact across
    tiles."""
    return _opening_sharded(mesh, field >= threshold)


def sharded_anvil_prep(mesh, field, marker_labels, fwd, bwd, lower, upper, erode_distance, hx,
                       warp_radius=21):
    """The anvil watershed's inputs on tiles (the fused
    ``anvil_pre_watershed``): the cubic uphill-Sobel edge field of the
    linearised field and the in-plane eroded markers with -1 over the
    eroded mask.  ``marker_labels`` are int seeds.  Returns (edges,
    eroded markers)."""
    f = linearise_field(field, lower, upper)
    ero = _binary_morph(halo_exchange_x(mesh, marker_labels != 0, 1, False), _S2D_OFFS, 1, 0,
                        "erode")
    eroded = marker_labels * _crop(ero, 1).to(torch.int32)
    wh_nan = torch.isnan(f)
    e = int(erode_distance)
    m = halo_exchange_t(mesh, halo_exchange_x(mesh, (f <= 0) | wh_nan, e, True), e, True)
    m = _binary_morph(m, _B3_OFFS, e, 1, "erode")
    eroded = torch.where(_crop(m[e:m.shape[0] - e], e) | wh_nan, -1, eroded)

    # the 27-tap uphill Sobel (cubic), one band of taps per neighbouring frame
    ext = halo_exchange_x(mesh, f, hx, math.nan)
    fh = halo_exchange_t(mesh, ext, 1, math.nan)
    fwd_e, bwd_e = _flows_ext(mesh, fwd, bwd, hx)
    prev_taps = _crop(warp_banded_exact_multi(fh[:-2], bwd_e, _SQUARE, warp_radius, "cubic",
                                              math.nan, radius_x=warp_radius), hx)
    next_taps = _crop(warp_banded_exact_multi(fh[2:], fwd_e, _SQUARE, warp_radius, "cubic",
                                              math.nan, radius_x=warp_radius), hx)
    same_taps = [_crop(_shift2d(ext, oy, ox, math.nan, math.nan), hx) for ox, oy in _SQUARE]
    taps = list(prev_taps) + same_taps + list(next_taps)
    edges = sobel_magnitude(taps, f, "uphill")
    edges = torch.where(wh_nan, math.nan, edges)
    edges = edges + (edges > 0).to(edges.dtype) - f
    return torch.where(wh_nan, math.inf, edges), eroded


def sharded_anvil_post(mesh, labels, markers):
    """The anvil watershed's clean-up on tiles (the fused
    ``anvil_post_watershed``): the -1 barrier to background, pixels the
    in-plane opening removes cleared, markers written back."""
    labels = labels.clamp(min=0)
    labels = labels * _opening_sharded(mesh, labels != 0).to(labels.dtype)
    return torch.where(markers > 0, markers.to(labels.dtype), labels)
