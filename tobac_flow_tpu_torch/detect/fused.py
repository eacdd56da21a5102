"""The detection chain's dense stages over whole volumes on the device
(counterpart of ``tobac_flow_tpu/detect/fused.py``).

- ``core_markers``: the combined cloud-top filter and the growth markers
  of ``detect_cores`` (the reference's ``_core_markers_jit``).
- ``anvil_marker_mask``: the thresholded, opened anvil-marker field
  (``_marker_mask_jit``).
- ``anvil_pre_watershed`` / ``anvil_post_watershed``: the watershed's
  edge field and eroded markers, and the clean-up of its labels
  (``_anvil_pre_jit``, ``_anvil_post_jit``).

Each stage is the reference's program on the whole volume at once, built
from the same pieces: flow-warped convolutions, the structure-offset
morphology, the hole fill and the symmetric-border Gaussian.  The 21×21
peak maximum runs separably, rows then columns, as in the reference.

Where a stage's volume would exceed its device budget (``budget_bytes``;
``None`` means ``device.memory_budget``, and no chunks on the CPU), it
runs in time chunks sized from its measured bytes per pixel, each read
with its stencil's frame halos, as the reference's chunked drivers do:
one frame for the cores' t±1 convolutions, ``max(1, erode_distance)`` for
the anvil watershed's inputs, none for the in-plane stages.  The chunks'
frames are the whole volume's, bit for bit.  The inputs may wait on the
host; the outputs are on the flows' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tobac_flow_tpu_torch import device as _dev
from tobac_flow_tpu_torch.ops.convolve import (
    _convolve_impl, any0, diff_func, nanmean0, structure_taps,
)
from tobac_flow_tpu_torch.ops.morphology import (
    _binary_morph, _fill_holes_device, _gauss_kernel, _grey_morph, _sepconv_reflect,
    _structure_offsets,
)
from tobac_flow_tpu_torch.ops.sobel import sobel_magnitude
from tobac_flow_tpu_torch.utils.normalisation import linearise_field

__all__ = ["core_markers", "anvil_marker_mask", "anvil_pre_watershed",
           "anvil_post_watershed"]


def _t_struct():
    s = np.zeros((3, 3, 3), bool)
    s[:, 1, 1] = True
    return s


def _s2d_structure():
    """Spatial-only connectivity-1 structure (temporal planes cleared)."""
    s = np.abs(np.indices((3, 3, 3)) - 1).sum(axis=0) <= 1
    s[0] = 0
    s[2] = 0
    return s


_T_TAPS = structure_taps(_t_struct())
_S2D_OFFS = _structure_offsets(_s2d_structure(), 3)
_S2D_TAPS = structure_taps(_s2d_structure())
_FULL_TAPS = structure_taps(np.ones((3, 3, 3), bool))
_B3_OFFS = _structure_offsets(np.ones((3, 3, 3), bool), 3)
# the EDT < 5 disk, as (t, y, x) offsets
_yy, _xx = np.mgrid[-4:5, -4:5]
_DISK_OFFS = tuple((0, int(_yy[i, j]), int(_xx[i, j]))
                   for i, j in zip(*np.nonzero((_yy**2 + _xx**2) < 25)))
_ROW_MAX_OFFS = tuple((0, d, 0) for d in range(-10, 11))
_COL_MAX_OFFS = tuple((0, 0, d) for d in range(-10, 11))


def _spatial_gauss_kernels(sigma):
    return ((0, None), (1, _gauss_kernel(sigma)), (2, _gauss_kernel(sigma)))


def _opening(mask, offs):
    return _binary_morph(_binary_morph(mask, offs, 1, 0, "erode"), offs, 1, 0, "dilate")


def _fill_iters(shape):
    """The hole fill's iteration cap, the reference's ``T + H + W + 8`` of
    the whole volume: a chunk keeps the whole volume's cap, so that its
    frames are the whole volume's."""
    return int(sum(shape)) + 8


def _curvature_filter(field, direction, fill_iters=None, sigma=2.0, threshold=0.0):
    """Where the smoothed field's x and y curvatures share the requested
    sign, hole-filled (at most ``fill_iters`` flood steps, by default the
    field's own cap) and opened."""
    if fill_iters is None:
        fill_iters = _fill_iters(field.shape)
    sm = _sepconv_reflect(field, _spatial_gauss_kernels(sigma))
    x2 = torch.zeros_like(field)
    x2[:, :, 1:-1] = sm[:, :, 2:] - 2 * sm[:, :, 1:-1] + sm[:, :, :-2]
    y2 = torch.zeros_like(field)
    y2[:, 1:-1] = sm[:, 2:] - 2 * sm[:, 1:-1] + sm[:, :-2]
    if direction == "negative":
        cond = (x2 < -threshold) & (y2 < -threshold)
    else:
        cond = (x2 > threshold) & (y2 > threshold)
    filled = _fill_holes_device(cond, _S2D_OFFS, fill_iters)
    return _opening(filled, _S2D_OFFS)


def _peak_filter(field, direction, sigma=0.5, min_distance=10):
    """Within 5 px of the local extrema of the smoothed field (21×21
    window, away from a ``min_distance`` border)."""
    sm = _sepconv_reflect(field, _spatial_gauss_kernels(sigma))
    if direction == "positive":
        sm = -sm
    mx = _grey_morph(_grey_morph(sm, _ROW_MAX_OFFS, "max"), _COL_MAX_OFFS, "max")
    peaks = (sm >= mx) & (sm > 0.0)
    d = int(min_distance)
    border = torch.zeros_like(peaks)
    border[:, d:-d, d:-d] = peaks[:, d:-d, d:-d]
    return _binary_morph(border, _DISK_OFFS, 1, 0, "dilate")


def _channel_filter(field, direction, fwd, bwd, fill_iters=None):
    """Curvature or peak filter, tracked ±1 frame along the flow."""
    either = (_curvature_filter(field, direction, fill_iters) | _peak_filter(field, direction))
    return _convolve_impl(either.to(torch.int32), fwd, bwd, _T_TAPS, "nearest", 0, any0, 0)


def _growth_rate(field, fwd, bwd, dt, method="cubic"):
    """Semi-Lagrangian difference per minute, averaged over the in-plane
    cross (cubic warps unless ``method`` says otherwise)."""
    diff = _convolve_impl(field, fwd, bwd, _T_TAPS, method, math.nan, diff_func, math.nan)
    return _convolve_impl(diff / dt, fwd, bwd, _S2D_TAPS, method, math.nan, nanmean0,
                          math.nan)


def _combined_filter(bt, wvd, swd, fwd, bwd, use_wvd, fill_iters, divide=False):
    """The combined cloud-top filter: BT's (and WVD's) curvature or peak
    filter tracked ±1 frame, hole-filled and opened, times one less the
    SWD linearised over 2.5-7.5 K (``divide``: see ``linearise_field``)."""
    combined = _channel_filter(bt, "positive", fwd, bwd, fill_iters) != 0
    if use_wvd:
        combined = combined | (_channel_filter(wvd, "negative", fwd, bwd, fill_iters) != 0)
    combined = _opening(_fill_holes_device(combined, _S2D_OFFS, fill_iters), _S2D_OFFS)
    return combined.to(torch.float32) * (1.0 - linearise_field(swd, 2.5, 7.5, divide))


def _core_markers(bt, wvd, swd, fwd, bwd, dt, wvd_threshold, bt_threshold, use_wvd,
                  fill_iters):
    combined_filter = _combined_filter(bt, wvd, swd, fwd, bwd, use_wvd, fill_iters)
    markers = (_growth_rate(-bt, fwd, bwd, dt) * combined_filter) > bt_threshold
    if use_wvd:
        markers = markers | (
            (_growth_rate(wvd, fwd, bwd, dt) * combined_filter) > wvd_threshold)
    return (_opening(markers, _S2D_OFFS),)


def core_markers(bt, wvd, swd, fwd, bwd, dt, wvd_threshold, bt_threshold, use_wvd,
                 budget_bytes=None):
    """The growth-marker mask of ``detect_cores``; ``dt`` is (T, 1, 1)
    minutes.  In time chunks with one halo frame where the budget calls
    for it (see the module's notes)."""
    fill_iters = _fill_iters(bt.shape)
    return _dev.run_chunked(
        "core_markers",
        lambda *v: _core_markers(*v, wvd_threshold, bt_threshold, use_wvd, fill_iters),
        (bt, wvd, swd, fwd, bwd, dt), fwd.device, budget_bytes,
        _dev.CORE_MARKERS_BYTES_PER_PX, 1, 1)[0]


def anvil_marker_mask(field, threshold, device=None, budget_bytes=None):
    """The anvil-marker field thresholded and opened (in-plane: chunks need
    no halo), on ``device`` (the field's by default)."""
    device = field.device if device is None else device
    return _dev.run_chunked(
        "anvil_marker_mask", lambda f: (_opening(f >= threshold, _S2D_OFFS),), (field,),
        device, budget_bytes, _dev.MARKER_MASK_BYTES_PER_PX, 0, 1)[0]


def _watershed_mask(f, erode_distance):
    """Where the field is ≤ 0 or NaN, eroded ``erode_distance`` times by
    the 3×3×3 cube with the outside set, NaN pixels set again."""
    wh_nan = torch.isnan(f)
    return _binary_morph((f <= 0) | wh_nan, _B3_OFFS, int(erode_distance), 1, "erode") | wh_nan


def _edge_field(f, fwd, bwd):
    """The uphill Sobel magnitude of the field (cubic warps), +1 where
    positive, less the field, +inf at NaN."""
    edges = _convolve_impl(f, fwd, bwd, _FULL_TAPS, "cubic", math.nan,
                           lambda taps: sobel_magnitude(taps, taps[13], "uphill"), math.nan)
    edges = edges + (edges > 0).to(edges.dtype)
    edges = edges - f
    return torch.where(torch.isnan(f), math.inf, edges)


def _anvil_pre(field, markers, fwd, bwd, lower, upper, erode_distance):
    f = linearise_field(field, lower, upper)
    eroded = markers * _binary_morph(markers != 0, _S2D_OFFS, 1, 0, "erode").to(torch.int32)
    eroded = torch.where(_watershed_mask(f, erode_distance), -1, eroded)
    return _edge_field(f, fwd, bwd), eroded


def anvil_pre_watershed(field, markers, fwd, bwd, lower, upper, erode_distance,
                        budget_bytes=None):
    """The anvil watershed's inputs: the uphill-Sobel edge field of the
    linearised field (+1 where positive, less the field, +inf at NaN) and
    the markers eroded in-plane, with -1 over the eroded watershed mask
    (where the linearised field is ≤ 0 or NaN).  In time chunks with
    ``max(1, erode_distance)`` halo frames where the budget calls for it:
    the mask's 3×3×3 erosion reaches one frame a step."""
    return _dev.run_chunked(
        "anvil_pre_watershed",
        lambda *v: _anvil_pre(*v, lower, upper, erode_distance),
        (field, markers, fwd, bwd), fwd.device, budget_bytes, _dev.ANVIL_PRE_BYTES_PER_PX,
        max(1, int(erode_distance)), 8)


def _anvil_post(labels, markers):
    labels = labels.clamp(min=0)
    labels = labels * _opening(labels != 0, _S2D_OFFS).to(labels.dtype)
    return (torch.where(markers > 0, markers.to(labels.dtype), labels),)


def anvil_post_watershed(labels, markers, budget_bytes=None):
    """Negative labels cleared, labels kept where their in-plane opening
    holds, markers written back over them (in-plane: chunks need no
    halo)."""
    return _dev.run_chunked(
        "anvil_post_watershed", _anvil_post, (labels, markers), labels.device, budget_bytes,
        _dev.ANVIL_POST_BYTES_PER_PX, 0, 4)[0]
