"""DCC detection science (counterpart of
``tobac_flow_tpu/detect/detection.py``): cores, anvil markers, anvil
watersheds and anvil relabelling, with the reference's defaults; the
op-by-op filters they are built from (curvature, peak, growth rate,
combined filter, watershed mask, edge field); and the legacy path of the
oldest GOES pipeline (growth markers from the smoothed time derivative,
the edge watershed).

Fields are tensors on the flow's device or waiting on the host (numpy
arrays and DataArrays move to the flow's device); the labels come back as
int32 tensors on the flow's device.  The time coordinate is a numpy
``datetime64`` array (``times``; where a function lets it default, the
``t`` coordinate of its DataArray field).  A filter without a flow runs
where its tensor lies, or on ``device`` (CUDA unless the caller passes
``device="cpu"``).  Dense work runs on the device: the op-by-op filters
are the steps of ``detect.fused`` that the chain runs, so each equals the
chain's intermediate; labelling and the watershed.  The per-label
filters' tables and the cooling-rate arithmetic run on the host.
``budget_bytes`` goes to every step: over it a step runs in time chunks
(``None`` means ``device.memory_budget`` at the step's start, and no
chunks on the CPU).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from tobac_flow_tpu_torch import device as _dev
from tobac_flow_tpu_torch.detect import fused
from tobac_flow_tpu_torch.detect.analysis import (
    filter_labels_by_length, filter_labels_by_length_and_multimask_legacy,
    filter_labels_by_mask, find_object_lengths, mask_labels,
)
from tobac_flow_tpu_torch.ops import morphology as morph
from tobac_flow_tpu_torch.ops.convolve import nanmean0
from tobac_flow_tpu_torch.utils.datetime_utils import get_time_diff_from_coord
from tobac_flow_tpu_torch.utils.labels import (
    labeled_comprehension, make_step_labels, remap_labels, slice_labels,
)
from tobac_flow_tpu_torch.utils.normalisation import linearise_field

__all__ = [
    "filtered_tdiff", "get_curvature_filter", "get_peak_filter", "get_growth_rate",
    "get_combined_filters", "detect_cores", "get_anvil_markers", "detect_anvils",
    "relabel_anvils", "get_watershed_mask", "get_combined_edge_field", "nan_gaussian_filter",
    "detect_growth_markers", "detect_growth_markers_multichannel", "edge_watershed",
]

nan_gaussian_filter = morph.nan_gaussian_filter

# the anvil watersheds' structure: connectivity 1 in space and time
_ANVIL_CONNECTIVITY = np.abs(np.indices((3, 3, 3)) - 1).sum(axis=0) <= 1
# the legacy path's in-plane cross, as a (1, 3, 3) structure
_CROSS_2D = np.zeros((1, 3, 3), bool)
_CROSS_2D[0, 1, :] = True
_CROSS_2D[0, :, 1] = True


def _core_cooling_rates(core_labels, bt, times, min_length, budget_bytes=None):
    """For each core 1..max, the largest drop of its per-step mean BT over
    ``min_length`` steps, in K per minute (0 for a core with no more than
    ``min_length`` steps).  Each step's mean is numpy's float32 ``nanmean``
    of the step's pixels in raster order, on the host, as the reference
    computes it."""
    step_labels = slice_labels(core_labels, budget_bytes)
    n_steps = int(step_labels.max())
    if n_steps == 0:
        return np.zeros(int(core_labels.max()), dtype=np.float64)
    # every pixel of a step label has one core label and one frame
    fg = step_labels > 0
    core_of_step = torch.zeros(n_steps + 1, dtype=torch.int64, device=core_labels.device)
    core_of_step[step_labels[fg].long()] = core_labels[fg].long()
    frame = torch.arange(core_labels.shape[0], device=core_labels.device).view(-1, 1, 1)
    frame_of_step = torch.zeros(n_steps + 1, dtype=torch.int64, device=core_labels.device)
    frame_of_step[step_labels[fg].long()] = frame.expand(core_labels.shape)[fg]
    core_of_step = core_of_step[1:].cpu().numpy()
    step_t = np.asarray(times)[frame_of_step[1:].cpu().numpy()]
    step_bt_mean = labeled_comprehension(bt, step_labels, np.nanmean, default=np.nan)

    def bt_diff_func(step_bt, pos):
        st = step_t[pos]
        order = np.argsort(st)
        sb = step_bt[order]
        st = st[order]
        if sb.size <= min_length:
            return 0
        dt_min = ((st[min_length:] - st[:-min_length]).astype("timedelta64[s]").astype(int)
                  / 60)
        diffs = (sb[:-min_length] - sb[min_length:]) / dt_min
        return np.nanmax(diffs) if diffs.size else 0

    return labeled_comprehension(step_bt_mean, core_of_step, bt_diff_func, default=0,
                                 dtype=np.float64, pass_positions=True)


def _field(flow, a, dtype=torch.float32):
    """A field as a tensor: where it lies when it is one, else on the
    flow's device."""
    if hasattr(a, "dims"):  # a DataArray
        a = a.data
    if isinstance(a, torch.Tensor):
        return a if a.dtype == dtype else a.to(dtype)
    return flow.tensor(np.asarray(a), dtype)


def _alone(a, device, dtype=torch.float32):
    """A field for a step without a flow: where it lies when it is a
    tensor and no ``device`` is named, else on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    if hasattr(a, "dims"):
        a = a.data
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    elif device is None:
        return a.to(dtype)
    return a.to(_dev.resolve_device(device), dtype)


def _times_of(times, *fields):
    """``times``, or the ``t`` coordinate of the first DataArray field."""
    if times is not None:
        return np.asarray(times)
    for f in fields:
        if hasattr(f, "coords") and "t" in f.coords:
            return np.asarray(f.coords["t"])
    raise ValueError("times must be given where no field is a DataArray with a t coordinate")


def _per_minute(flow, times):
    """The (T, 1, 1) float32 minutes between steps, on the flow's device."""
    dt = get_time_diff_from_coord(_times_of(times)).astype(np.float32)
    return torch.from_numpy(dt).to(flow.device).view(-1, 1, 1)


def filtered_tdiff(flow, raw_diff, budget_bytes=None):
    """The temporal moving mean (NaN-aware, t±1 along the flow, linear
    warps) of a time derivative in the moving frame."""
    return flow.convolve(_field(flow, raw_diff), structure=fused._t_struct(), func=nanmean0,
                         budget_bytes=budget_bytes)


def get_curvature_filter(field, sigma=2, threshold=0, direction="negative", device=None,
                         budget_bytes=None):
    """Where the smoothed field's x and y curvatures both fall below
    ``-threshold`` (``direction="negative"``) or rise above ``threshold``
    ("positive"), hole-filled and opened in plane: a bool tensor."""
    if direction not in ("negative", "positive"):
        raise ValueError("Direction must be either positive or negative")
    field = _alone(field, device)
    fill_iters = fused._fill_iters(field.shape)
    return _dev.run_chunked(
        "curvature_filter",
        lambda f: (fused._curvature_filter(f, direction, fill_iters, float(sigma),
                                           float(threshold)),),
        (field,), field.device, budget_bytes, _dev.CORE_MARKERS_BYTES_PER_PX, 0, 1)[0]


def get_peak_filter(field, sigma=2, min_distance=10, direction="negative", device=None,
                    budget_bytes=None):
    """Within 5 px of the peaks of the smoothed field (its maxima above 0
    for ``direction="negative"``, as the reference names it, the maxima of
    its negation for "positive"), each frame's over a 21×21 window away
    from a 10 px border: an int32 tensor.  As in the reference, the peaks
    keep 10 px whatever ``min_distance`` says."""
    del min_distance  # the reference passes 10 to the peak search
    if direction not in ("negative", "positive"):
        raise ValueError("Direction must be either positive or negative")
    field = _alone(field, device)
    return _dev.run_chunked(
        "peak_filter",
        lambda f: (fused._peak_filter(f, direction, float(sigma)).to(torch.int32),),
        (field,), field.device, budget_bytes, _dev.CORE_MARKERS_BYTES_PER_PX, 0, 4)[0]


def get_growth_rate(flow, field, times=None, method="linear", budget_bytes=None):
    """Growth (or cooling) rate: the semi-Lagrangian difference per minute
    of the field, averaged over the in-plane cross along the flow."""
    dt = _per_minute(flow, _times_of(times, field))  # before the field becomes a tensor
    return _dev.run_chunked(
        "growth_rate", lambda f, fw, bw, d: (fused._growth_rate(f, fw, bw, d, method),),
        (_field(flow, field), flow.forward_flow, flow.backward_flow, dt), flow.device,
        budget_bytes, _dev.CORE_MARKERS_BYTES_PER_PX, 1, 4)[0]


def get_combined_filters(flow, bt, wvd, swd, use_wvd=True, budget_bytes=None):
    """The combined cloud-top filter of BT, WVD and SWD: where BT's (and
    WVD's) curvature or peak filter holds within a frame along the flow,
    hole-filled and opened, times one less the SWD linearised over
    2.5-7.5 K (a float32 tensor)."""
    bt, wvd, swd = (_field(flow, a) for a in (bt, wvd, swd))
    fill_iters = fused._fill_iters(bt.shape)
    return _dev.run_chunked(
        "combined_filters",
        lambda *v: (fused._combined_filter(*v, use_wvd, fill_iters, divide=True),),
        (bt, wvd, swd, flow.forward_flow, flow.backward_flow), flow.device, budget_bytes,
        _dev.CORE_MARKERS_BYTES_PER_PX, 1, 4)[0]


def detect_cores(flow, bt, wvd, swd, times, wvd_threshold=0.25, bt_threshold=0.5,
                 overlap=0.5, absolute_overlap=4, subsegment_shrink=0.0, min_length=3,
                 use_wvd=True, budget_bytes=None):
    """Growing convective cores from the BT, WVD and SWD channels: growth
    markers inside the combined cloud-top filter, linked along the flow,
    kept when longer than ``min_length`` steps, reaching WVD > -5 and
    cooling by at least 0.5 K/min over ``min_length`` steps."""
    bt, wvd, swd = (_field(flow, a) for a in (bt, wvd, swd))
    dt = torch.from_numpy(get_time_diff_from_coord(times).astype(np.float32))
    markers = fused.core_markers(
        bt, wvd, swd, flow.forward_flow, flow.backward_flow,
        dt.to(flow.device).view(-1, 1, 1), wvd_threshold, bt_threshold, use_wvd,
        budget_bytes=budget_bytes,
    )
    core_labels = flow.label(markers, overlap=overlap, absolute_overlap=absolute_overlap,
                             subsegment_shrink=subsegment_shrink, budget_bytes=budget_bytes)
    del markers
    keep = (find_object_lengths(core_labels, budget_bytes=budget_bytes) > min_length) & (
        mask_labels(core_labels, wvd > -5, budget_bytes=budget_bytes))
    core_labels = remap_labels(core_labels, keep, budget_bytes=budget_bytes)
    return remap_labels(core_labels,
                        _core_cooling_rates(core_labels, bt, times, min_length,
                                            budget_bytes) >= 0.5,
                        budget_bytes=budget_bytes)


def get_anvil_markers(flow, field, threshold=-5, overlap=0.5, absolute_overlap=5,
                      subsegment_shrink=0, min_length=3, budget_bytes=None):
    """Anvil seed markers: the thresholded, opened field linked along the
    flow, kept when longer than ``min_length`` steps."""
    mask = fused.anvil_marker_mask(_field(flow, field), threshold, flow.device, budget_bytes)
    marker_labels = flow.label(mask, overlap=overlap, absolute_overlap=absolute_overlap,
                               subsegment_shrink=subsegment_shrink, budget_bytes=budget_bytes)
    del mask
    return remap_labels(
        marker_labels, find_object_lengths(marker_labels, budget_bytes=budget_bytes) > min_length,
        budget_bytes=budget_bytes)


def detect_anvils(flow, field, markers=None, upper_threshold=-5, lower_threshold=-15,
                  erode_distance=1, min_length=3, budget_bytes=None, stats=None):
    """Anvils: the watershed of the linearised field's uphill edges from the
    eroded markers, against a -1 barrier over the eroded field ≤ 0 mask;
    kept when longer than ``min_length`` steps and overlapping a marker.
    With ``markers=None`` the markers are where the linearised field
    reaches 1 (all of them label 1), the field linearised by a division as
    the reference's op-by-op path takes it.  ``stats`` receives the
    flood's round counts and, where it ran in time chunks, its plan."""
    field = _field(flow, field)
    if markers is None:
        # the linearised field goes on as a field already within [0, 1]:
        # linearising it again over (0, 1) leaves it as it is
        field = linearise_field(field, lower_threshold, upper_threshold, divide=True)
        markers = (field >= 1).to(torch.int32)
        lower_threshold, upper_threshold = 0, 1
    markers = _field(flow, markers, torch.int32)
    edges, eroded = fused.anvil_pre_watershed(
        field, markers, flow.forward_flow, flow.backward_flow, lower_threshold,
        upper_threshold, erode_distance, budget_bytes=budget_bytes,
    )
    raw = flow.watershed(edges, eroded, mask=None, connectivity=_ANVIL_CONNECTIVITY,
                         stats=stats, budget_bytes=budget_bytes)
    del edges, eroded
    anvil_labels = fused.anvil_post_watershed(raw, markers, budget_bytes=budget_bytes)
    del raw
    keep = (find_object_lengths(anvil_labels, budget_bytes=budget_bytes) > min_length) & (
        mask_labels(anvil_labels, markers != 0, budget_bytes=budget_bytes))
    return remap_labels(anvil_labels, keep, budget_bytes=budget_bytes)


def relabel_anvils(flow, anvil_labels, markers=None, overlap=0.5, absolute_overlap=5,
                   min_length=3, budget_bytes=None):
    """Split anvils into per-step labels and re-link them along the flow;
    keep those longer than ``min_length`` steps (and overlapping
    ``markers``, when given)."""
    steps = make_step_labels(_field(flow, anvil_labels, torch.int32), budget_bytes, flow.device)
    anvil_labels = flow.link_overlap(steps, overlap=overlap, absolute_overlap=absolute_overlap,
                                     budget_bytes=budget_bytes)
    del steps
    keep = find_object_lengths(anvil_labels, budget_bytes=budget_bytes) > min_length
    if markers is not None:
        keep = keep & mask_labels(anvil_labels, _field(flow, markers, torch.int32) != 0,
                                  budget_bytes=budget_bytes)
    return remap_labels(anvil_labels, keep, budget_bytes=budget_bytes)


def get_watershed_mask(field, erode_distance: int = 1, device=None):
    """Where the field is ≤ 0 or NaN, eroded ``erode_distance`` times by
    the 3×3×3 cube (the outside counting as set), NaN pixels set again: a
    bool tensor."""
    return fused._watershed_mask(_alone(field, device), erode_distance)


def get_combined_edge_field(flow, field, **kwargs):
    """The uphill Sobel edge field (cubic warps) +1 where positive, less
    the field, +inf at NaN."""
    del kwargs
    return fused._edge_field(_field(flow, field), flow.forward_flow, flow.backward_flow)


# -- the legacy detection path (the oldest GOES pipeline) -----------------


def _smoothed_tdiff(flow, field, times, budget_bytes):
    """The field's semi-Lagrangian difference per minute (linear warps),
    then its temporal moving mean along the flow."""
    raw = flow.diff(_field(flow, field)) / _per_minute(flow, times)
    return filtered_tdiff(flow, raw, budget_bytes)


def detect_growth_markers(flow, wvd, times=None, budget_bytes=None):
    """Legacy growth markers from WVD alone: its smoothed time derivative,
    opened by the in-plane cross and kept inside the curvature filter,
    above 0.25 K/min, linked along the flow; objects of at least 3 steps
    that reach 0.5 K/min and WVD ≥ -5.  Returns (the smoothed derivative,
    the marker labels)."""
    times = _times_of(times, wvd)
    wvd = _field(flow, wvd)
    smoothed = _smoothed_tdiff(flow, wvd, times, budget_bytes)
    filtered = morph.grey_opening(smoothed, footprint=_CROSS_2D) * get_curvature_filter(
        wvd, budget_bytes=budget_bytes)
    labels = flow.label(morph.binary_opening(filtered >= 0.25, structure=_CROSS_2D),
                        budget_bytes=budget_bytes)
    labels = filter_labels_by_length(labels, 3)
    labels = filter_labels_by_mask(labels, filtered >= 0.5)
    return smoothed, filter_labels_by_mask(labels, wvd >= -5)


def detect_growth_markers_multichannel(flow, wvd, bt, times=None, t_sigma=1, overlap=0.5,
                                       subsegment_shrink=0, min_length=4,
                                       lower_threshold=0.25, upper_threshold=0.5,
                                       budget_bytes=None):
    """Legacy growth markers from WVD and BT: where WVD's smoothed time
    derivative inside its curvature filter reaches ``lower_threshold``
    K/min, or BT's inside its positive curvature filter falls to
    ``-lower_threshold``; opened by the in-plane cross and linked along the
    flow; objects of at least ``min_length`` steps that reach
    ``upper_threshold`` in both and WVD > -5.  Returns (WVD's and BT's
    smoothed derivatives, the marker labels).  (``t_sigma`` is unused, as
    in the reference.)"""
    del t_sigma
    times = _times_of(times, wvd, bt)
    wvd, bt = _field(flow, wvd), _field(flow, bt)
    wvd_smoothed = _smoothed_tdiff(flow, wvd, times, budget_bytes)
    bt_smoothed = _smoothed_tdiff(flow, bt, times, budget_bytes)
    markers = ((wvd_smoothed * get_curvature_filter(wvd, budget_bytes=budget_bytes))
               >= lower_threshold) | (
        (bt_smoothed * get_curvature_filter(bt, direction="positive",
                                            budget_bytes=budget_bytes))
        <= -lower_threshold)
    markers = flow.label(morph.binary_opening(markers, structure=_CROSS_2D), overlap=overlap,
                         subsegment_shrink=subsegment_shrink, budget_bytes=budget_bytes)
    if bool((markers != 0).any()):
        markers = filter_labels_by_length_and_multimask_legacy(
            markers, [wvd_smoothed >= upper_threshold, bt_smoothed <= -upper_threshold,
                      wvd > -5], min_length)
    else:
        warnings.warn("No regions detected in labeled array", RuntimeWarning)
    return wvd_smoothed, bt_smoothed, markers


def edge_watershed(flow, field, markers, upper_threshold, lower_threshold, erode_distance=5,
                   verbose=False, stats=None, budget_bytes=None):
    """The legacy edge watershed: the field clipped to the thresholds and
    set to the upper one at the markers; its Sobel edges (nearest warps)
    flooded from the markers within ``mask``, the pixels at the lower
    threshold eroded ``erode_distance`` times in plane (the outside
    counting as set), as the reference passes it (``mask`` names the
    pixels that may flood); the labels kept where their in-plane opening
    holds.  ``stats`` receives the flood's round counts and the seconds
    and peaks of its steps (``edge_prep``, ``edge_flood``,
    ``edge_opening``; see ``device.stage``)."""
    del verbose
    dev = flow.device
    with _dev.stage("edge_prep", stats, dev):
        field = _field(flow, field).clamp(lower_threshold, upper_threshold)
        markers = _field(flow, markers, torch.int32)
        field = torch.where(markers != 0, float(upper_threshold), field)
        mask = morph.binary_erosion(field == lower_threshold, structure=np.ones((1, 3, 3)),
                                    iterations=erode_distance, border_value=1)
        edges = flow.sobel(field, method="nearest")
        del field
    with _dev.stage("edge_flood", stats, dev):
        out = flow.watershed(edges, markers, mask=mask, stats=stats, budget_bytes=budget_bytes)
        del edges, mask
    with _dev.stage("edge_opening", stats, dev):
        return out * morph.binary_opening(out != 0, structure=fused._s2d_structure()).to(
            out.dtype)
