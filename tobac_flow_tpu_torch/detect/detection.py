"""DCC detection science (counterpart of the parts of
``tobac_flow_tpu/detect/detection.py`` that ``run_detection`` calls):
cores, anvil markers, anvil watersheds and anvil relabelling, with the
reference's defaults.

Fields are tensors on the flow's device or waiting on the host (numpy
arrays move to the flow's device); the labels come back as int32 tensors
on the flow's device.  The time coordinate is a numpy ``datetime64``
array.  Dense work runs on the device (``detect.fused``, labelling, the
watershed); the per-label filters' tables and the cooling-rate arithmetic
run on the host.  ``budget_bytes`` goes to every step: over it a step runs
in time chunks (``None`` means ``device.memory_budget`` at the step's
start, and no chunks on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.detect import fused
from tobac_flow_tpu_torch.detect.analysis import find_object_lengths, mask_labels
from tobac_flow_tpu_torch.utils.datetime_utils import get_time_diff_from_coord
from tobac_flow_tpu_torch.utils.labels import (
    labeled_comprehension, make_step_labels, remap_labels, slice_labels,
)

__all__ = ["detect_cores", "get_anvil_markers", "detect_anvils", "relabel_anvils"]

# the anvil watersheds' structure: connectivity 1 in space and time
_ANVIL_CONNECTIVITY = np.abs(np.indices((3, 3, 3)) - 1).sum(axis=0) <= 1


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
    if isinstance(a, torch.Tensor):
        return a if a.dtype == dtype else a.to(dtype)
    return flow.tensor(a, dtype)


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


def detect_anvils(flow, field, markers, upper_threshold=-5, lower_threshold=-15,
                  erode_distance=1, min_length=3, budget_bytes=None, stats=None):
    """Anvils: the watershed of the linearised field's uphill edges from the
    eroded markers, against a -1 barrier over the eroded field ≤ 0 mask;
    kept when longer than ``min_length`` steps and overlapping a marker.
    (The reference's ``markers=None``, seeding from the field itself, is
    not ported: the chain always passes markers.)  ``stats`` receives the
    flood's round counts and, where it ran in time chunks, its plan."""
    field = _field(flow, field)
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
