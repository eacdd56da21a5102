"""The device half of the detection CLIs (counterpart of
``tobac_flow_tpu/cli/common.run_detection`` up to the label volumes it
stores): the flow, cores, anvil markers, thick anvils, their relabelling
and thin anvils, in that order and with ``DetectionOptions``' defaults.

Each stage runs inside a profiler range (``stage.flow``,
``stage.detect_cores``, ``stage.anvil_markers``, ``stage.thick_anvils``,
``stage.relabel_anvils``, ``stage.thin_anvils``).
"""

from __future__ import annotations

import torch

from tobac_flow_tpu_torch.core.flow import Flow, create_flow
from tobac_flow_tpu_torch.detect.detection import (
    detect_anvils, detect_cores, get_anvil_markers, relabel_anvils,
)
from tobac_flow_tpu_torch.device import resolve_device, stage as timed_stage

__all__ = ["DetectionOptions", "run_detection", "STAGES"]

STAGES = ("flow", "detect_cores", "anvil_markers", "thick_anvils", "relabel_anvils",
          "thin_anvils")


class DetectionOptions:
    """The chain's thresholds and flow settings (the reference CLI's
    defaults)."""

    def __init__(self, wvd_threshold=0.25, bt_threshold=0.5, overlap=0.5,
                 absolute_overlap=4, subsegment_shrink=0.0, t_offset=3, use_wvd=False,
                 thick_upper=-5.0, thick_lower=-12.5, thin_upper=0.0, thin_lower=-7.5,
                 erode_distance=2, relabel=True, flow_model="Farneback", vr_steps=1,
                 smoothing_passes=1, interp_method="cubic"):
        self.__dict__.update(locals())
        del self.__dict__["self"]


def run_detection(bt, wvd, swd, times, opts: DetectionOptions | None = None,
                  flow: Flow | None = None, device=None, stats: dict | None = None):
    """Core, anvil-marker, thick- and thin-anvil labels of (T, H, W) BT, WVD
    and SWD fields (arrays or tensors) with the ``datetime64`` time
    coordinate ``times``.

    ``flow`` replaces the chain's own flow (the JAX package's flows, for
    one, through ``Flow.from_numpy``); otherwise ``create_flow`` runs on
    ``device`` (see :func:`resolve_device`).  ``stats``, a dict, receives
    each stage's seconds (the device is synchronised at each stage's end),
    its start and end on the Unix clock in ns (``time.time_ns``, the
    profiler's clock) and the objects each stage found.

    Returns a dict of int32 label tensors on the flow's device:
    ``core_label``, ``anvil_marker_label``, ``thick_anvil_label`` and
    ``thin_anvil_label``, and the ``flow``.
    """
    opts = DetectionOptions() if opts is None else opts
    dev = flow.device if flow is not None else resolve_device(device)
    bt, wvd, swd = (torch.as_tensor(a).to(dev, torch.float32) for a in (bt, wvd, swd))
    out = {}

    def stage(name, fn):
        with timed_stage(name, stats, dev):
            result = fn()
        if stats is not None and name != "flow":
            stats[f"{name}_n"] = int(result.max()) if result.numel() else 0
        return result

    if flow is None:
        flow = stage("flow", lambda: create_flow(
            bt, model=opts.flow_model, vr_steps=opts.vr_steps,
            smoothing_passes=opts.smoothing_passes, interp_method=opts.interp_method,
            device=dev,
        ))
    out["core_label"] = stage("detect_cores", lambda: detect_cores(
        flow, bt, wvd, swd, times, wvd_threshold=opts.wvd_threshold,
        bt_threshold=opts.bt_threshold, overlap=opts.overlap,
        absolute_overlap=opts.absolute_overlap, subsegment_shrink=opts.subsegment_shrink,
        min_length=opts.t_offset, use_wvd=opts.use_wvd,
    ))
    wvd_minus_swd = wvd - swd
    markers = stage("anvil_markers", lambda: get_anvil_markers(
        flow, wvd_minus_swd, threshold=opts.thick_upper, overlap=opts.overlap,
        absolute_overlap=opts.absolute_overlap, subsegment_shrink=opts.subsegment_shrink,
        min_length=opts.t_offset,
    ))
    out["anvil_marker_label"] = markers
    thick = stage("thick_anvils", lambda: detect_anvils(
        flow, wvd_minus_swd, markers=markers, upper_threshold=opts.thick_upper,
        lower_threshold=opts.thick_lower, erode_distance=opts.erode_distance,
        min_length=opts.t_offset,
    ))
    if opts.relabel:
        thick = stage("relabel_anvils", lambda: relabel_anvils(
            flow, thick, markers=markers, overlap=opts.overlap,
            absolute_overlap=opts.absolute_overlap, min_length=opts.t_offset,
        ))
    out["thick_anvil_label"] = thick
    del wvd_minus_swd
    out["thin_anvil_label"] = stage("thin_anvils", lambda: detect_anvils(
        flow, wvd + swd, markers=thick, upper_threshold=opts.thin_upper,
        lower_threshold=opts.thin_lower, erode_distance=opts.erode_distance,
        min_length=opts.t_offset,
    ))
    out["flow"] = flow
    return out
