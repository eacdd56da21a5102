"""The device half of the detection CLIs (counterpart of
``tobac_flow_tpu/cli/common.run_detection`` up to the label volumes it
stores): the flow, cores, anvil markers, thick anvils, their relabelling
and thin anvils, in that order and with ``DetectionOptions``' defaults.

Each stage runs inside a profiler range (``stage.flow``,
``stage.detect_cores``, ``stage.anvil_markers``, ``stage.thick_anvils``,
``stage.relabel_anvils``, ``stage.thin_anvils``).

Depth: each stage's steps run in time chunks where their volumes would
exceed the device budget (``budget_bytes``, given to every stage; see
``device.chunk_plan``).  The flows stay on the card.  The fields go to
the card where it holds them; before each stage, the volumes that it does
not read (fields, the channel combinations, earlier stages' labels) wait
on the host (pinned) as far as the card needs the room to run the stage
whole (``device.park``); a stage reads a volume waiting on the host a
chunk at a time.
"""

from __future__ import annotations

import math

import torch

from tobac_flow_tpu_torch import device as _dev
from tobac_flow_tpu_torch.core.flow import Flow, create_flow
from tobac_flow_tpu_torch.detect.detection import (
    detect_anvils, detect_cores, get_anvil_markers, relabel_anvils,
)
from tobac_flow_tpu_torch.device import resolve_device, stage as timed_stage
from tobac_flow_tpu_torch.ops.watershed import FLOOD_BYTES_PER_PX

__all__ = ["DetectionOptions", "run_detection", "STAGES"]

STAGES = ("flow", "detect_cores", "anvil_markers", "thick_anvils", "relabel_anvils",
          "thin_anvils")

# the volumes each stage reads, and the most bytes per pixel of its steps:
# what the card must hold to run it whole
_READS = {
    "detect_cores": ({"bt", "wvd", "swd"}, _dev.CORE_MARKERS_BYTES_PER_PX),
    "anvil_markers": ({"wvd_minus_swd"}, max(_dev.MARKER_MASK_BYTES_PER_PX,
                                             _dev.LABEL_BYTES_PER_PX, _dev.LINK_BYTES_PER_PX)),
    "thick_anvils": ({"wvd_minus_swd", "anvil_marker_label"},
                     max(_dev.ANVIL_PRE_BYTES_PER_PX, FLOOD_BYTES_PER_PX[True])),
    "relabel_anvils": ({"thick_anvil_label", "anvil_marker_label"},
                       max(_dev.LABEL_BYTES_PER_PX, _dev.LINK_BYTES_PER_PX)),
    "thin_anvils": ({"wvd", "swd", "thick_anvil_label"},
                    max(_dev.ANVIL_PRE_BYTES_PER_PX, FLOOD_BYTES_PER_PX[True])),
}


def _combined(a, b, sign, dev, budget_bytes):
    """``a + sign * b`` of two (T, H, W) fields on ``dev``, a chunk of
    frames at a time where either waits on the host."""
    if a.device.type == dev.type and b.device.type == dev.type:
        return a + b if sign > 0 else a - b
    out = torch.empty(a.shape, dtype=a.dtype, device=dev)
    # two float32 inputs and the sum a pixel, the sum kept whole
    chunk = _dev.chunk_plan("combine_fields", a.shape, 12, dev, budget_bytes, 0, 4)
    for s, e, _, _ in _dev.time_chunks(a.shape[0], chunk):
        x, y = a[s:e].to(dev), b[s:e].to(dev)
        out[s:e] = x + y if sign > 0 else x - y
    return out


class DetectionOptions:
    """Pipeline thresholds, flow settings and output choices (the
    reference CLI's defaults, ``cli/common.DetectionOptions``).  The chain
    reads the thresholds and flow settings; ``cli.common.run_detection``
    also reads ``save_*``, ``checkpoint_path`` and ``flow_factory`` (a
    function of the BT field that returns the ``Flow`` to use)."""

    def __init__(self, wvd_threshold=0.25, bt_threshold=0.5, overlap=0.5,
                 absolute_overlap=4, subsegment_shrink=0.0, t_offset=3, use_wvd=False,
                 thick_upper=-5.0, thick_lower=-12.5, thin_upper=0.0, thin_lower=-7.5,
                 erode_distance=2, relabel=True, flow_model="Farneback", vr_steps=1,
                 smoothing_passes=1, interp_method="cubic", save_label_props=True,
                 save_spatial_props=False, save_field_props=True, save_bt=False,
                 save_wvd=False, save_swd=False, save_anvil_markers=False,
                 checkpoint_path=None, flow_factory=None):
        self.__dict__.update(locals())
        del self.__dict__["self"]


def run_detection(bt, wvd, swd, times, opts: DetectionOptions | None = None,
                  flow: Flow | None = None, device=None, stats: dict | None = None,
                  budget_bytes=None):
    """Core, anvil-marker, thick- and thin-anvil labels of (T, H, W) BT, WVD
    and SWD fields (arrays or tensors) with the ``datetime64`` time
    coordinate ``times``.

    ``flow`` replaces the chain's own flow (the JAX package's flows, for
    one, through ``Flow.from_numpy``); otherwise ``create_flow`` runs on
    ``device`` (see :func:`resolve_device`).  ``stats``, a dict, receives
    each stage's seconds (the device is synchronised at each stage's end),
    its start and end on the Unix clock in ns (``time.time_ns``, the
    profiler's clock), the objects each stage found, its time chunks
    (``{stage}_chunks``, ``{stage}_chunk_frames``; see
    :func:`~tobac_flow_tpu_torch.device.stage`), the anvil floods' chunks
    (``{stage}_flood_chunks``) and the volumes that waited on the host
    during it (``{stage}_parked``).

    ``budget_bytes`` goes to every stage: device bytes a step may take
    beyond its inputs, over which it runs in time chunks.  ``None`` means
    ``device.memory_budget`` at each step's start (the card's free memory
    less 15 %; on the CPU, no chunks).  A stage that cannot fit even a
    4-frame chunk raises MemoryError.

    Returns a dict of int32 label tensors on the flow's device (or waiting
    on the host where the card lacked the room): ``core_label``,
    ``anvil_marker_label``, ``thick_anvil_label`` and ``thin_anvil_label``;
    the ``flow``; and the float32 ``fields`` (bt, wvd, swd) where they
    ended.
    """
    opts = DetectionOptions() if opts is None else opts
    dev = flow.device if flow is not None else resolve_device(device)
    vols = {}
    for name, a in (("bt", bt), ("wvd", wvd), ("swd", swd)):
        vols[name] = _dev.place(torch.as_tensor(a).to(dtype=torch.float32), dev)
    frame_px = math.prod(vols["bt"].shape)

    def stage(name, fn):
        parked = []
        if name in _READS:
            reads, per_px = _READS[name]
            if opts.subsegment_shrink and name in ("detect_cores", "anvil_markers"):
                per_px = max(per_px, _dev.SUBSEGMENT_BYTES_PER_PX)
            parked = _dev.park(vols, reads, dev, per_px * frame_px)
        with timed_stage(name, stats, dev):
            result = fn()
        if stats is not None and name != "flow":
            stats[f"{name}_n"] = int(result.max()) if result.numel() else 0
            stats[f"{name}_parked"] = parked
        return result

    def anvils(name, field, markers, upper, lower):
        flood = {}
        result = detect_anvils(
            flow, field, markers=markers, upper_threshold=upper, lower_threshold=lower,
            erode_distance=opts.erode_distance, min_length=opts.t_offset,
            budget_bytes=budget_bytes, stats=flood)
        if stats is not None:
            stats[f"{name}_flood_chunks"] = flood.get("chunks", 1)
        return result

    if flow is None:
        flow = stage("flow", lambda: create_flow(
            vols["bt"], model=opts.flow_model, vr_steps=opts.vr_steps,
            smoothing_passes=opts.smoothing_passes, interp_method=opts.interp_method,
            device=dev,
        ))
    vols["core_label"] = stage("detect_cores", lambda: detect_cores(
        flow, vols["bt"], vols["wvd"], vols["swd"], times, wvd_threshold=opts.wvd_threshold,
        bt_threshold=opts.bt_threshold, overlap=opts.overlap,
        absolute_overlap=opts.absolute_overlap, subsegment_shrink=opts.subsegment_shrink,
        min_length=opts.t_offset, use_wvd=opts.use_wvd, budget_bytes=budget_bytes,
    ))
    vols["wvd_minus_swd"] = _combined(vols["wvd"], vols["swd"], -1, dev, budget_bytes)
    vols["anvil_marker_label"] = stage("anvil_markers", lambda: get_anvil_markers(
        flow, vols["wvd_minus_swd"], threshold=opts.thick_upper, overlap=opts.overlap,
        absolute_overlap=opts.absolute_overlap, subsegment_shrink=opts.subsegment_shrink,
        min_length=opts.t_offset, budget_bytes=budget_bytes,
    ))
    vols["thick_anvil_label"] = stage("thick_anvils", lambda: anvils(
        "thick_anvils", vols["wvd_minus_swd"], vols["anvil_marker_label"], opts.thick_upper,
        opts.thick_lower))
    if opts.relabel:
        vols["thick_anvil_label"] = stage("relabel_anvils", lambda: relabel_anvils(
            flow, vols["thick_anvil_label"], markers=vols["anvil_marker_label"],
            overlap=opts.overlap, absolute_overlap=opts.absolute_overlap,
            min_length=opts.t_offset, budget_bytes=budget_bytes,
        ))
    del vols["wvd_minus_swd"]
    vols["thin_anvil_label"] = stage("thin_anvils", lambda: anvils(
        "thin_anvils", _combined(vols["wvd"], vols["swd"], 1, dev, budget_bytes),
        vols["thick_anvil_label"], opts.thin_upper, opts.thin_lower))
    out = {k: vols[k] for k in ("core_label", "anvil_marker_label", "thick_anvil_label",
                                "thin_anvil_label")}
    out["flow"] = flow
    out["fields"] = (vols["bt"], vols["wvd"], vols["swd"])
    return out
