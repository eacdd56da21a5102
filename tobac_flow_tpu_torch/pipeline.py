"""The fused detection path in PyTorch (counterpart of
``tobac_flow_tpu/pipeline.py``): flow → growth and edge fields → watershed.

The entry points ``device_flow`` and ``fused_flow_watershed`` take numpy
arrays or tensors, move them once to ``device`` (CUDA unless the caller
passes ``device="cpu"``) and return tensors there; the functions below them
run on their inputs' device.  Frame pairs, both flow directions and whole
volumes are batch dimensions; nothing is mapped frame by frame.  Where
the device memory left (``device.memory_budget``) cannot hold a stage's
batch whole, the pairs, or the frames of the fields, run in groups sized
to fit; each group computes its frames with the same arithmetic, so the
results do not depend on the grouping.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tobac_flow_tpu_torch.core.flow import smooth_flow_step
from tobac_flow_tpu_torch.device import group_size, resolve_device, stage
from tobac_flow_tpu_torch.models.farneback import FarnebackFlow, FarnebackParams
from tobac_flow_tpu_torch.models.variational import variational_refine
from tobac_flow_tpu_torch.ops.banded import warp_banded_exact, warp_banded_exact_multi
from tobac_flow_tpu_torch.ops.sobel import sobel_magnitude
from tobac_flow_tpu_torch.ops.warp import shift_plane
from tobac_flow_tpu_torch.ops.watershed import watershed

__all__ = ["device_flow", "fused_flow_watershed", "pair_flows"]


def _normalise_pair(prev, nxt):
    """Quantise frame pairs (N, H, W) to [0, 255] over each pair's joint
    range, NaN filled from the other frame (or 127), rounded half to even."""
    stack = torch.stack([prev, nxt], dim=1)
    nan = torch.isnan(stack)
    vmin = torch.where(nan, math.inf, stack).amin(dim=(1, 2, 3), keepdim=True)
    vmax = torch.where(nan, -math.inf, stack).amax(dim=(1, 2, 3), keepdim=True)
    all_nan = nan.all(dim=(1, 2, 3), keepdim=True)
    vmin = torch.where(all_nan, math.nan, vmin)
    vmax = torch.where(all_nan, math.nan, vmax)
    inv = torch.where(vmax > vmin, 1.0 / (vmax - vmin), torch.zeros_like(vmax))
    scaled = torch.clamp((stack - vmin) * inv, 0.0, 1.0) * 255.0
    finite = torch.isfinite(scaled)
    filled = torch.where(finite, scaled, 127.0)
    a = torch.where(finite[:, 0], filled[:, 0], torch.where(finite[:, 1], filled[:, 1], 127.0))
    b = torch.where(finite[:, 1], filled[:, 1], torch.where(finite[:, 0], filled[:, 0], 127.0))
    return torch.round(a), torch.round(b)


_FLOW_CLIP = 20.0  # px, as the reference (tobac-flow's flow.py clips to ±20)
_WS_ITERS = 128  # the fused path's Jacobi round cap

# Device bytes that a stage allocates at its peak beyond its inputs,
# rounded up: per frame pair and pixel for the flow (Farneback, both
# directions; the detection CLI's refinement and smoothing add nothing to
# the peak) and per frame and pixel for the fields, its outputs included.
# The most that tools/torch_flood_memory.py measured with the whole stage
# in one group at 6 and 12 x 1500 x 2500 and 24 x 1024 x 1536 on an H100
# 80GB HBM3 (700 W): 880.33 and 248.00.
FLOW_BYTES_PER_PAIR_PX = 881
FIELDS_BYTES_PER_PX = 249


def pair_flows(data, model, vr_steps=0, smoothing_passes=0, interp_method="linear",
               device=None, group=None):
    """Forward/backward flow of a (T, H, W) stack, unclipped, on ``device``
    (see :func:`resolve_device`): ``model`` (a pair-flow module) runs the
    pair solves of both directions as one batch of 2 x ``group`` pairs
    (see :func:`~tobac_flow_tpu_torch.device.group_size`; all 2(T-1)
    where they fit); each pair is then
    refined (``vr_steps``) and smoothed (``smoothing_passes`` with
    ``interp_method``), as the reference does per pair.  The boundary
    frames take the negated opposite flow."""
    data = torch.as_tensor(data).to(resolve_device(device))
    if data.shape[0] < 2:
        raise ValueError("Need at least two frames to compute flow")
    t = data.shape[0]
    model = model.to(data.device)
    px = data[0].numel()
    # the two (T, H, W, 2) float32 flows are allocated whole: before the
    # groups' working memory where there are groups (so that they pin none
    # of its blocks), after it where there is one
    step = group_size(t - 1, px, FLOW_BYTES_PER_PAIR_PX, data.device, group, 16 * t * px)

    def outputs():
        out = torch.empty(data.shape + (2,), dtype=torch.float32, device=data.device)
        return out, torch.empty_like(out)

    fwd, bwd = outputs() if step < t - 1 else (None, None)
    for a in range(0, t - 1, step):
        b = min(t - 1, a + step)
        p8, n8 = _normalise_pair(data[a:b], data[a + 1:b + 1])
        first, second = torch.cat([p8, n8]), torch.cat([n8, p8])
        flows = model(first, second)
        if vr_steps > 0:
            flows = variational_refine(first, second, flows, steps=vr_steps)
        del first, second, p8, n8
        fwd_pairs, bwd_pairs = flows[: b - a], flows[b - a:]
        for _ in range(smoothing_passes):
            fwd_pairs, bwd_pairs = smooth_flow_step(fwd_pairs, bwd_pairs,
                                                    method=interp_method)
        if fwd is None:
            fwd, bwd = outputs()
        fwd[a:b] = fwd_pairs
        bwd[a + 1:b + 1] = bwd_pairs
        del flows, fwd_pairs, bwd_pairs
    fwd[-1] = -bwd[-1]
    bwd[0] = -fwd[0]
    return fwd, bwd


def device_flow(data, params: FarnebackParams | None = None, vr_steps=0,
                smoothing_passes=0, interp_method="linear", device=None):
    """Forward/backward Farneback flow of a (T, H, W) stack: (T, H, W, 2)
    each, channel 0 = x, on ``device`` (see :func:`resolve_device`), with
    ``vr_steps`` of variational refinement and ``smoothing_passes`` of
    smoothing (see :func:`pair_flows`); both are clipped to ±20 px."""
    fwd, bwd = pair_flows(data, FarnebackFlow(params), vr_steps, smoothing_passes,
                          interp_method, device)
    return fwd.clamp(-_FLOW_CLIP, _FLOW_CLIP), bwd.clamp(-_FLOW_CLIP, _FLOW_CLIP)


def _neighbour_frames(data):
    nan_frame = torch.full_like(data[:1], math.nan)
    return torch.cat([nan_frame, data[:-1]]), torch.cat([data[1:], nan_frame])


def _flow_diff(data, fwd, bwd, radius):
    """Semi-Lagrangian central difference in the moving frame."""
    prev, nxt = _neighbour_frames(data)
    prev_tap = warp_banded_exact(prev, bwd, radius)
    next_tap = warp_banded_exact(nxt, fwd, radius)
    f_ok = torch.isfinite(next_tap)
    b_ok = torch.isfinite(prev_tap)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    total = torch.where(f_ok, next_tap - data, zero) + torch.where(b_ok, data - prev_tap, zero)
    return total / torch.clamp(f_ok.to(torch.float32) + b_ok.to(torch.float32), min=1.0)


def _flow_sobel_uphill(data, fwd, bwd, radius):
    """27-tap uphill Sobel magnitude: the previous and next planes are read
    at ``p + flow(p) + o`` through the exact linear warp, the current plane
    at ``p + o``, for the 9 in-plane offsets o."""
    offsets = [(ox, oy) for oy in (-1, 0, 1) for ox in (-1, 0, 1)]
    prev, nxt = _neighbour_frames(data)
    taps = torch.cat([
        warp_banded_exact_multi(prev, bwd, offsets, radius),
        shift_plane(data, offsets, math.nan),
        warp_banded_exact_multi(nxt, fwd, offsets, radius),
    ])
    return sobel_magnitude(taps, data, "uphill")


def _fields_block(bt, fwd, bwd, dt_minutes, radius):
    growth = -_flow_diff(bt, fwd, bwd, radius) / dt_minutes
    # the reference's ``/ 10.0``, as XLA compiles it: a multiply by the
    # float32 reciprocal (so the field and its thresholds match bit for bit)
    field = torch.clamp((260.0 - bt) * 0.1, 0.0, 1.0)
    edges = _flow_sobel_uphill(field, fwd, bwd, radius)
    edges = torch.where(edges > 0, edges + 1.0, edges) - field
    return growth, field, edges


def _detect_fields_stage(bt, fwd, bwd, dt_minutes, radius, group=None):
    """Growth, the core field and the anvil edges of a (T, H, W) stack, in
    groups of frames (see :func:`~tobac_flow_tpu_torch.device.group_size`),
    each computed with one
    neighbour frame per side."""
    t = bt.shape[0]
    px = bt[0].numel()
    # growth, the field and the edges are allocated whole; each group
    # computes a neighbour frame each side
    step = group_size(t, px, FIELDS_BYTES_PER_PX, bt.device, group, 12 * t * px, 2)
    if step >= t:
        return _fields_block(bt, fwd, bwd, dt_minutes, radius)
    out = tuple(torch.empty_like(bt) for _ in range(3))
    for a in range(0, t, step):
        b = min(t, a + step)
        lo, hi = max(a - 1, 0), min(b + 1, t)
        block = _fields_block(bt[lo:hi], fwd[lo:hi], bwd[lo:hi], dt_minutes, radius)
        for o, x in zip(out, block):
            o[a:b] = x[a - lo:b - lo]
        del block
    return out


def adaptive_band_radius(fwd, bwd):
    """Warp band radius covering the flow extrema (one scalar readback),
    between 2 and 20 px."""
    m = float(torch.maximum(fwd.abs().max(), bwd.abs().max()))
    if not np.isfinite(m):
        return int(_FLOW_CLIP)
    return int(min(_FLOW_CLIP, max(2, int(np.ceil(m)))))


def _fields_stage(bt, dt_minutes, params=None, stats=None):
    with stage("flow", stats, bt.device):
        fwd, bwd = device_flow(bt, params, device=bt.device)
    radius = adaptive_band_radius(fwd, bwd)
    with stage("fields", stats, bt.device):
        growth, field, edges = _detect_fields_stage(bt, fwd, bwd, dt_minutes, radius)
    return fwd, bwd, growth, field, edges


def fused_flow_watershed(bt, dt_minutes, params=None, markers=None, stats=None,
                         budget_bytes=None, device=None):
    """bt (T, H, W) float32 → (forward flow, growth, edges, labels), all on
    ``device``: CUDA when it is ``None`` (raising where CUDA is not
    available), the plain PyTorch versions when it is ``"cpu"``.

    ``markers`` (int32, 0 = unlabelled) seeds the watershed with competing
    basins; ``None`` seeds one label from the core threshold.  ``stats``,
    when a dict, receives each stage's seconds (the device is synchronised
    at each stage boundary) and Unix-clock span (see
    :func:`~tobac_flow_tpu_torch.device.stage`) and the watershed's round
    counts.  Each stage runs inside a profiler range, ``stage.flow``,
    ``stage.fields`` and ``stage.watershed``.  ``budget_bytes`` goes to
    :func:`~tobac_flow_tpu_torch.ops.watershed.watershed`: a flood over it
    runs in time chunks.
    """
    dev = resolve_device(device)
    bt = torch.as_tensor(bt).to(dev)
    fwd, bwd, growth, field, edges = _fields_stage(bt, dt_minutes, params, stats=stats)
    if markers is None:
        markers = (field >= 1.0).to(torch.int32)
    else:
        markers = torch.as_tensor(markers).to(dev, torch.int32)
    mask = field > 0.05
    with stage("watershed", stats, dev):
        labels = watershed(fwd, bwd, edges, markers, mask=mask, max_iters=_WS_ITERS,
                           stats=stats, budget_bytes=budget_bytes, device=dev)
    return fwd, growth, edges, labels
