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
from tobac_flow_tpu_torch.ops.warp import fma, shift_plane
from tobac_flow_tpu_torch.ops.watershed import watershed

__all__ = ["device_flow", "flow_pairs", "fused_flow_watershed", "pair_flows"]


def _log32(x):
    """Natural log of positive float32 values as the reference's compiled
    CPU program computes it (XLA's ``log_f32``: the mantissa in
    [sqrt(1/2), sqrt(2)) less 1, Cephes' degree-8 polynomial, the exponent
    in two parts; 11 products fused into their adds).  Zero gives -inf,
    +inf itself, a negative value or NaN gives NaN."""
    tiny = torch.finfo(torch.float32).tiny
    v = torch.where(x > tiny, x, tiny)
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    mant = ((bits & -2139095041) | 1056964608).view(torch.float32)
    low = mant < 0.70710677
    m = (mant - 1.0) + torch.where(low, mant, 0.0)
    e = e - torch.where(low, 1.0, 0.0)
    m2 = m * m
    m3 = m2 * m
    y = fma(fma(m, 7.0376836292e-2, -1.1514610310e-1), m, 1.1676998740e-1)
    y1 = fma(fma(m, -1.2420140846e-1, 1.4249322787e-1), m, -1.6668057665e-1)
    y2 = fma(fma(m, 2.0000714765e-1, -2.4999993993e-1), m, 3.3333331174e-1)
    y = fma(fma(y, m3, y1), m3, y2)
    y = fma(y, m3, -2.12194440e-4 * e)
    out = fma(0.693359375, e, fma(-0.5, m2, m) + y)
    out = torch.where(x == 0, -math.inf, out)
    out = torch.where(x == math.inf, math.inf, out)
    return torch.where((x < 0) | torch.isnan(x), math.nan, out)


def _pair_reduce(stack, fill, op):
    """``op`` ("amin", "amax") over each pair's two frames, NaN skipped
    (NaN where a pair is all NaN); ``stack`` is (N, 2, H, W)."""
    nan = torch.isnan(stack)
    out = getattr(torch.where(nan, fill, stack), op)(dim=(1, 2, 3), keepdim=True)
    return torch.where(nan.all(dim=(1, 2, 3), keepdim=True), math.nan, out)


_TREE_WINDOW = 32  # XLA's CPU tree reduction: windows of at most 32 along each axis


def _tree_sum(x):
    """float32 sums of (N, ...) over all but the first axis, in the order
    of the reference's compiled CPU program: the reduction is split into
    windows of at most 32 along each axis (zero-padded), each window
    summed element by element in row-major order, and the window sums
    reduced the same way until one window holds them all."""
    while True:
        sizes = x.shape[1:]
        win = [min(n, _TREE_WINDOW) for n in sizes]
        if all(n <= _TREE_WINDOW for n in sizes):
            flat = x.reshape(x.shape[0], -1)
            break
        pad = []
        for n, w in zip(reversed(sizes), reversed(win)):
            pad += [0, -n % w]
        x = torch.nn.functional.pad(x, pad)
        shape = [x.shape[0]]
        for n, w in zip(x.shape[1:], win):
            shape += [n // w, w]
        nd = len(sizes)
        x = x.reshape(shape).permute([0] + [1 + 2 * i for i in range(nd)]
                                     + [2 + 2 * i for i in range(nd)])
        blocks = x.shape[:1 + nd]
        flat = x.reshape(blocks + (-1,))
        acc = torch.zeros(blocks, dtype=x.dtype, device=x.device)
        for i in range(flat.shape[-1]):
            acc = acc + flat[..., i]
        x = acc
    acc = torch.zeros(flat.shape[:1], dtype=flat.dtype, device=flat.device)
    for i in range(flat.shape[-1]):
        acc = acc + flat[:, i]
    return acc


def _pair_mean_std(stack):
    """Each pair's NaN-skipping mean and (population) standard deviation
    over its two frames (N, 2, H, W), as ``jnp.nanmean`` and
    ``jnp.nanstd`` compute them in the reference's compiled program:
    float32 sums in its order (:func:`_tree_sum`), the sum of squared
    deviations over the count, a correctly rounded root."""
    ok = ~torch.isnan(stack)
    count = _tree_sum(ok.to(torch.float32))
    mean = (_tree_sum(torch.where(ok, stack, 0.0)) / count).view(-1, 1, 1, 1)
    dev = torch.where(ok, stack - mean, 0.0)
    var = _tree_sum(dev * dev) / count
    std = torch.sqrt(var.to(torch.float64)).to(torch.float32)
    return mean, std.view(-1, 1, 1, 1)


def _unit_range(stack, method):
    """Each pair (N, 2, H, W) mapped to [0, 1] by ``method``, every
    statistic taken over the pair's own two frames."""
    if method == "linear":
        vmin = _pair_reduce(stack, math.inf, "amin")
        vmax = _pair_reduce(stack, -math.inf, "amax")
        inv = torch.where(vmax > vmin, 1.0 / (vmax - vmin), torch.zeros_like(vmax))
        return torch.clamp((stack - vmin) * inv, 0.0, 1.0)
    if method == "z_score":
        mean, std = _pair_mean_std(stack)
        # ``/ 6`` as XLA compiles it: a multiply by the float32 reciprocal
        return torch.clamp(((stack - mean) / std + 3.0) * float(np.float32(1.0 / 6.0)),
                           0.0, 1.0)
    if method in ("log", "inverse_log"):
        if method == "log":
            shifted = _log32((stack - _pair_reduce(stack, math.inf, "amin")) + 1.0)
        else:
            shifted = _log32((_pair_reduce(stack, -math.inf, "amax") - stack) + 1.0)
        smax = _pair_reduce(shifted, -math.inf, "amax")
        inv = torch.where(smax > 0, 1.0 / smax, torch.zeros_like(smax))
        return torch.clamp(shifted * inv, 0.0, 1.0)
    raise NotImplementedError(
        f"normalisation method {method!r} is not available in the jitted "
        "flow path; use one of linear/z_score/log/inverse_log"
    )


def _normalise_pair(prev, nxt, method="linear"):
    """Quantise frame pairs (N, H, W) to [0, 255] by ``method`` ("linear",
    "z_score", "log" or "inverse_log") over each pair's own two frames,
    NaN filled from the other frame (or 127), rounded half to even."""
    scaled = _unit_range(torch.stack([prev, nxt], dim=1), method) * 255.0
    finite = torch.isfinite(scaled)
    filled = torch.where(finite, scaled, 127.0)
    a = torch.where(finite[:, 0], filled[:, 0], torch.where(finite[:, 1], filled[:, 1], 127.0))
    b = torch.where(finite[:, 1], filled[:, 1], torch.where(finite[:, 0], filled[:, 0], 127.0))
    return torch.round(a), torch.round(b)


_FLOW_CLIP = 20.0  # px, as the reference (tobac-flow's flow.py clips to ±20)
_WS_ITERS = 128  # the fused path's Jacobi round cap

# Device bytes that a stage allocates at its peak beyond its inputs,
# rounded up: per frame pair and pixel for the flow (both directions, with
# the detection CLI's refinement and smoothing, cubic or Lanczos), each
# model's ``BYTES_PER_PAIR_PX``, and per frame and pixel for the fields,
# its outputs included.  The most that tools/torch_flood_memory.py measured
# on an H100 80GB HBM3 (700 W): the models (``--models all``) at 5 x 1500 x
# 2500, whole and in groups of one pair (Farneback also at 6 and 12 x 1500
# x 2500 and 24 x 1024 x 1536); the fields 248.00.
FIELDS_BYTES_PER_PX = 249


def pair_flows(data, model, vr_steps=0, smoothing_passes=0, interp_method="linear",
               device=None, group=None, normalisation_method="linear"):
    """Forward/backward flow of a (T, H, W) stack, unclipped, on ``device``
    (see :func:`resolve_device`): ``model`` (a pair-flow module; its
    ``BYTES_PER_PAIR_PX`` sizes the groups) runs the pair solves of both
    directions as one batch of 2 x ``group`` pairs (see
    :func:`~tobac_flow_tpu_torch.device.group_size`; all 2(T-1) where
    they fit); each pair is normalised over its own two frames
    (``normalisation_method``), then refined (``vr_steps``) and smoothed
    (``smoothing_passes`` with ``interp_method``), as the reference does
    per pair.  The boundary frames take the negated opposite flow."""
    data = torch.as_tensor(data).to(resolve_device(device))
    if data.shape[0] < 2:
        raise ValueError("Need at least two frames to compute flow")
    t = data.shape[0]
    model = model.to(data.device)
    px = data[0].numel()
    # a pair-flow module outside the registry is planned as the costliest
    per_px = getattr(model, "BYTES_PER_PAIR_PX", FarnebackFlow.BYTES_PER_PAIR_PX)
    # the two (T, H, W, 2) float32 flows are allocated whole: before the
    # groups' working memory where there are groups (so that they pin none
    # of its blocks), after it where there is one
    step = group_size(t - 1, px, per_px, data.device, group, 16 * t * px)

    def outputs():
        out = torch.empty(data.shape + (2,), dtype=torch.float32, device=data.device)
        return out, torch.empty_like(out)

    fwd, bwd = outputs() if step < t - 1 else (None, None)
    for a in range(0, t - 1, step):
        b = min(t - 1, a + step)
        fwd_pairs, bwd_pairs = flow_pairs(data[a:b], data[a + 1:b + 1], model, vr_steps,
                                          smoothing_passes, interp_method,
                                          normalisation_method)
        if fwd is None:
            fwd, bwd = outputs()
        fwd[a:b] = fwd_pairs
        bwd[a + 1:b + 1] = bwd_pairs
        del fwd_pairs, bwd_pairs
    fwd[-1] = -bwd[-1]
    bwd[0] = -fwd[0]
    return fwd, bwd


def flow_pairs(prev, nxt, model, vr_steps=0, smoothing_passes=0, interp_method="linear",
               normalisation_method="linear"):
    """The forward (``prev`` → ``nxt``) and backward flows of frame pairs
    (N, H, W) each, unclipped, on their device: each pair normalised over
    its own two frames, both directions solved by ``model`` as one batch,
    refined and smoothed (see :func:`pair_flows`)."""
    p8, n8 = _normalise_pair(prev, nxt, normalisation_method)
    first, second = torch.cat([p8, n8]), torch.cat([n8, p8])
    del p8, n8
    flows = model(first, second)
    if vr_steps > 0:
        flows = variational_refine(first, second, flows, steps=vr_steps)
    del first, second
    n = prev.shape[0]
    fwd_pairs, bwd_pairs = flows[:n], flows[n:]
    for _ in range(smoothing_passes):
        fwd_pairs, bwd_pairs = smooth_flow_step(fwd_pairs, bwd_pairs, method=interp_method)
    return fwd_pairs, bwd_pairs


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
