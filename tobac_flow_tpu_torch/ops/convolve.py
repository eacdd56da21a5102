"""Semi-Lagrangian flow-warped convolution over a (T, H, W) volume
(counterpart of ``tobac_flow_tpu/ops/convolve.py``).

Every pixel gathers up to 27 neighbours picked by a (3, 3, 3) structuring
element: the t-1 plane samples the previous frame warped along the
*backward* flow, the t plane integer shifts of the frame itself, and the
t+1 plane the next frame warped along the *forward* flow.  Samples outside
the frame read ``fill_value``; the first frame's previous plane and the
last frame's next plane are all fill.  Taps are ordered as the reference
orders them (backward plane, same plane, forward plane; row-major within a
plane), so reductions such as the Sobel weights carry over.

The whole volume is one batch: the warps are direct gathers
(``ops.banded.warp_banded_exact_multi``) with the reference's per-plane
displacement clip, ``21 - max |offset|`` px along each axis.  Where the
batch would exceed the device budget, ``convolve`` runs in time chunks
with one halo frame each side (the stencil reaches t±1), which gives the
whole volume's result frame for frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tobac_flow_tpu_torch.device import CONVOLVE_BYTES_PER_TAP_PX, chunk_plan, time_chunks
from tobac_flow_tpu_torch.ops.banded import warp_banded_exact_multi
from tobac_flow_tpu_torch.ops.warp import shift_plane

__all__ = [
    "DEFAULT_STRUCTURE", "convolve", "structure_taps", "nanmean0", "any0", "diff_func",
]

_BAND = 21  # the reference's static band radius (flows are clipped to ±20 px)


def _binary_structure_1():
    s = np.zeros((3, 3, 3), dtype=bool)
    s[1, 1, :] = True
    s[1, :, 1] = True
    s[:, 1, 1] = True
    return s


DEFAULT_STRUCTURE = _binary_structure_1()


def structure_taps(structure):
    """Per-plane (ox, oy) taps of a (3, 3, 3) structuring element, row-major
    within each plane and measured from the plane's centre: (backward taps,
    same-plane taps, forward taps)."""
    structure = np.asarray(structure)
    if structure.shape != (3, 3, 3):
        raise ValueError("Structure input must be a 3x3x3 array")
    planes = []
    for k in range(3):
        rows, cols = np.nonzero(structure[k])
        planes.append(tuple((int(c) - 1, int(r) - 1) for r, c in zip(rows, cols)))
    return tuple(planes)


def nanmean0(x):
    """``jnp.nanmean(x, axis=0)``: the non-NaN taps summed in tap order,
    over their count (NaN where there is none)."""
    total = torch.where(torch.isnan(x[0]), 0.0, x[0])
    count = (~torch.isnan(x[0])).to(x.dtype)
    for v in x[1:]:
        total = total + torch.where(torch.isnan(v), 0.0, v)
        count = count + (~torch.isnan(v)).to(x.dtype)
    return total / count


def any0(x):
    """Any tap set, as int32."""
    return (x != 0).any(dim=0).to(torch.int32)


def diff_func(x):
    """NaN-aware mean of the forward and backward one-sided differences of
    the three temporal taps (x[0] previous, x[1] centre, x[2] next)."""
    fwd = x[2] - x[1]
    bwd = x[1] - x[0]
    total = torch.where(torch.isnan(fwd), 0.0, fwd) + torch.where(torch.isnan(bwd), 0.0, bwd)
    count = torch.isfinite(x[2]).to(torch.float32) + torch.isfinite(x[0]).to(torch.float32)
    return total / torch.clamp(count, min=1.0)


def _plane_warp(img, flow, taps, method, fill_value):
    max_ox = max(abs(ox) for ox, _ in taps)
    max_oy = max(abs(oy) for _, oy in taps)
    return warp_banded_exact_multi(
        img, flow, taps, max(1, _BAND - max_oy), method, fill_value,
        radius_x=max(1, _BAND - max_ox),
    )


def _convolve_impl(data, forward_flow, backward_flow, taps, method, fill_value, func,
                   out_fill):
    """The stacked taps (n_taps, T, H, W), or ``func`` of them with
    ``out_fill`` where floating ``data`` is NaN."""
    back_taps, same_taps, fwd_taps = taps
    fill_frame = torch.full_like(data[:1], fill_value)
    parts = []
    if back_taps:
        prev = torch.cat([fill_frame, data[:-1]])
        parts.append(_plane_warp(prev, backward_flow, back_taps, method, fill_value))
    if same_taps:
        parts.append(shift_plane(data, same_taps, fill_value))
    if fwd_taps:
        nxt = torch.cat([data[1:], fill_frame])
        parts.append(_plane_warp(nxt, forward_flow, fwd_taps, method, fill_value))
    stacked = torch.cat(parts)
    if func is None:
        return stacked
    out = func(stacked)
    if data.is_floating_point():
        out = torch.where(torch.isnan(data), torch.full((), out_fill, dtype=out.dtype,
                                                        device=out.device), out)
    return out


def convolve(data, forward_flow, backward_flow, structure=None, method="linear",
             dtype=torch.float32, fill_value=math.nan, func=None, budget_bytes=None):
    """Flow-warped convolution on the flows' device (``data`` may wait on
    the host: it moves there a chunk at a time).

    data : (T, H, W) tensor.
    forward_flow, backward_flow : (T, H, W, 2) tensors (channel 0 = x).
    structure : (3, 3, 3) array; plane 0 acts backwards in time, plane 2
        forwards.  Defaults to connectivity 1.
    method : "nearest", "linear" or "cubic" for the warped planes.
    dtype : output dtype; "nearest" gathers in it (labels stay integers),
        the others in float32.
    fill_value : out-of-frame and boundary-frame samples.
    func : optional reduction over the tap axis of the (n_taps, T, H, W)
        stack.
    budget_bytes : device bytes the call may take beyond its inputs
        (``CONVOLVE_BYTES_PER_TAP_PX`` a tap and pixel); over it, the call
        runs in time chunks with one halo frame each side.  ``None`` means
        :func:`~tobac_flow_tpu_torch.device.memory_budget` (no chunks on
        the CPU).

    Returns the stack, or ``func``'s result with NaN input locations set to
    ``fill_value``.
    """
    if structure is None:
        structure = DEFAULT_STRUCTURE
    taps = structure_taps(structure)
    n_taps = sum(len(p) for p in taps)
    dev = forward_flow.device
    out_px = (n_taps if func is None else 1) * torch.empty((), dtype=dtype).element_size()
    t = data.shape[0]
    chunk = chunk_plan("convolve", data.shape, CONVOLVE_BYTES_PER_TAP_PX * n_taps + out_px,
                       dev, budget_bytes, 1, out_px)

    def run(lo, hi):
        part = data[lo:hi].to(dev)
        work = part.to(dtype) if method == "nearest" else part.to(torch.float32)
        return _convolve_impl(work, forward_flow[lo:hi], backward_flow[lo:hi], taps, method,
                              fill_value, func, fill_value).to(dtype)

    if chunk >= t:
        return run(0, t)
    out = None
    for s, e, lo, hi in time_chunks(t, chunk, 1):
        part = run(lo, hi)
        if out is None:
            shape = list(part.shape)
            shape[-3] = t
            out = torch.empty(shape, dtype=dtype, device=dev)
        out.narrow(-3, s, e - s).copy_(part.narrow(-3, s - lo, e - s))
        del part
    return out
