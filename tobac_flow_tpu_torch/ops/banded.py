"""Bounded-displacement warps (counterpart of ``tobac_flow_tpu/ops/banded.py``).

The reference writes every gather as a sum of masked band shifts because a
general gather is slow on its chip.  Here each warp is a direct gather with
the same semantics: the same displacement clips, the same pad rules and
the same order of the interpolation terms, so the results match the
reference bit for bit.

- ``warp_banded_multi``: the separable two-pass, edge-padded warp used
  inside Farneback.  The y pass runs first; the x pass evaluates ``dx`` at
  the destination but reads the y-warped image.  Each pass clips its
  displacement to ±radius.
- ``warp_banded_exact`` / ``warp_banded_exact_multi``: the cv2.remap-exact
  linear warp, both displacement components read at the destination, NaN
  (constant) fill outside the frame.  A zero-weight tap contributes exactly
  0, so a NaN there does not poison the result.
"""

from __future__ import annotations

import math

import torch

from tobac_flow_tpu_torch.ops.warp import _linear_weights

__all__ = ["warp_banded_multi", "warp_banded_exact", "warp_banded_exact_multi"]


def _masked(w, v):
    """``where(w == 0, 0, w * v)``: a zero-weight tap adds exactly 0."""
    return torch.where(w == 0, torch.zeros((), dtype=v.dtype, device=v.device), w * v)


def _axis_index(shape, axis, device):
    n = shape[axis]
    view = [1] * len(shape)
    view[axis] = n
    return torch.arange(n, device=device).view(view)


def _edge_gather(img, pos, axis):
    """``img`` at integer positions ``pos`` along ``axis``, clamped to the
    frame (edge padding)."""
    return torch.gather(img, axis, pos.clamp(0, img.shape[axis] - 1))


def warp_banded_multi(channels, flow, radius=20, method="linear"):
    """Separable two-pass warp of ``channels`` (..., H, W) by ``flow``
    (..., H, W, 2), channel 0 = x, 1 = y, with edge padding; ``flow``
    broadcasts against the leading axes of ``channels``.  The y pass runs
    first; each pass clips its displacement to ±radius.  ``method`` is
    "nearest" (displacements rounded half to even) or "linear"."""
    out = channels
    for axis, disp in ((-2, flow[..., 1]), (-1, flow[..., 0])):
        disp = disp.expand(channels.shape)
        index = _axis_index(channels.shape, axis, channels.device)
        if method == "nearest":
            pos = index + torch.round(disp).long().clamp(-radius, radius)
            out = _edge_gather(out, pos, axis)
        elif method == "linear":
            disp = disp.clamp(-float(radius), float(radius))
            lo = torch.floor(disp)
            w0, w1 = _linear_weights((disp - lo).to(out.dtype))
            pos = index + lo.long()
            out = _masked(w0, _edge_gather(out, pos, axis)) + _masked(
                w1, _edge_gather(out, pos + 1, axis)
            )
        else:
            raise ValueError("method must be 'nearest' or 'linear'")
    return out


def _exact_taps(img, flow, radius, oy_range, ox_range):
    """Linear weights and the union grid of samples every offset reads:
    ``grid[(a, b)] = img[y + ⌊dy⌋ + a, x + ⌊dx⌋ + b]``, NaN outside."""
    h, w = img.shape[-2:]
    dy = flow[..., 1].clamp(-float(radius), float(radius))
    dx = flow[..., 0].clamp(-float(radius), float(radius))
    lo_y = torch.floor(dy)
    lo_x = torch.floor(dx)
    fy = (dy - lo_y).to(torch.float32)
    fx = (dx - lo_x).to(torch.float32)
    ys = torch.arange(h, device=img.device).view(h, 1)
    xs = torch.arange(w, device=img.device).view(1, w)
    row0 = ys + lo_y.long()
    col0 = xs + lo_x.long()
    flat = img.reshape(img.shape[:-2] + (h * w,))
    fill = torch.full((), math.nan, dtype=img.dtype, device=img.device)
    grid = {}
    for a in oy_range:
        rows = row0 + a
        rows_ok = (rows >= 0) & (rows < h)
        rows = rows.clamp(0, h - 1) * w
        for b in ox_range:
            cols = col0 + b
            ok = rows_ok & (cols >= 0) & (cols < w)
            idx = (rows + cols.clamp(0, w - 1)).reshape(flat.shape)
            v = torch.gather(flat, -1, idx).reshape(img.shape)
            grid[(a, b)] = torch.where(ok, v, fill)
    return _linear_weights(fy), _linear_weights(fx), grid


def _combine(wy, wx, grid, oy, ox):
    """Interpolate one offset: the x taps of each source row, then the two
    rows, each sum in increasing tap order (the reference's band order)."""
    rows = [
        _masked(wx[0], grid[(oy + i, ox)]) + _masked(wx[1], grid[(oy + i, ox + 1)])
        for i in (0, 1)
    ]
    return _masked(wy[0], rows[0]) + _masked(wy[1], rows[1])


def warp_banded_exact(img, flow, radius):
    """cv2.remap-exact linear warp of ``img`` (..., H, W) by ``flow``
    (..., H, W, 2): ``out[y, x] = interp(img)(y + dy(y, x), x + dx(y, x))``
    with each displacement clipped to ±radius, NaN outside the frame."""
    wy, wx, grid = _exact_taps(img, flow, radius, (0, 1), (0, 1))
    return _combine(wy, wx, grid, 0, 0)


def warp_banded_exact_multi(img, flow, offsets, radius):
    """``warp_banded_exact(img, flow + (ox, oy))`` for each integer offset,
    stacked along a new leading axis; the displacement is clipped before
    the offset is added, as in the reference."""
    offsets = [(int(ox), int(oy)) for ox, oy in offsets]
    oys = [oy for _, oy in offsets]
    oxs = [ox for ox, _ in offsets]
    wy, wx, grid = _exact_taps(
        img, flow, radius, range(min(oys), max(oys) + 2), range(min(oxs), max(oxs) + 2)
    )
    return torch.stack([_combine(wy, wx, grid, oy, ox) for ox, oy in offsets])
