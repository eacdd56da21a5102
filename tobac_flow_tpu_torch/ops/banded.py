"""Bounded-displacement warps (counterpart of ``tobac_flow_tpu/ops/banded.py``).

The reference writes every gather as a sum of masked band shifts because a
general gather is slow on its chip.  Here each warp is a direct gather with
the same semantics: the same displacement clips, the same pad rules and
the same order of the interpolation terms, so the results match the
reference bit for bit.

- ``warp_banded_multi`` / ``warp_banded``: the separable two-pass warp
  (nearest, linear or cubic).  The y pass runs first; the x pass evaluates
  ``dx`` at the destination but reads the y-warped image.  Each pass clips
  its displacement to ±radius; outside the frame it reads the edge
  (``pad_mode="edge"``) or ``fill_value``.
- ``banded_warp_axis``: a linear warp along one axis, the displacement
  clipped to ±radius, ``fill_value`` (or the edge) outside the frame.
- ``warp_banded_exact`` / ``warp_banded_exact_multi``: the cv2.remap-exact
  warp, both displacement components read at the destination, constant
  ``fill_value`` outside the frame.  A zero-weight tap contributes exactly
  0, so a NaN there does not poison the result.

Cubic weights are rounded as the reference's compiled programs round them
(``ops.warp._cubic_weights``).
"""

from __future__ import annotations

import math

import torch

from tobac_flow_tpu_torch.ops.warp import _cubic_weights, _linear_weights

__all__ = [
    "banded_warp_axis", "warp_banded", "warp_banded_multi", "warp_banded_exact",
    "warp_banded_exact_multi",
]

# (first tap's offset from the floor, tap count, weight function) per method
_INTERP = {
    "linear": (0, 2, _linear_weights),
    "cubic": (-1, 4, _cubic_weights),
}


def _masked(w, v):
    """``where(w == 0, 0, w * v)``: a zero-weight tap adds exactly 0."""
    return torch.where(w == 0, torch.zeros((), dtype=v.dtype, device=v.device), w * v)


def _weighted_sum(weights, taps):
    """Σ masked(w_j, tap_j) in increasing tap order."""
    out = _masked(weights[0], taps[0])
    for w, v in zip(weights[1:], taps[1:]):
        out = out + _masked(w, v)
    return out


def _axis_index(shape, axis, device):
    n = shape[axis]
    view = [1] * len(shape)
    view[axis] = n
    return torch.arange(n, device=device).view(view)


def _axis_gather(img, pos, axis, fill_value, pad_mode):
    """``img`` at integer positions ``pos`` along ``axis``: the edge sample
    outside the frame (``pad_mode="edge"``) or ``fill_value``."""
    n = img.shape[axis]
    out = torch.gather(img, axis, pos.clamp(0, n - 1))
    if pad_mode == "edge":
        return out
    fill = torch.full((), fill_value, dtype=img.dtype, device=img.device)
    return torch.where((pos >= 0) & (pos < n), out, fill)


def banded_warp_axis(img, disp, axis, radius, fill_value=math.nan, pad_mode="constant"):
    """Linear warp of ``img`` along ``axis`` by the fractional ``disp``
    (same shape), clipped to ±radius: ``(1 - f)·img[p + ⌊d⌋] +
    f·img[p + ⌊d⌋ + 1]``, a zero-weight tap adding exactly 0; outside the
    frame ``fill_value`` (or the edge sample with ``pad_mode="edge"``)."""
    axis = axis % img.dim()
    disp = disp.clamp(-float(radius), float(radius))
    lo = torch.floor(disp)
    frac = (disp - lo).to(img.dtype)
    pos = _axis_index(img.shape, axis, img.device) + lo.long()
    taps = [_axis_gather(img, pos + j, axis, fill_value, pad_mode) for j in (0, 1)]
    return _weighted_sum((1.0 - frac, frac), taps)


def warp_banded_multi(channels, flow, radius=20, method="linear",
                      fill_value=math.nan, pad_mode="edge"):
    """Separable two-pass warp of ``channels`` (..., H, W) by ``flow``
    (..., H, W, 2), channel 0 = x, 1 = y; ``flow`` broadcasts against the
    leading axes of ``channels``.  The y pass runs first; each pass clips
    its displacement to ±radius.  ``method`` is "nearest" (displacements
    rounded half to even), "linear" or "cubic"."""
    if pad_mode not in ("edge", "constant"):
        raise ValueError("pad_mode must be 'edge' or 'constant'")
    out = channels
    for axis, disp in ((-2, flow[..., 1]), (-1, flow[..., 0])):
        disp = disp.expand(channels.shape)
        index = _axis_index(channels.shape, axis, channels.device)
        if method == "nearest":
            pos = index + torch.round(disp).long().clamp(-radius, radius)
            out = _axis_gather(out, pos, axis, fill_value, pad_mode)
            continue
        if method not in _INTERP:
            raise ValueError("method must be 'nearest', 'linear' or 'cubic'")
        tap0, n_taps, weight_fn = _INTERP[method]
        disp = disp.clamp(-float(radius), float(radius))
        lo = torch.floor(disp)
        weights = weight_fn((disp - lo).to(out.dtype))
        pos = index + lo.long() + tap0
        taps = [_axis_gather(out, pos + j, axis, fill_value, pad_mode) for j in range(n_taps)]
        out = _weighted_sum(weights, taps)
        if method == "cubic":  # the reference starts this sum from +0
            out = out + 0.0
    return out


def warp_banded(img, flow, radius=20, method="linear", fill_value=math.nan,
                pad_mode="constant"):
    """Two-pass warp of one field (..., H, W) by ``flow`` (..., H, W, 2):
    ``warp_banded_multi`` with the reference's constant pad by default."""
    return warp_banded_multi(img, flow, radius, method, fill_value, pad_mode)


def _exact_taps(img, flow, radius_y, radius_x, oy_range, ox_range, fill_value):
    """The union grid of samples every offset reads,
    ``grid[(a, b)] = img[y + ⌊dy⌋ + a, x + ⌊dx⌋ + b]`` (``fill_value``
    outside the frame), and the fractional parts of the clipped
    displacements.  ``oy_range``/``ox_range`` are the grid's row and column
    offsets from the floor."""
    h, w = img.shape[-2:]
    dy = flow[..., 1].clamp(-float(radius_y), float(radius_y))
    dx = flow[..., 0].clamp(-float(radius_x), float(radius_x))
    lo_y = torch.floor(dy)
    lo_x = torch.floor(dx)
    fy = (dy - lo_y).to(torch.float32)
    fx = (dx - lo_x).to(torch.float32)
    ys = torch.arange(h, device=img.device).view(h, 1)
    xs = torch.arange(w, device=img.device).view(1, w)
    row0 = ys + lo_y.long()
    col0 = xs + lo_x.long()
    flat = img.reshape(img.shape[:-2] + (h * w,))
    fill = torch.full((), fill_value, dtype=img.dtype, device=img.device)
    grid = {}
    for a in oy_range:
        rows = row0 + a
        rows_ok = (rows >= 0) & (rows < h)
        rows = rows.clamp(0, h - 1) * w
        for b in ox_range:
            cols = col0 + b
            ok = rows_ok & (cols >= 0) & (cols < w)
            idx = (rows + cols.clamp(0, w - 1)).expand(img.shape).reshape(flat.shape)
            v = torch.gather(flat, -1, idx).reshape(img.shape)
            grid[(a, b)] = torch.where(ok, v, fill)
    return fy, fx, grid


def warp_banded_exact_multi(img, flow, offsets, radius, method="linear",
                            fill_value=math.nan, radius_x=None):
    """``warp_banded_exact(img, flow + (ox, oy))`` for each integer offset,
    stacked along a new leading axis.  Each displacement is clipped to
    ±radius (±``radius_x`` along x, when given) before the offset is added,
    as in the reference.

    ``method``: "nearest" reads ``img[y + round(dy) + oy, x + round(dx) +
    ox]`` (half to even; ``img`` may be an integer label raster);
    "linear" and "cubic" interpolate, the x taps of each source row first,
    then the rows, each sum in increasing tap order (the reference's band
    order)."""
    radius_x = radius if radius_x is None else radius_x
    offsets = [(int(ox), int(oy)) for ox, oy in offsets]
    oys = [oy for _, oy in offsets]
    oxs = [ox for ox, _ in offsets]
    if method == "nearest":
        rounded = torch.stack([
            torch.round(flow[..., 0].clamp(-float(radius_x), float(radius_x))),
            torch.round(flow[..., 1].clamp(-float(radius), float(radius))),
        ], dim=-1)
        _, _, grid = _exact_taps(
            img, rounded, radius, radius_x, range(min(oys), max(oys) + 1),
            range(min(oxs), max(oxs) + 1), fill_value,
        )
        return torch.stack([grid[(oy, ox)] for ox, oy in offsets])
    if method not in _INTERP:
        raise ValueError("method must be 'nearest', 'linear' or 'cubic'")
    tap0, n_taps, weight_fn = _INTERP[method]
    fy, fx, grid = _exact_taps(
        img, flow, radius, radius_x,
        range(min(oys) + tap0, max(oys) + tap0 + n_taps),
        range(min(oxs) + tap0, max(oxs) + tap0 + n_taps), fill_value,
    )
    wy, wx = weight_fn(fy), weight_fn(fx)
    out = []
    for ox, oy in offsets:
        rows = [
            _weighted_sum(wx, [grid[(oy + tap0 + i, ox + tap0 + j)] for j in range(n_taps)])
            for i in range(n_taps)
        ]
        out.append(_weighted_sum(wy, rows))
    return torch.stack(out)


def warp_banded_exact(img, flow, radius, method="linear", fill_value=math.nan):
    """cv2.remap-exact warp of ``img`` (..., H, W) by ``flow``
    (..., H, W, 2): ``out[y, x] = interp(img)(y + dy(y, x), x + dx(y, x))``
    with each displacement clipped to ±radius, ``fill_value`` outside the
    frame."""
    return warp_banded_exact_multi(img, flow, [(0, 0)], radius, method, fill_value)[0]
