"""Interpolation weights and integer-shift taps (counterpart of
``tobac_flow_tpu/ops/warp.py``).

Only what the fused flow → fields → watershed path needs: the linear and
cubic (cv2 INTER_CUBIC, A = -0.75) tap weights and the constant-fill shift
of a frame to a set of integer offsets.
"""

from __future__ import annotations

import math

import torch

__all__ = ["shift", "shift_axis", "shift_plane"]


def _linear_weights(f):
    """2-tap linear weights for fractional position f in [0, 1)."""
    return [1.0 - f, f]


def _cubic_weights(f):
    """4-tap cubic-convolution weights (cv2 INTER_CUBIC, A = -0.75)."""
    a = -0.75
    # tap distances: |x| for taps at -1, 0, 1, 2 are 1+f, f, 1-f, 2-f
    x0 = f + 1.0
    x1 = f
    x2 = 1.0 - f
    x3 = 2.0 - f
    w0 = a * (((x0 - 5.0) * x0 + 8.0) * x0 - 4.0)
    w1 = ((a + 2.0) * x1 - (a + 3.0)) * x1 * x1 + 1.0
    w2 = ((a + 2.0) * x2 - (a + 3.0)) * x2 * x2 + 1.0
    w3 = a * (((x3 - 5.0) * x3 + 8.0) * x3 - 4.0)
    return [w0, w1, w2, w3]


def shift_axis(a, s, axis, fill):
    """``out[p + s ê_axis] = a[p]``, constant ``fill`` where nothing lands."""
    if s == 0:
        return a
    n = a.shape[axis]
    out = torch.full_like(a, fill)
    if abs(s) < n:
        if s > 0:
            out.narrow(axis, s, n - s).copy_(a.narrow(axis, 0, n - s))
        else:
            out.narrow(axis, 0, n + s).copy_(a.narrow(axis, -s, n + s))
    return out


def shift(a, dy, dx, fill):
    """``out[..., y, x] = a[..., y + dy, x + dx]`` with constant fill outside
    the frame (the last two axes are (H, W))."""
    return shift_axis(shift_axis(a, -dy, -2, fill), -dx, -1, fill)


def shift_plane(img, offsets, fill_value=math.nan):
    """Integer-shift taps of a plane: ``img[..., y + oy, x + ox]`` for each
    ``(ox, oy)`` with constant fill, stacked along a new leading axis."""
    return torch.stack(
        [shift(img, int(oy), int(ox), fill_value) for ox, oy in offsets]
    )
