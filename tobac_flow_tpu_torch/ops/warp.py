"""Interpolation weights and integer-shift taps (counterpart of
``tobac_flow_tpu/ops/warp.py``).

The linear and cubic (cv2 INTER_CUBIC, A = -0.75) tap weights and the
constant-fill shift of a frame to a set of integer offsets.

The reference's compiled CPU programs contract a product that feeds an add
into one fused multiply-add (a product that passes through a select first
is not contracted).  ``fma`` reproduces that rounding where the port must
match the reference bit for bit: the product of two float32 numbers is
exact in float64, so one float64 add and one rounding to float32 give the
fused result (a double rounding can differ from it only when the float64
sum falls exactly halfway between two float32 numbers).
"""

from __future__ import annotations

import math

import torch

__all__ = ["fma", "shift", "shift_axis", "shift_plane"]


def _linear_weights(f):
    """2-tap linear weights for fractional position f in [0, 1)."""
    return [1.0 - f, f]


def fma(a, b, c):
    """float32 ``a * b + c`` rounded once (see the module docstring); any
    argument may be a Python number, taken as its float32 value."""
    def wide(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.float64)
        return float(torch.tensor(x, dtype=torch.float32))

    a, b, c = wide(a), wide(b), wide(c)
    return (a * b + c).to(torch.float32)


def _cubic_weights(f):
    """4-tap cubic-convolution weights (cv2 INTER_CUBIC, A = -0.75), rounded
    as the reference's compiled programs round them:
    each Horner step ``p * x + c`` is one fused multiply-add, and the outer
    taps' ``(f + 1) - 5`` and ``(2 - f) - 5`` are folded to ``f - 4`` and
    ``-3 - f`` before rounding."""
    a = -0.75
    x0 = f + 1.0
    x2 = 1.0 - f
    x3 = 2.0 - f

    def outer(x, x_minus_5):  # a * (((x - 5) * x + 8) * x - 4)
        return a * fma(fma(x_minus_5, x, 8.0), x, -4.0)

    def inner(x):  # ((a + 2) * x - (a + 3)) * x * x + 1
        return fma(fma(a + 2.0, x, -(a + 3.0)) * x, x, 1.0)

    return [outer(x0, f - 4.0), inner(f), inner(x2), outer(x3, -3.0 - f)]


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
