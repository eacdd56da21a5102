"""Flow-warped sampling and integer-shift taps (counterpart of
``tobac_flow_tpu/ops/warp.py``).

The linear, cubic (cv2 INTER_CUBIC, A = -0.75) and Lanczos4 tap weights,
the general-gather warp of a frame to a set of integer offsets displaced
by a flow (``warp_plane``, ``warp_flow``: nearest, linear, cubic or
Lanczos4, ``fill_value`` outside the frame, zero-weight taps masked) and
the constant-fill shift of a frame to a set of integer offsets.

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

import numpy as np
import torch

__all__ = [
    "INTERP_METHODS", "fma", "shift", "shift_axis", "shift_plane", "sqrt32", "warp_flow",
    "warp_plane",
]

INTERP_METHODS = ("nearest", "linear", "cubic", "lanczos")


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


def sqrt32(x):
    """Correctly rounded float32 square root, as the reference's compiled
    programs take it: the card's is; the CPU's vectorised one is not, so
    there it is taken in float64 (exact, then rounded once)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


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


# glibc's sinf/cosf (``sysdeps/ieee754/flt-32/s_sinf.c``, ``sincosf_data.c``),
# which the reference's compiled CPU programs call: the argument reduced by
# multiples of pi/2 and a polynomial, both in float64, rounded to float32
# once.  Per row: sign[4], hpi_inv, hpi, c0..c4, s1..s3; the second row
# serves quadrants 2 and 3.
_SINCOSF = (
    ((1.0, -1.0, -1.0, 1.0), float.fromhex("0x1.45F306DC9C883p+23"),
     float.fromhex("0x1.921FB54442D18p0"), 1.0, float.fromhex("-0x1.ffffffd0c621cp-2"),
     float.fromhex("0x1.55553e1068f19p-5"), float.fromhex("-0x1.6c087e89a359dp-10"),
     float.fromhex("0x1.99343027bf8c3p-16"), float.fromhex("-0x1.555545995a603p-3"),
     float.fromhex("0x1.1107605230bc4p-7"), float.fromhex("-0x1.994eb3774cf24p-13")),
)
_SINCOSF += ((_SINCOSF[0][:3] + tuple(-c for c in _SINCOSF[0][3:8]) + _SINCOSF[0][8:]),)
_PIO4_TOP12 = 0x3F4  # the top 12 bits of float32 pi/4


def _sincos_poly(x, x2, odd, row):
    """glibc's ``sinf_poly``: the sine polynomial where ``odd`` is False,
    the cosine's where it is True (float64 tensors; ``row`` picks the
    table row per element)."""
    def coef(k):
        pair = torch.tensor([_SINCOSF[0][k], _SINCOSF[1][k]], dtype=torch.float64,
                            device=x.device)
        return pair[row.long()]

    x3 = x * x2
    sin = (x + x3 * coef(8)) + (x3 * x2) * (coef(9) + x2 * coef(10))
    x4 = x2 * x2
    cos = ((coef(3) + x2 * coef(4)) + x4 * coef(5)) + (x4 * x2) * (coef(6) + x2 * coef(7))
    return torch.where(odd, cos, sin)


def _sincos(y):
    """(sin y, cos y) of a float32 tensor as glibc's ``sinf`` and ``cosf``
    round them, for |y| < 120 (the reduction the reference's arguments
    take; larger finite arguments raise; NaN and infinities give NaN)."""
    top12 = (y.view(torch.int32) >> 20) & 0x7FF
    finite = torch.isfinite(y)
    if bool((finite & (top12 >= 0x42F)).any()):  # 120.0f
        raise ValueError("_sincos takes |y| < 120")
    x = y.to(torch.float64)
    small = top12 < _PIO4_TOP12
    n = ((torch.trunc(x * _SINCOSF[0][1]).to(torch.int64) + 0x800000) >> 24)
    n = torch.where(small, 0, n)
    r = x - n.to(torch.float64) * _SINCOSF[0][2]
    sign = torch.tensor(_SINCOSF[0][0], dtype=torch.float64, device=y.device)[n & 3]
    row = (n & 2) != 0
    rs = r * sign
    r2 = r * r
    odd = (n & 1) != 0
    sin = _sincos_poly(rs, r2, odd, row).to(torch.float32)
    cos = _sincos_poly(rs, r2, ~odd, row).to(torch.float32)
    # glibc's tiny-argument branches: sinf(y) = y, cosf(y) = 1
    tiny = top12 < 0x398  # 0x1p-12f
    sin = torch.where(finite, torch.where(tiny, y, sin), math.nan)
    cos = torch.where(finite, torch.where(tiny, 1.0, cos), math.nan)
    return sin, cos


_LANCZOS_CS = (
    (1.0, 0.0),
    (-math.sqrt(0.5), -math.sqrt(0.5)),
    (0.0, 1.0),
    (math.sqrt(0.5), -math.sqrt(0.5)),
    (-1.0, 0.0),
    (math.sqrt(0.5), math.sqrt(0.5)),
    (0.0, -1.0),
    (-math.sqrt(0.5), math.sqrt(0.5)),
)


def _lanczos_weights(f):
    """8-tap Lanczos4 weights (taps -3..4 from the floor) of the fractional
    position ``f`` (float32), in cv2's trig-table form as the reference's
    compiled program rounds it: one sine and cosine (glibc's), each tap's
    ``a sin + b cos`` over its squared argument ``y = -(f + (3 - i)) pi/4``,
    those summed left to right, each tap ``(a sin + b cos) / (y^2 total)``
    (the compiler folds the two divisions into one), one-hot at integer
    positions.  Of the products, the compiled program fuses tap 1's sine
    product into its add, and no other."""
    quarter_pi = float(np.float32(math.pi * 0.25))
    s0, c0 = _sincos(-(f + 3.0) * quarter_pi)
    nums, sq = [], []
    for i, (a, b) in enumerate(_LANCZOS_CS):
        y = -(f + float(3 - i)) * quarter_pi if i != 3 else -f * quarter_pi
        sq.append(torch.where(y.abs() < 1e-6, 1.0, y * y))
        if i == 1:
            nums.append(fma(a, s0, c0 * b))
        else:
            nums.append((s0 if a == 1.0 else s0 * a) + c0 * b)
    total = nums[0] / sq[0]
    for num, y2 in zip(nums[1:], sq[1:]):
        total = total + num / y2
    exact = f < 1e-6
    return [torch.where(exact, 1.0 if i == 3 else 0.0, num / (y2 * total))
            for i, (num, y2) in enumerate(zip(nums, sq))]


# tap offsets from the floor and weight function per interpolating method
_SUPPORT = {
    "linear": (0, 1, _linear_weights),
    "cubic": (-1, 2, _cubic_weights),
    "lanczos": (-3, 4, _lanczos_weights),
}


def _gather_frame(flat, iy, ix, h, w, fill_value):
    """``flat[..., iy * w + ix]`` with ``fill_value`` outside the frame."""
    inb = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    idx = torch.where(inb, iy * w + ix, 0).expand(flat.shape[:-1] + iy.shape[-2:])
    vals = torch.gather(flat, -1, idx.reshape(flat.shape[:-1] + (-1,))).view(idx.shape)
    return torch.where(inb, vals, torch.full((), fill_value, dtype=vals.dtype,
                                              device=vals.device))


def warp_plane(img, flow, offsets, method="linear", fill_value=math.nan):
    """``img`` (..., H, W) sampled at ``(x + flow_x + ox, y + flow_y + oy)``
    for each integer offset ``(ox, oy)``, stacked along a new leading axis:
    (n_offsets, ..., H, W).  ``flow`` (..., H, W, 2), channel 0 = x,
    broadcasts against ``img``'s leading axes.  ``method``: "nearest"
    (coordinates rounded half to even), "linear", "cubic" or "lanczos";
    each output sums its taps row by row, x within a row, from zero, a tap
    of zero weight adding exactly 0."""
    if method not in INTERP_METHODS:
        raise ValueError(f"method must be one of {list(INTERP_METHODS)}")
    h, w = img.shape[-2:]
    flat = img.reshape(img.shape[:-2] + (h * w,))
    gx = torch.arange(w, dtype=torch.float32, device=img.device).view(1, w)
    gy = torch.arange(h, dtype=torch.float32, device=img.device).view(h, 1)
    bx = gx + flow[..., 0].to(torch.float32)
    by = gy + flow[..., 1].to(torch.float32)
    offsets = [(int(ox), int(oy)) for ox, oy in offsets]
    if method == "nearest":
        rx = torch.round(bx).to(torch.int64)
        ry = torch.round(by).to(torch.int64)
        return torch.stack([_gather_frame(flat, ry + oy, rx + ox, h, w, fill_value)
                            for ox, oy in offsets])
    lo, hi, weight_fn = _SUPPORT[method]
    fx = torch.floor(bx)
    fy = torch.floor(by)
    ix = fx.to(torch.int64)
    iy = fy.to(torch.int64)
    wx = weight_fn(bx - fx)
    wy = weight_fn(by - fy)
    # the union grid of taps is gathered once and shared by the offsets;
    # one offset reads each tap once, so it keeps none
    grid = {}

    def tap(gy_off, gx_off):
        if (gy_off, gx_off) in grid:
            return grid[(gy_off, gx_off)]
        v = _gather_frame(flat, iy + gy_off, ix + gx_off, h, w, fill_value)
        if len(offsets) > 1:
            grid[(gy_off, gx_off)] = v
        return v

    dtype = img.dtype if img.dtype.is_floating_point else torch.float32
    zero = torch.zeros((), dtype=dtype, device=img.device)
    outs = []
    for ox, oy in offsets:
        acc = None
        for ky in range(lo, hi + 1):
            for kx in range(lo, hi + 1):
                wgt = wy[ky - lo] * wx[kx - lo]
                term = torch.where(wgt == 0.0, zero, wgt * tap(oy + ky, ox + kx))
                acc = term + 0.0 if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs)


def warp_flow(img, flow, method="linear", fill_value=math.nan):
    """One frame (..., H, W) warped by a flow (..., H, W, 2), channel 0 = x
    (see :func:`warp_plane`); an integer frame is read as float32 except
    by "nearest"."""
    if method not in INTERP_METHODS:
        raise ValueError(f"method must be one of {list(INTERP_METHODS)}")
    img = torch.as_tensor(img)
    flow = torch.as_tensor(flow).to(img.device)
    if method != "nearest" and not img.dtype.is_floating_point:
        img = img.to(torch.float32)
    return warp_plane(img, flow, [(0, 0)], method=method, fill_value=fill_value)[0]
