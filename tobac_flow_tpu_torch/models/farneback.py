"""Pyramidal Farneback dense optical flow in PyTorch (counterpart of
``tobac_flow_tpu/models/farneback.py``).

The same algorithm as the reference, batched: every frame pair, in both
directions, is one leading batch dimension.

1. Polynomial expansion: six separable correlations with the Gaussian
   applicability, then the constant G⁻¹ product.
2. Per pyramid level, the target expansion is pre-shifted once by the
   rounded incoming flow, then ``min(resamples, num_iters)`` rounds each
   re-warp the residual displacement (within ±6 px) and solve the
   box-aggregated, Tikhonov-regularised (+1e-3) normal equations.  Every
   solve follows a re-warp: solves against a frozen warp diverge.
3. Levels are built by Gaussian smoothing of the full-resolution frames and
   an antialiased linear resize (the weights of ``jax.image.resize``).

Numerics: the correlations and the G⁻¹ product are fixed-order sums of
float32 terms, never convolution or matmul library calls, so TF32 cannot
enter on the GPU.  The box blur uses cumulative sums like the reference.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from tobac_flow_tpu_torch.ops.banded import warp_banded_multi

__all__ = [
    "FarnebackParams", "FarnebackFlow", "farneback_pair", "from_jax_params",
    "poly_exp", "resize_linear",
]

_PARAM_NAMES = (
    "num_levels", "pyr_scale", "winsize", "num_iters", "poly_n",
    "poly_sigma", "resamples",
)


class FarnebackParams:
    """Static hyper-parameters; defaults mirror cv2's FarnebackOpticalFlow
    plus the reference's ``resamples`` (warp+solve rounds per level)."""

    def __init__(
        self,
        num_levels: int = 5,
        pyr_scale: float = 0.5,
        winsize: int = 13,
        num_iters: int = 10,
        poly_n: int = 5,
        poly_sigma: float = 1.1,
        resamples: int = 5,
    ):
        self.num_levels = num_levels
        self.pyr_scale = pyr_scale
        self.winsize = winsize
        self.num_iters = num_iters
        self.poly_n = poly_n
        self.poly_sigma = poly_sigma
        self.resamples = resamples

    def as_dict(self):
        return {k: getattr(self, k) for k in _PARAM_NAMES}

    def __eq__(self, other):
        return isinstance(other, FarnebackParams) and self.as_dict() == other.as_dict()


@functools.lru_cache(maxsize=None)
def _poly_kernels(poly_n: int, poly_sigma: float):
    """1D applicability kernels and the inverse moment matrix G⁻¹, in
    float64 exactly as the reference derives them."""
    n = poly_n
    u = np.arange(-n, n + 1, dtype=np.float64)
    a = np.exp(-(u**2) / (2.0 * poly_sigma**2))
    a /= a.sum()
    ax, ay = np.meshgrid(u, u)
    w2 = np.outer(a, a)
    basis = np.stack(
        [np.ones_like(ax), ax, ay, ax**2, ay**2, ax * ay], axis=0
    ).reshape(6, -1)
    g = (basis * w2.reshape(1, -1)) @ basis.T
    return a, u * a, u**2 * a, np.linalg.inv(g)


def _f32(values):
    """Python floats holding the float32 roundings of ``values``."""
    return [float(v) for v in np.asarray(values, dtype=np.float32).ravel()]


def _sepconv(img, taps, axis):
    """Correlate (..., H, W) along ``axis`` (-1 or -2) with 1D ``taps``
    (float32 values), edge-replicated; a fixed-order sum of shifted taps."""
    r = len(taps) // 2
    n = img.shape[axis]
    idx = torch.arange(-r, n + r, device=img.device).clamp(0, n - 1)
    padded = img.index_select(axis, idx)
    acc = None
    for t, k in enumerate(taps):
        term = padded.narrow(axis, t, n) * k
        acc = term if acc is None else acc + term
    return acc


def _poly_moments(img, g, xg, xxg, inv_g):
    """Quadratic expansion coefficients of (..., H, W) frames as
    (..., 6, H, W): (c, bx, by, axx, ayy, axy)."""
    gy = _sepconv(img, g, -2)
    yg = _sepconv(img, xg, -2)
    yyg = _sepconv(img, xxg, -2)
    s = [
        _sepconv(gy, g, -1),
        _sepconv(gy, xg, -1),
        _sepconv(yg, g, -1),
        _sepconv(gy, xxg, -1),
        _sepconv(yyg, g, -1),
        _sepconv(yg, xg, -1),
    ]
    out = []
    for i in range(6):
        acc = s[0] * inv_g[i][0]
        for j in range(1, 6):
            acc = acc + s[j] * inv_g[i][j]
        out.append(acc)
    return torch.stack(out, dim=-3)


def poly_exp(img, poly_n=5, poly_sigma=1.1):
    """Quadratic polynomial expansion of (..., H, W) frames.  Returns
    (b, A) in the reference's layout: b (..., H, W, 2) = (bx, by), A
    (..., H, W, 3) = (axx, ayy, axy)."""
    g, xg, xxg, inv_g = _poly_kernels(poly_n, poly_sigma)
    r = _poly_moments(
        img, _f32(g), _f32(xg), _f32(xxg),
        np.asarray(inv_g, np.float32).astype(np.float64).tolist(),
    )
    r = torch.movedim(r, -3, -1)
    return r[..., 1:3], r[..., 3:6]


def _box_blur(img, winsize):
    """Separable box filter with edge replication (cv2 box aggregation),
    by cumulative sums along each axis, as in the reference."""
    r = winsize // 2

    def box1d(a, axis):
        n = a.shape[axis]
        idx = torch.arange(-r, n + r, device=a.device).clamp(0, n - 1)
        # float64 running sums, each rounded to float32 (the CPU's float32
        # cumsum; the card's float32 scan would round its partial sums)
        c = torch.cumsum(a.index_select(axis, idx), dim=axis, dtype=torch.float64)
        c = c.to(a.dtype)
        zero_shape = list(c.shape)
        zero_shape[axis] = 1
        c = torch.cat([c.new_zeros(zero_shape), c], dim=axis)
        # ``/ winsize`` as XLA compiles it: a multiply by the reciprocal
        return (c.narrow(axis, winsize, n) - c.narrow(axis, 0, n)) * (1.0 / winsize)

    return box1d(box1d(img, -2), -1)


@functools.lru_cache(maxsize=None)
def _resize_taps(n_in, n_out):
    """Banded form of ``jax.image.resize``'s linear weight matrix (triangle
    kernel, antialiased when downsampling), computed in float32 with the
    same steps: returns (first input index per output (n_out,), weights
    (L, n_out)) so that ``out[i] = Σ_l w[l, i] · x[start[i] + l]``."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0), f32(1) - np.abs(x)).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    eps_ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(eps_ok, weights / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    weights = np.where(inside[None, :], weights, f32(0)).astype(f32)
    nz = weights != 0
    first = np.where(nz.any(axis=0), nz.argmax(axis=0), 0)
    last = np.where(nz.any(axis=0), n_in - 1 - nz[::-1].argmax(axis=0), 0)
    n_taps = int((last - first).max()) + 1
    start = np.minimum(first, n_in - n_taps)
    taps = np.stack(
        [weights[start + l, np.arange(n_out)] for l in range(n_taps)]
    ).astype(f32)
    return start, taps


def _resize_axis(x, n_out, axis):
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    start, taps = _resize_taps(n_in, n_out)
    start = torch.as_tensor(start, device=x.device)
    taps = torch.as_tensor(taps, device=x.device)
    view = [1] * x.ndim
    view[axis] = n_out
    acc = None
    for l in range(taps.shape[0]):
        term = x.index_select(axis, start + l) * taps[l].view(view)
        acc = term if acc is None else acc + term
    return acc


def resize_linear(x, shape, dims=(-2, -1)):
    """``jax.image.resize(x, ..., method="linear")`` over the axes ``dims``
    (antialiased triangle filter when downsampling, plain linear
    interpolation when upsampling; an axis of unchanged size is left as
    it is)."""
    for d, n in zip(dims, shape):
        x = _resize_axis(x, int(n), d)
    return x


def _gauss_taps(sigma):
    r = max(1, int(math.ceil(sigma * 3.0)))
    u = np.arange(-r, r + 1)
    k = np.exp(-(u**2) / (2 * sigma**2))
    k /= k.sum()
    return _f32(k)


def _gauss_blur(img, sigma):
    if sigma <= 0:
        return img
    k = _gauss_taps(sigma)
    return _sepconv(_sepconv(img, k, -2), k, -1)


def _solve(b1, a1, samp, flow, winsize):
    """Window-aggregated least-squares displacement: b1 (B, 2, H, W), a1
    (B, 3, H, W), samp the warped target expansion (B, 5, H, W) and flow
    (B, H, W, 2); returns the new (B, H, W, 2) flow."""
    axx = 0.5 * (a1[:, 0] + samp[:, 2])
    ayy = 0.5 * (a1[:, 1] + samp[:, 3])
    axy = 0.25 * (a1[:, 2] + samp[:, 4])  # off-diagonal of A
    dbx = -0.5 * (samp[:, 0] - b1[:, 0])
    dby = -0.5 * (samp[:, 1] - b1[:, 1])
    dbx = dbx + axx * flow[..., 0] + axy * flow[..., 1]
    dby = dby + axy * flow[..., 0] + ayy * flow[..., 1]
    g11 = _box_blur(axx * axx + axy * axy, winsize)
    g12 = _box_blur(axx * axy + axy * ayy, winsize)
    g22 = _box_blur(axy * axy + ayy * ayy, winsize)
    h1 = _box_blur(axx * dbx + axy * dby, winsize)
    h2 = _box_blur(axy * dbx + ayy * dby, winsize)
    # Tikhonov-regularised inverse, as OpenCV's FarnebackUpdateFlow_blur
    inv_det = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    dx = (g22 * h1 - g12 * h2) * inv_det
    dy = (g11 * h2 - g12 * h1) * inv_det
    return torch.stack([dx, dy], dim=-1)


def _update_flow(b1, a1, r2, flow, winsize, num_iters, resamples):
    """Refinement at one pyramid level.  ``r2`` (B, 5, H, W) is the target
    expansion (bx, by, axx, ayy, axy).  It is pre-shifted once by the
    rounded incoming flow (band ±min(20, max(h, w)//2 + 1)); each round
    then re-warps the residual within ±6 px and solves."""
    h, w = b1.shape[-2:]
    radius = int(min(20, max(h, w) // 2 + 1))
    res_radius = min(6, radius)
    base_int = torch.round(flow)
    stack0 = warp_banded_multi(r2, base_int[:, None], radius=radius, method="nearest")
    for _ in range(max(1, min(resamples, num_iters))):
        samp = warp_banded_multi(
            stack0, (flow - base_int)[:, None], radius=res_radius, method="linear"
        )
        flow = _solve(b1, a1, samp, flow, winsize)
    return flow


class FarnebackFlow(nn.Module):
    """Dense Farneback flow from ``prev`` to ``nxt``, both (B, H, W) (or
    (H, W)) float32 in [0, 255]; returns (B, H, W, 2) flow, channel 0 = x.

    Buffers: the applicability kernels ``g``, ``xg``, ``xxg`` and ``inv_g``
    (G⁻¹), in float64 exactly as the reference derives them; the arithmetic
    uses their float32 roundings, as the reference does."""

    # the flow stage's bytes per pair-pixel (see pipeline.pair_flows): 880.33
    # in one group at 6 and 12 x 1500 x 2500 and 24 x 1024 x 1536
    BYTES_PER_PAIR_PX = 881

    def __init__(self, params: FarnebackParams | None = None):
        super().__init__()
        self.params = params if params is not None else FarnebackParams()
        g, xg, xxg, inv_g = _poly_kernels(self.params.poly_n, self.params.poly_sigma)
        self.register_buffer("g", torch.from_numpy(g.copy()))
        self.register_buffer("xg", torch.from_numpy(xg.copy()))
        self.register_buffer("xxg", torch.from_numpy(xxg.copy()))
        self.register_buffer("inv_g", torch.from_numpy(inv_g.copy()))

    def _taps(self):
        return (
            _f32(self.g.cpu().numpy()),
            _f32(self.xg.cpu().numpy()),
            _f32(self.xxg.cpu().numpy()),
            np.asarray(self.inv_g.cpu().numpy(), np.float32).astype(np.float64).tolist(),
        )

    def forward(self, prev, nxt):
        p = self.params
        squeeze = prev.dim() == 2
        if squeeze:
            prev, nxt = prev[None], nxt[None]
        prev = prev.to(torch.float32)
        nxt = nxt.to(torch.float32)
        taps = self._taps()
        h, w = prev.shape[-2:]
        # limit the pyramid so the coarsest level still fits the window
        min_size = 2 * p.poly_n + 3
        levels = 0
        for k in range(p.num_levels):
            if min(h, w) * p.pyr_scale**k < min_size:
                break
            levels = k
        frames = torch.cat([prev, nxt])
        n = prev.shape[0]
        flow = None
        for k in range(levels, -1, -1):
            scale = p.pyr_scale**k
            hk = max(int(round(h * scale)), 1)
            wk = max(int(round(w * scale)), 1)
            sigma = (1.0 / scale - 1.0) * 0.5
            level = resize_linear(_gauss_blur(frames, sigma), (hk, wk))
            r = _poly_moments(level, *taps)
            b1, a1 = r[:n, 1:3], r[:n, 3:6]
            r2 = r[n:, 1:6]
            if flow is None:
                flow = torch.zeros((n, hk, wk, 2), dtype=torch.float32, device=prev.device)
            else:
                flow = resize_linear(flow, (hk, wk), dims=(-3, -2)) / p.pyr_scale
            flow = _update_flow(b1, a1, r2, flow, p.winsize, p.num_iters, p.resamples)
        return flow[0] if squeeze else flow


def from_jax_params(params_like) -> FarnebackFlow:
    """A :class:`FarnebackFlow` from the reference's ``FarnebackParams``, or
    from a dict (or any object) carrying its fields."""
    if isinstance(params_like, dict):
        values = {k: params_like[k] for k in _PARAM_NAMES if k in params_like}
    else:
        values = {k: getattr(params_like, k) for k in _PARAM_NAMES if hasattr(params_like, k)}
    return FarnebackFlow(FarnebackParams(**values))


def farneback_pair(prev, nxt, params: FarnebackParams | None = None):
    """Dense flow from ``prev`` to ``nxt``; see :class:`FarnebackFlow`."""
    return FarnebackFlow(params).to(prev.device)(prev, nxt)
