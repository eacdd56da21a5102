"""SparseToDense optical flow, grid Lucas–Kanade plus densification, in
PyTorch (counterpart of ``tobac_flow_tpu/models/sparse_to_dense.py``).

Frame pairs are a batch dimension (B, H, W).

1. Tracks sit on a regular grid of ``stride``-pixel windows.  Each
   iteration warps the target frame once by the piecewise-constant grid
   flow (the banded warp, edge replicated), pools the residual against the
   window's gradients and solves the window's 2×2 Lucas–Kanade normal
   equations (forward additive, each step clipped to ±stride).
2. A pyramid (antialiased linear resize) supplies large displacements.
3. Densification is confidence-weighted: the grid flow and the structure
   tensor's smaller eigenvalue are upsampled, the products diffused by a
   Gaussian and normalised.
"""

from __future__ import annotations

import torch
from torch import nn

from tobac_flow_tpu_torch.models.farneback import _gauss_blur, resize_linear
from tobac_flow_tpu_torch.models.variational import _grad
from tobac_flow_tpu_torch.ops.banded import warp_banded
from tobac_flow_tpu_torch.ops.warp import sqrt32

__all__ = ["SparseToDenseParams", "SparseToDenseFlow", "from_jax_params"]

_PARAM_NAMES = ("stride", "num_levels", "iters_per_level", "sigma_densify")


class SparseToDenseParams:
    def __init__(self, stride: int = 8, num_levels: int = 4, iters_per_level: int = 8,
                 sigma_densify: float = 2.0):
        self.stride = stride
        self.num_levels = num_levels
        self.iters_per_level = iters_per_level
        self.sigma_densify = sigma_densify

    def as_dict(self):
        return {k: getattr(self, k) for k in _PARAM_NAMES}

    def __eq__(self, other):
        return isinstance(other, SparseToDenseParams) and self.as_dict() == other.as_dict()


def values_from(params_like, names):
    """The fields ``names`` of a reference params object or a dict."""
    if isinstance(params_like, dict):
        return {k: params_like[k] for k in names if k in params_like}
    return {k: getattr(params_like, k) for k in names if hasattr(params_like, k)}


def pyramid_sizes(h, w, num_levels, min_size, multiple=None, floor=8):
    """The reference's pyramid: levels while ``min(h, w) / 2**k`` holds
    ``min_size``, coarsest first; each level's size rounded down to a
    multiple of ``multiple`` (at least one) or held at ``floor``."""
    levels = 0
    for k in range(num_levels):
        if min(h, w) // (2**k) >= min_size:
            levels = k
    if multiple:
        return [(max(h // 2**k // multiple * multiple, multiple),
                 max(w // 2**k // multiple * multiple, multiple)) for k in range(levels, -1, -1)]
    return [(max(h // 2**k, floor), max(w // 2**k, floor)) for k in range(levels, -1, -1)]


def rescale_flow(flow, size, frame, prev_frame):
    """A (B, h, w, 2) flow resized to ``size`` and scaled by the ratio of
    the frame sizes ``frame`` over ``prev_frame`` (x by the widths', y by
    the heights')."""
    scale = torch.tensor([frame[1] / prev_frame[1], frame[0] / prev_frame[0]],
                         dtype=torch.float32, device=flow.device)
    return resize_linear(flow, size, dims=(-3, -2)) * scale


def repeat_grid(u, s):
    """Each grid cell of (B, gh, gw, C) repeated over its s×s pixels."""
    return u.repeat_interleave(s, dim=-3).repeat_interleave(s, dim=-2)


def _pool(field, s):
    """Mean over each s×s window of (B, H, W), summed in float64 and
    rounded once (the same on every device)."""
    b, h, w = field.shape
    return field.reshape(b, h // s, s, w // s, s).sum(
        dim=(2, 4), dtype=torch.float64).div(s * s).to(field.dtype)


def grid_lk(i1, i2, grid_flow, stride, iters, radius):
    """Forward-additive Lucas–Kanade on a stride-spaced grid of (B, H, W)
    frames; returns the grid flow (B, gh, gw, 2) and its confidence, the
    structure tensor's smaller eigenvalue (B, gh, gw)."""
    gx, gy = _grad(i1)
    jxx = _pool(gx * gx, stride) + 1e-4
    jxy = _pool(gx * gy, stride)
    jyy = _pool(gy * gy, stride) + 1e-4
    det = jxx * jyy - jxy * jxy
    inv_det = torch.where(det.abs() > 1e-9, 1.0 / det, torch.zeros_like(det))
    tr = 0.5 * (jxx + jyy)
    disc = sqrt32(torch.clamp(tr * tr - det, min=0.0))
    conf = torch.clamp(tr - disc, min=0.0)
    u = grid_flow
    for _ in range(int(iters)):
        dense = repeat_grid(u, stride)
        i2w = warp_banded(i2, dense, radius=radius, method="linear", pad_mode="edge")
        r = i2w - i1
        bx = _pool(gx * r, stride)
        by = _pool(gy * r, stride)
        du = (jyy * bx - jxy * by) * inv_det
        dv = (jxx * by - jxy * bx) * inv_det
        u = u - torch.clamp(torch.stack([du, dv], dim=-1), -float(stride), float(stride))
    return u, conf


def grid_matches(prev, nxt, stride, num_levels, iters_per_level):
    """Pyramidal grid Lucas–Kanade of (B, H, W) frames: the finest level's
    grid flow, confidence and size."""
    h, w = prev.shape[-2:]
    grid_flow = conf = prev_hw = None
    for hk, wk in pyramid_sizes(h, w, num_levels, 4 * stride, multiple=stride):
        i1 = resize_linear(prev, (hk, wk))
        i2 = resize_linear(nxt, (hk, wk))
        if grid_flow is None:
            grid_flow = torch.zeros((prev.shape[0], hk // stride, wk // stride, 2),
                                    dtype=torch.float32, device=prev.device)
        else:
            grid_flow = rescale_flow(grid_flow, (hk // stride, wk // stride), (hk, wk),
                                     prev_hw)
        radius = int(min(20, max(hk, wk) // 4 + 2))
        grid_flow, conf = grid_lk(i1, i2, grid_flow, stride, iters_per_level, radius)
        prev_hw = (hk, wk)
    return grid_flow, conf, prev_hw


class SparseToDenseFlow(nn.Module):
    """Dense flow from ``prev`` to ``nxt``, both (B, H, W) (or (H, W))
    float32 in [0, 255]; returns (B, H, W, 2), channel 0 = x."""

    # the flow stage's bytes per pair-pixel (see pipeline.pair_flows): 258.72
    BYTES_PER_PAIR_PX = 259

    def __init__(self, params: SparseToDenseParams | None = None):
        super().__init__()
        self.params = params if params is not None else SparseToDenseParams()

    def forward(self, prev, nxt):
        p = self.params
        squeeze = prev.dim() == 2
        if squeeze:
            prev, nxt = prev[None], nxt[None]
        prev = prev.to(torch.float32)
        nxt = nxt.to(torch.float32)
        h, w = prev.shape[-2:]
        grid_flow, conf, prev_hw = grid_matches(prev, nxt, p.stride, p.num_levels,
                                                p.iters_per_level)
        sx = float(torch.tensor(w / prev_hw[1], dtype=torch.float32))
        sy = float(torch.tensor(h / prev_hw[0], dtype=torch.float32))
        u = resize_linear(grid_flow[..., 0], (h, w)) * sx
        v = resize_linear(grid_flow[..., 1], (h, w)) * sy
        wgt = resize_linear(conf, (h, w)) + 1e-6
        num_u = _gauss_blur(wgt * u, p.sigma_densify)
        num_v = _gauss_blur(wgt * v, p.sigma_densify)
        den = _gauss_blur(wgt, p.sigma_densify)
        flow = torch.stack([num_u / den, num_v / den], dim=-1)
        return flow[0] if squeeze else flow


def from_jax_params(params_like) -> SparseToDenseFlow:
    """A :class:`SparseToDenseFlow` from the reference's
    ``SparseToDenseParams``, or from a dict (or any object) carrying its
    fields."""
    return SparseToDenseFlow(SparseToDenseParams(**values_from(params_like, _PARAM_NAMES)))
