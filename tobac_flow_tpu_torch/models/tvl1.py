"""TV-L1 dense optical flow (Zach, Pock and Bischof's duality scheme) in
PyTorch (counterpart of ``tobac_flow_tpu/models/tvl1.py``).

Frame pairs are a batch dimension (B, H, W).  Per pyramid level and warp:
the target is warped by the current flow (the banded warp, edge
replicated) and the residual linearised there; then ``inner_iters``
primal-dual iterations: the L1 proximal thresholding step, the primal
update by the divergence of the dual, and the dual ascent by the flow's
forward differences, projected onto the unit ball.  Intensities work on
[0, 1].
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tobac_flow_tpu_torch.models.farneback import resize_linear
from tobac_flow_tpu_torch.models.sparse_to_dense import pyramid_sizes, rescale_flow, values_from
from tobac_flow_tpu_torch.ops.banded import warp_banded
from tobac_flow_tpu_torch.ops.warp import sqrt32

__all__ = ["TVL1Params", "TVL1Flow", "from_jax_params"]

_PARAM_NAMES = ("tau", "lambda_", "theta", "num_levels", "warps", "inner_iters")


class TVL1Params:
    def __init__(self, tau: float = 0.25, lambda_: float = 0.5, theta: float = 0.3,
                 num_levels: int = 5, warps: int = 8, inner_iters: int = 50):
        self.tau = tau
        self.lambda_ = lambda_
        self.theta = theta
        self.num_levels = num_levels
        self.warps = warps
        self.inner_iters = inner_iters

    def as_dict(self):
        return {k: getattr(self, k) for k in _PARAM_NAMES}

    def __eq__(self, other):
        return isinstance(other, TVL1Params) and self.as_dict() == other.as_dict()


def _grad(img):
    """Forward differences of (..., H, W), zero on the last column/row."""
    gx = torch.cat([img[..., 1:] - img[..., :-1], torch.zeros_like(img[..., :1])], -1)
    gy = torch.cat([img[..., 1:, :] - img[..., :-1, :], torch.zeros_like(img[..., :1, :])], -2)
    return gx, gy


def _div(px, py):
    """The divergence adjoint to :func:`_grad`."""
    dx = torch.cat([px[..., :1], px[..., 1:-1] - px[..., :-2], -px[..., -2:-1]], -1)
    dy = torch.cat([py[..., :1, :], py[..., 1:-1, :] - py[..., :-2, :], -py[..., -2:-1, :]], -2)
    return dx + dy


def _project(a, b):
    """(a, b) / max(1, |(a, b)|), the root correctly rounded."""
    scale = torch.clamp(sqrt32(a * a + b * b), min=1.0)
    return a / scale, b / scale


def _tvl1_level(i1, i2, flow, p, radius):
    lam_theta = float(np.float32(p.lambda_ * p.theta))
    tau_theta = float(np.float32(p.tau / p.theta))
    theta = float(np.float32(p.theta))
    for _ in range(int(p.warps)):
        u0x, u0y = flow[..., 0], flow[..., 1]
        warped = warp_banded(i2, flow, radius=radius, method="linear", pad_mode="edge")
        ix, iy = _grad(warped)
        grad2 = ix * ix + iy * iy + 1e-7
        rho0 = warped - i1 - (ix * u0x + iy * u0y)
        lo_t = -lam_theta * grad2
        hi_t = lam_theta * grad2
        ux, uy = u0x, u0y
        p00 = p01 = p10 = p11 = torch.zeros_like(i1)
        for _ in range(int(p.inner_iters)):
            rho = rho0 + ix * ux + iy * uy
            lo = rho < lo_t
            hi = rho > hi_t
            vx = ux + torch.where(lo, lam_theta * ix,
                                  torch.where(hi, -lam_theta * ix, -rho * ix / grad2))
            vy = uy + torch.where(lo, lam_theta * iy,
                                  torch.where(hi, -lam_theta * iy, -rho * iy / grad2))
            ux = vx + theta * _div(p00, p01)
            uy = vy + theta * _div(p10, p11)
            gxu, gyu = _grad(ux)
            gxv, gyv = _grad(uy)
            p00, p01 = _project(p00 + tau_theta * gxu, p01 + tau_theta * gyu)
            p10, p11 = _project(p10 + tau_theta * gxv, p11 + tau_theta * gyv)
        flow = torch.stack([ux, uy], dim=-1)
    return flow


class TVL1Flow(nn.Module):
    """Dense flow from ``prev`` to ``nxt``, both (B, H, W) (or (H, W))
    float32 in [0, 255]; returns (B, H, W, 2), channel 0 = x."""

    # the flow stage's bytes per pair-pixel (see pipeline.pair_flows): 351.15
    BYTES_PER_PAIR_PX = 352

    def __init__(self, params: TVL1Params | None = None):
        super().__init__()
        self.params = params if params is not None else TVL1Params()

    def forward(self, prev, nxt):
        p = self.params
        squeeze = prev.dim() == 2
        if squeeze:
            prev, nxt = prev[None], nxt[None]
        # ``/ 255`` as XLA compiles it: a multiply by the float32 reciprocal
        inv = float(np.float32(1.0) / np.float32(255.0))
        prev = prev.to(torch.float32) * inv
        nxt = nxt.to(torch.float32) * inv
        h, w = prev.shape[-2:]
        flow = prev_hw = None
        for hk, wk in pyramid_sizes(h, w, p.num_levels, 16):
            i1 = resize_linear(prev, (hk, wk))
            i2 = resize_linear(nxt, (hk, wk))
            if flow is None:
                flow = torch.zeros((prev.shape[0], hk, wk, 2), dtype=torch.float32,
                                   device=prev.device)
            else:
                flow = rescale_flow(flow, (hk, wk), (hk, wk), prev_hw)
            radius = int(min(16, max(hk, wk) // 4 + 2))
            flow = _tvl1_level(i1, i2, flow, p, radius)
            prev_hw = (hk, wk)
        return flow[0] if squeeze else flow


def from_jax_params(params_like) -> TVL1Flow:
    """A :class:`TVL1Flow` from the reference's ``TVL1Params``, or from a
    dict (or any object) carrying its fields."""
    return TVL1Flow(TVL1Params(**values_from(params_like, _PARAM_NAMES)))
