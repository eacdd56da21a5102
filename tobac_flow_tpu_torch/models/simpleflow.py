"""SimpleFlow-style local-matching optical flow in PyTorch (counterpart of
``tobac_flow_tpu/models/simpleflow.py``).

Frame pairs are a batch dimension (B, H, W).

1. Every integer displacement in a ±R window is one shift of the target
   frame (edge replicated), scored by a box-filtered SSD: a cost volume of
   (2R + 1)² maps.
2. Each pixel takes the first displacement of least cost; a parabola
   through its ±1 neighbours in each axis (the winner clamped away from
   the volume's edge) gives the sub-pixel offset, within ±0.5.
3. Coarse to fine: each level warps the target by the upsampled flow (the
   banded warp) and matches the ±R residual; a Gaussian smooths the
   result.
"""

from __future__ import annotations

import torch
from torch import nn

from tobac_flow_tpu_torch.models.farneback import _box_blur, _gauss_blur, resize_linear
from tobac_flow_tpu_torch.models.sparse_to_dense import pyramid_sizes, rescale_flow, values_from
from tobac_flow_tpu_torch.ops.banded import warp_banded

__all__ = ["SimpleFlowParams", "SimpleFlow", "from_jax_params", "match_level"]

_PARAM_NAMES = ("radius", "window", "num_levels", "sigma_flow")


class SimpleFlowParams:
    def __init__(self, radius: int = 3, window: int = 7, num_levels: int = 4,
                 sigma_flow: float = 1.5):
        self.radius = radius
        self.window = window
        self.num_levels = num_levels
        self.sigma_flow = sigma_flow

    def as_dict(self):
        return {k: getattr(self, k) for k in _PARAM_NAMES}

    def __eq__(self, other):
        return isinstance(other, SimpleFlowParams) and self.as_dict() == other.as_dict()


def _shift2(img, dy, dx):
    """``img[..., y + dy, x + dx]`` of (..., H, W) with edge replication."""
    h, w = img.shape[-2:]
    rows = (torch.arange(h, device=img.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img.index_select(-2, rows).index_select(-1, cols)


def match_level(i1, i2, radius, window):
    """Best integer displacement within ±``radius`` of (B, H, W) frames
    with a parabolic sub-pixel fit; returns (B, H, W, 2) flow (x, y)."""
    n = 2 * radius + 1
    vol = torch.empty((n * n,) + tuple(i1.shape), dtype=torch.float32, device=i1.device)
    k = 0
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            diff = i1 - _shift2(i2, dy, dx)
            vol[k] = _box_blur(diff * diff, window)
            k += 1
            del diff
    best = torch.argmin(vol, dim=0)  # the first least cost, as jnp.argmin
    by = torch.clamp(best // n, 1, n - 2)
    bx = torch.clamp(best % n, 1, n - 2)
    del best

    def sel(iy, ix):
        return torch.gather(vol, 0, (iy * n + ix)[None])[0]

    c1 = sel(by, bx)

    def para(c0, c2):
        denom = c0 - 2 * c1 + c2
        off = torch.where(denom.abs() > 1e-9, 0.5 * (c0 - c2) / denom,
                          torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    dy = (by - radius) + para(sel(by - 1, bx), sel(by + 1, bx))
    dx = (bx - radius) + para(sel(by, bx - 1), sel(by, bx + 1))
    return torch.stack([dx, dy], dim=-1)


class SimpleFlow(nn.Module):
    """Dense flow from ``prev`` to ``nxt``, both (B, H, W) (or (H, W))
    float32 in [0, 255]; returns (B, H, W, 2), channel 0 = x."""

    # the flow stage's bytes per pair-pixel (see pipeline.pair_flows): 552.78,
    # its 49-map cost volume at every level
    BYTES_PER_PAIR_PX = 553

    def __init__(self, params: SimpleFlowParams | None = None):
        super().__init__()
        self.params = params if params is not None else SimpleFlowParams()

    def forward(self, prev, nxt):
        p = self.params
        squeeze = prev.dim() == 2
        if squeeze:
            prev, nxt = prev[None], nxt[None]
        prev = prev.to(torch.float32)
        nxt = nxt.to(torch.float32)
        h, w = prev.shape[-2:]
        flow = prev_hw = None
        for hk, wk in pyramid_sizes(h, w, p.num_levels, 4 * p.window):
            i1 = resize_linear(prev, (hk, wk))
            i2 = resize_linear(nxt, (hk, wk))
            if flow is None:
                flow = torch.zeros((prev.shape[0], hk, wk, 2), dtype=torch.float32,
                                   device=prev.device)
            else:
                flow = rescale_flow(flow, (hk, wk), (hk, wk), prev_hw)
            i2w = warp_banded(i2, flow, radius=20, method="linear", pad_mode="edge")
            flow = flow + match_level(i1, i2w, p.radius, p.window)
            prev_hw = (hk, wk)
        flow = torch.stack([_gauss_blur(flow[..., 0], p.sigma_flow),
                            _gauss_blur(flow[..., 1], p.sigma_flow)], dim=-1)
        return flow[0] if squeeze else flow


def from_jax_params(params_like) -> SimpleFlow:
    """A :class:`SimpleFlow` from the reference's ``SimpleFlowParams``, or
    from a dict (or any object) carrying its fields."""
    return SimpleFlow(SimpleFlowParams(**values_from(params_like, _PARAM_NAMES)))
