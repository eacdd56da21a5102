"""DIS-style dense inverse-search optical flow in PyTorch (counterpart of
``tobac_flow_tpu/models/dis.py``).

Frame pairs are a batch dimension (B, H, W).

1. The frame is tiled into non-overlapping patches, each carrying one
   displacement, refined by inverse-compositional Lucas–Kanade with the
   template's gradients and patch Hessian from the first frame.
2. Each iteration resamples the target frame once, by the banded warp of
   the whole frame by the piecewise-constant patch flow; the patch
   residual sums then reduce by reshape (in float64, rounded once, so
   that the card and the CPU agree: where a patch sees little texture the
   solve amplifies a sum's last bit into pixels).  Each update is clipped
   to ±patch size.
3. A pyramid supplies large displacements; the patch flow densifies by an
   antialiased linear resize and one variational refinement pass
   (``models/variational``) smooths it.
"""

from __future__ import annotations

import torch
from torch import nn

from tobac_flow_tpu_torch.models.farneback import resize_linear
from tobac_flow_tpu_torch.models.sparse_to_dense import (
    pyramid_sizes, repeat_grid, rescale_flow, values_from,
)
from tobac_flow_tpu_torch.models.variational import _grad, variational_refine
from tobac_flow_tpu_torch.ops.banded import warp_banded

__all__ = ["DISParams", "DISFlow", "from_jax_params"]

_PARAM_NAMES = ("patch_size", "num_levels", "iters_per_level", "refine_steps")


class DISParams:
    def __init__(self, patch_size: int = 8, num_levels: int = 4, iters_per_level: int = 6,
                 refine_steps: int = 1):
        self.patch_size = patch_size
        self.num_levels = num_levels
        self.iters_per_level = iters_per_level
        self.refine_steps = refine_steps

    def as_dict(self):
        return {k: getattr(self, k) for k in _PARAM_NAMES}

    def __eq__(self, other):
        return isinstance(other, DISParams) and self.as_dict() == other.as_dict()


def _patch_sum(field, ps):
    """Sum over each ps×ps patch of (B, H, W), taken in float64 and
    rounded once: the same on every device, where a float32 sum's order
    (and so its rounding) is the device's."""
    b, h, w = field.shape
    return field.reshape(b, h // ps, ps, w // ps, ps).sum(
        dim=(2, 4), dtype=torch.float64).to(field.dtype)


def _level_flow(i1, i2, patch_flow, ps, iters, radius):
    """Per-patch displacements (B, gh, gw, 2) refined at one level."""
    gx, gy = _grad(i1)
    hxx = _patch_sum(gx * gx, ps) + 1e-3
    hxy = _patch_sum(gx * gy, ps)
    hyy = _patch_sum(gy * gy, ps) + 1e-3
    det = hxx * hyy - hxy * hxy
    inv_det = torch.where(det.abs() > 1e-9, 1.0 / det, torch.zeros_like(det))
    u = patch_flow
    for _ in range(int(iters)):
        disp = repeat_grid(u, ps)
        i2w = warp_banded(i2, disp, radius=radius, method="linear", pad_mode="edge")
        r = i2w - i1
        jr_x = _patch_sum(gx * r, ps)
        jr_y = _patch_sum(gy * r, ps)
        dux = (hyy * jr_x - hxy * jr_y) * inv_det
        duy = (hxx * jr_y - hxy * jr_x) * inv_det
        u = u - torch.clamp(torch.stack([dux, duy], dim=-1), -float(ps), float(ps))
    return u


class DISFlow(nn.Module):
    """Dense flow from ``prev`` to ``nxt``, both (B, H, W) (or (H, W))
    float32 in [0, 255]; returns (B, H, W, 2), channel 0 = x."""

    # the flow stage's bytes per pair-pixel (see pipeline.pair_flows): 258.72
    BYTES_PER_PAIR_PX = 259

    def __init__(self, params: DISParams | None = None):
        super().__init__()
        self.params = params if params is not None else DISParams()

    def forward(self, prev, nxt):
        p = self.params
        ps = p.patch_size
        squeeze = prev.dim() == 2
        if squeeze:
            prev, nxt = prev[None], nxt[None]
        prev = prev.to(torch.float32)
        nxt = nxt.to(torch.float32)
        h, w = prev.shape[-2:]
        patch_flow = prev_hw = None
        for hk, wk in pyramid_sizes(h, w, p.num_levels, 4 * ps, multiple=ps):
            i1 = resize_linear(prev, (hk, wk))
            i2 = resize_linear(nxt, (hk, wk))
            if patch_flow is None:
                patch_flow = torch.zeros((prev.shape[0], hk // ps, wk // ps, 2),
                                         dtype=torch.float32, device=prev.device)
            else:
                patch_flow = rescale_flow(patch_flow, (hk // ps, wk // ps), (hk, wk), prev_hw)
            radius = int(min(20, max(hk, wk) // 4 + 2))
            patch_flow = _level_flow(i1, i2, patch_flow, ps, p.iters_per_level, radius)
            prev_hw = (hk, wk)
        flow = rescale_flow(patch_flow, (h, w), (h, w), prev_hw)
        if p.refine_steps > 0:
            flow = variational_refine(prev, nxt, flow, steps=p.refine_steps)
        return flow[0] if squeeze else flow


def from_jax_params(params_like) -> DISFlow:
    """A :class:`DISFlow` from the reference's ``DISParams``, or from a
    dict (or any object) carrying its fields."""
    return DISFlow(DISParams(**values_from(params_like, _PARAM_NAMES)))
