"""Variational refinement of a dense flow field (counterpart of
``tobac_flow_tpu/models/variational.py``).

A warped Horn–Schunck energy (brightness constancy linearised at the
current flow, plus quadratic smoothness) minimised by fixed-point
relinearisation with inner Jacobi sweeps.  Frame pairs are a batch
dimension.
"""

from __future__ import annotations

import torch

from tobac_flow_tpu_torch.ops.banded import warp_banded

__all__ = ["variational_refine"]


def _neighbor_avg(f):
    """4-neighbour average with edge replication of (..., H, W, C)."""
    up = torch.cat([f[..., :1, :, :], f[..., :-1, :, :]], dim=-3)
    dn = torch.cat([f[..., 1:, :, :], f[..., -1:, :, :]], dim=-3)
    lf = torch.cat([f[..., :1, :], f[..., :-1, :]], dim=-2)
    rt = torch.cat([f[..., 1:, :], f[..., -1:, :]], dim=-2)
    return 0.25 * (up + dn + lf + rt)


def _grad(img):
    """Central-difference gradients of (..., H, W) with edge replication."""
    gx = 0.5 * (torch.cat([img[..., 1:], img[..., -1:]], dim=-1)
                - torch.cat([img[..., :1], img[..., :-1]], dim=-1))
    gy = 0.5 * (torch.cat([img[..., 1:, :], img[..., -1:, :]], dim=-2)
                - torch.cat([img[..., :1, :], img[..., :-1, :]], dim=-2))
    return gx, gy


def variational_refine(i1, i2, flow, steps: int = 1, alpha: float = 20.0,
                       fixed_point_iters: int = 5, jacobi_iters: int = 10):
    """Refine ``flow`` (..., H, W, 2) mapping ``i1`` to ``i2`` (..., H, W,
    0..255 scale): ``steps`` × ``fixed_point_iters`` relinearisations, each
    followed by ``jacobi_iters`` Jacobi sweeps.  Returns the refined flow."""
    for _ in range(int(steps) * int(fixed_point_iters)):
        u0, v0 = flow[..., 0], flow[..., 1]
        i2w = warp_banded(i2, flow, radius=20, method="linear", pad_mode="edge")
        r = i2w - i1
        ix, iy = _grad(i2w)
        denom = alpha + ix * ix + iy * iy
        for _ in range(int(jacobi_iters)):
            bar = _neighbor_avg(flow)
            ub, vb = bar[..., 0], bar[..., 1]
            t = (ix * (ub - u0) + iy * (vb - v0) + r) / denom
            flow = torch.stack([ub - ix * t, vb - iy * t], dim=-1)
    return flow
