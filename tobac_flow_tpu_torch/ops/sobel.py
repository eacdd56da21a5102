"""Semi-Lagrangian 3D Sobel edge magnitude (counterpart of
``tobac_flow_tpu/ops/sobel.py``).

The 27 flow-warped taps of the full (3, 3, 3) neighbourhood, less the
centre pixel, are weighted by the three axis-permuted Sobel kernels.  NaN
taps contribute zero; the ``uphill`` and ``downhill`` variants keep only
taps above (below) the centre.  Each gradient is the reference's
sequential sum in tap order (its weights are 0, ±1, ±2 and ±4, so every
product is exact), and the magnitude rounds as the reference's compiled
program does: ``sqrt(fma(gt, gt, fma(gx, gx, gy * gy)))``, the root
correctly rounded.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tobac_flow_tpu_torch.ops.convolve import convolve
from tobac_flow_tpu_torch.ops.warp import fma

__all__ = ["sobel", "sobel_magnitude"]

_FULL_STRUCTURE = np.ones((3, 3, 3), dtype=bool)
_BASE = np.multiply.outer(
    np.array([1, 2, 1]), np.multiply.outer(np.array([1, 2, 1]), np.array([-1, 0, 1]))
)
# (t, y, x) weights of the derivative along x, y and t, in tap order
_WEIGHTS = tuple(w.ravel() for w in (_BASE, _BASE.transpose(0, 2, 1), _BASE.transpose(2, 0, 1)))
_RECTIFY = {
    None: lambda d: d,
    "uphill": lambda d: torch.fmax(d, torch.zeros((), dtype=d.dtype, device=d.device)),
    "downhill": lambda d: torch.fmin(d, torch.zeros((), dtype=d.dtype, device=d.device)),
}


def sobel_magnitude(taps, centre, direction=None):
    """Sobel magnitude of 27 taps (each (T, H, W), in structure order)
    around ``centre``: each tap less the centre, rectified by ``direction``,
    NaN as 0."""
    rectify = _RECTIFY[direction]
    grads = [torch.zeros_like(centre) for _ in range(3)]
    for k, tap in enumerate(taps):
        d = rectify(tap - centre)
        d = torch.where(torch.isnan(d), 0.0, d)
        for g, wts in zip(grads, _WEIGHTS):
            if wts[k]:
                g.add_(float(wts[k]) * d)
    gx, gy, gt = grads
    # the square root of a float32 taken in float64 and rounded once is the
    # correctly rounded float32 root (torch's vectorised float32 root on
    # the CPU is not always)
    return torch.sqrt(fma(gt, gt, fma(gx, gx, gy * gy)).to(torch.float64)).to(torch.float32)


def sobel(data, forward_flow, backward_flow, method="linear", dtype=torch.float32,
          fill_value=math.nan, direction=None):
    """Sobel edge magnitude in the moving frame; ``direction`` is None
    (signed taps), "uphill" or "downhill".  NaN data pixels give
    ``fill_value``."""
    if direction not in _RECTIFY:
        raise ValueError("direction must be None, 'uphill' or 'downhill'")
    return convolve(
        data, forward_flow, backward_flow, structure=_FULL_STRUCTURE, method=method,
        dtype=torch.float32 if dtype is None else dtype, fill_value=fill_value,
        func=lambda taps: sobel_magnitude(taps, taps[13], direction),
    )
