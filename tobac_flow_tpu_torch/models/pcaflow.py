"""PCA-Flow-style low-rank global optical flow in PyTorch (counterpart of
``tobac_flow_tpu/models/pcaflow.py``).

Frame pairs are a batch dimension (B, H, W); every statistic below belongs
to one pair.

1. Sparse matches: the pyramidal grid Lucas–Kanade tracker of
   ``models/sparse_to_dense`` with its texture-confidence weights
   (normalised by each pair's largest confidence).
2. The basis: the first K×K separable 2D cosine modes.
3. The fit: ridge-regularised weighted least squares, one (K², K²)
   normal-equation solve per pair (the ridge scaled by the pair's weight
   sum), in float64, so that the card and the CPU agree (the solve
   amplifies a float32 product's rounding, whose order is the device's).
4. The reconstruction: one (H·W, K²) × (K², 2) float32 product per pair.

The products run with TF32 held off, so that the card does not round
their float32 operands to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
from torch import nn

from tobac_flow_tpu_torch.models.sparse_to_dense import grid_matches, values_from

__all__ = ["PCAFlowParams", "PCAFlow", "from_jax_params", "full_precision_matmul"]

_PARAM_NAMES = ("basis_size", "stride", "num_levels", "iters_per_level", "ridge")


class PCAFlowParams:
    def __init__(self, basis_size: int = 6, stride: int = 8, num_levels: int = 4,
                 iters_per_level: int = 8, ridge: float = 1e-2):
        self.basis_size = basis_size
        self.stride = stride
        self.num_levels = num_levels
        self.iters_per_level = iters_per_level
        self.ridge = ridge

    def as_dict(self):
        return {k: getattr(self, k) for k in _PARAM_NAMES}

    def __eq__(self, other):
        return isinstance(other, PCAFlowParams) and self.as_dict() == other.as_dict()


@functools.lru_cache(maxsize=None)
def _dct_basis(n_points, k):
    """(n_points, k) 1D cosine modes sampled at n_points grid positions."""
    x = (np.arange(n_points) + 0.5) / n_points
    modes = [np.ones(n_points)]
    for m in range(1, k):
        modes.append(math.sqrt(2.0) * np.cos(math.pi * m * x))
    return np.stack(modes, axis=-1).astype(np.float32)


def _basis_2d(h, w, k, device):
    """(h·w, k·k) separable cosine basis, float32."""
    by = torch.from_numpy(_dct_basis(h, k)).to(device)
    bx = torch.from_numpy(_dct_basis(w, k)).to(device)
    return (by[:, None, :, None] * bx[None, :, None, :]).reshape(h * w, k * k)


@contextlib.contextmanager
def full_precision_matmul():
    """float32 matrix products in float32 on the card: TF32 held off for
    the block, restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class PCAFlow(nn.Module):
    """Dense flow from ``prev`` to ``nxt``, both (B, H, W) (or (H, W))
    float32 in [0, 255]; returns (B, H, W, 2), channel 0 = x."""

    # the flow stage's bytes per pair-pixel (see pipeline.pair_flows): 258.24
    BYTES_PER_PAIR_PX = 259

    def __init__(self, params: PCAFlowParams | None = None):
        super().__init__()
        self.params = params if params is not None else PCAFlowParams()

    def forward(self, prev, nxt):
        p = self.params
        squeeze = prev.dim() == 2
        if squeeze:
            prev, nxt = prev[None], nxt[None]
        prev = prev.to(torch.float32)
        nxt = nxt.to(torch.float32)
        b = prev.shape[0]
        h, w = prev.shape[-2:]
        grid_flow, conf, prev_hw = grid_matches(prev, nxt, p.stride, p.num_levels,
                                                p.iters_per_level)
        gh, gw = grid_flow.shape[1:3]
        k = p.basis_size
        dev = prev.device
        scale = torch.tensor([w / prev_hw[1], h / prev_hw[0]], dtype=torch.float32,
                             device=dev)
        uv = grid_flow.reshape(b, -1, 2) * scale
        top = conf.amax(dim=(1, 2), keepdim=True)
        wgt = (conf / (top + 1e-9)).reshape(b, -1, 1) + 1e-4
        basis_g = _basis_2d(gh, gw, k, dev)
        bw = (basis_g * wgt).double()  # (B, n, K²)
        eye = torch.eye(k * k, dtype=torch.float64, device=dev)
        ridge = (p.ridge * wgt.sum(dim=(1, 2), dtype=torch.float64)).view(b, 1, 1)
        with full_precision_matmul():
            # the fit in float64: the same on every device, where a float32
            # product's order is the device's and the solve amplifies it
            gram = bw.transpose(1, 2) @ basis_g.double() + ridge * eye
            rhs = bw.transpose(1, 2) @ uv.double()
            coef = torch.linalg.solve(gram, rhs).to(torch.float32)
            flow = (_basis_2d(h, w, k, dev) @ coef).reshape(b, h, w, 2)
        return flow[0] if squeeze else flow


def from_jax_params(params_like) -> PCAFlow:
    """A :class:`PCAFlow` from the reference's ``PCAFlowParams``, or from a
    dict (or any object) carrying its fields."""
    return PCAFlow(PCAFlowParams(**values_from(params_like, _PARAM_NAMES)))
