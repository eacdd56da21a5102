"""DeepFlow-style matching plus variational optical flow in PyTorch
(counterpart of ``tobac_flow_tpu/models/deepflow.py``).

Frame pairs are a batch dimension (B, H, W).  Coarse to fine over an
antialiased pyramid: the cost-volume matcher of ``models/simpleflow``
seeds the large displacements at the coarsest level; each finer level
upsamples the flow, adds a residual match against the target warped by it
(half the match radius) and relinearises the warped Horn–Schunck energy
(``models/variational.variational_refine`` with the model's ``alpha``,
``fixed_point_iters`` and ``jacobi_iters``).
"""

from __future__ import annotations

import torch
from torch import nn

from tobac_flow_tpu_torch.models.farneback import resize_linear
from tobac_flow_tpu_torch.models.simpleflow import match_level
from tobac_flow_tpu_torch.models.sparse_to_dense import pyramid_sizes, rescale_flow, values_from
from tobac_flow_tpu_torch.models.variational import variational_refine
from tobac_flow_tpu_torch.ops.banded import warp_banded

__all__ = ["DeepFlowParams", "DeepFlow", "from_jax_params"]

_PARAM_NAMES = ("num_levels", "match_radius", "match_window", "alpha", "fixed_point_iters",
                "jacobi_iters")


class DeepFlowParams:
    def __init__(self, num_levels: int = 5, match_radius: int = 3, match_window: int = 7,
                 alpha: float = 10.0, fixed_point_iters: int = 5, jacobi_iters: int = 10):
        self.num_levels = num_levels
        self.match_radius = match_radius
        self.match_window = match_window
        self.alpha = alpha
        self.fixed_point_iters = fixed_point_iters
        self.jacobi_iters = jacobi_iters

    def as_dict(self):
        return {k: getattr(self, k) for k in _PARAM_NAMES}

    def __eq__(self, other):
        return isinstance(other, DeepFlowParams) and self.as_dict() == other.as_dict()


class DeepFlow(nn.Module):
    """Dense flow from ``prev`` to ``nxt``, both (B, H, W) (or (H, W))
    float32 in [0, 255]; returns (B, H, W, 2), channel 0 = x."""

    # the flow stage's bytes per pair-pixel (see pipeline.pair_flows): 258.72
    BYTES_PER_PAIR_PX = 259

    def __init__(self, params: DeepFlowParams | None = None):
        super().__init__()
        self.params = params if params is not None else DeepFlowParams()

    def forward(self, prev, nxt):
        p = self.params
        squeeze = prev.dim() == 2
        if squeeze:
            prev, nxt = prev[None], nxt[None]
        prev = prev.to(torch.float32)
        nxt = nxt.to(torch.float32)
        h, w = prev.shape[-2:]
        flow = prev_hw = None
        for hk, wk in pyramid_sizes(h, w, p.num_levels, 4 * p.match_window):
            i1 = resize_linear(prev, (hk, wk))
            i2 = resize_linear(nxt, (hk, wk))
            if flow is None:
                flow = match_level(i1, i2, p.match_radius, p.match_window)
            else:
                flow = rescale_flow(flow, (hk, wk), (hk, wk), prev_hw)
                i2w = warp_banded(i2, flow, radius=20, method="linear", pad_mode="edge")
                flow = flow + match_level(i1, i2w, max(p.match_radius // 2, 1),
                                          p.match_window)
            flow = variational_refine(i1, i2, flow, steps=1, alpha=p.alpha,
                                      fixed_point_iters=p.fixed_point_iters,
                                      jacobi_iters=p.jacobi_iters)
            prev_hw = (hk, wk)
        return flow[0] if squeeze else flow


def from_jax_params(params_like) -> DeepFlow:
    """A :class:`DeepFlow` from the reference's ``DeepFlowParams``, or from
    a dict (or any object) carrying its fields."""
    return DeepFlow(DeepFlowParams(**values_from(params_like, _PARAM_NAMES)))
