"""The legacy flow engine's API (counterpart of ``tobac_flow_tpu/legacy.py``):
the old call signatures of nearest-neighbour flow convolution, the flow
Sobel, the pointer-network watershed and min-label-propagation labelling,
each adapted onto the port's :class:`~tobac_flow_tpu_torch.core.flow.Flow`
and its ops.  The flows are arrays or tensors; tensors stay on their
device, arrays go to ``device`` (CUDA unless the caller passes
``device="cpu"``), and the results are tensors there.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.core.flow import Flow
from tobac_flow_tpu_torch.ops.convolve import DEFAULT_STRUCTURE

__all__ = [
    "FlowFunc",
    "Flow_Func",
    "flow_convolve_nearest",
    "flow_sobel",
    "flow_network_watershed",
    "flow_label",
]


class FlowFunc:
    """The legacy engine's callable flow container with parabolic
    interpolation in t:

        dx(t) = t(t+1)/2 · dx_forward + t(t−1)/2 · dx_backward

    so dx(1) = forward, dx(−1) = backward and dx(0) = 0.  The four fields
    are arrays or tensors, and stay as they are given."""

    def __init__(self, flow_x_for, flow_x_back, flow_y_for, flow_y_back):
        self.flow_x_for, self.flow_x_back = _kept(flow_x_for), _kept(flow_x_back)
        self.flow_y_for, self.flow_y_back = _kept(flow_y_for), _kept(flow_y_back)
        self.shape = tuple(self.flow_x_for.shape)

    def __getitem__(self, items):
        return FlowFunc(self.flow_x_for[items], self.flow_x_back[items],
                        self.flow_y_for[items], self.flow_y_back[items])

    def __call__(self, t):
        a = 0.5 * t * (t + 1)
        b = 0.5 * t * (t - 1)
        return (a * self.flow_x_for + b * self.flow_x_back,
                a * self.flow_y_for + b * self.flow_y_back)

    @classmethod
    def from_flow(cls, flow):
        """From a :class:`Flow` (forward and backward (T, H, W, 2))."""
        return cls(flow.forward_flow[..., 0], flow.backward_flow[..., 0],
                   flow.forward_flow[..., 1], flow.backward_flow[..., 1])


Flow_Func = FlowFunc  # the reference's spelling


def _kept(a):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _flow_obj(forward_flow, backward_flow, device=None):
    """A :class:`Flow` of the two flows: tensors where they lie (unless
    ``device`` is named), arrays on ``device``."""
    if isinstance(forward_flow, torch.Tensor) and device is None:
        return Flow(forward_flow.float(), torch.as_tensor(backward_flow).to(
            forward_flow.device, torch.float32))
    return Flow.from_numpy(torch.as_tensor(forward_flow).cpu().numpy(),
                           torch.as_tensor(backward_flow).cpu().numpy(), device)


_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
           np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
           np.dtype(bool): torch.bool}


def _torch_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else _DTYPES[np.dtype(dtype)]


def flow_convolve_nearest(data, forward_flow, backward_flow, structure=None, fill_value=0,
                          dtype=np.int32, device=None):
    """The nearest-neighbour flow convolution: the stacked taps (n_taps,
    T, H, W) of ``structure`` (connectivity 1 by default)."""
    flow = _flow_obj(forward_flow, backward_flow, device)
    return flow.convolve(flow.tensor(data), structure=DEFAULT_STRUCTURE if structure is None
                         else structure, method="nearest", fill_value=fill_value,
                         dtype=_torch_dtype(dtype))


def flow_sobel(data, forward_flow, backward_flow, direction=None, device=None, **kwargs):
    """The flow-warped Sobel magnitude (see ``ops.sobel``)."""
    return _flow_obj(forward_flow, backward_flow, device).sobel(data, direction=direction,
                                                                **kwargs)


def flow_network_watershed(field, markers, forward_flow, backward_flow, mask=None,
                           structure=None, max_iter=100, device=None, **kwargs):
    """The iterative pointer-network watershed: each pixel adopts the label
    of its lowest flow-warped neighbour until a fixed point, which is the
    flood ``ops.watershed`` runs (at most ``4 · max_iter`` rounds)."""
    del kwargs
    return _flow_obj(forward_flow, backward_flow, device).watershed(
        field, markers, mask=mask, connectivity=1 if structure is None else structure,
        max_iters=max_iter * 4)


def flow_label(mask, forward_flow, backward_flow, structure=None, device=None, **kwargs):
    """Min-label-propagation flow labelling (see ``segment.label``)."""
    from tobac_flow_tpu_torch.segment.label import flow_label as _flow_label

    return _flow_label(_flow_obj(forward_flow, backward_flow, device), mask,
                       structure=DEFAULT_STRUCTURE if structure is None else structure,
                       **kwargs)
