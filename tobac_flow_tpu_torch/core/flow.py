"""The Flow object (counterpart of ``tobac_flow_tpu/core/flow.py``): forward
and backward optical-flow fields on one device, and every semi-Lagrangian
operation of the detection chain over them.

``create_flow`` estimates the flows on ``device`` (CUDA unless the caller
passes ``device="cpu"``); ``Flow.from_numpy`` carries flows computed
elsewhere (the JAX package's, say) onto a device.  Every method takes
numpy arrays or tensors, moves them to the flow's device and returns
tensors there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tobac_flow_tpu_torch.core.abstracts import AbstractFlow
from tobac_flow_tpu_torch.device import resolve_device
from tobac_flow_tpu_torch.ops.banded import warp_banded_multi
from tobac_flow_tpu_torch.ops.convolve import DEFAULT_STRUCTURE, convolve, diff_func
from tobac_flow_tpu_torch.ops.sobel import sobel

__all__ = ["Flow", "create_flow", "calculate_flow", "smooth_flow_step"]


def create_flow(data, model: str = "Farneback", vr_steps: int = 0,
                smoothing_passes: int = 0, interp_method: str = "linear",
                max_value: float = 20, device=None) -> "Flow":
    """Forward and backward flow of a (t, y, x) stack on ``device``, clipped
    to ±``max_value`` px, as a :class:`Flow`."""
    forward_flow, backward_flow = calculate_flow(
        data, model=model, vr_steps=vr_steps, smoothing_passes=smoothing_passes,
        interp_method=interp_method, device=device,
    )
    return Flow(forward_flow.clamp(-max_value, max_value),
                backward_flow.clamp(-max_value, max_value))


def calculate_flow(data, model: str = "Farneback", vr_steps: int = 0,
                   smoothing_passes: int = 0, interp_method: str = "linear",
                   normalisation_method: str = "linear", device=None):
    """Forward/backward flow for every frame pair of a (t, y, x) stack (see
    :func:`tobac_flow_tpu_torch.models.batch_flow`)."""
    from tobac_flow_tpu_torch.models import batch_flow

    return batch_flow(
        data, model=model, vr_steps=vr_steps, smoothing_passes=smoothing_passes,
        interp_method=interp_method, normalisation_method=normalisation_method,
        device=device,
    )


def smooth_flow_step(forward_flow, backward_flow, method="linear"):
    """One smoothing pass: each flow (..., H, W, 2) averaged with the
    negated opposite flow warped along it (two-pass warp, NaN outside the
    frame), NaN-aware."""
    if method not in ("nearest", "linear", "cubic"):
        raise NotImplementedError(
            f"interp_method={method!r}: the port's smoothing warp takes nearest, "
            "linear or cubic (the Lanczos warp is not ported)"
        )

    def _smooth(primary, opposite):
        both = warp_banded_multi(
            opposite.to(torch.float32).movedim(-1, 0), primary, radius=20, method=method,
            fill_value=math.nan, pad_mode="constant",
        )
        stacked = torch.stack([primary.to(torch.float32), -both.movedim(0, -1)])
        finite = torch.isfinite(stacked)
        cnt = finite[0].to(torch.int32) + finite[1].to(torch.int32)
        nan0 = torch.where(torch.isnan(stacked), 0.0, stacked)
        tot = nan0[0] + nan0[1]
        return torch.where(cnt > 0, tot / torch.clamp(cnt, min=1), math.nan)

    return _smooth(forward_flow, backward_flow), _smooth(backward_flow, forward_flow)


class Flow(AbstractFlow):
    """Semi-Lagrangian operations driven by dense optical flow fields."""

    def __init__(self, forward_flow, backward_flow) -> None:
        if forward_flow.shape != backward_flow.shape:
            raise ValueError("Forward and backward flow vector arrays must have the same shape")
        if forward_flow.shape[-1] != 2:
            raise ValueError("Flow vectors must have a size of 2 in the trailing dimension")
        if forward_flow.device != backward_flow.device:
            raise ValueError("Forward and backward flows must be on the same device")
        self.shape = tuple(forward_flow.shape[:-1])
        self.forward_flow = forward_flow
        self.backward_flow = backward_flow

    @classmethod
    def from_numpy(cls, forward_flow, backward_flow, device=None) -> "Flow":
        """A Flow of flows given as arrays (the JAX package's, for one),
        moved to ``device`` (see :func:`resolve_device`)."""
        dev = resolve_device(device)
        return cls(torch.from_numpy(np.array(forward_flow, np.float32)).to(dev),
                   torch.from_numpy(np.array(backward_flow, np.float32)).to(dev))

    @property
    def device(self) -> torch.device:
        return self.forward_flow.device

    @property
    def flow(self):
        return self.forward_flow, self.backward_flow

    def __getitem__(self, items) -> "Flow":
        return Flow(self.forward_flow[items], self.backward_flow[items])

    def tensor(self, data, dtype=None):
        """``data`` (array or tensor) on the flow's device."""
        return torch.as_tensor(data).to(self.device, dtype)

    def convolve(self, data, structure=DEFAULT_STRUCTURE, method="linear",
                 fill_value=math.nan, dtype=torch.float32, func=None, budget_bytes=None):
        """Flow-warped convolution of ``data`` (see ``ops.convolve``; in time
        chunks over ``budget_bytes``)."""
        data = torch.as_tensor(data)
        if tuple(data.shape) != self.shape:
            raise ValueError("Data input must have the same shape as the Flow object")
        return convolve(data, self.forward_flow, self.backward_flow, structure=structure,
                        method=method, dtype=dtype, fill_value=fill_value, func=func,
                        budget_bytes=budget_bytes)

    def diff(self, data, method="linear", dtype=torch.float32):
        """Semi-Lagrangian central difference along t: NaN-aware mean of the
        forward and backward one-sided differences."""
        diff_struct = np.zeros((3, 3, 3))
        diff_struct[:, 1, 1] = 1
        return self.convolve(data, structure=diff_struct, func=diff_func, method=method,
                             dtype=dtype)

    def sobel(self, data, method="linear", dtype=None, fill_value=math.nan, direction=None):
        """Semi-Lagrangian Sobel edge magnitude (see ``ops.sobel``)."""
        return sobel(self.tensor(data), self.forward_flow, self.backward_flow,
                     method=method, dtype=dtype, fill_value=fill_value, direction=direction)

    def watershed(self, field, markers, mask=None, connectivity=1, stats=None,
                  budget_bytes=None):
        """Flow-aware watershed segmentation (see ``ops.watershed``; in time
        chunks over ``budget_bytes``)."""
        from tobac_flow_tpu_torch.ops.watershed import watershed

        return watershed(self.forward_flow, self.backward_flow, field, markers, mask=mask,
                         connectivity=connectivity, stats=stats, budget_bytes=budget_bytes,
                         device=self.device)

    def label(self, data, structure=DEFAULT_STRUCTURE, dtype=torch.int32, overlap=0,
              absolute_overlap=1, subsegment_shrink=0, peak_min_distance=5,
              budget_bytes=None):
        """Label 3d connected objects in the moving frame (see
        ``segment.label.flow_label``; in time chunks over ``budget_bytes``)."""
        from tobac_flow_tpu_torch.segment.label import flow_label

        return flow_label(self, data, structure=structure, dtype=dtype, overlap=overlap,
                          absolute_overlap=absolute_overlap,
                          subsegment_shrink=subsegment_shrink,
                          peak_min_distance=peak_min_distance, budget_bytes=budget_bytes)

    def link_overlap(self, data, structure=DEFAULT_STRUCTURE, dtype=torch.int32, overlap=0,
                     absolute_overlap=1, budget_bytes=None):
        """Link existing labels into contiguous objects (see
        ``segment.label.flow_link_overlap``; in time chunks over
        ``budget_bytes``)."""
        from tobac_flow_tpu_torch.segment.label import flow_link_overlap

        return flow_link_overlap(self, data, structure=structure, dtype=dtype,
                                 overlap=overlap, absolute_overlap=absolute_overlap,
                                 budget_bytes=budget_bytes)
