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
from tobac_flow_tpu_torch.ops.warp import INTERP_METHODS, sqrt32, warp_flow

__all__ = [
    "Flow", "create_flow", "calculate_flow", "calculate_flow_frame", "calculate_flow_2",
    "smooth_flow_step", "combine_flow", "get_forward_warp", "flow_diff_mse_estimate",
    "get_flow_residual", "flow_residual_mse_estimate", "flow_magnitude",
]


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


def calculate_flow_frame(prev_frame, next_frame, model: str = "Farneback", vr_steps: int = 0,
                         smoothing_steps: int = 0, interp_method: str = "linear", device=None):
    """Forward and backward flow between one pair of frames already on the
    0..255 scale (no normalisation), each (H, W, 2) on ``device``."""
    from tobac_flow_tpu_torch.models import select_of_model
    from tobac_flow_tpu_torch.models.variational import variational_refine

    dev = resolve_device(device)
    prev = torch.as_tensor(np.asarray(prev_frame, np.float32)).to(dev)[None]
    nxt = torch.as_tensor(np.asarray(next_frame, np.float32)).to(dev)[None]
    pair = select_of_model(model).to(dev)
    flows = pair(torch.cat([prev, nxt]), torch.cat([nxt, prev]))
    if vr_steps > 0:
        flows = variational_refine(torch.cat([prev, nxt]), torch.cat([nxt, prev]), flows,
                                   steps=vr_steps)
    fwd, bwd = flows[:1], flows[1:]
    for _ in range(smoothing_steps):
        fwd, bwd = smooth_flow_step(fwd, bwd, method=interp_method)
    return fwd[0], bwd[0]


def _pair_flows_of(a, b, model, vr_steps, smoothing_passes, normalisation_method, device):
    """Flows of the frame pairs (a[i], b[i]) (N, H, W), all in one batch."""
    from tobac_flow_tpu_torch.models import select_of_model
    from tobac_flow_tpu_torch.pipeline import flow_pairs

    dev = resolve_device(device)
    a, b = (_as_float32(x).to(dev) for x in (a, b))
    return flow_pairs(a, b, select_of_model(model).to(dev), vr_steps, smoothing_passes,
                      normalisation_method=normalisation_method)


def _as_float32(da):
    """A field (DataArray, array or tensor) as a float32 tensor where it lies."""
    if hasattr(da, "dims"):  # a DataArray
        da = da.data
    if not isinstance(da, torch.Tensor):
        da = torch.from_numpy(np.asarray(da))
    return da.to(torch.float32)


def calculate_flow_2(a, b, model: str = "Farneback", vr_steps: int = 0,
                     smoothing_passes: int = 0, normalisation_method: str = "linear",
                     device=None):
    """Forward/backward flow between two co-timed (T, H, W) stacks: frame i
    of ``a`` paired with frame i of ``b`` for i < T - 1, every pair in one
    batch; ``fwd[i]`` is a[i] → b[i], ``bwd[i + 1]`` b[i] → a[i], and the
    boundary frames take the negated opposite flow."""
    a, b = _as_float32(a), _as_float32(b)
    f, bk = _pair_flows_of(a[:-1], b[:-1], model, vr_steps, smoothing_passes,
                           normalisation_method, device)
    fwd = torch.full(tuple(a.shape) + (2,), math.nan, dtype=torch.float32, device=f.device)
    bwd = torch.full_like(fwd, math.nan)
    fwd[:-1] = f
    bwd[1:] = bk
    fwd[-1] = -bwd[-1]
    bwd[0] = -fwd[0]
    return fwd, bwd


def smooth_flow_step(forward_flow, backward_flow, method="linear"):
    """One smoothing pass: each flow (..., H, W, 2) averaged with the
    negated opposite flow warped along it (NaN outside the frame),
    NaN-aware.  Nearest, linear and cubic warp by the two-pass banded
    warp; "lanczos" by the general gather (``ops.warp.warp_flow``)."""
    if method not in INTERP_METHODS:
        raise ValueError(f"method must be one of {list(INTERP_METHODS)}")

    def _smooth(primary, opposite):
        channels = opposite.to(torch.float32).movedim(-1, 0)
        if method == "lanczos":  # the general gather, as the reference
            both = warp_flow(channels, primary, method=method)
        else:
            both = warp_banded_multi(channels, primary, radius=20, method=method,
                                     fill_value=math.nan, pad_mode="constant")
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
                  budget_bytes=None, max_iters=None):
        """Flow-aware watershed segmentation (see ``ops.watershed``; in time
        chunks over ``budget_bytes``)."""
        from tobac_flow_tpu_torch.ops.watershed import watershed

        return watershed(self.forward_flow, self.backward_flow, field, markers, mask=mask,
                         connectivity=connectivity, max_iters=max_iters, stats=stats,
                         budget_bytes=budget_bytes, device=self.device)

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


def _field_on(flow, da):
    """A field (DataArray, array or tensor) as float32 on the flow's device."""
    return _as_float32(da).to(flow.device)


def _magnitude(f):
    return sqrt32(f[..., 0] ** 2 + f[..., 1] ** 2)


def combine_flow(*flows) -> Flow:
    """Magnitude-weighted merge of several Flows on one device."""

    def _merge(fields):
        mags = [_magnitude(f)[..., None] for f in fields]
        num = fields[0] * mags[0]
        den = mags[0]
        for f, m in zip(fields[1:], mags[1:]):
            num = num + f * m
            den = den + m
        return num / den

    return Flow(_merge([f.forward_flow for f in flows]),
                _merge([f.backward_flow for f in flows]))


def get_forward_warp(da, flow):
    """Each frame of ``da`` warped one step forward along the flow: frame
    t + 1 sampled at each pixel of frame t moved by the forward flow (NaN
    at the last frame)."""
    forward_struct = np.zeros([3, 3, 3], dtype=bool)
    forward_struct[2, 1, 1] = True
    return flow.convolve(_field_on(flow, da), structure=forward_struct)[0]


def flow_diff_mse_estimate(da, flow, cold_threshold=273.0):
    """(all-sky MSE, cold-pixel MSE) of the forward-warp residual."""
    from tobac_flow_tpu_torch.utils.stats import mse

    data = _field_on(flow, da)
    warp = get_forward_warp(data, flow)
    cold = data < cold_threshold
    return mse(warp, data), mse(warp[cold], data[cold])


def get_flow_residual(da, flow, model="Farneback", vr_steps=1, smoothing_passes=1):
    """The flow from each frame of ``da`` to its forward warp (T, H, W, 2),
    every frame's pair in one batch."""
    data = _field_on(flow, da)
    warp = get_forward_warp(data, flow)
    residual, _ = _pair_flows_of(data, warp, model, vr_steps, smoothing_passes, "linear",
                                 flow.device)
    return residual


def flow_residual_mse_estimate(da, flow, model="Farneback", vr_steps=1, smoothing_passes=1,
                               margin=20, cold_threshold=273.0):
    """(all-sky, cold) MSE of the residual flow's magnitude inside the
    margin."""
    from tobac_flow_tpu_torch.utils.stats import mse

    data = _field_on(flow, da)
    res = get_flow_residual(data, flow, model, vr_steps, smoothing_passes)
    inner = (slice(None), slice(margin, -margin), slice(margin, -margin))
    mag = _magnitude(res)[inner]
    cold = data[inner] < cold_threshold
    return mse(mag, torch.zeros_like(mag)), mse(mag[cold], torch.zeros_like(mag[cold]))


def flow_magnitude(flow, direction="forward"):
    """Per-pixel magnitude of the forward or backward flow."""
    if direction == "forward":
        f = flow.forward_flow
    elif direction == "backward":
        f = flow.backward_flow
    else:
        raise ValueError("Direction must be one of 'forward', 'backward'")
    return _magnitude(f)
