"""Field normalisation (counterpart of ``tobac_flow_tpu/utils/normalisation.py``).

``linearise_field`` serves the detection chain (on tensors or arrays);
the rest are the reference's host-side numpy normalisations:
``to_8bit`` (NaN-tolerant uint8 quantisation that copies the other
frame's values into NaN holes), the linear, log, inverse-log, z-score,
uniform and local-linear normalisations and their selector.  The flow
path's per-pair normalisation on the device is
``pipeline._normalise_pair``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "to_8bit",
    "linearise_field",
    "linear_norm",
    "log_norm",
    "inverse_log_norm",
    "z_norm",
    "uniform_norm",
    "local_linear_norm",
    "select_normalisation_method",
]


def to_8bit(array, vmin=None, vmax=None, fill_value=127):
    """Quantise an array to uint8 over [vmin, vmax].

    Non-finite values are replaced by ``fill_value``, except that for a
    2-frame stack each frame first inherits the other frame's values in its
    NaN holes (large NaN/value jumps between frames break optical flow).
    """
    array = np.asarray(array, dtype=np.float64)
    if vmin is None:
        vmin = np.nanmin(array)
    if vmax is None:
        vmax = np.nanmax(array)
    factor = 0.0 if vmin == vmax else 255.0 / (vmax - vmin)
    out = (array - vmin) * factor

    finite = np.isfinite(out)
    out[~finite] = fill_value
    if out.ndim >= 1 and out.shape[0] == 2:
        out[0][~finite[0]] = out[1][~finite[0]]
        out[1][~finite[1]] = out[0][~finite[1]]
    return out.astype(np.uint8)


def linearise_field(field, lower_threshold, upper_threshold, divide=False):
    """Clamp-rescale a field (array or tensor) to [0, 1] between two
    thresholds; thresholds passed high-to-low invert the result.  The
    division by the threshold span is a multiply by its float32
    reciprocal, as the reference's compiled programs fold it, or with
    ``divide`` a division, as its numpy steps take it."""
    if lower_threshold == upper_threshold:
        raise ValueError("lower and upper thresholds must have different values")
    invert = lower_threshold > upper_threshold
    if invert:
        lower_threshold, upper_threshold = upper_threshold, lower_threshold
    if divide:
        scaled = (field - lower_threshold) / (upper_threshold - lower_threshold)
    else:
        inverse = float(np.float32(1.0) / np.float32(upper_threshold - lower_threshold))
        scaled = (field - lower_threshold) * inverse
    if isinstance(scaled, torch.Tensor):
        clipped = scaled.clamp(0.0, 1.0)
    else:
        clipped = np.clip(scaled, 0.0, 1.0)
    return 1.0 - clipped if invert else clipped


def linear_norm(array, vmin=None, vmax=None):
    if vmin is None:
        vmin = np.nanmin(array)
    if vmax is None:
        vmax = np.nanmax(array)
    factor = 1.0 / (vmax - vmin) if vmax > vmin else 0.0
    return np.clip((array - vmin) * factor, 0.0, 1.0)


def log_norm(array, vmin=None, vmax=None):
    base = np.nanmin(array)
    return linear_norm(np.log(array - base + 1), vmin=base, vmax=vmax)


def inverse_log_norm(array, vmin=None, vmax=None):
    top = np.nanmax(array)
    return linear_norm(np.log(top - array + 1), vmin=vmin, vmax=top)


def z_norm(array, max_std=3):
    mean = np.nanmean(array)
    std = np.nanstd(array)
    return linear_norm((array - mean) / std, vmin=-max_std, vmax=max_std)


def uniform_norm(array, quantiles=256):
    edges = np.quantile(array, np.linspace(0, 1, quantiles + 1))
    edges[-1] += 1
    return linear_norm(np.digitize(array, edges))


def local_linear_norm(data, size=100):
    import scipy.ndimage as ndi

    if not np.all(np.isfinite(data)):
        data = np.where(np.isnan(data), np.nanmean(data), data)
    vmax = ndi.maximum_filter(data, size)
    vmin = ndi.minimum_filter(data, size)
    span = vmax - vmin
    inv = np.where(span == 0, 0.0, 1.0 / np.where(span == 0, 1.0, span))
    return (data - vmin) * inv


_NORM_METHODS = {
    "linear": linear_norm,
    "log": log_norm,
    "inverse_log": inverse_log_norm,
    "z_score": z_norm,
    "uniform": uniform_norm,
    "local_linear": local_linear_norm,
}


def select_normalisation_method(method):
    if method not in _NORM_METHODS:
        raise ValueError(
            f"{method} not an acceptable normalisation method, method must be "
            f"one of {list(_NORM_METHODS.keys())}"
        )
    return _NORM_METHODS[method]
