"""Field normalisation (counterpart of the parts of
``tobac_flow_tpu/utils/normalisation.py`` the detection chain uses)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["linearise_field"]


def linearise_field(field, lower_threshold, upper_threshold):
    """Clamp-rescale a field (array or tensor) to [0, 1] between two
    thresholds; thresholds passed high-to-low invert the result.  The
    division by the threshold span is a multiply by its float32
    reciprocal, as the reference's compiled programs fold it."""
    if lower_threshold == upper_threshold:
        raise ValueError("lower and upper thresholds must have different values")
    invert = lower_threshold > upper_threshold
    if invert:
        lower_threshold, upper_threshold = upper_threshold, lower_threshold
    inverse = float(np.float32(1.0) / np.float32(upper_threshold - lower_threshold))
    scaled = (field - lower_threshold) * inverse
    if isinstance(scaled, torch.Tensor):
        clipped = scaled.clamp(0.0, 1.0)
    else:
        clipped = np.clip(scaled, 0.0, 1.0)
    return 1.0 - clipped if invert else clipped
