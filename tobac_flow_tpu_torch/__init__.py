"""PyTorch port of the fused flow → fields → watershed path of
``tobac_flow_tpu``, for CUDA on NVIDIA Hopper.

The JAX package is the reference this package is held against; this one
imports neither it nor JAX.  Public entry points:

- :func:`tobac_flow_tpu_torch.pipeline.fused_flow_watershed`
- :func:`tobac_flow_tpu_torch.pipeline.device_flow`
- :func:`tobac_flow_tpu_torch.ops.watershed.watershed`
- :class:`tobac_flow_tpu_torch.models.farneback.FarnebackFlow`
"""

from tobac_flow_tpu_torch.models.farneback import (
    FarnebackFlow,
    FarnebackParams,
    from_jax_params,
)
from tobac_flow_tpu_torch.ops.watershed import watershed
from tobac_flow_tpu_torch.pipeline import device_flow, fused_flow_watershed

__all__ = [
    "FarnebackFlow", "FarnebackParams", "device_flow", "from_jax_params",
    "fused_flow_watershed", "watershed",
]
