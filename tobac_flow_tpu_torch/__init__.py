"""PyTorch port of ``tobac_flow_tpu`` for CUDA on NVIDIA Hopper: the fused
flow → fields → watershed path, and the detection of the ingest CLIs
from the fields to the detection file.

The JAX package is the reference this package is held against; this one
imports neither it nor JAX.  Public entry points:

- :func:`tobac_flow_tpu_torch.pipeline.fused_flow_watershed`
- :func:`tobac_flow_tpu_torch.pipeline.device_flow`
- :func:`tobac_flow_tpu_torch.ops.watershed.watershed`
- :func:`tobac_flow_tpu_torch.core.flow.create_flow` and
  :class:`tobac_flow_tpu_torch.core.flow.Flow`
- :func:`tobac_flow_tpu_torch.detect.chain.run_detection` (the label volumes)
- :func:`tobac_flow_tpu_torch.cli.common.run_detection` (the detection
  dataset) and ``python -m tobac_flow_tpu_torch.cli.dcc_detect_synthetic``
- :class:`tobac_flow_tpu_torch.models.farneback.FarnebackFlow` and the
  other flow models, by name through
  :func:`tobac_flow_tpu_torch.models.select_of_model`
- :class:`tobac_flow_tpu_torch.config.PipelineConfig` (its
  ``detection_options()`` configures the detection's flow model,
  smoothing and subsegmentation)
"""

from tobac_flow_tpu_torch.core.flow import Flow, create_flow
from tobac_flow_tpu_torch.detect.chain import DetectionOptions, run_detection
from tobac_flow_tpu_torch.models.farneback import (
    FarnebackFlow,
    FarnebackParams,
    from_jax_params,
)
from tobac_flow_tpu_torch.ops.watershed import watershed
from tobac_flow_tpu_torch.pipeline import device_flow, fused_flow_watershed

__all__ = [
    "DetectionOptions", "FarnebackFlow", "FarnebackParams", "Flow", "create_flow",
    "device_flow", "from_jax_params", "fused_flow_watershed", "run_detection", "watershed",
]
