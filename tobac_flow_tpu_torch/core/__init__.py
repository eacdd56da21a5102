from tobac_flow_tpu_torch.core.abstracts import AbstractFlow
from tobac_flow_tpu_torch.core.flow import Flow, calculate_flow, create_flow, smooth_flow_step

__all__ = ["AbstractFlow", "Flow", "calculate_flow", "create_flow", "smooth_flow_step"]
