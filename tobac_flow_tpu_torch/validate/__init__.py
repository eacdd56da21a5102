from tobac_flow_tpu_torch.validate.validation import (  # noqa: F401
    get_marker_distance,
    get_marker_distance_cylinder,
    validate_markers,
    get_edge_filter,
    validate_cores,
    validate_anvils,
)
