from tobac_flow_tpu_torch.schema.dataset import (  # noqa: F401
    add_step_labels,
    add_label_coords,
    link_cores_and_anvils,
    link_step_labels,
    find_edge_labels,
    flag_edge_labels,
    flag_nan_adjacent_labels,
    calculate_label_properties,
)
