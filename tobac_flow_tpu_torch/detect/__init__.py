from tobac_flow_tpu_torch.detect.detection import (  # noqa: F401
    detect_cores,
    get_anvil_markers,
    detect_anvils,
    relabel_anvils,
    get_growth_rate,
    get_combined_filters,
    get_curvature_filter,
    get_peak_filter,
    get_watershed_mask,
    get_combined_edge_field,
    filtered_tdiff,
    edge_watershed,
    detect_growth_markers,
    detect_growth_markers_multichannel,
)
from tobac_flow_tpu_torch.detect import analysis  # noqa: F401
