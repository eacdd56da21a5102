from tobac_flow_tpu_torch.track.linking import (  # noqa: F401
    find_overlap_between_files,
    find_overlap_between_labels,
    process_linking_output,
    relabel_file,
)
