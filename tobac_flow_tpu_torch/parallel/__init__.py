"""The sharded pipeline over a (t, x) mesh of ranks (counterpart of
``tobac_flow_tpu/parallel``): ``launch.launch`` starts the ranks and every
rank calls the same functions, as the bodies of ``jax.shard_map`` do."""

from tobac_flow_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from tobac_flow_tpu_torch.parallel.halo import halo_exchange_t, halo_exchange_x  # noqa: F401
from tobac_flow_tpu_torch.parallel.pipeline import sharded_detect_step  # noqa: F401
from tobac_flow_tpu_torch.parallel.label import (  # noqa: F401
    make_sharded_flow_label,
    sharded_flow_label,
)
from tobac_flow_tpu_torch.parallel.watershed import sharded_watershed  # noqa: F401
