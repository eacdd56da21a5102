"""The port's CUDA kernel on the card: it must build from ``csrc/`` and
be bit-equal to its plain PyTorch version.  These tests need an NVIDIA GPU
and nvcc, and skip elsewhere; run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda``.  They import no JAX.
"""

import numpy as np
import pytest
import torch

from bench import make_markers, make_scene
from chip_smoke import IN_PLANE, sweep_inputs
from tobac_flow_tpu_torch.ops import ws_sweeps
from tobac_flow_tpu_torch.ops.watershed import watershed

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [8, 4, 1])
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("shape", [(3, 230, 257), (2, 31, 33)])
def test_kernel_bit_equal_to_plain(cuda, shape, connectivity, k):
    taps = IN_PLANE[connectivity]
    args = sweep_inputs(shape, connectivity, cuda, taps)
    ref = ws_sweeps.spatial_sweeps_reference(*args, taps, k)
    out = ws_sweeps.spatial_sweeps(*args, taps, k)
    torch.cuda.synchronize()
    for name, a, b in zip(("claim", "claim2", "meta"), ref, out):
        assert torch.equal(a, b), f"{name}: {(a != b).sum().item()} mismatches"


def test_watershed_labels_equal_on_cuda_and_cpu(cuda):
    bt = make_scene(6, 96, 128)
    markers, _ = make_markers(bt)
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 1.5, bt.shape + (2,)).astype(np.float32)
    field = np.clip((260.0 - bt) / 10.0, 0.0, 1.0).astype(np.float32)
    args = [torch.from_numpy(a) for a in (flow, -flow, 1.0 - field, markers, field > 0.05)]
    cpu = watershed(*args[:4], mask=args[4], max_iters=64)
    before = ws_sweeps.spatial_sweeps.launches
    gpu = watershed(*[a.to(cuda) for a in args[:4]], mask=args[4].to(cuda), max_iters=64)
    assert ws_sweeps.spatial_sweeps.launches > before
    assert torch.equal(cpu, gpu.cpu())
