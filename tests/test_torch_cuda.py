"""The port on the card: its CUDA kernel must build from ``csrc/`` and be
bit-equal to its plain PyTorch version, and the paths through it must
give the CPU's results.  These tests need an NVIDIA GPU
and nvcc, and skip elsewhere; run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda``.  They import no JAX.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from bench import make_markers, make_scene
from chip_smoke import IN_PLANE, compare_datasets, sweep_inputs
from tobac_flow_tpu_torch.cli.common import DetectionOptions, prepare_output
from tobac_flow_tpu_torch.core.flow import Flow, create_flow
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset
from tobac_flow_tpu_torch.detect.chain import run_detection
from tobac_flow_tpu_torch.ops import ws_sweeps
from tobac_flow_tpu_torch.ops.ccl import flat_label
from tobac_flow_tpu_torch.ops.watershed import watershed
from tools.parity_detect import make_multistorm_scene

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
    _assert_kernel_equals_plain(sweep_inputs(shape, connectivity, cuda, taps), taps, k)


def _assert_kernel_equals_plain(args, taps, k):
    ref = ws_sweeps.spatial_sweeps_reference(*args, taps, k)
    out = ws_sweeps.spatial_sweeps(*args, taps, k)
    torch.cuda.synchronize()
    for name, a, b in zip(("claim", "claim2", "meta"), ref, out):
        assert torch.equal(a, b), f"{name}: {(a != b).sum().item()} mismatches"


@pytest.mark.parametrize("k", [2, 3, 5, 6, 7])
def test_generic_instance_bit_equal_to_plain(cuda, k):
    """K outside {1, 4, 8} runs the instance with run-time K and taps."""
    _assert_kernel_equals_plain(sweep_inputs((2, 100, 130), k, cuda), IN_PLANE[1], k)


@pytest.mark.parametrize("k", [8, 4])
def test_kernel_keeps_the_callers_tap_order(cuda, k):
    taps = IN_PLANE[2][::-1]
    _assert_kernel_equals_plain(sweep_inputs((2, 100, 130), k, cuda, taps), taps, k)


@pytest.mark.parametrize("k", [8, 4, 1])
def test_kernel_nan_and_signed_zero(cuda, k):
    """NaN fields and claims (the NaN-propagating max, and NaN never
    comparing less or equal) and -0.0 against +0.0 (equal claims, the
    first in tap order kept), compared bit for bit."""
    rng = np.random.default_rng(k)
    args = sweep_inputs((2, 100, 130), 4, "cpu")
    claim, claim2, _, field = (a.numpy() for a in args[:4])
    field[rng.uniform(size=field.shape) < 0.02] = np.nan
    field[rng.uniform(size=field.shape) < 0.05] = -0.0
    claim[rng.uniform(size=claim.shape) < 0.01] = np.nan
    claim[rng.uniform(size=claim.shape) < 0.03] = -0.0
    claim2[rng.uniform(size=claim2.shape) < 0.01] = np.nan
    args = [a.to(cuda) for a in args]
    ref = ws_sweeps.spatial_sweeps_reference(*args, IN_PLANE[2], k)
    out = ws_sweeps.spatial_sweeps(*args, IN_PLANE[2], k)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[0]).any())
    for name, a, b in zip(("claim", "claim2", "meta"), ref, out):
        a_bits, b_bits = (x.view(torch.int32) for x in (a, b))
        assert torch.equal(a_bits, b_bits), f"{name}: {(a_bits != b_bits).sum().item()} mismatches"


def test_persistent_grid_and_misaligned_masks(cuda):
    """More tiles than blocks (each block walks several tiles and prefetches
    the next), once with the masks as aligned words and once with the masks
    one byte off a word, which the kernel reads byte by byte."""
    args = sweep_inputs((4, 512, 512), 3, cuda)
    plan = ws_sweeps.launch_plan(4, 512, 512, 8, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.n_tiles > plan.grid
    _assert_kernel_equals_plain(args, IN_PLANE[1], 8)
    for i in (4, 5):
        buf = torch.zeros(args[i].numel() + 1, dtype=torch.bool, device=cuda)
        buf[1:] = args[i].reshape(-1)
        args[i] = buf[1:].view(args[i].shape)
    assert args[4].data_ptr() % 4 == 1
    _assert_kernel_equals_plain(args, IN_PLANE[1], 8)


def test_watershed_labels_equal_on_cuda_and_cpu(cuda):
    bt = make_scene(6, 96, 128)
    markers, _ = make_markers(bt)
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 1.5, bt.shape + (2,)).astype(np.float32)
    field = np.clip((260.0 - bt) / 10.0, 0.0, 1.0).astype(np.float32)
    args = [torch.from_numpy(a) for a in (flow, -flow, 1.0 - field, markers, field > 0.05)]
    cpu = watershed(*args[:4], mask=args[4], max_iters=64, device="cpu")
    before = ws_sweeps.spatial_sweeps.launches
    gpu = watershed(*args[:4], mask=args[4], max_iters=64)  # the card by default
    assert gpu.device.type == "cuda"
    assert ws_sweeps.spatial_sweeps.launches > before
    assert torch.equal(cpu, gpu.cpu())


@pytest.mark.parametrize("p", [0.3, 0.55, 0.65])
def test_flat_label_on_card_matches_scipy(cuda, p):
    mask = np.random.default_rng(7).uniform(size=(4, 200, 300)) < p
    out = flat_label(torch.from_numpy(mask).to(cuda))
    assert out.device.type == "cuda"
    ref = np.zeros(mask.shape, np.int64)
    offset = 0
    for i, frame in enumerate(mask):
        lab, n = ndi.label(frame, structure=ndi.generate_binary_structure(2, 1))
        ref[i] = np.where(lab > 0, lab + offset, 0)
        offset += n
    assert np.array_equal(out.cpu().numpy(), ref)


def test_chain_on_card_equals_cpu(cuda):
    """The detection chain on the card and on the CPU, given the same
    (card-computed, CLI-default) flows: identical labels at every stage."""
    t, h, w = 9, 64, 96
    bt, wvd, swd = make_multistorm_scene(t, h, w)
    times = np.datetime64("2020-06-01T00:00", "ns") + np.arange(t) * np.timedelta64(300, "s")
    flow = create_flow(bt, vr_steps=1, smoothing_passes=1, interp_method="cubic")
    assert flow.device.type == "cuda"
    gpu = run_detection(bt, wvd, swd, times, flow=flow)
    cpu = run_detection(bt, wvd, swd, times,
                        flow=Flow(flow.forward_flow.cpu(), flow.backward_flow.cpu()))
    for name in ("core_label", "anvil_marker_label", "thick_anvil_label", "thin_anvil_label"):
        assert gpu[name].device.type == "cuda" and int(cpu[name].max()) > 0, name
        assert torch.equal(gpu[name].cpu(), cpu[name]), name


def test_output_stages_on_card_equal_cpu(cuda):
    """The output stages (schema, label, spatial and field properties) on
    the card and on the CPU, given the same labels (the chain's on the
    card, with a NaN patch in WVD): the same dataset, float means and stds
    within the CPU tests' tolerance."""
    t, h, w = 9, 64, 96
    bt, wvd, swd = make_multistorm_scene(t, h, w)
    wvd[3:6, 20:26, 40:46] = np.nan
    times = np.datetime64("2020-06-01T00:00", "ns") + np.arange(t) * np.timedelta64(300, "s")
    labels = run_detection(bt, wvd, swd, times)
    coords = {"t": times, "y": np.arange(h) * 2000.0, "x": np.arange(w) * 2000.0}
    opts = DetectionOptions(save_spatial_props=True)
    out = {}
    for device in ("cuda", "cpu"):
        ds = Dataset(coords=coords)
        for name in ("core_label", "thick_anvil_label", "thin_anvil_label"):
            ds[name] = DataArray(labels[name].to(device), dims=("t", "y", "x"))
        fields = [DataArray(a, coords=coords, dims=("t", "y", "x"), name=n,
                            attrs={"long_name": n, "units": "K"})
                  for a, n in ((bt, "bt"), (wvd, "wvd"), (swd, "swd"))]
        stats = {}
        out[device] = prepare_output(ds, *fields, opts=opts, device=device, stats=stats)
        assert {"schema_s", "label_props_s", "field_props_s"} <= set(stats)
    assert out["cpu"].coords["core"].size > 0 and out["cpu"].coords["anvil"].size > 0
    assert out["cpu"]["core_nan_flag"].values.dtype == bool
    compare_datasets(out["cpu"], out["cuda"])
