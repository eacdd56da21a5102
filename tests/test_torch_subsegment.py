"""The port's subsegmentation, its labelling branch and the configured
detection against ``tobac_flow_tpu`` on the CPU.

Tolerance: exact everywhere.
- ``peak_local_max_mask`` (live): the frames cast to float32 before the
  dilation compare, as the reference casts them.
- ``subsegment_labels`` on the reference tests' two-discs-and-bridge scene
  and on a seeded 4-frame mask of touching blobs, and ``flow_label`` with
  ``subsegment_shrink=0.1`` on that mask given the same seeded flows:
  identical labels (the watershed breaks ties by label, so the markers
  are numbered as the reference numbers them).
- The configured detection (``PipelineConfig(flow_model="DIS",
  interp_method="lanczos", subsegment_shrink=0.1)``) on the chain's
  9×64×96 scene: ``detect.chain.run_detection`` under the configuration's
  ``DetectionOptions``, given the reference's flows, gives every stage's
  labels identical to the reference's.  (Given its own flows the port's
  labels are not held to the reference's here: on the early frames the
  cells are barely there, DIS's patch solves see noise, and a change of
  summation order alone moves the port's own flow by up to 3.5 px.)

The reference's subsegmentation compiles its watershed (about 40 s), so
its outputs are recorded once by ``tools/record_torch_refs.py``
(``tests/data/subsegment.npz``, ``tests/data/configured_chain.npz``).
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.ops import morphology as jmorph  # noqa: E402
from tobac_flow_tpu_torch import device as port_device  # noqa: E402
from tobac_flow_tpu_torch.config import PipelineConfig  # noqa: E402
from tobac_flow_tpu_torch.core.flow import Flow  # noqa: E402
from tobac_flow_tpu_torch.detect.chain import run_detection  # noqa: E402
from tobac_flow_tpu_torch.ops.morphology import grey_dilation, peak_local_max_mask  # noqa: E402
from tobac_flow_tpu_torch.segment.label import flow_label  # noqa: E402
from tobac_flow_tpu_torch.segment.subsegment import subsegment_labels  # noqa: E402
from tools.record_torch_refs import (  # noqa: E402
    CHAIN_STAGES, CONFIGURED, SUBSEGMENT_SHRINK, chain_scene, discs_and_bridge, seeded_flows,
    seeded_mask,
)

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def recorded():
    return dict(np.load(DATA / "subsegment.npz"))


@pytest.mark.parametrize("min_distance", [0, 3, 5, 10])
def test_peak_local_max_mask(min_distance):
    rng = np.random.default_rng(min_distance)
    frames = rng.uniform(0, 3, (3, 30, 40))  # float64, cast to float32 inside
    frames[0, 5:9, 5:9] = 2.5  # a plateau
    got = peak_local_max_mask(torch.from_numpy(frames), min_distance, 0.5)
    for i in range(3):
        want = jmorph.peak_local_max_mask(frames[i], min_distance=min_distance,
                                          threshold_abs=0.5)
        assert np.array_equal(np.asarray(want), got[i].numpy())


def test_grey_dilation():
    frames = np.random.default_rng(9).normal(size=(2, 17, 23)).astype(np.float32)
    got = grey_dilation(torch.from_numpy(frames), (5, 3))
    for i in range(2):
        want = jmorph.grey_dilation(frames[i], size=(5, 3))
        assert np.array_equal(np.asarray(want), got[i].numpy())


@pytest.mark.parametrize("scene", ["discs", "seeded"])
def test_subsegment_labels(scene, recorded):
    mask = discs_and_bridge() if scene == "discs" else seeded_mask()
    got = subsegment_labels(mask, SUBSEGMENT_SHRINK[scene], device="cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(recorded[scene], got.numpy())
    assert np.array_equal(got.numpy() != 0, mask)
    if scene == "discs":  # the two discs' cores carry different labels
        xx = np.mgrid[0:40, 0:80][1]
        left = set(np.unique(got[0].numpy()[(xx < 35) & mask[0]])) - {0}
        right = set(np.unique(got[0].numpy()[(xx > 45) & mask[0]])) - {0}
        assert left and right and not left & right
    else:
        assert recorded[scene].max() > 10


def test_subsegment_labels_in_time_chunks(recorded):
    """Three copies of the seeded mask under a 4-frame budget: each copy's
    chunk numbered on from the last, equal to the whole volume's run and
    to the recorded labels so offset."""
    mask = np.concatenate([seeded_mask()] * 3)
    stats = {}
    with port_device.stage("subsegment", stats, torch.device("cpu")):
        got = subsegment_labels(mask, SUBSEGMENT_SHRINK["seeded"], device="cpu",
                                budget_bytes=port_device.frames_budget(4))
    assert stats["subsegment_chunks"] == 3 and stats["subsegment_chunk_frames"] == 4
    whole = subsegment_labels(mask, SUBSEGMENT_SHRINK["seeded"], device="cpu")
    assert torch.equal(got, whole)
    want = recorded["seeded"]
    for k in range(3):
        assert np.array_equal(got[4 * k:4 * k + 4].numpy(),
                              np.where(want > 0, want + k * want.max(), 0))


def test_flow_label_subsegmented(recorded):
    mask = seeded_mask()
    fwd, bwd = seeded_flows(mask.shape)
    flow = Flow.from_numpy(fwd, bwd, device="cpu")
    got = flow_label(flow, mask, overlap=0.5, absolute_overlap=4, subsegment_shrink=0.1,
                     peak_min_distance=5)
    assert np.array_equal(recorded["flow_label"], got.numpy())
    # Flow.label passes peak_min_distance=5, as the reference's does
    assert torch.equal(got, flow.label(mask, overlap=0.5, absolute_overlap=4,
                                       subsegment_shrink=0.1))


def test_configured_run_detection():
    want = dict(np.load(DATA / "configured_chain.npz"))
    bt, wvd, swd, times = chain_scene()
    opts = PipelineConfig(**CONFIGURED).detection_options()
    stats = {}
    out = run_detection(bt, wvd, swd, times, opts=opts, stats=stats,
                        flow=Flow.from_numpy(want["fwd"], want["bwd"], device="cpu"))
    for name in CHAIN_STAGES:
        assert np.array_equal(want[name], out[name].numpy()), name
    # the anvil markers are subsegmented; no core of this scene passes the
    # length and cooling filters under DIS flows, in the reference as here
    assert min(want[name].max() for name in CHAIN_STAGES[1:]) >= 1
    assert stats["anvil_markers_n"] == want["anvil_marker_label"].max()
