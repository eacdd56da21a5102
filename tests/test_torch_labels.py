"""The port's labelling against ``tobac_flow_tpu/ops/ccl.py``,
``tobac_flow_tpu/segment/label.py``, ``tobac_flow_tpu/utils/labels.py``
and ``tobac_flow_tpu/detect/analysis.py``.

Tolerance: exact.  ``flat_label`` gives scipy's partitions and numbering
(1..N frame-major by each component's first raster pixel), as the
reference's host and device routes do; overlap linking gives the
reference's labels; the per-label tables are equal.  Inputs: masks of
advecting storm cells (``tools/parity_detect.make_multistorm_scene``)
and random masks, from numpy seeds.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.core.flow import Flow as JaxFlow  # noqa: E402
from tobac_flow_tpu.detect import analysis as janalysis  # noqa: E402
from tobac_flow_tpu.ops import ccl as jccl  # noqa: E402
from tobac_flow_tpu.segment import label as jlabel  # noqa: E402
from tobac_flow_tpu.utils import labels as jlabels  # noqa: E402
from tobac_flow_tpu_torch.core.flow import Flow  # noqa: E402
from tobac_flow_tpu_torch.detect import analysis  # noqa: E402
from tobac_flow_tpu_torch.ops import ccl  # noqa: E402
from tobac_flow_tpu_torch.segment import label  # noqa: E402
from tobac_flow_tpu_torch.utils import labels  # noqa: E402
from tools.parity_detect import make_multistorm_scene  # noqa: E402

SHAPE = (8, 64, 96)


@pytest.fixture(scope="module")
def storm():
    """Cold-cloud mask of the storm scene and a flow along the cells'
    motion (2 px/frame in x, 0.5 in y) with noise."""
    bt, wvd, swd = make_multistorm_scene(*SHAPE)
    rng = np.random.default_rng(0)
    fwd = np.empty(SHAPE + (2,), np.float32)
    fwd[..., 0] = 2.0 + rng.normal(0, 0.3, SHAPE)
    fwd[..., 1] = 0.5 + rng.normal(0, 0.3, SHAPE)
    bwd = (-fwd + rng.normal(0, 0.2, fwd.shape)).astype(np.float32)
    return {"mask": bt < 250, "fwd": fwd, "bwd": bwd, "wvd": wvd}


def _scipy_flat(mask):
    out = np.zeros(mask.shape, np.int64)
    offset = 0
    for i, frame in enumerate(mask):
        lab, n = ndi.label(frame, structure=ndi.generate_binary_structure(2, 1))
        out[i] = np.where(lab > 0, lab + offset, 0)
        offset += n
    return out


@pytest.mark.parametrize("p", [0.3, 0.55, 0.65])
def test_flat_label_random(p):
    mask = np.random.default_rng(1).uniform(size=(4, 50, 70)) < p
    out = ccl.flat_label(torch.from_numpy(mask)).numpy()
    assert np.array_equal(out, _scipy_flat(mask))
    assert np.array_equal(out, np.asarray(jccl.flat_label(jnp.asarray(mask))))


def test_flat_label_storm(storm):
    out = ccl.flat_label(torch.from_numpy(storm["mask"])).numpy()
    assert out.max() >= 20
    assert np.array_equal(out, _scipy_flat(storm["mask"]))
    assert np.array_equal(out, np.asarray(jccl.flat_label(storm["mask"])))


@pytest.mark.parametrize("overlap,absolute", [(0.5, 4), (0.0, 0), (0.9, 30)])
def test_link_labels_by_overlap(storm, overlap, absolute):
    flat = jccl.flat_label(storm["mask"])
    jflow = JaxFlow(jnp.asarray(storm["fwd"]), jnp.asarray(storm["bwd"]))
    ref = jlabel.link_labels_by_overlap(jflow, flat, overlap=overlap, absolute_overlap=absolute)
    flow = Flow.from_numpy(storm["fwd"], storm["bwd"], device="cpu")
    out = label.link_labels_by_overlap(flow, flat, overlap=overlap, absolute_overlap=absolute)
    assert 0 < ref.max() < flat.max()
    assert np.array_equal(np.asarray(ref), out.numpy())


def test_flow_label_and_link_overlap(storm):
    jflow = JaxFlow(jnp.asarray(storm["fwd"]), jnp.asarray(storm["bwd"]))
    flow = Flow.from_numpy(storm["fwd"], storm["bwd"], device="cpu")
    ref = jflow.label(storm["mask"], overlap=0.5, absolute_overlap=4)
    out = flow.label(storm["mask"], overlap=0.5, absolute_overlap=4)
    assert np.array_equal(np.asarray(ref), out.numpy())
    steps = jlabels.make_step_labels(np.asarray(ref))
    assert np.array_equal(steps, labels.make_step_labels(out).numpy())
    ref_link = jflow.link_overlap(steps, overlap=0.5, absolute_overlap=4)
    out_link = flow.link_overlap(torch.from_numpy(steps), overlap=0.5, absolute_overlap=4)
    assert np.array_equal(np.asarray(ref_link), out_link.numpy())
    # subsegmented labels lie inside the mask (held to the reference's in
    # test_torch_subsegment.py; a region too small for a marker stays 0)
    sub = flow.label(storm["mask"], subsegment_shrink=0.5)
    assert sub.dtype == torch.int32 and int(sub.max()) > 0
    assert not sub.numpy()[np.asarray(storm["mask"]) == 0].any()


def _labels(seed):
    """Random labels 1..9 over random blobs, some labels absent."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, 10, (6, 30, 40)).astype(np.int32)
    lab[rng.uniform(size=lab.shape) < 0.5] = 0
    lab[lab == 4] = 0
    return lab


def test_slice_and_step_labels():
    lab = _labels(2)
    assert np.array_equal(jlabels.slice_labels(lab), labels.slice_labels(torch.from_numpy(lab)).numpy())
    assert np.array_equal(jlabels.make_step_labels(lab),
                          labels.make_step_labels(torch.from_numpy(lab)).numpy())


def test_remap_labels():
    lab = _labels(3)
    keep = np.random.default_rng(3).uniform(size=lab.max()) < 0.5
    assert np.array_equal(jlabels.remap_labels(lab, keep),
                          labels.remap_labels(torch.from_numpy(lab), keep).numpy())
    values, new = np.array([2, 7]), np.array([1, 2])
    assert np.array_equal(jlabels.remap_labels(lab, values, new),
                          labels.remap_labels(torch.from_numpy(lab), values, new).numpy())


def test_object_lengths_and_mask_labels(storm):
    lab = _labels(4)
    mask = np.random.default_rng(4).uniform(size=lab.shape) < 0.01
    t = torch.from_numpy(lab)
    assert np.array_equal(janalysis.find_object_lengths(lab), analysis.find_object_lengths(t))
    assert np.array_equal(janalysis.mask_labels(lab, mask),
                          analysis.mask_labels(t, torch.from_numpy(mask)))


def test_labeled_comprehension():
    lab = _labels(5)
    field = np.random.default_rng(5).normal(250, 10, lab.shape).astype(np.float32)
    field[0, 0, :10] = np.nan
    ref = jlabels.labeled_comprehension(field, lab, np.nanmean, default=np.nan)
    out = labels.labeled_comprehension(torch.from_numpy(field), torch.from_numpy(lab),
                                       np.nanmean, default=np.nan)
    assert ref.dtype == out.dtype and np.array_equal(ref, out, equal_nan=True)
    per = np.arange(1, 13) % 4  # a 1-D "label" array with positions passed on
    vals = np.linspace(0.0, 1.0, 12)

    def func(v, pos):
        return float(v.sum() + pos.sum())

    ref = jlabels.labeled_comprehension(vals, per, func, default=0, dtype=np.float64,
                                        pass_positions=True)
    out = labels.labeled_comprehension(vals, per, func, default=0, dtype=np.float64,
                                       pass_positions=True)
    assert np.array_equal(ref, out)
