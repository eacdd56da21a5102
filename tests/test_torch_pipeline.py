"""The port's fused flow → fields → watershed path against
``tobac_flow_tpu/pipeline.py`` on ``make_scene(8, 160, 224)``.

- Teacher-forced fields stage (the JAX flows into both): growth, the
  field and the edge magnitude are bit-equal.  XLA on the CPU contracts
  the reference's ``gx*gx + gy*gy + gt*gt`` into
  ``fma(gt, gt, fma(gx, gx, gy*gy))`` and takes a correctly rounded root;
  the port's ``ops.sobel.sobel_magnitude`` does the same.
- Flows: the Farneback tolerances of ``test_torch_farneback.py``, inside
  the storm mask.
- The whole slice: foreground IoU ≥ 0.99, and ≥ 0.99 same-label agreement
  where both label, against JAX ``fused_flow_watershed``.

The reference's outputs are read as ``tools/record_torch_refs.py``
recorded them (``tests/data/fused_scene.npz``, with a digest of the scene
it was made from): its fields stage and watershed compile, about a
minute of the suite's time when run live.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes side by side, and
# torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from tobac_flow_tpu_torch import pipeline as pp  # noqa: E402
from tools.record_torch_refs import FUSED_SHAPE, fused_scene, scene_digest  # noqa: E402

SHAPE = FUSED_SHAPE
RECORD = Path(__file__).resolve().parent / "data" / "fused_scene.npz"


@pytest.fixture(scope="module")
def scene():
    """The scene, its markers, and the reference's fields stage and fused
    labels, as ``tools/record_torch_refs.record_fused_scene`` recorded
    them."""
    bt, markers, n = fused_scene()
    rec = dict(np.load(RECORD))
    assert str(rec.pop("digest")) == scene_digest(bt, markers), "stale record"
    return {"bt": bt, "markers": markers, "n": n, **rec}


def test_fields_stage_teacher_forced(scene):
    fwd, bwd = (torch.from_numpy(scene[k]) for k in ("fwd", "bwd"))
    radius = pp.adaptive_band_radius(fwd, bwd)
    assert radius == int(scene["radius"])
    # the reference's fields stage given its own flows (recorded once: it
    # gives the stage's fields again)
    ref = [scene[k] for k in ("growth", "field", "edges")]
    growth, field, edges = (a.numpy() for a in pp._detect_fields_stage(
        torch.from_numpy(scene["bt"]), fwd, bwd, 5.0, radius
    ))
    nan_same = np.isnan(ref[0]) == np.isnan(growth)
    assert nan_same.all()
    assert np.array_equal(np.nan_to_num(ref[0]), np.nan_to_num(growth))
    assert np.array_equal(ref[1], field)
    assert np.array_equal(ref[2], edges)


def test_device_flow(scene):
    fwd, bwd = pp.device_flow(scene["bt"], device="cpu")
    mask = scene["field"] > 0.05
    for out, ref in ((fwd.numpy(), scene["fwd"]), (bwd.numpy(), scene["bwd"])):
        assert out.shape == ref.shape and np.abs(out).max() <= 20.0
        diff = np.abs(out - ref)[mask]
        assert np.percentile(diff, 99) <= 0.01 and diff.max() <= 0.1
        assert (np.round(out) == np.round(ref))[mask].mean() >= 0.999
    # boundary frames take the negated opposite flow
    assert torch.equal(fwd[-1], -bwd[-1]) and torch.equal(bwd[0], -fwd[0])
    # the CLI-default flow (refinement, cubic smoothing) runs through the same
    # function; test_torch_detect.py holds it to the reference
    cli = pp.device_flow(scene["bt"], vr_steps=1, smoothing_passes=1, interp_method="cubic",
                         device="cpu")
    assert cli[0].shape == fwd.shape and float(cli[0].abs().max()) <= 20.0
    assert not torch.equal(cli[0], fwd)


def test_fused_flow_watershed_against_jax(scene):
    stats = {}
    fwd, growth, edges, labels = pp.fused_flow_watershed(
        torch.from_numpy(scene["bt"]), 5.0, markers=scene["markers"], stats=stats,
        device="cpu",
    )
    ref, out = scene["labels"], labels.numpy()
    assert out.shape == SHAPE and out.dtype == np.int32
    fg_ref, fg_out = ref != 0, out != 0
    iou = (fg_ref & fg_out).sum() / (fg_ref | fg_out).sum()
    both = fg_ref & fg_out
    agree = (ref[both] == out[both]).mean()
    assert iou >= 0.99 and agree >= 0.99, (iou, agree)
    assert set(np.unique(out[out > 0])) == set(range(1, scene["n"] + 1))
    assert np.isfinite(fwd.numpy()).all()
    for key in ("flow_s", "fields_s", "watershed_s", "jacobi_rounds", "flow_span_ns",
                "fields_span_ns", "watershed_span_ns"):
        assert key in stats
