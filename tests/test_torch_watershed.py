"""The port's whole-volume watershed against ``tobac_flow_tpu/ops/watershed.py``.

Given the same flows, edge field, markers and mask (the JAX fields stage
on ``make_scene(8, 160, 224)``), the labels must be identical: the flood
uses only compares, selects, max and integer operations, and the port
runs the reference's schedule exactly.  Cases: the scene's positive
markers, mixed -1 barrier and positive markers (the barrier-first
pre-flood), and multigrid on and off.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side, and
# torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

import bench  # noqa: E402
from tobac_flow_tpu.ops import watershed as jws  # noqa: E402
from tobac_flow_tpu.pipeline import _fields_stage  # noqa: E402
from tobac_flow_tpu_torch.ops import watershed as pws  # noqa: E402


@pytest.fixture(scope="module")
def fields():
    bt = bench.make_scene(8, 160, 224)
    markers, _ = bench.make_markers(bt)
    fwd, bwd, _, field, edges = (np.array(a) for a in _fields_stage(jnp.asarray(bt), 5.0))
    mask = field > 0.05
    mixed = markers.copy()
    # a -1 barrier ring around the storms, racing the positive labels
    mixed[(field > 0.05) & (field < 0.12) & (markers == 0)] = -1
    return {"fwd": fwd, "bwd": bwd, "edges": edges, "mask": mask,
            "positive": markers, "mixed": mixed}


def _labels_both(f, markers, **kw):
    ref = np.asarray(jws.watershed(
        f["fwd"], f["bwd"], f["edges"], markers, mask=f["mask"], max_iters=128, **kw
    ))
    stats = {}
    out = pws.watershed(
        *(torch.from_numpy(f[k]) for k in ("fwd", "bwd", "edges")),
        torch.from_numpy(markers), mask=torch.from_numpy(f["mask"]), max_iters=128,
        stats=stats, device="cpu", **kw,
    ).numpy()
    return ref, out, stats


@pytest.mark.parametrize(
    "kind, multigrid", [("positive", True), ("positive", False), ("mixed", True)]
)
def test_labels_identical_to_jax(fields, kind, multigrid):
    ref, out, stats = _labels_both(fields, fields[kind], multigrid=multigrid)
    assert out.dtype == np.int32
    assert (ref != 0).sum() > 1000  # the flood really ran
    assert np.array_equal(ref, out), f"{(ref != out).sum()} labels differ"
    assert stats["jacobi_rounds"] >= 1 and stats["scan_rounds"] >= 1
    assert ("coarse_jacobi_rounds" in stats) == multigrid


def test_band_radius_and_decode():
    assert pws._band_radius_from_stats(np.array([5, 2] + [0] * 19)) == 2
    assert pws._band_radius_from_stats(np.ones(21)) == 21
    assert jws._band_radius_from_stats(np.stack([np.array([5, 2] + [0] * 19), np.full(21, 9)])) == 2
    with pytest.raises(ValueError):
        pws.watershed(torch.zeros(2, 4, 4, 2), torch.zeros(2, 4, 4, 2), torch.zeros(2, 4, 4),
                      torch.zeros(2, 4, 5, dtype=torch.int32), device="cpu")
