"""The port's whole-volume watershed against ``tobac_flow_tpu/ops/watershed.py``.

Given the same flows, edge field, markers and mask (the JAX fields stage
on ``make_scene(8, 160, 224)``), the labels must be identical: the flood
uses only compares, selects, max and integer operations, and the port
runs the reference's schedule exactly.  Cases: the scene's positive
markers, mixed -1 barrier and positive markers (the barrier-first
pre-flood), and multigrid on and off.

The reference's fields and labels are read as
``tools/record_torch_refs.py`` recorded them
(``tests/data/fused_scene.npz``, with a digest of the scene it was made
from): its multigrid flood compiles, about a minute of the suite's time
a case when run live.
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side, and
# torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from tobac_flow_tpu.ops import watershed as jws  # noqa: E402
from tobac_flow_tpu_torch.ops import watershed as pws  # noqa: E402
from tools.record_torch_refs import fused_scene, mixed_markers, scene_digest  # noqa: E402

RECORD = Path(__file__).resolve().parent / "data" / "fused_scene.npz"


@pytest.fixture(scope="module")
def fields():
    """The reference's fields stage on the scene, its markers (positive,
    and with a -1 barrier ring around the storms racing the positive
    labels), and the reference's labels of each case
    (``ws_{kind}_{multigrid}``), as recorded."""
    bt, markers, _ = fused_scene()
    rec = dict(np.load(RECORD))
    assert str(rec.pop("digest")) == scene_digest(bt, markers), "stale record"
    return {**rec, "mask": rec["field"] > 0.05, "positive": markers,
            "mixed": mixed_markers(markers, rec["field"])}


def _labels_both(f, kind, multigrid):
    ref = f[f"ws_{kind}_{multigrid}"]
    stats = {}
    out = pws.watershed(
        *(torch.from_numpy(f[k]) for k in ("fwd", "bwd", "edges")),
        torch.from_numpy(f[kind]), mask=torch.from_numpy(f["mask"]), max_iters=128,
        stats=stats, device="cpu", multigrid=multigrid,
    ).numpy()
    return ref, out, stats


@pytest.mark.parametrize(
    "kind, multigrid", [("positive", True), ("positive", False), ("mixed", True)]
)
def test_labels_identical_to_jax(fields, kind, multigrid):
    ref, out, stats = _labels_both(fields, kind, multigrid)
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


@pytest.mark.parametrize("radius, spread, live_share", [
    (5, 1, 0.3), (5, 7, 0.6), (20, 2, 0.1), (3, 3, 1.0),
])
def test_banded_scatter_min_identical_to_jax(radius, spread, live_share):
    """The port's scatter-min visits only the shifts that claimed sources
    take; the reference visits every shift of the band.  On random pushes
    (tied costs, unclaimed sources carrying displacements, some pushes
    out of the band) the outputs are identical."""
    from tobac_flow_tpu.ops.watershed import _banded_scatter_min as jax_scatter
    from tobac_flow_tpu_torch.ops.ws_sweeps import META_MAX

    rng = np.random.default_rng(radius * 100 + spread)
    shape = (2, 24, 40)
    live = rng.uniform(0, 1, shape) < live_share
    cost = np.where(live, np.round(rng.uniform(0, 1, shape) * 4) / 4, np.inf).astype(np.float32)
    cost2 = np.where(live, np.round(rng.uniform(0, 1, shape) * 4) / 4, np.inf).astype(np.float32)
    meta = (rng.integers(0, 3, shape) << 23 | rng.integers(1, 6, shape)).astype(np.int32)
    meta = np.where(live, meta, META_MAX).astype(np.int32)
    dy, dx = (rng.integers(-spread, spread + 1, shape).astype(np.int32) for _ in range(2))
    want = jax_scatter(cost, cost2, meta, dy, dx, radius, META_MAX)
    got = pws._banded_scatter_min(*(torch.from_numpy(a) for a in (cost, cost2, meta, dy, dx)),
                                  radius)
    assert (np.asarray(want[2]) != META_MAX).sum() > 50
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("radius, spread, live_share, shape", [
    (5, 1, 0.3, (2, 24, 40)), (5, 7, 0.6, (2, 24, 40)), (20, 2, 0.1, (2, 24, 40)),
    (3, 3, 1.0, (24, 40)), (20, 20, 0.7, (3, 30, 45)), (2, 1, 1.0, (2, 24, 40)),
])
def test_compact_scatter_min_identical_to_jax(radius, spread, live_share, shape):
    """The scatter-min's compact forms, which run where many shifts are
    taken on the card (shift by shift: each shift's pushes gathered and
    folded at the cells they reach, out-of-frame pushes into a spare row;
    in waves: every cell's k-th push at once), give the reference's
    outputs and the dense form's on random pushes with tied costs, tied
    claims of both signs of zero, unclaimed sources carrying displacements
    and pushes out of the band."""
    from tobac_flow_tpu.ops.watershed import _banded_scatter_min as jax_scatter
    from tobac_flow_tpu_torch.ops.ws_sweeps import META_MAX

    rng = np.random.default_rng(radius * 100 + spread)
    live = rng.uniform(0, 1, shape) < live_share
    cost = np.where(live, np.round(rng.uniform(-1, 1, shape) * 4) / 4, np.inf).astype(np.float32)
    cost2 = np.where(live, np.round(rng.uniform(0, 1, shape) * 4) / 4, np.inf).astype(np.float32)
    meta = (rng.integers(0, 3, shape) << 23 | rng.integers(1, 6, shape)).astype(np.int32)
    meta = np.where(live, meta, META_MAX).astype(np.int32)
    dy, dx = (rng.integers(-spread, spread + 1, shape).astype(np.int32) for _ in range(2))
    want = jax_scatter(cost, cost2, meta, dy, dx, radius, META_MAX)
    args = [torch.from_numpy(a) for a in (cost, cost2, meta, dy, dx)]
    keyed = pws._shift_keys(args[3], args[2] != META_MAX, radius)
    dense = pws._scatter_min_dense(*args, radius, keyed[1])
    assert (np.asarray(want[2]) != META_MAX).sum() > 50
    for form in (pws._scatter_min_shifts, pws._scatter_min_waves):
        for w, c, d in zip(want, form(*args, radius, keyed), dense):
            assert np.array_equal(np.asarray(w).view(np.int32), c.numpy().view(np.int32))
            assert torch.equal(c, d)
