"""The port's time-chunked flood (``ops/watershed._watershed_time_chunked``
and its dispatch in ``watershed``) and the grouped flow and fields stages,
on the CPU at small shapes.

- Against the JAX package's chunked flood on the two 16×24×32 scenes of
  ``tests/test_watershed.py`` (plain and mixed -1/positive markers, seeds
  in frame 0 only), with the reference's plan (4-frame chunks): identical
  labels.  The JAX side compiles its flood for minutes on one core, so
  its chunked and whole-volume labels are recorded in
  ``tests/data/ws_time_chunked.npz`` with a hash of the inputs, by running
  this module from the repo root::

      PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_watershed_chunked.py

- The same for the 12×128×128 mixed scene of
  ``test_time_chunked_global_coarse_solve`` at 3 chunks, with a budget
  that leaves out the reference's global coarse solve, is held on the card
  (``tests/test_torch_cuda.py``): its CPU floods take minutes.
- The budget sends a deep volume to the chunked flood; a budget below a
  4-frame chunk raises; grouped flows and fields are bit-equal to
  ungrouped ones.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu_torch.models.farneback import FarnebackFlow  # noqa: E402
from tobac_flow_tpu_torch.ops import watershed as pws  # noqa: E402
from tobac_flow_tpu_torch.pipeline import (  # noqa: E402
    _detect_fields_stage, adaptive_band_radius, pair_flows,
)

DATA = Path(__file__).resolve().parent / "data" / "ws_time_chunked.npz"
REFERENCE_CHUNK = 4  # the reference tests' budgets give 4-frame chunks


def _moving_scene(seed, t, h, w, centers, speed, scale, barrier_rim):
    """The reference tests' advecting multi-basin scene: seeds in frame 0
    only, uniform x flow of ``speed`` px a frame, and optionally a -1
    barrier along the last column of every frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    field = np.empty((t, h, w), np.float32)
    for i in range(t):
        field[i] = 10.0
        for cy, cx in centers:
            r2 = (yy - cy) ** 2 + (xx - cx - speed * i) ** 2
            field[i] = np.minimum(field[i], scale * r2)
    field += rng.normal(0, 1e-3, field.shape).astype(np.float32)
    markers = np.zeros((t, h, w), np.int32)
    for k, (cy, cx) in enumerate(centers, start=1):
        markers[0, cy, cx] = k
    if barrier_rim:
        markers[:, :, -1] = -1
    fwd = np.zeros((t, h, w, 2), np.float32)
    bwd = np.zeros((t, h, w, 2), np.float32)
    fwd[..., 0] = speed
    bwd[..., 0] = -speed
    return fwd, bwd, field, markers


SCENES = {
    # test_time_chunked_matches_whole_volume
    "plain": lambda: _moving_scene(3, 16, 24, 32, [(8, 6), (8, 22), (16, 14)], 0.5, 0.08,
                                   False),
    # test_time_chunked_matches_whole_volume_mixed_markers
    "mixed": lambda: _moving_scene(7, 16, 24, 32, [(8, 6), (16, 22)], 0.5, 0.08, True),
    # test_time_chunked_global_coarse_solve (held on the card, in
    # tests/test_torch_cuda.py: its CPU floods take minutes)
    "coarse": lambda: _moving_scene(11, 12, 128, 128, [(40, 30), (88, 90)], 1.0, 0.01, True),
}
# budgets of the reference's TFT_WS_HBM_BUDGET_BYTES gate that give its
# 4-frame chunks: the reference tests' own for the 16x24x32 scenes; for the
# 12x128x128 scene one under 2 x its coarse grid's 12 x 32 x 32 x 224
# bytes, which leaves out the global coarse solve
REFERENCE_BUDGETS = {"plain": 16 * 24 * 32 * 40 // 4, "mixed": 16 * 24 * 32 * 96 // 4,
                     "coarse": 5_000_000}


def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _port_chunked(scene, chunk_t, stats=None):
    fwd, bwd, field, markers = (torch.from_numpy(a) for a in scene)
    taps = pws._structure_taps_3d(pws.connectivity_structure(1))
    mask = torch.ones(field.shape, dtype=torch.bool)
    return pws._watershed_time_chunked(
        field, markers, mask, fwd, bwd, taps, chunk_t=chunk_t, max_iters_cap=1 << 30,
        multigrid=True, run_scans=True, stats=stats,
    ).numpy()


@pytest.fixture(scope="module")
def recorded():
    return np.load(DATA)


@pytest.mark.parametrize("kind", ["mixed", "plain"])
def test_labels_identical_to_jax_chunked(recorded, kind):
    scene = SCENES[kind]()
    assert str(recorded[f"{kind}_digest"]) == _digest(scene), "the scene changed"
    stats = {}
    out = _port_chunked(scene, REFERENCE_CHUNK, stats)
    assert stats["chunks"] == 4 and stats["chunk_passes"] >= 2
    want = recorded[f"{kind}_labels"]
    assert (want != 0).all()
    np.testing.assert_array_equal(out, want)


def test_budget_sends_the_flood_to_time_chunks():
    scene = _moving_scene(5, 12, 8, 12, [(3, 3), (5, 8)], 0.5, 0.08, False)
    bpx = pws.FLOOD_BYTES_PER_PX[False]
    t, h, w = scene[2].shape
    # room for 4-frame chunks with their halos and the labels, not the whole
    budget = 6 * bpx * h * w + t * h * w * pws._CHUNKED_BYTES_PER_PX
    assert t * h * w * bpx > budget
    stats = {}
    out = pws.watershed(*scene, stats=stats, budget_bytes=budget, device="cpu")
    assert (stats["chunks"], stats["chunk_frames"]) == (3, 4)
    assert stats["chunk_floods"] + stats["chunk_skips"] == 3 * stats["chunk_passes"]
    np.testing.assert_array_equal(out.numpy(), _port_chunked(scene, 4))
    # enough for the whole volume, or fewer than 12 frames: no chunks
    for args, kw in ((scene, dict(budget_bytes=t * h * w * bpx)),
                     (tuple(a[:11] for a in scene), dict(budget_bytes=budget))):
        stats = {}
        pws.watershed(*args, stats=stats, device="cpu", **kw)
        assert "chunks" not in stats and stats["jacobi_rounds"] > 0


def test_chunk_that_does_not_fit_raises():
    scene = SCENES["mixed"]()
    t, h, w = scene[2].shape
    per_frame = pws.FLOOD_BYTES_PER_PX[True] * h * w
    assert pws.chunk_frames(t, h, w, 6 * per_frame, True) == 4
    with pytest.raises(MemoryError, match=r"\(16, 24, 32\) volume.*budget of"):
        pws.chunk_frames(t, h, w, 6 * per_frame - 1, True)
    with pytest.raises(MemoryError, match="4-frame chunk"):
        pws.watershed(*scene, budget_bytes=t * per_frame // 4, device="cpu")


def test_chunk_plan_is_the_references():
    """frames_cap = budget // (B_px·H·W) − 2, then the chunk count, then an
    even chunk length."""
    b = pws.FLOOD_BYTES_PER_PX[False] * 100
    assert pws.chunk_frames(30, 10, 10, 12 * b, False) == 10  # cap 10: 3 chunks of 10
    assert pws.chunk_frames(31, 10, 10, 12 * b, False) == 8  # 4 chunks: 8, 8, 8, 7
    assert pws.chunk_frames(12, 10, 10, 8 * b, False) == 6  # cap 6: 2 chunks


def test_kernel_tile_count_fits_its_ints():
    """The sweep kernel counts tiles in 32-bit ints and addresses pixels in
    64-bit: the chunks' volumes at the standard job's 1500×2500 are far
    inside, and a plan past the ints raises."""
    from tobac_flow_tpu_torch.ops.ws_sweeps import launch_plan

    for t in (6, 50, 314):  # a smallest chunk, a deep chunk, a whole day
        assert launch_plan(t, 1500, 2500, 1, 132).n_tiles == t * 25 * 41
    assert launch_plan(2**31 // (25 * 41), 1500, 2500, 1, 132).n_tiles < 2**31
    with pytest.raises(ValueError, match="tiles"):
        launch_plan(2**31 // (25 * 41) + 1, 1500, 2500, 1, 132)


def _bench_bt(t=5, h=40, w=56):
    import bench

    return torch.from_numpy(bench.make_scene(t, h, w))


def test_grouped_pair_flows_bit_equal():
    bt = _bench_bt()
    model = FarnebackFlow()
    kw = dict(vr_steps=1, smoothing_passes=1, interp_method="cubic", device="cpu")
    whole = pair_flows(bt, model, **kw)
    grouped = pair_flows(bt, model, group=3, **kw)
    for a, b in zip(whole, grouped):
        assert torch.equal(a, b)


def test_grouped_fields_bit_equal():
    bt = _bench_bt()
    fwd, bwd = (f.clamp(-20, 20) for f in pair_flows(bt, FarnebackFlow(), device="cpu"))
    radius = adaptive_band_radius(fwd, bwd)
    whole = _detect_fields_stage(bt, fwd, bwd, 5.0, radius)
    for group in (1, 2):
        grouped = _detect_fields_stage(bt, fwd, bwd, 5.0, radius, group=group)
        for a, b in zip(whole, grouped):
            assert torch.equal(a, b)


if __name__ == "__main__":
    # record the JAX package's chunked labels with the reference tests'
    # budgets (their plan: 4-frame chunks)
    import os

    from tobac_flow_tpu.ops.watershed import watershed as jax_watershed

    out = {}
    for kind, make in SCENES.items():
        scene = make()
        os.environ.pop("TFT_WS_HBM_BUDGET_BYTES", None)
        out[f"{kind}_whole"] = np.asarray(jax_watershed(*scene), np.int32)
        os.environ["TFT_WS_HBM_BUDGET_BYTES"] = str(REFERENCE_BUDGETS[kind])
        out[f"{kind}_labels"] = np.asarray(jax_watershed(*scene), np.int32)
        out[f"{kind}_digest"] = np.array(_digest(scene))
    np.savez_compressed(DATA, **out)
    print("recorded", DATA, {k: v.shape for k, v in out.items()})


def test_threaded_job_scene_is_make_scene():
    """``chip_smoke.job_scene`` builds ``bench.make_scene``'s frames in
    threads: the same scene, bit for bit."""
    import bench
    from chip_smoke import job_scene

    np.testing.assert_array_equal(job_scene(5, 30, 40, threads=3), bench.make_scene(5, 30, 40))
