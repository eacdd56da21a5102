"""The detection chain's stages in time chunks (``budget_bytes``), on the
CPU at small shapes, one torch thread.

- Each chunked stage against its whole-volume form in the port:
  identical labels, masks and edge fields; float64 sums to rtol 1e-12 and
  float32 means to 1e-5 in the output dataset.
- Against the JAX package's chunked drivers with the reference tests'
  own budgets (``tests/test_fused_detect.py``: ``BUDGET_PX = 1``, 4-frame
  chunks; ``tests/test_convolve.py``: 4-frame convolve chunks): the
  chunked convolve and core markers identical, the chunked anvil
  watershed inputs identical in the markers and within the reference
  test's 1e-5 in the edges.  The JAX side takes about a minute on one
  core, so its flows and outputs are recorded in
  ``tests/data/chunked_chain.npz``, by running this module from the repo
  root::

      PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_chunked_chain.py

- ``cli.common.run_detection`` under a budget that forces 4-frame chunks
  on the anvil stages gives the unchunked run's dataset; a budget under
  one 4-frame chunk raises MemoryError naming the stage.
"""

from pathlib import Path

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from chip_smoke import chain_inputs, chain_times, compare_datasets  # noqa: E402
from tobac_flow_tpu_torch import device as dev  # noqa: E402
from tobac_flow_tpu_torch.cli import common  # noqa: E402
from tobac_flow_tpu_torch.core.flow import Flow  # noqa: E402
from tobac_flow_tpu_torch.detect import analysis, fused  # noqa: E402
from tobac_flow_tpu_torch.detect.chain import DetectionOptions  # noqa: E402
from tobac_flow_tpu_torch.ops.ccl import flat_label  # noqa: E402
from tobac_flow_tpu_torch.ops.convolve import convolve, nanmean0  # noqa: E402
from tobac_flow_tpu_torch.segment.label import link_labels_by_overlap  # noqa: E402
from tobac_flow_tpu_torch.utils import labels as lab  # noqa: E402
from tools.parity_detect import make_multistorm_scene  # noqa: E402

DATA = Path(__file__).resolve().parent / "data" / "chunked_chain.npz"
SCENE = dict(t=10, h=64, w=96, seed=4)  # tests/test_fused_detect.py's scene, narrower
CONVOLVE = (30, 24, 32)  # tests/test_convolve.py's chunked case
CHAIN = (11, 32, 48)
MIN = dev.MIN_CHUNK_FRAMES


def budget(shape, per_px, frames=MIN, halo=0, out_per_px=0):
    """A ``budget_bytes`` under which a stage of ``per_px`` bytes a pixel
    over ``shape`` runs in chunks of ``frames`` (evened out)."""
    t, h, w = shape
    return (frames + 2 * halo) * per_px * h * w + out_per_px * t * h * w


@pytest.fixture(scope="module")
def rec():
    with np.load(DATA) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def scene(rec):
    flow = Flow(torch.from_numpy(rec["fwd"]), torch.from_numpy(rec["bwd"]))
    bt, wvd, swd = (torch.from_numpy(rec[k]) for k in ("bt", "wvd", "swd"))
    return flow, bt, wvd, swd


def test_convolve_chunked_matches_whole_and_jax(rec):
    rng = np.random.default_rng(3)
    t, h, w = CONVOLVE
    data = torch.from_numpy(rng.normal(290, 5, (t, h, w)).astype(np.float32))
    fwd = torch.from_numpy(rng.uniform(-2, 2, (t, h, w, 2)).astype(np.float32))
    bwd = torch.from_numpy(rng.uniform(-2, 2, (t, h, w, 2)).astype(np.float32))
    kw = dict(structure=np.ones((3, 3, 3)), func=nanmean0)
    whole = convolve(data, fwd, bwd, **kw)
    per_px = 27 * dev.CONVOLVE_BYTES_PER_TAP_PX + 4
    chunked = convolve(data, fwd, bwd, budget_bytes=budget(CONVOLVE, per_px, 4, 1, 4), **kw)
    assert torch.equal(whole, chunked)
    np.testing.assert_array_equal(chunked.numpy(), rec["convolve_chunked"])
    stack = convolve(data, fwd, bwd, structure=np.ones((3, 3, 3)))
    stack_chunked = convolve(data, fwd, bwd, structure=np.ones((3, 3, 3)),
                             budget_bytes=budget(CONVOLVE, per_px + 26 * 4, 4, 1, 27 * 4))
    assert stack.shape == (27,) + CONVOLVE
    np.testing.assert_array_equal(stack.numpy(), stack_chunked.numpy())  # NaN in place


def _core_markers(scene, rec, budget_bytes):
    flow, bt, wvd, swd = scene
    dt = torch.from_numpy(rec["dt"]).view(-1, 1, 1)
    return fused.core_markers(bt, wvd, swd, flow.forward_flow, flow.backward_flow, dt, 0.25,
                              0.5, True, budget_bytes=budget_bytes)


def test_core_markers_chunked_matches_whole_and_jax(scene, rec):
    shape = scene[1].shape
    whole = _core_markers(scene, rec, None)
    stats = {}
    with dev.stage("cores", stats, torch.device("cpu")):
        chunked = _core_markers(scene, rec, budget(shape, dev.CORE_MARKERS_BYTES_PER_PX, 4, 1, 1))
    assert stats["cores_chunks"] == 3 and stats["cores_chunk_frames"] == 4
    assert int(whole.sum()) > 0 and torch.equal(whole, chunked)
    np.testing.assert_array_equal(chunked.numpy(), rec["core_markers"])


def test_anvil_stages_chunked_match_whole_and_jax(scene, rec):
    flow, _, wvd, swd = scene
    field = wvd - swd
    markers = torch.from_numpy(rec["anvil_markers"])
    assert int(markers.max()) > 0
    shape = field.shape
    mask = fused.anvil_marker_mask(field, -5.0)
    assert torch.equal(mask, fused.anvil_marker_mask(
        field, -5.0, budget_bytes=budget(shape, dev.MARKER_MASK_BYTES_PER_PX, 4, 0, 1)))
    args = (field, markers, flow.forward_flow, flow.backward_flow, -12.5, -5.0, 2)
    edges, seeds = fused.anvil_pre_watershed(*args)
    edges_c, seeds_c = fused.anvil_pre_watershed(
        *args, budget_bytes=budget(shape, dev.ANVIL_PRE_BYTES_PER_PX, 4, 2, 8))
    assert torch.equal(edges, edges_c) and torch.equal(seeds, seeds_c)
    # the JAX package's own chunked edges hold its whole-volume edges to 1e-5
    np.testing.assert_array_equal(seeds_c.numpy(), rec["anvil_seeds"])
    ref = rec["anvil_edges"]
    assert np.array_equal(np.isfinite(ref), np.isfinite(edges_c.numpy()))
    ok = np.isfinite(ref)
    assert np.allclose(edges_c.numpy()[ok], ref[ok], atol=1e-5, rtol=0)
    raw = torch.where(seeds > 0, seeds, 0) + torch.roll(seeds.clamp(min=0), 3, 2)
    post = fused.anvil_post_watershed(raw, markers)
    assert torch.equal(post, fused.anvil_post_watershed(
        raw, markers, budget_bytes=budget(shape, dev.ANVIL_POST_BYTES_PER_PX, 4, 0, 4)))


def test_labelling_chunked_matches_whole(scene, rec):
    """``flat_label`` numbers components as scipy does frame by frame;
    the overlap link, step labels and per-label tables are the whole
    volume's."""
    flow = scene[0]
    mask = torch.from_numpy(rec["core_markers"]) | (scene[1] > 288.2)
    shape = mask.shape
    small = budget(shape, dev.LABEL_BYTES_PER_PX, 4, 0, 4)
    flat = flat_label(mask)
    chunked = flat_label(mask, budget_bytes=small)
    expect, count = np.zeros(shape, np.int32), 0
    for i, frame in enumerate(mask.numpy()):
        lab_i, n = ndi.label(frame)
        expect[i] = np.where(lab_i > 0, lab_i + count, 0)
        count += n
    assert count > 50
    np.testing.assert_array_equal(chunked.numpy(), expect)
    assert torch.equal(flat, chunked)
    kw = dict(overlap=0.5, absolute_overlap=4)
    linked = link_labels_by_overlap(flow, flat, **kw)
    linked_c = link_labels_by_overlap(
        flow, flat, budget_bytes=budget(shape, dev.LINK_BYTES_PER_PX, 4, 1, 4), **kw)
    assert int(linked.max()) < count and torch.equal(linked, linked_c)
    table = budget(shape, dev.LABEL_TABLE_BYTES_PER_PX, 4)
    steps = budget(shape, dev.LABEL_BYTES_PER_PX, 4)
    for whole, part in [
        (lab.make_step_labels(linked), lab.make_step_labels(linked, steps)),
        (lab.slice_labels(linked), lab.slice_labels(linked, table)),
        (lab.remap_labels(linked, np.arange(int(linked.max())) % 3 == 0),
         lab.remap_labels(linked, np.arange(int(linked.max())) % 3 == 0, budget_bytes=table)),
    ]:
        assert int(whole.max()) > 0 and torch.equal(whole, part)
    np.testing.assert_array_equal(lab.unique_labels(linked), lab.unique_labels(linked, table))
    np.testing.assert_array_equal(analysis.find_object_lengths(linked),
                                  analysis.find_object_lengths(linked, budget_bytes=table))
    hit = scene[1] < 230
    np.testing.assert_array_equal(analysis.mask_labels(linked, hit),
                                  analysis.mask_labels(linked, hit, budget_bytes=table))


def _chain_run(budget_bytes, stats):
    bt, wvd, swd = make_multistorm_scene(*CHAIN)
    wvd[3:6, 10:14, 20:24] = np.nan  # missing data at a cell's edge
    fwd = torch.zeros(CHAIN + (2,))
    fwd[..., 0], fwd[..., 1] = 2.0, 0.5  # the scene's own advection
    flow = Flow(fwd, -fwd)
    fields, ds = chain_inputs(bt, wvd, swd, chain_times(CHAIN[0]))
    opts = DetectionOptions(flow_factory=lambda _: flow)
    return common.run_detection(*fields, ds, opts=opts, device="cpu", stats=stats,
                                budget_bytes=budget_bytes)


def test_run_detection_chunked_gives_the_whole_dataset():
    """The anvil stages in 4-frame chunks (at 11 frames the floods stay
    whole); then the output stages in 4-frame chunks."""
    whole = _chain_run(None, {})
    stats = {}
    chunked = _chain_run(budget(CHAIN, dev.ANVIL_PRE_BYTES_PER_PX, 4, 2, 8), stats)
    assert stats["thick_anvils_chunk_frames"] == 4 and stats["thin_anvils_chunks"] == 3
    assert stats["thick_anvils_flood_chunks"] == 1
    assert min(whole.coords[c].size for c in ("core", "anvil", "thick_anvil_step")) > 0
    compare_datasets(whole, chunked)
    out_stats = {}
    small = budget(CHAIN, dev.OUTPUT_BYTES_PER_PX, 4)
    ds = common.prepare_output(
        _strip(whole), *_fields(), device="cpu", stats=out_stats, budget_bytes=small)
    assert out_stats["field_props_chunks"] == 3 and out_stats["label_props_chunks"] == 3
    assert out_stats["schema_chunk_frames"] == 4
    compare_datasets(whole, ds)


def _fields():
    bt, wvd, swd = make_multistorm_scene(*CHAIN)
    wvd[3:6, 10:14, 20:24] = np.nan
    return chain_inputs(bt, wvd, swd, chain_times(CHAIN[0]))[0]


def _strip(ds):
    """A dataset holding only the three label volumes of ``ds``."""
    fields, out = chain_inputs(*(f.values for f in _fields()), chain_times(CHAIN[0]))
    for name in ("core_label", "thick_anvil_label", "thin_anvil_label"):
        out[name] = ds[name].__class__(ds[name].values.copy(), dims=ds[name].dims,
                                       attrs=ds[name].attrs)
    return out


def test_residency_is_a_no_op_on_the_cpu():
    """On the CPU nothing waits elsewhere: ``park`` moves nothing and
    ``place`` gives a CPU tensor."""
    vols = {"bt": torch.ones(3, 4, 4)}
    assert dev.park(vols, set(), "cpu", need=1 << 60) == []
    assert vols["bt"].device.type == "cpu"
    assert dev.place(np.ones((3, 4, 4), np.float32), "cpu").device.type == "cpu"


@pytest.mark.parametrize("what, call", [
    ("core_markers", lambda s, r, b: _core_markers(s, r, b)),
    ("anvil_pre_watershed", lambda s, r, b: fused.anvil_pre_watershed(
        s[2] - s[3], torch.from_numpy(r["anvil_markers"]), s[0].forward_flow,
        s[0].backward_flow, -12.5, -5.0, 2, budget_bytes=b)),
    ("flat_label", lambda s, r, b: flat_label(s[2] > -1.0, budget_bytes=b)),
])
def test_budget_under_one_chunk_raises(scene, rec, what, call):
    with pytest.raises(MemoryError, match=what):
        call(scene, rec, 1000)


if __name__ == "__main__":
    # record the JAX package's flows and chunked outputs with the reference
    # tests' budgets
    import sys

    import jax.numpy as jnp

    from tests.synthetic import growing_storm_scene
    from tobac_flow_tpu.core.flow import create_flow
    from tobac_flow_tpu.detect import get_anvil_markers
    from tobac_flow_tpu.detect import fused as jfused
    from tobac_flow_tpu.utils.datetime_utils import get_time_diff_from_coord

    conv = sys.modules["tobac_flow_tpu.ops.convolve"]
    rng = np.random.default_rng(3)
    t, h, w = CONVOLVE
    data = rng.normal(290, 5, (t, h, w)).astype(np.float32)
    cf = rng.uniform(-2, 2, (t, h, w, 2)).astype(np.float32)
    cb = rng.uniform(-2, 2, (t, h, w, 2)).astype(np.float32)
    conv.BUDGET_TAP_PX = 27 * 4 * h * w  # the reference test's 4-frame chunks
    out = {"convolve_chunked": np.asarray(conv.convolve(
        data, cf, cb, structure=np.ones((3, 3, 3)), func=lambda x: jnp.nanmean(x, axis=0)))}

    bt, wvd, swd = growing_storm_scene(**SCENE)
    flow = create_flow(np.asarray(bt.values), vr_steps=1, smoothing_passes=1,
                       interp_method="cubic")
    jfused.BUDGET_PX = 1  # the reference tests' budget: 4-frame chunks
    markers, _, _ = jfused.fused_core_markers(flow, bt, wvd, swd, use_wvd=True,
                                              wvd_threshold=0.25, bt_threshold=0.5)
    jfused.BUDGET_PX = 20_000_000
    anvil = np.asarray(get_anvil_markers(flow, wvd - swd, threshold=-5.0, overlap=0.5,
                                         absolute_overlap=4).values, np.int32)
    jfused.BUDGET_PX = 1
    edges, seeds = jfused.fused_anvil_pre_watershed(flow, wvd - swd, anvil, -12.5, -5.0, 2)
    out.update(
        bt=np.asarray(bt.values, np.float32), wvd=np.asarray(wvd.values, np.float32),
        swd=np.asarray(swd.values, np.float32),
        dt=np.asarray(get_time_diff_from_coord(bt.t), np.float32),
        fwd=np.asarray(flow.forward_flow, np.float32),
        bwd=np.asarray(flow.backward_flow, np.float32),
        core_markers=np.asarray(markers, bool), anvil_markers=anvil,
        anvil_edges=np.asarray(edges, np.float32), anvil_seeds=np.asarray(seeds, np.int32),
    )
    np.savez_compressed(DATA, **out)
    print("recorded", DATA, {k: (v.shape, v.dtype) for k, v in out.items()},
          "core marker px", int(out["core_markers"].sum()), "anvil markers", int(anvil.max()))
