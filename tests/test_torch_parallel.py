"""The port's sharded path (``tobac_flow_tpu_torch/parallel``) on gloo
ranks on the CPU, against the JAX package's sharded path on the same mesh
shapes and against the port's single-device functions.

The JAX side ran on a virtual 8-device CPU mesh and is read from
``tests/data/parallel.npz`` (``tools/record_torch_refs.py parallel``,
about 3 minutes): both halo exchanges and flow labelling and the
watershed on a (4, 2) mesh, the detection step given flows (hx 17, warp
radius 6) and the whole chain (flood rounds capped at 64) on a (2, 2)
mesh, and the step computing its own flows (the CLI's refinement and cubic
smoothing) on the (4, 2) mesh.  Each mesh is launched once for the file
(``tests/torch_parallel_cases.py``); the (2, 2) mesh also runs the dry
run's measured job (``parallel.dryrun._job``: the chain, then flow
labelling under its flows) and reports its place in the mesh.  The
single-device checks run here.

Tolerances: halos, masks, labels and the edge field exact (the edge field
as ``tests/test_torch_detect.py`` holds the single-device one); the
in-step flow at ``tests/test_torch_farneback.py``'s bars inside the cold
cloud.  The floods are compared with the JAX package's under the
reference's schedule (``torch_parallel_cases.reference_schedule``, which
skips the port's barrier pre-flood and coarse V-cycle).  Against the
single-device functions, at least the reference test's bars (markers
bit-equal, core labels the same partition, the edge field to 1e-4, anvil
marker labels exact, thick and thin anvils agreeing on 99 % of their
pixels); the port's own schedule gives the single device's floods exactly.

Two places where the port deliberately differs from the JAX package's
sharded path (ROADMAP.md, not inherited), each with a test that shows it:
flow labelling follows every link both ways with the displacement read at
the pixel (the single device's graph), and the flood runs the single
device's schedule (the barrier first, the coarse V-cycle).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tests import torch_parallel_cases as cases  # noqa: E402
from tobac_flow_tpu_torch.core.flow import Flow  # noqa: E402
from tobac_flow_tpu_torch.ops.banded import banded_warp_axis  # noqa: E402
from tobac_flow_tpu_torch.parallel import pipeline as ppipe  # noqa: E402
from tobac_flow_tpu_torch.parallel.launch import launch  # noqa: E402
from tools import record_torch_refs as rec  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def ref():
    return np.load(DATA / "parallel.npz")


@pytest.fixture(scope="module")
def wide():
    return launch(cases.wide_mesh_cases, *rec.PARALLEL_MESH, rec.parallel_label_scenes(),
                  rec.parallel_ws_scenes(), rec.parallel_flow_scene(), rec.PARALLEL_FLOW_STEP,
                  rec.parallel_varying_scene(), device="cpu")


@pytest.fixture(scope="module")
def scene(ref):
    return (*rec.parallel_step_scene(), ref["step_fwd"], ref["step_bwd"])


def _cold(scene):
    """The mask the (2, 2) mesh labels under the chain's flows."""
    return scene[0] < 235.0


def _single_device_chain(scene):
    """The port's single-device stages under the scene's flows: the core
    markers and their flow labels, the anvil marker mask and edge field,
    the anvil markers, and the thick (relabelled) and thin anvils."""
    from tobac_flow_tpu_torch.detect import fused
    from tobac_flow_tpu_torch.detect.detection import (
        detect_anvils, get_anvil_markers, relabel_anvils,
    )
    from tobac_flow_tpu_torch.segment.label import flow_label

    bt, wvd, swd, fwd, bwd = (torch.from_numpy(np.asarray(a)) for a in scene)
    flow = Flow(fwd, bwd)
    dt = torch.full((bt.shape[0], 1, 1), 5.0)
    out = {"core_markers": fused.core_markers(bt, wvd, swd, fwd, bwd, dt, 0.25, 0.5, True)}
    out["core_labels"] = flow_label(flow, out["core_markers"])
    out["anvil_mask"] = fused.anvil_marker_mask(wvd - swd, -5.0)
    out["edges"] = fused.anvil_pre_watershed(wvd - swd, out["anvil_mask"].to(torch.int32), fwd,
                                             bwd, -12.5, -5.0, 2)[0]
    link = {"overlap": 0.5, "absolute_overlap": 4, "min_length": 3}
    markers = get_anvil_markers(flow, wvd - swd, threshold=-5.0, **link)
    thick = detect_anvils(flow, wvd - swd, markers=markers, upper_threshold=-5.0,
                          lower_threshold=-12.5, erode_distance=2, min_length=3)
    out["anvil_marker_labels"] = markers
    out["thick_anvil_labels"] = relabel_anvils(flow, thick, markers=markers, **link)
    out["thin_anvil_labels"] = detect_anvils(flow, wvd + swd, markers=out["thick_anvil_labels"],
                                             upper_threshold=0.0, lower_threshold=-7.5,
                                             erode_distance=2, min_length=3)
    out["flow_labels"] = flow_label(flow, torch.from_numpy(_cold(scene)))
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def step_runs(scene):
    """(the (2, 2) mesh's outputs, the single-device chain's), the latter
    computed here while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        mesh = pool.submit(launch, cases.step_mesh_cases, *rec.PARALLEL_STEP_MESH, *scene,
                           rec.PARALLEL_STEP, _cold(scene), device="cpu")
        single = _single_device_chain(scene)
        return mesh.result(), single


@pytest.fixture(scope="module")
def stepped(step_runs):
    return step_runs[0]


@pytest.fixture(scope="module")
def single(step_runs):
    return step_runs[1]


def _same_partition(a, b, mask):
    pairs = set(zip(a[mask].tolist(), b[mask].tolist()))
    return len(pairs) == len({x for x, _ in pairs}) == len({y for _, y in pairs})


# -- the launcher ----------------------------------------------------------------


def test_launch_returns_rank_0s_view_of_a_gloo_mesh(stepped):
    """``launch(device="cpu")`` starts gloo ranks and returns rank 0's
    result: rank 0 of the (2, 2) mesh at (0, 0), with its t halo from rank
    2 and the fill before it."""
    assert stepped["facts"] == {"rank": 0, "coords": (0, 0), "device": "cpu",
                                "backend": "gloo", "halo": [-1, 0, 2], "world": 4}


def test_dry_run_job_labels_the_chains_flows(stepped, single, scene):
    """The dry run's job labels a mask under the flows that rank 0 holds
    after the chain (each rank gets its tiles of them): the single
    device's ``flow_label`` partition."""
    mask = _cold(scene)
    got = stepped["all_flow_labels"]
    assert mask.sum() > 100 and ((got != 0) == mask).all()
    assert _same_partition(got, single["flow_labels"], mask)
    assert len(np.unique(got[mask])) == len(np.unique(single["flow_labels"][mask]))


# -- halos -------------------------------------------------------------------


@pytest.mark.parametrize("name", ["halo_t", "halo_x"])
def test_halo_exchange_matches_jax(wide, ref, name):
    assert np.array_equal(wide[name], ref[name])


def test_halo_exchange_of_a_bool_mask(wide):
    """Bool tiles travel as uint8 and come back bool; the domain's edges
    take the fill."""
    got = wide["halo_x_bool"]
    assert got.dtype == bool and got.shape == (4, 4, 40)
    mask = np.arange(4 * 4 * 32).reshape(4, 4, 32) % 3 == 0
    assert got[..., :2].all() and got[..., -2:].all()
    assert np.array_equal(got[..., 2:18], mask[..., :16])
    assert np.array_equal(got[..., 18:20], mask[..., 16:18])  # tile 0's right halo
    assert np.array_equal(got[..., 20:22], mask[..., 14:16])  # tile 1's left halo


# -- flow labelling ----------------------------------------------------------


@pytest.mark.parametrize("name", ["label_noise", "label_hop", "label_hop_still"])
def test_sharded_flow_label_matches_jax(wide, ref, name):
    assert np.array_equal(wide[name], ref[name])


def test_sharded_flow_label_zero_flow_matches_scipy(wide):
    from scipy import ndimage as ndi

    mask = rec.parallel_label_scenes()["label_noise"][0]
    out = wide["label_noise"]
    want, _ = ndi.label(mask, structure=ndi.generate_binary_structure(3, 1))
    assert ((out != 0) == mask).all() and _same_partition(out, want, mask)


def test_sharded_flow_label_is_the_single_device_partition(wide, ref):
    """Under varying, asymmetric flows the port's labels are
    ``flow_label``'s components; the reference's pull-only labelling
    (recorded) splits some of them."""
    from tobac_flow_tpu_torch.segment.label import flow_label

    mask, fwd, bwd, _ = rec.parallel_varying_scene()
    single = flow_label(Flow(torch.from_numpy(fwd), torch.from_numpy(bwd)),
                        torch.from_numpy(mask)).numpy()
    got, jax_labels = wide["label_varying"], ref["label_varying"]
    assert ((got != 0) == mask).all() and _same_partition(got, single, mask)
    assert len(np.unique(got[mask])) == len(np.unique(single[mask]))
    assert len(np.unique(jax_labels[mask])) > len(np.unique(single[mask]))


def test_sharded_flow_label_links_through_flow(wide):
    mask = rec.parallel_label_scenes()["label_hop"][0]
    assert len(np.unique(wide["label_hop"][mask])) == 1
    assert len(np.unique(wide["label_hop_still"][mask])) == mask.shape[0]


# -- the watershed -----------------------------------------------------------


@pytest.mark.parametrize("name", ["ws_cross", "ws_xwall", "ws_ywall", "ws_basins"])
def test_sharded_watershed_matches_jax(wide, ref, name):
    assert np.array_equal(wide[name], ref[name])


def test_sharded_watershed_crosses_tiles_without_wrapping(wide):
    """One marker floods both x tiles; walls of masked-out pixels stop the
    flood, and nothing reaches round the domain's edges."""
    assert (wide["ws_cross"] == 7).all()
    assert (wide["ws_xwall"][:, :, :30] == 3).all() and (wide["ws_xwall"][:, :, 30:] == 0).all()
    assert (wide["ws_ywall"][:, :7] == 5).all() and (wide["ws_ywall"][:, 7:] == 0).all()


def test_sharded_watershed_matches_single_device(wide):
    from tobac_flow_tpu_torch.ops.watershed import watershed

    field, markers, fwd, bwd, _, _ = rec.parallel_ws_scenes()["ws_basins"]
    single = watershed(torch.from_numpy(fwd), torch.from_numpy(bwd), torch.from_numpy(field),
                       torch.from_numpy(markers), device="cpu").numpy()
    sharded = wide["ws_basins_own"]
    assert (sharded != 0).all() and np.array_equal(sharded, single)
    assert np.array_equal(wide["ws_basins"], sharded)  # the reference's schedule too


def test_sharded_watershed_refuses_seeds_past_the_label_bits(wide):
    """Labels past 2^23 - 3 would spill into the packed hop bits: every
    rank raises."""
    assert "must lie in [-1, 8388605]" in wide["seed_contract"]


# -- the detection step and the whole chain ------------------------------------


def test_in_step_flow_matches_jax(wide, ref):
    """The step's own flow (per-tile normalisation, Farneback, one
    refinement step, cubic smoothing, hx 4) at the Farneback test's bars
    inside the cold cloud."""
    cloud = rec.parallel_flow_scene()[0] < 260.0
    for name in ("flow_step_fwd", "flow_step_bwd"):
        got, want = wide[name], ref[name]
        assert got.shape == want.shape and np.isfinite(got).all()
        diff = np.abs(got - want)[cloud]
        assert np.percentile(diff, 99) <= 0.01 and diff.max() <= 0.1
        assert (np.round(got) == np.round(want))[cloud].mean() >= 0.999


@pytest.mark.parametrize("name", ["core_markers", "core_labels", "edges", "thick_labels",
                                  "anvil_mask"])
def test_sharded_detect_step_matches_jax(stepped, ref, name):
    got, want = stepped[f"step_{name}"], ref[f"step_{name}_out"]
    assert np.array_equal(got, want, equal_nan=name == "edges")


@pytest.mark.parametrize("name", ["core_markers", "core_labels", "anvil_marker_mask",
                                  "anvil_marker_labels", "thick_anvil_labels",
                                  "thin_anvil_labels"])
def test_sharded_detect_all_matches_jax(stepped, ref, name):
    """With the reference's flood schedule, every output is the JAX
    package's."""
    assert np.array_equal(stepped[f"all_ref_{name}"], ref[f"all_{name}"])


def test_sharded_detect_all_keeps_the_injected_flows(stepped, scene):
    assert np.array_equal(stepped["all_forward_flow"], scene[3])
    assert np.array_equal(stepped["all_backward_flow"], scene[4])
    for prefix in ("all", "all_ref"):
        stats = stepped[f"{prefix}_stats"]
        assert stats["thick_flood_rounds"] < 64 and stats["thin_flood_rounds"] < 64


def test_sharded_step_matches_single_device(stepped, single):
    """The reference test's bars against the port's single-device stages
    under the same flows."""
    markers = single["core_markers"]
    assert np.array_equal(stepped["step_core_markers"], markers) and markers.sum() > 50
    core = stepped["step_core_labels"]
    assert ((core != 0) == markers).all()
    assert _same_partition(core, single["core_labels"], markers)
    assert np.array_equal(stepped["step_anvil_mask"], single["anvil_mask"])
    edges, got = single["edges"], stepped["step_edges"]
    assert np.array_equal(np.isposinf(got), np.isposinf(edges))
    ok = np.isfinite(got)
    np.testing.assert_allclose(got[ok], edges[ok], rtol=0, atol=1e-4)


def test_sharded_detect_all_matches_single_device(stepped, single):
    markers = single["anvil_marker_labels"]
    assert markers.max() >= 1
    for prefix in ("all", "all_ref"):
        assert np.array_equal(stepped[f"{prefix}_anvil_marker_labels"], markers)
    for key in ("thick_anvil_labels", "thin_anvil_labels"):
        want = single[key]
        assert want.max() >= 1
        # the port's schedule: the single device's labels
        assert np.array_equal(stepped[f"all_{key}"], want), key
        # the reference's: its test's bar
        got = stepped[f"all_ref_{key}"]
        both = (got != 0) | (want != 0)
        assert (got[both] == want[both]).mean() >= 0.99, key


# -- the one-axis banded warp ---------------------------------------------------


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("mode", ["constant", "edge"])
def test_banded_warp_axis_matches_jax(ref, axis, mode):
    img, disp, radius = rec.banded_axis_case()
    got = banded_warp_axis(torch.from_numpy(img), torch.from_numpy(disp), axis, radius,
                           pad_mode=mode).numpy()
    assert np.array_equal(got, ref[f"banded_axis{axis}_{mode}"], equal_nan=True)


@pytest.mark.parametrize("dyx", [-1, 1])
def test_stencil_gather_matches_jax(ref, dyx):
    data_h, flow, taps = rec.stencil_case()
    got = ppipe._stencil_gather(torch.from_numpy(data_h), torch.from_numpy(flow), dyx, taps,
                                float("nan"))
    assert np.array_equal(torch.stack(got).numpy(), ref[f"stencil_{dyx}"], equal_nan=True)
