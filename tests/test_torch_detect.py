"""The port's detection chain against the JAX package's, on
``tools/parity_detect.make_multistorm_scene(9, 64, 96)`` with a NaN patch
in the WVD channel (so the anvil watersheds flood +inf edge fields beside
their -1 barriers), in ``cli/common.run_detection``'s order and with its
``DetectionOptions`` defaults: the CLI-default flow, cores, anvil
markers, thick anvils, their relabelling and thin anvils.

- Teacher-forced (the reference's flows in the port's ``Flow``): every
  stage's labels are identical to the reference's, and every stage finds
  at least 3 objects.
- Free (each package with its own flows): equal object counts per stage
  and a mean object IoU ≥ 0.99 (``tools/parity_detect.object_iou``).
- The CLI-default flow: the Farneback tolerances of
  ``test_torch_farneback.py`` inside the storm mask (p99 ≤ 0.01 px, max
  ≤ 0.1 px, rounded equal ≥ 0.999) on every frame where the reference
  reproduces itself to them: where its two flow functions (``create_flow``
  and ``pipeline.device_flow``, the same arithmetic compiled twice)
  agree.  On the early frames the cells are barely there, the flow is
  noise that reaches the ±20 px clip, and variational refinement
  amplifies rounding-level differences into pixels; the reference's
  two functions disagree there by up to 10 px (measured), and so does the port.

The reference's outputs come from one module-scoped fixture, which reads
them as ``tools/record_torch_refs.py`` recorded them
(``tests/data/detect_chain.npz``): the reference's chain compiles its
watershed, about 5 minutes of the suite's time when run live.
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.detect import fused as jfused  # noqa: E402
from tobac_flow_tpu_torch.core.flow import Flow  # noqa: E402
from tobac_flow_tpu_torch.detect import fused  # noqa: E402
from tobac_flow_tpu_torch.detect.chain import DetectionOptions, run_detection  # noqa: E402
from tools.parity_detect import object_iou  # noqa: E402
from tools.record_torch_refs import CHAIN_SHAPE as SHAPE  # noqa: E402
from tools.record_torch_refs import CHAIN_STAGES as STAGES  # noqa: E402
from tools.record_torch_refs import chain_scene as _scene  # noqa: E402

RECORD = Path(__file__).resolve().parent / "data" / "detect_chain.npz"


@pytest.fixture(scope="module")
def ref():
    """The reference's chain: each stage's labels, its ``create_flow``
    flows (``fwd``, ``bwd``) and the same flows from
    ``pipeline.device_flow`` (``fwd_again``, ``bwd_again``), as
    ``tools/record_torch_refs.record_detect_chain`` recorded them."""
    return dict(np.load(RECORD))


@pytest.fixture(scope="module")
def free():
    """The port's chain with its own flows."""
    bt, wvd, swd, times = _scene()
    return run_detection(bt, wvd, swd, times, device="cpu")


def _forced_flow(ref):
    return Flow.from_numpy(ref["fwd"], ref["bwd"], device="cpu")


def test_chain_teacher_forced(ref):
    bt, wvd, swd, times = _scene()
    stats = {}
    out = run_detection(bt, wvd, swd, times, flow=_forced_flow(ref), stats=stats)
    for name in STAGES:
        assert ref[name].max() >= 3, (name, ref[name].max())
        assert out[name].dtype == torch.int32
        assert np.array_equal(ref[name], out[name].numpy()), name
    assert stats["relabel_anvils_n"] == ref["thick_anvil_label"].max()


def test_chain_free(ref, free):
    for name in STAGES:
        mean_iou, _, n_ref, n_port = object_iou(ref[name], free[name].numpy())
        assert n_port == n_ref and mean_iou >= 0.99, (name, mean_iou, n_ref, n_port)


def _within(out, want, mask):
    diff = np.abs(out - want)[mask]
    return (np.percentile(diff, 99) <= 0.01 and diff.max() <= 0.1
            and (np.round(out) == np.round(want))[mask].mean() >= 0.999)


def test_create_flow_cli_defaults(ref, free):
    storm = _scene()[0] < 250
    checked = 0
    for out, want, again in ((free["flow"].forward_flow, ref["fwd"], ref["fwd_again"]),
                             (free["flow"].backward_flow, ref["bwd"], ref["bwd_again"])):
        out = out.numpy()
        assert out.shape == want.shape and np.abs(out).max() <= 20.0
        for t in range(SHAPE[0]):
            if storm[t].any() and _within(again[t], want[t], storm[t]):
                assert _within(out[t], want[t], storm[t]), t
                checked += 1
    assert checked >= 8


def test_core_markers_and_anvil_inputs(ref):
    """The dense stages given the reference's flows: the growth markers are
    identical, and the thick-anvil watershed's inputs hold +inf edges and
    -1 barriers beside positive markers and equal the reference's."""
    bt, wvd, swd, times = _scene()
    flow = _forced_flow(ref)
    dt = np.full((SHAPE[0], 1, 1), 5.0, np.float32)
    o = DetectionOptions()
    for use_wvd in (False, True):  # the CLI's default, and the function's
        want = jfused._core_markers_jit(
            jnp.asarray(bt), jnp.asarray(wvd), jnp.asarray(swd), jnp.asarray(ref["fwd"]),
            jnp.asarray(ref["bwd"]), jnp.asarray(dt), jnp.float32(o.wvd_threshold),
            jnp.float32(o.bt_threshold), use_wvd, jfused._warp_mode_key(), (0, SHAPE[0]),
        )[0]
        got = fused.core_markers(
            torch.from_numpy(bt), torch.from_numpy(wvd), torch.from_numpy(swd),
            flow.forward_flow, flow.backward_flow, torch.from_numpy(dt), o.wvd_threshold,
            o.bt_threshold, use_wvd,
        )
        assert np.asarray(want).any() and np.array_equal(np.asarray(want), got.numpy())

    field = wvd - swd
    markers = ref["anvil_marker_label"]
    want_edges, want_marks = (np.asarray(a) for a in jfused._anvil_pre_jit(
        jnp.asarray(field), jnp.asarray(markers), jnp.asarray(ref["fwd"]),
        jnp.asarray(ref["bwd"]), o.thick_lower, o.thick_upper, o.erode_distance,
        jfused._warp_mode_key(),
    ))
    edges, marks = fused.anvil_pre_watershed(
        torch.from_numpy(field), torch.from_numpy(markers), flow.forward_flow,
        flow.backward_flow, o.thick_lower, o.thick_upper, o.erode_distance,
    )
    edges, marks = edges.numpy(), marks.numpy()
    assert np.isposinf(edges).any() and (marks == -1).any() and (marks > 0).any()
    assert np.array_equal(want_marks, marks)
    assert np.array_equal(want_edges, edges, equal_nan=True)
