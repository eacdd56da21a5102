"""Record the JAX package's outputs that the port's CPU tests compare
against, where the JAX side takes more than a few seconds to run live
(its watershed compiles, its iterative flow models trace), into
``tests/data/``.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_torch_refs.py [NAME ...]

NAME is any of ``flow_qc``, ``detect_chain``, ``flow_models``,
``subsegment``, ``configured_chain``, ``fused_scene``, ``legacy`` and
``parallel`` (all by default; ``parallel`` runs on a virtual 8-device CPU
mesh); each writes
``tests/data/NAME.npz``.  The scenes and settings are
defined here and imported by the tests, so that a test reads exactly what
was recorded for it.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parents[1] / "tests" / "data"

# -- the detection chain (tests/test_torch_detect.py) ---------------------

CHAIN_SHAPE = (9, 64, 96)
CHAIN_STAGES = ("core_label", "anvil_marker_label", "thick_anvil_label", "thin_anvil_label")


def chain_scene():
    """``make_multistorm_scene(9, 64, 96)`` with a NaN patch in WVD at a
    cell's edge, and its 5-minute time coordinate."""
    from tools.parity_detect import make_multistorm_scene

    bt, wvd, swd = make_multistorm_scene(*CHAIN_SHAPE)
    wvd[3:6, 20:26, 40:46] = np.nan  # missing data at a cell's edge
    times = (np.datetime64("2020-06-01T00:00", "ns")
             + np.arange(CHAIN_SHAPE[0]) * np.timedelta64(300, "s"))
    return bt, wvd, swd, times


def jax_chain(flow, bt, wvd, swd, opts):
    """The JAX package's stages of ``cli.common.run_detection`` with the
    thresholds of ``opts`` (a ``DetectionOptions``): cores, anvil markers,
    thick anvils, their relabelling and thin anvils."""
    from tobac_flow_tpu.detect import (
        detect_anvils, detect_cores, get_anvil_markers, relabel_anvils,
    )
    from tools.parity_detect import _da

    o = opts
    bt, wvd, swd = _da(bt, "bt"), _da(wvd, "wvd"), _da(swd, "swd")
    cores = detect_cores(flow, bt, wvd, swd, wvd_threshold=o.wvd_threshold,
                         bt_threshold=o.bt_threshold, overlap=o.overlap,
                         absolute_overlap=o.absolute_overlap,
                         subsegment_shrink=o.subsegment_shrink, min_length=o.t_offset,
                         use_wvd=o.use_wvd)
    markers = get_anvil_markers(flow, wvd - swd, threshold=o.thick_upper, overlap=o.overlap,
                                absolute_overlap=o.absolute_overlap,
                                subsegment_shrink=o.subsegment_shrink, min_length=o.t_offset)
    thick = detect_anvils(flow, wvd - swd, markers=markers, upper_threshold=o.thick_upper,
                          lower_threshold=o.thick_lower, erode_distance=o.erode_distance,
                          min_length=o.t_offset)
    thick = relabel_anvils(flow, thick, markers=markers, overlap=o.overlap,
                           absolute_overlap=o.absolute_overlap, min_length=o.t_offset)
    thin = detect_anvils(flow, wvd + swd, markers=thick, upper_threshold=o.thin_upper,
                         lower_threshold=o.thin_lower, erode_distance=o.erode_distance,
                         min_length=o.t_offset)
    return {k: np.asarray(v.values) for k, v in zip(CHAIN_STAGES, (cores, markers, thick, thin))}


def record_detect_chain():
    """The CLI-default chain: its flows (``create_flow``), the same flows
    from ``pipeline.device_flow``, and each stage's labels."""
    import jax.numpy as jnp

    from tobac_flow_tpu import pipeline as jax_pipeline
    from tobac_flow_tpu.cli.common import DetectionOptions
    from tobac_flow_tpu.core.flow import create_flow

    bt, wvd, swd, _ = chain_scene()
    o = DetectionOptions()
    flow = create_flow(bt, vr_steps=o.vr_steps, smoothing_passes=o.smoothing_passes,
                       interp_method=o.interp_method)
    out = jax_chain(flow, bt, wvd, swd, o)
    out.update(fwd=np.asarray(flow.forward_flow), bwd=np.asarray(flow.backward_flow))
    again = jax_pipeline.device_flow(jnp.asarray(bt), vr_steps=o.vr_steps,
                                     smoothing_passes=o.smoothing_passes,
                                     interp_method=o.interp_method)
    out.update(fwd_again=np.asarray(again[0]), bwd_again=np.asarray(again[1]))
    return out


# -- the configured chain (tests/test_torch_subsegment.py) ---------------------

CONFIGURED = {"flow_model": "DIS", "interp_method": "lanczos", "subsegment_shrink": 0.1}


def record_configured_chain():
    """The chain under ``PipelineConfig(**CONFIGURED)``: its flows and each
    stage's labels."""
    from tobac_flow_tpu.config import PipelineConfig
    from tobac_flow_tpu.core.flow import create_flow

    bt, wvd, swd, _ = chain_scene()
    o = PipelineConfig(**CONFIGURED).detection_options()
    flow = create_flow(bt, model=o.flow_model, vr_steps=o.vr_steps,
                       smoothing_passes=o.smoothing_passes, interp_method=o.interp_method)
    out = jax_chain(flow, bt, wvd, swd, o)
    out.update(fwd=np.asarray(flow.forward_flow), bwd=np.asarray(flow.backward_flow))
    return out


# -- the flow models (tests/test_torch_flow_models.py) -------------------------

MODEL_SHAPE = (64, 96)  # two pyramid levels for every model
MODELS = {  # name: (JAX module, pair function, params class)
    "DIS": ("dis", "dis_pair", "DISParams"),
    "DualTVL1": ("tvl1", "tvl1_pair", "TVL1Params"),
    "DeepFlow": ("deepflow", "deepflow_pair", "DeepFlowParams"),
    "PCA": ("pcaflow", "pcaflow_pair", "PCAFlowParams"),
    "SimpleFlow": ("simpleflow", "simpleflow_pair", "SimpleFlowParams"),
    "SparseToDense": ("sparse_to_dense", "sparse_to_dense_pair", "SparseToDenseParams"),
}
NORMALISATIONS = ("linear", "z_score", "log", "inverse_log")


def blob_pair(h, w, shift, seed, depth=60.0):
    """An anvil-like blob advecting by ``shift`` (x, y) px over noise: two
    (H, W) float32 BT frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(2):
        r2 = (xx - 0.4 * w - shift[0] * i) ** 2 + (yy - 0.45 * h - shift[1] * i) ** 2
        frames.append(290.0 - depth * np.exp(-r2 / (2 * (h / 7) ** 2)))
    return (np.stack(frames).astype(np.float32)
            + rng.normal(0, 0.3, (2, h, w)).astype(np.float32))


def model_pairs():
    """Two different frame pairs (2, 2, H, W): a blob moving (2.5, 1.25)
    px and a shallower one moving (-1.5, 2.0) px."""
    return np.stack([blob_pair(*MODEL_SHAPE, (2.5, 1.25), 0),
                     blob_pair(*MODEL_SHAPE, (-1.5, 2.0), 1, depth=40.0)])


def record_flow_models():
    """Each model's JAX pair flow on each pair's quantised frames, and the
    JAX ``batch_flow`` (Farneback) of the first pair under each jitted
    normalisation."""
    import importlib

    import jax

    from tobac_flow_tpu.models import _normalise_pair, batch_flow

    pairs = model_pairs()
    out = {}
    for i, (a, b) in enumerate(pairs):
        p8, n8 = jax.jit(lambda x, y: _normalise_pair(x, y, "linear"))(a, b)
        for name, (mod, fn, params) in MODELS.items():
            m = importlib.import_module(f"tobac_flow_tpu.models.{mod}")
            pair = jax.jit(lambda x, y: getattr(m, fn)(x, y, getattr(m, params)()))
            out[f"{name}_{i}"] = np.asarray(pair(p8, n8))
            print(name, i, flush=True)
    for method in NORMALISATIONS:
        fwd, bwd = batch_flow(pairs[0], normalisation_method=method)
        out[f"norm_{method}_fwd"] = np.asarray(fwd)[0]
        out[f"norm_{method}_bwd"] = np.asarray(bwd)[1]
        print(method, flush=True)
    return out


# -- subsegmentation (tests/test_torch_subsegment.py) ------------------------


def discs_and_bridge():
    """The reference tests' scene: two discs joined by a thin bridge, one
    frame (1, 40, 80)."""
    h, w = 40, 80
    yy, xx = np.mgrid[0:h, 0:w]
    mask = ((xx - 20) ** 2 + (yy - 20) ** 2 < 100) | ((xx - 60) ** 2 + (yy - 20) ** 2 < 100)
    mask |= (np.abs(yy - 20) <= 1) & (xx >= 20) & (xx <= 60)
    return mask[None]


def seeded_mask(t=4, h=48, w=64, seed=0):
    """Smoothed noise above a threshold: many touching, irregular blobs."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    return ndi.gaussian_filter(rng.normal(size=(t, h, w)), (0, 3, 3)) > 0.05


def seeded_flows(shape, seed=1):
    """Smooth (T, H, W, 2) forward and backward flows within ±3 px."""
    import scipy.ndimage as ndi

    rng = np.random.default_rng(seed)
    f = ndi.gaussian_filter(rng.normal(size=(2,) + shape + (2,)), (0, 0, 6, 6, 0))
    f = 3.0 * f / np.abs(f).max()
    return f[0].astype(np.float32), f[1].astype(np.float32)


SUBSEGMENT_SHRINK = {"discs": 0.2, "seeded": 0.1}


def record_subsegment():
    """``subsegment_labels`` on the two scenes, and ``flow_label`` with
    ``subsegment_shrink=0.1`` on the seeded mask given the seeded flows."""
    from tobac_flow_tpu.core.flow import Flow
    from tobac_flow_tpu.segment.label import flow_label
    from tobac_flow_tpu.segment.subsegment import subsegment_labels

    mask = seeded_mask()
    out = {
        "discs": subsegment_labels(discs_and_bridge(), SUBSEGMENT_SHRINK["discs"]),
        "seeded": subsegment_labels(mask, SUBSEGMENT_SHRINK["seeded"]),
    }
    fwd, bwd = seeded_flows(mask.shape)
    out["flow_label"] = np.asarray(flow_label(Flow(fwd, bwd), mask, overlap=0.5,
                                              absolute_overlap=4, subsegment_shrink=0.1,
                                              peak_min_distance=5))
    return out


# -- flow QC (tests/test_torch_flow_qc.py) ----------------------------------


def moving_blob(t, h, w, sx):
    """A Gaussian blob moving ``sx`` px a frame along x: (T, H, W)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([200.0 * np.exp(-((xx - 20 - sx * i) ** 2 + (yy - 16) ** 2) / 30.0)
                     for i in range(t)]).astype(np.float32)


QC_MARGIN = 5  # flow_residual_mse_estimate's margin at 32x64


def record_flow_qc():
    """``calculate_flow_2`` of a moving blob against itself shifted 3 px;
    ``create_flow`` of the blob, and ``get_flow_residual`` and
    ``flow_residual_mse_estimate`` given that flow."""
    from tobac_flow_tpu.core.flow import (
        calculate_flow_2, create_flow, flow_residual_mse_estimate, get_flow_residual,
    )

    a = moving_blob(3, 32, 64, 2.0)
    fwd2, bwd2 = calculate_flow_2(a, np.roll(a, 3, axis=2))
    frames = moving_blob(4, 32, 64, 2.0)
    flow = create_flow(frames, model="Farneback")
    residual = get_flow_residual(frames, flow)
    all_sky, cold = flow_residual_mse_estimate(frames, flow, margin=QC_MARGIN,
                                               cold_threshold=100.0)
    return {"flow2_fwd": np.asarray(fwd2), "flow2_bwd": np.asarray(bwd2),
            "fwd": np.asarray(flow.forward_flow), "bwd": np.asarray(flow.backward_flow),
            "residual": np.asarray(residual), "residual_mse": np.array([all_sky, cold])}


# -- the fused slice (tests/test_torch_pipeline.py, test_torch_watershed.py) ---

FUSED_SHAPE = (8, 160, 224)
WS_CASES = (("positive", True), ("positive", False), ("mixed", True))


def fused_scene():
    """``bench.make_scene(*FUSED_SHAPE)``, its markers and their count."""
    import bench

    bt = bench.make_scene(*FUSED_SHAPE)
    markers, n = bench.make_markers(bt)
    return bt, markers, n


def scene_digest(*arrays):
    """A SHA-256 of the arrays' bytes: a recording names the inputs it
    was made from, so a changed scene fails its test instead of reading a
    stale record."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def mixed_markers(markers, field):
    """The markers with a -1 barrier ring around the storms, racing the
    positive labels."""
    mixed = markers.copy()
    mixed[(field > 0.05) & (field < 0.12) & (markers == 0)] = -1
    return mixed


def record_fused_scene():
    """The fields stage of the fused slice (its flows, growth, field and
    edges, which the stage given those flows gives again), the fused
    path's labels, the band radius of those flows, and the whole-volume
    watershed of each ``WS_CASES`` case (markers, multigrid) on its
    edges."""
    import jax.numpy as jnp

    from tobac_flow_tpu import pipeline as jp
    from tobac_flow_tpu.ops import watershed as jws

    bt, markers, _ = fused_scene()
    fwd, bwd, growth, field, edges = (np.array(a) for a in jp._fields_stage(jnp.asarray(bt), 5.0))
    out = {"digest": np.array(scene_digest(bt, markers)), "fwd": fwd, "bwd": bwd,
           "growth": growth, "field": field, "edges": edges,
           "labels": np.array(jp.fused_flow_watershed(jnp.asarray(bt), 5.0, markers=markers)[3])}
    radius = jp.adaptive_band_radius(jnp.asarray(fwd), jnp.asarray(bwd))
    out["radius"] = np.array(radius)
    # the fields stage given the stage's own flows gives its fields again,
    # so they are recorded once
    tf = jp._detect_fields_stage(jnp.asarray(bt), jnp.asarray(fwd), jnp.asarray(bwd), 5.0, radius)
    for a, b in zip(tf, (growth, field, edges)):
        assert np.array_equal(np.asarray(a), b, equal_nan=True)
    kinds = {"positive": markers, "mixed": mixed_markers(markers, field)}
    for kind, multigrid in WS_CASES:
        out[f"ws_{kind}_{multigrid}"] = np.asarray(jws.watershed(
            fwd, bwd, edges, kinds[kind], mask=field > 0.05, max_iters=128,
            multigrid=multigrid))
    return out


# -- the op-by-op filters and the legacy path (tests/test_torch_legacy.py) ----

LEGACY_CROP = (slice(0, 6), slice(20, 44), slice(30, 66))  # the floods' cut of the chain scene
LEGACY_CLI_SHAPE = (8, 48, 64)  # the legacy CLI's synthetic scene
LEGACY_MAX_ITER = 6  # flow_network_watershed's max_iter: 24 rounds


def legacy_inputs():
    """The chain scene, its recorded JAX flows (``detect_chain.npz``) and a
    digest of both, which ``legacy.npz`` keeps to name its inputs."""
    bt, wvd, swd, times = chain_scene()
    ref = np.load(DATA / "detect_chain.npz")
    fwd, bwd = ref["fwd"], ref["bwd"]
    return bt, wvd, swd, times, fwd, bwd, scene_digest(bt, wvd, swd, fwd, bwd)


def record_legacy():
    """On the chain scene given its recorded flows: each op-by-op filter of
    ``detect/detection.py``, the growth markers (WVD alone and
    multichannel); on its crop ``LEGACY_CROP``: ``detect_anvils`` with
    ``markers=None``, ``edge_watershed`` from the multichannel markers and
    the legacy module's functions; and the legacy CLI at
    ``LEGACY_CLI_SHAPE``: its flows, markers and labels as its file holds
    them."""
    import tempfile

    from tobac_flow_tpu import legacy
    from tobac_flow_tpu.cli import dcc_detect_legacy as jcli
    from tobac_flow_tpu.core.flow import Flow
    from tobac_flow_tpu.data.ncdataset import open_dataset
    from tobac_flow_tpu.detect import detection as jd
    from tobac_flow_tpu.ops.convolve import set_plan_frame_k
    from tools.parity_detect import _da

    bt, wvd, swd, _, fwd, bwd, digest = legacy_inputs()
    flow = Flow(fwd, bwd)
    B, W, S = _da(bt, "bt"), _da(wvd, "wvd"), _da(swd, "swd")
    f = wvd - swd
    out = {"digest": np.array(digest)}
    for name, fld, direction in (("bt", bt, "positive"), ("wvd", wvd, "negative"),
                                 ("bt_neg", bt, "negative")):
        out[f"curv_{name}"] = jd.get_curvature_filter(fld, direction=direction)
        out[f"peak_{name}"] = jd.get_peak_filter(fld, sigma=0.5, direction=direction)
    out["growth_cubic"] = jd.get_growth_rate(flow, -B, method="cubic")
    out["growth_linear"] = jd.get_growth_rate(flow, W)
    out["combined"] = jd.get_combined_filters(flow, B, W, S)
    out["combined_bt"] = jd.get_combined_filters(flow, B, W, S, use_wvd=False)
    out["ws_mask"] = jd.get_watershed_mask(f, 2)
    out["edges"] = jd.get_combined_edge_field(flow, f)
    out["tdiff"] = jd.filtered_tdiff(flow, f)
    out["nan_gauss"] = jd.nan_gaussian_filter(np.where(wvd > 0, np.nan, wvd), (0, 1.5, 2))
    out["gm_smoothed"], out["gm_labels"] = jd.detect_growth_markers(flow, W)
    out["gmm_wvd"], out["gmm_bt"], out["gmm_labels"] = jd.detect_growth_markers_multichannel(
        flow, W, B)
    assert np.asarray(out["gm_labels"]).max() > 0 and np.asarray(out["gmm_labels"]).max() > 0

    c = LEGACY_CROP
    crop = Flow(fwd[c], bwd[c])
    out["anvils_none"] = jd.detect_anvils(crop, _da(f[c], "f"), markers=None).values
    markers = np.asarray(out["gmm_labels"])[c]
    out["edge_ws"] = jd.edge_watershed(crop, f[c], markers, -5, -15)
    edges = np.asarray(crop.sobel(np.clip(f[c], -15, -5), method="nearest"))
    mask = f[c] > -12
    out["network_ws"] = legacy.flow_network_watershed(edges, markers, fwd[c], bwd[c], mask=mask,
                                                      max_iter=LEGACY_MAX_ITER)
    out["legacy_label"] = legacy.flow_label(mask, fwd[c], bwd[c], overlap=0.5)
    out["legacy_convolve"] = legacy.flow_convolve_nearest(markers, fwd[c], bwd[c])
    # the linear warp's band plan loses each frame's pixel (0, 0) (ROADMAP.md
    # section 3), which the port does not inherit: its exact warp, plan off
    prev = set_plan_frame_k(0)
    try:
        out["legacy_sobel"] = np.asarray(
            legacy.flow_sobel(f[c], fwd[c], bwd[c], direction="uphill"))
    finally:
        set_plan_frame_k(prev)
    assert np.asarray(out["edge_ws"]).max() > 0 and np.asarray(out["anvils_none"]).max() > 0

    captured = {}

    def create_flow(*args, **kwargs):
        captured["flow"] = jcli_create_flow(*args, **kwargs)
        return captured["flow"]

    jcli_create_flow = jcli.create_flow
    jcli.create_flow = create_flow
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t, y, x = LEGACY_CLI_SHAPE
            ds = open_dataset(jcli.main(["-sd", tmp, "-t", str(t), "-y", str(y), "-x", str(x)]))
            for var in ("growth_markers", "watershed_label"):
                out[f"cli_{var}"] = np.asarray(ds[var].values)
                out[f"cli_{var}_long_name"] = np.array(ds[var].attrs["long_name"])
    finally:
        jcli.create_flow = jcli_create_flow
    out["cli_fwd"] = np.asarray(captured["flow"].forward_flow)
    out["cli_bwd"] = np.asarray(captured["flow"].backward_flow)
    assert out["cli_growth_markers"].max() > 0 and out["cli_watershed_label"].max() > 0
    return {k: np.asarray(getattr(v, "values", v)) for k, v in out.items()}


# -- the sharded path (tests/test_torch_parallel.py) -----------------------

PARALLEL_MESH = (4, 2)  # (n_t, n_x): halos, flow labelling, the watershed
PARALLEL_STEP_MESH = (2, 2)  # the detection step and the whole chain
PARALLEL_STEP = dict(hx=17, warp_radius=6)
PARALLEL_FLOW_STEP = dict(hx=4, ws_sweeps=2, vr_steps=1, smoothing_passes=1,
                          interp_method="cubic", warp_radius=6)


def parallel_label_scenes():
    """Flow labelling: a random mask under zero flow, and an object that
    hops 6 px a frame along x (linked only through the flow): (name ->
    (mask, forward flow, backward flow, halo))."""
    rng = np.random.default_rng(7)
    t, h, w = 8, 16, 64
    zf = np.zeros((t, h, w, 2), np.float32)
    hop = np.zeros((t, h, w), bool)
    for i in range(t):
        hop[i, 6:10, 4 + 6 * i: 8 + 6 * i] = True
    fwd, bwd = zf.copy(), zf.copy()
    fwd[..., 0] = 6.0
    bwd[..., 0] = -6.0
    return {
        "label_noise": (rng.random((t, h, w)) > 0.7, zf, zf, 4),
        "label_hop": (hop, fwd, bwd, 8),
        "label_hop_still": (hop, zf, zf, 8),
    }


def parallel_varying_scene():
    """Flow labelling where the flow varies pixel to pixel (as a refined
    flow does over noise): ``seeded_mask``'s irregular blobs at 8 x 24 x 32
    under independent forward and backward flows drawn uniformly within
    ±3 px: (mask, forward flow, backward flow, halo)."""
    mask = seeded_mask(8, 24, 32, seed=0)
    rng = np.random.default_rng(0)
    fwd, bwd = (rng.uniform(-3, 3, mask.shape + (2,)).astype(np.float32) for _ in range(2))
    return mask, fwd, bwd, 4


def parallel_ws_scenes():
    """The sharded watershed: one marker flooding across the x tiles, x and
    y walls of masked-out pixels, and five advecting basins: (name ->
    (field, markers, forward flow, backward flow, mask, max_rounds))."""
    t, h, w = 8, 16, 64
    zf = np.zeros((t, h, w, 2), np.float32)
    flat = np.zeros((t, h, w), np.float32)
    cross = np.zeros((t, h, w), np.int32)
    cross[0, 4, 5] = 7
    xwall = np.ones((t, h, w), bool)
    xwall[:, :, 30:35] = False
    xseeds = np.zeros((t, h, w), np.int32)
    xseeds[:, :, 2] = 3
    ywall = np.ones((t, h, w), bool)
    ywall[:, 7:10, :] = False
    yseeds = np.zeros((t, h, w), np.int32)
    yseeds[:, 1, :] = 5
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    centres = [(4, 8), (4, 28), (10, 18), (10, 44), (4, 52)]
    basins = np.empty((t, h, w), np.float32)
    for i in range(t):
        basins[i] = 10.0
        for cy, cx in centres:
            basins[i] = np.minimum(basins[i], 0.1 * ((yy - cy) ** 2 + (xx - cx - 1.0 * i) ** 2))
    basins += rng.normal(0, 1e-3, basins.shape).astype(np.float32)
    bseeds = np.zeros((t, h, w), np.int32)
    for k, (cy, cx) in enumerate(centres):
        bseeds[0, cy, cx] = k + 1
    fwd, bwd = zf.copy(), zf.copy()
    fwd[..., 0] = 1.0
    bwd[..., 0] = -1.0
    return {
        "ws_cross": (flat, cross, zf, zf, None, 128),
        "ws_xwall": (flat, xseeds, zf, zf, xwall, 128),
        "ws_ywall": (flat, yseeds, zf, zf, ywall, 128),
        "ws_basins": (basins, bseeds, fwd, bwd, None, 256),
    }


def parallel_step_scene():
    """``growing_storm_scene(8, 48, 64, seed=2)``'s bt, wvd and swd."""
    from tests.synthetic import growing_storm_scene

    return tuple(np.asarray(a.values) for a in growing_storm_scene(t=8, h=48, w=64, seed=2))


def parallel_flow_scene():
    """A cold spot moving 2 px a frame along x, as (bt, wvd, swd) 8 x 16 x 64."""
    t, h, w = 8, 16, 64
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bt = np.stack([290 - 50 * np.exp(-((xx - 16 - 2 * i) ** 2 + (yy - 8) ** 2) / 18.0)
                   for i in range(t)]).astype(np.float32)
    return bt, (250 - bt) * 0.2 - 5, 5 - (290 - bt) * 0.07


def banded_axis_case():
    """An image, fractional displacements within ±5 px and the radius."""
    rng = np.random.default_rng(11)
    img = rng.normal(size=(3, 20, 24)).astype(np.float32)
    disp = rng.uniform(-5, 5, img.shape).astype(np.float32)
    disp[0, :4] = np.round(disp[0, :4])  # whole-pixel displacements stay exact
    return img, disp, 4


def stencil_case():
    """A ±1-frame halo block (T + 2, H, W), flows within ±4 px and the taps."""
    rng = np.random.default_rng(12)
    data_h = rng.normal(size=(4, 16, 20)).astype(np.float32)
    flow = rng.uniform(-4, 4, (2, 16, 20, 2)).astype(np.float32)
    return data_h, flow, ((0, 0), (1, -1), (-1, 1))


def record_parallel():
    """The JAX package's sharded path on a virtual 8-device CPU mesh:
    both halo exchanges, flow labelling, the watershed, the detection step
    given flows and computing them, and the whole chain given flows."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from tobac_flow_tpu.core.flow import create_flow
    from tobac_flow_tpu.ops.banded import banded_warp_axis
    from tobac_flow_tpu.parallel import halo
    from tobac_flow_tpu.parallel.label import sharded_flow_label
    from tobac_flow_tpu.parallel.mesh import make_mesh
    from tobac_flow_tpu.parallel.pipeline import sharded_detect_all, sharded_detect_step
    from tobac_flow_tpu.parallel.watershed import sharded_watershed

    mesh = make_mesh(*PARALLEL_MESH)
    spec = P("t", None, "x")
    out = {}

    def mapped(fn, data):
        return np.asarray(jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=spec,
                                                out_specs=spec))(jnp.asarray(data)))

    out["halo_t"] = mapped(lambda x: halo.halo_exchange_t(x, halo=1, fill_value=-1.0),
                           np.arange(8 * 4 * 16, dtype=np.float32).reshape(8, 4, 16))
    out["halo_x"] = mapped(lambda x: halo.halo_exchange_x(x, halo=2, fill_value=-1.0),
                           np.arange(4 * 4 * 32, dtype=np.float32).reshape(4, 4, 32))
    for name, (mask, fwd, bwd, hw) in parallel_label_scenes().items():
        out[name] = np.asarray(sharded_flow_label(mesh, mask, fwd, bwd, halo=hw))
    mask, fwd, bwd, hw = parallel_varying_scene()
    out["label_varying"] = np.asarray(sharded_flow_label(mesh, mask, fwd, bwd, halo=hw))
    for name, (field, markers, fwd, bwd, mask, rounds) in parallel_ws_scenes().items():
        out[name] = np.asarray(sharded_watershed(mesh, field, markers, fwd, bwd, mask=mask,
                                                 max_rounds=rounds))
    img, disp, radius = banded_axis_case()
    for axis in (-2, -1):
        for mode in ("constant", "edge"):
            out[f"banded_axis{axis}_{mode}"] = np.asarray(
                banded_warp_axis(jnp.asarray(img), jnp.asarray(disp), axis, radius,
                                 pad_mode=mode))

    from tobac_flow_tpu.parallel.pipeline import _stencil_gather

    data_h, flow, taps = stencil_case()
    for dyx in (-1, 1):
        out[f"stencil_{dyx}"] = np.stack([np.asarray(a) for a in _stencil_gather(
            jnp.asarray(data_h), jnp.asarray(flow), dyx, taps, np.nan)])

    bt, wvd, swd = parallel_step_scene()
    cf = create_flow(bt, vr_steps=1, smoothing_passes=1, interp_method="cubic")
    fwd = np.clip(np.asarray(cf.forward_flow), -6, 6)
    bwd = np.clip(np.asarray(cf.backward_flow), -6, 6)
    out["step_fwd"], out["step_bwd"] = fwd, bwd
    step_mesh = make_mesh(*PARALLEL_STEP_MESH)
    names = ("fwd", "bwd", "core_markers", "core_labels", "edges", "thick_labels",
             "anvil_mask")
    step = sharded_detect_step(step_mesh, bt, wvd, swd, flows=(fwd, bwd), ws_sweeps=2,
                               **PARALLEL_STEP)
    for name, a in zip(names[2:], step[2:]):
        out[f"step_{name}_out"] = np.asarray(a)
    chain = sharded_detect_all(step_mesh, bt, wvd, swd, flows=(fwd, bwd), ws_sweeps=64,
                               **PARALLEL_STEP)
    for name, a in chain.items():
        if name not in ("forward_flow", "backward_flow"):
            out[f"all_{name}"] = np.asarray(a)
    free = sharded_detect_step(mesh, *parallel_flow_scene(), **PARALLEL_FLOW_STEP)
    out["flow_step_fwd"], out["flow_step_bwd"] = np.asarray(free[0]), np.asarray(free[1])
    assert out["step_core_markers_out"].sum() > 50
    assert out["all_thick_anvil_labels"].max() >= 1 and out["all_thin_anvil_labels"].max() >= 1
    return out


RECORDS = {
    "flow_qc": record_flow_qc,
    "detect_chain": record_detect_chain,
    "flow_models": record_flow_models,
    "subsegment": record_subsegment,
    "configured_chain": record_configured_chain,
    "fused_scene": record_fused_scene,
    "legacy": record_legacy,
    "parallel": record_parallel,
}


def main(names):
    for name in names or RECORDS:
        out = RECORDS[name]()
        np.savez_compressed(DATA / f"{name}.npz", **out)
        print("recorded", DATA / f"{name}.npz", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main(sys.argv[1:])
