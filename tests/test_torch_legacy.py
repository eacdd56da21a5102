"""The port's legacy detection path and the pieces it is built from,
against the JAX package on the CPU: the morphology (``ops/morphology.py``),
the ``filter_labels_by_*`` family and ``get_stats_for_labels``
(``detect/analysis.py``), the op-by-op filters of ``detect/detection.py``,
``detect_anvils(markers=None)``, the legacy growth markers and
``edge_watershed``, ``legacy.py``, ``decorators.py`` and the legacy CLI.

Tolerances: labels, masks and counts exact; every op-by-op filter, the
smoothed derivatives and the edge fields bit-equal; the per-label float32
means and stds of ``get_stats_for_labels`` to rtol 1e-5 (its sums add in
float64), its maxima and minima exact.

The morphology and the label filters run the JAX side live on small
seeded inputs.  The rest reads the JAX package's outputs as
``tools/record_torch_refs.py legacy`` recorded them
(``tests/data/legacy.npz``: its watershed and filters compile for about a
minute), on the detection chain's scene given the flows recorded in
``tests/data/detect_chain.npz``, the floods on a 6×24×36 cut of it, and
the legacy CLI's synthetic 8×48×64 scene given its recorded flows (the
CLI-default Farneback flow is chaotic on noise frames, so the labels are
compared given the same flows).
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.data import ncdataset as jnc  # noqa: E402
from tobac_flow_tpu.detect import analysis as janalysis  # noqa: E402
from tobac_flow_tpu.ops import morphology as jmorph  # noqa: E402
from tobac_flow_tpu_torch import legacy  # noqa: E402
from tobac_flow_tpu_torch.core.flow import Flow  # noqa: E402
from tobac_flow_tpu_torch.data import ncdataset as tnc  # noqa: E402
from tobac_flow_tpu_torch.detect import analysis, detection, fused  # noqa: E402
from tobac_flow_tpu_torch.ops import morphology  # noqa: E402
from tools.record_torch_refs import (  # noqa: E402
    LEGACY_CLI_SHAPE, LEGACY_CROP, LEGACY_MAX_ITER, legacy_inputs,
)

RECORD = Path(__file__).resolve().parent / "data" / "legacy.npz"
SHAPE = (3, 20, 24)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (``tools/record_torch_refs.record_legacy``)
    and the inputs they were made from, checked by their digest."""
    rec = dict(np.load(RECORD))
    bt, wvd, swd, times, fwd, bwd, digest = legacy_inputs()
    assert str(rec["digest"]) == digest, "legacy.npz was recorded from other inputs"
    flow = Flow.from_numpy(fwd, bwd, device="cpu")
    c = LEGACY_CROP
    return dict(rec=rec, bt=bt, wvd=wvd, swd=swd, times=times, fwd=fwd, bwd=bwd, flow=flow,
                crop=Flow.from_numpy(fwd[c], bwd[c], device="cpu"))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(getattr(a, "values", a))


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got, want.astype(got.dtype), equal_nan=True), (
        f"{int(np.sum(got != want))} of {got.size} differ")


# -- morphology ----------------------------------------------------------------


def _mask(seed, p=0.5):
    return np.random.default_rng(seed).uniform(size=SHAPE) < p


def _field(seed):
    return np.random.default_rng(seed).normal(0, 3, SHAPE).astype(np.float32)


S2 = np.zeros((1, 3, 3), bool)
S2[0, 1, :] = S2[0, :, 1] = True


@pytest.mark.parametrize("structure", [None, S2, np.ones((3, 3, 3))], ids=["cross", "s2", "cube"])
def test_binary_closing_and_fill_holes(structure):
    m = _mask(1)
    _same(morphology.binary_closing(m, structure), jmorph.binary_closing(m, structure))
    _same(morphology.binary_closing(m, structure, 2), jmorph.binary_closing(m, structure, 2))
    holes = _mask(2, 0.7)
    _same(morphology.binary_fill_holes(holes, structure), jmorph.binary_fill_holes(holes, structure))


@pytest.mark.parametrize("kw", [dict(size=3), dict(size=(1, 4, 3)), dict(footprint=S2), {}],
                         ids=["size3", "size143", "footprint", "cross"])
def test_grey_morphology(kw):
    f = _field(3)
    for port, ref in ((morphology.grey_erosion, jmorph.grey_erosion),
                      (morphology.grey_dilation, jmorph.grey_dilation),
                      (morphology.grey_opening, jmorph.grey_opening)):
        _same(port(torch.from_numpy(f), **kw), ref(f, **kw))


def test_maximum_minimum_filters():
    f = _field(4)
    _same(morphology.maximum_filter(f, (1, 5, 3)), jmorph.maximum_filter(f, (1, 5, 3)))
    _same(morphology.minimum_filter(f, 3), jmorph.minimum_filter(f, 3))


@pytest.mark.parametrize("sigma", [1.5, (0, 2, 0.7)], ids=["scalar", "per_axis"])
def test_gaussian_filters(sigma):
    f = np.random.default_rng(5).normal(0, 3, (14, 20, 24)).astype(np.float32)
    _same(morphology.gaussian_filter(f, sigma), jmorph.gaussian_filter(f, sigma))
    g = np.where(f > 2, np.nan, f).astype(np.float32)
    assert np.isnan(g).any()
    for propagate in (True, False):
        _same(morphology.nan_gaussian_filter(g, sigma, propagate),
              jmorph.nan_gaussian_filter(g, sigma, propagate))
    assert detection.nan_gaussian_filter is morphology.nan_gaussian_filter


@pytest.mark.parametrize("frames", [2, 3, 4, 5])
@pytest.mark.parametrize("sigma", [1.0, 1.5, 2.0])
def test_gaussian_along_an_axis_shorter_than_its_radius(frames, sigma):
    """Along an axis shorter than the kernel's radius, where the reflected
    padding repeats whole copies of the axis, taps that read the same
    slice with the same weight share one rounded product in the
    reference's compiled program; the port rounds them so too."""
    f = _field(5)[:frames]
    got = morphology.gaussian_filter(f, (sigma, 0, 0)).numpy()
    want = np.asarray(jmorph.gaussian_filter(f, (sigma, 0, 0)))
    assert np.array_equal(got, want)


# -- label filters and statistics ----------------------------------------------


def _labels():
    """Labels 1..12 scattered over (6, 16, 20), some spanning several
    frames, one absent (7), and a float field with NaNs."""
    rng = np.random.default_rng(6)
    labels = np.zeros((6, 16, 20), np.int32)
    for lab in range(1, 13):
        if lab == 7:
            continue
        t0 = rng.integers(0, 5)
        t1 = rng.integers(t0 + 1, 7)
        y, x = rng.integers(0, 13), rng.integers(0, 17)
        labels[t0:t1, y:y + 3, x:x + 3] = lab
    field = rng.normal(250, 10, labels.shape).astype(np.float32)
    field[rng.uniform(size=labels.shape) < 0.2] = np.nan
    field[labels == 5] = np.nan  # a label without a value
    return labels, field


def test_filter_labels_family():
    labels, field = _labels()
    masks = [field > 255, np.isnan(field) | (field < 240)]
    t = torch.from_numpy(labels)
    for n in (1, 3, 5):
        _same(analysis.filter_labels_by_length(t, n), janalysis.filter_labels_by_length(labels, n))
        _same(analysis.filter_labels_by_length_and_mask(t, masks[0], n),
              janalysis.filter_labels_by_length_and_mask(labels, masks[0], n))
        _same(analysis.filter_labels_by_length_and_multimask(t, masks, n),
              janalysis.filter_labels_by_length_and_multimask(labels, masks, n))
        _same(analysis.filter_labels_by_length_and_multimask_legacy(t, masks, n),
              janalysis.filter_labels_by_length_and_multimask_legacy(labels, masks, n))
    _same(analysis.filter_labels_by_mask(t, torch.from_numpy(masks[1])),
          janalysis.filter_labels_by_mask(labels, masks[1]))
    _same(analysis.filter_labels_by_multimask(t, masks),
          janalysis.filter_labels_by_multimask(labels, masks))
    with pytest.raises(ValueError, match="list"):
        analysis.filter_labels_by_multimask(t, masks[0])


def test_get_stats_for_labels():
    labels, field = _labels()
    jl = jnc.DataArray(labels, dims=("t", "y", "x"), name="core_label")
    jf = jnc.DataArray(field, dims=("t", "y", "x"), name="bt",
                       attrs={"long_name": "brightness temperature", "units": "K"})
    tl = tnc.DataArray(torch.from_numpy(labels), dims=("t", "y", "x"), name="core_label")
    tf = tnc.DataArray(torch.from_numpy(field), dims=("t", "y", "x"), name="bt",
                       attrs={"long_name": "brightness temperature", "units": "K"})
    with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
        want = janalysis.get_stats_for_labels(jl, jf)
    got = analysis.get_stats_for_labels(tl, tf)
    for g, w in zip(got, want):
        assert (g.name, g.dims, g.attrs, g.dtype) == (w.name, w.dims, w.attrs, w.dtype)
        if g.name.endswith(("mean", "std")):
            np.testing.assert_allclose(g.values, w.values, rtol=1e-5)
            assert np.array_equal(np.isnan(g.values), np.isnan(w.values))
        else:
            _same(g.values, w.values)
    assert np.isnan(got[0].values[[4, 6]]).all() and np.isfinite(got[0].values[:4]).all()


def test_configure_dataarray_keeps_a_tensor():
    from tobac_flow_tpu_torch.decorators import configure_dataarray

    @configure_dataarray(name="anvil_label", drop_attrs=["units"], long_name="anvils", units="")
    def double(flow, field):
        return torch.as_tensor(field.data if hasattr(field, "dims") else field) * 2

    t = torch.arange(6.0).view(1, 2, 3)
    da = tnc.DataArray(t, coords={"t": np.arange(1)}, dims=("t", "y", "x"), name="f",
                       attrs={"units": "K", "source": "seed"})
    out = double(None, da)
    assert isinstance(out, tnc.DataArray) and isinstance(out.data, torch.Tensor)
    assert out.name == "anvil_label" and out.dims == da.dims and "t" in out.coords
    assert out.attrs == {"source": "seed", "long_name": "anvils", "units": ""}
    assert np.array_equal(out.values, 2 * t.numpy())
    renamed = double(None, da, name="other", attributes={"note": "x"})
    assert renamed.name == "other" and renamed.attrs["note"] == "x"
    assert isinstance(double(None, t), torch.Tensor)  # no DataArray argument: as it came


# -- the op-by-op filters, against the JAX package's recorded outputs ----------


def test_op_by_op_filters(ref):
    r, flow = ref["rec"], ref["flow"]
    bt, wvd, swd, times = ref["bt"], ref["wvd"], ref["swd"], ref["times"]
    for name, fld, direction in (("bt", bt, "positive"), ("wvd", wvd, "negative"),
                                 ("bt_neg", bt, "negative")):
        _same(detection.get_curvature_filter(fld, direction=direction, device="cpu"),
              r[f"curv_{name}"])
        _same(detection.get_peak_filter(fld, sigma=0.5, direction=direction, device="cpu"),
              r[f"peak_{name}"])
    assert r["curv_wvd"].any() and r["peak_wvd"].any() and r["curv_bt"].any()
    _same(detection.get_growth_rate(flow, -bt, times, method="cubic"), r["growth_cubic"])
    _same(detection.get_growth_rate(flow, wvd, times), r["growth_linear"])
    _same(detection.get_combined_filters(flow, bt, wvd, swd), r["combined"].astype(np.float32))
    _same(detection.get_combined_filters(flow, bt, wvd, swd, use_wvd=False),
          r["combined_bt"].astype(np.float32))
    f = wvd - swd
    _same(detection.get_watershed_mask(f, 2, device="cpu"), r["ws_mask"])
    _same(detection.get_combined_edge_field(flow, f), r["edges"])
    _same(detection.filtered_tdiff(flow, f), r["tdiff"])
    _same(detection.nan_gaussian_filter(np.where(wvd > 0, np.nan, wvd), (0, 1.5, 2)),
          r["nan_gauss"])
    with pytest.raises(ValueError, match="positive or negative"):
        detection.get_curvature_filter(bt, direction="up", device="cpu")


def test_op_by_op_filters_give_the_fused_markers(ref):
    """The combined filter and the growth rates, thresholded and opened as
    ``detect_cores`` does, give ``fused.core_markers``' markers."""
    flow, bt, wvd, swd, times = (ref[k] for k in ("flow", "bt", "wvd", "swd", "times"))
    combined = detection.get_combined_filters(flow, bt, wvd, swd)
    markers = (detection.get_growth_rate(flow, -bt, times, "cubic") * combined > 0.5) | (
        detection.get_growth_rate(flow, wvd, times, "cubic") * combined > 0.25)
    markers = morphology.binary_opening(markers, structure=fused._s2d_structure())
    dt = detection._per_minute(flow, times)
    want = fused.core_markers(*(torch.from_numpy(a) for a in (bt, wvd, swd)), flow.forward_flow,
                              flow.backward_flow, dt, 0.25, 0.5, True)
    assert int(want.sum()) > 0 and torch.equal(markers, want)


def test_growth_markers(ref):
    r, flow = ref["rec"], ref["flow"]
    smoothed, labels = detection.detect_growth_markers(flow, ref["wvd"], ref["times"])
    _same(smoothed, r["gm_smoothed"])
    _same(labels, r["gm_labels"])
    out = detection.detect_growth_markers_multichannel(flow, ref["wvd"], ref["bt"], ref["times"])
    for got, name in zip(out, ("gmm_wvd", "gmm_bt", "gmm_labels")):
        _same(got, r[name])
    assert r["gmm_labels"].max() > 0


def test_growth_markers_take_times_from_dataarrays(ref):
    coords = {"t": ref["times"]}
    wvd = tnc.DataArray(ref["wvd"], coords=coords, dims=("t", "y", "x"), name="wvd")
    _, labels = detection.detect_growth_markers(ref["flow"], wvd)
    _same(labels, ref["rec"]["gm_labels"])
    with pytest.raises(ValueError, match="times"):
        detection.detect_growth_markers(ref["flow"], ref["wvd"])


def test_floods_on_the_cut(ref):
    """``detect_anvils(markers=None)`` and ``edge_watershed`` (whose mask,
    the eroded pixels at the lower threshold, is where it floods) on the
    6×24×36 cut, and ``legacy.py``'s functions there (the Sobel against
    the reference's exact warp: its band plan loses each frame's pixel
    (0, 0), which the port does not inherit)."""
    r, crop, c = ref["rec"], ref["crop"], LEGACY_CROP
    f = (ref["wvd"] - ref["swd"])[c]
    _same(detection.detect_anvils(crop, f), r["anvils_none"])
    markers = r["gmm_labels"][c]
    stats = {}
    out = detection.edge_watershed(crop, f, markers, -5, -15, stats=stats)
    _same(out, r["edge_ws"])
    assert stats["jacobi_rounds"] > 0 and r["edge_ws"].max() > 0
    # most of what it labels lies at the lower threshold, away from the markers
    assert (np.clip(f, -15, -5)[r["edge_ws"] > 0] == -15).mean() > 0.5
    fwd, bwd = ref["fwd"][c], ref["bwd"][c]
    edges = crop.sobel(np.clip(f, -15, -5), method="nearest")
    _same(legacy.flow_network_watershed(edges, markers, fwd, bwd, mask=f > -12,
                                        max_iter=LEGACY_MAX_ITER, device="cpu"),
          r["network_ws"])
    _same(legacy.flow_label(f > -12, fwd, bwd, overlap=0.5, device="cpu"), r["legacy_label"])
    _same(legacy.flow_convolve_nearest(markers, fwd, bwd, device="cpu"), r["legacy_convolve"])
    _same(legacy.flow_sobel(f, torch.from_numpy(fwd), torch.from_numpy(bwd), direction="uphill"),
          r["legacy_sobel"])


def test_flow_func():
    rng = np.random.default_rng(0)
    fx_for, fx_back, fy_for, fy_back = rng.normal(0, 2, (4, 3, 8, 10))
    for wrap in (np.asarray, torch.from_numpy):
        ff = legacy.FlowFunc(*(wrap(a) for a in (fx_for, fx_back, fy_for, fy_back)))
        assert legacy.Flow_Func is legacy.FlowFunc and ff.shape == (3, 8, 10)
        for t, want in ((1.0, (fx_for, fy_for)), (-1.0, (fx_back, fy_back)),
                        (0.5, (0.375 * fx_for - 0.125 * fx_back,
                               0.375 * fy_for - 0.125 * fy_back))):
            for got, w in zip(ff(t), want):
                np.testing.assert_allclose(_np(got), w, rtol=1e-12)
        assert ff[1:].shape == (2, 8, 10)
    fwd = np.zeros((2, 4, 5, 2), np.float32)
    bwd = np.zeros((2, 4, 5, 2), np.float32)
    fwd[..., 0], bwd[..., 1] = 2.0, -1.0
    dx, dy = legacy.FlowFunc.from_flow(Flow.from_numpy(fwd, bwd, device="cpu"))(-1.0)
    assert (dx == 0).all() and (dy == -1).all()


# -- the legacy CLI --------------------------------------------------------------


def test_legacy_cli_given_the_flows(ref, tmp_path, monkeypatch):
    """The CLI's file given the JAX CLI's flows holds the JAX CLI's markers
    and labels; ``detect_legacy`` logs each step."""
    pytest.importorskip("h5py")
    from tobac_flow_tpu_torch.cli import dcc_detect_legacy

    r = ref["rec"]
    flow = Flow.from_numpy(r["cli_fwd"], r["cli_bwd"], device="cpu")
    monkeypatch.setattr(dcc_detect_legacy, "create_flow", lambda *a, **k: flow)
    stats = {}
    run = dcc_detect_legacy.detect_legacy
    monkeypatch.setattr(dcc_detect_legacy, "detect_legacy",
                        lambda *a, **k: run(*a, stats=stats, **k))
    t, y, x = LEGACY_CLI_SHAPE
    path = dcc_detect_legacy.main(["-sd", str(tmp_path), "-t", str(t), "-y", str(y),
                                   "-x", str(x), "--device", "cpu"])
    ds = tnc.open_dataset(path)
    for var in ("growth_markers", "watershed_label"):
        _same(ds[var].values, r[f"cli_{var}"])
        assert ds[var].attrs["long_name"] == str(r[f"cli_{var}_long_name"])
    assert r["cli_growth_markers"].max() > 0
    assert {"flow_s", "markers_s", "watershed_s", "jacobi_rounds"} <= set(stats)


def test_detect_exports_match_the_reference():
    import ast

    root = Path(__file__).resolve().parent.parent
    names = [{a.name for node in ast.parse((root / pkg / "detect" / "__init__.py").read_text()).body
              if isinstance(node, ast.ImportFrom) for a in node.names}
             for pkg in ("tobac_flow_tpu", "tobac_flow_tpu_torch")]
    assert names[0] == names[1]
    assert set(detection.__all__) == set(
        __import__("tobac_flow_tpu.detect.detection", fromlist=["__all__"]).__all__)
