"""The port's warps, flow-warped convolution and Sobel against
``tobac_flow_tpu/ops/{warp,banded,convolve,sobel}.py``.

Tolerance: bit-equal (NaN where the reference has NaN).  The reference's
compiled CPU programs round ``p * x + c`` as one fused multiply-add; the
port rounds the cubic weights and the Sobel magnitude the same way
(``ops.warp.fma``), and is bit-equal there too.  Inputs: a (3, 40, 48)
field with NaN holes, flows in ±20 px with some integer displacements
(zero-weight taps) and a clipped tail, from a numpy seed.

The convolutions are held bit-equal to the reference's exact warp (its
per-frame band plan switched off, ``set_plan_frame_k(0)``), and the
growth-rate difference also to its default path everywhere but each
frame's pixel (0, 0).  There the default path is not the exact warp: the
plan repairs the pixels outside its band by a scatter whose padding
entries (position -1, clamped to pixel 0) write the unrepaired value back
over pixel 0, and the last write wins.  ``test_reference_plan_loses_pixel_0``
shows it.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.detect import fused as jfused  # noqa: E402
from tobac_flow_tpu.ops import banded as jbanded  # noqa: E402
from tobac_flow_tpu.ops.convolve import convolve as jconvolve  # noqa: E402
from tobac_flow_tpu.ops.convolve import set_plan_frame_k  # noqa: E402
from tobac_flow_tpu.ops.sobel import sobel as jsobel  # noqa: E402
from tobac_flow_tpu_torch.ops import banded, convolve, sobel, warp  # noqa: E402

SHAPE = (3, 40, 48)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(250.0, 20.0, SHAPE).astype(np.float32)
    data[rng.uniform(size=SHAPE) < 0.02] = np.nan
    flows = []
    for _ in range(2):
        f = rng.normal(0.0, 4.0, SHAPE + (2,))
        whole = rng.uniform(size=SHAPE + (2,)) < 0.2
        f[whole] = np.round(f[whole])
        f[rng.uniform(size=SHAPE + (2,)) < 0.1] = 20.0
        flows.append(np.clip(f, -20, 20).astype(np.float32))
    return data, flows[0], flows[1]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _differ(ref, out):
    ref = np.asarray(ref)
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    assert ref.shape == out.shape and ref.dtype == out.dtype, (ref.shape, out.shape)
    if np.issubdtype(ref.dtype, np.floating):
        return ~((ref == out) | (np.isnan(ref) & np.isnan(out)))
    return ref != out


def _equal(ref, out):
    bad = _differ(ref, out)
    assert not bad.any(), f"{bad.sum()} differ"


def _reference_both(fn):
    """``fn()`` under the reference's exact warp (band plan off) and under
    its default path."""
    prev = set_plan_frame_k(0)
    try:
        exact = np.asarray(fn())
    finally:
        set_plan_frame_k(prev)
    return exact, np.asarray(fn())


def _equal_exact(fn, out):
    """Bit-equal to the reference's exact warp."""
    prev = set_plan_frame_k(0)
    try:
        _equal(fn(), out)
    finally:
        set_plan_frame_k(prev)


def test_growth_difference_equals_default_path_off_pixel_0():
    data, fwd, bwd = _inputs(5)
    _, default = _reference_both(lambda: jconvolve(
        data, fwd, bwd, structure=_t_struct(), method="cubic", func=jfused._diff_func))
    out = convolve.convolve(_t(data), _t(fwd), _t(bwd), structure=_t_struct(), method="cubic",
                            func=convolve.diff_func)
    bad = _differ(default, out)
    assert not bad[..., 1:, :].any() and not bad[..., 0, 1:].any(), f"{bad.sum()} differ"


def test_fma_rounds_once():
    rng = np.random.default_rng(1)
    a, b, c = (rng.normal(0, 100, 10_000).astype(np.float32) for _ in range(3))
    _equal(jax.jit(lambda a, b, c: a * b + c)(a, b, c), warp.fma(_t(a), _t(b), _t(c)))


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
def test_warp_banded_multi(method):
    data, fwd, _ = _inputs(2)
    chans = np.nan_to_num(np.stack([data, -data]), nan=1.0)
    ref = jax.jit(lambda c, f: jbanded.warp_banded_multi(c, f, radius=20, method=method))(
        chans, fwd)
    _equal(ref, banded.warp_banded_multi(_t(chans), _t(fwd), 20, method,
                                         pad_mode="constant"))


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic"])
def test_warp_banded_exact_multi(method):
    data, fwd, _ = _inputs(3)
    offsets = [(ox, oy) for oy in (-1, 0, 1) for ox in (-1, 0, 1)]
    ref = jax.jit(jax.vmap(lambda img, fl: jbanded.warp_banded_exact_multi(
        img, fl, offsets, 20, 20, method=method, fill_value=jnp.nan)))(
        jnp.asarray(data), jnp.asarray(fwd))
    _equal(jnp.moveaxis(ref, 0, 1), banded.warp_banded_exact_multi(_t(data), _t(fwd), offsets,
                                                                    20, method))


def test_warp_banded_exact_nearest_labels():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 9, SHAPE).astype(np.int32)
    _, fwd, _ = _inputs(4)
    ref = jax.jit(jax.vmap(lambda img, fl: jbanded.warp_banded_exact_multi(
        img, fl, [(0, 0)], 21, 21, method="nearest", fill_value=0)))(
        jnp.asarray(labels), jnp.asarray(fwd))
    _equal(ref[:, 0], banded.warp_banded_exact(_t(labels), _t(fwd), 21, "nearest", 0))


def _t_struct():
    s = np.zeros((3, 3, 3), bool)
    s[:, 1, 1] = True
    return s


CASES = {
    "diff cubic": (_t_struct(), "cubic", jfused._diff_func, convolve.diff_func),
    "diff linear": (_t_struct(), "linear", jfused._diff_func, convolve.diff_func),
    "nanmean cross cubic": (jfused._s2d(), "cubic", jfused._nanmean0, convolve.nanmean0),
    "nanmean default linear": (None, "linear", jfused._nanmean0, convolve.nanmean0),
    "stack full nearest": (np.ones((3, 3, 3), bool), "nearest", None, None),
    "stack default cubic": (None, "cubic", None, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_convolve(case):
    structure, method, jfunc, func = CASES[case]
    data, fwd, bwd = _inputs(5)
    _equal_exact(
        lambda: jconvolve(data, fwd, bwd, structure=structure, method=method, func=jfunc),
        convolve.convolve(_t(data), _t(fwd), _t(bwd), structure=structure, method=method,
                          func=func),
    )


def test_convolve_any0_nearest_int():
    rng = np.random.default_rng(6)
    mask = (rng.uniform(size=SHAPE) < 0.1).astype(np.int32)
    _, fwd, bwd = _inputs(6)
    _equal_exact(
        lambda: jconvolve(mask, fwd, bwd, structure=_t_struct(), method="nearest",
                          fill_value=0, dtype=np.int32, func=jfused._any0),
        convolve.convolve(_t(mask), _t(fwd), _t(bwd), structure=_t_struct(),
                          method="nearest", fill_value=0, dtype=torch.int32,
                          func=convolve.any0),
    )


@pytest.mark.parametrize("method,direction",
                         [("cubic", "uphill"), ("linear", None), ("linear", "downhill")])
def test_sobel(method, direction):
    data, fwd, bwd = _inputs(7)
    data = np.clip((data - 230.0) / 40.0, 0, 1).astype(np.float32)
    _equal_exact(
        lambda: jsobel(data, fwd, bwd, method=method, direction=direction),
        sobel.sobel(_t(data), _t(fwd), _t(bwd), method=method, direction=direction),
    )


def test_reference_plan_loses_pixel_0():
    """Frame 1's pixel (0, 0) reads the previous frame 6 px to its left:
    outside the frame, so the exact warp gives NaN.  Its flow lies beyond
    the default plan's band, and the plan's repair of it is overwritten:
    the default path gives the band's partial sum, 0."""
    data, fwd, bwd = _inputs(5)
    diff = np.zeros((3, 3, 3), bool)
    diff[0, 1, 1] = True
    exact, default = _reference_both(
        lambda: jconvolve(data, fwd, bwd, structure=diff, method="linear"))
    assert bwd[1, 0, 0, 0] < -6 and np.isnan(exact[0, 1, 0, 0]) and default[0, 1, 0, 0] == 0
    out = convolve.convolve(_t(data), _t(fwd), _t(bwd), structure=diff, method="linear")
    assert bool(torch.isnan(out[0, 1, 0, 0]))
