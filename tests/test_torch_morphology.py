"""The port's morphology and the detection chain's dense filters against
``tobac_flow_tpu/ops/morphology.py`` and ``tobac_flow_tpu/detect/fused.py``
(and scipy where it is the reference's oracle).

Tolerance: bit-equal.  The reference's compiled Gaussian rounds each tap
after the first as a fused multiply-add; the port does the same
(``ops.warp.fma``).  The hole fill runs the reference's flood, to its
iteration cap; the test also shows that the reference's flood converged
(it equals scipy's ``binary_fill_holes``) on the masks used.  Inputs from
a numpy seed at (3, 40, 48).
"""

import numpy as np
import pytest
import scipy.ndimage as ndi

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.detect import fused as jfused  # noqa: E402
from tobac_flow_tpu.ops import morphology as jmorph  # noqa: E402
from tobac_flow_tpu_torch.detect import fused  # noqa: E402
from tobac_flow_tpu_torch.ops import morphology  # noqa: E402

SHAPE = (3, 40, 48)
S2D = jfused._S2D_OFFS
B3 = jfused._B3_OFFS


def _mask(seed, p=0.45):
    return np.random.default_rng(seed).uniform(size=SHAPE) < p


def _field(seed):
    """A smooth field with noise about 0: curvatures and extrema of both
    signs (the peak filter keeps only extrema of the signed field above 0)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SHAPE[1], 0:SHAPE[2]]
    base = 30 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
    base += 80 * (np.exp(-((xx - 20) ** 2 + (yy - 15) ** 2) / 8.0)
                 - np.exp(-((xx - 28) ** 2 + (yy - 24) ** 2) / 8.0))
    return (base[None] + rng.normal(0, 2.0, SHAPE)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mode,offsets,iterations,border", [
    ("erode", S2D, 1, 0), ("dilate", S2D, 1, 0), ("erode", B3, 2, 1),
    ("dilate", jfused._DISK_OFFS, 1, 0), ("erode", B3, 3, 0),
])
def test_binary_morph(mode, offsets, iterations, border):
    m = _mask(1)
    ref = jmorph._binary_morph(jnp.asarray(m), offsets, iterations, border, mode)
    out = morphology._binary_morph(_t(m), offsets, iterations, border, mode)
    assert np.array_equal(np.asarray(ref), out.numpy())


@pytest.mark.parametrize("p", [0.35, 0.55, 0.7])
def test_fill_holes(p):
    m = _mask(2, p)
    max_iters = sum(SHAPE) + 8
    ref = np.asarray(jmorph._fill_holes_device(jnp.asarray(m), S2D, max_iters))
    out = morphology._fill_holes_device(_t(m), S2D, max_iters).numpy()
    assert np.array_equal(ref, out)
    # the reference's flood converged: it is scipy's fill, frame by frame
    plane = ndi.generate_binary_structure(2, 1)
    assert np.array_equal(ref, np.stack([ndi.binary_fill_holes(f, plane) for f in m]))


@pytest.mark.parametrize("mode", ["min", "max"])
def test_grey_morph(mode):
    f = _field(3)
    f[0, 5, 5] = np.nan
    for offs in (jfused._ROW_MAX_OFFS, jfused._COL_MAX_OFFS, S2D):
        ref = np.asarray(jmorph._grey_morph(jnp.asarray(f), offs, mode))
        out = morphology._grey_morph(_t(f), offs, mode).numpy()
        assert np.array_equal(ref, out, equal_nan=True)


@pytest.mark.parametrize("sigma", [2.0, 0.5, 1.3])
def test_sepconv_reflect(sigma):
    f = _field(4)
    kernels = jfused._spatial_gauss_kernels(sigma)
    ref = np.asarray(jmorph._sepconv_reflect(jnp.asarray(f), kernels))
    out = morphology._sepconv_reflect(_t(f), fused._spatial_gauss_kernels(sigma)).numpy()
    assert np.array_equal(ref, out)


def test_gauss_kernel():
    for sigma in (0.5, 2.0, 3.7):
        assert np.array_equal(jmorph._gauss_kernel(sigma), morphology._gauss_kernel(sigma))
    assert morphology._gauss_kernel(0.1) is None


@pytest.mark.parametrize("direction", ["positive", "negative"])
def test_curvature_and_peak_filters(direction):
    f = _field(5)
    ref = jax.jit(lambda f: (jfused._curvature_filter_j(f, direction),
                             jfused._peak_filter_j(f, direction)))(jnp.asarray(f))
    curv = fused._curvature_filter(_t(f), direction)
    peak = fused._peak_filter(_t(f), direction)
    assert np.asarray(ref[0]).any() and np.asarray(ref[1]).any()
    assert np.array_equal(np.asarray(ref[0]), curv.numpy())
    assert np.array_equal(np.asarray(ref[1]), peak.numpy())


def test_public_ops_against_scipy():
    m = _mask(6, 0.6)
    s = np.zeros((3, 3, 3), bool)
    s[1] = ndi.generate_binary_structure(2, 1)
    out = morphology.binary_opening(_t(m), structure=s).numpy()
    assert np.array_equal(out, ndi.binary_opening(m, structure=s))
    out = morphology.binary_erosion(_t(m), iterations=2, border_value=1).numpy()
    assert np.array_equal(out, ndi.binary_erosion(m, iterations=2, border_value=1))
    out = morphology.binary_dilation(_t(m), structure=np.ones((3, 3, 3))).numpy()
    assert np.array_equal(out, ndi.binary_dilation(m, structure=np.ones((3, 3, 3))))
    assert np.array_equal(np.asarray(jfused._opening(jnp.asarray(m), S2D)),
                          fused._opening(_t(m), S2D).numpy())
