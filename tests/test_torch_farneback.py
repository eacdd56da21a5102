"""The port's Farneback flow against ``tobac_flow_tpu/models/farneback.py``
on the CPU.

Tolerances, and why they are not zero: XLA sums the reference's
correlations, its G⁻¹ dot and its cumulative-sum box blur in other orders
(and with fused multiply-adds) than the port's fixed-order float32 sums,
so single steps differ in the last bits (measured: polynomial expansion
≤ 3.5e-5 on coefficients up to ~50, resize ≤ 3.9e-5 on 0-255 data, 1e-6 on
upsampled flow); the iterated solves amplify that a little.  The flow gate
inside the storm mask is p99 |Δflow| ≤ 0.01 px, max ≤ 0.1 px, and the
rounded flows (what the watershed reads) agree on ≥ 99.9 % of mask pixels.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side, and
# torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from tobac_flow_tpu.models import farneback as jf  # noqa: E402
from tobac_flow_tpu.pipeline import _normalise_pair as j_normalise_pair  # noqa: E402
from tobac_flow_tpu_torch.models import farneback as pf  # noqa: E402
from tobac_flow_tpu_torch.pipeline import _normalise_pair  # noqa: E402


def test_from_jax_params_constants_bit_equal():
    params = jf.FarnebackParams(num_levels=4, winsize=9, poly_n=7, poly_sigma=1.5)
    g, xg, xxg, inv_g = jf._poly_kernels(params.poly_n, params.poly_sigma)
    for source in (params, vars(params)):
        model = pf.from_jax_params(source)
        assert model.params.as_dict() == {k: getattr(params, k) for k in pf._PARAM_NAMES}
        for ref, buf in zip((g, xg, xxg, inv_g), (model.g, model.xg, model.xxg, model.inv_g)):
            assert np.array_equal(np.asarray(ref, np.float64), buf.numpy())
    assert pf.from_jax_params(jf.FarnebackParams()).params == pf.FarnebackParams()


def test_poly_exp_matches():
    img = np.random.default_rng(0).uniform(0, 255, (48, 70)).astype(np.float32)
    jb_, ja = jax.jit(jf.poly_exp)(jnp.asarray(img))
    b, a = pf.poly_exp(torch.from_numpy(img))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb_), rtol=0, atol=1e-4)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-4)


@pytest.mark.parametrize("out_shape", [(32, 48), (16, 24), (8, 12), (4, 6), (13, 37)])
def test_resize_down_matches_jax_image_resize(out_shape):
    img = np.random.default_rng(1).uniform(0, 255, (64, 96)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(img), out_shape, method="linear")
    out = pf.resize_linear(torch.from_numpy(img), out_shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


@pytest.mark.parametrize("out_shape", [(32, 48), (33, 47)])
def test_resize_up_matches_jax_image_resize(out_shape):
    flow = np.random.default_rng(2).normal(0, 3, (16, 24, 2)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(flow), out_shape + (2,), method="linear")
    out = pf.resize_linear(torch.from_numpy(flow), out_shape, dims=(-3, -2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _blob_pair(h=80, w=112, shift=(2.5, 1.25), seed=0):
    """An anvil-like blob advecting by ``shift`` (x, y) px over noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(2):
        r2 = (xx - 0.4 * w - shift[0] * i) ** 2 + (yy - 0.45 * h - shift[1] * i) ** 2
        frames.append(290.0 - 60.0 * np.exp(-r2 / (2 * (h / 7) ** 2)))
    bt = np.stack(frames).astype(np.float32) + rng.normal(0, 0.3, (2, h, w)).astype(np.float32)
    return bt


def test_farneback_pair_on_advecting_blob():
    bt = _blob_pair()
    p8, n8 = (np.array(a) for a in j_normalise_pair(jnp.asarray(bt[0]), jnp.asarray(bt[1])))
    q8, m8 = _normalise_pair(torch.from_numpy(bt[:1]), torch.from_numpy(bt[1:]))
    assert np.array_equal(q8[0].numpy(), p8) and np.array_equal(m8[0].numpy(), n8)

    fn = jax.jit(lambda a, b: jf.farneback_pair(a, b, jf.FarnebackParams()))
    ref = np.asarray(fn(jnp.asarray(p8), jnp.asarray(n8)))
    out = pf.FarnebackFlow()(torch.from_numpy(p8), torch.from_numpy(n8)).numpy()
    assert out.shape == ref.shape
    mask = bt[0] < 260.0  # the storm: anvil and core
    diff = np.abs(out - ref)[mask]
    assert np.percentile(diff, 99) <= 0.01
    assert diff.max() <= 0.1
    assert (np.round(out) == np.round(ref))[mask].mean() >= 0.999
    # the flow recovers the advection inside the storm
    np.testing.assert_allclose(np.median(out[mask], axis=0), (2.5, 1.25), atol=0.2)
