"""The port's flow QC helpers, warps and host normalisations against
``tobac_flow_tpu/core/flow.py``, ``tobac_flow_tpu/ops/warp.py`` and
``tobac_flow_tpu/utils/normalisation.py`` on the CPU.

Tolerances:
- exact: the glibc sine and cosine the Lanczos weights take, the Lanczos
  weights, ``smooth_flow_step(method="lanczos")`` (NaN where the
  reference has NaN), ``warp_plane`` at every method and ``warp_flow`` at
  nearest, linear and cubic, ``combine_flow``, ``flow_magnitude``, the
  forward warp, and the host normalisations;
- ``warp_flow`` with Lanczos: within 1e-5 of the reference's own
  standalone program.  The reference's compiler fuses one multiply of the
  weights into its add where it compiles them inside the smoothing step
  (the port's arithmetic), and none where ``warp_flow`` is compiled alone
  (measured: 2.9e-6 on values of about 10);
- the MSE estimates: rtol 1e-5 (the port sums in float64, the reference
  in float32);
- ``calculate_flow_2`` and ``get_flow_residual``: the Farneback gate
  inside the blob (p99 |Δ| ≤ 0.01 px, max ≤ 0.1 px, rounded equal ≥
  0.999), against the reference's outputs recorded by
  ``tools/record_torch_refs.py`` (``tests/data/flow_qc.npz``).
"""

import ctypes
import ctypes.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.core import flow as jflow  # noqa: E402
from tobac_flow_tpu.ops import warp as jwarp  # noqa: E402
from tobac_flow_tpu.utils import normalisation as jnorm  # noqa: E402
from tobac_flow_tpu_torch.core import flow  # noqa: E402
from tobac_flow_tpu_torch.ops import warp  # noqa: E402
from tobac_flow_tpu_torch.utils import normalisation as norm  # noqa: E402
from tools.record_torch_refs import QC_MARGIN, moving_blob  # noqa: E402

RECORD = Path(__file__).resolve().parent / "data" / "flow_qc.npz"
METHODS = ("nearest", "linear", "cubic", "lanczos")


def _gate(out, want, mask):
    diff = np.abs(out - want)[mask]
    assert np.percentile(diff, 99) <= 0.01 and diff.max() <= 0.1, diff.max()
    assert (np.round(out) == np.round(want))[mask].mean() >= 0.999


def test_sincos_is_glibcs():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    for fn in (libm.sinf, libm.cosf):
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    y = np.random.default_rng(0).uniform(-119, 119, 3000).astype(np.float32)
    y = np.concatenate([y, np.float32([0.0, 1e-5, -0.5, 0.75, -np.pi, np.pi / 4])])
    s, c = warp._sincos(torch.from_numpy(y))
    assert np.array_equal(s.numpy(), np.float32([libm.sinf(float(v)) for v in y]))
    assert np.array_equal(c.numpy(), np.float32([libm.cosf(float(v)) for v in y]))
    # the reference's compiled sine and cosine on the Lanczos arguments
    f = np.random.default_rng(1).uniform(0, 1, 20000).astype(np.float32)
    arg = (-(f + np.float32(3.0)) * np.float32(np.pi * 0.25)).astype(np.float32)
    s, c = warp._sincos(torch.from_numpy(arg))
    assert np.array_equal(s.numpy(), np.asarray(jax.jit(jnp.sin)(arg)))
    assert np.array_equal(c.numpy(), np.asarray(jax.jit(jnp.cos)(arg)))


def test_lanczos_weights_exact():
    f = np.random.default_rng(2).uniform(0, 1, 20000).astype(np.float32)
    f = np.concatenate([f, np.float32([0.0, 1e-7, 1e-6, 0.5, 0.9999999])])
    want = np.asarray(jax.jit(lambda x: jnp.stack(jwarp._lanczos_weights(x)))(f))
    got = torch.stack(warp._lanczos_weights(torch.from_numpy(f))).numpy()
    assert np.array_equal(want, got)


def _flows(seed, shape=(2, 24, 32)):
    rng = np.random.default_rng(seed)
    fwd = rng.normal(0, 3, shape + (2,)).astype(np.float32)
    bwd = (-fwd + rng.normal(0, 1, fwd.shape)).astype(np.float32)
    fwd[0, :3, :3] = np.nan
    return fwd, bwd


def test_smooth_flow_step_lanczos():
    fwd, bwd = _flows(3)
    ref = jax.jit(jax.vmap(lambda f, b: jflow.smooth_flow_step(f, b, method="lanczos")))(fwd, bwd)
    out = flow.smooth_flow_step(torch.from_numpy(fwd), torch.from_numpy(bwd), method="lanczos")
    for r, o in zip(ref, out):
        assert np.array_equal(np.asarray(r), o.numpy(), equal_nan=True)


@pytest.mark.parametrize("method", METHODS)
def test_warp_plane(method):
    rng = np.random.default_rng(4)
    img = rng.normal(0, 10, (2, 24, 32)).astype(np.float32)
    img[0, 3, 4] = np.nan
    fl = rng.normal(0, 3, (2, 24, 32, 2)).astype(np.float32)
    offsets = [(-1, -1), (0, 1), (1, 0)]
    want = np.stack([np.asarray(jax.jit(
        lambda a, b: jwarp.warp_plane(a, b, offsets, method=method))(img[i], fl[i]))
        for i in range(2)], axis=1)
    got = warp.warp_plane(torch.from_numpy(img), torch.from_numpy(fl), offsets, method=method)
    assert np.array_equal(want, got.numpy(), equal_nan=True)


@pytest.mark.parametrize("method", METHODS)
def test_warp_flow(method):
    rng = np.random.default_rng(5)
    img = rng.normal(0, 10, (24, 32)).astype(np.float32)
    fl = rng.normal(0, 3, (24, 32, 2)).astype(np.float32)
    want = np.asarray(jwarp.warp_flow(img, fl, method=method))
    got = warp.warp_flow(torch.from_numpy(img), torch.from_numpy(fl), method=method).numpy()
    assert np.array_equal(np.isnan(want), np.isnan(got))
    if method == "lanczos":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.array_equal(want, got, equal_nan=True)
    with pytest.raises(ValueError):
        warp.warp_flow(torch.from_numpy(img), torch.from_numpy(fl), method="area")


@pytest.fixture(scope="module")
def recorded():
    return dict(np.load(RECORD))


def test_calculate_flow_2(recorded):
    a = moving_blob(3, 32, 64, 2.0)
    fwd, bwd = flow.calculate_flow_2(a, np.roll(a, 3, axis=2), device="cpu")
    assert fwd.shape == (3, 32, 64, 2)
    mask = a > 30
    for got, want in ((fwd, recorded["flow2_fwd"]), (bwd, recorded["flow2_bwd"])):
        for t in range(3):
            _gate(got[t].numpy(), want[t], mask[t])
    assert torch.equal(fwd[-1], -bwd[-1]) and torch.equal(bwd[0], -fwd[0])
    np.testing.assert_allclose(np.median(fwd[0].numpy()[mask[0]][:, 0]), 3.0, atol=0.4)


def test_calculate_flow_frame():
    frames = moving_blob(2, 32, 64, 2.0)
    fwd, bwd = flow.calculate_flow_frame(frames[0], frames[1], device="cpu")
    m = frames[0] > 30
    assert np.allclose(np.median(fwd.numpy()[m][:, 0]), 2.0, atol=0.3)
    assert np.allclose(np.median(bwd.numpy()[m][:, 0]), -2.0, atol=0.3)


def test_combine_flow_and_magnitude():
    rng = np.random.default_rng(6)
    fields = [rng.normal(0, s, (2, 3, 8, 8, 2)).astype(np.float32) for s in (0.3, 2.0, 5.0)]
    jflows = [jflow.Flow(f[0], f[1]) for f in fields]
    flows = [flow.Flow.from_numpy(f[0], f[1], device="cpu") for f in fields]
    want, got = jflow.combine_flow(*jflows), flow.combine_flow(*flows)
    assert np.array_equal(np.asarray(want.forward_flow), got.forward_flow.numpy())
    assert np.array_equal(np.asarray(want.backward_flow), got.backward_flow.numpy())
    for direction in ("forward", "backward"):
        assert np.array_equal(np.asarray(jflow.flow_magnitude(jflows[1], direction)),
                              flow.flow_magnitude(flows[1], direction).numpy())
    with pytest.raises(ValueError):
        flow.flow_magnitude(flows[0], "sideways")


def test_forward_warp_and_mse(recorded):
    frames = moving_blob(4, 32, 64, 2.0)
    jf = jflow.Flow(recorded["fwd"], recorded["bwd"])
    f = flow.Flow.from_numpy(recorded["fwd"], recorded["bwd"], device="cpu")
    want = jflow.get_forward_warp(frames, jf)
    assert np.array_equal(want, flow.get_forward_warp(frames, f).numpy(), equal_nan=True)
    np.testing.assert_allclose(flow.flow_diff_mse_estimate(frames, f, cold_threshold=100.0),
                               jflow.flow_diff_mse_estimate(frames, jf, cold_threshold=100.0),
                               rtol=1e-5)


def test_flow_residual(recorded):
    frames = moving_blob(4, 32, 64, 2.0)
    f = flow.Flow.from_numpy(recorded["fwd"], recorded["bwd"], device="cpu")
    residual = flow.get_flow_residual(frames, f).numpy()
    for t in range(3):
        _gate(residual[t], recorded["residual"][t], frames[t] > 30)
    got = flow.flow_residual_mse_estimate(frames, f, margin=QC_MARGIN, cold_threshold=100.0)
    np.testing.assert_allclose(got, recorded["residual_mse"], rtol=0.05, atol=1e-4)


def _field(seed, nan=True):
    a = np.random.default_rng(seed).normal(250, 20, (2, 24, 32))
    if nan:
        a[0, 2:5, 3:9] = np.nan
    return a


@pytest.mark.parametrize("name", ["linear_norm", "log_norm", "inverse_log_norm", "z_norm",
                                  "uniform_norm", "local_linear_norm"])
def test_host_normalisations(name):
    a = _field(7, nan=name not in ("uniform_norm",))
    want = getattr(jnorm, name)(a.copy())
    got = getattr(norm, name)(a.copy())
    assert np.array_equal(want, got, equal_nan=True)
    assert norm.select_normalisation_method(name.replace("_norm", "").replace(
        "z", "z_score")) is getattr(norm, name)


def test_to_8bit_and_selector():
    a = _field(8)
    assert np.array_equal(jnorm.to_8bit(a.copy()), norm.to_8bit(a.copy()))
    assert np.array_equal(jnorm.to_8bit(a[0].copy(), 200, 300),
                          norm.to_8bit(a[0].copy(), 200, 300))
    with pytest.raises(ValueError, match="normalisation"):
        norm.select_normalisation_method("cubic")
