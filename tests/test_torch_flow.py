"""The port's CLI-default flow pieces against ``tobac_flow_tpu/core/flow.py``,
``tobac_flow_tpu/models/variational.py`` and ``tobac_flow_tpu/models``.

- ``smooth_flow_step`` (linear, cubic): bit-equal to the reference's
  compiled step (NaN where it has NaN).
- ``variational_refine``: within 1e-4 px of the reference on a smooth
  frame pair (measured: 3.7e-6 px); the reference's compiled program fuses
  its multiply-adds and the port does not, so single steps agree to
  rounding and the refinement's relinearisations carry it on.
- The registry and the flow functions: the ported models build,
  DenseRLOF and the non-jitted normalisations raise (the other models and
  normalisations are held to the reference in
  ``test_torch_flow_models.py``, Lanczos smoothing in
  ``test_torch_flow_qc.py``).

``create_flow`` with the CLI defaults is held to the reference in
``test_torch_detect.py``, which computes the reference's flows once for
the chain.  Inputs from numpy seeds.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu.core import flow as jflow  # noqa: E402
from tobac_flow_tpu.models.variational import variational_refine as jvariational  # noqa: E402
from tobac_flow_tpu_torch import models  # noqa: E402
from tobac_flow_tpu_torch.core import flow  # noqa: E402
from tobac_flow_tpu_torch.models.variational import variational_refine  # noqa: E402
from tobac_flow_tpu_torch.pipeline import device_flow  # noqa: E402


def _flows(seed, shape=(2, 40, 48)):
    rng = np.random.default_rng(seed)
    fwd = rng.normal(0, 3, shape + (2,)).astype(np.float32)
    bwd = (-fwd + rng.normal(0, 1, fwd.shape)).astype(np.float32)
    fwd[0, :3, :3] = np.nan
    return fwd, bwd


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_smooth_flow_step(method):
    fwd, bwd = _flows(1)
    ref = jax.jit(jax.vmap(lambda f, b: jflow.smooth_flow_step(f, b, method=method)))(fwd, bwd)
    out = flow.smooth_flow_step(torch.from_numpy(fwd), torch.from_numpy(bwd), method=method)
    for r, o in zip(ref, out):
        assert np.array_equal(np.asarray(r), o.numpy(), equal_nan=True)


def _smooth_pair():
    yy, xx = np.mgrid[0:40, 0:48]
    a = np.round(100 + 80 * np.exp(-((xx - 20) ** 2 + (yy - 18) ** 2) / 60.0))
    b = np.round(100 + 80 * np.exp(-((xx - 22) ** 2 + (yy - 19) ** 2) / 60.0))
    return a.astype(np.float32), b.astype(np.float32)


def test_variational_refine():
    i1, i2 = _smooth_pair()
    init = np.zeros((40, 48, 2), np.float32)
    init[..., 0] = 1.5
    ref = np.asarray(jax.jit(jvariational)(i1, i2, init))
    out = variational_refine(torch.from_numpy(i1)[None], torch.from_numpy(i2)[None],
                             torch.from_numpy(init)[None])[0].numpy()
    assert np.abs(ref - init).max() > 0.5  # the refinement moved the flow
    assert np.abs(ref - out).max() <= 1e-4


def test_model_registry():
    assert isinstance(models.select_of_model("Farneback"), torch.nn.Module)
    assert isinstance(models.select_of_model("DIS"), torch.nn.Module)
    with pytest.raises(NotImplementedError, match="DenseRLOF"):
        models.select_of_model("DenseRLOF")
    with pytest.raises(ValueError):
        models.select_of_model("nope")
    with pytest.raises(NotImplementedError, match="uniform"):
        models.batch_flow(np.zeros((2, 8, 8), np.float32), normalisation_method="uniform",
                          device="cpu")


def test_cli_default_flow_runs_and_clips():
    i1, i2 = _smooth_pair()
    data = np.stack([i1, i2, i1])
    fwd, bwd = device_flow(data, vr_steps=1, smoothing_passes=1, interp_method="cubic",
                           device="cpu")
    f = flow.create_flow(data, vr_steps=1, smoothing_passes=1, interp_method="cubic",
                         device="cpu")
    assert torch.equal(f.forward_flow, fwd) and torch.equal(f.backward_flow, bwd)
    assert fwd.shape == (3, 40, 48, 2) and float(fwd.abs().max()) <= 20.0
    assert torch.equal(fwd[-1], -bwd[-1]) and torch.equal(bwd[0], -fwd[0])
    with pytest.raises(ValueError, match="method"):
        flow.smooth_flow_step(fwd, bwd, method="area")
