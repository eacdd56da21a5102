"""The port's six other flow models, its registry and its batched flow
function against ``tobac_flow_tpu/models`` on the CPU.

Inputs: two different frame pairs at 64×96 (two pyramid levels for every
model; ``tools/record_torch_refs.model_pairs``), quantised as the flow path
quantises them.  The JAX package's pair flows, and its ``batch_flow``
under each jitted normalisation, are recorded once by
``tools/record_torch_refs.py`` (``tests/data/flow_models.npz``): TV-L1,
DeepFlow and SimpleFlow take 6-8 s each to trace and compile.

Tolerances, inside the moving blob (BT < 260 K):
- every model: Farneback's gate, p99 |Δflow| ≤ 0.01 px, max ≤ 0.1 px,
  rounded flows equal on ≥ 99.9 % of pixels.  XLA sums the patch and
  window reductions and the box blurs in other orders, and fuses
  multiply-adds, so single steps differ in the last bits (measured at
  64×96: DIS, SparseToDense, PCA, TV-L1 and SimpleFlow within 2e-5 px;
  DeepFlow's relinearisations and matches carry more).
- batched over the two pairs: each pair within the same gate of its own
  reference (a statistic taken over the batch instead of the pair would
  miss it).
- ``_normalise_pair``'s quantised frames under each jitted normalisation:
  exact (the z-score's sums in the reference's order, its log as its
  compiled program computes it).
- ``batch_flow`` (Farneback) under each normalisation: the same gate.
"""

from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

# one intra-op thread: the suite runs several test processes side by side
torch.set_num_threads(1)

from tobac_flow_tpu import models as jmodels  # noqa: E402
from tobac_flow_tpu_torch import models  # noqa: E402
from tobac_flow_tpu_torch.pipeline import _normalise_pair  # noqa: E402
from tools.record_torch_refs import MODELS, NORMALISATIONS, model_pairs  # noqa: E402

RECORD = Path(__file__).resolve().parent / "data" / "flow_models.npz"
PORTED = {"DIS": "dis", "DualTVL1": "tvl1", "DeepFlow": "deepflow", "PCA": "pcaflow",
          "SimpleFlow": "simpleflow", "SparseToDense": "sparse_to_dense"}
# non-default values for every field of each params class
PARAMS = {
    "DIS": dict(patch_size=4, num_levels=3, iters_per_level=5, refine_steps=2),
    "DualTVL1": dict(tau=0.2, lambda_=0.4, theta=0.25, num_levels=4, warps=6, inner_iters=30),
    "DeepFlow": dict(num_levels=4, match_radius=2, match_window=5, alpha=8.0,
                     fixed_point_iters=4, jacobi_iters=7),
    "PCA": dict(basis_size=5, stride=4, num_levels=3, iters_per_level=6, ridge=0.05),
    "SimpleFlow": dict(radius=2, window=5, num_levels=3, sigma_flow=1.0),
    "SparseToDense": dict(stride=4, num_levels=3, iters_per_level=6, sigma_densify=1.5),
}


@pytest.fixture(scope="module")
def recorded():
    return dict(np.load(RECORD))


@pytest.fixture(scope="module")
def quantised():
    """Each pair's frames quantised by the port ((2, H, W) each), checked
    equal to the reference's."""
    pairs = model_pairs()
    p8, n8 = _normalise_pair(torch.from_numpy(pairs[:, 0]), torch.from_numpy(pairs[:, 1]))
    for i, (a, b) in enumerate(pairs):
        want = jax.jit(lambda x, y: jmodels._normalise_pair(x, y, "linear"))(a, b)
        assert np.array_equal(np.asarray(want[0]), p8[i].numpy())
        assert np.array_equal(np.asarray(want[1]), n8[i].numpy())
    return p8, n8


def _gate(out, want, mask):
    diff = np.abs(out - want)[mask]
    p99, top = np.percentile(diff, 99), diff.max()
    rounded = (np.round(out) == np.round(want))[mask].mean()
    assert p99 <= 0.01 and top <= 0.1 and rounded >= 0.999, (p99, top, rounded)


def _masks():
    return model_pairs()[:, 0] < 260.0


@pytest.mark.parametrize("name", sorted(PORTED))
@pytest.mark.parametrize("pair", [0, 1])
def test_model_pair(name, pair, recorded, quantised):
    p8, n8 = quantised
    out = models.select_of_model(name)(p8[pair], n8[pair])
    assert out.shape == p8.shape[1:] + (2,) and out.dtype == torch.float32
    _gate(out.numpy(), recorded[f"{name}_{pair}"], _masks()[pair])


@pytest.mark.parametrize("name", sorted(PORTED))
def test_model_batched_over_two_pairs(name, recorded, quantised):
    p8, n8 = quantised
    out = models.select_of_model(name)(p8, n8)
    assert out.shape == p8.shape + (2,)
    masks = _masks()
    for pair in range(2):
        _gate(out[pair].numpy(), recorded[f"{name}_{pair}"], masks[pair])
    # the flow follows each blob: (2.5, 1.25) and (-1.5, 2.0) px
    for pair, want in enumerate(((2.5, 1.25), (-1.5, 2.0))):
        np.testing.assert_allclose(np.median(out[pair].numpy()[masks[pair]], axis=0), want,
                                   atol=0.5)


@pytest.mark.parametrize("name", sorted(PORTED))
def test_from_jax_params(name):
    import importlib

    mod, _, cls = MODELS[name]
    jparams = getattr(importlib.import_module(f"tobac_flow_tpu.models.{mod}"), cls)(
        **PARAMS[name])
    port = importlib.import_module(f"tobac_flow_tpu_torch.models.{PORTED[name]}")
    for source in (jparams, dict(PARAMS[name])):
        module = port.from_jax_params(source)
        assert isinstance(module, torch.nn.Module)
        assert module.params.as_dict() == PARAMS[name]
    default = port.from_jax_params(getattr(importlib.import_module(
        f"tobac_flow_tpu.models.{mod}"), cls)())
    assert default.params == type(default.params)()
    assert models.select_of_model(name, module.params).params == module.params


def test_registry():
    assert list(models.FLOW_MODELS) == list(jmodels.FLOW_MODELS)
    for name in jmodels.FLOW_MODELS:
        if name == "DenseRLOF":
            with pytest.raises(NotImplementedError, match="DenseRLOF"):
                models.select_of_model(name)
            continue
        module = models.select_of_model(name)
        assert isinstance(module, torch.nn.Module), name
        assert callable(jmodels.select_of_model(name))
    with pytest.raises(ValueError, match="must be one of"):
        models.select_of_model("RAFT")


@pytest.mark.parametrize("method", NORMALISATIONS)
def test_normalise_pair_exact(method):
    rng = np.random.default_rng(3)
    a = rng.normal(250, 15, (2, 40, 72)).astype(np.float32)
    b = rng.normal(240, 25, (2, 40, 72)).astype(np.float32)
    a[0, 3:9, 5:20] = np.nan  # a hole the other frame fills
    b[1] += 30.0  # a pair whose range differs from the first's
    p8, n8 = _normalise_pair(torch.from_numpy(a), torch.from_numpy(b), method)
    for i in range(2):
        want = jax.jit(lambda x, y: jmodels._normalise_pair(x, y, method))(a[i], b[i])
        assert np.array_equal(np.asarray(want[0]), p8[i].numpy())
        assert np.array_equal(np.asarray(want[1]), n8[i].numpy())


def test_normalise_pair_unknown_method():
    x = torch.zeros((1, 4, 4))
    with pytest.raises(NotImplementedError, match="uniform"):
        _normalise_pair(x, x, "uniform")


@pytest.mark.parametrize("method", NORMALISATIONS)
def test_batch_flow_normalisation(method, recorded):
    pair = model_pairs()[0]
    fwd, bwd = models.batch_flow(pair, normalisation_method=method, device="cpu")
    mask = pair[0] < 260.0
    _gate(fwd[0].numpy(), recorded[f"norm_{method}_fwd"], mask)
    _gate(bwd[1].numpy(), recorded[f"norm_{method}_bwd"], mask)
    assert torch.equal(fwd[-1], -bwd[-1]) and torch.equal(bwd[0], -fwd[0])
