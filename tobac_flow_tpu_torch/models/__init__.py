"""Optical-flow model registry and the batched flow function (counterpart of
``tobac_flow_tpu/models/__init__.py``).

The registry keeps the reference's eight names.  Seven are ported, each a
module that maps a batch of frame pairs (B, H, W) to flows (B, H, W, 2):
Farneback (the detection chain's default), DIS, DualTVL1, DeepFlow, PCA,
SimpleFlow and SparseToDense.  DenseRLOF raises as it does in the
reference (it needs multi-channel input).
"""

from __future__ import annotations

import importlib

__all__ = ["FLOW_MODELS", "select_of_model", "batch_flow"]

# model name -> (module, class) of its port; "not_implemented" as the reference
FLOW_MODELS = {
    "Farneback": ("farneback", "FarnebackFlow"),
    "DIS": ("dis", "DISFlow"),
    "DualTVL1": ("tvl1", "TVL1Flow"),
    "DeepFlow": ("deepflow", "DeepFlow"),
    "PCA": ("pcaflow", "PCAFlow"),
    "SimpleFlow": ("simpleflow", "SimpleFlow"),
    "SparseToDense": ("sparse_to_dense", "SparseToDenseFlow"),
    "DenseRLOF": "not_implemented",
}


def select_of_model(model: str, params=None):
    """The pair-flow module of a named model with ``params`` (its params
    class; ``None`` for the defaults): ``module(prev, nxt)`` maps frames
    (B, H, W) to flows (B, H, W, 2)."""
    if model not in FLOW_MODELS:
        raise ValueError(
            "'model' parameter must be one of: " + ", ".join(repr(k) for k in FLOW_MODELS)
        )
    entry = FLOW_MODELS[model]
    if entry == "not_implemented":
        raise NotImplementedError(
            "DenseRLOF requires multi-channel input which is currently not implemented"
        )
    module, cls = entry
    return getattr(importlib.import_module(f"tobac_flow_tpu_torch.models.{module}"), cls)(params)


def batch_flow(data, model: str = "Farneback", vr_steps: int = 0,
               smoothing_passes: int = 0, interp_method: str = "linear",
               normalisation_method: str = "linear", params=None, device=None):
    """Forward/backward flow for every adjacent frame pair of (T, H, W)
    data, unclipped, on ``device`` (see :func:`resolve_device`); the
    boundary frames take the negated opposite flow.  Each pair is
    normalised over its own two frames by ``normalisation_method``
    ("linear", "z_score", "log" or "inverse_log"); the pairs of both
    directions run as one batch where the device holds them (see
    :func:`~tobac_flow_tpu_torch.pipeline.pair_flows`)."""
    from tobac_flow_tpu_torch.pipeline import pair_flows

    return pair_flows(data, select_of_model(model, params), vr_steps=vr_steps,
                      smoothing_passes=smoothing_passes, interp_method=interp_method,
                      normalisation_method=normalisation_method, device=device)
