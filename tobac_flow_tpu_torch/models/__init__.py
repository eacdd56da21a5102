"""Optical-flow model registry and the batched flow function (counterpart of
``tobac_flow_tpu/models/__init__.py``).

The registry keeps the reference's eight names.  Farneback, the default
and the only model the detection chain uses, is ported; the others raise
``NotImplementedError`` (DenseRLOF raises as it does in the reference).
"""

from __future__ import annotations

__all__ = ["FLOW_MODELS", "select_of_model", "batch_flow"]

_LATER = "ROADMAP.md, 'Modules to port', item 11 (other flow models)"
FLOW_MODELS = {
    "Farneback": "farneback",
    "DIS": "later",
    "DualTVL1": "later",
    "DeepFlow": "later",
    "PCA": "later",
    "SimpleFlow": "later",
    "SparseToDense": "later",
    "DenseRLOF": "not_implemented",
}


def select_of_model(model: str, params=None):
    """The pair-flow module of a named model: ``module(prev, nxt)`` maps
    frames (B, H, W) to flows (B, H, W, 2)."""
    if model not in FLOW_MODELS:
        raise ValueError(
            "'model' parameter must be one of: " + ", ".join(repr(k) for k in FLOW_MODELS)
        )
    entry = FLOW_MODELS[model]
    if entry == "not_implemented":
        raise NotImplementedError(
            "DenseRLOF requires multi-channel input which is currently not implemented"
        )
    if entry == "later":
        raise NotImplementedError(f"flow model {model!r} is not ported yet: {_LATER}")
    from tobac_flow_tpu_torch.models.farneback import FarnebackFlow

    return FarnebackFlow(params)


def batch_flow(data, model: str = "Farneback", vr_steps: int = 0,
               smoothing_passes: int = 0, interp_method: str = "linear",
               normalisation_method: str = "linear", params=None, device=None):
    """Forward/backward flow for every adjacent frame pair of (T, H, W)
    data, unclipped, on ``device`` (see :func:`resolve_device`); the
    boundary frames take the negated opposite flow.  Every pair and both
    directions run as one batch."""
    from tobac_flow_tpu_torch.pipeline import pair_flows

    if normalisation_method != "linear":
        raise NotImplementedError(
            f"normalisation_method={normalisation_method!r}: the port normalises "
            "frame pairs linearly only"
        )
    return pair_flows(data, select_of_model(model, params), vr_steps=vr_steps,
                      smoothing_passes=smoothing_passes, interp_method=interp_method,
                      device=device)
