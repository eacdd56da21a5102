"""The sharded detection pipeline over a (t, x) mesh (counterpart of
``tobac_flow_tpu/parallel/pipeline.py``).

Every rank calls these functions with the global volumes; each takes its
tile, runs the dense stages on it with halo exchanges
(``parallel/science.py``, ``parallel/label.py``,
``parallel/watershed.py``) and sends its tiles of what the caller gets
back to rank 0: pairwise optical flow, the growth markers, their
flow-displaced labels, the anvil edge field and marker mask, and the
seeded anvil floods.  The label bookkeeping between the floods (the
flow-linked anvil markers, the length and marker filters, the overlap
relabel) depends on whole objects, so it runs once, on rank 0, through the
single-device functions, and rank 0 sends each rank its tile of the
result.  Only rank 0 holds whole volumes; the other ranks hold tiles.
"""

from __future__ import annotations

import math
import time
from contextlib import contextmanager

import numpy as np
import torch

from tobac_flow_tpu_torch.models.farneback import FarnebackFlow, FarnebackParams
from tobac_flow_tpu_torch.parallel.halo import halo_exchange_t, halo_exchange_x
from tobac_flow_tpu_torch.parallel.label import IN_PLANE, _label_step_local
from tobac_flow_tpu_torch.parallel.science import (
    sharded_anvil_marker_mask, sharded_anvil_post, sharded_anvil_prep, sharded_core_markers,
)
from tobac_flow_tpu_torch.parallel.watershed import global_marker_labels, sharded_watershed_local

__all__ = [
    "sharded_detect_step", "make_sharded_step", "make_sharded_anvil_step",
    "make_sharded_thin_step", "sharded_detect_all",
]

STEP_OUTPUTS = ("forward_flow", "backward_flow", "core_markers", "core_labels", "edges",
                "thick_labels", "anvil_mask")


@contextmanager
def _timed(stats, name, mesh):
    """Add the body's seconds (the device synchronised at its end) to
    ``stats[name + "_s"]``."""
    t0 = time.perf_counter()
    yield
    if stats is not None:
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        stats[f"{name}_s"] = stats.get(f"{name}_s", 0.0) + time.perf_counter() - t0


def _local_flow(bt_h, params, vr_steps=0, smoothing_passes=0, interp_method="linear"):
    """Forward and backward flow of the T_l interior frames of a
    halo-extended (T_l + 2, H, W) block: every pair normalised over its own
    tile, Farneback both ways in one batch, then the CLI's refinement and
    smoothing passes (elementwise and banded, so they run on the tile
    unchanged; near a tile's edge the warps read the x halo)."""
    from tobac_flow_tpu_torch.core.flow import smooth_flow_step
    from tobac_flow_tpu_torch.models.variational import variational_refine
    from tobac_flow_tpu_torch.pipeline import _normalise_pair

    p8, n8 = _normalise_pair(bt_h[:-1], bt_h[1:], "linear")
    n = p8.shape[0]
    both = FarnebackFlow(params).to(bt_h.device)(torch.cat([p8, n8]), torch.cat([n8, p8]))
    fwd, bwd = both[:n], both[n:]
    if vr_steps > 0:
        fwd = variational_refine(p8, n8, fwd, steps=vr_steps)
        bwd = variational_refine(n8, p8, bwd, steps=vr_steps)
    for _ in range(smoothing_passes):
        fwd, bwd = smooth_flow_step(fwd, bwd, method=interp_method)
    # interior frame i (block index i + 1): forward = pair i + 1, backward = pair i
    return fwd[1:], bwd[:-1]


def _stencil_gather(data_h, flow, dyx, taps, fill):
    """Flow-displaced neighbours from a ±1-frame halo block through the
    one-axis banded warp (``ops.banded.banded_warp_axis``, radius 21): the
    integer tap offsets fold into the displacement, so each tap is a y
    pass and an x pass.  data_h: (T_l + 2, H, W); flow: (T_l, H, W, 2)
    toward the neighbouring frame ``dyx`` (±1); returns the (T_l, H, W)
    taps."""
    from tobac_flow_tpu_torch.ops.banded import banded_warp_axis

    tl = flow.shape[0]
    neighbour = data_h[1 + dyx:1 + dyx + tl]
    out = []
    for ox, oy in taps:
        a = banded_warp_axis(neighbour, flow[..., 1] + oy, -2, 21, fill)
        out.append(banded_warp_axis(a, flow[..., 0] + ox, -1, 21, fill))
    return out


def _detect_step_local(mesh, bt, wvd, swd, dt, fwd_in, bwd_in, *, params, hx, ws_sweeps,
                       vr_steps, smoothing_passes, interp_method, use_wvd, wvd_threshold,
                       bt_threshold, thick_upper, thick_lower, erode_distance, warp_radius,
                       w_global, use_injected_flows, label_rounds, run_thick, stats=None):
    """Per rank, on (T_l, H, W_l) tiles: flow (unless injected), the growth
    markers, their flow-displaced labels, the anvil marker mask, the edge
    field and (with ``run_thick``) the thick-anvil flood from pixel-id
    seeds.  Returns the seven tiles of ``STEP_OUTPUTS``."""
    with _timed(stats, "flow", mesh):
        if use_injected_flows:
            fwd, bwd = fwd_in, bwd_in
        else:
            bt_h = halo_exchange_t(mesh, halo_exchange_x(mesh, bt, hx, math.nan), 1, math.nan)
            fwd, bwd = _local_flow(bt_h, params, vr_steps, smoothing_passes, interp_method)
            fwd, bwd = fwd.clamp(-20.0, 20.0), bwd.clamp(-20.0, 20.0)
            # the reference's rule at the sequence's ends
            if mesh.t == 0:
                bwd[0] = -fwd[0]
            if mesh.t == mesh.n_t - 1:
                fwd[-1] = -bwd[-1]
            # the science exchanges its own halos
            fwd = fwd[:, :, hx:fwd.shape[2] - hx].contiguous()
            bwd = bwd[:, :, hx:bwd.shape[2] - hx].contiguous()
    with _timed(stats, "cores", mesh):
        core_markers = sharded_core_markers(
            mesh, bt, wvd, swd, fwd, bwd, dt, hx, w_global, use_wvd=use_wvd,
            wvd_threshold=wvd_threshold, bt_threshold=bt_threshold, warp_radius=warp_radius,
            stats=stats)
    with _timed(stats, "core_labels", mesh):
        core_labels, rounds = _label_step_local(mesh, core_markers, fwd, bwd, w_global,
                                                IN_PLANE, warp_radius, label_rounds)
    if stats is not None:
        stats["core_label_rounds"] = rounds
    with _timed(stats, "anvil_prep", mesh):
        field_thick = wvd - swd
        anvil_mask = sharded_anvil_marker_mask(mesh, field_thick, thick_upper)
        marker_ids = global_marker_labels(mesh, anvil_mask, w_global)
        edges, eroded = sharded_anvil_prep(mesh, field_thick, marker_ids, fwd, bwd, thick_lower,
                                           thick_upper, erode_distance, hx, warp_radius)
    if run_thick:
        # a flood from pixel-id seeds; the whole chain (sharded_detect_all)
        # floods from the flow-linked marker labels instead
        with _timed(stats, "thick_flood", mesh):
            flood = {}
            thick = sharded_watershed_local(
                mesh, edges, eroded, torch.round(fwd).to(torch.int32),
                torch.round(bwd).to(torch.int32), radius=warp_radius, max_rounds=ws_sweeps,
                stats=flood)
            thick = sharded_anvil_post(mesh, thick, marker_ids)
        if stats is not None:
            stats["thick_flood_rounds"] = flood["rounds"]
    else:
        thick = torch.zeros_like(eroded)
    return fwd, bwd, core_markers, core_labels, edges, thick, anvil_mask


def make_sharded_step(mesh, w_global, dt_minutes: float = 5.0,
                      params: FarnebackParams | None = None, hx: int = 24, ws_sweeps: int = 8,
                      vr_steps: int = 0, smoothing_passes: int = 0,
                      interp_method: str = "linear", use_wvd: bool = True,
                      wvd_threshold: float = 0.25, bt_threshold: float = 0.5,
                      thick_upper: float = -5.0, thick_lower: float = -12.5,
                      erode_distance: int = 2, warp_radius: int = 21,
                      inject_flows: bool = False, label_rounds: int = 256,
                      run_thick: bool = True, stats=None, gather=True):
    """The SPMD detection step for a mesh: ``step(bt, wvd, swd[, fwd,
    bwd])``, called on every rank with the global (T, H, W) fields (and
    (T, H, W, 2) flows with ``inject_flows``), returns the seven global
    volumes of ``STEP_OUTPUTS`` on rank 0's device (Nones on the other
    ranks; every rank's own tiles with ``gather=False``).  ``hx`` must be at least ``warp_radius + 3``
    for results exact at the tile edges (the warp band plus the deepest
    local stencil); injected flows make the step comparable bit for bit
    with the single-device stages.  ``stats``, a dict, gets each part's
    seconds and rounds."""
    if params is None:
        params = FarnebackParams(num_levels=2, winsize=9, num_iters=3)
    kw = dict(params=params, hx=hx, ws_sweeps=ws_sweeps, vr_steps=vr_steps,
              smoothing_passes=smoothing_passes, interp_method=interp_method, use_wvd=use_wvd,
              wvd_threshold=wvd_threshold, bt_threshold=bt_threshold,
              thick_upper=thick_upper, thick_lower=thick_lower, erode_distance=erode_distance,
              warp_radius=warp_radius, w_global=w_global, use_injected_flows=inject_flows,
              label_rounds=label_rounds, run_thick=run_thick, stats=stats)

    def step(bt, wvd, swd, fwd=None, bwd=None):
        tiles = [mesh.tile(a, torch.float32) for a in (bt, wvd, swd)]
        dt = torch.full((tiles[0].shape[0], 1, 1), float(dt_minutes), device=mesh.device)
        if inject_flows:
            fwd, bwd = mesh.tile(fwd, torch.float32), mesh.tile(bwd, torch.float32)
        out = _detect_step_local(mesh, *tiles, dt, fwd, bwd, **kw)
        if not gather:
            return out
        with _timed(stats, "gather", mesh):
            return tuple(mesh.gather(a) for a in out)

    return step


def sharded_detect_step(mesh, bt, wvd, swd, flows=None, **kwargs):
    """Run one detection step over the mesh (see :func:`make_sharded_step`);
    ``flows=(fwd, bwd)`` injects flow fields, otherwise each tile computes
    its flow in the step."""
    step = make_sharded_step(mesh, bt.shape[-1], inject_flows=flows is not None, **kwargs)
    return step(bt, wvd, swd, *(flows or ()))


def _anvil_step_local(mesh, field, markers, fwd, bwd, *, hx, warp_radius, upper, lower,
                      erode_distance, ws_sweeps, stats=None):
    """Per rank: one seeded anvil flood, its inputs (linearised field,
    eroded markers, uphill-Sobel edges) and its clean-up."""
    edges, eroded = sharded_anvil_prep(mesh, field, markers, fwd, bwd, lower, upper,
                                       erode_distance, hx, warp_radius)
    labels = sharded_watershed_local(mesh, edges, eroded, torch.round(fwd).to(torch.int32),
                                     torch.round(bwd).to(torch.int32), radius=warp_radius,
                                     max_rounds=ws_sweeps, stats=stats)
    return sharded_anvil_post(mesh, labels, markers)


def make_sharded_anvil_step(mesh, hx: int = 24, ws_sweeps: int = 8, upper: float = -5.0,
                            lower: float = -12.5, erode_distance: int = 2,
                            warp_radius: int = 21, stats=None):
    """One seeded anvil flood over the mesh: ``fn(field, markers, fwd,
    bwd)`` with the global volumes returns the global anvil labels on rank
    0's device (None on the other ranks).  ``ws_sweeps`` caps the flood's rounds.  The thick
    anvils (upper -5, lower -12.5, the flow-linked anvil markers) and the
    thin ones (upper 0, lower -7.5, the relabelled thick anvils) are both
    this step.  ``stats``, a dict, gets ``rounds``."""

    def fn(field, markers, fwd, bwd):
        labels = _anvil_step_local(
            mesh, mesh.tile(field, torch.float32), mesh.tile(markers, torch.int32),
            mesh.tile(fwd, torch.float32), mesh.tile(bwd, torch.float32), hx=hx,
            warp_radius=warp_radius, upper=upper, lower=lower, erode_distance=erode_distance,
            ws_sweeps=ws_sweeps, stats=stats)
        return mesh.gather(labels)

    return fn


def make_sharded_thin_step(mesh, thin_upper=0.0, thin_lower=-7.5, **kw):
    """The thin-anvil flood: :func:`make_sharded_anvil_step` with the thin
    thresholds."""
    return make_sharded_anvil_step(mesh, upper=thin_upper, lower=thin_lower, **kw)


def _on_rank0(mesh, fn, shape):
    """``fn()``'s int32 volume of ``shape``, computed on rank 0: (the
    volume on rank 0 and None on the other ranks, this rank's tile of
    it)."""
    whole = fn().to(device=mesh.device, dtype=torch.int32) if mesh.rank == 0 else None
    return whole, mesh.scatter(whole, shape, torch.int32)


def _kept(labels, markers, min_length):
    """Labels longer than ``min_length`` steps that overlap ``markers``."""
    from tobac_flow_tpu_torch.detect.analysis import find_object_lengths, mask_labels
    from tobac_flow_tpu_torch.utils.labels import remap_labels

    keep = (find_object_lengths(labels) > min_length) & mask_labels(labels, markers != 0)
    return remap_labels(labels, keep)


def sharded_detect_all(mesh, bt, wvd, swd, flows=None, overlap: float = 0.5,
                       absolute_overlap: int = 4, min_length: int = 3, relabel: bool = True,
                       thick_upper: float = -5.0, thick_lower: float = -12.5,
                       thin_upper: float = 0.0, thin_lower: float = -7.5,
                       erode_distance: int = 2, stats=None, **kwargs):
    """The whole sharded chain: flow, cores, anvil markers, thick anvils,
    relabel, thin anvils (the dense pipeline of
    ``cli.common.run_detection``), called on every rank with the global
    fields (and ``flows=(fwd, bwd)`` to inject flows).  The dense stages
    run on the tiles; the label bookkeeping between them runs on rank 0
    through the single-device functions (``get_anvil_markers``, the length
    and marker filters, ``relabel_anvils``), which gets the tiles it needs
    and sends each rank its tile of the result.  Returns, on rank 0, a
    dict of global volumes on its device: the flows, the core markers and
    labels, the anvil marker mask and labels, and the thick and thin anvil
    labels; None on the other ranks.  ``ws_sweeps`` (default 8) caps each
    anvil flood's rounds.  ``stats``, a dict, gets each part's seconds and
    rounds."""
    from tobac_flow_tpu_torch.core.flow import Flow
    from tobac_flow_tpu_torch.detect.detection import get_anvil_markers, relabel_anvils

    kwargs.setdefault("run_thick", False)  # the chain floods from the linked markers below
    step = make_sharded_step(mesh, bt.shape[-1], thick_upper=thick_upper,
                             thick_lower=thick_lower, erode_distance=erode_distance,
                             inject_flows=flows is not None, stats=stats, gather=False,
                             **kwargs)
    tiles = step(bt, wvd, swd, *(flows or ()))
    fwd_l, bwd_l = tiles[0], tiles[1]
    with _timed(stats, "gather", mesh):
        fwd, bwd, core_markers, core_labels = (mesh.gather(a) for a in tiles[:4])
        anvil_mask = mesh.gather(tiles[6])
    del tiles
    root = mesh.rank == 0
    flow = Flow(fwd, bwd) if root else None
    shape = tuple(bt.shape[:3])

    def field(sign, whole=False):
        """``wvd + sign·swd``, float32, on this rank's device: this rank's
        tile, or (``whole``, rank 0's bookkeeping) the whole volume."""
        if whole:
            a, b = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
                    for x in (wvd, swd))
        else:
            a, b = mesh.tile(wvd), mesh.tile(swd)
        return a.to(mesh.device, torch.float32) + sign * b.to(mesh.device, torch.float32)

    with _timed(stats, "host_markers", mesh):
        markers, markers_l = _on_rank0(mesh, lambda: get_anvil_markers(
            flow, field(-1, whole=True), threshold=thick_upper, overlap=overlap,
            absolute_overlap=absolute_overlap, min_length=min_length), shape)
    anvil_kw = dict(hx=kwargs.get("hx", 24), ws_sweeps=kwargs.get("ws_sweeps", 8),
                    erode_distance=erode_distance, warp_radius=kwargs.get("warp_radius", 21))
    thick_stats, thin_stats = {}, {}
    with _timed(stats, "thick_flood", mesh):
        thick = mesh.gather(_anvil_step_local(
            mesh, field(-1), markers_l, fwd_l, bwd_l, upper=thick_upper, lower=thick_lower,
            stats=thick_stats, **anvil_kw))

    def thick_tail():
        kept = _kept(thick, markers, min_length)
        if not relabel:
            return kept
        return relabel_anvils(flow, kept, markers=markers, overlap=overlap,
                              absolute_overlap=absolute_overlap, min_length=min_length)

    with _timed(stats, "host_thick", mesh):
        thick, thick_l = _on_rank0(mesh, thick_tail, shape)
    with _timed(stats, "thin_flood", mesh):
        thin = mesh.gather(_anvil_step_local(
            mesh, field(1), thick_l, fwd_l, bwd_l, upper=thin_upper, lower=thin_lower,
            stats=thin_stats, **anvil_kw))
    with _timed(stats, "host_thin", mesh):
        if root:
            thin = _kept(thin, thick, min_length).to(device=mesh.device, dtype=torch.int32)
    if stats is not None:
        for name, st in (("thick", thick_stats), ("thin", thin_stats)):
            stats[f"{name}_flood_rounds"] = st["rounds"]
            stats[f"{name}_barrier_rounds"] = st.get("barrier_rounds", 0)
    if not root:
        return None
    return {
        "forward_flow": fwd, "backward_flow": bwd, "core_markers": core_markers,
        "core_labels": core_labels, "anvil_marker_mask": anvil_mask,
        "anvil_marker_labels": markers, "thick_anvil_labels": thick,
        "thin_anvil_labels": thin,
    }
