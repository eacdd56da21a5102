"""Sharded flow-aware watershed over a (t, x) mesh (counterpart of
``tobac_flow_tpu/parallel/watershed.py``).

The ranks run the single-device flood's relaxation (``ops/watershed.py``)
on their tiles with the same heap-faithful tie rules: the packed state
(claim, claim2, ``min(hops, 255) << 23 | label + 2``), the hop clock that
ticks only on its level and the barrier-last order of
``ops.ws_sweeps.lex_better``.  So a mesh flood and the single-device flood
agree on ties, not only on clear minimax winners.

- The state lives on each tile's interior.  Each round first refreshes an
  x halo of the state of the temporal band's width (``radius``), so that
  the in-plane and the flow-displaced temporal taps reach across tile
  edges, and a ±1-frame t halo for the temporal taps.
- A round is one full sweep (the in-plane taps, then each neighbouring
  frame pushing along its own rounded flow through the single-device
  scatter-min, ``ops.watershed._banded_scatter_min``) followed by
  ``spatial_per_temporal`` in-plane sweeps.  The in-plane sweeps run on
  the x-extended tile through ``ops.ws_sweeps.spatial_sweeps``: on a card
  the Hopper kernel, K = 1 for the full sweep's in-plane part and K = 8
  for the rest (the reference's ``sweep(st, False)`` eight times).
- The domain's edges are barriers, as the single-device padding is.
- The loop ends after two rounds in which no rank's labels changed (an
  ``all_reduce`` of a changed flag), or after ``max_rounds``.
- As in the single-device flood, a -1 barrier floods alone first, to the
  whole state's convergence, and the rounds start from a 4x coarse flood
  adopted deep inside label-uniform territory: the coarse problem is
  small, so rank 0 floods all of it with the single-device flood.  Without
  these (the reference's sharded flood) a label-only stop freezes the
  barrier's still-relaxing claims, and the labels differ from the single
  device's on a few per cent of the anvil pixels of a multi-storm scene.

Labels must lie in [-1, 2^23 - 3] (the packed meta's contract);
``sharded_watershed_local`` raises on every rank otherwise.
"""

from __future__ import annotations

import math

import torch

from tobac_flow_tpu_torch.ops.watershed import _banded_scatter_min
from tobac_flow_tpu_torch.ops.ws_sweeps import (
    LABEL_MASK, META_MAX, consider, lex_better, max_nan, pushed, spatial_sweeps,
)
from tobac_flow_tpu_torch.parallel.halo import halo_exchange_t, halo_exchange_x
from tobac_flow_tpu_torch.parallel.label import global_pixel_ids

__all__ = ["sharded_watershed", "sharded_watershed_local", "global_marker_labels"]

IN_PLANE = ((1, 0), (-1, 0), (0, 1), (0, -1))  # the reference's in-plane taps, in order
_LABEL_MAX = (1 << 23) - 3
_GRACE = 2
_FACTOR = 4  # the V-cycle's coarsening, the single device's


def _flood(mesh, field_x, markers, mask, fwd_t, bwd_t, state, radius, max_rounds,
           spatial_per_temporal, grace, label_only):
    """Jacobi rounds of the packed ``state`` on the tile until ``grace``
    rounds in a row change nothing on any rank (the labels alone, or the
    whole state) or ``max_rounds`` have run; returns (state, rounds)."""
    hw = int(radius)
    seeded = markers != 0
    seeded_x = halo_exchange_x(mesh, seeded, hw, False).contiguous()
    flood_x = halo_exchange_x(mesh, mask & ~seeded, hw, False).contiguous()
    tl = markers.shape[0]
    # each neighbouring frame pushes along its own flow: t-1 forward, t+1 backward
    sources = ((0, fwd_t[:tl]), (2, bwd_t[2:]))

    def crop(a):
        return a[:, :, hw:a.shape[2] - hw] if hw else a

    def round_(state):
        c, c2, m = (halo_exchange_x(mesh, a, hw, f) for a, f in
                    zip(state, (math.inf, math.inf, META_MAX)))
        best = spatial_sweeps(c, c2, m, field_x, seeded_x, flood_x, IN_PLANE, 1)
        cost, cost2, meta_p = pushed(c, c2, m, field_x, seeded_x)
        cost_t = halo_exchange_t(mesh, cost, 1, math.inf)
        cost2_t = halo_exchange_t(mesh, cost2, 1, math.inf)
        meta_t = halo_exchange_t(mesh, meta_p, 1, META_MAX)
        for start, flow in sources:
            cq = _banded_scatter_min(cost_t[start:start + tl], cost2_t[start:start + tl],
                                     meta_t[start:start + tl], flow[..., 1], flow[..., 0],
                                     radius)
            best = consider(best, *cq, field_x)
        best = tuple(torch.where(flood_x, b, a).contiguous() for b, a in zip(best, (c, c2, m)))
        st = spatial_sweeps(*best, field_x, seeded_x, flood_x, IN_PLANE, spatial_per_temporal)
        return tuple(crop(a) for a in st)

    quiet = rounds = 0
    while quiet < grace and rounds < max_rounds:
        new = round_(state)
        if label_only:
            changed = torch.any((new[2] & LABEL_MASK) != (state[2] & LABEL_MASK))
        else:
            changed = torch.stack([torch.any(a != b) for a, b in zip(new, state)]).any()
        quiet = 0 if mesh.any(changed) else quiet + 1
        state = new
        rounds += 1
    return state, rounds


def _seed_state(markers):
    seeded = markers != 0
    claim = torch.where(seeded, -math.inf, math.inf).to(torch.float32)
    meta = torch.where(seeded, markers.to(torch.int32) + 2, META_MAX).to(torch.int32)
    return claim, claim.clone(), meta


def _owned_cells(x, wl, w):
    """The global coarse columns [j0, j1) that the tile at x index ``x``
    pools: those whose first fine column lies in it (within the global
    grid's ``w // _FACTOR`` columns)."""
    x0 = x * wl
    f = _FACTOR
    return -(-x0 // f), min(-(-(x0 + wl) // f), w // f)


def _coarse_start(mesh, field, markers, mask, fwd_int, bwd_int, state, max_rounds, grace,
                  label_only):
    """The single-device flood's V-cycle on the mesh: the whole volume's
    4x max-pooled problem (``ops.watershed._ws_coarse_prep``; each rank
    pools the coarse columns that start in its tile, a coarse cell across
    a tile edge read through a 3-column halo), gathered to rank 0 and
    flooded there by the single-device flood (its scans and Jacobi rounds, capped at ``max_rounds //
    2 + 8``, in the band the single device picks, stopping as the fine
    flood does: ``grace``, ``label_only``) and broadcast; each rank
    then adopts it on its tile deep inside label-uniform coarse territory
    (``ops.watershed._ws_adopt``).  Returns the tile's new state."""
    from tobac_flow_tpu_torch.ops import watershed as ws

    f = _FACTOR
    tl, h, wl = field.shape
    w = wl * mesh.n_x
    if h < 8 * f or w < 8 * f:
        return state
    # the single device's band radius covers every in-mask rounded displacement
    mag = torch.maximum(fwd_int.abs(), bwd_int.abs()).clamp(max=127)[mask]
    counts = mesh.sum(torch.bincount(mag.reshape(-1).long(), minlength=128))
    exceed = counts.flip(0).cumsum(0).flip(0)[1:ws._BAND_CAP + 1].cpu().numpy()
    cradius = max(ws._band_radius_from_stats(exceed) // f, 1)

    j0, j1 = _owned_cells(mesh.x, wl, w)
    lo, hi = f - 1 + f * j0 - mesh.x * wl, f - 1 + f * j1 - mesh.x * wl

    def part(a, axis=-1):
        a = halo_exchange_x(mesh, a, f - 1, 0, axis)
        return a[:, :, lo:hi]

    pieces = ws._ws_coarse_prep(part(field), part(markers), part(mask), part(fwd_int, -2),
                                part(bwd_int, -2), f)[:5]
    widths = [b - a for a, b in (_owned_cells(x, wl, w) for x in range(mesh.n_x))]
    cf, cmask, cmark, cfwd, cbwd = (mesh.gather(a, widths) for a in pieces)
    shape = (tl * mesh.n_t, pieces[0].shape[1], sum(widths))
    if mesh.rank == 0:
        taps = ws._structure_taps_3d(ws.connectivity_structure(1))
        cstate = ws._flood_state(cf, cmark, cmask, cfwd, cbwd, ws._seed_state(cmark), taps,
                                 cradius, max_iters=max_rounds // 2 + 8,
                                 run_scans=shape[0] >= 4, multigrid=False, grace=grace,
                                 label_only=label_only, barrier_first=False)
    else:
        cstate = (torch.empty(shape, device=field.device), None,
                  torch.empty(shape, dtype=torch.int32, device=field.device))
    cclaim, cmeta = mesh.broadcast(cstate[0]), mesh.broadcast(cstate[2])

    # ops.watershed._ws_adopt on this rank's tile of the whole volume
    hc, wc = shape[1:]
    lab_valid = cmeta != META_MAX
    clabel = (cmeta & LABEL_MASK) - 2
    rc = -(-ws._BAND_CAP // f) + 1
    big = 1 << 30
    wmax = ws._sep_window(torch.where(lab_valid, clabel, big), -big, torch.maximum, rc)
    wmin = ws._sep_window(torch.where(lab_valid, clabel, -big), big, torch.minimum, rc)
    deep = lab_valid & (wmax == clabel) & (wmin == clabel)
    frames = slice(mesh.t * tl, (mesh.t + 1) * tl)
    ys = torch.arange(h, device=field.device)
    xs = torch.arange(wl, device=field.device) + mesh.x * wl
    cy = ys.clamp(max=hc * f - 1) // f
    cx = xs.clamp(max=wc * f - 1) // f

    def up(a):
        return a[frames].index_select(1, cy).index_select(2, cx)

    in_cov = (ys < hc * f).view(1, h, 1) & (xs < wc * f).view(1, 1, wl)
    up_meta = up(cmeta)
    adopt = mask & (markers == 0) & (up_meta != META_MAX) & up(deep) & in_cov
    adopted = max_nan(up(cclaim), field)
    hops = torch.clamp((up_meta >> 23) * f, max=255)
    up_meta = (hops << 23) | (up_meta & LABEL_MASK)
    return (torch.where(adopt, adopted, state[0]), torch.where(adopt, adopted, state[1]),
            torch.where(adopt, up_meta, state[2]))


def _single_device_start(mesh, state, field, field_x, markers, mask, fwd_int, bwd_int,
                         common, radius, max_rounds, spatial_per_temporal, stats):
    """The single-device flood's start on the mesh: with -1 barrier and
    positive markers both present, the barrier alone first, to the whole
    state's convergence (its claims keep relaxing after its labels settle,
    which a label-only stop would freeze); then, on frames of at least
    32 x 32, the coarse V-cycle (``_coarse_start``).  Returns the state the
    label-only rounds start from."""
    if mesh.any(torch.any(markers < 0)) and mesh.any(torch.any(markers > 0)):
        neg = torch.where(markers < 0, markers, 0)
        bar_mask = mask & (markers <= 0)
        state0 = _coarse_start(mesh, field, neg, bar_mask, fwd_int, bwd_int, _seed_state(neg),
                               max_rounds, 1, False)
        state0, rounds0 = _flood(mesh, field_x, neg, bar_mask, *common, state0, radius,
                                 max_rounds, spatial_per_temporal, 1, False)
        better = lex_better(*state0, *state)
        state = tuple(torch.where(better, a, b) for a, b in zip(state0, state))
        if stats is not None:
            stats["barrier_rounds"] = rounds0
    return _coarse_start(mesh, field, markers, mask, fwd_int, bwd_int, state, max_rounds,
                         _GRACE, True)


def sharded_watershed_local(mesh, field, markers, fwd_int, bwd_int, mask=None, radius=21,
                            max_rounds=64, spatial_per_temporal=8, stats=None):
    """Per rank: the minimax watershed of local (T_l, H, W_l) tiles.

    field: topography (NaN and +inf flood last); markers: int seed labels
    (0 = none), the same label meaning the same object on every tile;
    fwd_int, bwd_int: rounded (T_l, H, W_l, 2) flows; mask: optional bool
    tile whose False pixels are never flooded.  Returns the label tile.

    The rounds follow the single-device flood's schedule
    (``_single_device_start``, then label-only rounds), so the labels are
    ``ops.watershed.watershed``'s.  ``stats``, a dict, gets ``rounds``
    (and ``barrier_rounds``)."""
    bad = (markers < -1) | (markers > _LABEL_MAX)
    if mesh.any(torch.any(bad)):
        raise ValueError(f"watershed markers must lie in [-1, {_LABEL_MAX}] (the packed "
                         "state's label bits)")
    if mask is None:
        mask = torch.ones_like(markers, dtype=torch.bool)
    field = torch.where(torch.isnan(field), math.inf, field.to(torch.float32))
    hw = int(radius)
    field_x = halo_exchange_x(mesh, field, hw, math.inf).contiguous()
    fwd_t = halo_exchange_t(mesh, halo_exchange_x(mesh, fwd_int, hw, 0, axis=-2), 1, 0)
    bwd_t = halo_exchange_t(mesh, halo_exchange_x(mesh, bwd_int, hw, 0, axis=-2), 1, 0)
    common = (fwd_t, bwd_t)
    state = _single_device_start(mesh, _seed_state(markers), field, field_x, markers, mask,
                                 fwd_int, bwd_int, common, radius, max_rounds,
                                 spatial_per_temporal, stats)
    state, rounds = _flood(mesh, field_x, markers, mask, *common, state, radius, max_rounds,
                           spatial_per_temporal, _GRACE, True)
    if stats is not None:
        stats["rounds"] = rounds
    meta = state[2]
    label = torch.where(meta == META_MAX, 0, (meta & LABEL_MASK) - 2)
    return torch.where(markers != 0, markers.to(label.dtype), label)


def global_marker_labels(mesh, markers_bool, w_global=None):
    """Globally unique positive labels of a bool marker tile: each marker
    pixel's global pixel id (1-based), the same under any mesh."""
    tl, h, wl = markers_bool.shape
    w_global = wl * mesh.n_x if w_global is None else w_global
    return torch.where(markers_bool, global_pixel_ids(mesh, markers_bool.shape, w_global), 0)


def sharded_watershed(mesh, field, markers, forward_flow, backward_flow, mask=None, radius=21,
                      max_rounds=64, spatial_per_temporal=8, stats=None):
    """Seeded flow-aware watershed of a (T, H, W) field over the mesh,
    called on every rank with the global arrays: ``markers`` int seed
    labels, flows (T, H, W, 2) (x, y channels), ``mask`` optional bool
    (False pixels are never flooded).  Returns the global labels on rank
    0's device (None on the other ranks)."""
    f = mesh.tile(field, torch.float32)
    mk = mesh.tile(markers, torch.int32)
    m = None if mask is None else mesh.tile(mask, torch.bool)
    fwd = torch.round(mesh.tile(forward_flow, torch.float32)).to(torch.int32)
    bwd = torch.round(mesh.tile(backward_flow, torch.float32)).to(torch.int32)
    labels = sharded_watershed_local(mesh, f, mk, fwd, bwd, m, radius, max_rounds,
                                     spatial_per_temporal, stats)
    return mesh.gather(labels)
