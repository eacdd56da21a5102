"""Flow-aware multi-marker watershed over a whole (T, H, W) volume
(counterpart of ``tobac_flow_tpu/ops/watershed.py``).

The reference's serial priority flood is solved as a minimax-path fixed
point by data-parallel relaxation of a packed state (claim f32, claim2 f32,
meta i32 = ``min(hops, 255) << 23 | label + 2``); see ``ops/ws_sweeps.py``
for one sweep's arithmetic and the reference module for why each term is
there.  Labels depend on where the flood stops, so the schedule is the
reference's exactly: barrier-first pre-flood for mixed -1/positive markers
(grace 1, full-state convergence), a 4x max-pooled coarse flood adopted
deep inside label-uniform territory (when h, w >= 32), forward/backward
temporal scan rounds (cap 12), then Jacobi rounds in chunks of 16 with
label-only convergence after ``grace`` quiet rounds.

Temporal taps are pushed along the source pixel's rounded flow with the
reference's two-lane banded scatter-min, so the same pushes survive
collisions.  The in-plane sweeps go through ``spatial_sweeps`` (the CUDA
kernel on the GPU).

A volume whose flood would not fit in the device memory left
(``budget_bytes``; on CUDA by default the free memory less a margin) floods
in overlapping time chunks, as the reference's ``_watershed_time_chunked``
does: block Gauss-Seidel over the chunks, each with one frozen halo frame
per side holding its neighbour's converged state.  The inputs stay on the
device and each chunk is a slice of them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tobac_flow_tpu_torch.device import memory_budget, resolve_device
from tobac_flow_tpu_torch.ops.warp import shift_axis
from tobac_flow_tpu_torch.ops.ws_sweeps import (
    LABEL_MASK,
    META_MAX,
    consider,
    lex_better,
    max_nan,
    pushed,
    spatial_sweeps,
)

__all__ = ["watershed", "connectivity_structure"]

_BAND_CAP = 21  # largest temporal band radius (flows are clipped to ±20 px)
_CHUNK_ITERS = 16  # Jacobi rounds per convergence chunk (the grace count restarts)
_GRACE = 2  # quiet rounds that end the label-only Jacobi loop
_SCAN_CAP = 12  # temporal scan rounds, coarse and fine
_JACOBI_SWEEPS = 8  # in-plane kernel sweeps after each full sweep of a Jacobi round
_SCAN_SWEEPS = 4  # in-plane kernel sweeps of each frame step of a scan round

# Device bytes per pixel that a whole-volume flood allocates beyond its
# inputs at its peak, for plain and for mixed -1/positive markers (the
# barrier-first pre-flood keeps a second state), rounded up: the most of
# (max_memory_allocated - memory_allocated before) / pixels that
# tools/torch_flood_memory.py measured on the fused path's inputs at
# 6, 12 and 24 x 1500 x 2500 on an H100 80GB HBM3 (700 W): 306.04 and
# 337.04 (306.00 and 325.00 at 24 x 1024 x 1536).
FLOOD_BYTES_PER_PX = {False: 307, True: 338}
# the time-chunked flood's own whole-volume buffers: the labels (int32)
_CHUNKED_BYTES_PER_PX = 4
_MIN_CHUNK_FRAMES = 4  # the reference's smallest chunk
_MIN_CHUNKED_DEPTH = 12  # shorter volumes always flood whole, as in the reference
_MAX_PASSES = 8  # chunk passes, alternating forward and backward order


def connectivity_structure(connectivity):
    """(3, 3, 3) boolean neighbourhood of an int connectivity (1..3), or an
    explicit (3, 3, 3) structuring array passed through."""
    if isinstance(connectivity, (np.ndarray, torch.Tensor)):
        s = np.asarray(connectivity).astype(bool)
        if s.shape != (3, 3, 3):
            raise ValueError("connectivity structure must have shape (3,3,3)")
        return s
    grid = np.abs(np.indices((3, 3, 3)) - 1).sum(axis=0)
    return grid <= int(connectivity)


def _structure_taps_3d(structure):
    """(dt, dy, dx) neighbour offsets in raster order, excluding the centre."""
    return tuple(
        (int(t) - 1, int(r) - 1, int(c) - 1)
        for t, r, c in zip(*np.nonzero(structure))
        if not (t == 1 and r == 1 and c == 1)
    )


def _where4(cond, a, b):
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def _present_shifts(disps, radius):
    """For each (displacement, live) pair, the shifts in -radius..radius
    that some live pixel takes, ascending; one transfer to the host."""
    n = 2 * radius + 1
    counts = [
        torch.bincount(torch.where(live & (d.abs() <= radius), d + radius, n).reshape(-1),
                       minlength=n + 1)[:n]
        for d, live in disps
    ]
    present = torch.stack(counts).cpu().numpy()
    return [[int(s) - radius for s in np.flatnonzero(row)] for row in present]


def _scatter_min_dense(cost, cost2, meta, dy, dx, radius, y_shifts):
    """The scatter-min over whole volumes: each taken y shift's pushes
    masked, shifted and folded into both lanes at every cell, then each
    lane's taken x shifts landed likewise."""
    dev = cost.device
    inf = torch.tensor(math.inf, device=dev)
    big_m = torch.tensor(META_MAX, dtype=torch.int32, device=dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    lane0 = (
        torch.full_like(cost, math.inf), torch.full_like(cost, math.inf),
        torch.full_like(meta, META_MAX), torch.zeros_like(dx),
    )
    lane_a, lane_b = lane0, lane0
    fills = (math.inf, math.inf, META_MAX, 0)
    for s in y_shifts:
        m = dy == s
        cand = (
            torch.where(m, cost, inf), torch.where(m, cost2, inf),
            torch.where(m, meta, big_m), torch.where(m, dx, zero_i),
        )
        cc, cc2, cm, cdx = (shift_axis(a, s, -2, f) for a, f in zip(cand, fills))
        ac, ac2, am, adx = lane_a
        bc, bc2, bm, bdx = lane_b
        cand_first = lex_better(cc, cc2, cm, ac, ac2, am)
        top = _where4(cand_first, (cc, cc2, cm, cdx), lane_a)
        # the displaced runner-up: whichever of {candidate, lane A} lost
        oc, oc2, om, odx = _where4(cand_first, lane_a, (cc, cc2, cm, cdx))
        o_ok = (om != META_MAX) & (odx != top[3])
        b_ok = (bm != META_MAX) & (bdx != top[3])
        pick_o = o_ok & (~b_ok | lex_better(oc, oc2, om, bc, bc2, bm))
        b_kept = _where4(b_ok, lane_b, (inf, inf, big_m, zero_i))
        lane_b = _where4(pick_o, (oc, oc2, om, odx), b_kept)
        lane_a = top

    out = lane0[:3]
    lanes = (lane_a, lane_b)
    x_shifts = _present_shifts([(lane[3], lane[2] != META_MAX) for lane in lanes], radius)
    for s in range(-radius, radius + 1):
        for (lc, lc2, lm, ldx), taken in zip(lanes, x_shifts):
            if s not in taken:
                continue
            m = (ldx == s) & (lm != META_MAX)
            cc = shift_axis(torch.where(m, lc, inf), s, -1, math.inf)
            cc2 = shift_axis(torch.where(m, lc2, inf), s, -1, math.inf)
            cm = shift_axis(torch.where(m, lm, big_m), s, -1, META_MAX)
            better = lex_better(cc, cc2, cm, *out)
            out = _where4(better, (cc, cc2, cm), out)
    return out


def _shift_keys(disp, live, radius):
    """Each pixel's displacement as a bin 0..2R (2R + 1 past the band), and
    the shifts that some ``live`` pixel takes, ascending (one transfer to
    the host)."""
    n = 2 * radius + 1
    key = torch.where(disp.abs() <= radius, disp + radius, n).reshape(-1)
    counts = torch.bincount(torch.where(live.reshape(-1), key, n), minlength=n + 1)[:n]
    return key, [int(k) - radius for k in np.flatnonzero(counts.cpu().numpy())]


def _waves(tgt, order_key, n_keys):
    """The entries grouped into waves: wave k holds each target's k-th
    entry in ``order_key`` order (so a wave never holds a target twice),
    by two sorts and one transfer to the host."""
    order = torch.argsort(tgt * n_keys + order_key)
    t_sorted = tgt[order]
    pos = torch.arange(t_sorted.numel(), device=tgt.device)
    first = torch.ones_like(t_sorted, dtype=torch.bool)
    first[1:] = t_sorted[1:] != t_sorted[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    counts = torch.bincount(rank).cpu().numpy() if rank.numel() else np.zeros(0, np.int64)
    order = order[torch.argsort(rank, stable=True)]
    ends = np.cumsum(counts)
    return [order[e - c:e] for c, e in zip(counts, ends)]


def _lex_rows(a, b):
    """``lex_better`` of (n, 3+) int32 rows holding (claim, claim2) as
    float32 bits and meta."""
    f32 = torch.float32
    return lex_better(a[:, 0].view(f32), a[:, 1].view(f32), a[:, 2],
                      b[:, 0].view(f32), b[:, 1].view(f32), b[:, 2])


def _scatter_min_waves(cost, cost2, meta, dy, dx, radius, keyed):
    """The scatter-min folding each cell's pushes in their order, wave by
    wave: wave k carries every cell's k-th push (by shift in the y pass;
    by shift, lane A first, in the x pass), so each wave touches only the
    cells it reaches and each cell once.  A cell that no push of a shift
    reaches keeps its lanes (an empty push never ranks first, and lane B
    never holds lane A's x displacement), so the result is the dense
    fold's, bit for bit.  A lane is one (cells, 4) int32 tensor of
    (claim, claim2) as float32 bits, meta and x displacement, so that a
    push's fold gathers and writes a row at once."""
    shape = cost.shape
    h, w = shape[-2], shape[-1]
    n_keys = 2 * radius + 1
    dev = cost.device
    i32 = torch.int32
    src = torch.stack([cost.reshape(-1).view(i32), cost2.reshape(-1).view(i32),
                       meta.reshape(-1), dx.reshape(-1)], 1)
    inf_bits = int(torch.tensor(math.inf).view(i32))
    empty = torch.tensor([inf_bits, inf_bits, META_MAX, 0], dtype=i32, device=dev)
    key, taken = keyed
    taken_key = torch.zeros(n_keys + 1, dtype=torch.bool, device=dev)
    taken_key[torch.tensor([t + radius for t in taken], dtype=torch.long, device=dev)] = True
    shift = key.long() - radius
    idx = torch.arange(key.numel(), device=dev)
    row = (idx // w) % h + shift
    (ok,) = torch.nonzero(taken_key[key] & (row >= 0) & (row < h), as_tuple=True)
    idx, s = idx[ok], shift[ok]
    tgt = idx + s * w
    lane_a = empty.repeat(cost.numel(), 1)
    lane_b = lane_a.clone()
    for wave in _waves(tgt, s + radius, n_keys):
        t = tgt[wave]
        cand = src.index_select(0, idx[wave])
        la, lb = lane_a.index_select(0, t), lane_b.index_select(0, t)
        cand_first = _lex_rows(cand, la)[:, None]
        top = torch.where(cand_first, cand, la)
        # the displaced runner-up: whichever of {candidate, lane A} lost
        oth = torch.where(cand_first, la, cand)
        o_ok = (oth[:, 2] != META_MAX) & (oth[:, 3] != top[:, 3])
        b_ok = (lb[:, 2] != META_MAX) & (lb[:, 3] != top[:, 3])
        pick_o = o_ok & (~b_ok | _lex_rows(oth, lb))
        lane_b.index_copy_(0, t, torch.where(pick_o[:, None], oth,
                                             torch.where(b_ok[:, None], lb, empty)))
        lane_a.index_copy_(0, t, top)

    out = empty[:3].repeat(cost.numel(), 1)
    both = torch.cat([lane_a, lane_b])  # lane A's rows first: first in a shift's order
    cell = torch.arange(both.shape[0], device=dev) % cost.numel()
    col = cell % w + both[:, 3]
    (ok,) = torch.nonzero((both[:, 2] != META_MAX) & (both[:, 3].abs() <= radius)
                          & (col >= 0) & (col < w), as_tuple=True)
    tgt = cell[ok] + both[ok, 3]
    for wave in _waves(tgt, both[ok, 3].long() + radius, n_keys):
        t = tgt[wave]
        cand = both.index_select(0, ok[wave])[:, :3]
        cur = out.index_select(0, t)
        out.index_copy_(0, t, torch.where(_lex_rows(cand, cur)[:, None], cand, cur))
    return (out[:, 0].contiguous().view(torch.float32).view(shape),
            out[:, 1].contiguous().view(torch.float32).view(shape),
            out[:, 2].contiguous().view(shape))


def _by_shift(key, taken, radius):
    """The flat indices of the pixels of each taken shift (a dict shift ->
    indices, ``key`` and ``taken`` from ``_shift_keys``), grouped by one
    stable sort and one transfer to the host."""
    counts = torch.bincount(key, minlength=2 * radius + 2).cpu().numpy()
    order = torch.argsort(key, stable=True)
    ends = np.cumsum(counts)
    return {t: order[ends[t + radius] - counts[t + radius]:ends[t + radius]] for t in taken}


def _scatter_min_shifts(cost, cost2, meta, dy, dx, radius, keyed):
    """The scatter-min visiting, shift by shift, only the cells that a push
    reaches (see ``_scatter_min_waves`` for why that is the dense fold, bit
    for bit).  A push that leaves the frame lands in a spare row past the
    volume, which is never read back.  Lanes as in ``_scatter_min_waves``."""
    shape = cost.shape
    h, w = shape[-2], shape[-1]
    n = cost.numel()  # the spare row
    dev = cost.device
    i32 = torch.int32
    src = torch.stack([cost.reshape(-1).view(i32), cost2.reshape(-1).view(i32),
                       meta.reshape(-1), dx.reshape(-1)], 1)
    inf_bits = int(torch.tensor(math.inf).view(i32))
    empty = torch.tensor([inf_bits, inf_bits, META_MAX, 0], dtype=i32, device=dev)
    spare = torch.tensor(n, dtype=torch.int64, device=dev)
    lane_a = empty.repeat(n + 1, 1)
    lane_b = lane_a.clone()
    for s, idx in _by_shift(keyed[0], keyed[1], radius).items():
        row = (idx // w) % h + s
        tgt = torch.where((row >= 0) & (row < h), idx + s * w, spare)
        cand = src.index_select(0, idx)
        la, lb = lane_a.index_select(0, tgt), lane_b.index_select(0, tgt)
        cand_first = _lex_rows(cand, la)[:, None]
        top = torch.where(cand_first, cand, la)
        # the displaced runner-up: whichever of {candidate, lane A} lost
        oth = torch.where(cand_first, la, cand)
        o_ok = (oth[:, 2] != META_MAX) & (oth[:, 3] != top[:, 3])
        b_ok = (lb[:, 2] != META_MAX) & (lb[:, 3] != top[:, 3])
        pick_o = o_ok & (~b_ok | _lex_rows(oth, lb))
        # the spare row may take several writes; it is never read back
        lane_b.index_copy_(0, tgt, torch.where(pick_o[:, None], oth,
                                               torch.where(b_ok[:, None], lb, empty)))
        lane_a.index_copy_(0, tgt, top)

    out = empty[:3].repeat(n + 1, 1)
    both = (lane_a[:n], lane_b[:n])
    groups = [_by_shift(*_shift_keys(lane[:, 3], lane[:, 2] != META_MAX, radius), radius)
              for lane in both]
    for s in range(-radius, radius + 1):
        for lane, group in zip(both, groups):
            if s not in group:
                continue
            idx = group[s]
            col = idx % w + s
            cand = lane.index_select(0, idx)[:, :3]
            tgt = torch.where((cand[:, 2] != META_MAX) & (col >= 0) & (col < w), idx + s, spare)
            cur = out.index_select(0, tgt)
            better = _lex_rows(cand, cur) & (tgt != n)
            out.index_copy_(0, tgt, torch.where(better[:, None], cand, cur))
    out = out[:n]
    return (out[:, 0].contiguous().view(torch.float32).view(shape),
            out[:, 1].contiguous().view(torch.float32).view(shape),
            out[:, 2].contiguous().view(shape))


# The forms' costs on an H100 80GB HBM3 (700 W), fitted to the times of
# tools/torch_scatter_min_forms.py on a 1500x2500 frame and a 6-frame
# volume: dense about 0.5 ms a taken y shift and million cells; shift by
# shift about 3.5 ms a million cells and 2.5 ms a taken shift (its
# launches); in waves about 9 ms a million cells (its sorts) and 4 ms.
# So a frame with many taken shifts (noise flows) goes in waves, a volume
# with many shift by shift, and few shifts dense.
_DENSE_MS_PER_SHIFT_MPX = 0.5
_SHIFTS_MS_PER_MPX, _SHIFTS_MS_PER_SHIFT = 3.5, 2.5
_WAVES_MS_PER_MPX, _WAVES_MS = 9.0, 4.0


def _scatter_min_costs(n_shifts, cells):
    """The three forms' estimated milliseconds for ``n_shifts`` taken y
    shifts over ``cells`` cells: (dense, shift by shift, waves)."""
    mpx = cells / 1e6
    return (n_shifts * mpx * _DENSE_MS_PER_SHIFT_MPX,
            mpx * _SHIFTS_MS_PER_MPX + n_shifts * _SHIFTS_MS_PER_SHIFT,
            mpx * _WAVES_MS_PER_MPX + _WAVES_MS)


def _banded_scatter_min(cost, cost2, meta, disp_y, disp_x, radius):
    """Each source p pushes (cost, cost2, meta) to p + (disp_y, disp_x)(p);
    colliding pushes keep the lexicographic minimum.  A y pass over the
    shifts -R..R (in that order) keeps two lanes per intermediate cell: the
    best push, and the best push whose x displacement differs from it; an x
    pass then lands both lanes.  Pushes outside the band are dropped, never
    clipped.  A shift that no claimed source (meta below META_MAX) takes
    leaves both lanes as they are, and a lane's x shift that none of its
    claimed entries takes leaves the output as it is, so both passes visit
    only the shifts taken.  Three forms give the same bits; the cheapest
    for the volume's size and taken shifts runs (see the costs above)."""
    dy = disp_y.to(torch.int32)
    dx = disp_x.to(torch.int32)
    keyed = _shift_keys(dy, meta != META_MAX, radius)
    costs = _scatter_min_costs(len(keyed[1]), cost.numel())
    form = costs.index(min(costs))
    if form == 0:
        return _scatter_min_dense(cost, cost2, meta, dy, dx, radius, keyed[1])
    return (_scatter_min_shifts, _scatter_min_waves)[form - 1](cost, cost2, meta, dy, dx,
                                                               radius, keyed)


def _shift_t(a, dt, fill):
    """``a[t + dt]`` with constant fill at the sequence ends (dt = ±1)."""
    fill_frame = torch.full_like(a[:1], fill)
    if dt == 1:
        return torch.cat([a[1:], fill_frame])
    return torch.cat([fill_frame, a[:-1]])


def _split_taps(taps):
    in_plane = tuple((dy, dx) for dt, dy, dx in taps if dt == 0)
    temporal = tuple((dt, dy, dx) for dt, dy, dx in taps if dt != 0)
    return in_plane, temporal


def _jacobi_round(field, seeded, floodable, fwd_int, bwd_int, state, taps, radius):
    """One round of ``_watershed_sweeps``: a full sweep (in-plane taps,
    then the flow-displaced temporal pushes), then ``_JACOBI_SWEEPS``
    in-plane sweeps through the kernel."""
    in_plane, temporal = _split_taps(taps)
    claim, claim2, meta = state
    # the in-plane taps of the full sweep: one kernel sweep keeps the best of
    # (state, in-plane candidates) at floodable pixels; the temporal
    # candidates then fold into that running best before the same select
    best = spatial_sweeps(claim, claim2, meta, field, seeded, floodable, in_plane, 1)
    if temporal:
        cost, cost2, meta_p = pushed(claim, claim2, meta, field, seeded)
        for dt, dy, dx in temporal:
            src_flow = fwd_int if dt == 1 else bwd_int
            fs = _shift_t(src_flow, -dt, 0)
            cq = _banded_scatter_min(
                _shift_t(cost, -dt, math.inf), _shift_t(cost2, -dt, math.inf),
                _shift_t(meta_p, -dt, META_MAX), fs[..., 1] + dy, fs[..., 0] + dx,
                radius,
            )
            best = consider(best, *cq, field)
        best = (
            torch.where(floodable, best[0], claim),
            torch.where(floodable, best[1], claim2),
            torch.where(floodable, best[2], meta),
        )
    return spatial_sweeps(*best, field, seeded, floodable, in_plane, _JACOBI_SWEEPS)


def _changed(new, old, label_only):
    if label_only:
        return bool(torch.any((new[2] & LABEL_MASK) != (old[2] & LABEL_MASK)))
    return bool(
        torch.any(new[2] != old[2]) or torch.any(new[0] != old[0])
        or torch.any(new[1] != old[1])
    )


def _watershed_sweeps(field, markers, mask, fwd_int, bwd_int, state, taps,
                      radius, n_iters, grace, label_only):
    """Up to ``n_iters`` Jacobi rounds, stopping after ``grace`` consecutive
    quiet rounds; returns (state, rounds_used)."""
    seeded = markers != 0
    floodable = mask & ~seeded
    quiet = 0
    it = 0
    while quiet < grace and it < n_iters:
        new = _jacobi_round(field, seeded, floodable, fwd_int, bwd_int, state, taps, radius)
        quiet = 0 if _changed(new, state, label_only) else quiet + 1
        state = new
        it += 1
    return state, it


def _watershed_scan_round(field, markers, mask, fwd_int, bwd_int, state, taps,
                          radius, label_only):
    """One temporal Gauss–Seidel round: a forward then a backward pass over
    the frames, each frame taking the already-updated neighbour's pushes
    and then ``_SCAN_SWEEPS`` in-plane sweeps.  Returns (state, changed)."""
    seeded = markers != 0
    floodable = mask & ~seeded
    in_plane, temporal = _split_taps(taps)

    def direction(state, dt_dir, flow, reverse):
        d_taps = tuple((dy, dx) for dt, dy, dx in temporal if dt == dt_dir)
        outs = [torch.empty_like(a) for a in state]
        carry = None
        order = range(field.shape[0] - 1, -1, -1) if reverse else range(field.shape[0])
        for i in order:
            f, sd, fl = field[i], seeded[i], floodable[i]
            best = (state[0][i], state[1][i], state[2][i])
            c, c2, m = best
            for dy, dx in d_taps:
                if carry is None:  # nothing pushes into the first frame
                    continue
                pc, pc2, pm, pflow = carry
                cq = _banded_scatter_min(
                    pc, pc2, pm, pflow[..., 1] + dy, pflow[..., 0] + dx, radius
                )
                best = consider(best, *cq, f)
            c = torch.where(fl, best[0], c)
            c2 = torch.where(fl, best[1], c2)
            m = torch.where(fl, best[2], m)
            c, c2, m = spatial_sweeps(
                c[None], c2[None], m[None], f[None], sd[None], fl[None],
                in_plane, _SCAN_SWEEPS,
            )
            c, c2, m = c[0], c2[0], m[0]
            carry = (*pushed(c, c2, m, f, sd), flow[i])
            outs[0][i], outs[1][i], outs[2][i] = c, c2, m
        return tuple(outs)

    old = state
    # forward pass pushes t-1 -> t along each frame's own forward flow;
    # backward pass pushes t+1 -> t along the backward flow
    state = direction(state, 1, fwd_int, reverse=False)
    state = direction(state, -1, bwd_int, reverse=True)
    return state, _changed(state, old, label_only)


def _coarsen(a, f, reduce):
    """Factor-f pooling of the spatial axes of a (T, H, W) tensor."""
    t, h, w = a.shape
    hc, wc = h // f, w // f
    v = a[:, : hc * f, : wc * f].reshape(t, hc, f, wc, f)
    if reduce == "max":
        return v.amax(dim=(2, 4))
    if reduce == "min":
        return v.amin(dim=(2, 4))
    return v.to(torch.float32).mean(dim=(2, 4))


def _upsample_nearest(a, f, h, w):
    up = a.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
    iy = torch.arange(h, device=a.device).clamp(max=up.shape[1] - 1)
    ix = torch.arange(w, device=a.device).clamp(max=up.shape[2] - 1)
    return up.index_select(1, iy).index_select(2, ix)


def _seed_state(markers):
    seeded = markers != 0
    claim = torch.where(seeded, -math.inf, math.inf).to(torch.float32)
    meta = torch.where(seeded, markers + 2, META_MAX).to(torch.int32)
    return claim, claim.clone(), meta


def _round_flow(flow):
    """Flows rounded half to even and clipped to ±127."""
    return torch.clamp(torch.round(flow), -127, 127).to(torch.int32)


def _ws_prep(field, markers, mask, fwd, bwd):
    """NaN fields become +inf barriers; flows are rounded half to even and
    clipped to ±127; the seeded state is packed; and the band exceedance
    curve ``exceed[k]`` counts in-mask displacement components with
    ``|disp| > k``, k = 0..20."""
    field = torch.where(torch.isnan(field), math.inf, field)
    fwd_int = _round_flow(fwd)
    bwd_int = _round_flow(bwd)
    mag = torch.maximum(fwd_int.abs(), bwd_int.abs())[mask]
    counts = torch.bincount(mag.reshape(-1), minlength=128)
    exceed = counts.flip(0).cumsum(0).flip(0)[1:_BAND_CAP + 1]
    return field, fwd_int, bwd_int, _seed_state(markers), exceed.cpu().numpy()


def _band_radius_from_stats(exceed):
    """Full coverage: the smallest k with no in-mask displacement beyond it
    (21 when even 20 does not cover), since out-of-band pushes are dropped."""
    covered = np.asarray(exceed) == 0
    return int(np.argmax(covered)) if covered.any() else _BAND_CAP


def _ws_coarse_prep(field, markers, mask, fwd_int, bwd_int, factor):
    """Coarse-grid (max-pooled) inputs of the V-cycle."""
    cf = _coarsen(field, factor, "max")
    cmask = _coarsen(mask.to(torch.int32), factor, "max").to(torch.bool)
    cmark = _coarsen(markers, factor, "max")
    neg = _coarsen(markers, factor, "min")
    cmark = torch.where((cmark == 0) & (neg < 0), neg, cmark)

    def cflow(flow):
        return torch.stack(
            [(_coarsen(flow[..., c], factor, "mean") / factor).to(torch.int32)
             for c in (0, 1)], dim=-1,
        )

    return cf, cmask, cmark, cflow(fwd_int), cflow(bwd_int), _seed_state(cmark)


def _sep_window(a, init, op, rc):
    """Separable (3, 2rc+1, 2rc+1) moving max/min, padded with ``init``."""
    for axis, r in ((0, 1), (1, rc), (2, rc)):
        out = a
        for s in range(-r, r + 1):
            if s:
                out = op(out, shift_axis(a, s, axis, init))
        a = out
    return a


def _ws_adopt(cstate, field, markers, mask, state, factor):
    """Adopt the coarse flood as the fine initial state only deep inside
    label-uniform coarse territory (the whole (3, 2rc+1, 2rc+1) coarse
    neighbourhood carries one label), with hops rescaled to fine units."""
    h, w = field.shape[1:]
    seeded = markers != 0
    up_claim = _upsample_nearest(cstate[0], factor, h, w)
    up_meta = _upsample_nearest(cstate[2], factor, h, w)
    yi = torch.arange(h, device=field.device).view(1, h, 1)
    xi = torch.arange(w, device=field.device).view(1, 1, w)
    in_cov = (yi < (h // factor) * factor) & (xi < (w // factor) * factor)
    lab_valid = cstate[2] != META_MAX
    clabel = (cstate[2] & LABEL_MASK) - 2
    rc = -(-21 // int(factor)) + 1  # flow band in coarse cells + fuzz margin
    big = 1 << 30
    wmax = _sep_window(torch.where(lab_valid, clabel, big), -big, torch.maximum, rc)
    wmin = _sep_window(torch.where(lab_valid, clabel, -big), big, torch.minimum, rc)
    deep_same = lab_valid & (wmax == clabel) & (wmin == clabel)
    up_deep = _upsample_nearest(deep_same.to(torch.int32), factor, h, w).to(torch.bool)
    adopt = mask & ~seeded & (up_meta != META_MAX) & up_deep & in_cov
    adopted_claim = max_nan(up_claim, field)
    up_hops = torch.clamp((up_meta >> 23) * int(factor), max=255)
    up_meta = (up_hops << 23) | (up_meta & LABEL_MASK)
    return (
        torch.where(adopt, adopted_claim, state[0]),
        torch.where(adopt, adopted_claim, state[1]),
        torch.where(adopt, up_meta, state[2]),
    )


def _ws_decode(meta, markers, mask):
    """Unpack labels from the converged meta and restore marker identity."""
    label = torch.where(meta == META_MAX, 0, (meta & LABEL_MASK) - 2)
    label = torch.where(markers != 0, markers, label)
    return torch.where((markers != 0) | (mask & (label != 0)), label, 0).to(torch.int32)


def _count(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _flood_state(field, markers, mask, fwd_int, bwd_int, state, taps, radius, *,
                 max_iters, run_scans, multigrid, grace=_GRACE, label_only=True,
                 barrier_first=True, stats=None):
    """The reference's flood schedule on one volume: barrier-first
    pre-flood, coarse V-cycle, temporal scans, Jacobi rounds."""
    h, w = field.shape[1:]

    if (barrier_first and label_only and bool(torch.any(markers < 0))
            and bool(torch.any(markers > 0))):
        # flood the -1 barrier alone to full-state convergence first; its
        # final claims seed the mixed flood (label-only convergence would
        # otherwise freeze the barrier's silently relaxing claims)
        neg = torch.where(markers < 0, markers, 0)
        state0 = _seed_state(neg)
        in_bar = (state[2] != META_MAX) & ((state[2] & LABEL_MASK) == 1)
        adopt = in_bar & lex_better(*state, *state0)
        state0 = tuple(torch.where(adopt, a, b) for a, b in zip(state, state0))
        state0 = _flood_state(
            field, neg, mask & (markers <= 0), fwd_int, bwd_int, state0, taps,
            radius, max_iters=max_iters, run_scans=run_scans, multigrid=multigrid,
            grace=1, label_only=False,
            barrier_first=False, stats=stats,
        )
        better0 = lex_better(*state0, *state)
        state = tuple(torch.where(better0, a, b) for a, b in zip(state0, state))
        del state0

    def scan_rounds(fld, mrk, msk, fwd, bwd, st, rad, key):
        for _ in range(_SCAN_CAP):
            st, changed = _watershed_scan_round(
                fld, mrk, msk, fwd, bwd, st, taps, rad, label_only=label_only
            )
            _count(stats, key, 1)
            if not changed:
                break
        return st

    def jacobi(fld, mrk, msk, fwd, bwd, st, rad, cap, key):
        done = 0
        while done < cap:
            n = min(_CHUNK_ITERS, cap - done)
            st, used = _watershed_sweeps(
                fld, mrk, msk, fwd, bwd, st, taps, rad, n, grace=grace,
                label_only=label_only,
            )
            _count(stats, key, used)
            done += used
            if used < n:  # converged inside the chunk
                break
        return st

    factor = 4
    if multigrid and h >= 8 * factor and w >= 8 * factor:
        # V-cycle: coarse barriers >= true barriers, so upsampled claims are
        # upper bounds and the fine rounds relax to the same fixed point
        cf, cmask, cmark, cfwd, cbwd, cstate = _ws_coarse_prep(
            field, markers, mask, fwd_int, bwd_int, factor
        )
        cradius = max(radius // factor, 1)
        if run_scans:
            cstate = scan_rounds(cf, cmark, cmask, cfwd, cbwd, cstate, cradius,
                                 "coarse_scan_rounds")
        cstate = jacobi(cf, cmark, cmask, cfwd, cbwd, cstate, cradius,
                        max_iters // 2 + 8, "coarse_jacobi_rounds")
        state = _ws_adopt(cstate, field, markers, mask, state, factor)
        del cstate, cf, cmask, cmark, cfwd, cbwd

    if run_scans:
        state = scan_rounds(field, markers, mask, fwd_int, bwd_int, state, radius,
                            "scan_rounds")
    return jacobi(field, markers, mask, fwd_int, bwd_int, state, radius, max_iters,
                  "jacobi_rounds")


def chunk_frames(t, h, w, budget, mixed):
    """Frames per chunk of the time-chunked flood within ``budget`` bytes
    (the reference's plan, in the port's own bytes per pixel): the most
    frames whose flood fits with a halo frame each side, then as many
    chunks as ``t`` frames need, evened out.  Raises MemoryError where not
    even the smallest chunk, 4 frames, fits."""
    per_frame = FLOOD_BYTES_PER_PX[mixed] * h * w
    frames_cap = int(budget) // per_frame - 2
    if frames_cap < _MIN_CHUNK_FRAMES:
        raise MemoryError(
            f"watershed of a ({t}, {h}, {w}) volume: a {_MIN_CHUNK_FRAMES}-frame chunk "
            f"with its two halo frames needs {(_MIN_CHUNK_FRAMES + 2) * per_frame} bytes, "
            f"over the budget of {int(budget)} bytes"
        )
    n_chunks = -(-t // frames_cap)
    return -(-t // n_chunks)


def _chunk_sums(labels):
    """Per-frame change checks of a label chunk: the sums of the labels and
    of their squares, and the labelled count (int64, on the device)."""
    lab = labels.to(torch.int64)
    return torch.stack([lab.sum(dim=(1, 2)), (lab * lab).sum(dim=(1, 2)),
                        (lab != 0).sum(dim=(1, 2))])


def _chunked_band_radius(mask, fwd, bwd, chunk_t):
    """The reference's full-coverage band of the chunked flood: the largest
    in-mask rounded displacement component, at least 1 and at most 21,
    taken a chunk of frames at a time."""
    mx = 0
    for s in range(0, mask.shape[0], chunk_t):
        sl = slice(s, s + chunk_t)
        m = torch.maximum(_round_flow(fwd[sl]).abs(), _round_flow(bwd[sl]).abs())
        m = m.amax(dim=-1)[mask[sl]]
        if m.numel():
            mx = max(mx, int(m.max()))
    return min(max(mx, 1), _BAND_CAP)


def _watershed_time_chunked(field, markers, mask, fwd, bwd, taps, *, chunk_t,
                            max_iters_cap, multigrid, run_scans,
                            max_passes=_MAX_PASSES, stats=None):
    """Block Gauss-Seidel over overlapping time chunks of ``chunk_t``
    frames (counterpart of the reference's ``_watershed_time_chunked``).

    Each chunk floods through :func:`_flood_state` with one frozen halo
    frame per side holding the neighbouring chunk's converged (claim,
    claim2, meta): halo frames are outside the floodable mask but push
    through the temporal scatter-min like interior frames.  Passes
    alternate forward and backward chunk order; a chunk is flooded again
    only when the version of one of its halo frames changed since its last
    flood, and a pass that changes no chunk's label sums and no boundary
    frame ends the loop.  Everything stays on the device.  ``stats``
    receives the round counts summed over the chunk floods, and
    ``chunks``, ``chunk_frames``, ``chunk_passes``, ``chunk_floods`` and
    ``chunk_skips``."""
    t, h, w = field.shape
    n_chunks = -(-t // chunk_t)
    radius = _chunked_band_radius(mask, fwd, bwd, chunk_t)
    # the labels and the boundary frames that the chunks hand each other
    # are allocated before the floods' working memory, so that they pin
    # none of its blocks
    labels = torch.zeros((t, h, w), dtype=torch.int32, device=field.device)
    bound = {  # frame -> its (claim, claim2, meta), as a neighbour's halo
        key: (field.new_empty((h, w)), field.new_empty((h, w)),
              markers.new_empty((h, w), dtype=torch.int32))
        for c in range(1, n_chunks) for key in (c * chunk_t - 1, c * chunk_t)
    }
    have = set()  # the boundary frames stored so far
    sums_prev = {}
    bound_ver = {}  # frame -> version of its boundary state
    flooded_ver = {}  # chunk -> the halo versions it last flooded with
    floods = skips = passes = 0
    for pass_i in range(max_passes):
        passes += 1
        order = range(n_chunks) if pass_i % 2 == 0 else range(n_chunks - 1, -1, -1)
        changed_any = False
        for ci in order:
            s, e = ci * chunk_t, min(t, (ci + 1) * chunk_t)
            in_ver = (bound_ver.get(s - 1, 0) if s > 0 else -1,
                      bound_ver.get(e, 0) if e < t else -1)
            if flooded_ver.get(ci) == in_ver:
                skips += 1
                continue
            lo, hi = max(s - 1, 0), min(e + 1, t)
            fld = torch.where(torch.isnan(field[lo:hi]), math.inf, field[lo:hi])
            mrk = markers[lo:hi]
            msk = mask[lo:hi].clone()
            if s > 0:
                msk[0] = False  # frozen boundary-condition frames
            if e < t:
                msk[-1] = False
            state = _seed_state(mrk)
            for idx, key, has in ((0, s - 1, s > 0), (-1, e, e < t)):
                if has and key in have:
                    for a, b in zip(state, bound[key]):
                        a[idx] = b
            state = _flood_state(
                fld, mrk, msk, _round_flow(fwd[lo:hi]), _round_flow(bwd[lo:hi]), state,
                taps, radius, max_iters=min(max_iters_cap, (hi - lo) + h + w + 32),
                run_scans=run_scans and hi - lo >= 4, multigrid=multigrid, stats=stats,
            )
            floods += 1
            i0, i1 = s - lo, e - 1 - lo
            # this chunk's first and last interior frames are its
            # neighbours' halo frames
            for key, idx, has in ((s, i0, s > 0), (e - 1, i1, e < t)):
                if not has:
                    continue
                new_b = tuple(a[idx] for a in state)
                if key not in have or not all(
                        torch.equal(x, y) for x, y in zip(new_b, bound[key])):
                    changed_any = True
                    bound_ver[key] = bound_ver.get(key, 0) + 1
                for x, y in zip(bound[key], new_b):
                    x.copy_(y)
                have.add(key)
            flooded_ver[ci] = in_ver
            lab = _ws_decode(state[2], mrk, msk)[i0:i1 + 1]
            del state
            sums = _chunk_sums(lab)
            if ci not in sums_prev or not torch.equal(sums, sums_prev[ci]):
                changed_any = True
                sums_prev[ci] = sums
                labels[s:e] = lab
        if not changed_any:
            break
    if stats is not None:
        stats.update(chunks=n_chunks, chunk_frames=chunk_t, chunk_passes=passes,
                     chunk_floods=floods, chunk_skips=skips)
    return labels


def watershed(forward_flow, backward_flow, field, markers, mask=None,
              connectivity=1, max_iters: int | None = None, multigrid: bool = True,
              stats: dict | None = None, budget_bytes: int | None = None, device=None):
    """Watershed segmentation of a (T, H, W) volume in the moving frame.

    forward_flow, backward_flow : (T, H, W, 2) flows (channel 0 = x).
    field : (T, H, W) topography to flood (NaN is a +inf barrier).
    markers : (T, H, W) int seeds; negative markers flood as barriers.
    mask : optional bool tensor; False pixels are never flooded.
    connectivity : 1..3, or an explicit (3, 3, 3) structure.
    max_iters : Jacobi round cap (default T + H + W + 32).
    multigrid : run the 4x coarse V-cycle first (when H, W >= 32).
    stats : optional dict that receives the round counts (and, when the
        flood is chunked, the chunk plan and passes).
    budget_bytes : device bytes the flood may take beyond its inputs.  A
        volume of at least 12 frames whose whole-volume flood would need
        more (``FLOOD_BYTES_PER_PX`` a pixel) floods in time chunks sized
        to fit; MemoryError where not even a 4-frame chunk fits.  ``None``
        means :func:`~tobac_flow_tpu_torch.device.memory_budget` at the
        call: the free memory less a margin on CUDA, no chunking on the
        CPU.
    device : where the flood runs; the arrays (numpy or tensors) are moved
        there.  ``None`` means CUDA and raises where CUDA is not available;
        ``"cpu"`` runs the plain PyTorch version of every op.

    The temporal band radius covers every in-mask rounded displacement
    (at least 1 px when chunked, as in the reference).

    Returns int32 labels on ``device``.
    """
    dev = resolve_device(device)
    field = torch.as_tensor(field).to(dev, torch.float32)
    markers = torch.as_tensor(markers).to(dev, torch.int32)
    if markers.shape != field.shape:
        raise ValueError(
            f"`markers` (shape {tuple(markers.shape)}) must have same shape as "
            f"`image` (shape {tuple(field.shape)})"
        )
    if mask is None:
        mask = torch.ones(field.shape, dtype=torch.bool, device=dev)
    else:
        mask = torch.as_tensor(mask).to(dev, torch.bool)
        if mask.shape != field.shape:
            raise ValueError(
                f"`mask` (shape {tuple(mask.shape)}) must have same shape "
                f"as `image` (shape {tuple(field.shape)})"
            )
    taps = _structure_taps_3d(connectivity_structure(connectivity))
    fwd = torch.as_tensor(forward_flow).to(dev)
    bwd = torch.as_tensor(backward_flow).to(dev)
    temporal = any(dt != 0 for dt, _, _ in taps)
    if field.dim() == 3 and field.shape[0] >= _MIN_CHUNKED_DEPTH and (
            budget_bytes is not None or dev.type == "cuda"):
        mixed = bool(torch.any(markers < 0)) and bool(torch.any(markers > 0))
        need = field.numel() * FLOOD_BYTES_PER_PX[mixed]
        if budget_bytes is None:
            budget_bytes = memory_budget(dev, need)
        if need > budget_bytes:
            own = field.numel() * _CHUNKED_BYTES_PER_PX
            chunk_t = chunk_frames(*field.shape, budget_bytes - own, mixed)
            return _watershed_time_chunked(
                field, markers, mask, fwd, bwd, taps, chunk_t=chunk_t,
                max_iters_cap=(1 << 30) if max_iters is None else max_iters,
                multigrid=multigrid, run_scans=temporal, stats=stats,
            )
    if max_iters is None:
        max_iters = int(sum(field.shape)) + 32
    field, fwd_int, bwd_int, state, exceed = _ws_prep(field, markers, mask, fwd, bwd)
    radius = _band_radius_from_stats(exceed)
    run_scans = field.shape[0] >= 4 and temporal
    state = _flood_state(
        field, markers, mask, fwd_int, bwd_int, state, taps, radius,
        max_iters=max_iters, run_scans=run_scans, multigrid=multigrid, stats=stats,
    )
    return _ws_decode(state[2], markers, mask)
