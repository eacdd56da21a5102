"""Cross-tile connected-component labelling in the moving frame
(counterpart of ``tobac_flow_tpu/parallel/label.py``).

The mask is split over a (t, x) mesh and every in-mask pixel seeds its
global pixel id, ``(t·H + y)·W + x + 1`` in int32, which is the same under
any mesh.  Each round refreshes the halos, takes the minimum over the
in-plane cross and over each pixel's links to the neighbouring frames
(then, as the reference does not, 7 more such sweeps inside the tile on
the same halos), and ends with an ``all_reduce`` of a changed flag; the
loop stops when no rank changed.  Output labels are the minimum seed id of each component.

A pixel links to the pixel its own rounded flow takes it to in the next
frame (forward flow) and in the previous one (backward flow), both
components of the displacement read at the pixel, and a link joins its two
ends whichever end it starts from: the graph of the single-device
``segment.label.flow_label`` with no overlap thresholds, so the two give
the same partition.  (The reference reads the row displacement at the
displaced column and only pulls along the links, so its labels can split
a component where the flow varies: not inherited.)
"""

from __future__ import annotations

import torch

from tobac_flow_tpu_torch.parallel.halo import _exchange, halo_exchange_t, halo_exchange_x

__all__ = ["sharded_flow_label", "make_sharded_flow_label"]

_INT_MAX = 2**31 - 1
IN_PLANE = ((-1, 0), (0, -1), (0, 1), (1, 0))  # the reference's in-plane cross, raster order
_LOCAL_SWEEPS = 8  # sweeps a round, the first with fresh halos


def _displaced(ext, dy, dx, radius):
    """``ext[t, y + dy, x + radius + dx]`` for each (t, y, x) of the
    interior, 0 where the row falls outside the frame.  ext: (T, H, W_l +
    2·radius) halo-extended labels; dy, dx: (T, H, W_l) clipped integer
    displacements, both read at the destination."""
    h, wl = dy.shape[1], dy.shape[2]
    rows = torch.arange(h, device=ext.device).view(1, h, 1) + dy
    cols = torch.arange(wl, device=ext.device).view(1, 1, wl) + radius + dx
    ok = (rows >= 0) & (rows < h)
    flat = (rows.clamp(0, h - 1) * ext.shape[2] + cols).reshape(dy.shape[0], -1)
    got = torch.gather(ext.reshape(ext.shape[0], -1), 1, flat).view(dy.shape)
    return torch.where(ok, got, torch.zeros((), dtype=ext.dtype, device=ext.device))


def _pushed(mesh, values, moves, radius, fold=True):
    """Each interior pixel's ``values`` pushed to its neighbouring frames
    along its own displacements (``moves``: ((dt, dy, dx), ...), clipped
    integer fields), colliding pushes keeping the least; pushes that land
    in a neighbouring tile go to its owner (a halo exchange in reverse,
    x first, then t, so that a corner reaches its diagonal tile), or with
    ``fold=False`` are dropped.  Returns the least push each interior pixel
    received (``_INT_MAX`` where none)."""
    tl, h, wl = values.shape
    we = wl + 2 * radius
    out = torch.full((tl + 2, h, we), _INT_MAX, dtype=torch.int32, device=values.device)
    flat_out = out.view(-1)
    frames = torch.arange(tl, device=values.device).view(tl, 1, 1)
    ys = torch.arange(h, device=values.device).view(1, h, 1)
    xs = torch.arange(wl, device=values.device).view(1, 1, wl)
    for dt, dy, dx in moves:
        rows = ys + dy
        ok = (rows >= 0) & (rows < h) & (values != _INT_MAX)
        index = ((frames + 1 + dt) * h + rows.clamp(0, h - 1)) * we + xs + radius + dx
        flat_out.scatter_reduce_(0, index[ok], values[ok], "amin")
    if not fold:
        return out[1:tl + 1, :, radius:radius + wl]
    if radius:
        from_prev, from_next = _exchange(mesh, out[..., :radius], out[..., we - radius:], "x")
        if from_prev is not None:
            out[..., radius:2 * radius] = torch.minimum(out[..., radius:2 * radius], from_prev)
        if from_next is not None:
            out[..., wl:wl + radius] = torch.minimum(out[..., wl:wl + radius], from_next)
    inner = out[:, :, radius:radius + wl]
    from_prev, from_next = _exchange(mesh, inner[:1].contiguous(), inner[-1:].contiguous(), "t")
    if from_prev is not None:
        inner[1] = torch.minimum(inner[1], from_prev[0])
    if from_next is not None:
        inner[tl] = torch.minimum(inner[tl], from_next[0])
    return inner[1:tl + 1]


def _shift_y(a, dy):
    """``a[:, y + dy]`` with 0 outside."""
    if dy == 0:
        return a
    pad = torch.zeros_like(a[:, :abs(dy)])
    return torch.cat([a[:, dy:], pad], 1) if dy > 0 else torch.cat([pad, a[:, :dy]], 1)


def global_pixel_ids(mesh, shape, w_total):
    """The global pixel ids ``(t·H + y)·W + x + 1`` of this rank's
    (T_l, H, W_l) tile, int32."""
    tl, h, wl = shape
    dev = mesh.device
    tt = torch.arange(tl, dtype=torch.int32, device=dev).view(tl, 1, 1) + mesh.t * tl
    yy = torch.arange(h, dtype=torch.int32, device=dev).view(1, h, 1)
    xx = torch.arange(wl, dtype=torch.int32, device=dev).view(1, 1, wl) + mesh.x * wl
    return (tt * h + yy) * int(w_total) + xx + 1


def _label_step_local(mesh, mask, fwd, bwd, w_total, in_plane, halo, max_rounds):
    """Per rank: seed global pixel ids, min-propagate to the mesh's fixed
    point; returns (labels tile, rounds)."""
    tl, h, wl = mask.shape
    labels = torch.where(mask, global_pixel_ids(mesh, mask.shape, w_total), 0)
    def rounded(f, i):
        return torch.round(f[..., i]).clamp(-halo, halo).to(torch.int32)

    fdx, fdy, bdx, bdy = rounded(fwd, 0), rounded(fwd, 1), rounded(bwd, 0), rounded(bwd, 1)
    moves = ((1, fdy, fdx), (-1, bdy, bdx))
    big = torch.tensor(_INT_MAX, dtype=torch.int32, device=mask.device)

    def cand(v):
        return torch.where(v == 0, big, v)

    def sweep(labels, ext, fold):
        best = cand(labels)
        for dy, dx in in_plane:
            shifted = _shift_y(ext[1:1 + tl, :, halo + dx:halo + dx + wl], dy)
            best = torch.minimum(best, cand(shifted))
        # each frame's pixels link to where their own flow takes them in the
        # neighbouring frames: pull along those links, and push back along them
        best = torch.minimum(best, cand(_displaced(ext[2:], fdy, fdx, halo)))
        best = torch.minimum(best, cand(_displaced(ext[:tl], bdy, bdx, halo)))
        best = torch.minimum(best, _pushed(mesh, cand(labels), moves, halo, fold))
        return torch.where(mask & (best != _INT_MAX), best, labels)

    # a round: one sweep with fresh halos, then local sweeps that read the
    # same halos and drop pushes across tile edges; labels only fall, so
    # they reach the same fixed point, in fewer exchanges
    rounds = 0
    changed = True
    while changed and rounds < max_rounds:
        ext = halo_exchange_x(mesh, halo_exchange_t(mesh, labels, 1, 0), halo, 0, axis=2)
        new = sweep(labels, ext, True)
        for _ in range(_LOCAL_SWEEPS - 1):
            ext[1:1 + tl, :, halo:halo + wl] = new
            new = sweep(new, ext, False)
        changed = mesh.any(torch.any(new != labels))
        labels = new
        rounds += 1
    return labels, rounds


def make_sharded_flow_label(mesh, t_total, h, w_total, halo=24, max_rounds=512):
    """A sharded flow-labelling step for fixed global shapes: ``fn(mask,
    forward_flow, backward_flow) -> labels``, called on every rank with the
    global (T, H, W) mask and (T, H, W, 2) flows; returns the global labels
    on rank 0's device (None on the other ranks) (the minimum seed id of each component, the same
    under any mesh).  ``fn.rounds`` holds the last call's rounds."""

    def fn(mask, forward_flow, backward_flow):
        if tuple(mask.shape) != (t_total, h, w_total):
            raise ValueError(f"expected a {(t_total, h, w_total)} mask, got {tuple(mask.shape)}")
        m = mesh.tile(mask, torch.bool)
        fwd = mesh.tile(forward_flow, torch.float32)
        bwd = mesh.tile(backward_flow, torch.float32)
        labels, fn.rounds = _label_step_local(mesh, m, fwd, bwd, w_total, IN_PLANE, halo,
                                              max_rounds)
        return mesh.gather(labels)

    fn.rounds = 0
    return fn


def sharded_flow_label(mesh, mask, forward_flow, backward_flow, halo=24):
    """One-shot sharded flow labelling (see :func:`make_sharded_flow_label`)."""
    t, h, w = mask.shape
    return make_sharded_flow_label(mesh, t, h, w, halo=halo)(mask, forward_flow, backward_flow)
