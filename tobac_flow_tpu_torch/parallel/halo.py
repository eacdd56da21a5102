"""Halo exchange between neighbouring tiles of the mesh (counterpart of
``tobac_flow_tpu/parallel/halo.py``).

Stencils in the moving frame reach a bounded neighbourhood: ±1 frame in
time and ±(largest flow + interpolation support) pixels in x (flows are
clipped to ±20 px).  So each tile is extended by a fixed halo from its
neighbours before a stencil runs, and the tiles at the global domain edge
take a constant fill instead, which makes the domain edge behave exactly
as the single-device out-of-frame fill.  Each rank sends its first halo
slab back and its last slab forward, and receives the matching slabs, in
one ``batch_isend_irecv`` over its axis group: both directions go
together, so no rank waits on another's order.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = ["halo_exchange_t", "halo_exchange_x"]


def _exchange(mesh, head, tail, axis):
    """(slab from the previous tile, slab from the next tile) along the
    mesh's ``axis``; None past the mesh's edge.  ``head`` goes to the
    previous tile, ``tail`` to the next."""
    t0 = time.perf_counter()
    prev, nxt = mesh.neighbour(axis, -1), mesh.neighbour(axis, 1)
    ops, bufs = [], [None, None]
    group = mesh.group(axis)
    for slot, peer, out in ((0, prev, head), (1, nxt, tail)):
        if peer is None:
            continue
        send = mesh.outbound(out)
        bufs[slot] = mesh.inbound_buffer(out.shape, out.dtype)
        ops.append(dist.P2POp(dist.isend, send, peer, group))
        ops.append(dist.P2POp(dist.irecv, bufs[slot], peer, group))
        mesh.bytes_sent += send.numel() * send.element_size()
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out = tuple(None if b is None else mesh.arrived(b, head.dtype) for b in bufs)
    mesh.exchange_s += time.perf_counter() - t0
    return out


def _extend(mesh, local, axis_name, halo, fill_value, axis):
    if halo == 0:
        return local
    axis = axis % local.dim()
    n = local.shape[axis]
    if halo > n:
        raise ValueError(f"a halo of {halo} exceeds the tile's {n} along axis {axis}")
    head = local.narrow(axis, 0, halo)
    tail = local.narrow(axis, n - halo, halo)
    from_prev, from_next = _exchange(mesh, head, tail, axis_name)
    if from_prev is None:
        from_prev = torch.full_like(head, fill_value)
    if from_next is None:
        from_next = torch.full_like(tail, fill_value)
    return torch.cat([from_prev, local, from_next], dim=axis)


def halo_exchange_t(mesh, local, halo=1, fill_value=0.0):
    """``local`` (T_l, ...) with ``halo`` frames of the neighbouring time
    tiles on each side: (T_l + 2·halo, ...); the first and last tiles of the
    sequence take ``fill_value`` frames."""
    return _extend(mesh, local, "t", int(halo), fill_value, 0)


def halo_exchange_x(mesh, local, halo=24, fill_value=0.0, axis=-1):
    """``local`` with ``halo`` columns of the neighbouring x tiles on each
    side along ``axis`` (the sharded spatial axis); the tiles at the
    domain's edges take ``fill_value`` columns."""
    return _extend(mesh, local, "x", int(halo), fill_value, axis)
