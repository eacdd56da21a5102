"""The (t, x) mesh of ranks for the sharded pipeline (counterpart of
``tobac_flow_tpu/parallel/mesh.py``).

The reference splits a volume over a ``jax.sharding.Mesh`` of devices: the
time axis ("t") is the sequence-parallel axis, the trailing spatial axis
("x") the tile axis, and stencil ops exchange halos between neighbouring
tiles.  Here every tile is one process (a rank of ``torch.distributed``)
and all ranks run the same functions, as the bodies of ``jax.shard_map``
do.  Rank ``r`` holds tile ``(r // n_x, r % n_x)``.

Where every rank has a card of its own, the ranks talk over NCCL with card
tensors.  Where several ranks share a card (or run on the CPU), they talk
over gloo, and a card tensor goes through pinned host memory on its way.
The launcher (``parallel/launch.py``) picks the backend from the layout,
before any rank starts.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from tobac_flow_tpu_torch.device import resolve_device

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """One rank's view of an ``n_t`` x ``n_x`` mesh: its coordinates, the
    ranks of its t column (``t_group``) and x row (``x_group``), its
    device and the backend.  ``bytes_sent`` counts the bytes this rank has
    sent to other ranks and ``exchange_s`` the seconds its exchanges took
    on the host's clock (a card tensor's copy to the host waits for the
    card's queued work)."""

    def __init__(self, n_t, n_x, device, backend, t_group=None, x_group=None):
        self.n_t, self.n_x = int(n_t), int(n_x)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        if self.world != self.n_t * self.n_x:
            raise ValueError(f"a ({n_t}, {n_x}) mesh needs {self.n_t * self.n_x} ranks, "
                             f"the process group has {self.world}")
        self.t, self.x = divmod(self.rank, self.n_x)
        self.device = torch.device(device)
        self.backend = backend
        self.t_group, self.x_group = t_group, x_group
        # gloo moves host tensors only: a card tensor travels through the host
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.bytes_sent = 0
        self.exchange_s = 0.0

    def __repr__(self):
        return (f"Mesh(t={self.n_t}, x={self.n_x}, rank={self.rank} at ({self.t}, {self.x}), "
                f"device={self.device}, backend={self.backend})")

    def coord(self, axis):
        """This rank's index along ``axis`` ("t" or "x") and the axis size."""
        return (self.t, self.n_t) if axis == "t" else (self.x, self.n_x)

    def neighbour(self, axis, step):
        """The global rank ``step`` tiles along ``axis``, or None past the
        mesh's edge."""
        i, n = self.coord(axis)
        j = i + step
        if not 0 <= j < n:
            return None
        return j * self.n_x + self.x if axis == "t" else self.t * self.n_x + j

    def group(self, axis):
        return self.t_group if axis == "t" else self.x_group

    def outbound(self, a):
        """``a`` as the backend sends it: bool as uint8, a card tensor in
        pinned host memory under gloo; contiguous."""
        if a.dtype == torch.bool:
            a = a.to(torch.uint8)
        if self.staged:
            host = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
            host.copy_(a)
            return host
        return a.contiguous()

    def inbound_buffer(self, shape, dtype):
        """An empty buffer the backend receives a tensor of ``dtype`` into."""
        dtype = torch.uint8 if dtype == torch.bool else dtype
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def arrived(self, buf, dtype):
        """A received buffer as a tensor of ``dtype`` on this rank's device."""
        out = buf.to(self.device, non_blocking=True)
        return out != 0 if dtype == torch.bool else out

    def any(self, flag) -> bool:
        """Whether ``flag`` (a bool tensor or value) holds on any rank: an
        ``all_reduce`` over the whole mesh, as the reference's ``psum``."""
        t0 = time.perf_counter()
        flag = torch.as_tensor(flag, device=self.device).reshape(1).to(torch.int32)
        buf = self.outbound(flag)
        dist.all_reduce(buf)
        out = bool(buf.item() > 0)
        self.exchange_s += time.perf_counter() - t0
        return out

    def tile_bounds(self, shape):
        """(t0, t1, x0, x1) of this rank's tile of a (T, H, W, ...) volume;
        raises unless the mesh divides T and W evenly."""
        t, w = int(shape[0]), int(shape[2])
        if t % self.n_t or w % self.n_x:
            raise ValueError(f"a ({self.n_t}, {self.n_x}) mesh needs T divisible by "
                             f"{self.n_t} and W by {self.n_x}, got {tuple(shape)}")
        tl, wl = t // self.n_t, w // self.n_x
        return self.t * tl, (self.t + 1) * tl, self.x * wl, (self.x + 1) * wl

    def tile(self, a, dtype=None):
        """This rank's (T/n_t, H, W/n_x, ...) tile of a global volume (a
        numpy array, a memory map or a tensor) on its device."""
        t0, t1, x0, x1 = self.tile_bounds(a.shape)
        part = a[t0:t1, :, x0:x1]
        out = torch.as_tensor(part if isinstance(part, torch.Tensor) else part.copy())
        return out.to(self.device, dtype=dtype).contiguous()

    def sum(self, a):
        """The elementwise sum of ``a`` over every rank (an ``all_reduce``)."""
        t0 = time.perf_counter()
        buf = self.outbound(a)
        dist.all_reduce(buf)
        out = self.arrived(buf, a.dtype)
        self.exchange_s += time.perf_counter() - t0
        return out

    def _p2p(self, ops):
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def gather(self, local, widths=None):
        """The global volume from every rank's tile, on rank 0 (None on the
        other ranks, which keep only their tiles).  Tiles (T_l, H, W_l, ...)
        join along T by t index and along W by x index; ``widths`` gives
        each x index's W_l where they differ (a tile travels padded to the
        widest)."""
        t0 = time.perf_counter()
        dtype = local.dtype
        if widths is not None:
            pad = list(local.shape)
            pad[2] = max(widths) - local.shape[2]
            local = torch.cat([local, local.new_zeros(pad)], dim=2)
        buf = self.outbound(local)
        if self.rank == 0:
            parts = [buf] + [self.inbound_buffer(buf.shape, buf.dtype)
                             for _ in range(1, self.world)]
            self._p2p([dist.P2POp(dist.irecv, parts[r], r) for r in range(1, self.world)])
            if widths is not None:
                parts = [a[:, :, :widths[r % self.n_x]] for r, a in enumerate(parts)]
            rows = [torch.cat(parts[i * self.n_x:(i + 1) * self.n_x], dim=2)
                    for i in range(self.n_t)]
            out = self.arrived(torch.cat(rows, dim=0), dtype)
        else:
            self._p2p([dist.P2POp(dist.isend, buf, 0)])
            self.bytes_sent += buf.numel() * buf.element_size()
            out = None
        self.exchange_s += time.perf_counter() - t0
        return out

    def scatter(self, whole, shape, dtype):
        """This rank's tile of a (T, H, W, ...) volume of ``shape`` that only
        rank 0 holds (``whole``; None on the other ranks), as ``dtype`` on
        this rank's device: rank 0 sends each rank its tile."""
        t0 = time.perf_counter()
        t_lo, t_hi, x_lo, x_hi = self.tile_bounds(shape)
        tl, wl = t_hi - t_lo, x_hi - x_lo
        if self.rank == 0:
            ops = []
            for r in range(1, self.world):
                t, x = divmod(r, self.n_x)
                send = self.outbound(whole[t * tl:(t + 1) * tl, :, x * wl:(x + 1) * wl].to(dtype))
                ops.append(dist.P2POp(dist.isend, send, r))
                self.bytes_sent += send.numel() * send.element_size()
            self._p2p(ops)
            out = whole[:tl, :, :wl].to(self.device, dtype).contiguous()
        else:
            buf = self.inbound_buffer((tl, shape[1], wl, *shape[3:]), dtype)
            self._p2p([dist.P2POp(dist.irecv, buf, 0)])
            out = self.arrived(buf, dtype)
        self.exchange_s += time.perf_counter() - t0
        return out

    def broadcast(self, a, src=0):
        """Rank ``src``'s tensor ``a`` on every rank (``a`` gives the shape
        and dtype on the others)."""
        t0 = time.perf_counter()
        dtype = a.dtype
        buf = self.outbound(a) if self.rank == src else self.inbound_buffer(a.shape, dtype)
        dist.broadcast(buf, src)
        if self.rank == src:
            self.bytes_sent += buf.numel() * buf.element_size() * (self.world - 1)
        out = self.arrived(buf, dtype)
        self.exchange_s += time.perf_counter() - t0
        return out


def make_mesh(n_t: int | None = None, n_x: int = 1, device=None) -> Mesh:
    """This rank's view of a (t, x) mesh over the initialised process group
    (``parallel.launch.launch`` starts the ranks and calls this).  With only
    ``n_t`` given, every rank goes to the time axis.  ``device=None`` means
    this rank's current CUDA device, and raises where CUDA is not available;
    ``device="cpu"`` runs the plain PyTorch versions.  The backend is the
    process group's."""
    if device is None:
        resolve_device()  # raises where CUDA is not available
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: start the ranks "
                           "with tobac_flow_tpu_torch.parallel.launch.launch")
    world = dist.get_world_size()
    if n_t is None:
        n_t = world // n_x
    backend = dist.get_backend()
    columns = [[t * n_x + x for t in range(n_t)] for x in range(n_x)]
    rows = [[t * n_x + x for x in range(n_x)] for t in range(n_t)]
    t_group = x_group = None
    if world > 1:
        t_group, _ = dist.new_subgroups_by_enumeration(columns, backend=backend)
        x_group, _ = dist.new_subgroups_by_enumeration(rows, backend=backend)
    return Mesh(n_t, n_x, device, backend, t_group, x_group)
