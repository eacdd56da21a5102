"""K in-plane Jacobi sweeps of the packed watershed state (counterpart of
``tobac_flow_tpu/ops/ws_pallas.py``).

``spatial_sweeps`` is the wrapper: on a CUDA tensor it launches the Hopper
kernel in ``csrc/ws_sweeps.cu``, built from source at first use; on a CPU
tensor it runs ``spatial_sweeps_reference``, the plain PyTorch version of
the same arithmetic.  There is no fallback between the two.

State: claim f32, claim2 f32, meta i32 = ``min(hops, 255) << 23 | label + 2``
(unlabelled = INT32_MAX).  One sweep, for every floodable pixel p and every
in-plane tap q = p + (dy, dx), considers q's pushed candidate

    cost  = field(q) if seeded(q) else max(field(q), claim(q))
    cost2 = -inf if seeded(q) else (claim(q) if field(q) > claim(q) else claim2(q))
    meta  = meta(q) with its hops cleared where field(q) > claim(q) (plateau entry)
            + one hop if field(p) == cost and hops < 255

and keeps the lexicographic minimum of (claim, hops, claim2, label), the -1
barrier losing full-tuple ties.  Every tap reads the state from before the
sweep (Jacobi).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple

import torch

from tobac_flow_tpu_torch.ops.warp import shift

__all__ = ["spatial_sweeps", "spatial_sweeps_reference", "build_library", "launch_plan"]

META_MAX = 2**31 - 1
LABEL_MASK = (1 << 23) - 1
HOPS_STEP = 1 << 23
HOPS_CAP = 255 << 23

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ws_sweeps.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB = None


def lex_better(c1a, c2a, ma, c1b, c2b, mb):
    """a < b in the (claim, hops, claim2, label) order; the -1 barrier
    (label code 1) ranks after every positive label on full-tuple ties."""
    ka = torch.where((ma & LABEL_MASK) == 1, ma | LABEL_MASK, ma)
    kb = torch.where((mb & LABEL_MASK) == 1, mb | LABEL_MASK, mb)
    ha = ma >> 23
    hb = mb >> 23
    c1_eq = c1a == c1b
    h_eq = ha == hb
    return (c1a < c1b) | (c1_eq & (ha < hb)) | (c1_eq & h_eq & (c2a < c2b)) | (
        c1_eq & h_eq & (c2a == c2b) & (ka < kb)
    )


def max_nan(a, b):
    """``jnp.maximum``: NaN propagates, and +0 ranks above -0.
    (``torch.maximum`` returns either zero of an equal pair, depending on
    which of its loops runs.)"""
    zero_max = (a.view(torch.int32) & b.view(torch.int32)).view(torch.float32)
    return torch.where(a == b, zero_max, torch.maximum(a, b))


def pushed(c, c2, m, f, sd):
    """Each pixel's outgoing candidate (cost, cost2, meta) with the
    plateau-entry hop reset."""
    rise = ~sd & (f > c)
    cost = torch.where(sd, f, max_nan(f, c))
    cost2 = torch.where(sd, -torch.inf, torch.where(f > c, c, c2))
    meta_p = torch.where(rise, m & LABEL_MASK, m)
    return cost, cost2, meta_p


def consider(best, cq, c2q, mq, f):
    """Fold one candidate into the running best; the hop clock ticks only
    on-level (receiver field == candidate claim) and saturates at 255."""
    bc, bc2, bm = best
    tick = (mq < HOPS_CAP) & (f == cq)
    cand_m = mq + torch.where(tick, HOPS_STEP, 0).to(torch.int32)
    better = lex_better(cq, c2q, cand_m, bc, bc2, bm) & (mq != META_MAX)
    return (
        torch.where(better, cq, bc),
        torch.where(better, c2q, bc2),
        torch.where(better, cand_m, bm),
    )


def spatial_sweeps_reference(claim, claim2, meta, field, seeded, floodable,
                             in_plane, k_sweeps=8):
    """Plain PyTorch version: ``k_sweeps`` whole-array Jacobi sweeps over
    the in-plane taps ``in_plane`` ((dy, dx) pairs)."""
    c, c2, m = claim, claim2, meta
    for _ in range(k_sweeps):
        cost, cost2, meta_p = pushed(c, c2, m, field, seeded)
        best = (c, c2, m)
        for dy, dx in in_plane:
            best = consider(
                best,
                shift(cost, dy, dx, torch.inf),
                shift(cost2, dy, dx, torch.inf),
                shift(meta_p, dy, dx, META_MAX),
                field,
            )
        c = torch.where(floodable, best[0], c)
        c2 = torch.where(floodable, best[1], c2)
        m = torch.where(floodable, best[2], m)
    return c, c2, m


class SweepPlan(NamedTuple):
    """How one launch of the kernel covers a (T, H, W) volume: haloed
    ``halo`` x ``halo`` tiles whose ``tile`` x ``tile`` interiors cover
    each frame once, walked by a persistent grid of ``grid`` blocks."""

    halo: int
    tile: int
    tiles_y: int
    tiles_x: int
    n_tiles: int
    grid: int
    threads: int
    smem_bytes: int


# the tile of csrc/ws_sweeps.cu, which checks each launch's plan against it
HALO = 64
THREADS = 512
_CAND_LEN = HALO * HALO + 8  # words per candidate array, with guards
_CAND_ARRAYS = 4  # cost, cost2, pushed meta, its barrier key; double-buffered
_MASK_ROW = HALO + 8  # bytes per staged mask row
SMEM_BYTES = (2 * _CAND_ARRAYS * _CAND_LEN * 4 + 4 * HALO * HALO * 4
              + 2 * HALO * _MASK_ROW)
SMEM_PER_SM = 233_472  # Hopper: 228 KB of shared memory per SM
SMEM_PER_BLOCK = 232_448  # Hopper: the most one block may ask for
_SMEM_RESERVED = 1_024  # per resident block, kept by the runtime
_INT32_MAX = 2**31 - 1


@lru_cache(maxsize=64)
def launch_plan(t, h, w, k, sm_count):
    """The launch plan of ``k`` sweeps over a (t, h, w) volume on a card
    with ``sm_count`` SMs: a tile's interior is the haloed tile less ``k``
    cells each side; the grid is as many blocks as fit on the card at once
    (one per SM), or fewer when there are fewer tiles."""
    if not 1 <= k <= 8:
        raise ValueError("k_sweeps must lie in [1, 8]")
    tile = HALO - 2 * k
    tiles_y = -(-h // tile)
    tiles_x = -(-w // tile)
    n_tiles = t * tiles_y * tiles_x
    if n_tiles > _INT32_MAX:
        # the kernel counts tiles in 32-bit ints (its pixel offsets are 64-bit)
        raise ValueError(f"a ({t}, {h}, {w}) volume at k={k} has {n_tiles} tiles, over "
                         f"the kernel's {_INT32_MAX}")
    per_sm = max(1, SMEM_PER_SM // (SMEM_BYTES + _SMEM_RESERVED))
    grid = max(1, min(n_tiles, sm_count * per_sm))
    return SweepPlan(HALO, tile, tiles_y, tiles_x, n_tiles, grid, THREADS, SMEM_BYTES)


def build_library():
    """Compile ``csrc/ws_sweeps.cu`` into ``_build/`` (keyed on a hash of
    the source and flags) and load it; returns the ctypes library.  The
    compiler's report (``-Xptxas -v``: registers, spills, shared memory)
    of a build made in this process is kept in ``build_library.report``."""
    global _LIB
    if _LIB is not None:
        return _LIB
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"ws_sweeps_{key}.so"
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build ws_sweeps.cu")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            done = subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                check=True, capture_output=True, text=True,
            )
            build_library.report = done.stderr
            os.replace(tmp, lib_path)
        except subprocess.CalledProcessError as err:
            raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{err.stderr}") from err
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    lib.ws_sweeps_prepare.restype = ctypes.c_int
    lib.ws_sweeps_prepare.argtypes = ()
    fn = lib.ws_spatial_sweeps
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_uint]
        + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_void_p]
    )
    _LIB = lib
    return lib


build_library.report = ""

_DTYPES = (torch.float32, torch.float32, torch.int32, torch.float32, torch.bool, torch.bool)
_NAMES = ("claim", "claim2", "meta", "field", "seeded", "floodable")


def _check(*arrays):
    claim = arrays[0]
    if claim.dim() != 3:
        raise ValueError(f"expected (T, H, W) arrays, got {tuple(claim.shape)}")
    shape, dev = claim.shape, claim.device
    if all(a.dtype == d and a.shape == shape and a.device == dev and a.is_contiguous()
           for a, d in zip(arrays, _DTYPES)):
        return
    for name, a, dtype in zip(_NAMES, arrays, _DTYPES):
        if a.shape != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {tuple(shape)}")
        if a.dtype != dtype:
            raise TypeError(f"{name} has dtype {a.dtype}, expected {dtype}")
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, claim on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


@lru_cache(maxsize=16)
def _tap_code(in_plane):
    """Taps packed 4 bits each, (dy + 1) * 3 + (dx + 1), in the given order."""
    if not 1 <= len(in_plane) <= 8:
        raise ValueError("between 1 and 8 in-plane taps are supported")
    code = 0
    for i, (dy, dx) in enumerate(in_plane):
        if abs(dy) > 1 or abs(dx) > 1 or (dy, dx) == (0, 0):
            raise ValueError(f"in-plane tap {(dy, dx)} is not a 3x3 neighbour")
        code |= ((dy + 1) * 3 + (dx + 1)) << (4 * i)
    return code


_SM_COUNT = {}  # device index -> SMs; the kernel's shared-memory limit is raised there


def _prepared_sm_count(lib, index):
    """The SM count of CUDA device ``index``, raising the kernel's
    shared-memory limit there on first use."""
    if index not in _SM_COUNT:
        with torch.cuda.device(index):
            err = lib.ws_sweeps_prepare()
        if err != 0:
            raise RuntimeError(f"ws_sweeps_prepare failed: CUDA error {err}")
        _SM_COUNT[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SM_COUNT[index]


def spatial_sweeps(claim, claim2, meta, field, seeded, floodable, in_plane,
                   k_sweeps=8):
    """``k_sweeps`` in-plane Jacobi sweeps of contiguous (T, H, W) state;
    returns new (claim, claim2, meta).  CUDA tensors go through the kernel,
    CPU tensors through :func:`spatial_sweeps_reference`.  Each launch adds
    one to ``spatial_sweeps.launches`` and to
    ``spatial_sweeps.launches_by_shape[(T, H, W, k_sweeps)]``."""
    _check(claim, claim2, meta, field, seeded, floodable)
    in_plane = tuple((int(dy), int(dx)) for dy, dx in in_plane)
    if claim.device.type == "cpu":
        return spatial_sweeps_reference(
            claim, claim2, meta, field, seeded, floodable, in_plane, k_sweeps
        )
    if claim.device.type != "cuda":
        raise ValueError(f"spatial_sweeps runs on CUDA or CPU tensors, not {claim.device}")
    code = _tap_code(in_plane)
    t, h, w = claim.shape
    k = int(k_sweeps)
    outs = (torch.empty_like(claim), torch.empty_like(claim2), torch.empty_like(meta))
    if claim.numel() == 0:
        return outs
    lib = build_library()
    index = claim.device.index
    plan = launch_plan(t, h, w, k, _prepared_sm_count(lib, index))
    with torch.cuda.device(index):
        err = lib.ws_spatial_sweeps(
            claim.data_ptr(), claim2.data_ptr(), meta.data_ptr(), field.data_ptr(),
            seeded.data_ptr(), floodable.data_ptr(), *(o.data_ptr() for o in outs),
            t, h, w, k, code, len(in_plane), plan.halo, plan.tiles_y, plan.tiles_x,
            plan.grid, plan.threads, plan.smem_bytes,
            torch.cuda.current_stream(index).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ws_spatial_sweeps launch failed: CUDA error {err}")
    spatial_sweeps.launches += 1
    by_shape = spatial_sweeps.launches_by_shape
    by_shape[(t, h, w, k)] = by_shape.get((t, h, w, k), 0) + 1
    return outs


spatial_sweeps.launches = 0
spatial_sweeps.launches_by_shape = {}
