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
from pathlib import Path

import torch

from tobac_flow_tpu_torch.ops.warp import shift

__all__ = ["spatial_sweeps", "spatial_sweeps_reference", "build_library"]

META_MAX = 2**31 - 1
LABEL_MASK = (1 << 23) - 1
HOPS_STEP = 1 << 23
HOPS_CAP = 255 << 23

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "ws_sweeps.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
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


def pushed(c, c2, m, f, sd):
    """Each pixel's outgoing candidate (cost, cost2, meta) with the
    plateau-entry hop reset."""
    rise = ~sd & (f > c)
    cost = torch.where(sd, f, torch.maximum(f, c))
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


def build_library():
    """Compile ``csrc/ws_sweeps.cu`` into ``_build/`` (keyed on a hash of
    the source and flags) and load it; returns the ctypes library."""
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
            subprocess.run(
                [nvcc, *_NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, lib_path)
        except subprocess.CalledProcessError as err:
            raise RuntimeError(f"nvcc failed on {_SOURCE}:\n{err.stderr}") from err
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.ws_spatial_sweeps
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    )
    _LIB = lib
    return lib


def _check(claim, claim2, meta, field, seeded, floodable):
    shape = claim.shape
    if claim.dim() != 3:
        raise ValueError(f"expected (T, H, W) arrays, got {tuple(shape)}")
    for name, a, dtype in (
        ("claim", claim, torch.float32), ("claim2", claim2, torch.float32),
        ("meta", meta, torch.int32), ("field", field, torch.float32),
        ("seeded", seeded, torch.bool), ("floodable", floodable, torch.bool),
    ):
        if a.shape != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {tuple(shape)}")
        if a.dtype != dtype:
            raise TypeError(f"{name} has dtype {a.dtype}, expected {dtype}")
        if a.device != claim.device:
            raise ValueError(f"{name} is on {a.device}, claim on {claim.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _tap_code(in_plane):
    """Taps packed 4 bits each, (dy + 1) * 3 + (dx + 1), in the given order."""
    code = 0
    for i, (dy, dx) in enumerate(in_plane):
        if abs(dy) > 1 or abs(dx) > 1 or (dy, dx) == (0, 0):
            raise ValueError(f"in-plane tap {(dy, dx)} is not a 3x3 neighbour")
        code |= ((dy + 1) * 3 + (dx + 1)) << (4 * i)
    return code


def spatial_sweeps(claim, claim2, meta, field, seeded, floodable, in_plane,
                   k_sweeps=8):
    """``k_sweeps`` in-plane Jacobi sweeps of contiguous (T, H, W) state;
    returns new (claim, claim2, meta).  CUDA tensors go through the kernel,
    CPU tensors through :func:`spatial_sweeps_reference`."""
    _check(claim, claim2, meta, field, seeded, floodable)
    in_plane = tuple((int(dy), int(dx)) for dy, dx in in_plane)
    if claim.device.type == "cpu":
        return spatial_sweeps_reference(
            claim, claim2, meta, field, seeded, floodable, in_plane, k_sweeps
        )
    if claim.device.type != "cuda":
        raise ValueError(f"spatial_sweeps runs on CUDA or CPU tensors, not {claim.device}")
    if not 1 <= len(in_plane) <= 8:
        raise ValueError("between 1 and 8 in-plane taps are supported")
    if not 1 <= k_sweeps <= 8:
        raise ValueError("k_sweeps must lie in [1, 8]")
    ins = (claim, claim2, meta, field, seeded, floodable)
    outs = [torch.empty_like(ins[0]), torch.empty_like(ins[1]), torch.empty_like(ins[2])]
    t, h, w = claim.shape
    lib = build_library()
    with torch.cuda.device(claim.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ws_spatial_sweeps(
            *[a.data_ptr() for a in ins], *[o.data_ptr() for o in outs],
            t, h, w, int(k_sweeps), _tap_code(in_plane), len(in_plane), stream,
        )
    if err != 0:
        raise RuntimeError(f"ws_spatial_sweeps launch failed: CUDA error {err}")
    spatial_sweeps.launches += 1
    return tuple(outs)


spatial_sweeps.launches = 0
