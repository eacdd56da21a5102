"""Binary and greyscale morphology as stencil min/max ops (counterpart of
the parts of ``tobac_flow_tpu/ops/morphology.py`` the detection chain
uses).

Semantics follow scipy as the reference does: the structure is anchored
at its centre, ``border_value`` is what lies outside the array,
``iterations`` repeats the base operation.  Every op runs on its input's
device over the whole volume.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.ops.warp import fma, shift_axis

__all__ = ["binary_erosion", "binary_dilation", "binary_opening"]

_FLOOD_CHECK = 8  # flood iterations between convergence checks


def _structure_offsets(structure, ndim):
    structure = np.asarray(structure)
    if structure.ndim != ndim:
        raise ValueError(f"structure must have {ndim} dimensions")
    centre = tuple(s // 2 for s in structure.shape)
    return tuple(
        tuple(int(i) - c for i, c in zip(idx, centre)) for idx in zip(*np.nonzero(structure))
    )


def _shift_nd(arr, offsets, fill):
    """``arr[p + o]`` for the offset tuple ``o``, constant ``fill``
    outside."""
    for axis, o in enumerate(offsets):
        arr = shift_axis(arr, -int(o), axis, fill)
    return arr


def _binary_morph(mask, offsets, iterations, border_value, mode):
    """``iterations`` erosions (AND over ``mask[p + o]``) or dilations (OR
    over ``mask[p - o]``) with ``border_value`` outside the array."""
    border = bool(border_value)
    for _ in range(int(iterations)):
        out = None
        for off in offsets:
            if mode == "erode":
                shifted = _shift_nd(mask, off, border)
                out = shifted if out is None else out & shifted
            else:
                shifted = _shift_nd(mask, tuple(-o for o in off), border)
                out = shifted if out is None else out | shifted
        mask = out
    return mask


def _prep(mask, structure, default_conn):
    mask = torch.as_tensor(mask) != 0
    if structure is None:
        grid = np.abs(np.indices((3,) * mask.dim()) - 1).sum(axis=0)
        structure = grid <= default_conn
    return mask, _structure_offsets(structure, mask.dim())


def binary_erosion(mask, structure=None, iterations=1, border_value=0):
    mask, offs = _prep(mask, structure, 1)
    return _binary_morph(mask, offs, iterations, border_value, "erode")


def binary_dilation(mask, structure=None, iterations=1, border_value=0):
    mask, offs = _prep(mask, structure, 1)
    return _binary_morph(mask, offs, iterations, border_value, "dilate")


def binary_opening(mask, structure=None, iterations=1):
    mask, offs = _prep(mask, structure, 1)
    out = _binary_morph(mask, offs, iterations, 0, "erode")
    return _binary_morph(out, offs, iterations, 0, "dilate")


def _flood(inv, seed, offsets, max_iters):
    """Grow ``seed`` through ``inv`` along the structure's moves, one step
    per iteration, until a step changes nothing or ``max_iters`` steps have
    run (the reference's loop).  Growth is monotone, so checking every
    ``_FLOOD_CHECK`` steps stops at the same set."""
    reach = seed
    done = 0
    while done < max_iters:
        before = reach
        for _ in range(min(_FLOOD_CHECK, max_iters - done)):
            grown = reach
            for off in offsets:
                grown = grown | _shift_nd(reach, tuple(-o for o in off), False)
            reach = grown & inv
            done += 1
        if torch.equal(reach, before):
            break
    return reach


def _fill_holes_device(mask, offsets, max_iters):
    """scipy's ``binary_fill_holes``: flood the complement from a padded
    outside shell; what the flood does not reach is a hole.  The shell
    touches the interior only through the structure's moves, so an axis it
    cannot traverse (time, for an in-plane structure) stays disconnected.
    (The reference also seeds the flood from a 4x coarse grid; its coarse
    shell is padded closed, so those seeds are always empty and the fine
    flood alone decides.)"""
    padded = torch.nn.functional.pad(mask, (1, 1) * mask.dim(), value=False)
    inv = ~padded
    shell = torch.ones_like(padded)
    shell[(slice(1, -1),) * mask.dim()] = False
    reach = _flood(inv, shell & inv, offsets, max_iters)
    filled = padded | (inv & ~reach)
    return filled[(slice(1, -1),) * mask.dim()]


def _grey_morph(data, offsets, mode):
    """Moving minimum (``data[p + o]``, +inf outside) or maximum
    (``data[p - o]``, -inf outside) over the structure's offsets."""
    fill = float("inf") if mode == "min" else -float("inf")
    out = data
    for off in offsets:
        if mode == "min":
            out = torch.minimum(out, _shift_nd(data, off, fill))
        else:
            out = torch.maximum(out, _shift_nd(data, tuple(-x for x in off), fill))
    return out


def _gauss_kernel(sigma, truncate=4.0):
    r = int(truncate * float(sigma) + 0.5)
    if r < 1:
        return None
    u = np.arange(-r, r + 1)
    k = np.exp(-(u**2) / (2.0 * sigma**2))
    return k / k.sum()


def _symmetric_index(n, r, device):
    """Source indices of numpy's ``"symmetric"`` padding by ``r`` (scipy's
    ``reflect``: the edge sample repeats)."""
    j = torch.remainder(torch.arange(-r, n + r, device=device), 2 * n)
    return torch.where(j >= n, 2 * n - 1 - j, j)


def _sepconv_reflect(data, kernels):
    """Separable correlation with symmetric borders, one axis after the
    other: ``kernels`` is a sequence of (axis, taps or None).  Each output
    is ``fma(k_0, p_0, k_1 p_1)``, then one fused multiply-add per further
    tap, left to right, as the reference's compiled program rounds it."""
    for axis, kern in kernels:
        if kern is None:
            continue
        k = [float(np.float32(x)) for x in kern]
        r = len(k) // 2
        n = data.shape[axis]
        padded = data.index_select(axis, _symmetric_index(n, r, data.device))
        out = fma(k[0], padded.narrow(axis, 0, n), k[1] * padded.narrow(axis, 1, n))
        for i in range(2, len(k)):
            out = fma(k[i], padded.narrow(axis, i, n), out)
        data = out
    return data
