"""Binary and greyscale morphology as stencil min/max ops (counterpart of
``tobac_flow_tpu/ops/morphology.py``).

Semantics follow scipy as the reference does: the structure is anchored
at its centre, ``border_value`` is what lies outside the array,
``iterations`` repeats the base operation.  Every op runs on its input's
device over the whole volume.  ``distance_transform_edt`` is the exact
Euclidean distance transform that validation and subsegmentation use;
a greyscale ``size`` with fewer entries than the data has axes spans the
last axes (so ``grey_dilation(frames, (h, w))`` and
``peak_local_max_mask`` work frame by frame over a stack).  The Gaussian
is the reference's compiled separable correlation with scipy's reflect
borders and float32 taps.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.ops.warp import fma, shift_axis

__all__ = [
    "binary_erosion", "binary_dilation", "binary_opening", "binary_closing",
    "binary_fill_holes", "grey_erosion", "grey_dilation", "grey_opening", "gaussian_filter",
    "nan_gaussian_filter", "maximum_filter", "minimum_filter", "peak_local_max_mask",
    "distance_transform_edt",
]

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


def binary_closing(mask, structure=None, iterations=1):
    mask, offs = _prep(mask, structure, 1)
    out = _binary_morph(mask, offs, iterations, 0, "dilate")
    return _binary_morph(out, offs, iterations, 0, "erode")


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


def binary_fill_holes(mask, structure=None):
    """Fill the holes not connected to the array's border (scipy's
    semantics; the flood capped at the sum of the sides plus 8 steps, as
    in the reference)."""
    mask, offs = _prep(mask, structure, 1)
    return _fill_holes_device(mask, offs, int(sum(mask.shape)) + 8)


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


def _box_axes(ndim, size):
    """Per axis, the offsets of a ``size`` box (scalar: every axis; fewer
    entries than ``ndim``: the last axes), each as a 1-D structure."""
    if np.isscalar(size):
        size = (int(size),) * ndim
    size = (1,) * (ndim - len(size)) + tuple(int(s) for s in size)
    axes = []
    for axis, n in enumerate(size):
        offs = []
        for o in range(-(n // 2), n - n // 2):
            off = [0] * ndim
            off[axis] = o
            offs.append(tuple(off))
        axes.append(tuple(offs))
    return axes


def _grey(data, size, footprint, mode):
    """Moving minimum or maximum of float32 ``data`` over a ``footprint``
    (nonzero cells about its centre) or a ``size`` box (one axis after the
    other: a box's extremum is exact in any order); the reference's
    connectivity-1 cross where neither is given."""
    data = torch.as_tensor(data).to(torch.float32)
    if footprint is not None:
        return _grey_morph(data, _structure_offsets(np.asarray(footprint) != 0, data.dim()),
                           mode)
    if size is None:
        grid = np.abs(np.indices((3,) * data.dim()) - 1).sum(axis=0)
        return _grey_morph(data, _structure_offsets(grid <= 1, data.dim()), mode)
    for offs in _box_axes(data.dim(), size):
        data = _grey_morph(data, offs, mode)
    return data


def grey_erosion(data, size=None, footprint=None):
    return _grey(data, size, footprint, "min")


def grey_dilation(data, size=None, footprint=None):
    return _grey(data, size, footprint, "max")


def grey_opening(data, size=None, footprint=None):
    return grey_dilation(grey_erosion(data, size, footprint), size, footprint)


def maximum_filter(data, size):
    return grey_dilation(data, size=size)


def minimum_filter(data, size):
    return grey_erosion(data, size=size)


def peak_local_max_mask(frames, min_distance=10, threshold_abs=0.0):
    """Dense local-maxima mask of each frame of ``frames`` (..., H, W),
    cast to float32 first: pixels equal to the maximum over their
    (2d + 1)² window and above ``threshold_abs``, the ``d``-pixel border
    ring excluded (skimage ``peak_local_max``'s filter stage; a plateau
    keeps all its pixels)."""
    frames = torch.as_tensor(frames).to(torch.float32)
    d = int(min_distance)
    peaks = (frames >= grey_dilation(frames, (2 * d + 1, 2 * d + 1))) & (
        frames > float(np.float32(threshold_abs)))
    if d > 0:
        inner = torch.zeros_like(peaks)
        inner[..., d:-d, d:-d] = peaks[..., d:-d, d:-d]
        peaks = inner
    return peaks


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
    other: ``kernels`` is a sequence of (axis, taps or None).  The taps add
    left to right, rounded as the reference's compiled program rounds them:
    each tap's product fused into its add (``fma(k_0, p_0, k_1 p_1)``, then
    ``fma(k_i, p_i, sum)``), except where taps read the same reflected
    slice with the same float32 weight (an axis shorter than the kernel's
    radius): the program computes their product once, rounds it, and adds
    it plainly, and in the first add the other operand is the fused one."""
    for axis, kern in kernels:
        if kern is None:
            continue
        k = [float(np.float32(x)) for x in kern]
        r = len(k) // 2
        n = data.shape[axis]
        index = _symmetric_index(n, r, torch.device("cpu"))
        keys = [(tuple(index[i:i + n].tolist()), k[i]) for i in range(len(k))]
        single = [keys.count(key) == 1 for key in keys]
        padded = data.index_select(axis, index.to(data.device))

        def tap(i):
            return padded.narrow(axis, i, n)

        if single[0]:
            out = fma(k[0], tap(0), k[1] * tap(1))
        elif single[1]:
            out = fma(k[1], tap(1), k[0] * tap(0))
        else:
            out = k[0] * tap(0) + k[1] * tap(1)
        for i in range(2, len(k)):
            out = fma(k[i], tap(i), out) if single[i] else out + k[i] * tap(i)
        data = out
    return data


def gaussian_filter(data, sigma, truncate=4.0):
    """Separable Gaussian of float32 ``data`` with scipy's reflect borders
    and kernel radius (``sigma`` a scalar or one per axis; 0 skips an
    axis)."""
    data = torch.as_tensor(data).to(torch.float32)
    if np.isscalar(sigma):
        sigma = (sigma,) * data.dim()
    return _sepconv_reflect(data, tuple(
        (axis, None if s <= 0 else _gauss_kernel(s, truncate)) for axis, s in enumerate(sigma)))


def nan_gaussian_filter(a, sigma, propagate_nan=True, truncate=4.0):
    """Normalised-convolution Gaussian that ignores NaNs: the Gaussian of
    the field with NaN as 0 over the Gaussian of its valid mask (NaN where
    that is 0), NaN again at NaN input where ``propagate_nan``."""
    a = torch.as_tensor(a).to(torch.float32)
    nan = torch.isnan(a)
    ag = gaussian_filter(torch.where(nan, 0.0, a), sigma, truncate)
    cg = gaussian_filter((~nan).to(torch.float32), sigma, truncate)
    res = ag / torch.where(cg == 0, torch.nan, cg)
    return torch.where(nan, torch.nan, res) if propagate_nan else res


_EDT_BIG = 1e30  # the reference's cap on missing distances, before and after squaring
_EDT_SKIP = 1e8  # an axis spaced this far apart is not crossed
_EDT_ROWS = 4  # output rows of one block of the brute-force minimum, at least
_EDT_MIN_BLOCK = 2**22  # elements of one block's temporary, at least


def _run_table(s, n):
    """The reference's running distance ``k`` pixels past a zero: ``s``
    added once a pixel (``n + 1`` values, float64), which for a
    non-integer ``s`` is not ``k * s``."""
    out, run = [0.0], 0.0
    for _ in range(n):
        run = min(run + s, _EDT_BIG)
        out.append(run)
    return out


def _zero_steps(mask):
    """Per pixel, the pixels along the last axis back to the closest zero
    at or before it and on to the closest zero at or after it, and whether
    there is one each way."""
    n = mask.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    left = torch.where(mask, -1, idx).cummax(-1).values
    right = torch.where(mask, n, idx).flip(-1).cummin(-1).values.flip(-1)
    return idx - left, left >= 0, right - idx, right < n


def _brute_min(d2, axis, dist2):
    """``D(i) = min_j d2(j) + dist2[i, j]`` along ``axis``, over blocks of
    output rows whose temporary holds ``_EDT_ROWS`` times the volume (or
    ``_EDT_MIN_BLOCK`` elements)."""
    moved = d2.movedim(axis, -1)
    shape, m = moved.shape, moved.shape[-1]
    flat = moved.reshape(-1, m)
    out = torch.empty_like(flat)
    rows = max(_EDT_ROWS, _EDT_MIN_BLOCK // max(1, flat.numel()))
    for i0 in range(0, m, rows):
        i1 = min(m, i0 + rows)
        out[:, i0:i1] = (flat[:, None, :] + dist2[i0:i1]).amin(-1)
    del flat
    return out.reshape(shape).movedim(-1, axis).contiguous()


def _sqrt(x):
    """The correctly rounded float64 square root that numpy takes: the
    card's is; the CPU's vectorised one is not, so there numpy's runs."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return x.sqrt()


def distance_transform_edt(mask, sampling=None):
    """Exact Euclidean distance of each pixel to the nearest zero pixel of
    ``mask`` (an array or tensor; float64, on its device), equal bit for
    bit to the reference's two-stage transform: the closest zero along the
    last axis, then for each other axis from the second last down
    ``D²(i) = min_j d²(j) + (s (i - j))²`` by brute force, skipping an axis
    whose ``sampling`` is at least 1e8 (so ``(1e9, 1, 1)`` gives each
    frame's 2D distances).  Missing distances are capped at 1e30 before
    and after squaring: a mask without a zero gives 1e15 everywhere.

    With unit spacing the squared distances are exact integers, carried
    as int32 (int64 past 2^29) with a sentinel for the cap; otherwise the
    reference's float64 operations run as they are, its running sums of
    ``s`` included."""
    if hasattr(mask, "dims"):  # a DataArray
        mask = mask.data
    mask = torch.as_tensor(mask) != 0
    nd = mask.dim()
    if sampling is None:
        sampling = (1.0,) * nd
    sampling = tuple(float(s) for s in sampling)
    axes = [ax for ax in range(nd - 2, -1, -1) if sampling[ax] < _EDT_SKIP]
    n = mask.shape[-1]
    dev = mask.device
    k_left, has_left, k_right, has_right = _zero_steps(mask)
    del mask
    if all(sampling[ax] == 1.0 for ax in axes + [nd - 1]):
        span = sum((d - 1) ** 2 for d in k_left.shape)
        dtype, sent = (torch.int32, 2**30) if span < 2**29 else (torch.int64, 2**61)
        k = torch.minimum(torch.where(has_left, k_left, n), torch.where(has_right, k_right, n))
        del k_left, k_right
        d2 = torch.where(has_left | has_right, k.to(dtype) ** 2, sent)
        del k, has_left, has_right
        for ax in axes:
            i = torch.arange(d2.shape[ax], device=dev, dtype=dtype)
            d2 = _brute_min(d2, ax, (i[:, None] - i[None, :]) ** 2).clamp_(max=sent)
        return _sqrt(torch.where(d2 >= sent, _EDT_BIG, d2.double()))
    table = torch.tensor(_run_table(sampling[-1], n), dtype=torch.float64, device=dev)
    big = torch.tensor(_EDT_BIG, dtype=torch.float64, device=dev)
    fwd = torch.where(has_left, table[k_left.long()], big)
    bwd = torch.where(has_right, table[k_right.long()], big)
    del k_left, k_right, has_left, has_right
    d1 = torch.minimum(fwd, bwd)
    del fwd, bwd
    d2 = torch.minimum(d1 * d1, big)
    del d1
    for ax in axes:
        i = torch.arange(d2.shape[ax], device=dev)
        step = (i[:, None] - i[None, :]).double() * sampling[ax]
        d2 = _brute_min(d2, ax, step * step)
    return _sqrt(torch.minimum(d2, big))
