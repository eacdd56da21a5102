"""Label bookkeeping (counterpart of the parts of
``tobac_flow_tpu/utils/labels.py`` that ``run_detection`` uses).

Volume-sized work (renumbering, splitting labels by step, grouping pixels
by label, the per-label reductions of :class:`LabelSegments`) runs on the
label tensor's device; the per-label tables it produces, and the
per-label Python functions of ``labeled_comprehension``, run on the host.
Over the device budget (``budget_bytes``; ``None`` means
``device.memory_budget``, no chunks on the CPU) the volume passes run in
time chunks, and the numberings carry each chunk's count on to the next,
so that they number the labels as the whole volume does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tobac_flow_tpu_torch.data.ncdataset import DataArray
from tobac_flow_tpu_torch.device import (
    LABEL_BYTES_PER_PX, LABEL_TABLE_BYTES_PER_PX, OUTPUT_BYTES_PER_PX, chunk_plan, time_chunks,
)
from tobac_flow_tpu_torch.ops.ccl import label_components, relabel_sequential

__all__ = [
    "LabelSegments", "SegmentChunks", "apply_func_to_labels", "bin_sums", "sum_plan",
    "find_overlapping_labels",
    "get_step_labels_for_label", "labeled_comprehension", "make_step_labels",
    "relabel_objects", "remap_labels", "remap_table", "slice_labels", "unique_labels",
]


class LabelSegments:
    """The pixels of each label 1..n of a non-negative label volume (a
    tensor; n its largest label), for per-label reductions on its device:
    the counterpart of the reference's per-label comprehensions
    (``apply_func_to_labels``), which sort the volume and call a Python
    function once per label.

    ``gather`` picks a field's values at the labelled pixels; ``sum`` and
    ``reduce`` turn such per-pixel values into n + 1 per-label bins (bin 0
    unused), over all labelled pixels or those flagged by ``keep``; ``at``
    takes bins at label values to the host, with a default for a label
    that has no pixel.  Sums run through :func:`bin_sums` over the pixels
    sorted by label once, so that a sum has the same bits on every device
    and in every run."""

    def __init__(self, labels, n=None):
        self.labels = labels
        if n is None:
            n = max(int(labels.max()), 0) if labels.numel() else 0
        self.n = n
        self.mask = labels > 0
        self.bins = labels[self.mask].long()
        self.counts = torch.bincount(self.bins, minlength=self.n + 1)
        self._present = self._plan = None

    def gather(self, values):
        """``values`` (a tensor or array broadcasting against the volume)
        at the labelled pixels, in raster order."""
        values = torch.as_tensor(values, device=self.labels.device)
        return values.expand(self.labels.shape)[self.mask]

    def _select(self, values, keep):
        if keep is None:
            return self.bins, values
        return self.bins[keep], values[keep]

    def sum(self, values, keep=None, dtype=torch.float64):
        """Per-label sums of per-pixel ``values`` (those ``keep`` flags),
        accumulated in ``dtype`` (:func:`bin_sums`)."""
        values = values.to(dtype)
        if keep is not None:
            values = torch.where(keep, values, torch.zeros((), dtype=dtype, device=values.device))
        if self._plan is None:
            self._plan = sum_plan(self.bins, self.n + 1, self.counts)
        return bin_sums(values, self.bins, self.n + 1, self._plan)

    def reduce(self, values, how, keep=None, empty=0):
        """Per-label ``how`` ("amin", "amax") of per-pixel ``values``;
        ``empty`` in a bin without values."""
        bins, values = self._select(values, keep)
        out = torch.full((self.n + 1,), empty, dtype=values.dtype, device=self.labels.device)
        return out.scatter_reduce_(0, bins, values, how, include_self=False)

    def at(self, per_label, index, default):
        """``per_label`` bins at the label values ``index``, as numpy;
        ``default`` for a label without pixels."""
        if self._present is None:
            self._present = self.counts.cpu().numpy() > 0
        return _bins_at(self._present, per_label, index, default)


def sum_plan(bins, n, counts=None):
    """The pairwise tree of :func:`bin_sums` over ``bins`` (0..n-1): the
    stable order of the values by bin, the slots of each level (values of
    a bin added in neighbouring pairs, until one value per bin is left)
    and the bin of each final value."""
    small = bins.numel() < 2**31 and n < 2**31  # int32 positions: half the memory
    order = torch.argsort(bins.int() if small else bins, stable=True)
    if small:
        order = order.int()
    if counts is None:
        counts = torch.bincount(bins, minlength=n)
    sorted_bins, levels = bins[order], []
    device, m = bins.device, bins.numel()
    while m and int(counts.max()) > 1:
        starts = torch.cumsum(counts, 0) - counts
        pairs = (counts + 1) // 2
        slot = (torch.cumsum(pairs, 0) - pairs)[sorted_bins] + (
            torch.arange(m, device=device) - starts[sorted_bins]) // 2
        m = int(pairs.sum())
        levels.append((slot.int() if small else slot, m))
        sorted_bins = torch.repeat_interleave(torch.arange(n, device=device), pairs,
                                              output_size=m)
        counts = pairs
    return order, levels, sorted_bins


def bin_sums(values, bins, n, plan=None):
    """Per-bin sums (bins 0..n-1) of ``values``, each bin's values added
    in the fixed pairwise tree of :func:`sum_plan` (``plan``, when given):
    the tree depends only on the bins, and ``index_add_`` puts at most two
    values into a slot, whose sum does not depend on their order, so the
    sums have the same bits on every device and in every run (and are
    more accurate than a running sum)."""
    order, levels, last_bins = sum_plan(bins, n) if plan is None else plan
    values = values[order]
    for slot, total in levels:
        values = torch.zeros(total, dtype=values.dtype, device=values.device).index_add_(
            0, slot, values)
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    out[last_bins] = values
    return out


def _bins_at(present, per_label, index, default):
    """``per_label`` bins at the label values ``index`` where ``present``
    (a bool per bin) holds, else ``default``, as numpy."""
    index = np.atleast_1d(np.asarray(index, dtype=np.int64))
    inside = (index > 0) & (index < present.size)
    safe = np.where(inside, index, 0)
    return np.where(inside & present[safe], per_label.cpu().numpy()[safe], default)


class SegmentChunks:
    """A (T, ...) label volume's :class:`LabelSegments`, a chunk of frames
    at a time on ``device`` (the labels may wait on the host), each over
    the whole volume's labels 1..n, for per-label reductions that
    accumulate across chunks: iterating gives (s, e, segments of frames
    [s, e)); ``take`` gives a field's part for a chunk; ``counts`` are the
    whole volume's pixels per label and ``at`` reads bins as
    :meth:`LabelSegments.at` does.  The chunks are sized from
    ``bytes_per_px`` within ``budget_bytes`` (see
    ``device.chunk_plan``)."""

    def __init__(self, labels, what, budget_bytes=None, device=None,
                 bytes_per_px=OUTPUT_BYTES_PER_PX):
        self.labels = labels
        self.device = labels.device if device is None else torch.device(device)
        self.t = labels.shape[0]
        self.n = max(int(labels.max()), 0) if labels.numel() else 0
        self.chunk = chunk_plan(what, labels.shape, bytes_per_px, self.device, budget_bytes)
        self._counts = self._present = self._whole = None

    @property
    def counts(self):
        if self._counts is None:
            self._counts = sum(seg.counts for _, _, seg in self)
        return self._counts

    def __iter__(self):
        if self.chunk >= self.t:  # one chunk: its segments (and sum plan) serve every pass
            if self._whole is None:
                self._whole = LabelSegments(self.labels.to(self.device), self.n)
            yield 0, self.t, self._whole
            return
        for s, e, _, _ in time_chunks(self.t, self.chunk):
            yield s, e, LabelSegments(self.labels[s:e].to(self.device), self.n)

    def take(self, values, s, e):
        """``values`` (a tensor or array that broadcasts against the
        volume) for frames [s, e), on the device."""
        values = torch.as_tensor(values)
        if values.dim() == self.labels.dim() and values.shape[0] == self.t:
            values = values[s:e]
        return values.to(self.device)

    at = LabelSegments.at


def _chunk(what, labels, budget_bytes, bytes_per_px=LABEL_TABLE_BYTES_PER_PX, device=None):
    return chunk_plan(what, labels.shape, bytes_per_px,
                      labels.device if device is None else device, budget_bytes)


def unique_labels(labels, budget_bytes=None):
    """Sorted nonzero label values present in a tensor, as numpy of its
    dtype (flags set per chunk on its device where the labels are
    non-negative integers)."""
    labels = torch.as_tensor(labels)
    dtype = torch.empty((), dtype=labels.dtype).numpy().dtype
    if labels.numel() == 0:
        return np.empty(0, dtype=dtype)
    if not labels.is_floating_point() and int(labels.min()) >= 0:
        seen = torch.zeros(int(labels.max()) + 1, dtype=torch.bool, device=labels.device)
        for s, e, _, _ in time_chunks(labels.shape[0], _chunk("unique_labels", labels,
                                                                budget_bytes)):
            seen[labels[s:e].reshape(-1).long()] = True
        present = torch.nonzero(seen).squeeze(1)
    else:
        present = torch.unique(labels)
    return present[present != 0].cpu().numpy().astype(dtype)


def _sequential(keys, fg, shape):
    """``keys`` (one per foreground pixel) renumbered 1..N in increasing
    order into a zero int32 volume of ``shape``."""
    out = torch.zeros(shape, dtype=torch.int32, device=keys.device)
    _, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    out[fg] = inverse.to(torch.int32) + 1
    return out


def remap_labels(labels, locations=None, new_labels=None, budget_bytes=None):
    """Keep and renumber the labels flagged in ``locations`` (a bool per
    label 1..max, or label values) and zero the rest (a lookup applied a
    chunk at a time)."""
    lut = remap_table(labels, locations, new_labels)
    if labels.dim() == 0:
        return lut[labels.long()]
    out = torch.empty_like(labels)
    for s, e, _, _ in time_chunks(labels.shape[0], _chunk("remap_labels", labels,
                                                            budget_bytes)):
        out[s:e] = lut[labels[s:e].long()]
    return out


def remap_table(labels, locations=None, new_labels=None):
    """The lookup table of :func:`remap_labels`, on the labels' device."""
    max_label = int(labels.max()) if labels.numel() else 0
    if new_labels is not None:
        max_label = max(max_label, np.size(new_labels))
    remapper = np.zeros(max_label + 1, dtype=np.int64)
    if new_labels is None and locations is not None:
        new_labels = np.arange(1, int(np.sum(locations)) + 1)
    if locations is not None:
        locations = np.asarray(locations)
        if locations.dtype == bool:
            remapper[1:][locations] = new_labels
        else:
            remapper[locations] = new_labels
    else:
        remapper[1:] = new_labels
    return torch.from_numpy(remapper).to(labels.device, labels.dtype)


def _numbered_by_chunks(what, labels, keys_of, budget_bytes, bytes_per_px, device=None):
    """An int32 volume that numbers the foreground pixels of ``labels``
    1..N, a chunk of frames at a time, each chunk's numbers carrying on
    from the last's: within a chunk in increasing order of
    ``keys_of(chunk, foreground, s)`` (int64 keys, one per foreground
    pixel of the chunk of frames from ``s``).  The whole volume's
    numbering, where the whole volume's order puts every pixel of a chunk
    after those of the chunks before it (as frame-major keys do).  On
    ``device`` (the labels' by default), a chunk moved there at a time."""
    device = labels.device if device is None else torch.device(device)
    out = torch.zeros(labels.shape, dtype=torch.int32, device=device)
    count = 0
    for s, e, _, _ in time_chunks(labels.shape[0], _chunk(what, labels, budget_bytes,
                                                            bytes_per_px, device)):
        lab = labels[s:e].to(device)
        fg = lab > 0
        part = _sequential(keys_of(lab, fg, s), fg, lab.shape)
        n = int(part.max()) if part.numel() else 0
        out[s:e] = torch.where(fg, part + count, part)
        count += n
        del part, fg
    return out


def slice_labels(labels, budget_bytes=None, device=None):
    """Split labels along the leading (time) axis: each label's pixels at
    one step share one id even where disconnected; ids run 1..N in step,
    then label order."""
    device = labels.device if device is None else torch.device(device)
    step_max = labels.reshape(labels.shape[0], -1).amax(dim=1).clamp(min=0).to(device,
                                                                                torch.int64)
    offsets = (torch.cumsum(step_max, 0) - step_max).view(-1, *([1] * (labels.dim() - 1)))

    def keys(lab, fg, s):
        return (lab.to(torch.int64) + offsets[s:s + lab.shape[0]])[fg]

    return _numbered_by_chunks("slice_labels", labels, keys, budget_bytes,
                               LABEL_TABLE_BYTES_PER_PX, device)


def make_step_labels(labels, budget_bytes=None, device=None):
    """Split a label raster into per-step labels: each (connected region in
    one frame, label) gets its own id, numbered in (region, label) order."""
    width = int(labels.max()) + 1 if labels.numel() else 1

    def keys(lab, fg, s):
        # a chunk's regions numbered from 1: their order, and so the keys',
        # is the whole volume's
        step = relabel_sequential(label_components(fg))
        return step[fg].to(torch.int64) * width + lab[fg].to(torch.int64)

    return _numbered_by_chunks("make_step_labels", labels, keys, budget_bytes,
                               LABEL_BYTES_PER_PX, device)


def labeled_comprehension(field, labels, func: Callable, index=None, dtype=None,
                          default=None, pass_positions: bool = False):
    """``func`` of the values of ``field`` within each label
    (scipy.ndimage.labeled_comprehension semantics; ``index=None`` takes
    every positive label present).  Each label's values come in raster
    order; with ``pass_positions`` ``func`` also gets their raveled
    positions.

    ``labels`` is a tensor or an array; ``field`` a tensor on its device or
    an array broadcasting against it.  The pixels are grouped on the
    labels' device; the groups' values and ``func`` run on the host."""
    labels = torch.as_tensor(labels)
    flat = labels.reshape(-1)
    fg = torch.nonzero(flat > 0).squeeze(1)
    vals = flat[fg]
    order = torch.argsort(vals, stable=True)
    pos = fg[order]
    groups, counts = torch.unique_consecutive(vals[order], return_counts=True)
    if isinstance(field, torch.Tensor):
        field_vals = (field.broadcast_to(labels.shape).reshape(-1)[pos.to(field.device)]
                      .cpu().numpy())
        if dtype is None:
            dtype = field_vals.dtype
    else:
        field = np.asarray(field)
        if dtype is None:
            dtype = field.dtype
        field_vals = np.broadcast_to(field, tuple(labels.shape)).reshape(-1)[pos.cpu().numpy()]
    pos = pos.cpu().numpy()
    groups = groups.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
    where = {int(v): i for i, v in enumerate(groups)}
    if index is None:
        index = groups
    out = []
    for v in np.atleast_1d(np.asarray(index)):
        i = where.get(int(v))
        if i is None:
            out.append(default)
            continue
        sl = slice(starts[i], starts[i + 1])
        out.append(func(field_vals[sl], pos[sl]) if pass_positions else func(field_vals[sl]))
    return np.asarray(out, dtype=dtype)


def _tensor(x):
    """A DataArray's data, a tensor or an array as a tensor where it lies."""
    return torch.as_tensor(x.data if isinstance(x, DataArray) else x)


def _numpy(x):
    if isinstance(x, DataArray):
        x = x.data
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def apply_func_to_labels(labels, *fields, func: Callable = np.mean, index=None,
                         default=None):
    """``func`` of the values of each field within each label, over the
    label values of ``index`` (by default 1..max), as the reference's
    general comprehension gives it: each label's values in raster order,
    ``func`` called on the host once per label, ``default`` (its length
    probed from ``func`` on the first label where it is a scalar) for a
    label without pixels, the results stacked on a last axis and squeezed.
    The labels and fields broadcast together; the pixels are grouped on
    the labels' device, and only the labelled values come to the host."""
    labels = _tensor(labels)
    shapes = [tuple(f.shape) for f in fields]
    shape = torch.broadcast_shapes(tuple(labels.shape), *shapes)
    flat = labels.expand(shape).reshape(-1)
    fg = torch.nonzero(flat != 0).squeeze(1)
    vals = flat[fg]
    order = torch.argsort(vals, stable=True)
    pos = fg[order]
    groups, counts = torch.unique_consecutive(vals[order], return_counts=True)
    groups = groups.cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(counts.cpu().numpy())])
    has_zero = fg.numel() < flat.numel()
    vmin, vmax = (int(groups.min()), int(groups.max())) if groups.size else (0, 0)
    lab_min = min(vmin, 0) if has_zero else vmin
    lab_max = max(vmax, 0) if has_zero else vmax
    if index is None:
        index = range(1, lab_max - min(lab_min, 0) + 1)
    elif len(index) == 0:
        return np.empty(0)
    if len(index) == 0:
        return np.empty(0)

    def values_at(positions):
        out = []
        for f in fields:
            if isinstance(f, DataArray):
                f = f.data
            if isinstance(f, torch.Tensor):
                out.append(f.expand(shape).reshape(-1)[positions.to(f.device)].cpu().numpy())
            else:
                nd = np.unravel_index(positions.cpu().numpy(), shape)
                out.append(np.broadcast_to(np.asarray(f), shape)[nd])
        return out

    sorted_fields = values_at(pos)
    where = {int(v): i for i, v in enumerate(groups)}

    def group_values(v):
        i = where.get(int(v))
        if int(v) == 0 or i is None:
            return None
        return [f[starts[i]:starts[i + 1]] for f in sorted_fields]

    default_vals = default
    try:
        iter(default)
        assert not isinstance(default, str)
    except (TypeError, AssertionError):
        if groups[groups != 0].size:
            probe = func(*group_values(groups[groups != 0][0]))
            try:
                assert not isinstance(probe, str)
                default_vals = [default] * len(probe)
            except (AssertionError, TypeError):
                default_vals = default
    else:
        if len(default) == 1 and not isinstance(default, str):
            default_vals = default[0]

    results = []
    for i in index:
        part = group_values(i)
        if part is not None:
            results.append(func(*part))
        elif i == 0 and has_zero:
            background = torch.nonzero(flat == 0).squeeze(1)
            results.append(func(*values_at(background)))
        else:
            results.append(default_vals)
    return np.stack(results, -1).squeeze()


def get_step_labels_for_label(labels, step_labels):
    """For each label value 0..max, the sorted step-label values its pixels
    carry (None for a value without pixels), from the distinct (label,
    step label) pairs found on the labels' device."""
    labels, steps = _tensor(labels), _tensor(step_labels)
    lab_max = max(int(labels.max()), 0) if labels.numel() else 0
    pairs = torch.unique(torch.stack([labels.reshape(-1).long(),
                                      steps.reshape(-1).to(labels.device).long()], 1), dim=0)
    pairs = pairs.cpu().numpy()
    dtype = torch.empty((), dtype=steps.dtype).numpy().dtype
    bounds = np.searchsorted(pairs[:, 0], np.arange(lab_max + 2))
    return [pairs[bounds[v]:bounds[v + 1], 1].astype(dtype)
            if bounds[v + 1] > bounds[v] else None for v in range(lab_max + 1)]


def relabel_objects(labels, inplace=False, budget_bytes=None):
    """Renumber the labels present to 1..N in increasing order (a lookup
    applied a chunk at a time where the labels lie); with ``inplace``, into
    ``labels`` itself (an array's memory on the CPU)."""
    labels = _tensor(labels)
    uniq = unique_labels(labels, budget_bytes)
    lut = torch.zeros(int(labels.max()) + 1 if labels.numel() else 1, dtype=labels.dtype,
                      device=labels.device)
    lut[torch.as_tensor(uniq.astype(np.int64), device=labels.device)] = torch.arange(
        1, uniq.size + 1, dtype=labels.dtype, device=labels.device)
    out = labels if inplace else torch.zeros_like(labels)
    if labels.dim() == 0:
        out[...] = lut[labels.long()]
        return out
    for s, e, _, _ in time_chunks(labels.shape[0], _chunk("relabel_objects", labels,
                                                            budget_bytes)):
        out[s:e] = lut[labels[s:e].long()]
    return out


def find_overlapping_labels(labels, locs, bins, overlap: float = 0,
                            absolute_overlap: int = 0):
    """Labels overlapping the raveled positions ``locs``: those covering
    more than ``absolute_overlap`` of them and at least ``overlap`` times
    the smaller of their count and the label's size (``bins`` cumulative,
    so that label v has ``bins[v] - bins[v - 1]`` pixels)."""
    locs = _numpy(locs)
    if not len(locs):
        return []
    labels = _tensor(labels)
    values = labels.reshape(-1)[torch.as_tensor(locs.astype(np.int64), device=labels.device)]
    counts = torch.bincount(values.clamp(min=0).long()).cpu().numpy()
    bins = _numpy(bins)
    n_locs = len(locs)
    return [int(v) for v in torch.unique(values).cpu().numpy()
            if v != 0 and counts[v] > absolute_overlap
            and counts[v] >= overlap * min(n_locs, bins[v] - bins[v - 1])]
