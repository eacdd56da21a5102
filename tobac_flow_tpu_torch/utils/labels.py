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

from tobac_flow_tpu_torch.device import (
    LABEL_BYTES_PER_PX, LABEL_TABLE_BYTES_PER_PX, OUTPUT_BYTES_PER_PX, chunk_plan, time_chunks,
)
from tobac_flow_tpu_torch.ops.ccl import label_components, relabel_sequential

__all__ = [
    "LabelSegments", "SegmentChunks", "labeled_comprehension", "make_step_labels",
    "remap_labels", "remap_table", "slice_labels", "unique_labels",
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
    that has no pixel.  Float sums run through ``index_put_`` with
    ``accumulate=True``, whose CUDA version sorts the pixels by bin and
    adds each bin's values in pixel order, so that a sum does not change
    from run to run."""

    def __init__(self, labels, n=None):
        self.labels = labels
        if n is None:
            n = max(int(labels.max()), 0) if labels.numel() else 0
        self.n = n
        self.mask = labels > 0
        self.bins = labels[self.mask].long()
        self.counts = torch.bincount(self.bins, minlength=self.n + 1)
        self._present = None

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
        """Per-label sums of per-pixel ``values``, accumulated in ``dtype``."""
        bins, values = self._select(values, keep)
        out = torch.zeros(self.n + 1, dtype=dtype, device=self.labels.device)
        return out.index_put_((bins,), values.to(dtype), accumulate=True)

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
        self._counts = self._present = None

    @property
    def counts(self):
        if self._counts is None:
            self._counts = sum(seg.counts for _, _, seg in self)
        return self._counts

    def __iter__(self):
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
