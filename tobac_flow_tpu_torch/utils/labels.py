"""Label bookkeeping (counterpart of the parts of
``tobac_flow_tpu/utils/labels.py`` that ``run_detection`` uses).

Volume-sized work (renumbering, splitting labels by step, grouping pixels
by label, the per-label reductions of :class:`LabelSegments`) runs on the
label tensor's device; the per-label tables it produces, and the
per-label Python functions of ``labeled_comprehension``, run on the host.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tobac_flow_tpu_torch.ops.ccl import flat_label

__all__ = [
    "LabelSegments", "labeled_comprehension", "make_step_labels", "remap_labels",
    "slice_labels", "unique_labels",
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

    def __init__(self, labels):
        self.labels = labels
        self.n = max(int(labels.max()), 0) if labels.numel() else 0
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
        index = np.atleast_1d(np.asarray(index, dtype=np.int64))
        inside = (index > 0) & (index <= self.n)
        safe = np.where(inside, index, 0)
        found = inside & self._present[safe]
        return np.where(found, per_label.cpu().numpy()[safe], default)


def unique_labels(labels):
    """Sorted nonzero label values present in a tensor, as numpy of its
    dtype (a bincount on its device where the labels are non-negative
    integers)."""
    labels = torch.as_tensor(labels)
    dtype = torch.empty((), dtype=labels.dtype).numpy().dtype
    if labels.numel() == 0:
        return np.empty(0, dtype=dtype)
    if not labels.is_floating_point() and int(labels.min()) >= 0:
        present = torch.nonzero(torch.bincount(labels.reshape(-1).long())).squeeze(1)
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


def remap_labels(labels, locations=None, new_labels=None):
    """Keep and renumber the labels flagged in ``locations`` (a bool per
    label 1..max, or label values) and zero the rest."""
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
    lut = torch.from_numpy(remapper).to(labels.device, labels.dtype)
    return lut[labels.long()]


def slice_labels(labels):
    """Split labels along the leading (time) axis: each label's pixels at
    one step share one id even where disconnected; ids run 1..N in step,
    then label order."""
    fg = labels > 0
    step_max = labels.reshape(labels.shape[0], -1).amax(dim=1).clamp(min=0).to(torch.int64)
    offsets = torch.cumsum(step_max, 0) - step_max
    keys = (labels.to(torch.int64) + offsets.view(-1, *([1] * (labels.dim() - 1))))[fg]
    return _sequential(keys, fg, labels.shape)


def make_step_labels(labels):
    """Split a label raster into per-step labels: each (connected region in
    one frame, label) gets its own id, numbered in (region, label) order."""
    step = flat_label(labels != 0)
    fg = step > 0
    keys = step[fg].to(torch.int64) * (int(labels.max()) + 1) + labels[fg].to(torch.int64)
    return _sequential(keys, fg, labels.shape)


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
        field_vals = field.broadcast_to(labels.shape).reshape(-1)[pos].cpu().numpy()
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
