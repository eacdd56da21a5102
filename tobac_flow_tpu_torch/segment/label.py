"""Flow-aware labelling: connected components tracked in the moving frame
(counterpart of ``tobac_flow_tpu/segment/label.py``).

1. Per-frame connected components on the device (``ops.ccl``).
2. The label raster warped one step forward and backward along the flow
   (nearest taps of the t±1 centre, fill 0), on the device.
3. The (label, warped label) pair histogram of both directions: int64
   keys counted on the device; only the unique pairs and their counts come
   to the host.  Over the device budget, steps 2-3 run per time chunk
   (one halo frame each side for the t±1 warp) and the chunks'
   histograms are summed, as the reference's
   ``_overlap_pair_hists_device`` does; the final lookup is applied a
   chunk at a time.
4. Pairs that pass the absolute (strictly greater) and proportional
   (≥ overlap × the smaller label's size) thresholds join one object: the
   undirected graph's connected components (scipy, one node per label),
   numbered by each group's smallest member label.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sparse
import scipy.sparse.csgraph as csgraph
import torch

from tobac_flow_tpu_torch.device import LINK_BYTES_PER_PX, chunk_plan, time_chunks
from tobac_flow_tpu_torch.ops.ccl import flat_label
from tobac_flow_tpu_torch.ops.convolve import DEFAULT_STRUCTURE, _convolve_impl, structure_taps

__all__ = ["flow_label", "flow_link_overlap", "link_labels_by_overlap"]


def _label_struct_taps(structure):
    """``structure`` with its same-time plane cleared: the t±1 planes must
    each carry the centre tap alone."""
    structure = np.asarray(structure)
    label_struct = structure * np.array([1, 0, 1])[:, np.newaxis, np.newaxis]
    if (np.count_nonzero(label_struct[0]) != 1 or np.count_nonzero(label_struct[2]) != 1):
        raise ValueError("structure must have exactly the centre tap in its temporal planes")
    return label_struct


def _pair_hist(labels, warped, nplus1):
    """Unique foreground (label, warped label) keys ``a * nplus1 + b`` and
    their pixel counts, on the host."""
    a = labels.to(torch.int64)
    b = warped.to(torch.int64)
    keys = (a * nplus1 + b)[(a > 0) & (b > 0)]
    uniq, counts = torch.unique(keys, return_counts=True)
    return uniq.cpu().numpy(), counts.cpu().numpy()


def _sum_hists(parts):
    """The union of per-chunk (keys, counts) histograms, counts summed."""
    keys = np.concatenate([k for k, _ in parts])
    counts = np.concatenate([c for _, c in parts]).astype(np.int64)
    uniq, inverse = np.unique(keys, return_inverse=True)
    total = np.zeros(uniq.size, dtype=np.int64)
    np.add.at(total, inverse, counts)
    return uniq, total


def _support_chunk(labels, budget_bytes):
    # two bool volumes and their compare
    return chunk_plan("support", labels.shape, 3, labels.device, budget_bytes)


def _same_support(a, b, chunk):
    """Are the nonzero pixels of the (T, ...) tensors ``a`` and ``b`` the
    same?  Compared ``chunk`` frames at a time on ``a``'s device."""
    return all(torch.equal(a[s:e] != 0, b[s:e].to(a.device) != 0)
               for s, e, _, _ in time_chunks(a.shape[0], chunk))


def _edges_from_hist(keys, counts, sizes, overlap, absolute_overlap):
    n = sizes.size
    ua = keys // n
    ub = keys % n
    min_size = np.minimum(sizes[ua], sizes[ub])
    ok = (counts > absolute_overlap) & (counts >= overlap * min_size)
    return np.stack([ua[ok], ub[ok]], axis=-1)


def link_labels_by_overlap(flow, flat_labels, structure=DEFAULT_STRUCTURE,
                           dtype=torch.int32, overlap: float = 0.0,
                           absolute_overlap: int = 0, budget_bytes=None):
    """Merge per-frame labels into tracked objects by their warped overlap;
    linked groups share one id, numbered by each group's smallest original
    label.  ``flat_labels`` may wait on the host; the result is on the
    flow's device.  Over ``budget_bytes`` (``None``:
    ``device.memory_budget``, no chunks on the CPU) in time chunks."""
    dev = flow.device
    flat_labels = torch.as_tensor(flat_labels)
    t = flat_labels.shape[0]
    chunk = chunk_plan("link_labels_by_overlap", flat_labels.shape, LINK_BYTES_PER_PX, dev,
                       budget_bytes, 1, torch.empty((), dtype=dtype).element_size())
    n_labels = int(flat_labels.max()) if flat_labels.numel() else 0
    if n_labels == 0:
        return torch.zeros(flat_labels.shape, dtype=dtype, device=dev)
    nplus1 = n_labels + 1
    taps = structure_taps(_label_struct_taps(structure))
    sizes = torch.zeros(nplus1, dtype=torch.int64, device=dev)
    hists = ([], [])  # forward-warped, then backward-warped
    for s, e, lo, hi in time_chunks(t, chunk, 1):
        lab = flat_labels[lo:hi].to(dev, torch.int32)
        warped = _convolve_impl(lab, flow.forward_flow[lo:hi], flow.backward_flow[lo:hi],
                                taps, "nearest", 0, None, 0)
        inner = lab[s - lo:e - lo]
        sizes += torch.bincount(inner.reshape(-1).long(), minlength=nplus1)
        for hist, d in zip(hists, (1, 0)):
            hist.append(_pair_hist(inner, warped[d, s - lo:e - lo], nplus1))
        del lab, warped, inner
    sizes = sizes.cpu().numpy()
    edges = np.concatenate([
        _edges_from_hist(*_sum_hists(hist), sizes, overlap, absolute_overlap)
        for hist in hists
    ])
    graph = sparse.coo_matrix(
        (np.ones(len(edges), dtype=np.int8), (edges[:, 0], edges[:, 1])),
        shape=(nplus1, nplus1),
    )
    _, comp = csgraph.connected_components(graph, directed=False)
    n_comp = int(comp.max()) + 1
    first_member = np.full(n_comp, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(first_member, comp[1:], np.arange(1, nplus1))
    active = first_member != np.iinfo(np.int64).max
    new_id = np.zeros(n_comp, dtype=np.int64)
    new_id[active] = np.argsort(np.argsort(first_member[active], kind="stable")) + 1
    lut = np.zeros(nplus1, dtype=np.int64)
    lut[1:] = new_id[comp[1:]]
    lut = torch.from_numpy(lut).to(dev, dtype)
    out = torch.empty(flat_labels.shape, dtype=dtype, device=dev)
    for s, e, _, _ in time_chunks(t, chunk):
        out[s:e] = lut[flat_labels[s:e].to(dev).long()]
    return out


def flow_label(flow, mask, structure=DEFAULT_STRUCTURE, dtype=torch.int32,
               overlap: float = 0.0, absolute_overlap: int = 0,
               subsegment_shrink: float = 0.0, peak_min_distance: int = 10,
               budget_bytes=None):
    """Label 3d connected objects in the moving frame: per-frame components
    of ``mask`` (with ``subsegment_shrink`` != 0, its per-frame
    morphological subsegments, ``segment.subsegment.subsegment_labels``),
    linked by warped overlap."""
    mask = torch.as_tensor(mask)
    if subsegment_shrink == 0:
        flat = flat_label(mask, structure=structure, device=flow.device,
                          budget_bytes=budget_bytes)
    else:
        from tobac_flow_tpu_torch.segment.subsegment import subsegment_labels

        flat = subsegment_labels(mask, shrink_factor=subsegment_shrink,
                                 peak_min_distance=peak_min_distance, device=flow.device,
                                 budget_bytes=budget_bytes)
    new_labels = link_labels_by_overlap(
        flow, flat, structure=structure, dtype=dtype, overlap=overlap,
        absolute_overlap=absolute_overlap, budget_bytes=budget_bytes,
    )
    del flat
    if not _same_support(new_labels, mask, _support_chunk(new_labels, budget_bytes)):
        warnings.warn("Not all regions present in labeled array", RuntimeWarning)
    return new_labels


def flow_link_overlap(flow, flat_labels, structure=DEFAULT_STRUCTURE, dtype=torch.int32,
                      overlap: float = 0.0, absolute_overlap: int = 0, budget_bytes=None):
    """Link an existing label raster into contiguous objects."""
    flat_labels = torch.as_tensor(flat_labels)
    new_labels = link_labels_by_overlap(flow, flat_labels, structure=structure, dtype=dtype,
                                        overlap=overlap, absolute_overlap=absolute_overlap,
                                        budget_bytes=budget_bytes)
    if not _same_support(new_labels, flat_labels, _support_chunk(new_labels, budget_bytes)):
        warnings.warn("Not all regions present in labeled array", RuntimeWarning)
    return new_labels
