"""Flow-aware labelling: connected components tracked in the moving frame
(counterpart of ``tobac_flow_tpu/segment/label.py``).

1. Per-frame connected components on the device (``ops.ccl``).
2. The label raster warped one step forward and backward along the flow
   (nearest taps of the t±1 centre, fill 0), on the device.
3. The (label, warped label) pair histogram of both directions: int64
   keys counted on the device; only the unique pairs and their counts come
   to the host.
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

from tobac_flow_tpu_torch.ops.ccl import flat_label
from tobac_flow_tpu_torch.ops.convolve import DEFAULT_STRUCTURE, convolve

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


def _edges_from_hist(keys, counts, sizes, overlap, absolute_overlap):
    n = sizes.size
    ua = keys // n
    ub = keys % n
    min_size = np.minimum(sizes[ua], sizes[ub])
    ok = (counts > absolute_overlap) & (counts >= overlap * min_size)
    return np.stack([ua[ok], ub[ok]], axis=-1)


def link_labels_by_overlap(flow, flat_labels, structure=DEFAULT_STRUCTURE,
                           dtype=torch.int32, overlap: float = 0.0,
                           absolute_overlap: int = 0):
    """Merge per-frame labels into tracked objects by their warped overlap;
    linked groups share one id, numbered by each group's smallest original
    label."""
    flat_labels = flow.tensor(flat_labels, torch.int32)
    n_labels = int(flat_labels.max())
    if n_labels == 0:
        return torch.zeros(flat_labels.shape, dtype=dtype, device=flat_labels.device)
    sizes = torch.bincount(flat_labels.reshape(-1).long(), minlength=n_labels + 1)
    sizes = sizes.cpu().numpy().astype(np.int64)
    warped = convolve(flat_labels, flow.forward_flow, flow.backward_flow,
                      structure=_label_struct_taps(structure), method="nearest",
                      dtype=torch.int32, fill_value=0)
    edges = np.concatenate([
        _edges_from_hist(*_pair_hist(flat_labels, warped[d], n_labels + 1), sizes,
                         overlap, absolute_overlap)
        for d in (1, 0)  # forward-warped, then backward-warped
    ])
    graph = sparse.coo_matrix(
        (np.ones(len(edges), dtype=np.int8), (edges[:, 0], edges[:, 1])),
        shape=(n_labels + 1, n_labels + 1),
    )
    _, comp = csgraph.connected_components(graph, directed=False)
    n_comp = int(comp.max()) + 1
    first_member = np.full(n_comp, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(first_member, comp[1:], np.arange(1, n_labels + 1))
    active = first_member != np.iinfo(np.int64).max
    new_id = np.zeros(n_comp, dtype=np.int64)
    new_id[active] = np.argsort(np.argsort(first_member[active], kind="stable")) + 1
    lut = np.zeros(n_labels + 1, dtype=np.int64)
    lut[1:] = new_id[comp[1:]]
    return torch.from_numpy(lut).to(flat_labels.device, dtype)[flat_labels.long()]


def flow_label(flow, mask, structure=DEFAULT_STRUCTURE, dtype=torch.int32,
               overlap: float = 0.0, absolute_overlap: int = 0,
               subsegment_shrink: float = 0.0, peak_min_distance: int = 10):
    """Label 3d connected objects in the moving frame: per-frame components
    of ``mask``, linked by warped overlap."""
    if subsegment_shrink != 0:
        raise NotImplementedError(
            "subsegment_shrink > 0 needs segment/subsegment.py, which is not ported yet"
        )
    mask = flow.tensor(mask) != 0
    new_labels = link_labels_by_overlap(
        flow, flat_label(mask, structure=structure), structure=structure, dtype=dtype,
        overlap=overlap, absolute_overlap=absolute_overlap,
    )
    if not torch.equal(new_labels != 0, mask):
        warnings.warn("Not all regions present in labeled array", RuntimeWarning)
    return new_labels


def flow_link_overlap(flow, flat_labels, structure=DEFAULT_STRUCTURE, dtype=torch.int32,
                      overlap: float = 0.0, absolute_overlap: int = 0):
    """Link an existing label raster into contiguous objects."""
    flat_labels = flow.tensor(flat_labels)
    new_labels = link_labels_by_overlap(flow, flat_labels, structure=structure, dtype=dtype,
                                        overlap=overlap, absolute_overlap=absolute_overlap)
    if not torch.equal(new_labels != 0, flat_labels != 0):
        warnings.warn("Not all regions present in labeled array", RuntimeWarning)
    return new_labels
