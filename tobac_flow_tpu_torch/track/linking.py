"""Cross-file label linking (counterpart of
``tobac_flow_tpu/track/linking.py``): the overlap of two detection files'
labels over their shared interior frames, the global overlap graph over
every file's labels, and each file's labels remapped to the linked ids.

The label volumes may lie on the card or wait on the host; every pass
over them runs on ``device`` (CUDA unless the caller asks for the CPU),
a chunk of frames at a time where the frames it reads exceed the budget
(``budget_bytes``; ``None`` means ``device.memory_budget``, no chunks on
the CPU): the pair histogram of the shared interior (per-chunk
histograms summed) and the per-label pixel counts that its thresholds
read.  The graph and the per-file maps are small and stay on the host
(scipy ``csgraph``).  Only ``find_overlap_between_files`` and
``relabel_file`` read files, through a store (``track.store``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sparse
import scipy.sparse.csgraph as csgraph
import torch

from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, as_tensor
from tobac_flow_tpu_torch.device import (
    LABEL_TABLE_BYTES_PER_PX, OVERLAP_BYTES_PER_PX, chunk_plan, resolve_device, time_chunks,
)
from tobac_flow_tpu_torch.track.store import NetCDFStore
from tobac_flow_tpu_torch.utils.labels import remap_labels, unique_labels

__all__ = [
    "find_overlap_between_labels",
    "find_overlap_between_files",
    "process_linking_output",
    "relabel_dataset",
    "relabel_file",
    "link_labels",
]

LABEL_VARS = ("core_label", "thick_anvil_label", "thin_anvil_label")


def _times(t):
    return np.asarray(getattr(t, "values", t))


def _frames_index(vol, frames, s, e):
    """Frames ``frames[s:e]`` of ``vol`` as an index: a slice where they
    are consecutive, else a tensor on ``vol``'s device."""
    idx = np.asarray(frames[s:e])
    if idx.size and np.array_equal(idx, np.arange(idx[0], idx[0] + idx.size)):
        return slice(int(idx[0]), int(idx[0]) + idx.size)
    return torch.as_tensor(idx, dtype=torch.long, device=vol.device)


def take_frames(vol, frames, s, e, device):
    """Frames ``frames[s:e]`` (indices into the first axis of the tensor
    ``vol``) on ``device``."""
    return vol[_frames_index(vol, frames, s, e)].to(device)


def put_frames(vol, frames, s, e, value):
    """Write ``value`` into frames ``frames[s:e]`` of the tensor ``vol``,
    where ``vol`` lies."""
    vol[_frames_index(vol, frames, s, e)] = value.to(vol.device, vol.dtype)


def frame_chunks(what, vol, frames, bytes_per_px, device, budget_bytes=None):
    """(s, e) of the time chunks over the frames ``frames`` of ``vol``
    (all of them where ``None``) that a pass of ``bytes_per_px`` runs
    in (``device.chunk_plan``)."""
    n = vol.shape[0] if frames is None else len(frames)
    if n == 0:
        return []
    chunk = chunk_plan(what, (n,) + tuple(vol.shape[1:]), bytes_per_px, device, budget_bytes)
    return [(s, e) for s, e, _, _ in time_chunks(n, chunk)]


def volume_max(vol, device, budget_bytes=None) -> int:
    """The largest value of the tensor ``vol``: where it lies if that is
    ``device``, else a chunk of frames at a time moved there."""
    device = torch.device(device)
    if vol.device.type == device.type:
        return int(vol.max())
    frames = np.arange(vol.shape[0])
    # a chunk's copy on the device, 4 bytes a pixel
    return max(int(take_frames(vol, frames, s, e, device).max())
               for s, e in frame_chunks("volume_max", vol, frames, 4, device, budget_bytes))


def unique_frames(vol, frames, device, budget_bytes=None, what="unique_frames"):
    """Sorted nonzero values of the frames ``frames`` of ``vol`` (all
    where ``None``), as numpy int64, counted a chunk at a time on
    ``device``."""
    all_frames = np.arange(vol.shape[0]) if frames is None else np.asarray(frames)
    if all_frames.size == 0:
        return np.empty(0, np.int64)
    found = [unique_labels(take_frames(vol, all_frames, s, e, device), budget_bytes)
             for s, e in frame_chunks(what, vol, all_frames, LABEL_TABLE_BYTES_PER_PX, device,
                                      budget_bytes)]
    return np.unique(np.concatenate(found).astype(np.int64))


def _pair_counts(pairs, max_a, max_b, device):
    """The histogram of foreground (a, b) pairs and the per-label pixel
    counts (background included) of the chunks ``pairs`` yields, each a
    pair of flat int64 tensors: (keys ``a * (max_b + 1) + b``, their
    counts, a's counts, b's counts), on ``device``."""
    a_counts = torch.zeros(max_a + 1, dtype=torch.int64, device=device)
    b_counts = torch.zeros(max_b + 1, dtype=torch.int64, device=device)
    keys, counts = [], []
    for a, b in pairs:
        a_counts += torch.bincount(a, minlength=max_a + 1)
        b_counts += torch.bincount(b, minlength=max_b + 1)
        wh = (a > 0) & (b > 0)
        k, n = torch.unique(a[wh] * (max_b + 1) + b[wh], return_counts=True)
        keys.append(k)
        counts.append(n)
        del a, b, wh
    keys = torch.cat(keys) if keys else torch.empty(0, dtype=torch.int64, device=device)
    counts = torch.cat(counts) if counts else torch.empty(0, dtype=torch.int64, device=device)
    uniq, inverse = torch.unique(keys, return_inverse=True)
    total = torch.zeros(uniq.numel(), dtype=torch.int64, device=device).index_add_(
        0, inverse, counts)
    return uniq, total, a_counts, b_counts


def _edges(uniq, counts, a_counts, b_counts, max_b, atol, rtol):
    """The (a, b) pairs whose overlap passes ``counts >= atol`` and the
    larger of its shares of a's and of b's pixels ``>= rtol``, as
    numpy int64."""
    ua, ub = uniq // (max_b + 1), uniq % (max_b + 1)
    share = counts.double()
    frac = torch.maximum(share / a_counts[ua].clamp(min=1).double(),
                         share / b_counts[ub].clamp(min=1).double())
    ok = (counts >= atol) & (frac >= rtol)
    return ua[ok].cpu().numpy(), ub[ok].cpu().numpy()


def link_labels(labels_a, labels_b, atol=0, rtol=0.0, device=None, budget_bytes=None):
    """Transitive overlap closure between two co-located label arrays:
    (groups_a, groups_b), where linked labels share a group id.  The pair
    histogram runs on ``device`` (CUDA by default), in chunks of the
    flattened arrays where the budget calls for them."""
    dev = resolve_device(device)
    a = as_tensor(labels_a).reshape(-1)
    b = as_tensor(labels_b).reshape(-1)
    max_a = volume_max(a, dev) if a.numel() else 0
    max_b = volume_max(b, dev) if b.numel() else 0
    chunk = chunk_plan("link_labels", (a.numel(),), OVERLAP_BYTES_PER_PX, dev, budget_bytes)
    pairs = ((a[s:e].to(dev, torch.int64), b[s:e].to(dev, torch.int64))
             for s, e, _, _ in time_chunks(a.numel(), chunk))
    x, y = _edges(*_pair_counts(pairs, max_a, max_b, dev), max_b, max(atol, 1), rtol)
    n = max_a + max_b + 1
    graph = sparse.coo_matrix((np.ones(x.size), (x, y + max_a)), shape=(n, n))
    comp = csgraph.connected_components(graph, directed=False)[1]
    return comp[1 : max_a + 1], comp[max_a + 1 :]


def find_overlap_between_labels(cur_labels, cur_times, next_labels, next_times, atol=5,
                                rtol=0.5, device=None, budget_bytes=None):
    """Linked (a, b) label pairs over the shared interior time window: the
    shared frames less the first and last, none where at most 2 frames
    are shared.  A pair links when its overlap count is ``>= atol`` and
    the larger of its shares of a's and of b's pixels in the window
    (background included in neither) is ``>= rtol``.  Returns (max_a,
    max_b, x, y), the largest label of each volume and the linked pairs
    as numpy int64.

    The labels (DataArrays, tensors or arrays) stay where they lie; the
    histogram runs on ``device`` (CUDA by default) a chunk of interior
    frames at a time (``OVERLAP_BYTES_PER_PX``), the chunks' histograms
    and pixel counts summed."""
    dev = resolve_device(device)
    cur, nxt = as_tensor(cur_labels), as_tensor(next_labels)
    max_a = volume_max(cur, dev, budget_bytes)
    max_b = volume_max(nxt, dev, budget_bytes)
    none = np.empty(0, np.int64)
    shared, ci, ni = np.intersect1d(_times(cur_times), _times(next_times), return_indices=True)
    if shared.size <= 2:
        return max_a, max_b, none, none
    ci, ni = ci[1:-1], ni[1:-1]
    pairs = ((take_frames(cur, ci, s, e, dev).reshape(-1).long(),
              take_frames(nxt, ni, s, e, dev).reshape(-1).long())
             for s, e in frame_chunks("find_overlap_between_labels", cur, ci,
                                      OVERLAP_BYTES_PER_PX, dev, budget_bytes))
    uniq, counts, a_counts, b_counts = _pair_counts(pairs, max_a, max_b, dev)
    if uniq.numel() == 0:
        return max_a, max_b, none, none
    x, y = _edges(uniq, counts, a_counts, b_counts, max_b, atol, rtol)
    return max_a, max_b, x, y


def find_overlap_between_files(filename_1, filename_2, atol=5, rtol=0.5, device=None,
                               budget_bytes=None, store=None):
    """Core and anvil overlap edges between two consecutive detection
    files (read through ``store``, netCDF files by default)."""
    store = NetCDFStore() if store is None else store
    ds_1 = store.open(filename_1)
    ds_2 = store.open(filename_2)
    result = dict(filename_1=str(filename_1), filename_2=str(filename_2))
    for key, var in (("core", "core_label"), ("anvil", "thick_anvil_label")):
        result[key] = find_overlap_between_labels(
            ds_1[var], ds_1.coords["t"], ds_2[var], ds_2.coords["t"], atol=atol, rtol=rtol,
            device=device, budget_bytes=budget_bytes,
        )
    return result


def _resolve(results, key):
    """Global connected components over the files' label spaces, numbered
    1.. in order of each component's first node (node 0, the background,
    keeps 0)."""
    starts = np.cumsum([0] + [r[key][0] for r in results]).astype(np.int64)
    total = int(starts[-1] + results[-1][key][1])
    xs = [r[key][2] + start for r, start in zip(results, starts)]
    ys = [r[key][3] + start for r, start in zip(results, starts[1:])]
    x = np.concatenate(xs) if xs else np.empty(0, np.int64)
    y = np.concatenate(ys) if ys else np.empty(0, np.int64)
    graph = sparse.coo_matrix((np.ones(x.size), (x, y)), shape=(total + 1, total + 1))
    comp = csgraph.connected_components(graph, directed=False)[1]
    new = np.zeros(comp.size, dtype=np.int64)
    nodes = comp[1:]
    found, first = np.unique(nodes, return_index=True)
    rank = np.empty(found.size, dtype=np.int64)
    rank[np.argsort(first)] = np.arange(1, found.size + 1)
    new[1:] = rank[np.searchsorted(found, nodes)]
    return starts, new


def process_linking_output(overlap_results):
    """Resolve the global overlap graph into per-file relabel maps: a
    links Dataset with filename-indexed start offsets and the global core
    and anvil label maps."""
    filenames = [r["filename_1"] for r in overlap_results] + [
        overlap_results[-1]["filename_2"]
    ]
    core_starts, core_labels = _resolve(overlap_results, "core")
    anvil_starts, anvil_labels = _resolve(overlap_results, "anvil")

    ds = Dataset(coords={"filename": np.asarray(filenames, dtype=object)})
    ds["previous_filename"] = DataArray(
        np.asarray([""] + filenames[:-1], dtype=object), dims=("filename",)
    )
    ds["next_filename"] = DataArray(
        np.asarray(filenames[1:] + [""], dtype=object), dims=("filename",)
    )
    ds["core_start"] = DataArray(core_starts.astype(np.int64), dims=("filename",))
    ds["anvil_start"] = DataArray(anvil_starts.astype(np.int64), dims=("filename",))
    ds["core_labels"] = DataArray(core_labels[1:].astype(np.int32), dims=("core",))
    ds["anvil_labels"] = DataArray(anvil_labels[1:].astype(np.int32), dims=("anvil",))
    return ds


def _label_map_for_file(links_ds, file_index, key):
    starts = np.asarray(links_ds[f"{key}_start"].values)
    labels = np.asarray(links_ds[f"{key}_labels"].values)
    start = starts[file_index]
    stop = starts[file_index + 1] if file_index + 1 < starts.size else labels.size
    return labels[start:stop]


def relabel_dataset(ds, links_ds, filename, device=None, budget_bytes=None):
    """Apply the global label maps of ``links_ds`` to the detection
    dataset of ``filename`` in place: its core and anvil volumes remapped
    to the linked ids on ``device`` (CUDA by default; ``remap_labels`` a
    chunk at a time), and its ``core`` and ``anvil`` coordinates and
    ``core_anvil_index`` (on the host) with them, duplicates kept where
    labels merged."""
    dev = resolve_device(device)
    filenames = [str(f) for f in np.asarray(links_ds.coords["filename"])]
    file_index = filenames.index(str(filename))
    core_map = _label_map_for_file(links_ds, file_index, "core")
    anvil_map = _label_map_for_file(links_ds, file_index, "anvil")

    for var, mapping in zip(LABEL_VARS, (core_map, anvil_map, anvil_map)):
        if var in ds.data_vars:
            vals = as_tensor(ds[var], dev)
            ds[var].data = remap_labels(vals, locations=np.arange(1, mapping.size + 1),
                                        new_labels=mapping, budget_bytes=budget_bytes)
    for dim, mapping in [("core", core_map), ("anvil", anvil_map)]:
        if dim in ds.coords:
            old = ds.coords[dim]
            valid = (old >= 1) & (old <= mapping.size)
            ds.coords[dim] = np.where(valid, mapping[np.maximum(old, 1) - 1], old)
    if "core_anvil_index" in ds.data_vars:
        idx = np.asarray(ds["core_anvil_index"].values)
        valid = (idx >= 1) & (idx <= anvil_map.size)
        ds["core_anvil_index"].values = np.where(
            valid, anvil_map[np.maximum(idx, 1) - 1], 0).astype(idx.dtype)
    return ds


def relabel_file(filename, links_ds, save_path=None, device=None, budget_bytes=None,
                 store=None):
    """:func:`relabel_dataset` on one detection file read through
    ``store`` (netCDF files by default), written to ``save_path`` where
    given; returns the dataset."""
    store = NetCDFStore() if store is None else store
    ds = relabel_dataset(store.open(filename), links_ds, filename, device, budget_bytes)
    if save_path is not None:
        store.save(ds, save_path)
    return ds
