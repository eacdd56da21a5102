"""Streaming cross-file linkers (counterpart of
``tobac_flow_tpu/track/file_linker.py``), with the same outputs.

* ``FileLinker``: a streaming two-file linker.  Only the current and next
  datasets are resident; each step offsets the next file's labels above a
  running maximum, links the pair over the shared interior frames,
  transfers interior pixels both ways (less the "stub" labels), then
  finalises and writes the current file before it advances.
* ``LabelLinker``: one global label map per label family, updated per
  file pair with min-label pointers and resolved by pointer convergence
  (``map = map[map]``, at most ``max_convergence_iterations`` times), then
  a second streaming pass that relabels, merges and writes each file.

Where the data lies: each dataset's three label volumes move to ``device``
(CUDA unless the caller asks for the CPU) when it is opened, or wait on
the host (pinned) where the card's budget does not hold them
(``device.place``); the other variables (BT) stay on the host, and the
NaN flags read them a chunk at a time.  Before a file's output passes the
other resident dataset's volumes, which those passes do not read, move to
the host as far as the passes need the room (``device.park``).  Every
pass over a volume runs on ``device`` in time chunks where the frames it
reads exceed the budget (``budget_bytes``; ``None`` means
``device.memory_budget`` at the pass's start, no chunks on the CPU):
offsets, maxima and uniques, the pair histogram, the label lookups, the
interior merges and the output schema passes (``schema.dataset``).  The
label maps, link groups and graphs are per label and stay on the host.

Files are read and written through a store (``track.store``): netCDF
files by default, or datasets in memory.  Each pass is timed in
``passes``.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from datetime import datetime
from pathlib import Path

import numpy as np
import scipy.sparse as sparse
import scipy.sparse.csgraph as csgraph
import torch

from tobac_flow_tpu_torch.data.ncdataset import as_tensor
from tobac_flow_tpu_torch.device import (
    LABEL_TABLE_BYTES_PER_PX, MERGE_BYTES_PER_PX, RELABEL_BYTES_PER_PX, memory_budget, park,
    place, resolve_device, stage,
)
from tobac_flow_tpu_torch.schema.dataset import (
    add_label_coords,
    add_step_labels,
    flag_edge_labels,
    flag_nan_adjacent_labels,
    link_step_labels,
)
from tobac_flow_tpu_torch.track.linking import (
    LABEL_VARS, find_overlap_between_labels, frame_chunks, put_frames, take_frames,
    unique_frames, volume_max,
)
from tobac_flow_tpu_torch.track.store import NetCDFStore
from tobac_flow_tpu_torch.utils.datetime_utils import (
    get_dates_from_filename,
    trim_file_start_and_end,
)

__all__ = ["FileLinker", "LabelLinker"]

_KEEP_VARS = (
    "goes_imager_projection",
    "lat",
    "lon",
    "area",
    "BT",
    "bt",
    "WVD",
    "wvd",
    "SWD",
    "swd",
    "core_label",
    "thick_anvil_label",
    "thin_anvil_label",
)
STEP_VARS = ("core_step_label", "thick_anvil_step_label", "thin_anvil_step_label")


def _shared_time_indices(cur_times, next_times):
    return np.intersect1d(np.asarray(cur_times), np.asarray(next_times), return_indices=True)


def _map_frames(what, vol, frames, fn, device, budget_bytes, bytes_per_px=RELABEL_BYTES_PER_PX):
    """``vol``'s frames ``frames`` (all where ``None``) replaced by ``fn``
    of themselves, a chunk at a time on ``device``, in place where ``vol``
    lies."""
    frames = np.arange(vol.shape[0]) if frames is None else np.asarray(frames)
    for s, e in frame_chunks(what, vol, frames, bytes_per_px, device, budget_bytes):
        put_frames(vol, frames, s, e, fn(take_frames(vol, frames, s, e, device)))


def _lookup(table, device):
    """A label lookup table (numpy, one entry per label) on ``device``."""
    return torch.as_tensor(np.asarray(table, dtype=np.int64), device=device)


def _flags(labels, device):
    """A bool per label 0..max(labels), set at ``labels``, on ``device``."""
    flag = torch.zeros(max(labels) + 1, dtype=torch.bool, device=device)
    flag[torch.as_tensor(sorted(labels), dtype=torch.long, device=device)] = True
    return flag


def _interior_merge(what, vals, vi, other, oi, combine, lut, device, budget_bytes):
    """``vals[vi] += other'[oi] * (other'[oi] in combine & vals[vi] == 0)``
    a chunk of the interior frames at a time on ``device``, where
    ``other'`` is ``lut[other]`` (``other`` where ``lut`` is None), in
    place where ``vals`` lies (int32 adds, as the reference's)."""
    if not combine:
        return
    flag = _flags(combine, device)
    n = flag.numel()
    for s, e in frame_chunks(what, vals, vi, MERGE_BYTES_PER_PX, device, budget_bytes):
        cur = take_frames(vals, vi, s, e, device)
        add = take_frames(other, oi, s, e, device)
        if lut is not None:
            add = lut[add.long()].to(cur.dtype)
        idx = add.long()
        wh = (cur == 0) & (idx < n) & flag[idx.clamp_(max=n - 1)]
        put_frames(vals, vi, s, e, cur + add * wh)
        del cur, add, idx, wh


class _Linker:
    """What both linkers share: the device, the budget, the store, the
    residency of the label volumes and the pass log, ``passes``: one dict
    per pass run, with ``pass`` (its name), ``file``, ``seconds`` (the
    device synchronised at its end), ``chunks`` (the most chunks of one
    of its steps; 1 where nothing was chunked) and ``linked`` (link
    groups, where the pass links); on CUDA also ``start_bytes`` and
    ``peak_bytes`` (allocated at its start, and the most during it) and
    ``budget_bytes`` (``device.memory_budget`` at its start, or the
    budget it was given)."""

    def __init__(self, files, output_path, device, budget_bytes, store):
        self.device = resolve_device(device)
        self.budget_bytes = budget_bytes
        self.store = NetCDFStore() if store is None else store
        self.files = [Path(f) for f in files]
        for f in self.files:
            if not self.store.exists(f):
                raise ValueError(f"File {f} does not exist")
        self.output_path = Path(output_path) if output_path is not None else None
        if self.output_path is not None:
            self.store.makedirs(self.output_path)
        self.passes = []
        self._file = None

    @contextmanager
    def _pass(self, name):
        """Time the body as the pass ``name`` into ``passes``; yields its
        record."""
        stats = {}
        record = {"pass": name, "file": self._file}
        if self.device.type == "cuda":
            record["budget_bytes"] = (memory_budget(self.device) if self.budget_bytes is None
                                      else self.budget_bytes)
        with stage(name, stats, self.device):
            yield record
        record["seconds"] = stats[f"{name}_s"]
        record["chunks"] = stats.get(f"{name}_chunks", 1)
        for key in ("start_bytes", "peak_bytes"):
            if f"{name}_{key}" in stats:
                record[key] = stats[f"{name}_{key}"]
        self.passes.append(record)

    def _open(self, path):
        """The dataset of ``path`` from the store, its label volumes on the
        device where the budget holds them."""
        self._file = Path(path).name
        with self._pass("open"):
            ds = self.store.open(path)
            for var in LABEL_VARS:
                if var in ds.data_vars:
                    ds[var].data = place(as_tensor(ds[var]), self.device)
        return ds

    def _save(self, ds, path):
        with self._pass("save"):
            self.store.save(ds, path)

    def _make_room(self, keep, others):
        """Park the label volumes of the datasets ``others`` on the host as
        far as the output passes over ``keep`` need the room, then move
        ``keep``'s label volumes to the device."""
        if self.device.type != "cuda":
            return
        vols = {(i, var): as_tensor(ds[var]) for i, ds in enumerate(others)
                for var in LABEL_VARS if var in ds.data_vars}
        t, px = keep["core_label"].shape[0], int(np.prod(keep["core_label"].shape[1:]))
        need = (3 * 4 + LABEL_TABLE_BYTES_PER_PX) * t * px
        for key in park(vols, (), self.device, need):
            others[key[0]][key[1]].data = vols[key]
        for var in LABEL_VARS:
            if var in keep.data_vars:
                keep[var].data = as_tensor(keep[var]).to(self.device)

    def _max(self, da):
        return volume_max(as_tensor(da), self.device, self.budget_bytes)

    def _output_path(self, file):
        parent = self.output_path if self.output_path is not None else Path(file).parent
        return parent / (Path(file).stem + self.file_suffix + ".nc")

    def _finalise(self, ds, start_date, end_date):
        """Drop the variables the output does not keep, add label
        coordinates and the edge and NaN flags, and trim to the file's own
        window; returns the trimmed dataset."""
        drop = [v for v in list(ds.data_vars) if v not in _KEEP_VARS]
        if drop:
            ds = ds.drop_vars(drop)
        with self._pass("label_coords"):
            ds = add_label_coords(ds, self.budget_bytes)
        with self._pass("edge_flags"):
            flag_edge_labels(ds, start_date, end_date)
        bt_name = "BT" if "BT" in ds.data_vars else ("bt" if "bt" in ds.data_vars else None)
        if bt_name is not None:
            with self._pass("nan_flags"):
                flag_nan_adjacent_labels(ds, ds[bt_name], self.budget_bytes)
        ds = trim_file_start_and_end(ds, start_date, end_date)
        with self._pass("label_coords"):
            ds = add_label_coords(ds, self.budget_bytes)
        return ds


class FileLinker(_Linker):
    """Stream consecutive detection files, linking labels across each pair
    with two datasets resident at most.

    ``files`` are paths (or names in ``store``); ``device`` (CUDA by
    default) runs every pass over the label volumes, within
    ``budget_bytes`` (see the module's text; ``device.frames_budget``
    forces chunks); ``store`` reads and writes the datasets (netCDF files
    by default, ``track.store.MemoryStore`` in memory)."""

    def __init__(self, files, output_path=None, atol=5, rtol=0.5, output_file_suffix=None,
                 output_func=None, device=None, budget_bytes=None, store=None):
        super().__init__(files, output_path, device, budget_bytes, store)
        self.atol = atol
        self.rtol = rtol
        suffix = output_file_suffix or "_linked"
        if not suffix.startswith("_"):
            suffix = "_" + suffix
        self.file_suffix = suffix
        self.output_func = output_func

        # running max-label state
        self.current_max_core_label = 0
        self.current_max_anvil_label = 0
        self.current_max_core_step_label = 0
        self.current_max_thick_anvil_step_label = 0
        self.current_max_thin_anvil_step_label = 0

        self._queue = list(self.files)
        self.current_filename = self._queue.pop(0)
        self.current_ds = self._open(self.current_filename)
        self.outputs: list[Path] = []
        # bounded-memory diagnostic: never exceeds 2 resident datasets
        self.open_datasets = 1
        self.max_open_datasets = 1

    # -- streaming loop ---------------------------------------------------

    def process_files(self) -> list[Path]:
        while self._queue:
            self.process_next_file()
        self.start_date, self.end_date = get_dates_from_filename(self.current_filename)
        self.output_current_ds()
        return self.outputs

    def process_next_file(self) -> None:
        self.next_filename = self._queue.pop(0)
        self.start_date, self.end_date = get_dates_from_filename(self.current_filename)
        self.next_ds = self._open(self.next_filename)
        self.open_datasets += 1
        self.max_open_datasets = max(self.max_open_datasets, self.open_datasets)
        self.relabel_next_ds()

        shared, _, _ = _shared_time_indices(
            self.current_ds.coords["t"], self.next_ds.coords["t"]
        )
        if shared.size > 2:
            self.relabel_cores()
            self.relabel_anvils()
        else:
            # no linkable overlap: roll the running maxima forward from the
            # current file's own window
            with self._pass("running_max"):
                trimmed = trim_file_start_and_end(self.current_ds, self.start_date,
                                                  self.end_date)
                self.current_max_core_label = max(
                    self._max(trimmed["core_label"]), self.current_max_core_label
                )
                self.current_max_anvil_label = max(
                    self._max(trimmed["thick_anvil_label"]),
                    self._max(trimmed["thin_anvil_label"]),
                    self.current_max_anvil_label,
                )

        self.output_current_ds()
        self.current_ds = self.next_ds
        self.current_filename = self.next_filename
        self.open_datasets -= 1

    # -- pair linking -----------------------------------------------------

    def relabel_next_ds(self) -> None:
        """Offset every label in next_ds above the running maxima, in place
        a chunk at a time on the device."""
        with self._pass("relabel_next_ds"):
            max_core = max(self.current_max_core_label,
                           self._max(self.current_ds["core_label"]))
            max_anvil = max(
                self.current_max_anvil_label,
                self._max(self.current_ds["thick_anvil_label"]),
                self._max(self.current_ds["thin_anvil_label"]),
            )
            for var, off in [
                ("core_label", max_core),
                ("thick_anvil_label", max_anvil),
                ("thin_anvil_label", max_anvil),
            ]:
                _map_frames("relabel_next_ds", as_tensor(self.next_ds[var]), None,
                            lambda v, off=off: torch.where(v != 0, v + off, v),
                            self.device, self.budget_bytes)

    def _label_map(self, groups, unique_labels, previous_max):
        """Contiguous linked label map: each group adopts its lowest
        current-file label; surviving labels above previous_max renumber
        contiguously."""
        max_label = int(unique_labels.max()) if unique_labels.size else 0
        label_map = np.zeros(max_label + 1, dtype=np.int64)
        label_map[unique_labels] = unique_labels
        for cur_group, next_group in groups:
            new_label = cur_group[0]
            for lbl in cur_group[1:]:
                label_map[lbl] = new_label
            for lbl in next_group:
                label_map[lbl] = new_label
        unique_mapped = np.unique(label_map)
        remapper = np.zeros(max_label + 1, dtype=np.int64)
        existing = unique_mapped[unique_mapped <= previous_max]
        remapper[existing] = existing
        new = unique_mapped[unique_mapped > previous_max]
        remapper[new] = np.arange(new.size) + previous_max + 1
        return remapper[label_map]

    def _relabel_family(self, variables, previous_max):
        """Link one label family across the pair and remap both datasets
        (the new running maximum from the current dataset alone)."""
        with self._pass("overlap") as record:
            groups = _pair_link_groups(
                self.current_ds[variables[0]], self.current_ds.coords["t"],
                self.next_ds[variables[0]], self.next_ds.coords["t"],
                self.atol, self.rtol, self.device, self.budget_bytes,
            )
            record["linked"] = len(groups)
        with self._pass("relabel_family"):
            found = {id(ds): [unique_frames(as_tensor(ds[var]), None, self.device,
                                            self.budget_bytes, "relabel_family")
                              for var in variables]
                     for ds in (self.current_ds, self.next_ds)}
            unique_labels = np.unique(np.concatenate(sum(found.values(), [])))
            if not unique_labels.size:
                return previous_max
            label_map = self._label_map(groups, unique_labels, previous_max)
            lut = _lookup(label_map, self.device)
            for ds in (self.current_ds, self.next_ds):
                for var in variables:
                    vol = as_tensor(ds[var])
                    _map_frames("relabel_family", vol, None,
                                lambda v: lut[v.long()].to(v.dtype), self.device,
                                self.budget_bytes)
            present = np.concatenate(found[id(self.current_ds)])
            return max([previous_max] + ([int(label_map[present].max())] if present.size
                                         else []))

    def relabel_cores(self) -> None:
        self.current_max_core_label = self._relabel_family(
            ("core_label",), self.current_max_core_label
        )
        self.combine_labels("core_label")

    def relabel_anvils(self) -> None:
        self.current_max_anvil_label = self._relabel_family(
            ("thick_anvil_label", "thin_anvil_label"), self.current_max_anvil_label
        )
        self.combine_labels("thick_anvil_label")
        self.combine_labels("thin_anvil_label")

    def combine_labels(self, var: str) -> None:
        """Transfer labels between the pair's interior windows: each side
        fills its zero pixels from the other's labels, less the "stubs" —
        labels that enter the window at the wrong end.  Next to current
        first; current to next then reads the updated current."""
        with self._pass("combine_labels"):
            shared, ci, ni = _shared_time_indices(
                self.current_ds.coords["t"], self.next_ds.coords["t"]
            )
            cur = as_tensor(self.current_ds[var])
            nxt = as_tensor(self.next_ds[var])

            def uniq(vol, frames):
                return set(unique_frames(vol, frames, self.device, self.budget_bytes,
                                         "combine_labels").tolist())

            # next -> current: next labels in the interior that don't start
            # at the first shared frame, or that already exist in current
            combine = (uniq(nxt, ni[1:-1]) - uniq(nxt, ni[[0]])) | uniq(cur, ci[:-1])
            _interior_merge("combine_labels", cur, ci[1:-1], nxt, ni[1:-1], combine, None,
                            self.device, self.budget_bytes)
            # current -> next: current labels that don't reach the last
            # shared frame, or that already exist in next
            combine = (uniq(cur, ci[1:-1]) - uniq(cur, ci[[-1]])) | uniq(nxt, ni[1:])
            _interior_merge("combine_labels", nxt, ni[1:-1], cur, ci[1:-1], combine, None,
                            self.device, self.budget_bytes)

    # -- per-file output ----------------------------------------------------

    def output_current_ds(self) -> None:
        """Finalise and write the current file: keep the raster variables,
        re-derive label coords and flags, trim to the file's own window,
        add step labels offset by the running step maxima, and save."""
        other = getattr(self, "next_ds", None)
        self._make_room(self.current_ds,
                        [other] if other is not None and other is not self.current_ds else [])
        self._file = self.current_filename.name
        ds = self._finalise(self.current_ds, self.start_date, self.end_date)

        with self._pass("step_labels"):
            add_step_labels(ds, self.budget_bytes)
            for var, attr in zip(STEP_VARS, ("current_max_core_step_label",
                                              "current_max_thick_anvil_step_label",
                                              "current_max_thin_anvil_step_label")):
                off = getattr(self, attr)
                _map_frames("step_labels", as_tensor(ds[var]), None,
                            lambda v, off=off: torch.where(v != 0, v + off, v),
                            self.device, self.budget_bytes)
        with self._pass("label_coords"):
            ds = add_label_coords(ds, self.budget_bytes)
        for coord, attr in [
            ("core_step", "current_max_core_step_label"),
            ("thick_anvil_step", "current_max_thick_anvil_step_label"),
            ("thin_anvil_step", "current_max_thin_anvil_step_label"),
        ]:
            if coord in ds.coords and len(ds.coords[coord]):
                setattr(self, attr, int(np.asarray(ds.coords[coord]).max()))
        with self._pass("link_step_labels"):
            link_step_labels(ds, self.budget_bytes)

        if self.output_func is not None:
            self.output_func(ds)

        new_filename = self._output_path(self.current_filename)
        self._save(ds, new_filename)
        self.outputs.append(new_filename)
        self.current_ds = ds


def _pair_link_groups(cur_labels, cur_times, next_labels, next_times, atol, rtol, device,
                      budget_bytes):
    """Transitive link groups between two label stacks over the shared
    interior frames: (sorted current labels, sorted next labels) per
    connected group that has at least one cross-file edge, in the order
    of the groups' component numbers."""
    max_a, max_b, x, y = find_overlap_between_labels(
        cur_labels, cur_times, next_labels, next_times, atol=atol, rtol=rtol, device=device,
        budget_bytes=budget_bytes,
    )
    if not x.size:
        return []
    n = max_a + max_b + 1
    graph = sparse.coo_matrix((np.ones(x.size), (x, y + max_a)), shape=(n, n))
    comp = csgraph.connected_components(graph, directed=False)[1]
    groups: dict[int, tuple[list, list]] = {}
    for a in np.unique(x):
        groups.setdefault(comp[a], ([], []))[0].append(int(a))
    for b in np.unique(y):
        groups.setdefault(comp[b + max_a], ([], []))[1].append(int(b))
    return [(sorted(g[0]), sorted(g[1])) for _, g in sorted(groups.items())]


class LabelLinker(_Linker):
    """Global label maps resolved by pointer convergence, two datasets
    resident at a time; ``device``, ``budget_bytes`` and ``store`` as
    :class:`FileLinker`'s."""

    def __init__(self, files, max_convergence_iterations: int = 10, output_path=None,
                 output_file_suffix: str = "", atol: int = 1, rtol: float = 0.0, device=None,
                 budget_bytes=None, store=None):
        super().__init__(files, output_path, device, budget_bytes, store)
        self.file_suffix = output_file_suffix or "_linked"
        if not self.file_suffix.startswith("_"):
            self.file_suffix = "_" + self.file_suffix
        self.atol = atol
        self.rtol = rtol
        self.max_convergence_iterations = max_convergence_iterations

        self.next_ds = self._open(self.files[0])
        self.open_datasets = 1
        self.max_open_datasets = 1

        self.next_min_core = 0
        self.max_core = self._max(self.next_ds["core_label"])
        self.next_min_core_map = {str(self.files[0]): 0}
        self.core_label_map = np.arange(self.max_core + 1, dtype=np.int64)

        self.next_min_anvil = 0
        self.max_anvil = max(self._max(self.next_ds["thick_anvil_label"]),
                             self._max(self.next_ds["thin_anvil_label"]))
        self.next_min_anvil_map = {str(self.files[0]): 0}
        self.anvil_label_map = np.arange(self.max_anvil + 1, dtype=np.int64)

    # -- pass 1: build the label maps --------------------------------------

    def link_all(self) -> None:
        print(self.files[0], flush=True)
        for file in self.files[1:]:
            self.link_next_file(file)
        self.next_ds = None
        self.open_datasets -= 1
        print(datetime.now(), "Linking complete", flush=True)
        print(
            "Total cores relabelled:",
            int(np.sum(self.core_label_map != np.arange(self.core_label_map.size))),
            flush=True,
        )
        print(
            "Total anvils relabelled:",
            int(np.sum(self.anvil_label_map != np.arange(self.anvil_label_map.size))),
            flush=True,
        )

    def link_next_file(self, file) -> None:
        self.read_new_file(file)
        shared = np.intersect1d(
            np.asarray(self.current_ds.coords["t"]), np.asarray(self.next_ds.coords["t"])
        )
        if shared.size > 2:
            self.update_core_label_map()
            self.update_anvil_label_map()
        else:
            warnings.warn("No overlap between files")
        self.current_ds = None
        self.open_datasets -= 1

    def read_new_file(self, file) -> None:
        print(file, flush=True)
        self.current_ds, self.next_ds = self.next_ds, self._open(file)
        self.open_datasets += 1
        self.max_open_datasets = max(self.max_open_datasets, self.open_datasets)

        self.current_min_core, self.next_min_core = (
            self.next_min_core,
            self.next_min_core + self.max_core,
        )
        self.max_core = self._max(self.next_ds["core_label"])
        self.next_min_core_map[str(file)] = self.next_min_core
        self.core_label_map = np.concatenate([
            self.core_label_map,
            np.arange(self.next_min_core + 1, self.next_min_core + self.max_core + 1,
                      dtype=np.int64),
        ])

        self.current_min_anvil, self.next_min_anvil = (
            self.next_min_anvil,
            self.next_min_anvil + self.max_anvil,
        )
        self.max_anvil = max(self._max(self.next_ds["thick_anvil_label"]),
                             self._max(self.next_ds["thin_anvil_label"]))
        self.next_min_anvil_map[str(file)] = self.next_min_anvil
        self.anvil_label_map = np.concatenate([
            self.anvil_label_map,
            np.arange(self.next_min_anvil + 1, self.next_min_anvil + self.max_anvil + 1,
                      dtype=np.int64),
        ])

    def _converge(self, label_map, what: str):
        """Pointer convergence, at most ``max_convergence_iterations``
        hops; ValueError where the map has not converged by then."""
        for n_converge in range(self.max_convergence_iterations + 1):
            if np.any(label_map[label_map] != label_map):
                label_map = label_map[label_map]
            else:
                if n_converge > 0:
                    print(f"Iterations required for {what} labels to converge:", n_converge,
                          flush=True)
                break
        else:
            raise ValueError(f"{what} label map failed to converge")
        return label_map

    def _update_map(self, label_map, var, cur_min, next_min, what):
        with self._pass("overlap") as record:
            groups = _pair_link_groups(
                self.current_ds[var], self.current_ds.coords["t"],
                self.next_ds[var], self.next_ds.coords["t"],
                self.atol, self.rtol, self.device, self.budget_bytes,
            )
            record["linked"] = len(groups)
        for cur_group, next_group in groups:
            first = cur_group[0] + cur_min
            new_label = min(first, label_map[first])
            for lbl in cur_group[1:]:
                label_map[lbl + cur_min] = new_label
            for lbl in next_group:
                label_map[lbl + next_min] = new_label
        return self._converge(label_map, what)

    def update_core_label_map(self) -> None:
        self.core_label_map = self._update_map(
            self.core_label_map, "core_label", self.current_min_core, self.next_min_core, "core"
        )

    def update_anvil_label_map(self) -> None:
        self.anvil_label_map = self._update_map(
            self.anvil_label_map, "thick_anvil_label", self.current_min_anvil,
            self.next_min_anvil, "anvil",
        )

    # -- pass 2: relabel + write every file ---------------------------------

    def _lut(self, label_map, offset, max_label):
        """The global map's slice for a file's labels 0..max_label, label 0
        kept 0, on the device."""
        table = np.array(label_map[offset : offset + max_label + 1])
        table[:1] = 0
        return _lookup(table, self.device)

    def _core_lut(self, ds, min_core_map):
        return self._lut(self.core_label_map, min_core_map, self._max(ds["core_label"]))

    def _anvil_lut(self, ds, min_anvil_map):
        max_anvil = max(self._max(ds["thick_anvil_label"]), self._max(ds["thin_anvil_label"]))
        return self._lut(self.anvil_label_map, min_anvil_map, max_anvil)

    def _relabelled(self, ds, var, lut, inplace):
        vol = as_tensor(ds[var])
        if not inplace:
            vol = vol.clone()
        with self._pass("relabel"):
            _map_frames("relabel", vol, None, lambda v: lut[v.long()].to(v.dtype),
                        self.device, self.budget_bytes)
        return None if inplace else vol

    def relabel_cores(self, ds, min_core_map, inplace=False):
        """Map a file's core volume through the global map's slice (in
        place, or as a new tensor)."""
        return self._relabelled(ds, "core_label", self._core_lut(ds, min_core_map), inplace)

    def relabel_anvils(self, ds, min_anvil_map, inplace=False):
        lut = self._anvil_lut(ds, min_anvil_map)
        outs = tuple(self._relabelled(ds, var, lut, inplace)
                     for var in ("thick_anvil_label", "thin_anvil_label"))
        return None if inplace else outs

    def merge_labels(self, ds, filename, join="start") -> None:
        """Fill zero pixels of ``ds``'s interior window from a neighbouring
        file's (remapped) labels, less its stubs: labels at the ``join``
        end of the window (the last shared frame where ``join`` is
        "start") that ``ds`` does not have.  The neighbour's labels are
        remapped over the shared frames alone, a chunk at a time."""
        join_i = -1 if join == "start" else 0
        merge_ds = self._open(filename)
        self.open_datasets += 1
        self.max_open_datasets = max(self.max_open_datasets, self.open_datasets)
        shared, di, mi = _shared_time_indices(ds.coords["t"], merge_ds.coords["t"])
        if shared.size > 2:
            with self._pass("merge_labels"):
                core = self._core_lut(merge_ds, self.next_min_core_map[str(filename)])
                anvil = self._anvil_lut(merge_ds, self.next_min_anvil_map[str(filename)])
                for var, lut in zip(LABEL_VARS, (core, anvil, anvil)):
                    vals = as_tensor(ds[var])
                    other = as_tensor(merge_ds[var])
                    table = lut.cpu().numpy()

                    def uniq(vol, frames, mapped=False):
                        found = unique_frames(vol, frames, self.device, self.budget_bytes,
                                              "merge_labels")
                        return set((table[found] if mapped else found).tolist())

                    combine = (uniq(other, mi[1:-1], True)
                               - (uniq(other, mi[[join_i]], True) - uniq(vals, di))) - {0}
                    _interior_merge("merge_labels", vals, di[1:-1], other, mi[1:-1], combine,
                                    lut, self.device, self.budget_bytes)
        del merge_ds
        self.open_datasets -= 1

    def output_files(self) -> list[Path]:
        outputs = []
        for i, file in enumerate(self.files):
            outputs.append(self.output_a_file(
                file,
                self.files[i - 1] if i > 0 else None,
                self.files[i + 1] if i < len(self.files) - 1 else None,
            ))
        return outputs

    def output_a_file(self, file, prev_file, next_file) -> Path:
        print(datetime.now(), "Processing output for:", file, flush=True)
        ds = self._open(file)
        self.open_datasets += 1
        self.max_open_datasets = max(self.max_open_datasets, self.open_datasets)
        self.relabel_cores(ds, self.next_min_core_map[str(file)], inplace=True)
        self.relabel_anvils(ds, self.next_min_anvil_map[str(file)], inplace=True)
        if prev_file is not None:
            self.merge_labels(ds, prev_file, join="start")
        if next_file is not None:
            self.merge_labels(ds, next_file, join="end")

        start_date, end_date = get_dates_from_filename(file)
        ds = self._finalise(ds, start_date, end_date)
        out = self._output_path(file)
        self._save(ds, out)
        self.open_datasets -= 1
        return out
