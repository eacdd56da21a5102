"""CLI: combine detection files and compute per-object statistics
(counterpart of ``tobac_flow_tpu/cli/dcc_statistics.py``, with the same
arguments and file, and ``--device``): merge label flags and per-step
statistics across files, filter invalid cores and anvils, aggregate step
statistics to object properties, add validity flags, save.

Usage: python -m tobac_flow_tpu_torch.cli.dcc_statistics -sd OUT detected_*.nc
(on the card), or with ``--device cpu``.  Reading and writing the files
needs h5py; :func:`dcc_statistics` does the work on Datasets in memory.
"""

from __future__ import annotations

import argparse
import pathlib
from datetime import datetime

import numpy as np

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.ncdataset import Dataset, open_dataset, require_h5py
from tobac_flow_tpu_torch.device import resolve_device, stage
from tobac_flow_tpu_torch.schema.postprocess import (
    add_validity_flags,
    process_core_properties,
    process_thick_anvil_properties,
    process_thin_anvil_properties,
)
from tobac_flow_tpu_torch.utils.filters import (
    filter_anvils,
    filter_cores,
    remove_orphan_coords,
)

_FLAG_VARS = [
    "core_edge_label_flag",
    "core_start_label_flag",
    "core_end_label_flag",
    "thick_anvil_edge_label_flag",
    "thick_anvil_start_label_flag",
    "thick_anvil_end_label_flag",
    "thin_anvil_edge_label_flag",
    "thin_anvil_start_label_flag",
    "thin_anvil_end_label_flag",
    "core_nan_flag",
    "thick_anvil_nan_flag",
    "thin_anvil_nan_flag",
    "core_anvil_index",
]


def _step_vars(ds):
    return [
        v
        for v in ds.data_vars
        if ds[v].dims in [("core_step",), ("thick_anvil_step",), ("thin_anvil_step",)]
    ]


def subset(ds, var_list):
    """The per-object and per-step variables of ``var_list`` that ``ds``
    holds, with its coordinates but the (t, y, x) grid: what the
    statistics read of a detection file."""
    out = Dataset(attrs=dict(ds.attrs))
    out.coords.update(ds.coords)
    for v in var_list:
        if v in ds.data_vars:
            out.data_vars[v] = ds.data_vars[v]
    for k in ("t", "y", "x"):
        out.coords.pop(k, None)
    return out


def statistics_variables(ds):
    """The variables the statistics take from every file: the flags,
    ``core_anvil_index`` and the first file's per-step variables."""
    return _FLAG_VARS + _step_vars(ds)


def _concat_on(ds_a, ds_b, dim):
    """Outer-concatenate two datasets along a label dimension, keeping
    ds_a's values for overlapping labels."""
    a_vals = ds_a.coords[dim]
    b_vals = ds_b.coords[dim]
    new = np.asarray(sorted(set(b_vals.tolist()) - set(a_vals.tolist())), dtype=a_vals.dtype)
    merged = np.concatenate([a_vals, new])
    order = np.argsort(merged)
    out_coord = merged[order]
    sel_b = ds_b.sel(**{dim: new}) if new.size else None
    return out_coord, order, sel_b


def combine_datasets(datasets):
    """Merge per-file label statistics (host numpy, as the reference):
    overlapping labels keep the first file's values, with the edge and NaN
    flags ORed, the later file's end flag, and an empty
    ``core_anvil_index`` filled from the later file (all written in place
    into the first file's variables); new labels are appended."""
    base = datasets[0]
    for nxt in datasets[1:]:
        for dim in ("core", "anvil", "core_step", "thick_anvil_step", "thin_anvil_step"):
            if dim not in base.coords or dim not in nxt.coords:
                continue
            a_vals = base.coords[dim]
            overlap = np.intersect1d(a_vals, nxt.coords[dim])
            if overlap.size and dim in ("core", "anvil"):
                for var in base.data_vars:
                    if base[var].dims != (dim,):
                        continue
                    pos_a = np.searchsorted(a_vals, overlap)
                    pos_b = np.searchsorted(nxt.coords[dim], overlap)
                    va = base[var].values
                    vb = nxt[var].values
                    if var.endswith("_nan_flag") or var.endswith("edge_label_flag"):
                        va[pos_a] = np.logical_or(va[pos_a], vb[pos_b])
                    elif var.endswith("end_label_flag"):
                        va[pos_a] = vb[pos_b]
                    elif var == "core_anvil_index":
                        wh = va[pos_a] == 0
                        va[pos_a[wh]] = vb[pos_b[wh]]
            new_vals, order, sel_b = _concat_on(base, nxt, dim)
            if sel_b is None:
                continue
            merged = Dataset(attrs=dict(base.attrs))
            merged.coords.update(base.coords)
            merged.coords[dim] = new_vals
            for var in set(base.data_vars) | set(sel_b.data_vars):
                if var in base.data_vars and base[var].dims == (dim,):
                    if var in sel_b.data_vars:
                        joined = np.concatenate(
                            [base[var].values, sel_b[var].values]
                        )[order]
                    else:
                        fill = np.zeros(
                            len(new_vals) - len(base[var].values),
                            base[var].values.dtype,
                        )
                        joined = np.concatenate([base[var].values, fill])[order]
                    da = base[var].copy()
                    da.values = joined
                    da.coords[dim] = new_vals
                    merged.data_vars[var] = da
                elif var in base.data_vars:
                    merged.data_vars[var] = base.data_vars[var]
            base = merged
    return base


def dcc_statistics(datasets, device=None, stats=None):
    """The CLI's work on the files' subsets (:func:`subset`, in file
    order): combine them, drop orphans, filter and process the cores, then
    the anvils, drop orphans again and flag validity, the per-object
    reductions on ``device`` (CUDA by default; ``stats``: ``combine``,
    ``cores``, ``anvils``, ``flags``).  Returns the dataset."""
    dev = resolve_device(device)
    with stage("combine", stats, dev):
        dataset = combine_datasets(list(datasets))
        print(datetime.now(), "Removing orphaned items", flush=True)
        dataset = remove_orphan_coords(dataset)

    print(datetime.now(), "Filtering and processing cores", flush=True)
    with stage("cores", stats, dev):
        dataset = filter_cores(dataset, verbose=True, device=dev)
        dataset = process_core_properties(dataset, device=dev)

    print(datetime.now(), "Filtering and processing anvils", flush=True)
    with stage("anvils", stats, dev):
        dataset = filter_anvils(dataset, verbose=True, device=dev)
        dataset = process_thick_anvil_properties(dataset, device=dev)
        dataset = process_thin_anvil_properties(dataset, device=dev)

    print(datetime.now(), "Flagging core and anvil quality", flush=True)
    with stage("flags", stats, dev):
        dataset = remove_orphan_coords(dataset)
        dataset = add_validity_flags(dataset, device=dev)

    print(f"Final core count: {dataset.coords['core'].size}")
    print(f"Final valid core count: {dataset['core_is_valid'].values.sum()}")
    print(f"Final anvil count: {dataset.coords['anvil'].size}")
    print(
        f"Final valid thick anvil count: {dataset['thick_anvil_is_valid'].values.sum()}"
    )
    return dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sd", help="Directory to save output files", default=".")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    parser.add_argument("files", help="List of files to combine", nargs="+", type=str)
    args = parser.parse_args(argv)
    require_h5py("dcc_statistics")

    dcc_files = sorted(pathlib.Path(f) for f in args.files)
    datasets = []
    var_list = None
    for f in dcc_files:
        print(f, flush=True)
        ds = open_dataset(f)
        if var_list is None:
            var_list = statistics_variables(ds)
        datasets.append(subset(ds, var_list))
    dataset = dcc_statistics(datasets, args.device)

    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    stem = dcc_files[0].stem
    name = f"dcc_statistics_{stem.split('detected_dccs_')[-1]}.nc"
    save_path = save_dir / name
    save_dataset(dataset, save_path)
    return save_path


if __name__ == "__main__":
    main()
