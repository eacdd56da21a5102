"""CLI: repair a detection file by (re)computing per-label weighted field
statistics from companion field files (counterpart of
``tobac_flow_tpu/cli/quick_fix.py``, with the same arguments and file, and
``--device``).

Usage: python -m tobac_flow_tpu_torch.cli.quick_fix FILE -src FIELDS.nc \
    -vars toa_swup toa_lwup -sd OUT
(on the card), or with ``--device cpu``.  Reading and writing the files
needs h5py; :func:`quick_fix` does the work on Datasets in memory.
"""

from __future__ import annotations

import argparse
import pathlib
from datetime import datetime

import numpy as np
import torch

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.cli.relabel_postprocess import pixel_weights
from tobac_flow_tpu_torch.data.ncdataset import as_tensor, open_dataset, require_h5py
from tobac_flow_tpu_torch.detect.analysis import weighted_statistics_on_labels
from tobac_flow_tpu_torch.device import resolve_device, stage

LABEL_GROUPS = [
    ("core_label", "core", "core"),
    ("thick_anvil_label", "thick_anvil", "anvil"),
    ("thin_anvil_label", "thin_anvil", "anvil"),
    ("core_step_label", "core_step", "core_step"),
    ("thick_anvil_step_label", "thick_anvil_step", "thick_anvil_step"),
    ("thin_anvil_step_label", "thin_anvil_step", "thin_anvil_step"),
]


def quick_fix(dataset, field_datasets, variables, device=None, budget_bytes=None, stats=None):
    """The CLI's work: for each field Dataset and each of ``variables`` it
    holds, the float32 weighted statistics over every label family of
    ``dataset`` (its pixel areas, or ones, as weights), on ``device`` (CUDA
    by default) in ``device.stage`` ``field_stats``.  Returns ``dataset``."""
    dev = resolve_device(device)
    groups = [g for g in LABEL_GROUPS if g[0] in dataset.data_vars and g[2] in dataset.coords]
    for label_var, _, _ in groups:
        dataset[label_var].data = as_tensor(dataset[label_var], dev)
    weights = pixel_weights(dataset, dev, torch.float32)
    with stage("field_stats", stats, dev):
        for field_ds in field_datasets:
            for var in variables:
                if var not in field_ds.data_vars:
                    continue
                print(datetime.now(), "Adding statistics for", var, flush=True)
                field = field_ds[var]
                for label_var, name, dim in groups:
                    for da in weighted_statistics_on_labels(
                        dataset[label_var], field, weights, name=name, dim=dim,
                        dtype=np.float32, budget_bytes=budget_bytes,
                    ):
                        dataset[da.name] = da
    return dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("file", help="Detection file to repair", type=str)
    parser.add_argument(
        "-src", nargs="+", required=True,
        help="Field netCDF file(s) on the same (t, y, x) grid",
    )
    parser.add_argument("-vars", nargs="+", required=True, help="Field variables")
    parser.add_argument("-sd", help="Directory to save output", default=".")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("quick_fix")

    filename = pathlib.Path(args.file)
    dataset = quick_fix(open_dataset(filename), (open_dataset(src) for src in args.src),
                        args.vars, args.device)
    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    save_path = save_dir / filename.name
    save_dataset(dataset, save_path)
    return save_path


if __name__ == "__main__":
    main()
