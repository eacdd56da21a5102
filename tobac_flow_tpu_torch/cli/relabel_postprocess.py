"""CLI: apply a links file to a detection file, then post-process it
(counterpart of ``tobac_flow_tpu/cli/relabel_postprocess.py``, with the
same arguments and file, and ``--device``): relabel, label properties,
optionally the spatial properties, the per-step weighted BT statistics,
then drop the BT.

Usage: python -m tobac_flow_tpu_torch.cli.relabel_postprocess FILE LINKS -sd OUT
(on the card), or with ``--device cpu``.  Reading and writing the files
needs h5py; :func:`relabel_postprocess` does the work on a Dataset in
memory.
"""

from __future__ import annotations

import argparse
import pathlib
from datetime import datetime

import numpy as np
import torch

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.ncdataset import as_tensor, open_dataset, require_h5py
from tobac_flow_tpu_torch.detect.analysis import get_label_stats, weighted_statistics_on_labels
from tobac_flow_tpu_torch.device import resolve_device, stage
from tobac_flow_tpu_torch.schema import calculate_label_properties
from tobac_flow_tpu_torch.track.linking import relabel_dataset
from tobac_flow_tpu_torch.utils.datetime_utils import get_dates_from_filename

LABELS = ("core_label", "thick_anvil_label", "thin_anvil_label")
STEP_LABELS = (("core_step_label", "core_step"), ("thick_anvil_step_label", "thick_anvil_step"),
               ("thin_anvil_step_label", "thin_anvil_step"))


def labels_to(dataset, dev, names):
    """Move the label volumes ``names`` of ``dataset`` (those it holds) to
    ``dev``."""
    for name in names:
        if name in dataset.data_vars:
            dataset[name].data = as_tensor(dataset[name], dev)


def pixel_weights(dataset, dev, dtype=torch.float64):
    """The pixel areas (H, W) on ``dev``, or a scalar one, as the
    statistics weight each pixel (no copy per frame)."""
    if "area" in dataset.data_vars:
        return as_tensor(dataset["area"], dev)
    return torch.ones((), dtype=dtype, device=dev)


def relabel_postprocess(dataset, links_ds, filename, save_spatial_props=False, device=None,
                        budget_bytes=None, stats=None):
    """The CLI's work on the detection ``dataset`` read from ``filename``:
    its labels relabelled by ``links_ds`` on ``device`` (CUDA by default),
    label properties, the spatial properties where asked, the weighted BT
    statistics per step (float32), the BT dropped.  Each step runs in
    ``device.stage`` (``stats``: ``relabel``, ``label_props``,
    ``spatial_props``, ``step_stats``) under ``budget_bytes`` (``None``:
    the card's free memory at each pass).  Returns the dataset, its
    volumes where they were computed."""
    dev = resolve_device(device)
    with stage("relabel", stats, dev):
        labels_to(dataset, dev, [name for name, _ in STEP_LABELS])
        dataset = relabel_dataset(dataset, links_ds, filename, dev, budget_bytes)

    print(datetime.now(), "Calculating label properties", flush=True)
    with stage("label_props", stats, dev):
        calculate_label_properties(dataset, budget_bytes)

    if save_spatial_props:
        print(datetime.now(), "Calculating spatial properties", flush=True)
        with stage("spatial_props", stats, dev):
            for var in LABELS:
                get_label_stats(dataset[var], dataset, budget_bytes)

    bt_name = next((n for n in ("bt", "BT") if n in dataset.data_vars), None)
    if bt_name is not None:
        print(datetime.now(), "Calculating statistics", flush=True)
        field = dataset[bt_name]
        weights = pixel_weights(dataset, dev, torch.float32)
        with stage("step_stats", stats, dev):
            for labels, name in STEP_LABELS:
                for da in weighted_statistics_on_labels(
                    dataset[labels], field, weights, name=name, dim=name, dtype=np.float32,
                    budget_bytes=budget_bytes,
                ):
                    dataset[da.name] = da
        # the field is only needed for the statistics: drop it to shrink the output
        dataset = dataset.drop_vars(bt_name)
    return dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("file", help="Detection file to relabel", type=str)
    parser.add_argument("links_file", help="Links file with the new labels", type=str)
    parser.add_argument("-sd", help="Directory to save output", default="")
    parser.add_argument(
        "-sdf", help="Date formatting string for subdirectories", default=""
    )
    parser.add_argument("--save_spatial_props", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("relabel_postprocess")

    filename = pathlib.Path(args.file)
    if not filename.exists():
        raise FileNotFoundError(filename)
    start_date, _ = get_dates_from_filename(filename)

    save_path = pathlib.Path(args.sd or ".")
    if args.sdf:
        save_path = save_path / start_date.strftime(args.sdf)
    save_path.mkdir(parents=True, exist_ok=True)
    save_path = save_path / filename.name

    dataset = relabel_postprocess(open_dataset(filename), open_dataset(args.links_file),
                                  filename, args.save_spatial_props, args.device)
    save_dataset(dataset, save_path)
    return save_path


if __name__ == "__main__":
    main()
