"""CLI: repair SEVIRI DCC detection files (counterpart of
``tobac_flow_tpu/cli/fix_seviri_dccs.py``, with the same arguments and
files, and ``--device``): drops the derived variables of an existing
detection file and re-derives its label coordinates, core-anvil links,
step labels, quality flags and label properties through the schema
steps (on the CUDA card unless ``--device cpu``).

Usage: python -m tobac_flow_tpu_torch.cli.fix_seviri_dccs -sd OUT detected_*.nc

Reading and writing the files needs h5py, which is checked before any
read; :func:`fix_dataset` repairs a Dataset in memory.
"""

from __future__ import annotations

import argparse
import pathlib
from datetime import datetime

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.ncdataset import as_tensor, open_dataset, require_h5py
from tobac_flow_tpu_torch.device import resolve_device
from tobac_flow_tpu_torch.schema import (
    add_label_coords,
    add_step_labels,
    calculate_label_properties,
    flag_edge_labels,
    flag_nan_adjacent_labels,
    link_cores_and_anvils,
    link_step_labels,
)
from tobac_flow_tpu_torch.utils.datetime_utils import get_dates_from_filename

# the rasters and raw fields a repair keeps; every other variable is
# derived and rebuilt
_RASTERS = ("core_label", "thick_anvil_label", "thin_anvil_label")
_KEEP = _RASTERS + (
    "goes_imager_projection", "lat", "lon", "area", "bt", "BT", "wvd", "WVD",
    "swd", "SWD",
)


def fix_dataset(dataset, filename, device=None, budget_bytes=None):
    """The CLI's work on a detection Dataset read from ``filename`` (whose
    ``_S…_E…`` tokens, where present, give the edge flags' period), on
    ``device`` (CUDA by default).  Returns the repaired Dataset, holding
    numpy."""
    dev = resolve_device(device)
    drop = [v for v in list(dataset.data_vars) if v not in _KEEP]
    if drop:
        dataset = dataset.drop_vars(drop)
    for name in _RASTERS:
        if name in dataset.data_vars:
            dataset[name].data = as_tensor(dataset[name], dev)

    dataset = add_label_coords(dataset, budget_bytes)
    link_cores_and_anvils(dataset, budget_bytes=budget_bytes)
    add_step_labels(dataset, budget_bytes)
    dataset = add_label_coords(dataset, budget_bytes)
    link_step_labels(dataset, budget_bytes)
    try:
        start_date, end_date = get_dates_from_filename(filename)
    except ValueError:
        start_date = end_date = None
    flag_edge_labels(dataset, start_date, end_date)
    field = next((n for n in ("wvd", "WVD", "bt", "BT") if n in dataset.data_vars), None)
    if field is not None:
        dataset[field].data = as_tensor(dataset[field], dev)
        flag_nan_adjacent_labels(dataset, dataset[field], budget_bytes)
    calculate_label_properties(dataset, budget_bytes)
    return dataset.load()


def fix_file(filename, save_dir=None, device=None):
    """Repair one file into ``save_dir`` (its own directory by default)."""
    filename = pathlib.Path(filename)
    print(datetime.now(), "Fixing", filename, flush=True)
    dataset = fix_dataset(open_dataset(filename), filename, device)
    out_dir = pathlib.Path(save_dir) if save_dir else filename.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    save_path = out_dir / filename.name
    save_dataset(dataset, save_path)
    return save_path


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sd", help="Directory to save repaired files", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    parser.add_argument("files", nargs="+", type=str)
    args = parser.parse_args(argv)
    require_h5py("fix_seviri_dccs")
    device = resolve_device(args.device)
    return [fix_file(f, args.sd, device) for f in sorted(args.files)]


if __name__ == "__main__":
    main()
