"""CLI: detect DCCs in native-format Meteosat SEVIRI archives (counterpart
of ``tobac_flow_tpu/cli/dcc_detect_seviri_nat.py``, with the same
arguments and file name, ``detected_dccs_SEVIRI_S*.nc``, and
``--device``): decodes the ``.nat`` files (``data/seviri_nat``, host
numpy without h5py), crops them to ``-x0..-y1``, and runs the detection
(on the CUDA card unless ``--device cpu``).

Usage: python -m tobac_flow_tpu_torch.cli.dcc_detect_seviri_nat -sd OUT *.nat

Writing the output (and the core-label checkpoint) needs h5py, which is
checked before any file is decoded; :func:`detect_seviri_nat` runs
everything up to the write where h5py is absent.
"""

from __future__ import annotations

import argparse
import pathlib
from datetime import datetime

from tobac_flow_tpu_torch.cli.common import DetectionOptions, run_detection, save_dataset
from tobac_flow_tpu_torch.data.ncdataset import Dataset, require_h5py
from tobac_flow_tpu_torch.device import resolve_device
from tobac_flow_tpu_torch.data.seviri_nat import seviri_nat_dataloader


def save_name(bt):
    """``detected_dccs_SEVIRI_S<first time>.nc`` of a loaded BT field."""
    start = str(bt.coords["t"][0].astype("datetime64[s]")).replace("-", "").replace(":", "")
    return f"detected_dccs_SEVIRI_S{start}.nc"


TITLE = "Detected DCCs in Meteosat SEVIRI native observations (tobac-flow-tpu)"


def detect_fields(bt, wvd, twd, save_spatial_props=False, checkpoint_path=None, device=None,
                  stats=None, budget_bytes=None, title=TITLE):
    """The detection of the loaded fields (DataArrays) with
    ``DetectionOptions()`` on ``device`` (CUDA by default; ``stats`` and
    ``budget_bytes`` as ``run_detection`` takes them), the dataset titled
    ``title``: the work of this CLI and of ``dcc_detect_seviri``.
    Returns (the dataset, its file name)."""
    opts = DetectionOptions(save_spatial_props=save_spatial_props,
                            checkpoint_path=checkpoint_path)
    ds = run_detection(bt, wvd, twd, Dataset(coords=dict(bt.coords)), opts=opts,
                       device=device, stats=stats, budget_bytes=budget_bytes)
    ds.attrs.update(
        title=title,
        history=f"Processed on {datetime.now().isoformat()}",
        references="https://doi.org/10.5194/amt-16-1043-2023",
    )
    return ds, save_name(bt)


def detect_seviri_nat(files, x0=None, x1=None, y0=None, y1=None, save_spatial_props=False,
                      checkpoint_path=None, device=None, stats=None, budget_bytes=None):
    """The CLI's work: the archives decoded and cropped, then
    :func:`detect_fields`.  Returns (the dataset, its file name)."""
    bt, wvd, twd = seviri_nat_dataloader(None, None, files, x0=x0, x1=x1, y0=y0, y1=y1)
    return detect_fields(bt, wvd, twd, save_spatial_props, checkpoint_path, device, stats,
                         budget_bytes)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("-x0", default=None, type=int)
    parser.add_argument("-x1", default=None, type=int)
    parser.add_argument("-y0", default=None, type=int)
    parser.add_argument("-y1", default=None, type=int)
    parser.add_argument("--save_spatial_props", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    parser.add_argument("files", nargs="+", type=str)
    args = parser.parse_args(argv)
    require_h5py("dcc_detect_seviri_nat")
    device = resolve_device(args.device)

    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    ds, name = detect_seviri_nat(
        args.files, args.x0, args.x1, args.y0, args.y1, args.save_spatial_props,
        save_dir / "dcc_detect_seviri_nat.checkpoint.nc", device)
    save_path = save_dir / name
    save_dataset(ds, save_path)
    return save_path


if __name__ == "__main__":
    main()
