"""CLI: detect DCCs in Meteosat SEVIRI netCDF channel files (counterpart of
``tobac_flow_tpu/cli/dcc_detect_seviri.py``, with the same arguments and
file name, ``detected_dccs_SEVIRI_S*.nc``, and ``--device``): one file per
time step holding IR_108, WV_062, WV_073, IR_087 and IR_120 (or ORAC's
``ch5``, ``ch6``, ``ch9``, ``ch10``), cropped to ``-x0..-y1``, through the
detection (``dcc_detect_seviri_nat.detect_fields``, on the CUDA card unless
``--device cpu``).

Usage: python -m tobac_flow_tpu_torch.cli.dcc_detect_seviri SEVIRI_DIR/*.nc -sd OUT

Reading and writing the files needs h5py, which is checked before any
read.
"""

from __future__ import annotations

import argparse
import pathlib

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.cli.dcc_detect_seviri_nat import detect_fields
from tobac_flow_tpu_torch.data.dataloader import seviri_dataloader
from tobac_flow_tpu_torch.data.ncdataset import require_h5py
from tobac_flow_tpu_torch.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("files", nargs="+", help="SEVIRI channel netCDF files")
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("-x0", default=None, type=int)
    parser.add_argument("-x1", default=None, type=int)
    parser.add_argument("-y0", default=None, type=int)
    parser.add_argument("-y1", default=None, type=int)
    parser.add_argument("--save_spatial_props", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("dcc_detect_seviri")
    device = resolve_device(args.device)

    bt, wvd, swd = seviri_dataloader(
        None, None, args.files, x0=args.x0, x1=args.x1, y0=args.y0, y1=args.y1
    )
    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    ds, name = detect_fields(
        bt, wvd, swd, args.save_spatial_props, save_dir / "dcc_detect_seviri.checkpoint.nc",
        device, title="Detected DCCs in Meteosat SEVIRI observations (tobac-flow-tpu)")
    save_path = save_dir / name
    save_dataset(ds, save_path)
    return save_path


if __name__ == "__main__":
    main()
