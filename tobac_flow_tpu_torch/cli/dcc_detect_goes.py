"""CLI: detect DCCs in GOES-16/17 ABI data (counterpart of
``tobac_flow_tpu/cli/dcc_detect_goes.py``, with the same arguments and
file name, and ``--device``): loads a padded window of MCMIP files (a
local archive; missing files are downloaded from the public GCS bucket
with ``--download``), runs the detection (on the CUDA card unless
``--device cpu``) and writes the labelled dataset.

Usage:
  TFT_OFFLINE=1 python -m tobac_flow_tpu_torch.cli.dcc_detect_goes DATE \\
      -hours 24 -sat 16 -x0 1000 -x1 1500 -y0 300 -y1 800 -sd OUT -gd GOES_DATA \\
      --device cpu

``TFT_OFFLINE`` skips the bucket's listing and globs ``-gd`` alone.
Reading the MCMIP files and writing the output need h5py, which is
checked before any file is read.
"""

from __future__ import annotations

import argparse
import pathlib
from datetime import datetime, timedelta

from tobac_flow_tpu_torch.cli.common import DetectionOptions, run_detection, save_dataset
from tobac_flow_tpu_torch.data.dataloader import goes_dataloader
from tobac_flow_tpu_torch.data.ncdataset import require_h5py


def parse_date(s):
    for fmt in ("%Y-%m-%d %H:%M", "%Y-%m-%d", "%Y%m%d", "%Y%m%d_%H%M%S", "%Y-%m-%dT%H:%M"):
        try:
            return datetime.strptime(s, fmt)
        except ValueError:
            continue
    raise ValueError(f"unrecognised date {s!r}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("date", help="Start date (e.g. 2020-06-01)")
    parser.add_argument("-hours", default=24, type=float, help="Hours to process")
    parser.add_argument("-sat", default=16, type=int, help="GOES satellite (16/17)")
    parser.add_argument("-x0", default=None, type=int)
    parser.add_argument("-x1", default=None, type=int)
    parser.add_argument("-y0", default=None, type=int)
    parser.add_argument("-y1", default=None, type=int)
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("-gd", default="./goes_data", help="GOES data directory")
    parser.add_argument("--download", action="store_true", help="Download missing files")
    parser.add_argument("--n_pad_files", default=12, type=int)
    parser.add_argument("--save_bt", action="store_true")
    parser.add_argument("--save_wvd", action="store_true")
    parser.add_argument("--save_swd", action="store_true")
    parser.add_argument("--save_spatial_props", action="store_true")
    parser.add_argument("--no_relabel_anvils", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    # without h5py every file read would fail and be skipped as unreadable
    require_h5py("dcc_detect_goes")

    start_date = parse_date(args.date)
    end_date = start_date + timedelta(hours=args.hours)

    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    save_name = "detected_dccs_G%02d_S%s_E%s_X%04d_%04d_Y%04d_%04d.nc" % (
        args.sat,
        start_date.strftime("%Y%m%d_%H0000"),
        end_date.strftime("%Y%m%d_%H0000"),
        args.x0 or 0,
        args.x1 or 0,
        args.y0 or 0,
        args.y1 or 0,
    )
    save_path = save_dir / save_name
    print("Saving output to:", save_path, flush=True)

    print(datetime.now(), "Loading ABI data", flush=True)
    bt, wvd, swd, dataset = goes_dataloader(
        start_date,
        end_date,
        n_pad_files=args.n_pad_files,
        x0=args.x0,
        x1=args.x1,
        y0=args.y0,
        y1=args.y1,
        return_new_ds=True,
        satellite=args.sat,
        product="MCMIP",
        view="C",
        mode=[3, 4, 6],
        save_dir=args.gd,
        replicate_path=True,
        check_download=True,
        n_attempts=1,
        download_missing=args.download,
    )

    opts = DetectionOptions(
        relabel=not args.no_relabel_anvils,
        save_bt=args.save_bt,
        save_wvd=args.save_wvd,
        save_swd=args.save_swd,
        save_spatial_props=args.save_spatial_props,
        checkpoint_path=save_path.with_suffix(".checkpoint.nc"),
    )
    dataset = run_detection(bt, wvd, swd, dataset, start_date=start_date,
                            end_date=end_date, opts=opts, device=args.device)
    dataset.attrs.update(
        title=f"Detected DCCs in GOES-{args.sat} observations (tobac-flow-tpu)",
        history=f"Processed on {datetime.now().isoformat()}",
        references="https://doi.org/10.5194/amt-16-1043-2023",
    )
    save_dataset(dataset, save_path)
    return save_path


if __name__ == "__main__":
    main()
