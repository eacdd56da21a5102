"""CLI: run the full DCC detection on a synthetic advecting-storm scene
and write the detection file (counterpart of
``tobac_flow_tpu/cli/dcc_detect_synthetic.py``, with the same arguments,
scene and file name, and ``--device``).

Usage: python -m tobac_flow_tpu_torch.cli.dcc_detect_synthetic -sd /tmp/out
(on the card), or with ``--device cpu`` for the plain PyTorch path.
Writing the file needs h5py.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from tobac_flow_tpu_torch.cli.common import DetectionOptions, run_detection, save_dataset
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset


def make_scene(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    bt = np.empty((t, h, w), np.float32)
    wvd = np.empty((t, h, w), np.float32)
    swd = np.empty((t, h, w), np.float32)
    for i in range(t):
        phase = i / max(t - 1, 1)
        # storm life cycle: rapid growth to ~60% of the window, then decay
        # (the core's cooling stops while the anvil persists and spreads)
        growth = min(phase / 0.6, 1.0)
        decay = max(0.0, (phase - 0.6) / 0.4)
        cx, cy = 0.3 * w + 2.0 * i, 0.4 * h + 1.0 * i
        radius = h / 16 + h / 8 * growth + h / 10 * decay
        core = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * radius**2))
        depth = (10.0 + 80.0 * growth) * (1.0 - 0.4 * decay)
        bt[i] = 290.0 - depth * core + rng.normal(0, 0.3, (h, w))
        wvd[i] = -15.0 + 17.0 * core * (0.3 + 0.7 * growth) + rng.normal(0, 0.2, (h, w))
        swd[i] = 5.0 - 4.5 * core * (1.0 - 0.3 * decay) + rng.normal(0, 0.1, (h, w))
    times = np.datetime64("2020-06-01T00:00:00", "ns") + np.arange(t) * np.timedelta64(
        300, "s"
    )
    coords = {"t": times, "y": np.arange(h) * 2000.0, "x": np.arange(w) * 2000.0}

    def da(v, name):
        return DataArray(
            v, coords=coords, dims=("t", "y", "x"), name=name,
            attrs={"long_name": name, "units": "K"},
        )

    return da(bt, "bt"), da(wvd, "wvd"), da(swd, "swd")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("-t", default=12, type=int, help="Number of frames")
    parser.add_argument("-y", default=96, type=int, help="Frame height")
    parser.add_argument("-x", default=128, type=int, help="Frame width")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--save_spatial_props", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)

    bt, wvd, swd = make_scene(args.t, args.y, args.x, args.seed)
    ds = Dataset(coords={"t": bt.coords["t"], "y": bt.coords["y"], "x": bt.coords["x"]})

    save_dir = Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    start = "20200601_000000"
    save_path = save_dir / f"detected_dccs_SYN_S{start}_X{args.x:04d}_Y{args.y:04d}.nc"
    opts = DetectionOptions(
        save_spatial_props=args.save_spatial_props,
        checkpoint_path=save_path.with_suffix(".checkpoint.nc"),
    )
    ds = run_detection(bt, wvd, swd, ds, opts=opts, device=args.device)
    save_dataset(ds, save_path)
    return save_path


if __name__ == "__main__":
    main()
