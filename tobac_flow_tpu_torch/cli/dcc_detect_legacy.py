"""CLI: the legacy detection pipeline, the oldest GOES pipeline's
multichannel growth markers and edge watershed in place of the core and
anvil chain (counterpart of ``tobac_flow_tpu/cli/dcc_detect_legacy.py``,
with the same arguments, synthetic scene and file name, and ``--device``).

Usage: python -m tobac_flow_tpu_torch.cli.dcc_detect_legacy -sd /tmp/out
(on the card), or with ``--device cpu`` for the plain PyTorch path.
Writing the file needs h5py; ``detect_legacy`` runs from memory without it.
"""

from __future__ import annotations

import argparse
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.core.flow import create_flow
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, require_h5py
from tobac_flow_tpu_torch.detect.detection import (
    detect_growth_markers_multichannel, edge_watershed,
)
from tobac_flow_tpu_torch.device import resolve_device, stage

__all__ = ["detect_legacy", "main"]


def _on(flow, a):
    """A field (DataArray, array or tensor) as float32 on the flow's device."""
    a = a.data if hasattr(a, "dims") else a
    return flow.tensor(a if isinstance(a, torch.Tensor) else np.asarray(a), torch.float32)


def detect_legacy(bt, wvd, swd, times, device=None, flow=None, coords=None, stats=None):
    """The legacy pipeline from memory: the flow of ``bt``
    (``create_flow(bt, model="Farneback", vr_steps=1, smoothing_passes=1)``
    on ``device``, CUDA unless the caller passes ``device="cpu"``; or the
    given ``flow``), the multichannel growth markers of WVD and BT, and
    the edge watershed of WVD - SWD between -15 and -5 from them.  Returns
    a Dataset with ``growth_markers`` and ``watershed_label`` (int32
    tensors on the flow's device) over ``coords`` (``t`` = ``times`` by
    default).  ``stats`` receives each step's seconds and peak (the keys
    of ``device.stage``: ``flow``, ``markers``, ``watershed``) and the
    flood's round counts."""
    stats = {} if stats is None else stats
    if flow is None:
        dev = resolve_device(device)
        with stage("flow", stats, dev):
            print(datetime.now(), "Calculating flow", flush=True)
            flow = create_flow(bt.data if hasattr(bt, "dims") else bt, model="Farneback",
                               vr_steps=1, smoothing_passes=1, device=dev)
    bt, wvd, swd = (_on(flow, a) for a in (bt, wvd, swd))
    with stage("markers", stats, flow.device):
        print(datetime.now(), "Detecting growth markers (legacy)", flush=True)
        _, _, markers = detect_growth_markers_multichannel(flow, wvd, bt, times)
        print("marker count:", int(markers.max()) if markers.numel() else 0, flush=True)
    with stage("watershed", stats, flow.device):
        print(datetime.now(), "Edge watershed (legacy)", flush=True)
        labels = edge_watershed(flow, wvd - swd, markers, -5, -15, stats=stats)
    ds = Dataset(coords=dict(coords) if coords is not None else {"t": np.asarray(times)})
    ds["growth_markers"] = DataArray(markers.to(torch.int32), dims=("t", "y", "x"),
                                     attrs={"long_name": "legacy growth-marker labels"})
    ds["watershed_label"] = DataArray(labels.to(torch.int32), dims=("t", "y", "x"),
                                      attrs={"long_name": "legacy edge-watershed labels"})
    return ds


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("-t", default=12, type=int)
    parser.add_argument("-y", default=96, type=int)
    parser.add_argument("-x", default=128, type=int)
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("dcc_detect_legacy")

    from tobac_flow_tpu_torch.cli.dcc_detect_synthetic import make_scene

    bt, wvd, swd = make_scene(args.t, args.y, args.x)
    coords = {"t": bt.coords["t"], "y": bt.coords["y"], "x": bt.coords["x"]}
    ds = detect_legacy(bt, wvd, swd, bt.coords["t"], device=args.device, coords=coords).load()
    save_dir = Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    save_path = save_dir / "detected_dccs_legacy.nc"
    save_dataset(ds, save_path)
    return save_path


if __name__ == "__main__":
    main()
