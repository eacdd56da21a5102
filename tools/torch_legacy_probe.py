"""Time the legacy path (``cli.dcc_detect_legacy.detect_legacy``) on the
card on ``chip_smoke``'s CONUS-shaped GOES scene at 1500x2500, for each
frame count given (the scene's first N frames): each step's seconds and
peaks, the flood's rounds, the markers, objects and ``ws_sweeps`` launches
by shape.

    python3 tools/torch_legacy_probe.py 6,9
"""

from __future__ import annotations

import gc
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from tobac_flow_tpu_torch.cli.dcc_detect_legacy import detect_legacy  # noqa: E402
from tobac_flow_tpu_torch.ops import ws_sweeps  # noqa: E402


def main(depths):
    dev = torch.device("cuda", 0)
    cs.log(cs.card())
    ws_sweeps.build_library()
    times, frames, x, y = cs.goes_frames(cs.GOES_FULL, cs.GOES_MISSING)
    fields, _ = cs.goes_ingest(times, frames, x, y)
    del frames
    bt, wvd, swd = (torch.from_numpy(np.asarray(f.values)).to(dev) for f in fields)
    t_all = np.asarray(fields[0].coords["t"])
    for n in depths:
        gc.collect()
        torch.cuda.empty_cache()
        stats = {}
        cs.reset_counts()
        t0 = time.perf_counter()
        out = detect_legacy(bt[:n], wvd[:n], swd[:n], t_all[:n], device=dev, stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, by_shape = cs.read_counts()
        markers, labels = out["growth_markers"].data, out["watershed_label"].data
        cs.log(f"legacy {n} frames: {seconds:.2f} s; " + ", ".join(
            f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in sorted(stats.items()) if not k.endswith("span_ns"))
            + f"; markers {int(markers.max())} ({int((markers > 0).sum())} px), objects "
            f"{int(labels.max())} ({int((labels > 0).sum())} px); launches {launches} {by_shape}")
        del out, markers, labels


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("torch_legacy_probe: needs an NVIDIA GPU")
    main([int(a) for a in sys.argv[1].split(",")])
