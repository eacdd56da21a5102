"""Device memory per pixel of the PyTorch port's main-path stages, on one
NVIDIA GPU.

    python3 tools/torch_flood_memory.py [--height 1500] [--width 2500]
        [--depths 6,12,24] [--chunked-depth 24] [--flow-depth 12] [--json PATH]

For each depth T, on ``bench.make_scene(T, H, W)`` with ``make_markers``:

- the flow stage, ``pair_flows`` over all T-1 pairs as one group, with the
  fused path's Farneback and with the detection CLI's refinement and
  smoothing: (peak - allocated before) / (pairs x H x W), up to
  ``--flow-depth`` (deeper, the flow runs in groups and is not measured);
- the fields stage (one group): (peak - before) / (T x H x W);
- the whole-volume flood (``watershed`` with no budget, so never
  chunked) on the fused path's edges, markers and mask, with those
  markers ("plain") and with a -1 barrier ring added inside the mask
  ("mixed"): (peak - before) / (T x H x W).

Then the flood at ``--chunked-depth`` forced into at least 3 time chunks,
against its whole-volume labels: agreement, chunks, passes, floods and
seconds.  Every figure is printed with the card's name and power limit;
``--json PATH`` also writes them to a file.  Run from the repo root.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import make_markers, make_scene  # noqa: E402
from chip_smoke import card  # noqa: E402
from tobac_flow_tpu_torch.detect.chain import DetectionOptions  # noqa: E402
from tobac_flow_tpu_torch.models.farneback import FarnebackFlow  # noqa: E402
from tobac_flow_tpu_torch.ops import watershed as ws  # noqa: E402
from tobac_flow_tpu_torch.pipeline import (  # noqa: E402
    _WS_ITERS, _detect_fields_stage, adaptive_band_radius, pair_flows,
)

NO_BUDGET = 1 << 60  # a budget no volume exceeds: the flood runs whole


def measured(fn):
    """(result, bytes allocated at the peak beyond those allocated before,
    seconds) of ``fn()``."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1500)
    ap.add_argument("--width", type=int, default=2500)
    ap.add_argument("--depths", default="6,12,24")
    ap.add_argument("--chunked-depth", type=int, default=24)
    ap.add_argument("--flow-depth", type=int, default=12,
                    help="the deepest T whose flow stage runs as one group")
    ap.add_argument("--json", help="also write the numbers to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flood_memory: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    line = card()
    h, w = args.height, args.width
    px = h * w
    opts = DetectionOptions()
    rows = []
    for t in [int(d) for d in args.depths.split(",")]:
        bt_np = make_scene(t, h, w)
        markers_np, n = make_markers(bt_np)
        bt = torch.from_numpy(bt_np).to(dev)
        row = {"shape": [t, h, w], "markers": n}
        if t <= args.flow_depth:
            (fwd, bwd), peak, sec = measured(
                lambda: pair_flows(bt, FarnebackFlow(), device=dev, group=t - 1))
            row["flow_bytes_per_pair_px"] = peak / ((t - 1) * px)
            row["flow_s"] = sec
            _, peak, sec = measured(lambda: pair_flows(
                bt, FarnebackFlow(), opts.vr_steps, opts.smoothing_passes,
                opts.interp_method, device=dev, group=t - 1))
            row["cli_flow_bytes_per_pair_px"] = peak / ((t - 1) * px)
            row["cli_flow_s"] = sec
        else:  # in groups sized from the free memory, not measured
            fwd, bwd = pair_flows(bt, FarnebackFlow(), device=dev)
        fwd, bwd = fwd.clamp(-20, 20), bwd.clamp(-20, 20)
        radius = adaptive_band_radius(fwd, bwd)
        (growth, field, edges), peak, sec = measured(
            lambda: _detect_fields_stage(bt, fwd, bwd, 5.0, radius, group=t))
        row["fields_bytes_per_px"] = peak / (t * px)
        row["fields_s"] = sec
        markers = torch.from_numpy(markers_np).to(dev)
        mask = field > 0.05
        mixed = torch.where((markers == 0) & mask & (field < 0.1), -1, markers)
        del growth, field
        for kind, mk in (("plain", markers), ("mixed", mixed)):
            stats = {}
            labels, peak, sec = measured(lambda: ws.watershed(
                fwd, bwd, edges, mk, mask=mask, max_iters=_WS_ITERS, stats=stats,
                budget_bytes=NO_BUDGET, device=dev))
            row[f"flood_{kind}_bytes_per_px"] = peak / (t * px)
            row[f"flood_{kind}_s"] = sec
            row[f"flood_{kind}_rounds"] = {k: v for k, v in stats.items()
                                           if k.endswith("rounds")}
            if kind == "plain" and t == args.chunked_depth:
                whole = labels
                chunk_t = -(-t // 3)
                stats = {}
                chunked, peak, sec = measured(lambda: ws._watershed_time_chunked(
                    edges, markers, mask, fwd, bwd, ws._structure_taps_3d(
                        ws.connectivity_structure(1)), chunk_t=chunk_t,
                    max_iters_cap=_WS_ITERS, multigrid=True, run_scans=True, stats=stats))
                agree = float((chunked == whole).float().mean())
                row["chunked"] = {
                    "agreement": agree, "seconds": sec, "whole_seconds": row["flood_plain_s"],
                    "bytes_per_px": peak / (t * px),
                    **{k: v for k, v in stats.items() if k.startswith("chunk")},
                    "rounds": {k: v for k, v in stats.items() if k.endswith("rounds")},
                }
                del chunked, whole
            del labels
        rows.append(row)
        print(json.dumps(row), f"[{line}]", flush=True)
        del bt, fwd, bwd, edges, markers, mixed, mask
        torch.cuda.empty_cache()
    summary = {"card": line, "rows": rows}
    for key in ("flow_bytes_per_pair_px", "cli_flow_bytes_per_pair_px", "fields_bytes_per_px",
                "flood_plain_bytes_per_px", "flood_mixed_bytes_per_px"):
        summary[f"max_{key}"] = max(r[key] for r in rows if key in r)
    if args.json:
        Path(args.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
