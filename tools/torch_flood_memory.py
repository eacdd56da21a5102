"""Device memory per pixel of the PyTorch port's main-path stages and of
the detection chain's chunked stages, on one NVIDIA GPU.

    python3 tools/torch_flood_memory.py [--height 1500] [--width 2500]
        [--depths 6,12,24] [--chunked-depth 24] [--flow-depth 12]
        [--stage-depths 6,12] [--stages-only] [--only PREFIXES] [--json PATH]
        [--models NAMES] [--model-depth 5]

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
seconds.

Then (or alone, with ``--stages-only``) each time-chunked stage of the
detection chain, each pass of the cross-file linker and of the
post-processing, validation's marker distance and the core
subsegmentation (the ``*_BYTES_PER_PX`` of
``tobac_flow_tpu_torch/device.py``) on
``chip_smoke.deep_scene`` at each ``--stage-depths`` T, given its
CLI-default flow: whole, (peak - allocated before) / (T x H x W), or per
pixel of the T - 2 interior frames that the linker's pair histogram and
merge read; and in 4-frame chunks (``get_label_stats``: row blocks and time
chunks of as many pixels), (peak - before - its whole-volume outputs) /
((4 + 2 halos) x H x W), each chunked result checked equal to the whole
one (float64 sums to rtol 1e-12); ``--only`` keeps the stages whose
constants start with its prefixes.  Every figure is printed with the
card's name and power limit; ``--json PATH`` also writes them to a
file.  Run from the repo root.  Imports no JAX.

With ``--models`` (a comma-separated list of registry names, or ``all``),
only the flow stage of each model (its ``BYTES_PER_PAIR_PX``): on
``bench.make_scene`` at ``--model-depth`` frames of H×W,
``pair_flows`` with the detection CLI's refinement and smoothing (cubic,
then Lanczos), whole ((peak - before) / (pairs × H × W)) and in groups of
one pair ((peak - before - the two whole flows) / (H × W)), with each
one's seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import make_markers, make_scene  # noqa: E402
from chip_smoke import card, chain_times, deep_scene  # noqa: E402
from tobac_flow_tpu_torch import device as port_device  # noqa: E402
from tobac_flow_tpu_torch.core.flow import create_flow  # noqa: E402
from tobac_flow_tpu_torch.data.ncdataset import DataArray  # noqa: E402
from tobac_flow_tpu_torch.detect import analysis, fused  # noqa: E402
from tobac_flow_tpu_torch.detect.chain import DetectionOptions  # noqa: E402
from tobac_flow_tpu_torch.detect.detection import get_anvil_markers  # noqa: E402
from tobac_flow_tpu_torch.ops.ccl import flat_label  # noqa: E402
from tobac_flow_tpu_torch.ops.convolve import convolve, nanmean0  # noqa: E402
from tobac_flow_tpu_torch.schema import dataset as schema  # noqa: E402
from tobac_flow_tpu_torch.schema import postprocess  # noqa: E402
from tobac_flow_tpu_torch.track import file_linker, linking  # noqa: E402
from tobac_flow_tpu_torch.segment.label import link_labels_by_overlap  # noqa: E402
from tobac_flow_tpu_torch.segment.subsegment import subsegment_labels  # noqa: E402
from tobac_flow_tpu_torch.utils import labels as labels_mod  # noqa: E402
from tobac_flow_tpu_torch.utils.stats import find_overlap_mode  # noqa: E402
from tobac_flow_tpu_torch.validate import validation  # noqa: E402
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


CHUNK = 4  # frames of a measured chunk


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, DataArray):
        a, b = np.asarray(a.values), np.asarray(b.values)
        if a.dtype == np.float64:
            return _equal(a, b)
        return _equal(torch.as_tensor(a), torch.as_tensor(b))
    if isinstance(a, np.ndarray):
        if a.dtype == np.float64:  # float64 sums over chunks: another order of adds
            return np.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True)
        return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")
    if a.is_floating_point():
        return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
    return torch.equal(a, b)


def stage_rows(t, h, w, dev, line, only=None):
    """Bytes per pixel of each chunked stage at (t, h, w), whole and per
    chunk frame: {constant: {"whole": B/px, "chunked": B/px, "s": ...}}."""
    opts = DetectionOptions()
    px = t * h * w
    bt, wvd, swd = (torch.from_numpy(a).to(dev) for a in deep_scene(t, h, w))
    flow = create_flow(bt, vr_steps=opts.vr_steps, smoothing_passes=opts.smoothing_passes,
                       interp_method=opts.interp_method, device=dev)
    fwd, bwd = flow.forward_flow, flow.backward_flow
    dt = torch.full((t, 1, 1), 5.0, device=dev)
    diff = wvd - swd
    markers = get_anvil_markers(flow, diff, threshold=opts.thick_upper, overlap=opts.overlap,
                                absolute_overlap=opts.absolute_overlap,
                                min_length=opts.t_offset)
    mask = fused.anvil_marker_mask(diff, opts.thick_upper)
    flat = flat_label(mask)
    linked = link_labels_by_overlap(flow, flat, overlap=0.5, absolute_overlap=4)
    edges, eroded = fused.anvil_pre_watershed(diff, markers, fwd, bwd, opts.thick_lower,
                                              opts.thick_upper, opts.erode_distance)
    # the per-label passes cost bytes per labelled pixel: measure them on
    # labels that cover every pixel (the linked objects, the rest one label)
    dense = torch.where(linked > 0, linked, int(linked.max()) + 1)
    keep = np.arange(int(dense.max())) % 2 == 0
    bt_da = DataArray(bt, dims=("t", "y", "x"), name="bt")
    label_da = DataArray(dense, dims=("t", "y", "x"), name="anvil_label")
    ds = schema.Dataset(coords={"t": chain_times(t)})
    ds["core_label"] = DataArray(dense, dims=("t", "y", "x"))
    for name in ("thick_anvil_label", "thin_anvil_label"):
        ds[name] = DataArray(dense, dims=("t", "y", "x"))
    ds.coords["core"] = labels_mod.unique_labels(dense).astype(np.int32)
    ds.coords["anvil"] = ds.coords["core"]
    wvd_nan = wvd.clone()
    wvd_nan[t // 2, : h // 4] = float("nan")
    weights = torch.ones((), device=dev)
    times = chain_times(t)
    other = torch.where(flat > 0, flat, int(flat.max()) + 1)
    top = max(int(dense.max()), int(other.max())) + 1
    lut = (top - torch.arange(top, device=dev)) % top  # a permutation keeping 0
    interior = np.arange(1, t - 1)
    merged = set(range(1, int(other.max()) + 1))
    holes = torch.where(dense % 2 == 0, 0, dense)
    area = torch.rand((h, w), generator=torch.Generator(dev).manual_seed(1), device=dev) + 3.5
    fields = schema.Dataset()
    fields["bt"] = bt_da
    fields["bt_uncertainty"] = DataArray(bt * 0.01, dims=("t", "y", "x"))
    flag = DataArray((bt % 4).to(torch.int8), dims=("t", "y", "x"), name="flag",
                     attrs={"flag_values": "0b 1b 2b 3b"})

    def label_stats(b):
        out = schema.Dataset()
        analysis.get_label_stats(label_da, out, b)
        return tuple(out.data_vars.values())

    def in_place(fn):
        """``fn`` on the copy of its volume made before the measurement
        (the linker's passes write where the volume lies); returns it."""
        vol = copies.pop()
        fn(vol)
        return vol

    copies = []
    bases = {"RELABEL_BYTES_PER_PX": dense, "MERGE_BYTES_PER_PX": holes}
    # constant -> (call given a budget, halo frames, output bytes per pixel)
    stages = {
        "CONVOLVE_BYTES_PER_TAP_PX": (lambda b: convolve(
            bt, fwd, bwd, structure=np.ones((3, 3, 3)), method="cubic", func=nanmean0,
            budget_bytes=b), 1, 4),
        "CORE_MARKERS_BYTES_PER_PX": (lambda b: fused.core_markers(
            bt, wvd, swd, fwd, bwd, dt, 0.25, 0.5, True, budget_bytes=b), 1, 1),
        "MARKER_MASK_BYTES_PER_PX": (lambda b: fused.anvil_marker_mask(
            diff, opts.thick_upper, budget_bytes=b), 0, 1),
        "ANVIL_PRE_BYTES_PER_PX": (lambda b: fused.anvil_pre_watershed(
            diff, markers, fwd, bwd, opts.thick_lower, opts.thick_upper, opts.erode_distance,
            budget_bytes=b), max(1, opts.erode_distance), 8),
        "ANVIL_POST_BYTES_PER_PX": (lambda b: fused.anvil_post_watershed(
            eroded, markers, budget_bytes=b), 0, 4),
        "LABEL_BYTES_PER_PX": (lambda b: flat_label(mask, budget_bytes=b), 0, 4),
        "LABEL_BYTES_PER_PX step labels": (lambda b: labels_mod.make_step_labels(
            dense, b), 0, 4),
        "LINK_BYTES_PER_PX": (lambda b: link_labels_by_overlap(
            flow, flat, overlap=0.5, absolute_overlap=4, budget_bytes=b), 1, 4),
        "LABEL_TABLE_BYTES_PER_PX remap": (lambda b: labels_mod.remap_labels(
            dense, keep, budget_bytes=b), 0, 4),
        "LABEL_TABLE_BYTES_PER_PX slice": (lambda b: labels_mod.slice_labels(dense, b), 0, 4),
        "LABEL_TABLE_BYTES_PER_PX unique": (lambda b: labels_mod.unique_labels(dense, b), 0, 0),
        "LABEL_TABLE_BYTES_PER_PX lengths": (lambda b: analysis.find_object_lengths(
            dense, budget_bytes=b), 0, 0),
        "LABEL_TABLE_BYTES_PER_PX mask": (lambda b: analysis.mask_labels(
            dense, wvd > -5, budget_bytes=b), 0, 0),
        "OUTPUT_BYTES_PER_PX statistics": (lambda b: analysis.weighted_statistics_on_labels(
            label_da, bt_da, weights, name="anvil", dim="anvil", budget_bytes=b), 0, 0),
        "OUTPUT_BYTES_PER_PX overlap": (lambda b: find_overlap_mode(
            dense, flat, ds.coords["core"], budget_bytes=b), 0, 0),
        "OUTPUT_BYTES_PER_PX properties": (lambda b: schema.calculate_label_properties(
            ds, b), 0, 0),
        "NAN_FLAG_BYTES_PER_PX": (lambda b: schema.flag_nan_adjacent_labels(
            ds, wvd_nan, b), 1, 0),
        # the post-processing passes: weighted statistics with uncertainties
        # over (H, W) weights, weighted flag proportions, coverage statistics
        "POSTPROCESS_BYTES_PER_PX statistics": (lambda b: postprocess.weighted_label_stats(
            dense, area, fields, "bt", ds.coords["core"], "anvil", uncertainty=True,
            budget_bytes=b), 0, 0),
        "POSTPROCESS_BYTES_PER_PX proportions": (lambda b: postprocess.get_weighted_proportions_da(
            flag, area, dense, "anvil", index=ds.coords["core"], budget_bytes=b), 0, 0),
        "LABEL_STATS_BYTES_PER_PX": (label_stats, 0, 0),
        # the linker's passes: the pair histogram and the merge over the
        # shared interior (every frame but the first and last of two
        # volumes on one clock), and a family's lookup, in place
        "OVERLAP_BYTES_PER_PX": (lambda b: linking.find_overlap_between_labels(
            dense, times, other, times, device=dev, budget_bytes=b)[2:], 0, 0),
        "RELABEL_BYTES_PER_PX": (lambda b: in_place(lambda vol: file_linker._map_frames(
            "relabel_family", vol, None, lambda v: lut[v.long()].to(v.dtype), dev, b)), 0, 0),
        "MERGE_BYTES_PER_PX": (lambda b: in_place(lambda vol: file_linker._interior_merge(
            "merge_labels", vol, interior, other, interior, merged, lut, dev, b)), 0, 0),
        # validation's marker distance: each frame's exact transform and the
        # minimum over the 3-frame time margin (a 4-frame chunk reads 10)
        "VALIDATE_BYTES_PER_PX": (lambda b: validation.get_marker_distance(
            dense, 3, device=dev, budget_bytes=b), 3, 8),
        # the core subsegmentation of the anvil marker mask, as
        # get_anvil_markers runs it with a subsegment_shrink
        "SUBSEGMENT_BYTES_PER_PX": (lambda b: subsegment_labels(
            mask, 0.1, 10, device=dev, budget_bytes=b), 0, 4),
    }
    # the frames each pass reads, where not all t
    frames = {"OVERLAP_BYTES_PER_PX": t - 2, "MERGE_BYTES_PER_PX": t - 2}
    rows = {}
    for name, (call, halo, out_px) in stages.items():
        if only and not name.startswith(tuple(only)):
            continue
        copies.extend(bases[name].clone() for _ in range(2) if name in bases)
        whole, peak, sec = measured(lambda: call(NO_BUDGET))
        row = {"whole": peak / (frames.get(name, t) * h * w), "whole_s": sec}
        constant = getattr(port_device, name.split()[0])
        if name.startswith("CONVOLVE"):
            constant = 27 * constant + 4  # as ops.convolve plans its 27 taps and output
        budget = (CHUNK + 2 * halo) * constant * h * w + out_px * px
        chunked, peak, sec = measured(lambda: call(budget))
        row["chunked"] = (peak - out_px * px) / ((CHUNK + 2 * halo) * h * w)
        row["chunked_s"] = sec
        row["equal"] = whole is None or _equal(whole, chunked)
        if name.startswith("CONVOLVE"):
            row = {k: v / 27 if k in ("whole", "chunked") else v for k, v in row.items()}
        rows[name] = row
        print(json.dumps({"shape": [t, h, w], "stage": name, **row}), f"[{line}]", flush=True)
        if not row["equal"]:
            raise AssertionError(f"{name}: chunked result differs from the whole volume's")
        del whole, chunked
    return rows


def measure_models(args, dev, line):
    """Each model's flow stage, whole and in groups of one pair."""
    import gc

    from tobac_flow_tpu_torch.models import FLOW_MODELS, select_of_model

    names = [n for n in FLOW_MODELS if FLOW_MODELS[n] != "not_implemented"]
    if args.models != "all":
        names = args.models.split(",")
    t, h, w = args.model_depth, args.height, args.width
    bt = torch.from_numpy(make_scene(t, h, w)).to(dev)
    px = h * w
    opts = DetectionOptions()
    summary = {"card": line, "shape": [t, h, w], "rows": []}
    for name in names:
        for interp in ("cubic", "lanczos"):
            row = {"model": name, "interp_method": interp}
            for kind, group in (("whole", t - 1), ("groups", 1)):
                gc.collect()
                torch.cuda.empty_cache()
                (fwd, bwd), peak, sec = measured(lambda: pair_flows(
                    bt, select_of_model(name), opts.vr_steps, opts.smoothing_passes, interp,
                    device=dev, group=group))
                outputs = 0 if group == t - 1 else 2 * fwd.numel() * 4
                row[f"{kind}_bytes_per_pair_px"] = (peak - outputs) / (group * px)
                row[f"{kind}_s"] = sec
                row[f"{kind}_finite"] = bool(torch.isfinite(fwd).all()
                                             and torch.isfinite(bwd).all())
                del fwd, bwd
            summary["rows"].append(row)
            print(json.dumps(row), f"[{line}]", flush=True)
    summary["bytes_per_pair_px"] = {
        n: max(max(r["whole_bytes_per_pair_px"], r["groups_bytes_per_pair_px"])
               for r in summary["rows"] if r["model"] == n) for n in names}
    if args.json:
        Path(args.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}), f"[{line}]")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=1500)
    ap.add_argument("--width", type=int, default=2500)
    ap.add_argument("--depths", default="6,12,24")
    ap.add_argument("--chunked-depth", type=int, default=24)
    ap.add_argument("--flow-depth", type=int, default=12,
                    help="the deepest T whose flow stage runs as one group")
    ap.add_argument("--stage-depths", default="6,12")
    ap.add_argument("--only", default="",
                    help="comma-separated prefixes of the constants whose stages to measure")
    ap.add_argument("--stages-only", action="store_true",
                    help="measure the chain's chunked stages alone")
    ap.add_argument("--json", help="also write the numbers to this file")
    ap.add_argument("--models", default="",
                    help="measure these flow models' flow stage alone ('all': every one)")
    ap.add_argument("--model-depth", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flood_memory: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    line = card()
    if args.models:
        return measure_models(args, dev, line)
    h, w = args.height, args.width
    px = h * w
    opts = DetectionOptions()
    rows = []
    for t in [] if args.stages_only else [int(d) for d in args.depths.split(",")]:
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
        if any(key in r for r in rows):
            summary[f"max_{key}"] = max(r[key] for r in rows if key in r)
    only = [p for p in args.only.split(",") if p]
    stage_runs = [stage_rows(t, h, w, dev, line, only) for t in
                  (int(d) for d in args.stage_depths.split(",") if d)]
    summary["stages"] = stage_runs
    for name in stage_runs[0] if stage_runs else ():
        constant = name.split()[0]
        most = max(max(r[name]["whole"], r[name]["chunked"]) for r in stage_runs)
        summary[f"max_{constant}"] = max(summary.get(f"max_{constant}", 0), most)
        torch.cuda.empty_cache()
    if args.json:
        Path(args.json).write_text(json.dumps(summary, indent=1))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
