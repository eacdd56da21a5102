"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the port's CUDA kernel (``tobac_flow_tpu_torch/csrc/ws_sweeps.cu``)
   from source and prints ptxas's registers, spills and shared memory.
3. Holds the kernel against its plain PyTorch version on the card
   (bit-equal is the tolerance) at every shape class the main path launches
   it with (``SHAPE_CLASSES``) and a ragged (3, 230, 257), for K = 1, 4, 8
   and the 4 and 8 in-plane taps; then times each shape class (kernel and
   plain version) and computes its bound.
4. Runs the fused flow → fields → watershed slice on ``make_scene(8, 160,
   224)`` on the GPU and on the CPU (plain versions): flows within the CPU
   tests' tolerance, labels at IoU ≥ 0.99.
5. Runs the full slice, ``make_scene(24, 1024, 1536)`` with its 24 storm
   markers, once to warm up and then three timed runs, each with the
   kernel's launch counts reset just before it; checks the outputs, and
   that the three runs give the same labels.
6. Runs the full slice once more under ``torch.profiler``: for each stage
   (the pipeline's ``stage.*`` ranges) the device operations started in it,
   the union of their intervals and the stage's idle share, and the
   kernel's own launches and device time in the run.

Kernel times are CUDA-event times of a CUDA graph of back-to-back
launches, after a warm-up, so a launch's host cost does not count.  Each
launch reads one of enough copies of its inputs, and writes outputs of its
own, that it finds them cold in the card's 50 MB L2 cache; a launch that
fits in the L2 is also timed on one copy of its inputs (L2 warm).  The
lines before the last are the per-shape table, the profile, one JSON
object describing each kernel and the ``nvidia-smi`` name and power limit;
the last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  It imports nothing of JAX: the scene comes from
``bench.make_scene`` and ``bench.make_markers``, which need only numpy and
scipy.
"""

from __future__ import annotations

import gc
import json
import math
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from bench import make_markers, make_scene
from tobac_flow_tpu_torch.ops import ws_sweeps
from tobac_flow_tpu_torch.pipeline import fused_flow_watershed

SMALL = (8, 160, 224)
FULL = (24, 1024, 1536)
COARSE = (24, 256, 384)  # the watershed's 4x coarse grid of FULL
RUNS = 3
# (shape, K) of every launch of the bench slice: the scan rounds' per-frame
# steps (K = 4), the in-plane part of each Jacobi round's full sweep (K = 1)
# and its 8 kernel sweeps (K = 8), on the fine and the coarse grid
SHAPE_CLASSES = (
    ((1,) + FULL[1:], 4), ((1,) + COARSE[1:], 4),
    (FULL, 1), (FULL, 8), (COARSE, 1), (COARSE, 8),
)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores, the same source
# compares, selects and integer adds issue at 64 lanes per SM and clock on
# sm_90: a quarter of the float32 rate, which counts an FMA at 128 lanes as
# two operations
INT_CMP_OPS_PER_S = FP32_OPS_PER_S / 4
L2_BYTES = 50 * 2**20  # H100 SXM
IN_BYTES_PER_PIXEL = 18  # claim, claim2, meta, field (4 B) + seeded, floodable (1 B)
OUT_BYTES_PER_PIXEL = 12  # claim, claim2, meta
# compares, selects and integer adds of one tap's fold in one sweep (the
# lexicographic compare, the hop tick, the three selects); the candidate
# build, once per cell and sweep, is not counted
OPS_PER_TAP = 19
STAGES = ("stage.flow", "stage.fields", "stage.watershed")
KERNEL_SOURCE = "tobac_flow_tpu_torch/csrc/ws_sweeps.cu"
KERNEL_REPLACES = "tobac_flow_tpu/ops/ws_pallas.py:151"
IN_PLANE = {
    1: ((-1, 0), (0, -1), (0, 1), (1, 0)),
    2: ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)),
}
IN_PLANE[3] = IN_PLANE[2]  # connectivity 3 adds only temporal taps


def log(msg):
    print(msg, flush=True)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sweep_inputs(shape, seed, device, in_plane=IN_PLANE[1]):
    """A flood part-way through, as (claim, claim2, meta, field, seeded,
    floodable): a quantised field (plateaus), a seed on about 1 % of pixels
    with a label from 1..24 or the -1 barrier, 10 % unmasked pixels, and the
    state after 8 plain sweeps from those seeds.  At (3, 230, 257) and
    connectivity 1, 64 % of pixels then hold a label and the next 8 sweeps
    change 58 % of them."""
    rng = np.random.default_rng(seed)
    field = np.round(rng.uniform(0, 1, shape) * 16).astype(np.float32) / 16
    seeded = rng.uniform(0, 1, shape) < 0.01
    labels = rng.integers(0, 25, shape).astype(np.int32)
    labels[labels == 0] = -1
    floodable = (rng.uniform(0, 1, shape) > 0.1) & ~seeded
    claim = np.where(seeded, -np.inf, np.inf).astype(np.float32)
    meta = np.where(seeded, labels + 2, 2**31 - 1).astype(np.int32)
    args = [torch.from_numpy(a).to(device)
            for a in (claim, claim.copy(), meta, field, seeded, floodable)]
    args[:3] = ws_sweeps.spatial_sweeps_reference(*args, in_plane, 8)
    return args


def max_abs_err(a, b):
    """Max |a - b| with equal values (infinities included) counting 0."""
    diff = torch.where(a == b, 0.0, (a.double() - b.double()).abs())
    return float(torch.nan_to_num(diff, nan=float("inf")).max())


def time_ms(fn, reps):
    """Mean ms per call of ``reps`` back-to-back calls, by CUDA events,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, arg_sets, launches, replays=3):
    """Mean device ms per launch of ``fn``: ``launches`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events after a
    warm-up replay, so that no host work sits between the launches.  Launch
    i reads ``arg_sets[i % len(arg_sets)]``; with more than one set, every
    launch's outputs are kept until the graph is freed, so that no two
    launches of a replay write the same memory."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    kept = []
    with torch.cuda.graph(graph):
        for i in range(launches):
            out = fn(*arg_sets[i % len(arg_sets)])
            if len(arg_sets) > 1:
                kept.append(out)
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * launches)
    del graph, kept, out
    torch.cuda.empty_cache()
    return ms


def cold_sets(args):
    """``args`` and enough copies of it that together they hold at least
    four times the L2, so that a launch does not find its inputs there."""
    n = -(-4 * L2_BYTES // (IN_BYTES_PER_PIXEL * args[0].numel()))
    return [args] + [[a.clone() for a in args] for _ in range(n - 1)]


def shape_key(shape, k):
    return "x".join(map(str, shape)) + f" K={k}"


def graph_launches(shape):
    """Launches per CUDA graph: about 2e8 pixels of work, between 5 and
    200 launches."""
    return max(5, min(200, int(2e8 // np.prod(shape))))


def bound(shape, k, n_taps):
    """(bytes ms, operations ms) of one launch: the bytes it must move over
    the card's memory rate, and the compares, selects and adds its taps
    need over their issue rate.  The bound is the larger of the two."""
    pixels = float(np.prod(shape))
    return ((IN_BYTES_PER_PIXEL + OUT_BYTES_PER_PIXEL) * pixels / HBM_BYTES_PER_S * 1e3,
            k * n_taps * OPS_PER_TAP * pixels / INT_CMP_OPS_PER_S * 1e3)


def check_kernel(device):
    """Kernel against plain version, bit-equal, at every shape class of the
    main path and a ragged shape, K = 1, 4, 8, 4 and 8 taps (and
    connectivity 3, whose in-plane taps are connectivity 2's, at the ragged
    and the bench shape).  Returns the worst |kernel - plain|."""
    shapes = sorted({s for s, _ in SHAPE_CLASSES} | {(3, 230, 257)}, key=np.prod)
    worst = 0.0
    for shape in shapes:
        conns = (1, 2, 3) if shape in ((3, 230, 257), FULL) else (1, 2)
        for conn in conns:
            args = sweep_inputs(shape, conn, device, IN_PLANE[conn])
            live = float((args[2] != 2**31 - 1).float().mean())
            for k in (8, 4, 1):
                plain = ws_sweeps.spatial_sweeps_reference(*args, IN_PLANE[conn], k)
                kern = ws_sweeps.spatial_sweeps(*args, IN_PLANE[conn], k)
                torch.cuda.synchronize()
                for name, a, b in zip(("claim", "claim2", "meta"), plain, kern):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"kernel != plain at {shape} conn={conn} K={k}: {name} differs "
                            f"at {(a != b).sum().item()} pixels"
                        )
                    worst = max(worst, max_abs_err(a, b))
                changed = float(((kern[0] != args[0]) | (kern[1] != args[1])
                                 | (kern[2] != args[2])).float().mean())
                log(f"kernel == plain (bit-equal) at {shape} connectivity={conn} K={k}; "
                    f"labelled before {live:.4f}, changed by the sweeps {changed:.4f}")
                del plain, kern
            del args
    return worst


def time_shape_classes(device, card_line):
    """Kernel ms per launch with its inputs cold in L2 and, where one
    launch fits in L2, warm; plain ms; and the bound, at every shape class
    (connectivity 1, from the live state of ``sweep_inputs``)."""
    rows = {}
    for shape, k in SHAPE_CLASSES:
        args = sweep_inputs(shape, 1, device)
        sets = cold_sets(args)

        def launch(*a):
            return ws_sweeps.spatial_sweeps(*a, IN_PLANE[1], k)

        ms = graph_ms(launch, sets, graph_launches(shape))
        warm_ms = graph_ms(launch, [args], graph_launches(shape)) if len(sets) > 1 else ms
        plain_ms = time_ms(lambda: ws_sweeps.spatial_sweeps_reference(*args, IN_PLANE[1], k), 3)
        bytes_ms, ops_ms = bound(shape, k, len(IN_PLANE[1]))
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        rows[shape_key(shape, k)] = {"ms": ms, "warm_l2_ms": warm_ms, "plain_ms": plain_ms,
                                     "bound_ms": bound_ms, "bound_by": bound_by,
                                     "bytes_ms": bytes_ms, "ops_ms": ops_ms}
        log(f"ws_spatial_sweeps at {shape_key(shape, k)}, connectivity 1: kernel {ms:.4f} ms "
            f"cold ({len(sets)} input copies), {warm_ms:.4f} ms on one copy; plain PyTorch "
            f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}; bytes {bytes_ms:.4f}, "
            f"operations {ops_ms:.4f}), {100 * bound_ms / ms:.1f} % of the bound [{card_line}]")
        del args, sets
    return rows


def union_ms(intervals):
    """ms covered by the union of (start, end) intervals in µs."""
    total, end = 0.0, -math.inf
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total / 1e3


def profile_slice(bt, markers, card_line):
    """One run of the slice under torch.profiler.  For each stage range,
    the device operations (kernels, copies, fills) that start in it, the
    union of their intervals and the share of the stage's wall time the
    device spent idle; and the sweep kernel's launches and device ms.
    Returns (the sweep kernel's device ms in the run, its launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.synchronize()
    ws_sweeps.spatial_sweeps.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_flow_watershed(bt, 5.0, markers=markers, stats={})
        torch.cuda.synchronize()
    counted = ws_sweeps.spatial_sweeps.launches
    events = prof.events()
    ranges = {e.name: (e.time_range.start, e.time_range.end) for e in events
              if e.name in STAGES and e.device_type == DeviceType.CPU}
    ops = [(e.time_range.start, e.time_range.end, e.name) for e in events
           if e.device_type == DeviceType.CUDA and e.name not in STAGES
           and not getattr(e, "is_user_annotation", False)]
    if set(ranges) != set(STAGES) or not ops:
        raise AssertionError(f"profile: stage ranges {sorted(ranges)}, {len(ops)} device ops")
    for name in STAGES:
        lo, hi = ranges[name]
        mine = [(s, e) for s, e, _ in ops if lo <= s <= hi]
        busy = union_ms(mine)
        wall = (hi - lo) / 1e3
        log(f"profile, {name}: wall {wall / 1e3:.3f} s, device busy {busy / 1e3:.3f} s, "
            f"{len(mine)} device ops, idle {100 * (1 - busy / wall):.1f} % [{card_line}]")
    sweeps = [(s, e) for s, e, n in ops if "sweeps_kernel" in n]
    ms = sum(e - s for s, e in sweeps) / 1e3
    if len(sweeps) != counted:
        raise AssertionError(f"profile: {len(sweeps)} sweep kernels ran, the wrapper "
                             f"counted {counted} launches")
    log(f"profile: {len(ops)} device ops in the run; the sweep kernel {len(sweeps)} launches, "
        f"{ms:.3f} ms of device time [{card_line}]")
    return ms, len(sweeps)


def iou_and_agreement(a, b):
    fa, fb = a != 0, b != 0
    both = fa & fb
    iou = float((fa & fb).sum() / max((fa | fb).sum(), 1))
    agree = float((a[both] == b[both]).mean()) if both.any() else 1.0
    return iou, agree


def flow_gate(out, ref, mask):
    """The CPU tests' Farneback tolerance inside the storm mask."""
    diff = np.abs(out - ref)[mask]
    p99, mx = float(np.percentile(diff, 99)), float(diff.max())
    rounded = float((np.round(out) == np.round(ref))[mask].mean())
    if not (p99 <= 0.01 and mx <= 0.1 and rounded >= 0.999):
        raise AssertionError(f"GPU flow vs CPU flow: p99 {p99}, max {mx}, rounded {rounded}")
    return p99, mx, rounded


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card_line = card()
    log(f"card: {card_line}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    shutil.rmtree(ws_sweeps._BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    ws_sweeps.build_library()
    log(f"built {KERNEL_SOURCE} with nvcc in {time.perf_counter() - t0:.2f} s")
    for line in ws_sweeps.build_library.report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")

    worst = check_kernel(device)
    per_shape = time_shape_classes(device, card_line)

    # small slice: GPU (the default device) against the CPU plain path
    bt = make_scene(*SMALL)
    markers, n_small = make_markers(bt)
    gpu = fused_flow_watershed(bt, 5.0, markers=markers)
    if gpu[3].device.type != "cuda":
        raise AssertionError(f"fused_flow_watershed ran on {gpu[3].device}, not on the card")
    cpu = fused_flow_watershed(bt, 5.0, markers=markers, device="cpu")
    field = np.clip((260.0 - bt) / 10.0, 0.0, 1.0)
    p99, mx, rounded = flow_gate(gpu[0].cpu().numpy(), cpu[0].numpy(), field > 0.05)
    iou, agree = iou_and_agreement(gpu[3].cpu().numpy(), cpu[3].numpy())
    if iou < 0.99:
        raise AssertionError(f"small slice: GPU vs CPU label IoU {iou}")
    log(f"small slice {SMALL}: flow |GPU-CPU| p99 {p99:.3g} max {mx:.3g} rounded-equal "
        f"{rounded:.5f}; labels IoU {iou:.5f} agreement {agree:.5f}")
    del gpu, cpu

    # full slice: warm-up, then timed runs through the kernel
    bt = make_scene(*FULL)
    markers, n_markers = make_markers(bt)
    bt_dev = torch.from_numpy(bt).to(device)
    fused_flow_watershed(bt_dev, 5.0, markers=markers)
    sweeps = ws_sweeps.spatial_sweeps
    npix = float(np.prod(FULL))
    first = None
    for run in range(1, RUNS + 1):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        stats = {}
        sweeps.launches = 0
        sweeps.launches_by_shape.clear()
        t0 = time.perf_counter()
        fwd, growth, edges, labels = fused_flow_watershed(bt_dev, 5.0, markers=markers,
                                                          stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = sweeps.launches
        by_shape = {shape_key(key[:3], key[3]): n for key, n in sweeps.launches_by_shape.items()}
        peak = torch.cuda.max_memory_allocated()

        if not bool(torch.isfinite(fwd).all()):
            raise AssertionError("full slice: non-finite flow")
        if launches == 0:
            raise AssertionError("full slice: the ws_sweeps kernel was never launched")
        if first is None:
            first = labels
        elif not torch.equal(first, labels):
            raise AssertionError(f"full slice: run {run} labels differ from run 1")
        log(f"full slice {FULL}, {n_markers} markers, run {run} [{card_line}]: "
            f"{seconds:.3f} s, {npix / 1e6 / seconds:.3f} Mpix/s; flow "
            f"{stats['flow_s']:.3f} s, fields {stats['fields_s']:.3f} s, watershed "
            f"{stats['watershed_s']:.3f} s; kernel launches {launches}; device memory "
            f"resident at start {resident / 2**30:.3f} GiB, peak {peak / 2**30:.3f} GiB")
        del fwd, growth, edges, labels
    lab = first.cpu().numpy()
    present = set(np.unique(lab[lab > 0]).tolist())
    if present != set(range(1, n_markers + 1)):
        raise AssertionError(f"full slice: labels {sorted(present)} != 1..{n_markers}")
    if not np.array_equal(lab[markers != 0], markers[markers != 0]):
        raise AssertionError("full slice: a marker lost its label")
    log("watershed rounds: " + ", ".join(
        f"{k} {v}" for k, v in sorted(stats.items()) if k.endswith("rounds")))
    log(f"labelled pixels {int((lab != 0).sum())}; runs give equal labels")
    unknown = set(by_shape) - set(per_shape)
    if unknown:
        raise AssertionError(f"the slice launched the kernel at untimed shapes {sorted(unknown)}")
    profiled_ms, profiled_launches = profile_slice(bt_dev, markers, card_line)

    for key, row in per_shape.items():
        n = by_shape.get(key, 0)
        log(f"shape {key}: {row['ms']:.4f} ms per launch cold ({row['warm_l2_ms']:.4f} warm), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound, {n} launches per run, "
            f"{n * row['ms']:.3f} ms per run cold ({n * row['warm_l2_ms']:.3f} warm) "
            f"[{card_line}]")

    def per_run(field):
        return sum(n * per_shape[key][field] for key, n in by_shape.items())

    print(json.dumps({"kernels": [{
        "name": "ws_spatial_sweeps", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": per_run("ms"), "plain_ms": per_run("plain_ms"), "bound_ms": per_run("bound_ms"),
        "bound_by": "bytes" if per_run("bytes_ms") >= per_run("ops_ms") else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "per": "one bench-slice run: the sum over launches_by_shape of launches x ms per "
               "launch, with the inputs cold in L2",
        "warm_l2_ms": per_run("warm_l2_ms"),
        "profiled_ms": profiled_ms, "profiled_launches": profiled_launches,
        "ms_by_shape": {k: r["ms"] for k, r in per_shape.items()},
        "warm_l2_ms_by_shape": {k: r["warm_l2_ms"] for k, r in per_shape.items()},
        "plain_ms_by_shape": {k: r["plain_ms"] for k, r in per_shape.items()},
        "bound_ms_by_shape": {k: r["bound_ms"] for k, r in per_shape.items()},
        "launches_by_shape": by_shape,
    }]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
