"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the port's CUDA kernel (``tobac_flow_tpu_torch/csrc/ws_sweeps.cu``)
   from source and prints ptxas's registers, spills and shared memory.
3. Holds the kernel against its plain PyTorch version on the card
   (bit-equal is the tolerance) at every shape class either path launches
   it with (``SHAPE_CLASSES``, and ``PROFILED_SHAPES`` of the chain's
   profiled run) and a ragged (3, 230, 257), for K = 1, 4, 8 and the 4 and
   8 in-plane taps; then times each shape class of ``SHAPE_CLASSES``
   (kernel and plain version) and computes its bound.
4. Runs the fused flow → fields → watershed slice on ``make_scene(8, 160,
   224)`` on the GPU and on the CPU (plain versions): flows within the CPU
   tests' tolerance, labels at IoU ≥ 0.99.
5. Runs the full slice, ``make_scene(24, 1024, 1536)`` with its 24 storm
   markers, once to warm up and then two timed runs, each with the
   kernel's launch counts reset just before it; checks the outputs, and
   that the runs give the same labels.
6. Runs the full slice once more under ``torch.profiler``, recording device
   activity alone: for each stage (its span on the host, which the
   ``stage.*`` profiler range also covers) the device operations started
   in it, the union of their intervals and the stage's idle share; the
   device ops with the most time, by name; and the kernel's own launches
   and device time in the run.
7. The detection CLI's pipeline (``cli.common.run_detection``: the chain,
   ``detect.chain.run_detection``, with the CLI-default flow, cores,
   anvil markers, thick anvils, their relabelling and thin anvils; then
   the output stages ``schema``, ``label_props`` and ``field_props``) on
   ``tools/parity_detect.make_multistorm_scene``.  On (9, 64, 96): the
   card's flows against the CPU's, with the CPU tests' Farneback tolerance
   inside the storm mask on every frame the CPU reproduces from the card's
   Farneback flows (refinement is chaotic where the flow is noise); then,
   given the same flows and with a NaN patch in WVD, the dataset built on
   the card against the CPU's (``compare_datasets``: identical but the
   float means and stds, held to the CPU tests' rtol 1e-5), every stage
   non-empty.  Then one profiled run on (6, 1024, 1536), split by the
   stages as in 6, which also warms the path up.  Then two timed runs on
   (8, 1024, 1536), the bench frame at its full width with the depth cut
   to 8 frames: each stage's seconds and objects, the variables, the peak
   memory and the kernel's launches by shape; every stage finds objects
   and the runs give identical datasets.  Last, the output stages on the
   CPU from the second run's labels, timed and held to the card's dataset.

Kernel times are CUDA-event times of a CUDA graph of back-to-back
launches, after a warm-up, so a launch's host cost does not count.  Each
launch reads one of enough copies of its inputs, and writes outputs of its
own, that it finds them cold in the card's 50 MB L2 cache; a launch that
fits in the L2 is also timed on one copy of its inputs (L2 warm).  The
lines before the last are the per-shape table, the profile, one JSON
object describing each kernel and the ``nvidia-smi`` name and power limit;
the last line is ``{"ok": true, "device": {...}}``.  Each log line starts
with the seconds since the script started.  Any failure raises and
exits non-zero.  It imports nothing of JAX, nor h5py: the scenes come from
``bench.make_scene``, ``bench.make_markers`` and
``tools/parity_detect.make_multistorm_scene``, which need only numpy and
scipy.
"""

from __future__ import annotations

import bisect
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
from tobac_flow_tpu_torch.core.flow import Flow, create_flow
from tobac_flow_tpu_torch.cli import common as cli
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset
from tobac_flow_tpu_torch.detect.chain import STAGES as CHAIN_STAGES
from tobac_flow_tpu_torch.detect.chain import DetectionOptions
from tobac_flow_tpu_torch.models.farneback import FarnebackFlow
from tobac_flow_tpu_torch.ops import ws_sweeps
from tobac_flow_tpu_torch.pipeline import _normalise_pair, fused_flow_watershed, pair_flows
from tools.parity_detect import make_multistorm_scene

SMALL = (8, 160, 224)
FULL = (24, 1024, 1536)
COARSE = (24, 256, 384)  # the watershed's 4x coarse grid of FULL
RUNS = 2
CHAIN_SMALL = (9, 64, 96)
# the chain's timed runs at the bench frame's full width with its depth cut
# to 8 frames, the fewest at which every cell of the scene lives through
# every stage (at 8 and 24 frames the stages find 24, 24, 24, 23 and 23
# objects; at 6, 15, 5, 5, 5 and 5).  On an H100 80GB HBM3 (700 W) a run
# took 280-293 s at 24 frames and 125-143 s at 8.  The profiled run is cut
# to 6 frames: the profiler's processing grows with the device ops, 4.6
# million at 6 frames (330-350 s with the run) and 6.2 million at 8.
CHAIN_FULL = (8,) + FULL[1:]
CHAIN_PROFILED = (6,) + FULL[1:]
CHAIN_RUNS = 2
CHAIN_LABELS = ("core_label", "anvil_marker_label", "thick_anvil_label", "thin_anvil_label")
# the stages of cli.common.run_detection: the chain's, then the output's
CLI_STAGES = CHAIN_STAGES + cli.OUTPUT_STAGES
# the coordinates that every stage's objects fill
CLI_COORDS = ("core", "anvil", "core_step", "thick_anvil_step", "thin_anvil_step")
CHAIN_COARSE = (CHAIN_FULL[0],) + COARSE[1:]
# (shape, K) of every launch of the bench slice and the chain's timed runs:
# the scan rounds' per-frame steps (K = 4), the in-plane part of each Jacobi
# round's full sweep (K = 1) and its 8 kernel sweeps (K = 8), on the fine
# and the coarse grid
SHAPE_CLASSES = (
    ((1,) + FULL[1:], 4), ((1,) + COARSE[1:], 4),
    (FULL, 1), (FULL, 8), (COARSE, 1), (COARSE, 8),
    (CHAIN_FULL, 1), (CHAIN_FULL, 8), (CHAIN_COARSE, 1), (CHAIN_COARSE, 8),
)
# the volumes the profiled chain run launches the kernel with besides
PROFILED_SHAPES = (CHAIN_PROFILED, (CHAIN_PROFILED[0],) + COARSE[1:])
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
STAGES = ("flow", "fields", "watershed")
TOP_OPS = 8  # device ops by total time printed per profile
KERNEL_SOURCE = "tobac_flow_tpu_torch/csrc/ws_sweeps.cu"
KERNEL_REPLACES = "tobac_flow_tpu/ops/ws_pallas.py:151"
IN_PLANE = {
    1: ((-1, 0), (0, -1), (0, 1), (1, 0)),
    2: ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)),
}
IN_PLANE[3] = IN_PLANE[2]  # connectivity 3 adds only temporal taps


T_START = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


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
    shapes = sorted({s for s, _ in SHAPE_CLASSES} | set(PROFILED_SHAPES) | {(3, 230, 257)},
                    key=np.prod)
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


def profile_run(run, stages, card_line, what):
    """One call of ``run`` under torch.profiler, recording device activity
    alone.  ``run`` returns the ``stats`` dict of the path it drives, whose
    ``{stage}_span_ns`` are the stages' spans on the host's Unix clock, the
    profiler's.  For each stage, the device operations (kernels, copies,
    fills) that start in its span, the union of their intervals and the
    share of the stage's wall time the device spent idle; the device ops
    with the most time, by name; and the sweep kernel's launches and
    device ms.  Raises if a stage saw no device op or the stages together
    saw under 99 % of the run's (the two clocks would disagree).  Returns
    (the sweep kernel's device ms in the run, its launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gc.collect()
    torch.cuda.synchronize()
    ws_sweeps.spatial_sweeps.launches = 0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stats = run()
        torch.cuda.synchronize()
        t_run = time.perf_counter()
    t_stop = time.perf_counter()
    counted = ws_sweeps.spatial_sweeps.launches
    # the raw events (µs), without building the profiler's event tree
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            start = e.start_ns() / 1e3
            ops.append((start, start + e.duration_ns() / 1e3, e.name()))
    ops.sort()
    starts = [s for s, _, _ in ops]
    in_stages = 0
    for name in stages:
        lo, hi = (t / 1e3 for t in stats[f"{name}_span_ns"])
        mine = ops[bisect.bisect_left(starts, lo):bisect.bisect_right(starts, hi)]
        if not mine:
            raise AssertionError(f"profile of {what}: no device op started inside the host "
                                 f"span of stage.{name}")
        in_stages += len(mine)
        busy = union_ms([(s, e) for s, e, _ in mine])
        wall = (hi - lo) / 1e3
        log(f"profile of {what}, stage.{name}: wall {wall / 1e3:.3f} s, device busy "
            f"{busy / 1e3:.3f} s, {len(mine)} device ops, idle "
            f"{100 * (1 - busy / wall):.1f} % [{card_line}]")
    if in_stages < 0.99 * len(ops):
        raise AssertionError(f"profile of {what}: the stages' host spans hold {in_stages} of "
                             f"the run's {len(ops)} device ops")
    by_name = {}
    for s, e, n in ops:
        total, count = by_name.get(n, (0.0, 0))
        by_name[n] = (total + e - s, count + 1)
    for n, (total, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_OPS]:
        log(f"profile of {what}, top device ops: {total / 1e3:.3f} ms in {count} launches "
            f"of {n[:110]} [{card_line}]")
    sweeps = [(s, e) for s, e, n in ops if "sweeps_kernel" in n]
    ms = sum(e - s for s, e in sweeps) / 1e3
    if len(sweeps) != counted:
        raise AssertionError(f"profile: {len(sweeps)} sweep kernels ran, the wrapper "
                             f"counted {counted} launches")
    log(f"profile of {what}: {len(ops)} device ops in the run, {in_stages} inside the "
        f"stages; the sweep kernel {len(sweeps)} launches, {ms:.3f} ms of device time; "
        f"profiled run {t_run - t0:.1f} s, the profiler's stop {t_stop - t_run:.1f} s, "
        f"the analysis {time.perf_counter() - t_stop:.1f} s [{card_line}]")
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


def chain_times(t):
    """A 5-minute time coordinate of ``t`` steps."""
    return np.datetime64("2020-06-01T00:00", "ns") + np.arange(t) * np.timedelta64(300, "s")


class GivenFlows(torch.nn.Module):
    """A pair-flow model that returns flows computed elsewhere."""

    def __init__(self, flows):
        super().__init__()
        self.flows = flows

    def forward(self, prev, nxt):
        return self.flows.to(prev.device)


def within(out, want, mask):
    """The CPU tests' Farneback tolerance inside ``mask``."""
    diff = np.abs(out - want)[mask]
    return bool(np.percentile(diff, 99) <= 0.01 and diff.max() <= 0.1
                and (np.round(out) == np.round(want))[mask].mean() >= 0.999)


def chain_inputs(bt, wvd, swd, times):
    """The chain scene's fields as the CLI's DataArrays (numpy or tensors)
    and an empty output dataset on their grid."""
    h, w = bt.shape[1:]
    coords = {"t": times, "y": np.arange(h) * 2000.0, "x": np.arange(w) * 2000.0}
    fields = [DataArray(a, coords=coords, dims=("t", "y", "x"), name=n,
                        attrs={"long_name": n, "units": "K"})
              for a, n in ((bt, "bt"), (wvd, "wvd"), (swd, "swd"))]
    return fields, Dataset(coords=coords)


def check_chain_small(device, card_line):
    """``cli.common.run_detection`` on the card against the CPU at
    CHAIN_SMALL.  Flows: the CPU tests' tolerance inside the storm mask on
    every frame where the CPU reproduces its own CLI-default flow from the
    card's Farneback flows.  Given the same flows, the datasets (labels of
    every stage, anvil markers and spatial properties included) are the
    same: identical but the float means and stds, which are held to the
    CPU tests' tolerance; and no stage is empty."""
    opts = DetectionOptions()
    bt, wvd, swd = make_multistorm_scene(*CHAIN_SMALL)
    times = chain_times(CHAIN_SMALL[0])
    kw = dict(vr_steps=opts.vr_steps, smoothing_passes=opts.smoothing_passes,
              interp_method=opts.interp_method)
    gpu = create_flow(bt, **kw)
    if gpu.device.type != device.type:
        raise AssertionError(f"create_flow ran on {gpu.device}, not on the card")
    cpu = create_flow(bt, device="cpu", **kw)
    frames = torch.from_numpy(bt).to(device)
    p8, n8 = _normalise_pair(frames[:-1], frames[1:])
    raw = FarnebackFlow().to(device)(torch.cat([p8, n8]), torch.cat([n8, p8])).cpu()
    again = [f.clamp(-20, 20) for f in pair_flows(bt, GivenFlows(raw), device="cpu", **kw)]
    storm = bt < 250
    checked, worst = 0, 0.0
    for g, c, a in zip(gpu.flow, cpu.flow, again):
        g, c, a = g.cpu().numpy(), c.numpy(), a.numpy()
        for t in range(CHAIN_SMALL[0]):
            if storm[t].any() and within(a[t], c[t], storm[t]):
                if not within(g[t], c[t], storm[t]):
                    raise AssertionError(f"chain small: card flow vs CPU flow at frame {t}")
                checked += 1
                worst = max(worst, float(np.abs(g[t] - c[t])[storm[t]].max()))
    if checked < 6:
        raise AssertionError(f"chain small: only {checked} frames reproducible on the CPU")
    log(f"chain small {CHAIN_SMALL}: card vs CPU CLI-default flow within the Farneback "
        f"tolerance on the {checked} of {2 * CHAIN_SMALL[0]} frames the CPU reproduces, "
        f"max |card - CPU| there {worst:.3g} px")
    wvd[3:6, 20:26, 40:46] = np.nan  # missing data at a cell's edge, as the CPU tests
    out = {}
    for where, flow in (("card", gpu), ("cpu", Flow(gpu.forward_flow.cpu(),
                                                     gpu.backward_flow.cpu()))):
        fields, ds = chain_inputs(bt, wvd, swd, times)
        opts = DetectionOptions(save_anvil_markers=True, save_spatial_props=True,
                                flow_factory=lambda _, flow=flow: flow)
        out[where] = cli.run_detection(*fields, ds, opts=opts,
                                       device=None if where == "card" else "cpu")
    counts = {name: int(out["cpu"][name].values.max()) for name in CHAIN_LABELS}
    if min(counts.values()) == 0 or min(out["cpu"].coords[c].size for c in CLI_COORDS) == 0:
        raise AssertionError(f"chain small: an empty stage: {counts}")
    worst = compare_datasets(out["cpu"], out["card"])
    log(f"chain small {CHAIN_SMALL}: cli.run_detection on the card gives the CPU's dataset "
        f"given the same flows ({len(out['cpu'].data_vars)} variables; float32 means and "
        f"stds within {worst:.3g}, the rest identical); objects {counts}")


# netCDF's own attributes of a variable read from a file
_FILE_ATTRS = ("DIMENSION_LIST", "REFERENCE_LIST", "CLASS", "NAME")


def manifest(ds):
    """Each variable's dims, dtype, shape and attrs, and the coordinates'
    names and dtypes."""
    return ({k: (v.dims, v.dtype, v.shape, {a: str(x) for a, x in v.attrs.items()
                                             if a not in _FILE_ATTRS})
             for k, v in ds.data_vars.items()},
            {k: c.dtype for k, c in ds.coords.items()})


def compare_datasets(want, got, rtol32=1e-5, rtol64=1e-12, loose=()):
    """Hold the dataset ``got`` to ``want``: the same variables (names,
    dims, dtypes, shapes, attrs) and coordinates; values identical for
    integers, bools, times and durations and for float32 variables other
    than means and stds (maxima, minima, fractions); float64 variables
    (sums and weighted means) within ``rtol64``; float32 means and stds,
    and the variables named in ``loose``, within ``rtol32``; NaN where
    ``want`` has NaN.  Raises AssertionError naming what differs; returns
    the largest relative error of the float32 means and stds."""
    (mine, my_coords), (theirs, their_coords) = manifest(got), manifest(want)
    if mine != theirs:
        diff = sorted(k for k in set(mine) | set(theirs) if mine.get(k) != theirs.get(k))
        raise AssertionError(f"variables differ in name, dims, dtype, shape or attrs: "
                             f"{[(k, theirs.get(k), mine.get(k)) for k in diff[:4]]}")
    if my_coords != their_coords:
        raise AssertionError(f"coordinates {my_coords} != {their_coords}")
    for k, c in want.coords.items():
        if not np.array_equal(c, got.coords[k]):
            raise AssertionError(f"coordinate {k} differs")
    worst = 0.0
    for k, v in want.data_vars.items():
        a, b = v.values, got[k].values
        if a.dtype.kind == "f":
            stat = a.dtype == np.float32 and k.endswith(("_mean", "_std"))
            rtol = rtol32 if stat or k in loose else rtol64 if a.dtype == np.float64 else 0.0
            nan = np.isnan(a)
            if not np.array_equal(nan, np.isnan(b)):
                raise AssertionError(f"{k}: NaN at other places")
            err = np.abs(a[~nan].astype(np.float64) - b[~nan]) / np.maximum(np.abs(a[~nan]), 1e-30)
            err = float(err.max()) if err.size else 0.0
            if err > rtol:
                raise AssertionError(f"{k}: relative error {err:.3g} over {rtol:.0e}")
            if stat:
                worst = max(worst, err)
        elif not np.array_equal(a, b, equal_nan=a.dtype.kind in "mM"):
            raise AssertionError(f"{k}: values differ at {int((a != b).sum())} places")
    return worst


def chain_fields(shape, device):
    t0 = time.perf_counter()
    bt, wvd, swd = make_multistorm_scene(*shape)
    log(f"made the chain's scene {shape} on the host in {time.perf_counter() - t0:.1f} s")
    return chain_inputs(*(torch.from_numpy(a).to(device) for a in (bt, wvd, swd)),
                        chain_times(shape[0]))


def run_cli(fields, stats, keep=None):
    """``cli.common.run_detection`` with ``DetectionOptions()`` on the
    chain scene's fields.  With a dict ``keep``, the label volumes that its
    output stages start from are also copied to the host into it (three
    copies, outside every stage)."""
    fields, ds = fields[0], Dataset(coords=fields[1].coords)
    if keep is None:
        return cli.run_detection(*fields, ds, stats=stats)
    prepare = cli.prepare_output

    def copy_then_prepare(dataset, *args):
        keep.update({k: DataArray(dataset[k].data.cpu(), dims=dataset[k].dims,
                                  attrs=dataset[k].attrs)
                     for k in CHAIN_LABELS if k in dataset})
        return prepare(dataset, *args)

    cli.prepare_output = copy_then_prepare
    try:
        return cli.run_detection(*fields, ds, stats=stats)
    finally:
        cli.prepare_output = prepare


def check_output_stages_on_cpu(out, labels, fields, card_line):
    """The output stages on the CPU from the card's labels (``labels``,
    copied to the host before the card's output stages), held to the
    card's dataset ``out`` as the CPU tests hold the card."""
    (bt, wvd, swd), ds = fields
    ds = Dataset(coords=ds.coords)
    for name, da in labels.items():
        ds[name] = da
    cpu_fields = [DataArray(f.data.cpu(), coords=f.coords, dims=f.dims, name=f.name,
                            attrs=f.attrs) for f in (bt, wvd, swd)]
    stats = {}
    t0 = time.perf_counter()
    cpu = cli.prepare_output(ds, *cpu_fields, device="cpu", stats=stats)
    seconds = time.perf_counter() - t0
    worst = compare_datasets(cpu, out)
    log(f"chain {CHAIN_FULL}: the output stages on the CPU from the card's labels take "
        f"{seconds:.3f} s (" + ", ".join(f"{n} {stats[n + '_s']:.3f} s"
                                           for n in cli.OUTPUT_STAGES)
        + f") and give the card's dataset: float32 means and stds within {worst:.3g}, "
        f"the rest identical [{card_line}, {torch.get_num_threads()} CPU threads]")


def run_chain_full(device, card_line):
    """``cli.common.run_detection``'s profiled run at CHAIN_PROFILED, which
    also warms it up, then CHAIN_RUNS timed runs at CHAIN_FULL (the
    kernel's counts reset just before each and read just after), the last
    also checked against the output stages on the CPU.  Returns (launches
    per run, launches by shape, profiled sweep ms, profiled sweep
    launches)."""
    fields = chain_fields(CHAIN_PROFILED, device)

    def profiled_run():
        stats = {}
        run_cli(fields, stats)
        return stats

    profiled = profile_run(profiled_run, CLI_STAGES, card_line,
                           f"cli.run_detection {CHAIN_PROFILED}")
    del fields
    fields = chain_fields(CHAIN_FULL, device)
    sweeps = ws_sweeps.spatial_sweeps
    first = None
    for run in range(1, CHAIN_RUNS + 1):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        stats, labels = {}, ({} if run == CHAIN_RUNS else None)
        sweeps.launches = 0
        sweeps.launches_by_shape.clear()
        t0 = time.perf_counter()
        out = run_cli(fields, stats, labels)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = sweeps.launches
        by_shape = {shape_key(key[:3], key[3]): n for key, n in sweeps.launches_by_shape.items()}
        peak = torch.cuda.max_memory_allocated()
        if launches == 0:
            raise AssertionError("chain: the ws_sweeps kernel was never launched")
        empty = [name for name in CHAIN_STAGES[1:] if stats[name + "_n"] == 0]
        empty += [c for c in CLI_COORDS if out.coords[c].size == 0]
        if empty:
            raise AssertionError(f"chain run {run}: no objects in {empty}")
        for name, da in out.data_vars.items():
            if da.dtype.kind == "f" and name.endswith("_mean") and np.isnan(da.values).all():
                raise AssertionError(f"chain run {run}: {name} is NaN for every object")
        if first is None:
            first = out
        else:
            compare_datasets(first, out, rtol32=0.0, rtol64=0.0)
        log(f"chain {CHAIN_FULL} run {run} through cli.run_detection [{card_line}]: "
            f"{seconds:.3f} s; " + ", ".join(
                f"{name} {stats[name + '_s']:.3f} s" for name in CLI_STAGES) + "; objects "
            + ", ".join(f"{name} {stats[name + '_n']}" for name in CHAIN_STAGES[1:])
            + f"; {len(out.data_vars)} variables, " + ", ".join(
                f"{c} {out.coords[c].size}" for c in CLI_COORDS)
            + f"; kernel launches {launches} {by_shape}; device memory resident at start "
            f"{resident / 2**30:.3f} GiB, peak {peak / 2**30:.3f} GiB")
        del out
    log("chain: the runs give equal datasets, every variable identical")
    check_output_stages_on_cpu(first, labels, fields, card_line)
    return launches, by_shape, *profiled


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

    def profiled_slice():
        stats = {}
        fused_flow_watershed(bt_dev, 5.0, markers=markers, stats=stats)
        return stats

    profiled_ms, profiled_launches = profile_run(profiled_slice, STAGES, card_line,
                                                 "the bench slice")
    del bt_dev, first

    # the detection chain: card against CPU on a small scene, then the full
    # scene through the kernel
    check_chain_small(device, card_line)
    chain_launches, chain_by_shape, chain_profiled_ms, chain_profiled_launches = (
        run_chain_full(device, card_line))
    unknown = set(chain_by_shape) - set(per_shape)
    if unknown:
        raise AssertionError(f"the chain launched the kernel at untimed shapes {sorted(unknown)}")
    paths = {"fused_flow_watershed": by_shape, "run_detection": chain_by_shape}

    for key, row in per_shape.items():
        n = by_shape.get(key, 0)
        m = chain_by_shape.get(key, 0)
        log(f"shape {key}: {row['ms']:.4f} ms per launch cold ({row['warm_l2_ms']:.4f} warm), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound; launches per run "
            f"{n} (bench slice), {m} (detection chain); ms per run cold "
            f"{n * row['ms']:.3f} and {m * row['ms']:.3f} [{card_line}]")

    def per_run(field, counts):
        return sum(n * per_shape[key][field] for key, n in counts.items())

    def both(field):
        return sum(per_run(field, counts) for counts in paths.values())

    print(json.dumps({"kernels": [{
        "name": "ws_spatial_sweeps", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches + chain_launches,
        "max_abs_err": worst,
        "ms": both("ms"), "plain_ms": both("plain_ms"), "bound_ms": both("bound_ms"),
        "bound_by": "bytes" if both("bytes_ms") >= both("ops_ms") else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "per": "one run of each main path (the bench slice and the detection chain): the "
               "sum over its launches_by_shape of launches x ms per launch, with the "
               "inputs cold in L2",
        "launches_by_path": {p: sum(c.values()) for p, c in paths.items()},
        "ms_by_path": {p: per_run("ms", c) for p, c in paths.items()},
        "plain_ms_by_path": {p: per_run("plain_ms", c) for p, c in paths.items()},
        "bound_ms_by_path": {p: per_run("bound_ms", c) for p, c in paths.items()},
        "warm_l2_ms": both("warm_l2_ms"),
        "profiled_ms_by_path": {"fused_flow_watershed": profiled_ms,
                                "run_detection": chain_profiled_ms},
        "profiled_launches_by_path": {"fused_flow_watershed": profiled_launches,
                                      "run_detection": chain_profiled_launches},
        "profiled_shapes": {"fused_flow_watershed": "x".join(map(str, FULL)),
                            "run_detection": "x".join(map(str, CHAIN_PROFILED))},
        "ms_by_shape": {k: r["ms"] for k, r in per_shape.items()},
        "warm_l2_ms_by_shape": {k: r["warm_l2_ms"] for k, r in per_shape.items()},
        "plain_ms_by_shape": {k: r["plain_ms"] for k, r in per_shape.items()},
        "bound_ms_by_shape": {k: r["bound_ms"] for k, r in per_shape.items()},
        "launches_by_shape": paths,
    }]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
