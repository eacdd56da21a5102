"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the port's CUDA kernel (``tobac_flow_tpu_torch/csrc/ws_sweeps.cu``)
   from source.
3. Holds the kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it (bit-equal is the tolerance), and times both.
4. Runs the fused flow → fields → watershed slice on ``make_scene(8, 160,
   224)`` on the GPU and on the CPU (plain versions): flows within the CPU
   tests' tolerance, labels at IoU ≥ 0.99.
5. Runs the full slice, ``make_scene(24, 1024, 1536)`` with its 24 storm
   markers, once to warm up and then three timed runs, each with the
   kernel's launch count reset just before it; checks the outputs, and that
   the three runs give the same labels.

The second-to-last lines are one JSON object describing each kernel and the
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
It imports nothing of JAX: the scene comes from ``bench.make_scene`` and
``bench.make_markers``, which need only numpy and scipy.
"""

from __future__ import annotations

import gc
import json
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
RUNS = 3
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
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernel(device):
    """Kernel against plain version, bit-equal, at the main path's shapes:
    K = 8 over the volume (Jacobi rounds), K = 1 (the in-plane part of a
    full sweep), K = 4 on one frame (scan rounds).  Returns the worst
    |kernel - plain| and both times at the bench shape, connectivity 1,
    K = 8."""
    cases = [((3, 230, 257), c, k) for c in (1, 2, 3) for k in (8, 4)]
    cases += [(FULL, c, k) for c in (1, 2, 3) for k in (8, 4)]
    cases += [(FULL, 1, 1), ((1,) + FULL[1:], 1, 4)]
    worst = 0.0
    for shape, conn, k in cases:
        args = sweep_inputs(shape, conn, device, IN_PLANE[conn])
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
        live = float((args[2] != 2**31 - 1).float().mean())
        changed = float(((kern[0] != args[0]) | (kern[1] != args[1])
                         | (kern[2] != args[2])).float().mean())
        log(f"kernel == plain (bit-equal) at {shape} connectivity={conn} K={k}; "
            f"labelled before {live:.4f}, changed by the sweeps {changed:.4f}")
        del args, plain, kern
    args = sweep_inputs(FULL, 1, device)
    ms = time_ms(lambda: ws_sweeps.spatial_sweeps(*args, IN_PLANE[1], 8), 10)
    plain_ms = time_ms(lambda: ws_sweeps.spatial_sweeps_reference(*args, IN_PLANE[1], 8), 3)
    return worst, ms, plain_ms


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

    worst, ms, plain_ms = check_kernel(device)
    log(f"ws_spatial_sweeps at {FULL}, connectivity 1, K=8: kernel {ms:.3f} ms, "
        f"plain PyTorch {plain_ms:.3f} ms [{card_line}]")

    # small slice: GPU against the CPU plain path
    bt = make_scene(*SMALL)
    markers, n_small = make_markers(bt)
    gpu = fused_flow_watershed(torch.from_numpy(bt).to(device), 5.0, markers=markers)
    cpu = fused_flow_watershed(torch.from_numpy(bt), 5.0, markers=markers)
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
    npix = float(np.prod(FULL))
    first = None
    for run in range(1, RUNS + 1):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        stats = {}
        ws_sweeps.spatial_sweeps.launches = 0
        t0 = time.perf_counter()
        fwd, growth, edges, labels = fused_flow_watershed(bt_dev, 5.0, markers=markers,
                                                          stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = ws_sweeps.spatial_sweeps.launches
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

    print(json.dumps({"kernels": [{
        "name": "ws_spatial_sweeps", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
