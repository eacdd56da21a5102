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
   the output stages ``schema``, ``label_props`` and ``field_props``).  On
   ``tools/parity_detect.make_multistorm_scene(9, 64, 96)``: the card's
   flows against the CPU's, with the CPU tests' Farneback tolerance inside
   the storm mask on every frame the CPU reproduces from the card's
   Farneback flows (refinement is chaotic where the flow is noise); then,
   given the same flows and with a NaN patch in WVD, the dataset built on
   the card against the CPU's (``compare_datasets``: identical but the
   float means and stds, held to the CPU tests' rtol 1e-5), every stage
   non-empty.  Then one profiled run on (6, 1024, 1536), split by the
   stages as in 6, which also warms the path up.
8. The GOES ingest's output through it.  ``goes_frames`` turns
   ``make_multistorm_scene`` into GOES-16 MCMIP channels on the CONUS
   fixed grid (NaN off the Earth's disk, a DQF box, a flagged row, three
   missing frames), and the port's ingest (``data.dataloader``: masking,
   stacking, the NaN gap frame, lat, lon and pixel area) runs on them from
   memory, as ``goes_dataloader`` does after its file reads (no h5py).
   On the CPU tests' small GOES scene: the card's dataset against the
   CPU's given the same flows.  Then the CONUS-shaped run: 8 real frames
   and 1 NaN frame of 1500x2500 through ``cli.common.run_detection`` on
   the card, timed: each stage's seconds, peak memory and objects, the
   kernel's launches by shape; every stage finds objects, the
   area-weighted field statistics are finite for every object with a
   non-NaN pixel, and the output stages on the CPU from the card's labels
   give the card's dataset.
9. The time-chunked flood.  On ``CHUNK_SMALL`` in 3 chunks, with the
   slice's markers and with a -1 barrier ring: the card's labels equal the
   CPU's given the same inputs.  At ``FIT_DEPTH`` frames of the standard
   job's 1500x2500 (``JOB_FRAME``), which the card floods whole: chunked
   in 3 chunks against whole, agreement at least 0.995.  Then the main
   path, ``fused_flow_watershed``, at 1500x2500 and 1.4 times the most
   frames the card floods whole (``FLOOD_BYTES_PER_PX`` against its free
   memory), in at least 3 chunks: each stage's seconds and peak, the
   chunks, passes and chunk floods, the peak memory; every marker keeps
   its label and a label crosses every chunk boundary.  Last, the kernel
   against its plain version (bit-equal) and timed at each shape class
   that the CONUS-shaped GOES run and these floods launched it with and 3
   did not cover.
10. Cross-file linking, which floods nothing (0 kernel launches).  Where
   h5py is absent, each of the four linking CLIs raises naming it before
   any read or pass.  (a) FileLinker, LabelLinker and the batch path on
   the card over the four recorded JAX detection windows
   (``tests/data/linking_windows.npz``), from memory, whole and under a
   budget that runs every pass over a volume in at least 3 chunks: each
   output identical to the JAX package's recorded output.  (b) After the
   deep chain (``create_flow``, ``detect_cores`` and ``get_anvil_markers``
   at 1500x2500 past the depth whose cores the card holds whole), three
   windows in the GOES CLI's layout cut from its volumes, linked by all
   three under the card's own budget: each pass's seconds, peak, budget,
   chunks and links; the labels held to the deep volume's.
11. Statistics and post-processing, which flood nothing (0 kernel
   launches; ``run_statistics``).  Where h5py is absent, each of the four
   statistics CLIs raises naming it before any read or pass.  The three
   linked windows (the batch path's, their anvils widened, through the
   detection schema, with the pixel areas, lat and lon of GOES-16's
   fixed grid) go through ``relabel_postprocess`` (spatial properties
   on), ``postprocess_dcc`` (CTT and CTH with uncertainties, a flag
   field's proportions and the TOA net CRE from six fluxes, all made on
   the card from a seed) and ``dcc_statistics`` from memory on the card
   under its own budget: each step's seconds, peak against its budget,
   chunks, and the objects before and after the filters; cores and
   anvils survive, some valid.  On the middle window's first 9 frames the
   card's datasets equal the CPU's, and forced chunks (every new pass in
   at least 3) equal the whole run's.
12. Validation against GLM lightning, which floods nothing (0 kernel
   launches; ``run_validation``).  Seeded flashes over the three windows
   (at pixels inside the cores and the thick anvils, and false ones),
   gridded on the card by ``regrid_glm`` with parallax correction, then
   ``validate_cores`` and ``validate_anvils`` (thick and thin) on every
   window and the with-anvils and with-cores variants on the middle one,
   under the card's own budget: each step's seconds (the transforms, the
   per-object reductions, the binning), peak against its budget and
   chunks, the flashes, POD and FAR and the depth validation reaches.
   Checks: the counts equal numpy's ``histogram2d``; the transform equals
   scipy's on whole frames; on a 9x375x625 cut the card equals the CPU;
   forced chunks equal the whole run; POD in (0, 1], FAR in [0, 1].
13. The SEVIRI native ingest and detection (``run_seviri``): 8 full-disk
   3712x3712 native archives (9 scans 15 minutes apart, one missing),
   written with ``write_nat`` in 8 threads, decoded and cropped to
   640x640 by ``seviri_nat_dataloader`` (timed per file), then
   ``dcc_detect_seviri_nat``'s detection on the card: the gap is one NaN
   frame, every stage finds objects, and its kernel launches join the
   kernels line under their own path.
14. The configured detection: a ``PipelineConfig`` (``CONFIGURED``: DIS
   flow, Lanczos smoothing, core subsegmentation) written as JSON and
   read back.  (a) Card against CPU (the CPU's sides in the worker
   process, beside the small checks of 7-9): each of the six flow models
   on 3 pairs of ``make_multistorm_scene(5, 128, 192)`` within the
   Farneback gate; ``subsegment_labels`` of its cold cores identical; the
   configuration through ``cli.common.run_detection`` at (9, 48, 64)
   given the card's flows, the same dataset.  (b) At the GOES job's frame
   (8's CONUS-shaped scene, 9x1500x2500 with its NaN frame): the
   configured chain's ``create_flow``, ``detect_cores`` and
   ``get_anvil_markers`` (whose subsegmentation floods in plane), with
   the kernel's counts reset before and read after (the kernels line's
   ``run_detection_configured``), then ``create_flow`` with each other
   model: seconds, peak over the start against the budget, groups of
   pairs and objects; flows finite off the gap frame and within the clip,
   cores and anvil markers found; the anvil marker mask's subsegmentation
   in forced 4-frame time chunks equal to the whole volume's.  The anvil
   floods under these flows are left to (a).
15. The legacy path, and the radar and flux gridding.  (a) Card against
   CPU (the CPU's side in the worker process), given the card's
   CLI-default flow of the legacy CLI's scene at (9, 96, 128): the legacy
   CLI's ``detect_legacy`` (growth markers, edge watershed), its labels'
   ``get_stats_for_labels``, ``detect_anvils(markers=None)`` and
   ``legacy.flow_network_watershed`` on a cut, a crafted Level-II archive
   (written here) decoded and gridded in 2D and 3D, and ``grid_flux`` and
   ``grid_flux_native`` from memory: identical; the op-by-op filters give
   ``fused.core_markers``' markers.  (b) ``detect_legacy`` on the GOES
   scene's first LEGACY_FRAMES frames at 1500x2500, with the kernel's
   counts reset before and read after (the kernels line's
   ``dcc_detect_legacy``): each step's seconds and peak, at least one
   marker and one object; then 4 sites' WSR-88D-shaped volumes (drawn and
   projected on the host beside the small checks, 2.1e7 gates) binned on
   the card into the 2D composite and the 20-level 3D histogram, a cut of
   the 3D histogram held to the CPU's beside the last kernel timings.
16. The sharded chain (``parallel.pipeline.sharded_detect_all``, its floods'
   in-plane sweeps through the kernel) on a (2, 2) mesh of ranks that
   ``parallel.launch.launch`` starts; on one card the four ranks share it
   over gloo (card tensors staged through pinned host memory), on four
   cards each has its own over NCCL (``check_sharded``).  (a) At (8, 64,
   96) given the single card's flows: the card's ranks against four gloo
   ranks on the CPU, identical outputs, ``sharded_flow_label`` included;
   against the single card's chain, markers bit-equal, core labels its
   partition, anvil marker labels exact, thick and thin anvils agreeing on
   at least 99 % of their pixels; the same on a (1, 1) mesh on card 0 over
   NCCL.  (b) At the GOES job's frame, ``deep_scene`` (8, 1500, 2500),
   given the single card's flows (the kernels line's
   ``sharded_detect_all``) and computing its own (``..._own_flow``), the
   floods at the reference's default cap of 8 rounds (4 computing its own
   flows, for the script's time): each rank's seconds by part, rounds,
   exchanges, peak memory against its budget and kernel launches; the
   markers, core labels and anvil markers held to the single card's.
   Converged, those floods take minutes on one card, so they run to
   convergence on an 8x640x640 crop of (b)'s scene and flows, held to the
   single card's chain there by (a)'s bars.

The script's own host work runs beside its checks and kernel timings,
never beside a main path whose seconds it logs: the CPU sides of the
small card-against-CPU checks of 7-9 and 14 (a) and the SEVIRI archives
run in a spawned worker process, and the GOES and deep scenes in
threads, while those checks run on the card first; all of it is joined
before 7's profile.  The deep chain's scene is made
in threads beside the chunked GOES check.  The CPU sides of 11's and 12's cut checks
run in threads beside the last kernel checks and timings, which are
CUDA-event times of CUDA graphs; the plain versions, whose many small
launches make them host-bound, are timed after those threads end.

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

import atexit
import bisect
import bz2
import gc
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
from datetime import datetime, timedelta
from pathlib import Path

import numpy as np
import torch

from bench import _cell_params, make_markers, make_scene
from tobac_flow_tpu_torch import device as port_device
from tobac_flow_tpu_torch.core.flow import Flow, create_flow
from tobac_flow_tpu_torch.cli import common as cli
from tobac_flow_tpu_torch.cli import (
    dcc_detect_seviri_nat, dcc_detect_synthetic, dcc_statistics, dcc_validation, postprocess_dcc,
    relabel_postprocess,
)
from tobac_flow_tpu_torch.data.abi import ABIProjection
from tobac_flow_tpu_torch.data.dataloader import (
    CHANNELS, fill_time_gap_nan, goes_geometry, mask_mcmip_frame, stack_mcmip,
)
from tobac_flow_tpu_torch import schema
from tobac_flow_tpu_torch.data import glm
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset, as_tensor
from tobac_flow_tpu_torch.data.seviri_nat import decode_nat, seviri_nat_dataloader, write_nat
from tobac_flow_tpu_torch.detect import chain as chain_mod
from tobac_flow_tpu_torch.detect.chain import STAGES as CHAIN_STAGES
from tobac_flow_tpu_torch.detect.chain import DetectionOptions
from tobac_flow_tpu_torch.detect.detection import detect_cores, get_anvil_markers
from tobac_flow_tpu_torch.models import select_of_model
from tobac_flow_tpu_torch.models.farneback import FarnebackFlow
from tobac_flow_tpu_torch.ops import watershed as ws
from tobac_flow_tpu_torch.ops import ws_sweeps
from tobac_flow_tpu_torch.pipeline import (
    _normalise_pair, fused_flow_watershed, pair_flows,
)
from tobac_flow_tpu_torch.track import file_linker, linking
from tobac_flow_tpu_torch.track.store import MemoryStore
from tobac_flow_tpu_torch.utils.datetime_utils import (
    get_dates_from_filename, trim_file_start_and_end,
)
from tobac_flow_tpu_torch.utils.labels import unique_labels
from tobac_flow_tpu_torch.ops.morphology import distance_transform_edt
from tobac_flow_tpu_torch.validate import validation
from tools.parity_detect import make_multistorm_scene

SMALL = (8, 160, 224)
FULL = (24, 1024, 1536)
COARSE = (24, 256, 384)  # the watershed's 4x coarse grid of FULL
RUNS = 2
CHAIN_SMALL = (9, 64, 96)
# the chain's profiled run at the bench frame's full width with its depth
# cut to 5 frames: the profiler's processing grows with the device ops, 4.6
# million at 6 frames (243 s with the run on an H100 80GB HBM3, 700 W) and
# 6.2 million at 8; the script's time limit leaves room for 5.
CHAIN_PROFILED = (5,) + FULL[1:]
CHAIN_LABELS = ("core_label", "anvil_marker_label", "thick_anvil_label", "thin_anvil_label")
# the stages of cli.common.run_detection: the chain's, then the output's
CLI_STAGES = CHAIN_STAGES + cli.OUTPUT_STAGES
# the coordinates that every stage's objects fill
CLI_COORDS = ("core", "anvil", "core_step", "thick_anvil_step", "thin_anvil_step")
# the label volumes whose objects get field statistics
FIELD_STAT_LABELS = (("core_label", "core"), ("thick_anvil_label", "thick_anvil"),
                     ("thin_anvil_label", "thin_anvil"), ("core_step_label", "core_step"),
                     ("thick_anvil_step_label", "thick_anvil_step"),
                     ("thin_anvil_step_label", "thin_anvil_step"))
# (shape, K) of every launch of the bench slice: the scan rounds' per-frame
# steps (K = 4), the in-plane part of each Jacobi round's full sweep (K = 1)
# and its 8 kernel sweeps (K = 8), on the fine and the coarse grid
SHAPE_CLASSES = (
    ((1,) + FULL[1:], 4), ((1,) + COARSE[1:], 4),
    (FULL, 1), (FULL, 8), (COARSE, 1), (COARSE, 8),
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
# the time-chunked flood: card against CPU at a small size (3 chunks);
# chunked against whole volume at the standard job's 1500x2500 frame
# (BASELINE.md) at a depth the card floods whole (3 chunks); and the main
# path at that frame past the depth the card floods whole
CHUNK_SMALL = (12, 48, 64)
JOB_FRAME = (1500, 2500)
FIT_DEPTH = 12
# the deep run's depth over the most the card floods whole: on an H100 80GB
# HBM3 the budget floods 55 frames whole, and the card's whole memory would
# flood 73 at FLOOD_BYTES_PER_PX, which the run must pass (1.4: 77 frames)
DEEP_OVER_FIT = 1.4
CHUNK_AGREEMENT = 0.995  # the reference's bar, chunked against whole volume
# ws_sweeps launches of one bench-slice run before the flood could run in
# time chunks (PERF.md): it still floods the whole volume
WHOLE_FLOOD_LAUNCHES = 248
# The GOES ingest: make_multistorm_scene's frames as MCMIP channels on
# GOES-16's fixed grid (the projection attrs of the reference's own
# fixture, tests/test_goes_ingest_chain.py; the L2 CONUS product's first
# pixel centres and 56 µrad steps, y decreasing), a DQF box on one frame's
# C13, a flagged row on another frame's C08, and three consecutive
# 5-minute frames missing, which the ingest fills with one NaN frame.
GOES16_PROJECTION = {
    "semi_major_axis": 6378137.0,
    "semi_minor_axis": 6356752.31414,
    "perspective_point_height": 35786023.0,
    "longitude_of_projection_origin": -75.0,
    "sweep_angle_axis": "x",
}
CONUS_X0, CONUS_Y0, ABI_STEP = -0.101332, 0.128212, 56e-6
GOES_T0 = np.datetime64("2020-06-01T00:00", "ns")
# the CONUS-shaped run: 8 real frames and 1 NaN frame of the CONUS sector.
# The scene's cells grow over its first 7 frames and mature from the 4th:
# on an H100 with frames 4-6 missing the cores found 2 objects, with 5-7 or
# 6-8 the anvils none; with 7-9, 22 cores and 2 anvils.
GOES_FULL = (11,) + JOB_FRAME
GOES_MISSING = (7, 8, 9)
# the CPU tests' GOES scene: the smallest tried with a gap frame at which
# every stage finds objects (13x32x48 less frames 8-10: 2 cores, 1 anvil)
GOES_SMALL = (13, 32, 48)
GOES_SMALL_MISSING = (8, 9, 10)
GOES_SMALL_ORIGIN = (1226, 734)  # the CONUS sector's centre
GOES_DQF_FRAME, GOES_STRIPE_FRAME = 3, 4


def goes_flags(h, w):
    """The DQF box's (rows, columns) slices and the flagged row of a frame
    of (h, w): rows 30-45 % and columns 25-40 %, the row at 60 %."""
    return (slice(int(0.3 * h), int(0.45 * h)), slice(int(0.25 * w), int(0.4 * w))), int(0.6 * h)


T_START = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


class prefetched:
    """``fn(*args)`` computed in a thread beside the card's work (host
    scenes, files and the CPU sides of checks): calling the object waits
    for it, raises what it raised, and gives (its result, the seconds it
    took, the seconds the first call waited for it); later calls give the
    same without waiting.  The script joins each before the next phase
    whose seconds it records, so that nothing of its own runs beside a
    timed main path."""

    def __init__(self, fn, *args):
        self.out = {}
        self.thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        t0 = time.perf_counter()
        try:
            self.out["value"] = fn(*args)
        except BaseException as err:  # raised again by the caller
            self.out["error"] = err
        self.out["seconds"] = time.perf_counter() - t0

    def __call__(self):
        if "waited" not in self.out:
            t0 = time.perf_counter()
            self.thread.join()
            self.out["waited"] = time.perf_counter() - t0
        if "error" in self.out:
            raise self.out["error"]
        return self.out["value"], self.out["seconds"], self.out["waited"]


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sweep_inputs(shape, seed, device, in_plane=IN_PLANE[1]):
    """A flood part-way through, as (claim, claim2, meta, field, seeded,
    floodable), drawn on ``device`` from a generator seeded by ``seed``: a
    quantised field (plateaus), a seed on about 1 % of pixels with a label
    from 1..24 or the -1 barrier, 10 % unmasked pixels, and the state after
    8 plain sweeps from those seeds.  At (3, 230, 257) and connectivity 1,
    about 64 % of pixels then hold a label and the next 8 sweeps change
    about 58 % of them."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform():
        return torch.rand(shape, generator=gen, device=device)

    field = torch.round(uniform() * 16) / 16
    seeded = uniform() < 0.01
    labels = torch.randint(0, 25, shape, generator=gen, device=device, dtype=torch.int32)
    labels[labels == 0] = -1
    floodable = (uniform() > 0.1) & ~seeded
    claim = torch.where(seeded, -math.inf, math.inf)
    meta = torch.where(seeded, labels + 2, 2**31 - 1).to(torch.int32)
    args = [claim, claim.clone(), meta, field, seeded, floodable]
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
    launches of a replay write the same memory.  The capture checks this
    thread alone: the CPU sides of checks may run in other threads."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    kept = []
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
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


def time_shape_classes(device, card_line, classes=SHAPE_CLASSES, inputs=None, plain=True):
    """Kernel ms per launch with its inputs cold in L2 and, where one
    launch fits in L2, warm; plain ms (unless ``plain`` is false:
    ``time_plain`` then times it); and the bound, at every shape class
    (connectivity 1, from the live state of ``sweep_inputs``, one set per
    shape, or ``inputs[shape]`` where given)."""
    rows, made = {}, {}
    for shape, k in classes:
        if inputs and shape in inputs:
            args = inputs[shape]
        else:
            if shape not in made:
                made = {shape: sweep_inputs(shape, 1, device)}  # one shape's set at a time
            args = made[shape]
        sets = cold_sets(args)

        def launch(*a):
            return ws_sweeps.spatial_sweeps(*a, IN_PLANE[1], k)

        ms = graph_ms(launch, sets, graph_launches(shape))
        warm_ms = graph_ms(launch, [args], graph_launches(shape)) if len(sets) > 1 else ms
        plain_ms = time_plain_ms(args, k) if plain else None
        bytes_ms, ops_ms = bound(shape, k, len(IN_PLANE[1]))
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        rows[shape_key(shape, k)] = {"ms": ms, "warm_l2_ms": warm_ms, "plain_ms": plain_ms,
                                     "bound_ms": bound_ms, "bound_by": bound_by,
                                     "bytes_ms": bytes_ms, "ops_ms": ops_ms}
        log(f"ws_spatial_sweeps at {shape_key(shape, k)}, connectivity 1: kernel {ms:.4f} ms "
            f"cold ({len(sets)} input copies), {warm_ms:.4f} ms on one copy; plain PyTorch "
            + (f"{plain_ms:.3f} ms" if plain else "timed below") + f"; bound {bound_ms:.4f} ms "
            f"({bound_by}; bytes {bytes_ms:.4f}, "
            f"operations {ops_ms:.4f}), {100 * bound_ms / ms:.1f} % of the bound [{card_line}]")
        del args, sets
    return rows


def time_plain_ms(args, k):
    """The plain version's ms per call at ``args``, K = ``k``, by CUDA
    events.  Its many small launches make it host-bound, so no host work
    of the script may run beside it."""
    return time_ms(lambda: ws_sweeps.spatial_sweeps_reference(*args, IN_PLANE[1], k), 3)


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
    profiler's.  Each device operation (kernel, copy, fill) belongs to the
    stage whose span holds its launch: the host's runtime call that shares
    its correlation id.  (The device's own timestamps are not used for
    that: on a later profiling cycle in one process they put ops outside
    the span of the stage that launched them, ``tools/torch_profile_probe.py``
    shows it.)  For each
    stage, its device ops, the union of their intervals and the share of
    the stage's wall time the device spent idle, and how many of its ops
    the device's clock puts outside its span; the device ops with the most
    time, by name; and the sweep kernel's launches and device ms.  Raises
    if a stage launched no device op, or the stages together launched
    under 99 % of the run's.  Returns (the sweep kernel's device ms in the
    run, its launches)."""
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
    # the raw events (µs), without building the profiler's event tree: the
    # device's ops, and the host's runtime calls (cudaLaunchKernel,
    # cudaMemcpyAsync, ...) by correlation id
    ops, calls = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            start = e.start_ns() / 1e3
            ops.append((e.correlation_id(), start, start + e.duration_ns() / 1e3, e.name()))
        elif e.device_type() == DeviceType.CPU and e.name().startswith("cu"):
            calls.setdefault(e.correlation_id(), e.start_ns() / 1e3)
    launched = [calls.get(c, -math.inf) for c, _, _, _ in ops]
    order = sorted(range(len(ops)), key=launched.__getitem__)
    launched = [launched[i] for i in order]
    ops = [ops[i][1:] for i in order]
    in_stages = 0
    for name in stages:
        lo, hi = (t / 1e3 for t in stats[f"{name}_span_ns"])
        first, last = bisect.bisect_left(launched, lo), bisect.bisect_right(launched, hi)
        mine = ops[first:last]
        if not mine:
            raise AssertionError(f"profile of {what}: no device op was launched inside the "
                                 f"host span of stage.{name}")
        in_stages += len(mine)
        busy = union_ms([(s, e) for s, e, _ in mine])
        wall = (hi - lo) / 1e3
        skewed = sum(1 for s, _, _ in mine if not lo <= s <= hi)
        log(f"profile of {what}, stage.{name}: wall {wall / 1e3:.3f} s, device busy "
            f"{busy / 1e3:.3f} s, {len(mine)} device ops, idle "
            f"{100 * (1 - busy / wall):.1f} %; the device's clock puts {skewed} of its ops "
            f"outside its span [{card_line}]")
    if in_stages < 0.99 * len(ops):
        raise AssertionError(f"profile of {what}: {in_stages} of the run's {len(ops)} "
                             f"device ops were launched inside the stages' host spans")
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
    log(f"profile of {what}: {len(ops)} device ops in the run, {in_stages} launched inside "
        f"the stages; the sweep kernel {len(sweeps)} launches, {ms:.3f} ms of device time; "
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


CPU_LEG_THREADS = 4  # a worker process's intra-op threads, beside the card's host thread


def cpu_chain_flows(bt, raw, kw):
    """The CPU's CLI-default flow of ``bt``, and the same refinement and
    smoothing of the card's raw Farneback flows ``raw`` on the CPU (all
    numpy, clipped): the CPU side of ``check_chain_small``'s flow check,
    run in a worker process (``cpu_legs``)."""
    torch.set_num_threads(CPU_LEG_THREADS)
    cpu = create_flow(bt, device="cpu", **kw)
    again = pair_flows(bt, GivenFlows(torch.from_numpy(raw)), device="cpu", **kw)
    return (cpu.forward_flow.numpy(), cpu.backward_flow.numpy(),
            *(f.clamp(-20, 20).numpy() for f in again))


def cpu_detection(fields, ds, fwd, bwd, config=None):
    """``cli.run_detection`` on the CPU given the flows (numpy), with the
    anvil markers saved (and, without a ``config``, the spatial
    properties): the CPU side of a card-against-CPU check, run in a worker
    process (``cpu_legs``).  ``config``: ``PipelineConfig`` fields whose
    ``detection_options()`` to run with."""
    from tobac_flow_tpu_torch.config import PipelineConfig

    torch.set_num_threads(CPU_LEG_THREADS)
    flow = Flow(torch.from_numpy(fwd), torch.from_numpy(bwd))
    if config is None:
        opts = DetectionOptions(save_anvil_markers=True, save_spatial_props=True)
    else:
        opts = PipelineConfig(**config).detection_options()
        opts.save_anvil_markers = True
    opts.flow_factory = lambda _: flow
    return cli.run_detection(*fields, ds, opts=opts, device="cpu")


class cpu_legs:
    """A spawned worker process that runs the CPU sides of the small
    card-against-CPU checks while the card goes on with the next phases:
    ``submit`` gives a future; leaving the block stops the process."""

    def __enter__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
        return self

    def submit(self, fn, *args):
        return self.pool.submit(fn, *args)

    def __exit__(self, *exc):
        self.pool.shutdown(wait=True, cancel_futures=True)
        return False


def check_chain_small(device, card_line, legs):
    """``cli.common.run_detection`` on the card against the CPU at
    CHAIN_SMALL.  Flows: the CPU tests' tolerance inside the storm mask on
    every frame where the CPU reproduces its own CLI-default flow from the
    card's Farneback flows.  Given the same flows, the datasets (labels of
    every stage, anvil markers and spatial properties included) are the
    same: identical but the float means and stds, which are held to the
    CPU tests' tolerance; and no stage is empty.  The CPU's flows and run
    go on in ``legs``' worker process.  Returns the scene (its fields with the NaN
    patch and times), the card's flow, the card's dataset, and a function
    that waits for the CPU's dataset and checks it against the card's."""
    opts = DetectionOptions()
    bt, wvd, swd = make_multistorm_scene(*CHAIN_SMALL)
    times = chain_times(CHAIN_SMALL[0])
    kw = dict(vr_steps=opts.vr_steps, smoothing_passes=opts.smoothing_passes,
              interp_method=opts.interp_method)
    gpu = create_flow(bt, **kw)
    if gpu.device.type != device.type:
        raise AssertionError(f"create_flow ran on {gpu.device}, not on the card")
    frames = torch.from_numpy(bt).to(device)
    p8, n8 = _normalise_pair(frames[:-1], frames[1:])
    raw = FarnebackFlow().to(device)(torch.cat([p8, n8]), torch.cat([n8, p8])).cpu()
    cpu_flows = legs.submit(cpu_chain_flows, bt, raw.numpy(), kw)
    gpu_flows = [f.cpu().numpy() for f in gpu.flow]
    wvd[3:6, 20:26, 40:46] = np.nan  # missing data at a cell's edge, as the CPU tests
    cpu_run = legs.submit(cpu_detection, *chain_inputs(bt, wvd, swd, times),
                          gpu.forward_flow.cpu().numpy(), gpu.backward_flow.cpu().numpy())
    fields, ds = chain_inputs(bt, wvd, swd, times)
    opts = DetectionOptions(save_anvil_markers=True, save_spatial_props=True,
                            flow_factory=lambda _: gpu)
    card_out = cli.run_detection(*fields, ds, opts=opts)

    def finish():
        storm = bt < 250
        checked, worst = 0, 0.0
        cpu_fwd, cpu_bwd, again_fwd, again_bwd = cpu_flows.result()
        for g, c, a in zip(gpu_flows, (cpu_fwd, cpu_bwd), (again_fwd, again_bwd)):
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
            f"max |card - CPU| there {worst:.3g} px (the CPU's flows in the worker process)")
        cpu_out = cpu_run.result()
        counts = {name: int(cpu_out[name].values.max()) for name in CHAIN_LABELS}
        if min(counts.values()) == 0 or min(cpu_out.coords[c].size for c in CLI_COORDS) == 0:
            raise AssertionError(f"chain small: an empty stage: {counts}")
        worst = compare_datasets(cpu_out, card_out)
        log(f"chain small {CHAIN_SMALL}: cli.run_detection on the card gives the CPU's "
            f"dataset given the same flows ({len(cpu_out.data_vars)} variables; float32 means "
            f"and stds within {worst:.3g}, the rest identical; the CPU's run in a worker "
            f"process beside the card's next phases); objects {counts}")

    return (bt, wvd, swd, times), gpu, card_out, finish


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
    """``cli.common.run_detection`` with ``DetectionOptions()`` on
    ``fields``: the (bt, wvd, swd) DataArrays and the output dataset, which
    is copied.  With a dict ``keep``, the label volumes that
    its output stages start from are also copied to the host into it
    (three copies, outside every stage)."""
    (bt, wvd, swd), ds = fields
    ds = Dataset(data_vars=ds.data_vars, coords=ds.coords)
    if keep is None:
        return cli.run_detection(bt, wvd, swd, ds, stats=stats)
    prepare = cli.prepare_output

    def copy_then_prepare(dataset, *args):
        keep.update({k: DataArray(dataset[k].data.cpu(), dims=dataset[k].dims,
                                  attrs=dataset[k].attrs)
                     for k in CHAIN_LABELS if k in dataset})
        return prepare(dataset, *args)

    cli.prepare_output = copy_then_prepare
    try:
        return cli.run_detection(bt, wvd, swd, ds, stats=stats)
    finally:
        cli.prepare_output = prepare


def check_output_stages_on_cpu(out, labels, fields, card_line, what):
    """The output stages on the CPU from the card's labels (``labels``,
    copied to the host before the card's output stages), held to the
    card's dataset ``out`` as the CPU tests hold the card."""
    (bt, wvd, swd), ds = fields
    ds = Dataset(data_vars=ds.data_vars, coords=ds.coords)
    for name, da in labels.items():
        ds[name] = da
    cpu_fields = [DataArray(as_tensor(f).cpu(), coords=f.coords, dims=f.dims, name=f.name,
                            attrs=f.attrs) for f in (bt, wvd, swd)]
    stats = {}
    t0 = time.perf_counter()
    cpu = cli.prepare_output(ds, *cpu_fields, device="cpu", stats=stats)
    seconds = time.perf_counter() - t0
    worst = compare_datasets(cpu, out)
    log(f"{what}: the output stages on the CPU from the card's labels take "
        f"{seconds:.3f} s (" + ", ".join(f"{n} {stats[n + '_s']:.3f} s"
                                           for n in cli.OUTPUT_STAGES)
        + f") and give the card's dataset: float32 means and stds within {worst:.3g}, "
        f"the rest identical [{card_line}, {torch.get_num_threads()} CPU threads]")


def profile_chain(device, card_line):
    """``cli.common.run_detection``'s profiled run at CHAIN_PROFILED, which
    also warms the path up.  Returns (profiled sweep ms, profiled sweep
    launches)."""
    fields = chain_fields(CHAIN_PROFILED, device)

    def profiled_run():
        stats = {}
        run_cli(fields, stats)
        return stats

    return profile_run(profiled_run, CLI_STAGES, card_line,
                       f"cli.run_detection {CHAIN_PROFILED}")


def goes_frames(shape, missing, origin=(0, 0)):
    """``make_multistorm_scene(*shape)`` as the MCMIP frames of a GOES-16
    window whose top-left pixel is ``origin`` (x, y) in the CONUS sector,
    as the reference's own fixture turns fields into channels: C13 = bt,
    C10 = 240 K, C08 = wvd + C10, C15 = bt - swd, and NaN off the Earth's
    disk, as the product's fill values read.  Frame GOES_DQF_FRAME has a
    DQF box on C13, frame GOES_STRIPE_FRAME a flagged row on C08 (see
    ``goes_flags``), and the frames ``missing`` are left out.  Returns (times, frames, x, y): the
    frames as (channels, dqfs) per time, as ``read_mcmip_frame`` gives
    them, and the window's scan angles."""
    t, h, w = shape
    x = CONUS_X0 + (origin[0] + np.arange(w)) * ABI_STEP
    y = CONUS_Y0 - (origin[1] + np.arange(h)) * ABI_STEP
    off_disk = np.isnan(ABIProjection(**GOES16_PROJECTION).to_latlon(*np.meshgrid(x, y))[0])
    bt, wvd, swd = make_multistorm_scene(t, h, w)
    for field in (bt, wvd, swd):
        field[:, off_disk] = np.nan
    times = GOES_T0 + np.arange(t) * np.timedelta64(300, "s")
    c10 = np.full((h, w), 240.0, np.float32)
    zeros = np.zeros((h, w), np.float32)
    box, row = goes_flags(h, w)
    out_times, frames = [], []
    for i in range(t):
        if i in missing:
            continue
        channels = {"C13": bt[i], "C10": c10, "C08": (wvd[i] + c10).astype(np.float32),
                    "C15": (bt[i] - swd[i]).astype(np.float32)}
        dqfs = dict.fromkeys(CHANNELS, zeros)
        if i == GOES_DQF_FRAME:
            dqfs["C13"] = zeros.copy()
            dqfs["C13"][box] = 1
        if i == GOES_STRIPE_FRAME:
            dqfs["C08"] = zeros.copy()
            dqfs["C08"][row] = 1
        out_times.append(times[i])
        frames.append((channels, dqfs))
    return out_times, frames, x, y


def goes_ingest(times, frames, x, y):
    """The port's ingest of in-memory MCMIP frames, as ``goes_dataloader``
    runs it after its file reads: each frame masked, the stack sorted in
    time, each gap over 15 minutes filled with a NaN frame, and the output
    dataset with the projection, lat, lon and pixel area.  Returns
    ((bt, wvd, swd), dataset)."""
    masked = [mask_mcmip_frame(channels, dqfs) for channels, dqfs in frames]
    fields = [fill_time_gap_nan(da) for da in stack_mcmip(times, masked, x, y)]
    return fields, goes_geometry(fields[0].coords, GOES16_PROJECTION)


def check_field_stats(out, fields, what):
    """The area-weighted field statistics are finite for every object with
    a non-NaN pixel of the field, and NaN for every other label number.
    Returns the number of (object, field) pairs checked."""
    checked = 0
    for label_name, name in FIELD_STAT_LABELS:
        labels = out[label_name].values.ravel()
        for field in fields:
            counts = np.bincount(labels[np.isfinite(field.values.ravel()) & (labels > 0)],
                                 minlength=int(labels.max()) + 1)[1:]
            for stat in ("mean", "std", "max", "min"):
                finite = np.isfinite(out[f"{name}_{field.name}_{stat}"].values)
                if not np.array_equal(finite, counts > 0):
                    raise AssertionError(f"{what}: {name}_{field.name}_{stat} is finite for "
                                         f"{int(finite.sum())} labels, {int((counts > 0).sum())} "
                                         f"have non-NaN pixels")
            checked += int((counts > 0).sum())
    return checked


def check_goes_small(device, card_line, legs):
    """``cli.common.run_detection`` on the card against the CPU on the CPU
    tests' GOES scene (GOES_SMALL less GOES_SMALL_MISSING, with its NaN
    frame, masks and area weights), given the same (the card's) flows: the
    same dataset, as ``check_chain_small`` holds the synthetic scene, and
    no stage empty.  The CPU's run goes on in ``legs``' worker process;
    returns a function that waits for it and checks."""
    fields, ds = goes_ingest(*goes_frames(GOES_SMALL, GOES_SMALL_MISSING, GOES_SMALL_ORIGIN))
    flow = create_flow(fields[0].values, vr_steps=1, smoothing_passes=1, interp_method="cubic")
    if flow.device.type != device.type:
        raise AssertionError(f"create_flow ran on {flow.device}, not on the card")
    cpu_run = legs.submit(cpu_detection, fields, Dataset(data_vars=ds.data_vars, coords=ds.coords),
                          flow.forward_flow.cpu().numpy(), flow.backward_flow.cpu().numpy())
    opts = DetectionOptions(save_anvil_markers=True, save_spatial_props=True,
                            flow_factory=lambda _: flow)
    card_out = cli.run_detection(*fields, Dataset(data_vars=ds.data_vars, coords=ds.coords),
                                 opts=opts)

    def finish():
        cpu_out = cpu_run.result()
        counts = {name: int(cpu_out[name].values.max()) for name in CHAIN_LABELS}
        if min(counts.values()) == 0 or min(cpu_out.coords[c].size for c in CLI_COORDS) == 0:
            raise AssertionError(f"GOES small: an empty stage: {counts}")
        worst = compare_datasets(cpu_out, card_out)
        checked = check_field_stats(card_out, fields, "GOES small")
        log(f"GOES small {fields[0].shape} (from {GOES_SMALL} less frames "
            f"{GOES_SMALL_MISSING}): cli.run_detection on the card gives the CPU's dataset given "
            f"the same flows ({len(cpu_out.data_vars)} variables; float32 means and stds within "
            f"{worst:.3g}, the rest identical; the CPU's run in a worker process); objects "
            f"{counts}; area-weighted statistics finite for the {checked} (object, field) pairs "
            f"with non-NaN pixels")

    return finish


def run_goes(device, card_line, scene=None):
    """The CONUS-shaped GOES run: GOES_FULL less GOES_MISSING through the
    port's ingest (8 real frames and 1 NaN frame of 1500x2500, DQF-masked
    pixels, lat, lon and pixel areas), then ``cli.common.run_detection``
    with ``DetectionOptions()`` on the card, timed, with the kernel's counts
    reset just before it and read just after.  Every stage finds objects,
    the area-weighted statistics are finite for every object with non-NaN
    pixels, and the output stages on the CPU from the card's labels give
    the card's dataset.  Returns (launches, launches by shape, the run's
    record for ``check_chunked_goes``: the chain's stage calls and floods
    (``recorded_stages``), its dataset, the label volumes its output stages
    started from, its fields and output dataset).  ``scene``: the scene's
    frames being made beside the earlier phases (``prefetched``)."""
    if scene is None:
        scene = prefetched(goes_frames, GOES_FULL, GOES_MISSING)
    (times, frames, x, y), made, waited = scene()
    t1 = time.perf_counter()
    fields, ds = goes_ingest(times, frames, x, y)
    del frames
    t2 = time.perf_counter()
    bt = fields[0].values
    nan_px = [int(np.isnan(f.values).sum()) for f in fields]
    nan_frames = [i for i in range(bt.shape[0]) if np.isnan(bt[i]).all()]
    area = ds["area"].values
    off_disk = np.isnan(area)
    log(f"GOES scene {GOES_FULL} less frames {GOES_MISSING}: made on the host in "
        f"{made:.1f} s ({waited:.1f} s waited for), through the port's ingest (mask, stack, "
        f"NaN gap fill, geometry) in "
        f"{t2 - t1:.1f} s: {bt.shape}, NaN frames {nan_frames}, NaN pixels (bt, wvd, swd) "
        f"{nan_px}, off the disk {int(off_disk.sum())} pixels, times "
        f"{str(fields[0].coords['t'][0])[:19]} .. {str(fields[0].coords['t'][-1])[:19]}, lat "
        f"{np.nanmin(ds['lat'].values):.3f} .. {np.nanmax(ds['lat'].values):.3f}, pixel area "
        f"{np.nanmin(area):.3f} .. {np.nanmax(area):.3f} km^2")
    box, row = goes_flags(*bt.shape[1:])
    flagged = all(np.isnan(f.values[GOES_DQF_FRAME][box]).all()
                  and np.isnan(f.values[GOES_STRIPE_FRAME, row]).all() for f in fields)
    if (nan_frames != [GOES_MISSING[0]] or not flagged or not np.isnan(bt[:, off_disk]).all()
            or not np.array_equal(off_disk, np.isnan(ds["lat"].values))):
        raise AssertionError(f"GOES scene: NaN frames {nan_frames}, NaN pixels {nan_px}, "
                             f"flags masked {flagged}, {int(off_disk.sum())} pixels off the disk")
    gc.collect()
    torch.cuda.synchronize()
    port_device.reset_peak_memory(device)
    resident = torch.cuda.memory_allocated()
    stats, labels = {}, {}
    calls, floods = [], []
    reset_counts()
    t0 = time.perf_counter()
    with recorded_stages(calls, floods):
        out = run_cli((fields, ds), stats, labels)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_shape = read_counts()
    peak = port_device.peak_memory(device)
    what = f"GOES {bt.shape}"
    if launches == 0:
        raise AssertionError(f"{what}: the ws_sweeps kernel was never launched")
    empty = [name for name in CHAIN_STAGES[1:] if stats[name + "_n"] == 0]
    empty += [c for c in CLI_COORDS if out.coords[c].size == 0]
    if empty:
        raise AssertionError(f"{what}: no objects in {empty}")
    checked = check_field_stats(out, fields, what)
    px = float(np.prod(bt.shape))
    log(f"{what} through cli.run_detection [{card_line}]: {seconds:.3f} s; " + ", ".join(
            f"{name} {stats[name + '_s']:.3f} s" for name in CLI_STAGES) + "; objects "
        + ", ".join(f"{name} {stats[name + '_n']}" for name in CHAIN_STAGES[1:])
        + f"; {len(out.data_vars)} variables, " + ", ".join(
            f"{c} {out.coords[c].size}" for c in CLI_COORDS)
        + "; stage peaks " + ", ".join(
            f"{name} {stats[name + '_peak_bytes'] / 2**30:.3f} GiB "
            f"({(stats[name + '_peak_bytes'] - resident) / px:.1f} B/px over the run's start)"
            for name in CLI_STAGES)
        + f"; area-weighted statistics finite for the {checked} (object, field) pairs with "
        f"non-NaN pixels; kernel launches {launches} {by_shape}; device memory resident at "
        f"start {resident / 2**30:.3f} GiB, peak {peak / 2**30:.3f} GiB")
    check_output_stages_on_cpu(out, labels, (fields, ds), card_line, what)
    return launches, by_shape, dict(calls=calls, floods=floods, out=out, labels=labels,
                                    fields=fields, ds=ds)


def job_scene(t, h, w, threads=8):
    """``bench.make_scene(t, h, w)`` bit for bit, its frames computed in
    threads (numpy's exp releases the GIL; one 1500x2500 frame takes about
    a second on one core)."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(0)
    cy, cx, radius, depth = _cell_params(h, w, seed=0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bt = np.empty((t, h, w), np.float32)

    def frame(i):
        grow = min(0.4 + 0.6 * i / max(t - 1, 1), 1.0)
        acc = np.zeros((h, w), np.float32)
        for k in range(len(cy)):
            r2 = (xx - cx[k] - 3.0 * i) ** 2 + (yy - cy[k] - 1.5 * i) ** 2
            acc += depth[k] * grow * np.exp(-r2 / (2 * radius[k] ** 2))
        bt[i] = 290.0 - np.minimum(acc, 85.0)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(frame, range(t)))
    bt += rng.normal(0, 0.3, bt.shape).astype(np.float32)
    return bt


def check_cli_h5py():
    """Where h5py cannot be imported (the card's machine has none), the
    synthetic CLI raises naming it before any stage of the chain runs."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        pass
    else:
        log("h5py imports here: the CLI's early check passes, and it writes its file")
        return
    before = ws_sweeps.spatial_sweeps.launches
    t0 = time.perf_counter()
    try:
        # the CLI raises before it makes its output directory
        dcc_detect_synthetic.main(["-sd", str(ws_sweeps._BUILD_DIR / "cli"), "-t", "8",
                                   "-y", "32", "-x", "48"])
    except ImportError as err:
        if "h5py" not in str(err):
            raise
        seconds = time.perf_counter() - t0
        if ws_sweeps.spatial_sweeps.launches != before or seconds > 5:
            raise AssertionError(f"the CLI raised for h5py only after {seconds:.1f} s")
        log(f"no h5py here: the synthetic CLI raised in {seconds:.3f} s, before any stage "
            f"of the chain: {err}")
        return
    raise AssertionError("the synthetic CLI ran without h5py")


# -- phase 15: the legacy path, and the radar and flux gridding -------------------

LEVEL2_DATE = 18500  # a Level-II collect date: days since 1 Jan 1970, day 1 (2020-08-26)
RADAR_FIRST_GATE, RADAR_GATE_SPACING = 2125, 250  # m: WSR-88D super-resolution reflectivity
RADAR_SCALE, RADAR_OFFSET = 2.0, 66.0  # dBZ = (raw - 66) / 2; raw 0 and 1 flag no echo
RADAR_RADIALS, RADAR_GATES = 720, 1832  # a super-resolution cut: 0.5 deg radials to 460 km
RADAR_CUTS = (0.5, 0.9, 1.3, 1.8)  # elevation angles (deg) of each site's volume
RADAR_SITES = 4  # sites that filter_nexrad_sites finds on the CONUS grid, at least
RADAR_ALT_EDGES = np.arange(0, 20001, 1000.0)  # m: get_3d_nexrad_hist's 20 levels


def level2_radial(site, az, el, raw, collect_ms=43_200_000, icao=b"KTLX"):
    """One message-31 radial of a Level-II archive (the 12-byte CTM pad,
    the message header and the body) with an RVOL block at ``site`` (lat,
    lon, height in m) and a DREF block of the raw gate bytes ``raw``."""
    lat, lon, height = site
    vol = struct.pack(">1s3sHBBffhhf", b"R", b"VOL", 44, 1, 0, lat, lon, int(height), 25, 0.0)
    raw = np.asarray(raw, np.uint8)
    ref = struct.pack(">1s3sIHHHHHBBff", b"D", b"REF", 0, raw.size, RADAR_FIRST_GATE,
                      RADAR_GATE_SPACING, 16, 16, 0, 8, RADAR_SCALE, RADAR_OFFSET) + raw.tobytes()
    pointers = 32 + 2 * 4  # the body's header and two block pointers
    body = (struct.pack(">4sIHHfBBHBBBBfBbH", icao, collect_ms, LEVEL2_DATE, 1, az, 0, 0, 0, 1,
                        0, 1, 0, el, 0, 0, 2)
            + struct.pack(">2i", pointers, pointers + len(vol)) + vol + ref)
    if (16 + len(body)) % 2:
        body += b"\x00"
    header = struct.pack(">HBBHHIHH", (16 + len(body)) // 2, 0, 31, 1, LEVEL2_DATE, collect_ms,
                         1, 1)
    return b"\x00" * 12 + header + body


def level2_archive(radials, icao=b"KTLX"):
    """A Level-II archive: the volume header and one bzip2 LDM record of
    the radials (``level2_radial``)."""
    payload = bz2.compress(b"".join(radials))
    return (struct.pack(">9s3siI4s", b"AR2V0006.", b"001", LEVEL2_DATE, 0, icao)
            + struct.pack(">i", -len(payload)) + payload)


def radar_raw(rng, shape):
    """Raw reflectivity bytes drawn from ``rng``: half the gates without an
    echo (0), the rest 2..180 (-32 to 57 dBZ)."""
    return np.where(rng.uniform(size=shape) < 0.5, 0,
                    rng.integers(2, 181, shape)).astype(np.uint8)


def radar_volume(site, seed, cuts=RADAR_CUTS, radials=RADAR_RADIALS, gates=RADAR_GATES):
    """The gates of one site's volume as the Level-II reader gives them:
    ``cuts`` elevations of ``radials`` radials of ``gates`` reflectivity
    gates, their (lat, lon, alt) by ``gate_lat_lon_alt`` and their
    reflectivity (float64 dBZ, NaN without an echo) from raw bytes drawn
    from ``seed``: flat (lat, lon, alt, refl) arrays."""
    from tobac_flow_tpu_torch.data.nexrad_level2 import gate_lat_lon_alt

    rng = np.random.default_rng(seed)
    az = (0.25 + 0.5 * np.arange(radials))[:, None]
    rng_m = RADAR_FIRST_GATE + RADAR_GATE_SPACING * np.arange(gates)[None, :]
    parts = [np.broadcast_arrays(*gate_lat_lon_alt(*site, az, el, rng_m)) for el in cuts]
    lat, lon, alt = (np.concatenate([p[i].ravel() for p in parts]) for i in range(3))
    raw = radar_raw(rng, lat.shape).astype(np.float32)
    refl = np.where(raw < 2, np.float32(np.nan), (raw - RADAR_OFFSET) / RADAR_SCALE)
    return lat, lon, alt, refl.astype(np.float64)


LEGACY_SMALL = (9, 96, 128)  # the legacy CLI's synthetic scene for the card-against-CPU check
LEGACY_FLOOD_CUT = (slice(0, 6), slice(24, 72), slice(32, 96))  # where (a) floods the others
LEGACY_FRAMES = 4  # the GOES scene's frames that the legacy path runs at full width (3 find no marker)
RADAR_WINDOW = (96, 128)  # the grid of (a)'s radar and flux checks, at the CONUS sector's centre
RADAR_CHECK_CUT = (slice(600, 800), slice(1100, 1400))  # (b)'s 3D cut held to the CPU


def window_grid(h, w, origin=GOES_SMALL_ORIGIN):
    """A GOES-16 fixed-grid Dataset of (h, w) pixels of the CONUS sector
    from ``origin`` (x, y), with its projection."""
    x = CONUS_X0 + (origin[0] + np.arange(w)) * ABI_STEP
    y = CONUS_Y0 - (origin[1] + np.arange(h)) * ABI_STEP
    ds = Dataset(coords={"y": y, "x": x})
    ds["goes_imager_projection"] = DataArray(np.zeros((), np.int32), dims=(),
                                             attrs=dict(GOES16_PROJECTION))
    return ds


def grid_centre(ds):
    x, y = ds.coords["x"], ds.coords["y"]
    lat, lon = ABIProjection(**GOES16_PROJECTION).to_latlon(x[x.size // 2], y[y.size // 2])
    return float(lat), float(lon)


def radar_tar(path, site, seed, radials=240, gates=400):
    """A tar file of one crafted Level-II archive at ``site``: two cuts of
    ``radials`` radials of ``gates`` gates, raw bytes from ``seed``."""
    import io
    import tarfile

    rng = np.random.default_rng(seed)
    msgs = [level2_radial(site, float((0.25 + 0.5 * (i % (radials // 2))) * 720 / radials),
                          0.5 if i < radials // 2 else 1.5, radar_raw(rng, gates))
            for i in range(radials)]
    data = level2_archive(msgs)
    with tarfile.open(path, "w") as tar:
        info = tarfile.TarInfo("KTLX20200826_120000_V06.ar2v")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    return path


def flux_datasets(seed, n=4000, frames=2):
    """Flux files' Datasets from a seed: lat, lon and every flux of
    ``grid_flux_native.FLUX_VARS`` with its clear-sky pair, one per hour."""
    from tobac_flow_tpu_torch.cli.grid_flux_native import FLUX_VARS

    rng = np.random.default_rng(seed)
    out = []
    for i in range(frames):
        ds = Dataset(coords={"t": np.asarray([np.datetime64("2020-06-01T00:00", "ns")
                                              + np.timedelta64(frames - 1 - i, "h")]),
                             "pix": np.arange(n)})
        ds["lat"] = DataArray(rng.uniform(-60, 60, n), dims=("pix",), name="lat")
        ds["lon"] = DataArray(rng.uniform(-60, 60, n), dims=("pix",), name="lon")
        for var in FLUX_VARS:
            for name in (var, f"{var}_clr"):
                ds[name] = DataArray(rng.uniform(0, 1000, n).astype(np.float32), dims=("pix",),
                                     name=name)
        out.append(ds)
    return out


def latlon_source(goes, seed, frames=2):
    """A lat/lon field over the grid ``goes`` and its surroundings: the
    source of ``grid_flux``."""
    lat, lon = grid_centre(goes)
    rng = np.random.default_rng(seed)
    lats, lons = lat + np.linspace(-1.5, 1.5, 120), lon + np.linspace(-2.0, 2.0, 160)
    src = Dataset(coords={"t": np.datetime64("2020-06-01T12:00", "ns")
                          + np.arange(frames) * np.timedelta64(1, "h"), "lat": lats, "lon": lons})
    src["lat"] = DataArray(lats, dims=("lat",))
    src["lon"] = DataArray(lons, dims=("lon",))
    src["toa_swup"] = DataArray(rng.uniform(0, 1000, (frames, 120, 160)).astype(np.float32),
                                dims=("t", "lat", "lon"), attrs={"units": "W m-2"})
    src["toa_lwup"] = DataArray(rng.uniform(100, 300, (120, 160)).astype(np.float32),
                                dims=("lat", "lon"), attrs={"units": "W m-2"})
    return src


def legacy_small_inputs():
    """The legacy CLI's synthetic scene at LEGACY_SMALL (DataArrays), its
    times and coordinates."""
    from tobac_flow_tpu_torch.cli.dcc_detect_synthetic import make_scene

    bt, wvd, swd = make_scene(*LEGACY_SMALL)
    coords = {k: bt.coords[k] for k in ("t", "y", "x")}
    return (bt, wvd, swd), coords["t"], coords


def phase15_small(device, flow, tar_path, budget_bytes=None):
    """Phase 15 (a)'s runs on ``device`` given the card's legacy ``flow``
    (whose device it moves to): the legacy CLI's ``detect_legacy``, its
    labels' ``get_stats_for_labels`` over BT, ``detect_anvils(markers=None)``
    and ``legacy.flow_network_watershed`` on a cut, the radar archive in
    ``tar_path`` decoded and gridded (2D composite and 3D), and both flux
    CLIs' in-memory functions.  Returns a dict of Datasets and arrays (on
    the host), and the kernel's launches by shape of its floods where the
    device is the card."""
    from tobac_flow_tpu_torch import legacy
    from tobac_flow_tpu_torch.cli import grid_flux, grid_flux_native, grid_nexrad
    from tobac_flow_tpu_torch.cli.dcc_detect_legacy import detect_legacy
    from tobac_flow_tpu_torch.data import nexrad
    from tobac_flow_tpu_torch.detect.analysis import get_stats_for_labels
    from tobac_flow_tpu_torch.detect.detection import detect_anvils

    device = torch.device(device)
    flow = Flow(flow.forward_flow.to(device), flow.backward_flow.to(device))
    (bt, wvd, swd), times, coords = legacy_small_inputs()
    out = {}
    ds = detect_legacy(bt, wvd, swd, times, flow=flow, coords=coords)
    labels = DataArray(ds["watershed_label"].data, dims=("t", "y", "x"), name="watershed_label")
    for da in get_stats_for_labels(labels, DataArray(torch.from_numpy(bt.values).to(device),
                                                     dims=("t", "y", "x"), name="bt")):
        ds[da.name] = da
    out["legacy"] = ds.load()
    c = LEGACY_FLOOD_CUT
    cut = flow[c]
    field = (wvd.values - swd.values)[c]
    out["anvils_none"] = detect_anvils(cut, field).cpu().numpy()
    edges = cut.sobel(np.clip(field, -15, -5), method="nearest")
    markers = out["legacy"]["growth_markers"].values[c]
    out["network_ws"] = legacy.flow_network_watershed(
        edges, markers, cut.forward_flow, cut.backward_flow, mask=field > -12,
        max_iter=25).cpu().numpy()
    goes = window_grid(*RADAR_WINDOW)
    gates = nexrad.get_gates_from_tar(tar_path)
    out["radar"] = grid_nexrad.grid_nexrad(goes, [gates], device=device).load()
    gx, gy = nexrad.map_nexrad_to_goes(*gates[:3], goes)
    out["radar_3d"] = [a.cpu().numpy() for a in nexrad.get_3d_nexrad_hist(
        gx, gy, gates[2], gates[3], goes, RADAR_ALT_EDGES, device=device)]
    out["flux"] = grid_flux.grid_flux(goes, latlon_source(goes, 11), ["toa_swup", "toa_lwup"],
                                      device=device).load()
    out["flux_native"] = grid_flux_native.grid_flux_native(flux_datasets(12), device).load()
    return out


def cpu_phase15(fwd, bwd, tar_path):
    """Phase 15 (a)'s CPU side given the card's flows (numpy), run in a
    worker process (``cpu_legs``)."""
    torch.set_num_threads(CPU_LEG_THREADS)
    return phase15_small("cpu", Flow(torch.from_numpy(fwd), torch.from_numpy(bwd)), tar_path)


def check_legacy_small(device, card_line, legs):
    """Phase 15 (a), card against CPU (the CPU's side in ``legs``' worker
    process): ``phase15_small`` on the card and on the CPU given the card's
    CLI-default flow of the legacy scene: the datasets identical (markers,
    labels, their BT statistics, the radar composite, both flux CLIs'
    grids), the cut's floods and the 3D radar histogram identical; and the
    op-by-op filters (``get_combined_filters``, ``get_growth_rate``) give
    ``fused.core_markers``' markers on the card.  Returns the kernel's
    launches by shape in the card's floods, and a function that waits for
    the CPU and checks."""
    from tobac_flow_tpu_torch.detect import detection, fused
    from tobac_flow_tpu_torch.ops.morphology import binary_opening

    t0 = time.perf_counter()
    (bt, wvd, swd), times, _ = legacy_small_inputs()
    flow = create_flow(bt.values, model="Farneback", vr_steps=1, smoothing_passes=1)
    if flow.device.type != device.type:
        raise AssertionError(f"create_flow ran on {flow.device}, not on the card")
    tar_path = ws_sweeps._BUILD_DIR / "radar_small.tar"
    tar_path.parent.mkdir(parents=True, exist_ok=True)
    lat, lon = grid_centre(window_grid(*RADAR_WINDOW))
    radar_tar(tar_path, (lat, lon, 250.0), 13)
    cpu_run = legs.submit(cpu_phase15, flow.forward_flow.cpu().numpy(),
                          flow.backward_flow.cpu().numpy(), str(tar_path))
    reset_counts()
    card = phase15_small(device, flow, str(tar_path))
    torch.cuda.synchronize()
    launches, by_shape = read_counts()
    # the op-by-op filters against the fused chain's markers, on the card
    b, w, sw = (torch.from_numpy(a.values).to(device) for a in (bt, wvd, swd))
    combined = detection.get_combined_filters(flow, b, w, sw)
    markers = (detection.get_growth_rate(flow, -b, times, "cubic") * combined > 0.5) | (
        detection.get_growth_rate(flow, w, times, "cubic") * combined > 0.25)
    markers = binary_opening(markers, structure=fused._s2d_structure())
    want = fused.core_markers(b, w, sw, flow.forward_flow, flow.backward_flow,
                              detection._per_minute(flow, times), 0.25, 0.5, True)
    if not torch.equal(markers, want) or int(want.sum()) == 0:
        raise AssertionError(f"legacy (a): the op-by-op filters' markers ({int(markers.sum())} "
                             f"px) differ from fused.core_markers' ({int(want.sum())} px)")
    n_markers = int(want.sum())
    del b, w, sw, combined, markers, want
    log(f"legacy and gridding (a): the card's sides in {time.perf_counter() - t0:.1f} s: the "
        f"legacy CLI at {LEGACY_SMALL}, detect_anvils(markers=None) and flow_network_watershed "
        f"on its cut, {launches} ws_sweeps launches {by_shape}; the op-by-op filters give "
        f"fused.core_markers' {n_markers} marker pixels [{card_line}]")

    def finish():
        cpu = cpu_run.result()
        legacy_ds = cpu["legacy"]
        counts = {k: int(legacy_ds[k].values.max()) for k in ("growth_markers",
                                                              "watershed_label")}
        if min(counts.values()) == 0 or cpu["anvils_none"].max() == 0:
            raise AssertionError(f"legacy (a): an empty result {counts}, anvils "
                                 f"{cpu['anvils_none'].max()}")
        for name in ("legacy", "radar", "flux", "flux_native"):
            compare_datasets(cpu[name], card[name], rtol32=0.0, rtol64=0.0)
        for name in ("anvils_none", "network_ws"):
            if not np.array_equal(cpu[name], card[name]):
                raise AssertionError(f"legacy (a): {name} card != CPU")
        for a, b in zip(cpu["radar_3d"], card["radar_3d"]):
            if not np.array_equal(a, b, equal_nan=True):
                raise AssertionError("legacy (a): the 3D radar histogram card != CPU")
        gates = int(cpu["radar"]["nexrad_gate_count"].values.sum())
        log(f"legacy and gridding (a) checks: card = CPU bit for bit: the legacy CLI's dataset "
            f"(markers {counts['growth_markers']}, objects {counts['watershed_label']}, their "
            f"BT mean, std, max, min), detect_anvils(markers=None) "
            f"({int(cpu['anvils_none'].max())} anvil), flow_network_watershed "
            f"({int(cpu['network_ws'].max())} labels), the crafted archive's {gates} gates in "
            f"{RADAR_WINDOW} (2D composite and 20-level 3D), grid_flux and grid_flux_native")

    return by_shape, finish


def run_legacy(device, card_line, goes_fields):
    """Phase 15 (b), the legacy path: ``detect_legacy`` (the CLI-default
    flow, the multichannel growth markers and the edge watershed) on the
    CONUS-shaped GOES scene's first LEGACY_FRAMES frames at 1500x2500 on
    the card, with the kernel's counts reset just before and read just
    after.  Each step's seconds, peak over its start against the budget at
    the path's start, the flood's rounds and the launches by shape are
    logged.  Checks: at least one marker and one object; every peak
    within the budget.  Returns (launches, launches by shape)."""
    from tobac_flow_tpu_torch.cli.dcc_detect_legacy import detect_legacy

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bt, wvd, swd = (torch.from_numpy(np.asarray(f.values)[:LEGACY_FRAMES]).to(device)
                    for f in goes_fields)
    times = np.asarray(goes_fields[0].coords["t"])[:LEGACY_FRAMES]
    torch.cuda.synchronize()
    budget = port_device.memory_budget(device)
    stats = {}
    reset_counts()
    t1 = time.perf_counter()
    ds = detect_legacy(bt, wvd, swd, times, device=device, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches, by_shape = read_counts()
    markers = int(ds["growth_markers"].data.max())
    labels = ds["watershed_label"].data
    objects, labelled = int(labels.max()), int((labels > 0).sum())
    steps = ("flow", "markers", "watershed", "edge_prep", "edge_flood", "edge_opening")
    over = [n for n in steps if stats[f"{n}_peak_bytes"] - stats[f"{n}_start_bytes"] > budget]
    if markers == 0 or objects == 0 or launches == 0 or over:
        raise AssertionError(f"legacy (b): markers {markers}, objects {objects}, launches "
                             f"{launches}, peaks over the budget {over}")
    del ds, labels, bt, wvd, swd
    log(f"legacy (b) {(LEGACY_FRAMES,) + JOB_FRAME} of the GOES scene [{card_line}]: "
        f"{seconds:.3f} s; " + "; ".join(
            f"{n} {stats[n + '_s']:.3f} s, peak {(stats[n + '_peak_bytes'] - stats[n + '_start_bytes']) / 2**30:.3f} GiB over its start"
            for n in steps)
        + f" (budget {budget / 2**30:.3f} GiB); flood rounds " + ", ".join(
            f"{k} {v}" for k, v in sorted(stats.items()) if k.endswith("rounds"))
        + f"; growth markers {markers}, objects {objects} ({labelled} px); ws_sweeps launches "
        f"{launches} {by_shape}; phase {time.perf_counter() - t0:.1f} s")
    return launches, by_shape


def radar_gates(goes):
    """Phase 15 (b)'s radar volumes, on the host: RADAR_SITES sites that
    ``filter_nexrad_sites`` finds on the grid ``goes``, each a volume of
    ``radar_volume``'s shape (RADAR_CUTS x RADAR_RADIALS x RADAR_GATES
    gates) drawn from its seed, parallax-mapped to scan angles by
    ``map_nexrad_to_goes``.  Returns (sites, per site (x, y, alt, refl),
    seconds drawing, seconds mapping)."""
    from tobac_flow_tpu_torch.data import nexrad

    sites = nexrad.filter_nexrad_sites(goes)
    if len(sites) < RADAR_SITES:
        raise AssertionError(f"radar: {len(sites)} sites on the grid, want {RADAR_SITES}")
    # spread over the grid: every len(sites) // RADAR_SITES-th site
    sites = sites[::len(sites) // RADAR_SITES][:RADAR_SITES]
    t0 = time.perf_counter()
    volumes = [radar_volume(nexrad.NEXRAD_SITES[s] + (200.0 + 100.0 * k,), 100 + k)
               for k, s in enumerate(sites)]
    t1 = time.perf_counter()
    mapped = []
    for lat, lon, alt, refl in volumes:
        gx, gy = nexrad.map_nexrad_to_goes(lat, lon, alt, goes)
        mapped.append((gx, gy, alt, refl))
    return sites, mapped, t1 - t0, time.perf_counter() - t1


def run_radar(device, card_line, goes, made):
    """Phase 15 (b), the radar gridding on the card: ``made``'s gates
    (``radar_gates``, made beside earlier phases) binned by
    ``get_nexrad_hist`` per site and composited (counts summed, mean
    reflectivities by ``fmax``, as ``regrid_nexrad``), and by
    ``get_3d_nexrad_hist`` over all sites, timed.  Checks: every gate on
    the grid counted, means finite exactly where counts are positive, the
    3D counts summed over altitude within the composite's (gates above
    the top level are left out).  Returns a
    function that starts the CPU's check of RADAR_CHECK_CUT (the 3D
    histogram over that cut of the grid, its border bins left out, whose
    outer edges are the cut's own) in a thread and gives the function
    that waits for it."""
    from tobac_flow_tpu_torch.data import nexrad

    (sites, mapped, drawn, projected), _, waited = made()
    n = sum(m[0].size for m in mapped)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = mean = None
    for gx, gy, alt, refl in mapped:
        c, m = nexrad.get_nexrad_hist(gx, gy, refl, goes, device=device)
        counts, mean = (c, m) if counts is None else (counts + c, torch.fmax(mean, m))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    gx, gy, alt, refl = (np.concatenate([m[i] for m in mapped]) for i in range(4))
    t2 = time.perf_counter()
    c3, m3 = nexrad.get_3d_nexrad_hist(gx, gy, alt, refl, goes, RADAR_ALT_EDGES, device=device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    gridded = int(counts.sum())
    in_levels = int(c3.sum())  # gates above the top level (20 km) are left out in 3D
    if (gridded == 0 or not bool((c3.sum(0) <= counts).all()) or not 0 < in_levels <= gridded
            or not torch.equal(torch.isfinite(mean), counts > 0)
            or not torch.equal(torch.isfinite(m3), c3 > 0)):
        raise AssertionError(f"radar (b): {gridded} gates gridded; 2D and 3D counts or means "
                             f"disagree")
    levels = int((c3.sum((1, 2)) > 0).sum())
    ry, rx = RADAR_CHECK_CUT
    card_cut = [a[:, ry, rx].cpu().numpy() for a in (c3, m3)]
    del c3, m3, counts, mean
    log(f"radar (b) [{card_line}]: {len(sites)} sites {sites} on the {JOB_FRAME} CONUS grid, "
        f"{n} gates ({len(RADAR_CUTS)} cuts of {RADAR_RADIALS}x{RADAR_GATES} a site), drawn "
        f"in {drawn:.2f} s and projected in {projected:.2f} s on the host ({waited:.1f} s "
        f"waited for); binned on the card: 2D composite {t1 - t0:.3f} s ({gridded} gates on "
        f"the grid), 3D {t3 - t2:.3f} s ({in_levels} gates in {levels} of "
        f"{RADAR_ALT_EDGES.size - 1} levels)")

    def start_check():
        cut = window_grid(*JOB_FRAME)
        cut.coords["x"] = goes.coords["x"][rx]
        cut.coords["y"] = goes.coords["y"][ry]
        job = prefetched(lambda: [a.numpy() for a in nexrad.get_3d_nexrad_hist(
            gx, gy, alt, refl, cut, RADAR_ALT_EDGES, device="cpu")])

        def finish():
            want = job()[0]
            inner = (slice(None), slice(1, -1), slice(1, -1))
            for name, a, b in zip(("counts", "means"), want, card_cut):
                if not np.array_equal(a[inner], b[inner], equal_nan=True):
                    raise AssertionError(f"radar (b): the 3D {name} of the cut card != CPU")
            log(f"radar (b) check: the 3D histogram's cut {card_cut[0].shape} (its border bins "
                f"left out) equals the CPU's bit for bit ({int(want[0][inner].sum())} gates)")

        return finish

    return start_check


def chunk_budget(shape, mixed, chunk):
    """A ``budget_bytes`` under which ``watershed`` floods a volume of
    ``shape`` in chunks of ``chunk`` frames (or fewer, evened out)."""
    t, h, w = shape
    return ((chunk + 2) * ws.FLOOD_BYTES_PER_PX[mixed] * h * w
            + t * h * w * ws._CHUNKED_BYTES_PER_PX)


def reset_counts():
    ws_sweeps.spatial_sweeps.launches = 0
    ws_sweeps.spatial_sweeps.launches_by_shape.clear()


def read_counts():
    sweeps = ws_sweeps.spatial_sweeps
    return sweeps.launches, {shape_key(key[:3], key[3]): n
                             for key, n in sweeps.launches_by_shape.items()}


def chunk_line(stats):
    return (f"{stats['chunks']} chunks of {stats['chunk_frames']} frames, "
            f"{stats['chunk_passes']} passes, {stats['chunk_floods']} chunk floods, "
            f"{stats['chunk_skips']} skipped; rounds " + ", ".join(
                f"{k} {v}" for k, v in sorted(stats.items()) if k.endswith("rounds")))


def cpu_chunked_flood(fwd, bwd, edges, markers, mask, budget):
    """The time-chunked flood on the CPU (numpy in, labels and stats out):
    the CPU side of ``check_chunked_small``, run in a worker process
    (``cpu_legs``)."""
    torch.set_num_threads(CPU_LEG_THREADS)
    stats = {}
    labels = ws.watershed(*(torch.from_numpy(a) for a in (fwd, bwd, edges, markers, mask)),
                          max_iters=128, stats=stats, budget_bytes=budget, device="cpu")
    return labels.numpy(), stats


def check_chunked_small(device, card_line, legs):
    """The time-chunked flood on the card against the CPU at CHUNK_SMALL,
    3 chunks, with the slice's markers and with a -1 barrier ring added
    inside the mask, given the same inputs (the CPU's flow and fields):
    identical labels.  The CPU's floods run in ``legs``' worker process;
    returns a function that waits for them and checks the card's labels
    against them."""
    from tobac_flow_tpu_torch.pipeline import _fields_stage

    bt = make_scene(*CHUNK_SMALL)
    markers, _ = make_markers(bt)
    fwd, bwd, _, field, edges = _fields_stage(torch.from_numpy(bt), 5.0)
    markers = torch.from_numpy(markers)
    mask = field > 0.05
    mixed = torch.where((markers == 0) & mask & (field < 0.1), -1, markers)
    runs = []
    for kind, mk in (("plain", markers), ("mixed", mixed)):
        budget = chunk_budget(CHUNK_SMALL, kind == "mixed", 4)
        cpu_run = legs.submit(cpu_chunked_flood, *(a.numpy() for a in (fwd, bwd, edges, mk,
                                                                         mask)), budget)
        stats = {}
        reset_counts()
        card = ws.watershed(fwd, bwd, edges, mk, mask=mask, max_iters=128, stats=stats,
                            budget_bytes=budget)
        launches = ws_sweeps.spatial_sweeps.launches
        if stats.get("chunks", 0) < 3 or launches == 0:
            raise AssertionError(f"chunked small {kind}: {stats.get('chunks')} chunks, "
                                 f"{launches} launches")
        runs.append((kind, cpu_run, card.cpu(), stats, launches))

    def finish():
        for kind, cpu_run, card, st_card, launches in runs:
            cpu, st_cpu = cpu_run.result()
            cpu = torch.from_numpy(cpu)
            if not torch.equal(cpu, card) or st_cpu != st_card:
                raise AssertionError(f"chunked small {kind}: card labels differ from the CPU's "
                                     f"at {int((cpu != card).sum())} pixels ({st_card} vs "
                                     f"{st_cpu})")
            log(f"chunked flood {CHUNK_SMALL} {kind} markers: the card's labels equal the CPU's "
                f"({chunk_line(st_card)}; {launches} kernel launches; the CPU's flood in the "
                f"worker process)")

    return finish


def run_chunked_fit(device, card_line):
    """At FIT_DEPTH x JOB_FRAME, which the card floods whole: the flood of
    the fused path's inputs whole (the default budget) and in 3 chunks (a
    budget for a third of the frames).  Labels agree at CHUNK_AGREEMENT.
    Returns the chunked run's launches by shape."""
    from tobac_flow_tpu_torch.pipeline import _fields_stage

    shape = (FIT_DEPTH,) + JOB_FRAME
    t0 = time.perf_counter()
    bt = job_scene(*shape)
    markers, n = make_markers(bt)
    log(f"made {shape} with {n} markers on the host in {time.perf_counter() - t0:.1f} s")
    fwd, bwd, growth, field, edges = _fields_stage(torch.from_numpy(bt).to(device), 5.0)
    markers = torch.from_numpy(markers).to(device)
    mask = field > 0.05
    del growth, field
    runs = {}
    for name, budget in (("whole", None), ("chunked", chunk_budget(shape, False, -(-shape[0] // 3)))):
        stats = {}
        gc.collect()
        torch.cuda.synchronize()
        port_device.reset_peak_memory(device)
        before = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        labels = ws.watershed(fwd, bwd, edges, markers, mask=mask, max_iters=128, stats=stats,
                              budget_bytes=budget, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, by_shape = read_counts()
        peak = port_device.peak_memory(device) - before
        runs[name] = labels, stats, by_shape
        log(f"flood of {shape} {name} [{card_line}]: {seconds:.3f} s, peak {peak / 2**30:.3f} GiB "
            f"over its inputs ({peak / np.prod(shape):.1f} B/px), {launches} kernel launches; "
            + (chunk_line(stats) if name == "chunked" else "rounds " + ", ".join(
                f"{k} {v}" for k, v in sorted(stats.items()) if k.endswith("rounds"))))
    (whole, st_whole, _), (chunked, st_chunked, by_shape) = runs["whole"], runs["chunked"]
    if "chunks" in st_whole or st_chunked.get("chunks", 0) < 3:
        raise AssertionError(f"flood of {shape}: whole {st_whole.get('chunks')} chunks, "
                             f"chunked {st_chunked.get('chunks')}")
    agree = float((chunked == whole).float().mean())
    labelled = float((whole != 0).float().mean())
    if agree < CHUNK_AGREEMENT or labelled == 0:
        raise AssertionError(f"flood of {shape}: chunked agrees with whole at {agree:.6f}")
    log(f"flood of {shape}: chunked labels agree with the whole volume's at {agree:.6f} "
        f"(bar {CHUNK_AGREEMENT}); labelled {labelled:.4f} of the pixels")
    return by_shape


# held through the deep flood: bt, the flows (8 B each), growth, edges and
# markers (4 B), the mask (1 B) and the labels (4 B)
DEEP_RESIDENT_BYTES_PER_PX = 4 + 16 + 4 + 4 + 4 + 1 + 4


def deep_shape(device):
    """(the deep main path's shape, the frames the card floods whole, the
    budget): DEEP_OVER_FIT times the most frames of JOB_FRAME that the
    card's budget floods whole."""
    h, w = JOB_FRAME
    torch.cuda.empty_cache()
    budget = port_device.memory_budget(device)
    fit = budget // ((ws.FLOOD_BYTES_PER_PX[False] + DEEP_RESIDENT_BYTES_PER_PX) * h * w)
    return (int(math.ceil(DEEP_OVER_FIT * fit)), h, w), fit, budget


def deep_inputs(shape):
    """The deep main path's scene and markers."""
    bt = job_scene(*shape)
    return bt, make_markers(bt)


def run_deep(device, card_line, scene=None):
    """``fused_flow_watershed`` at JOB_FRAME and DEEP_OVER_FIT times the most
    frames the card floods whole (FLOOD_BYTES_PER_PX and the resident
    inputs against the free memory), in at least 3 time chunks.  ``scene``:
    (the shape it is for, its inputs being made beside the earlier phases,
    ``prefetched``), used where the shape is this run's.  Returns
    (launches, launches by shape)."""
    shape, fit, budget = deep_shape(device)
    t, h, w = shape
    resident = DEEP_RESIDENT_BYTES_PER_PX
    total = torch.cuda.get_device_properties(device).total_memory
    if t * h * w * ws.FLOOD_BYTES_PER_PX[False] <= total:
        raise AssertionError(f"deep main path: {shape} would flood whole in {total} bytes")
    own = ws.chunk_frames(t, h, w, budget - t * h * w * resident, False)
    chunk = min(own, -(-t // 3))
    if scene is None or scene[0] != shape:
        scene = (shape, prefetched(deep_inputs, shape))
    (bt, (markers, n)), made, waited = scene[1]()
    log(f"deep main path: the card floods at most {fit} frames of {JOB_FRAME} whole "
        f"({budget / 2**30:.1f} GiB budget of {total / 2**30:.1f} GiB, "
        f"{ws.FLOOD_BYTES_PER_PX[False]} + {resident} B/px); "
        f"running {shape} ({np.prod(shape) / 1e6:.0f} Mpx, {n} markers, made on the host in "
        f"{made:.1f} s, {waited:.1f} s waited for); the card's own budget "
        f"would give "
        f"{-(-t // own)} chunks of {own} frames, this run {-(-t // chunk)} of {chunk}")
    bt_dev = torch.from_numpy(bt).to(device)
    del bt
    gc.collect()
    torch.cuda.synchronize()
    port_device.reset_peak_memory(device)
    resident_start = torch.cuda.memory_allocated()
    stats = {}
    reset_counts()
    t0 = time.perf_counter()
    fwd, growth, edges, labels = fused_flow_watershed(
        bt_dev, 5.0, markers=markers, stats=stats,
        budget_bytes=chunk_budget(shape, False, chunk), device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, by_shape = read_counts()
    peak = port_device.peak_memory(device)
    if stats.get("chunks", 0) < 3 or launches == 0:
        raise AssertionError(f"deep main path: {stats.get('chunks')} chunks, {launches} launches")
    if not bool(torch.isfinite(fwd).all()):
        raise AssertionError("deep main path: non-finite flow")
    lab = labels.cpu().numpy()
    present = set(np.unique(lab[lab > 0]).tolist())
    if present != set(range(1, n + 1)) or not np.array_equal(lab[markers != 0],
                                                              markers[markers != 0]):
        raise AssertionError(f"deep main path: labels {sorted(present)[:8]}... of 1..{n}")
    step = stats["chunk_frames"]
    crossing = []
    for b in range(step, t, step):
        both = set(np.unique(lab[b - 1]).tolist()) & set(np.unique(lab[b]).tolist()) - {0}
        if not both:
            raise AssertionError(f"deep main path: no label crosses the chunk boundary at {b}")
        crossing.append(len(both))
    log(f"deep main path {shape} through fused_flow_watershed [{card_line}]: {seconds:.3f} s, "
        f"{np.prod(shape) / 1e6 / seconds:.3f} Mpix/s; " + "; ".join(
            f"{name} {stats[name + '_s']:.3f} s, peak {stats[name + '_peak_bytes'] / 2**30:.3f} "
            f"GiB ({(stats[name + '_peak_bytes'] - stats[name + '_start_bytes']) / np.prod(shape):.1f}"
            f" B/px over its start)" for name in STAGES)
        + f"; {chunk_line(stats)}; labels crossing each chunk boundary {crossing}; kernel "
        f"launches {launches} {by_shape}; device memory at start {resident_start / 2**30:.3f} "
        f"GiB, peak {peak / 2**30:.3f} GiB")
    return launches, by_shape


# The chain's stages in time chunks.  Each chain stage's budget gives its
# largest step 4-frame chunks (3 chunks of 3 frames at 9 frames): the
# step's bytes per pixel, halo frames and whole-volume output bytes per
# pixel (device.py).
STAGE_STEPS = {
    "detect_cores": (port_device.CORE_MARKERS_BYTES_PER_PX, 1, 1),
    "anvil_markers": (port_device.LINK_BYTES_PER_PX, 1, 4),
    "thick_anvils": (port_device.ANVIL_PRE_BYTES_PER_PX, 2, 8),
    "relabel_anvils": (port_device.LINK_BYTES_PER_PX, 1, 4),
    "thin_anvils": (port_device.ANVIL_PRE_BYTES_PER_PX, 2, 8),
    "output": (port_device.OUTPUT_BYTES_PER_PX, 0, 0),
}
CHUNK_CAP = 4  # frames a forced chunk holds at most
# the deep phase's depth over the most frames detect_cores holds whole in
# the card's own budget (CORE_MARKERS_BYTES_PER_PX): 116 frames for a fit of
# 108 on an H100 80GB HBM3 (1.25, 135 frames, past the card's whole memory,
# until the configured detection's phase needed the time)
DEEP_CORES_OVER_FIT = 1.07


def stage_budget(name, shape, frames=CHUNK_CAP):
    """A ``budget_bytes`` under which the chain stage ``name`` runs its
    largest step over ``shape`` in chunks of at most ``frames``."""
    per_px, halo, out_px = STAGE_STEPS[name]
    t, h, w = shape
    return (frames + 2 * halo) * per_px * h * w + out_px * t * h * w


def _host(x, device=None):
    """``x`` with its tensors (and a ``Flow``'s flows) on the host, or on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.cpu() if device is None else x.to(device)
    if isinstance(x, Flow):
        return Flow(_host(x.forward_flow, device), _host(x.backward_flow, device))
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _host(v, device) for k, v in x.items()}
    return x


class recorded_stages:
    """Within it, each call of the chain's ``detect_cores``,
    ``get_anvil_markers``, ``detect_anvils`` and ``relabel_anvils`` is
    appended to ``calls`` as (function name, host copies of its
    arguments, keyword arguments, its labels on the host), and each flood
    to ``floods`` as host copies of (field, markers, labels).  A ``Flow``
    argument is kept as a host copy (``_host``), so that the card frees
    it when the chain ends."""

    NAMES = ("detect_cores", "get_anvil_markers", "detect_anvils", "relabel_anvils")

    def __init__(self, calls, floods):
        self.calls, self.floods, self.flows = calls, floods, {}

    def __enter__(self):
        self.saved = {n: getattr(chain_mod, n) for n in self.NAMES}
        self.saved_ws = ws.watershed
        for name, fn in self.saved.items():
            def wrapped(flow, *args, _fn=fn, _name=name, **kwargs):
                result = _fn(flow, *args, **kwargs)
                if id(flow) not in self.flows:  # one host copy of the run's flow
                    self.flows[id(flow)] = _host(flow)
                self.calls.append((_name, (self.flows[id(flow)],) + _host(args), _host(kwargs),
                                   result.cpu()))
                return result
            setattr(chain_mod, name, wrapped)

        def flood(*args, **kwargs):
            result = self.saved_ws(*args, **kwargs)
            self.floods.append((args[2].cpu(), args[3].cpu(), result.cpu()))
            return result
        ws.watershed = flood
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(chain_mod, name, fn)
        ws.watershed = self.saved_ws


def bits_equal(a, b):
    """Equal bit for bit (NaN payloads and signed zeros included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


class replayed_floods:
    """Within it, ``ops.watershed.watershed`` returns the recorded flood
    whose field and markers equal its own, and raises where none does."""

    def __init__(self, floods):
        self.floods = floods

    def __enter__(self):
        self.saved = ws.watershed

        def flood(fwd, bwd, field, markers, *args, device=None, **kwargs):
            for f, m, labels in self.floods:
                if bits_equal(field.cpu(), f) and torch.equal(markers.cpu(), m):
                    return labels.to(device)
            raise AssertionError("a chunked stage's flood inputs differ from the whole run's")
        ws.watershed = flood
        return self

    def __exit__(self, *exc):
        ws.watershed = self.saved


def check_chunked_chain_small(small, card_line):
    """``cli.common.run_detection`` on the card at CHAIN_SMALL under a
    budget that forces the anvil stages into 4-frame chunks (3 chunks),
    given the card's flow, against ``check_chain_small``'s whole run on
    the card (``small``: its fields, flow and dataset): identical
    datasets, anvil markers included; the floods stay whole at 9 frames.
    Returns the chunked run's launches by shape."""
    (bt, wvd, swd, times), flow, whole = small[:3]
    fields, ds = chain_inputs(bt, wvd, swd, times)
    opts = DetectionOptions(save_anvil_markers=True, save_spatial_props=True,
                            flow_factory=lambda _: flow)
    stats = {}
    reset_counts()
    out = cli.run_detection(*fields, ds, opts=opts, stats=stats,
                            budget_bytes=stage_budget("thick_anvils", CHAIN_SMALL))
    launches, by_shape = read_counts()
    if (stats["thick_anvils_chunks"] < 3 or stats["thin_anvils_chunks"] < 3 or launches == 0
            or stats["thick_anvils_flood_chunks"] != 1):
        raise AssertionError(f"chunked chain small: chunks {chunk_counts(stats)}, "
                             f"{launches} launches")
    worst = compare_datasets(whole, out)
    log(f"chunked chain {CHAIN_SMALL} on the card [{card_line}]: cli.run_detection under a "
        f"4-frame budget gives the whole run's dataset ({len(whole.data_vars)} variables; "
        f"float32 means and stds within {worst:.3g}, the rest identical); chunks (stage: "
        f"chunks, fewest frames) {chunk_counts(stats)}; {launches} kernel launches")
    return by_shape


def chunk_counts(stats):
    return {n: (stats.get(f"{n}_chunks"), stats.get(f"{n}_chunk_frames"))
            for n in CLI_STAGES[1:] if f"{n}_chunks" in stats}


def check_chunked_goes(record, device, card_line):
    """Every chunked stage at the CONUS-shaped GOES run's 9x1500x2500,
    teacher-forced with that run's flow, stage inputs and flood outputs
    (``recorded_stages``), each under a budget that forces its largest
    step into 3 chunks (``stage_budget``), its inputs (but the flow, which
    returns to the card) waiting on the host:
    each stage's labels identical to the run's own; then the output stages
    under their budget give the run's dataset (``compare_datasets``)."""
    stage_of = iter(("detect_cores", "anvil_markers", "thick_anvils", "relabel_anvils",
                     "thin_anvils"))
    done, flow = [], None
    with replayed_floods(record["floods"]):
        for fn_name, args, kwargs, want in record["calls"]:
            name = next(stage_of)
            shape = tuple(want.shape)
            budget = stage_budget(name, shape)
            stats = {}
            gc.collect()
            torch.cuda.synchronize()
            if flow is None:
                flow = _host(args[0], device)
            with port_device.stage(name, stats, device):
                got = getattr(chain_mod, fn_name)(flow, *args[1:],
                                                  **{**kwargs, "budget_bytes": budget})
            if stats[f"{name}_chunks"] < 3 or not torch.equal(got.cpu(), want):
                raise AssertionError(
                    f"chunked GOES {name}: {stats[f'{name}_chunks']} chunks; labels differ at "
                    f"{int((got.cpu() != want).sum())} pixels")
            over = stats[f"{name}_peak_bytes"] - stats[f"{name}_start_bytes"]
            done.append(f"{name} {stats[f'{name}_s']:.3f} s in {stats[f'{name}_chunks']} "
                        f"chunks of {stats[f'{name}_chunk_frames']} frames, peak "
                        f"{over / 2**30:.3f} GiB over its start (budget {budget / 2**30:.3f})")
            del got
    (bt, wvd, swd), ds = record["fields"], record["ds"]
    ds = Dataset(data_vars=ds.data_vars, coords=ds.coords)
    for name, da in record["labels"].items():
        ds[name] = DataArray(da.data.clone(), dims=da.dims, attrs=da.attrs)
    stats = {}
    budget = stage_budget("output", tuple(bt.shape))
    out = cli.prepare_output(ds, bt, wvd, swd, stats=stats, budget_bytes=budget)
    low = [n for n in cli.OUTPUT_STAGES if stats[f"{n}_chunks"] < 3]
    if low:
        raise AssertionError(f"chunked GOES output: {low} ran in under 3 chunks")
    worst = compare_datasets(record["out"], out)
    log(f"chunked GOES {tuple(bt.shape)} [{card_line}], teacher-forced, each stage in forced "
        f"chunks equal to the whole run: " + "; ".join(done) + "; output stages " + ", ".join(
            f"{n} {stats[n + '_s']:.3f} s in {stats[n + '_chunks']} chunks" for n in
            cli.OUTPUT_STAGES) + f": the run's dataset (float32 means and stds within "
        f"{worst:.3g}, the rest identical)")


def storm_cells(h, w, seed=0):
    """``tools/parity_detect.make_multistorm_scene``'s cells over (h, w):
    (n, centres y and x, radii, growth phases) from the same draws."""
    rng = np.random.default_rng(seed)
    n = max(6, min(24, (h * w) // 8000))
    cols = int(np.ceil(np.sqrt(n * 1.5)))
    rows = int(np.ceil(n / cols))
    pitch_y, pitch_x = 0.72 * h / rows, 0.55 * w / cols
    ks = np.arange(n)
    cy = 0.14 * h + (ks // cols + 0.5 + rng.uniform(-0.15, 0.15, n)) * pitch_y
    cx = 0.04 * w + (ks % cols + 0.5 + rng.uniform(-0.15, 0.15, n)) * pitch_x
    pitch = min(pitch_y, pitch_x)
    radius = rng.uniform(pitch / 5.0, pitch / 3.2, n)
    phase = rng.uniform(0.0, 0.3, n)
    return n, cy, cx, radius, phase


def deep_scene(t, h, w, seed=0, threads=8, cycle=GOES_FULL[0]):
    """BT, WVD and SWD of ``make_multistorm_scene``'s storms at (t, h, w):
    its cells, 2 px and 0.5 px a frame of advection and channel formulas,
    the cells growing anew every ``cycle`` frames as they grow over the
    GOES scene's frames (so that a deep scene has storms that cool as
    fast as the GOES scene's), each cell's Gaussian summed within 6 radii
    of its centre; frames computed in threads, each frame's noise (the
    scene's amplitudes) drawn from a generator seeded by (``seed``, the
    frame)."""
    from concurrent.futures import ThreadPoolExecutor

    n, cy, cx, radius, phase = storm_cells(h, w, seed)
    fields = [np.empty((t, h, w), np.float32) for _ in range(3)]
    channels = ((290.0, -80.0, 0.15), (-15.0, 16.0, 0.1), (5.0, -4.0, 0.05))

    def frame(i):
        prog = (i % cycle) / max(cycle - 1, 1)
        acc = np.zeros((h, w))
        for k in range(n):
            g = min(max((prog - phase[k]) / 0.35, 0.0), 1.0)
            if g <= 0:
                continue
            y0, x0, r = cy[k] + 0.5 * i, cx[k] + 2.0 * i, 6 * radius[k]
            ys = slice(max(0, int(y0 - r)), min(h, int(y0 + r) + 1))
            xs = slice(max(0, int(x0 - r)), min(w, int(x0 + r) + 1))
            yy, xx = np.ogrid[ys, xs]
            acc[ys, xs] += g * np.exp(-((xx - x0) ** 2 + (yy - y0) ** 2) / (2 * radius[k] ** 2))
        core = np.minimum(acc, 1.2).astype(np.float32)
        noise = np.random.default_rng([seed, i]).standard_normal((3, h, w), dtype=np.float32)
        for f, z, (base, scale, sigma) in zip(fields, noise, channels):
            f[i] = np.float32(base) + np.float32(scale) * core + np.float32(sigma) * z

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(frame, range(t)))
    return fields


def deep_chain_most_frames(device):
    """The most frames ``run_deep_chain`` can run: DEEP_CORES_OVER_FIT times
    the frames that detect_cores holds whole in the card's total memory
    less its margin, which its budget never exceeds."""
    h, w = JOB_FRAME
    total = torch.cuda.get_device_properties(device).total_memory
    room = total - int(port_device.MEMORY_MARGIN * total)
    return int(math.ceil(DEEP_CORES_OVER_FIT * (
        room // (port_device.CORE_MARKERS_BYTES_PER_PX * h * w))))


def run_deep_chain(device, card_line, scene):
    """The chain's stages before the floods at JOB_FRAME past the depth
    that detect_cores holds whole in the card's own budget
    (DEEP_CORES_OVER_FIT x that depth): ``create_flow``, ``detect_cores``
    and ``get_anvil_markers`` under the card's own budget, each stage's
    seconds, peak, chunks and objects logged, every peak within the budget
    at its start, ``detect_cores`` in at least 2 chunks, cores and markers
    non-empty; then ``detect_cores`` again
    at half the chunk depth gives the same labels.  ``scene``:
    ``deep_scene`` at ``deep_chain_most_frames`` made beside an earlier
    check (``prefetched``), whose first frames are the run's, as each
    frame is made alone.  Returns the cores, the anvil markers (on the
    card), the BT (on the host) and the times, for the linking phase."""
    h, w = JOB_FRAME
    opts = DetectionOptions()
    gc.collect()
    torch.cuda.empty_cache()
    budget = port_device.memory_budget(device)
    total = torch.cuda.get_device_properties(device).total_memory
    per_px = port_device.CORE_MARKERS_BYTES_PER_PX
    fit = budget // (per_px * h * w)
    t = int(math.ceil(DEEP_CORES_OVER_FIT * fit))
    shape = (t, h, w)
    if t <= fit:
        raise AssertionError(f"deep chain: {shape} would run detect_cores whole in the budget")
    full, made, waited = scene()
    if full[0].shape[0] < t:
        raise AssertionError(f"deep chain: a scene of {full[0].shape[0]} frames for {shape}")
    bt, wvd, swd = (f[:t] for f in full)
    del full
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    log(f"deep chain: the card's budget ({budget / 2**30:.1f} GiB of {total / 2**30:.1f} GiB) "
        f"holds detect_cores whole ({per_px} B/px) to {fit} frames of {JOB_FRAME}; running "
        f"{shape} ({np.prod(shape) / 1e6:.0f} Mpx, whole need "
        f"{t * h * w * per_px / 2**30:.1f} GiB), scene made on the host in {made:.1f} s "
        f"({waited:.1f} s waited for; {3 * bt.nbytes / 2**30:.1f} GiB of the host's "
        f"{host / 2**30:.1f} GiB)")
    times = chain_times(t)
    fields = [port_device.place(torch.from_numpy(a), device) for a in (bt, wvd, swd)]
    del bt, wvd, swd
    stats, budgets = {}, {}
    kw = dict(overlap=opts.overlap, absolute_overlap=opts.absolute_overlap,
              subsegment_shrink=opts.subsegment_shrink, min_length=opts.t_offset)

    def run(name, fn, extra=None):
        gc.collect()
        torch.cuda.synchronize()
        # the budget as the stage's own planner sees it: the blocks that the
        # allocator caches from the stage before are free to it
        torch.cuda.empty_cache()
        budgets[name] = port_device.memory_budget(device)
        with port_device.stage(name, stats, device):
            result = fn()
        if extra is not None:
            stats[f"{name}_n"] = int(extra(result))
        return result

    flow = run("flow", lambda: create_flow(fields[0], vr_steps=opts.vr_steps,
                                           smoothing_passes=opts.smoothing_passes,
                                           interp_method=opts.interp_method))
    cores = run("detect_cores", lambda: detect_cores(
        flow, *fields, times, wvd_threshold=opts.wvd_threshold, bt_threshold=opts.bt_threshold,
        use_wvd=opts.use_wvd, **kw), lambda r: r.max())
    diff = fields[1] - fields[2]
    markers = run("anvil_markers", lambda: get_anvil_markers(
        flow, diff, threshold=opts.thick_upper, **kw), lambda r: r.max())
    del diff
    names = ("flow", "detect_cores", "anvil_markers")
    over = [n for n in names
            if stats[f"{n}_peak_bytes"] - stats[f"{n}_start_bytes"] > budgets[n]]
    if (over or stats["detect_cores_n"] == 0 or stats["anvil_markers_n"] == 0
            or stats.get("detect_cores_chunks", 1) < 2):
        raise AssertionError(f"deep chain: peaks over budget {over}; objects "
                             f"{stats['detect_cores_n']}, {stats['anvil_markers_n']}; "
                             f"{stats.get('detect_cores_chunks', 1)} chunks; " + ", ".join(
                                 f"{n} peak {stats[n + '_peak_bytes']} start "
                                 f"{stats[n + '_start_bytes']} budget {budgets[n]}"
                                 for n in names))
    log(f"deep chain {shape} [{card_line}]: " + "; ".join(
        f"{n} {stats[n + '_s']:.3f} s, peak {stats[n + '_peak_bytes'] / 2**30:.3f} GiB "
        f"({(stats[n + '_peak_bytes'] - stats[n + '_start_bytes']) / 2**30:.3f} over its start, "
        f"budget {budgets[n] / 2**30:.3f})"
        + (f", {stats[n + '_chunks']} chunks, the fewest {stats[n + '_chunk_frames']} frames"
           if n + "_chunks" in stats else "")
        + (f", objects {stats[n + '_n']}" if n + "_n" in stats else "") for n in names)
        + f"; {stats['detect_cores_s'] / t:.3f} s a frame in detect_cores")
    half = max(1, stats["detect_cores_chunk_frames"] // 2)
    again = {}
    t0 = time.perf_counter()
    with port_device.stage("detect_cores", again, device):
        cores_half = detect_cores(
            flow, *fields, times, wvd_threshold=opts.wvd_threshold,
            bt_threshold=opts.bt_threshold, use_wvd=opts.use_wvd,
            budget_bytes=stage_budget("detect_cores", shape, half), **kw)
    if not torch.equal(cores, cores_half):
        raise AssertionError("deep chain: detect_cores at half the chunk depth differs")
    log(f"deep chain: detect_cores again at {again['detect_cores_chunk_frames']}-frame chunks "
        f"({again['detect_cores_chunks']} chunks, {time.perf_counter() - t0:.3f} s) gives the "
        f"same {stats['detect_cores_n']} cores")
    bt = fields[0].cpu().numpy()
    del flow, fields, cores_half
    return cores, markers, bt, times


# -- cross-file linking -------------------------------------------------------

LINKING_RECORD = "linking_windows.npz"  # in tests/data: tests/test_torch_linking.py writes it
# tests/test_linking.py's long-lived storm, (frames, height, width), and its
# windows: (first frame, frames, owned frames [s, e)); the last after a gap
LINK_SCENE = (56, 96, 128)
LINK_LAYOUT = ((0, 21, 6, 15), (9, 21, 15, 24), (18, 21, 24, 33), (41, 15, 44, 53))
# (window, frame, rows, columns) of the recorded BT's NaN patch
LINK_NAN_PATCH = (1, 10, (44, 52), (58, 70))
LINK_CHUNK_FRAMES = 4  # a forced budget's chunks (device.frames_budget)
# passes that read no volume a chunk at a time: the store's reads and
# writes, the edge flags (a volume's edge rows and pad frames) and
# whole-volume maxima (reductions where the volume lies)
LINK_UNCHUNKED = ("open", "save", "edge_flags", "running_max")
LINK_PAD = 12  # the GOES CLI's pad frames each side of a window
LINK_ATOL, LINK_RTOL = 5, 0.5


def linking_window_name(own_start, own_end):
    """A GOES-style detection file name, its _S/_E tokens the window's
    owned frames on a 5-minute clock from 2020-06-01."""
    from datetime import datetime, timedelta

    def tok(frame):
        dt = datetime(2020, 6, 1) + timedelta(seconds=300 * int(frame))
        return f"{dt.year}{dt.timetuple().tm_yday:03d}{dt:%H%M%S}"

    return f"detected_dccs_SYN_S{tok(own_start)}_E{tok(own_end)}.nc"


def linking_record(path):
    """The recorded linking windows (numpy only): ``names``, ``windows``
    (port Datasets: the three label volumes, ``core_anvil_index``, the
    ``core`` and ``anvil`` coordinates and the BT, NaN where recorded),
    and the JAX linkers' outputs on them, ``file``, ``label`` and
    ``batch``: per window {variable or coordinate: values}, the BT and the
    y and x coordinates left out."""
    z = np.load(path, allow_pickle=False)
    t, h, w = (int(v) for v in z["scene"])
    times = chain_times(t)
    names, windows = [], []
    for i, (t0, nt, s, e) in enumerate(z["layout"]):
        ds = Dataset(coords={"t": times[t0:t0 + nt], "y": np.arange(h) * 2000.0,
                             "x": np.arange(w) * 2000.0})
        for name in ("core_label", "thick_anvil_label", "thin_anvil_label"):
            ds[name] = DataArray(z[f"w{i}_{name}"], dims=("t", "y", "x"))
        ds.coords["core"] = z[f"w{i}_c_core"]
        ds.coords["anvil"] = z[f"w{i}_c_anvil"]
        ds["core_anvil_index"] = DataArray(z[f"w{i}_core_anvil_index"], dims=("core",))
        tenths = z[f"w{i}_bt_tenths"]
        bt = np.where(tenths == np.iinfo(np.int16).min, np.nan, tenths / 10.0)
        ds["bt"] = DataArray(bt.astype(np.float32), dims=("t", "y", "x"))
        names.append(linking_window_name(s, e))
        windows.append(ds)
    out = {"names": names, "windows": windows}
    for key in ("file", "label", "batch"):
        out[key] = [{k.split("_", 1)[1].removeprefix("c_"): z[k] for k in z.files
                     if k.startswith(f"{key}{i}_")} for i in range(len(names))]
    return out


def _held_to(want, got, what):
    """The dataset ``got`` holds every recorded variable and coordinate of
    ``want`` ({name: values}), with equal dtypes and values."""
    for name, values in want.items():
        have = got[name].values if name in got.data_vars else got.coords[name]
        if have.dtype != values.dtype or not np.array_equal(have, values):
            raise AssertionError(f"{what}: {name} differs from the JAX record")
    extra = set(got.data_vars) - set(want) - {"bt"}
    if extra:
        raise AssertionError(f"{what}: variables {sorted(extra)} not in the JAX record")


def link_all(names, store, device, budget, atol=None, rtol=None):
    """FileLinker, LabelLinker and the batch path (overlaps,
    ``process_linking_output``, ``relabel_file``) over the datasets of
    ``names`` in ``store``, on ``device`` under ``budget``: {linker:
    (outputs, pass log)}.  LabelLinker at its own defaults unless ``atol``
    and ``rtol`` are given."""
    out = {}
    fl = file_linker.FileLinker(names, device=device, budget_bytes=budget, store=store)
    paths = fl.process_files()
    if fl.max_open_datasets > 2:
        raise AssertionError(f"FileLinker held {fl.max_open_datasets} datasets")
    out["file"] = ([store.saved[str(p)] for p in paths], fl.passes)
    kw = {} if atol is None else {"atol": atol, "rtol": rtol}
    ll = file_linker.LabelLinker(names, device=device, budget_bytes=budget, store=store, **kw)
    ll.link_all()
    paths = ll.output_files()
    if ll.max_open_datasets > 2:
        raise AssertionError(f"LabelLinker held {ll.max_open_datasets} datasets")
    out["label"] = ([store.saved[str(p)] for p in paths], ll.passes)
    batch, t0 = [], time.perf_counter()
    results = [linking.find_overlap_between_files(a, b, device=device, budget_bytes=budget,
                                                  store=store)
               for a, b in zip(names[:-1], names[1:])]
    links = linking.process_linking_output(results)
    for name in names:
        batch.append(linking.relabel_file(name, links, device=device, budget_bytes=budget,
                                          store=store).load())
    torch.cuda.synchronize()
    linked = sum(int(r[k][2].size) for r in results for k in ("core", "anvil"))
    out["batch"] = (batch, [{"pass": "batch", "seconds": time.perf_counter() - t0,
                             "chunks": 1, "linked": linked}])
    return out


def most_chunks(passes):
    """{pass: the most chunks it ran in} over a linker's pass log, less the
    passes that read no volume a chunk at a time (``LINK_UNCHUNKED``)."""
    most = {}
    for p in passes:
        if p["pass"] not in LINK_UNCHUNKED:
            most[p["pass"]] = max(most.get(p["pass"], 0), p["chunks"])
    return most


def check_linking_small(device, card_line):
    """Phase (a): both linkers and the batch path on the card over the
    recorded windows, from memory (``MemoryStore``): every output window
    identical to the JAX package's recorded output (labels, coordinates,
    flags, step labels and indices), whole and under a budget that runs
    every pass over a volume in at least 3 chunks."""
    rec = linking_record(Path(__file__).resolve().parent / "tests" / "data" / LINKING_RECORD)
    t0 = time.perf_counter()
    reset_counts()
    for what, budget in (("whole", None),
                         ("chunked", port_device.frames_budget(LINK_CHUNK_FRAMES))):
        store = MemoryStore(dict(zip(rec["names"], rec["windows"])))
        outs = link_all(rec["names"], store, device, budget)
        for key, (datasets, _) in outs.items():
            for i, ds in enumerate(datasets):
                _held_to(rec[key][i], ds, f"linking {what}, {key} window {i}")
        chunks = {k: most_chunks(outs[k][1]) for k in ("file", "label")}
        if what == "chunked" and min(min(c.values()) for c in chunks.values()) < 3:
            raise AssertionError(f"linking: a pass ran in fewer than 3 chunks: {chunks}")
        log(f"linking (a) {what} on the card [{card_line}]: FileLinker, LabelLinker and the "
            f"batch path over the {len(rec['names'])} recorded windows "
            f"{tuple(rec['windows'][0]['core_label'].shape[1:])} give the JAX record's outputs"
            + (f"; most chunks per pass {chunks}" if what == "chunked" else ""))
    launches, _ = read_counts()
    if launches:
        raise AssertionError(f"linking launched the ws_sweeps kernel {launches} times")
    log(f"linking (a): {time.perf_counter() - t0:.1f} s, 0 kernel launches")


def deep_thin(thick, device, radius=2):
    """A thin-anvil family over the thick labels ``thick`` (T, H, W) on
    the card without the floods: each frame's labels grown by a (2r+1)^2
    max filter into their unlabelled neighbours, so thin ⊇ thick under
    the same numbers."""
    out = torch.empty_like(thick)
    for s, e, _, _ in port_device.time_chunks(thick.shape[0], 8):
        lab = thick[s:e].to(device)
        grown = torch.nn.functional.max_pool2d(lab[:, None].float(), 2 * radius + 1, 1,
                                               radius)[:, 0].to(lab.dtype)
        out[s:e] = torch.where(lab > 0, lab, grown)
    return out


def _numbered(vol, uniq_from=None):
    """``vol`` with its labels (those of ``uniq_from``, by default its
    own) renumbered 1..n in increasing order, as a window's own detection
    numbers them."""
    found = unique_labels(vol if uniq_from is None else uniq_from)
    lut = torch.zeros(int(found.max()) + 1 if found.size else 1, dtype=vol.dtype,
                      device=vol.device)
    lut[torch.as_tensor(found.astype(np.int64), device=vol.device)] = torch.arange(
        1, found.size + 1, dtype=vol.dtype, device=vol.device)
    return lut[vol.long()]


def _pairs(a, b):
    """The (a, b) label pairs over the pixels where both are nonzero, on
    the card; raises where their supports differ."""
    if not torch.equal(a != 0, b != 0):
        raise AssertionError("linking: the linked labels' pixels differ from the deep volume's")
    m = a != 0
    width = int(b.max()) + 1
    keys = torch.unique(a[m].long() * width + b[m].long()).cpu().numpy()
    return np.stack([keys // width, keys % width], axis=1)


def run_deep_linking(deep, device, card_line):
    """Phase (b): three windows in the GOES CLI's layout cut from the deep
    chain's volumes (``run_deep_chain``: each window owns a third of the
    frames within LINK_PAD pad frames each side, so neighbours share
    2 x LINK_PAD frames; its labels numbered from 1 as its own detection
    would; a thin family grown from the thick one; the deep BT, one NaN
    frame in the middle window), linked on the card under its own budget
    by FileLinker, LabelLinker (atol 5, rtol 0.5) and the batch path.
    Logs each linker's passes (seconds, peak over its start against the
    budget at its start, chunks, objects linked).  Checks: over the owned
    frames each linker's labels and the deep volume's are in bijection
    for cores and both anvil families, but for objects with fewer than
    atol pixels in a shared interior (which may split; counted); the
    three linkers give the same partition; every peak within its budget;
    the step labels rise across the windows.  Returns the kernel's
    launches by shape, and the windows' names, their datasets and the
    batch path's relabelled windows (for the statistics phase)."""
    cores, markers, bt, times = deep
    t, h, w = cores.shape
    own = (t - 2 * LINK_PAD) // 3
    t0 = time.perf_counter()
    thin = deep_thin(markers, device)
    names, store, bounds = [], {}, []
    for k in range(3):
        lo, hi = k * own, k * own + own + 2 * LINK_PAD
        ds = Dataset(coords={"t": times[lo:hi], "y": np.arange(h) * 2000.0,
                             "x": np.arange(w) * 2000.0})
        ds["core_label"] = DataArray(_numbered(cores[lo:hi].to(device)), dims=("t", "y", "x"))
        ds["thick_anvil_label"] = DataArray(_numbered(markers[lo:hi].to(device),
                                                      thin[lo:hi]), dims=("t", "y", "x"))
        ds["thin_anvil_label"] = DataArray(_numbered(thin[lo:hi]), dims=("t", "y", "x"))
        window_bt = bt[lo:hi]
        if k == 1:  # a NaN frame of the middle window's own (where own > 2 pads, its alone)
            window_bt = window_bt.copy()
            window_bt[(2 * LINK_PAD + own) // 2] = np.nan
        ds["bt"] = DataArray(window_bt, dims=("t", "y", "x"))
        names.append(linking_window_name(lo + LINK_PAD, lo + LINK_PAD + own))
        store[names[-1]] = ds
        bounds.append((lo, hi))
    torch.cuda.synchronize()
    log(f"linking (b): 3 windows of {(own + 2 * LINK_PAD, h, w)} (owned {own} frames, "
        f"{2 * LINK_PAD} shared with each neighbour) cut from the deep {tuple(cores.shape)} on "
        f"the card in {time.perf_counter() - t0:.1f} s: cores from detect_cores, thick from "
        f"get_anvil_markers, thin = thick grown by a 5x5 max filter per frame where unlabelled, "
        f"each window numbered from 1; BT the deep scene's, a NaN frame in window 1")
    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    outs = link_all(names, MemoryStore(store), device, None, LINK_ATOL, LINK_RTOL)
    launches, by_shape = read_counts()
    if launches:
        raise AssertionError(f"linking launched the ws_sweeps kernel {launches} times")

    over = []
    for key, (_, passes) in outs.items():
        rows = {}
        for p in passes:
            row = rows.setdefault(p["pass"], {"n": 0, "s": 0.0, "over": 0, "budget": 0,
                                              "chunks": 0, "linked": 0})
            row["n"] += 1
            row["s"] += p["seconds"]
            row["chunks"] = max(row["chunks"], p["chunks"])
            row["linked"] += p.get("linked", 0)
            if "peak_bytes" in p:
                grew = p["peak_bytes"] - p["start_bytes"]
                if grew > p["budget_bytes"]:
                    over.append((key, p["pass"], p["file"], grew, p["budget_bytes"]))
                if grew >= row["over"]:
                    row["over"], row["budget"] = grew, p["budget_bytes"]
        log(f"linking (b) {key} [{card_line}]: total {sum(r['s'] for r in rows.values()):.3f} s; "
            + "; ".join(f"{name} x{r['n']} {r['s']:.3f} s" + (
                f", peak {r['over'] / 2**30:.3f} GiB over its start (budget "
                f"{r['budget'] / 2**30:.1f})" if r["budget"] else "")
                + f", chunks {r['chunks']}" + (f", linked {r['linked']}" if r["linked"] else "")
                for name, r in rows.items()))
    if over:
        raise AssertionError(f"linking: peaks over budget {over}")

    # bijection with the deep volume over the owned frames
    deep_vols = {"core_label": cores, "thick_anvil_label": markers, "thin_anvil_label": thin}
    split_ok = {}
    for var, link_var in (("core_label", cores), ("thick_anvil_label", markers)):
        allowed = set()
        for k in range(2):
            lo, hi = bounds[k + 1][0] + 1, bounds[k][1] - 1  # the shared interior
            counts = torch.bincount(link_var[lo:hi].reshape(-1).long()).cpu().numpy()
            present = set(unique_labels(link_var[bounds[k][0]:bounds[k][1]]).tolist()) & set(
                unique_labels(link_var[bounds[k + 1][0]:bounds[k + 1][1]]).tolist())
            allowed |= {v for v in present if v >= counts.size or counts[v] < LINK_ATOL}
        split_ok[var] = allowed
    split_ok["thin_anvil_label"] = split_ok["thick_anvil_label"]
    partitions, splits = {}, {}
    for key, (datasets, _) in outs.items():
        for var, deep_vol in deep_vols.items():
            pairs = []
            for k, ds in enumerate(datasets):
                if key == "batch":
                    s, e = get_dates_from_filename(names[k])
                    ds = trim_file_start_and_end(ds, s, e)
                lo = bounds[k][0] + LINK_PAD
                lab = torch.as_tensor(ds[var].values).to(device)
                pairs.append(_pairs(lab, deep_vol[lo:lo + lab.shape[0]].to(device)))
            pairs = np.unique(np.concatenate(pairs), axis=0)
            linked, deep_ids = pairs[:, 0], pairs[:, 1]
            if np.unique(linked).size != linked.size:
                raise AssertionError(f"linking {key}: {var} merged deep objects")
            ids, n = np.unique(deep_ids, return_counts=True)
            split = set(ids[n > 1].tolist())
            if split - split_ok[var]:
                raise AssertionError(f"linking {key}: {var} split deep objects "
                                     f"{sorted(split - split_ok[var])[:5]} that overlap in an "
                                     f"interior by at least {LINK_ATOL} pixels")
            splits[(key, var)] = len(split)
            partitions[(key, var)] = dict(zip(linked.tolist(), deep_ids.tolist()))
    for var in deep_vols:
        a, b, c = (partitions[(k, var)] for k in ("file", "label", "batch"))
        if not (_same_partition(a, b) and _same_partition(a, c)):
            raise AssertionError(f"linking: the linkers' {var} partitions differ")
    steps = [(int(ds["core_step_label"].values.max()),
              int(ds["core_step_label"].values[ds["core_step_label"].values > 0].min()))
             for ds in outs["file"][0]]
    if any(steps[k][0] >= steps[k + 1][1] for k in range(len(steps) - 1)):
        raise AssertionError(f"linking: step labels do not rise across the windows {steps}")
    nan_flagged = {key: int(sum(ds[f"{v}_nan_flag"].values.sum()
                               for v in ("core", "thick_anvil", "thin_anvil")))
                   for key, (datasets, _) in outs.items() if key != "batch"
                   for ds in datasets[1:2]}
    if min(nan_flagged.values()) == 0:
        raise AssertionError(f"linking: the NaN frame flagged nothing {nan_flagged}")
    log(f"linking (b) checks: each linker's labels in bijection with the deep volume's over "
        f"the owned frames (objects per linker and family: "
        + ", ".join(f"{k[0]} {k[1].split('_')[0]} {len(p)}" for k, p in partitions.items())
        + f"); split objects (fewer than {LINK_ATOL} px in a shared interior): "
        + ", ".join(f"{k[0]} {k[1].split('_')[0]} {n}" for k, n in splits.items())
        + f" (allowed {[len(v) for v in split_ok.values()]}); the three linkers' partitions "
        f"equal; every pass within its budget; core step labels rise across the windows "
        f"(max, min per window {steps}); NaN-flagged objects in window 1 {nan_flagged}; 0 kernel "
        f"launches; phase {time.perf_counter() - t0:.1f} s")
    return by_shape, (names, store, outs["batch"][0])


def _same_partition(a, b):
    """Do two {linked label: deep label} maps partition the deep objects
    alike (a bijection between their labels)?"""
    inv_a, inv_b = {}, {}
    for k, v in a.items():
        inv_a.setdefault(v, set()).add(k)
    for k, v in b.items():
        inv_b.setdefault(v, set()).add(k)
    return sorted(len(s) for s in inv_a.values()) == sorted(len(s) for s in inv_b.values()) \
        and inv_a.keys() == inv_b.keys()


def check_linking_clis():
    """Phase (c): where h5py cannot be imported (the card's machine has
    none), each of the four linking CLIs, the four statistics CLIs and
    the six validation and SEVIRI CLIs raises naming it before it reads a
    file or runs a pass."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        pass
    else:
        log("h5py imports here: the linking and statistics CLIs' early check passes")
        return
    from tobac_flow_tpu_torch.cli import (
        combine_dccs, dcc_detect_seviri, fix_seviri_dccs, grid_glm, link_dcc_files,
        linking_parallel, quick_fix, relabel_linked_files, seviri_cre_time_series,
    )

    out = ws_sweeps._BUILD_DIR / "link_cli"
    files = [str(out / linking_window_name(0, 37)), str(out / linking_window_name(37, 74))]
    sd = ["-sd", str(out)]
    for cli_mod, argv in ((link_dcc_files, sd + files), (combine_dccs, sd + files),
                          (linking_parallel, sd + files),
                          (relabel_linked_files, sd + ["-links", str(out / "links.nc")] + files),
                          (relabel_postprocess, files[:1] + [str(out / "links.nc")] + sd),
                          (postprocess_dcc, files[:1] + ["-fields", files[1]] + sd),
                          (quick_fix, files[:1] + ["-src", files[1], "-vars", "ctt"] + sd),
                          (dcc_statistics, sd + files),
                          (dcc_validation, files[:1] + ["-glm", files[1]] + sd),
                          (grid_glm, files[:1] + ["-glm", str(out)] + sd),
                          (dcc_detect_seviri_nat, sd + [str(out / "a.nat")]),
                          (dcc_detect_seviri, files + sd),
                          (fix_seviri_dccs, sd + files),
                          (seviri_cre_time_series, files + sd)):
        t0 = time.perf_counter()
        try:
            cli_mod.main(argv)
        except ImportError as err:
            seconds = time.perf_counter() - t0
            if "h5py" not in str(err) or seconds > 5 or out.exists():
                raise AssertionError(f"{cli_mod.__name__} raised after {seconds:.1f} s: {err}")
            log(f"no h5py here: {cli_mod.__name__.rsplit('.', 1)[1]} raised in {seconds:.3f} s, "
                f"before any read or pass")
            continue
        raise AssertionError(f"{cli_mod.__name__} ran without h5py")


# -- statistics and post-processing ---------------------------------------------

STATS_VARS = ("ctt", "cth", "toa_net_cre")  # postprocess_dcc's -vars
STATS_FLAGS = ("flag",)  # postprocess_dcc's -flags
STATS_CHECK_FRAMES = 9  # the window cut that the card and the CPU both run
STATS_CHUNK_FRAMES = 4  # a forced budget's chunks (device.frames_budget)
# the passes this phase adds, each of which a forced budget must chunk
STATS_PASSES = ("weighted_label_stats", "weighted_proportions", "label_stats_rows",
                "label_stats_frames")
FLUXES = ("toa_swup", "toa_lwup", "boa_swdn", "boa_swup", "boa_lwdn", "boa_lwup")


STATS_STEP = ABI_STEP / 8  # the statistics' grid spacing: 7 µrad, about 250 m at nadir


def disk_geometry(h, w, step=STATS_STEP):
    """The float32 lat, lon and pixel area (km²) of (h, w) pixels of
    GOES-16's fixed grid at ``step`` radians about the sub-satellite
    point, as ``goes_geometry`` gives them: all on the Earth's disk (an
    object off the disk has no area, over which the reference's average
    positions divide by zero).  At ``STATS_STEP`` (an eighth of the 2 km
    bands' spacing) the deep scene's cells, 46-72 px wide Gaussians at
    1500x2500, are cores a few thousand km² large, as deep convective
    cores are; at 2 km every one would exceed ``filter_cores``' 1e4
    km² cap."""
    x = (np.arange(w) - (w - 1) / 2) * step
    y = ((h - 1) / 2 - np.arange(h)) * step
    return goes_geometry({"y": y, "x": x}, GOES16_PROJECTION)


def aux_fields(shape, seed, device):
    """The auxiliary fields of ``postprocess_dcc``, made from ``seed`` on
    ``device``: CTT and CTH with uncertainties (a NaN patch in CTT), a flag
    field with ``flag_values``, and the six fluxes with their clear-sky
    counterparts and the TOA downwelling flux."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    t, h, w = shape
    ds = Dataset()
    values = {"ctt": uniform(190, 260), "ctt_uncertainty": uniform(0.5, 3),
              "cth": uniform(8000, 16000), "cth_uncertainty": uniform(100, 900)}
    values["ctt"][t // 2, h // 3:h // 2, w // 3:w // 2] = float("nan")
    for var in FLUXES:
        values[var], values[f"{var}_clr"] = uniform(50, 900), uniform(50, 900)
    values["toa_swdn"] = uniform(800, 1300)
    for name, v in values.items():
        ds[name] = DataArray(v, dims=("t", "y", "x"), name=name,
                             attrs={"long_name": name, "units": "W m-2", "valid_max": 1500.0})
    ds["flag"] = DataArray(torch.randint(0, 4, shape, generator=gen, device=device,
                                         dtype=torch.int8), dims=("t", "y", "x"), name="flag",
                           attrs={"flag_values": "0b 1b 2b 3b", "long_name": "flag"})
    return ds


ANVIL_GROWTH = 24  # widen_anvils grows thick anvils by a frame's height / this, in pixels


def grow_labels(labels, radius, device):
    """Each frame's labels grown into their unlabelled neighbours within a
    (2 radius + 1)^2 square by a separable max filter, on ``device``, 8
    frames at a time."""
    out = torch.empty_like(labels, device=device)
    k = 2 * radius + 1
    for s, e, _, _ in port_device.time_chunks(labels.shape[0], 8):
        lab = labels[s:e].to(device)
        grown = torch.nn.functional.max_pool2d(lab[:, None].float(), (1, k), 1, (0, radius))
        grown = torch.nn.functional.max_pool2d(grown, (k, 1), 1, (radius, 0))[:, 0]
        out[s:e] = torch.where(lab > 0, lab, grown.to(lab.dtype))
    return out


def widen_anvils(ds, device):
    """The window's anvils as a detection's outgrow their cores: the thick
    ones (the deep chain's anvil markers, which lie within the cores'
    extent) grown by a frame's height / ``ANVIL_GROWTH`` pixels, the thin
    ones twice that (``grow_labels``); returns the dataset."""
    radius = max(1, round(ds["thick_anvil_label"].shape[1] / ANVIL_GROWTH))
    thick = grow_labels(as_tensor(ds["thick_anvil_label"]), radius, device)
    ds["thin_anvil_label"].data = grow_labels(thick, 2 * radius, device)
    ds["thick_anvil_label"].data = thick
    return ds


def detection_window(ds, name, geometry, device, budget=None):
    """A window's detection dataset as the GOES CLI writes it, on
    ``device``: its label volumes and BT through the output stages' schema
    (label coordinates, core-anvil links, step labels, edge, start, end and
    NaN flags over the window's owned period), with the grid's lat, lon
    and pixel areas (``disk_geometry``)."""
    for var in ("core_label", "thick_anvil_label", "thin_anvil_label"):
        ds[var].data = as_tensor(ds[var], device)
    for var in ("lat", "lon", "area"):
        ds[var] = DataArray(as_tensor(geometry[var], device), dims=("y", "x"))
    start, end = get_dates_from_filename(name)
    ds = schema.add_label_coords(ds, budget)
    schema.link_cores_and_anvils(ds, budget_bytes=budget)
    schema.add_step_labels(ds, budget)
    ds = schema.add_label_coords(ds, budget)
    schema.link_step_labels(ds, budget)
    schema.flag_edge_labels(ds, start, end)
    schema.flag_nan_adjacent_labels(ds, ds["bt"], budget)
    return ds


def statistics_chain(windows, links, fields, device, budget=None, log_steps=None):
    """relabel_postprocess (with the spatial properties), postprocess_dcc
    (``STATS_VARS`` with the CRE fields, ``STATS_FLAGS``) and
    dcc_statistics from memory on ``device``: ``windows`` {name:
    detection dataset}, ``fields(name)`` the auxiliary field dataset of a
    window (made when its turn comes, dropped after).  With
    ``log_steps`` (a list), each step appends (what, seconds, bytes over
    its start at its peak, the budget at its start, stage stats).  Returns
    ({name: post-processed dataset}, the statistics dataset)."""
    cuda = device.type == "cuda"

    def step(what, fn):
        room = start = 0
        if cuda:
            torch.cuda.synchronize()
            room = port_device.memory_budget(device)
            start = torch.cuda.memory_allocated(device)
            port_device.reset_peak_memory(device)
        stats, t0 = {}, time.perf_counter()
        out = fn(stats)
        if cuda:
            torch.cuda.synchronize()
        if log_steps is not None:
            peak = port_device.peak_memory(device) if cuda else 0
            log_steps.append((what, time.perf_counter() - t0, peak - start, room, stats))
        return out

    done = {}
    for name, ds in windows.items():
        ds = step(f"relabel_postprocess {name}", lambda st: relabel_postprocess.relabel_postprocess(
            ds, links, name, True, device, budget, st))
        aux = fields(name)
        ds = step(f"postprocess_dcc {name}", lambda st: postprocess_dcc.postprocess_dataset(
            ds, aux, STATS_VARS, True, STATS_FLAGS, device, budget, st))
        del aux
        done[name] = ds.load()  # its volumes wait on the host
    first = next(iter(done.values()))
    keep = dcc_statistics.statistics_variables(first)
    table = step("dcc_statistics", lambda st: dcc_statistics.dcc_statistics(
        [dcc_statistics.subset(ds, keep) for ds in done.values()], device, st))
    return done, table


def _cut(ds, frames):
    """The first ``frames`` frames of a window's label volumes and BT."""
    out = Dataset(coords={"t": ds.coords["t"][:frames], "y": ds.coords["y"],
                          "x": ds.coords["x"]})
    for var in ("core_label", "thick_anvil_label", "thin_anvil_label", "bt"):
        out[var] = DataArray(as_tensor(ds[var])[:frames].clone(), dims=("t", "y", "x"))
    return out


def _fields_on(fields, device):
    out = Dataset()
    for name, var in fields.data_vars.items():
        out[name] = DataArray(as_tensor(var, device), dims=var.dims, name=name,
                              attrs=dict(var.attrs))
    return out


def _held_equal(want, got, what, rtol32=1e-5):
    """``got`` (datasets by name, and a table) equal to ``want`` by
    ``compare_datasets``: float64 to rtol 1e-12, float32 means and stds to
    ``rtol32``, the rest identical."""
    for key in want:
        try:
            compare_datasets(want[key].load(), got[key].load(), rtol32=rtol32)
        except AssertionError as err:
            raise AssertionError(f"statistics: {what}, {key}: {err}") from None


def identity_links(windows):
    """A links dataset in ``process_linking_output``'s layout that maps
    each window's labels (``windows``: {name: dataset}) to themselves, for
    windows whose labels are already linked."""
    def top(ds, names):
        return max(int(as_tensor(ds[n]).max()) for n in names)

    counts = {"core": [top(ds, ("core_label",)) for ds in windows.values()],
              "anvil": [top(ds, ("thick_anvil_label", "thin_anvil_label"))
                        for ds in windows.values()]}
    links = Dataset(coords={"filename": np.asarray(list(windows), dtype=object)})
    for key, n in counts.items():
        links[f"{key}_start"] = DataArray(np.cumsum([0] + n[:-1]).astype(np.int64),
                                          dims=("filename",))
        links[f"{key}_labels"] = DataArray(np.concatenate(
            [np.arange(1, k + 1) for k in n]).astype(np.int32), dims=(key,))
    return links


def run_statistics(linked, device, card_line):
    """The statistics phase, over the linking phase's three windows as the
    batch path relabelled them (linked labels, every frame of a window,
    the BT), their anvils widened (``widen_anvils``), each through the
    detection schema (``detection_window``; its
    step labels 1..n, as the reference's per-step statistics need them):
    on the card under its own budget, per window
    ``relabel_postprocess`` (relabelled through links that keep the linked
    labels, label properties, spatial properties, per-step BT
    statistics) and ``postprocess_dcc`` (CTT and CTH with uncertainties,
    the flag proportions and the TOA net CRE from the fluxes, over the
    (H, W) pixel areas of ``disk_geometry``), then ``dcc_statistics`` over
    the three.  Logs each step's seconds, peak over its start against the
    budget at its start, chunks, and the objects before and after the
    filters.  Checks: on the middle window's first ``STATS_CHECK_FRAMES``
    frames, the card's datasets equal the CPU's and, under a budget that
    runs each of ``STATS_PASSES`` in at least 3 chunks, the whole run's;
    every peak within its budget; 0 kernel launches; at least one core and
    one anvil survive the filters, and one of each is valid.  Returns the
    kernel's launches by shape, the windows through the detection schema
    (for validation) and a function that starts the cut's run on the CPU
    in a thread and gives the one that finishes the cut's checks."""
    names, store, relabelled = linked
    t0 = time.perf_counter()
    h, w = store[names[0]]["core_label"].shape[1:]
    geometry = disk_geometry(h, w)
    for ds in relabelled:
        widen_anvils(ds, device)
    cut_name = names[1]
    cut = detection_window(widen_anvils(_cut(store[cut_name], STATS_CHECK_FRAMES), device),
                           cut_name, geometry, device)
    store.clear()  # the linking phase's windows leave the card
    # each window's volumes wait on the host until its turn
    windows = {name: detection_window(ds, name, geometry, device).load()
               for name, ds in zip(names, relabelled)}
    links = identity_links(windows)
    cut_links = identity_links({cut_name: cut})
    cut_copy = MemoryStore({cut_name: cut})
    torch.cuda.synchronize()
    shape = tuple(relabelled[0]["core_label"].shape)
    log(f"statistics: the batch path's 3 relabelled windows {shape} "
        f"and the middle window's first {STATS_CHECK_FRAMES} frames through the detection schema "
        f"on the card, with the grid's pixel areas, in {time.perf_counter() - t0:.1f} s")

    cut_fields = aux_fields(tuple(cut["core_label"].shape), 20, device)

    def cut_on(dev):
        """The cut and its fields as ``statistics_chain`` takes them, every
        tensor on ``dev``."""
        ds = cut_copy.open(cut_name)
        for var in ds.data_vars.values():
            if isinstance(var.data, torch.Tensor):
                var.data = var.data.to(dev)
        for var in ("bt", "area", "lat", "lon"):
            ds[var] = DataArray(as_tensor(cut[var], dev), dims=cut[var].dims)
        return ds, _fields_on(cut_fields, dev)

    def run_cut(ds, fields_there, dev, budget=None):
        t3 = time.perf_counter()
        out, tab = statistics_chain({cut_name: ds}, cut_links, lambda _: fields_there, dev,
                                    budget)
        return {cut_name: out[cut_name], "statistics": tab}, time.perf_counter() - t3

    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()

    def fields(name):
        return aux_fields(tuple(windows[name]["core_label"].shape), 10 + names.index(name),
                          device)

    steps = []
    t1 = time.perf_counter()
    done, table = statistics_chain(windows, links, fields, device, None, steps)
    seconds = time.perf_counter() - t1
    launches, by_shape = read_counts()
    if launches:
        raise AssertionError(f"statistics launched the ws_sweeps kernel {launches} times")
    over = [(what, grew, room) for what, _, grew, room, _ in steps if grew > room]
    for what, sec, grew, room, stats in steps:
        chunks = {k[:-len("_chunks")]: v for k, v in stats.items() if k.endswith("_chunks")}
        log(f"statistics {what} [{card_line}]: {sec:.3f} s, peak {grew / 2**30:.3f} GiB over "
            f"its start (budget {room / 2**30:.1f} GiB); " + ", ".join(
                f"{k[:-2]} {v:.3f} s" for k, v in stats.items() if k.endswith("_s"))
            + f"; most chunks {chunks or 1}")
    if over:
        raise AssertionError(f"statistics: peaks over budget {over}")
    before = {k: sum(ds.coords[k].size for ds in done.values()) for k in ("core", "anvil")}
    after = {k: table.coords[k].size for k in ("core", "anvil")}
    valid = {"core": int(table["core_is_valid"].values.sum()),
             "anvil": int(table["thick_anvil_is_valid"].values.sum())}
    if min(after.values()) == 0 or min(valid.values()) == 0:
        raise AssertionError(f"statistics: objects after the filters {after}, valid {valid}")
    for name, ds in done.items():
        for var in ("core_ctt_mean", "thick_anvil_toa_net_cre_mean",
                    "core_step_flag_proportion"):
            if var not in ds.data_vars:
                raise AssertionError(f"statistics: {name} lacks {var}")
    log(f"statistics [{card_line}]: 3 windows of {tuple(windows[names[0]]['core_label'].shape)} "
        f"post-processed in {seconds:.3f} s ({seconds / 3:.3f} s a window, "
        + ", ".join(f"{sum(s for what, s, *_ in steps if what.startswith(cli)):.3f} s {cli}"
                    for cli in ("relabel_postprocess", "postprocess_dcc")) + ", "
        f"{steps[-1][1]:.3f} s dcc_statistics); objects "
        f"before the filters (summed over the windows) {before}, after {after}, valid {valid}; "
        f"0 kernel launches")
    del done, table
    gc.collect()
    torch.cuda.empty_cache()

    def start_check():
        """Starts the cut's run on the CPU in a thread (its inputs copied
        to the host here, so that the thread makes no CUDA call) and
        returns a function that checks the card against it, and forced
        chunks against whole, once it is done.  No other thread may run
        beside that function: ``device.chunk_plan`` records every
        thread's plans."""
        cpu_run = prefetched(run_cut, *cut_on(torch.device("cpu")), torch.device("cpu"))

        def finish():
            t2 = time.perf_counter()
            card = run_cut(*cut_on(device), device)
            (cpu, cpu_s), _, waited = cpu_run()
            plans = []
            port_device._PLANS.append(plans)
            try:
                chunked = run_cut(*cut_on(device), device,
                                  port_device.frames_budget(STATS_CHUNK_FRAMES))
            finally:
                port_device._PLANS[:] = [p for p in port_device._PLANS if p is not plans]
            fewest = {p: min((-(-t // c) for what, t, c in plans if what == p), default=0)
                      for p in STATS_PASSES}
            if min(fewest.values()) < 3:
                raise AssertionError(f"statistics: a new pass ran in fewer than 3 chunks "
                                     f"{fewest}")
            _held_equal(cpu, card[0], "card against CPU")
            _held_equal(card[0], chunked[0], "chunked against whole")
            log(f"statistics checks on window 1's first {STATS_CHECK_FRAMES} frames "
                f"{tuple(cut['core_label'].shape)} [{card_line}]: the card's datasets equal "
                f"the CPU's (float64 to rtol 1e-12, float32 means and stds to 1e-5, the rest "
                f"identical) and, with every new pass in at least 3 chunks (fewest {fewest}), "
                f"the whole run's; card {card[1]:.1f} s, CPU {cpu_s:.1f} s (in a thread "
                f"beside the new shapes' kernel timings; {waited:.1f} s waited for), chunked "
                f"{chunked[1]:.1f} s; {time.perf_counter() - t2:.1f} s for the checks")

        return finish

    return by_shape, windows, start_check


# -- validation against GLM lightning -------------------------------------------

VALIDATE_CHECK = (9, 375, 625)  # the cut that the card and the CPU both validate
VALIDATE_CHUNKED_FRAMES = 16  # the cut that forced chunks validate (4 chunks of 4)
SCIPY_FRAMES = 3  # frames a window's transform is held to scipy's on
# flashes a frame: at pixels drawn inside cores and inside thick anvils, and
# false flashes uniform over the grid
GLM_PER_FRAME = {"core": 20, "thick_anvil": 10, "false": 10}
# the bytes per pixel that validation keeps whole beside a chunk: the three
# int32 label volumes, the int32 flash grid, the edge filter and the two
# float64 distance grids
VALIDATE_RESIDENT_BYTES_PER_PX = 3 * 4 + 4 + 1 + 2 * 8


def same_bits(a, b):
    """Two numpy arrays equal bit for bit, with their dtypes and shapes."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def stats_grid(h, w, step=STATS_STEP):
    """The (y, x) scan angles of ``disk_geometry``'s grid."""
    return ((h - 1) / 2 - np.arange(h)) * step, (np.arange(w) - (w - 1) / 2) * step


def glm_flashes(ds, seed, device):
    """GLM flashes over a window (``ds``: its core and thick anvil labels
    and times) on ``disk_geometry``'s grid, made from ``seed``: per frame
    ``GLM_PER_FRAME`` flashes at pixels drawn (on ``device``) inside the
    cores and the thick anvils, and false ones uniform over the grid, each
    at a uniform point of its pixel and a uniform time inside the frame's
    bin; their lat and lon from the grid's scan angles.  Returns (times,
    lats, lons) as numpy."""
    t, h, w = ds["core_label"].shape
    gen = torch.Generator(device=device).manual_seed(seed)
    labels = {name: as_tensor(ds[f"{name}_label"], device) for name in ("core", "thick_anvil")}
    picks, frames = [], []
    for i in range(t):
        for name in ("core", "thick_anvil"):
            inside = torch.nonzero(labels[name][i].reshape(-1) > 0)[:, 0]
            if inside.numel():
                n = GLM_PER_FRAME[name]
                picks.append(inside[torch.randint(inside.numel(), (n,), generator=gen,
                                                  device=device)])
                frames += [i] * n
        picks.append(torch.randint(h * w, (GLM_PER_FRAME["false"],), generator=gen,
                                   device=device))
        frames += [i] * GLM_PER_FRAME["false"]
    flat = torch.cat(picks).cpu().numpy()
    frames = np.asarray(frames)
    rng = np.random.default_rng(seed)
    y, x = stats_grid(h, w)
    ys = y[flat // w] + rng.uniform(-0.5, 0.5, flat.size) * STATS_STEP
    xs = x[flat % w] + rng.uniform(-0.5, 0.5, flat.size) * STATS_STEP
    lat, lon = ABIProjection(**GOES16_PROJECTION).to_latlon(xs, ys)
    times = np.asarray(ds.coords["t"])[frames] + rng.uniform(-149, 149, flat.size).astype(
        "timedelta64[s]")
    return times, lat, lon


def glm_grid_ds(ds):
    """The fixed-grid dataset of a window (its times and ``stats_grid``'s
    scan angles) that ``regrid_glm`` grids onto."""
    t, h, w = ds["core_label"].shape
    y, x = stats_grid(h, w)
    grid = Dataset(coords={"t": np.asarray(ds.coords["t"]), "y": y, "x": x})
    grid["goes_imager_projection"] = DataArray(np.zeros((), np.int32), dims=(),
                                               attrs=dict(GOES16_PROJECTION))
    return grid


def host_counts(grid, times, lat, lon):
    """numpy's ``histogram2d`` of the flashes' parallax-corrected scan
    angles per time bin, rows flipped back (y decreases): the reference's
    counts, to hold the card's binning to."""
    proj = ABIProjection(**GOES16_PROJECTION)
    lat_c, lon_c = glm.get_glm_parallax_offsets(lat, lon, sat_lon=proj.lon0,
                                                sat_height=proj.h - proj.req)
    fx, fy = proj.to_xy(lat_c, lon_c)
    y, x = grid.coords["y"], grid.coords["x"]
    t_bins = glm._time_bins(np.asarray(grid.coords["t"]))
    tidx = np.searchsorted(t_bins, times, side="right") - 1
    out = np.zeros((len(t_bins) - 1, y.size, x.size), np.int32)
    for ti in np.unique(tidx[(tidx >= 0) & (tidx < len(t_bins) - 1)]):
        sel = tidx == ti
        counts, _, _ = np.histogram2d(fy[sel], fx[sel], bins=[glm._edges(y)[::-1],
                                                              glm._edges(x)])
        out[ti] = counts[::-1]
    return out


def validation_window(ds, device, frames=slice(None), rows=slice(None), cols=slice(None)):
    """A detection window's labels (cut to ``frames``, ``rows``, ``cols``)
    with its times, label coordinates and core-anvil index, the labels on
    ``device``: what the validation entry points read."""
    t = np.asarray(ds.coords["t"])[frames]
    out = Dataset(coords={"t": t, "core": ds.coords["core"], "anvil": ds.coords["anvil"]})
    for var in ("core_label", "thick_anvil_label", "thin_anvil_label"):
        out[var] = DataArray(as_tensor(ds[var])[frames, rows, cols].to(device).clone(),
                             dims=("t", "y", "x"))
    out["core_anvil_index"] = DataArray(np.asarray(ds["core_anvil_index"].values),
                                        dims=("core",))
    return out


def validate_all(ds, glm_grid, device, budget=None, both=False, step=None):
    """Cores, thick and thin anvils (and, with ``both``, cores within
    anvils and anvils with cores) validated on ``device``: ``step(what,
    fn)`` runs each (``fn(stats)``), by default untimed.  Returns the
    dataset and the marker and flash distance grids of the cores (on the
    host) where ``both``."""
    step = step or (lambda what, fn: fn(None))
    step("validate_cores", lambda st: validation.validate_cores(
        ds, glm_grid, device=device, budget_bytes=budget, stats=st))
    for thick in (True, False):
        step(f"validate_anvils {'thick' if thick else 'thin'}",
             lambda st: validation.validate_anvils(ds, glm_grid, thick=thick, device=device,
                                                   budget_bytes=budget, stats=st))
    grids = None
    if both:
        step("validate_cores_with_anvils", lambda st: validation.validate_cores_with_anvils(
            ds, glm_grid, device=device, budget_bytes=budget, stats=st))
        step("validate_anvils_with_cores", lambda st: validation.validate_anvils_with_cores(
            ds, glm_grid, device=device, budget_bytes=budget, stats=st))
        edge = validation.get_edge_filter(ds, device=device)
        out = validation.validate_markers(ds["core_label"], glm_grid, None, edge, device=device,
                                          budget_bytes=budget)
        grids = (out[0].cpu(), out[1].cpu())
    return ds, grids


def _validated_equal(want, got, what):
    """Two validation runs' datasets and grids identical: the datasets'
    attrs (NaN equal to NaN), their per-object distances bit for bit, the
    grids bit for bit."""
    (a, grids_a), (b, grids_b) = want, got
    same = {k: (x == b.attrs.get(k) or (x != x and b.attrs.get(k) != b.attrs.get(k)))
            for k, x in a.attrs.items()}
    if set(a.attrs) != set(b.attrs) or not all(same.values()):
        raise AssertionError(f"validation {what}: attrs differ {a.attrs} != {b.attrs}")
    for name in ("core_glm_distance", "thick_anvil_glm_distance", "thin_anvil_glm_distance"):
        if not same_bits(np.asarray(a[name].values), np.asarray(b[name].values)):
            raise AssertionError(f"validation {what}: {name} differs")
    for x, y in zip(grids_a or (), grids_b or ()):
        if not torch.equal(x.view(torch.int64), y.view(torch.int64)):
            raise AssertionError(f"validation {what}: a distance grid differs")


def run_validation(windows, device, card_line):
    """Validation against GLM lightning over the statistics phase's three
    windows (``windows``: {name: detection dataset}) on
    ``disk_geometry``'s grid, on the card under its own budget: seeded
    flashes (``glm_flashes``) gridded by ``regrid_glm`` with parallax
    correction, then ``validate_cores`` and ``validate_anvils`` (thick,
    thin) on every window, and ``validate_cores_with_anvils`` and
    ``validate_anvils_with_cores`` on the middle one.  Logs each step's
    seconds (the transforms, the per-object reductions, the binning), its
    peak over its start against the budget at its start, its chunks, the
    flashes, POD and FAR, and the depth validation reaches at the
    windows' frame.  Checks: (a) the card's counts equal numpy's
    ``histogram2d``; (b) the card's transform equals scipy's on
    ``SCIPY_FRAMES`` frames a window; (c) on the middle window's first
    frames cut to ``VALIDATE_CHECK`` the card's results (grids, POD, FAR,
    per-object distances) equal the CPU's; (d) on its first
    ``VALIDATE_CHUNKED_FRAMES`` frames, under a budget that runs the
    marker distance and the per-object passes in at least 3 chunks, the
    results equal the whole run's; (e) every peak within its budget; (f)
    POD in (0, 1], FAR in [0, 1]; (g) 0 kernel launches.  Returns the
    kernel's launches by shape and a function that starts (c)'s run on
    the CPU in a thread and gives the one that finishes (c)."""
    from scipy.ndimage import distance_transform_edt as scipy_edt

    t0 = time.perf_counter()
    names = list(windows)
    mid = windows[names[1]]
    t, h, w = mid["core_label"].shape
    steps = []
    cuda = device.type == "cuda"

    def step(what, fn):
        room = start = 0
        if cuda:
            torch.cuda.synchronize()
            room = port_device.memory_budget(device)
            start = torch.cuda.memory_allocated(device)
            port_device.reset_peak_memory(device)
        stats, t1 = {}, time.perf_counter()
        out = fn(stats)
        if cuda:
            torch.cuda.synchronize()
        peak = port_device.peak_memory(device) - start if cuda else 0
        steps.append((what, time.perf_counter() - t1, peak, room, stats))
        return out

    # the check's cut, around the middle window's cores in its first frames
    ct, ch, cw = VALIDATE_CHECK
    core = as_tensor(mid["core_label"])[:ct]
    where = torch.nonzero(core.to(device) > 0).float()
    cy, cx = (where[:, 1].mean().item(), where[:, 2].mean().item()) if where.numel() else (
        h / 2, w / 2)
    y0 = int(min(max(cy - ch / 2, 0), h - ch))
    x0 = int(min(max(cx - cw / 2, 0), w - cw))
    cut = validation_window(mid, torch.device("cpu"), slice(0, ct), slice(y0, y0 + ch),
                            slice(x0, x0 + cw))

    reset_counts()
    flashes, pods, scipy_s, frame_s = {}, {}, 0.0, []
    for k, name in enumerate(names):
        ds = windows[name]
        grid = glm_grid_ds(ds)
        ftimes, lat, lon = glm_flashes(ds, 30 + k, device)
        flashes[name] = lat.size
        glm_ds = step(f"regrid_glm {name}", lambda st: glm.gridded_flash_ds(
            grid, ftimes, lat, lon, device))
        counts = glm_ds["glm_flashes"].data
        if not np.array_equal(counts.cpu().numpy(), host_counts(grid, ftimes, lat, lon)):
            raise AssertionError(f"validation (a): {name}: the card's counts differ from "
                                 f"numpy's histogram2d")
        if k == 1:  # the flashes of check (c)'s cut
            glm_cut = counts[:ct, y0:y0 + ch, x0:x0 + cw].cpu().clone()
        vds = validation_window(ds, device)
        validate_all(vds, counts, device, both=k == 1, step=step)
        pods[name] = {key: vds.attrs[key] for key in sorted(vds.attrs)
                      if key.endswith(("_pod", "_far"))}
        bad = {key: v for key, v in pods[name].items()
               if not math.isfinite(v) or not (0 < v <= 1 if key.endswith("pod") else 0 <= v <= 1)}
        if bad:
            raise AssertionError(f"validation (f): {name}: {bad}")
        # (b) the card's transform of whole frames against scipy's
        labels = vds["core_label"].data
        held = torch.nonzero((labels != 0).flatten(1).any(1))[:, 0].tolist()
        for i in [held[0], held[len(held) // 2], held[-1]][:SCIPY_FRAMES]:
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            mine = distance_transform_edt(labels[i] == 0)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t2)
            t2 = time.perf_counter()
            want = scipy_edt(labels[i].cpu().numpy() == 0)
            scipy_s += time.perf_counter() - t2
            if not same_bits(mine.cpu().numpy(), want):
                raise AssertionError(f"validation (b): {name} frame {i}: the card's transform "
                                     f"differs from scipy's")
        del vds, glm_ds, counts, labels
        gc.collect()
        torch.cuda.empty_cache()
    launches, by_shape = read_counts()
    if launches:
        raise AssertionError(f"validation launched the ws_sweeps kernel {launches} times")
    seconds = sum(sec for _, sec, *_ in steps)
    over = [(what, grew, room) for what, _, grew, room, _ in steps if grew > room]
    for what, sec, grew, room, stats in steps:
        chunks = {k[:-len("_chunks")]: v for k, v in stats.items() if k.endswith("_chunks")}
        log(f"validation {what} [{card_line}]: {sec:.3f} s, peak {grew / 2**30:.3f} GiB over "
            f"its start (budget {room / 2**30:.1f} GiB); " + ", ".join(
                f"{k[:-2]} {v:.3f} s" for k, v in stats.items() if k.endswith("_s"))
            + f"; chunks {chunks or 1}")
    if over:
        raise AssertionError(f"validation (e): peaks over budget {over}")
    transforms = [st[f"{k}_s"] for what, _, _, _, st in steps for k in
                  ("marker_distance", "flash_distance") if f"{k}_s" in st]
    budget = port_device.memory_budget(device) or 0  # no budget on the CPU
    px = h * w
    depth = (budget - port_device.VALIDATE_BYTES_PER_PX * (4 + 6) * px) // (
        VALIDATE_RESIDENT_BYTES_PER_PX * px)
    log(f"validation [{card_line}]: 3 windows of {(t, h, w)}, flashes {flashes}, in "
        f"{seconds:.3f} s of steps; {len(transforms)} marker-distance volumes "
        f"{sum(transforms):.3f} s ({sum(transforms) / (len(transforms) * t) * 1e3:.2f} ms a frame "
        f"with the time-margin minimum); a whole-frame transform alone "
        f"{min(frame_s) * 1e3:.2f}-{max(frame_s) * 1e3:.2f} ms (scipy on the host "
        f"{scipy_s / len(frame_s) * 1e3:.1f} ms); POD and FAR {pods}; 0 kernel launches; "
        f"computed depth at {(h, w)} under the card's budget ({budget / 2**30:.1f} GiB: "
        f"{VALIDATE_RESIDENT_BYTES_PER_PX} B/px kept whole, a 4-frame chunk and its 6 halo "
        f"frames at {port_device.VALIDATE_BYTES_PER_PX} B/px) {depth} frames")

    # (d) forced chunks against whole
    t2 = time.perf_counter()
    deep = validation_window(mid, device, slice(0, VALIDATE_CHUNKED_FRAMES))
    grid = glm_grid_ds(deep)
    ftimes, lat, lon = glm_flashes(deep, 40, device)
    counts = glm.gridded_flash_ds(grid, ftimes, lat, lon, device)["glm_flashes"].data
    whole = validate_all(deep, counts, device)
    plans = []
    port_device._PLANS.append(plans)
    try:
        chunked = validate_all(validation_window(mid, device, slice(0, VALIDATE_CHUNKED_FRAMES)),
                               counts, device, port_device.frames_budget(4))
    finally:
        port_device._PLANS[:] = [p for p in port_device._PLANS if p is not plans]
    fewest = {p: min((-(-n // c) for what, n, c in plans if what == p), default=0)
              for p in ("marker_distance", "validate_objects")}
    if min(fewest.values()) < 3:
        raise AssertionError(f"validation (d): a pass ran in fewer than 3 chunks {fewest}")
    _validated_equal(whole, chunked, "(d) chunked against whole")
    log(f"validation checks [{card_line}]: (a) the card's flash counts equal numpy's "
        f"histogram2d in every window; (b) its transform equals scipy's on {SCIPY_FRAMES} "
        f"whole frames a window; (d) on window 1's first {VALIDATE_CHUNKED_FRAMES} frames in "
        f"forced chunks (fewest {fewest}) the whole run's; (e) every peak within its budget; "
        f"(f) POD in (0, 1], FAR in [0, 1]; (g) 0 kernel launches; checks "
        f"{time.perf_counter() - t2:.1f} s; phase {time.perf_counter() - t0:.1f} s")

    def start_check():
        """(c): starts the cut's run on the CPU in a thread and returns a
        function that holds the card's run of the cut to it."""
        card_cut = validation_window(cut, device)
        cpu_run = prefetched(validate_all, cut, glm_cut, torch.device("cpu"), None, True)

        def finish():
            t2 = time.perf_counter()
            card_run = validate_all(card_cut, glm_cut.to(device), device, both=True)
            cpu_out, cpu_s, waited = cpu_run()
            _validated_equal(cpu_out, card_run, "(c) card against CPU")
            log(f"validation check (c) [{card_line}]: on window 1's first {ct} frames cut to "
                f"{(ch, cw)} at ({y0}, {x0}) the card's grids, POD, FAR and per-object "
                f"distances equal the CPU's (CPU {cpu_s:.1f} s in a thread beside the new "
                f"shapes' kernel timings, {waited:.1f} s waited for); "
                f"{time.perf_counter() - t2:.1f} s")

        return finish

    return by_shape, start_check


# -- SEVIRI native ingest --------------------------------------------------------

SEVIRI_DISK = 3712  # the full disk's VISIR lines and columns
SEVIRI_SCANS = 9  # 15 minutes apart
SEVIRI_MISSING = 1  # the scan left out: a 30-minute gap, one NaN frame
SEVIRI_CYCLE = 12  # deep_scene's cycle: its cells grow over 3.85 scans (1.4 K/min)
# y0, y1, x0, x1: 640x640 about the disk's centre, where the detection finds
# several cores (3 on the H100; 1 at 448x448 and at 512x512) and the phase
# stays within about two minutes (its floods took 63-87 s)
SEVIRI_CROP = (1536, 2176, 1536, 2176)
SEVIRI_T0 = datetime(2020, 6, 1, 12, 0)
# each IR channel's background BT (K) over the disk, with 0.3 K of noise
SEVIRI_BACKGROUND = {"WV_062": 226.0, "WV_073": 240.0, "IR_087": 286.0, "IR_108": 290.0,
                     "IR_120": 288.0}
SEVIRI_WORKERS = 8  # threads that write the archives


def seviri_scan(path, i, storm, disk, crop, seed):
    """Write scan ``i`` as a full-disk native archive at ``path``: the
    background BTs with noise from (``seed``, ``i``), and inside ``crop``
    the storm fields ``storm`` (BT, WVD, SWD of the crop) as IR_108 = BT,
    WV_062 = WV_073 + WVD, IR_120 = BT - 2 and IR_087 = IR_120 + SWD."""
    bt, wvd, swd = storm
    rng = np.random.default_rng([seed, i])
    fields = {}
    for ch, base in SEVIRI_BACKGROUND.items():
        f = rng.standard_normal((disk, disk), dtype=np.float32)
        f *= np.float32(0.3)
        f += np.float32(base)
        fields[ch] = f
    y0, y1, x0, x1 = crop
    inside = (slice(y0, y1), slice(x0, x1))
    fields["IR_108"][inside] = bt
    fields["WV_062"][inside] = fields["WV_073"][inside] + wvd
    fields["IR_120"][inside] = bt - np.float32(2)
    fields["IR_087"][inside] = fields["IR_120"][inside] + swd
    write_nat(path, fields, SEVIRI_T0 + timedelta(minutes=15 * i))
    return str(path)


def seviri_archives(directory):
    """``deep_scene``'s storm cells over ``SEVIRI_CROP`` (growing over the 9
    scans) written with ``write_nat`` as full-disk archives with the five IR
    channels, 15 minutes apart, less scan ``SEVIRI_MISSING``, into
    ``directory`` (``SEVIRI_WORKERS`` threads).  Returns their paths and
    the seconds it took."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    y0, y1, x0, x1 = SEVIRI_CROP
    storm = deep_scene(SEVIRI_SCANS, y1 - y0, x1 - x0, seed=3, cycle=SEVIRI_CYCLE)
    scans = [i for i in range(SEVIRI_SCANS) if i != SEVIRI_MISSING]
    paths = [str(Path(directory) / f"MSG4-SEVI-MSG15-0100-NA-{i:02d}.nat") for i in scans]
    with ThreadPoolExecutor(SEVIRI_WORKERS) as pool:
        list(pool.map(seviri_scan, paths, scans, [[f[i] for f in storm] for i in scans],
                      [SEVIRI_DISK] * len(scans), [SEVIRI_CROP] * len(scans),
                      [3] * len(scans)))
    return paths, time.perf_counter() - t0


def run_seviri(device, card_line, archives):
    """The SEVIRI native ingest and detection: the archives of
    ``seviri_archives`` (``archives``: their paths, the seconds they took
    and the seconds waited for them, written beside the earlier checks),
    decoded at full width and cropped by
    ``seviri_nat_dataloader`` (8 threads) and timed per file, as
    ``dcc_detect_seviri_nat.detect_seviri_nat`` loads them; then its
    ``detect_fields`` on the card.  Checks: the decode equals a file's
    decode alone and reaches the card unchanged; the gap is one NaN frame;
    every stage finds objects.  Returns the kernel's launches, in all and
    by shape."""
    t0 = time.perf_counter()
    y0, y1, x0, x1 = SEVIRI_CROP
    paths, written, waited = archives
    size = sum(os.path.getsize(p) for p in paths)
    t1 = time.perf_counter()
    bt, wvd, twd = seviri_nat_dataloader(None, None, paths, x0=x0, x1=x1, y0=y0, y1=y1)
    decoded = time.perf_counter() - t1
    t1 = time.perf_counter()
    alone = decode_nat(paths[0])[0]
    one = time.perf_counter() - t1
    if not same_bits(bt.values[0], alone["IR_108"][y0:y1, x0:x1]):
        raise AssertionError("SEVIRI: the threaded decode differs from a file's decode alone")
    for da in (bt, wvd, twd):
        if not same_bits(as_tensor(da, device).cpu().numpy(), da.values):
            raise AssertionError(f"SEVIRI: {da.name} changed on its way to the card")
    gap = np.isnan(bt.values).all(axis=(1, 2))
    if bt.shape != (SEVIRI_SCANS, y1 - y0, x1 - x0) or gap.tolist() != [
            i == SEVIRI_MISSING for i in range(SEVIRI_SCANS)]:
        raise AssertionError(f"SEVIRI: loaded {bt.shape}, NaN frames {np.flatnonzero(gap)}")
    log(f"SEVIRI: {len(paths)} full-disk {SEVIRI_DISK}x{SEVIRI_DISK} native archives (5 IR "
        f"channels, {size / len(paths) / 2**20:.1f} MiB each) written in {written:.1f} s "
        f"({SEVIRI_WORKERS} threads of the CPU checks' worker process, beside the small "
        f"checks; {waited:.1f} s waited for); decoded and cropped to {bt.shape[1:]} in "
        f"{decoded:.2f} s ({decoded / len(paths):.3f} s a file in 8 threads; "
        f"{one:.3f} s for a file alone) [{card_line}]; the fields reach the card unchanged, "
        f"the gap is one NaN frame")
    del alone
    reset_counts()
    gc.collect()
    torch.cuda.empty_cache()
    stats = {}
    t1 = time.perf_counter()
    ds, name = dcc_detect_seviri_nat.detect_fields(bt, wvd, twd, device=device, stats=stats)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t1
    launches, by_shape = read_counts()
    objects = {k: int(ds.coords[k].size) for k in CLI_COORDS}
    if min(objects.values()) == 0 or launches == 0:
        raise AssertionError(f"SEVIRI: objects {objects}, {launches} kernel launches")
    log(f"SEVIRI {name} {tuple(ds['core_label'].shape)} through dcc_detect_seviri_nat's "
        f"detection of the decoded fields [{card_line}]: {seconds:.3f} s; " + ", ".join(
            f"{k} {stats[k + '_s']:.3f} s" for k in CLI_STAGES if k + "_s" in stats)
        + f"; objects {objects}; kernel launches {launches} by shape {by_shape}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, by_shape


# -- the configured detection ------------------------------------------------

# the PipelineConfig the phase writes as JSON and reads back: any registered
# flow model, Lanczos smoothing and core subsegmentation
CONFIGURED = {"flow_model": "DIS", "interp_method": "lanczos", "subsegment_shrink": 0.1}
FLOW_MODEL_NAMES = ("DIS", "DualTVL1", "DeepFlow", "PCA", "SimpleFlow", "SparseToDense")
# make_multistorm_scene's frames whose last 3 pairs the card and the CPU flow
# (its first frame holds no storm yet)
MODEL_CHECK = (5, 128, 192)
SUBSEGMENT_BT = 235.0  # K: the subsegmented mask of the card-against-CPU check
# make_multistorm_scene's scene of the configured CLI's card-against-CPU
# check: the smallest tried where the configuration finds anvil markers
# and cores (9x64x96's floods took 27 s on the card, 9x32x48 finds no core)
CONFIGURED_SMALL = (9, 48, 64)


def cpu_model_flows(p8, n8):
    """Each ported model's flows of the quantised pairs (numpy) on the CPU:
    the CPU side of phase 14 (a), run in a worker process (``cpu_legs``)."""
    torch.set_num_threads(CPU_LEG_THREADS)
    p8, n8 = torch.from_numpy(p8), torch.from_numpy(n8)
    return {name: select_of_model(name)(p8, n8).numpy() for name in FLOW_MODEL_NAMES}


def cpu_subsegment(mask):
    """``subsegment_labels`` of ``mask`` on the CPU (worker process)."""
    from tobac_flow_tpu_torch.segment.subsegment import subsegment_labels

    torch.set_num_threads(CPU_LEG_THREADS)
    return subsegment_labels(mask, CONFIGURED["subsegment_shrink"], device="cpu").numpy()


def check_configured_small(device, card_line, legs):
    """Phase 14 (a), card against CPU, the CPU sides in ``legs``' worker
    process: each model's flows of MODEL_CHECK's last 3 pairs (the Farneback
    gate inside the storms); ``subsegment_labels`` of its cold cores
    (identical); and ``PipelineConfig(**CONFIGURED)`` written as JSON,
    read back and run through ``cli.common.run_detection`` at
    CONFIGURED_SMALL given the card's flows of that configuration (identical datasets but
    the float means and stds, held to rtol 1e-5; anvil markers and anvils
    found).  Returns the configuration read back, and a function that
    waits for the CPU's sides and checks them."""
    from tobac_flow_tpu_torch.config import PipelineConfig
    from tobac_flow_tpu_torch.segment.subsegment import subsegment_labels

    t0 = time.perf_counter()
    bt = make_multistorm_scene(*MODEL_CHECK)[0][1:]
    frames = torch.from_numpy(bt)
    p8, n8 = _normalise_pair(frames[:-1], frames[1:])
    cpu_flows = legs.submit(cpu_model_flows, p8.numpy(), n8.numpy())
    cores = bt[1:3] < SUBSEGMENT_BT  # two frames of well-grown cells
    cpu_sub = legs.submit(cpu_subsegment, cores)
    card_flows, seconds = {}, {}
    for name in FLOW_MODEL_NAMES:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = select_of_model(name).to(device)(p8.to(device), n8.to(device))
        card_flows[name] = out.cpu().numpy()
        seconds[name] = time.perf_counter() - t1
    card_sub = subsegment_labels(cores, CONFIGURED["subsegment_shrink"], device=device)
    if card_sub.device.type != device.type:
        raise AssertionError(f"subsegment_labels ran on {card_sub.device}")
    card_sub = card_sub.cpu().numpy()

    path = ws_sweeps._BUILD_DIR / "configured.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    PipelineConfig(**CONFIGURED).to_json(path)
    config = PipelineConfig.from_json(path)
    if config != PipelineConfig(**CONFIGURED):
        raise AssertionError(f"PipelineConfig: {path} read back as {config}")
    bt_s, wvd_s, swd_s = make_multistorm_scene(*CONFIGURED_SMALL)
    wvd_s[3:6, 14:20, 26:32] = np.nan  # a patch of missing data
    times = chain_times(CONFIGURED_SMALL[0])
    flow = create_flow(bt_s, model=config.flow_model, vr_steps=config.vr_steps,
                       smoothing_passes=config.smoothing_passes,
                       interp_method=config.interp_method, max_value=config.flow_max_value)
    if flow.device.type != device.type:
        raise AssertionError(f"create_flow ran on {flow.device}, not on the card")
    cpu_run = legs.submit(cpu_detection, *chain_inputs(bt_s, wvd_s, swd_s, times),
                          flow.forward_flow.cpu().numpy(), flow.backward_flow.cpu().numpy(),
                          CONFIGURED)
    fields, ds = chain_inputs(bt_s, wvd_s, swd_s, times)
    opts = config.detection_options()
    opts.save_anvil_markers = True
    opts.flow_factory = lambda _: flow
    card_out = cli.run_detection(*fields, ds, opts=opts)
    log(f"configured (a): the card's sides in {time.perf_counter() - t0:.1f} s: each model on "
        f"{MODEL_CHECK[0] - 2} pairs of {MODEL_CHECK[1:]} " + ", ".join(
            f"{n} {s:.3f} s" for n, s in seconds.items())
        + f"; {config} through cli.run_detection at {CONFIGURED_SMALL} [{card_line}]")

    def finish():
        storm = bt[:-1] < 260.0
        worst = {}
        for name, want in cpu_flows.result().items():
            got = card_flows[name]
            for i in range(got.shape[0]):
                if not within(got[i], want[i], storm[i]):
                    raise AssertionError(f"configured (a): {name} card vs CPU flow, pair {i}")
            worst[name] = float(np.abs(got - want)[storm].max())
        want_sub = cpu_sub.result()
        if not np.array_equal(want_sub, card_sub) or want_sub.max() == 0:
            raise AssertionError(f"configured (a): subsegment_labels card vs CPU "
                                 f"({want_sub.max()} and {card_sub.max()} labels)")
        cpu_out = cpu_run.result()
        counts = {name: int(cpu_out[name].values.max()) for name in CHAIN_LABELS}
        if counts["anvil_marker_label"] == 0 or counts["thick_anvil_label"] == 0:
            raise AssertionError(f"configured (a): no anvil markers or anvils: {counts}")
        dataset_worst = compare_datasets(cpu_out, card_out)
        log(f"configured (a) checks: each model's card flows within the Farneback gate of the "
            f"CPU's inside the storms (max |card - CPU| " + ", ".join(
                f"{n} {v:.3g}" for n, v in worst.items())
            + f" px); subsegment_labels identical ({int(want_sub.max())} subsegments of "
            f"{int(cores.sum())} core pixels); cli.run_detection under the JSON configuration "
            f"gives the CPU's dataset given the same flows (float32 means and stds within "
            f"{dataset_worst:.3g}, the rest identical); objects {counts}")

    return config, finish


def run_configured(device, card_line, goes_fields, config):
    """Phase 14 (b): the configured chain's first three stages at the GOES
    job's frame on the card, as the chain calls them (``create_flow`` with
    ``config``'s model and smoothing, ``detect_cores`` and
    ``get_anvil_markers`` with its ``subsegment_shrink``), with the
    kernel's counts reset just before and read just after; then
    ``create_flow`` with each other model.  Each stage's seconds, peak over
    its start against the budget at its start, groups of pairs and
    objects are logged.  Checks: every flow finite off the gap frame and
    within ±``flow_max_value``; cores and anvil markers found; every peak
    within its budget; the anvil marker mask's subsegmentation in forced
    time chunks equal to the whole volume's (outside the counted run).
    Returns (launches, launches by shape, seconds per
    pair-direction by model)."""
    from tobac_flow_tpu_torch.detect.fused import anvil_marker_mask
    from tobac_flow_tpu_torch.segment.subsegment import subsegment_labels

    opts = config.detection_options()
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    bt, wvd, swd = (torch.from_numpy(np.asarray(f.values)).to(device) for f in goes_fields)
    times = goes_fields[0].coords["t"]
    t = bt.shape[0]
    px = bt[0].numel()
    gap = [i for i in range(t) if bool(torch.isnan(bt[i]).all())]
    stats, budgets, groups = {}, {}, {}
    kw = dict(overlap=opts.overlap, absolute_overlap=opts.absolute_overlap,
              subsegment_shrink=opts.subsegment_shrink, min_length=opts.t_offset)

    def run(name, fn, count=None):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # as run_deep_chain's stages
        budgets[name] = port_device.memory_budget(device)
        with port_device.stage(name, stats, device):
            result = fn()
        if count is not None:
            stats[f"{name}_n"] = int(count(result))
        return result

    def flow_of(model):
        step = port_device.group_size(t - 1, px, select_of_model(model).BYTES_PER_PAIR_PX,
                                      device, None, 16 * t * px)
        groups[model] = -(-(t - 1) // step)
        return create_flow(bt, model=model, vr_steps=opts.vr_steps,
                           smoothing_passes=opts.smoothing_passes,
                           interp_method=opts.interp_method, max_value=config.flow_max_value,
                           device=device)

    def check_flow(flow, model):
        for f in flow.flow:
            off_gap = torch.stack([f[i] for i in range(t) if i not in gap])
            top = float(torch.nan_to_num(f, nan=0.0).abs().max())
            if not bool(torch.isfinite(off_gap).all()) or top > config.flow_max_value:
                raise AssertionError(f"configured: {model} flow not finite off the gap frame "
                                     f"or over the clip ({top} px)")

    reset_counts()
    flow = run("flow", lambda: flow_of(config.flow_model))
    cores = run("detect_cores", lambda: detect_cores(
        flow, bt, wvd, swd, times, wvd_threshold=opts.wvd_threshold,
        bt_threshold=opts.bt_threshold, use_wvd=opts.use_wvd, **kw), lambda r: r.max())
    diff = wvd - swd
    markers = run("anvil_markers", lambda: get_anvil_markers(
        flow, diff, threshold=opts.thick_upper, **kw), lambda r: r.max())
    torch.cuda.synchronize()
    launches, by_shape = read_counts()
    del cores, markers
    # the subsegmentation of the anvil marker mask at full width in forced
    # 4-frame time chunks against the whole volume (9 frames run whole)
    mask = anvil_marker_mask(diff, opts.thick_upper)
    del diff
    whole = subsegment_labels(mask, config.subsegment_shrink, 10, device=device)
    sub = {}
    with port_device.stage("subsegment_chunked", sub, device):
        chunked = subsegment_labels(mask, config.subsegment_shrink, 10, device=device,
                                    budget_bytes=port_device.frames_budget(CHUNK_CAP))
    if sub.get("subsegment_chunked_chunks", 1) < 2 or not torch.equal(whole, chunked):
        raise AssertionError(f"configured: the subsegmentation in "
                             f"{sub.get('subsegment_chunked_chunks', 1)} time chunks differs "
                             f"from the whole volume's")
    n_sub = int(whole.max())
    del mask, whole, chunked
    check_flow(flow, config.flow_model)
    del flow
    names = ["flow", "detect_cores", "anvil_markers"]
    if stats["detect_cores_n"] == 0 or stats["anvil_markers_n"] == 0 or launches == 0:
        raise AssertionError(f"configured: objects {stats['detect_cores_n']}, "
                             f"{stats['anvil_markers_n']}; {launches} kernel launches")
    per_pair = {config.flow_model: stats["flow_s"] / (2 * (t - 1))}
    for model in FLOW_MODEL_NAMES:
        if model == config.flow_model:
            continue
        name = f"flow_{model}"
        flow = run(name, lambda: flow_of(model))
        check_flow(flow, model)
        del flow
        per_pair[model] = stats[f"{name}_s"] / (2 * (t - 1))
        names.append(name)
    over = [n for n in names
            if stats[f"{n}_peak_bytes"] - stats[f"{n}_start_bytes"] > budgets[n]]
    if over:
        raise AssertionError(f"configured: peaks over budget {over}")
    del bt, wvd, swd
    log(f"configured (b) {tuple(goes_fields[0].shape)}, NaN frames {gap}, {config.flow_model} "
        f"with {config.interp_method} smoothing, subsegment_shrink "
        f"{config.subsegment_shrink} [{card_line}]: " + "; ".join(
            f"{n} {stats[n + '_s']:.3f} s, peak {stats[n + '_peak_bytes'] / 2**30:.3f} GiB "
            f"({(stats[n + '_peak_bytes'] - stats[n + '_start_bytes']) / 2**30:.3f} over its "
            f"start, budget {budgets[n] / 2**30:.3f})"
            + (f", objects {stats[n + '_n']}" if n + "_n" in stats else "") for n in names)
        + "; groups of pairs " + ", ".join(f"{m} {g}" for m, g in groups.items())
        + "; seconds per pair-direction " + ", ".join(
            f"{m} {s:.4f}" for m, s in per_pair.items())
        + f"; kernel launches {launches} {by_shape}; the markers' subsegmentation in "
        f"{sub['subsegment_chunked_chunks']} forced chunks = whole ({n_sub} subsegments); "
        f"phase {time.perf_counter() - t0:.1f} s")
    return launches, by_shape, per_pair


SHARDED_MESH = (2, 2)  # (n_t, n_x)
SHARDED_SMALL = (8, 64, 96)
SHARDED_FULL = (8,) + JOB_FRAME
SHARDED_KW = {"hx": 24, "warp_radius": 21}  # the reference's edge-exact halo and band
SHARDED_SMALL_ROUNDS = 64  # (a)'s flood cap, the reference test's
SHARDED_FULL_ROUNDS = 8  # (b)'s cap: the reference's default (converged, (b) took 530 s)
SHARDED_OWN_ROUNDS = 4  # (b)'s own-flow run: every part of the chain, fewer rounds, for time
SHARDED_CONVERGED_ROUNDS = 4096  # the crop's cap: its floods stop at their convergence first
SHARDED_CROP = (slice(None), slice(430, 1070), slice(500, 1140))  # 8x640x640 of (b)'s scene
SHARDED_FLOW_KW = {"vr_steps": 1, "smoothing_passes": 1, "interp_method": "cubic"}
SHARDED_AGREEMENT = 0.99
SHARDED_LABELS = ("core_markers", "core_labels", "anvil_marker_labels", "thick_anvil_labels",
                  "thin_anvil_labels")


def single_card_chain(bt, wvd, swd, fwd, bwd, device, anvils=True):
    """The single device's stages under the given flows, as numpy: the core
    markers (``fused.core_markers``), their ``flow_label``, the anvil
    markers (``get_anvil_markers``) and, with ``anvils``, the thick anvils
    (``detect_anvils``, ``relabel_anvils``) and the thin ones, at the
    sharded chain's thresholds."""
    from tobac_flow_tpu_torch.detect import fused
    from tobac_flow_tpu_torch.detect.detection import detect_anvils, relabel_anvils
    from tobac_flow_tpu_torch.segment.label import flow_label

    bt, wvd, swd, fwd, bwd = (torch.as_tensor(np.asarray(a)).to(device)
                              for a in (bt, wvd, swd, fwd, bwd))
    flow = Flow(fwd, bwd)
    dt = torch.full((bt.shape[0], 1, 1), 5.0, device=device)
    markers = fused.core_markers(bt, wvd, swd, fwd, bwd, dt, 0.25, 0.5, True)
    out = {"core_markers": markers, "core_labels": flow_label(flow, markers)}
    link = {"overlap": 0.5, "absolute_overlap": 4, "min_length": 3}
    out["anvil_marker_labels"] = get_anvil_markers(flow, wvd - swd, threshold=-5.0, **link)
    if anvils:
        thick = detect_anvils(flow, wvd - swd, markers=out["anvil_marker_labels"],
                              upper_threshold=-5.0, lower_threshold=-12.5, erode_distance=2,
                              min_length=3)
        out["thick_anvil_labels"] = relabel_anvils(
            flow, thick, markers=out["anvil_marker_labels"], **link)
        out["thin_anvil_labels"] = detect_anvils(
            flow, wvd + swd, markers=out["thick_anvil_labels"], upper_threshold=0.0,
            lower_threshold=-7.5, erode_distance=2, min_length=3)
    return {k: v.cpu().numpy() for k, v in out.items()}


def bijective(a, b):
    """Do the paired labels of ``a`` and ``b`` (1-D) map one to one?"""
    if a.size == 0:
        return b.size == 0
    a, b = a.astype(np.int64), b.astype(np.int64)
    pairs = np.unique((a - a.min()) * (int(b.max() - b.min()) + 1) + (b - b.min()))
    return pairs.size == np.unique(a).size == np.unique(b).size


def held_to_single(sharded, single, what, floods=True):
    """The reference test's bars: markers bit-equal, core labels the same
    partition, anvil marker labels exact and (``floods``) thick and thin
    anvils agreeing on at least SHARDED_AGREEMENT of their pixels.  Returns
    the agreements."""
    markers = single["core_markers"]
    if not np.array_equal(sharded["core_markers"], markers):
        raise AssertionError(f"{what}: core markers differ from the single card's at "
                             f"{int((sharded['core_markers'] != markers).sum())} pixels")
    core = sharded["core_labels"]
    if not (((core != 0) == markers).all()
            and bijective(core[markers], single["core_labels"][markers])):
        raise AssertionError(f"{what}: core labels are not the single card's partition")
    if not np.array_equal(sharded["anvil_marker_labels"], single["anvil_marker_labels"]):
        raise AssertionError(f"{what}: anvil marker labels differ from the single card's")
    agree = {}
    for key in ("thick_anvil_labels", "thin_anvil_labels") if floods else ():
        a, b = sharded[key], single[key]
        both = (a != 0) | (b != 0)
        agree[key] = float((a[both] == b[both]).mean()) if both.any() else 1.0
        if b.max() < 1 or agree[key] < SHARDED_AGREEMENT:
            raise AssertionError(f"{what}: {key} agree with the single card's at "
                                 f"{agree[key]:.4f} ({int(b.max())} objects)")
    return agree


def sharded_by_shape(result):
    """A job's ``ws_sweeps`` launches by shape key, summed over its ranks."""
    counts = {}
    for rank in result["ranks"]:
        for (t, h, w, k), n in rank["launches_by_shape"].items():
            key = shape_key((t, h, w), k)
            counts[key] = counts.get(key, 0) + n
    return counts


def log_sharded_ranks(result, what, card_line, plan):
    """Each rank's seconds by part, rounds, exchanges, peak memory against
    its budget and kernel launches by shape."""
    parts = ("flow", "cores", "core_labels", "anvil_prep", "gather", "host_markers",
             "thick_flood", "host_thick", "thin_flood", "host_thin", "flow_label")
    for rank in result["ranks"]:
        st = rank["stats"]
        budget = rank["budget"]
        log(f"{what} rank {rank['rank']} at {rank['coords']} [{card_line}; {plan['ranks']} "
            f"ranks on {max(plan['cards'], 1)} card(s), {plan['backend']}]: "
            f"{rank['seconds']:.3f} s; " + ", ".join(
                f"{p} {st[p + '_s']:.3f} s" for p in parts if p + "_s" in st)
            + f"; rounds: core labels {st.get('core_label_rounds')}, hole fill "
            f"{st.get('fill_rounds')}, thick {st.get('thick_barrier_rounds')} + "
            f"{st.get('thick_flood_rounds')}, thin {st.get('thin_barrier_rounds')} + "
            f"{st.get('thin_flood_rounds')} (barrier + mixed); exchanges "
            f"{rank['exchange_s']:.3f} s (waits included), "
            f"{rank['bytes_sent'] / 2**20:.1f} MiB sent; peak "
            f"{(rank['peak_bytes'] - rank['start_bytes']) / 2**30:.3f} GiB over its start"
            + (f" of a {budget / 2**30:.1f} GiB budget" if budget else "")
            + f"; ws_sweeps launches {dict(sorted(sharded_by_shape({'ranks': [rank]}).items()))}")
        if budget and rank["peak_bytes"] - rank["start_bytes"] > budget:
            raise AssertionError(f"{what}: rank {rank['rank']} peaked over its budget")


def check_sharded(device, card_line):
    """Phase 16, the sharded chain (``parallel.pipeline.sharded_detect_all``)
    on a SHARDED_MESH of ranks, started by ``parallel.launch.launch``; on
    one card the ranks share it and talk over gloo through pinned host
    memory, on one card each over NCCL.

    (a) Card against CPU at SHARDED_SMALL (``make_multistorm_scene``) given
    the single card's CLI-default flows: the card's ranks and gloo ranks on
    the CPU give identical outputs, and ``sharded_flow_label`` of the cold
    cloud too; both meet the reference test's bars against the single
    card's chain (``held_to_single``); a (1, 1) mesh on card 0, over NCCL,
    meets them as well.  (b) At the GOES job's frame, ``deep_scene`` at
    SHARDED_FULL, given the single card's flows and then computing its own
    (the CLI's passes), the floods at the reference's default cap of
    SHARDED_FULL_ROUNDS rounds (SHARDED_OWN_ROUNDS with its own flows):
    each rank's seconds by part, exchanges, peak memory against its budget
    and kernel launches; core markers bit-equal to the single card's, core
    labels its partition, anvil marker labels exact; with its own flows,
    flows finite within the clip.  Converged, the floods take several
    minutes on one card, so they run to convergence on SHARDED_CROP of
    (b)'s scene and flows, held to the single card's chain there by (a)'s
    bars.  The ranks start, and run (a) and the crop, beside this
    process's own work on the card (the single card's sides, the (1, 1)
    mesh); (b) waits for it.  Returns (the kernel's
    launches by shape in (b) given flows, with its own flows, in the other
    runs)."""
    from tobac_flow_tpu_torch.parallel.dryrun import chain_jobs
    from tobac_flow_tpu_torch.parallel.launch import launch, layout

    t_start = time.perf_counter()
    scene = prefetched(deep_scene, *SHARDED_FULL)
    bt, wvd, swd = make_multistorm_scene(*SHARDED_SMALL)
    flow = create_flow(bt, vr_steps=1, smoothing_passes=1, interp_method="cubic",
                       device=device)
    fwd, bwd = (f.cpu().numpy() for f in flow.flow)
    del flow
    small_kw = dict(SHARDED_KW, ws_sweeps=SHARDED_SMALL_ROUNDS)
    job_a = {"fields": (bt, wvd, swd), "flows": (fwd, bwd), "kw": small_kw,
             "label_mask": bt < 235.0, "label_halo": SHARDED_KW["warp_radius"]}
    on_cpu = prefetched(lambda: launch(chain_jobs, *SHARDED_MESH, [job_a], device="cpu"))
    full, made, waited = scene()
    fields = tuple(full)
    del full
    flow = create_flow(fields[0], vr_steps=1, smoothing_passes=1, interp_method="cubic",
                       device=device)
    full_fwd, full_bwd = (f.cpu().numpy() for f in flow.flow)
    del flow
    crop = tuple(np.ascontiguousarray(a[SHARDED_CROP]) for a in (*fields, full_fwd, full_bwd))
    # the ranks start, run (a) and the crop while this process computes the
    # single card's sides; (b), timed, waits for the signal that they are done
    signal = Path(tempfile.mkdtemp(prefix="tft_phase16_")) / "single_card_done"
    atexit.register(shutil.rmtree, signal.parent, True)
    full_kw = dict(SHARDED_KW, ws_sweeps=SHARDED_FULL_ROUNDS)
    jobs = [job_a,
            {"fields": crop[:3], "flows": crop[3:],
             "kw": dict(SHARDED_KW, ws_sweeps=SHARDED_CONVERGED_ROUNDS)},
            {"fields": fields, "flows": (full_fwd, full_bwd), "kw": full_kw,
             "keep": SHARDED_LABELS[:3], "after": str(signal)},
            {"fields": fields, "keep": (),
             "kw": dict(SHARDED_KW, ws_sweeps=SHARDED_OWN_ROUNDS, **SHARDED_FLOW_KW)}]
    plan = layout(SHARDED_MESH[0] * SHARDED_MESH[1], device)
    log(f"sharded: launching {plan['ranks']} ranks on {plan['cards']} card(s), "
        f"{plan['ranks_per_card']} a card, over {plan['backend']}; deep_scene{SHARDED_FULL} "
        f"made in {made:.1f} s (waited {waited:.1f} s)")
    t0 = time.perf_counter()
    on_card = prefetched(lambda: launch(chain_jobs, *SHARDED_MESH, jobs, device=device))
    try:
        single_a = single_card_chain(bt, wvd, swd, fwd, bwd, device)
        plan1 = layout(1, device)
        one = launch(chain_jobs, 1, 1, [job_a], device=device)[0]
        agree1 = held_to_single(one["outputs"], single_a, "sharded (a) on a (1, 1) mesh")
        log(f"sharded (a) {SHARDED_SMALL} on a (1, 1) mesh on card 0 over {plan1['backend']}, "
            f"beside the ranks' start: the reference test's bars against the single card hold "
            f"(thick and thin agree {agree1}); {one['ranks'][0]['seconds']:.3f} s")
        single_b = single_card_chain(*fields, full_fwd, full_bwd, device, anvils=False)
        single_c = single_card_chain(*crop, device)
        gc.collect()
        torch.cuda.empty_cache()
        cpu = on_cpu()[0][0]
    except BaseException:
        signal.write_text("abort")  # the ranks stop at (b) instead of waiting for ever
        on_card.thread.join()
        raise
    single_s = time.perf_counter() - t0
    signal.write_text("go")
    card_a, cropped, given, own = on_card()[0]
    log(f"sharded: beside the ranks' start, (a) and the crop, this process ran (a) on the "
        f"single card and the (1, 1) mesh and computed the single card's core markers, core "
        f"labels and anvil markers at {SHARDED_FULL} and its chain on the {crop[0].shape} crop "
        f"in {single_s:.1f} s; the ranks ran everything in "
        f"{time.perf_counter() - t0:.1f} s, start-up and the scenes' hand-over included")

    for name, a in card_a["outputs"].items():
        if not np.array_equal(a, cpu["outputs"][name]):
            raise AssertionError(f"sharded (a): the card's {name} differ from the CPU ranks'")
    agree = held_to_single(card_a["outputs"], single_a, "sharded (a)")
    log(f"sharded (a) {SHARDED_SMALL} on a {SHARDED_MESH} mesh: the card's ranks equal the "
        f"CPU's gloo ranks in every output ({len(card_a['outputs'])}, sharded_flow_label "
        f"included); against the single card: markers bit-equal, core labels its partition, "
        f"anvil marker labels exact, thick and thin agree {agree} (floods capped at "
        f"{SHARDED_SMALL_ROUNDS} rounds)")
    log_sharded_ranks(card_a, "sharded (a)", card_line, plan)

    agree_c = held_to_single(cropped["outputs"], single_c, "sharded (b) crop")
    rounds = [r["stats"][f"{k}_{p}_rounds"] for r in cropped["ranks"] for k in ("thick", "thin")
              for p in ("flood", "barrier")]
    if max(rounds) >= SHARDED_CONVERGED_ROUNDS:
        raise AssertionError("sharded (b) crop: a flood did not converge")
    log(f"sharded (b) crop {crop[0].shape} converged [{card_line}]: "
        f"{max(r['seconds'] for r in cropped['ranks']):.3f} s (slowest rank, beside the single "
        f"card's sides); against the "
        f"single card's chain: markers bit-equal, core labels its partition, anvil marker "
        f"labels exact, thick and thin agree {agree_c}")
    log_sharded_ranks(cropped, "sharded (b) crop", card_line, plan)

    held_to_single(given["outputs"], single_b, "sharded (b)", floods=False)
    for res, what in ((given, "given flows"), (own, "its own flows")):
        rank0 = res["ranks"][0]
        if not rank0["objects"]["thick_anvil_labels"] or not rank0["objects"]["core_labels"]:
            raise AssertionError(f"sharded (b), {what}: no cores or no thick anvils")
        if not (rank0["flow_finite"] and rank0["flow_max_abs"] <= 20.0):
            raise AssertionError(f"sharded (b), {what}: flows not finite within the clip")
        log(f"sharded (b) {SHARDED_FULL} on a {SHARDED_MESH} mesh, {what} [{card_line}]: "
            f"{max(r['seconds'] for r in res['ranks']):.3f} s (slowest rank); objects "
            f"{rank0['objects']}; flows finite, |flow| <= {rank0['flow_max_abs']:.2f}")
        log_sharded_ranks(res, f"sharded (b), {what}", card_line, plan)
    log(f"sharded (b): core markers bit-equal to the single card's, core labels its "
        f"partition, anvil marker labels exact; phase 16 took "
        f"{time.perf_counter() - t_start:.1f} s")
    return (sharded_by_shape(given), sharded_by_shape(own),
            {**sharded_by_shape(card_a), **sharded_by_shape(one), **sharded_by_shape(cropped)})


def check_and_time_new_shapes(by_shape, per_shape, device, card_line, before_plain=None):
    """The kernel against its plain version (bit-equal, connectivity 1) and
    timed at every (shape, K) of ``by_shape`` that ``per_shape`` lacks.
    With ``before_plain``, the plain versions are timed after it returns,
    their inputs kept until then: the kernel's times (CUDA graphs) do not
    see host work that runs until then, the plain version's would."""
    worst = 0.0
    kept = {}
    keys = {}
    for key in sorted(set(by_shape) - set(per_shape)):
        dims, k = key.split(" K=")
        keys.setdefault(tuple(int(d) for d in dims.split("x")), []).append(int(k))
    for shape, ks in keys.items():
        args = sweep_inputs(shape, 1, device)  # one input set for the shape's checks and times
        for k in ks:
            key = shape_key(shape, k)
            plain = ws_sweeps.spatial_sweeps_reference(*args, IN_PLANE[1], k)
            kern = ws_sweeps.spatial_sweeps(*args, IN_PLANE[1], k)
            torch.cuda.synchronize()
            for name, a, b in zip(("claim", "claim2", "meta"), plain, kern):
                if not torch.equal(a, b):
                    raise AssertionError(f"kernel != plain at {key}: {name} differs at "
                                         f"{int((a != b).sum())} pixels")
                worst = max(worst, max_abs_err(a, b))
            log(f"kernel == plain (bit-equal) at {key}, connectivity 1")
            del plain, kern
        per_shape.update(time_shape_classes(device, card_line, [(shape, k) for k in ks],
                                            {shape: args}, plain=before_plain is None))
        if before_plain is not None:
            kept[shape] = (args, ks)
        del args
    if before_plain is not None:
        before_plain()
        for shape, (args, ks) in kept.items():
            for k in ks:
                row = per_shape[shape_key(shape, k)]
                row["plain_ms"] = time_plain_ms(args, k)
                log(f"ws_spatial_sweeps at {shape_key(shape, k)}, connectivity 1: plain PyTorch "
                    f"{row['plain_ms']:.3f} ms, {100 * row['bound_ms'] / row['plain_ms']:.3f} % "
                    f"of the bound [{card_line}]")
    return worst


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

    check_cli_h5py()
    check_linking_clis()
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
    npix = float(np.prod(FULL))
    first = None
    for run in range(1, RUNS + 1):
        gc.collect()
        torch.cuda.synchronize()
        port_device.reset_peak_memory(device)
        resident = torch.cuda.memory_allocated()
        stats = {}
        reset_counts()
        t0 = time.perf_counter()
        fwd, growth, edges, labels = fused_flow_watershed(bt_dev, 5.0, markers=markers,
                                                          stats=stats)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, by_shape = read_counts()
        peak = port_device.peak_memory(device)

        if "chunks" in stats:
            raise AssertionError("full slice: the flood ran in time chunks")
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
            f"{stats['watershed_s']:.3f} s; stage peaks " + ", ".join(
                f"{name} {stats[name + '_peak_bytes'] / 2**30:.3f} GiB" for name in STAGES)
            + f"; kernel launches {launches} (before time chunks: {WHOLE_FLOOD_LAUNCHES}); "
            f"device memory resident at start {resident / 2**30:.3f} GiB, peak "
            f"{peak / 2**30:.3f} GiB")
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

    # the small checks, card against CPU: the detection chain, the GOES
    # ingest's output through it and the time-chunked flood, with their CPU
    # sides and the SEVIRI archives in a worker process and the GOES and
    # deep scenes in threads.  All of that is joined before the chain's
    # profile, so that nothing of the script's own runs beside a timed main
    # path from there on.
    seviri_dir = ws_sweeps._BUILD_DIR / "seviri"
    shutil.rmtree(seviri_dir, ignore_errors=True)
    seviri_dir.mkdir(parents=True)
    atexit.register(shutil.rmtree, seviri_dir, True)
    conus = window_grid(*JOB_FRAME, origin=(0, 0))  # the GOES scene's grid
    radar_made = prefetched(radar_gates, conus)
    with cpu_legs() as legs:
        small = check_chain_small(device, card_line, legs)
        goes_scene = prefetched(goes_frames, GOES_FULL, GOES_MISSING)
        small_by_shape = check_chunked_chain_small(small, card_line)
        finish_goes_small = check_goes_small(device, card_line, legs)
        archives = legs.submit(seviri_archives, str(seviri_dir))
        deep_at = deep_shape(device)[0]
        deep_scene_made = (deep_at, prefetched(deep_inputs, deep_at))
        finish_chunked_small = check_chunked_small(device, card_line, legs)
        config, finish_configured = check_configured_small(device, card_line, legs)
        legacy_small_by_shape, finish_legacy_small = check_legacy_small(device, card_line, legs)
        small[3]()
        finish_goes_small()
        finish_chunked_small()
        finish_configured()
        finish_legacy_small()
        t0 = time.perf_counter()
        seviri_paths, seviri_written = archives.result()
        seviri_archived = (seviri_paths, seviri_written, time.perf_counter() - t0)
        del small
    goes_scene()
    deep_scene_made[1]()
    radar_made()

    # the chain's profile at the bench frame, the CONUS-shaped GOES run, then
    # the chunked chain against it while the deep chain's scene is made
    chain_profiled_ms, chain_profiled_launches = profile_chain(device, card_line)
    goes_launches, goes_by_shape, goes_record = run_goes(device, card_line, goes_scene)
    del goes_scene
    chain_scene = prefetched(deep_scene, deep_chain_most_frames(device), *JOB_FRAME)
    check_chunked_goes(goes_record, device, card_line)
    configured_fields = goes_record["fields"]  # phase 14 (b) reuses the GOES scene
    del goes_record
    chain_scene()

    # the time-chunked flood: chunked against whole at the job's frame, then
    # the main path past what the card floods whole
    fit_by_shape = run_chunked_fit(device, card_line)
    deep_launches, deep_by_shape = run_deep(device, card_line, deep_scene_made)
    del deep_scene_made
    # cross-file linking: the recorded windows against the JAX record, then
    # three windows cut from the deep chain's volumes at the job's frame
    check_linking_small(device, card_line)
    link_by_shape, linked = run_deep_linking(run_deep_chain(device, card_line, chain_scene),
                                             device, card_line)
    del chain_scene
    # statistics and post-processing of the linked windows, their validation
    # against seeded GLM flashes, and the SEVIRI ingest and detection
    stats_by_shape, windows, start_statistics_check = run_statistics(linked, device, card_line)
    del linked
    validation_by_shape, start_validation_check = run_validation(windows, device, card_line)
    del windows
    gc.collect()
    torch.cuda.empty_cache()
    seviri_launches, seviri_by_shape = run_seviri(device, card_line, seviri_archived)
    shutil.rmtree(seviri_dir, ignore_errors=True)
    # the configured detection at the GOES job's frame: any flow model,
    # Lanczos smoothing and core subsegmentation
    gc.collect()
    torch.cuda.empty_cache()
    configured_launches, configured_by_shape, _ = run_configured(
        device, card_line, configured_fields, config)
    # the legacy path on the same scene, and the radar gridding on its grid
    legacy_launches, legacy_by_shape = run_legacy(device, card_line, configured_fields)
    del configured_fields
    start_radar_check = run_radar(device, card_line, conus, radar_made)
    del radar_made
    # the sharded chain on a mesh of ranks: card against CPU, then the job's frame
    gc.collect()
    torch.cuda.empty_cache()
    sharded_by, sharded_own_by, sharded_small_by = check_sharded(device, card_line)
    # the kernel at the new shapes checked and timed in CUDA graphs while the
    # CPU sides of the statistics' and validation's cut checks run in
    # threads; then those checks ((c) first, as the statistics' forced
    # chunks need no other thread beside them), and the plain versions'
    # host-bound times with nothing beside them
    finish_validation = start_validation_check()
    finish_statistics = start_statistics_check()
    finish_radar = start_radar_check()

    def finish_checks():
        finish_validation()
        finish_statistics()
        finish_radar()

    worst = max(worst, check_and_time_new_shapes(
        {**goes_by_shape, **fit_by_shape, **deep_by_shape, **small_by_shape, **seviri_by_shape,
         **configured_by_shape, **legacy_by_shape, **legacy_small_by_shape, **sharded_by,
         **sharded_own_by, **sharded_small_by},
        per_shape, device, card_line, finish_checks))
    paths = {"fused_flow_watershed": by_shape, "run_detection_goes": goes_by_shape,
             "fused_flow_watershed_deep": deep_by_shape, "linking_deep": link_by_shape,
             "statistics": stats_by_shape, "validation": validation_by_shape,
             "dcc_detect_seviri_nat": seviri_by_shape,
             "run_detection_configured": configured_by_shape,
             "dcc_detect_legacy": legacy_by_shape, "nexrad_gridding": {},
             "sharded_detect_all": sharded_by, "sharded_detect_all_own_flow": sharded_own_by}

    for key, row in per_shape.items():
        counts = [c.get(key, 0) for c in paths.values()]
        log(f"shape {key}: {row['ms']:.4f} ms per launch cold ({row['warm_l2_ms']:.4f} warm), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{100 * row['bound_ms'] / row['ms']:.1f} % of the bound; plain "
            f"{row['plain_ms']:.3f} ms; launches per run {counts} ({', '.join(paths)}; "
            f"{fit_by_shape.get(key, 0)} in the chunked flood at {FIT_DEPTH} frames); ms per "
            f"run cold {[round(n * row['ms'], 3) for n in counts]} [{card_line}]")

    def per_run(field, counts):
        return sum(n * per_shape[key][field] for key, n in counts.items())

    def both(field):
        return sum(per_run(field, counts) for counts in paths.values())

    print(json.dumps({"kernels": [{
        "name": "ws_spatial_sweeps", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches + goes_launches + deep_launches + seviri_launches
        + configured_launches + legacy_launches + sum(sharded_by.values())
        + sum(sharded_own_by.values()),
        "max_abs_err": worst,
        "ms": both("ms"), "plain_ms": both("plain_ms"), "bound_ms": both("bound_ms"),
        "bound_by": "bytes" if both("bytes_ms") >= both("ops_ms") else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes this function",
        "per": "one run of each main path (the bench slice, the detection of the "
               "CONUS-shaped GOES scene, the deep time-chunked slice, the linking of three "
               "windows cut from the deep chain, their statistics and their validation, which "
               "flood nothing, the SEVIRI native CLI's detection of its crop, and the "
               "configured chain's flow, cores and anvil markers at the GOES job's frame, "
               "whose subsegmentation floods in plane, the legacy CLI's path on the GOES "
               "scene's first frames, the radar gridding, which floods nothing, and the "
               "sharded chain on a (2, 2) mesh at the GOES job's frame, given the single "
               "card's flows and with its own, the launches of all its ranks): "
               "the sum over its "
               "launches_by_shape of launches x ms per launch, with the inputs cold in L2",
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
