"""Where the port's entry points run: on the card unless the caller asks
for the CPU; how their stages are timed; how much device memory a stage
may still take; how a stage over that memory is cut into time chunks; and
which volumes wait on the host while a stage runs."""

from __future__ import annotations

import math
import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function

__all__ = ["resolve_device", "stage", "memory_budget", "peak_memory", "reset_peak_memory",
           "group_size", "chunk_plan", "frames_budget", "time_chunks", "run_chunked", "park",
           "place"]

# share of the card's memory that a budget leaves free: the caching
# allocator's fragmentation, the CUDA context and library workspaces
MEMORY_MARGIN = 0.15

# Device bytes per pixel that a stage allocates at its peak beyond its
# inputs, its outputs included, rounded up: the most that
# tools/torch_flood_memory.py --stages-only measured over whole volumes and
# over time chunks (per chunk frame, halos included) at 6 and 12 x 1500 x
# 2500 on an H100 80GB HBM3 (700 W); the per-label passes on labels that
# cover every pixel, as they cost bytes per labelled pixel.  A stage whose
# volume would need more than its budget runs in time chunks sized from
# these (``chunk_plan``).
CORE_MARKERS_BYTES_PER_PX = 175  # detect.fused.core_markers: 174.57
MARKER_MASK_BYTES_PER_PX = 7  # detect.fused.anvil_marker_mask: 6.10
ANVIL_PRE_BYTES_PER_PX = 366  # detect.fused.anvil_pre_watershed: 365.52
ANVIL_POST_BYTES_PER_PX = 17  # detect.fused.anvil_post_watershed: 16.00
CONVOLVE_BYTES_PER_TAP_PX = 14  # ops.convolve.convolve, per tap: 13.06
LABEL_BYTES_PER_PX = 62  # ops.ccl.flat_label, utils.labels.make_step_labels: 61.01
LINK_BYTES_PER_PX = 95  # segment.label.link_labels_by_overlap: 94.68
LABEL_TABLE_BYTES_PER_PX = 62  # utils.labels, detect.analysis label passes: 61.01
OUTPUT_BYTES_PER_PX = 95  # the output stages' per-label reductions: 94.07 (pairwise sums)
NAN_FLAG_BYTES_PER_PX = 7  # schema.dataset.flag_nan_adjacent_labels: 6.01
# the cross-file linker's passes (track/), per pixel of the frames of one
# volume that a pass reads (6 and 12 frames): the pair histogram over a
# shared interior (both files' frames), a family's lookup (offsets,
# remaps), and the interior merge
OVERLAP_BYTES_PER_PX = 66  # track.linking.find_overlap_between_labels: 65.05
RELABEL_BYTES_PER_PX = 16  # track.file_linker label lookups: 16.00
MERGE_BYTES_PER_PX = 22  # track.file_linker.combine_labels, merge_labels: 21.22
# the post-processing passes, on labels that cover every pixel: the
# weighted label statistics with uncertainties and the weighted flag
# proportions (schema.postprocess), and detect.analysis.get_label_stats
# (per pixel of a row block or time chunk)
POSTPROCESS_BYTES_PER_PX = 87  # weighted_label_stats: 86.03; proportions: 62.05
LABEL_STATS_BYTES_PER_PX = 20  # get_label_stats: 19.10
# validation's marker distance (validate.validation): each frame's exact
# distance transform and the minimum over the frames within the time
# margin, per pixel of a time chunk with its halos (3 frames each side),
# measured at 6 and 24 frames
VALIDATE_BYTES_PER_PX = 37  # validate.validation marker distance: 28.41 whole, 36.25 chunked
# the core subsegmentation (segment.subsegment.subsegment_labels) of the
# anvil marker mask: the labelling, each frame's distance transform, the
# peaks and the in-plane watershed, measured at 6 and 12 frames
SUBSEGMENT_BYTES_PER_PX = 124  # 123.01 whole, 123.14 chunked
MIN_CHUNK_FRAMES = 4  # the smallest time chunk, as the reference's

# the high-water mark of each CUDA device before ``stage``'s last reset of
# the allocator's peak statistics, and the peaks of the stages still open
_CARRIED = {}
_OPEN = []


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA, and raises where CUDA is not available (there
    is no fallback to the CPU); anything else is passed to
    ``torch.device``.  ``device="cpu"`` runs every op's plain PyTorch
    version."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device=\"cpu\" to run the plain "
                "PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


# processes sharing this process's card (the ranks of a mesh that the
# launcher put on one card): each plans for its share of the free memory
_RANKS_PER_CARD = [1]


def set_ranks_per_card(n: int) -> None:
    """Declare that ``n`` processes share this process's card, so that
    :func:`memory_budget` gives this one a ``1/n`` share."""
    _RANKS_PER_CARD[0] = max(1, int(n))


def memory_budget(device, need=0) -> int | None:
    """Bytes that a stage may still allocate on ``device``: the card's free
    memory less ``MEMORY_MARGIN`` of its total, divided among the processes
    that share the card (:func:`set_ranks_per_card`).  Where that is under
    ``need``, PyTorch's caching allocator first returns its unused blocks
    to the card (a cached block that a live tensor shares cannot be
    returned, and is not counted).  ``None`` on the CPU, where no stage is
    sized by memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    share = _RANKS_PER_CARD[0]
    free, total = torch.cuda.mem_get_info(device)
    margin = int(MEMORY_MARGIN * total)
    if (free - margin) // share < need:
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(device)
    return max(0, free - margin) // share


def group_size(n, frame_px, bytes_per_px, device, group=None, reserve=0, halo=0,
               budget=None, least=0, what="stage"):
    """How many of ``n`` pairs or frames of ``frame_px`` pixels a stage
    runs at once (at least one): ``group`` when given, else as many as
    ``budget`` (by default :func:`memory_budget`) less ``reserve`` bytes
    (the stage's whole-volume outputs) holds at ``bytes_per_px`` with
    ``halo`` more frames each, and all ``n`` where there is no budget (the
    CPU).  Where that is under ``least`` frames (and under ``n``),
    MemoryError names ``what`` and the budget."""
    if group is None:
        per = bytes_per_px * frame_px
        if budget is None:
            budget = memory_budget(device, reserve + (n + halo) * per)
        if budget is None:
            return int(n)
        group = (int(budget) - reserve) // per - halo
        if group < min(n, least):
            raise MemoryError(
                f"{what}: a {least}-frame chunk with its {halo} halo frames needs "
                f"{reserve + (least + halo) * per} bytes ({bytes_per_px} B/px), over the "
                f"budget of {int(budget)} bytes"
            )
    return int(max(1, min(n, group)))


# the chunk plans of the stages still open: ``stage`` records them
_PLANS = []


def chunk_plan(what, shape, bytes_per_px, device, budget=None, halo=0, out_bytes_per_px=0):
    """Frames per time chunk of a stage over a (T, ...) volume ``shape``
    that allocates ``bytes_per_px`` at its peak (its outputs included)
    and reads ``halo`` frames each side of a chunk: T (one chunk) where
    the whole volume fits ``budget`` bytes (by default
    :func:`memory_budget`; no budget, as on the CPU, runs whole), else the
    most frames whose chunk and halos fit beside the whole-volume outputs
    (``out_bytes_per_px``), evened out over as many chunks as T needs.
    Raises MemoryError, naming ``what``, the volume and the budget, where
    not even a ``MIN_CHUNK_FRAMES`` chunk fits.  ``budget`` may also be a
    function of (shape, bytes_per_px, halo, out_bytes_per_px) that gives
    the bytes (see :func:`frames_budget`)."""
    t = int(shape[0])
    px = math.prod(shape[1:])
    need = bytes_per_px * t * px
    if callable(budget):
        budget = budget(shape, bytes_per_px, halo, out_bytes_per_px)
    if budget is None:
        budget = memory_budget(device, need)
    if budget is None or need <= budget:
        chunk = t
    else:
        cap = group_size(t, px, bytes_per_px, device, None, out_bytes_per_px * t * px,
                         2 * halo, budget, MIN_CHUNK_FRAMES,
                         f"{what} of a {tuple(shape)} volume")
        chunk = -(-t // -(-t // cap))
    for log in _PLANS:
        log.append((what, t, chunk))
    return chunk


def frames_budget(frames):
    """A ``budget_bytes`` under which every step planned by
    :func:`chunk_plan` runs in time chunks of at most ``frames`` frames
    (and no fewer than ``MIN_CHUNK_FRAMES``), whatever its bytes per
    pixel: a function that gives each step the bytes of that many frames
    with its halos, beside its whole-volume outputs."""
    def budget(shape, bytes_per_px, halo, out_bytes_per_px):
        t, px = int(shape[0]), math.prod(shape[1:])
        return ((max(frames, MIN_CHUNK_FRAMES) + 2 * halo) * bytes_per_px
                + out_bytes_per_px * t) * px
    return budget


def time_chunks(t, chunk, halo=0):
    """(s, e, lo, hi) of each time chunk of ``chunk`` frames over ``t``:
    its frames [s, e) and, with ``halo`` frames each side within the
    volume, the frames [lo, hi) that it reads."""
    for s in range(0, t, chunk):
        e = min(t, s + chunk)
        yield s, e, max(0, s - halo), min(t, e + halo)


def run_chunked(what, fn, vols, device, budget=None, bytes_per_px=0, halo=0,
                out_bytes_per_px=0):
    """``fn`` over time chunks of the (T, ...) tensors ``vols`` (on
    ``device`` or waiting on the host; each chunk moves there): a tuple of
    (T, ...) outputs on ``device``, frames [s, e) of each chunk from the
    chunk read with ``halo`` frames each side (see :func:`chunk_plan`).
    ``fn`` takes the chunks of ``vols`` and returns a tuple of tensors
    over their frames; a stencil that reaches no further than ``halo``
    frames gives the whole volume's result."""
    t = vols[0].shape[0]
    chunk = chunk_plan(what, vols[0].shape, bytes_per_px, device, budget, halo,
                       out_bytes_per_px)
    if chunk >= t:
        return fn(*(v.to(device) for v in vols))
    outs = None
    for s, e, lo, hi in time_chunks(t, chunk, halo):
        parts = fn(*(v[lo:hi].to(device) for v in vols))
        if outs is None:
            outs = tuple(torch.empty((t,) + tuple(p.shape[1:]), dtype=p.dtype, device=device)
                         for p in parts)
        for out, part in zip(outs, parts):
            out[s:e] = part[s - lo:e - lo]
        del parts
    return outs


def place(x, device):
    """``x`` (array or tensor) on ``device`` where the card holds it within
    :func:`memory_budget`, else on the host (pinned).  On the CPU, a CPU
    tensor."""
    x = torch.as_tensor(x)
    device = torch.device(device)
    if x.device.type == device.type or device.type != "cuda":
        return x.to(device)
    need = x.numel() * x.element_size()
    budget = memory_budget(device, need)
    if budget >= need:
        return x.to(device)
    host = x.cpu()
    return host if host.is_pinned() else host.pin_memory()


def park(volumes, keep, device, need):
    """Move the card's tensors of the dict ``volumes`` whose names are not
    in ``keep`` to the host (pinned), largest first, until
    :func:`memory_budget` holds ``need`` bytes (a stage's whole-volume
    working set) or none is left on the card.  Returns the names moved."""
    device = torch.device(device)
    if device.type != "cuda":
        return []
    budget = memory_budget(device, need)
    moved = []
    order = sorted(volumes, key=lambda k: -volumes[k].numel() * volumes[k].element_size())
    for name in order:
        if budget >= need:
            break
        x = volumes[name]
        if name in keep or x.device.type != "cuda":
            continue
        volumes[name] = x.cpu().pin_memory()
        moved.append(name)
        del x
        budget = memory_budget(device, need)
    return moved


def _index(device):
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def reset_peak_memory(device) -> None:
    """Start a new high-water mark of ``device``'s allocated memory."""
    torch.cuda.reset_peak_memory_stats(device)
    _CARRIED[_index(device)] = 0


def peak_memory(device) -> int:
    """The most memory allocated on ``device`` since
    :func:`reset_peak_memory`, across the resets that ``stage`` makes to
    measure its own peaks (``torch.cuda.max_memory_allocated`` alone sees
    only the time since the last stage began)."""
    return max(torch.cuda.max_memory_allocated(device), _CARRIED.get(_index(device), 0))


def _carry(device):
    """Fold the allocator's peak so far into the open stages' and the
    device's high-water marks; returns it."""
    peak = torch.cuda.max_memory_allocated(device)
    idx = _index(device)
    _CARRIED[idx] = max(_CARRIED.get(idx, 0), peak)
    for frame in _OPEN:
        frame[0] = max(frame[0], peak)
    return peak


@contextmanager
def stage(name, stats, device):
    """Run the body inside the profiler range ``stage.{name}``.  With a
    ``stats`` dict, also record the stage's seconds as ``{name}_s`` (the
    device synchronised at its end) and its start and end on the Unix
    clock in ns (``time.time_ns``, the profiler's clock) as
    ``{name}_span_ns``; on CUDA also the memory allocated at its start,
    ``{name}_start_bytes``, and the most allocated during it,
    ``{name}_peak_bytes``; and, where it ran anything in time chunks
    (:func:`chunk_plan`), the most chunks of one of its steps,
    ``{name}_chunks``, and the fewest frames of one chunk,
    ``{name}_chunk_frames`` (1 and the volume's depth where nothing was
    chunked)."""
    cuda = stats is not None and device.type == "cuda"
    plans = []
    _PLANS.append(plans)
    if cuda:
        _carry(device)
        start_bytes = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        frame = [0]
        _OPEN.append(frame)
    t0, start_ns = time.perf_counter(), time.time_ns()
    try:
        with record_function(f"stage.{name}"):
            yield
            if stats is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                stats[f"{name}_s"] = time.perf_counter() - t0
                stats[f"{name}_span_ns"] = (start_ns, time.time_ns())
    finally:
        _PLANS[:] = [p for p in _PLANS if p is not plans]
        if stats is not None and plans:
            stats[f"{name}_chunks"] = max(-(-t // c) for _, t, c in plans)
            stats[f"{name}_chunk_frames"] = min(c for _, _, c in plans)
        if cuda:
            _OPEN[:] = [f for f in _OPEN if f is not frame]
            peak = _carry(device)
            stats[f"{name}_start_bytes"] = start_bytes
            stats[f"{name}_peak_bytes"] = max(frame[0], peak)
