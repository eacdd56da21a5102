"""Connected-component labelling of frame stacks on the device (counterpart
of ``tobac_flow_tpu/ops/ccl.py``).

Components are per frame (no temporal connectivity), over the in-plane
part of the structuring element.  Each masked pixel starts with its
volume-raveled index + 1; rounds of neighbour-minimum propagation, each
followed by pointer jumping (a pixel takes the label of the pixel its
label names), run until a round changes nothing.  Labels only decrease and
always name a pixel of the same component, so every component ends at its
smallest raveled index.  Sorting those roots numbers the components 1..N
frame-major by each one's first raster pixel: scipy's partition and
numbering, with no cap on the component count.  Over the device budget,
``flat_label`` labels groups of frames and carries each group's count on
to the next, which gives the whole volume's numbering.
"""

from __future__ import annotations

import numpy as np
import torch

from tobac_flow_tpu_torch.device import LABEL_BYTES_PER_PX, chunk_plan, time_chunks
from tobac_flow_tpu_torch.ops.convolve import DEFAULT_STRUCTURE
from tobac_flow_tpu_torch.ops.warp import shift

__all__ = ["label_components", "relabel_sequential", "flat_label"]

_JUMPS = 2  # pointer jumps per round


def _plane_offsets(structure):
    """In-plane neighbour offsets (oy, ox) of a (3, 3, 3) or (3, 3)
    structuring element, excluding the centre."""
    structure = np.asarray(structure)
    if structure.shape == (3, 3, 3):
        plane = structure[1]
    elif structure.shape == (3, 3):
        plane = structure
    else:
        raise ValueError("structure must be (3,3,3) or (3,3)")
    return tuple((int(r) - 1, int(c) - 1) for r, c in zip(*np.nonzero(plane))
                 if not (r == 1 and c == 1))


def label_components(mask, structure=DEFAULT_STRUCTURE):
    """Per-frame components of a (T, H, W) boolean mask: each pixel of a
    component holds the smallest volume-raveled index + 1 of its pixels; 0
    is background."""
    mask = mask.to(torch.bool)
    offsets = _plane_offsets(structure)
    n = mask.numel()
    dtype = torch.int32 if n + 1 < 2**31 else torch.int64
    big = n + 1
    labels = torch.where(
        mask, torch.arange(1, n + 1, dtype=dtype, device=mask.device).view(mask.shape), big
    )
    big_t = torch.full((), big, dtype=dtype, device=mask.device)
    while True:
        new = labels
        for oy, ox in offsets:
            new = torch.minimum(new, shift(labels, oy, ox, big))
        new = torch.where(mask, new, big_t)
        for _ in range(_JUMPS):
            flat = new.reshape(-1)
            jumped = flat[(flat.clamp(max=n) - 1).long()].view(mask.shape)
            new = torch.where(mask, jumped, big_t)
        if torch.equal(new, labels):
            break
        labels = new
    return torch.where(mask, labels, 0)


def relabel_sequential(raw):
    """Component roots renumbered 1..N in increasing order (0 stays 0), as
    int32."""
    out = torch.zeros(raw.shape, dtype=torch.int32, device=raw.device)
    fg = raw > 0
    _, inverse = torch.unique(raw[fg], sorted=True, return_inverse=True)
    out[fg] = inverse.to(torch.int32) + 1
    return out


def flat_label(mask, structure=DEFAULT_STRUCTURE, dtype=torch.int32, device=None,
               budget_bytes=None):
    """Connected components of a (T, H, W) mask (a tensor) that do not
    connect across time, numbered 1..N as scipy numbers them frame by
    frame, on ``device`` (the mask's by default).  Over ``budget_bytes``
    (``None``: ``device.memory_budget``, no chunks on the CPU) in groups of
    frames, each numbered on from the last."""
    device = mask.device if device is None else torch.device(device)
    t = mask.shape[0]
    chunk = chunk_plan("flat_label", mask.shape, LABEL_BYTES_PER_PX, device, budget_bytes,
                       0, torch.empty((), dtype=dtype).element_size())
    if chunk >= t:
        return relabel_sequential(label_components(mask.to(device) != 0, structure)).to(dtype)
    out = torch.empty(mask.shape, dtype=dtype, device=device)
    count = 0
    for s, e, _, _ in time_chunks(t, chunk):
        part = relabel_sequential(label_components(mask[s:e].to(device) != 0, structure))
        n = int(part.max()) if part.numel() else 0
        out[s:e] = torch.where(part > 0, part + count, 0).to(dtype)
        count += n
        del part
    return out
