"""Time the three forms of the floods' temporal scatter-min
(``tobac_flow_tpu_torch/ops/watershed.py``: ``_scatter_min_dense``,
``_scatter_min_shifts`` and ``_scatter_min_waves``) on the card, each
twice in turns (dense, shifts, waves, waves, shifts, dense), on a frame
and a 6-frame volume of 1500x2500 with noise displacements (every shift
of the band taken) and smooth ones (3 to 17 shifts), and check that they
give the same bits.  Prints each case's milliseconds, the taken y shifts
and which form ``_banded_scatter_min`` picks; the cost constants in
``ops/watershed.py`` come from these times.

    python3 tools/torch_scatter_min_forms.py
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tobac_flow_tpu_torch.ops import watershed as ws  # noqa: E402
from tobac_flow_tpu_torch.ops.ws_sweeps import META_MAX  # noqa: E402

RADIUS = 20
CASES = ((20, False), (3, True), (1, True), (8, True))  # (spread px, smooth)
SHAPES = ((1500, 2500), (6, 1500, 2500))


def inputs(shape, spread, smooth, g, dev):
    """Claims with 30 % unclaimed cells, and displacements within
    ±``spread``: drawn at random, or a smooth field (few shifts)."""
    cost = torch.rand(shape, device=dev, generator=g)
    meta = torch.randint(2, 40, shape, device=dev, dtype=torch.int32, generator=g)
    meta[torch.rand(shape, device=dev, generator=g) < 0.3] = META_MAX
    if smooth:
        yy = torch.linspace(0, 6.28, shape[-2], device=dev).view(-1, 1)
        xx = torch.linspace(0, 6.28, shape[-1], device=dev).view(1, -1)
        dy = (spread * torch.sin(yy + xx)).round().to(torch.int32).expand(shape).contiguous()
        dx = (spread * torch.cos(yy - xx)).round().to(torch.int32).expand(shape).contiguous()
    else:
        dy = torch.randint(-spread, spread + 1, shape, device=dev, dtype=torch.int32, generator=g)
        dx = torch.randint(-spread, spread + 1, shape, device=dev, dtype=torch.int32, generator=g)
    return cost, cost.clone(), meta, dy, dx


def timed(fn, reps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch_scatter_min_forms: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(0)
    for shape in SHAPES:
        for spread, smooth in CASES:
            args = inputs(shape, spread, smooth, g, dev)
            keyed = ws._shift_keys(args[3], args[2] != META_MAX, RADIUS)

            forms = {
                "dense": lambda: ws._scatter_min_dense(*args, RADIUS, keyed[1]),
                "shifts": lambda: ws._scatter_min_shifts(*args, RADIUS, keyed),
                "waves": lambda: ws._scatter_min_waves(*args, RADIUS, keyed),
            }
            reps = 5 if len(shape) == 2 else 2
            times, outs = {}, {}
            for name in list(forms) + list(forms)[::-1]:
                forms[name]()  # warm-up
                ms, outs[name] = timed(forms[name], reps)
                times.setdefault(name, []).append(ms)
            for name, out in outs.items():
                if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                           for x, y in zip(out, outs["dense"])):
                    raise AssertionError(f"{name} differs from dense at {shape}, spread {spread}")
            costs = ws._scatter_min_costs(len(keyed[1]), args[0].numel())
            picks = list(forms)[costs.index(min(costs))]
            print(f"{shape} spread {spread} {'smooth' if smooth else 'noise'} "
                  f"({len(keyed[1])} y shifts): " + "; ".join(
                      f"{k} {t[0]:.1f}, {t[1]:.1f} ms" for k, t in times.items())
                  + f"; equal; picks {picks} [{card}]", flush=True)


if __name__ == "__main__":
    main()
