"""How far the port's time-chunked flood, its whole-volume flood and the
flood's exact fixed point lie apart on the 12x128x128 mixed scene of the
JAX package's ``test_time_chunked_global_coarse_solve`` (3 chunks of 4
frames), on the CPU.

    PYTHONPATH=. python tools/torch_chunked_fixed_point.py [--threads 4]

Prints the label agreement of each pair among: the whole-volume flood
(label-only convergence, as ``watershed`` runs it), the exact fixed point
(the same flood run to full-state convergence), the chunked flood with
the reference's 8 passes, and the chunked flood run until a pass changes
nothing.  Takes about 5 minutes on 4 cores.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

from test_torch_watershed_chunked import SCENES  # noqa: E402

from tobac_flow_tpu_torch.ops import watershed as ws  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=4)
    torch.set_num_threads(ap.parse_args(argv).threads)
    fwd, bwd, field, markers = (torch.from_numpy(a) for a in SCENES["coarse"]())
    mask = torch.ones(field.shape, dtype=torch.bool)
    taps = ws._structure_taps_3d(ws.connectivity_structure(1))
    out = {}
    t0 = time.perf_counter()
    out["whole"] = ws.watershed(fwd, bwd, field, markers, device="cpu")
    prep = ws._ws_prep(field, markers, mask, fwd, bwd)
    state = ws._flood_state(
        prep[0], markers, mask, prep[1], prep[2], prep[3], taps,
        ws._band_radius_from_stats(prep[4]), max_iters=1 << 30, run_scans=True,
        multigrid=True, grace=1, label_only=False,
    )
    out["exact"] = ws._ws_decode(state[2], markers, mask)
    for name, passes in (("chunked, 8 passes", 8), ("chunked, converged", 64)):
        stats = {}
        out[name] = ws._watershed_time_chunked(
            field, markers, mask, fwd, bwd, taps, chunk_t=4, max_iters_cap=1 << 30,
            multigrid=True, run_scans=True, max_passes=passes, stats=stats)
        print(f"{name}: {stats['chunk_passes']} passes, {stats['chunk_floods']} chunk floods",
              flush=True)
    names = list(out)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            print(f"agreement {a} / {b}: {float((out[a] == out[b]).double().mean()):.6f}")
    print(f"{time.perf_counter() - t0:.1f} s on the CPU, {torch.get_num_threads()} threads")
    return 0


if __name__ == "__main__":
    sys.exit(main())
