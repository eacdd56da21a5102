"""The GOES phase of ``chip_smoke.py`` alone, on one NVIDIA GPU, for other
choices of the scene's missing frames.

    python3 tools/torch_goes_probe.py [--small] 7,8,9 [4,5,6 ...]

For each comma-separated set of missing frames, ``chip_smoke.run_goes``
on ``make_multistorm_scene(11, 1500, 2500)`` less those frames: the port's
in-memory ingest, then ``cli.common.run_detection`` on the card, each
stage's seconds, peak and objects and the kernel's launches; a set at
which a stage finds no object is reported and the next one tried.  With
``--small``, first the card against the CPU on the CPU tests' GOES scene
(``chip_smoke.check_goes_small``).  Last, the kernel against its plain
version and timed at the shape classes of the last run that completed.
Every figure is printed with the card's name and power limit.  Run from
the repo root.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from tobac_flow_tpu_torch.ops import ws_sweeps  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("missing", nargs="+", help="missing frames, e.g. 7,8,9")
    parser.add_argument("--small", action="store_true",
                        help="first hold the card against the CPU on the small scene")
    args = parser.parse_args(argv)
    device = torch.device("cuda", 0)
    card_line = cs.card()
    cs.log(f"card: {card_line}")
    ws_sweeps.build_library()
    if args.small:
        with cs.cpu_legs() as legs:
            cs.check_goes_small(device, card_line, legs)()
    by_shape = None
    for missing in args.missing:
        cs.GOES_MISSING = tuple(int(i) for i in missing.split(","))
        try:
            by_shape = cs.run_goes(device, card_line)[1]
        except AssertionError as err:
            cs.log(f"frames {cs.GOES_MISSING} missing: {err}")
    if by_shape is None:
        return 1
    per_shape = {}
    cs.check_and_time_new_shapes(by_shape, per_shape, device, card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
