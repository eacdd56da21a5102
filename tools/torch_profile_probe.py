"""Profile ``chip_smoke.py``'s chain (``cli.common.run_detection`` at
``chip_smoke.CHAIN_PROFILED``) twice in one process, through
``chip_smoke.profile_chain``, and print each cycle's per-stage lines: the
device ops launched in each stage's host span, and how many of them the
device's own clock places outside that span.  A check of the profiler's
clocks from one cycle to the next; it needs an NVIDIA GPU.

    python3 tools/torch_profile_probe.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main():
    card_line = cs.card()
    cs.log(f"card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    cs.ws_sweeps.build_library()
    device = torch.device("cuda", 0)
    for cycle in range(2):
        ms, launches = cs.profile_chain(device, card_line)
        cs.log(f"cycle {cycle}: the sweep kernel {launches} launches, {ms:.3f} ms")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_probe: needs an NVIDIA GPU")
    main()
