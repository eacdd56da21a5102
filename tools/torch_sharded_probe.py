"""Run ``chip_smoke.py``'s phase 16 alone (``chip_smoke.check_sharded``, the
sharded chain on a (2, 2) mesh of ranks) and then check and time the
kernel at the shape classes its floods launched, as the script does.  On
one card the four ranks share it over gloo; on four cards each rank has
its own, over NCCL.

    python3 tools/torch_sharded_probe.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main():
    card_line = cs.card()
    cs.log(f"card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.device_count()} card(s)")
    t0 = time.perf_counter()
    cs.ws_sweeps.build_library()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda", 0)
    given, own, small = cs.check_sharded(device, card_line)
    per_shape = {}
    worst = cs.check_and_time_new_shapes({**given, **own, **small}, per_shape, device, card_line)
    for key, row in per_shape.items():
        cs.log(f"shape {key}: {row['ms']:.4f} ms cold, bound {row['bound_ms']:.4f} ms "
               f"({row['bound_by']}), plain {row['plain_ms']:.3f} ms; launches: given "
               f"{given.get(key, 0)}, own {own.get(key, 0)}, small {small.get(key, 0)}")
    cs.log(f"worst |kernel - plain| {worst}")


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("torch_sharded_probe: needs an NVIDIA GPU")
    main()
