"""CLI: link labels across consecutive detection files in parallel
(counterpart of ``tobac_flow_tpu/cli/linking_parallel.py``, with the same
arguments and links file, and ``--device``): the overlaps between each
file pair are computed, resolved into a global links dataset and saved.

Usage: python -m tobac_flow_tpu_torch.cli.linking_parallel -sd OUT detected_*.nc
(on the card), or with ``--device cpu``.  Reading and writing the files
needs h5py.

With ``-p N`` the files of N pairs at a time are read in N threads, and
each pair's overlap is counted on the device in this process (a forked
process could not use the card once this one has).
"""

from __future__ import annotations

import argparse
import pathlib
from concurrent.futures import ThreadPoolExecutor

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.data.ncdataset import open_dataset, require_h5py
from tobac_flow_tpu_torch.device import resolve_device
from tobac_flow_tpu_torch.track.linking import (
    find_overlap_between_files,
    process_linking_output,
)
from tobac_flow_tpu_torch.track.store import MemoryStore


def _overlaps(pairs, device, processes):
    """Each pair's core and anvil overlaps, counted on ``device``; with
    ``processes`` > 1 that many pairs' files are read at a time, in as
    many threads."""
    if not processes or processes <= 1:
        return [find_overlap_between_files(a, b, device=device) for a, b in pairs]

    def read(pair):
        return MemoryStore({str(f): open_dataset(f) for f in pair})

    results = []
    with ThreadPoolExecutor(processes) as pool:
        for i in range(0, len(pairs), processes):
            batch = pairs[i:i + processes]
            for (a, b), store in zip(batch, pool.map(read, batch)):
                results.append(find_overlap_between_files(a, b, device=device, store=store))
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("-p", default=None, type=int, help="Number of processes")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    parser.add_argument("files", nargs="+", type=str)
    args = parser.parse_args(argv)
    require_h5py("linking_parallel")
    device = resolve_device(args.device)

    files = sorted(pathlib.Path(f) for f in args.files)
    pairs = list(zip(files[:-1], files[1:]))
    if not pairs:
        raise SystemExit("need at least two files to link")

    links = process_linking_output(_overlaps(pairs, device, args.p))

    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    start = files[0].stem.split("_S")[-1][:15]
    end = files[-1].stem.split("_E")[-1][:15] if "_E" in files[-1].stem else "end"
    save_path = save_dir / f"dcc_links_S{start}_E{end}.nc"
    save_dataset(links, save_path)
    return save_path


if __name__ == "__main__":
    main()
