"""CLI: apply a links dataset to detection files, rewriting their labels to
the globally-linked ids (counterpart of
``tobac_flow_tpu/cli/relabel_linked_files.py``, with the same arguments and
files, and ``--device``).

Usage: python -m tobac_flow_tpu_torch.cli.relabel_linked_files -links LINKS.nc -sd OUT detected_*.nc
(on the card), or with ``--device cpu``.  Reading and writing the files
needs h5py.
"""

from __future__ import annotations

import argparse
import pathlib

from tobac_flow_tpu_torch.data.ncdataset import open_dataset, require_h5py
from tobac_flow_tpu_torch.track.linking import relabel_file


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-links", required=True, help="Links netCDF file")
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    parser.add_argument("files", nargs="+", type=str)
    args = parser.parse_args(argv)
    require_h5py("relabel_linked_files")

    links = open_dataset(args.links)
    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    outputs = []
    for f in args.files:
        f = pathlib.Path(f)
        out = save_dir / f.name.replace("detected_", "relabeled_")
        relabel_file(f, links, save_path=out, device=args.device)
        print("relabeled", f, "->", out, flush=True)
        outputs.append(out)
    return outputs


if __name__ == "__main__":
    main()
