"""CLI: stream-link consecutive detection files and write relabelled outputs
(counterpart of ``tobac_flow_tpu/cli/link_dcc_files.py``, with the same
arguments and files, and ``--device``).

Usage: python -m tobac_flow_tpu_torch.cli.link_dcc_files -sd OUT detected_*.nc
(on the card), or with ``--device cpu`` for the plain PyTorch path.

With ``--linker label`` the pointer-convergence ``LabelLinker`` is used
instead of the streaming two-file ``FileLinker``.  Reading and writing the
files needs h5py.
"""

from __future__ import annotations

import argparse
import pathlib

from tobac_flow_tpu_torch.data.ncdataset import require_h5py
from tobac_flow_tpu_torch.track.file_linker import FileLinker, LabelLinker


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("-atol", default=5, type=int)
    parser.add_argument("-rtol", default=0.5, type=float)
    parser.add_argument(
        "--linker", default="file", choices=("file", "label"),
        help="file = streaming two-file linker, label = pointer-convergence map",
    )
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    parser.add_argument("files", nargs="+", type=str)
    args = parser.parse_args(argv)
    require_h5py("link_dcc_files")

    files = sorted(pathlib.Path(f) for f in args.files)
    if args.linker == "label":
        linker = LabelLinker(files, output_path=args.sd, atol=args.atol, rtol=args.rtol,
                             device=args.device)
        linker.link_all()
        outputs = linker.output_files()
    else:
        linker = FileLinker(files, args.sd, atol=args.atol, rtol=args.rtol, device=args.device)
        outputs = linker.process_files()
    print(f"{len(outputs)} linked files saved to {args.sd}", flush=True)
    return outputs


if __name__ == "__main__":
    main()
