"""CLI: combine multiple detected-DCC files with the streaming two-file
linker (counterpart of ``tobac_flow_tpu/cli/combine_dccs.py``, with the
same arguments and files, and ``--device``).

Usage: python -m tobac_flow_tpu_torch.cli.combine_dccs -sd OUT detected_*.nc
(on the card), or with ``--device cpu``.  Reading and writing the files
needs h5py.
"""

from __future__ import annotations

import argparse

from tobac_flow_tpu_torch.data.ncdataset import require_h5py
from tobac_flow_tpu_torch.track.file_linker import FileLinker


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-sd", help="Directory to save output files", default=None)
    parser.add_argument("--file_suffix", help="Suffix to save files under", default="")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    parser.add_argument("files", help="List of files to combine", nargs="+", type=str)
    args = parser.parse_args(argv)
    require_h5py("combine_dccs")

    linker = FileLinker(
        sorted(args.files),
        output_path=args.sd,
        output_file_suffix=args.file_suffix,
        device=args.device,
    )
    return linker.process_files()


if __name__ == "__main__":
    main()
