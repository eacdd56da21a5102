"""CLI: post-process detected DCCs with per-object statistics from an
auxiliary field file (counterpart of
``tobac_flow_tpu/cli/postprocess_dcc.py``, with the same arguments and
file, and ``--device`` and ``-flags``): weighted per-label statistics of
the requested variables (with their uncertainties where the field file
holds ``{var}_uncertainty``), optionally the CRE fields first, the
weighted proportions of flag variables, then the object properties and
validity flags.

Usage: python -m tobac_flow_tpu_torch.cli.postprocess_dcc DETECTED.nc \
    -fields FIELDS.nc -vars ctt cth toa_net_cre --cre -sd OUT
(on the card), or with ``--device cpu``.  Reading and writing the files
needs h5py; :func:`postprocess_dataset` does the work on Datasets in
memory.
"""

from __future__ import annotations

import argparse
import pathlib
from datetime import datetime

from tobac_flow_tpu_torch.cli.common import save_dataset
from tobac_flow_tpu_torch.cli.relabel_postprocess import LABELS, labels_to, pixel_weights
from tobac_flow_tpu_torch.data.ncdataset import open_dataset, require_h5py
from tobac_flow_tpu_torch.device import resolve_device, stage
from tobac_flow_tpu_torch.schema.postprocess import (
    add_cre_to_dataset,
    add_validity_flags,
    add_weighted_proportions_to_dataset,
    add_weighted_stats_to_dataset,
    process_core_properties,
    process_thick_anvil_properties,
    process_thin_anvil_properties,
)

FAMILIES = [
    ("core", "core"),
    ("anvil", "thick_anvil"),
    ("anvil", "thin_anvil"),
    ("core_step", "core_step"),
    ("thick_anvil_step", "thick_anvil_step"),
    ("thin_anvil_step", "thin_anvil_step"),
]


def postprocess_dataset(dataset, fields=None, variables=(), cre=False, flags=(), device=None,
                        budget_bytes=None, stats=None):
    """The CLI's work: on ``device`` (CUDA by default), with the field
    Dataset ``fields`` (its CRE fields added first with ``cre``), each of
    ``variables`` and ``flags`` aggregated over every label family that
    ``dataset`` holds, weighted by the pixel areas (H, W) or ones; then the
    core, thick and thin anvil properties and the validity flags.  Each
    step runs in ``device.stage`` (``stats``: ``cre``, ``field_stats``,
    ``proportions``, ``properties``) under ``budget_bytes``.  Returns
    ``dataset``."""
    dev = resolve_device(device)
    if fields is not None:
        labels_to(dataset, dev, LABELS + tuple(f"{name}_label" for _, name in FAMILIES[3:]))
        if cre:
            with stage("cre", stats, dev):
                fields = add_cre_to_dataset(fields)
        weights = pixel_weights(dataset, dev)
        families = [(dim, name) for dim, name in FAMILIES if f"{name}_label" in dataset]
        with stage("field_stats", stats, dev):
            for var in variables:
                for dim, dim_name in families:
                    add_weighted_stats_to_dataset(dataset, fields, weights, var, dim,
                                                  dim_name=dim_name, budget_bytes=budget_bytes)
        with stage("proportions", stats, dev):
            for var in flags:
                for dim, dim_name in families:
                    add_weighted_proportions_to_dataset(dataset, fields[var], weights, dim,
                                                        dim_name=dim_name,
                                                        budget_bytes=budget_bytes)

    print(datetime.now(), "Aggregating object properties", flush=True)
    with stage("properties", stats, dev):
        dataset = process_core_properties(dataset, device=dev)
        dataset = process_thick_anvil_properties(dataset, device=dev)
        dataset = process_thin_anvil_properties(dataset, device=dev)
        dataset = add_validity_flags(dataset, device=dev)
    return dataset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("file", help="Detection netCDF file")
    parser.add_argument("-fields", default=None, help="Auxiliary field netCDF file")
    parser.add_argument("-vars", nargs="*", default=[], help="Variables to aggregate")
    parser.add_argument("-flags", nargs="*", default=[],
                        help="Flag variables (with flag_values) whose weighted proportions "
                             "to aggregate")
    parser.add_argument("--cre", action="store_true", help="Compute CRE fields first")
    parser.add_argument("-sd", default=".", help="Directory to save output")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    args = parser.parse_args(argv)
    require_h5py("postprocess_dcc")

    dataset = open_dataset(args.file)
    fields = open_dataset(args.fields) if args.fields else None
    dataset = postprocess_dataset(dataset, fields, args.vars, args.cre, args.flags, args.device)

    save_dir = pathlib.Path(args.sd)
    save_dir.mkdir(parents=True, exist_ok=True)
    out = save_dir / pathlib.Path(args.file).name.replace(
        "detected_", "postprocessed_"
    )
    save_dataset(dataset, out)
    return out


if __name__ == "__main__":
    main()
