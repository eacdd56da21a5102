"""The detection pipeline of the ingest CLIs (counterpart of
``tobac_flow_tpu/cli/common.py``): the detection chain
(``detect/chain.run_detection``: flow, cores, anvil markers, thick anvils
and their relabelling, thin anvils), then the output stages: the schema
(label coordinates, the core-anvil link that paints cores into both anvil
volumes, step labels, step links, edge and NaN flags), the label
properties and the field properties, into a :class:`Dataset` written as
netCDF with compression through a ``.temp.nc`` rename.

Everything runs on ``device`` (CUDA unless the caller passes
``device="cpu"``): the label volumes and fields stay there from the chain
to the end of the field properties (a field the card cannot hold beside
them waits on the host, pinned, and is read a chunk of frames at a time:
``device.place``), and cross to the host once, when the dataset is
returned.  ``budget_bytes`` goes to every stage, whose passes
over a volume run in time chunks over it (see ``device.chunk_plan``).
The stages ``schema``, ``label_props`` and ``field_props`` are timed and
profiled as the chain's are (``device.stage``).
"""

from __future__ import annotations

import os
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from tobac_flow_tpu_torch.data.ncdataset import (
    DataArray, Dataset, as_tensor, open_dataset, require_h5py,
)
from tobac_flow_tpu_torch.detect import chain
from tobac_flow_tpu_torch.detect.analysis import get_label_stats, weighted_statistics_on_labels
from tobac_flow_tpu_torch.detect.chain import DetectionOptions
from tobac_flow_tpu_torch.device import place, resolve_device, stage
from tobac_flow_tpu_torch.schema import (
    add_label_coords,
    add_step_labels,
    calculate_label_properties,
    flag_edge_labels,
    flag_nan_adjacent_labels,
    link_cores_and_anvils,
    link_step_labels,
)

__all__ = ["DetectionOptions", "OUTPUT_STAGES", "prepare_output", "run_detection",
           "save_dataset"]

OUTPUT_STAGES = ("schema", "label_props", "field_props")

# a label volume keeps its field's attrs but these, as the reference's
# detection functions do
_DROP_ATTRS = ("standard_name", "units", "valid_range", "_FillValue", "missing_value",
               "cell_methods", "units_metadata")


def _label_array(labels, template, long_name):
    attrs = {k: v for k, v in template.attrs.items() if k not in _DROP_ATTRS}
    attrs.update(long_name=long_name, units="", cell_measures="area: area")
    return DataArray(labels, coords=dict(template.coords), dims=template.dims, attrs=attrs)


def _on_device(da, device):
    """``da`` with its data on ``device`` where the card holds it, else
    waiting on the host (see ``device.place``)."""
    return DataArray(place(as_tensor(da), device), coords=da.coords, dims=da.dims,
                     name=da.name, attrs=da.attrs)


def run_detection(bt, wvd, swd, dataset: Dataset, start_date=None, end_date=None,
                  opts: DetectionOptions | None = None, device=None,
                  stats: dict | None = None, budget_bytes=None) -> Dataset:
    """The full DCC detection of the BT, WVD and SWD DataArrays (t, y, x)
    into ``dataset``, on ``device`` (see :func:`resolve_device`).

    ``stats``, a dict, receives each stage's seconds, host span and (for
    the chain's) objects, as ``detect/chain.run_detection`` records them,
    for the chain's stages and :data:`OUTPUT_STAGES`, with their time
    chunks.  ``budget_bytes`` goes to every stage (``None``:
    ``device.memory_budget`` at each step's start, no chunks on the CPU).
    With ``opts.checkpoint_path`` the dataset with the core labels is written
    there and read back, as the reference does: then h5py must be
    importable, which is checked before the chain starts.  Returns the
    dataset, holding numpy."""
    opts = DetectionOptions() if opts is None else opts
    if opts.checkpoint_path:
        require_h5py("run_detection with a checkpoint_path")
    dev = resolve_device(device)

    print(datetime.now(), "Detecting cores and anvils", flush=True)
    flow = None
    if opts.flow_factory is not None:
        with stage("flow", stats, dev):
            flow = opts.flow_factory(bt)
    # the chain holds the only references to the fields it was given, so
    # that the volumes it moves to the host free the card
    labels = chain.run_detection(*(place(as_tensor(da), dev) for da in (bt, wvd, swd)),
                                 bt.coords["t"], opts=opts, flow=flow, device=dev,
                                 stats=stats, budget_bytes=budget_bytes)
    fields = [DataArray(x, coords=da.coords, dims=da.dims, name=da.name, attrs=da.attrs)
              for x, da in zip(labels.pop("fields"), (bt, wvd, swd))]
    print("Detected cores, thick anvils, thin anvils: n =", ", ".join(
        str(int(labels[k].max())) for k in ("core_label", "thick_anvil_label",
                                             "thin_anvil_label")), flush=True)
    dataset["core_label"] = _label_array(labels["core_label"], bt,
                                         "Labels of detected core regions")
    checkpoint = Path(opts.checkpoint_path) if opts.checkpoint_path else None
    if checkpoint is not None:
        if opts.save_bt:
            dataset["bt"] = bt
        dataset.to_netcdf(checkpoint, compress=True, complevel=5)
        print(datetime.now(), "Checkpointed core labels to", checkpoint, flush=True)
        dataset = open_dataset(checkpoint)
        checkpoint.unlink()
    dataset["thick_anvil_label"] = _label_array(labels["thick_anvil_label"], wvd,
                                                "Labels of detected thick anvil regions")
    if opts.save_anvil_markers:
        dataset["anvil_marker_label"] = _label_array(labels["anvil_marker_label"], wvd,
                                                     "labels for anvil markers")
    dataset["thin_anvil_label"] = _label_array(labels["thin_anvil_label"], wvd,
                                               "Labels of detected thin anvil regions")
    del labels
    return prepare_output(dataset, *fields, start_date, end_date, opts, dev, stats,
                          budget_bytes)


def prepare_output(dataset: Dataset, bt, wvd, swd, start_date=None, end_date=None,
                   opts: DetectionOptions | None = None, device=None,
                   stats: dict | None = None, budget_bytes=None) -> Dataset:
    """The output stages of :func:`run_detection` on a dataset that holds
    ``core_label``, ``thick_anvil_label`` and ``thin_anvil_label``, on
    ``device`` (see :func:`resolve_device`; the label volumes move there,
    the fields where the card holds them) with ``budget_bytes`` (see
    :func:`run_detection`).  Returns the dataset, holding numpy."""
    opts = DetectionOptions() if opts is None else opts
    dev = resolve_device(device)
    for name in ("core_label", "thick_anvil_label", "thin_anvil_label"):
        dataset[name].data = as_tensor(dataset[name], dev)
    bt, wvd, swd = (_on_device(da, dev) for da in (bt, wvd, swd))

    print(datetime.now(), "Preparing output", flush=True)
    budget = budget_bytes  # every stage's
    with stage("schema", stats, dev):
        dataset = add_label_coords(dataset, budget)
        link_cores_and_anvils(dataset, budget_bytes=budget)
        add_step_labels(dataset, budget)
        dataset = add_label_coords(dataset, budget)
        link_step_labels(dataset, budget)
        flag_edge_labels(dataset, start_date, end_date)
        flag_nan_adjacent_labels(dataset, wvd, budget)

    if opts.save_label_props:
        with stage("label_props", stats, dev):
            calculate_label_properties(dataset, budget)
    if opts.save_spatial_props:
        for name in ("core_label", "thick_anvil_label", "thin_anvil_label"):
            get_label_stats(dataset[name], dataset, budget)
    if opts.save_field_props:
        if "area" in dataset:
            weights = as_tensor(dataset["area"], dev)
        else:
            weights = torch.ones((), dtype=bt.data.dtype, device=dev)
        with stage("field_props", stats, dev):
            for field in (bt, wvd, swd):
                for label_name, name, dim in [
                    ("core_label", "core", "core"),
                    ("thick_anvil_label", "thick_anvil", "anvil"),
                    ("thin_anvil_label", "thin_anvil", "anvil"),
                    ("core_step_label", "core_step", "core_step"),
                    ("thick_anvil_step_label", "thick_anvil_step", "thick_anvil_step"),
                    ("thin_anvil_step_label", "thin_anvil_step", "thin_anvil_step"),
                ]:
                    for da in weighted_statistics_on_labels(
                        dataset[label_name], field, weights, name=name, dim=dim,
                        dtype=np.float32, budget_bytes=budget,
                    ):
                        dataset[da.name] = da
    if opts.save_bt:
        dataset["bt"] = bt
    if opts.save_wvd:
        dataset["wvd"] = wvd
    if opts.save_swd:
        dataset["swd"] = swd
    return dataset.load()


def save_dataset(dataset: Dataset, save_path) -> None:
    """Write through a ``.temp.nc`` file renamed into place."""
    save_path = Path(save_path)
    temp_path = save_path.with_suffix(".temp.nc")
    dataset.to_netcdf(temp_path, compress=True, complevel=5)
    os.replace(temp_path, save_path)
    print(datetime.now(), "Saved to", save_path, flush=True)
