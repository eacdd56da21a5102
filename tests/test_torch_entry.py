"""The port's entry points run on the card unless the caller asks for the
CPU: without ``device`` they raise where CUDA is not available, and with
``device="cpu"`` they take numpy arrays and return CPU tensors.  Tiny
shapes; no JAX."""

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several test processes side by side, and
# torch's default thread pool per process oversubscribes the cores
torch.set_num_threads(1)

from tobac_flow_tpu_torch import (  # noqa: E402
    Flow, create_flow, device_flow, fused_flow_watershed, run_detection, watershed,
)
import time  # noqa: E402

from tobac_flow_tpu_torch.device import resolve_device, stage  # noqa: E402
from tobac_flow_tpu_torch.parallel import make_mesh  # noqa: E402
from tobac_flow_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from tobac_flow_tpu_torch.parallel.launch import launch, layout  # noqa: E402
from tests.torch_parallel_cases import mesh_facts, uneven_tile  # noqa: E402

T, H, W = 3, 12, 16


def _ws_args():
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 1, (T, H, W, 2)).astype(np.float32)
    field = rng.uniform(0, 1, (T, H, W)).astype(np.float32)
    markers = np.zeros((T, H, W), np.int32)
    markers[:, 2, 3], markers[:, 9, 12] = 1, 2
    return flow, -flow, field, markers


ENTRIES = ["fused_flow_watershed", "device_flow", "watershed", "create_flow",
           "run_detection", "Flow.from_numpy", "detect_legacy", "get_curvature_filter",
           "get_peak_filter", "get_watershed_mask", "flow_network_watershed", "flow_label",
           "get_nexrad_hist", "get_3d_nexrad_hist", "regrid_nexrad", "grid_nexrad",
           "regrid_latlon_to_abi", "grid_flux", "bin_to_latlon", "grid_flux_native",
           "make_mesh", "launch", "dryrun_multichip"]


def _grid():
    """A small GOES-16 fixed-grid Dataset of the port's, and a flux Dataset."""
    from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset

    ds = Dataset(coords={"y": 0.05 - np.arange(H) * 56e-6, "x": 0.02 + np.arange(W) * 56e-6})
    ds["goes_imager_projection"] = DataArray(np.zeros((), np.int32), dims=(), attrs={
        "semi_major_axis": 6378137.0, "semi_minor_axis": 6356752.31414,
        "perspective_point_height": 35786023.0, "longitude_of_projection_origin": -75.0})
    src = Dataset(coords={"t": np.asarray([np.datetime64("2020-06-01", "ns")])})
    for name, v in (("lat", np.full(5, 30.0)), ("lon", np.full(5, -70.0)),
                    ("toa_swup", np.ones(5))):
        src[name] = DataArray(v, dims=("pix",))
    return ds, src


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bt = np.full((T, H, W), 250.0, np.float32)
    times = np.arange(T) * np.timedelta64(300, "s") + np.datetime64("2020-06-01", "ns")
    flow = np.zeros((T, H, W, 2), np.float32)
    from tobac_flow_tpu_torch import legacy
    from tobac_flow_tpu_torch.cli import grid_flux, grid_flux_native, grid_nexrad
    from tobac_flow_tpu_torch.cli.dcc_detect_legacy import detect_legacy
    from tobac_flow_tpu_torch.data import nexrad
    from tobac_flow_tpu_torch.detect import detection

    grid, src = _grid()
    gates = (np.full(4, 30.0), np.full(4, -70.0), np.zeros(4), np.full(4, 20.0))
    call = {
        "detect_legacy": lambda: detect_legacy(bt, bt - 260, bt - 250, times),
        "get_curvature_filter": lambda: detection.get_curvature_filter(bt),
        "get_peak_filter": lambda: detection.get_peak_filter(bt),
        "get_watershed_mask": lambda: detection.get_watershed_mask(bt),
        "flow_network_watershed": lambda: legacy.flow_network_watershed(
            bt, np.ones((T, H, W), np.int32), flow, flow),
        "flow_label": lambda: legacy.flow_label(bt > 0, flow, flow),
        "get_nexrad_hist": lambda: nexrad.get_nexrad_hist(*gates[:2], gates[3], grid),
        "get_3d_nexrad_hist": lambda: nexrad.get_3d_nexrad_hist(*gates[:3], gates[3], grid),
        "regrid_nexrad": lambda: nexrad.regrid_nexrad([gates], grid),
        "grid_nexrad": lambda: grid_nexrad.grid_nexrad(grid, [gates]),
        "regrid_latlon_to_abi": lambda: grid_flux.regrid_latlon_to_abi(
            gates[3], gates[0], gates[1], grid),
        "grid_flux": lambda: grid_flux.grid_flux(grid, src, ["toa_swup"]),
        "bin_to_latlon": lambda: grid_flux_native.bin_to_latlon(
            gates[3], gates[0], gates[1], np.arange(-90.0, 91.0), np.arange(-180.0, 181.0)),
        "grid_flux_native": lambda: grid_flux_native.grid_flux_native([src]),
        "fused_flow_watershed": lambda: fused_flow_watershed(bt, 5.0),
        "device_flow": lambda: device_flow(bt),
        "watershed": lambda: watershed(*_ws_args()),
        "create_flow": lambda: create_flow(bt, vr_steps=1, smoothing_passes=1,
                                           interp_method="cubic"),
        "run_detection": lambda: run_detection(bt, bt - 260, bt - 250, times),
        "Flow.from_numpy": lambda: Flow.from_numpy(flow, flow),
        "make_mesh": lambda: make_mesh(1, 1),
        "launch": lambda: launch(mesh_facts, 1, 2),
        "dryrun_multichip": lambda: dryrun_multichip(2),
    }[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


def test_cpu_when_asked():
    labels = watershed(*_ws_args(), device="cpu")
    assert labels.device.type == "cpu" and labels.dtype == torch.int32
    same = watershed(*(torch.from_numpy(a) for a in _ws_args()), device=torch.device("cpu"))
    assert torch.equal(labels, same)
    assert set(np.unique(labels.numpy())) == {1, 2}
    assert resolve_device("cpu") == torch.device("cpu")


def test_mesh_runs_on_cpu_ranks_when_asked():
    """``launch(device="cpu")`` runs gloo ranks (a single rank in this
    process; ``tests/test_torch_parallel.py`` holds a spawned mesh) and
    returns rank 0's result; a rank that fails ends the run."""
    one = launch(mesh_facts, 1, 1, device="cpu")
    assert one == {"rank": 0, "coords": (0, 0), "device": "cpu", "backend": "gloo",
                   "halo": [-1, 0, -1], "world": 1}
    assert layout(4, "cpu") == {"device": "cpu", "ranks": 4, "cards": 0, "ranks_per_card": 0,
                                "backend": "gloo"}
    # 3 frames do not split over 2 ranks
    with pytest.raises(Exception, match="T divisible by 2"):
        launch(uneven_tile, 2, 1, device="cpu")


def test_dryrun_on_cpu_ranks(capsys):
    """The sharded chain's summary line on a CPU mesh (one rank, in this
    process)."""
    line = dryrun_multichip(1, device="cpu")
    assert line.startswith("dryrun_multichip OK: mesh=(t=1, x=1), field shape=(2, 32, 32), "
                           "outputs=8")
    assert "backend=gloo" in line and line in capsys.readouterr().out


def test_stage_records_seconds_and_span():
    """A stage records its seconds and its span on the Unix clock, which the
    profiles of ``chip_smoke.py`` split by."""
    stats = {}
    before = time.time_ns()
    with stage("work", stats, torch.device("cpu")):
        time.sleep(0.01)
    after = time.time_ns()
    assert set(stats) == {"work_s", "work_span_ns"}
    lo, hi = stats["work_span_ns"]
    assert before <= lo < hi <= after and hi - lo >= 10_000_000
    assert 0.01 <= stats["work_s"] <= (after - before) / 1e9
