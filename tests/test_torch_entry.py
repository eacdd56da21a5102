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

T, H, W = 3, 12, 16


def _ws_args():
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 1, (T, H, W, 2)).astype(np.float32)
    field = rng.uniform(0, 1, (T, H, W)).astype(np.float32)
    markers = np.zeros((T, H, W), np.int32)
    markers[:, 2, 3], markers[:, 9, 12] = 1, 2
    return flow, -flow, field, markers


ENTRIES = ["fused_flow_watershed", "device_flow", "watershed", "create_flow",
           "run_detection", "Flow.from_numpy"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bt = np.full((T, H, W), 250.0, np.float32)
    times = np.arange(T) * np.timedelta64(300, "s") + np.datetime64("2020-06-01", "ns")
    flow = np.zeros((T, H, W, 2), np.float32)
    call = {
        "fused_flow_watershed": lambda: fused_flow_watershed(bt, 5.0),
        "device_flow": lambda: device_flow(bt),
        "watershed": lambda: watershed(*_ws_args()),
        "create_flow": lambda: create_flow(bt, vr_steps=1, smoothing_passes=1,
                                           interp_method="cubic"),
        "run_detection": lambda: run_detection(bt, bt - 260, bt - 250, times),
        "Flow.from_numpy": lambda: Flow.from_numpy(flow, flow),
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
