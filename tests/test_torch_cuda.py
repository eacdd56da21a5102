"""The port on the card: its CUDA kernel must build from ``csrc/`` and be
bit-equal to its plain PyTorch version, and the paths through it must
give the CPU's results.  These tests need an NVIDIA GPU
and nvcc, and skip elsewhere; run them on the card with
``python -m pytest tests/test_torch_cuda.py -m cuda``.  They import no JAX.
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from bench import make_markers, make_scene
from chip_smoke import (
    GOES_SMALL, GOES_SMALL_MISSING, GOES_SMALL_ORIGIN, IN_PLANE, compare_datasets, goes_frames,
    goes_ingest, sweep_inputs,
)
from tobac_flow_tpu_torch.cli import common
from tobac_flow_tpu_torch.cli.common import DetectionOptions, prepare_output
from tobac_flow_tpu_torch.core.flow import Flow, create_flow
from tobac_flow_tpu_torch.data.ncdataset import DataArray, Dataset
from tobac_flow_tpu_torch.detect.chain import run_detection
from tobac_flow_tpu_torch.ops import ws_sweeps
from tobac_flow_tpu_torch.ops.ccl import flat_label
from tobac_flow_tpu_torch.ops.morphology import distance_transform_edt
from tobac_flow_tpu_torch.ops.watershed import watershed
from tools.parity_detect import make_multistorm_scene

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


@pytest.mark.parametrize("k", [8, 4, 1])
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("shape", [(3, 230, 257), (2, 31, 33)])
def test_kernel_bit_equal_to_plain(cuda, shape, connectivity, k):
    taps = IN_PLANE[connectivity]
    _assert_kernel_equals_plain(sweep_inputs(shape, connectivity, cuda, taps), taps, k)


def _assert_kernel_equals_plain(args, taps, k):
    ref = ws_sweeps.spatial_sweeps_reference(*args, taps, k)
    out = ws_sweeps.spatial_sweeps(*args, taps, k)
    torch.cuda.synchronize()
    for name, a, b in zip(("claim", "claim2", "meta"), ref, out):
        assert torch.equal(a, b), f"{name}: {(a != b).sum().item()} mismatches"


@pytest.mark.parametrize("k", [2, 3, 5, 6, 7])
def test_generic_instance_bit_equal_to_plain(cuda, k):
    """K outside {1, 4, 8} runs the instance with run-time K and taps."""
    _assert_kernel_equals_plain(sweep_inputs((2, 100, 130), k, cuda), IN_PLANE[1], k)


@pytest.mark.parametrize("k", [8, 4])
def test_kernel_keeps_the_callers_tap_order(cuda, k):
    taps = IN_PLANE[2][::-1]
    _assert_kernel_equals_plain(sweep_inputs((2, 100, 130), k, cuda, taps), taps, k)


@pytest.mark.parametrize("k", [8, 4, 1])
def test_kernel_nan_and_signed_zero(cuda, k):
    """NaN fields and claims (the NaN-propagating max, and NaN never
    comparing less or equal) and -0.0 against +0.0 (equal claims, the
    first in tap order kept), compared bit for bit."""
    rng = np.random.default_rng(k)
    args = sweep_inputs((2, 100, 130), 4, "cpu")
    claim, claim2, _, field = (a.numpy() for a in args[:4])
    field[rng.uniform(size=field.shape) < 0.02] = np.nan
    field[rng.uniform(size=field.shape) < 0.05] = -0.0
    claim[rng.uniform(size=claim.shape) < 0.01] = np.nan
    claim[rng.uniform(size=claim.shape) < 0.03] = -0.0
    claim2[rng.uniform(size=claim2.shape) < 0.01] = np.nan
    args = [a.to(cuda) for a in args]
    ref = ws_sweeps.spatial_sweeps_reference(*args, IN_PLANE[2], k)
    out = ws_sweeps.spatial_sweeps(*args, IN_PLANE[2], k)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[0]).any())
    for name, a, b in zip(("claim", "claim2", "meta"), ref, out):
        a_bits, b_bits = (x.view(torch.int32) for x in (a, b))
        assert torch.equal(a_bits, b_bits), f"{name}: {(a_bits != b_bits).sum().item()} mismatches"


def test_persistent_grid_and_misaligned_masks(cuda):
    """More tiles than blocks (each block walks several tiles and prefetches
    the next), once with the masks as aligned words and once with the masks
    one byte off a word, which the kernel reads byte by byte."""
    args = sweep_inputs((4, 512, 512), 3, cuda)
    plan = ws_sweeps.launch_plan(4, 512, 512, 8, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.n_tiles > plan.grid
    _assert_kernel_equals_plain(args, IN_PLANE[1], 8)
    for i in (4, 5):
        buf = torch.zeros(args[i].numel() + 1, dtype=torch.bool, device=cuda)
        buf[1:] = args[i].reshape(-1)
        args[i] = buf[1:].view(args[i].shape)
    assert args[4].data_ptr() % 4 == 1
    _assert_kernel_equals_plain(args, IN_PLANE[1], 8)


def test_watershed_labels_equal_on_cuda_and_cpu(cuda):
    bt = make_scene(6, 96, 128)
    markers, _ = make_markers(bt)
    rng = np.random.default_rng(0)
    flow = rng.normal(0, 1.5, bt.shape + (2,)).astype(np.float32)
    field = np.clip((260.0 - bt) / 10.0, 0.0, 1.0).astype(np.float32)
    args = [torch.from_numpy(a) for a in (flow, -flow, 1.0 - field, markers, field > 0.05)]
    cpu = watershed(*args[:4], mask=args[4], max_iters=64, device="cpu")
    before = ws_sweeps.spatial_sweeps.launches
    gpu = watershed(*args[:4], mask=args[4], max_iters=64)  # the card by default
    assert gpu.device.type == "cuda"
    assert ws_sweeps.spatial_sweeps.launches > before
    assert torch.equal(cpu, gpu.cpu())


@pytest.mark.parametrize("p", [0.3, 0.55, 0.65])
def test_flat_label_on_card_matches_scipy(cuda, p):
    mask = np.random.default_rng(7).uniform(size=(4, 200, 300)) < p
    out = flat_label(torch.from_numpy(mask).to(cuda))
    assert out.device.type == "cuda"
    ref = np.zeros(mask.shape, np.int64)
    offset = 0
    for i, frame in enumerate(mask):
        lab, n = ndi.label(frame, structure=ndi.generate_binary_structure(2, 1))
        ref[i] = np.where(lab > 0, lab + offset, 0)
        offset += n
    assert np.array_equal(out.cpu().numpy(), ref)


def test_chain_on_card_equals_cpu(cuda):
    """The detection chain on the card and on the CPU, given the same
    (card-computed, CLI-default) flows: identical labels at every stage."""
    t, h, w = 9, 64, 96
    bt, wvd, swd = make_multistorm_scene(t, h, w)
    times = np.datetime64("2020-06-01T00:00", "ns") + np.arange(t) * np.timedelta64(300, "s")
    flow = create_flow(bt, vr_steps=1, smoothing_passes=1, interp_method="cubic")
    assert flow.device.type == "cuda"
    gpu = run_detection(bt, wvd, swd, times, flow=flow)
    cpu = run_detection(bt, wvd, swd, times,
                        flow=Flow(flow.forward_flow.cpu(), flow.backward_flow.cpu()))
    for name in ("core_label", "anvil_marker_label", "thick_anvil_label", "thin_anvil_label"):
        assert gpu[name].device.type == "cuda" and int(cpu[name].max()) > 0, name
        assert torch.equal(gpu[name].cpu(), cpu[name]), name


def test_output_stages_on_card_equal_cpu(cuda):
    """The output stages (schema, label, spatial and field properties) on
    the card and on the CPU, given the same labels (the chain's on the
    card, with a NaN patch in WVD): the same dataset, float means and stds
    within the CPU tests' tolerance."""
    t, h, w = 9, 64, 96
    bt, wvd, swd = make_multistorm_scene(t, h, w)
    wvd[3:6, 20:26, 40:46] = np.nan
    times = np.datetime64("2020-06-01T00:00", "ns") + np.arange(t) * np.timedelta64(300, "s")
    labels = run_detection(bt, wvd, swd, times)
    coords = {"t": times, "y": np.arange(h) * 2000.0, "x": np.arange(w) * 2000.0}
    opts = DetectionOptions(save_spatial_props=True)
    out = {}
    for device in ("cuda", "cpu"):
        ds = Dataset(coords=coords)
        for name in ("core_label", "thick_anvil_label", "thin_anvil_label"):
            ds[name] = DataArray(labels[name].to(device), dims=("t", "y", "x"))
        fields = [DataArray(a, coords=coords, dims=("t", "y", "x"), name=n,
                            attrs={"long_name": n, "units": "K"})
                  for a, n in ((bt, "bt"), (wvd, "wvd"), (swd, "swd"))]
        stats = {}
        out[device] = prepare_output(ds, *fields, opts=opts, device=device, stats=stats)
        assert {"schema_s", "label_props_s", "field_props_s"} <= set(stats)
    assert out["cpu"].coords["core"].size > 0 and out["cpu"].coords["anvil"].size > 0
    assert out["cpu"]["core_nan_flag"].values.dtype == bool
    compare_datasets(out["cpu"], out["cuda"])


def test_goes_detection_on_card_equals_cpu(cuda):
    """The small GOES scene of the CPU tests (a NaN gap frame, DQF-masked
    pixels, pixel-area weights) through ``cli.common.run_detection`` on the
    card and on the CPU, given the same (the card's) flows: the same
    dataset, float means and stds within the CPU tests' tolerance, and
    every stage non-empty."""
    fields, ds = goes_ingest(*goes_frames(GOES_SMALL, GOES_SMALL_MISSING, GOES_SMALL_ORIGIN))
    assert np.isnan(fields[0].values[GOES_SMALL_MISSING[0]]).all() and "area" in ds
    flow = create_flow(fields[0].values, vr_steps=1, smoothing_passes=1, interp_method="cubic")
    assert flow.device.type == "cuda"
    out = {}
    for device, given in (("cuda", flow), ("cpu", Flow(flow.forward_flow.cpu(),
                                                       flow.backward_flow.cpu()))):
        opts = DetectionOptions(save_anvil_markers=True,
                                flow_factory=lambda _, given=given: given)
        out[device] = common.run_detection(*fields, Dataset(data_vars=ds.data_vars,
                                                            coords=ds.coords),
                                           opts=opts, device=device)
    for name in ("core_label", "anvil_marker_label", "thick_anvil_label", "thin_anvil_label"):
        assert int(out["cpu"][name].values.max()) > 0, name
    compare_datasets(out["cpu"], out["cuda"])


@pytest.mark.parametrize("kind", ["plain", "mixed"])
def test_chunked_watershed_equal_on_cuda_and_cpu(cuda, kind):
    """The time-chunked flood in 3 chunks on the card and on the CPU, given
    the same inputs: identical labels, the same passes and floods."""
    from chip_smoke import chunk_budget

    bt = make_scene(12, 64, 96)
    markers, _ = make_markers(bt)
    rng = np.random.default_rng(1)
    flow = rng.normal(0, 1.5, bt.shape + (2,)).astype(np.float32)
    field = np.clip((260.0 - bt) / 10.0, 0.0, 1.0).astype(np.float32)
    if kind == "mixed":
        markers = np.where((markers == 0) & (field > 0.05) & (field < 0.1), -1, markers)
    args = [torch.from_numpy(a) for a in (flow, -flow, 1.0 - field, markers, field > 0.05)]
    budget = chunk_budget(bt.shape, kind == "mixed", 4)
    out = {}
    for device in ("cpu", None):
        stats = {}
        labels = watershed(*args[:4], mask=args[4], max_iters=64, stats=stats,
                           budget_bytes=budget, device=device)
        out[device] = labels.cpu(), stats
    assert out[None][1]["chunks"] == 3
    assert torch.equal(out["cpu"][0], out[None][0])
    assert out["cpu"][1] == out[None][1]


def test_chunked_coarse_scene_on_card_matches_jax(cuda):
    """The 12×128×128 mixed scene of the reference's global-coarse-solve
    test, in 3 chunks of 4 frames on the card: the JAX package's chunked
    labels without its global coarse solve (recorded by
    ``tests/test_torch_watershed_chunked.py``), and the whole-volume flood
    the JAX package's whole-volume labels."""
    from test_torch_watershed_chunked import DATA, SCENES, _digest

    from tobac_flow_tpu_torch.ops import watershed as pws

    recorded = np.load(DATA)
    scene = SCENES["coarse"]()
    assert str(recorded["coarse_digest"]) == _digest(scene)
    fwd, bwd, field, markers = (torch.from_numpy(a).to(cuda) for a in scene)
    taps = pws._structure_taps_3d(pws.connectivity_structure(1))
    stats = {}
    chunked = pws._watershed_time_chunked(
        field, markers, torch.ones(field.shape, dtype=torch.bool, device=cuda), fwd, bwd,
        taps, chunk_t=4, max_iters_cap=1 << 30, multigrid=True, run_scans=True, stats=stats,
    )
    whole = watershed(fwd, bwd, field, markers)
    assert stats["chunks"] == 3
    np.testing.assert_array_equal(chunked.cpu().numpy(), recorded["coarse_labels"])
    np.testing.assert_array_equal(whole.cpu().numpy(), recorded["coarse_whole"])


def test_stage_peaks_and_memory_budget(cuda):
    """``device.stage`` records each stage's peak, nested stages too, and
    ``peak_memory`` keeps the run's across the stages' resets; the budget
    never exceeds the card's free memory."""
    from tobac_flow_tpu_torch.device import memory_budget, peak_memory, reset_peak_memory, stage

    reset_peak_memory(cuda)
    stats = {}
    with stage("outer", stats, cuda):
        a = torch.empty(2**28, dtype=torch.uint8, device=cuda)
        with stage("inner", stats, cuda):
            b = torch.empty(2**29, dtype=torch.uint8, device=cuda)
            del b
        del a
    assert stats["inner_peak_bytes"] >= stats["inner_start_bytes"] + 2**29
    assert stats["outer_peak_bytes"] >= stats["outer_start_bytes"] + 2**28 + 2**29
    assert peak_memory(cuda) >= stats["outer_peak_bytes"]
    free, total = torch.cuda.mem_get_info(cuda)
    assert 0 < memory_budget(cuda) <= free and memory_budget(cuda, total) <= total


def test_chunked_chain_on_card_equals_whole(cuda):
    """``cli.common.run_detection`` on the card under a budget that forces
    the anvil stages into 4-frame chunks gives the whole run's dataset,
    anvil markers included (``chip_smoke.check_chunked_chain_small``)."""
    from chip_smoke import CHAIN_SMALL, chain_inputs, chain_times, stage_budget

    bt, wvd, swd = make_multistorm_scene(*CHAIN_SMALL)
    wvd[3:6, 20:26, 40:46] = np.nan
    times = chain_times(CHAIN_SMALL[0])
    flow = create_flow(bt, vr_steps=1, smoothing_passes=1, interp_method="cubic")
    out, stats = {}, {}
    for name, budget in (("whole", None), ("chunked", stage_budget("thick_anvils", CHAIN_SMALL))):
        fields, ds = chain_inputs(bt, wvd, swd, times)
        opts = DetectionOptions(save_anvil_markers=True, flow_factory=lambda _: flow)
        stats[name] = {}
        out[name] = common.run_detection(*fields, ds, opts=opts, stats=stats[name],
                                         budget_bytes=budget)
    assert stats["chunked"]["thick_anvils_chunks"] == 3
    assert stats["chunked"]["thin_anvils_chunks"] == 3
    assert stats["whole"]["thick_anvils_chunks"] == 1
    assert int(out["whole"]["thick_anvil_label"].values.max()) > 0
    compare_datasets(out["whole"], out["chunked"])


def test_park_and_place_on_card(cuda):
    """``device.park`` moves the card's volumes that a stage does not read
    to pinned host memory while the card lacks the room, largest first;
    ``device.place`` puts a volume on the card where it fits."""
    from tobac_flow_tpu_torch.device import park, place

    vols = {"small": torch.ones(8, device=cuda), "big": torch.ones(1 << 20, device=cuda),
            "read": torch.ones(1 << 21, device=cuda)}
    free, _ = torch.cuda.mem_get_info(cuda)
    moved = park(vols, {"read"}, cuda, need=2 * free)
    assert moved == ["big", "small"]
    assert vols["big"].is_pinned() and vols["small"].is_pinned()
    assert vols["read"].device.type == "cuda"
    assert park(vols, set(), cuda, need=0) == []
    assert place(np.ones((4, 8, 8), np.float32), cuda).device.type == "cuda"


@pytest.mark.parametrize("budget", ["whole", "chunked"])
def test_linkers_on_card_equal_cpu(cuda, budget):
    """FileLinker, LabelLinker and the batch path on the card over the
    recorded linking windows (from memory) give the CPU's outputs, whole
    and under a budget that chunks every pass over a volume, and the JAX
    record's."""
    from pathlib import Path

    from chip_smoke import (
        LINK_CHUNK_FRAMES, LINKING_RECORD, _held_to, link_all, linking_record,
    )
    from tobac_flow_tpu_torch import device as port_device
    from tobac_flow_tpu_torch.track.store import MemoryStore

    rec = linking_record(Path(__file__).resolve().parent / "data" / LINKING_RECORD)
    forced = port_device.frames_budget(LINK_CHUNK_FRAMES) if budget == "chunked" else None
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        store = MemoryStore(dict(zip(rec["names"], rec["windows"])))
        outs[dev.type] = link_all(rec["names"], store, dev, forced)
    for key in ("file", "label", "batch"):
        for i, (card_ds, cpu_ds) in enumerate(zip(outs["cuda"][key][0], outs["cpu"][key][0])):
            compare_datasets(cpu_ds, card_ds, rtol32=0.0, rtol64=0.0)
            _held_to(rec[key][i], card_ds, f"{key} window {i}")


@pytest.mark.parametrize("budget", ["whole", "chunked"])
def test_postprocess_passes_on_card_equal_cpu(cuda, budget):
    """``weighted_label_stats`` with uncertainties over (H, W) weights, the
    weighted flag proportions and ``get_label_stats`` on the card give the
    CPU's results (float64 to rtol 1e-12, the rest identical), whole and
    under a budget that runs every pass in at least 3 chunks."""
    from tobac_flow_tpu_torch import device as port_device
    from tobac_flow_tpu_torch.detect.analysis import get_label_stats
    from tobac_flow_tpu_torch.schema.postprocess import (
        get_weighted_proportions_da, weighted_label_stats,
    )

    rng = np.random.default_rng(12)
    shape = (12, 96, 128)
    labels = ndi.label(ndi.uniform_filter(rng.random(shape), 5) > 0.52)[0].astype(np.int32)
    field = rng.normal(225, 12, shape).astype(np.float32)
    field[3, 10:40, 20:60] = np.nan
    errors = rng.uniform(0.5, 3, shape).astype(np.float32)
    flags = rng.integers(0, 4, shape).astype(np.int8)
    area = rng.uniform(3.5, 4.5, shape[1:])
    index = np.arange(1, int(labels.max()) + 2)
    forced = port_device.frames_budget(4) if budget == "chunked" else None
    out = {}
    for dev in (cuda, torch.device("cpu")):
        ds = Dataset()
        ds["ctt"] = DataArray(torch.as_tensor(field, device=dev), dims=("t", "y", "x"))
        ds["ctt_uncertainty"] = DataArray(torch.as_tensor(errors, device=dev),
                                          dims=("t", "y", "x"))
        lab = torch.as_tensor(labels, device=dev)
        w = torch.as_tensor(area, device=dev)
        stats = {}
        with port_device.stage("post", stats, dev):
            res = Dataset()
            for da in weighted_label_stats(lab, w, ds, "ctt", index, "core", uncertainty=True,
                                           budget_bytes=forced):
                res[da.name] = da
            flag = DataArray(torch.as_tensor(flags, device=dev), dims=("t", "y", "x"),
                             name="flag", attrs={"flag_values": "0b 1b 2b 3b"})
            res["p"] = get_weighted_proportions_da(flag, w, lab, "core", index=index,
                                                   budget_bytes=forced)
            get_label_stats(DataArray(lab, dims=("t", "y", "x"), name="core_label"), res,
                            forced)
        if budget == "chunked":
            assert stats["post_chunks"] >= 3
        out[dev.type] = res.load()
    compare_datasets(out["cpu"], out["cuda"], rtol32=0.0)


def test_bin_sums_on_card_equal_cpu_bitwise(cuda):
    """The pairwise per-bin sums have the same bits on the card as on the
    CPU, so per-label sums (and what is derived from them, as rates from
    per-step means) agree exactly."""
    from tobac_flow_tpu_torch.utils.labels import bin_sums

    rng = np.random.default_rng(3)
    for m, n in ((1, 2), (100000, 7), (3000000, 5000)):
        bins = torch.as_tensor(rng.integers(0, n, m))
        values = torch.as_tensor(rng.normal(225, 9, m))
        assert torch.equal(bin_sums(values.to(cuda), bins.to(cuda), n).cpu(),
                           bin_sums(values, bins, n))


@pytest.mark.parametrize("sampling", [None, (1e9, 1.0, 1.0), (1.7, 0.35, 1.3)])
def test_distance_transform_on_card_equals_cpu_and_scipy(cuda, sampling):
    """The exact transform on the card equals the CPU's bit for bit (unit,
    per-frame and non-integer spacings), and scipy's: bit for bit at unit
    spacing, to rounding at the others (scipy adds in another order)."""
    rng = np.random.default_rng(3)
    mask = rng.random((5, 150, 230)) > 0.01
    mask[2] = True  # a frame without a zero pixel
    mask[3, 40] = True  # a row without one
    cpu = distance_transform_edt(torch.from_numpy(mask), sampling)
    card = distance_transform_edt(torch.from_numpy(mask).to(cuda), sampling)
    assert torch.equal(card.cpu().view(torch.int64), cpu.view(torch.int64))
    want = ndi.distance_transform_edt(mask, sampling=sampling) if sampling != (1e9, 1.0, 1.0) \
        else np.stack([ndi.distance_transform_edt(m) for m in mask])
    if sampling == (1e9, 1.0, 1.0):
        want[2] = 1e15  # no zero in the frame: the reference's cap, not scipy's
    if sampling is None or sampling[0] == 1e9:
        assert np.array_equal(card.cpu().numpy(), want)
    else:
        np.testing.assert_allclose(card.cpu().numpy(), want, rtol=1e-12, atol=0)


def test_regrid_glm_on_card_equals_cpu(cuda):
    from tobac_flow_tpu_torch.data import glm
    from tobac_flow_tpu_torch.data.abi import ABIProjection

    rng = np.random.default_rng(5)
    y, x = (np.arange(300)[::-1] - 150) * 56e-6, (np.arange(400) - 200) * 56e-6
    t0 = np.datetime64("2020-06-01T12:00", "ns")
    ds = Dataset(coords={"t": t0 + np.arange(6) * np.timedelta64(300, "s"), "y": y, "x": x})
    ds["goes_imager_projection"] = DataArray(np.zeros((), np.int32), dims=(), attrs={
        "semi_major_axis": 6378137.0, "semi_minor_axis": 6356752.31414,
        "perspective_point_height": 35786023.0, "longitude_of_projection_origin": -75.0})
    n = 200_000
    lat, lon = ABIProjection().to_latlon(rng.uniform(-0.012, 0.012, n),
                                         rng.uniform(-0.009, 0.009, n))
    times = t0 + rng.integers(-200, 1900, n).astype("timedelta64[s]")
    t_bins = glm._time_bins(np.asarray(ds.coords["t"]))
    cpu = glm.regrid_glm(times, lat, lon, ds, t_bins, device="cpu")
    card = glm.regrid_glm(times, lat, lon, ds, t_bins, device=cuda)
    assert card.device.type == "cuda" and torch.equal(card.cpu(), cpu) and int(cpu.sum()) > 0


def _validation_scene(shape=(12, 120, 160), seed=0):
    """Label volumes (cores, thick anvils as cores grown, thin anvils) and
    an int32 flash grid with flashes on most cores and false ones."""
    rng = np.random.default_rng(seed)
    t, h, w = shape
    cores = np.zeros(shape, np.int32)
    for k in range(1, 13):
        t0, y, x = rng.integers(0, t - 4), rng.integers(10, h - 20), rng.integers(10, w - 20)
        cores[t0:t0 + rng.integers(3, 8), y:y + 6, x:x + 6] = k
    thick = ndi.grey_dilation(cores, size=(1, 9, 9))
    thin = ndi.grey_dilation(cores, size=(1, 17, 17))
    glm_grid = np.zeros(shape, np.int32)
    on = np.argwhere((cores > 0) & (cores % 4 != 0))
    np.add.at(glm_grid, tuple(on[rng.integers(0, len(on), 60)].T), 1)
    np.add.at(glm_grid, tuple(rng.integers(0, shape, (30, 3)).T), 1)
    return cores, thick, thin, glm_grid


@pytest.mark.parametrize("budget", ["whole", "chunked"])
def test_validate_cores_on_card_equals_cpu(cuda, budget):
    """``validate_cores`` and ``validate_anvils`` on the card (whole, and in
    forced chunks) give the CPU's scores, per-object distances and grids."""
    from tobac_flow_tpu_torch import device as port_device
    from tobac_flow_tpu_torch.validate import validation

    cores, thick, thin, glm_grid = _validation_scene()
    times = np.datetime64("2020-06-01T12:00", "ns") + np.arange(12) * np.timedelta64(300, "s")
    b = port_device.frames_budget(4) if budget == "chunked" else None
    runs = []
    for dev in (torch.device("cpu"), cuda):
        ds = Dataset(coords={"t": times, "core": np.arange(1, 14), "anvil": np.arange(1, 13)})
        for name, vol in (("core_label", cores), ("thick_anvil_label", thick),
                          ("thin_anvil_label", thin)):
            ds[name] = DataArray(torch.from_numpy(vol).to(dev), dims=("t", "y", "x"))
        scores = (validation.validate_cores(ds, glm_grid, margin=5, time_margin=1, device=dev,
                                            budget_bytes=b),
                  validation.validate_anvils(ds, glm_grid, margin=5, time_margin=1, device=dev,
                                             budget_bytes=b))
        edge = validation.get_edge_filter(ds, margin=5, device=dev)
        grids = validation.validate_markers(ds["core_label"], glm_grid, None, edge,
                                            time_margin=1, device=dev, budget_bytes=b)[:2]
        runs.append((scores, dict(ds.attrs), ds["core_glm_distance"].values,
                     ds["thick_anvil_glm_distance"].values, [g.cpu() for g in grids]))
    (s0, a0, c0, t0, g0), (s1, a1, c1, t1, g1) = runs
    assert s0 == s1 and a0 == a1 and 0 < s0[0][0] <= 1
    assert np.array_equal(c0, c1) and np.array_equal(t0, t1)
    assert all(torch.equal(x.view(torch.int64), y.view(torch.int64)) for x, y in zip(g0, g1))


def _model_pairs():
    """Three storm-bearing frame pairs of the multistorm scene, quantised as
    the flow path quantises them (on the CPU)."""
    from tobac_flow_tpu_torch.pipeline import _normalise_pair

    bt = make_multistorm_scene(5, 96, 128)[0][1:]
    frames = torch.from_numpy(bt)
    p8, n8 = _normalise_pair(frames[:-1], frames[1:])
    return bt, p8, n8


@pytest.mark.parametrize("name", ["DIS", "DualTVL1", "DeepFlow", "PCA", "SimpleFlow",
                                  "SparseToDense"])
def test_flow_model_on_card_equals_cpu(cuda, name):
    """Each model's flows of three pairs in one batch on the card within the
    CPU tests' Farneback gate of the CPU's, inside the storms."""
    from tobac_flow_tpu_torch.models import select_of_model

    bt, p8, n8 = _model_pairs()
    want = select_of_model(name)(p8, n8).numpy()
    got = select_of_model(name).to(cuda)(p8.to(cuda), n8.to(cuda)).cpu().numpy()
    storm = bt[:-1] < 260.0
    for i in range(got.shape[0]):
        diff = np.abs(got[i] - want[i])[storm[i]]
        assert np.percentile(diff, 99) <= 0.01 and diff.max() <= 0.1, (i, diff.max())
        assert (np.round(got[i]) == np.round(want[i]))[storm[i]].mean() >= 0.999


def test_pca_holds_tf32_off(cuda, monkeypatch):
    """PCA's products run with TF32 off even where the caller allows it
    (restored after): inside ``full_precision_matmul`` a float32 product
    on the card matches float64 to float32 rounding (TF32's 10-bit
    mantissa would miss it by about 1e-3), and the model's flows on the
    card are the CPU's within the Farneback gate."""
    from tobac_flow_tpu_torch.models import pcaflow

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    gen = torch.Generator(device="cpu").manual_seed(0)
    a = torch.rand((4096, 36), generator=gen)
    b = torch.rand((36, 2), generator=gen)
    exact = a.double() @ b.double()
    with pcaflow.full_precision_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is False
        got = (a.to(cuda) @ b.to(cuda)).cpu().double()
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert float(((got - exact).abs() / exact.abs()).max()) < 1e-5
    seen = []
    real = torch.linalg.solve

    def spy(x, y):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(x, y)

    monkeypatch.setattr(torch.linalg, "solve", spy)
    bt, p8, n8 = _model_pairs()
    got = pcaflow.PCAFlow().to(cuda)(p8.to(cuda), n8.to(cuda)).cpu().numpy()
    assert seen == [False] and torch.backends.cuda.matmul.allow_tf32 is True
    want = pcaflow.PCAFlow()(p8, n8).numpy()
    storm = bt[:-1] < 260.0
    for i in range(got.shape[0]):
        diff = np.abs(got[i] - want[i])[storm[i]]
        assert np.percentile(diff, 99) <= 0.01 and diff.max() <= 0.1, (i, diff.max())


@pytest.mark.parametrize("method", ["linear", "z_score", "log", "inverse_log"])
def test_normalise_pair_on_card_equals_cpu(cuda, method):
    from tobac_flow_tpu_torch.pipeline import _normalise_pair

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(250, 15, (3, 150, 250)).astype(np.float32))
    b = torch.from_numpy(rng.normal(240, 25, (3, 150, 250)).astype(np.float32))
    a[0, 3:9, 5:20] = float("nan")
    want = _normalise_pair(a, b, method)
    got = _normalise_pair(a.to(cuda), b.to(cuda), method)
    for w, g in zip(want, got):
        assert torch.equal(w, g.cpu())


def test_lanczos_smoothing_and_subsegmentation_on_card_equal_cpu(cuda):
    from tobac_flow_tpu_torch import device as port_device
    from tobac_flow_tpu_torch.core.flow import smooth_flow_step
    from tobac_flow_tpu_torch.segment.subsegment import subsegment_labels

    rng = np.random.default_rng(1)
    fwd = torch.from_numpy(rng.normal(0, 3, (2, 64, 96, 2)).astype(np.float32))
    bwd = -fwd + torch.from_numpy(rng.normal(0, 1, (2, 64, 96, 2)).astype(np.float32))
    want = smooth_flow_step(fwd, bwd, method="lanczos")
    got = smooth_flow_step(fwd.to(cuda), bwd.to(cuda), method="lanczos")
    for w, g in zip(want, got):
        assert torch.equal(torch.isnan(w), torch.isnan(g.cpu()))
        assert torch.equal(torch.nan_to_num(w), torch.nan_to_num(g.cpu()))
    mask = make_multistorm_scene(6, 96, 128)[0] < 235.0
    want = subsegment_labels(mask, 0.1, device="cpu")
    got = subsegment_labels(mask, 0.1, device=cuda)
    assert want.max() > 1 and torch.equal(want, got.cpu())
    chunked = subsegment_labels(mask, 0.1, device=cuda,
                                budget_bytes=port_device.frames_budget(4))
    assert torch.equal(want, chunked.cpu())


@pytest.mark.parametrize("shape,k", [((6, 1500, 2500), 1), ((6, 1500, 2500), 8),
                                     ((6, 375, 625), 1), ((6, 375, 625), 8)])
def test_kernel_at_the_legacy_flood_classes(cuda, shape, k):
    """The legacy path's flood at 6x1500x2500 launches these volume classes."""
    _assert_kernel_equals_plain(sweep_inputs(shape, 1, cuda), IN_PLANE[1], k)


@pytest.mark.parametrize("form", ["dense", "shifts", "waves"])
def test_scatter_min_on_card_equals_cpu(cuda, form):
    """The temporal scatter-min of the floods, in each of its three forms:
    the card's folds give the CPU's bits, with pushes of every shift and
    collisions."""
    from tobac_flow_tpu_torch.ops import watershed as pws

    def _banded_scatter_min(*args):
        *args, radius = args
        keyed = pws._shift_keys(args[3], args[2] != ws_sweeps.META_MAX, radius)
        if form == "dense":
            return pws._scatter_min_dense(*args, radius, keyed[1])
        return getattr(pws, f"_scatter_min_{form}")(*args, radius, keyed)

    rng = np.random.default_rng(3)
    shape = (3, 90, 130)
    cost = rng.normal(0, 1, shape).astype(np.float32)
    cost2 = rng.normal(0, 1, shape).astype(np.float32)
    meta = rng.integers(2, 40, shape).astype(np.int32) | (rng.integers(0, 4, shape) << 23).astype(
        np.int32)
    meta[rng.uniform(size=shape) < 0.3] = ws_sweeps.META_MAX
    dy, dx = (rng.integers(-12, 13, shape).astype(np.int32) for _ in range(2))
    args = (cost, cost2, meta, dy, dx)
    cpu = _banded_scatter_min(*(torch.from_numpy(a) for a in args), 10)
    card = _banded_scatter_min(*(torch.from_numpy(a).to(cuda) for a in args), 10)
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())


def test_legacy_path_on_card_equals_cpu(cuda):
    """``detect_legacy`` at 8x48x64 given the card's flows: the card's
    markers and labels are the CPU's."""
    from tobac_flow_tpu_torch.cli.dcc_detect_legacy import detect_legacy
    from tobac_flow_tpu_torch.cli.dcc_detect_synthetic import make_scene

    bt, wvd, swd = make_scene(8, 48, 64)
    times = bt.coords["t"]
    flow = create_flow(bt.values, model="Farneback", vr_steps=1, smoothing_passes=1,
                       device=cuda)
    card = detect_legacy(bt, wvd, swd, times, flow=flow)
    cpu = detect_legacy(bt, wvd, swd, times,
                        flow=Flow(flow.forward_flow.cpu(), flow.backward_flow.cpu()))
    for name in ("growth_markers", "watershed_label"):
        assert card[name].data.device.type == "cuda"
        assert torch.equal(card[name].data.cpu(), cpu[name].data)


@pytest.mark.parametrize("flip", [True, False])
def test_radar_histograms_on_card_equal_cpu(cuda, flip):
    """``get_nexrad_hist`` and ``get_3d_nexrad_hist`` of 3 million gates:
    the card's counts and means are the CPU's, bit for bit."""
    from chip_smoke import RADAR_ALT_EDGES, radar_volume, window_grid
    from tobac_flow_tpu_torch.data import nexrad
    from tobac_flow_tpu_torch.data.abi import get_abi_proj

    goes = window_grid(300, 400, origin=(1100, 650))
    if not flip:
        goes.coords["y"] = goes.coords["y"][::-1].copy()
    lat, lon = get_abi_proj(goes).to_latlon(goes.coords["x"][200], goes.coords["y"][150])
    gates = radar_volume((float(lat), float(lon), 300.0), 7, cuts=(0.5, 2.4), radials=720,
                         gates=1000)
    gx, gy = nexrad.map_nexrad_to_goes(*gates[:3], goes)
    for fn, args in ((nexrad.get_nexrad_hist, (gx, gy, gates[3], goes)),
                     (nexrad.get_3d_nexrad_hist, (gx, gy, gates[2], gates[3], goes,
                                                  RADAR_ALT_EDGES))):
        card = fn(*args, device=cuda)
        cpu = fn(*args, device="cpu")
        assert int(card[0].sum()) > 0
        for a, b in zip(card, cpu):
            a = a.cpu()
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_sharded_chain_on_card_ranks_equals_cpu_ranks(cuda):
    """``sharded_detect_all`` and ``sharded_flow_label`` on a (2, 2) mesh
    of ranks on the card(s) (gloo through pinned host memory where they
    share one, NCCL where each has its own) against four gloo ranks on the
    CPU, given the same flows: identical outputs; every rank's floods
    launched the kernel."""
    from tobac_flow_tpu_torch.parallel.dryrun import chain_jobs
    from tobac_flow_tpu_torch.parallel.launch import launch

    bt, wvd, swd = make_multistorm_scene(8, 64, 96)
    flow = create_flow(bt, vr_steps=1, smoothing_passes=1, interp_method="cubic")
    job = {"fields": (bt, wvd, swd), "flows": tuple(f.cpu().numpy() for f in flow.flow),
           "kw": {"hx": 24, "warp_radius": 21, "ws_sweeps": 64}, "label_mask": bt < 235.0,
           "label_halo": 21}
    card = launch(chain_jobs, 2, 2, [job])[0]
    cpu = launch(chain_jobs, 2, 2, [job], device="cpu")[0]
    assert card["outputs"]["thick_anvil_labels"].max() >= 1
    for name, a in card["outputs"].items():
        assert np.array_equal(a, cpu["outputs"][name]), name
    assert all(sum(r["launches_by_shape"].values()) > 0 for r in card["ranks"])
