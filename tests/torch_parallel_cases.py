"""Rank functions of ``tests/test_torch_parallel.py``: each runs on every
rank of a mesh that ``parallel.launch.launch`` starts, drives all of the
file's sharded cases for that mesh and returns the global outputs as numpy
arrays (rank 0's, which the launcher returns; the other ranks get None).
They live here, not in the test module, so that the spawned ranks import
only the port."""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch


def _np(a):
    return None if a is None else a.cpu().numpy()


@contextmanager
def reference_schedule():
    """Flood as the JAX package's sharded flood does: label-only rounds from
    the seeds alone, without the single device's barrier pre-flood and
    coarse V-cycle, so that the labels can be held to the JAX package's
    exactly."""
    from tobac_flow_tpu_torch.parallel import watershed

    start = watershed._single_device_start
    watershed._single_device_start = lambda mesh, state, *args: state
    try:
        yield
    finally:
        watershed._single_device_start = start


def mesh_facts(mesh):
    """The rank's place in the mesh, its device and backend, and a t halo
    of its own rank number (from the neighbouring tiles)."""
    from tobac_flow_tpu_torch.parallel.halo import halo_exchange_t

    ranks = torch.full((1, 1, 1), mesh.rank, dtype=torch.int32, device=mesh.device)
    halo = halo_exchange_t(mesh, ranks, 1, -1)
    return {"rank": mesh.rank, "coords": (mesh.t, mesh.x), "device": mesh.device.type,
            "backend": mesh.backend, "halo": halo.flatten().tolist(), "world": mesh.world}


def uneven_tile(mesh):
    """Tile a volume whose 3 frames the mesh cannot split evenly."""
    return mesh.tile(np.zeros((3, 4, 4), np.float32))


def wide_mesh_cases(mesh, label_scenes, ws_scenes, flow_scene, flow_step, varying):
    """The (4, 2) mesh: both halo exchanges, flow labelling, the watershed,
    the step computing its own flows, and the seed contract."""
    from tobac_flow_tpu_torch.parallel import halo
    from tobac_flow_tpu_torch.parallel.label import sharded_flow_label
    from tobac_flow_tpu_torch.parallel.pipeline import sharded_detect_step
    from tobac_flow_tpu_torch.parallel.watershed import sharded_watershed

    out = {}
    data = torch.arange(8 * 4 * 16, dtype=torch.float32).reshape(8, 4, 16)
    out["halo_t"] = _np(mesh.gather(halo.halo_exchange_t(mesh, mesh.tile(data), 1, -1.0)))
    data = torch.arange(4 * 4 * 32, dtype=torch.float32).reshape(4, 4, 32)
    out["halo_x"] = _np(mesh.gather(halo.halo_exchange_x(mesh, mesh.tile(data), 2, -1.0)))
    mask = mesh.tile(torch.arange(4 * 4 * 32).reshape(4, 4, 32) % 3 == 0)
    out["halo_x_bool"] = _np(mesh.gather(halo.halo_exchange_x(mesh, mask, 2, True)))
    for name, (m, fwd, bwd, hw) in label_scenes.items():
        out[name] = _np(sharded_flow_label(mesh, m, fwd, bwd, halo=hw))
    m, fwd, bwd, hw = varying
    out["label_varying"] = _np(sharded_flow_label(mesh, m, fwd, bwd, halo=hw))
    for name, (field, markers, fwd, bwd, m, rounds) in ws_scenes.items():
        stats = {}
        with reference_schedule():
            out[name] = _np(sharded_watershed(mesh, field, markers, fwd, bwd, mask=m,
                                              max_rounds=rounds, stats=stats))
        out[f"{name}_rounds"] = stats["rounds"]
    # the port's own schedule: no barrier, and frames too small for the
    # V-cycle, so the same rounds
    field, markers, fwd, bwd, _, rounds = ws_scenes["ws_basins"]
    out["ws_basins_own"] = _np(sharded_watershed(mesh, field, markers, fwd, bwd,
                                                 max_rounds=rounds))
    free = sharded_detect_step(mesh, *flow_scene, **flow_step)
    out["flow_step_fwd"], out["flow_step_bwd"] = _np(free[0]), _np(free[1])
    del free
    field, markers, fwd, bwd, _, _ = ws_scenes["ws_cross"]
    try:
        sharded_watershed(mesh, field, np.full_like(markers, 1 << 23), fwd, bwd, max_rounds=1)
    except ValueError as err:
        out["seed_contract"] = str(err)
    return out


def step_mesh_cases(mesh, bt, wvd, swd, fwd, bwd, step_kw, label_mask):
    """The (2, 2) mesh: its place and backend and a t halo of rank numbers
    (``mesh_facts``), the detection step given flows (its pixel-id thick
    flood capped at 2 rounds) and the whole chain (rounds capped at 64),
    with the reference's flood schedule (``all_ref_*``) and, as the dry
    run's measured job (``parallel.dryrun._job``, which then labels
    ``label_mask`` under the chain's flows), the single device's
    (``all_*``)."""
    from tobac_flow_tpu_torch.parallel.dryrun import _job
    from tobac_flow_tpu_torch.parallel.pipeline import (
        STEP_OUTPUTS, sharded_detect_all, sharded_detect_step,
    )

    out = {"facts": mesh_facts(mesh)}
    with reference_schedule():
        step = sharded_detect_step(mesh, bt, wvd, swd, flows=(fwd, bwd), ws_sweeps=2,
                                   **step_kw)
    for name, a in zip(STEP_OUTPUTS, step):
        out[f"step_{name}"] = _np(a)
    stats = {}
    with reference_schedule():
        chain = sharded_detect_all(mesh, bt, wvd, swd, flows=(fwd, bwd), ws_sweeps=64,
                                   stats=stats, **step_kw)
    for name, a in (chain or {}).items():
        out[f"all_ref_{name}"] = _np(a)
    out["all_ref_stats"] = stats
    chain, record = _job(mesh, (bt, wvd, swd), flows=(fwd, bwd),
                         kw=dict(ws_sweeps=64, **step_kw), label_mask=label_mask,
                         label_halo=step_kw["warp_radius"])
    for name, a in chain.items():
        out[f"all_{name}"] = a
    out["all_stats"] = record["stats"]
    return out
