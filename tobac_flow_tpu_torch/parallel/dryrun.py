"""Run the whole sharded chain and the sharded flow labelling once on an
N-rank mesh and print a one-line summary (counterpart of the reference's
``__graft_entry__.dryrun_multichip``):

    python -m tobac_flow_tpu_torch.parallel.dryrun N [--device cpu]

The mesh is (N/2, 2) for an even N of at least 4, else (N, 1); the scene is
an advecting cold cloud of 2·n_t x 32 x 32·n_x pixels, with the CLI's flow
passes (one refinement step, one cubic smoothing pass) computed in the
step and an x halo that covers the warp band.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from tobac_flow_tpu_torch.parallel.launch import launch, layout

__all__ = ["chain_jobs", "dryrun_multichip", "synthetic"]

LABEL_OUTPUTS = ("core_labels", "anvil_marker_labels", "thick_anvil_labels", "thin_anvil_labels")


def synthetic(t, h, w, seed=0):
    """(bt, wvd, swd) float32 (t, h, w): a cold cloud moving (2, 1) px a
    frame over noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bt = np.stack([
        290.0 - 60.0 * np.exp(-((xx - w * 0.3 - 2 * i) ** 2 + (yy - h * 0.4 - i) ** 2)
                              / (2 * (h / 8) ** 2))
        for i in range(t)
    ]).astype(np.float32)
    bt += rng.normal(0, 0.3, bt.shape).astype(np.float32)
    wvd = (250.0 - bt) * 0.2 - 5.0
    swd = 5.0 - (290.0 - bt) * 0.07
    return bt, wvd.astype(np.float32), swd.astype(np.float32)


def _job(mesh, fields, flows=None, kw=None, label_mask=None, label_halo=4, keep=None):
    """One measured run of ``sharded_detect_all`` (then, given a
    ``label_mask``, its sharded flow labelling under the chain's flows):
    (the outputs named in ``keep``, all by default, as numpy arrays on rank
    0; this rank's record)."""
    import torch

    from tobac_flow_tpu_torch import device as port_device
    from tobac_flow_tpu_torch.ops.ws_sweeps import spatial_sweeps
    from tobac_flow_tpu_torch.parallel.label import IN_PLANE, _label_step_local
    from tobac_flow_tpu_torch.parallel.pipeline import sharded_detect_all

    cuda = mesh.device.type == "cuda"
    budget = port_device.memory_budget(mesh.device)
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    start_bytes = torch.cuda.memory_allocated(mesh.device) if cuda else 0
    spatial_sweeps.launches = 0
    spatial_sweeps.launches_by_shape.clear()
    mesh.bytes_sent, mesh.exchange_s = 0, 0.0
    stats = {}
    t0 = time.perf_counter()
    out = sharded_detect_all(mesh, *fields, flows=flows, stats=stats, **(kw or {}))
    if label_mask is not None:
        # the chain's flows, which rank 0 holds, labelled on the tiles
        t1 = time.perf_counter()
        shape = tuple(label_mask.shape) + (2,)
        fwd, bwd = (mesh.scatter(None if out is None else out[k], shape, torch.float32)
                    for k in ("forward_flow", "backward_flow"))
        labels, _ = _label_step_local(mesh, mesh.tile(label_mask, torch.bool), fwd, bwd,
                                      shape[2], IN_PLANE, label_halo, 512)
        labels = mesh.gather(labels)
        if out is not None:
            out["flow_labels"] = labels
        if cuda:
            torch.cuda.synchronize(mesh.device)
        stats["flow_label_s"] = time.perf_counter() - t1
    if cuda:
        torch.cuda.synchronize(mesh.device)
    record = {
        "rank": mesh.rank, "coords": (mesh.t, mesh.x), "seconds": time.perf_counter() - t0,
        "stats": stats, "launches_by_shape": dict(spatial_sweeps.launches_by_shape),
        "bytes_sent": mesh.bytes_sent, "exchange_s": mesh.exchange_s, "budget": budget,
        "start_bytes": start_bytes,
        "peak_bytes": torch.cuda.max_memory_allocated(mesh.device) if cuda else 0,
    }
    if mesh.rank != 0:
        return {}, record
    flows = torch.stack([out["forward_flow"], out["backward_flow"]])
    record["flow_finite"] = bool(torch.isfinite(flows).all())
    record["flow_max_abs"] = float(flows.abs().max())
    record["objects"] = {k: int((out[k].unique() != 0).sum()) for k in LABEL_OUTPUTS}
    names = out if keep is None else keep
    return {k: out[k].cpu().numpy() for k in names}, record


def chain_jobs(mesh, jobs):
    """Rank function (see ``parallel.launch``): each job (a dict of
    :func:`_job`'s arguments) in turn, every rank's counts and peak memory
    reset just before it; a job with an ``"after"`` path starts only once
    that file exists (the caller's own work on the card is done), and
    raises on every rank if the file says ``abort``.  Rank 0
    returns, per job, ``{"outputs": ..., "ranks": [each rank's record]}``:
    its seconds and the chain's per-part seconds and rounds (``stats``),
    its ``ws_sweeps`` launches by (T, H, W, K), the bytes it sent and the
    seconds its exchanges took, its memory budget and the peak it
    allocated."""
    import torch.distributed as dist

    results = []
    for job in jobs:
        job = dict(job)
        after = job.pop("after", None)
        if after is not None:
            while mesh.rank == 0 and not os.path.exists(after):
                time.sleep(0.05)
            dist.barrier()
            with open(after) as f:
                if f.read().strip() == "abort":
                    raise RuntimeError(f"the caller aborted the run ({after})")
        outputs, record = _job(mesh, **job)
        records = [None] * mesh.world
        dist.all_gather_object(records, record)
        results.append({"outputs": outputs, "ranks": records})
    return results


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Launch an ``n_devices``-rank mesh over the whole sharded chain and
    ``sharded_flow_label``; prints and returns the summary line."""
    n = int(n_devices)
    n_x = 2 if n % 2 == 0 and n >= 4 else 1
    n_t = n // n_x
    t, h, w = 2 * n_t, 32, 32 * n_x
    bt, wvd, swd = synthetic(t, h, w)
    # the CLI's flow passes, and an x halo that covers the warp band and the
    # peak filter's 16-px stencil
    job = {"fields": (bt, wvd, swd), "label_mask": bt < np.percentile(bt, 20),
           "kw": dict(hx=24, warp_radius=21, ws_sweeps=2, vr_steps=1, smoothing_passes=1,
                      interp_method="cubic")}
    out = launch(chain_jobs, n_t, n_x, [job], device=device)[0]["outputs"]
    labels = out["flow_labels"]
    plan = layout(n, device)
    line = (f"dryrun_multichip OK: mesh=(t={n_t}, x={n_x}), field shape={(t, h, w)}, "
            f"outputs={len(out) - 1}, thick={int(out['thick_anvil_labels'].max())}, "
            f"thin={int(out['thin_anvil_labels'].max())}, "
            f"sharded labels={len(np.unique(labels[labels != 0]))}, "
            f"backend={plan['backend']}, ranks per card={plan['ranks_per_card']}")
    print(line, flush=True)
    return line


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, help="ranks in the mesh")
    ap.add_argument("--device", default=None, help='"cpu" for gloo ranks on the CPU')
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
