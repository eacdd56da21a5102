"""Start the ranks of a (t, x) mesh and run one function on each (the
port's form of the reference's single controller, which drives every
device of a ``jax.sharding.Mesh`` from one process).

``launch(fn, n_t, n_x, *args, device=None, **kwargs)`` starts ``n_t·n_x``
processes with ``torch.multiprocessing`` (spawned, so ``fn`` must live in
an importable module, not in ``__main__``), joins them in one process
group through a rendezvous file in a fresh temporary directory, calls
``fn(mesh, *args, **kwargs)`` on every rank and returns rank 0's result.
A single rank runs in the calling process.  Any rank that fails ends the
run: the others are stopped and the error is raised here.

The layout is fixed before any rank starts (:func:`layout`): on the CPU
every rank runs gloo; on CUDA, ranks that each get a card of their own run
NCCL, and ranks that must share cards (more ranks than cards) run gloo,
rank ``r`` on card ``r % cards``, their card tensors staged through pinned
host memory.  The kernels are built once, before the ranks start; the
ranks only load them.  Large numpy arguments reach the ranks as memory maps
of files in the temporary directory, so that each reads only its tile.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tobac_flow_tpu_torch.device import resolve_device, set_ranks_per_card
from tobac_flow_tpu_torch.parallel.mesh import make_mesh

__all__ = ["launch", "layout"]

_SPILL_BYTES = 1 << 20  # numpy arguments from this size reach the ranks as memory maps
_TIMEOUT = datetime.timedelta(minutes=15)


def layout(world, device=None):
    """How ``world`` ranks map to cards: a dict with the device type, the
    cards used, the ranks per card and the backend (see the module's
    notes).  ``device=None`` means CUDA, and raises where CUDA is not
    available."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return {"device": "cpu", "ranks": world, "cards": 0, "ranks_per_card": 0,
                "backend": "gloo"}
    cards = min(world, torch.cuda.device_count())
    return {"device": "cuda", "ranks": world, "cards": cards,
            "ranks_per_card": -(-world // cards),
            "backend": "nccl" if world <= cards else "gloo"}


class _Spilled:
    """A numpy argument saved to ``path``; a rank opens it as a memory map."""

    def __init__(self, path):
        self.path = str(path)


def _spill(obj, folder, counter):
    if isinstance(obj, np.ndarray) and obj.nbytes >= _SPILL_BYTES:
        path = Path(folder) / f"arg{next(counter)}.npy"
        np.save(path, obj)
        return _Spilled(path)
    if isinstance(obj, (tuple, list)):
        return type(obj)(_spill(v, folder, counter) for v in obj)
    if isinstance(obj, dict):
        return {k: _spill(v, folder, counter) for k, v in obj.items()}
    return obj


def _unspill(obj):
    if isinstance(obj, _Spilled):
        return np.load(obj.path, mmap_mode="r")
    if isinstance(obj, (tuple, list)):
        return type(obj)(_unspill(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _unspill(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, folder):
    """One rank: read the run's spec, bind its card, join the group, build
    the mesh, run."""
    with open(Path(folder) / "spec.pkl", "rb") as f:
        plan, n_t, n_x, threads, fn, args, kwargs = pickle.load(f)
    world = plan["ranks"]
    if plan["device"] == "cuda":
        card = rank % plan["cards"]
        torch.cuda.set_device(card)
        device = torch.device("cuda", card)
        set_ranks_per_card(sum(1 for r in range(world) if r % plan["cards"] == card))
    else:
        device = torch.device("cpu")
    if world > 1:
        torch.set_num_threads(threads)
    dist.init_process_group(plan["backend"], init_method=f"file://{folder}/rendezvous",
                            rank=rank, world_size=world, timeout=_TIMEOUT)
    try:
        mesh = make_mesh(n_t, n_x, device=device)
        result = fn(mesh, *_unspill(args), **_unspill(kwargs))
        if rank == 0:
            with open(Path(folder) / "result.pkl", "wb") as f:
                pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn, n_t, n_x, *args, device=None, **kwargs):
    """Run ``fn(mesh, *args, **kwargs)`` on every rank of an ``n_t`` x
    ``n_x`` mesh and return rank 0's result (see the module's notes).
    ``device=None`` means CUDA, and raises where CUDA is not available;
    ``device="cpu"`` runs gloo ranks on the CPU."""
    world = int(n_t) * int(n_x)
    plan = layout(world, device)
    if plan["device"] == "cuda":
        from tobac_flow_tpu_torch.ops.ws_sweeps import build_library

        build_library()
    folder = tempfile.mkdtemp(prefix="tft_mesh_")
    try:
        counter = iter(range(1 << 30))
        # the spec goes through a file: a spawned child reads its pipe only
        # once it has imported its modules, so a large pipe payload would
        # start the ranks one after another
        with open(Path(folder) / "spec.pkl", "wb") as f:
            # the ranks together take no more intra-op threads than the caller
            threads = max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // world))
            pickle.dump((plan, int(n_t), int(n_x), threads, fn, _spill(args, folder, counter),
                         _spill(kwargs, folder, counter)), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        if world == 1:
            _rank_main(0, folder)
        else:
            mp.start_processes(_rank_main, args=(folder,), nprocs=world, join=True,
                               start_method="spawn")
        with open(Path(folder) / "result.pkl", "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
