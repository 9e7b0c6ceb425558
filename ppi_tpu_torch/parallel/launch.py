"""Start the ranks of a sample-parallel run.

The JAX package is single-controller: one process drives every device of a
``jax.sharding.Mesh``, and its tests make 8 virtual CPU devices. PyTorch
runs one process per rank, so the port's counterpart of that virtual-device
mesh is this module: ``spawn`` starts ``n_ranks`` processes that join one
``torch.distributed`` group, and ``parallel.mesh`` lays its mesh over them.
It is no feature of its own.

Backend rule, applied once when a rank joins, never switched after a
failure: ``nccl`` when every rank has a card of its own; ``gloo`` when
ranks share a card (NCCL refuses two ranks on one card) or run on the CPU.

Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` in the environment) nothing
is spawned: ``parallel.mesh.make_mesh`` joins the launcher's group with the
same rule.
"""

import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``cuda:{rank % cards}`` for a CUDA device,
    the CPU only when asked for."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available")
    return torch.device("cuda", rank % cards)


def backend_for(device, n_ranks: int) -> str:
    """``nccl`` when every one of ``n_ranks`` has a card of its own, else
    ``gloo``."""
    device = torch.device(device)
    if device.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def join_group(rank: int, n_ranks: int, init_method: str, device) -> None:
    """Make ``rank``'s device current and join the group of ``n_ranks``
    ranks at ``init_method`` with the backend of ``backend_for``."""
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev, n_ranks),
                            init_method=init_method, world_size=n_ranks,
                            rank=rank)


def in_group() -> bool:
    """Whether this process is a rank of a process group already: one
    started by ``spawn`` or by ``torchrun``."""
    return dist.is_initialized() or "RANK" in os.environ


def call_main(rank, main, args):
    """A spawned rank of a runner: its ``main(args)`` (which, in the group,
    makes the mesh over it)."""
    del rank
    return main(args)


def _rank_main(rank, fn, n_ranks, workdir, device, args):
    join_group(rank, n_ranks, f"file://{workdir}/pg", device)
    try:
        out = fn(rank, *args)
        if rank == 0:
            torch.save(out, Path(workdir) / "result.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, *args, device="cuda", workdir=None):
    """Run ``fn(rank, *args)`` in ``n_ranks`` new processes (the ``spawn``
    start method: ``fork`` breaks once the parent holds a CUDA context)
    that share one process group, and return rank 0's value.

    Each rank joins through a file under a fresh directory inside
    ``workdir`` (default: the system's temporary directory), so concurrent
    calls never share a rendezvous; sets its device
    (``rank_device(device, rank)``); calls ``fn``; and leaves the group.
    ``fn`` must be importable by name (a module-level function of a module
    that the children can import). An exception in any rank fails the call
    (``torch.multiprocessing.ProcessRaisedException``) and ends the
    others."""
    rank_device(device, 0)  # no card: raise here, before any process starts
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        mp.start_processes(_rank_main,
                           args=(fn, n_ranks, tmp, str(device), args),
                           nprocs=n_ranks, join=True, start_method="spawn")
        return torch.load(Path(tmp) / "result.pt", weights_only=False)
