"""Process-group initialization for many ranks, one device each
(counterpart of deepprior_tpu/parallel/multihost.py).

Launch every rank with torchrun, which sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT; ``initialize()`` reads them.  On a node of N
cards: ``torchrun --nproc-per-node N -m deepprior_tpu_torch.mains.<main>
--dp D --tp T``; across hosts, torchrun's --nnodes and --rdzv-endpoint.
Other launchers pass the coordinator's address, the world size and the
rank, or a ``torch.distributed`` store.  Then ``global_mesh`` is the
('dp', 'tp') mesh over every rank of every host.

On CUDA the group is NCCL and each rank takes the card LOCAL_RANK; on the
CPU it is gloo.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from deepprior_tpu_torch.parallel.mesh import data_rank, make_mesh

LAUNCHER = ("torchrun --nproc-per-node N -m deepprior_tpu_torch.mains.<main> "
            "--dp D --tp T (one process per device)")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
    store=None,
    backend: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` for this rank.

    Without arguments it reads torchrun's environment.  With
    ``coordinator_address`` ('host:port') or ``store`` (e.g. a
    ``FileStore``), ``num_processes`` and ``process_id`` name the world and
    this rank.  ``device`` 'cuda' (the default when a card is present)
    selects the card LOCAL_RANK before anything touches CUDA and an NCCL
    group; 'cpu' a gloo group; ``backend`` overrides (e.g.
    'cpu:gloo,cuda:gloo').  Idempotent: a process whose group is
    initialized returns at once."""
    if dist.is_initialized():
        return
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if store is not None or coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("num_processes and process_id are needed with a "
                             "coordinator address or a store")
        kw = dict(store=store) if store is not None else dict(
            init_method=coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, rank=int(process_id),
                                world_size=int(num_processes), **kw)
        return
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError(
            "no process group: RANK and WORLD_SIZE are not set. Launch with "
            f"{LAUNCHER}, or pass the coordinator address, num_processes "
            "and process_id")
    dist.init_process_group(backend, init_method="env://")


def global_mesh(tp: int = 1, slices: int = 1):
    """The ('dp', 'tp') mesh — ('dcn', 'dp', 'tp') with slices > 1 — over
    every rank of every host.  Consecutive ranks (one host's cards) share a
    tp group; the batch splits over the rest."""
    return make_mesh(tp=tp, slices=slices)


def process_local_batch_slice(global_batch: int, mesh=None) -> slice:
    """The rows of a globally indexed batch that this process feeds: its
    block of the data-parallel ranks of ``mesh`` (tp ranks of one data rank
    feed the same rows), or of every rank without a mesh."""
    if mesh is not None:
        index, count = data_rank(mesh)
    elif dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    if global_batch % count:
        # silent truncation would make the ranks jointly feed fewer rows
        # than the global batch holds
        raise ValueError(
            f"global_batch {global_batch} not divisible by the {count} "
            "data-parallel processes")
    per = global_batch // count
    return slice(per * index, per * (index + 1))


def is_writer() -> bool:
    """True on the rank that writes a run's files (rank 0, or no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """A barrier over the world, where there is a group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _spawned_rank(rank, fn, nprocs, store_path, args):
    torch.set_num_threads(1)
    initialize(store=dist.FileStore(store_path, nprocs), num_processes=nprocs,
               process_id=rank, device="cpu")
    try:
        fn(rank, nprocs, *args)
    finally:
        dist.destroy_process_group()


def spawn_cpu(fn, nprocs: int, args=(), store_path: Optional[str] = None) -> None:
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` fresh processes, each a
    rank of one gloo group over a ``FileStore`` at ``store_path`` (a path
    that does not exist yet; default: a new temporary file), with one
    intra-op thread each: the CPU stand-in for torchrun that the dry run
    and the tests use.  ``fn`` must be importable by name.  A rank's
    exception re-raises here."""
    import tempfile

    import torch.multiprocessing as mp

    tmp = None
    if store_path is None:
        tmp = tempfile.mkdtemp(prefix="deepprior_store_")
        store_path = os.path.join(tmp, "store")
    try:
        mp.start_processes(_spawned_rank, args=(fn, nprocs, store_path, tuple(args)),
                           nprocs=nprocs, start_method="spawn")
    finally:
        if tmp is not None:
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
