"""Process-group set-up across processes and hosts — the port of
``parallel/multihost.py`` over ``torch.distributed``.

Usage, one process a GPU (``torchrun --nproc-per-node <gpus> ...``, which
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``):

    from gymothelloenv_tpu_torch.parallel import multihost
    multihost.initialize(backend="nccl")
    mesh = multihost.make_pod_mesh(backend="nccl")
    trainer = PPOSelfPlayTrainer(..., mesh=mesh)   # N global games

Each rank then holds ``N / world`` games; ``host_batch_slice`` gives its
share of a global batch and ``assemble_global`` gathers the shares back.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from gymothelloenv_tpu_torch.parallel.sharding import (BACKENDS, DataMesh,
                                                       make_mesh)


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str = "nccl", timeout_s: float = 600.0) -> bool:
    """``torch.distributed.init_process_group`` over ``backend`` (``nccl``
    or ``gloo``, never switched).  Without arguments it reads the
    ``env://`` variables ``torchrun`` sets; ``init_method`` (e.g.
    ``tcp://localhost:29500`` or ``file:///tmp/rendezvous``),
    ``world_size`` and ``rank`` may be given instead.  A single process
    (no ``WORLD_SIZE`` or a world of 1, and no ``init_method``) is a
    no-op.  Under nccl the rank's card (``LOCAL_RANK``, else the rank) is
    made current first.  Returns whether a group was initialised."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None:
        if world_size == 1:
            return False
        init_method = "env://"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_pod_mesh(model_parallel: int = 1, backend: str = "nccl",
                  device=None) -> DataMesh:
    """The mesh over every rank of the group (``make_mesh``)."""
    return make_mesh(n_devices=None, model_parallel=model_parallel,
                     backend=backend, device=device)


def host_batch_slice(global_batch: int,
                     mesh: DataMesh | None = None) -> tuple[int, int]:
    """``(per-rank batch, offset)`` of this rank's share of a global batch
    (the group's rank and world when no mesh is given)."""
    if mesh is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        rank = dist.get_rank() if dist.is_initialized() else 0
        per = global_batch // world
        return per, rank * per
    return mesh.shard(global_batch)


def assemble_global(mesh: DataMesh, host_local: torch.Tensor,
                    axis: int = 0) -> torch.Tensor:
    """Every rank's ``host_local`` (equal shapes) concatenated along
    ``axis`` in rank order, on every rank (one ``all_gather``)."""
    if not mesh.distributed:
        return host_local
    parts = [torch.empty_like(host_local) for _ in range(mesh.world)]
    dist.all_gather(parts, host_local.contiguous())
    return torch.cat(parts, dim=axis)
