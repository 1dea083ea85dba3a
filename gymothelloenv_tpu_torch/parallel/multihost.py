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
                                                       all_gather_cat,
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
    """The (n / model_parallel, model_parallel) mesh over every rank of
    the group (``make_mesh``)."""
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
    """Every data index's ``host_local`` (equal shapes) concatenated
    along ``axis`` in rank order, on every rank (one ``all_gather`` over
    the data group)."""
    return all_gather_cat(host_local, mesh, axis)


def add_mesh_flags(parser, replay: bool = False) -> None:
    """The off-policy CLIs' mesh flags (JAX ``cli/dqn_train.py``):
    ``--data-parallel``, ``--dist-backend`` and, with ``replay``,
    ``--replay-sharding``."""
    parser.add_argument("--data-parallel", type=int, default=0,
                        help="shard the games and the updates over this "
                             "many ranks, one process a rank as torchrun "
                             "starts them (torchrun --nproc-per-node N; "
                             "0 = no mesh)")
    parser.add_argument("--dist-backend", choices=BACKENDS, default="nccl",
                        help="the ranks' collectives: nccl (one card a "
                             "rank) or gloo (CPU ranks, or several ranks "
                             "on one card)")
    if replay:
        parser.add_argument("--replay-sharding", default="replicated",
                            choices=("replicated", "per-shard"),
                            help="replay layout under --data-parallel: "
                                 "'replicated' = the whole ring on every "
                                 "rank (exact global PER); 'per-shard' = "
                                 "each rank owns capacity/N of it, "
                                 "sampling still globally prioritized "
                                 "(parallel/replay_shards.py)")


def mesh_from_flags(parser, args) -> DataMesh | None:
    """The mesh of ``add_mesh_flags``' flags: ``None`` without
    ``--data-parallel`` (where ``--replay-sharding per-shard`` is a usage
    error, as JAX's CLIs make it); else this process joins the group
    ``torchrun``'s variables describe (``initialize``) and the mesh over
    it, which must have ``--data-parallel`` ranks.  ``--device cpu`` puts
    the rank on the CPU; otherwise nccl takes ``cuda:LOCAL_RANK``."""
    if not args.data_parallel:
        if getattr(args, "replay_sharding", "replicated") != "replicated":
            parser.error("--replay-sharding per-shard requires "
                         "--data-parallel")
        return None
    initialize(backend=args.dist_backend)
    device = None if args.device == "cuda" else args.device
    return make_mesh(args.data_parallel, backend=args.dist_backend,
                     device=device)


def leave(mesh: DataMesh | None) -> None:
    """Leave the process group ``mesh_from_flags`` joined, if any."""
    if mesh is not None and dist.is_initialized():
        dist.destroy_process_group()

