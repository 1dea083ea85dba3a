"""The (data, model) mesh and its collectives — the port of
``parallel/sharding.py`` in PyTorch's idiom: one process per GPU under
``torch.distributed`` (as ``torchrun`` starts them).  JAX lays its devices
out as an (n / m, m) ``Mesh`` with axes ``data`` and ``model`` and lets
GSPMD insert the collectives; here a ``DataMesh`` names this process's
place on the two axes and the process groups of each: process ``p`` sits
at data index ``p // m`` and model index ``p % m``, as JAX's reshape puts
device ``p``.  Each data index owns ``N / (n / m)`` games of the global
batch; the ``m`` processes of one data index hold the same games and the
same replicated parameters (JAX's trainers only replicate over
``model``), or, under ``parallel/dp.py``'s tensor parallelism, each its
slice of ``PolicyNet``'s wide layers (``policy_param_shardings``).
Gradients are summed over the data group only.

The backend is explicit, ``nccl`` or ``gloo``, and never chosen from what
is found: ``make_mesh`` refuses a group of another backend.  NCCL puts one
rank on a card; gloo runs ranks on the CPU, or several ranks on one card
(its collectives take CUDA tensors).

JAX's ``constrain_batch``, ``constrain_batch_axes`` and
``constrain_replicated`` are GSPMD sharding hints inside a traced
program; eager PyTorch has no counterpart (each process holds only its
slice, ``shard_batch_tree``/``shard_batch_axes``), so they are not
ported.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from gymothelloenv_tpu_torch.utils.device import resolve_device

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place on the (data, model) mesh: ``rank`` of
    ``world`` along the data axis (the data index and the data axis's
    size) and ``model_rank`` of ``model_parallel`` along the model axis,
    over ``backend``, its games and net on ``device``.  ``data_group``:
    the processes of this model index, one a data index (``None``: the
    default group, every process, when ``model_parallel`` is 1, or no
    group at all for a single process that never initialised one);
    ``model_group``: the processes of this data index (``None`` when
    ``model_parallel`` is 1)."""
    rank: int
    world: int
    device: torch.device
    backend: str
    model_rank: int = 0
    model_parallel: int = 1
    data_group: object = dataclasses.field(default=None, compare=False,
                                           repr=False)
    model_group: object = dataclasses.field(default=None, compare=False,
                                            repr=False)

    def shard(self, n: int) -> tuple[int, int]:
        """``(per_rank, offset)`` of this data index's share of ``n`` rows;
        ``n`` must divide by the data axis."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.world} ranks")
        per = n // self.world
        return per, self.rank * per

    @property
    def distributed(self) -> bool:
        """Whether collectives go through a process group (a world of one
        without a group reduces to the identity)."""
        return dist.is_initialized()

    @property
    def process_rank(self) -> int:
        """This process's rank in the default group."""
        return self.rank * self.model_parallel + self.model_rank


def check_data_mesh(mesh) -> DataMesh:
    """``mesh`` if it is a ``DataMesh`` (with or without a model axis);
    anything else (a JAX mesh) raises ``TypeError``."""
    if not isinstance(mesh, DataMesh):
        raise TypeError(
            f"mesh must be a DataMesh from gymothelloenv_tpu_torch.parallel."
            f"make_mesh, got {type(mesh).__name__}")
    return mesh


def mesh_device(mesh: DataMesh | None, device) -> torch.device:
    """A trainer's device: ``resolve_device(device)`` without a mesh, the
    mesh's device with one (a ``device`` that is not the mesh's
    raises)."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def owned_rows(idx: torch.Tensor, num_games: int, mesh: DataMesh):
    """For global flat rows ``idx`` of a (T, N) batch whose games are
    spread over the ranks: ``(mine, local)``, the mask of the rows this
    rank's games hold and their flat rows in its (T, N / world) share."""
    per, off = mesh.shard(num_games)
    col = idx % num_games
    mine = (col >= off) & (col < off + per)
    return mine, (idx[mine] // num_games) * per + (col[mine] - off)


def _default_device(backend: str, rank: int) -> torch.device:
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % max(torch.cuda.device_count(),
                                                1))
    return resolve_device(None)


def make_mesh(n_devices: int | None = None, model_parallel: int = 1,
              backend: str = "nccl", device=None) -> DataMesh:
    """The (n / m, m) mesh over every rank of the initialised process
    group (``multihost.initialize``), ``m = model_parallel``, or over this
    process alone when no group is initialised (then ``n_devices`` must
    be 1 or ``None``).  ``n_devices``, when given, must equal the world
    size, and ``model_parallel`` must divide it (JAX's ``ValueError``).
    With ``m > 1`` every rank makes the m data groups and the n / m model
    groups with ``dist.new_group``, in the same order, so every rank must
    call this together.  ``device``: this rank's device (default:
    ``cuda:LOCAL_RANK`` under nccl, the current card under gloo; pass
    ``"cpu"`` for CPU ranks).  A group of another backend raises
    ``ValueError``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if dist.is_initialized():
        found = dist.get_backend()
        if found != backend:
            raise ValueError(f"the process group runs {found!r}, not the "
                             f"{backend!r} this mesh was asked for")
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if n_devices not in (None, world):
        raise ValueError(f"n_devices={n_devices}, but the group has "
                         f"{world} ranks (one device a rank)")
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_parallel={model_parallel}")
    device = (_default_device(backend, rank) if device is None
              else torch.device(device))
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl ranks run on a card, not {device}")
    m, data = model_parallel, world // model_parallel
    data_group = model_group = None
    if m > 1:
        for k in range(m):
            group = dist.new_group([d * m + k for d in range(data)])
            if k == rank % m:
                data_group = group
        for d in range(data):
            group = dist.new_group([d * m + k for k in range(m)])
            if d == rank // m:
                model_group = group
    return DataMesh(rank=rank // m, world=data, device=device,
                    backend=backend, model_rank=rank % m, model_parallel=m,
                    data_group=data_group, model_group=model_group)


# Tensor-parallel split of PolicyNet (JAX ``_POLICY_TP_RULES``): the wide fc
# and the heads' kernels are the only layers worth sharding; the trunk and
# the heads' biases replicate.  Each entry: the parameter's name and the
# torch axis split over ``model`` (torch's Linear weight is JAX's kernel
# transposed: JAX's fc columns are torch's rows, its head rows torch's
# columns).
POLICY_TP_RULES = (
    ("fc.weight", 0),       # Dense_0/kernel P(None, "model"): columns
    ("fc.bias", 0),         # Dense_0/bias P("model")
    ("value.weight", 1),    # Dense_1/kernel P("model", None): rows
    ("logits.weight", 1),   # Dense_2/kernel P("model", None): rows
)


def policy_param_shardings(mesh: DataMesh, net: torch.nn.Module) -> dict:
    """The split of each of ``net``'s (a ``PolicyNet``'s) parameters over
    the model axis: ``{name: axis}``, the torch axis a ``POLICY_TP_RULES``
    parameter is cut on, ``None`` where it replicates, and every
    parameter replicated on a mesh whose model axis is 1 (JAX
    ``policy_param_shardings``)."""
    rules = dict(POLICY_TP_RULES) if mesh.model_parallel > 1 else {}
    return {name: rules.get(name) for name, _ in net.named_parameters()}


# --- collectives ------------------------------------------------------------

def _all_reduce(buf: torch.Tensor, mesh: DataMesh, op,
                group: str = "data", replicate: bool = True) -> None:
    """``buf`` reduced in place over the mesh's ``group`` axis (``"data"``
    or ``"model"``).  A data-axis reduction on a mesh with a model axis
    is then copied from model index 0 to the others (``replicate``): the
    model ranks of a data index compute the same values, but a card's
    kernels (cuDNN's weight gradient) need not round alike from run to
    run, and replicated state must stay bit-equal as JAX's does."""
    size = mesh.world if group == "data" else mesh.model_parallel
    if size > 1:
        if not mesh.distributed:
            raise RuntimeError("a mesh of several ranks needs an "
                               "initialised process group")
        dist.all_reduce(buf, op=op, group=getattr(mesh, f"{group}_group"))
    if group == "data" and replicate and mesh.model_parallel > 1:
        dist.broadcast(buf, src=mesh.rank * mesh.model_parallel,
                       group=mesh.model_group)


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: DataMesh,
                   op=None, group: str = "data",
                   replicate: bool = True) -> list:
    """Sum (or reduce with ``op``) ``tensors`` over the mesh's data axis
    (or ``group="model"``: its model axis) in place, with one collective
    a dtype (the tensors flattened into one buffer); ``replicate``: as
    ``_all_reduce``'s (``False`` for tensors split over the model axis).
    Returns the tensors."""
    op = dist.ReduceOp.SUM if op is None else op
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        buf = torch.cat([t.reshape(-1) for t in same])
        _all_reduce(buf, mesh, op, group, replicate)
        start = 0
        for t in same:
            t.copy_(buf[start:start + t.numel()].view_as(t))
            start += t.numel()
    return list(tensors)


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: DataMesh) -> list:
    """``all_reduce_sum`` divided by the data axis's size."""
    out = all_reduce_sum(tensors, mesh)
    for t in out:
        t.div_(mesh.world)
    return out


def all_reduce_grads(params: Sequence[torch.Tensor], mesh: DataMesh,
                     extra: Sequence[torch.Tensor] = ()) -> None:
    """Sum the parameters' ``.grad`` (zeros where a parameter has none)
    and ``extra`` tensors over the data axis in one collective;
    afterwards every data index holds the same gradients.  The model
    axis is not summed: its ranks hold the same gradients (copied from
    model index 0, ``_all_reduce``), or each its own slice's (a
    parameter split over the model axis, marked ``model_split`` by
    ``parallel.dp.TPPolicyNet``, summed in a collective of its own)."""
    grads, split = [], []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        (split if getattr(p, "model_split", False) else grads).append(p.grad)
    all_reduce_sum(grads + list(extra), mesh)
    if split:
        all_reduce_sum(split, mesh, replicate=False)


def global_sums(values: Sequence[torch.Tensor], mesh: DataMesh | None) -> list:
    """Each 0-d tensor of ``values`` summed over the mesh's ranks (as
    float32; as given without a mesh), in one collective."""
    if mesh is None:
        return list(values)
    buf = torch.stack([v.to(torch.float32) for v in values])
    all_reduce_sum([buf], mesh)
    return list(buf)


def global_mean(x: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The mean of ``x`` over every rank's rows: ``x.mean()`` without a
    mesh; on one, this rank's sum over the global count (its own count
    times the world, every rank holding as many rows), whose gradient,
    summed over the ranks, is the world-1 mean's."""
    if mesh is None:
        return x.mean()
    return x.sum() / (x.numel() * mesh.world)


def is_main(mesh: DataMesh | None) -> bool:
    """Whether this process logs and writes checkpoints: process 0, or
    the only process."""
    return mesh is None or mesh.process_rank == 0


def all_gather_cat(t: torch.Tensor, mesh: DataMesh, axis: int = 0
                   ) -> torch.Tensor:
    """Every data index's ``t`` (equal shapes) concatenated along
    ``axis`` in data-rank order, on every rank (one ``all_gather`` over
    the data group; ``t`` itself at a data axis of 1)."""
    if mesh.world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
    return torch.cat(parts, dim=axis)


def global_any(flag: torch.Tensor, mesh: DataMesh) -> bool:
    """Whether ``flag`` (a bool tensor) holds anywhere on any data
    index."""
    buf = flag.any().to(torch.int32).reshape(1)
    _all_reduce(buf, mesh, dist.ReduceOp.MAX)
    return bool(buf.item())


# --- trees ------------------------------------------------------------------

def tree_map(fn, tree):
    """``fn`` on every tensor of ``tree`` (tensors, and dicts, lists,
    tuples and dataclasses of them); other leaves pass through."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` (tensors, dicts, lists and tuples of them,
    modules: their state dict's values)."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return []


def replicated(tensor: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Rank 0's value of ``tensor`` on every rank (a new tensor)."""
    out = tensor.detach().clone().contiguous()
    if mesh.distributed:
        dist.broadcast(out, src=0)
    return out


def place_replicated(tree, mesh: DataMesh):
    """Broadcast every tensor of ``tree`` (or a module's parameters and
    buffers) from rank 0, in place, so that every rank holds rank 0's
    values; returns ``tree``."""
    if mesh.distributed:
        with torch.no_grad():
            for t in tree_leaves(tree):
                buf = t.contiguous()
                dist.broadcast(buf, src=0)
                if buf.data_ptr() != t.data_ptr():
                    t.copy_(buf)
    return tree


def _slice(t: torch.Tensor, axis: int, mesh: DataMesh, n: int):
    per, off = mesh.shard(n)
    return t.narrow(axis, off, per)


def shard_batch_tree(mesh: DataMesh, tree, axis: int = 0,
                     batch_size: int | None = None):
    """This rank's slice of a global batch tree: every tensor whose
    ``axis`` has extent ``batch_size`` (any extent when ``None``) keeps
    its rows ``[rank * N / world, (rank + 1) * N / world)`` there; 0-d
    and shorter tensors pass whole."""
    def cut(t):
        if t.dim() <= axis:
            return t
        if batch_size is not None and t.shape[axis] != batch_size:
            return t
        return _slice(t, axis, mesh, t.shape[axis])
    return tree_map(cut, tree)


def shard_batch_axes(mesh: DataMesh, tree, sizes: Sequence[int]):
    """This rank's slice of a heterogeneous batch tree: each tensor is cut
    on the first of its axes 0 and 1 whose extent is one of ``sizes``
    (tried in order); other tensors pass whole (JAX
    ``shard_batch_axes``)."""
    def cut(t):
        for size in sizes:
            for ax, extent in enumerate(t.shape[:2]):
                if extent == size:
                    return _slice(t, ax, mesh, size)
        return t
    return tree_map(cut, tree)


def assert_tree_allclose(a, b, rtol=5e-3, atol=1e-5, name="tree",
                         require_finite=False):
    """The 1-vs-N parity gate's comparator (JAX's, same defaults): the
    leaves of ``a`` and ``b`` (tensors, numpy arrays, state dicts,
    modules) agree to ``rtol``/``atol``; ``require_finite`` also refuses
    non-finite values in ``b``."""
    flat_a, flat_b = _np_leaves(a), _np_leaves(b)
    assert len(flat_a) == len(flat_b), name
    for i, (x, y) in enumerate(zip(flat_a, flat_b)):
        if require_finite and not np.all(np.isfinite(y.astype(np.float64))):
            raise AssertionError(f"{name}: non-finite values in leaf {i}")
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                   err_msg=f"{name}: 1-vs-N divergence "
                                           f"(leaf {i})")


def _np_leaves(tree) -> list:
    if isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict) and not isinstance(tree, torch.Tensor):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    return [t.detach().to("cpu").numpy() for t in tree_leaves(tree)]
