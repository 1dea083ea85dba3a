"""The sharded PPO self-play train step — the port of ``parallel/dp.py``:
the game batch (and every (T, N, ...) rollout tensor) split over the mesh's
data axis, ``PolicyNet``'s wide layers split over its model axis
(``sharding.POLICY_TP_RULES``, JAX's ``_POLICY_TP_RULES``), everything else
replicated.  JAX writes one GSPMD program and lets XLA insert the
collectives; here they are written out, Megatron's way:

  * the trunk is replicated; its features enter the column-parallel ``fc``
    (this model index's ``hidden / m`` output units and their bias)
    through ``CopyToModel``, identity forward and a model-axis all-reduce
    of the gradient backward;
  * the heads are row-parallel: each model index multiplies its ``hidden /
    m`` units by its rows of the value and logits kernels, the partial
    products are summed over the model axis by ``ReduceFromModel``
    (all-reduce forward, identity backward), and the heads' biases,
    replicated, are added once, after the sum;
  * every gradient, of a sharded or a replicated leaf, is summed over the
    data axis only (``agents.ppo.ppo_update(mesh=)``);
  * the global-norm clip (``max_grad_norm``, optax's
    ``clip_by_global_norm``) counts each sharded leaf's slices over the
    model axis once and each replicated leaf once (``global_grad_norm``),
    so it scales as at world 1.

A model axis of 1 is plain data parallelism: the net is the replicated
``PolicyNet`` itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gymothelloenv_tpu_torch.agents.ppo import (Optimizer, PPOConfig,
                                                ppo_update)
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.parallel.sharding import (all_reduce_sum,
                                                       place_replicated,
                                                       policy_param_shardings,
                                                       shard_batch_tree)
from gymothelloenv_tpu_torch.train.self_play import collect_rollout
from gymothelloenv_tpu_torch.utils.device import use_float32


class CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis
    backward (the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        all_reduce_sum([grad], ctx.mesh, group="model")
        return grad, None


class ReduceFromModel(torch.autograd.Function):
    """The partial products summed over the model axis forward; identity
    backward (the output of a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, mesh):
        x = x.contiguous().clone()
        all_reduce_sum([x], mesh, group="model")
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TPPolicyNet(nn.Module):
    """A feed-forward float32 ``PolicyNet`` split over ``mesh``'s model
    axis: the trunk whole, ``fc`` this model index's ``hidden / m``
    output units, ``value`` and ``logits`` its ``hidden / m`` input
    columns with their biases whole.  The parameters keep
    ``PolicyNet``'s names, the split ones marked ``model_split`` (for
    ``sharding.all_reduce_grads``); ``forward(x)`` gives the whole
    ``(logits, value)`` on every model index."""

    def __init__(self, net: nn.Module, mesh):
        super().__init__()
        if getattr(net, "recurrent", False) or net.dtype != torch.float32:
            raise ValueError("tensor parallelism splits the feed-forward "
                             "float32 PolicyNet only")
        m, k = mesh.model_parallel, mesh.model_rank
        if net.hidden_size % m:
            raise ValueError(f"hidden_size {net.hidden_size} not divisible "
                             f"by model_parallel={m}")
        self.mesh = mesh
        self.hidden_size = net.hidden_size
        self.recurrent = False
        self.dtype = torch.float32
        self.trunk = net.trunk
        split = policy_param_shardings(mesh, net)
        full = dict(net.named_parameters())
        per = net.hidden_size // m
        self.fc = nn.Linear(net.fc.in_features, per)
        self.value = nn.Linear(per, 1)
        self.logits = nn.Linear(per, net.logits.out_features)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.startswith("trunk."):
                    continue
                src = full[name]
                axis = split[name]
                if axis is not None:
                    src = src.narrow(axis, k * per, per)
                    p.model_split = True
                p.copy_(src)
        self.to(full["fc.weight"].device)

    def forward(self, x: torch.Tensor):
        feat = CopyToModel.apply(self.trunk(x), self.mesh)
        h = torch.relu(self.fc(feat))
        partial = torch.cat([F.linear(h, self.logits.weight),
                             F.linear(h, self.value.weight)], dim=-1)
        out = ReduceFromModel.apply(partial, self.mesh)
        logits = out[..., :-1] + self.logits.bias
        value = (out[..., -1:] + self.value.bias)[..., 0]
        return logits, value


def sharded_names(net: nn.Module, mesh) -> set:
    """The names of ``net``'s parameters that are split over the model
    axis."""
    return {name for name, axis in policy_param_shardings(mesh, net).items()
            if axis is not None}


def full_state_dict(net: nn.Module, mesh) -> dict:
    """``PolicyNet``'s whole state dict from a ``TPPolicyNet`` (each split
    parameter's slices all-gathered over the model axis, every rank
    calling), or ``net``'s own."""
    if not isinstance(net, TPPolicyNet):
        return {k: v.detach().clone() for k, v in net.state_dict().items()}
    split = policy_param_shardings(mesh, net)
    out = {}
    for name, p in net.state_dict().items():
        axis = split.get(name)
        if axis is None:
            out[name] = p.detach().clone()
            continue
        parts = [torch.empty_like(p) for _ in range(mesh.model_parallel)]
        torch.distributed.all_gather(parts, p.detach().contiguous(),
                                     group=mesh.model_group)
        out[name] = torch.cat(parts, dim=axis)
    return out


def global_grad_norm(params, sharded, mesh) -> torch.Tensor:
    """The world-1 gradient norm of a split net: the squared norms of the
    ``sharded`` (a bool a parameter) leaves' slices summed over the model
    axis, those of the replicated leaves once."""
    sq = torch.zeros(2, dtype=torch.float32, device=params[0].device)
    for p, cut in zip(params, sharded):
        sq[int(cut)] += p.grad.to(torch.float32).pow(2).sum()
    parts = sq[1:].clone()
    all_reduce_sum([parts], mesh, group="model")
    return torch.sqrt(sq[0] + parts[0])


class ShardedOptimizer(Optimizer):
    """``agents.ppo.Optimizer`` (global-norm clip, then Adam with the
    linear decay) over a split net's parameters, its clip by
    ``global_grad_norm`` (each step's norm kept in ``last_norm``, a
    tensor); Adam is elementwise, so each rank's Adam on its slices is
    the slices of world 1's."""

    def __init__(self, net: nn.Module, cfg: PPOConfig, mesh):
        super().__init__(net.parameters(), cfg)
        cut = sharded_names(net, mesh)
        self.mesh = mesh
        self.sharded = [name in cut for name, p in net.named_parameters()
                        if p.requires_grad]
        self.last_norm = None

    def step(self) -> None:
        norm = global_grad_norm(self.params, self.sharded, self.mesh)
        self.last_norm = norm
        factor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                             self.max_norm / norm)
        for p in self.params:
            p.grad.mul_(factor)
        self.adam.step()
        if self.schedule is not None:
            self.schedule.step()


def make_sharded_train_step(mesh, env_cfg: EnvConfig, ppo_cfg: PPOConfig,
                            num_steps: int, init_rand_steps: int = 0):
    """Returns ``(train_step, place_params, place_selfplay_state)`` (JAX
    ``make_sharded_train_step``):

      * ``place_params(net) -> (net, optimizer)``: rank 0's ``PolicyNet``
        on every rank (a broadcast), split into a ``TPPolicyNet`` when the
        model axis is above 1, and its ``ShardedOptimizer``;
      * ``place_selfplay_state(sp_state)``: this data index's games of a
        global ``train.self_play.SelfPlayState`` (every model index of it
        holds the same);
      * ``train_step(net, optimizer, sp_state, draws, epoch_words) ->
        (sp_state, metrics)``: one collection of ``num_steps`` slots on
        this rank's games (``draws``: a ``train.self_play.ShardedDraws``
        over the global stream) and one ``ppo_update`` of the global
        batch, in place on ``net`` and ``optimizer``.

    Like every entry point that runs the net, it switches TF32 off
    (``utils.device.use_float32``).
    """
    use_float32()

    def place_params(net):
        place_replicated(net, mesh)
        if mesh.model_parallel > 1:
            net = TPPolicyNet(net, mesh)
        return net, ShardedOptimizer(net, ppo_cfg, mesh)

    def place_selfplay_state(sp_state):
        n = sp_state.pcolor.shape[0]
        return shard_batch_tree(mesh, sp_state, axis=0, batch_size=n)

    def train_step(net, optimizer, sp_state, draws, epoch_words):
        sp_state, rollout, bootstrap = collect_rollout(
            net, sp_state, env_cfg, num_steps, draws, init_rand_steps)
        metrics = ppo_update(net, optimizer, rollout, bootstrap,
                             epoch_words, ppo_cfg, mesh=mesh)
        return sp_state, metrics

    return train_step, place_params, place_selfplay_state
