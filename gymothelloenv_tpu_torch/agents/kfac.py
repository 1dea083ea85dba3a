"""K-FAC natural-gradient optimizer and the ACKTR update — the port of
``agents/kfac.py`` (the vendored ``algo/kfac.py``, :87-241, and the
``A2C_ACKTR(acktr=True)`` path).

Stacks of Dense and Conv2d layers, the two module types the vendored K-FAC
supports, as explicit parameters: a layer is ``{"w", "b"}``, ``w`` 2-D
``(in, out)`` in flax's layout (a conv's ``in`` is its patch row,
``c_in * k * k`` channel-major).  A forward (``stack_apply``) returns each
layer's Kronecker input rows (a dense layer's activations, a conv's im2col
patch rows, in JAX's ``conv_general_dilated_patches`` order) and takes an
optional zero perturbation of every pre-activation: autograd with respect
to that zero tensor gives the per-row ``dL/dz`` the Fisher factors need,
as JAX's ``jax.grad`` of the same trick does (no module hooks).

Per layer (kfac.py semantics):
  * running factors ``m_aa <- rho m_aa + (1 - rho) E[a a^T]`` (``a`` bias-
    augmented with a 1) and ``m_gg <- rho m_gg + (1 - rho) E[g g^T]``,
    ``g`` from the sampled Fisher loss scaled by the batch (kfac.py's
    grad-scale convention);
  * every ``t_inv`` steps: eigendecompositions of both factors
    (``torch.linalg.eigh``, eigenvalues clamped at 0), computed only on
    those steps;
  * precondition ``Q_g (Q_g^T grad Q_a / (d_g d_a^T + damping)) Q_a^T``;
  * the KL trust region scales every layer of a tower by ``min(1,
    sqrt(kl_clip / sum(nat . grad) lr^2))``;
  * SGD with momentum on the scaled natural gradients of the augmented
    weights.

The eigenvectors of LAPACK/cuSOLVER and XLA differ by sign and by
rotations within near-degenerate eigenspaces; the preconditioner does not
depend on either, so the tests compare natural gradients and steps, never
``q_a``/``q_g``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.parallel.sharding import (all_reduce_sum,
                                                       global_mean)
from gymothelloenv_tpu_torch.utils.device import resolve_device

_LAYER_LEAVES = ("d_a", "d_g", "m_aa", "m_gg", "momentum", "q_a", "q_g")


@dataclasses.dataclass(frozen=True)
class DenseSpec:
    n_in: int
    n_out: int
    act: str = "tanh"
    gain: float = 1.4142135623730951  # sqrt(2)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """NCHW conv; spatial dims are static so patch shapes stay fixed."""
    h: int
    w: int
    c_in: int
    c_out: int
    kernel: int
    stride: int = 1
    pad: int = 0
    act: str = "relu"
    gain: float = 1.4142135623730951

    @property
    def h_out(self) -> int:
        return (self.h + 2 * self.pad - self.kernel) // self.stride + 1

    @property
    def w_out(self) -> int:
        return (self.w + 2 * self.pad - self.kernel) // self.stride + 1


def mlp_specs(sizes: Sequence[int]) -> tuple:
    """Dense specs of the vendored MLP (tanh hidden, linear last;
    sqrt(2)/0.01 gains), JAX's ``mlp_stack_init``/``mlp_stack_apply``."""
    specs = []
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        specs.append(DenseSpec(n_in, n_out, act="none" if last else "tanh",
                               gain=0.01 if last else 1.4142135623730951))
    return tuple(specs)


def conv_trunk_specs(board_size: int, in_planes: int = 4) -> tuple:
    """The vendored CNNBase trunk (model.py:295-300): conv(32, k3, s2, p1)
    -> conv(64, k2) -> conv(64, k2) -> fc 512, all ReLU."""
    c1 = ConvSpec(board_size, board_size, in_planes, 32, kernel=3,
                  stride=2, pad=1)
    c2 = ConvSpec(c1.h_out, c1.w_out, 32, 64, kernel=2)
    c3 = ConvSpec(c2.h_out, c2.w_out, 64, 64, kernel=2)
    flat = 64 * c3.h_out * c3.w_out
    return (c1, c2, c3, DenseSpec(flat, 512, act="relu"))


def _activate(act: str, z: torch.Tensor) -> torch.Tensor:
    """``tanh``, ``relu`` (looked up on ``torch`` at the call) or none."""
    return z if act == "none" else getattr(torch, act)(z)


def _shape(spec) -> tuple:
    if isinstance(spec, ConvSpec):
        return (spec.kernel * spec.kernel * spec.c_in, spec.c_out)
    return (spec.n_in, spec.n_out)


def stack_init(specs, generator: torch.Generator | None = None,
               device=None) -> list:
    """``{"w", "b"}`` a layer: orthogonal ``w`` at the spec's gain, zero
    ``b`` (JAX ``stack_init``; the draws are torch's, not JAX's)."""
    params = []
    for spec in specs:
        shape = _shape(spec)
        w = torch.empty(shape)
        nn.init.orthogonal_(w, gain=spec.gain, generator=generator)
        params.append({"w": w.to(device), "b": torch.zeros(shape[1],
                                                           device=device)})
    return params


def mlp_stack_init(sizes: Sequence[int], generator=None,
                   device=None) -> list:
    """JAX ``mlp_stack_init``: orthogonal sqrt(2) hidden, 0.01 last."""
    return stack_init(mlp_specs(sizes), generator, device)


def _patch_rows(spec: ConvSpec, x: torch.Tensor) -> torch.Tensor:
    """im2col: (B, C, H, W) -> (B * h_out * w_out, C * k * k) patch rows,
    channel-major within a row as ``conv_general_dilated_patches``
    (``F.unfold``'s order).  The windows are a strided view copied once:
    ``F.unfold`` on CUDA launches a kernel an image, thousands a forward
    here."""
    k, s = spec.kernel, spec.stride
    if spec.pad:
        x = F.pad(x, (spec.pad,) * 4)
    windows = x.unfold(2, k, s).unfold(3, k, s)     # (B, C, h', w', k, k)
    return windows.permute(0, 2, 3, 1, 4, 5).reshape(-1, spec.c_in * k * k)


def stack_apply(params, specs, x: torch.Tensor, perturb=None):
    """The spec'd stack on ``x``; returns ``(out, layer_inputs)``,
    ``layer_inputs[i]`` the 2-D K-FAC input rows of layer i (dense: its
    input; conv: its patch rows).  ``perturb`` (zero tensors shaped like
    each layer's 2-D pre-activation rows) is added to the pre-activations;
    the gradient with respect to it is the per-row ``dL/dz``.  A dense
    layer after a conv flattens ``(B, c * h' * w')``."""
    inputs = []
    h = x
    for i, (spec, layer) in enumerate(zip(specs, params)):
        if isinstance(spec, ConvSpec):
            rows = _patch_rows(spec, h)
        else:
            if h.ndim > 2:
                h = h.reshape(h.shape[0], -1)
            rows = h
        inputs.append(rows)
        z = rows @ layer["w"] + layer["b"]
        if perturb is not None:
            z = z + perturb[i]
        z = _activate(spec.act, z)
        if isinstance(spec, ConvSpec):
            z = z.reshape(h.shape[0], spec.h_out, spec.w_out,
                          spec.c_out).permute(0, 3, 1, 2)
        h = z
    return h, inputs


def mlp_stack_apply(params, x: torch.Tensor, perturb=None):
    """JAX ``mlp_stack_apply``: tanh hidden layers, a linear last."""
    sizes = [p["w"].shape[0] for p in params] + [params[-1]["w"].shape[1]]
    return stack_apply(params, mlp_specs(sizes), x, perturb)


def stack_zero_perturb(params, specs, batch: int) -> list:
    """Zero pre-activation perturbations, one a layer, that require
    gradients."""
    out = []
    for spec, layer in zip(specs, params):
        rows = (batch * spec.h_out * spec.w_out
                if isinstance(spec, ConvSpec) else batch)
        out.append(torch.zeros(rows, layer["w"].shape[1],
                               device=layer["w"].device, requires_grad=True))
    return out


@dataclasses.dataclass(frozen=True)
class ACKTRConfig:
    """kfac.py:87-100 defaults."""
    lr: float = 0.25
    momentum: float = 0.9
    stat_decay: float = 0.99
    kl_clip: float = 0.001
    damping: float = 1e-2
    weight_decay: float = 0.0
    t_stat: int = 1      # Ts: Fisher-statistics refresh interval
    t_inv: int = 10      # Tf: eigendecomposition refresh interval
    gamma: float = 0.99
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01


@dataclasses.dataclass
class KFACLayerState:
    m_aa: torch.Tensor      # (in+1, in+1)
    m_gg: torch.Tensor      # (out, out)
    q_a: torch.Tensor
    d_a: torch.Tensor
    q_g: torch.Tensor
    d_g: torch.Tensor
    momentum: torch.Tensor  # (in+1, out) buffer on the augmented weights


@dataclasses.dataclass
class KFACState:
    layers: list
    step: int = 0


def kfac_init(params) -> KFACState:
    layers = []
    for layer in params:
        (n_in, n_out), dev = layer["w"].shape, layer["w"].device
        layers.append(KFACLayerState(
            m_aa=torch.eye(n_in + 1, device=dev),
            m_gg=torch.eye(n_out, device=dev),
            q_a=torch.eye(n_in + 1, device=dev),
            d_a=torch.ones(n_in + 1, device=dev),
            q_g=torch.eye(n_out, device=dev),
            d_g=torch.ones(n_out, device=dev),
            momentum=torch.zeros(n_in + 1, n_out, device=dev)))
    return KFACState(layers=layers)


def _augment(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, a.new_ones(a.shape[:-1] + (1,))], dim=-1)


@torch.no_grad()
def update_fisher_stats(state: KFACState, cfg: ACKTRConfig, layer_inputs,
                        fisher_g, mesh=None) -> None:
    """Fold one Fisher sample into the running Kronecker factors, in place
    (kfac.py:144-188).  The factors are batch means: on a ``mesh`` (each
    rank holding its share of the rows) the sums ``a^T a`` and ``g^T g``
    of every layer are summed over the ranks in one collective and divided
    by the global row count, so every rank folds in the global factors
    before its eigendecomposition."""
    world = 1 if mesh is None else mesh.world
    sums = []
    for a, g in zip(layer_inputs, fisher_g):
        batch = a.shape[0] * world
        a_aug = _augment(a)
        gs = g * batch                       # kfac.py grad-scale convention
        sums += [a_aug.T @ a_aug, gs.T @ gs]
    if mesh is not None:
        all_reduce_sum(sums, mesh)
    for i, (ls, a) in enumerate(zip(state.layers, layer_inputs)):
        batch = a.shape[0] * world
        cov_a, cov_g = sums[2 * i] / batch, sums[2 * i + 1] / batch
        ls.m_aa = cfg.stat_decay * ls.m_aa + (1 - cfg.stat_decay) * cov_a
        ls.m_gg = cfg.stat_decay * ls.m_gg + (1 - cfg.stat_decay) * cov_g


@torch.no_grad()
def refresh_eigendecomp(state: KFACState) -> None:
    """The factors' eigendecompositions, eigenvalues clamped at 0, in place
    (kfac.py:205-214); the caller runs it on refresh steps only."""
    for ls in state.layers:
        d_a, ls.q_a = torch.linalg.eigh(ls.m_aa)
        d_g, ls.q_g = torch.linalg.eigh(ls.m_gg)
        ls.d_a = torch.clamp(d_a, min=0.0)
        ls.d_g = torch.clamp(d_g, min=0.0)


@torch.no_grad()
def natural_gradients(state: KFACState, cfg: ACKTRConfig, grads) -> list:
    """Each layer's preconditioned gradient of the augmented weights,
    ``(in+1, out)``; ``grads`` as the params, ``{"w", "b"}`` a layer."""
    out = []
    for ls, grad in zip(state.layers, grads):
        g_aug = torch.cat([grad["w"], grad["b"][None, :]], dim=0)
        v1 = ls.q_g.T @ g_aug.T @ ls.q_a        # (out, in+1)
        v2 = v1 / (ls.d_g[:, None] * ls.d_a[None, :] + cfg.damping)
        out.append((ls.q_g @ v2 @ ls.q_a.T).T)
    return out


@torch.no_grad()
def kfac_step(params, state: KFACState, cfg: ACKTRConfig, grads) -> None:
    """Precondition ``grads``, apply the KL trust region and a momentum-SGD
    step to ``params`` in place (kfac.py:216-241); the step count
    advances."""
    precond = natural_gradients(state, cfg, grads)
    vg = sum((nat[:-1] * grad["w"]).sum() + (nat[-1] * grad["b"]).sum()
             for nat, grad in zip(precond, grads)) * cfg.lr ** 2
    nu = torch.clamp(torch.sqrt(cfg.kl_clip / (torch.abs(vg) + 1e-12)),
                     max=1.0)
    for ls, layer, nat in zip(state.layers, params, precond):
        ls.momentum = cfg.momentum * ls.momentum + nat * nu
        w_aug = torch.cat([layer["w"], layer["b"][None, :]], dim=0)
        w_aug = w_aug - cfg.lr * ls.momentum
        layer["w"].copy_(w_aug[:-1])
        layer["b"].copy_(w_aug[-1])
    state.step += 1


class Stack(nn.Module):
    """A spec'd stack's parameters (``w_i``, ``b_i``) as a module;
    ``layers()`` gives them as ``stack_apply``'s ``{"w", "b"}`` list."""

    def __init__(self, specs, params):
        super().__init__()
        self.specs = tuple(specs)
        self.w = nn.ParameterList([p["w"] for p in params])
        self.b = nn.ParameterList([p["b"] for p in params])

    def layers(self) -> list:
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    def forward(self, x: torch.Tensor, perturb=None):
        return stack_apply(self.layers(), self.specs, x, perturb)


class ACKTRAgent(nn.Module):
    """The actor and critic towers and their K-FAC states (JAX
    ``ACKTRAgent``).  ``forward(obs)`` is JAX's collector apply function:
    ``(logits, value)`` of (N, 4, B, B) planes, flattened first for the
    MLP towers (``make_mlp_apply_fn``), as planes for the conv towers
    (``make_conv_apply_fn``)."""

    def __init__(self, actor_specs, critic_specs, actor, critic):
        super().__init__()
        self.actor = Stack(actor_specs, actor)
        self.critic = Stack(critic_specs, critic)
        self.conv = isinstance(actor_specs[0], ConvSpec)
        self.kfac_actor = kfac_init(actor)
        self.kfac_critic = kfac_init(critic)

    def _apply(self, fn, recurse=True):
        """``Module.to`` and kin move the K-FAC states with the towers."""
        super()._apply(fn, recurse)
        for state in (self.kfac_actor, self.kfac_critic):
            for ls in state.layers:
                for k in _LAYER_LEAVES:
                    setattr(ls, k, fn(getattr(ls, k)))
        return self

    def forward(self, obs: torch.Tensor):
        x = obs.to(torch.float32)
        if not self.conv:
            x = x.reshape(x.shape[0], -1)
        logits, _ = self.actor(x)
        values, _ = self.critic(x)
        return logits, values[:, 0]

    def flax_tree(self) -> dict:
        """The JAX agent's checkpoint tree: ``actor``/``critic`` ``{"0":
        {"b", "w"}, ...}`` and ``kfac_actor``/``kfac_critic`` ``{"layers":
        {"0": {d_a, d_g, m_aa, m_gg, momentum, q_a, q_g}, ...}, "step":
        int32}``, float32 numpy."""
        def arr(t):
            return np.ascontiguousarray(t.detach().to("cpu").numpy())
        tree = {}
        for name in ("actor", "critic"):
            tree[name] = {str(i): {"b": arr(layer["b"]), "w": arr(layer["w"])}
                          for i, layer in enumerate(
                              getattr(self, name).layers())}
            state = getattr(self, f"kfac_{name}")
            tree[f"kfac_{name}"] = {
                "layers": {str(i): {k: arr(getattr(ls, k))
                                    for k in _LAYER_LEAVES}
                           for i, ls in enumerate(state.layers)},
                "step": np.asarray(state.step, np.int32)}
        return tree

    def load_flax_tree(self, tree) -> None:
        """The inverse of ``flax_tree`` (a JAX checkpoint's params); a tree
        of other towers raises ``ValueError`` before anything changes."""
        new = {}
        for name in ("actor", "critic"):
            layers = getattr(self, name).layers()
            state = getattr(self, f"kfac_{name}")
            try:
                node, knode = tree[name], tree[f"kfac_{name}"]
                if len(node) != len(layers) or len(knode["layers"]) != len(
                        layers):
                    raise KeyError("layer count")
                for i, (layer, ls) in enumerate(zip(layers, state.layers)):
                    for k in ("w", "b"):
                        new[(name, i, k)] = _like(node[str(i)][k], layer[k])
                    for k in _LAYER_LEAVES:
                        new[(f"kfac_{name}", i, k)] = _like(
                            knode["layers"][str(i)][k], getattr(ls, k))
                new[(f"kfac_{name}", "step")] = int(np.asarray(
                    knode["step"]))
            except (KeyError, TypeError) as err:
                raise ValueError(f"checkpoint is not this ACKTR agent's tree "
                                 f"({name}): {err!r}") from err
        with torch.no_grad():
            for name in ("actor", "critic"):
                state = getattr(self, f"kfac_{name}")
                for i, (layer, ls) in enumerate(zip(
                        getattr(self, name).layers(), state.layers)):
                    for k in ("w", "b"):
                        layer[k].copy_(new[(name, i, k)])
                    for k in _LAYER_LEAVES:
                        setattr(ls, k, new[(f"kfac_{name}", i, k)])
                state.step = new[(f"kfac_{name}", "step")]


def _like(a, like: torch.Tensor) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"leaf of shape {a.shape} where {tuple(like.shape)} "
                         "is wanted")
    return torch.from_numpy(np.array(a, np.float32)).to(like.device)


def acktr_init(obs_dim: int, num_actions: int, hidden: int = 64,
               seed: int = 0, device=None) -> ACKTRAgent:
    """MLP actor and critic (MLPBase's 2 x 64 tanh towers) with their
    K-FAC states."""
    gen = torch.Generator().manual_seed(seed)
    a_specs = mlp_specs([obs_dim, hidden, hidden, num_actions])
    c_specs = mlp_specs([obs_dim, hidden, hidden, 1])
    dev = resolve_device(device)
    return ACKTRAgent(a_specs, c_specs, stack_init(a_specs, gen, dev),
                      stack_init(c_specs, gen, dev))


def acktr_conv_init(board_size: int, num_actions: int, in_planes: int = 4,
                    seed: int = 0, device=None) -> ACKTRAgent:
    """Conv actor-critic (two CNNBase-shaped towers, model.py:295-304)
    with KFC conv factors."""
    trunk = conv_trunk_specs(board_size, in_planes)
    a_specs = trunk + (DenseSpec(512, num_actions, act="none", gain=0.01),)
    c_specs = trunk + (DenseSpec(512, 1, act="none", gain=1.0),)
    gen = torch.Generator().manual_seed(seed)
    dev = resolve_device(device)
    return ACKTRAgent(a_specs, c_specs, stack_init(a_specs, gen, dev),
                      stack_init(c_specs, gen, dev))


def fisher_grads(agent: ACKTRAgent, obs: torch.Tensor, legal: torch.Tensor,
                 cfg: ACKTRConfig, draws, mesh=None):
    """The sampled-label Fisher losses' pre-activation gradients
    (a2c_acktr.py:53-68): the actor's ``-mean log pi(a~)`` at actions
    sampled from the policy (a uniform a row from ``draws``), the critic's
    ``-coef * mean (v - (v + noise))^2`` with standard-normal noise (a
    normal a row from ``draws``).  Returns ``(actor inputs, actor dL/dz,
    critic inputs, critic dL/dz)``.  On a ``mesh`` the means are over
    every rank's rows (this rank's ``obs`` are its share)."""
    k = obs.shape[0]
    towers = []
    for stack in (agent.actor, agent.critic):
        pert = stack_zero_perturb(stack.layers(), stack.specs, k)
        out, inputs = stack(obs, pert)
        towers.append((out, [a.detach() for a in inputs], pert))
    (logits, a_in, a_pert), (values, c_in, c_pert) = towers
    dist = MaskedCategorical(logits=logits, mask=legal)
    sampled = dist.sample(u=draws.uniforms(k, obs.device))
    g_actor = torch.autograd.grad(
        -global_mean(dist.log_prob(sampled), mesh), a_pert)
    noise = draws.normals(k, obs.device)[:, None]
    target = (values + noise).detach()
    critic_loss = -cfg.value_loss_coef * global_mean(
        (values - target) ** 2, mesh)
    g_critic = torch.autograd.grad(critic_loss, c_pert)
    return a_in, g_actor, c_in, g_critic


def acktr_loss(agent: ACKTRAgent, obs, legal, action, returns,
               cfg: ACKTRConfig, mesh=None):
    """A2C's loss on both towers; returns ``(total, metrics)``.  On a
    ``mesh`` each mean is this rank's sum over every rank's row count."""
    logits, _ = agent.actor(obs)
    values, _ = agent.critic(obs)
    values = values[:, 0]
    dist = MaskedCategorical(logits=logits, mask=legal)
    logp = dist.log_prob(action)
    adv = returns - values
    value_loss = global_mean(adv ** 2, mesh)
    action_loss = -global_mean(adv.detach() * logp, mesh)
    entropy = global_mean(dist.entropy_full(), mesh)
    total = (value_loss * cfg.value_loss_coef + action_loss
             - entropy * cfg.entropy_coef)
    return total, {"value_loss": value_loss.detach(),
                   "action_loss": action_loss.detach(),
                   "entropy": entropy.detach()}


def acktr_update(agent: ACKTRAgent, obs: torch.Tensor, legal: torch.Tensor,
                 action: torch.Tensor, returns: torch.Tensor,
                 cfg: ACKTRConfig, draws, mesh=None) -> dict:
    """One ACKTR update (a2c_acktr.py:34-76 with acktr=True), in place:
    every ``t_stat`` steps the Fisher sample folds into the factors (its
    uniforms and normals from ``draws``), every ``t_inv`` steps the
    eigendecompositions refresh, then the A2C loss gradients take the
    K-FAC step on both towers.  ``obs``: flat (K, obs_dim) for the MLP
    towers, (K, C, B, B) planes for the conv ones; ``returns`` (K,).
    Returns the loss metrics (0-d tensors).

    ``mesh``: the K rows are this rank's share (its draws from a
    ``ShardedDraws``); the Fisher factors, the gradients and the metrics
    are reduced over the ranks, so every rank takes the same step."""
    obs = obs.to(torch.float32)
    ka, kc = agent.kfac_actor, agent.kfac_critic
    if ka.step % cfg.t_stat == 0:
        a_in, g_actor, c_in, g_critic = fisher_grads(agent, obs, legal, cfg,
                                                     draws, mesh)
        update_fisher_stats(ka, cfg, a_in, g_actor, mesh)
        update_fisher_stats(kc, cfg, c_in, g_critic, mesh)
    if ka.step % cfg.t_inv == 0:
        refresh_eigendecomp(ka)
        refresh_eigendecomp(kc)
    total, metrics = acktr_loss(agent, obs, legal, action, returns, cfg,
                                mesh)
    actor, critic = agent.actor.layers(), agent.critic.layers()
    flat = [p for layer in actor + critic for p in (layer["w"], layer["b"])]
    grads = torch.autograd.grad(total, flat)
    if mesh is not None:
        terms = torch.stack(list(metrics.values()))
        grads = all_reduce_sum([g.clone() for g in grads] + [terms],
                               mesh)[:-1]
        metrics = dict(zip(metrics, terms))
    pairs = [{"w": w, "b": b} for w, b in zip(grads[0::2], grads[1::2])]
    kfac_step(actor, ka, cfg, pairs[:len(actor)])
    kfac_step(critic, kc, cfg, pairs[len(actor):])
    return metrics
