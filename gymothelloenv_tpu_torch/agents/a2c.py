"""A2C — the port of ``agents/a2c.py`` (the vendored ``A2C_ACKTR``,
a2c_acktr.py:8-80): one full-batch actor-critic gradient step a rollout,
``value_loss * coef + policy_gradient_loss - entropy * coef``, the
entropy of the unmasked softmax (``entropy_full``), with the masked
categorical the reference's A2C cannot call (SURVEY.md §2.2).

The optimizer is optax's ``chain(clip_by_global_norm(0.5), rmsprop(lr,
decay=0.99, eps=1e-5))``: the global-norm clip of ``agents/ppo.py`` and
the hand-written ``agents.dqn.RMSprop`` without momentum (eps inside the
root, ``nu`` from 0; ``torch.optim.RMSprop`` does neither), its state in
optax's tree ``{"0": {}, "1": {"0": {"nu"}, "1": {}, "2": {}}}``.
"""

from __future__ import annotations

import dataclasses

import torch

from gymothelloenv_tpu_torch.agents.dqn import RMSprop
from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, Transition,
                                                clip_by_global_norm,
                                                compute_gae)
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.parallel.sharding import (all_reduce_grads,
                                                       global_mean)


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    """arguments.py defaults used by the A2C branch."""
    lr: float = 7e-4
    rms_eps: float = 1e-5
    rms_alpha: float = 0.99
    gamma: float = 0.99
    use_gae: bool = False
    gae_lambda: float = 0.95
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.01
    max_grad_norm: float = 0.5


class A2COptimizer:
    """``make_a2c_optimizer``'s result over ``params``: the global-norm
    clip, then RMSprop without momentum; ``step()`` uses and leaves the
    parameters' ``.grad``."""

    def __init__(self, params, cfg: A2CConfig):
        self.rms = RMSprop(params, cfg.lr, eps=cfg.rms_eps, momentum=None,
                           decay=cfg.rms_alpha)
        self.params = self.rms.params
        self.max_norm = cfg.max_grad_norm

    def zero_grad(self) -> None:
        self.rms.zero_grad()

    def step(self) -> None:
        clip_by_global_norm(self.params, self.max_norm)
        self.rms.step()

    def to_optax_state(self, to_tree) -> dict:
        return {"0": {}, "1": self.rms.to_optax_state(to_tree)}

    def load_optax_state(self, state, from_tree) -> None:
        """The inverse of ``to_optax_state``; another layout raises
        ``ValueError``."""
        if (not isinstance(state, dict) or set(state) != {"0", "1"}
                or state["0"]):
            raise ValueError("optimizer state is not the layout of optax "
                             "clip_by_global_norm -> rmsprop ({'0': {}, "
                             "'1': ...})")
        self.rms.load_optax_state(state["1"], from_tree)


def make_a2c_optimizer(cfg: A2CConfig, params) -> A2COptimizer:
    return A2COptimizer(params, cfg)


@torch.no_grad()
def a2c_returns(rollout: Transition, bootstrap_value: torch.Tensor,
                cfg: A2CConfig) -> torch.Tensor:
    """storage.compute_returns (storage.py:107-112): bootstrapped
    discounted returns with episode-boundary masks, (T, N); with
    ``use_gae`` the GAE returns (``agents.ppo.compute_gae``)."""
    if cfg.use_gae:
        gcfg = PPOConfig(gamma=cfg.gamma, gae_lambda=cfg.gae_lambda)
        return compute_gae(rollout, bootstrap_value, gcfg)[1]
    not_done = 1.0 - rollout.done.to(torch.float32)
    returns = torch.empty_like(rollout.reward)
    ret = bootstrap_value
    for t in range(rollout.reward.shape[0] - 1, -1, -1):
        # r + (gamma * ret) * mask in ONE rounding: XLA contracts JAX's
        # scan body into a fused multiply-add, and addcmul keeps the port
        # bit-equal to it.
        ret = torch.addcmul(rollout.reward[t], cfg.gamma * ret, not_done[t])
        returns[t] = ret
    return returns


def a2c_update(net: torch.nn.Module, optimizer: A2COptimizer,
               rollout: Transition, bootstrap_value: torch.Tensor,
               cfg: A2CConfig, mesh=None) -> dict:
    """One full-batch update (a2c_acktr.py:34-76) of ``net`` (``net(obs)
    -> (logits, value)``) on the (T, N) rollout.  Returns the metrics
    ``value_loss``, ``action_loss`` and ``entropy`` (0-d tensors).
    ``mesh``: the rollout holds this rank's games; the means are over
    every rank's rows and the gradients are summed over the ranks before
    the step (``agents.ppo.ppo_update``'s scheme)."""
    returns = a2c_returns(rollout, bootstrap_value, cfg).reshape(-1)

    def flat(x):
        return x.reshape((-1,) + x.shape[2:])
    logits, values = net(flat(rollout.obs).to(torch.float32))
    dist = MaskedCategorical(logits=logits, mask=flat(rollout.legal))
    logp = dist.log_prob(flat(rollout.action))
    adv = returns - values
    value_loss = global_mean(adv ** 2, mesh)
    action_loss = -global_mean(adv.detach() * logp, mesh)
    entropy = global_mean(dist.entropy_full(), mesh)
    total = (value_loss * cfg.value_loss_coef + action_loss
             - entropy * cfg.entropy_coef)
    optimizer.zero_grad()
    total.backward()
    terms = torch.stack([value_loss.detach(), action_loss.detach(),
                         entropy.detach()])
    if mesh is not None:
        all_reduce_grads(optimizer.params, mesh, [terms])
    optimizer.step()
    return dict(zip(("value_loss", "action_loss", "entropy"), terms))
