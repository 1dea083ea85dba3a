"""The standalone "simple" PPO — the port of ``agents/simple_ppo.py`` (the
reference's ppo.py:111-334).

Distinct from the GAE variant (``agents/ppo.py``): Monte-Carlo discounted
returns with no bootstrap (zeroed at terminals and at the buffer edge,
ppo.py:179-187), whole-buffer return normalisation with the population
std (ppo.py:189-190), a plain (unclipped) value MSE, entropy coefficient
0.01, Adam at lr 1e-3 (optax ``adam(lr, b1, b2)``, ``agents.ppo.Adam``).

The reference quirk is kept: actions are sampled from the legal-subset
renormalised probabilities (ppo.py:233-251), but the stored behaviour
log-prob and the update's log-probs and entropy all use the full unmasked
softmax (ppo.py:98-108, :309-310); the update never sees the legal mask.

The K epochs index the flat rollout with each epoch's permutation and
take ``total // batch_size`` minibatches of it (JAX's ``pack_rows`` row
gather is a TPU workaround and is not ported).
"""

from __future__ import annotations

import dataclasses

import torch

from gymothelloenv_tpu_torch.agents.ppo import Adam, Transition


@dataclasses.dataclass(frozen=True)
class SimplePPOConfig:
    """Defaults from PPO.__init__ (ppo.py:112-139)."""
    lr: float = 1e-3
    betas: tuple = (0.9, 0.999)
    gamma: float = 0.99
    k_epochs: int = 5
    eps_clip: float = 0.2
    update_timestep: int = 2048   # reference 2000; rounded to T*N tiles
    batch_size: int = 256
    value_coef: float = 0.5
    entropy_coef: float = 0.01


def make_simple_ppo_optimizer(cfg: SimplePPOConfig, params) -> Adam:
    """optax ``adam(lr, b1, b2)`` over ``params``."""
    return Adam(params, cfg.lr, betas=cfg.betas)


@torch.no_grad()
def mc_returns(rewards: torch.Tensor, dones: torch.Tensor,
               gamma: float) -> torch.Tensor:
    """Reversed discounted sums, reset at terminals, a zero "bootstrap" at
    the buffer edge (ppo.py:179-187).  Shapes (T, N) -> (T, N)."""
    not_done = 1.0 - dones.to(torch.float32)
    out = torch.empty_like(rewards)
    acc = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        # r + (gamma * acc) * (1 - d) in one rounding, as XLA's fused
        # multiply-add (agents.a2c.a2c_returns).
        acc = torch.addcmul(rewards[t], gamma * acc, not_done[t])
        out[t] = acc
    return out


def simple_ppo_loss(net: torch.nn.Module, obs: torch.Tensor,
                    action: torch.Tensor, old_logp: torch.Tensor,
                    ret: torch.Tensor, cfg: SimplePPOConfig) -> torch.Tensor:
    """The minibatch loss (ppo.py:196-221): the clipped surrogate on
    ``ret - V`` (V detached), ``value_coef * (V - ret)^2`` and the full
    softmax's entropy bonus, averaged over the rows."""
    logits, values = net(obs.to(torch.float32))
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, action.to(torch.int64)[:, None])[:, 0]
    ratio = torch.exp(logp - old_logp)
    adv = ret - values.detach()
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1 - cfg.eps_clip, 1 + cfg.eps_clip) * adv
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1)
    loss = (-torch.minimum(surr1, surr2)
            + cfg.value_coef * (values - ret) ** 2
            - cfg.entropy_coef * entropy)
    return loss.mean()


def simple_ppo_update(net: torch.nn.Module, optimizer: Adam,
                      rollout: Transition, cfg: SimplePPOConfig, perms=None,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
    """K-epoch shuffled-minibatch update (ppo.py:178-227) of ``net``
    (``net(obs) -> (logits, value)``) in place.

    ``rollout.logp`` must hold full-softmax behaviour log-probs recorded
    at collection (the reference's ``policy_old``: collection always runs
    on the post-update weights, so storing them at sample time is the
    same as a separate old-policy copy).  ``perms``: one permutation of
    the ``T * N`` flat rows an epoch (JAX draws
    ``jax.random.permutation(epoch_key, T * N)``); ``None`` draws them
    with ``torch.randperm`` from ``generator`` (on the CPU).  Returns the
    loss averaged over every minibatch (0-d, on the rollout's device)."""
    returns = mc_returns(rollout.reward, rollout.done, cfg.gamma)
    returns = (returns - returns.mean()) / (returns.std(correction=0)
                                            + 1e-5)
    T, N = rollout.reward.shape
    total = T * N
    device = rollout.reward.device
    obs = rollout.obs.reshape((total,) + rollout.obs.shape[2:])
    action = rollout.action.reshape(-1)
    logp = rollout.logp.reshape(-1)
    ret = returns.reshape(-1)
    mb_size = min(cfg.batch_size, total)
    num_batches = max(1, total // mb_size)
    if perms is None:
        perms = [torch.randperm(total, generator=generator)
                 for _ in range(cfg.k_epochs)]
    if len(perms) != cfg.k_epochs:
        raise ValueError(f"perms must hold {cfg.k_epochs} permutations, "
                         f"got {len(perms)}")
    losses = []
    for perm in perms:
        perm = torch.as_tensor(perm, dtype=torch.int64, device=device)
        for i in range(num_batches):
            idx = perm[i * mb_size:(i + 1) * mb_size]
            optimizer.zero_grad()
            loss = simple_ppo_loss(net, obs[idx], action[idx], logp[idx],
                                   ret[idx], cfg)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
    # JAX: the mean over epochs of each epoch's mean over its minibatches.
    return torch.stack(losses).reshape(len(perms), num_batches).mean(
        1).mean()
