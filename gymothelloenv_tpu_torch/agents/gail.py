"""GAIL — the port of ``agents/gail.py`` (the vendored ``algo/gail.py``,
dead in the reference snapshot, working in the JAX package and here).

- ``Discriminator``: a tanh MLP over ``[state, action]`` rows (gail.py:
  12-28) giving one logit, flax ``Dense`` init (lecun-normal kernels, zero
  biases); trained by ``gail_discriminator_update`` with BCE on logits
  (expert 1, policy 0) plus the mixup gradient penalty (gail.py:32-57,
  lambda 10).  The penalty is a gradient with respect to the input inside
  the loss, so the step is a double backward
  (``torch.autograd.grad(..., create_graph=True)``).  Adam is optax
  ``adam(1e-3)`` (``agents.ppo.Adam``).
- ``gail_predict_reward``: ``log s - log(1 - s)`` (1e-8 inside each log)
  over the running std of the discounted return accumulator
  (gail.py:98-111), ``RunningMeanStd`` with the population variance and a
  float32 count.
- ``ExpertDataset``: trajectories with per-trajectory random-phase
  subsampling (gail.py:114-167) from an npz, or from the reference's raw
  h5 schema through ``h5py``; its ``np.random.RandomState`` draws are
  JAX's: ``permutation``, then ``randint`` for the phases, then one
  ``randint`` a sampled batch.

Randomness of the update comes from a draws object
(``train.self_play.Draws``, or the tests' ``InjectedDraws``): the mixup
weights ``alpha`` are one ``mix_uniforms`` call a step.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from gymothelloenv_tpu_torch.agents.ppo import Adam
from gymothelloenv_tpu_torch.utils.device import resolve_device


class Discriminator(nn.Module):
    """tanh MLP trunk -> a scalar logit (gail.py:18-22); flax names its
    layers ``Dense_0..2``."""

    FLAX_MODULES = {"fc0": ("Dense_0",), "fc1": ("Dense_1",),
                    "out": ("Dense_2",)}

    def __init__(self, input_dim: int, hidden_dim: int = 100):
        super().__init__()
        self.fc0 = nn.Linear(input_dim, hidden_dim)
        self.fc1 = nn.Linear(hidden_dim, hidden_dim)
        self.out = nn.Linear(hidden_dim, 1)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax ``Dense``'s init: lecun-normal kernels (a normal truncated
        at two deviations, scaled to variance 1 / fan_in) and zero
        biases."""
        for layer in (self.fc0, self.fc1, self.out):
            std = math.sqrt(1.0 / layer.in_features) / .87962566103423978
            nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(self.fc0(x))
        x = torch.tanh(self.fc1(x))
        return self.out(x)[..., 0]


@dataclasses.dataclass
class RunningMeanStd:
    """baselines ``running_mean_std`` over scalars (parallel-variance
    merge), float32 0-d tensors."""
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, device=None) -> "RunningMeanStd":
        def f(v):
            return torch.tensor(v, dtype=torch.float32, device=device)
        return cls(mean=f(0.0), var=f(1.0), count=f(1e-4))

    def update(self, batch: torch.Tensor) -> "RunningMeanStd":
        b_mean = batch.mean()
        b_var = batch.var(correction=0)
        b_count = torch.tensor(float(batch.numel()), dtype=torch.float32,
                               device=batch.device)
        delta = b_mean - self.mean
        tot = self.count + b_count
        new_mean = self.mean + delta * b_count / tot
        m_a = self.var * self.count
        m_b = b_var * b_count
        m2 = m_a + m_b + delta ** 2 * self.count * b_count / tot
        return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)


@dataclasses.dataclass
class GAILState:
    net: Discriminator
    optimizer: Adam
    returns: torch.Tensor      # discounted reward accumulator (N,)
    ret_rms: RunningMeanStd


@dataclasses.dataclass(frozen=True)
class GAILConfig:
    hidden_dim: int = 100
    grad_pen_lambda: float = 10.0
    gamma: float = 0.99


def gail_init(cfg: GAILConfig, input_dim: int, num_envs: int,
              seed: int = 0, device=None) -> GAILState:
    """A seeded discriminator on ``device``, Adam(1e-3), a zero return
    accumulator a game and fresh running moments."""
    device = resolve_device(device)
    net = Discriminator(input_dim, cfg.hidden_dim)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    net = net.to(device)
    return GAILState(net=net, optimizer=Adam(net.parameters(), 1e-3),
                     returns=torch.zeros(num_envs, device=device),
                     ret_rms=RunningMeanStd.create(device))


def discriminator_loss(net: Discriminator, cfg: GAILConfig,
                       expert_sa: torch.Tensor, policy_sa: torch.Tensor,
                       alpha: torch.Tensor) -> torch.Tensor:
    """BCE(expert -> 1, policy -> 0) on logits plus ``lambda * mean((|d
    D / d mix| - 1)^2)`` at ``mix = alpha * expert + (1 - alpha) *
    policy`` (``alpha`` (M,)), the input gradient kept in the graph."""
    d_expert = net(expert_sa)
    d_policy = net(policy_sa)
    expert_loss = F.binary_cross_entropy_with_logits(
        d_expert, torch.ones_like(d_expert))
    policy_loss = F.binary_cross_entropy_with_logits(
        d_policy, torch.zeros_like(d_policy))
    a = alpha[:, None]
    mix = (a * expert_sa + (1 - a) * policy_sa).detach().requires_grad_(True)
    grads_x, = torch.autograd.grad(net(mix).sum(), mix, create_graph=True)
    gp = cfg.grad_pen_lambda * (
        (torch.linalg.vector_norm(grads_x, dim=1) - 1.0) ** 2).mean()
    return expert_loss + policy_loss + gp


def gail_discriminator_update(state: GAILState, cfg: GAILConfig,
                              expert_sa: torch.Tensor,
                              policy_sa: torch.Tensor, draws):
    """One discriminator step (gail.py:60-96) in place: the loss of
    ``discriminator_loss`` with ``alpha`` from ``draws.mix_uniforms``,
    its gradients through the penalty's double backward, one Adam step.
    ``*_sa`` are flat ``[state, action]`` batches of equal size.  Returns
    ``(state, loss)``, the loss 0-d before the step."""
    alpha = draws.mix_uniforms(expert_sa.shape[0], expert_sa.device)
    state.optimizer.zero_grad()
    loss = discriminator_loss(state.net, cfg, expert_sa, policy_sa, alpha)
    loss.backward()
    state.optimizer.step()
    return state, loss.detach()


@torch.no_grad()
def gail_predict_reward(state: GAILState, cfg: GAILConfig,
                        sa: torch.Tensor, masks: torch.Tensor,
                        update_rms: bool = True):
    """``log s - log(1 - s)`` over the running return std (gail.py:
    98-111).  ``sa`` (N, D), ``masks`` (N,) = 1 - the previous slot's
    done.  Returns ``(state, rewards (N,))``."""
    s = torch.sigmoid(state.net(sa))
    reward = torch.log(s + 1e-8) - torch.log(1 - s + 1e-8)
    # returns * masks * gamma + reward in one rounding, as XLA's fused
    # multiply-add (agents.a2c.a2c_returns).
    returns = torch.addcmul(reward, state.returns * masks,
                            torch.full_like(reward, cfg.gamma))
    ret_rms = state.ret_rms.update(returns) if update_rms \
        else state.ret_rms
    state = dataclasses.replace(state, returns=returns, ret_rms=ret_rms)
    return state, reward / torch.sqrt(ret_rms.var + 1e-8)


def _load_trajectories(file_name: str):
    """An npz with 'states'/'actions'/'lengths', or a raw h5 in the
    reference's schema (obs_B_T_Do / a_B_T_Da / len_B, the input of
    gail_experts/convert_to_pytorch.py:29-47), read through ``h5py``."""
    if file_name.endswith((".h5", ".hdf5")):
        try:
            import h5py
        except ImportError as err:
            raise ImportError(
                f"{file_name}: reading an .h5/.hdf5 expert file needs the "
                "h5py package, which is not installed; write the "
                "trajectories to an npz with 'states', 'actions' and "
                "'lengths' instead") from err
        with h5py.File(file_name, "r") as f:
            return {"states": np.asarray(f["obs_B_T_Do"]),
                    "actions": np.asarray(f["a_B_T_Da"]),
                    "lengths": np.asarray(f["len_B"])}
    return np.load(file_name)


class ExpertDataset:
    """Trajectories with random-phase subsampling (gail.py:114-167) from
    an npz with 'states' (K, T, D), 'actions' (K, T, ...), 'lengths'
    (K,), or from the reference's raw h5 trajectory files."""

    def __init__(self, file_name: str, num_trajectories: int = 4,
                 subsample_frequency: int = 20, seed: int = 0):
        data = _load_trajectories(file_name)
        rng = np.random.RandomState(seed)
        k = data["states"].shape[0]
        idx = rng.permutation(k)[:num_trajectories]
        starts = rng.randint(0, subsample_frequency, size=num_trajectories)
        states, actions, lengths = [], [], []
        for j, i in enumerate(idx):
            s = data["states"][i, starts[j]::subsample_frequency]
            a = data["actions"][i, starts[j]::subsample_frequency]
            n = int(data["lengths"][i]) // subsample_frequency
            states.append(s[:n])
            actions.append(a[:n])
            lengths.append(n)
        self.states = np.concatenate(states)
        self.actions = np.concatenate(actions)
        self.length = int(np.sum(lengths))

    def __len__(self):
        return self.length

    def sample(self, rng: np.random.RandomState, batch_size: int):
        idx = rng.randint(0, self.length, batch_size)
        return self.states[idx], self.actions[idx]
