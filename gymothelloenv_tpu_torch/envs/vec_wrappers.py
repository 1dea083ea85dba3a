"""Vectorized-env wrappers: running normalization, frame stacking, time
limits — the port of ``envs/vec_wrappers.py`` (the vendored vec-env
pipeline, a2c_ppo_acktr/envs.py:75-250).

Each wrapper is a pure function over an explicit state dataclass, as in
JAX: nothing holds mutable tensors between calls.

- ``RunningMeanStd``: the parallel (Chan) merge of batch moments into
  running mean/var/count (baselines ``running_mean_std``).
- ``VecNormState``: the obs filter ``clip((obs - mean)/sqrt(var + eps),
  +-clipob)`` whose stats update only in training, and the reward scaled
  by the running std of the per-env discounted return (reset on done),
  clipped to +-cliprew (envs.py:185-205).
- ``FrameStackState``: the channel ring of the last ``nstack``
  observations, zeroed per env on done before the newest frame is
  written (envs.py:210-250).
- ``TimeLimitState``: gym's TimeLimit plus the fork's TimeLimitMask
  (envs.py:110-119), the ``bad_transition`` flag that
  ``agents.ppo.compute_gae_time_limits`` consumes.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class RunningMeanStd:
    mean: torch.Tensor   # (*shape,)
    var: torch.Tensor    # (*shape,)
    count: torch.Tensor  # 0-d


def rms_init(shape=(), epsilon: float = 1e-4, dtype=torch.float32,
             device=None) -> RunningMeanStd:
    return RunningMeanStd(
        mean=torch.zeros(shape, dtype=dtype, device=device),
        var=torch.ones(shape, dtype=dtype, device=device),
        count=torch.tensor(epsilon, dtype=dtype, device=device))


def _merge(rms: RunningMeanStd, batch_mean, batch_var, batch_count):
    delta = batch_mean - rms.mean
    tot = rms.count + batch_count
    new_mean = rms.mean + delta * batch_count / tot
    m2 = (rms.var * rms.count + batch_var * batch_count
          + torch.square(delta) * rms.count * batch_count / tot)
    return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)


def rms_update(rms: RunningMeanStd, batch: torch.Tensor) -> RunningMeanStd:
    """Merge a (N, *shape) batch into the running moments (baselines
    ``update_from_moments``)."""
    batch = batch.to(rms.mean.dtype)
    n = batch.shape[0]
    mean = batch.sum(0) / n
    var = torch.square(batch - mean).sum(0) / n
    return _merge(rms, mean, var, torch.tensor(n, dtype=rms.mean.dtype,
                                               device=batch.device))


def rms_update_masked(rms: RunningMeanStd, batch: torch.Tensor,
                      weights: torch.Tensor) -> RunningMeanStd:
    """``rms_update`` over only the rows with ``weights > 0``."""
    w = weights.to(rms.mean.dtype)
    w = w.reshape(w.shape + (1,) * (batch.ndim - w.ndim))
    batch = batch.to(rms.mean.dtype)
    count = w.sum(0).reshape(()).clamp(min=1e-8)
    mean = (batch * w).sum(0) / count
    var = (torch.square(batch - mean) * w).sum(0) / count
    return _merge(rms, mean, var, count)


def rms_normalize(rms: RunningMeanStd, x: torch.Tensor, clip: float = 10.0,
                  eps: float = 1e-8) -> torch.Tensor:
    """``clip((x - mean)/sqrt(var + eps), +-clip)`` (envs.py:189-196)."""
    return torch.clamp((x - rms.mean) / torch.sqrt(rms.var + eps),
                       -clip, clip)


@dataclasses.dataclass
class VecNormState:
    ob_rms: RunningMeanStd    # stats over obs (*obs_shape)
    ret_rms: RunningMeanStd   # stats over the scalar discounted return
    ret: torch.Tensor         # (N,) per-env running discounted return
    gamma: float = 0.99
    clipob: float = 10.0
    cliprew: float = 10.0
    eps: float = 1e-8


def vecnorm_init(obs_shape, num_envs: int, gamma: float = 0.99,
                 clipob: float = 10.0, cliprew: float = 10.0,
                 eps: float = 1e-8, device=None) -> VecNormState:
    return VecNormState(ob_rms=rms_init(obs_shape, device=device),
                        ret_rms=rms_init((), device=device),
                        ret=torch.zeros(num_envs, device=device),
                        gamma=gamma, clipob=clipob, cliprew=cliprew, eps=eps)


def vecnorm_obs(state: VecNormState, obs: torch.Tensor,
                training: bool = True):
    """The fork's ``_obfilt``: the stats update only in training; the
    observation is always normalised.  Returns ``(state, obs)``."""
    ob_rms = rms_update(state.ob_rms, obs) if training else state.ob_rms
    return (dataclasses.replace(state, ob_rms=ob_rms),
            rms_normalize(ob_rms, obs, state.clipob, state.eps))


def vecnorm_reward(state: VecNormState, reward: torch.Tensor,
                   done: torch.Tensor, training: bool = True):
    """The reward scaled by the running std of the discounted return (the
    mean is not subtracted), the return zeroed on done.  Returns
    ``(state, reward)``."""
    # ret * gamma + reward in one rounding, as XLA's fused multiply-add
    # (agents.ppo.compute_gae).
    ret = torch.addcmul(reward, state.ret, torch.full_like(state.ret,
                                                           state.gamma))
    ret_rms = rms_update(state.ret_rms, ret) if training else state.ret_rms
    norm = torch.clamp(reward / torch.sqrt(ret_rms.var + state.eps),
                       -state.cliprew, state.cliprew)
    ret = torch.where(done, torch.zeros_like(ret), ret)
    return dataclasses.replace(state, ret_rms=ret_rms, ret=ret), norm


@dataclasses.dataclass
class FrameStackState:
    stacked: torch.Tensor  # (N, nstack * C, *rest)
    nstack: int = 4


def frame_stack_init(obs: torch.Tensor, nstack: int) -> FrameStackState:
    """Zeros with the newest frame in the last C channels (envs.py:244-249)."""
    n, c = obs.shape[0], obs.shape[1]
    stacked = obs.new_zeros((n, nstack * c) + tuple(obs.shape[2:]))
    stacked[:, -c:] = obs
    return FrameStackState(stacked=stacked, nstack=nstack)


def frame_stack_step(state: FrameStackState, obs: torch.Tensor,
                     done: torch.Tensor) -> FrameStackState:
    """Shift left by C channels, zero the stack of envs whose episode just
    reset, write the new frame (envs.py:231-238)."""
    c = obs.shape[1]
    shifted = torch.cat([state.stacked[:, c:],
                         torch.zeros_like(state.stacked[:, :c])], dim=1)
    keep = ~done.reshape((-1,) + (1,) * (shifted.ndim - 1))
    shifted = torch.where(keep, shifted, torch.zeros_like(shifted))
    shifted[:, -c:] = obs
    return dataclasses.replace(state, stacked=shifted)


@dataclasses.dataclass
class TimeLimitState:
    elapsed: torch.Tensor  # int32 (N,)
    max_steps: int = 1000


def time_limit_init(num_envs: int, max_steps: int,
                    device=None) -> TimeLimitState:
    return TimeLimitState(
        elapsed=torch.zeros(num_envs, dtype=torch.int32, device=device),
        max_steps=max_steps)


def time_limit_step(state: TimeLimitState, env_done: torch.Tensor):
    """gym's TimeLimit with the fork's TimeLimitMask: returns ``(state,
    done, bad_transition)``; ``done`` adds the truncation at
    ``max_steps``, and ``bad_transition`` marks the dones the cap caused,
    also where the task ended on the same step."""
    elapsed = state.elapsed + 1
    truncated = elapsed >= state.max_steps
    done = env_done | truncated
    elapsed = torch.where(done, torch.zeros_like(elapsed), elapsed)
    return dataclasses.replace(state, elapsed=elapsed), done, truncated
