"""Decompose the PPO update's cost: forward, the loss, forward and
backward, the optimizer step, the minibatch gather, the shuffle, GAE and
the full 4 x 4 epoch/minibatch update — the port of
``scripts/profile_update_breakdown.py``.

Each piece is timed over ``REPS`` back-to-back calls between CUDA events
after a warm-up call (``utils/timing.mean_ms``; on the CPU the host
clock), at the default net on a random minibatch of ``T * N / 4`` rows
or a random (T, N) rollout.  JAX timed each inside one scan to hide its
per-call dispatch; eager PyTorch has no such cost to hide, so a call's
time includes its launches, as in the trainer.  The shuffle is the
port's own (``ops/shuffle``: the keyed bijection when ``T * N`` is a
power of two, else a sort), where JAX timed ``jax.random.permutation``.
Prints one JSON line a measurement, ``{"minibatch": M, "<name>_ms":
ms}``, under JAX's names, then ``grad_steps_per_update``.

Usage: python -m gymothelloenv_tpu_torch.scripts.profile_update_breakdown
       [T] [N] [--device=cuda]
"""

from __future__ import annotations

import json
import sys

import torch

from gymothelloenv_tpu_torch.scripts.tool import positional, setup
from gymothelloenv_tpu_torch.utils.timing import mean_ms

REPS = 32


def main(argv=None) -> dict:
    from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, Transition,
                                                    compute_gae,
                                                    make_optimizer,
                                                    ppo_loss, ppo_update)
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.ops.shuffle import (draw_words,
                                                     is_power_of_two,
                                                     minibatch_indices,
                                                     sort_perm)
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network

    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    pos = positional(argv)
    T = int(pos[0]) if pos else 64
    N = int(pos[1]) if len(pos) > 1 else 4096
    env_cfg = EnvConfig()
    ppo_cfg = PPOConfig()
    net = make_network(env_cfg, seed=0, device=dev)
    optimizer = make_optimizer(ppo_cfg, net.parameters())
    M = T * N // ppo_cfg.num_mini_batch
    gen = torch.Generator(dev).manual_seed(0)

    def bern(shape):
        return (torch.rand(shape, generator=gen, device=dev) < 0.3).to(
            torch.float32)

    def normal(n):
        return torch.randn((n,), generator=gen, device=dev)

    def rollout(lead):
        return Transition(
            obs=bern(lead + (4, 8, 8)),
            action=torch.randint(0, 64, lead, generator=gen, device=dev),
            logp=torch.full(lead, -3.0, device=dev),
            value=(normal(lead[0]) if len(lead) == 1
                   else torch.zeros(lead, device=dev)),
            reward=torch.zeros(lead, device=dev),
            done=torch.zeros(lead, dtype=torch.bool, device=dev),
            legal=torch.ones(lead + (64,), dtype=torch.bool, device=dev))

    mb, adv, ret = rollout((M,)), normal(M), normal(M)
    roll, boot = rollout((T, N)), torch.zeros((N,), device=dev)
    words = draw_words(torch.Generator().manual_seed(1), ppo_cfg.ppo_epochs)
    flat = {k: getattr(roll, k).reshape((T * N,) + getattr(roll, k).shape[2:])
            for k in ("obs", "action", "logp", "value", "legal")}
    idx = torch.randperm(T * N, generator=torch.Generator().manual_seed(7)
                         )[:M].to(dev)
    obs2d = flat["obs"].reshape(T * N, -1)

    def loss():
        return ppo_loss(net, mb, adv, ret, ppo_cfg)[0]

    def grad():
        optimizer.zero_grad()
        loss().backward()

    def opt_apply():
        optimizer.step()

    def gather():
        return {k: v[idx] for k, v in flat.items()}

    def perm():
        n = T * N
        if ppo_cfg.shuffle == "hash" and is_power_of_two(n):
            return [minibatch_indices(words[0].tolist(), n, b, M, dev)
                    for b in range(ppo_cfg.num_mini_batch)]
        return sort_perm(words[0].tolist(), n, dev)

    def gather_grad():
        batch = Transition(reward=None, done=None, **gather())
        optimizer.zero_grad()
        ppo_loss(net, batch, adv, ret, ppo_cfg)[0].backward()

    def full_update(r=roll):
        ppo_update(net, optimizer, r, boot, words, ppo_cfg)

    roll_i8 = Transition(**{**vars(roll), "obs": roll.obs.to(torch.int8)})
    grad()                     # the optimizer steps on real gradients
    pieces = (
        ("fwd_ms", lambda: net(mb.obs)[0]),
        ("loss_fwd_ms", loss),
        ("grad_ms", grad),
        ("opt_apply_ms", opt_apply),
        ("gather_ms", gather),
        ("gather4d_obs_ms", lambda: flat["obs"][idx]),
        ("gather2d_obs_ms", lambda: obs2d[idx]),
        ("gather2d_int8_obs_ms",
         lambda: obs2d.to(torch.int8)[idx].to(torch.float32)),
        ("gather_grad_ms", gather_grad),
        ("perm_ms", perm),
        ("gae_ms", lambda: compute_gae(roll, boot, ppo_cfg)),
        ("full_update_ms", full_update),
        ("full_update_int8_ms", lambda: full_update(roll_i8)),
    )
    out = {}
    for name, fn in pieces:
        out[name] = mean_ms(fn, REPS, dev)
        print(json.dumps({"minibatch": M, name: round(out[name], 3)}),
              flush=True)
    steps = ppo_cfg.ppo_epochs * ppo_cfg.num_mini_batch
    print(json.dumps({"minibatch": M, "grad_steps_per_update": steps}),
          flush=True)
    return dict(out, minibatch=M, grad_steps_per_update=steps)


if __name__ == "__main__":
    main()
