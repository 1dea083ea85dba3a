"""Rainbow job 07 at its own hyperparameters, cut in games and chunks: the
port's chunks held to JAX's on the CPU with JAX's draws injected.

``tests/test_torch_rainbow.py``'s pool witnesses run a small
configuration (16-row batches, a 2,048-row ring, the target synced every
200 transitions, no warm-up replay).  This script runs job 07's
(``data/queue/done/07_rainbow_pool.job``: batch 4096, one update a 512
transitions, a 1,000,000-row PER ring, 20,000 warm-up transitions, the
target synced every 10,000, the pool's frozen opponent, seed 21) at
``--num-envs`` games (1024 in the job) for ``--chunks`` chunks of 64
plies.  JAX's chunks run with their draws recorded (``_JaxPool``); the
port's trainer then plays each chunk on JAX's draws, and after each
chunk the script prints: the replay's rows equal to JAX's (exactly),
``t``, the sampled rows the port's own PER sampler draws from JAX's
uniforms against JAX's, how many differ and by how many rows at most
(the port then takes JAX's, as the witnesses do),
each update's loss against JAX's, the params' and target's worst leaf
against JAX's over the leaf's largest change in the chunk, and the
priorities.  Each chunk starts from JAX's params and target of the
chunk before (as ``test_pool_interval_1_chunks_equal_jax`` does).  It is
not a tier-1 test (a chunk at N 256 takes about a minute here).

Usage: python tests/torch_rainbow_scale_witness.py [--num-envs 256]
       [--chunks 6] [--seed 21]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_dqn_trainer  # noqa: E402
import test_torch_rainbow as T  # noqa: E402
from gymothelloenv_tpu.agents import rainbow as jrainbow  # noqa: E402
from gymothelloenv_tpu.agents import replay as jreplay  # noqa: E402
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig  # noqa
from gymothelloenv_tpu.train import dqn_trainer as jdqn_trainer  # noqa
from gymothelloenv_tpu_torch.agents import rainbow  # noqa: E402
from gymothelloenv_tpu_torch.agents.rainbow import RainbowConfig  # noqa
from gymothelloenv_tpu_torch.agents.replay import ReplayConfig  # noqa
from gymothelloenv_tpu_torch.core.state import EnvConfig  # noqa: E402
from gymothelloenv_tpu_torch.models.convert import load_flax_params  # noqa
from gymothelloenv_tpu_torch.train.dqn_trainer import DQNRunConfig  # noqa
from gymothelloenv_tpu_torch.train.rainbow_trainer import (  # noqa: E402
    RainbowTrainer)


def configs(num_envs: int, seed: int):
    kw = dict(batch_size=4096, train_interval=512)
    run = dict(num_envs=num_envs, chunk_plies=64, opponent_pool=8,
               pool_interval=50, test_interval=10 ** 9, num_test_games=4,
               seed=seed)
    rb = dict(capacity=1_000_000, prioritized=True)
    return ((JaxEnvConfig(num_disk_as_reward=True),
             jrainbow.RainbowConfig(**kw), jreplay.ReplayConfig(**rb),
             jdqn_trainer.DQNRunConfig(**run)),
            (EnvConfig(num_disk_as_reward=True), RainbowConfig(**kw),
             ReplayConfig(**rb), DQNRunConfig(**run)))


def worst_leaf(port, want, begin):
    """The largest per-leaf difference over the leaf's largest change."""
    worst = 0.0
    for k, w in want.items():
        big = float((w - begin[k]).abs().max())
        if big > 0:
            worst = max(worst, float((port[k] - w).abs().max()) / big)
    return worst


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--chunks", type=int, default=6)
    p.add_argument("--seed", type=int, default=21)
    args = p.parse_args(argv)
    torch.set_num_threads(4)
    test_torch_dqn_trainer.INIT = 0            # job 07: no random openings
    jcfgs, cfgs = configs(args.num_envs, args.seed)
    t0 = time.time()
    pool = T._JaxPool(jcfgs)
    jtr, draws, params0, jidx = pool.run(args.chunks)
    print(f"JAX: {args.chunks} chunks recorded in {time.time() - t0:.0f} s;"
          f" updates {[s['updates'] for s in jtr.snapshots]}", flush=True)

    taken, sampled, losses = iter(jidx), [], []
    real_sample, real_loss = rainbow.replay_sample_idx, \
        rainbow.rainbow_loss_grads

    def sample_idx(rb, cfg, u):
        want = next(taken).to(torch.int64)
        got = real_sample(rb, cfg, u)
        apart = (got - want).abs()
        sampled.append((int((apart > 0).sum()), int(apart.max())))
        return want

    def loss_grads(state, cfg, batch, draws_):
        loss, kl = real_loss(state, cfg, batch, draws_)
        losses.append(float(loss))
        return loss, kl
    rainbow.replay_sample_idx = sample_idx
    rainbow.rainbow_loss_grads = loss_grads
    tr = RainbowTrainer(*cfgs, log_fn=lambda *a: None, device="cpu")
    tr.draws = draws
    load_flax_params(tr.agent.net, params0)
    load_flax_params(tr.agent.target, params0)
    snap = tr._snapshot()
    begin = T._leaves(T._port_net(params0))
    first = 0
    for c, s in enumerate(jtr.snapshots):
        t1 = time.time()
        tr.train_chunk(snap)
        size = int(s["replay"].size)
        got = T._rows(tr.replay, size)
        want = jreplay.replay_gather(s["replay"], np.arange(size))
        rows_equal = all(np.array_equal(got[f], np.asarray(w))
                         for f, w in zip(T.FIELDS, want))
        n_up = s["updates"] - first
        jl = [jtr.losses[i][1] for i in range(first, s["updates"])]
        pl = losses[first:s["updates"]]
        loss_rel = max((abs(a - b) / abs(b) for a, b in zip(pl, jl)),
                       default=0.0)
        miss = sampled[first:s["updates"]]
        end = T._leaves(T._port_net(s["params"]))
        target = T._leaves(T._port_net(s["target"]))
        prio = float(np.abs(tr.replay.priority[:size].numpy() - np.asarray(
            s["replay"].priority[:size])).max()) if size else 0.0
        net_worst = worst_leaf(T._leaves(tr.agent.net), end, begin)
        target_worst = worst_leaf(T._leaves(tr.agent.target), target,
                                  begin)
        print(f"chunk {c + 1}: t {tr.agent.t} (JAX {s['t']}), rows "
              f"{size} equal {rows_equal}, write_pos "
              f"{int(tr.replay.write_pos)} (JAX "
              f"{int(s['replay'].write_pos)}), updates {n_up}, loss "
              f"{np.mean(pl) if pl else 0:.4f} (JAX "
              f"{np.mean(jl) if jl else 0:.4f}), worst loss rel "
              f"{loss_rel:.2e}, PER rows the port's sampler picks "
              f"otherwise {sum(m for m, _ in miss)} of {4096 * n_up} (at "
              f"most {max((d for _, d in miss), default=0)} rows away), "
              f"params worst leaf "
              f"{net_worst:.2e}, target {target_worst:.2e}"
              f", priorities max diff {prio:.2e} [{time.time() - t1:.0f} s]",
              flush=True)
        load_flax_params(tr.agent.net, s["params"])
        load_flax_params(tr.agent.target, s["target"])
        begin, first = end, s["updates"]
    rainbow.replay_sample_idx, rainbow.rainbow_loss_grads = \
        real_sample, real_loss


if __name__ == "__main__":
    main()
