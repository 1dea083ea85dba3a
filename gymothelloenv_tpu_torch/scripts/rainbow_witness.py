"""Rainbow's training on the card against its CPU twin, chunk by chunk, at
JAX job 07's size (``data/queue/done/07_rainbow_pool.job``: N 1024,
64-ply chunks, batch 4096, train interval 512, the opponent pool, a 1M
PER replay; no warm-up, so every chunk trains).

Both trainers start from the card's initial params.  Each chunk runs on
the card first with every random number it draws and every PER row its
sampler picks recorded; the CPU twin then runs the same chunk on those
draws (``train.self_play.InjectedDraws``) and rows.  After each chunk it
prints the replay rows that differ (of the fields that make a
transition), the chunk's mean loss on each side and their largest
relative gap an update, each parameter leaf's largest difference over the
leaf's largest value, and the priorities' largest difference.  Equal rows
and losses to float32 rounding say the card computes what the CPU does
on the same draws, so a difference between runs on the two devices is a
difference of their random streams.

    python -m gymothelloenv_tpu_torch.scripts.rainbow_witness [--chunks 3]
        [--seed 21] [--num-envs 1024]

Needs a card; on it first prints the card's name and power limit
(nvidia-smi).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from gymothelloenv_tpu_torch.agents import rainbow
from gymothelloenv_tpu_torch.agents.rainbow import RainbowConfig
from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.train.dqn_trainer import DQNRunConfig
from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer
from gymothelloenv_tpu_torch.train.self_play import InjectedDraws

DRAWS = ("colors", "uniforms", "rand_left", "legal_index",
         "replay_uniforms", "normals")
ROW_FIELDS = ("board", "action", "reward", "done", "next_board")


class RecordingDraws:
    """``draws`` with every result also kept, on the CPU, in ``record``."""

    def __init__(self, draws):
        self.draws = draws
        self.record = {k: [] for k in DRAWS}

    def _kept(self, name, out):
        self.record[name].append(out.cpu())
        return out

    def colors(self, n, device):
        return self._kept("colors", self.draws.colors(n, device))

    def uniforms(self, n, device):
        return self._kept("uniforms", self.draws.uniforms(n, device))

    def rand_left(self, n, init, device):
        return self._kept("rand_left", self.draws.rand_left(n, init, device))

    def legal_index(self, counts):
        return self._kept("legal_index", self.draws.legal_index(counts))

    def replay_uniforms(self, n, device):
        return self._kept("replay_uniforms",
                          self.draws.replay_uniforms(n, device))

    def normals(self, n, device):
        return self._kept("normals", self.draws.normals(n, device))

    def noise(self, n, device):
        return self._kept("normals", self.draws.noise(n, device))


def _run_chunk(trainer, snap, sample, losses):
    """One ``train_chunk`` with the PER sampler ``sample`` and each
    update's loss appended to ``losses``."""
    real_sample, real_loss = rainbow.replay_sample_idx, \
        rainbow.rainbow_loss_grads

    def loss_grads(*args):
        out = real_loss(*args)
        losses.append(float(out[0]))
        return out
    rainbow.replay_sample_idx, rainbow.rainbow_loss_grads = sample, \
        loss_grads
    try:
        t0 = time.perf_counter()
        trainer.train_chunk(snap)
        return time.perf_counter() - t0
    finally:
        rainbow.replay_sample_idx = real_sample
        rainbow.rainbow_loss_grads = real_loss


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        prog="python -m gymothelloenv_tpu_torch.scripts.rainbow_witness")
    parser.add_argument("--chunks", type=int, default=3)
    parser.add_argument("--seed", type=int, default=21)
    parser.add_argument("--num-envs", type=int, default=1024)
    args = parser.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=10, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    cfgs = (EnvConfig(num_disk_as_reward=True),
            RainbowConfig(batch_size=4096, train_interval=512,
                          initial_replay_size=0),
            ReplayConfig(capacity=1_000_000, prioritized=True),
            DQNRunConfig(num_envs=args.num_envs, opponent_pool=8,
                         pool_interval=50, seed=args.seed))
    card = RainbowTrainer(*cfgs, device="cuda")
    cpu = RainbowTrainer(*cfgs, device="cpu")
    state = {k: v.cpu() for k, v in card.agent.net.state_dict().items()}
    for net in (cpu.agent.net, cpu.agent.target):
        net.load_state_dict(state)
    snaps = (card._snapshot(), cpu._snapshot())
    rec = RecordingDraws(card.draws)
    card.draws = rec
    rows, loss_card, loss_cpu, out = [], [], [], []
    real_sample = rainbow.replay_sample_idx

    def sample_card(rb, cfg, u):
        idx = real_sample(rb, cfg, u)
        rows.append(idx.cpu())
        return idx
    for chunk in range(args.chunks):
        start = {k: len(v) for k, v in rec.record.items()}
        first_row, first_loss = len(rows), len(loss_card)
        secs_card = _run_chunk(card, snaps[0], sample_card, loss_card)
        torch.cuda.synchronize()
        cpu.draws = InjectedDraws(**{k: v[start[k]:]
                                     for k, v in rec.record.items()})
        taken = iter(rows[first_row:])
        secs_cpu = _run_chunk(cpu, snaps[1], lambda *a: next(taken),
                              loss_cpu)
        size = int(card.replay.size)
        differ = {f: int((getattr(card.replay, f)[:size].cpu()
                          != getattr(cpu.replay, f)[:size]).reshape(
                              size, -1).any(1).sum()) for f in ROW_FIELDS}
        lc = np.array(loss_card[first_loss:])
        lp = np.array(loss_cpu[first_loss:])
        params = {k: float((a.cpu() - b).abs().max() / b.abs().max())
                  for (k, a), b in zip(card.agent.net.state_dict().items(),
                                       cpu.agent.net.state_dict().values())}
        worst = max(params, key=params.get)
        reading = dict(chunk=chunk + 1, transitions=card.agent.t,
                       rows_differ=differ, loss_card=float(lc.mean()),
                       loss_cpu=float(lp.mean()),
                       loss_rel=float(np.abs(lc - lp).max()
                                      / np.abs(lp).max()),
                       param_rel=params[worst], worst_leaf=worst,
                       priority_abs=float((card.replay.priority[:size].cpu()
                                           - cpu.replay.priority[:size])
                                          .abs().max()),
                       seconds_card=secs_card, seconds_cpu=secs_cpu)
        out.append(reading)
        print(reading, flush=True)
    return out


if __name__ == "__main__":
    main()
