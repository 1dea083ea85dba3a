"""Trace one Rainbow ``train_chunk`` (C51, noisy nets, prioritized replay)
and print its kernel table — the port of ``scripts/trace_rainbow_chunk.
py``.

``RainbowTrainer`` at N games, batch ``--batch``, one update a
``--interval`` learner transitions, ``--plies`` plies a chunk, no
warm-up replay, a 1,000,000-row PER replay; two chunks, then one
traced, with ``trace_dqn_chunk``'s readings.  JAX's script then printed
the XLA HLO bodies of unnamed fusions; eager PyTorch launches named
kernels, so the table names them already.

Usage: python -m gymothelloenv_tpu_torch.scripts.trace_rainbow_chunk [N]
       [--batch=4096] [--interval=512] [--plies=64] [--device=cuda]
"""

from __future__ import annotations

import sys

from gymothelloenv_tpu_torch.scripts import trace_dqn_chunk
from gymothelloenv_tpu_torch.scripts.tool import flag, positional, setup


def main(argv=None) -> dict:
    from gymothelloenv_tpu_torch.agents.rainbow import RainbowConfig
    from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.dqn_trainer import DQNRunConfig
    from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer

    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    batch = int(flag(argv, "batch", "4096"))
    interval = int(flag(argv, "interval", "512"))
    plies = int(flag(argv, "plies", "64"))
    pos = positional(argv)
    N = int(pos[0]) if pos else 1024

    trainer = RainbowTrainer(
        env_cfg=EnvConfig(num_disk_as_reward=True),
        rainbow_cfg=RainbowConfig(batch_size=batch, train_interval=interval,
                                  initial_replay_size=0),
        rb_cfg=ReplayConfig(capacity=trace_dqn_chunk.CAPACITY,
                            prioritized=True),
        run_cfg=DQNRunConfig(num_envs=N, chunk_plies=plies, seed=0),
        log_fn=lambda step, m: None, device=dev)
    return trace_dqn_chunk.trace_chunk(trainer, "torchtrace_rainbow_")


if __name__ == "__main__":
    main()
