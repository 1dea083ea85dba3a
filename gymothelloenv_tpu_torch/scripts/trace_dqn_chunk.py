"""Trace one DQN ``train_chunk`` (the collection plies, the replay inserts
and the minibatch updates) and print its kernel table — the port of
``scripts/trace_dqn_chunk.py``.

``DQNTrainer`` at N games, batch ``--batch``, one update a
``--interval`` learner transitions, ``--plies`` plies a chunk (the
trainer's 64), no warm-up replay, a 1,000,000-row uniform replay; two
chunks fill the replay and warm up, then one chunk is
traced.  Prints the chunk's plies, its ply-kernel launches (the wrapper's
count and the trace's ``bit_step_kernel`` runs: one a ply), its updates,
wall and device seconds, then the kernel table.

Usage: python -m gymothelloenv_tpu_torch.scripts.trace_dqn_chunk [N]
       [--batch=4096] [--interval=512] [--plies=64] [--device=cuda]
"""

from __future__ import annotations

import sys
import tempfile

from gymothelloenv_tpu_torch.scripts.tool import flag, positional, setup
from gymothelloenv_tpu_torch.scripts.trace_update import capture, summarize
from gymothelloenv_tpu_torch.utils.profiling import (B1_KERNEL,
                                                     kernel_launches,
                                                     report)

CAPACITY = 1_000_000


def trace_chunk(trainer, prefix: str) -> dict:
    """Two chunks of ``trainer`` to fill its replay and warm up, then one
    traced (``trace_update.capture``: a warm-up chunk and the traced
    one); prints and returns the traced chunk's readings."""
    from gymothelloenv_tpu_torch.ops import step
    trainer.train(num_chunks=2, log_every=10)
    metrics = {}

    def chunk_once():
        before = step.bit_step.launches
        metrics.update(trainer.train_chunk())
        metrics["b1"] = step.bit_step.launches - before
        return metrics["loss"]

    trace_dir = tempfile.mkdtemp(prefix=prefix)
    _, wall = capture(chunk_once, (), trace_dir)
    print("trace dir:", trace_dir, flush=True)
    plies = trainer.run_cfg.chunk_plies
    print(f"chunk: {plies} plies, B1 launches {metrics['b1']}, updates "
          f"{metrics['updates']}, loss {float(metrics['loss']):.4g}",
          flush=True)
    ops = summarize(trace_dir)
    out = report("chunk", ops, wall, top=0)
    out.update(trace_dir=trace_dir, plies=plies, b1_launches=metrics["b1"],
               b1_traced=kernel_launches(ops, B1_KERNEL),
               updates=int(metrics["updates"]), ops=ops)
    return out


def main(argv=None) -> dict:
    from gymothelloenv_tpu_torch.agents.dqn import DQNConfig
    from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                           DQNTrainer)

    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    batch = int(flag(argv, "batch", "4096"))
    interval = int(flag(argv, "interval", "512"))
    plies = int(flag(argv, "plies", "64"))
    pos = positional(argv)
    N = int(pos[0]) if pos else 1024

    trainer = DQNTrainer(
        env_cfg=EnvConfig(num_disk_as_reward=True),
        dqn_cfg=DQNConfig(batch_size=batch, train_interval=interval,
                          initial_replay_size=0),
        rb_cfg=ReplayConfig(capacity=CAPACITY),
        run_cfg=DQNRunConfig(num_envs=N, chunk_plies=plies, seed=0),
        log_fn=lambda step, m: None, device=dev)
    return trace_chunk(trainer, "torchtrace_dqn_")


if __name__ == "__main__":
    main()
