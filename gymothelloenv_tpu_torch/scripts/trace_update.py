"""Trace one full PPO update with ``torch.profiler`` and print the top
kernels by device time — the port of ``scripts/trace_update.py``.

``utils/profiling.summarize_trace`` reads the Chrome trace the profiler
writes and sums the device time of each kernel, so update-tuning decisions
rest on measured kernel costs.  The update (``agents/ppo.ppo_update``,
``PPOConfig()``'s 4 epochs x 4 minibatches) runs on a random (T, N)
rollout at the default net (or ``--bf16``'s); JAX's ``--impl`` picks
TPU-only trunks and is not taken.  ``capture`` and ``summarize`` are the
helpers the other trace scripts share.

Usage: python -m gymothelloenv_tpu_torch.scripts.trace_update [T] [N]
       [--bf16] [--device=cuda]
"""

from __future__ import annotations

import sys
import tempfile

import torch

from gymothelloenv_tpu_torch.scripts.tool import positional, setup
from gymothelloenv_tpu_torch.utils.profiling import (B1_KERNEL,
                                                     force_sync,
                                                     format_op_table,
                                                     kernel_launches,
                                                     summarize_trace,
                                                     traced_call)


def capture(fn, args, trace_dir):
    """``fn(*args)`` once to warm up, then once under the profiler into
    ``trace_dir``; returns ``(out, wall seconds)`` of the traced call."""
    force_sync(fn(*args))
    return traced_call(lambda: fn(*args), trace_dir)


def summarize(trace_dir, top=45):
    """Print the trace's kernels by device time and the ply kernel's runs
    (B1, ``bit_step_kernel``); returns the ``OpCost`` list."""
    ops = summarize_trace(trace_dir)
    print(format_op_table(ops, top=top))
    print(f"bit_step_kernel runs: {kernel_launches(ops, B1_KERNEL)}",
          flush=True)
    return ops


def main(argv=None) -> dict:
    from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, Transition,
                                                    make_optimizer,
                                                    ppo_update)
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.ops.shuffle import draw_words
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network

    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    bf16 = "--bf16" in argv
    pos = positional(argv)
    T = int(pos[0]) if pos else 64
    N = int(pos[1]) if len(pos) > 1 else 4096

    env_cfg = EnvConfig()
    ppo_cfg = PPOConfig()
    net = make_network(env_cfg, seed=1, device=dev, bf16=bf16)
    optimizer = make_optimizer(ppo_cfg, net.parameters())
    gen = torch.Generator(dev).manual_seed(0)
    roll = Transition(
        obs=(torch.rand((T, N, 4, 8, 8), generator=gen, device=dev)
             < 0.3).to(torch.int8),
        action=torch.randint(0, 64, (T, N), generator=gen, device=dev),
        logp=torch.full((T, N), -3.0, device=dev),
        value=torch.zeros((T, N), device=dev),
        reward=torch.zeros((T, N), device=dev),
        done=torch.zeros((T, N), dtype=torch.bool, device=dev),
        legal=torch.ones((T, N, 64), dtype=torch.bool, device=dev))
    boot = torch.zeros((N,), device=dev)
    words = draw_words(torch.Generator().manual_seed(2), ppo_cfg.ppo_epochs)

    def full_update(roll):
        return ppo_update(net, optimizer, roll, boot, words,
                          ppo_cfg)["value_loss"]

    trace_dir = tempfile.mkdtemp(prefix="torchtrace_")
    _, wall = capture(full_update, (roll,), trace_dir)
    print("trace dir:", trace_dir, flush=True)
    print(f"update T={T} N={N} bf16={bf16}: wall {wall:.4f} s", flush=True)
    ops = summarize(trace_dir)
    return dict(trace_dir=trace_dir, wall_s=wall, ops=ops)


if __name__ == "__main__":
    main()
