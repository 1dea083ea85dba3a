"""Trace the PPO self-play collection (``train/self_play.collect_rollout``)
and print its wall timings and kernel table — the port of
``scripts/trace_collect.py``.

A seeded net (``--width-mult``, ``--hidden``, ``--bf16``) collects T
slots on N games with disk-count rewards, the protagonist sampling or,
with ``--lookahead``, playing the 1-ply value search
(``make_lookahead_override(tau)``).  One warm-up collection, five timed
back to back (ms a rollout and transitions/s), then one traced: its wall
seconds, device seconds, idle share, kernels a slot and the ply kernel's
launches (the wrapper's count and the trace's ``bit_step_kernel`` runs),
then the kernel table.  JAX's ``--k=`` patched its search's compaction
width, which the port's search does not have, and is not taken.

Usage: python -m gymothelloenv_tpu_torch.scripts.trace_collect [T] [N]
       [--bf16] [--lookahead] [--tau=0.0] [--width-mult=1] [--hidden=512]
       [--device=cuda]
"""

from __future__ import annotations

import sys
import tempfile
import time

import torch

from gymothelloenv_tpu_torch.scripts.tool import flag, positional, setup
from gymothelloenv_tpu_torch.utils.profiling import (B1_KERNEL,
                                                     format_op_table,
                                                     force_sync,
                                                     kernel_launches,
                                                     report,
                                                     summarize_trace,
                                                     traced_call)


def main(argv=None) -> dict:
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.ops import step
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    from gymothelloenv_tpu_torch.train.self_play import (
        Draws, collect_rollout, make_lookahead_override, selfplay_init)

    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    bf16 = "--bf16" in argv
    lookahead = "--lookahead" in argv
    tau = float(flag(argv, "tau", "0.0"))
    width_mult = int(flag(argv, "width-mult", "1"))
    hidden = int(flag(argv, "hidden", "512"))
    pos = positional(argv)
    T = int(pos[0]) if pos else 64
    N = int(pos[1]) if len(pos) > 1 else 4096

    env_cfg = EnvConfig(num_disk_as_reward=True)
    net = make_network(env_cfg, hidden, width_mult, seed=1, device=dev,
                       bf16=bf16)
    override = make_lookahead_override(env_cfg, tau) if lookahead else None
    draws = Draws(torch.Generator(dev).manual_seed(0))
    sp = {"state": selfplay_init(net, env_cfg, N, draws,
                                 act_override=override)}

    def collect():
        sp["state"], rollout, boot = collect_rollout(
            net, sp["state"], env_cfg, T, draws, act_override=override)
        return rollout.reward.sum() + boot.sum()

    force_sync(collect())
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        s = collect()
    force_sync(s)
    dt = (time.perf_counter() - t0) / reps
    print(f"collect T={T} N={N} bf16={bf16} lookahead={lookahead} "
          f"tau={tau} wm={width_mult}: {dt * 1e3:.1f} ms/rollout = "
          f"{T * N / dt / 1e6:.2f}M trans/s", flush=True)

    trace_dir = tempfile.mkdtemp(prefix="torchtrace_collect_")
    before = step.bit_step.launches
    _, wall = traced_call(collect, trace_dir)
    b1 = step.bit_step.launches - before
    ops = summarize_trace(trace_dir)
    out = report("collect", ops, wall)
    traced_b1 = kernel_launches(ops, B1_KERNEL)
    print(f"[collect] {out['launches'] / T:.1f} kernels a slot ({T} "
          f"slots); B1 launches {b1}, bit_step_kernel runs {traced_b1}",
          flush=True)
    print(format_op_table(ops, top=40))
    out.update(trace_dir=trace_dir, ms_per_rollout=dt * 1e3,
               trans_per_sec=T * N / dt, b1_launches=b1,
               b1_traced=traced_b1, ops=ops)
    return out


if __name__ == "__main__":
    main()
