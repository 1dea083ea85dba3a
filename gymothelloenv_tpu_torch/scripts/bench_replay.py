"""Micro-bench the device replay at DQN throughput sizes: K-row masked
inserts and batch sampling against a 1,000,000-row buffer, ``REPS`` (64)
sequential calls, the per-ply cadence of ``train_chunk`` — the port of
``scripts/bench_replay.py``.

Both replays are timed, uniform and prioritized (JAX's script timed PER
alone): an insert is ``agents/replay.replay_insert`` of K rows, about 90%
valid; a sample is ``replay_sample_idx`` on ``batch`` uniforms and
``replay_gather`` of the rows.  Times are ms a call between CUDA events
(``utils/timing.mean_ms``).  Beside them each line carries the exact
counts the calls must leave: the rows inserted (``REPS`` times the valid
rows, one warm-up insert more, up to the capacity), the write position
they imply, and the rows sampled, all within the filled rows.

Usage: python -m gymothelloenv_tpu_torch.scripts.bench_replay [K] [batch]
       [--device=cuda]
"""

from __future__ import annotations

import json
import sys

import torch

from gymothelloenv_tpu_torch.scripts.tool import positional, setup
from gymothelloenv_tpu_torch.utils.timing import mean_ms

REPS = 64
CAPACITY = 1_000_000


def main(argv=None) -> list:
    from gymothelloenv_tpu_torch.agents.replay import (ReplayConfig,
                                                       replay_gather,
                                                       replay_init,
                                                       replay_insert,
                                                       replay_sample_idx)
    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    pos = positional(argv)
    K = int(pos[0]) if pos else 2048
    batch = int(pos[1]) if len(pos) > 1 else 4096
    gen = torch.Generator(dev).manual_seed(0)
    board = torch.randint(-1, 2, (K, 8, 8), generator=gen,
                          device=dev).to(torch.int8)
    turn = torch.ones((K,), dtype=torch.int8, device=dev)
    action = torch.randint(0, 64, (K,), generator=gen, device=dev)
    reward = torch.randn((K,), generator=gen, device=dev)
    done = torch.rand((K,), generator=gen, device=dev) < 0.03
    valid = torch.rand((K,), generator=gen, device=dev) < 0.9
    n_valid = int(valid.sum())
    rows = []
    for prioritized in (False, True):
        cfg = ReplayConfig(capacity=CAPACITY, prioritized=prioritized)
        rb = replay_init(cfg, dev)

        def insert():
            replay_insert(rb, cfg, board, turn, action, reward, board, turn,
                          done, valid)

        insert_ms = mean_ms(lambda: [insert() for _ in range(REPS)], 1,
                            dev) / REPS
        inserted = min((2 * REPS) * n_valid, CAPACITY)
        size, write_pos = int(rb.size), int(rb.write_pos)
        sampled, worst = [], [0]

        def sample():
            for _ in range(REPS):
                u = torch.rand((batch,), generator=gen, device=dev)
                idx = replay_sample_idx(rb, cfg, u)
                out = replay_gather(rb, idx)
                sampled.append(out[0].shape[0])
                worst[0] = max(worst[0], int(idx.max()))

        sample_ms = mean_ms(sample, 1, dev) / REPS
        rows.append(dict(
            K=K, batch=batch, prioritized=prioritized,
            insert_ms=round(insert_ms, 4), sample_ms=round(sample_ms, 4),
            inserted=size, inserted_want=inserted,
            write_pos=write_pos, write_pos_want=(2 * REPS * n_valid)
            % CAPACITY, sampled=sum(sampled[-REPS:]),
            sampled_want=REPS * batch, max_index=worst[0]))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
