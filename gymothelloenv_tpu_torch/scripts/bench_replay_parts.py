"""Decompose the replay insert's cost — pack, data scatter, priority
scatter, and the prefix-sum slot math with its scatter — at two
capacities, to show whether the scatter's cost follows the buffer's
capacity or the rows written — the port of
``scripts/bench_replay_parts.py``.

The port's ring keeps each field in a tensor of its own
(``agents/replay.Replay``), so its data scatter is seven column scatters
of K rows; ``pack`` is ``agents/replay.pack_bytes`` of the K rows, the
byte rows the ring's collectives move (JAX packs every insert).  Each
part is ``REPS`` (64) sequential calls, timed between CUDA events
(``utils/timing.mean_ms``), as ms a call; one JSON line under JAX's
keys.

Usage: python -m gymothelloenv_tpu_torch.scripts.bench_replay_parts
       [--device=cuda]
"""

from __future__ import annotations

import json
import sys

import torch

from gymothelloenv_tpu_torch.scripts.tool import setup
from gymothelloenv_tpu_torch.utils.timing import mean_ms

REPS = 64
K = 2048
CAPACITIES = (1_000_000, 100_000)


def timed(fn, device) -> float:
    """ms a call of ``fn(i)`` over ``REPS`` sequential calls."""
    def run():
        for i in range(REPS):
            fn(i)
    return mean_ms(run, 1, device) / REPS


def main(argv=None) -> dict:
    from gymothelloenv_tpu_torch.agents.replay import (FIELDS, ReplayConfig,
                                                       pack_bytes,
                                                       replay_init)
    argv = sys.argv[1:] if argv is None else argv
    dev = setup(argv)
    gen = torch.Generator(dev).manual_seed(0)
    board = torch.randint(-1, 2, (K, 8, 8), generator=gen,
                          device=dev).to(torch.int8)
    rows = {"board": board, "turn": torch.ones((K,), dtype=torch.int8,
                                               device=dev),
            "action": torch.randint(0, 64, (K,), generator=gen,
                                    device=dev).to(torch.int32),
            "reward": torch.randn((K,), generator=gen, device=dev),
            "next_board": board,
            "next_turn": torch.ones((K,), dtype=torch.int8, device=dev),
            "done": torch.zeros((K,), dtype=torch.bool, device=dev)}
    valid = torch.rand((K,), generator=gen, device=dev) < 0.9
    packed = pack_bytes([rows[f] for f in FIELDS], 1)
    out = {"row_bytes": packed.shape[1]}
    out["pack_ms"] = round(timed(lambda i: pack_bytes(
        [rows[f] + i if f == "reward" else rows[f] for f in FIELDS], 1),
        dev), 4)
    for C in CAPACITIES:
        rb = replay_init(ReplayConfig(capacity=C), dev)
        idx0 = torch.randint(0, C, (K,), generator=gen, device=dev)

        def scatter_data(i):
            idx = (idx0 + i) % C
            for f in FIELDS:
                getattr(rb, f)[idx] = rows[f]

        def scatter_prio(i):
            rb.priority[(idx0 + i) % C] = 1.0 + i

        wp = [torch.zeros((), dtype=torch.int64, device=dev)]

        def slot_math(i):
            offsets = torch.cumsum(valid.to(torch.int64), 0) - 1
            idx = torch.where(valid, (wp[0] + offsets) % C,
                              torch.full_like(offsets, C))
            for f in FIELDS:
                getattr(rb, f)[idx] = rows[f]
            wp[0] = wp[0] + valid.sum()

        out[f"scatter_data_ms_C{C}"] = round(timed(scatter_data, dev), 4)
        out[f"scatter_prio_ms_C{C}"] = round(timed(scatter_prio, dev), 4)
        out[f"scatter_slotmath_ms_C{C}"] = round(timed(slot_math, dev), 4)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
