"""Scripted baseline policies — the port of ``policies/scripted.py``
(random and greedy; maximin is not ported yet).

Protocol: ``act(state, generator) -> int64 actions (N,)`` on a batched
``BitState``; policies that need no randomness ignore ``generator``.
"""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.core import bitboard as bb
from gymothelloenv_tpu_torch.core.engine import BitEngine

_ENGINE = BitEngine()


def random_policy(state: bb.BitState,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """Uniform sample over legal actions (RandomPolicy,
    simple_policies.py:21-44)."""
    return bb.random_legal_bit(state.legal, generator=generator)


def greedy_policy(state: bb.BitState,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """1-ply disk-count maximizer, ties to the lowest action index
    (GreedyPolicy, simple_policies.py:57-92)."""
    del generator
    return _ENGINE.greedy(state)

