"""Reference-API policy classes (drop-in for ``simple_policies.py``) — the
port of ``compat/policies.py``.

The same duck-typed protocol, ``reset(env)``, ``get_action(obs)``,
``get_test_action(obs)`` and an optional ``seed(s)``, with the decisions
of the port's batched policies on a batch of one game (on the env's
device): ``GreedyPolicy`` is ``policies.scripted.greedy_policy``,
``MaxiMinPolicy`` is ``maximin_action`` (on a plane state: the
reference's own search, any board size).  ``RandomPolicy`` draws through
``np.random.RandomState`` in the reference's exact order
(simple_policies.py:21-44), so seeded runs equal JAX's and the
reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.state import OthelloState
from gymothelloenv_tpu_torch.policies.scripted import (greedy_policy,
                                                       maximin_action)

WHITE_DISK = 1
BLACK_DISK = -1


def _unwrap(env):
    return env.env if hasattr(env, "env") else env


def _plane_state(env) -> OthelloState:
    """The env's position as a batch of one plane game on its device, the
    legal moves recomputed for the side to move."""
    device = getattr(env, "device", "cpu")
    board = torch.as_tensor(env.board_state, dtype=torch.int8,
                            device=device)[None]
    turn = torch.tensor([env.player_turn], dtype=torch.int8, device=device)
    return OthelloState(board=board, turn=turn,
                        legal=core.legal_actions(board, turn),
                        terminated=torch.zeros(1, dtype=torch.bool,
                                               device=device),
                        winner=torch.zeros(1, dtype=torch.int8,
                                           device=device))


class RandomPolicy:
    """simple_policies.py:21-44 (bit-exact RandomState draws)."""

    def __init__(self, seed=0):
        self.rnd = np.random.RandomState(seed=seed)
        self.env = None

    def reset(self, env):
        self.env = _unwrap(env)

    def seed(self, seed):
        self.rnd = np.random.RandomState(seed=seed)

    def get_action(self, obs):
        possible_moves = self.env.possible_moves
        ix = self.rnd.randint(0, len(possible_moves))
        return possible_moves[ix]

    def get_test_action(self, obs):
        return self.get_action(obs)


class GreedyPolicy:
    """simple_policies.py:57-95 — 1-ply disk-count maximisation, ties to
    the lowest action.  Reads the position from the env handle (the
    reference un-featurizes its obs and replays on a scratch env; the
    same decision either way)."""

    def __init__(self):
        self.env = None

    def reset(self, env):
        self.env = _unwrap(env)

    def get_action(self, obs):
        return int(greedy_policy(_plane_state(self.env))[0])

    def get_test_action(self, obs):
        return self.get_action(obs)


class MaxiMinPolicy:
    """simple_policies.py:98-163 — depth-k maximin (with the reference's
    forced-pass node handling)."""

    def __init__(self, max_search_depth=1):
        self.env = None
        self.max_search_depth = max_search_depth

    def reset(self, env):
        self.env = _unwrap(env)

    def get_action(self, obs):
        return int(maximin_action(_plane_state(self.env),
                                  self.max_search_depth)[0])

    def get_test_action(self, obs):
        return self.get_action(obs)


class HumanPolicy:
    """simple_policies.py:166-177."""

    def __init__(self, board_size=8):
        self.board_size = board_size

    def reset(self, env):
        pass

    def get_action(self, obs):
        return int(input("Enter action index:"))

    def get_test_action(self, obs):
        return self.get_action(obs)
