"""The recorded reference transcripts (tests/golden/golden_games.json)
replayed through the port's bitboard engine, and the port's greedy policy
on every recorded position where greedy moved."""

import json
import os

import numpy as np
import pytest
import torch

from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.ops import step
from gymothelloenv_tpu_torch.policies.scripted import greedy_policy

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_games.json")

with open(GOLDEN) as f:
    DATA = json.load(f)

GAME_IDS = [f"{g['black']}_vs_{g['white']}" for g in DATA["games"]]


def replay(game):
    """Replay one transcript, checking every ply; returns the pre-move
    states stacked into one batch."""
    s = tb.bit_reset(1, device="cpu")
    states = []
    for i, rec in enumerate(game["steps"]):
        assert not bool(s.terminated[0]), f"ply {i}"
        assert int(s.turn[0]) == rec["turn"], f"ply {i}"
        legal = torch.nonzero(tb.unpack_flat(s.legal)[0])[:, 0].tolist()
        assert legal == sorted(rec["legal"]), f"ply {i}"
        states.append(s)
        r = step.bit_step(s, torch.tensor([rec["action"]]))
        assert float(r.reward[0]) == rec["reward"], f"ply {i}"
        assert bool(r.done[0]) == rec["done"], f"ply {i}"
        s = r.state
    board = (tb.unpack(s.white)[0].to(torch.int8)
             - tb.unpack(s.black)[0].to(torch.int8))
    np.testing.assert_array_equal(board.numpy(),
                                  np.asarray(game["final_board"]))
    assert int(s.winner[0]) == game["winner"]
    return tb.BitState(**{k: torch.cat([getattr(x, k) for x in states])
                          for k in vars(states[0])})


@pytest.mark.parametrize("game", DATA["games"], ids=GAME_IDS)
def test_golden_replay_through_port(game):
    batch = replay(game)
    actions = np.asarray([rec["action"] for rec in game["steps"]])
    turns = np.asarray([rec["turn"] for rec in game["steps"]])
    for color, spec in ((-1, game["black"]), (1, game["white"])):
        if spec != "greedy":
            continue
        idx = torch.from_numpy(np.nonzero(turns == color)[0])
        sub = tb.BitState(**{k: v[idx] for k, v in vars(batch).items()})
        got = greedy_policy(sub).numpy()
        np.testing.assert_array_equal(got, actions[idx.numpy()],
                                      err_msg=f"greedy as {color}")
