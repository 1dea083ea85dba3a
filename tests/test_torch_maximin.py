"""Port maximin (``policies/scripted.maximin_action``) against JAX's
``maximin_action``: the same decision on every tested state, exactly.

States: random reachable positions (``torch_port_helpers.random_states``),
from which the tests take ended games, positions with a move after which
the reply side has no move (the reference's pass quirk: that child is
scored at once) and positions with a move that ends the game.  Also:
maximin-1 equals greedy, chunked equals unchunked, one ply-kernel call a
level, and the recorded golden transcripts' maximin moves."""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import bitboard as jbb
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.core.state import OthelloState
from gymothelloenv_tpu.policies.scripted import maximin_action as jax_maximin
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.policies import scripted
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import random_states, to_port

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_games.json")


@functools.cache
def _jax_maximin(depth):
    return jax.jit(jax.vmap(functools.partial(
        jax_maximin, cfg=JaxEnvConfig(), max_search_depth=depth)))


def _take(state, idx):
    return tb.BitState(**{k: v[idx] for k, v in vars(state).items()})


@functools.cache
def _states():
    """(JAX BitState, port BitState, {kind: indices}) over 512 random
    positions: ``ended`` games, ``quirk`` positions (a legal move leaves
    the reply side without a move), ``ending`` positions (a legal move
    ends the game) and ``plain`` ones."""
    jstate = random_states(512, 7, max_plies=64)
    port = to_port(jstate)
    node, action = torch.nonzero(tb.unpack_flat(port.legal), as_tuple=True)
    child = tb.bit_step_plain(_take(port, node), action).state
    flags = {}
    for kind, hit in (("quirk", (child.turn == port.turn[node])
                       & ~child.terminated),
                      ("ending", child.terminated)):
        mask = torch.zeros(512, dtype=torch.bool)
        mask[node[hit]] = True
        flags[kind] = mask
    flags["ended"] = port.terminated
    flags["plain"] = ~(flags["quirk"] | flags["ending"] | flags["ended"])
    kinds = {k: torch.nonzero(v)[:, 0] for k, v in flags.items()}
    return jstate, port, kinds


def _pick(counts):
    """Indices of ``counts[kind]`` states of each kind."""
    _, _, kinds = _states()
    for kind, n in counts.items():
        assert len(kinds[kind]) >= n, (kind, len(kinds[kind]))
    return torch.cat([kinds[k][:n] for k, n in counts.items()])


def _jax_decisions(idx, depth):
    jstate, _, _ = _states()
    sub = jax.tree.map(lambda x: x[idx.numpy()], jstate)
    legal = jbb.unpack2(sub.legal).reshape(sub.turn.shape + (64,))
    othello = OthelloState(board=jbb.to_board(sub), turn=sub.turn,
                           legal=legal, terminated=sub.terminated,
                           winner=sub.winner)
    return np.asarray(_jax_maximin(depth)(othello))


MIXED = {"quirk": 8, "ending": 8, "ended": 8, "plain": 24}   # 48 states


@pytest.mark.parametrize("depth", [1, 2])
def test_maximin_matches_jax(depth):
    idx = _pick(MIXED)
    _, port, _ = _states()
    got = scripted.maximin_action(_take(port, idx), depth)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _jax_decisions(idx, depth))


def test_maximin_depth3_matches_jax_on_quirk_states():
    idx = _pick({"quirk": 3})
    _, port, _ = _states()
    got = scripted.maximin_action(_take(port, idx), 3)
    np.testing.assert_array_equal(got.numpy(), _jax_decisions(idx, 3))


def test_maximin1_equals_greedy():
    _, port, kinds = _states()
    live = _take(port, torch.cat([kinds["plain"], kinds["quirk"],
                                  kinds["ending"]]))
    assert torch.equal(scripted.maximin_action(live, 1),
                       scripted.greedy_policy(live))


@pytest.mark.parametrize("chunk", [1, 7, -1])
def test_chunked_equals_unchunked(chunk, monkeypatch):
    _, port, _ = _states()
    states = _take(port, torch.arange(96))
    want = scripted.maximin_action(states, 2)
    assert torch.equal(scripted.maximin_action(states, 2, chunk), want)
    # The automatic split halves a chunk whose frontier does not fit.
    monkeypatch.setattr(scripted, "_CPU_BUDGET", 200_000)
    assert torch.equal(scripted.maximin_action(states, 2), want)


def test_one_ply_call_a_level(monkeypatch):
    calls = []
    real = scripted.step.bit_step

    def counted(state, action, *args, **kwargs):
        calls.append(action.shape[0])
        return real(state, action, *args, **kwargs)

    monkeypatch.setattr(scripted.step, "bit_step", counted)
    _, port, kinds = _states()
    states = _take(port, kinds["plain"][:16])
    scripted.maximin_action(states, 3)
    legal = int(tb.popcount(states.legal).sum())
    assert len(calls) == 3 and calls[0] == legal
    with pytest.raises(ValueError):
        scripted.maximin_action(states, 0)


def test_make_policy():
    assert scripted.make_policy("rand") is scripted.random_policy
    assert scripted.make_policy("greedy") is scripted.greedy_policy
    _, port, kinds = _states()
    states = _take(port, kinds["plain"][:8])
    act = scripted.make_policy("maximin", search_depth=2)
    assert torch.equal(act(states), scripted.maximin_action(states, 2))
    with pytest.raises(ValueError, match="unknown scripted policy"):
        scripted.make_policy("minimax")


with open(GOLDEN) as f:
    _GAMES = json.load(f)["games"]


def _golden_cases():
    for g in _GAMES:
        for colour, spec in ((-1, g["black"]), (1, g["white"])):
            if spec.startswith("maximin-"):
                yield pytest.param(g, colour, int(spec[-1]),
                                   id=f"{g['black']}_vs_{g['white']}"
                                      f"_{'white' if colour == 1 else 'black'}")


@pytest.mark.parametrize("game,colour,depth", _golden_cases())
def test_golden_transcripts(game, colour, depth):
    """Every recorded move of a maximin side, from the replayed
    position."""
    s = tb.bit_reset(1, device="cpu")
    states, actions = [], []
    for rec in game["steps"]:
        if rec["turn"] == colour:
            states.append(s)
            actions.append(rec["action"])
        s = tb.bit_step(s, torch.tensor([rec["action"]])).state
    batch = tb.BitState(**{k: torch.cat([getattr(x, k) for x in states])
                           for k in vars(states[0])})
    got = scripted.maximin_action(batch, depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(actions))
