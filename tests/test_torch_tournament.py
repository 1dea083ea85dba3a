"""Port tournament against JAX's ``play_games_impl``: state-determined
policies give the same action streams on both sides, so the winners and
the tally must agree game for game."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.train import tournament as jt
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.models.nets import make_policy_net
from gymothelloenv_tpu_torch.policies.scripted import (greedy_policy,
                                                       random_policy)
from gymothelloenv_tpu_torch.train import tournament as pt

N_GAMES = 48


def _params():
    """Per-game policy parameters; ``d`` = 1 lets white play illegally."""
    rng = np.random.RandomState(0)
    a = rng.randint(1, 17, N_GAMES)
    b = rng.randint(0, 64, N_GAMES)
    c = rng.randint(0, 11, N_GAMES)
    d = np.arange(N_GAMES) % 2
    return a, b, c, d


def _jax_policy(a, b, c, d):
    """k-th legal move with k = (disks * a + b) mod count; where ``d`` is
    set, the out-of-range action 64 when (disks + c) % 11 == 0 (sudden
    death)."""
    def act(key, s):
        del key
        disks = (s.board != 0).sum()
        count = s.legal.sum()
        k = (disks * a + b) % jnp.maximum(count, 1)
        idx = jnp.argmax(jnp.cumsum(s.legal) > k)
        idx = jnp.where((d == 1) & ((disks + c) % 11 == 0), 64, idx)
        return idx.astype(jnp.int32)
    return act


def _port_policy(a, b, c, d):
    a, b, c, d = (torch.from_numpy(x.astype(np.int64)) for x in (a, b, c, d))

    def act(state, generator=None):
        disks = tb.popcount(state.black | state.white)
        count = tb.popcount(state.legal)
        k = (disks * a + b) % count.clamp(min=1)
        idx = tb.random_legal_bit(state.legal, k)
        return torch.where((d == 1) & ((disks + c) % 11 == 0), 64, idx)
    return act


@functools.cache
def _jax_winners(max_plies):
    a, b, c, d = _params()
    cfg = JaxEnvConfig()

    def one(a, b, c, d):
        return jt.play_games_impl(
            jax.random.PRNGKey(0), cfg, _jax_policy(a, b, c, 0 * d),
            _jax_policy(a + 3, b + 5, c, d), 1, 0, max_plies)[0]
    return np.asarray(jax.jit(jax.vmap(one))(
        *(jnp.asarray(x) for x in (a, b, c, d))))


@pytest.mark.parametrize("max_plies", [0, 30])
def test_play_games_matches_jax_on_same_action_streams(max_plies):
    a, b, c, d = _params()
    want = _jax_winners(max_plies)
    got = pt.play_games(_port_policy(a, b, c, 0 * d),
                        _port_policy(a + 3, b + 5, c, d),
                        N_GAMES, 0, max_plies, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    jb, jd, jw = jt.tally(jnp.asarray(want))
    assert pt.tally(got) == (int(jb), int(jd), int(jw))
    if max_plies == 0:
        # Both outcomes occur.
        assert (got == -1).any() and (got == 1).any()
    else:
        assert (got == 0).any()


def test_random_openings_play_rand_left_random_plies():
    """Both sides play the illegal action 64, so a game lasts exactly its
    forced-random plies (2 * U{0..5}) plus the sudden-death ply."""
    seen = []

    def black(state, generator=None):
        seen.append(state.terminated.clone())
        return torch.full_like(state.turn, 64, dtype=torch.int64)

    def white(state, generator=None):
        return torch.full_like(state.turn, 64, dtype=torch.int64)

    g = torch.Generator().manual_seed(0)
    winners = pt.play_games(black, white, 256, init_rand_steps=10,
                            generator=g, device="cpu")
    # Plies each game lasted: the first ply whose state shows it over (the
    # longest games end the loop, so they are never shown over).
    over = torch.stack(seen + [torch.ones_like(seen[0])])
    lengths = over.to(torch.int64).argmax(0).numpy()
    assert set(np.unique(lengths)) == {1, 3, 5, 7, 9, 11}
    # An even number of random plies leaves black to move: black loses.
    assert (winners == 1).all()


def test_scripted_policies_play_legal_moves():
    g = torch.Generator().manual_seed(1)
    for policy in (random_policy, greedy_policy):
        winners = pt.play_games(policy, random_policy, 32, generator=g,
                                device="cpu")
        assert winners.shape == (32,) and winners.dtype == torch.int8
        assert (winners != 0).float().mean() > 0.5


def test_net_vs_greedy_evaluate():
    net = make_policy_net(1, 64, seed=0, device="cpu")
    act = pt.net_tournament_policy(net)
    g = torch.Generator().manual_seed(2)
    state = tb.bit_reset(6, device="cpu")
    a = act(state, g)
    assert bool((tb.action_bit(a) & state.legal != 0).all())
    w, d, l = pt.evaluate(act, greedy_policy, 16, init_rand_steps=4,
                          generator=g, device="cpu")
    assert w + d + l == 16 and min(w, d, l) >= 0
