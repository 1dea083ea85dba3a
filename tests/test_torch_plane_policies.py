"""The scripted policies on plane games and the tournament at B != 8
against JAX: greedy at B = 6 and 10 and maximin-k (depths 1-3 at B = 6,
depth 1 at B = 10; chunked = unchunked) against ``gymothelloenv_tpu.
policies.scripted`` on reachable positions, and whole 6x6 tournaments
(``train/tournament.play_games``) against JAX's jitted ``play_games`` with
random openings, JAX's draws rebuilt from its keys and injected
(``InjectedDraws``).  Tolerance: exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import state as jcore
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.policies import scripted as jscripted
from gymothelloenv_tpu.train import tournament as jtour
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.policies import scripted
from gymothelloenv_tpu_torch.train import tournament
from gymothelloenv_tpu_torch.train.self_play import InjectedDraws
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import plane_positions, plane_to_port


@pytest.mark.parametrize("b", (6, 10))
def test_plane_greedy_and_random_match_jax(b):
    states = plane_positions(b, seed=b)
    port = plane_to_port(states)
    want = np.asarray(jax.vmap(jscripted.greedy_action)(states))
    np.testing.assert_array_equal(scripted.greedy_policy(port).numpy(),
                                  want)
    legal = np.asarray(states.legal)
    has = legal.any(1)
    moves = scripted.random_policy(port, torch.Generator().manual_seed(b))
    assert legal[np.arange(len(legal)), moves.numpy()][has].all()


# (board, depth, states): depth 3 on fewer states (JAX expands all B^3).
MAXIMIN = ((6, 1, 64), (6, 2, 64), (6, 3, 12), (10, 1, 64))


@pytest.mark.parametrize("b,depth,n", MAXIMIN)
def test_plane_maximin_matches_jax(b, depth, n):
    states = plane_positions(b, n=n, seed=10 + depth)
    cfg = JaxEnvConfig(board_size=b)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: jscripted.maximin_action(s, cfg, depth)))(states))
    port = plane_to_port(states)
    got = scripted.maximin_action(port, depth)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        scripted.maximin_action(port, depth, expand_chunk=5).numpy(), want)
    np.testing.assert_array_equal(
        scripted.maximin_action(port, depth, expand_chunk=-1).numpy(), want)


def _jax_policy(name):
    if name == "greedy":
        return jscripted.greedy_policy
    return jscripted.maximin_policy(int(name[-1]), JaxEnvConfig(board_size=6))


def _port_policy(name):
    if name == "greedy":
        return scripted.greedy_policy
    return scripted.maximin_policy(int(name[-1]))


def _jax_draws(key, black, white, n, init, cfg):
    """JAX ``play_games_impl``'s loop replayed step for step with its key
    schedule: the winners and, per ply, each game's random move as its
    rank among the legal moves (0 without one), and the opening counts."""
    game_keys = jax.random.split(key, n + 1)
    key = game_keys[0]
    rand_left = np.asarray(jax.vmap(jtour.draw_max_rand_steps,
                                    in_axes=(0, None))(game_keys[1:], init))
    s = jax.vmap(lambda _: jcore.reset(cfg))(jnp.arange(n))
    step = jax.jit(jax.vmap(jcore.step, in_axes=(0, 0, None)),
                   static_argnums=2)
    acts = {c: jax.jit(jax.vmap(p)) for c, p in (("b", black), ("w", white))}
    ranks = []
    left = rand_left.copy()
    for _ in range(cfg.board_size ** 2):
        if bool(np.asarray(s.terminated).all()):
            break
        key, k_rand, k_black, k_white = jax.random.split(key, 4)
        a_rand = np.asarray(jax.vmap(jscripted.random_action)(
            jax.random.split(k_rand, n), s.legal))
        legal = np.asarray(s.legal)
        ranks.append(torch.tensor([int(legal[i, :a_rand[i]].sum())
                                   for i in range(n)]))
        a_b = np.asarray(acts["b"](jax.random.split(k_black, n), s))
        a_w = np.asarray(acts["w"](jax.random.split(k_white, n), s))
        turn = np.asarray(s.turn)
        action = np.where(left > 0, a_rand, np.where(turn == -1, a_b, a_w))
        live = ~np.asarray(s.terminated)
        new = step(s, jnp.asarray(action.astype(np.int32)), cfg).state
        s = jax.tree.map(lambda x, o: jnp.where(
            jnp.asarray(live).reshape((-1,) + (1,) * (x.ndim - 1)), x, o),
            new, s)
        left = np.where(live, np.maximum(left - 1, 0), left)
    return np.asarray(s.winner), torch.from_numpy(rand_left), ranks


@functools.cache
def _jax_play(black, white, n, init):
    cfg = JaxEnvConfig(board_size=6)
    key = jax.random.PRNGKey(5)
    winners = np.asarray(jtour.play_games(key, cfg, _jax_policy(black),
                                          _jax_policy(white), n, init))
    replay = _jax_draws(key, _jax_policy(black), _jax_policy(white), n, init,
                        cfg)
    return winners, replay


@pytest.mark.parametrize("black,white", (("greedy", "maximin-1"),
                                         ("maximin-2", "greedy")))
def test_board6_tournament_matches_jax(black, white):
    """24 games with 8 random opening plies: JAX's winners from its jitted
    ``play_games``; the replay of its loop gives the same winners and the
    draws the port plays from."""
    n, init = 24, 8
    want, (replayed, rand_left, ranks) = _jax_play(black, white, n, init)
    np.testing.assert_array_equal(replayed, want)
    draws = InjectedDraws((), (), [rand_left], ranks)
    got = tournament.play_games(_port_policy(black), _port_policy(white), n,
                                init, cfg=EnvConfig(board_size=6),
                                device="cpu", draws=draws)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want.tolist())) > 1
