"""The port's reference-API layer (``compat/envs.py``,
``compat/policies.py``, ``compat/featurize.py``) and its drivers
(``cli/run.py``, ``cli/run_2agent.py``) against JAX's compat: the same
seeded games give the same boards, observations, legal moves, rewards,
ends and printed lines, with random openings from ``RandomState`` in the
reference's order, the embedded opponent, sudden death and a forfeited
turn; greedy and maximin-1/2 decide as JAX's on the positions of those
games; and the drivers' W/D/L and transcripts equal JAX's for seeded
scripted games.  Everything on the CPU."""

import contextlib
import io

import numpy as np
import pytest

from gymothelloenv_tpu import compat as jcompat
from gymothelloenv_tpu.cli import run as jrun
from gymothelloenv_tpu.cli import run_2agent as jrun2
from gymothelloenv_tpu.compat import featurize as jfeat
from gymothelloenv_tpu_torch import compat
from gymothelloenv_tpu_torch.cli import run, run_2agent
from gymothelloenv_tpu_torch.compat import featurize
from torch_port_helpers import one_torch_thread  # noqa: F401

CPU = {"device": "cpu"}


def _capture(fn):
    """``fn()``'s result and its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fn()
    return got, out.getvalue().splitlines()


def _play_simple(mod, kw, seed, bogus=False):
    """One game of a ``SimpleOthelloEnv`` of ``mod`` driven by a
    ``RandomState(seed)`` player (with ``bogus``, an illegal move at ply
    12): the transcript of each ply."""
    env = mod.SimpleOthelloEnv(**kw)
    rng = np.random.RandomState(seed)
    log = [env.reset().tolist()]
    done, ply = False, 0
    while not done:
        moves = env.possible_moves
        a = (64 if bogus and ply == 12 else moves[rng.randint(len(moves))])
        obs, r, done, info = env.step(a)
        base = env.env
        log.append((np.asarray(obs).tolist(), r, done, info, moves,
                    env.player_turn, base.board_state.tolist(),
                    base.count_disks(), base.winner))
        ply += 1
    env.render()
    return log


@pytest.mark.parametrize("kw, seed, bogus", [
    (dict(initial_rand_steps=10, seed=3), 0, False),
    (dict(initial_rand_steps=6, seed=1, num_disk_as_reward=True), 2, False),
    (dict(seed=4, possible_actions_in_obs=True), 5, False),
    (dict(seed=2), 7, True),
    (dict(seed=2, sudden_death_on_invalid_move=False), 7, True),
    (dict(board_size=6, seed=8), 9, False)])
def test_simple_env_games_equal_jax(kw, seed, bogus):
    want, want_lines = _capture(lambda: _play_simple(jcompat, kw, seed,
                                                     bogus))
    got, lines = _capture(lambda: _play_simple(compat, {**kw, **CPU}, seed,
                                               bogus))
    assert got == want
    assert lines == want_lines


def _play_embedded(mod, make_opp, seed, rounds=3, **kw):
    """``rounds`` games of an ``OthelloEnv`` of ``mod`` against
    ``make_opp(mod)``, the protagonist a ``RandomState`` player and the
    colour switched after each game (the opponent object unchanged)."""
    opp = make_opp(mod)
    env = mod.OthelloEnv(white_policy=opp, black_policy=opp, protagonist=-1,
                         initial_rand_steps=4, seed=seed, **kw)
    rng = np.random.RandomState(seed + 1)
    log = []
    for _ in range(rounds):
        obs = env.reset()
        log.append(obs.tolist())
        done = False
        while not done:
            moves = env.possible_moves
            obs, r, done, _ = env.step(moves[rng.randint(len(moves))])
            log.append((obs.tolist(), r, done, env.player_turn))
        env.switch_color()
        assert env.opponent is opp
    return log


@pytest.mark.parametrize("opp", ["rand", "greedy", "maximin1", "maximin2"])
def test_embedded_opponent_games_equal_jax(opp):
    def make(mod):
        return {"rand": lambda: mod.RandomPolicy(seed=5),
                "greedy": mod.GreedyPolicy,
                "maximin1": lambda: mod.MaxiMinPolicy(1),
                "maximin2": lambda: mod.MaxiMinPolicy(2)}[opp]()
    want, want_lines = _capture(lambda: _play_embedded(jcompat, make, 11,
                                                       mute=False))
    got, lines = _capture(lambda: _play_embedded(compat, make, 11,
                                                 mute=False, **CPU))
    assert got == want
    assert lines == want_lines


def test_featurizers_and_set_board_equal_jax():
    boards = []
    for mod, kw in ((jcompat, {}), (compat, CPU)):
        env = mod.SimpleOthelloEnv(seed=6, initial_rand_steps=12, mute=True,
                                   **kw)
        env.reset()
        for _ in range(9):
            env.step(env.possible_moves[0])   # the openings may replace it
        f = featurize if mod is compat else jfeat
        base = env.env
        other = mod.OthelloBaseEnv(mute=True, **kw)
        other.set_board_state(base.board_state * -1, perspective=-1)
        other.set_player_turn(-base.player_turn)
        boards.append((f.make_state4(env).tolist(),
                       f.make_state3(env).tolist(), base.possible_moves,
                       other.possible_moves, other.board_state.tolist(),
                       other.get_observation().tolist()))
    assert boards[0] == boards[1]
    env = compat.OthelloBaseEnv(mute=True, **CPU)
    _, r, done, _ = env.step(0)                  # illegal: sudden death
    assert done and r == -1.0 and env.winner == 1
    with pytest.raises(ValueError, match="terminated"):
        env.step(19)


def _driver(mod, fn, seed, **kw):
    np.random.seed(seed)
    return fn(mod)(**kw)


@pytest.mark.parametrize("prot, opp, depth, disk", [
    ("maximin", "rand", 2, False), ("greedy", "maximin", 1, True),
    ("rand", "greedy", 1, False)])
def test_run_play_equals_jax(prot, opp, depth, disk):
    kw = dict(protagonist=-1, protagonist_agent_type=prot,
              opponent_agent_type=opp, num_rounds=4,
              protagonist_search_depth=depth, opponent_search_depth=depth,
              rand_seed=3, env_init_rand_steps=4, num_disk_as_reward=disk,
              render=False)
    want, want_lines = _capture(lambda: _driver(jrun, lambda m: m.play, 0,
                                                **kw))
    got, lines = _capture(lambda: _driver(run, lambda m: m.play, 0, **kw,
                                          **CPU))
    assert got == want and sum(got) == 4
    assert lines == want_lines


@pytest.mark.parametrize("prot, opp", [("greedy", "rand"),
                                       ("rand", "maximin")])
def test_run_2agent_equals_jax(prot, opp):
    kw = dict(protagonist=1, protagonist_agent_type=prot,
              opponent_agent_type=opp, num_rounds=3, rand_seed=2,
              env_init_rand_steps=6)
    want, want_lines = _capture(lambda: _driver(jrun2, lambda m: m.play, 1,
                                                **kw))
    got, lines = _capture(lambda: _driver(run_2agent, lambda m: m.play, 1,
                                          **kw, **CPU))
    assert got == want and sum(got) == 3
    assert lines == want_lines


def test_run_main_with_render_equals_jax():
    argv = ["--protagonist", "greedy", "--opponent", "rand",
            "--num-rounds", "1", "--init-rand-steps", "2"]
    want, want_lines = _capture(lambda: _driver(jrun, lambda m: m.main, 4,
                                                argv=argv))
    got, lines = _capture(lambda: _driver(run, lambda m: m.main, 4,
                                          argv=argv + ["--device", "cpu"]))
    assert want is None and sum(got) == 1
    assert lines == want_lines and any(ln.startswith("Valid actions")
                                       for ln in lines)
