"""The port's plane engine and its callers against JAX and against the
port's own bit engine:

* ``PlaneEngine``'s ten methods against ``gymothelloenv_tpu.core.engine.
  PlaneEngine`` on reachable positions at B = 6 and at B = 8 (forced plane);
* ``get_engine`` selection, and the port's two engines on the same 8x8
  positions;
* the plain (with and without random openings), time-limited and recurrent
  collectors with ``force_plane`` on 8x8 against the same collectors on the
  bit engine, leaf for leaf under the same draws;
* the board-6 collector against JAX's ``collect_rollout`` (a peaked policy
  whose sample does not depend on the uniform, JAX's colours injected);
* ``envs/vector_env.py`` against JAX's ``vec_reset``/``vec_step`` with
  random openings, JAX's draws rebuilt from its keys and injected.

Tolerance: exact, but ``logp``/``value`` against JAX (atol 1e-5: fp32
forwards summed in other orders)."""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import engine as jengine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.envs import vector_env as jvec
from gymothelloenv_tpu.models.nets import PolicyNet as JaxPolicyNet
from gymothelloenv_tpu.policies.scripted import random_actions_batched
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu.train.ppo_trainer import make_apply_fn
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.engine import (BitEngine, PlaneEngine,
                                                 get_engine, nth_legal)
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.envs import vector_env as vec
from gymothelloenv_tpu_torch.models.convert import policy_net_from_flax
from gymothelloenv_tpu_torch.models.nets import make_policy_net
from gymothelloenv_tpu_torch.train import self_play as sp
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import (PLANE_FIELDS, assert_same_planes,
                                plane_positions, plane_to_port)

PLANE, BIT = PlaneEngine(), BitEngine()
JPLANE = jengine.PlaneEngine()
N = 64
ROLLOUT = ("obs", "action", "logp", "value", "reward", "done", "legal")


def _legal_actions(legal: np.ndarray, rng) -> np.ndarray:
    return np.array([rng.choice(np.nonzero(r)[0]) if r.any() else 0
                     for r in legal], np.int32)


def test_get_engine_selection():
    assert isinstance(get_engine(EnvConfig()), BitEngine)
    assert isinstance(get_engine(EnvConfig(), force_plane=True), PlaneEngine)
    assert isinstance(get_engine(EnvConfig(board_size=6)), PlaneEngine)
    assert isinstance(get_engine(EnvConfig(board_size=10), True),
                      PlaneEngine)


@pytest.mark.parametrize("b", (6, 8))
def test_plane_engine_matches_jax(b):
    """All ten methods (at B = 8 the plane engine is the forced one)."""
    jcfg = JaxEnvConfig(board_size=b, num_disk_as_reward=True)
    cfg = EnvConfig(board_size=b, num_disk_as_reward=True)
    states = plane_positions(b)
    port = plane_to_port(states)
    rng = np.random.RandomState(b)
    assert_same_planes(PLANE.reset_batch(5, cfg, "cpu"),
                       JPLANE.reset_batch(5, jcfg))
    done = rng.rand(N) < 0.5
    assert_same_planes(PLANE.reset_where(port, torch.from_numpy(done), cfg),
                jax.jit(JPLANE.reset_where, static_argnums=2)(
                    states, jnp.asarray(done), jcfg))
    actions = _legal_actions(np.asarray(states.legal), rng)
    actions[rng.rand(N) < 0.1] = rng.randint(b * b)
    do = rng.rand(N) < 0.7
    assert_same_planes(PLANE.step_where(port, torch.from_numpy(actions),
                                 torch.from_numpy(do), cfg),
                jax.jit(JPLANE.step_where, static_argnums=3)(
                    states, jnp.asarray(actions), jnp.asarray(do), jcfg))
    live = ~np.asarray(states.terminated)
    got, reward = PLANE.step_all(port, torch.from_numpy(actions), cfg)
    want, jreward = jax.jit(JPLANE.step_all, static_argnums=2)(
        states, jnp.asarray(actions), jcfg)
    assert_same_planes(core.index_games(got, torch.from_numpy(live)),
                jax.tree.map(lambda x: x[live], want))
    np.testing.assert_array_equal(reward.numpy()[live],
                                  np.asarray(jreward)[live])
    np.testing.assert_array_equal(PLANE.featurize(port).numpy(),
                                  np.asarray(JPLANE.featurize(states)))
    np.testing.assert_array_equal(PLANE.legal_flat(port).numpy(),
                                  np.asarray(JPLANE.legal_flat(states)))
    board, turn = PLANE.board_turn(port)
    np.testing.assert_array_equal(board.numpy(), np.asarray(states.board))
    np.testing.assert_array_equal(turn.numpy(), np.asarray(states.turn))
    np.testing.assert_array_equal(PLANE.greedy(port).numpy(),
                                  np.asarray(JPLANE.greedy(states)))
    pcolor = np.where(rng.rand(N) < 0.5, 1, -1).astype(np.int8)
    for c in (cfg, EnvConfig(board_size=b)):
        jc = JaxEnvConfig(board_size=b,
                          num_disk_as_reward=c.num_disk_as_reward)
        np.testing.assert_array_equal(
            PLANE.outcome_for(port, torch.from_numpy(pcolor), c).numpy(),
            np.asarray(JPLANE.outcome_for(states, jnp.asarray(pcolor), jc)))
    # random_legal: JAX draws from its keys; given the rank of JAX's move
    # among the legal ones, the port plays the same move.
    keys = jax.random.split(jax.random.PRNGKey(b), N)
    jmove = np.asarray(JPLANE.random_legal(keys, states))
    legal = np.asarray(states.legal)
    has = legal.any(1)
    t = np.array([legal[i, :jmove[i]].sum() for i in range(N)])
    got = PLANE.random_legal(port, torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(got[has], jmove[has])
    counts = PLANE.legal_count(port)
    drawn = PLANE.random_legal(port,
                               generator=torch.Generator().manual_seed(0))
    assert legal[np.arange(N), drawn.numpy()][has].all()
    assert torch.equal(counts, torch.from_numpy(legal.sum(1)))


def test_nth_legal():
    legal = torch.tensor([[0, 1, 0, 1, 1], [0, 0, 0, 0, 0],
                          [1, 0, 0, 0, 0]], dtype=torch.bool)
    assert nth_legal(legal, torch.tensor([2, 0, 0])).tolist() == [4, 4, 0]
    assert nth_legal(legal, torch.tensor([0, 3, 0])).tolist() == [1, 4, 0]


def test_bit_and_plane_engines_agree_on_8x8():
    """The port's engines on the same positions: featurize, legal, greedy,
    outcome, the t-th legal move, step_where, step_all, reset_where and
    the board view."""
    cfg = EnvConfig(num_disk_as_reward=True)
    plane = plane_to_port(plane_positions(8, seed=3))
    bits = tb.from_planes(plane.board, plane.turn, plane.legal,
                          plane.terminated, plane.winner)
    rng = np.random.RandomState(1)
    for name in ("featurize", "legal_flat", "greedy", "legal_count"):
        assert torch.equal(getattr(PLANE, name)(plane),
                           getattr(BIT, name)(bits)), name
    pcolor = torch.from_numpy(np.where(rng.rand(N) < 0.5, 1, -1)
                              .astype(np.int8))
    assert torch.equal(PLANE.outcome_for(plane, pcolor, cfg),
                       BIT.outcome_for(bits, pcolor, cfg))
    t = torch.from_numpy(rng.randint(0, 64, N)) % PLANE.legal_count(
        plane).clamp(min=1)
    has = plane.legal.any(1)
    assert torch.equal(PLANE.random_legal(plane, t)[has],
                       BIT.random_legal(bits, t)[has])
    actions = PLANE.random_legal(plane, t)
    do = torch.from_numpy(rng.rand(N) < 0.7) & ~plane.terminated
    for got, want in (
            (PLANE.step_where(plane, actions, do, cfg),
             BIT.step_where(bits, actions, do, cfg)),
            (PLANE.step_all(plane, actions, cfg)[0],
             BIT.step_all(bits, actions, cfg)[0]),
            (PLANE.reset_where(plane, do, cfg),
             BIT.reset_where(bits, do, cfg))):
        board, turn = BIT.board_turn(want)
        assert torch.equal(got.board, board) and torch.equal(got.turn, turn)
        assert torch.equal(got.legal, BIT.legal_flat(want))
        assert torch.equal(got.terminated, want.terminated)
        assert torch.equal(got.winner, want.winner)
    assert torch.equal(PLANE.step_all(plane, actions, cfg)[1],
                       BIT.step_all(bits, actions, cfg)[1])


def _same_rollout(a, b):
    for f in ROLLOUT:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _same_env(plane_env, bit_env):
    board, turn = BIT.board_turn(bit_env)
    assert torch.equal(plane_env.board, board)
    assert torch.equal(plane_env.turn, turn)
    assert torch.equal(plane_env.legal, BIT.legal_flat(bit_env))


@pytest.mark.parametrize("kind", ("plain", "openings", "time_limited",
                                  "recurrent"))
def test_force_plane_collectors_equal_bit_collectors(kind):
    """Four rollouts of T = 10 at N = 32 (40 slots: games end and reset)
    on each engine from the same seeded draws; every leaf of every rollout
    equal, and the games after them."""
    cfg = EnvConfig(num_disk_as_reward=True)
    rec = kind == "recurrent"
    net = make_policy_net(1, 32, seed=2, device="cpu", recurrent=rec)
    rand = 6 if kind == "openings" else 0
    outs = {}
    for force in (False, True):
        draws = sp.Draws(torch.Generator().manual_seed(7))
        if rec:
            state = sp.selfplay_init_recurrent(net, cfg, 32, 32, draws,
                                               rand, force_plane=force)
        else:
            state = sp.selfplay_init(net, cfg, 32, draws, rand,
                                     force_plane=force)
        elapsed = torch.ones(32, dtype=torch.int32)
        rolls = []
        for _ in range(4):
            if rec:
                state, roll, h0, masks, _ = sp.collect_rollout_recurrent(
                    net, state, cfg, 10, draws, rand, force_plane=force)
                rolls.append((roll, h0, masks))
            elif kind == "time_limited":
                state, elapsed, roll, bad, _ = \
                    sp.collect_rollout_time_limited(
                        net, state, elapsed, cfg, 10, 12, draws,
                        force_plane=force)
                rolls.append((roll, bad))
            else:
                state, roll, _ = sp.collect_rollout(net, state, cfg, 10,
                                                    draws, rand,
                                                    force_plane=force)
                rolls.append((roll,))
        outs[force] = state, rolls
    (bit_state, bit_rolls), (plane_state, plane_rolls) = outs[False], \
        outs[True]
    assert isinstance(plane_state.env, core.OthelloState)
    assert isinstance(bit_state.env, tb.BitState)
    for got, want in zip(plane_rolls, bit_rolls):
        _same_rollout(got[0], want[0])
        for x, y in zip(got[1:], want[1:]):
            assert torch.equal(x, y)
    assert sum(int(r[0].done.sum()) for r in bit_rolls) >= 16
    _same_env(plane_state.env, bit_state.env)
    with pytest.raises(ValueError, match="force_plane"):
        sp.collect_rollout(net, outs[True][0], cfg, 1, sp.Draws(
            torch.Generator()), force_plane=False) if not rec else \
            sp.collect_rollout_recurrent(net, outs[True][0], cfg, 1, sp.Draws(
                torch.Generator()), force_plane=False)


B6, N6, T6, HIDDEN = 6, 32, 6, 32


@functools.cache
def _jax_board6():
    jnet = JaxPolicyNet(num_actions=B6 * B6, hidden_size=HIDDEN)
    apply_fn = make_apply_fn(jnet)
    cfg = JaxEnvConfig(board_size=B6, num_disk_as_reward=True)
    init = jax.jit(functools.partial(jsp.selfplay_init, apply_fn=apply_fn,
                                     cfg=cfg, num_envs=N6))
    collect = jax.jit(functools.partial(jsp.collect_rollout,
                                        apply_fn=apply_fn, cfg=cfg,
                                        num_steps=T6))
    params = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, B6, B6)))
    head = params["params"]["Dense_2"]
    rank = np.random.RandomState(0).permutation(B6 * B6)
    head["kernel"] = jnp.zeros_like(head["kernel"])
    head["bias"] = jnp.asarray(200.0 * rank, jnp.float32)
    return params, init, collect


def test_board6_collection_matches_jax():
    """4 rollouts of T = 6 at N = 32 on 6x6 (games end and reset): a
    ranked policy (zero logits kernel, bias 200 x a cell ranking) plays
    the same games on both sides once the port has JAX's colours, read
    from the emitted observations' turn plane."""
    params, init, collect = _jax_board6()
    state = init(params, key=jax.random.PRNGKey(4))
    want = []
    for _ in range(4):
        state, roll, _ = collect(params, sp=state)
        want.append({f: np.asarray(getattr(roll, f)) for f in ROLLOUT})
    want = {f: np.concatenate([w[f] for w in want]) for f in ROLLOUT}
    colours = [torch.from_numpy(2 * o[:, 2, 0, 0].astype(np.int8) - 1)
               for o in want["obs"]]
    colours.append(torch.from_numpy(
        2 * np.asarray(state.pending.obs)[:, 2, 0, 0].astype(np.int8) - 1))
    draws = sp.InjectedDraws(colours, itertools.repeat(torch.full((N6,),
                                                                  0.5)))
    net = policy_net_from_flax(params, device="cpu")
    assert net.board_size == B6
    cfg = EnvConfig(board_size=B6, num_disk_as_reward=True)
    pstate = sp.selfplay_init(net, cfg, N6, draws, device="cpu")
    got = []
    for _ in range(4):
        pstate, roll, _ = sp.collect_rollout(net, pstate, cfg, T6, draws)
        got.append({f: getattr(roll, f).numpy() for f in ROLLOUT})
    got = {f: np.concatenate([g[f] for g in got]) for f in ROLLOUT}
    assert want["done"].sum() >= N6 // 2
    assert got["obs"].shape == (4 * T6, N6, 4, B6, B6)
    for f in ("obs", "action", "reward", "done", "legal"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("logp", "value"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-5, rtol=0,
                                   err_msg=f)
    np.testing.assert_array_equal(pstate.env.board.numpy(),
                                  np.asarray(state.env.board))


@pytest.mark.parametrize("b", (6, 8))
def test_vector_env_matches_jax(b):
    """``vec_reset`` and 3 B^2 ``vec_step`` plies with random openings
    (``initial_rand_steps`` 6) and random legal actions; JAX's random
    moves and reset counts rebuilt from its keys and injected (the move
    as its rank among the legal ones)."""
    init = 6
    jcfg = JaxEnvConfig(board_size=b)
    cfg = EnvConfig(board_size=b)
    js = jvec.vec_reset(jax.random.PRNGKey(b), jcfg, N, init)
    ps = vec.vec_reset(cfg, N, init, rand_left=torch.from_numpy(
        np.asarray(js.rand_left)), device="cpu")
    step = jax.jit(jvec.vec_step, static_argnums=(2, 3))
    rng = np.random.RandomState(b)
    dones = 0
    for ply in range(3 * b * b):
        legal = np.asarray(js.core.legal)
        actions = _legal_actions(legal, rng)
        _, k_rand, k_reset = jax.random.split(js.key, 3)
        jmove = np.asarray(random_actions_batched(k_rand, js.core.legal))
        t = np.array([legal[i, :jmove[i]].sum() for i in range(N)])
        reset_left = np.asarray(jvec._draw_rand_left(k_reset, N, init))
        res = step(js, jnp.asarray(actions), jcfg, init)
        got = vec.vec_step(ps, torch.from_numpy(actions), cfg, init,
                           rand_t=torch.from_numpy(t),
                           reset_rand_left=torch.from_numpy(reset_left))
        assert_same_planes(got.state.core, res.state.core, f"ply {ply}")
        np.testing.assert_array_equal(got.state.rand_left.numpy(),
                                      np.asarray(res.state.rand_left))
        for name in ("obs", "reward", "done"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(res, name)))
        dones += int(got.done.sum())
        js, ps = res.state, got.state
    assert dones >= N
    assert dataclasses.fields(ps.core)[0].name == PLANE_FIELDS[0]
