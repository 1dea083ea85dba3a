"""The port's plane game state (``gymothelloenv_tpu_torch/core/state.py``)
against ``gymothelloenv_tpu.core.state`` under ``vmap``: ``reset``,
``step`` and ``step_autoreset`` over random playouts at B = 4, 6, 8 and 10
(8 through the bitboard rules on both sides), with sudden death on and off
and with the disk reward; the observation and featurizer functions; and
``step`` against the clean-room oracle ``tests/reference_spec.SpecGame``.
Actions are numpy-seeded: mostly legal, some illegal cells.  Tolerance:
exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import featurize as jfeat
from gymothelloenv_tpu.core import state as jcore
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu_torch.core import featurize
from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.state import EnvConfig
from reference_spec import SpecGame
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import assert_same_planes, plane_to_port

N = 48


@functools.cache
def _jax_fns(b, sudden, disk):
    cfg = JaxEnvConfig(board_size=b, sudden_death_on_invalid_move=sudden,
                       num_disk_as_reward=disk)
    reset = jax.jit(jax.vmap(lambda _: jcore.reset(cfg)))
    step = jax.jit(jax.vmap(jcore.step, in_axes=(0, 0, None)),
                   static_argnums=2)
    auto = jax.jit(jax.vmap(jcore.step_autoreset, in_axes=(0, 0, None)),
                   static_argnums=2)
    return cfg, reset, step, auto


def _port_cfg(b, sudden=True, disk=False):
    return EnvConfig(board_size=b, sudden_death_on_invalid_move=sudden,
                     num_disk_as_reward=disk)


def _actions(rng, legal, b, illegal_share):
    """A random legal action a game, or with ``illegal_share`` (and on a
    game without a move) any cell."""
    out = []
    for row in legal:
        if row.any() and rng.rand() >= illegal_share:
            out.append(rng.choice(np.nonzero(row)[0]))
        else:
            out.append(rng.randint(b * b))
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("b", (4, 6, 8, 10))
def test_reset_matches_jax(b):
    _, reset, _, _ = _jax_fns(b, True, False)
    assert_same_planes(core.reset(_port_cfg(b), N, "cpu"),
                       reset(jnp.arange(N)))


# (board, sudden death, disk reward): every flag pair at B = 6, and two
# pairs each at the others (a JAX compile per case is the cost).
CASES = ((4, True, False), (4, False, True), (6, True, False),
         (6, False, True), (6, True, True), (6, False, False),
         (8, True, False), (8, False, True), (10, True, True),
         (10, False, False))


@pytest.mark.parametrize("b,sudden,disk", CASES)
def test_step_playouts_match_jax(b, sudden, disk):
    """Both engines play the same actions from the opening until every
    game has ended; games freeze once ended.  State, observation, reward
    and done agree on the live games at every ply."""
    jcfg, reset, step, _ = _jax_fns(b, sudden, disk)
    cfg = _port_cfg(b, sudden, disk)
    rng = np.random.RandomState(b * 4 + 2 * sudden + disk)
    ref = reset(jnp.arange(N))
    port = core.reset(cfg, N, "cpu")
    ended = 0
    for ply in range(b * b + 8):
        live = ~np.asarray(ref.terminated)
        if not live.any():
            break
        actions = _actions(rng, np.asarray(ref.legal), b, 0.04)
        res = step(ref, jnp.asarray(actions), jcfg)
        got = core.step(port, torch.from_numpy(actions), cfg)
        sel = torch.from_numpy(live)
        assert_same_planes(core.index_games(got.state, sel),
                    jax.tree.map(lambda x: x[live], res.state), f"ply {ply}")
        for name in ("obs", "reward", "done"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy()[live],
                np.asarray(getattr(res, name))[live], err_msg=name)
        ended += int(np.asarray(res.done)[live].sum())
        ref = jax.tree.map(lambda a, o: jnp.where(
            jnp.asarray(live).reshape((-1,) + (1,) * (a.ndim - 1)), a, o),
            res.state, ref)
        port = core.select_games(sel, got.state, port)
    assert ended == N and bool(port.terminated.all())
    assert_same_planes(port, ref, "final")


@pytest.mark.parametrize("b", (4, 6, 10))
def test_step_autoreset_matches_jax(b):
    """``step_autoreset`` for 3 B^2 plies with the disk reward: games
    reset in the ply they end; games terminated on entry (planted) reset
    without a transition."""
    jcfg, _, _, auto = _jax_fns(b, True, True)
    cfg = _port_cfg(b, True, True)
    rng = np.random.RandomState(b)
    ref = _jax_fns(b, True, True)[1](jnp.arange(N))
    port = plane_to_port(ref)
    dones = 0
    for ply in range(3 * b * b):
        if ply == 5:
            # Plant ended games: the port's and JAX's reset on entry.
            planted = rng.rand(N) < 0.2
            term = np.asarray(ref.terminated) | planted
            ref = ref.replace(terminated=jnp.asarray(term))
            port.terminated = torch.from_numpy(term)
        actions = _actions(rng, np.asarray(ref.legal), b, 0.02)
        res = auto(ref, jnp.asarray(actions), jcfg)
        got = core.step_autoreset(port, torch.from_numpy(actions), cfg)
        assert_same_planes(got.state, res.state, f"ply {ply}")
        for name in ("obs", "reward", "done"):
            np.testing.assert_array_equal(
                getattr(got, name).numpy(), np.asarray(getattr(res, name)),
                err_msg=f"{name} ply {ply}")
        dones += int(got.done.sum())
        ref, port = res.state, got.state
    assert dones >= N


@pytest.mark.parametrize("b", (4, 6, 10))
def test_step_matches_spec_oracle(b):
    """Single games against ``SpecGame``'s loop-based rules: board, turn,
    legal list, termination, winner, reward every ply."""
    rng = np.random.RandomState(40 + b)
    for sudden, disk in ((True, False), (False, True), (True, True)):
        cfg = _port_cfg(b, sudden, disk)
        for _ in range(3):
            spec = SpecGame(b, sudden, disk)
            s = core.reset(cfg, 1, "cpu")
            while not spec.terminated:
                if rng.rand() < 0.05 or not spec.legal:
                    action = rng.randint(b * b)
                else:
                    action = int(rng.choice(spec.legal))
                _, reward, done = spec.step(action)
                res = core.step(s, torch.tensor([action]), cfg)
                s = res.state
                np.testing.assert_array_equal(s.board[0].numpy(),
                                              spec.board)
                assert float(res.reward[0]) == reward
                assert bool(res.done[0]) == done
                assert int(s.winner[0]) == spec.winner
                if not done:
                    assert int(s.turn[0]) == spec.turn
                    assert (torch.nonzero(s.legal[0])[:, 0].tolist()
                            == sorted(spec.legal))


@pytest.mark.parametrize("b", (6, 10))
def test_observations_and_featurizers_match_jax(b):
    """``observe``, ``observe_with_legal``, ``count_disks``, plane
    ``make_state`` (both quirk settings), ``undo_state`` and
    ``make_state_3ch`` on positions of a random playout (exactly one
    legal move included, for the quirk)."""
    jcfg, reset, step, _ = _jax_fns(b, True, False)
    rng = np.random.RandomState(b)
    ref = reset(jnp.arange(N))
    seen = []
    for _ in range(b * b - 4):
        seen.append(ref)
        actions = _actions(rng, np.asarray(ref.legal), b, 0.0)
        new = step(ref, jnp.asarray(actions), jcfg).state
        ref = jax.tree.map(lambda a, o: jnp.where(
            ref.terminated.reshape((-1,) + (1,) * (a.ndim - 1)), o, a),
            new, ref)
    batch = jax.tree.map(lambda *xs: jnp.concatenate(xs), *seen)
    port = plane_to_port(batch)
    assert (np.asarray(batch.legal).sum(1) == 1).any()
    checks = (
        (core.observe(port), jax.vmap(jcore.observe)(batch)),
        (core.observe_with_legal(port),
         jax.vmap(jcore.observe_with_legal)(batch)),
        (torch.stack(core.count_disks(port.board)),
         jnp.stack(jax.vmap(jcore.count_disks)(batch.board))),
        (featurize.make_state(port), jax.vmap(jfeat.make_state)(batch)),
        (featurize.make_state(port, False),
         jax.vmap(lambda s: jfeat.make_state(s, False))(batch)),
        (featurize.make_state_3ch(port),
         jax.vmap(jfeat.make_state_3ch)(batch)))
    for i, (got, want) in enumerate(checks):
        assert got.numpy().dtype == np.asarray(want).dtype, i
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=str(i))
    planes = featurize.make_state(port)
    np.testing.assert_array_equal(
        featurize.undo_state(planes, port.turn).numpy(),
        np.asarray(jax.vmap(jfeat.undo_state)(
            jnp.asarray(planes.numpy()), batch.turn)))


def test_env_config_any_board():
    cfg = EnvConfig(board_size=10)
    assert cfg.num_actions == 100
    s = core.reset(cfg, 2, "cpu")
    assert s.board.shape == (2, 10, 10) and s.legal.shape == (2, 100)
    assert int(s.legal.sum()) == 8
