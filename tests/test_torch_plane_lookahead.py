"""The value-lookahead search on plane boards against JAX: decisions at
depth 1, depth 2 and the depth-3 beam at B = 6 and depth 1 at B = 10
(``net_lookahead_policy``), the recurrent depth 1 at B = 6
(``net_lookahead_cell_recurrent``), the collector's
``lookahead_action_values`` and ``make_lookahead_override`` at B = 6, and
the 8x8 plane search (``force_plane``-style planes, stepped through the
ply kernel) equal to the bitboard one.

States are random reachable plane positions made with the JAX engine
(``torch_port_helpers.plane_positions``), ended games included.  The value
net is JAX's stub ``_stub_apply`` and its port twin ``DiskDiffNet`` (the
disk difference from the mover's side), so every value is an integer and
every decision must equal JAX's exactly, ties included; the recurrent
stub adds its integer state to the value and counts its steps in the
state."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core.engine import get_engine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.train import ppo_trainer as jtrainer
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.ops import step as ply
from gymothelloenv_tpu_torch.policies import scripted
from gymothelloenv_tpu_torch.train import ppo_trainer
from gymothelloenv_tpu_torch.train import self_play as sp
from test_chunked_search import _stub_apply
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import (DiskDiffNet, othello_state, plane_positions,
                                plane_to_port, random_states, to_port)

STUB = DiskDiffNet()
GAMES = {6: 48, 10: 24}


def _cfgs(b):
    return (EnvConfig(board_size=b, num_disk_as_reward=True),
            JaxEnvConfig(board_size=b, num_disk_as_reward=True))


@functools.cache
def _states(b):
    """(JAX plane states, the port's) at board ``b``."""
    jstate = plane_positions(b, GAMES[b], seed=11)
    return jstate, plane_to_port(jstate)


@functools.cache
def _jax_policy(b, depth, beam_k):
    act = jtrainer.net_lookahead_policy(None, _stub_apply, _cfgs(b)[1],
                                        depth, beam_k)
    return jax.jit(jax.vmap(act))


@pytest.mark.parametrize("b,depth", [(6, 1), (6, 2), (6, 3), (10, 1)])
def test_decisions_equal_jax(b, depth):
    """Every decision equal to JAX's (beam-3 at depth 3); at B = 6 the
    search is chunked and unchunked alike."""
    jstate, state = _states(b)
    cfg = _cfgs(b)[0]
    keys = jax.random.split(jax.random.PRNGKey(0), GAMES[b])
    want = np.asarray(_jax_policy(b, depth, 3)(keys, jstate))
    got = ppo_trainer.net_lookahead_policy(STUB, cfg, depth, beam_k=3)(state)
    np.testing.assert_array_equal(got.numpy(), want)
    live = ~state.terminated
    assert bool(state.legal[torch.arange(GAMES[b]), got][live].all())
    if b == 6:
        chunked = ppo_trainer.lookahead_search(STUB, state, cfg, depth, 3,
                                               expand_chunk=5)[0]
        np.testing.assert_array_equal(chunked.numpy(), want)


class _RecStub(torch.nn.Module):
    """A recurrent stub: the state counts steps (``h * mask + 1``) and the
    value is the disk difference plus the state's first unit."""

    def forward(self, obs, h, mask):
        _, v = STUB(obs)
        h = h * mask[:, None] + 1.0
        return obs.new_zeros(obs.shape[0], obs.shape[-1] ** 2), \
            v + h[:, 0], h


def _jax_rec_stub(params, obs, h, mask):
    _, v, _ = _stub_apply(params, obs)
    h = h * mask[:, None] + 1.0
    return None, v + h[:, 0], h


def test_recurrent_depth1_equals_jax():
    """B = 6: decisions and the carried state equal JAX's with integer
    hidden states (values are integers, so exactly)."""
    jstate, state = _states(6)
    cfg, jcfg = _cfgs(6)
    n = GAMES[6]
    h = np.random.RandomState(2).randint(-3, 4, (n, 4)).astype(np.float32)
    cell = jtrainer.net_lookahead_cell_recurrent(None, _jax_rec_stub, jcfg)
    wa, wh = jax.jit(cell)(jax.random.split(jax.random.PRNGKey(0), n),
                           jstate, jnp.asarray(h))
    action, scores, _, h_cur = ppo_trainer.lookahead_recurrent(
        _RecStub(), state, torch.from_numpy(h), cfg)
    np.testing.assert_array_equal(action.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(h_cur.numpy(), np.asarray(wh))
    assert scores.shape == (n, 36)
    assert (scores[~state.legal] == sp.NEG).all()
    got, _ = ppo_trainer.net_lookahead_cell_recurrent(_RecStub(), cfg)(
        state, torch.from_numpy(h))
    np.testing.assert_array_equal(got.numpy(), np.asarray(wa))


def _jax_values(jstate, jcfg):
    eng = get_engine(jcfg)
    return np.asarray(jax.jit(lambda s: jsp.lookahead_action_values(
        None, _stub_apply, eng, s, jcfg))(jstate))


def test_action_values_equal_jax():
    """B = 6: the collector's child values equal JAX's on the legal
    actions; the others hold ``NEG``."""
    jstate, state = _states(6)
    cfg, jcfg = _cfgs(6)
    got = sp.lookahead_action_values(STUB, state, cfg).numpy()
    want = _jax_values(jstate, jcfg)
    legal = state.legal.numpy()
    assert got.shape == (GAMES[6], 36)
    np.testing.assert_array_equal(got[legal], want[legal])
    assert (got[~legal] == sp.NEG).all()


@pytest.mark.parametrize("tau", [0.0, 2.0])
def test_override_equals_jax_and_the_sampler(tau):
    """tau 0: the override's argmax equals JAX's.  tau 2: each live row's
    action is the inverse CDF of softmax(values / tau) over its legal
    actions at the injected uniform (a float64 numpy model; rows within
    1e-5 of a CDF step are left out)."""
    jstate, state = _states(6)
    cfg, jcfg = _cfgs(6)
    n = GAMES[6]
    live = ~state.terminated.numpy()
    if tau == 0:
        eng = get_engine(jcfg)
        ov = jsp.make_lookahead_override(jcfg, 0.0)
        want = np.asarray(jax.jit(lambda s, k: ov(
            None, _stub_apply, eng, s, k, eng.legal_flat(s)))(
                jstate, jax.random.PRNGKey(0)))
        got = sp.make_lookahead_override(cfg, 0.0)(STUB, state, state.legal,
                                                   None)
        np.testing.assert_array_equal(got.numpy()[live], want[live])
        return
    u = torch.from_numpy(np.random.RandomState(5).uniform(
        1e-3, 1.0, n).astype(np.float32))
    got = sp.make_lookahead_override(cfg, tau)(
        STUB, state, state.legal, sp.InjectedDraws([], [u]))
    vals = _jax_values(jstate, jcfg).astype(np.float64)
    checked = 0
    for i in np.nonzero(live)[0]:
        moves = np.nonzero(state.legal[i].numpy())[0]
        w = np.exp((vals[i, moves] - vals[i, moves].max()) / tau)
        cdf = np.cumsum(w) / w.sum()
        if np.abs(cdf - float(u[i])).min() < 1e-5:
            continue
        assert int(got[i]) == moves[np.searchsorted(cdf, float(u[i]))]
        checked += 1
    assert checked >= live.sum() - 2 and checked > 20


@pytest.mark.parametrize("depth", [1, 2])
def test_plane_8x8_equals_bitboard(depth, monkeypatch):
    """The 8x8 search on planes (the ``force_plane`` layout) decides as
    the bitboard one, each level one ply-kernel call (``ops.step``)."""
    jbit = random_states(48, 5, max_plies=60)
    bit = to_port(jbit)
    js = othello_state(jbit)
    planes = core.OthelloState(
        board=tb.to_board(bit), turn=bit.turn, legal=tb.unpack_flat(bit.legal),
        terminated=bit.terminated, winner=bit.winner)
    np.testing.assert_array_equal(planes.board.numpy(), np.asarray(js.board))
    cfg = EnvConfig(num_disk_as_reward=True)
    want = ppo_trainer.lookahead_search(STUB, bit, cfg, depth)[0]
    calls = []
    real = ply.bit_step

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(ply, "bit_step", counted)
    got = ppo_trainer.lookahead_search(STUB, planes, cfg, depth)[0]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert len(calls) == depth
    assert scripted.expand_legal(planes, planes.legal, cfg)[2].board.shape[
        1:] == (8, 8)
