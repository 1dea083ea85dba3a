"""The port's value-lookahead search against JAX's ``net_lookahead_policy``
(eval time: depths 1 and 2 and the depth-3 beam), its chunking and its
one ply-kernel launch a tree level.  The collector's side and the CLI
flags are in test_torch_lookahead_collect.py, which shares these states
and nets.

States: random reachable positions (``torch_port_helpers.random_states``)
of four kinds: ended games, ``quirk`` positions (a legal move after which
the reply side must pass, so the child is a max node again), ``ending``
positions (a legal move ends the game) and plain ones.

With the stub value net of JAX's search tests (the disk difference,
``DiskDiffNet``) every value is an integer, ties are common, and every
decision must equal JAX's bit for bit, including the beam's tie-breaks
(``jax.lax.top_k``: the lower action among equal depth-1 values, and +0.0
above -0.0).  With a seeded ``PolicyNet`` the values agree to 1e-5 and the
decisions wherever the port's margin (its best value over the second, and
the beam's cut) exceeds 1e-4."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import bitboard as jbb
from gymothelloenv_tpu.core.engine import get_engine
from gymothelloenv_tpu.core.state import EnvConfig as JaxEnvConfig
from gymothelloenv_tpu.models.nets import PolicyNet as JaxPolicyNet
from gymothelloenv_tpu.train import ppo_trainer as jtrainer
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core.state import EnvConfig, index_games
from gymothelloenv_tpu_torch.models.convert import policy_net_from_flax
from gymothelloenv_tpu_torch.policies import scripted
from gymothelloenv_tpu_torch.train import ppo_trainer
from gymothelloenv_tpu_torch.train import self_play as sp
from test_chunked_search import _stub_apply
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import (DiskDiffNet, legal_lists, othello_state,
                                random_states, to_port)

RCFG = EnvConfig(num_disk_as_reward=True)
JRCFG = JaxEnvConfig(num_disk_as_reward=True)
HIDDEN = 32
MARGIN = 1e-4
STATES, SEED = 1024, 7
STUB = DiskDiffNet()


@functools.cache
def _states():
    """(JAX BitState, port BitState, {kind: indices}) over STATES random
    positions."""
    jstate = random_states(STATES, SEED, max_plies=64)
    port = to_port(jstate)
    node, action = torch.nonzero(tb.unpack_flat(port.legal), as_tuple=True)
    child = tb.bit_step_plain(index_games(port, node), action).state
    flags = {"ended": port.terminated}
    for kind, hit in (("quirk", (child.turn == port.turn[node])
                       & ~child.terminated),
                      ("ending", child.terminated)):
        mask = torch.zeros(STATES, dtype=torch.bool)
        mask[node[hit]] = True
        flags[kind] = mask
    flags["plain"] = ~(flags["quirk"] | flags["ending"] | flags["ended"])
    kinds = {k: torch.nonzero(v)[:, 0] for k, v in flags.items()}
    return jstate, port, kinds


def _pick(counts, offset=0):
    """Indices of ``counts[kind]`` states of each kind, from ``offset``."""
    _, _, kinds = _states()
    for kind, n in counts.items():
        assert len(kinds[kind]) >= offset + n, (kind, len(kinds[kind]))
    return torch.cat([kinds[k][offset:offset + n] for k, n in counts.items()])


def _port(idx):
    return index_games(_states()[1], idx)


def _jax(idx):
    return jax.tree.map(lambda x: x[idx.numpy()], _states()[0])


@functools.cache
def _jax_policy(params_key, depth, beam_k):
    params, apply_fn = _NETS[params_key]
    act = jtrainer.net_lookahead_policy(params, apply_fn, JRCFG, depth,
                                        beam_k)
    return jax.jit(jax.vmap(act))


def _jax_decisions(idx, depth, beam_k=8, net="stub"):
    states = othello_state(_jax(idx))
    keys = jax.random.split(jax.random.PRNGKey(0), len(idx))
    return np.asarray(_jax_policy(net, depth, beam_k)(keys, states))


@functools.cache
def _seeded():
    jnet = JaxPolicyNet(num_actions=64, hidden_size=HIDDEN, width_mult=1)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(3),
                                jnp.zeros((1, 4, 8, 8)))
    # A value head of O(10): values far apart next to the 1e-5 agreement.
    dense = params["params"]["Dense_1"]
    dense["kernel"] = dense["kernel"] * 10.0
    return params, jtrainer.make_apply_fn(jnet), policy_net_from_flax(
        params, 1, HIDDEN, device="cpu")


class _Nets(dict):
    def __missing__(self, key):
        assert key == "seeded"
        params, apply_fn, _ = _seeded()
        self[key] = (params, apply_fn)
        return self[key]


_NETS = _Nets(stub=(None, _stub_apply))

MIXED = {"quirk": 10, "ending": 10, "ended": 6, "plain": 22}   # 48 states


@pytest.mark.parametrize("depth", [1, 2])
def test_decisions_bit_equal_to_jax(depth):
    idx = _pick(MIXED)
    got, scores, _ = ppo_trainer.lookahead_search(STUB, _port(idx), RCFG,
                                                  depth)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), _jax_decisions(idx, depth))
    # The states hold ties at the top, where the first maximum decides.
    top = scores.max(1, keepdim=True).values
    assert int(((scores == top).sum(1) > 1).sum()) >= 5


@pytest.mark.parametrize("beam_k", [1, 3, 8, 64])
def test_beam_bit_equal_to_jax(beam_k):
    counts = ({"quirk": 2, "ending": 2, "ended": 1, "plain": 3}
              if beam_k == 64 else
              {"quirk": 4, "ending": 4, "ended": 2, "plain": 6})
    idx = _pick(counts, offset=10)
    got, scores, _ = ppo_trainer.lookahead_search(STUB, _port(idx), RCFG, 3,
                                                  beam_k)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_decisions(idx, 3, beam_k))
    searched = (scores > sp.NEG).sum(1)
    legal = tb.popcount(_port(idx).legal)
    assert torch.equal(searched, torch.minimum(legal,
                                               torch.tensor(beam_k)))


def test_beam_ties_rank_by_total_order():
    """-0.0 ranks below +0.0 and equal values keep the lower action,
    as ``jax.lax.top_k``."""
    v = torch.tensor([0.0, -0.0, 0.0, -0.0, 1.0, -0.0, 0.0])
    order = torch.sort(-ppo_trainer._total_order(v), stable=True).indices
    want = jax.lax.top_k(jnp.asarray(v.numpy()), 7)[1]
    np.testing.assert_array_equal(order.numpy(), np.asarray(want))


@functools.cache
def _jax_values(net):
    """JAX's collector values (``lookahead_action_values``, bit engine)
    as numpy, jitted once per net."""
    params, apply_fn = _NETS[net]
    fn = jax.jit(lambda s: jsp.lookahead_action_values(
        params, apply_fn, get_engine(JRCFG), s, JRCFG))
    return lambda s: np.asarray(fn(s))


def _jax_depth2_values(params, apply_fn, idx):
    """JAX reference for the depth-2 values of the legal root actions,
    from JAX's own 1-ply values one level down: every legal child stepped
    with JAX's ``bit_step``, its replies' values from JAX's
    ``lookahead_action_values`` (the child mover's side), and the root's
    value of the child its reward if the game ended, else the best reply's
    value where the child's mover is the root's, else minus it."""
    jstate = _jax(idx)
    legal = legal_lists(jstate.legal)
    root, action = np.nonzero(legal)
    parents = jax.tree.map(lambda x: x[root], jstate)
    res = jax.jit(jbb.bit_step, static_argnums=(2, 3))(
        parents, jnp.asarray(action, jnp.int32), True, True)
    child = res.state
    vals = _jax_values("seeded")(child)
    best = np.where(legal_lists(child.legal), vals, -np.inf).max(1)
    same = np.asarray(child.turn) == np.asarray(jstate.turn)[root]
    value = np.where(np.asarray(child.terminated), np.asarray(res.reward),
                     np.where(same, best, -best))
    out = np.full((len(idx), 64), np.nan, np.float32)
    out[root, action] = value
    return out


def test_seeded_net_values_and_decisions():
    """Values at legal actions to 1e-5 (depth 1 against JAX's collector
    values, depth 2 against those values a level down); depth-1
    decisions equal JAX's ``net_lookahead_policy``'s wherever the margin
    exceeds 1e-4 (deeper decisions are held bit for bit with the stub
    above, and on the card against the CPU by chip_smoke.py)."""
    params, apply_fn, net = _seeded()
    idx = _pick(MIXED)
    state, legal = _port(idx), tb.unpack_flat(_port(idx).legal)
    want1 = _jax_values("seeded")(_jax(idx))
    want2 = _jax_depth2_values(params, apply_fn, idx)
    for depth, want in ((1, want1), (2, want2)):
        got, scores, margin = ppo_trainer.lookahead_search(net, state, RCFG,
                                                           depth)
        np.testing.assert_allclose(scores.numpy()[legal.numpy()],
                                   want[legal.numpy()], rtol=0, atol=1e-5,
                                   err_msg=f"depth {depth}")
        if depth == 1:
            clear = (margin > MARGIN).numpy()
            assert clear.sum() >= 0.9 * len(idx)
            np.testing.assert_array_equal(
                got.numpy()[clear],
                _jax_decisions(idx, 1, 8, "seeded")[clear])


@pytest.mark.parametrize("depth,chunk", [(2, 1), (2, 7), (2, -1), (3, 5),
                                         (3, 0)])
def test_chunked_equals_unchunked(depth, chunk, monkeypatch):
    """Exact: decisions, values and margins.  Chunk 0 with a tiny budget
    halves the chunks down to single games."""
    state = _port(_pick(MIXED))
    want = ppo_trainer.lookahead_search(STUB, state, RCFG, depth, 3)
    if chunk == 0:
        monkeypatch.setattr(scripted, "_CPU_BUDGET", 2_000_000)
    got = ppo_trainer.lookahead_search(STUB, state, RCFG, depth, 3, chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_one_ply_call_a_level(depth, monkeypatch):
    calls = []
    real = scripted.step.bit_step

    def counted(state, action, *args, **kwargs):
        calls.append((action.shape[0], kwargs))
        return real(state, action, *args, **kwargs)

    monkeypatch.setattr(scripted.step, "bit_step", counted)
    state = _port(_pick({"plain": 8}))
    ppo_trainer.net_lookahead_policy(STUB, RCFG, depth)(state)
    assert len(calls) == depth
    assert calls[0][0] == int(tb.popcount(state.legal).sum())
    assert all(kw["num_disk_as_reward"] for _, kw in calls)


def test_no_legal_move_gives_action_zero_and_guards():
    state = _port(_pick({"ended": 4}))
    for depth in (1, 2, 3):
        act = ppo_trainer.net_lookahead_policy(STUB, RCFG, depth)
        assert act(state).tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="depth"):
        ppo_trainer.net_lookahead_policy(STUB, RCFG, 4)
    with pytest.raises(ValueError, match="beam_k"):
        ppo_trainer.net_lookahead_policy(STUB, RCFG, 3, beam_k=65)
