"""Port rules (gymothelloenv_tpu_torch/core/bitboard.py) against the JAX
bitboard engine, bit for bit, on random reachable positions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import bitboard as bb
from gymothelloenv_tpu.core import bitops
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core.state import select_games
from gymothelloenv_tpu_torch.ops import step
from torch_port_helpers import (assert_same_state, legal_lists, pair,
                                random_states, to_port, word)


@pytest.fixture(scope="module")


def states():
    return random_states(96, seed=0)


def test_lsr_bit63_is_logical():
    """Torch's >> on int64 smears bit 63; lsr must not."""
    top = torch.tensor([-(1 << 63), -1, (1 << 62)], dtype=torch.int64)
    assert (top >> 1)[0] < 0                       # the trap itself
    got = tb.lsr(top, 1)
    assert got.tolist() == [1 << 62, (1 << 63) - 1, 1 << 61]
    assert tb.lsr(top, 63).tolist() == [1, 1, 0]
    # A piece on cell 63 moving up one row lands on cell 55 only.
    assert tb.shift(top[:1], -1, 0).tolist() == [1 << 55]
    assert tb.popcount(top).tolist() == [1, 64, 1]


def test_pack_pair_roundtrip_and_planes():
    rng = np.random.RandomState(1)
    raw = rng.randint(0, 2 ** 32, (50, 2), np.uint64).astype(np.uint32)
    raw[0] = [0, 0x80000000]                       # bit 63 alone
    w = tb.pack_pair(raw)
    np.testing.assert_array_equal(tb.unpack_pair(w), raw)
    planes = np.array(bb.unpack(jnp.asarray(raw)))
    np.testing.assert_array_equal(tb.unpack(w).numpy(), planes)
    assert torch.equal(tb.pack(torch.from_numpy(planes)), w)


@pytest.mark.parametrize("dr,dc", bb.DIRECTIONS)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_shift_matches_jax(dr, dc, k):
    rng = np.random.RandomState(2)
    raw = rng.randint(0, 2 ** 32, (64, 2), np.uint64).astype(np.uint32)
    want = pair(bb.shift2k(jnp.asarray(raw[:, 0]), jnp.asarray(raw[:, 1]),
                           dr, dc, k))
    got = tb.unpack_pair(tb.shift(tb.pack_pair(raw), dr, dc, k))
    np.testing.assert_array_equal(got, want)


def test_legal_mask_matches_jax_both_sides(states):
    for mine, opp in ((states.black, states.white),
                      (states.white, states.black)):
        want = pair(bb.legal_mask2(mine, opp))
        got = tb.unpack_pair(tb.legal_mask(word(mine), word(opp)))
        np.testing.assert_array_equal(got, want)


def test_legal_mask_matches_jax_on_random_boards():
    rng = np.random.RandomState(3)
    cells = rng.randint(0, 3, (300, 8, 8))
    mine = bb.pack(jnp.asarray(cells == 1))
    opp = bb.pack(jnp.asarray(cells == 2))
    want = np.asarray(bb.legal_mask(mine, opp))
    got = tb.unpack_pair(tb.legal_mask(tb.pack_pair(mine),
                                       tb.pack_pair(opp)))
    np.testing.assert_array_equal(got, want)


def test_resolve_flips_matches_jax(states):
    rng = np.random.RandomState(4)
    legal = legal_lists(states.legal)
    is_white = np.asarray(states.turn) == 1
    mine = np.where(is_white[:, None], pair(states.white), pair(states.black))
    opp = np.where(is_white[:, None], pair(states.black), pair(states.white))
    # One legal move per board where there is one, else a random cell.
    actions = np.array([rng.choice(np.nonzero(row)[0]) if row.any()
                        else rng.randint(64) for row in legal], np.int32)
    onehot = bb.action_bit2(jnp.asarray(actions))
    want = pair(bb.resolve_flips2(onehot, (jnp.asarray(mine[:, 0]),
                                           jnp.asarray(mine[:, 1])),
                                  (jnp.asarray(opp[:, 0]),
                                   jnp.asarray(opp[:, 1]))))
    got = tb.resolve_flips(tb.action_bit(torch.from_numpy(actions)),
                           tb.pack_pair(mine), tb.pack_pair(opp))
    np.testing.assert_array_equal(tb.unpack_pair(got), want)


def test_popcount_and_action_bit(states):
    got = tb.popcount(word(states.black)).numpy()
    want = np.asarray(bb.popcount2(states.black))
    np.testing.assert_array_equal(got, want)
    actions = np.array([0, 7, 31, 32, 63, 64, -1, 100], np.int32)
    want = pair(bb.action_bit2(jnp.asarray(actions)))
    got = tb.unpack_pair(tb.action_bit(torch.from_numpy(actions)))
    np.testing.assert_array_equal(got, want)
    assert tb.action_bit(torch.tensor([64, -1])).tolist() == [0, 0]


def test_flip_counts_match_plane_kernel(states):
    is_white = np.asarray(states.turn) == 1
    black = np.asarray(bb.unpack2(states.black))
    white = np.asarray(bb.unpack2(states.white))
    mine = np.where(is_white[:, None, None], white, black)
    opp = np.where(is_white[:, None, None], black, white)
    want = np.asarray(bitops.flip_counts(jnp.asarray(mine),
                                         jnp.asarray(opp))).reshape(-1, 64)
    got = tb.flip_counts(tb.pack(torch.from_numpy(mine)),
                         tb.pack(torch.from_numpy(opp)))
    empty = ~(mine | opp).reshape(-1, 64)
    np.testing.assert_array_equal(got.numpy()[empty], want[empty])


def test_bit_reset_matches_jax():
    assert_same_state(tb.bit_reset(5, device="cpu"), bb.bit_reset((5,)))


@pytest.mark.parametrize("sudden", [True, False])
@pytest.mark.parametrize("disk_reward", [False, True])
def test_bit_step_matches_jax(sudden, disk_reward, states):
    rng = np.random.RandomState(5)
    live = ~np.asarray(states.terminated)
    legal = legal_lists(states.legal)
    actions = []
    for i, row in enumerate(legal):
        roll = rng.rand()
        if roll < 0.15 or not row.any():
            actions.append(rng.choice([64, -1, rng.randint(64)]))
        else:
            actions.append(rng.choice(np.nonzero(row)[0]))
    actions = np.asarray(actions, np.int32)
    want = jax.jit(bb.bit_step, static_argnums=(2, 3))(
        states, jnp.asarray(actions), sudden, disk_reward)
    got = step.bit_step(to_port(states),
                        torch.from_numpy(actions.astype(np.int64)),
                        sudden_death_on_invalid_move=sudden,
                        num_disk_as_reward=disk_reward)
    sel = jax.tree.map(lambda x: x[live], want.state)
    port_sel = tb.BitState(**{k: v[torch.from_numpy(live)]
                              for k, v in vars(got.state).items()})
    assert_same_state(port_sel, sel)
    np.testing.assert_array_equal(got.reward.numpy()[live],
                                  np.asarray(want.reward)[live])
    np.testing.assert_array_equal(got.done.numpy()[live],
                                  np.asarray(want.done)[live])


def test_bit_step_full_games_match_jax():
    """Whole random games, stepping both engines from the opening."""
    rng = np.random.RandomState(6)
    n = 32
    ref = bb.bit_reset((n,))
    port = tb.bit_reset(n, device="cpu")
    jstep = jax.jit(bb.bit_step)
    for ply in range(70):
        legal = legal_lists(ref.legal)
        actions = np.array([rng.choice(np.nonzero(r)[0]) if r.any() else 0
                            for r in legal], np.int32)
        res = jstep(ref, jnp.asarray(actions))
        pres = step.bit_step(port, torch.from_numpy(actions.astype(np.int64)))
        live = ~np.asarray(ref.terminated)
        np.testing.assert_array_equal(pres.reward.numpy()[live],
                                      np.asarray(res.reward)[live])
        ref = jax.tree.map(lambda a, b: jnp.where(jnp.asarray(live), a, b),
                           res.state, ref)
        port = select_games(torch.from_numpy(live), pres.state, port)
        assert_same_state(port, ref, f"ply {ply}")
    assert bool(port.terminated.all())


def test_random_legal_bit_matches_jax_with_injected_t(states):
    key = jax.random.PRNGKey(7)
    want = np.asarray(bb.random_legal_bit(key, states.legal))
    # random_legal_bit's own draw, made here and injected into the port.
    count = bb.popcount2(states.legal)
    t = jax.random.randint(key, count.shape, 0, jnp.maximum(count, 1),
                           dtype=jnp.int32)
    got = tb.random_legal_bit(word(states.legal),
                              torch.from_numpy(np.asarray(t).astype(np.int64)))
    has = np.asarray(count) > 0
    np.testing.assert_array_equal(got.numpy()[has], want[has])


def test_random_legal_bit_draws_legal_moves(states):
    g = torch.Generator().manual_seed(0)
    legal = word(states.legal)
    has = (legal != 0).numpy()
    flat = legal_lists(states.legal)
    for _ in range(5):
        a = tb.random_legal_bit(legal, generator=g).numpy()
        assert flat[np.arange(len(a))[has], a[has]].all()

