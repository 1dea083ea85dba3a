"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py):
random reachable positions made with the JAX engine from a numpy seed,
conversion of JAX word pairs to the port's 64-bit words, of JAX
bitboard states to the plane states of JAX's search and of JAX plane
states to the port's, and the exact stub value net of JAX's search
tests."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import bitboard as bb
from gymothelloenv_tpu.core import state as jcore
from gymothelloenv_tpu.core.state import EnvConfig, OthelloState
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.core import state as core

PLANE_FIELDS = ("board", "turn", "legal", "terminated", "winner")


def pair(p) -> np.ndarray:
    """JAX word pair ``(w0, w1)`` -> uint32 (..., 2)."""
    return np.stack([np.asarray(p[0]), np.asarray(p[1])], axis=-1)


def word(p):
    """JAX word pair -> the port's int64 word tensor."""
    return tb.pack_pair(pair(p))


def to_port(s: bb.BitState) -> tb.BitState:
    return tb.BitState(
        black=word(s.black), white=word(s.white),
        turn=torch.from_numpy(np.asarray(s.turn).astype(np.int8)),
        legal=word(s.legal),
        terminated=torch.from_numpy(np.array(s.terminated)),
        winner=torch.from_numpy(np.asarray(s.winner).astype(np.int8)))


def assert_same_state(port: tb.BitState, ref: bb.BitState, msg=""):
    for name in ("black", "white", "legal"):
        np.testing.assert_array_equal(tb.unpack_pair(getattr(port, name)),
                                      pair(getattr(ref, name)),
                                      err_msg=f"{name} {msg}")
    for name in ("turn", "terminated", "winner"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=f"{name} {msg}")


def plane_to_port(s: OthelloState) -> core.OthelloState:
    """A JAX plane state as the port's ``OthelloState``."""
    return core.OthelloState(**{f: torch.from_numpy(np.array(getattr(s, f)))
                                for f in PLANE_FIELDS})


def assert_same_planes(port: core.OthelloState, ref, msg=""):
    """Every field of a port plane state equal to a JAX one, dtype too."""
    for f in PLANE_FIELDS:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f"{f} {msg}")


@functools.cache
def plane_positions(b: int, n: int = 64, seed: int = 0):
    """JAX plane states of a random playout, each game stopped after its
    own number of plies (terminal ones included)."""
    cfg = EnvConfig(board_size=b)
    step = jax.jit(jax.vmap(jcore.step, in_axes=(0, 0, None)),
                   static_argnums=2)
    rng = np.random.RandomState(seed)
    stop = rng.randint(0, b * b, n)
    s = jax.jit(jax.vmap(lambda _: jcore.reset(cfg)))(jnp.arange(n))
    for ply in range(b * b):
        live = (stop > ply) & ~np.asarray(s.terminated)
        if not live.any():
            break
        legal = np.asarray(s.legal)
        a = np.array([rng.choice(np.nonzero(r)[0]) if r.any() else 0
                      for r in legal], np.int32)
        new = step(s, jnp.asarray(a), cfg).state
        s = jax.tree.map(lambda x, o: jnp.where(
            jnp.asarray(live).reshape((-1,) + (1,) * (x.ndim - 1)), x, o),
            new, s)
    return s


def othello_state(s: bb.BitState) -> OthelloState:
    """A JAX bitboard state as the plane ``OthelloState`` that JAX's
    per-game policies (maximin, ``net_lookahead_policy``) take."""
    legal = bb.unpack2(s.legal).reshape(s.turn.shape + (64,))
    return OthelloState(board=bb.to_board(s), turn=s.turn, legal=legal,
                        terminated=s.terminated, winner=s.winner)


class DiskDiffNet(torch.nn.Module):
    """The port twin of JAX's stub ``_stub_apply``
    (tests/test_chunked_search.py:101-105): zero logits (one per cell of
    the input's board, any size) and the value ``(black - white disks) *
    (2 * turn plane - 1)``, computed in the same float32 steps, so search
    values are exact integers on both sides."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()),
                                         requires_grad=False)

    def forward(self, obs):
        diff = obs[:, 0].sum((1, 2)) - obs[:, 1].sum((1, 2))
        turn = 2.0 * obs[:, 2, 0, 0] - 1.0
        return obs.new_zeros(obs.shape[0], obs.shape[-1] ** 2), diff * turn


@functools.cache
def _jstep():
    return jax.jit(bb.bit_step)


def legal_lists(legal_pair) -> np.ndarray:
    """bool (N, 64) legal actions of a JAX word pair."""
    flat = np.asarray(bb.unpack2(legal_pair))
    return flat.reshape(flat.shape[0], 64)


def random_states(n: int, seed: int, max_plies: int = 60) -> bb.BitState:
    """``n`` positions reached by uniformly random legal play from the
    opening, each after its own number of plies in [0, max_plies); games
    that end early stay at their terminal position."""
    rng = np.random.RandomState(seed)
    budget = rng.randint(0, max_plies, n)
    s = bb.bit_reset((n,))
    step = _jstep()
    for ply in range(max_plies):
        legal = legal_lists(s.legal)
        live = (budget > ply) & ~np.asarray(s.terminated)
        if not live.any():
            break
        actions = np.zeros(n, np.int32)
        for i in np.nonzero(live)[0]:
            actions[i] = rng.choice(np.nonzero(legal[i])[0])
        new = step(s, jnp.asarray(actions)).state
        s = jax.tree.map(
            lambda a, b: jnp.where(jnp.asarray(live), a, b), new, s)
    return s


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for the module's tests.  The suite runs in
    several worker processes, and torch's default of one thread per core
    oversubscribes the CPU: tests made of many small ops then run many
    times slower.  Import it into a test module to apply it there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
