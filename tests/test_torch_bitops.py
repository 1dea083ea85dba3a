"""The port's plane rules (``gymothelloenv_tpu_torch/core/bitops.py``)
against ``gymothelloenv_tpu/core/bitops.py`` at B = 4, 6, 8 and 10, on
random boards made with numpy from a seed: ``shift``, ``legal_mask``,
``flip_counts``, ``resolve_flips`` and ``apply_move``.  Tolerance: exact
(booleans and int32 counts)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import bitops as jops
from gymothelloenv_tpu_torch.core import bitops
from torch_port_helpers import one_torch_thread  # noqa: F401

SIZES = (4, 6, 8, 10)
N = 256


def _boards(b: int, seed: int):
    """``N`` random (mine, opp) planes, each board with its own fill and
    side share, from sparse to nearly full."""
    rng = np.random.RandomState(seed)
    filled = rng.rand(N, b, b) < rng.uniform(0.15, 0.97, (N, 1, 1))
    side = rng.rand(N, b, b) < rng.uniform(0.2, 0.8, (N, 1, 1))
    return filled & side, filled & ~side


@functools.cache
def _jit(name: str):
    return jax.jit(getattr(jops, name))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b", (5, 8))
def test_shift_matches_jax(b):
    x = np.random.RandomState(b).rand(7, b, b) < 0.5
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            want = np.asarray(jops.shift(jnp.asarray(x), dr, dc))
            np.testing.assert_array_equal(
                bitops.shift(_t(x), dr, dc).numpy(), want,
                err_msg=f"shift {dr} {dc}")


@pytest.mark.parametrize("b", SIZES)
def test_legal_mask_and_flip_counts_match_jax(b):
    mine, opp = _boards(b, b)
    want_legal = np.asarray(_jit("legal_mask")(mine, opp))
    want_counts = np.asarray(_jit("flip_counts")(mine, opp))
    got_legal = bitops.legal_mask(_t(mine), _t(opp)).numpy()
    got_counts = bitops.flip_counts(_t(mine), _t(opp)).numpy()
    assert got_legal.dtype == np.bool_ and got_counts.dtype == np.int32
    assert want_legal.any() and want_counts.max() >= 2
    np.testing.assert_array_equal(got_legal, want_legal)
    np.testing.assert_array_equal(got_counts, want_counts)
    # legal <=> empty and at least one flip
    empty = ~(mine | opp)
    np.testing.assert_array_equal(got_legal, empty & (got_counts > 0))


@pytest.mark.parametrize("b", SIZES)
def test_resolve_flips_and_apply_move_match_jax(b):
    """One placement a board: a legal cell where the board has one, else
    any cell (then the flips must still agree)."""
    mine, opp = _boards(b, 100 + b)
    legal = np.asarray(_jit("legal_mask")(mine, opp)).reshape(N, -1)
    rng = np.random.RandomState(200 + b)
    cell = np.array([rng.choice(np.nonzero(row)[0]) if row.any()
                     else rng.randint(b * b) for row in legal])
    onehot = (np.arange(b * b) == cell[:, None]).reshape(N, b, b)
    want = np.asarray(_jit("resolve_flips")(onehot, mine, opp))
    got = bitops.resolve_flips(_t(onehot), _t(mine), _t(opp)).numpy()
    assert want.any()
    np.testing.assert_array_equal(got, want)
    want_m, want_o = _jit("apply_move")(onehot, mine, opp)
    got_m, got_o = bitops.apply_move(_t(onehot), _t(mine), _t(opp))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
