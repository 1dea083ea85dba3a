"""The port's perft (``gymothelloenv_tpu_torch/core/perft.py``: K2's and the
ply kernel's plain versions on the CPU) against JAX's ``core/perft.py``,
the published opening counts and the C++ oracle ``native/othello_perft.cpp``
(built with g++ into a temporary directory, as ``tests/test_perft.py``
builds it): the opening at depths 1-6, and ``perft_from`` at depths 2-4
from 8 random midgame positions.  Tolerance: exact."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

from gymothelloenv_tpu.core import perft as jperft
from gymothelloenv_tpu_torch.core import perft
from torch_port_helpers import one_torch_thread  # noqa: F401
from torch_port_helpers import random_states

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "othello_perft.cpp")
KNOWN = {1: 4, 2: 12, 3: 56, 4: 244, 5: 1396, 6: 8200}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("perft") / "libothello_perft.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", so, SOURCE],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.othello_perft.restype = ctypes.c_ulonglong
    lib.othello_perft.argtypes = [ctypes.c_int]
    lib.othello_perft_from.restype = ctypes.c_ulonglong
    lib.othello_perft_from.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                       ctypes.c_int]
    return lib


def _u64(pair) -> int:
    return int(pair[0]) | (int(pair[1]) << 32)


@pytest.mark.parametrize("depth", sorted(KNOWN))
def test_opening_perft_matches_jax_oracle_and_published(oracle, depth):
    got = perft.perft(depth, device="cpu")
    assert got == jperft.perft(depth) == int(oracle.othello_perft(depth)) \
        == KNOWN[depth]


def test_midgame_perft_from_matches_jax_and_oracle(oracle):
    """8 positions after 16-28 random plies (games still on), depths
    2-4, side to move first."""
    states = random_states(24, seed=11, max_plies=28)
    checked = 0
    for i in range(24):
        if bool(states.terminated[i]) or checked == 8:
            continue
        pairs = [(np.uint32(w[0][i]), np.uint32(w[1][i]))
                 for w in (states.black, states.white)]
        mine, theirs = pairs if int(states.turn[i]) == -1 else pairs[::-1]
        if bin(_u64(mine) | _u64(theirs)).count("1") < 20:
            continue
        for d in (2, 3, 4):
            got = perft.perft_from(_u64(mine), _u64(theirs), d, device="cpu")
            want = int(oracle.othello_perft_from(_u64(mine), _u64(theirs),
                                                 d))
            assert got == want, (i, d, got, want)
            if d == 3:
                assert got == jperft.perft_from(mine, theirs, d)
        checked += 1
    assert checked == 8


def test_perft_frontier_limit():
    with pytest.raises(ValueError, match="max_positions"):
        perft.perft(4, device="cpu", max_positions=100)
