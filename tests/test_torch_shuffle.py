"""The port's sort-free shuffle against ``gymothelloenv_tpu.ops.shuffle``:
the same 4 key words give the same permutation, bit for bit (tolerance:
exact), and it is a permutation for every power of two up to 2^16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.ops import shuffle as jshuffle
from gymothelloenv_tpu_torch.ops import shuffle as shuffle
from torch_port_helpers import one_torch_thread  # noqa: F401


def _key_and_words(seed):
    key = jax.random.PRNGKey(seed)
    words = np.asarray(jax.random.bits(key, (4,), jnp.uint32))
    return key, words


@pytest.mark.parametrize("k", [0, 1, 2, 5, 8, 13, 16])
def test_hash_perm_matches_jax(k):
    n = 2 ** k
    for seed in range(3):
        key, words = _key_and_words(seed)
        idx = np.arange(n, dtype=np.int32)
        want = np.asarray(jshuffle.hash_perm(key, n, jnp.asarray(idx)))
        got = shuffle.hash_perm(torch.from_numpy(words.astype(np.int64)), n,
                                torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), want)


def test_hash_perm_is_a_permutation_up_to_2_16():
    g = torch.Generator().manual_seed(0)
    for k in range(17):
        n = 2 ** k
        words = shuffle.draw_words(g, 1)[0]
        perm = shuffle.hash_perm(words, n, torch.arange(n))
        assert torch.equal(torch.sort(perm).values, torch.arange(n)), n


def test_minibatch_indices_match_jax_and_partition():
    key, words = _key_and_words(7)
    n, mb = 256, 64
    blocks = []
    for i in range(n // mb):
        want = np.asarray(jshuffle.minibatch_indices(key, n, jnp.int32(i),
                                                     mb))
        got = shuffle.minibatch_indices(words, n, i, mb)
        np.testing.assert_array_equal(got.numpy(), want)
        blocks.append(got)
    assert torch.equal(torch.sort(torch.cat(blocks)).values,
                       torch.arange(n))


def test_words_change_the_order_and_sort_perm_is_a_permutation():
    g = torch.Generator().manual_seed(1)
    w = shuffle.draw_words(g, 2)
    assert w.dtype == torch.int64 and w.shape == (2, 4)
    assert bool(((w >= 0) & (w < 2 ** 32)).all())
    a = shuffle.hash_perm(w[0], 1024, torch.arange(1024))
    b = shuffle.hash_perm(w[1], 1024, torch.arange(1024))
    assert not torch.equal(a, b)
    p = shuffle.sort_perm(w[0], 1000)
    assert torch.equal(torch.sort(p).values, torch.arange(1000))
    assert torch.equal(p, shuffle.sort_perm(w[0], 1000))


@pytest.mark.parametrize("n", [0, 3, 96, 2 ** 32])
def test_hash_perm_rejects_bad_domains(n):
    with pytest.raises(ValueError):
        shuffle.hash_perm([1, 2, 3, 4], n, torch.arange(4))
    assert shuffle.is_power_of_two(n) == (n in (2 ** 32,))
