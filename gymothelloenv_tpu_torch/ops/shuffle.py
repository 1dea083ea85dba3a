"""Sort-free minibatch shuffling — the port of ``ops/shuffle.py``.

For a power-of-two batch, a keyed bijection on ``[0, 2**k)`` evaluated
pointwise stands in for a uniform permutation (epoch shuffling carries no
order semantics): xor a constant, multiply by an odd constant mod 2^k,
xorshift right, twice, then xor again.  Every stage is invertible on k
bits.

The four 32-bit key words ``words`` are an INPUT (JAX draws them as
``jax.random.bits(key, (4,), uint32)``, which torch cannot reproduce), so
given the same words the port and the JAX package pick the same
minibatches.  Arithmetic is int64 with both factors masked to k bits
first: the product mod 2^k is what uint32 arithmetic keeps under the mask,
and two k-bit factors never overflow int64 for k <= 31.
"""

from __future__ import annotations

import torch


def is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def draw_words(generator: torch.Generator, rows: int) -> torch.Tensor:
    """``rows`` sets of 4 uniform 32-bit key words, int64 ``(rows, 4)`` on
    the CPU."""
    return torch.randint(0, 2 ** 32, (rows, 4), dtype=torch.int64,
                         generator=generator)


def hash_perm(words, n: int, idx: torch.Tensor) -> torch.Tensor:
    """Apply the keyed bijection on ``[0, n)`` given by the 4 key ``words``
    (ints or a length-4 tensor) to ``idx`` (any shape, integer).  ``n``
    must be a power of two, at most 2^31.  Returns int64."""
    if not is_power_of_two(n):
        raise ValueError(f"hash_perm needs a power-of-two domain, got {n}")
    if n > 2 ** 31:
        raise ValueError(f"hash_perm takes n <= 2^31, got {n}")
    k = n.bit_length() - 1
    if k == 0:
        return torch.zeros_like(idx, dtype=torch.int64)
    c = [int(w) & 0xFFFFFFFF for w in words]
    if len(c) != 4:
        raise ValueError(f"hash_perm takes 4 key words, got {len(c)}")
    mask = n - 1
    a1, a2 = (c[0] | 1) & mask, (c[1] | 1) & mask
    s1, s2 = max(1, k // 2), max(1, (k + 1) // 2)
    x = idx.to(torch.int64) & 0xFFFFFFFF
    x = (x ^ c[2]) & mask
    x = (x * a1) & mask
    x = x ^ (x >> s1)
    x = (x * a2) & mask
    x = x ^ (x >> s2)
    return (x ^ c[3]) & mask


def minibatch_indices(words, batch_size: int, mb_idx: int,
                      mb_size: int, device=None) -> torch.Tensor:
    """Indices of minibatch ``mb_idx`` under the epoch's hash permutation:
    positions ``[mb_idx * mb_size, ... + mb_size)`` mapped through
    ``hash_perm``."""
    j = mb_idx * mb_size + torch.arange(mb_size, dtype=torch.int64,
                                        device=device)
    return hash_perm(words, batch_size, j)


def sort_perm(words, n: int, device=None) -> torch.Tensor:
    """A uniform permutation of ``[0, n)`` (the ``shuffle="sort"`` and
    non-power-of-two case): ``torch.randperm`` from a CPU generator seeded
    by the first two key words."""
    c = [int(w) & 0xFFFFFFFF for w in words]
    g = torch.Generator().manual_seed(c[0] << 32 | c[1])
    return torch.randperm(n, generator=g).to(device)
