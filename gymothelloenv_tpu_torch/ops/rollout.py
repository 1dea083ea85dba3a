"""Kernel K1: the fused random-play rollout; kernel K3, its profiling
variants; and their plain version.

K1 replaces ``gymothelloenv_tpu/ops/pallas_rollout.py::rollout_chunk``.
Every game plays ``num_steps`` uniformly random legal plies in ONE launch
of ``csrc/rollout.cu`` and finished games reset to the opening.  The state
is the mover-perspective triple ``(cur, opp, legal)`` of int64 words
(uint64 on the card), one entry per game.

K3 replaces ``scripts/bench_rollout_variants.py::make_chunk``: the same
kernel with one component stubbed out (``VARIANTS``; only ``full`` plays
real games), an unroll factor and a block size, for cost attribution
(``scripts/bench_rollout_variants.py`` of this package).

Lanes: the kernel plays each game on a group of ``lanes`` threads (1, 2,
4 or 8), each flooding its share of the eight directions
(``core.bitboard.lane_directions``).  ``rollout_lanes`` picks it from N;
every ``lanes`` gives the same games.

Random bits: the kernel runs a Philox4x32-10 keyed by ``(seed, game)``
with counter ``(ply // 4, game >> 32, 0, 0)`` and takes word ``ply % 4``.
The plain version computes the same Philox in int64 tensor arithmetic, so
kernel and plain agree bit for bit in both modes: Philox, and injected
words (a ``(num_steps, N)`` tensor of 32-bit words).  CPU tensors take the
plain version; CUDA tensors launch the kernel, or the wrapper raises.
"""

from __future__ import annotations

import dataclasses

import torch

from gymothelloenv_tpu_torch.core.bitboard import (INIT_BLACK, INIT_LEGAL,
                                                   INIT_WHITE, legal_mask,
                                                   lsr, popcount,
                                                   resolve_flips)
from gymothelloenv_tpu_torch.ops import _build
from gymothelloenv_tpu_torch.parallel.sharding import (all_reduce_sum,
                                                       check_data_mesh)
from gymothelloenv_tpu_torch.utils.device import resolve_device

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class RolloutState:
    """Mover-perspective rollout state, each field int64 words (N,)."""
    cur: torch.Tensor    # current mover's disks
    opp: torch.Tensor    # opponent's disks
    legal: torch.Tensor  # mover's legal placements


def rollout_init(num_games: int, device=None) -> RolloutState:
    """All games at the opening (black to move)."""
    device = resolve_device(device)

    def full(v):
        return torch.full((num_games,), v, dtype=torch.int64, device=device)

    return RolloutState(cur=full(INIT_BLACK), opp=full(INIT_WHITE),
                        legal=full(INIT_LEGAL))


# --- plain version -----------------------------------------------------------

def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of the low 32 bits (``_popcount``)."""
    return popcount(v & _M32)


def sample_legal(r: torch.Tensor, legal: torch.Tensor) -> torch.Tensor:
    """Uniform random set bit of each legal word -> single-bit word
    (``_sample_legal``).  ``r``: 32-bit random words as int64.  Assumes
    every board has at least one legal move."""
    lo, hi = legal & _M32, lsr(legal, 32)
    cnt0 = popcount(lo)
    cnt = cnt0 + popcount(hi)
    # t = floor(u * cnt), u ~ U[0, 1) at 16-bit granularity.
    t = (((r & _M32) >> 16) * cnt) >> 16
    in_w1 = t >= cnt0
    t = torch.where(in_w1, t - cnt0, t)
    w = torch.where(in_w1, hi, lo)
    pos = torch.zeros_like(t)
    for width in (16, 8, 4, 2, 1):
        cm = popcount((w >> pos) & ((1 << width) - 1))
        skip = t >= cm
        pos = torch.where(skip, pos + width, pos)
        t = torch.where(skip, t - cm, t)
    return torch.ones_like(pos) << torch.where(in_w1, pos + 32, pos)


# K3's variants (_ply_variant): the one component each stubs out.
VARIANTS = ("full",       # nothing: K1's ply
            "nosample",   # the lowest set legal bit, not the uniform pick
            "noflips",    # the flips are the placed disk only
            "nopass")     # no mover-again flood: done = opponent can't move


def ply(cur: torch.Tensor, opp: torch.Tensor, legal: torch.Tensor,
        r: torch.Tensor, variant: str = "full"):
    """One random-move ply for every game (``_ply``, or ``_ply_variant``
    for a ``variant`` of ``VARIANTS``); returns the next ``(cur, opp,
    legal)`` and the bool mask of games that just ended (they are already
    reset to the opening)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if variant == "nosample":
        a = legal & -legal       # two's complement: the lowest set bit
    else:
        a = sample_legal(r, legal)
    f = a if variant == "noflips" else resolve_flips(a, cur, opp)
    nc, no = cur | a | f, opp & ~f
    lo = legal_mask(no, nc)      # opponent to move
    if variant == "nopass":
        ls = torch.zeros_like(lo)
    else:
        ls = legal_mask(nc, no)  # mover again (opponent passes)
    opp_has = lo != 0
    done = ~opp_has & (ls == 0)

    def pick(a_, b_, init):
        init = torch.full_like(a_, init)
        return torch.where(done, init, torch.where(opp_has, a_, b_))

    return (pick(no, nc, INIT_BLACK), pick(nc, no, INIT_WHITE),
            pick(lo, ls, INIT_LEGAL), done)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of ``m * x`` for a 32-bit constant ``m`` and
    int64 ``x`` in [0, 2^32), in 16-bit limbs so no product overflows."""
    part_lo = x * (m & 0xFFFF)          # < 2^48
    part_hi = x * (m >> 16)             # < 2^48
    hi = (part_hi + (part_lo >> 16)) >> 16
    lo = (((part_hi & 0xFFFF) << 16) + part_lo) & _M32
    return hi, lo


def philox4x32_10(ctr, key):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding
    32-bit words: ``ctr`` 4 words, ``key`` 2 words -> 4 words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def philox_words(seed: int, num_steps: int, n: int,
                 device) -> torch.Tensor:
    """The kernel's random words as int64 ``(num_steps, n)``: ply ``i`` of
    game ``g`` takes word ``i % 4`` of Philox(ctr=(i // 4, g >> 32, 0, 0),
    key=(seed, g))."""
    g = torch.arange(n, dtype=torch.int64, device=device)
    key = (torch.full_like(g, seed & _M32), g & _M32)
    zero = torch.zeros_like(g)
    rows = []
    for q in range((num_steps + 3) // 4):
        rows.extend(philox4x32_10((torch.full_like(g, q), g >> 32, zero,
                                   zero), key))
    return torch.stack(rows[:num_steps]) if rows else g.new_empty((0, n))


def rollout_chunk_plain(state: RolloutState, seed: int, num_steps: int,
                        words: torch.Tensor | None = None,
                        variant: str = "full"):
    """Plain version of K1 (and of K3 for another ``variant``):
    ``num_steps`` plies of ``ply``.  Returns ``(new_state, episodes)``
    with ``episodes`` an int64 0-d tensor."""
    n = state.cur.shape[0]
    if words is None:
        r_all = philox_words(seed, num_steps, n, state.cur.device)
    else:
        r_all = words.to(torch.int64) & _M32
    c, o, l = state.cur, state.opp, state.legal
    eps = torch.zeros((), dtype=torch.int64, device=c.device)
    for i in range(num_steps):
        c, o, l, done = ply(c, o, l, r_all[i], variant)
        eps = eps + done.sum()
    return RolloutState(cur=c, opp=o, legal=l), eps


# --- kernel wrapper ----------------------------------------------------------

LANES = (1, 2, 4, 8)
# One warp on each warp scheduler of an H100 SXM: 132 SMs x 4 x 32 threads.
SCHEDULER_THREADS = 132 * 4 * 32


def rollout_lanes(n: int) -> int:
    """Threads a game for a rollout of ``n`` games: the most lanes (1, 2,
    4 or 8) whose ``n * lanes`` threads still fit one warp on each of the
    H100's 528 warp schedulers (``SCHEDULER_THREADS``), and 1 once ``n``
    alone fills them.

    Why: a ply is a serial chain, and one warp per scheduler is what hides
    its latency best per instruction issued.  Fewer warps leave schedulers
    idle; a second warp on a scheduler brings the lanes' own costs (the
    sampler, Philox and the state updates that every lane repeats, and the
    reductions) without more overlap.  The grounds are the ``[rollout_lanes]``
    line of ``chip_smoke.py`` (ms per 512-ply chunk for every lanes at N
    1024 to 65,536), written down in PERF.md §5: at N 4096 Lanes 4 beats
    Lanes 8 and 1, at N 16,384 and 65,536 Lanes 1 is the fastest.  The rule
    and its thresholds were measured on the 132-SM H100 SXM only; a card
    with another SM count (an H100 PCIe has 114) gets the same lanes,
    unmeasured there."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    fitting = [lanes for lanes in LANES if n * lanes <= SCHEDULER_THREADS]
    return fitting[-1] if fitting else 1


# The lanes K3's stubbed variants and unroll 2/4 are built for besides 1:
# what rollout_lanes picks at the bench's N 4096.
BENCH_LANES = rollout_lanes(4096)
# Every (variant, unroll, lanes) that csrc/rollout.cu instantiates (its
# kBuilt rows): full at unroll 1 at every lanes, the profiler's other
# configurations at lanes 1 and BENCH_LANES.
BUILT = frozenset(
    [("full", 1, lanes) for lanes in LANES]
    + [(variant, unroll, lanes) for lanes in (1, BENCH_LANES)
       for variant, unroll in (("nosample", 1), ("noflips", 1),
                               ("nopass", 1), ("full", 2), ("full", 4))])


def built(variant: str, unroll: int = 1, lanes: int = 1) -> bool:
    """Whether ``csrc/rollout.cu`` instantiates this configuration."""
    return (variant, unroll, lanes) in BUILT


def _check_lanes(lanes: int) -> None:
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")


def _check(state: RolloutState, num_steps: int,
           words: torch.Tensor | None) -> None:
    t = (state.cur, state.opp, state.legal)
    if any(x.dtype != torch.int64 for x in t):
        raise TypeError("rollout state words must be int64")
    if any(x.dim() != 1 or x.shape != t[0].shape for x in t):
        raise ValueError("rollout state fields must be (N,) of one shape")
    if any(x.device != t[0].device for x in t):
        raise ValueError("rollout state fields on different devices")
    if num_steps < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")
    if words is not None:
        if words.dtype not in (torch.int32, torch.uint32):
            raise TypeError(f"words must be 32-bit, got {words.dtype}")
        if tuple(words.shape) != (num_steps, t[0].shape[0]):
            raise ValueError(f"words must be (num_steps, N) = "
                             f"{(num_steps, t[0].shape[0])}, got "
                             f"{tuple(words.shape)}")
        if words.device != t[0].device:
            raise ValueError("words and state on different devices")


def _launch(entry: str, state: RolloutState, seed: int, num_steps: int,
            words: torch.Tensor | None, episodes: torch.Tensor,
            *knobs: int) -> RolloutState:
    """One launch of the C entry ``entry`` on the state's card; ``knobs``
    go between the seed and the device (K1's lanes; K3's variant, unroll,
    threads, lanes)."""
    device = state.cur.device
    if device.type != "cuda":
        raise ValueError(f"the rollout kernels run on cpu or cuda, not "
                         f"{device}")
    tensors = [state.cur, state.opp, state.legal, episodes]
    if words is not None:
        tensors.append(words)
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the rollout kernels need contiguous tensors")
    if episodes.dtype != torch.int64 or episodes.device != device:
        raise ValueError("episodes must be an int64 tensor on the card")
    out = RolloutState(cur=torch.empty_like(state.cur),
                       opp=torch.empty_like(state.opp),
                       legal=torch.empty_like(state.legal))
    n = state.cur.shape[0]
    if n == 0:
        return out
    lib = _build.load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    _build.check(getattr(lib, entry)(
        state.cur.data_ptr(), state.opp.data_ptr(), state.legal.data_ptr(),
        out.cur.data_ptr(), out.opp.data_ptr(), out.legal.data_ptr(),
        episodes.data_ptr(), None if words is None else words.data_ptr(),
        n, num_steps, seed & _M32, *knobs, device.index, stream), entry)
    return out


def _new_episodes(state: RolloutState,
                  episodes: torch.Tensor | None) -> torch.Tensor:
    if episodes is None:
        return torch.zeros((), dtype=torch.int64, device=state.cur.device)
    return episodes


def rollout_chunk(state: RolloutState, seed: int, num_steps: int,
                  words: torch.Tensor | None = None,
                  episodes: torch.Tensor | None = None,
                  lanes: int | None = None):
    """Run ``num_steps`` random plies for every game in ONE kernel launch
    (Philox from ``seed``, or the injected ``words``), ``lanes`` threads a
    game (``None``: ``rollout_lanes(N)``; every lanes gives the same
    result).  Returns ``(new_state, episodes)``; ``episodes`` is an int64
    0-d tensor, and a given ``episodes`` tensor is added to in place."""
    _check(state, num_steps, words)
    if lanes is None:
        lanes = rollout_lanes(state.cur.shape[0])
    _check_lanes(lanes)
    episodes = _new_episodes(state, episodes)
    if state.cur.device.type == "cpu":
        new, eps = rollout_chunk_plain(state, seed, num_steps, words)
        episodes += eps
        return new, episodes
    out = _launch("otb_rollout", state, seed, num_steps, words, episodes,
                  lanes)
    if state.cur.numel():
        rollout_chunk.launches += 1
    return out, episodes


rollout_chunk.launches = 0


# K3's knobs: threads per block stands in for the TPU script's grid of
# 1, 2 or 4 programs.  Unroll 2 and 4 are built for ``full`` alone, the
# profiler's only unrolled configurations (``BUILT``).
THREADS = (32, 64, 128)
UNROLLS = (1, 2, 4)


def rollout_variant_chunk(state: RolloutState, seed: int, num_steps: int,
                          variant: str, unroll: int = 1, threads: int = 32,
                          lanes: int = BENCH_LANES,
                          words: torch.Tensor | None = None,
                          episodes: torch.Tensor | None = None):
    """K3: ``rollout_chunk`` with ``variant`` (one of ``VARIANTS``), the
    ply loop unrolled ``unroll`` times, ``threads`` per block, ``lanes``
    threads a game (default: K1's at the bench's N 4096), in ONE launch.
    Only the configurations of ``BUILT`` exist; another raises
    ``ValueError``.
    Philox is keyed by (seed, game), so no knob but ``variant`` changes
    the result.  CPU tensors take the plain loop (the knobs are checked,
    then have nothing to change).  Returns ``(new_state, episodes)`` as
    ``rollout_chunk`` does."""
    _check(state, num_steps, words)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if threads not in THREADS:
        raise ValueError(f"threads must be one of {THREADS}, got {threads}")
    if unroll not in UNROLLS:
        raise ValueError(f"unroll must be one of {UNROLLS}, got {unroll}")
    _check_lanes(lanes)
    if not built(variant, unroll, lanes):
        raise ValueError(f"variant {variant!r} at unroll {unroll}, lanes "
                         f"{lanes} is not built (ops/rollout.py BUILT)")
    episodes = _new_episodes(state, episodes)
    if state.cur.device.type == "cpu":
        new, eps = rollout_chunk_plain(state, seed, num_steps, words,
                                       variant)
        episodes += eps
        return new, episodes
    out = _launch("otb_rollout_variant", state, seed, num_steps, words,
                  episodes, VARIANTS.index(variant), unroll, threads, lanes)
    if state.cur.numel():
        rollout_variant_chunk.launches += 1
    return out, episodes


rollout_variant_chunk.launches = 0


def rollout_chunks(state: RolloutState, seed0: int, n_chunks: int,
                   num_steps: int, lanes: int | None = None):
    """``n_chunks`` chunks back to back, chunk ``i`` with seed
    ``seed0 + i`` (``rollout_chunks_scanned``): a host loop of launches
    into one episode counter, read once at the end (the only
    synchronisation).  ``lanes`` as for ``rollout_chunk``.  Returns
    ``(new_state, total_episodes)``."""
    total = torch.zeros((), dtype=torch.int64, device=state.cur.device)
    for i in range(n_chunks):
        state, total = rollout_chunk(state, seed0 + i, num_steps,
                                     episodes=total, lanes=lanes)
    return state, int(total.item())


# Seed offset a rank (JAX ``rollout_chunk_sharded``'s axis-index stride).
RANK_SEED_STRIDE = 7919


def rollout_chunk_sharded(state: RolloutState, seed: int, num_steps: int,
                          mesh, lanes: int | None = None):
    """K1 over a data-parallel mesh (JAX ``rollout_chunk_sharded``): each
    rank plays its own games ``state`` (its shard of the global batch) in
    ONE ``rollout_chunk`` launch at seed ``seed + rank * 7919``, then one
    ``all_reduce(SUM)`` gives every rank the global episode count.
    ``mesh``: a ``parallel.DataMesh``.  Returns ``(new local state,
    global episodes)``, the count an int64 0-d tensor on the state's
    device."""
    mesh = check_data_mesh(mesh)
    new, episodes = rollout_chunk(state, seed + mesh.rank * RANK_SEED_STRIDE,
                                  num_steps, lanes=lanes)
    all_reduce_sum([episodes], mesh)
    return new, episodes
