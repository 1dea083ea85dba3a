"""Bitboard rules for 8x8 boards on one 64-bit word per side — the port of
``gymothelloenv_tpu/core/bitboard.py``.

A side is a ``torch.int64`` tensor read as raw bits: bit ``k`` is cell
``k`` (row-major), the same numbering as the JAX word pair with
``word = w0 | w1 << 32``.  Torch's ``>>`` on int64 is an arithmetic shift
that smears bit 63, so every right shift goes through :func:`lsr`.

These are the plain PyTorch versions of the rules; they run on any device.
The hand-written kernels (``ops/legal_mask.py``, ``ops/rollout.py``,
``ops/step.py``) use the same Kogge-Stone floods in ``csrc/bitboard.cuh``.
A ply goes through the ply kernel's wrapper ``ops.step.bit_step`` (on a
CUDA tensor one launch of that kernel, which floods both legal masks
itself); ``bit_step_plain`` is its plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymothelloenv_tpu_torch.core.state import (select_games,
                                                terminal_reward,
                                                terminal_winner)
from gymothelloenv_tpu_torch.utils.device import resolve_device

DIRECTIONS = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)


def _i64(v: int) -> int:
    """Unsigned 64-bit constant -> the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


# Column masks for k-cell horizontal moves: a move towards higher columns
# wraps the low k columns of each row (clear them), a move towards lower
# columns wraps the high k.
_COL_HI = {1: _i64(0xFEFEFEFEFEFEFEFE), 2: _i64(0xFCFCFCFCFCFCFCFC),
           4: _i64(0xF0F0F0F0F0F0F0F0)}
_COL_LO = {1: 0x7F7F7F7F7F7F7F7F, 2: 0x3F3F3F3F3F3F3F3F,
           4: 0x0F0F0F0F0F0F0F0F}
_LOW32 = 0xFFFFFFFF

# Opening (othello.py:256-271): d4/e5 white (bits 27, 36), d5/e4 black
# (bits 28, 35); black's legal openings d3/c4/f5/e6 (bits 19, 26, 37, 44).
INIT_BLACK = (1 << 28) | (1 << 35)
INIT_WHITE = (1 << 27) | (1 << 36)
INIT_LEGAL = (1 << 19) | (1 << 26) | (1 << 37) | (1 << 44)


def lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits by ``k`` in [1, 63]."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def shift(x: torch.Tensor, dr: int, dc: int, k: int = 1) -> torch.Tensor:
    """Translate the bit set by ``k * (dr, dc)`` cells, dropping bits at
    the edges (``shift2k``); ``k`` in {1, 2, 4}."""
    s = (8 * dr + dc) * k
    if s > 0:
        x = x << s
    elif s < 0:
        x = lsr(x, -s)
    if dc == 1:
        x = x & _COL_HI[k]
    elif dc == -1:
        x = x & _COL_LO[k]
    return x


def fill(g: torch.Tensor, p: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """Kogge-Stone occluded flood (``_fill2``): the ``p`` cells reachable
    from a ``g`` cell by repeated ``(dr, dc)`` steps through ``p``."""
    g = g | (p & shift(g, dr, dc, 1))
    r = p & shift(p, dr, dc, 1)              # runs of >= 2 propagate
    g = g | (r & shift(g, dr, dc, 2))
    r = r & shift(r, dr, dc, 2)              # runs of >= 4 propagate
    g = g | (r & shift(g, dr, dc, 4))
    return g & p


def lane_directions(lane: int, lanes: int) -> tuple:
    """The directions that lane ``lane`` of a group of ``lanes`` threads
    floods in the rollout kernel: ``DIRECTIONS[lane::lanes]``.  Over the
    lanes of a group they partition the eight directions."""
    if lanes not in (1, 2, 4, 8) or not 0 <= lane < lanes:
        raise ValueError(f"lane {lane} of {lanes}: lanes must be 1, 2, 4 "
                         "or 8 and 0 <= lane < lanes")
    return DIRECTIONS[lane::lanes]


def legal_mask_lane(mine: torch.Tensor, opp: torch.Tensor, lane: int,
                    lanes: int) -> torch.Tensor:
    """Lane ``lane``'s share of ``legal_mask``: the placements found along
    ``lane_directions(lane, lanes)``.  OR over the lanes is the legal
    mask."""
    legal = torch.zeros_like(mine)
    for dr, dc in lane_directions(lane, lanes):
        legal = legal | shift(fill(mine, opp, dr, dc), dr, dc, 1)
    return legal & ~(mine | opp)


def legal_mask(mine: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """Legal placements for ``mine`` against ``opp`` (``legal_mask2``).
    This is the plain version of kernel K2 (``ops/legal_mask.py``)."""
    return legal_mask_lane(mine, opp, 0, 1)


def resolve_flips_lane(onehot: torch.Tensor, mine: torch.Tensor,
                       opp: torch.Tensor, lane: int,
                       lanes: int) -> torch.Tensor:
    """Lane ``lane``'s share of ``resolve_flips``: the flips along
    ``lane_directions(lane, lanes)``.  OR over the lanes is the flips."""
    flips = torch.zeros_like(mine)
    for dr, dc in lane_directions(lane, lanes):
        f = fill(onehot, opp, dr, dc)
        valid = (shift(f, dr, dc, 1) & mine) != 0
        flips = flips | torch.where(valid, f, torch.zeros_like(f))
    return flips


def resolve_flips(onehot: torch.Tensor, mine: torch.Tensor,
                  opp: torch.Tensor) -> torch.Tensor:
    """Disks flipped by placing at the single-bit ``onehot``
    (``resolve_flips2``)."""
    return resolve_flips_lane(onehot, mine, opp, 0, 1)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word, int64 (SWAR; no multiply, so nothing
    overflows)."""
    x = x - (lsr(x, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (lsr(x, 2) & 0x3333333333333333)
    x = (x + lsr(x, 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + lsr(x, 8)
    x = x + lsr(x, 16)
    x = x + lsr(x, 32)
    return x & 0x7F


def action_bit(action: torch.Tensor) -> torch.Tensor:
    """Flat action index -> single-bit word.  Out-of-range actions (e.g.
    64, or negative) give the empty word (illegal downstream)."""
    action = action.to(torch.int64)
    in_range = (action >= 0) & (action < 64)
    bit = torch.ones_like(action) << action.clamp(0, 63)
    return torch.where(in_range, bit, torch.zeros_like(bit))


def flip_counts(mine: torch.Tensor, opp: torch.Tensor) -> torch.Tensor:
    """int32 (..., 64): opponent disks a placement at each cell would flip
    (``bitops.flip_counts`` on words; meaningful at empty cells only)."""
    counts = torch.zeros(mine.shape + (64,), dtype=torch.int32,
                         device=mine.device)
    for dr, dc in DIRECTIONS:
        # s_j: cells p with p .. p+(j-1)d opponent and p+jd mine.
        s = opp & shift(mine, -dr, -dc)
        for j in range(1, 7):
            counts += j * unpack_flat(shift(s, -dr, -dc)).to(torch.int32)
            if j < 6:
                s = opp & shift(s, -dr, -dc)
    return counts


# --- layout conversion ------------------------------------------------------

def _bit_index(device) -> torch.Tensor:
    return torch.arange(64, dtype=torch.int64, device=device)


def unpack_flat(word: torch.Tensor) -> torch.Tensor:
    """int64 word (...,) -> bool (..., 64)."""
    return ((word[..., None] >> _bit_index(word.device)) & 1).bool()


def unpack(word: torch.Tensor) -> torch.Tensor:
    """int64 word (...,) -> bool planes (..., 8, 8)."""
    return unpack_flat(word).reshape(word.shape + (8, 8))


def pack(plane: torch.Tensor) -> torch.Tensor:
    """bool/int planes (..., 8, 8) -> int64 word (...,).  The bits are
    distinct, so the sum is their OR and wraps onto bit 63 exactly."""
    bits = plane.reshape(plane.shape[:-2] + (64,)).to(torch.int64) != 0
    return (bits.to(torch.int64) << _bit_index(plane.device)).sum(-1)


def pack_pair(pair) -> torch.Tensor:
    """JAX layout uint32 (..., 2) ``(w0, w1)`` -> int64 word (...,)."""
    a = np.asarray(pair).astype(np.uint64)
    word = a[..., 0] | (a[..., 1] << np.uint64(32))
    return torch.from_numpy(np.ascontiguousarray(word).view(np.int64))


def unpack_pair(word: torch.Tensor) -> np.ndarray:
    """int64 word (...,) -> JAX layout uint32 (..., 2)."""
    w = word.detach().cpu().numpy().astype(np.int64).view(np.uint64)
    return np.stack([w & np.uint64(_LOW32), w >> np.uint64(32)],
                    axis=-1).astype(np.uint32)


# ---------------------------------------------------------------------------
# Game state on words: the whole transition without planes.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BitState:
    """Batched 8x8 game state; every field has a leading ``(N,)`` axis."""
    black: torch.Tensor       # int64 black disks
    white: torch.Tensor       # int64 white disks
    turn: torch.Tensor        # int8 player to move (last mover if done)
    legal: torch.Tensor       # int64 legal placements for ``turn``
    terminated: torch.Tensor  # bool
    winner: torch.Tensor      # int8 (+1 white, -1 black, 0 draw/ongoing)


@dataclasses.dataclass
class BitStepResult:
    state: BitState
    reward: torch.Tensor      # float32 mover-perspective terminal reward
    done: torch.Tensor        # bool


def opening(n: int, device) -> BitState:
    """``n`` games at the opening, black to move, made without a kernel
    (the legal mask is the constant ``INIT_LEGAL``)."""
    def full(v, dtype):
        return torch.full((n,), v, dtype=dtype, device=device)

    return BitState(black=full(INIT_BLACK, torch.int64),
                    white=full(INIT_WHITE, torch.int64),
                    turn=full(-1, torch.int8),
                    legal=full(INIT_LEGAL, torch.int64),
                    terminated=full(False, torch.bool),
                    winner=full(0, torch.int8))


def bit_reset(n: int, device=None) -> BitState:
    """``n`` games at the opening, black to move, on ``device``
    (``opening``: the legal mask is the constant ``INIT_LEGAL``, so no
    kernel runs)."""
    return opening(n, resolve_device(device))


def from_planes(board: torch.Tensor, turn: torch.Tensor,
                legal: torch.Tensor, terminated: torch.Tensor,
                winner: torch.Tensor) -> BitState:
    """Plane state fields (``board`` int8 (N, 8, 8), ``legal`` bool
    (N, 64)) -> ``BitState`` (JAX ``from_planes``)."""
    return BitState(black=pack(board == -1), white=pack(board == 1),
                    turn=turn, legal=pack(legal.reshape(-1, 8, 8)),
                    terminated=terminated, winner=winner)


def to_board(state: BitState) -> torch.Tensor:
    """``BitState`` -> signed int8 boards (N, 8, 8) (JAX ``to_board``)."""
    return (unpack(state.white).to(torch.int8)
            - unpack(state.black).to(torch.int8))


def bit_step_plain(state: BitState, action: torch.Tensor,
                   sudden_death_on_invalid_move: bool = True,
                   num_disk_as_reward: bool = False,
                   do: torch.Tensor | None = None,
                   autoreset: bool = False) -> BitStepResult:
    """One ply for every game, bit-exact with ``bitboard.bit_step``
    (othello.py:412-462): the plain version of the ply kernel
    (``ops/step.py``), pure PyTorch on any device.

    With ``do``, games where ``~do`` keep their state and get reward 0 and
    ``done`` False (``BitEngine.step_where``).  With ``autoreset``, games
    the ply ends are at the opening in the returned state, while
    ``reward``/``done`` describe the terminal transition
    (``bitvec_step``)."""
    mover = state.turn
    is_white = mover == 1
    mine = torch.where(is_white, state.white, state.black)
    opp = torch.where(is_white, state.black, state.white)

    onehot = action_bit(action)
    valid = (state.legal & onehot) != 0
    flips = resolve_flips(onehot, mine, opp)
    mine = torch.where(valid, mine | onehot | flips, mine)
    opp = torch.where(valid, opp & ~flips, opp)

    board_full = popcount(mine | opp) == 64
    if sudden_death_on_invalid_move:
        sudden = ~valid
    else:
        sudden = torch.zeros_like(valid)
    done_now = sudden | board_full

    n = mine.shape[0]
    both = legal_mask(torch.cat([opp, mine]), torch.cat([mine, opp]))
    legal_opp, legal_same = both[:n], both[n:]
    opp_has = legal_opp != 0
    same_has = legal_same != 0
    terminated = done_now | (~opp_has & ~same_has)

    next_turn = torch.where(terminated | ~opp_has, mover, -mover)
    zero = torch.zeros_like(legal_opp)
    next_legal = torch.where(terminated, zero,
                             torch.where(opp_has, legal_opp, legal_same))

    mine_cnt = popcount(mine)
    opp_cnt = popcount(opp)
    white_cnt = torch.where(is_white, mine_cnt, opp_cnt)
    black_cnt = torch.where(is_white, opp_cnt, mine_cnt)
    winner = terminal_winner(terminated, sudden, mover, white_cnt, black_cnt)
    reward = terminal_reward(terminated, sudden, mover, winner, mine_cnt,
                             opp_cnt, num_disk_as_reward, 64)

    new = BitState(black=torch.where(is_white, opp, mine),
                   white=torch.where(is_white, mine, opp),
                   turn=next_turn, legal=next_legal,
                   terminated=terminated, winner=winner)
    if do is not None:
        return BitStepResult(
            state=select_games(do, new, state),
            reward=torch.where(do, reward, torch.zeros_like(reward)),
            done=do & terminated)
    if autoreset:
        new = select_games(terminated, opening(n, mine.device), new)
    return BitStepResult(state=new, reward=reward, done=terminated)


def reset_where_plain(state: BitState, done: torch.Tensor) -> BitState:
    """Games where ``done`` at the opening, the rest unchanged: the plain
    version of the ply kernel's ``reset_where``."""
    return select_games(done, opening(done.shape[0], done.device), state)


def uniform_index(count: torch.Tensor,
                  generator: torch.Generator | None = None,
                  u: torch.Tensor | None = None) -> torch.Tensor:
    """One uniform draw ``t`` in ``[0, max(count, 1))`` per row, int64,
    from float64 uniforms in [0, 1): ``u`` given, else drawn from
    ``generator``."""
    hi = count.clamp(min=1)
    if u is None:
        u = torch.rand(count.shape, generator=generator,
                       device=count.device, dtype=torch.float64)
    return torch.minimum((u * hi).to(torch.int64), hi - 1)


def random_legal_bit(legal: torch.Tensor,
                     t: torch.Tensor | None = None,
                     generator: torch.Generator | None = None
                     ) -> torch.Tensor:
    """The ``t``-th set bit (from bit 0) of each legal word -> flat action
    int64, by a 5-level prefix-popcount search (``random_legal_bit``).
    ``t`` in ``[0, popcount)`` is injected, or drawn uniformly from
    ``generator``.  Boards with no legal move give an arbitrary index."""
    if t is None:
        t = uniform_index(popcount(legal), generator)
    t = t.to(torch.int64)
    lo = legal & _LOW32
    n0 = popcount(lo)
    in_w1 = t >= n0
    t = torch.where(in_w1, t - n0, t)
    w = torch.where(in_w1, lsr(legal, 32), lo)
    pos = torch.zeros_like(t)
    for width in (16, 8, 4, 2, 1):
        cnt = popcount((w >> pos) & ((1 << width) - 1))
        skip = t >= cnt
        pos = torch.where(skip, pos + width, pos)
        t = torch.where(skip, t - cnt, t)
    return torch.where(in_w1, pos + 32, pos)
