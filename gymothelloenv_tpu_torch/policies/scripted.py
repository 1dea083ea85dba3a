"""Scripted baseline policies — the port of ``policies/scripted.py``:
random, greedy and depth-k maximin, and the ``make_policy`` factory.

Protocol: ``act(state, generator) -> int64 actions (N,)`` on a batched
state of either layout, a ``BitState`` (8x8 words) or a plane
``OthelloState`` (any board size); each policy dispatches on the state's
type (``core.engine.engine_of``), so the 8x8 bitboard policies run as
before.  Policies that need no randomness ignore ``generator``.

On planes, maximin keeps the reference's own search (JAX
scripted.py:66-145): a child's side to move is always the opponent of its
parent's (``_board_after`` flips the perspective with no bounce), and a
node whose side to move has no legal move is scored at once.  JAX expands
all ``B*B`` actions and masks the illegal ones; here only the legal
``(node, action)`` pairs are expanded, a level at a time (one host read a
level), which gives the same values and decisions.

On words, maximin expands its tree a level at a time through
``expand_legal`` (the ply kernel, ``ops.step.bit_step`` in plain mode: one
launch a level on the card, the plain ply on the CPU), stepping only the
legal ``(node, action)`` pairs, and reduces back with max/min as JAX's
``jnp.where(legal, vals, -+BIG)`` does (scripted.py:83-157).  A child's
moves for its side to move (the opponent of its parent's mover) are the
child's ``legal`` where its ``turn`` is that side, else none: the ply
kernel bounces the turn back when that side cannot move, and zeroes
``legal`` when the game ends.  A node without moves is scored at once,
the reference's pass quirk.
``expand_legal`` (on words or on planes) and the memory-bounded chunking
(``chunked``) also carry the value-lookahead search
(``train/ppo_trainer.lookahead_search``) at any board size.
"""

from __future__ import annotations

import functools

import torch

from gymothelloenv_tpu_torch.core import bitboard as bb
from gymothelloenv_tpu_torch.core import bitops
from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.engine import engine_of
from gymothelloenv_tpu_torch.core.state import (EnvConfig, OthelloState,
                                                disk_planes, index_games)
from gymothelloenv_tpu_torch.ops import step

_BIG = 1 << 20
# Device bytes a frontier node can hold while a level is expanded: the
# gathered parent state, the stepped child (words, small fields, reward),
# the pair index tensors and the plain ply's temporaries on the CPU, with
# room to spare.  A kept node (parent index and leaf value) costs 16.
NODE_BYTES = 512
_KEPT_BYTES = 16
# On planes a pair holds its child board and the flood's boolean planes
# while its level expands: bytes a cell of the board.
PLANE_NODE_BYTES_PER_CELL = 48
# The share of the card's free memory one expansion may take.
_FREE_SHARE = 0.5
# The budget on the CPU, where no free-memory reading is taken.
_CPU_BUDGET = 1 << 30


def random_policy(state, generator: torch.Generator | None = None
                  ) -> torch.Tensor:
    """Uniform sample over legal actions (RandomPolicy,
    simple_policies.py:21-44)."""
    return engine_of(state).random_legal(state, generator=generator)


def greedy_policy(state, generator: torch.Generator | None = None
                  ) -> torch.Tensor:
    """1-ply disk-count maximizer, ties to the lowest action index
    (GreedyPolicy, simple_policies.py:57-92)."""
    del generator
    return engine_of(state).greedy(state)


def memory_budget(device: torch.device) -> int:
    """Bytes a search may take: half the card's free memory
    (``torch.cuda.mem_get_info``), or 1 GiB on the CPU."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free * _FREE_SHARE)
    return _CPU_BUDGET


def expand_legal(nodes, legal: torch.Tensor,
                 cfg: EnvConfig = EnvConfig(), max_pairs: int | None = None):
    """One tree level: every legal ``(node, move)`` pair stepped from its
    node with the flags of ``cfg``.  On words (a ``BitState``) ``legal`` is
    int64 (M,) moves of each node and the pairs go through the ply kernel
    (one launch on the card); on planes (an ``OthelloState``) ``legal`` is
    bool (M, B*B) and the pairs go through ``core.state.step`` (at B = 8
    one launch of the ply kernel, else the plane rules).  Pairs come in
    node order, moves ascending within a node.  Returns ``(parent, action,
    child, reward)``: each pair's node index, its move (int64), the
    stepped state and the mover-perspective terminal reward; or ``None``
    when there are more than ``max_pairs`` pairs.  One host read: the
    number of pairs."""
    if isinstance(nodes, OthelloState):
        parent, action = legal.nonzero(as_tuple=True)
        if max_pairs is not None and parent.shape[0] > max_pairs:
            return None
        res = core.step(index_games(nodes, parent), action, cfg)
        return parent, action, res.state, res.reward
    counts = bb.popcount(legal)
    total = int(counts.sum())
    if max_pairs is not None and total > max_pairs:
        return None
    ends = torch.cumsum(counts, 0)
    k = torch.arange(total, device=legal.device)
    parent = torch.searchsorted(ends, k, right=True)
    action = bb.random_legal_bit(legal[parent], k - (ends - counts)[parent])
    res = step.bit_step(
        index_games(nodes, parent), action,
        sudden_death_on_invalid_move=cfg.sudden_death_on_invalid_move,
        num_disk_as_reward=cfg.num_disk_as_reward)
    return parent, action, res.state, res.reward


def _search(depth: int, state: bb.BitState, budget: int | None):
    """Decisions for every game of ``state``, or ``None`` when a level's
    frontier would not fit ``budget`` bytes (``None``: no limit).  One
    host read a level: the size of the next frontier."""
    n = state.turn.shape[0]
    me = state.turn
    game = torch.arange(n, device=me.device)
    nodes, legal = state, state.legal
    kept = 0
    levels = []                                 # (parent, action, leaf)
    for level in range(1, depth + 1):
        room = (None if budget is None else
                (budget - kept) // (_KEPT_BYTES + NODE_BYTES))
        got = expand_legal(nodes, legal, max_pairs=room)
        if got is None:
            return None
        parent, action, nodes, _ = got
        kept += _KEPT_BYTES * parent.shape[0]
        game = game[parent]
        mine = me[game]
        leaf = bb.popcount(torch.where(mine == 1, nodes.white, nodes.black))
        levels.append((parent, action, leaf))
        # The side to move at this level is me at even levels.
        persp = mine if level % 2 == 0 else -mine
        legal = torch.where(nodes.turn == persp, nodes.legal,
                            torch.zeros_like(nodes.legal))
    value = levels[-1][2]
    for level in range(depth - 1, 0, -1):
        parent, _, leaf = levels[level - 1]
        child_parent = levels[level][0]
        # A node at an odd level is the opponent's (min); a node without
        # children keeps its leaf value.
        value = leaf.scatter_reduce(0, child_parent, value,
                                    "amin" if level % 2 else "amax",
                                    include_self=False)
    parent, action, _ = levels[0]
    scores = torch.full((n, 64), -_BIG, dtype=value.dtype, device=me.device)
    scores[parent, action] = value
    return torch.argmax(scores, dim=1)


def _plane_search(depth: int, state: OthelloState, budget: int | None):
    """``_search`` on plane games (JAX ``maximin_action``'s recursion,
    batched over the legal pairs of a level): decisions for every game,
    or ``None`` when a level's frontier would not fit ``budget`` bytes.
    One host read a level: the number of pairs."""
    n, b = state.turn.shape[0], state.board.shape[-1]
    cells = b * b
    per_pair = _KEPT_BYTES + PLANE_NODE_BYTES_PER_CELL * cells
    me = state.turn
    game = torch.arange(n, device=me.device)
    board, persp, legal = state.board, state.turn, state.legal
    kept = 0
    levels = []                                 # (parent, action, leaf)
    index = torch.arange(cells, device=me.device)
    for level in range(1, depth + 1):
        total = int(legal.sum())
        if budget is not None and total > (budget - kept) // per_pair:
            return None
        parent, action = legal.nonzero(as_tuple=True)
        kept += _KEPT_BYTES * total
        onehot = (index == action[:, None]).reshape(total, b, b)
        p = persp[parent]
        mine, opp = bitops.apply_move(onehot,
                                      *disk_planes(board[parent], p))
        p = p[:, None, None]
        board = torch.where(mine, p, torch.where(opp, -p,
                                                 torch.zeros_like(p)))
        persp = -persp[parent]
        game = game[parent]
        leaf = (board == me[game][:, None, None]).flatten(1).sum(1)
        levels.append((parent, action, leaf))
        if level < depth:
            legal = bitops.legal_mask(*disk_planes(board, persp)).flatten(1)
    value = levels[-1][2]
    for level in range(depth - 1, 0, -1):
        _, _, leaf = levels[level - 1]
        # A node at an odd level is the opponent's (min); a node without
        # children keeps its leaf value.
        value = leaf.scatter_reduce(0, levels[level][0], value,
                                    "amin" if level % 2 else "amax",
                                    include_self=False)
    parent, action, _ = levels[0]
    scores = torch.full((n, cells), -_BIG, dtype=value.dtype,
                        device=me.device)
    scores[parent, action] = value
    return torch.argmax(scores, dim=1)


def chunked(search, state, expand_chunk: int = 0):
    """Run ``search(games, budget)`` (its result for the games of a
    batched state, a tensor or a tuple of tensors with a leading games
    axis, or ``None`` when ``budget`` bytes are too few) over the games of
    ``state`` in chunks, and concatenate.  ``expand_chunk``: 0 fits half
    the card's free memory (``torch.cuda.mem_get_info``; 1 GiB on the
    CPU), halving a chunk that does not fit; > 0 forces chunks of that
    many games; < 0 runs all games at once.  Games are independent, so
    the chunks never change a result."""
    n = state.turn.shape[0]
    if n == 0 or expand_chunk < 0:
        return search(state, None)
    if expand_chunk > 0:
        parts = [search(index_games(state, slice(i, i + expand_chunk)),
                        None) for i in range(0, n, expand_chunk)]
    else:
        budget = memory_budget(state.turn.device)
        done, todo = [], [(0, n)]
        while todo:
            lo, hi = todo.pop()
            got = search(index_games(state, slice(lo, hi)),
                         budget if hi - lo > 1 else None)
            if got is None:
                mid = (lo + hi) // 2
                todo += [(mid, hi), (lo, mid)]
            else:
                done.append((lo, got))
        parts = [got for _, got in sorted(done, key=lambda p: p[0])]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def maximin_action(state, depth: int,
                   expand_chunk: int = 0) -> torch.Tensor:
    """Depth-``depth`` maximin on disk count, no alpha-beta (MaxiMinPolicy,
    simple_policies.py:98-163; JAX ``maximin_action``): the root is a max
    node, ties go to the lowest action index, and a node whose side to
    move has no move is scored at once.  int64 (N,); a game without a
    legal move gets action 0.

    ``expand_chunk``: 0 splits the games so each expansion fits half the
    card's free memory (``torch.cuda.mem_get_info``; 1 GiB on the CPU),
    halving a chunk whose next frontier would not fit; > 0 forces chunks
    of that many games; < 0 expands all games at once.  Chunks never
    change a decision."""
    if depth < 1:
        raise ValueError(f"maximin depth must be >= 1, got {depth}")
    search = (_plane_search if isinstance(state, OthelloState)
              else _search)
    return chunked(functools.partial(search, depth), state, expand_chunk)


def maximin_policy(depth: int, expand_chunk: int = 0):
    """``maximin_action`` as a tournament policy."""
    @functools.wraps(maximin_action)
    def act(state, generator: torch.Generator | None = None
            ) -> torch.Tensor:
        del generator
        return maximin_action(state, depth, expand_chunk)
    return act


def make_policy(name: str, search_depth: int = 1, expand_chunk: int = 0):
    """Policy factory for the scripted zoo (``create_policy``,
    run.py:11-25): ``rand``, ``greedy`` or ``maximin`` at
    ``search_depth``."""
    if name == "rand":
        return random_policy
    if name == "greedy":
        return greedy_policy
    if name == "maximin":
        return maximin_policy(search_depth, expand_chunk)
    raise ValueError(f"unknown scripted policy: {name!r}")
