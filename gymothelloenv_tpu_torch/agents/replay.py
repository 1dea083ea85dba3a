"""Experience replay on the device: a uniform ring buffer and proportional
prioritized replay — the port of ``agents/replay.py``.

The prioritized variant keeps the reference's SumTree semantics (SumTree.py
and dqn.py ``Memory``): proportional sampling over stratified segments
(dqn.py:49-63), priority ``(|err| + e) ** a`` (dqn.py:38-39), new samples
inserted at the running maximum priority (dqn.py:311, :66-69).  Sampling
keeps JAX's arithmetic: targets ``(i + u) * total / batch``, prefix sums
within 1024-slot blocks and over the blocks, and a search by counting
(``count(prefix < target)``) with the final clip, so the indices equal
JAX's whenever the priorities are exactly representable (JAX computes the
block prefix with a triangular matmul, here ``torch.cumsum``; both are
exact on such priorities).

Each field is its own tensor (boards as int8 with the turn, not float
planes; JAX's byte-packed rows are a TPU layout).  Row ``capacity`` is a
scratch row that takes the masked (invalid) writes.  Every counter stays
on the device, so no call reads back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

_PER_BLOCK = 1024
FIELDS = ("board", "turn", "action", "reward", "next_board", "next_turn",
          "done")


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    capacity: int = 1_000_000     # dqn.py:176 replay_memory_size
    board_size: int = 8
    prioritized: bool = False
    priority_e: float = 0.01      # dqn.py:31-32
    priority_a: float = 0.6


@dataclasses.dataclass
class Replay:
    """Ring buffer of ``(s, a, r, s', done)``, one row a transition, rows
    ``0..capacity-1`` plus the scratch row ``capacity``."""
    board: torch.Tensor        # int8 (C+1, B, B)
    turn: torch.Tensor         # int8 (C+1,)
    action: torch.Tensor       # int32 (C+1,)
    reward: torch.Tensor       # float32 (C+1,)
    next_board: torch.Tensor   # int8 (C+1, B, B)
    next_turn: torch.Tensor    # int8 (C+1,)
    done: torch.Tensor         # bool (C+1,)
    priority: torch.Tensor     # float32 (C+1,) (unused when uniform)
    max_priority: torch.Tensor  # float32 () running max (dqn.py:36, :66-69)
    write_pos: torch.Tensor    # int64 () next slot
    size: torch.Tensor         # int64 () filled rows (<= capacity)


def replay_init(cfg: ReplayConfig, device=None) -> Replay:
    c, b = cfg.capacity + 1, cfg.board_size

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return Replay(board=z((c, b, b), torch.int8), turn=z((c,), torch.int8),
                  action=z((c,), torch.int32), reward=z((c,), torch.float32),
                  next_board=z((c, b, b), torch.int8),
                  next_turn=z((c,), torch.int8), done=z((c,), torch.bool),
                  priority=z((c,), torch.float32),
                  max_priority=torch.ones((), device=device),
                  write_pos=z((), torch.int64), size=z((), torch.int64))


def replay_insert(rb: Replay, cfg: ReplayConfig, board, turn, action,
                  reward, next_board, next_turn, done, valid) -> Replay:
    """Masked batch insert of K transitions, in place: the valid ones take
    consecutive ring slots from ``write_pos``, the others the scratch
    row, each at the running maximum priority."""
    c = cfg.capacity
    offsets = torch.cumsum(valid.to(torch.int64), 0) - 1
    idx = torch.where(valid, (rb.write_pos + offsets) % c,
                      torch.full_like(offsets, c))
    new = {"board": board, "turn": turn, "action": action,
           "reward": reward, "next_board": next_board,
           "next_turn": next_turn, "done": done}
    for f in FIELDS:
        col = getattr(rb, f)
        col[idx] = new[f].to(col.dtype)
    rb.priority[idx] = rb.max_priority
    num = valid.sum()
    rb.write_pos = (rb.write_pos + num) % c
    rb.size = torch.clamp(rb.size + num, max=c)
    return rb


def insert_emitted(rb: Replay, cfg: ReplayConfig, emitted) -> torch.Tensor:
    """The n-step pushes' emissions ``emitted`` (each with ``FIELDS`` and
    ``valid`` as (slot, stream, ...) tensors) into the ring in JAX's
    order (push, then window slot, then stream); returns how many rows
    were valid (0-d)."""
    def flat(name):
        return torch.cat([getattr(e, name).reshape(
            (-1,) + getattr(e, name).shape[2:]) for e in emitted])
    valid = flat("valid")
    replay_insert(rb, cfg, *(flat(f) for f in FIELDS), valid)
    return valid.sum()


def replay_sample_idx(rb: Replay, cfg: ReplayConfig, u: torch.Tensor
                      ) -> torch.Tensor:
    """int64 indices, one per uniform in ``u`` (float32 (batch,)): uniform
    over the filled rows (``floor(u * size)``), or stratified proportional
    (Memory.sample, dqn.py:49-63) with JAX's block prefix sums and
    count-based search (replay.py:147-187)."""
    batch = u.shape[0]
    if not cfg.prioritized:
        size = rb.size.clamp(min=1)
        return torch.minimum((u * size).to(torch.int64), size - 1)
    c = cfg.capacity
    dev = u.device
    nrows = -(-c // _PER_BLOCK)
    prio = torch.zeros(nrows * _PER_BLOCK, dtype=torch.float32, device=dev)
    prio[:c] = rb.priority[:c]
    live = torch.arange(nrows * _PER_BLOCK, device=dev) < rb.size
    grid = torch.where(live, prio, torch.zeros_like(prio)).reshape(
        nrows, _PER_BLOCK)
    row_cum = torch.cumsum(grid, 1)
    block_tot = row_cum[:, -1]
    block_cum = torch.cumsum(block_tot, 0)
    block_off = block_cum - block_tot
    segment = block_cum[-1] / batch
    targets = (torch.arange(batch, dtype=torch.float32, device=dev)
               + u) * segment
    b_idx = (block_cum[None, :] < targets[:, None]).sum(-1).clamp(
        0, nrows - 1)
    t_in = targets - block_off[b_idx]
    within = (row_cum[b_idx] < t_in[:, None]).sum(-1)
    idx = b_idx * _PER_BLOCK + within
    return torch.minimum(idx, (rb.size - 1).clamp(min=0))


def replay_update_priorities(rb: Replay, cfg: ReplayConfig,
                             idx: torch.Tensor, errors: torch.Tensor
                             ) -> Replay:
    """Memory.update (dqn.py:65-69), in place: ``p = (|err| + e) ** a``;
    the running maximum follows."""
    p = (errors.abs() + cfg.priority_e) ** cfg.priority_a
    rb.priority[idx] = p
    rb.max_priority = torch.maximum(rb.max_priority, p.max())
    return rb


def replay_gather(rb: Replay, idx: torch.Tensor) -> tuple:
    """``(board, turn, action, reward, next_board, next_turn, done)`` at
    the rows ``idx``."""
    return tuple(getattr(rb, f)[idx] for f in FIELDS)


def pack_bytes(tensors, lead: int) -> torch.Tensor:
    """``tensors`` (equal first ``lead`` axes) as one uint8 tensor of
    their bytes, ``lead`` axes then one axis of every tensor's bytes in
    order: the rows a collective moves whole (JAX packs its replay rows
    the same way)."""
    parts = []
    for t in tensors:
        t = t.contiguous()
        flat = t.reshape(t.shape[:lead] + (-1,))
        parts.append(flat.view(torch.uint8))
    return torch.cat(parts, dim=-1)


def unpack_bytes(buf: torch.Tensor, like) -> tuple:
    """The inverse of ``pack_bytes``: ``like`` gives each tensor's dtype
    and trailing shape, ``buf``'s leading axes its leading ones."""
    out, start = [], 0
    lead = buf.shape[:-1]
    for dtype, shape in like:
        width = torch.empty((), dtype=dtype).element_size()
        for extent in shape:
            width *= extent
        part = buf[..., start:start + width].contiguous()
        out.append(part.view(dtype).reshape(lead + tuple(shape)))
        start += width
    return tuple(out)


def row_layout(board_size: int) -> tuple:
    """``(dtype, trailing shape)`` of each of ``FIELDS`` in a replay row."""
    b = board_size
    return ((torch.int8, (b, b)), (torch.int8, ()), (torch.int32, ()),
            (torch.float32, ()), (torch.int8, (b, b)), (torch.int8, ()),
            (torch.bool, ()))


def ring_rows(rb: Replay) -> torch.Tensor:
    """uint8 (capacity, row bytes): the ring's rows, its fields packed in
    ``FIELDS`` order (``pack_bytes``), without the scratch row (which
    holds whichever masked write came last)."""
    return pack_bytes([getattr(rb, f)[:-1] for f in FIELDS], 1)
