"""Vectorized n-step transition windows — the port of ``agents/nstep.py``
(DQNAgent's n-step buffer, dqn.py:288-350, :469-473).

Each pushed transition enters its stream's FIFO; when the FIFO reaches
``n`` the oldest element is emitted as an n-step transition ``(s_0, a_0,
sum_k gamma^k r_k, s'_newest, done_newest)``; a terminal push flushes the
whole FIFO with shrinking windows (every element left emits against the
terminal next-state).  All streams advance in lockstep under masks; a push
emits at most ``n`` transitions a stream (the pop-on-full and the flush
exclude each other: a terminal push flushes everything, itself included).
The discounted suffix sums keep JAX's float32 steps: ``gamma ** arange(n)``
discounts and a running sum in FIFO order, each product added with one
rounding (``torch.addcmul``; XLA on the CPU fuses it into a multiply-add).
"""

from __future__ import annotations

import dataclasses

import torch

_FIELDS = ("board", "turn", "action", "reward", "next_board", "next_turn",
           "done")


@dataclasses.dataclass
class NStepFifo:
    """Per-stream FIFO, tensors ``(n, S, ...)``; index 0 is the oldest;
    ``count`` (S,) valid entries."""
    board: torch.Tensor        # int8 (n, S, B, B)
    turn: torch.Tensor         # int8 (n, S)
    action: torch.Tensor       # int32 (n, S)
    reward: torch.Tensor       # float32 (n, S)
    next_board: torch.Tensor   # int8 (n, S, B, B)
    next_turn: torch.Tensor    # int8 (n, S)
    done: torch.Tensor         # bool (n, S)
    count: torch.Tensor        # int32 (S,)


def nstep_init(n: int, num: int, board_size: int,
               device=None) -> NStepFifo:
    """Empty FIFOs of length ``n`` for ``num`` streams."""
    b = board_size

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    return NStepFifo(board=z((n, num, b, b), torch.int8),
                     turn=z((n, num), torch.int8),
                     action=z((n, num), torch.int32),
                     reward=z((n, num), torch.float32),
                     next_board=z((n, num, b, b), torch.int8),
                     next_turn=z((n, num), torch.int8),
                     done=z((n, num), torch.bool),
                     count=z((num,), torch.int32))


@dataclasses.dataclass
class Emitted:
    """``n`` emission slots a push, tensors ``(n, S, ...)``, masked by
    ``valid``; slot ``k`` is the window that starts at FIFO index ``k``."""
    board: torch.Tensor
    turn: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_board: torch.Tensor
    next_turn: torch.Tensor
    done: torch.Tensor
    valid: torch.Tensor


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask`` (n, S) broadcast over ``like``'s trailing axes."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 2))


def nstep_push(fifo: NStepFifo, gamma: float, board, turn, action, reward,
               next_board, next_turn, done, do):
    """Push one transition a stream where ``do`` (S,); returns the FIFO
    after the push and its emissions (``Emitted``)."""
    n, s = fifo.turn.shape
    dev = fifo.turn.device
    slots = torch.arange(n, device=dev)[:, None]            # (n, 1)
    # Append at index ``count``: a full FIFO pops below and a flush
    # empties it, so count < n before every push.
    at = (slots == fifo.count[None, :].to(torch.int64)) & do[None, :]
    new = {"board": board, "turn": turn,
           "action": action.to(torch.int32),
           "reward": reward.to(torch.float32), "next_board": next_board,
           "next_turn": next_turn, "done": done}
    fields = {f: torch.where(_rows(at, getattr(fifo, f)), new[f][None],
                             getattr(fifo, f)) for f in _FIELDS}
    count = torch.where(do, fifo.count + 1, fifo.count)      # post-push
    newest = (count - 1).clamp(min=0).to(torch.int64)
    flush = do & done                       # terminal push: emit all
    pop_one = do & ~done & (count == n)     # full: emit the oldest
    in_window = slots < count[None, :]
    valid = torch.where(flush[None, :], in_window,
                        (slots == 0) & pop_one[None, :])

    # R_k = sum_{j >= k, j < count} gamma^(j - k) r_j, in float32.
    r = torch.where(in_window, fields["reward"],
                    torch.zeros_like(fields["reward"]))
    discounts = torch.tensor(gamma, dtype=torch.float32, device=dev) ** \
        torch.arange(n, dtype=torch.float32, device=dev)
    sums = []
    for k in range(n):
        acc = torch.zeros(s, dtype=torch.float32, device=dev)
        for j in range(n):
            w = discounts[j - k] if j >= k else discounts.new_zeros(())
            acc = torch.addcmul(acc, w.expand(s), r[j])
        sums.append(acc)
    returns = torch.stack(sums)

    pick = torch.arange(s, device=dev)
    emitted = Emitted(
        board=fields["board"], turn=fields["turn"],
        action=fields["action"], reward=returns,
        next_board=fields["next_board"][newest, pick][None].expand_as(
            fields["next_board"]),
        next_turn=fields["next_turn"][newest, pick][None].expand_as(
            fields["next_turn"]),
        done=fields["done"][newest, pick][None].expand_as(fields["done"]),
        valid=valid)

    # A flush empties the FIFO; a pop shifts it left by one.
    rolled = {f: torch.where(_rows(pop_one[None, :].expand(n, s), v),
                             torch.roll(v, -1, 0), v)
              for f, v in fields.items()}
    count = torch.where(flush, torch.zeros_like(count),
                        torch.where(pop_one, torch.full_like(count, n - 1),
                                    count))
    return NStepFifo(**rolled, count=count), emitted
