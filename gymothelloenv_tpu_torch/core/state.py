"""Environment configuration, the terminal rules of one ply and the plane
game state for any board size — the port of
``gymothelloenv_tpu/core/state.py``.

Conventions (identical to the reference): ``board`` is int8 ``(B, B)``
with +1 = white, -1 = black, 0 = empty; black moves first; ``turn`` is the
player to move (the last mover once the game has ended); observations are
canonical (``board * turn``); actions are flat indices ``row * B + col``.

Unlike JAX's unbatched functions, every function here is batched over a
leading ``(N,)`` games axis.  ``step`` sends the 8x8 board through the
bitboard rules (``ops.step.bit_step``: one launch of the ply kernel on the
card), as JAX's ``step`` sends it to ``_step_bitboard``; other sizes run
the plane rules of ``core/bitops.py``, one eager launch an operation.
"""

from __future__ import annotations

import dataclasses

import torch

from gymothelloenv_tpu_torch.core import bitops
from gymothelloenv_tpu_torch.utils.device import resolve_device

BLACK_DISK = -1
NO_DISK = 0
WHITE_DISK = 1


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static environment configuration (``OthelloBaseEnv.__init__``
    flags, othello.py:222-236)."""
    board_size: int = 8
    sudden_death_on_invalid_move: bool = True
    num_disk_as_reward: bool = False

    @property
    def num_actions(self) -> int:
        return self.board_size * self.board_size


@dataclasses.dataclass
class OthelloState:
    """Batched plane game state; every field has a leading ``(N,)`` axis."""
    board: torch.Tensor       # int8 (N, B, B); +1 white, -1 black, 0 empty
    turn: torch.Tensor        # int8 (N,) player to move (last mover if done)
    legal: torch.Tensor       # bool (N, B*B) legal actions for ``turn``
    terminated: torch.Tensor  # bool (N,)
    winner: torch.Tensor      # int8 (N,) +1 white, -1 black, 0 draw/ongoing


@dataclasses.dataclass
class StepResult:
    state: OthelloState
    obs: torch.Tensor         # int8 (N, B, B) canonical board
    reward: torch.Tensor      # float32 (N,) mover-perspective terminal
    done: torch.Tensor        # bool (N,)


def index_games(state, idx):
    """The games ``idx`` (an index tensor or a slice) of a batched state
    (any dataclass of tensors with a leading games axis)."""
    return type(state)(**{f.name: getattr(state, f.name)[idx]
                          for f in dataclasses.fields(state)})


def select_games(cond: torch.Tensor, new, old):
    """Field-wise ``where(cond, new, old)`` of two batched states of one
    type, ``cond`` (N,) broadcast over each field's trailing axes."""
    def pick(a, b):
        return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)),
                           a, b)
    return type(new)(**{f.name: pick(getattr(new, f.name),
                                     getattr(old, f.name))
                        for f in dataclasses.fields(new)})


def terminal_winner(terminated: torch.Tensor, sudden: torch.Tensor,
                    mover: torch.Tensor, white_cnt: torch.Tensor,
                    black_cnt: torch.Tensor) -> torch.Tensor:
    """int8 winner: the opponent of the mover after sudden death (an
    illegal move), else the sign of white minus black disks; 0 while the
    game goes on."""
    count_winner = torch.sign(white_cnt - black_cnt).to(torch.int8)
    winner = torch.where(sudden, (-mover).to(torch.int8), count_winner)
    return torch.where(terminated, winner, torch.zeros_like(winner))


def terminal_reward(terminated: torch.Tensor, sudden: torch.Tensor,
                    mover: torch.Tensor, winner: torch.Tensor,
                    mover_cnt: torch.Tensor, opp_cnt: torch.Tensor,
                    num_disk_as_reward: bool, cells: int) -> torch.Tensor:
    """float32 mover-perspective terminal reward (0 before the end):
    ``winner * mover``, or with ``num_disk_as_reward`` the disk margin,
    ``+cells`` (the board's ``B * B``) for a wipe-out and ``-cells`` for
    sudden death."""
    if num_disk_as_reward:
        reward = (mover_cnt - opp_cnt).to(torch.float32)
        reward = torch.where(opp_cnt == 0,
                             torch.full_like(reward, float(cells)), reward)
        reward = torch.where(sudden, torch.full_like(reward, -float(cells)),
                             reward)
    else:
        reward = (winner.to(torch.int32) * mover.to(torch.int32)).to(
            torch.float32)
    return torch.where(terminated, reward, torch.zeros_like(reward))


def initial_board(cfg: EnvConfig, device=None) -> torch.Tensor:
    """The central 4-disk setup, int8 ``(B, B)`` (othello.py:256-263)."""
    b = cfg.board_size
    c = b // 2
    board = torch.zeros((b, b), dtype=torch.int8,
                        device=resolve_device(device))
    board[c - 1, c - 1] = WHITE_DISK
    board[c, c] = WHITE_DISK
    board[c, c - 1] = BLACK_DISK
    board[c - 1, c] = BLACK_DISK
    return board


def disk_planes(board: torch.Tensor, turn: torch.Tensor):
    """Split signed boards ``(N, B, B)`` into ``(mine, opp)`` boolean
    planes for ``turn`` (N,)."""
    signed = board * turn.to(board.dtype)[:, None, None]
    return signed == 1, signed == -1


def legal_actions(board: torch.Tensor, turn: torch.Tensor) -> torch.Tensor:
    """bool ``(N, B*B)`` legal actions for ``turn`` (othello.py:313-343)."""
    mine, opp = disk_planes(board, turn)
    return bitops.legal_mask(mine, opp).flatten(1)


def reset(cfg: EnvConfig, n: int, device=None) -> OthelloState:
    """``n`` fresh games, black to move (othello.py:265-271)."""
    device = resolve_device(device)
    board = initial_board(cfg, device).expand(n, -1, -1).contiguous()
    turn = torch.full((n,), BLACK_DISK, dtype=torch.int8, device=device)
    return OthelloState(
        board=board, turn=turn, legal=legal_actions(board, turn),
        terminated=torch.zeros(n, dtype=torch.bool, device=device),
        winner=torch.zeros(n, dtype=torch.int8, device=device))


def observe(state: OthelloState) -> torch.Tensor:
    """Canonical observations: the current player's disks are +1
    (othello.py:363-369)."""
    return state.board * state.turn[:, None, None]


def observe_with_legal(state: OthelloState) -> torch.Tensor:
    """int8 ``(N, 2, B, B)``: the canonical board and the legal plane
    (``possible_actions_in_obs=True``, othello.py:370-376)."""
    return torch.stack([observe(state),
                        state.legal.reshape(state.board.shape).to(
                            torch.int8)], dim=1)


def count_disks(board: torch.Tensor):
    """``(white_count, black_count)``, int32 (N,) (othello.py:468-471)."""
    white = (board == WHITE_DISK).flatten(1).sum(1).to(torch.int32)
    black = (board == BLACK_DISK).flatten(1).sum(1).to(torch.int32)
    return white, black


def _step_bitboard(state: OthelloState, action: torch.Tensor,
                   cfg: EnvConfig) -> StepResult:
    """The 8x8 board through the bitboard rules: pack, one
    ``ops.step.bit_step`` (one ply-kernel launch on the card), unpack."""
    # Imported here: core.bitboard and ops.step build on this module.
    from gymothelloenv_tpu_torch.core import bitboard as bb
    from gymothelloenv_tpu_torch.ops import step as ply

    bits = bb.from_planes(state.board, state.turn, state.legal,
                          state.terminated, state.winner)
    res = ply.bit_step(bits, action.to(torch.int64),
                       cfg.sudden_death_on_invalid_move,
                       cfg.num_disk_as_reward)
    board = bb.to_board(res.state)
    new = OthelloState(board=board, turn=res.state.turn,
                       legal=bb.unpack_flat(res.state.legal),
                       terminated=res.state.terminated,
                       winner=res.state.winner)
    return StepResult(state=new, obs=observe(new), reward=res.reward,
                      done=res.done)


def step(state: OthelloState, action: torch.Tensor,
         cfg: EnvConfig) -> StepResult:
    """One ply for every game, bit-exact with JAX ``state.step``
    (othello.py:412-462): an illegal action leaves the board and is a
    sudden-death loss with ``sudden_death_on_invalid_move`` (else the
    mover forfeits the ply); a legal one places and flips; the game ends
    on sudden death, a full board or neither side able to move; a side
    without a move passes back; the terminal reward is from the mover's
    side.  ``action``: integer (N,); an index outside ``[0, B*B)`` is
    illegal.  A terminated game must not be stepped (see
    ``step_autoreset``)."""
    if cfg.board_size == 8:
        return _step_bitboard(state, action, cfg)
    b = cfg.board_size
    n = state.turn.shape[0]
    mover = state.turn
    action = action.to(torch.int64)
    in_range = (action >= 0) & (action < b * b)
    cells = torch.arange(b * b, device=action.device)
    onehot = (cells == action[:, None]).reshape(n, b, b)
    mine, opp = disk_planes(state.board, mover)
    valid = in_range & state.legal.gather(
        1, action.clamp(0, b * b - 1)[:, None])[:, 0]

    new_mine, new_opp = bitops.apply_move(onehot, mine, opp)
    keep = valid[:, None, None]
    mine = torch.where(keep, new_mine, mine)
    opp = torch.where(keep, new_opp, opp)
    m = mover[:, None, None]
    board = torch.where(mine, m, torch.where(opp, -m, torch.zeros_like(m)))

    board_full = (board != NO_DISK).flatten(1).all(1)
    if cfg.sudden_death_on_invalid_move:
        sudden = ~valid
    else:
        sudden = torch.zeros_like(valid)
    done_now = sudden | board_full

    # Both sides' legal moves in one flood over the stacked boards.
    both = bitops.legal_mask(torch.cat([opp, mine]),
                             torch.cat([mine, opp])).flatten(1)
    legal_opp, legal_same = both[:n], both[n:]
    opp_has = legal_opp.any(1)
    same_has = legal_same.any(1)
    terminated = done_now | (~opp_has & ~same_has)

    next_turn = torch.where(terminated | ~opp_has, mover, -mover)
    next_legal = torch.where(opp_has[:, None], legal_opp, legal_same)
    next_legal = next_legal & ~terminated[:, None]

    white_cnt, black_cnt = count_disks(board)
    winner = terminal_winner(terminated, sudden, mover, white_cnt, black_cnt)
    is_white = mover == WHITE_DISK
    reward = terminal_reward(
        terminated, sudden, mover, winner,
        torch.where(is_white, white_cnt, black_cnt),
        torch.where(is_white, black_cnt, white_cnt),
        cfg.num_disk_as_reward, b * b)
    new = OthelloState(board=board, turn=next_turn, legal=next_legal,
                       terminated=terminated, winner=winner)
    return StepResult(state=new, obs=observe(new), reward=reward,
                      done=terminated)


def step_autoreset(state: OthelloState, action: torch.Tensor,
                   cfg: EnvConfig) -> StepResult:
    """``step``; games the ply ends are fresh in the returned state while
    ``obs``/``reward``/``done`` describe the terminal transition.  Games
    terminated on entry are reset (their action ignored) with the fresh
    game's observation, reward 0 and ``done`` False."""
    n = state.turn.shape[0]
    fresh = reset(cfg, n, state.board.device)
    res = step(state, action, cfg)
    entry = state.terminated
    obs = torch.where(entry[:, None, None], observe(fresh), res.obs)
    reward = torch.where(entry, torch.zeros_like(res.reward), res.reward)
    done = res.done & ~entry
    return StepResult(state=select_games(done | entry, fresh, res.state),
                      obs=obs, reward=reward, done=done)
