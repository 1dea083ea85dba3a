"""Reference-API environment classes (drop-in for ``othello.py``) — the
port of ``compat/envs.py``.

Host-side wrappers with the reference's Gym-style interface,
``OthelloBaseEnv`` / ``SimpleOthelloEnv`` / ``OthelloEnv``
(othello.py:21-501): numpy observations, ``possible_moves`` lists,
``player_turn`` ints, the print side effects, and the
``np.random.RandomState`` opening draws in the reference's exact order.
Every rules computation is the port's plane rules on a batch of one game
(``core/state.py``: ``reset``, ``step``, ``legal_actions``; on 8x8
``step`` goes through the ply kernel, one launch a ply on the card), on
``device`` (default the current CUDA card; ``device="cpu"`` on the CPU).
After each reset or step the game's board, turn, legal moves, end flag
and winner come to the host in one copy.

As JAX's, this module is a parity shim: its ``step``/``reset`` control
flow tracks othello.py:60-214 statement by statement, since the
``RandomState`` call order, the retry and opponent-move sequencing and
the prints are what make it a drop-in; for throughput use the batched
engines (``core/engine.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from gymothelloenv_tpu_torch.core import state as core
from gymothelloenv_tpu_torch.core.state import EnvConfig, OthelloState
from gymothelloenv_tpu_torch.utils.device import resolve_device

BLACK_DISK = -1
NO_DISK = 0
WHITE_DISK = 1


class OthelloBaseEnv:
    """A host-side single game over the port's rules (othello.py:
    217-501)."""

    metadata = {"render.modes": ["np_array", "human"]}

    def __init__(self, board_size=8, sudden_death_on_invalid_move=True,
                 num_disk_as_reward=False, possible_actions_in_obs=False,
                 mute=False, device=None):
        self.board_size = max(4, board_size)
        self.sudden_death_on_invalid_move = sudden_death_on_invalid_move
        self.num_disk_as_reward = num_disk_as_reward
        self.possible_actions_in_obs = possible_actions_in_obs
        self.mute = mute
        self.device = resolve_device(device)
        self.cfg = EnvConfig(
            board_size=self.board_size,
            sudden_death_on_invalid_move=sudden_death_on_invalid_move,
            num_disk_as_reward=num_disk_as_reward)
        self._state: OthelloState = None
        self.reset()

    def _set_state(self, state: OthelloState, reward=None) -> float:
        """Keep ``state`` and its host copy; returns ``reward`` (a (1,)
        tensor, or 0) as a float.  One device-to-host copy: every field
        is a small integer, exact in float32."""
        self._state = state
        cells = self.board_size ** 2
        if reward is None:
            reward = torch.zeros(1, device=self.device)
        packed = torch.cat([
            state.board[0].reshape(-1).to(torch.float32),
            state.legal[0].to(torch.float32),
            torch.stack([state.turn[0], state.terminated[0],
                         state.winner[0]]).to(torch.float32),
            reward.to(torch.float32)]).cpu().numpy()
        self._board = packed[:cells].astype(np.int64).reshape(
            self.board_size, self.board_size)
        self._moves = np.nonzero(packed[cells:2 * cells])[0].tolist()
        self._turn, self._terminated, self._winner = (
            int(x) for x in packed[2 * cells:2 * cells + 3])
        return float(packed[-1])

    # -- accessors mirroring the reference attributes -------------------
    @property
    def board_state(self) -> np.ndarray:
        return self._board.copy()

    @property
    def player_turn(self) -> int:
        return self._turn

    @property
    def possible_moves(self):
        return list(self._moves)

    @property
    def terminated(self) -> bool:
        return bool(self._terminated)

    @property
    def winner(self) -> int:
        return self._winner

    # -- API ------------------------------------------------------------
    def reset(self):
        self._set_state(core.reset(self.cfg, 1, self.device))
        return self.get_observation()

    def get_observation(self):
        obs = self.board_state * self.player_turn
        if self.possible_actions_in_obs:
            grid = np.zeros(self.board_size ** 2, dtype=bool)
            grid[self.possible_moves] = True
            return np.concatenate(
                [obs[None], grid.reshape(1, self.board_size,
                                         self.board_size)], axis=0)
        return obs

    def set_board_state(self, board_state, perspective=WHITE_DISK):
        """othello.py:380-389; recomputes the legal mask for the current
        turn."""
        state = np.asarray(board_state)
        if state.ndim > 2:
            state = state[0]
        board = torch.as_tensor(state * perspective, dtype=torch.int8,
                                device=self.device)[None]
        self._set_state(OthelloState(
            board=board, turn=self._state.turn,
            legal=core.legal_actions(board, self._state.turn),
            terminated=self._state.terminated, winner=self._state.winner))

    def set_player_turn(self, turn):
        turn = torch.tensor([turn], dtype=torch.int8, device=self.device)
        self._set_state(OthelloState(
            board=self._state.board, turn=turn,
            legal=core.legal_actions(self._state.board, turn),
            terminated=self._state.terminated, winner=self._state.winner))

    def count_disks(self):
        b = self.board_state
        return int((b == WHITE_DISK).sum()), int((b == BLACK_DISK).sum())

    def step(self, action):
        if self.terminated:
            raise ValueError("Game has terminated!")
        pre_moves = self.possible_moves
        res = core.step(self._state, torch.tensor(
            [int(action)], dtype=torch.int64, device=self.device), self.cfg)
        reward = self._set_state(res.state, res.reward)
        done = self.terminated
        if done and not self.mute:
            self._print_outcome(int(action) not in pre_moves)
        # A turn that bounces back (the opponent had no move) prints
        # nothing; the reference's 'No possible moves for either party.'
        # fires only at the stuck terminal (_print_outcome).
        return (self.get_observation(), reward, done, None)

    def _print_outcome(self, invalid_action):
        sudden = invalid_action and self.sudden_death_on_invalid_move
        if sudden:
            print("sudden death due to rule violation")
            print("BLACK wins" if self.winner == BLACK_DISK
                  else "WHITE wins")
            return
        w, b = self.count_disks()
        if w + b < self.board_size ** 2:
            print("No possible moves for either party.")
        print(f"white: {w}, black: {b}")
        if self.winner == WHITE_DISK:
            print("WHITE wins")
        elif self.winner == BLACK_DISK:
            print("BLACK wins")
        else:
            print("DRAW")

    def print_board(self, print_valid_moves=True):
        """ASCII board (othello.py:345-361)."""
        valid_actions = self.possible_moves
        board = self.board_state.copy().ravel()
        if print_valid_moves:
            for p in valid_actions:
                board[p] = 2
        board = board.reshape(self.board_size, self.board_size)
        print("Turn: {}".format(
            "WHITE" if self.player_turn == WHITE_DISK else "BLACK"))
        print("Valid actions: {}".format(valid_actions))
        for row in board:
            print(" ".join("BOWV"[int(x) + 1] for x in row))
        print("-" * 10)

    def render(self, mode="np_array", close=False):
        if close:
            return
        # The reference's pyglet GUI is broken in its snapshot
        # (othello.py:5 commented import); ASCII is the working path for
        # both modes.
        self.print_board()

    def close(self):
        pass


class SimpleOthelloEnv:
    """othello.py:21-93 — the base env and a per-reset random-opening
    counter with the reference's exact RandomState draw order."""

    metadata = {"render.modes": ["np_array", "human"]}

    def __init__(self, board_size=8, initial_rand_steps=0, seed=0,
                 sudden_death_on_invalid_move=True, render_in_step=False,
                 num_disk_as_reward=False, possible_actions_in_obs=False,
                 mute=False, device=None):
        self.board_size = board_size
        self.num_disk_as_reward = num_disk_as_reward
        self.env = OthelloBaseEnv(
            board_size=board_size,
            sudden_death_on_invalid_move=sudden_death_on_invalid_move,
            num_disk_as_reward=num_disk_as_reward,
            possible_actions_in_obs=possible_actions_in_obs,
            mute=mute, device=device)
        self.mute = mute
        self.render_in_step = render_in_step
        self.initial_rand_steps = initial_rand_steps
        self.rand_seed = seed
        self.rnd = np.random.RandomState(seed=self.rand_seed)
        self.max_rand_steps = 0
        self.rand_step_cnt = 0
        self.sudden_death_on_invalid_move = sudden_death_on_invalid_move

    def seed(self, seed=None):
        if seed is not None:
            self.rand_seed = seed
            self.rnd = np.random.RandomState(seed=self.rand_seed)

    def reset(self):
        obs = self.env.reset()
        self.max_rand_steps = self.rnd.randint(
            low=0, high=self.initial_rand_steps // 2 + 1) * 2
        self.rand_step_cnt = 0
        if not self.mute:
            print("The initial {} steps will be random".format(
                self.max_rand_steps))
        return obs

    def step(self, action):
        if self.rand_step_cnt < self.max_rand_steps:
            ix = self.rnd.randint(0, len(self.possible_moves))
            action = self.possible_moves[ix]
            self.rand_step_cnt += 1
        obs, reward, done, _ = self.env.step(action)
        if self.render_in_step:
            self.render()
        return obs, reward, done, None

    def render(self, mode="np_array", close=False):
        self.env.render(mode=mode, close=close)

    def close(self):
        self.env.close()

    @property
    def player_turn(self):
        return self.env.player_turn

    @property
    def possible_moves(self):
        return self.env.possible_moves


class OthelloEnv:
    """othello.py:96-214 — the embedded-opponent env: the opponent policy
    plays inside ``step``; rewards are the protagonist's (negated when the
    opponent's reply ended the exchange)."""

    metadata = {"render.modes": ["np_array", "human"]}

    def __init__(self, white_policy=None, black_policy=None,
                 protagonist=WHITE_DISK, board_size=8,
                 initial_rand_steps=0, seed=0,
                 sudden_death_on_invalid_move=True, render_in_step=False,
                 num_disk_as_reward=False, possible_actions_in_obs=False,
                 mute=False, device=None):
        self.board_size = board_size
        self.num_disk_as_reward = num_disk_as_reward
        self.env = OthelloBaseEnv(
            board_size=board_size,
            sudden_death_on_invalid_move=sudden_death_on_invalid_move,
            num_disk_as_reward=num_disk_as_reward,
            possible_actions_in_obs=possible_actions_in_obs,
            mute=mute, device=device)
        self.mute = mute
        self.render_in_step = render_in_step
        self.initial_rand_steps = initial_rand_steps
        self.rand_seed = seed
        self.rnd = np.random.RandomState(seed=self.rand_seed)
        self.max_rand_steps = 0
        self.rand_step_cnt = 0
        self.protagonist = protagonist
        self._white_policy = white_policy
        self._black_policy = black_policy
        if self.protagonist == BLACK_DISK:
            self.opponent = white_policy
        else:
            self.opponent = black_policy

    def switch_color(self):
        # As the reference (othello.py:138-142), only the protagonist
        # colour flips: ``self.opponent`` keeps pointing at the same
        # policy object, which now plays the other colour.
        if self.protagonist == BLACK_DISK:
            self.protagonist = WHITE_DISK
        else:
            self.protagonist = BLACK_DISK

    def seed(self, seed=None):
        if seed is not None:
            self.rand_seed = seed
            self.rnd = np.random.RandomState(seed=self.rand_seed)
            if self.opponent is not None and hasattr(self.opponent, "seed"):
                self.opponent.seed(self.rand_seed)

    def reset(self):
        obs = self.env.reset()
        self.max_rand_steps = self.rnd.randint(
            low=0, high=self.initial_rand_steps // 2 + 1) * 2
        self.rand_step_cnt = 0
        if not self.mute:
            print("The initial {} steps will be random".format(
                self.max_rand_steps))
        if hasattr(self.opponent, "reset"):
            try:
                self.opponent.reset(self)
            except TypeError:
                pass
        if self.env.player_turn == self.protagonist:
            return obs
        action = self.opponent.get_action(obs)
        obs, _, done, _ = self.env.step(action)
        if done:
            if not self.mute:
                print("done==True in reset(), do it again.")
            return self.reset()
        return obs

    def step(self, action):
        assert self.env.player_turn == self.protagonist
        if self.rand_step_cnt < self.max_rand_steps:
            ix = self.rnd.randint(0, len(self.possible_moves))
            action = self.possible_moves[ix]
            self.rand_step_cnt += 1

        obs, reward, done, _ = self.env.step(action)
        if self.render_in_step:
            self.render()
        if done:
            return obs, reward, done, None

        while not done and self.env.player_turn != self.protagonist:
            if self.rand_step_cnt < self.max_rand_steps:
                ix = self.rnd.randint(0, len(self.possible_moves))
                opponent_move = self.possible_moves[ix]
                self.rand_step_cnt += 1
            else:
                opponent_move = self.opponent.get_action(obs)
            obs, reward, done, _ = self.env.step(opponent_move)
            if self.render_in_step:
                self.render()
        return obs, -reward, done, None

    def render(self, mode="np_array", close=False):
        self.env.render(mode=mode, close=close)

    def close(self):
        self.env.close()

    @property
    def player_turn(self):
        return self.env.player_turn

    @property
    def possible_moves(self):
        return self.env.possible_moves
