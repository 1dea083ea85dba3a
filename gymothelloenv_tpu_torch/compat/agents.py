"""Reference-API learned agents — the port of ``compat/agents.py``:
``PPO`` (ppo.py:111-334), ``DQNAgent`` (dqn.py:135-503) and ``Rainbow``
(the class util.py:6 imports from an absent package), with the
duck-typed driver protocol ``reset(env)``, ``get_action(state)``,
``get_test_action(state)``, ``run(s, a, r, done, s')`` and
``save``/``load``.

These are the single-env host loops of the reference's drivers
(run.py, run_2agent.py, run_self_play.py); the batched trainers
(``train/simple_ppo_trainer.py``, ``train/dqn_trainer.py``,
``train/rainbow_trainer.py``) compute the same things for many games at
once.  The global ``np.random`` draws of acting (PPO's
``np.random.choice``, DQN's epsilon test and random move) are in JAX's
order; where JAX splits a key (an update's permutations, a replay
sample, Rainbow's noise) these take a ``train.self_play.Draws`` over a
torch generator seeded from ``seed + 1``.  The nets and the replay live
on ``device`` (default the current CUDA card).  Checkpoints are JAX's
files (flax msgpack).
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from gymothelloenv_tpu_torch.agents.dqn import (DQNConfig, dqn_init,
                                                dqn_train_batch, epsilon_at,
                                                maybe_sync_target)
from gymothelloenv_tpu_torch.agents.ppo import Transition
from gymothelloenv_tpu_torch.agents.replay import (ReplayConfig, replay_init,
                                                   replay_insert)
from gymothelloenv_tpu_torch.agents.simple_ppo import (
    SimplePPOConfig, make_simple_ppo_optimizer, simple_ppo_update)
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (flax_tree,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.train.self_play import Draws
from gymothelloenv_tpu_torch.train.simple_ppo_trainer import \
    make_actor_critic
from gymothelloenv_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from gymothelloenv_tpu_torch.utils.device import (resolve_device,
                                                  use_float32)


def _unwrap(env):
    return env.env if hasattr(env, "env") else env


def _save(path, step, net, optimizer, extra) -> None:
    to_tree = functools.partial(flax_tree, net)
    save_checkpoint(path, step, to_tree(),
                    optimizer.to_optax_state(to_tree), extra=extra)


def _load(path, net, optimizer):
    """Params and optimizer state of a checkpoint into ``net`` and
    ``optimizer``; returns ``(step, extra)``."""
    step, params, opt_state, extra = load_checkpoint(path)
    tensors = tensors_from_flax(net, params)
    optimizer.load_optax_state(opt_state,
                               functools.partial(tensors_from_flax, net))
    with torch.no_grad():
        for p, t in zip(net.parameters(), tensors):
            p.copy_(t)
    return step, extra


class PPO:
    """The standalone PPO agent with the reference protocol
    (ppo.py:111-334) on ``ActorCriticNet`` and ``agents/simple_ppo.py``:
    an update every ``update_timestep`` stored transitions."""

    def __init__(self, agent_name="ppo", board_size=8, state_channels=4,
                 lr=0.001, betas=(0.9, 0.999), gamma=0.99, K_epochs=5,
                 eps_clip=0.2, update_timestep=2000, batch_size=256,
                 random_seed=0, device=None):
        self.agent_name = agent_name
        self.board_size = board_size
        self.num_action = board_size ** 2
        self.cfg = SimplePPOConfig(
            lr=lr, betas=betas, gamma=gamma, k_epochs=K_epochs,
            eps_clip=eps_clip, update_timestep=update_timestep,
            batch_size=batch_size)
        self.env = None
        self.device = resolve_device(device)
        use_float32()
        self.net = make_actor_critic(EnvConfig(board_size=board_size),
                                     random_seed, self.device,
                                     in_channels=state_channels)
        self.optimizer = make_simple_ppo_optimizer(self.cfg,
                                                   self.net.parameters())
        self.memory = {k: [] for k in
                       ("states", "actions", "logprobs", "rewards",
                        "dones")}
        self.timestep = 0
        self.episode = 0
        self.avg_loss = 0.0
        self.total_reward = 0.0
        self.duration = 0
        self.start = time.time()
        self._shuffle = torch.Generator().manual_seed(random_seed + 1)

    def reset(self, env):
        self.env = _unwrap(env)

    @torch.no_grad()
    def _logits(self, state) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(state, np.float32),
                            device=self.device)[None]
        return self.net(x)[0][0]

    # -- acting ---------------------------------------------------------
    def _masked_probs(self, state):
        probs = torch.softmax(self._logits(state), -1).cpu().numpy()
        moves = self.env.possible_moves
        p = probs[moves]
        p = p / (p.sum() + 1e-60)
        if p.sum() == 0 or np.isnan(p).any():
            p = np.full(len(moves), 1.0 / len(moves))
        else:
            p = p / p.sum()
        return moves, p

    def get_action(self, state):
        moves, p = self._masked_probs(state)
        return int(np.random.choice(moves, p=p))

    def get_test_action(self, state):
        return self.get_action(state)

    # -- learning -------------------------------------------------------
    def run(self, state, action, reward, done, next_state):
        self.timestep += 1
        self.duration += 1
        self.total_reward += reward
        logp = float(torch.log_softmax(self._logits(state), -1)[int(action)])
        self.memory["states"].append(np.asarray(state, np.float32))
        self.memory["actions"].append(int(action))
        self.memory["logprobs"].append(logp)
        self.memory["rewards"].append(float(reward))
        self.memory["dones"].append(bool(done))

        if self.timestep % self.cfg.update_timestep == 0:
            self.avg_loss = self._do_update()
            for v in self.memory.values():
                v.clear()

        if done:
            elapsed = time.time() - self.start
            text = ("EPISODE: {0:6d} / TOTAL_STEPS: {1:8d} / STEPS: {2:5d}"
                    " / TOTAL_REWARD: {3:3.2f} / AVG_LOSS: {4:.5f} /"
                    " STEPS_PER_SECOND: {5:.1f}").format(
                self.episode + 1, self.timestep, self.duration,
                self.total_reward, self.avg_loss,
                self.duration / max(elapsed, 1e-9))
            print(text)
            with open(self.agent_name + "_output.txt", "a") as f:
                f.write(text + "\n")
            self.total_reward = 0.0
            self.duration = 0
            self.start = time.time()
            self.episode += 1

    def _do_update(self) -> float:
        """One ``simple_ppo_update`` on the stored transitions as a (T, 1)
        rollout."""
        t = len(self.memory["actions"])
        dev = self.device

        def col(values, dtype):
            return torch.as_tensor(np.asarray(values), dtype=dtype,
                                   device=dev)[:, None]
        roll = Transition(
            obs=torch.as_tensor(np.stack(self.memory["states"]),
                                device=dev)[:, None],
            action=col(self.memory["actions"], torch.int64),
            logp=col(self.memory["logprobs"], torch.float32),
            value=torch.zeros(t, 1, device=dev),
            reward=col(self.memory["rewards"], torch.float32),
            done=col(self.memory["dones"], torch.bool),
            legal=torch.ones(t, 1, self.num_action, dtype=torch.bool,
                             device=dev))
        return float(simple_ppo_update(self.net, self.optimizer, roll,
                                       self.cfg,
                                       generator=self._shuffle))

    def save(self, path, episode=0, loss=0.0):
        _save(path, episode, self.net, self.optimizer,
              {"loss": float(loss)})

    def load(self, checkpoint_or_path):
        if isinstance(checkpoint_or_path, str):
            ep, extra = _load(checkpoint_or_path, self.net, self.optimizer)
            return ep, extra.get("loss", 0.0)
        raise TypeError("pass a checkpoint path")


class DQNAgent:
    """The DQN agent with the reference protocol (dqn.py:135-503)."""

    def __init__(self, agent_name="dqn", board_size=8, state_length=3,
                 anealing_steps=1_000_000, initial_epsilon=1.0,
                 final_epsilon=0.1, target_update_interval=10_000,
                 train_interval=4, batch_size=32, lr=0.00025,
                 replay_memory_size=1_000_000, initial_replay_size=20_000,
                 gamma=0.99, n_step=1, prioritized=False, double=False,
                 dueling=False, seed=0, device=None):
        self.agent_name = agent_name
        self.env = None
        self.device = resolve_device(device)
        use_float32()
        self.cfg = DQNConfig(
            board_size=board_size, state_channels=state_length,
            gamma=gamma, n_step=n_step, double=double, dueling=dueling,
            lr=lr, batch_size=batch_size,
            initial_epsilon=initial_epsilon, final_epsilon=final_epsilon,
            annealing_steps=anealing_steps,
            initial_replay_size=initial_replay_size,
            target_update_interval=target_update_interval,
            train_interval=train_interval)
        self.rb_cfg = ReplayConfig(capacity=replay_memory_size,
                                   board_size=board_size,
                                   prioritized=prioritized)
        self.state = dqn_init(self.cfg, seed, self.device)
        self.replay = replay_init(self.rb_cfg, self.device)
        self.draws = Draws(torch.Generator(self.device).manual_seed(seed + 1))
        self.buffer = []        # host-side n-step window (dqn.py:224)
        self.total_loss = 0.0
        self.total_reward = 0.0
        self.duration = 0
        self.episode = 0
        self.start = time.time()

    def reset(self, env):
        self.env = _unwrap(env)

    @property
    def t(self):
        return int(self.state.t)

    @property
    def epsilon(self):
        return float(epsilon_at(self.cfg, self.state.t))

    @torch.no_grad()
    def _q(self, state):
        x = torch.as_tensor(np.asarray(state, np.float32),
                            device=self.device)[None]
        return self.state.net(x)[0].cpu().numpy()

    def _pick(self, state, eps):
        moves = self.env.possible_moves
        if np.random.random() < eps:
            return int(moves[np.random.randint(len(moves))])
        q = self._q(state)
        return int(moves[int(np.argmax(q[moves]))])

    def get_action(self, state):
        eps = 1.0 if self.t < self.cfg.initial_replay_size else self.epsilon
        return self._pick(state, eps)

    def get_test_action(self, state):
        return self._pick(state, self.cfg.test_epsilon)

    def _train_batch(self) -> torch.Tensor:
        return dqn_train_batch(self.state, self.replay, self.cfg,
                               self.rb_cfg, self.draws)

    def run(self, state, action, reward, terminal, next_state):
        """dqn.py:288-403 — n-step buffering, replay and cadenced updates.
        ``state``/``next_state`` are 3- or 4-plane features; the replay
        stores (board, turn) recovered from the planes."""
        reward = reward * self.cfg.reward_scale
        board, turn = _planes_to_board(state)
        nboard, nturn = _planes_to_board(next_state)
        self.buffer.append((board, turn, int(action), float(reward),
                            nboard, nturn, bool(terminal)))
        dev = self.device

        def emit(window):
            m = len(window)
            ret = sum(window[k][3] * self.cfg.gamma ** k for k in range(m))
            b0, t0, a0 = window[0][:3]
            nb, nt, dn = window[m - 1][4], window[m - 1][5], window[m - 1][6]
            self.replay = replay_insert(
                self.replay, self.rb_cfg,
                board=torch.as_tensor(b0, device=dev)[None],
                turn=torch.tensor([t0], dtype=torch.int8, device=dev),
                action=torch.tensor([a0], dtype=torch.int32, device=dev),
                reward=torch.tensor([ret], dtype=torch.float32, device=dev),
                next_board=torch.as_tensor(nb, device=dev)[None],
                next_turn=torch.tensor([nt], dtype=torch.int8, device=dev),
                done=torch.tensor([dn], device=dev),
                valid=torch.tensor([True], device=dev))
            self.state.t += 1

        if terminal:
            while self.buffer:
                emit(self.buffer)
                self.buffer.pop(0)
        elif len(self.buffer) >= self.cfg.n_step:
            emit(self.buffer[:self.cfg.n_step])
            self.buffer.pop(0)

        t = self.t
        if t >= self.cfg.initial_replay_size:
            if t % self.cfg.train_interval == 0:
                self.total_loss += float(self._train_batch())
            if t % self.cfg.target_update_interval == 0:
                self.state = maybe_sync_target(self.state, True)

        self.total_reward += reward / self.cfg.reward_scale
        self.duration += 1
        if terminal:
            elapsed = time.time() - self.start
            text = ("EPISODE: {0:6d} / TOTAL_STEPS: {1:8d} / "
                    "STEPS: {2:5d} / EPSILON: {3:.5f} / "
                    "TOTAL_REWARD: {4:3.0f} / AVG_LOSS: {5:.5f} / "
                    "STEPS_PER_SECOND: {6:.1f}").format(
                self.episode + 1, self.t, self.duration, self.epsilon,
                self.total_reward,
                self.total_loss / max(self.duration
                                      / self.cfg.train_interval, 1),
                self.duration / max(elapsed, 1e-9))
            print(text)
            with open(self.agent_name + "_output.txt", "a") as f:
                f.write(text + "\n")
            self.total_reward = 0.0
            self.total_loss = 0.0
            self.duration = 0
            self.episode += 1
            self.start = time.time()

    def save(self, path, episode=0, loss=0.0):
        _save(path, episode, self.state.net, self.state.optimizer,
              {"t": self.t, "loss": float(loss)})

    def load(self, path):
        ep, extra = _load(path, self.state.net, self.state.optimizer)
        self.state.target.load_state_dict(self.state.net.state_dict())
        self.state.t = int(extra.get("t", 0))
        return ep, extra.get("loss", 0.0)


def _planes_to_board(state):
    """(board int8, turn int8) from 3/4-plane features ([black, white,
    turn, ...])."""
    s = np.asarray(state)
    if s.ndim == 3:
        board = (s[1] - s[0]).astype(np.int8)     # white=+1, black=-1
        turn = np.int8(1 if s[2].flat[0] >= 0.5 else -1)
        return board, turn
    raise ValueError("expected plane features (C, B, B)")


class Rainbow(DQNAgent):
    """The Rainbow agent with the reference protocol (``from
    Rainbow.agent import Agent as Rainbow``, util.py:6;
    ``create_policy('rainbow')``, util.py:42-43): noisy nets and C51 on
    the DQN driver loop.  Exploration comes from the parameter noise (one
    sample a decision), so acting is greedy over the noisy expected Q.
    ``device`` is the reference signature's, used here as the torch
    device."""

    def __init__(self, agent_name="rainbow", board_size=8, device=None,
                 seed=0, **kwargs):
        from gymothelloenv_tpu_torch.agents import rainbow
        super().__init__(agent_name=agent_name, board_size=board_size,
                         seed=seed, prioritized=True, n_step=3,
                         device=device, **{
                             k: v for k, v in kwargs.items()
                             if k in ("replay_memory_size",
                                      "initial_replay_size",
                                      "target_update_interval",
                                      "train_interval", "batch_size",
                                      "gamma")})
        self._rainbow = rainbow
        self.rainbow_cfg = rainbow.RainbowConfig(
            board_size=board_size, gamma=self.cfg.gamma,
            n_step=self.cfg.n_step,
            initial_replay_size=self.cfg.initial_replay_size,
            target_update_interval=self.cfg.target_update_interval,
            train_interval=self.cfg.train_interval,
            batch_size=self.cfg.batch_size)
        self.state = rainbow.rainbow_init(self.rainbow_cfg, seed,
                                          self.device)

    @torch.no_grad()
    def _q(self, state):
        x = torch.as_tensor(np.asarray(state, np.float32),
                            device=self.device)[None]
        net = self.state.net
        logits = net(x, self._rainbow.draw_noise(net, self.draws,
                                                 self.device))
        return self._rainbow.expected_q(logits, self.rainbow_cfg)[0].cpu(
        ).numpy()

    def _train_batch(self) -> torch.Tensor:
        return self._rainbow.rainbow_train_batch(
            self.state, self.replay, self.rainbow_cfg, self.rb_cfg,
            self.draws)

    def get_action(self, state):
        # Noisy-net exploration: always greedy over the noisy values.
        return self._pick(state, 0.0)

    def get_test_action(self, state):
        return self._pick(state, 0.0)

