"""Rainbow trainer — the port of ``train/rainbow_trainer.py``: the DQN
collection loop (``train/dqn_trainer.py``: pending-pair crediting, the
n-step FIFO, the replay on the device, the target sync, the pool) with
Rainbow's hooks:

  * act: greedy over the expected Q of the noisy net, one noise sample a
    ply, so epsilon is pinned to 0;
  * update: the C51 projected-Bellman KL loss with double-DQN action
    selection (three noise samples); PER priorities are the per-sample
    KL terms;
  * the pool's frozen opponents and evaluation: the mean-weight (noise
    off) forward, pure greedy.

``RainbowConfig`` carries the fields the collection loop reads from
``DQNConfig``.  ``mesh`` and ``replay_sharding="per-shard"`` work as the
DQN trainer's (JAX rainbow_trainer.py; ``agents.rainbow.
rainbow_train_batch(mesh=)``, ``parallel.replay_shards.
rainbow_train_batch_pershard``): a noisy forward's noise is one draw, the
same on every rank.
"""

from __future__ import annotations

import torch

from gymothelloenv_tpu_torch.agents.dqn import (featurize3,
                                                greedy_legal_action)
from gymothelloenv_tpu_torch.agents.rainbow import (RainbowConfig,
                                                    expected_q, rainbow_act,
                                                    rainbow_init,
                                                    rainbow_train_batch)
from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
from gymothelloenv_tpu_torch.core.engine import engine_of
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.parallel import replay_shards
from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                       DQNTrainer)


class RainbowTrainer(DQNTrainer):
    """``device``: where the games, the nets, the replay and the updates
    run (``None``: the current CUDA card, or the mesh's; raises without
    one).  ``mesh``: as the DQN trainer's."""

    def __init__(self, env_cfg: EnvConfig = None,
                 rainbow_cfg: RainbowConfig = None,
                 rb_cfg: ReplayConfig = None,
                 run_cfg: DQNRunConfig = None,
                 log_fn=None, mesh=None, device=None):
        env_cfg = env_cfg or EnvConfig(num_disk_as_reward=True)
        rainbow_cfg = rainbow_cfg or RainbowConfig(
            board_size=env_cfg.board_size)
        # Rainbow: PER on by default.
        rb_cfg = rb_cfg or ReplayConfig(board_size=env_cfg.board_size,
                                        prioritized=True)
        super().__init__(env_cfg=env_cfg, dqn_cfg=rainbow_cfg,
                         rb_cfg=rb_cfg, run_cfg=run_cfg, log_fn=log_fn,
                         mesh=mesh, device=device)

    # -- algorithm hooks ------------------------------------------------
    def _init_agent(self):
        return rainbow_init(self.dqn_cfg, self.run_cfg.seed, self.device)

    def _epsilon(self, t: int) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32)

    def _agent_act(self, net, board, turn, legal, eps,
                   draws) -> torch.Tensor:
        return rainbow_act(net, board, turn, legal, draws, self.dqn_cfg)

    def _agent_train_batch(self, agent, replay, draws) -> torch.Tensor:
        if self._per_shard:
            return replay_shards.rainbow_train_batch_pershard(
                agent, replay, self.dqn_cfg, self._per_shard_cfg, draws,
                self.mesh)
        return rainbow_train_batch(agent, replay, self.dqn_cfg, self.rb_cfg,
                                   draws, mesh=self.mesh)

    @torch.no_grad()
    def _opponent_greedy(self, snap, board, turn, legal) -> torch.Tensor:
        """A frozen snapshot's greedy action over its mean-weight
        (noise-off) expected Q."""
        q = expected_q(snap(featurize3(board, turn)), self.dqn_cfg)
        return greedy_legal_action(q, legal)

    @torch.no_grad()
    def _eval_act(self, net, state, draws) -> torch.Tensor:
        """The mean-weight (noise-off) greedy action; no draws."""
        eng = engine_of(state)
        board, turn = eng.board_turn(state)
        return self._opponent_greedy(net, board, turn, eng.legal_flat(state))
