"""A2C self-play trainer — the port of ``train/a2c_trainer.py`` (the
vendored ``--algo a2c``, main.py:77-87 + algo/a2c_acktr.py, a dead path in
the reference's Othello fork, working here with masked actions): the PPO
trainer's collector, evaluation, pool and checkpoints, with one
full-batch RMSprop actor-critic step a rollout (``agents/a2c.py``) in
place of PPO's epochs, ``num_steps=5`` by default (arguments.py).
Recurrent, frame-stacked and time-limited runs raise, as JAX's do; the
base ``train`` loop honours ``chain_updates``.  Checkpoints hold the
optimizer's state in optax's tree, so either trainer resumes the other's
run.
"""

from __future__ import annotations

import time

from gymothelloenv_tpu_torch.agents.a2c import (A2CConfig, a2c_update,
                                                make_a2c_optimizer)
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.parallel.sharding import global_sums
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from gymothelloenv_tpu_torch.train.self_play import collect_rollout

PPO_ONLY = ("frame_stack/max_episode_plies are PPO-only (this trainer's "
            "collector is plain feed-forward)")
RECURRENT = "recurrent policies are PPO-only (use PPOSelfPlayTrainer)"


def check_feed_forward(run: SelfPlayConfig) -> None:
    """JAX's refusals of the A2C and ACKTR trainers (a2c_trainer.py:33-38,
    acktr_trainer.py:74-80): no recurrent, frame-stacked or time-limited
    collection."""
    if run.recurrent:
        raise ValueError(RECURRENT)
    if run.frame_stack > 1 or run.max_episode_plies > 0:
        raise ValueError(PPO_ONLY)


class A2CSelfPlayTrainer(PPOSelfPlayTrainer):
    """``device``: where the games, the net and the update run (``None``:
    the current CUDA card; raises without one).  ``mesh``: data-parallel
    training as the base trainer's (``agents.a2c.a2c_update(mesh=)``)."""

    def __init__(self, a2c_cfg: A2CConfig = None, env_cfg: EnvConfig = None,
                 run_cfg: SelfPlayConfig = None, log_fn=None, mesh=None,
                 device=None):
        self.a2c_cfg = a2c_cfg or A2CConfig()
        if run_cfg is None:
            run_cfg = SelfPlayConfig(num_steps=5)   # arguments.py default
        super().__init__(env_cfg=env_cfg, run_cfg=run_cfg, log_fn=log_fn,
                         mesh=mesh, device=device)
        check_feed_forward(self.run_cfg)

    def _make_optimizer(self):
        return make_a2c_optimizer(self.a2c_cfg, self.net.parameters())

    def _collect_and_update(self, opp_net) -> dict:
        """One collection of ``num_steps`` slots and one A2C update.
        Metrics: the update's, ``episodes``, and the host wall times
        ``collect_seconds``/``update_seconds`` (each ending in a device
        synchronisation)."""
        run = self.run_cfg
        self._sync()
        t0 = time.perf_counter()
        self.sp_state, rollout, bootstrap = collect_rollout(
            self.net, self.sp_state, self.env_cfg, run.num_steps,
            self.draws, run.init_rand_steps, opp_net=opp_net)
        self._sync()
        t1 = time.perf_counter()
        metrics = a2c_update(self.net, self.optimizer, rollout, bootstrap,
                             self.a2c_cfg, mesh=self.mesh)
        metrics["episodes"], = global_sums([rollout.done.sum()], self.mesh)
        self._sync()
        metrics["collect_seconds"] = t1 - t0
        metrics["update_seconds"] = time.perf_counter() - t1
        return metrics
