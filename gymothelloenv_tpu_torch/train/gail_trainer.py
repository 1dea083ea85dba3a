"""GAIL-PPO trainer — the port of ``train/gail_trainer.py`` (the vendored
``main.py`` GAIL wiring, main.py:141-162, dead in the reference, working
in the JAX package and here).

One update (JAX gail_trainer.py:83-157), in this order:
  1. collect ``num_steps`` slots of self-play (``collect_rollout``; on 8x8
     one ply-kernel launch a ply);
  2. ``gail_epoch`` discriminator steps, each on ``gail_batch_size``
     host-sampled expert rows (``ExpertDataset.sample`` from
     ``np.random.RandomState(seed)``) and as many policy rows drawn with
     replacement from the rollout (``draws.row_indices``);
  3. relabel every reward with the discriminator's signal, sequentially
     over T (``gail_predict_reward``), the return accumulator's
     ``masks[0] = 1 - last_done`` carried across updates;
  4. ``agents.ppo.ppo_update`` on the relabelled rollout.
Discriminator rows are ``[make_state planes flattened, one-hot action]``
(gail.py:12-28 concatenates state and action the same way).
``chain_updates`` runs that many updates an iteration of the base
``train`` loop, each with its own expert stack, as JAX's chained scan
does.  The opponent pool is not used (JAX's ``_do_update`` bypasses it).

``bc_warmstart``: behaviour cloning on the expert rows before adversarial
training, with its own Adam; the legal mask comes from plane 3 of the
stored observation.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.nn import functional as F

from gymothelloenv_tpu_torch.agents.gail import (ExpertDataset, GAILConfig,
                                                 gail_discriminator_update,
                                                 gail_init,
                                                 gail_predict_reward)
from gymothelloenv_tpu_torch.agents.ppo import Adam, ppo_update
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.ops.shuffle import draw_words
from gymothelloenv_tpu_torch.train.a2c_trainer import check_feed_forward
from gymothelloenv_tpu_torch.train.ppo_trainer import PPOSelfPlayTrainer
from gymothelloenv_tpu_torch.train.self_play import collect_rollout


@dataclasses.dataclass(frozen=True)
class GAILRunConfig:
    gail_epoch: int = 5            # discriminator steps per update
    #                                (arguments.py --gail-epoch default)
    gail_batch_size: int = 128     # args.gail_batch_size
    num_trajectories: int = 4      # ExpertDataset defaults (gail.py:117)
    subsample_frequency: int = 4   # the reference's 20 is for 1000-step
    #                                MuJoCo episodes; Othello games are
    #                                ~60 plies


class GAILPPOTrainer(PPOSelfPlayTrainer):
    """PPO self-play whose environment reward is replaced by the GAIL
    discriminator's signal (main.py:141-155).  ``device`` as the base
    trainer's; ``mesh`` raises there."""

    def __init__(self, expert_path: str, gail_cfg: GAILConfig = None,
                 gail_run: GAILRunConfig = None, **kw):
        super().__init__(**kw)
        check_feed_forward(self.run_cfg)
        self.gail_run = gail_run or GAILRunConfig()
        self.gail_cfg = gail_cfg or GAILConfig(gamma=self.ppo_cfg.gamma)
        self.expert = ExpertDataset(
            expert_path, num_trajectories=self.gail_run.num_trajectories,
            subsample_frequency=self.gail_run.subsample_frequency)
        self.np_rng = np.random.RandomState(self.run_cfg.seed)
        b = self.env_cfg.board_size
        self._num_actions = self.env_cfg.num_actions
        self._sa_dim = 4 * b * b + self._num_actions
        self.gail_state = gail_init(self.gail_cfg, self._sa_dim,
                                    self.run_cfg.num_envs,
                                    self.run_cfg.seed + 1, self.device)
        self._eye = np.eye(self._num_actions, dtype=np.float32)
        self._last_done = torch.zeros(self.run_cfg.num_envs,
                                      dtype=torch.bool, device=self.device)

    def bc_warmstart(self, updates: int, batch_size: int = 512,
                     lr: float = 2.5e-4, log_every: int = 100) -> None:
        """Behaviour cloning on expert ``(state, action)`` rows before
        adversarial training (JAX gail_trainer.py:186-257): minimise the
        masked cross-entropy of the policy at the expert's actions, the
        legal mask from the stored observation's legal plane (util.py:
        48-74, plane 3), with a dedicated optax ``adam(lr)``; the value
        head is not trained and the trainer's optimizer is untouched.
        Rows without a legal move, or whose action the plane does not
        allow, weigh 0 (their mask all-legal so the log-prob stays
        finite).  Logs ``bc_loss`` at steps ``i + 1 - updates``."""
        b = self.env_cfg.board_size
        bc_opt = Adam(self.net.parameters(), lr)
        for i in range(updates):
            s, a = self.expert.sample(self.np_rng, batch_size)
            s = np.asarray(s, np.float32).reshape(-1, 4, b, b)
            a = np.asarray(a, np.int64).reshape(-1)
            mask = s[:, 3].reshape(len(s), -1) > 0.5
            ok = mask.any(axis=1) & mask[np.arange(len(a)), a]
            loss = self._bc_step(bc_opt, *(torch.from_numpy(x).to(
                self.device) for x in (s, a, mask, ok)))
            if log_every and ((i + 1) % log_every == 0 or i == 0):
                self._log(i + 1 - updates, {"bc_loss": float(loss)})

    def _bc_step(self, opt: Adam, s, a, mask, ok) -> torch.Tensor:
        """One BC step; returns the loss before it (0-d)."""
        safe_mask = torch.where(ok[:, None], mask, torch.ones_like(mask))
        opt.zero_grad()
        logits, _ = self.net(s)
        lp = MaskedCategorical(logits=logits, mask=safe_mask).log_prob(a)
        w = ok.to(lp.dtype)
        loss = -(lp * w).sum() / w.sum().clamp(min=1.0)
        loss.backward()
        opt.step()
        return loss.detach()

    def sample_expert(self) -> torch.Tensor:
        """(gail_epoch, M, sa_dim) float32 ``[state, one-hot action]``
        expert rows on the device, from ``np_rng``."""
        out = []
        for _ in range(self.gail_run.gail_epoch):
            s, a = self.expert.sample(self.np_rng,
                                      self.gail_run.gail_batch_size)
            s = np.asarray(s, np.float32).reshape(len(s), -1)
            onehot = self._eye[np.asarray(a, np.int64).reshape(-1)]
            out.append(np.concatenate([s, onehot], axis=-1))
        return torch.from_numpy(np.stack(out)).to(self.device)

    def _do_update(self) -> dict:
        return self.gail_update(self.sample_expert())

    def gail_update(self, expert_sa: torch.Tensor, words=None) -> dict:
        """One GAIL update on ``expert_sa`` ((gail_epoch, M, sa_dim) rows):
        collect, ``gail_epoch`` discriminator steps, the sequential
        relabel, the PPO update (``words``: its epochs' shuffle words,
        default from ``shuffle_generator``).  Metrics: the PPO update's,
        ``disc_loss``, ``gail_reward``, ``episodes`` (0-d tensors), and
        the host wall times ``collect_seconds``, ``disc_seconds``,
        ``relabel_seconds`` and ``update_seconds``, each ending in a
        device synchronisation."""
        run, cfg = self.run_cfg, self.gail_cfg
        self._sync()
        t0 = time.perf_counter()
        self.sp_state, rollout, bootstrap = collect_rollout(
            self.net, self.sp_state, self.env_cfg, run.num_steps,
            self.draws, run.init_rand_steps)
        self._sync()
        t1 = time.perf_counter()
        T, N = rollout.reward.shape
        obs_flat = rollout.obs.to(torch.float32).reshape(T * N, -1)
        onehot = F.one_hot(rollout.action.reshape(-1),
                           self._num_actions).to(torch.float32)
        policy_sa = torch.cat([obs_flat, onehot], dim=-1)
        m = expert_sa.shape[1]
        dlosses = []
        for e_sa in expert_sa:
            # Policy rows with replacement (uniform over the T*N rows), a
            # documented divergence from the vendored DataLoader's pass.
            idx = self.draws.row_indices(m, T * N, self.device)
            self.gail_state, dloss = gail_discriminator_update(
                self.gail_state, cfg, e_sa, policy_sa[idx], self.draws)
            dlosses.append(dloss)
        self._sync()
        t2 = time.perf_counter()
        # masks[t] = 1 - done[t-1], carried across updates by last_done.
        masks = torch.cat([1.0 - self._last_done.to(torch.float32)[None],
                           1.0 - rollout.done[:-1].to(torch.float32)])
        sa_t = policy_sa.reshape(T, N, -1)
        rewards = []
        for t in range(T):
            self.gail_state, r = gail_predict_reward(self.gail_state, cfg,
                                                     sa_t[t], masks[t])
            rewards.append(r)
        rewards = torch.stack(rewards)
        rollout = dataclasses.replace(rollout, reward=rewards)
        self._sync()
        t3 = time.perf_counter()
        if words is None:
            words = draw_words(self.shuffle_generator,
                               self.ppo_cfg.ppo_epochs)
        metrics = ppo_update(self.net, self.optimizer, rollout, bootstrap,
                             words, self.ppo_cfg)
        self._last_done = rollout.done[-1]
        metrics["disc_loss"] = torch.stack(dlosses).mean()
        metrics["gail_reward"] = rewards.mean()
        metrics["episodes"] = rollout.done.sum()
        self._sync()
        metrics.update(collect_seconds=t1 - t0, disc_seconds=t2 - t1,
                       relabel_seconds=t3 - t2,
                       update_seconds=time.perf_counter() - t3)
        return metrics
