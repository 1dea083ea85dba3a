"""PPO self-play trainer — the port of ``train/ppo_trainer.py``
(``SelfPlayConfig``, ``make_network``, ``PPOSelfPlayTrainer``) for the
feed-forward, mirror self-play path.

One update collects ``num_steps`` slots from ``num_envs`` games
(``train/self_play.py``) and runs ``agents/ppo.ppo_update`` on them; every
``test_interval`` updates the net plays random and greedy, half the games
per colour (``train/tournament.evaluate``).  Checkpoint ``save``/``load``
wait for the port's own msgpack reader and writer (ROADMAP.md).

Randomness: a generator on the training device for the collector's
colours and samples and for the evaluation games, and a CPU generator for
each update's shuffle key words, both seeded from ``SelfPlayConfig.seed``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, make_optimizer,
                                                ppo_update)
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.nets import PolicyNet
from gymothelloenv_tpu_torch.ops.shuffle import draw_words
from gymothelloenv_tpu_torch.policies.scripted import (greedy_policy,
                                                       random_policy)
from gymothelloenv_tpu_torch.train import tournament
from gymothelloenv_tpu_torch.train.self_play import (Draws, collect_rollout,
                                                     selfplay_init)
from gymothelloenv_tpu_torch.utils.device import (resolve_device,
                                                  use_float32)


@dataclasses.dataclass(frozen=True)
class SelfPlayConfig:
    """Trainer knobs; reference values in comments
    (ppo_run_self_play.py:59-70, :41-56)."""
    num_envs: int = 256            # reference: 8 worker processes
    num_steps: int = 64            # rollout length T (args.num_steps)
    test_init_rand_steps: int = 10
    num_test_games: int = 200
    test_interval: int = 100       # in updates (reference: 500 episodes)
    seed: int = 0
    hidden_size: int = 512         # fc width (reference: 512)
    width_mult: int = 1            # trunk channel multiplier
    # Features of the JAX trainer that are not ported yet (ROADMAP.md):
    # any value other than the default raises in PPOSelfPlayTrainer.
    init_rand_steps: int = 0
    bf16: bool = False
    opponent_pool: int = 0
    pool_anchors: tuple = ()
    recurrent: bool = False
    frame_stack: int = 1
    max_episode_plies: int = 0
    chain_updates: int = 1
    lookahead_collect: bool = False


_UNPORTED = ("init_rand_steps", "bf16", "opponent_pool", "pool_anchors",
             "recurrent", "frame_stack", "max_episode_plies",
             "chain_updates", "lookahead_collect")


def make_network(cfg: EnvConfig, hidden_size: int = 512,
                 width_mult: int = 1, seed: int = 0,
                 device=None) -> PolicyNet:
    """A seeded orthogonal init of the feed-forward ``PolicyNet``."""
    net = PolicyNet(num_actions=cfg.num_actions, hidden_size=hidden_size,
                    width_mult=width_mult, board_size=cfg.board_size)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(resolve_device(device))


class PPOSelfPlayTrainer:
    """``device``: where the games, the net and the update run (``None``:
    the current CUDA card; raises without one).  ``mesh`` is not ported."""

    def __init__(self, env_cfg: EnvConfig = None,
                 ppo_cfg: PPOConfig = None,
                 run_cfg: SelfPlayConfig = None,
                 log_fn: Optional[Callable] = None, mesh=None, device=None):
        self.env_cfg = env_cfg or EnvConfig(num_disk_as_reward=True)
        self.ppo_cfg = ppo_cfg or PPOConfig()
        self.run_cfg = run_cfg or SelfPlayConfig()
        self.log_fn = log_fn
        if mesh is not None:
            raise NotImplementedError("multi-device training (mesh) is not "
                                      "ported yet")
        default = SelfPlayConfig()
        for name in _UNPORTED:
            if getattr(self.run_cfg, name) != getattr(default, name):
                raise NotImplementedError(
                    f"SelfPlayConfig.{name}={getattr(self.run_cfg, name)!r} "
                    "is not ported yet (ROADMAP.md)")
        self.device = resolve_device(device)
        use_float32()
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to train on the CPU")
        seed = self.run_cfg.seed
        self.net = make_network(self.env_cfg, self.run_cfg.hidden_size,
                                self.run_cfg.width_mult, seed,
                                self.device).train()
        self.optimizer = make_optimizer(self.ppo_cfg, self.net.parameters())
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.shuffle_generator = torch.Generator().manual_seed(seed)
        self.draws = Draws(self.generator)
        self.update_count = 0
        self.sp_state = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ensure_initialized(self) -> None:
        if self.sp_state is None:
            self.sp_state = selfplay_init(self.net, self.env_cfg,
                                          self.run_cfg.num_envs, self.draws)

    def _do_update(self) -> dict:
        """One collection and one PPO update.  Metrics are 0-d tensors
        and floats; ``collect_seconds``/``update_seconds`` are host wall
        times that end in a device synchronisation, ``collect_syncs`` the
        host reads of the collector's opponent loop."""
        syncs = self.sp_state.host_syncs
        self._sync()
        t0 = time.perf_counter()
        self.sp_state, rollout, bootstrap = collect_rollout(
            self.net, self.sp_state, self.env_cfg, self.run_cfg.num_steps,
            self.draws)
        self._sync()
        t1 = time.perf_counter()
        words = draw_words(self.shuffle_generator, self.ppo_cfg.ppo_epochs)
        metrics = ppo_update(self.net, self.optimizer, rollout, bootstrap,
                             words, self.ppo_cfg)
        episodes = rollout.done.sum()
        metrics["episode_return"] = (rollout.reward.sum()
                                     / episodes.clamp(min=1))
        metrics["episodes"] = episodes
        self._sync()
        metrics["collect_seconds"] = t1 - t0
        metrics["update_seconds"] = time.perf_counter() - t1
        metrics["collect_syncs"] = self.sp_state.host_syncs - syncs
        return metrics

    def train(self, num_updates: int, log_every: int = 10) -> None:
        """``num_updates`` updates; logs every ``log_every`` and after the
        last, with ``transitions_per_sec`` over the whole call (evaluations
        included, as the JAX trainer counts)."""
        self.ensure_initialized()
        t0 = time.perf_counter()
        transitions = 0
        for u in range(num_updates):
            metrics = self._do_update()
            self.update_count += 1
            transitions += self.run_cfg.num_steps * self.run_cfg.num_envs
            if (u + 1) % log_every == 0 or u + 1 == num_updates:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["transitions_per_sec"] = (
                    transitions / (time.perf_counter() - t0))
                self._log(self.update_count, metrics)
            if self.update_count % self.run_cfg.test_interval == 0:
                wins = self.evaluate()
                self._log(self.update_count,
                          {f"win%({k})": v for k, v in wins.items()})

    def evaluate(self) -> dict:
        """Win rates of the sampling net against random and greedy, half
        the games as each colour, with ``test_init_rand_steps`` random
        opening plies (rule_base_game, ppo_run_self_play.py:371-441)."""
        n = self.run_cfg.num_test_games // 2
        act = tournament.net_tournament_policy(self.net)
        results = {}
        for name, opp in (("rand", random_policy),
                          ("greedy", greedy_policy)):
            wins, _, _ = tournament.evaluate(
                act, opp, 2 * n, self.run_cfg.test_init_rand_steps,
                generator=self.generator, cfg=self.env_cfg,
                device=self.device)
            results[name] = wins / (2 * n)
        return results

    def _log(self, step: int, metrics: dict) -> None:
        if self.log_fn:
            self.log_fn(step, metrics)
        else:
            text = " ".join(f"{k}={v:.4g}" for k, v in metrics.items())
            print(f"[update {step}] {text}", flush=True)
