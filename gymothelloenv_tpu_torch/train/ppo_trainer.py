"""PPO self-play trainer — the port of ``train/ppo_trainer.py``
(``SelfPlayConfig``, ``make_network``, ``PPOSelfPlayTrainer``,
``load_eval_policy``) for the feed-forward self-play path: mirror
self-play, or an opponent pool of frozen snapshots and anchor
checkpoints.

One update collects ``num_steps`` slots from ``num_envs`` games
(``train/self_play.py``) and runs ``agents/ppo.ppo_update`` on them; every
``test_interval`` updates the net plays random and greedy, half the games
per colour (``train/tournament.evaluate``); every ``save_interval`` updates
``train`` writes a checkpoint.  Checkpoints are the JAX trainer's files
(flax msgpack, ``utils/checkpoint.py``): params in flax layout
(``models/convert.py``) and optax's optimizer state
(``agents/ppo.Optimizer.to_optax_state``), so either trainer resumes the
other's run.

Randomness: a generator on the training device for the collector's
colours and samples and for the evaluation games, a CPU generator for
each update's shuffle key words, both seeded from ``SelfPlayConfig.seed``,
and ``random.Random(seed)`` for the opponent draws (as the JAX trainer).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import random as pyrandom
import time
from typing import Callable, Optional

import numpy as np
import torch

from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, make_optimizer,
                                                ppo_update)
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (flax_leaves, flax_tree,
                                                    load_flax_params,
                                                    policy_net_from_flax,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.models.nets import PolicyNet
from gymothelloenv_tpu_torch.ops.shuffle import draw_words
from gymothelloenv_tpu_torch.policies.scripted import (greedy_policy,
                                                       random_policy)
from gymothelloenv_tpu_torch.train import tournament
from gymothelloenv_tpu_torch.train.self_play import (Draws, collect_rollout,
                                                     selfplay_init)
from gymothelloenv_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
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
    save_interval: int = 500       # in updates, with a checkpoint path
    seed: int = 0
    hidden_size: int = 512         # fc width (reference: 512)
    width_mult: int = 1            # trunk channel multiplier
    # Opponent pool: when > 0 the non-learning colour is played by a
    # frozen snapshot drawn uniformly from the anchors and the last
    # ``opponent_pool`` snapshots (one pushed every ``pool_interval``
    # updates) instead of the live net.
    opponent_pool: int = 0
    pool_interval: int = 250
    # Checkpoints of the training net's architecture that join the pool's
    # draw for good (needs opponent_pool > 0).
    pool_anchors: tuple = ()
    # Updates per ``train`` iteration: logging, evaluation and saving
    # quantise to it and the run length rounds up to a multiple of it.
    chain_updates: int = 1
    # Features of the JAX trainer that are not ported yet (ROADMAP.md):
    # any value other than the default raises in PPOSelfPlayTrainer.
    init_rand_steps: int = 0
    bf16: bool = False
    recurrent: bool = False
    frame_stack: int = 1
    max_episode_plies: int = 0
    lookahead_collect: bool = False


_UNPORTED = ("init_rand_steps", "bf16", "recurrent", "frame_stack",
             "max_episode_plies", "lookahead_collect")


def make_network(cfg: EnvConfig, hidden_size: int = 512,
                 width_mult: int = 1, seed: int = 0,
                 device=None) -> PolicyNet:
    """A seeded orthogonal init of the feed-forward ``PolicyNet``."""
    net = PolicyNet(num_actions=cfg.num_actions, hidden_size=hidden_size,
                    width_mult=width_mult, board_size=cfg.board_size)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(resolve_device(device))


def load_eval_policy(path: str, cfg: EnvConfig = EnvConfig(), device=None):
    """Load a policy checkpoint for evaluation (JAX ppo_trainer.py:
    334-392, the feed-forward msgpack case): ``width_mult`` and
    ``hidden_size`` come from the stored shapes.  Returns ``(net,
    description)``, the description as JAX writes it (``"step 4000,
    width_mult=2, hidden=1024"``).  ``cfg``: the board the net plays
    (8x8 in the port)."""
    if path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            "reference torch checkpoints (.pth/.pt) are not ported yet "
            "(ROADMAP.md queue 1 item 12, the compat layer)")
    step, raw, _, _ = load_checkpoint(path)
    p = raw["params"]
    trunk = p["ConvTrunk_0"]
    if "GRUCore_0" in p:
        raise NotImplementedError(
            f"{path}: recurrent checkpoints (GRUCore_0) are not ported yet "
            "(ROADMAP.md queue 1 item 7)")
    frame_stack = int(trunk["Conv_0"]["kernel"].shape[-2]) // 4
    if frame_stack > 1:
        raise NotImplementedError(
            f"{path}: frame-stacked checkpoints (frame_stack="
            f"{frame_stack}) are not ported yet (ROADMAP.md queue 1 item 7)")
    width_mult = int(trunk["Conv_0"]["kernel"].shape[-1]) // 32
    hidden_size = int(p["Dense_0"]["kernel"].shape[-1])
    del cfg     # 8x8 only; the stored shapes fix the 64 actions
    net = policy_net_from_flax(raw, width_mult, hidden_size, device)
    extra = ("" if width_mult == 1 and hidden_size == 512 else
             f", width_mult={width_mult}, hidden={hidden_size}")
    return net, f"step {step}{extra}"


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
        run = self.run_cfg
        if run.opponent_pool > 0 and run.pool_interval < 1:
            raise ValueError(
                f"pool_interval must be >= 1 when opponent_pool is on "
                f"(got {run.pool_interval})")
        if run.pool_anchors and run.opponent_pool <= 0:
            raise ValueError("pool_anchors requires opponent_pool > 0 "
                             "(anchors join the snapshot pool's draw)")
        if run.chain_updates > 1 and run.opponent_pool > 0:
            raise ValueError("chain_updates > 1 is incompatible with "
                             "opponent_pool (snapshots re-draw per "
                             "update on host)")
        self.device = resolve_device(device)
        use_float32()
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to train on the CPU")
        seed = run.seed
        self.net = make_network(self.env_cfg, run.hidden_size,
                                run.width_mult, seed, self.device).train()
        self.optimizer = make_optimizer(self.ppo_cfg, self.net.parameters())
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.shuffle_generator = torch.Generator().manual_seed(seed)
        self.draws = Draws(self.generator)
        self.update_count = 0
        self.sp_state = None
        self.pool: list = []
        self._pool_rng = pyrandom.Random(seed)
        self.anchors = [self._load_anchor(path) for path in run.pool_anchors]

    def _frozen_copy(self) -> PolicyNet:
        net = copy.deepcopy(self.net)
        net.requires_grad_(False)
        return net

    def _load_anchor(self, path: str) -> PolicyNet:
        """A pool anchor: a checkpoint of the training net's architecture
        (JAX ppo_trainer.py:747-770, the same check and error text)."""
        try:
            _, params, _, _ = load_checkpoint(path)
            stored = dict(flax_leaves(params))
            mismatch = []
            for key, leaf in flax_leaves(flax_tree(self.net)):
                if key not in stored:
                    raise ValueError(f"missing leaf {'/'.join(key)}")
                if np.shape(stored[key]) != leaf.shape:
                    mismatch.append(("".join(f"[{k!r}]" for k in key),
                                     np.shape(stored[key]), leaf.shape))
            if mismatch:
                err = f"shape mismatches {mismatch[:3]}"
            else:
                return load_flax_params(self._frozen_copy(), params)
        except (OSError, KeyError, TypeError, ValueError) as e:
            err = repr(e)
        raise ValueError(
            f"pool anchor {path!r} does not match the training "
            f"net architecture (hidden_size / width_mult / "
            f"recurrent must agree — the collector applies the "
            f"training net to the opponent params): {err}")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ensure_initialized(self) -> None:
        if self.sp_state is None:
            # With a pool the non-learning colour is a snapshot or an
            # anchor from the very first opponent ply.
            opp = (self._draw_opponent() if self.run_cfg.opponent_pool > 0
                   else None)
            self.sp_state = selfplay_init(self.net, self.env_cfg,
                                          self.run_cfg.num_envs, self.draws,
                                          opp_net=opp)

    def _draw_opponent(self) -> PolicyNet:
        """Uniform draw over the anchors and the snapshot ring (JAX
        ppo_trainer.py:854-861); the first draw snapshots the net."""
        if not self.pool:
            self.pool.append(self._frozen_copy())
        cands = self.anchors + self.pool
        return cands[self._pool_rng.randrange(len(cands))]

    def _do_update(self) -> dict:
        """One update; with a pool, against a drawn opponent, pushing a
        snapshot every ``pool_interval`` updates and evicting the oldest
        beyond ``opponent_pool`` (JAX ppo_trainer.py:876-893)."""
        run = self.run_cfg
        if run.opponent_pool <= 0:
            return self._collect_and_update(None)
        metrics = self._collect_and_update(self._draw_opponent())
        if (self.update_count + 1) % run.pool_interval == 0:
            self.pool.append(self._frozen_copy())
            if len(self.pool) > run.opponent_pool:
                self.pool.pop(0)
        return metrics

    def _collect_and_update(self, opp_net) -> dict:
        """One collection and one PPO update.  Metrics are 0-d tensors
        and floats; ``collect_seconds``/``update_seconds`` are host wall
        times that end in a device synchronisation, ``collect_syncs`` the
        host reads of the collector's opponent loop."""
        syncs = self.sp_state.host_syncs
        self._sync()
        t0 = time.perf_counter()
        self.sp_state, rollout, bootstrap = collect_rollout(
            self.net, self.sp_state, self.env_cfg, self.run_cfg.num_steps,
            self.draws, opp_net=opp_net)
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

    def train(self, num_updates: int, log_every: int = 10,
              checkpoint_path: str | None = None) -> None:
        """``num_updates`` updates, rounded up to a multiple of
        ``chain_updates``, in iterations of ``chain_updates`` (JAX
        ppo_trainer.py:895-935).  Logs the last update's metrics every
        ``log_every`` iterations and after the last, with
        ``transitions_per_sec`` over the whole call (evaluations
        included, as the JAX trainer counts); evaluates when the update
        count crosses a multiple of ``test_interval``; saves to
        ``checkpoint_path`` when it crosses a multiple of
        ``save_interval`` and at the end.  A ``{step}`` placeholder in the
        path gives each save its own file."""
        self.ensure_initialized()
        run = self.run_cfg
        chain = max(1, run.chain_updates)

        def crossed(interval):
            return (self.update_count // interval
                    > (self.update_count - chain) // interval)

        t0 = time.perf_counter()
        transitions = 0
        iters = 0
        for u in range(0, num_updates, chain):
            for _ in range(chain):
                metrics = self._do_update()
            self.update_count += chain
            iters += 1
            transitions += run.num_steps * run.num_envs * chain
            if iters % log_every == 0 or u + chain >= num_updates:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["transitions_per_sec"] = (
                    transitions / (time.perf_counter() - t0))
                self._log(self.update_count, metrics)
            if crossed(run.test_interval):
                wins = self.evaluate()
                self._log(self.update_count,
                          {f"win%({k})": v for k, v in wins.items()})
            if checkpoint_path and crossed(run.save_interval):
                self.save(checkpoint_path.format(step=self.update_count))
        if checkpoint_path:
            self.save(checkpoint_path.format(step=self.update_count))

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

    def save(self, path: str) -> None:
        """Write the update count, the params and the optimizer state as
        the JAX trainer does (``save_checkpoint``)."""
        to_tree = functools.partial(flax_tree, self.net)
        save_checkpoint(path, self.update_count, to_tree(),
                        self.optimizer.to_optax_state(to_tree))

    def load(self, path: str) -> None:
        """Resume from a checkpoint of either trainer: params, Adam state,
        the schedule's position and the update count.  A file of another
        layout raises before anything changes."""
        step, params, opt_state, _ = load_checkpoint(path)
        tensors = tensors_from_flax(self.net, params)
        self.optimizer.load_optax_state(
            opt_state, functools.partial(tensors_from_flax, self.net))
        with torch.no_grad():
            for param, t in zip(self.net.parameters(), tensors):
                param.copy_(t)
        self.update_count = step

    def load_params_only(self, path: str) -> None:
        """Warm start: the params only, with a fresh optimizer and the
        update count at 0 (fine-tuning under another schedule)."""
        _, params, _, _ = load_checkpoint(path)
        load_flax_params(self.net, params)
        self.optimizer = make_optimizer(self.ppo_cfg, self.net.parameters())
        self.update_count = 0
