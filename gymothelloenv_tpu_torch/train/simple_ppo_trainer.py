"""Simple-PPO self-play trainer — the port of
``train/simple_ppo_trainer.py`` (the reference's ``run_self_play.py``
driving the standalone PPO agent): one shared ``ActorCriticNet`` plays
both colours and learns only the per-episode protagonist colour, with an
update (``agents/simple_ppo.py``) every ``num_envs * num_steps``
transitions on MC returns.

Collection is ``train/self_play.collect_rollout`` with
``logp_mode="full"`` (on 8x8 one ply-kernel launch a ply).  With
``vecnorm_reward`` the (T, N) rewards go through the live VecNormalize
filter (``envs/vec_wrappers.vecnorm_reward``) in collection order before
the update.  Every ``test_interval`` updates the net plays random and
greedy, half the games a colour, with ``test_init_rand_steps`` random
openings.  Checkpoints are JAX's files: flax msgpack params
(``models/convert.py``), optax adam's state and, with ``vecnorm_reward``,
the filter's state under ``extra["vecnorm"]``.

Randomness: a generator on the training device for the collector and the
evaluation games, a CPU generator for each update's epoch permutations,
both seeded from ``seed``; the net's init from a CPU generator at
``seed``.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from gymothelloenv_tpu_torch.agents.simple_ppo import (
    SimplePPOConfig, make_simple_ppo_optimizer, simple_ppo_update)
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.envs.vec_wrappers import (RunningMeanStd,
                                                       vecnorm_init,
                                                       vecnorm_reward)
from gymothelloenv_tpu_torch.models.convert import (flax_tree,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.models.nets import ActorCriticNet
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
class SimpleSelfPlayConfig:
    """run_self_play.py:23-43 equivalents."""
    num_envs: int = 64
    num_steps: int = 32            # slots per update; N*T ~ update_timestep
    init_rand_steps: int = 0
    test_init_rand_steps: int = 10
    num_test_games: int = 200
    test_interval: int = 50        # updates (reference: 2500 episodes)
    save_interval: int = 200
    seed: int = 0
    # The live VecNormalize reward filter before the MC-return update;
    # off is the reference's behaviour.
    vecnorm_reward: bool = False


def make_actor_critic(cfg: EnvConfig, seed: int = 0, device=None,
                      in_channels: int = 4) -> ActorCriticNet:
    """A seeded torch-default init of ``ActorCriticNet`` for ``cfg``'s
    board on ``device``."""
    net = ActorCriticNet(num_actions=cfg.num_actions,
                         board_size=cfg.board_size, in_channels=in_channels)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(resolve_device(device))


def vecnorm_tree(vn) -> dict:
    """The filter's state as JAX's ``serialization.to_state_dict`` writes
    it: its data fields only, float32 numpy leaves."""
    def rms(r: RunningMeanStd) -> dict:
        return {k: getattr(r, k).detach().cpu().numpy()
                for k in ("mean", "var", "count")}
    return {"ob_rms": rms(vn.ob_rms), "ret_rms": rms(vn.ret_rms),
            "ret": vn.ret.detach().cpu().numpy()}


def vecnorm_from_tree(vn, tree: dict):
    """``vn`` with the data fields of a stored ``vecnorm_tree``."""
    dev = vn.ret.device

    def rms(node) -> RunningMeanStd:
        return RunningMeanStd(**{k: torch.as_tensor(
            np.asarray(node[k], np.float32), device=dev)
            for k in ("mean", "var", "count")})
    return dataclasses.replace(
        vn, ob_rms=rms(tree["ob_rms"]), ret_rms=rms(tree["ret_rms"]),
        ret=torch.as_tensor(np.asarray(tree["ret"], np.float32),
                            device=dev))


class SimplePPOSelfPlayTrainer:
    """``device``: where the games, the net and the update run (``None``:
    the current CUDA card; raises without one)."""

    def __init__(self, env_cfg: EnvConfig = None,
                 ppo_cfg: SimplePPOConfig = None,
                 run_cfg: SimpleSelfPlayConfig = None, log_fn=None,
                 device=None):
        self.env_cfg = env_cfg or EnvConfig(num_disk_as_reward=True)
        self.ppo_cfg = ppo_cfg or SimplePPOConfig()
        self.run_cfg = run_cfg or SimpleSelfPlayConfig()
        self.log_fn = log_fn
        self.device = resolve_device(device)
        use_float32()
        run = self.run_cfg
        self.net = make_actor_critic(self.env_cfg, run.seed,
                                     self.device).train()
        self.optimizer = make_simple_ppo_optimizer(self.ppo_cfg,
                                                   self.net.parameters())
        self.generator = torch.Generator(self.device).manual_seed(run.seed)
        self.shuffle_generator = torch.Generator().manual_seed(run.seed)
        self.draws = Draws(self.generator)
        self.update_count = 0
        self.sp_state = None
        self.vecnorm = vecnorm_init((), run.num_envs,
                                    gamma=self.ppo_cfg.gamma,
                                    device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def ensure_initialized(self) -> None:
        if self.sp_state is None:
            self.sp_state = selfplay_init(
                self.net, self.env_cfg, self.run_cfg.num_envs, self.draws,
                self.run_cfg.init_rand_steps, logp_mode="full")

    def _do_update(self, perms=None) -> dict:
        """One collection and one update (JAX ``train_step``).  Metrics:
        ``loss``, ``episode_return`` (the raw rewards over the finished
        episodes), ``episodes`` (0-d tensors), and the host wall times
        ``collect_seconds``/``update_seconds``, each ending in a device
        synchronisation.  ``perms``: the update's epoch permutations
        (``None``: drawn from ``shuffle_generator``)."""
        run = self.run_cfg
        self._sync()
        t0 = time.perf_counter()
        self.sp_state, rollout, _ = collect_rollout(
            self.net, self.sp_state, self.env_cfg, run.num_steps, self.draws,
            run.init_rand_steps, logp_mode="full")
        episodes = rollout.done.sum()
        raw_return = rollout.reward.sum() / episodes.clamp(min=1)
        if run.vecnorm_reward:
            rewards = []
            for t in range(run.num_steps):
                self.vecnorm, r = vecnorm_reward(self.vecnorm,
                                                 rollout.reward[t],
                                                 rollout.done[t])
                rewards.append(r)
            rollout = dataclasses.replace(rollout,
                                          reward=torch.stack(rewards))
        self._sync()
        t1 = time.perf_counter()
        loss = simple_ppo_update(self.net, self.optimizer, rollout,
                                 self.ppo_cfg, perms,
                                 generator=self.shuffle_generator)
        self._sync()
        return {"loss": loss, "episode_return": raw_return,
                "episodes": episodes, "collect_seconds": t1 - t0,
                "update_seconds": time.perf_counter() - t1}

    def train(self, num_updates: int, log_every: int = 10,
              checkpoint_path: str | None = None) -> None:
        """``num_updates`` updates (JAX simple_ppo_trainer.py:164-186): the
        metrics every ``log_every`` updates and after the last, with
        ``transitions_per_sec`` over the call; an evaluation when the
        update count is a multiple of ``test_interval``; a checkpoint at
        each multiple of ``save_interval`` and at the end."""
        self.ensure_initialized()
        run = self.run_cfg
        t0 = time.perf_counter()
        done_steps = 0
        for u in range(num_updates):
            metrics = self._do_update()
            self.update_count += 1
            done_steps += run.num_envs * run.num_steps
            if (u + 1) % log_every == 0 or u == num_updates - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["transitions_per_sec"] = (done_steps
                                            / (time.perf_counter() - t0))
                self._log(self.update_count, m)
            if self.update_count % run.test_interval == 0:
                self._log(self.update_count, {
                    f"win%({k})": v for k, v in self.evaluate().items()})
            if checkpoint_path and self.update_count % run.save_interval == 0:
                self.save(checkpoint_path)
        if checkpoint_path:
            self.save(checkpoint_path)

    def evaluate(self) -> dict:
        """Win rates of the sampling net against random and greedy,
        ``num_test_games // 2`` games a colour, with
        ``test_init_rand_steps`` random openings."""
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
        """The update count, the params, adam's state and, with
        ``vecnorm_reward``, the filter's state (a resumed run keeps its
        running return statistics), as the JAX trainer writes them."""
        to_tree = functools.partial(flax_tree, self.net)
        extra = ({"vecnorm": vecnorm_tree(self.vecnorm)}
                 if self.run_cfg.vecnorm_reward else {})
        save_checkpoint(path, self.update_count, to_tree(),
                        self.optimizer.to_optax_state(to_tree), extra=extra)

    def load(self, path: str) -> None:
        """Resume from a checkpoint of either trainer."""
        step, params, opt_state, extra = load_checkpoint(path)
        tensors = tensors_from_flax(self.net, params)
        self.optimizer.load_optax_state(
            opt_state, functools.partial(tensors_from_flax, self.net))
        with torch.no_grad():
            for param, t in zip(self.net.parameters(), tensors):
                param.copy_(t)
        if extra.get("vecnorm"):
            self.vecnorm = vecnorm_from_tree(self.vecnorm, extra["vecnorm"])
        self.update_count = step
