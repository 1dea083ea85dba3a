"""ACKTR self-play trainer — the port of ``train/acktr_trainer.py`` (the
vendored ``--algo acktr``, main.py:77-87 with ``acktr=True`` +
algo/kfac.py, made runnable on Othello): the PPO trainer's collector,
evaluation and train loop driving ``agents.kfac.ACKTRAgent``, a tanh-MLP
(``net="mlp"``, MLPBase's towers over flattened planes) or CNNBase-shaped
conv (``net="conv"``, KFC conv factors) actor-critic, updated with the
K-FAC natural-gradient step on A2C's returns.  JAX's
``make_mlp_apply_fn``/``make_conv_apply_fn`` are ``ACKTRAgent.forward``.

``self.net`` is the agent (its towers and K-FAC states); there is no
optimizer state.  Checkpoints are the JAX trainer's files byte for byte:
the agent's tree as params, ``{}`` as the optimizer state.  Recurrent,
frame-stacked and time-limited runs raise, as JAX's do.
"""

from __future__ import annotations

import time

from gymothelloenv_tpu_torch.agents.a2c import A2CConfig, a2c_returns
from gymothelloenv_tpu_torch.agents.kfac import (ACKTRConfig,
                                                 acktr_conv_init,
                                                 acktr_init, acktr_update)
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.parallel.sharding import (global_sums,
                                                       place_replicated)
from gymothelloenv_tpu_torch.train.a2c_trainer import check_feed_forward
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from gymothelloenv_tpu_torch.train.self_play import collect_rollout
from gymothelloenv_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)


class ACKTRSelfPlayTrainer(PPOSelfPlayTrainer):
    """``device``: where the games, the agent and the update run
    (``None``: the current CUDA card; raises without one).  ``mesh``:
    data-parallel training as the base trainer's; the Kronecker factors
    are all-reduced before each eigendecomposition
    (``agents.kfac.acktr_update(mesh=)``)."""

    def __init__(self, acktr_cfg: ACKTRConfig = None,
                 env_cfg: EnvConfig = None, run_cfg: SelfPlayConfig = None,
                 log_fn=None, net: str = "mlp", mesh=None, device=None):
        if net not in ("mlp", "conv"):
            raise ValueError(f"net must be 'mlp' or 'conv', got {net!r}")
        self.acktr_cfg = acktr_cfg or ACKTRConfig()
        if run_cfg is None:
            run_cfg = SelfPlayConfig(num_steps=5)   # arguments.py default
        super().__init__(env_cfg=env_cfg, run_cfg=run_cfg, log_fn=log_fn,
                         mesh=mesh, device=device)
        check_feed_forward(self.run_cfg)
        b, a = self.env_cfg.board_size, self.env_cfg.num_actions
        seed = self.run_cfg.seed
        self.net = (acktr_conv_init(b, a, seed=seed, device=self.device)
                    if net == "conv" else
                    acktr_init(4 * b * b, a, seed=seed, device=self.device))
        if self.mesh is not None:
            place_replicated(self.net, self.mesh)
        self.policy = self.net
        self._a2c_cfg = A2CConfig(gamma=self.acktr_cfg.gamma)

    def _make_optimizer(self):
        return None            # K-FAC's state lives in the agent

    @property
    def agent(self):
        """The ``ACKTRAgent`` (alias of ``net``)."""
        return self.net

    def _collect_and_update(self, opp_net) -> dict:
        """One collection of ``num_steps`` slots, A2C's returns and one
        ACKTR update.  Metrics: the update's, ``episodes``, and the host
        wall times ``collect_seconds``/``update_seconds`` (each ending in a
        device synchronisation)."""
        run = self.run_cfg
        self._sync()
        t0 = time.perf_counter()
        self.sp_state, rollout, bootstrap = collect_rollout(
            self.net, self.sp_state, self.env_cfg, run.num_steps,
            self.draws, run.init_rand_steps, opp_net=opp_net)
        self._sync()
        t1 = time.perf_counter()
        returns = a2c_returns(rollout, bootstrap, self._a2c_cfg)
        k = returns.numel()
        obs = rollout.obs.reshape((k,) + rollout.obs.shape[2:])
        if not self.net.conv:
            obs = obs.reshape(k, -1)
        metrics = acktr_update(self.net, obs, rollout.legal.reshape(k, -1),
                               rollout.action.reshape(k),
                               returns.reshape(k), self.acktr_cfg,
                               self.draws, mesh=self.mesh)
        metrics["episodes"], = global_sums([rollout.done.sum()], self.mesh)
        self._sync()
        metrics["collect_seconds"] = t1 - t0
        metrics["update_seconds"] = time.perf_counter() - t1
        return metrics

    def save(self, path: str) -> None:
        """The update count and the agent's tree, as JAX's trainer writes
        them (``opt_state`` empty); on a mesh rank 0 alone writes."""
        if not self.is_main:
            return
        save_checkpoint(path, self.update_count, self.net.flax_tree(), {})

    def load(self, path: str) -> None:
        """Resume from either trainer's checkpoint: towers, K-FAC states and
        the update count."""
        step, params, _, _ = load_checkpoint(path)
        self.net.load_flax_tree(params)
        self.update_count = step

    def load_params_only(self, path: str) -> None:
        raise NotImplementedError("ACKTR has no params-only warm start (JAX "
                                  "re-inits optax state it does not have)")
