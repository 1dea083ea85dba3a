"""Teacher-vs-student PPO — the port of ``train/teacher_student.py``
(``ppo_run_teacher_vs_student.py``, its worker :425-572 and
``PPOTeacherStudentEnvs``).

Two ``PolicyNet``s play each other: in each game the teacher takes one
colour (redrawn at every reset) and the student the other.  Both record
PPO transitions of their own decisions.  The student's terminal reward is
the game's outcome; the teacher's is the student's measured improvement,
``sum_k (win_avg[k] - last_win_avg[k])`` over the random and greedy
evaluation opponents (worker :456-474), a host float refreshed by the
student's evaluation every ``test_interval`` chunks.

Collection is a loop of slots; each slot appends a fixed set of records a
role, in JAX's order (teacher_student.py:185-249):

  A: two student plies (the second covers a pass) -> B: terminal emissions
  for both roles, the teacher paid ``teacher_reward`` -> C: finished games
  reset with fresh teacher colours -> C2: the student's opening ply of
  fresh games -> D: the teacher's decision.

A record with weight 0 is a bubble that the masked GAE
(``agents.ppo.compute_gae_masked``) and ``ppo_update(weights=)`` pass
over.  The games step on ``core.engine.get_engine(cfg, force_plane)``: on
8x8 each ply is one launch of the ply kernel on the card.

Randomness: one ``train.self_play.Draws`` over a generator on the training
device (colours, random-opening counts and moves, one sampling uniform a
game a decision) and a CPU generator for each update's shuffle words, both
seeded from ``TeacherStudentConfig.seed``.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch

from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, Transition,
                                                make_optimizer, ppo_update)
from gymothelloenv_tpu_torch.core.engine import get_engine
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (flax_tree,
                                                    load_flax_params,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.ops.shuffle import draw_words
from gymothelloenv_tpu_torch.parallel.sharding import (check_data_mesh,
                                                       global_sums, is_main,
                                                       mesh_device,
                                                       place_replicated)
from gymothelloenv_tpu_torch.policies.scripted import (greedy_policy,
                                                       random_policy)
from gymothelloenv_tpu_torch.train import tournament
from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
from gymothelloenv_tpu_torch.train.self_play import (Draws, ShardedDraws,
                                                     collector_engine,
                                                     masked_step,
                                                     reset_done)
from gymothelloenv_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from gymothelloenv_tpu_torch.utils.device import (resolve_device,
                                                  use_float32)


@dataclasses.dataclass(frozen=True)
class TeacherStudentConfig:
    num_envs: int = 128
    num_steps: int = 32            # slots a chunk
    train_teacher: bool = True
    init_rand_steps: int = 0
    test_init_rand_steps: int = 10
    num_test_games: int = 200
    test_interval: int = 10        # chunks (reference: 10 episodes)
    teacher_test_interval: int = 200
    save_interval: int = 200
    seed: int = 0
    hidden_size: int = 512
    width_mult: int = 1


@dataclasses.dataclass
class RolePending:
    obs: torch.Tensor      # int8 (N, 4, B, B)
    action: torch.Tensor   # int64 (N,)
    logp: torch.Tensor     # float32 (N,)
    value: torch.Tensor    # float32 (N,)
    legal: torch.Tensor    # bool (N, A)
    valid: torch.Tensor    # bool (N,)


@dataclasses.dataclass
class TSState:
    env: object            # BitState (8x8) or OthelloState, (N,) games
    rand_left: torch.Tensor  # int64 (N,)
    tcolor: torch.Tensor   # int8 (N,) the teacher's colour a game
    pending_t: RolePending
    pending_s: RolePending


def _empty_pending(n: int, b: int, device) -> RolePending:
    return RolePending(
        obs=torch.zeros((n, 4, b, b), dtype=torch.int8, device=device),
        action=torch.zeros(n, dtype=torch.int64, device=device),
        logp=torch.zeros(n, device=device),
        value=torch.zeros(n, device=device),
        legal=torch.zeros((n, b * b), dtype=torch.bool, device=device),
        valid=torch.zeros(n, dtype=torch.bool, device=device))


def _decide(net: torch.nn.Module, eng, env, draws):
    """Every game's masked sample from ``net``: ``(obs, action, logp,
    value, legal)``, one uniform a game from ``draws``."""
    obs = eng.featurize(env)
    legal = eng.legal_flat(env)
    logits, value = net(obs)
    dist = MaskedCategorical(logits=logits, mask=legal)
    action = dist.sample(u=draws.uniforms(obs.shape[0], obs.device))
    return obs, action, dist.log_prob(action), value, legal


def _emit(pending: RolePending, reward, done, emit_mask):
    """A weighted ``Transition`` record of the pending decisions where
    ``emit_mask``; weight-0 rows are bubbles (reward 0, done).  Returns
    ``(record, weight, pending)`` with the emitted ones spent."""
    w = emit_mask & pending.valid
    rec = Transition(obs=pending.obs, action=pending.action,
                     logp=pending.logp, value=pending.value,
                     reward=torch.where(w, reward, torch.zeros_like(reward)),
                     done=torch.where(w, done, torch.ones_like(done)),
                     legal=pending.legal)
    return rec, w, dataclasses.replace(pending, valid=pending.valid & ~w)


def _set_pending(pending: RolePending, mask, obs, action, logp, value,
                 legal) -> RolePending:
    """The new decisions where ``mask``, the old pending elsewhere."""
    def sel(new, old):
        return torch.where(mask.reshape((-1,) + (1,) * (old.dim() - 1)),
                           new.to(old.dtype), old)
    return RolePending(obs=sel(obs, pending.obs),
                       action=sel(action, pending.action),
                       logp=sel(logp, pending.logp),
                       value=sel(value, pending.value),
                       legal=sel(legal, pending.legal),
                       valid=pending.valid | mask)


def ts_init(cfg: EnvConfig, num_envs: int, init_rand_steps: int, draws,
            force_plane: bool = False, device=None) -> TSState:
    """Fresh games on ``get_engine(cfg, force_plane)``, their
    random-opening counts and teacher colours, and empty pendings."""
    device = resolve_device(device)
    env = get_engine(cfg, force_plane).reset_batch(num_envs, cfg, device)
    rand_left = tournament.draw_max_rand_steps(draws, num_envs,
                                               init_rand_steps, device)
    tcolor = draws.colors(num_envs, device)
    b = cfg.board_size
    return TSState(env=env, rand_left=rand_left, tcolor=tcolor,
                   pending_t=_empty_pending(num_envs, b, device),
                   pending_s=_empty_pending(num_envs, b, device))


def _stack(records) -> Transition:
    return Transition(**{f.name: torch.stack([getattr(r, f.name)
                                              for r in records])
                         for f in dataclasses.fields(Transition)})


@torch.no_grad()
def collect_ts_rollout(net_t: torch.nn.Module, net_s: torch.nn.Module,
                       ts: TSState, cfg: EnvConfig, num_steps: int,
                       init_rand_steps: int, teacher_reward: float, draws,
                       force_plane: bool = False):
    """``num_steps`` slots.  Returns ``(ts, (roll_t (2T, N), w_t, boot_t),
    (roll_s (4T, N), w_s, boot_s))``: each role's records in time order a
    game, float32 weights (0 at bubbles) and bootstrap values (the
    pending decision's value, 0 where there is none)."""
    eng = collector_engine(cfg, force_plane, ts.env)
    n = ts.tcolor.shape[0]
    dev = ts.tcolor.device
    ro = init_rand_steps > 0
    zero = torch.zeros(n, device=dev)
    false = torch.zeros(n, dtype=torch.bool, device=dev)
    true = torch.ones(n, dtype=torch.bool, device=dev)
    t_reward = torch.full((n,), float(teacher_reward), device=dev)
    env, rand_left, tcolor = ts.env, ts.rand_left, ts.tcolor
    pend_t, pend_s = ts.pending_t, ts.pending_s
    rec_t, w_t, rec_s, w_s = [], [], [], []

    def student_ply(env, rand_left, tcolor, pend_s):
        """Where it is the student's turn: emit its previous decision (the
        game went on), decide, step."""
        turn_now = ~env.terminated & (env.turn == -tcolor)
        rec, w, pend_s = _emit(pend_s, zero, false, turn_now)
        obs, action, logp, value, legal = _decide(net_s, eng, env, draws)
        pend_s = _set_pending(pend_s, turn_now, obs, action, logp, value,
                              legal)
        env, rand_left = masked_step(env, rand_left, action, turn_now, cfg,
                                     draws, ro)
        rec_s.append(rec)
        w_s.append(w)
        return env, rand_left, pend_s

    for _ in range(num_steps):
        # A: up to two student plies toward the teacher's turn.
        for _ in range(2):
            env, rand_left, pend_s = student_ply(env, rand_left, tcolor,
                                                 pend_s)
        # B: terminal emissions for both roles.
        term = env.terminated
        s_out = eng.outcome_for(env, -tcolor, cfg)
        rec, w, pend_t = _emit(pend_t, t_reward, true, term)
        rec_t.append(rec)
        w_t.append(w)
        rec, w, pend_s = _emit(pend_s, s_out, true, term)
        rec_s.append(rec)
        w_s.append(w)
        # C: reset finished games with fresh teacher colours.
        env, rand_left, tcolor = reset_done(env, rand_left, tcolor, term,
                                            cfg, draws, init_rand_steps)
        # C2: the student's opening ply of fresh games.
        env, rand_left, pend_s = student_ply(env, rand_left, tcolor, pend_s)
        # D: the teacher's decision.
        teacher_turn = ~env.terminated & (env.turn == tcolor)
        rec, w, pend_t = _emit(pend_t, zero, false, teacher_turn)
        rec_t.append(rec)
        w_t.append(w)
        obs, action, logp, value, legal = _decide(net_t, eng, env, draws)
        pend_t = _set_pending(pend_t, teacher_turn, obs, action, logp,
                              value, legal)
        env, rand_left = masked_step(env, rand_left, action, teacher_turn,
                                     cfg, draws, ro)
    ts = TSState(env=env, rand_left=rand_left, tcolor=tcolor,
                 pending_t=pend_t, pending_s=pend_s)
    boot_t = pend_t.value * pend_t.valid
    boot_s = pend_s.value * pend_s.valid
    return (ts,
            (_stack(rec_t), torch.stack(w_t).to(torch.float32), boot_t),
            (_stack(rec_s), torch.stack(w_s).to(torch.float32), boot_s))


class TeacherStudentTrainer:
    """``device``: where the games, both nets and their updates run
    (``None``: the current CUDA card, or the mesh's; raises without one).

    ``mesh``: a ``parallel.DataMesh`` (JAX teacher_student.py:271-397):
    ``num_envs`` is the global batch, this rank plays its share with the
    draws made at the global shape (``train.self_play.ShardedDraws``),
    both nets start as rank 0's and each role's weighted update sums its
    gradients over the ranks (``agents.ppo.ppo_update(mesh=)``, two
    parameter sets, two gradient all-reduces a minibatch).  Evaluation
    runs whole on every rank; process 0 alone logs and saves.  Anything
    else as ``mesh`` raises ``TypeError``."""

    def __init__(self, env_cfg: EnvConfig = None, ppo_cfg: PPOConfig = None,
                 run_cfg: TeacherStudentConfig = None, log_fn=None,
                 mesh=None, device=None):
        self.mesh = None if mesh is None else check_data_mesh(mesh)
        self.env_cfg = env_cfg or EnvConfig(num_disk_as_reward=True)
        # Reference overrides: lr 5e-6 (ppo_run_teacher_vs_student.py:
        # 64-74).
        self.ppo_cfg = ppo_cfg or PPOConfig(lr=5e-6)
        self.run_cfg = run_cfg or TeacherStudentConfig()
        self.log_fn = log_fn
        self.device = mesh_device(self.mesh, device)
        use_float32()
        run = self.run_cfg
        self.local_envs = (run.num_envs if self.mesh is None
                           else self.mesh.shard(run.num_envs)[0])
        self.net_t, self.net_s = (
            make_network(self.env_cfg, run.hidden_size, run.width_mult,
                         seed, self.device).train()
            for seed in (2 * run.seed, 2 * run.seed + 1))
        if self.mesh is not None:
            place_replicated([self.net_t, self.net_s], self.mesh)
        self.opt_t = make_optimizer(self.ppo_cfg, self.net_t.parameters())
        self.opt_s = make_optimizer(self.ppo_cfg, self.net_s.parameters())
        self.generator = torch.Generator(self.device).manual_seed(run.seed)
        self.shuffle_generator = torch.Generator().manual_seed(run.seed)
        self.draws = (Draws(self.generator) if self.mesh is None else
                      ShardedDraws(Draws(self.generator), self.mesh,
                                   run.num_envs))
        self.ts_state = None
        self.chunk_count = 0
        self.win_avg = {"rand": 0.0, "greedy": 0.0}
        self.last_win_avg = {"rand": 0.0, "greedy": 0.0}

    @property
    def teacher_reward(self) -> float:
        """``sum_k (win_avg[k] - last_win_avg[k])``: the student's
        improvement paid to the teacher at a game's end (worker
        :456-467)."""
        return sum(self.win_avg[k] - self.last_win_avg[k]
                   for k in self.win_avg)

    def ensure_initialized(self) -> None:
        if self.ts_state is None:
            run = self.run_cfg
            self.ts_state = ts_init(self.env_cfg, self.local_envs,
                                    run.init_rand_steps, self.draws,
                                    device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_step(self) -> dict:
        """One chunk: the collection, then the teacher's update (with
        ``train_teacher``) and the student's, each on its weighted stream.
        Metrics are 0-d tensors and floats: ``teacher_*``/``student_*``,
        ``student_episode_return``, ``episodes``, the records of weight 1
        in each stream (``teacher_records``/``student_records``), and
        ``collect_seconds``/``update_seconds`` (host wall times ending in
        a device synchronisation)."""
        self.ensure_initialized()
        run, cfg = self.run_cfg, self.ppo_cfg
        self._sync()
        t0 = time.perf_counter()
        self.ts_state, (roll_t, w_t, boot_t), (roll_s, w_s, boot_s) = \
            collect_ts_rollout(self.net_t, self.net_s, self.ts_state,
                               self.env_cfg, run.num_steps,
                               run.init_rand_steps, self.teacher_reward,
                               self.draws)
        self._sync()
        t1 = time.perf_counter()
        metrics = {}
        if run.train_teacher:
            m_t = ppo_update(self.net_t, self.opt_t, roll_t, boot_t,
                             draw_words(self.shuffle_generator,
                                        cfg.ppo_epochs), cfg, weights=w_t,
                             mesh=self.mesh)
            metrics.update({f"teacher_{k}": v for k, v in m_t.items()})
        m_s = ppo_update(self.net_s, self.opt_s, roll_s, boot_s,
                         draw_words(self.shuffle_generator, cfg.ppo_epochs),
                         cfg, weights=w_s, mesh=self.mesh)
        metrics.update({f"student_{k}": v for k, v in m_s.items()})
        episodes, returns, t_records, s_records = global_sums(
            [(roll_s.done & (w_s > 0)).sum(), (roll_s.reward * w_s).sum(),
             w_t.sum(), w_s.sum()], self.mesh)
        metrics["student_episode_return"] = returns / episodes.clamp(min=1)
        metrics["episodes"] = episodes
        metrics["teacher_records"] = t_records
        metrics["student_records"] = s_records
        self._sync()
        metrics["collect_seconds"] = t1 - t0
        metrics["update_seconds"] = time.perf_counter() - t1
        return metrics

    def _evaluate(self, net: torch.nn.Module) -> dict:
        """Win rates of ``net``'s sampling policy against random and
        greedy, half the games as each colour, with
        ``test_init_rand_steps`` random opening plies."""
        run = self.run_cfg
        act = tournament.net_tournament_policy(net)
        out = {}
        for name, opp in (("rand", random_policy),
                          ("greedy", greedy_policy)):
            wins, _, _ = tournament.evaluate(
                act, opp, run.num_test_games, run.test_init_rand_steps,
                generator=self.generator, cfg=self.env_cfg,
                device=self.device)
            out[name] = wins / (2 * (run.num_test_games // 2))
        return out

    def train(self, num_chunks: int, log_every: int = 10,
              checkpoint_path: str | None = None) -> None:
        """``num_chunks`` chunks (JAX teacher_student.py:392-424): the
        student's evaluation every ``test_interval`` chunks refreshes
        ``win_avg`` and ``last_win_avg``, the teacher's every
        ``teacher_test_interval``; saves every ``save_interval`` and at
        the end (a ``{step}`` placeholder keeps one file a save)."""
        self.ensure_initialized()
        run = self.run_cfg
        for c in range(num_chunks):
            metrics = self.train_step()
            self.chunk_count += 1
            if (c + 1) % log_every == 0 or c == num_chunks - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["teacher_reward_signal"] = self.teacher_reward
                self._log(self.chunk_count, m)
            if self.chunk_count % run.test_interval == 0:
                wins = self._evaluate(self.net_s)
                self.last_win_avg = dict(self.win_avg)
                self.win_avg = wins
                self._log(self.chunk_count,
                          {f"win avg({k})": v for k, v in wins.items()})
            if self.chunk_count % run.teacher_test_interval == 0:
                self._log(self.chunk_count,
                          {f"win avg teacher({k})": v for k, v in
                           self._evaluate(self.net_t).items()})
            if checkpoint_path and self.chunk_count % run.save_interval == 0:
                self.save(checkpoint_path.format(step=self.chunk_count))
        if checkpoint_path:
            self.save(checkpoint_path.format(step=self.chunk_count))

    def evaluate_student(self) -> dict:
        return self._evaluate(self.net_s)

    def load_teacher(self, path: str) -> None:
        """Warm-start the teacher's params from a self-play checkpoint
        (ppo_run_teacher_vs_student.py:60, :120-121)."""
        _, params, _, _ = load_checkpoint(path)
        load_flax_params(self.net_t, params)

    def save(self, path: str) -> None:
        """``path + ".teacher"`` and ``path + ".student"``: the chunk count,
        each role's params and Adam state, as JAX's trainer writes them;
        on a mesh rank 0 alone writes."""
        if not is_main(self.mesh):
            return
        for suffix, net, opt in ((".teacher", self.net_t, self.opt_t),
                                 (".student", self.net_s, self.opt_s)):
            to_tree = functools.partial(flax_tree, net)
            save_checkpoint(path + suffix, self.chunk_count, to_tree(),
                            opt.to_optax_state(to_tree))

    def load(self, path: str) -> None:
        """Resume both roles from ``save``'s files (of either trainer)."""
        for suffix, net, opt in ((".teacher", self.net_t, self.opt_t),
                                 (".student", self.net_s, self.opt_s)):
            step, params, opt_state, _ = load_checkpoint(path + suffix)
            tensors = tensors_from_flax(net, params)
            opt.load_optax_state(opt_state,
                                 functools.partial(tensors_from_flax, net))
            with torch.no_grad():
                for p, t in zip(net.parameters(), tensors):
                    p.copy_(t)
        self.chunk_count = step

    def _log(self, step: int, metrics: dict) -> None:
        if not is_main(self.mesh):
            return
        if self.log_fn:
            self.log_fn(step, metrics)
        else:
            text = " ".join(f"{k}={v:.4g}" for k, v in metrics.items())
            print(f"[chunk {step}] {text}", flush=True)
