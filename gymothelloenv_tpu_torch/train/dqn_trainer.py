"""DQN self-play and vs-scripted trainer — the port of
``train/dqn_trainer.py`` (the ``run_2agent.py`` training loop driving
``DQNAgent``, dqn.py).

Collection follows run_2agent.py:118-160: at a colour's decision the
colour's previous ``(state, action)`` pair is emitted as a transition whose
next-state is the current decision state (reward 0); at the end of a game
both colours' outstanding pairs are emitted with the terminal outcome from
each colour's side (scaled by ``reward_scale``) and the terminal board as
next-state.  Transitions pass through the n-step FIFO (``agents/nstep.py``;
black's N streams, then white's) into the replay, and minibatch updates run
at the reference's one update per ``train_interval`` transitions, a chunk
at a time: ``chunk_plies`` plies, then ``max(1, chunk_plies * N * per_ply
// (2 * train_interval))`` updates (JAX dqn_trainer.py:438), skipped until
``t >= initial_replay_size``.  The target net syncs when a chunk's
transitions cross a multiple of ``target_update_interval``.

Modes: shared self-play (both colours learn into one agent), the
protagonist against ``opponent`` ``rand`` or ``greedy`` (its colour
redrawn each game, run_2agent.py:94-97), or the opponent pool: the
non-learning colour played greedily by a frozen snapshot, one pushed every
``pool_interval`` chunks, the last ``opponent_pool`` kept.

The games step on ``core.engine.get_engine(cfg, force_plane)``: on 8x8 in
bitboard words, each ply one launch of the ply kernel on the card, the
boards unpacked to the replay's signed int8 layout at each ply; with
``force_plane`` or off 8x8, plane games.  A ply inserts its emissions into
the replay at once, in JAX's order, so the ring holds what JAX's one insert
a chunk writes.  One host read a chunk: its number of transitions.

The algorithm hooks (``_setup_algo``, ``_init_agent``, ``_epsilon``,
``_agent_act``, ``_agent_train_batch``, ``_opponent_greedy`` and
``_eval_act``) are what a subclass (``train/rainbow_trainer.py``)
overrides.  Where JAX's hooks take a key, these take a draws object: the
acting, training and evaluation hooks draw every random number they need
(epsilon uniforms, random moves, replay uniforms, Rainbow's noise) from
it.

Randomness: one ``train.self_play.Draws`` over a generator on the training
device, seeded from ``DQNRunConfig.seed``: colours, random-opening counts,
random legal moves, the epsilon uniforms, the replay's uniforms and the
noisy nets' normals; and ``random.Random(seed)`` for the pool's draws, as
JAX.

Under a mesh (``mesh``, a ``parallel.DataMesh``; JAX dqn_trainer.py:113-204,
:394-524) ``num_envs`` is the global batch and each data index plays its
``N / S`` games with the per-game draws made at the global shape
(``train.self_play.ShardedDraws``), so a world-S collection is world 1's
game for game; the pending pairs and the n-step FIFOs hold the rank's
games.  With the replicated replay (the default) every rank holds the
whole ring: each ply's emissions are all-gathered and put back into world
1's order before the insert (JAX flattens (push, slot, 2N streams) with
black's N streams first; a rank's own streams are two separated blocks of
that axis, black's and white's), the minibatch rows are drawn the same
on every rank, the gradients are data parallel and every rank refreshes
its replica's priorities from every row's error
(``agents.dqn.dqn_train_batch(mesh=)``), so the replicas stay bit-equal.
With ``replay_sharding="per-shard"`` each rank inserts its own games'
rows into its own ring of ``capacity / S`` and samples through
``parallel/replay_shards.py``.  ``t`` counts the global transitions, so
the target sync, the pool's snapshots and epsilon follow world 1's.  The
ranks of a model axis play the same games as their data index's first.
Every rank evaluates (with the global draws, the same on every rank) and
only process 0 logs and writes checkpoints.
"""

from __future__ import annotations

import dataclasses
import functools
import random as pyrandom
import time
from typing import Optional

import torch

from gymothelloenv_tpu_torch.agents.dqn import (DQNConfig, DQNState,
                                                dqn_act, dqn_init,
                                                dqn_train_batch, epsilon_at,
                                                featurize3, frozen_copy,
                                                greedy_legal_action,
                                                maybe_sync_target)
from gymothelloenv_tpu_torch.agents.nstep import nstep_init, nstep_push
from gymothelloenv_tpu_torch.agents.replay import (FIELDS, ReplayConfig,
                                                   insert_emitted,
                                                   pack_bytes, replay_init,
                                                   row_layout, unpack_bytes)
from gymothelloenv_tpu_torch.core.engine import engine_of, get_engine
from gymothelloenv_tpu_torch.core.state import EnvConfig
from gymothelloenv_tpu_torch.models.convert import (flax_tree,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.parallel import replay_shards
from gymothelloenv_tpu_torch.parallel.sharding import (all_gather_cat,
                                                       all_reduce_sum,
                                                       check_data_mesh,
                                                       is_main, mesh_device,
                                                       place_replicated)
from gymothelloenv_tpu_torch.policies.scripted import greedy_policy
from gymothelloenv_tpu_torch.train import tournament
from gymothelloenv_tpu_torch.train.self_play import Draws, ShardedDraws
from gymothelloenv_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      save_checkpoint)
from gymothelloenv_tpu_torch.utils.device import use_float32


@dataclasses.dataclass(frozen=True)
class DQNRunConfig:
    num_envs: int = 128
    chunk_plies: int = 64          # plies collected a chunk
    opponent: Optional[str] = None  # None = self-play | 'rand' | 'greedy'
    init_rand_steps: int = 0
    test_init_rand_steps: int = 10
    num_test_games: int = 200
    test_interval: int = 50        # chunks
    save_interval: int = 200
    seed: int = 0
    force_plane: bool = False      # keep the plane engine on 8x8 (A/B)
    # > 0: in self-play, the non-learning colour plays greedily from a
    # frozen snapshot drawn from the last K (one pushed every
    # pool_interval chunks) instead of the live net.
    opponent_pool: int = 0
    pool_interval: int = 100
    # Under a mesh: 'replicated' (every rank holds the whole ring; global
    # sampling, world 1's PER exactly) or 'per-shard' (each rank a ring of
    # capacity / S of its own games' rows, sampled globally through
    # parallel/replay_shards.py; for a ring that no longer fits a card).
    replay_sharding: str = "replicated"


@dataclasses.dataclass
class PendingPair:
    """Per colour (leading axis 2: black, white) the outstanding
    ``(state, action)`` pair awaiting its next-state."""
    board: torch.Tensor    # int8 (2, N, B, B)
    turn: torch.Tensor     # int8 (2, N)
    action: torch.Tensor   # int64 (2, N)
    valid: torch.Tensor    # bool (2, N)


@dataclasses.dataclass
class DQNRollState:
    env: object            # BitState (8x8) or OthelloState
    rand_left: torch.Tensor  # int64 (N,)
    pcolor: torch.Tensor   # int8 (N,) protagonist colour (vs-scripted)
    pending: PendingPair
    fifo: tuple            # (black's, white's) NStepFifo of N streams


_COLOURS = ((0, -1), (1, 1))


@dataclasses.dataclass
class _Rows:
    """One push's gathered emissions (``agents.nstep.Emitted``'s fields),
    tensors (slot, N streams, ...)."""
    board: torch.Tensor
    turn: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_board: torch.Tensor
    next_turn: torch.Tensor
    done: torch.Tensor
    valid: torch.Tensor


class DQNTrainer:
    """``device``: where the games, the nets, the replay and the updates
    run (``None``: the current CUDA card, or the mesh's; raises without
    one).  ``mesh``: a ``parallel.DataMesh`` (see the module's
    docstring); per-shard replay needs one, and a capacity, batch and
    ``2 * num_envs`` that divide by its data axis, else ``ValueError``
    (JAX's checks); the minibatch must divide by the data axis under the
    replicated replay too (each rank takes a contiguous share)."""

    def __init__(self, env_cfg: EnvConfig = None, dqn_cfg: DQNConfig = None,
                 rb_cfg: ReplayConfig = None, run_cfg: DQNRunConfig = None,
                 log_fn=None, mesh=None, device=None):
        self.env_cfg = env_cfg or EnvConfig(num_disk_as_reward=True)
        self.dqn_cfg = dqn_cfg or DQNConfig(
            board_size=self.env_cfg.board_size)
        self.rb_cfg = rb_cfg or ReplayConfig(
            board_size=self.env_cfg.board_size)
        self.run_cfg = run_cfg or DQNRunConfig()
        self.log_fn = log_fn
        self.mesh = None if mesh is None else check_data_mesh(mesh)
        if self.run_cfg.replay_sharding not in ("replicated", "per-shard"):
            raise ValueError(self.run_cfg.replay_sharding)
        self._per_shard = self.run_cfg.replay_sharding == "per-shard"
        if self._per_shard:
            if mesh is None:
                raise ValueError("per-shard replay requires a mesh")
            S = self.mesh.world
            for name, val in (("capacity", self.rb_cfg.capacity),
                              ("batch_size", self.dqn_cfg.batch_size),
                              ("2*num_envs", 2 * self.run_cfg.num_envs)):
                if val % S:
                    raise ValueError(f"{name}={val} not divisible by "
                                     f"data shards {S}")
            # rb_cfg.capacity is the global capacity; each rank owns an
            # equal slice of it.
            self._per_shard_cfg = dataclasses.replace(
                self.rb_cfg, capacity=self.rb_cfg.capacity // S)
        self.device = mesh_device(self.mesh, device)
        use_float32()
        self.generator = torch.Generator(self.device).manual_seed(
            self.run_cfg.seed)
        n = self.run_cfg.num_envs
        self.local_envs = n
        self.draws = Draws(self.generator)
        if self.mesh is not None:
            self.local_envs = self.mesh.shard(n)[0]
            # Each rank takes a contiguous share of every minibatch: the
            # batch must split over the data axis (this raises if not).
            self.mesh.shard(self.dqn_cfg.batch_size)
            self.draws = ShardedDraws(self.draws, self.mesh, n)
        self._setup_algo()
        self.agent = self._init_agent()
        if self.mesh is not None:
            place_replicated([self.agent.net, self.agent.target], self.mesh)
        self.replay = replay_init(
            self._per_shard_cfg if self._per_shard else self.rb_cfg,
            self.device)
        self.roll: DQNRollState | None = None
        self.chunk_count = 0
        self.pool: list = []
        self._pool_rng = pyrandom.Random(self.run_cfg.seed)
        run = self.run_cfg
        self._use_pool = run.opponent_pool > 0 and run.opponent is None
        self._selfplay = run.opponent is None and not self._use_pool
        self.eng = get_engine(self.env_cfg, run.force_plane)

    # -- algorithm hooks ------------------------------------------------
    def _setup_algo(self) -> None:
        """The algorithm's fixed parts (JAX: the apply function and the
        optax optimizer; here both live in the agent state)."""

    def _init_agent(self) -> DQNState:
        return dqn_init(self.dqn_cfg, self.run_cfg.seed, self.device)

    def _epsilon(self, t: int) -> torch.Tensor:
        return epsilon_at(self.dqn_cfg, t)

    def _agent_act(self, net, board, turn, legal, eps,
                   draws) -> torch.Tensor:
        return dqn_act(net, board, turn, legal, eps, draws)

    def _agent_train_batch(self, agent, replay, draws) -> torch.Tensor:
        if self._per_shard:
            return replay_shards.dqn_train_batch_pershard(
                agent, replay, self.dqn_cfg, self._per_shard_cfg, draws,
                self.mesh)
        return dqn_train_batch(agent, replay, self.dqn_cfg, self.rb_cfg,
                               draws, mesh=self.mesh)

    @torch.no_grad()
    def _opponent_greedy(self, snap, board, turn, legal) -> torch.Tensor:
        """Greedy action of a frozen snapshot (the pool mode)."""
        return greedy_legal_action(snap(featurize3(board, turn)), legal)

    @torch.no_grad()
    def _eval_act(self, net, state, draws) -> torch.Tensor:
        """The epsilon-greedy evaluation action at ``test_epsilon``
        (get_action_at_test, dqn.py:478-488), its random move and uniform
        from ``draws``."""
        eng = engine_of(state)
        board, turn = eng.board_turn(state)
        return dqn_act(net, board, turn, eng.legal_flat(state),
                       self.dqn_cfg.test_epsilon, draws)

    # -- collection -----------------------------------------------------
    def _init_roll(self) -> DQNRollState:
        run, n = self.run_cfg, self.local_envs
        b, dev = self.env_cfg.board_size, self.device
        env = self.eng.reset_batch(n, self.env_cfg, dev)
        rand_left = tournament.draw_max_rand_steps(
            self.draws, n, run.init_rand_steps, dev)
        pcolor = self.draws.colors(n, dev)
        pending = PendingPair(
            board=torch.zeros((2, n, b, b), dtype=torch.int8, device=dev),
            turn=torch.zeros((2, n), dtype=torch.int8, device=dev),
            action=torch.zeros((2, n), dtype=torch.int64, device=dev),
            valid=torch.zeros((2, n), dtype=torch.bool, device=dev))
        fifo = tuple(nstep_init(self.dqn_cfg.n_step, n, b, dev)
                     for _ in range(2))
        return DQNRollState(env=env, rand_left=rand_left, pcolor=pcolor,
                            pending=pending, fifo=fifo)

    def ensure_initialized(self) -> None:
        if self.roll is None:
            self.roll = self._init_roll()

    def _learner(self, roll: DQNRollState, colour: int) -> torch.Tensor:
        """Where ``colour`` learns: everywhere in self-play, else where it
        is the protagonist's."""
        if self._selfplay:
            return torch.ones_like(roll.pcolor, dtype=torch.bool)
        return roll.pcolor == colour

    def _push(self, fifo, pending, c, mask, reward, done, next_board,
              next_turn):
        return nstep_push(fifo[c], self.dqn_cfg.gamma, pending.board[c],
                          pending.turn[c], pending.action[c], reward,
                          next_board, next_turn, done, mask)

    @torch.no_grad()
    def _ply(self, roll: DQNRollState, eps, snap):
        """One ply of every game; returns ``(roll, emitted)``, the four
        pushes' emissions (pre-action black, white; terminal black,
        white)."""
        eng, cfg, run = self.eng, self.env_cfg, self.run_cfg
        env, pending = roll.env, roll.pending
        fifo, ems = list(roll.fifo), []
        live = ~env.terminated
        board, turn = eng.board_turn(env)
        legal = eng.legal_flat(env)
        zero = torch.zeros(turn.shape, dtype=torch.float32,
                           device=turn.device)
        valid = pending.valid.clone()

        # 1. The mover's previous pair, emitted against this state.
        for c, colour in _COLOURS:
            mask = (live & (turn == colour) & valid[c]
                    & self._learner(roll, colour))
            fifo[c], em = self._push(fifo, pending, c, mask, zero,
                                     torch.zeros_like(live), board, turn)
            ems.append(em)
            valid[c] &= ~mask

        # 2. The mover acts: the learner epsilon-greedy, the opponent
        # scripted or a snapshot.
        actions = self._agent_act(self.agent.net, board, turn, legal, eps,
                                  self.draws)
        if not self._selfplay:
            if self._use_pool:
                opp = self._opponent_greedy(snap, board, turn, legal)
            elif run.opponent == "rand":
                opp = eng.random_legal(env, self.draws.legal_index(
                    eng.legal_count(env)))
            elif run.opponent == "greedy":
                opp = eng.greedy(env)
            else:
                raise ValueError(run.opponent)
            actions = torch.where(turn == roll.pcolor, actions, opp)
        boards, turns = pending.board.clone(), pending.turn.clone()
        acts = pending.action.clone()
        for c, colour in _COLOURS:
            mask = live & (turn == colour) & self._learner(roll, colour)
            boards[c] = torch.where(mask[:, None, None], board, boards[c])
            turns[c] = torch.where(mask, turn, turns[c])
            acts[c] = torch.where(mask, actions, acts[c])
            valid[c] |= mask
        pending = PendingPair(board=boards, turn=turns, action=acts,
                              valid=valid)

        # 3. Step the live games, random openings first.
        rand_left = roll.rand_left
        if run.init_rand_steps > 0:
            use_rand = (rand_left > 0) & live
            rand = eng.random_legal(env, self.draws.legal_index(
                eng.legal_count(env)))
            actions = torch.where(use_rand, rand, actions)
            rand_left = torch.where(use_rand, rand_left - 1, rand_left)
        env = eng.step_where(env, actions, live, cfg)

        # 4. Terminal emissions for both colours.
        term = env.terminated & live
        next_board, next_turn = eng.board_turn(env)
        for c, colour in _COLOURS:
            outcome = eng.outcome_for(env, torch.full_like(turn, colour), cfg)
            mask = term & valid[c] & self._learner(roll, colour)
            fifo[c], em = self._push(
                fifo, pending, c, mask, outcome * self.dqn_cfg.reward_scale,
                torch.ones_like(live), next_board, next_turn)
            ems.append(em)
            valid[c] &= ~mask

        # 5. Reset finished games with fresh colours and openings.
        n, dev = term.shape[0], term.device
        env = eng.reset_where(env, term, cfg)
        if run.init_rand_steps > 0:
            rand_left = torch.where(term, tournament.draw_max_rand_steps(
                self.draws, n, run.init_rand_steps, dev), rand_left)
        pcolor = torch.where(term, self.draws.colors(n, dev), roll.pcolor)
        return DQNRollState(env=env, rand_left=rand_left, pcolor=pcolor,
                            pending=pending, fifo=tuple(fifo)), ems

    def _insert(self, ems) -> torch.Tensor:
        """One ply's emissions into the replay in JAX's order (push, then
        window slot, then stream); returns how many were valid (0-d, this
        rank's own under per-shard replay).  On a mesh with the
        replicated replay the four pushes' (slot, local stream) rows are
        all-gathered, one collective a ply of their packed bytes, and
        concatenated on the stream axis in rank order, which is world 1's
        stream order within each push."""
        if self._per_shard:
            return replay_shards.pershard_insert(
                self.replay, self._per_shard_cfg, ems)
        if self.mesh is not None:
            ems = self._gather_emissions(ems)
        return insert_emitted(self.replay, self.rb_cfg, ems)

    def _gather_emissions(self, ems) -> list:
        """Every rank's emissions of one ply, the streams in world 1's
        order: ``_Rows`` of (slot, N streams, ...) tensors, a push each."""
        names = FIELDS + ("valid",)
        pushes = torch.stack([pack_bytes([getattr(e, f) for f in names], 2)
                              for e in ems])
        full = all_gather_cat(pushes, self.mesh, axis=2)
        layout = row_layout(self.env_cfg.board_size) + ((torch.bool, ()),)
        fields = unpack_bytes(full, layout)
        return [_Rows(**{f: t[i] for f, t in zip(names, fields)})
                for i in range(len(ems))]

    def collect_chunk(self, snap=None) -> int:
        """``chunk_plies`` plies into the replay; returns the number of
        transitions inserted, over every rank's games on a mesh (the
        chunk's one host read)."""
        self.ensure_initialized()
        eps = self._epsilon(self.agent.t).to(self.device)
        added = torch.zeros(1, dtype=torch.int64, device=self.device)
        for _ in range(self.run_cfg.chunk_plies):
            self.roll, ems = self._ply(self.roll, eps, snap)
            added += self._insert(ems)
        if self._per_shard:
            all_reduce_sum([added], self.mesh)
        return int(added[0])

    def updates_per_chunk(self) -> int:
        """JAX's update count a chunk: about one learner transition a ply
        a learning colour, one update a ``train_interval`` of them."""
        per_ply = 2 if self._selfplay else 1
        return max(1, (self.run_cfg.chunk_plies * self.run_cfg.num_envs
                       * per_ply) // (2 * self.dqn_cfg.train_interval))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_chunk(self, snap=None) -> dict:
        """One chunk: collect, the minibatch updates (once ``t`` reaches
        ``initial_replay_size``), the target sync.  Metrics as JAX's, plus
        ``collect_seconds``/``update_seconds`` (host wall times ending in
        a device synchronisation) and ``updates``."""
        self._sync()
        t0 = time.perf_counter()
        t_old = self.agent.t
        self.agent.t = t_old + self.collect_chunk(snap)
        t1 = time.perf_counter()
        n_up = self.updates_per_chunk()
        if self.agent.t >= self.dqn_cfg.initial_replay_size:
            losses = torch.stack([self._agent_train_batch(
                self.agent, self.replay, self.draws) for _ in range(n_up)])
            loss = losses.mean()
        else:
            loss, n_up = torch.zeros(()), 0
        interval = self.dqn_cfg.target_update_interval
        maybe_sync_target(self.agent,
                          self.agent.t // interval != t_old // interval)
        size = (replay_shards.global_size(self.replay, self.mesh)
                if self._per_shard else self.replay.size)
        self._sync()
        return {"loss": loss, "epsilon": self._epsilon(self.agent.t),
                "transitions": self.agent.t,
                "replay_size": size,
                "collect_seconds": t1 - t0,
                "update_seconds": time.perf_counter() - t1,
                "updates": n_up}

    def _snapshot(self) -> torch.nn.Module:
        return frozen_copy(self.agent.net)

    def train(self, num_chunks: int, log_every: int = 10,
              checkpoint_path: str | None = None) -> None:
        """``num_chunks`` chunks (JAX dqn_trainer.py:533-571): logging every
        ``log_every`` and after the last, with ``transitions_per_sec``
        since the call began; evaluation every ``test_interval`` chunks;
        saves every ``save_interval`` and at the end (a ``{step}``
        placeholder keeps one file a save)."""
        self.ensure_initialized()
        run = self.run_cfg
        t0 = time.time()
        for c in range(num_chunks):
            snap = None
            if self._use_pool:
                if not self.pool:
                    self.pool.append(self._snapshot())
                snap = self.pool[self._pool_rng.randrange(len(self.pool))]
            metrics = self.train_chunk(snap)
            self.chunk_count += 1
            if self._use_pool and self.chunk_count % run.pool_interval == 0:
                self.pool.append(self._snapshot())
                if len(self.pool) > run.opponent_pool:
                    self.pool.pop(0)
            if (c + 1) % log_every == 0 or c == num_chunks - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["transitions_per_sec"] = m["transitions"] / (
                    time.time() - t0 + 1e-9)
                self._log(self.chunk_count, m)
            if self.chunk_count % run.test_interval == 0:
                self._log(self.chunk_count, {f"win%({k})": v for k, v in
                                             self.evaluate().items()})
            if checkpoint_path and self.chunk_count % run.save_interval == 0:
                self.save(checkpoint_path.format(step=self.chunk_count))
        if checkpoint_path:
            self.save(checkpoint_path.format(step=self.chunk_count))

    def evaluate(self, draws=None) -> dict:
        """Win rates of the epsilon-greedy net (``_eval_act``) against
        random and greedy, half the games as each colour, with
        ``test_init_rand_steps`` random opening plies.  Every random
        number (openings, the random moves, the epsilon uniforms) comes
        from ``draws``: the trainer's own by default (on a mesh their
        global stream, so every rank plays the same games),
        ``InjectedDraws`` in the parity tests."""
        net = self.agent.net
        draws = draws or self.draws
        if isinstance(draws, ShardedDraws):
            draws = draws.inner

        def act(state, generator=None):
            return self._eval_act(net, state, draws)

        def rand(state, generator=None):
            e = engine_of(state)
            return e.random_legal(state, draws.legal_index(
                e.legal_count(state)))
        run = self.run_cfg
        out = {}
        for name, opp in (("rand", rand), ("greedy", greedy_policy)):
            wins, _, _ = tournament.evaluate(
                act, opp, run.num_test_games, run.test_init_rand_steps,
                cfg=self.env_cfg, device=self.device, draws=draws)
            out[name] = wins / (2 * (run.num_test_games // 2))
        return out

    def _log(self, step: int, metrics: dict) -> None:
        if not is_main(self.mesh):
            return
        if self.log_fn:
            self.log_fn(step, metrics)
        else:
            text = " ".join(f"{k}={v:.4g}" for k, v in metrics.items())
            print(f"[chunk {step}] {text}", flush=True)

    def save(self, path: str) -> None:
        """The chunk count, the online params, the optimizer's state in
        optax's tree and ``extra.t``, as JAX's trainer writes them; on a
        mesh process 0 alone writes."""
        if not is_main(self.mesh):
            return
        net = self.agent.net
        to_tree = functools.partial(flax_tree, net)
        save_checkpoint(path, self.chunk_count, to_tree(),
                        self.agent.optimizer.to_optax_state(to_tree),
                        extra={"t": int(self.agent.t)})

    def load(self, path: str) -> None:
        """Resume from either trainer's checkpoint: params (online and
        target), the optimizer's state, ``t`` and the chunk count."""
        step, params, opt_state, extra = load_checkpoint(path)
        net = self.agent.net
        tensors = tensors_from_flax(net, params)
        self.agent.optimizer.load_optax_state(
            opt_state, functools.partial(tensors_from_flax, net))
        with torch.no_grad():
            for p, t in zip(net.parameters(), tensors):
                p.copy_(t)
        self.agent.target.load_state_dict(net.state_dict())
        self.agent.t = int(extra.get("t", 0))
        self.chunk_count = step
