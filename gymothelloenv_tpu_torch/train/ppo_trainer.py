"""PPO self-play trainer — the port of ``train/ppo_trainer.py``
(``SelfPlayConfig``, ``make_network``, ``PPOSelfPlayTrainer``,
``load_eval_policy``, ``net_lookahead_policy``) for the feed-forward
self-play path: mirror self-play, or an opponent pool of frozen snapshots
and anchor checkpoints; random openings; the lookahead override in
collection, on a ``lookahead_mix`` share of updates; and the eval-time
value-lookahead search (depths 1 and 2 and a depth-3 beam).

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
from gymothelloenv_tpu_torch.core import bitboard as bb
from gymothelloenv_tpu_torch.models.nets import PolicyNet
from gymothelloenv_tpu_torch.ops.shuffle import draw_words
from gymothelloenv_tpu_torch.policies import scripted
from gymothelloenv_tpu_torch.policies.scripted import (expand_legal,
                                                       greedy_policy,
                                                       random_policy)
from gymothelloenv_tpu_torch.train import tournament
from gymothelloenv_tpu_torch.train.self_play import (
    LEAF_SLICE, NEG, Draws, collect_rollout, make_lookahead_override,
    node_values, selfplay_init)
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
    # Random opening plies of each training game (env_init_rand_steps):
    # a game's first 2 * U{0..init_rand_steps // 2} plies are uniform
    # random legal moves.
    init_rand_steps: int = 0
    # Search-bootstrapped collection: the protagonist acts with the 1-ply
    # value lookahead (the raw policy's log-prob of that action is
    # stored, so PPO ratios start at 1) while the update trains the raw
    # net; opponent plies keep sampling.  Pair with PPOConfig.distill for
    # approximate policy iteration.
    lookahead_collect: bool = False
    # Softmax temperature over child values for the override (0 = argmax;
    # values on the training disk-difference scale, +-64).
    lookahead_tau: float = 0.0
    # Fraction of updates whose collection uses the override, interleaved
    # by a Bresenham accumulator (0.25: updates 4, 8, ...; 0.5 alternates
    # strictly).  Only with lookahead_collect.
    lookahead_mix: float = 1.0
    # Features of the JAX trainer that are not ported yet (ROADMAP.md):
    # any value other than the default raises in PPOSelfPlayTrainer.
    bf16: bool = False
    recurrent: bool = False
    frame_stack: int = 1
    max_episode_plies: int = 0


_UNPORTED = ("bf16", "recurrent", "frame_stack", "max_episode_plies")


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


# Device bytes a search node keeps for the backup (parent, move, turn,
# terminal flag, reward, value, and the beam's ranks), besides the
# scripted.NODE_BYTES it holds while its level is expanded.
_KEPT_BYTES = 96


def _board_bytes(net: torch.nn.Module) -> int:
    """Device bytes one board takes in a no-grad forward of ``net``: its
    input planes and every layer's output, twice over (a layer's input
    and output live at once), plus the featurisation's temporaries; 64 KB
    for a net that is not a ``PolicyNet``."""
    if not isinstance(net, PolicyNet):
        return 1 << 16
    t = net.trunk
    floats = (4 * 64 + 16 * t.conv0.out_channels + 9 * t.conv1.out_channels
              + 4 * t.conv2.out_channels + net.fc.out_features
              + net.logits.out_features + 1)
    return 2 * 4 * floats + 4096


def _room(budget, kept: int, board: int):
    """The most pairs a level may expand within ``budget`` bytes when
    ``kept`` are held: each pair's node bytes, plus the forward over
    ``min(pairs, LEAF_SLICE)`` boards.  ``None``: no limit."""
    if budget is None:
        return None
    per = scripted.NODE_BYTES + _KEPT_BYTES
    small = min((budget - kept) // (per + board), LEAF_SLICE)
    large = (budget - kept - board * LEAF_SLICE) // per
    return max(small, large if large >= LEAF_SLICE else -1)


def _backup(values: torch.Tensor, parent: torch.Tensor, m: int,
            is_max: torch.Tensor) -> torch.Tensor:
    """Each of ``m`` nodes' max (where ``is_max``) or min over its
    children's ``values``; ``NEG`` / ``-NEG`` for a node without
    children."""
    hi = torch.full((m,), NEG, dtype=values.dtype, device=values.device)
    lo = torch.full((m,), -NEG, dtype=values.dtype, device=values.device)
    hi = hi.scatter_reduce(0, parent, values, "amax")
    lo = lo.scatter_reduce(0, parent, values, "amin")
    return torch.where(is_max, hi, lo)


def _replies(nodes: bb.BitState, root_turn: torch.Tensor, cfg: EnvConfig,
             room):
    """Expand every legal reply of ``nodes`` (``expand_legal``); the
    replies' terminal rewards turned to the root mover's side.  Returns
    ``(parent, child, reward, root_turn)`` of the replies, or ``None``
    past ``room`` pairs."""
    got = expand_legal(nodes, nodes.legal, cfg, room)
    if got is None:
        return None
    parent, _, child, reward = got
    turn = root_turn[parent]
    reward = torch.where(nodes.turn[parent] == turn, reward, -reward)
    return parent, child, reward, turn


def _total_order(v: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as float32 ``v`` under IEEE total order (-0.0
    below +0.0), the order ``jax.lax.top_k`` ranks by."""
    bits = v.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _lookahead(net, depth: int, beam_k: int, cfg: EnvConfig,
               state: bb.BitState, budget):
    """``lookahead_search`` on one chunk of games within ``budget`` bytes
    (``None``: no limit); ``None`` when a level would not fit."""
    n = state.turn.shape[0]
    dev = state.turn.device
    board = _board_bytes(net)
    kept = 0
    got = expand_legal(state, state.legal, cfg, _room(budget, kept, board))
    if got is None:
        return None
    p1, a1, c1, r1 = got
    t1 = state.turn[p1]
    kept += _KEPT_BYTES * p1.shape[0]
    if depth == 1:
        score1 = node_values(net, c1, r1, t1)
    elif depth == 2:
        got = _replies(c1, t1, cfg, _room(budget, kept, board))
        if got is None:
            return None
        p2, c2, r2, t2 = got
        best = _backup(node_values(net, c2, r2, t2), p2, p1.shape[0],
                       c1.turn == t1)
        score1 = torch.where(c1.terminated, r1, best)
    if depth < 3:
        scores = torch.full((n, 64), NEG, dtype=score1.dtype, device=dev)
        scores[p1, a1] = score1
        top = scores.topk(2, dim=1).values
        return (torch.argmax(scores, dim=1), scores,
                torch.where(top[:, 0] > NEG, top[:, 0] - top[:, 1],
                            torch.full_like(top[:, 0], float("inf"))))

    # Beam: rank each root's children by depth-1 value, ties to the lower
    # action (jax.lax.top_k), keep the best beam_k, back each up exactly
    # to depth 2 below it.
    v1 = node_values(net, c1, r1, t1)
    order = torch.sort(-_total_order(v1), stable=True).indices
    order = order[torch.sort(p1[order], stable=True).indices]
    counts = torch.bincount(p1, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(p1.shape[0], device=dev) - starts[p1[order]]
    sel, sel_rank = order[rank < beam_k], rank[rank < beam_k]
    cb, tb_ = bb.index_state(c1, sel), t1[sel]
    got = _replies(cb, tb_, cfg, _room(budget, kept, board))
    if got is None:
        return None
    p2, c2, r2, t2 = got
    kept += _KEPT_BYTES * p2.shape[0]
    got = _replies(c2, t2, cfg, _room(budget, kept, board))
    if got is None:
        return None
    p3, c3, r3, t3 = got
    best2 = _backup(node_values(net, c3, r3, t3), p3, p2.shape[0],
                    c2.turn == t2)
    best1 = _backup(torch.where(c2.terminated, r2, best2), p2, sel.shape[0],
                    cb.turn == tb_)
    deep = torch.where(cb.terminated, r1[sel], best1)
    table = torch.full((n, beam_k), NEG, dtype=deep.dtype, device=dev)
    table[p1[sel], sel_rank] = deep
    moves = torch.zeros((n, beam_k), dtype=torch.int64, device=dev)
    moves[p1[sel], sel_rank] = a1[sel]
    action = moves.gather(1, torch.argmax(table, dim=1, keepdim=True))[:, 0]
    scores = torch.full((n, 64), NEG, dtype=deep.dtype, device=dev)
    scores[p1[sel], a1[sel]] = deep
    # Margins: the best deep value over the second, and the beam's last
    # depth-1 value over the first one left out.
    top = table.topk(min(2, beam_k), dim=1).values
    gap = (top[:, 0] - top[:, 1] if beam_k > 1
           else torch.full_like(top[:, 0], float("inf")))
    gap = torch.where(top[:, 0] > NEG, gap,
                      torch.full_like(gap, float("inf")))
    cut = torch.full((n,), float("inf"), dtype=v1.dtype, device=dev)
    edge = rank == beam_k - 1
    out = order[rank == beam_k]
    last = torch.full((n,), NEG, dtype=v1.dtype, device=dev)
    last[p1[order[edge]]] = v1[order[edge]]
    cut[p1[out]] = last[p1[out]] - v1[out]
    return action, scores, torch.minimum(gap, cut)


def _check_search(depth: int, beam_k: int, cfg: EnvConfig) -> None:
    if depth not in (1, 2, 3):
        raise ValueError(f"lookahead depth must be 1, 2 or 3, got {depth}")
    if depth == 3 and not 1 <= beam_k <= cfg.num_actions:
        raise ValueError(f"beam_k must be in [1, {cfg.num_actions}], got "
                         f"{beam_k}")


@torch.no_grad()
def lookahead_search(net: PolicyNet, state: bb.BitState, cfg: EnvConfig,
                     depth: int = 1, beam_k: int = 8,
                     expand_chunk: int = 0):
    """``net_lookahead_policy``'s search on a batch of games.  Returns
    ``(action, scores, margin)``: int64 (N,) decisions; float32 (N, 64)
    root-perspective values of the searched actions (the beam's deep
    values at its ``beam_k`` children; ``NEG`` elsewhere); float32 (N,)
    the least gap a decision rests on (best over second value, and for the
    beam its last kept depth-1 value over the first left out; ``inf``
    where no other choice exists).  ``expand_chunk`` as
    ``policies.scripted.chunked``."""
    _check_search(depth, beam_k, cfg)
    return scripted.chunked(
        functools.partial(_lookahead, net, depth, beam_k, cfg), state,
        expand_chunk)


def net_lookahead_policy(net: PolicyNet, cfg: EnvConfig, depth: int = 1,
                         beam_k: int = 8, expand_chunk: int = 0):
    """Eval-time value lookahead (JAX ppo_trainer.py:419-543) as a
    tournament policy: expand the legal moves with the exact rules, score
    leaves with the value head (negated where the leaf's player to move
    is not the root's), terminal leaves with their true reward, and back
    up max or min by whose turn each node is (the ply resolves passes, so
    a child can be a max node again).  Depth 1 is one forward over the
    legal children, depth 2 one over the legal grandchildren; depth 3 is
    a beam: the root's ``beam_k`` best children by depth-1 value, each
    backed up exactly to depth 2 below it (``beam_k`` 64 is exact depth
    3).  Ties: the first maximum in action order, and in the beam the
    better depth-1 rank.  A game without a legal move gets action 0.

    Each tree level is one ``expand_legal`` (one ply-kernel launch on the
    card); the net runs over at most ``LEAF_SLICE`` boards a forward.
    ``cfg`` must carry the training reward scale
    (``num_disk_as_reward=True``) so rewards and values are
    commensurable.  ``expand_chunk`` bounds the expansion as maximin's:
    0 fits half the card's free memory, > 0 forces that many games a
    chunk, < 0 is unchunked; chunks never change a decision."""
    use_float32()
    _check_search(depth, beam_k, cfg)

    def act(state: bb.BitState, generator=None) -> torch.Tensor:
        del generator
        return lookahead_search(net, state, cfg, depth, beam_k,
                                expand_chunk)[0]
    return act


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
        run = self.run_cfg
        # JAX's guards and wording (ppo_trainer.py:593-596, :719-726).
        if run.lookahead_collect and (
                run.recurrent or run.frame_stack > 1
                or run.max_episode_plies > 0):
            raise ValueError("lookahead_collect needs the plain "
                             "feed-forward collector (no recurrent/"
                             "frame-stack/max_episode_plies)")
        mix = run.lookahead_mix
        if run.lookahead_collect and not 0.0 < mix <= 1.0:
            raise ValueError(f"lookahead_mix must be in (0, 1], got {mix}")
        self._mixed = run.lookahead_collect and mix < 1.0
        if self._mixed and run.chain_updates > 1:
            raise ValueError("lookahead_mix < 1 is incompatible with "
                             "chain_updates > 1 (the chain bakes one "
                             "collection mode)")
        for name in _UNPORTED:
            if getattr(self.run_cfg, name) != getattr(default, name):
                raise NotImplementedError(
                    f"SelfPlayConfig.{name}={getattr(self.run_cfg, name)!r} "
                    "is not ported yet (ROADMAP.md)")
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
        self._override = (make_lookahead_override(self.env_cfg,
                                                  run.lookahead_tau)
                          if run.lookahead_collect else None)
        self._mix_err = 0.0
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
            self.sp_state = selfplay_init(
                self.net, self.env_cfg, self.run_cfg.num_envs, self.draws,
                self.run_cfg.init_rand_steps, opp_net=opp,
                act_override=self._override)

    def _draw_opponent(self) -> PolicyNet:
        """Uniform draw over the anchors and the snapshot ring (JAX
        ppo_trainer.py:854-861); the first draw snapshots the net."""
        if not self.pool:
            self.pool.append(self._frozen_copy())
        cands = self.anchors + self.pool
        return cands[self._pool_rng.randrange(len(cands))]

    def _pick_lookahead(self) -> bool:
        """Whether the next collection uses the lookahead override: every
        update with ``lookahead_mix`` 1, else a Bresenham accumulator
        picks a ``lookahead_mix`` share of updates (JAX ``_pick_step``,
        ppo_trainer.py:863-874)."""
        if not self._mixed:
            return self._override is not None
        self._mix_err += self.run_cfg.lookahead_mix
        if self._mix_err >= 1.0 - 1e-9:
            self._mix_err -= 1.0
            return True
        return False

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
        """One collection, with the lookahead override where
        ``_pick_lookahead`` says so, and one PPO update.  Metrics are 0-d
        tensors and floats; ``lookahead`` is 1.0 where the collection used
        the override,
        ``collect_seconds``/``update_seconds`` are host wall times that end
        in a device synchronisation, ``collect_syncs`` the host reads of
        the collector's opponent loop."""
        lookahead = self._pick_lookahead()
        syncs = self.sp_state.host_syncs
        self._sync()
        t0 = time.perf_counter()
        self.sp_state, rollout, bootstrap = collect_rollout(
            self.net, self.sp_state, self.env_cfg, self.run_cfg.num_steps,
            self.draws, self.run_cfg.init_rand_steps, opp_net=opp_net,
            act_override=self._override if lookahead else None)
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
        metrics["lookahead"] = float(lookahead)
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
