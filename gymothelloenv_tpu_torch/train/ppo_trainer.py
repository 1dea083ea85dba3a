"""PPO self-play trainer — the port of ``train/ppo_trainer.py``
(``SelfPlayConfig``, ``make_network``, ``PPOSelfPlayTrainer``,
``load_eval_policy``, ``net_lookahead_policy``, ``play_games_recurrent``
and its cells): mirror self-play, or an opponent pool of frozen snapshots
and anchor checkpoints; random openings; the lookahead override in
collection, on a ``lookahead_mix`` share of updates; recurrent (GRU),
frame-stacked and time-limited PPO; a net computed in bfloat16; and the
eval-time value-lookahead search (depths 1 and 2 and a depth-3 beam, and
depth 1 for a recurrent or frame-stacked net).

One update collects ``num_steps`` slots from ``num_envs`` games
(``train/self_play.py``) and runs ``agents/ppo.ppo_update`` (or
``ppo_update_recurrent``) on them; every
``test_interval`` updates the net plays random and greedy, half the games
per colour (``train/tournament.evaluate``); every ``save_interval`` updates
``train`` writes a checkpoint.  Checkpoints are the JAX trainer's files
(flax msgpack, ``utils/checkpoint.py``): params in flax layout
(``models/convert.py``) and optax's optimizer state
(``agents/ppo.Optimizer.to_optax_state``), so either trainer resumes the
other's run.

Randomness: a generator on the training device for the collector's
colours and samples and for the evaluation games, a CPU generator for
each update's shuffle key words (the recurrent update's env
permutations), both seeded from ``SelfPlayConfig.seed``,
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
                                                ppo_update,
                                                ppo_update_recurrent)
from gymothelloenv_tpu_torch.core.engine import engine_of, get_engine
from gymothelloenv_tpu_torch.core.featurize import make_state
from gymothelloenv_tpu_torch.core.state import (EnvConfig, OthelloState,
                                                index_games)
from gymothelloenv_tpu_torch.models.convert import (architecture,
                                                    flax_leaves, flax_tree,
                                                    load_flax_params,
                                                    policy_net_from_flax,
                                                    tensors_from_flax)
from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.models.nets import (FrameStackCell, PolicyNet,
                                                 params_net)
from gymothelloenv_tpu_torch.ops.shuffle import draw_words
from gymothelloenv_tpu_torch.policies import scripted
from gymothelloenv_tpu_torch.policies.scripted import (expand_legal,
                                                       greedy_policy,
                                                       random_policy)
from gymothelloenv_tpu_torch.train import tournament
from gymothelloenv_tpu_torch.train.self_play import (
    LEAF_SLICE, NEG, Draws, collect_rollout,
    collect_rollout_recurrent, collect_rollout_time_limited,
    make_lookahead_override, node_values, selfplay_init,
    selfplay_init_recurrent)
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
    # bfloat16 net compute; the params stay float32 (models/nets.py).
    bf16: bool = False
    # GRU-recurrent policy (model.py:230-285): the hidden state threads
    # through collection, and the update's minibatches are env subsets,
    # so num_envs must divide by PPOConfig.num_mini_batch.
    recurrent: bool = False
    # Channel frame stacking (VecPyTorchFrameStack, envs.py:210-250): the
    # net sees the last K observations over its channels, newest last,
    # zeroed at episode starts; it rides the recurrent machinery as a
    # cell whose state holds the previous K-1 frames.  1 = off; exclusive
    # with ``recurrent``.
    frame_stack: int = 1
    # Episode step cap (TimeLimit + TimeLimitMask, envs.py:110-119 +
    # storage.py:79-96): episodes are truncated after this many
    # protagonist decisions, and GAE zeroes the truncated advantages.
    # 0 = off.  Feed-forward only.
    max_episode_plies: int = 0


def make_network(cfg: EnvConfig, hidden_size: int = 512,
                 width_mult: int = 1, seed: int = 0, device=None,
                 recurrent: bool = False, bf16: bool = False,
                 frame_stack: int = 1) -> PolicyNet:
    """A seeded orthogonal init of ``PolicyNet``: recurrent or not,
    computing in bfloat16 or float32, with ``4 * frame_stack`` input
    channels."""
    net = PolicyNet(num_actions=cfg.num_actions, hidden_size=hidden_size,
                    width_mult=width_mult, board_size=cfg.board_size,
                    recurrent=recurrent, in_channels=4 * frame_stack,
                    dtype=torch.bfloat16 if bf16 else torch.float32)
    net.reset_parameters(torch.Generator().manual_seed(seed))
    return net.to(resolve_device(device))


def make_split_fns(net: PolicyNet) -> tuple:
    """``(features, core, heads)`` of a recurrent ``PolicyNet``, for
    ``ppo_update_recurrent``'s batched trunk."""
    return net.features, net.core, net.heads


def load_eval_policy(path: str, cfg: EnvConfig = EnvConfig(), device=None):
    """Load a policy checkpoint for evaluation (JAX ppo_trainer.py:
    334-392): a msgpack checkpoint, whose ``width_mult``, ``hidden_size``,
    GRU core and frame stack come from the stored shapes, or a reference
    torch ``.pth``/``.pt`` (``compat.torch_import``).  Returns ``(policy,
    description)``, the description as JAX writes it (``"step 2500,
    width_mult=2, hidden=512, recurrent"``, ``"torch checkpoint
    (architecture: dqn)"``): a ``PolicyNet`` (a recurrent one takes
    ``(obs, h, mask)``), for a frame-stacked net its ``FrameStackCell``,
    and for a torch file the imported net as a policy ``net(obs) ->
    (logits, value)`` (``compat.torch_import.imported_policy``).  A
    policy that threads state has ``recurrent`` True and its state width
    in ``hidden_size``.  ``cfg``: the board the net plays; a checkpoint
    whose logits are for another board raises ``ValueError``.  Sets
    float32 numerics (``use_float32``: TF32 off), so every evaluation
    path, the stateful one too, convolves in float32."""
    use_float32()
    if path.endswith((".pth", ".pt")):
        from gymothelloenv_tpu_torch.compat.torch_import import (
            detect_and_import, imported_policy, load_torch_checkpoint)
        kind, net = detect_and_import(load_torch_checkpoint(path),
                                      device=device)
        if cfg.board_size != 8:
            raise ValueError(f"{path}: the reference nets play the 8x8 "
                             f"board, not board_size={cfg.board_size}")
        return (imported_policy(kind, net),
                f"torch checkpoint (architecture: {kind})")
    step, raw, _, _ = load_checkpoint(path)
    arch = architecture(raw)
    if arch["board_size"] != cfg.board_size:
        raise ValueError(
            f"{path}: the net plays a {arch['board_size']}x"
            f"{arch['board_size']} board, not board_size={cfg.board_size}")
    net = policy_net_from_flax(raw, device=device)
    stack = arch["frame_stack"]
    policy = (FrameStackCell(net, stack, cfg.board_size)
              if stack > 1 and not arch["recurrent"] else net)
    extra = ("" if arch["width_mult"] == 1 and arch["hidden_size"] == 512
             else f", width_mult={arch['width_mult']}, "
                  f"hidden={arch['hidden_size']}")
    extra += ", recurrent" if arch["recurrent"] else ""
    extra += f", frame_stack={stack}" if stack > 1 else ""
    return policy, f"step {step}{extra}"


def net_sampling_cell(net: torch.nn.Module):
    """A stateful policy as a batched sampling actor ``cell(states, h,
    draws) -> (actions, h')`` (JAX ``net_sampling_cell``): the state
    advances on the observations, and each game samples its masked
    logits with one uniform from ``draws``."""
    def cell(states, h: torch.Tensor, draws):
        with torch.inference_mode():
            logits, _, h_new = net(make_state(states), h,
                                   torch.ones(h.shape[0], device=h.device))
            dist = MaskedCategorical(
                logits=logits, mask=engine_of(states).legal_flat(states))
            u = draws.uniforms(h.shape[0], h.device)
            return dist.sample(u=u), h_new
    return cell


@torch.no_grad()
def lookahead_recurrent(net: torch.nn.Module, states, h: torch.Tensor,
                        cfg: EnvConfig):
    """The recurrent depth-1 lookahead on a batch of games (JAX
    ``net_lookahead_cell_recurrent``'s cell).  The state first consumes
    the current observation (``h_cur``); each legal child (one
    ``expand_legal``, one ply-kernel launch) is scored by one step of
    ``net`` from ``h_cur`` over the child's observation, a terminal child
    by its true reward, negated where the turn passes.  Returns
    ``(action, scores, margin, h_cur)``: the argmax of the legal values
    (the first maximum; action 0 without a legal move), the (N, B*B)
    values (``NEG`` where illegal), the best value over the second
    (``inf`` without a second) and the state to carry.  Bit or plane
    games, as ``expand_legal``."""
    n = h.shape[0]
    ones = torch.ones(n, device=h.device)
    _, _, h_cur = net(make_state(states), h, ones)
    parent, action, child, reward = expand_legal(states, states.legal, cfg)
    _, v, _ = net(make_state(child), h_cur[parent], ones[parent])
    mover_v = torch.where(child.turn == states.turn[parent], v, -v)
    vals = torch.where(child.terminated, reward, mover_v)
    scores = torch.full((n, cfg.num_actions), NEG, dtype=vals.dtype,
                        device=h.device)
    scores[parent, action] = vals
    top = scores.topk(2, dim=1).values
    margin = torch.where(top[:, 1] > NEG, top[:, 0] - top[:, 1],
                         torch.full_like(top[:, 0], float("inf")))
    return torch.argmax(scores, dim=1), scores, margin, h_cur


def net_lookahead_cell_recurrent(net: torch.nn.Module, cfg: EnvConfig,
                                 depth: int = 1):
    """``lookahead_recurrent`` as a stateful actor ``cell(states, h,
    draws) -> (actions, h_cur)``: the carried state advances to
    ``h_cur``, never to a child's.  ``cfg`` carries the training reward
    scale.  Depth 1 only, as in JAX."""
    if depth != 1:
        raise NotImplementedError(
            "recurrent lookahead supports depth 1 only (depth-2 would "
            "thread A^2 speculative hiddens per game)")
    use_float32()

    def cell(states, h: torch.Tensor, draws=None):
        del draws
        action, _, _, h_cur = lookahead_recurrent(net, states, h, cfg)
        return action, h_cur
    return cell


def rec_lookahead_game_bytes(net: torch.nn.Module) -> int:
    """Device bytes one game of the recurrent lookahead takes: 34 children
    (no position has more than 33 legal moves), each a node, its board's
    forward and ~8 rows of state (the state and the GRU's gates)."""
    state = 4 * 8 * net.hidden_size
    return 34 * (scripted.NODE_BYTES + _board_bytes(params_net(net)) + state)


def play_games_recurrent(cfg: EnvConfig, net: torch.nn.Module, opp_policy,
                         num_games: int, net_color: int,
                         init_rand_steps: int = 0, hidden_size: int = 512,
                         act_cell=None, opp_cell=None,
                         opp_hidden_size: int = 0, draws=None,
                         generator: torch.Generator | None = None,
                         device=None) -> torch.Tensor:
    """Evaluation games of a stateful ``net`` (JAX
    ``play_games_recurrent``) on ``net_color`` against ``opp_policy``, a
    tournament policy ``(state, generator) -> actions``, or with
    ``opp_cell`` a second stateful actor with its own ``opp_hidden_size``
    state.  Returns winners int8 (N,).

    The games step in lockstep on ``get_engine(cfg)``, one ``step_where``
    a ply (on 8x8 one ply-kernel launch), for at most ``B * B`` plies.
    The net's state advances on every live ply where it is the net's
    turn, random-opening plies included (the collector advances
    ``h_prot`` on every protagonist decision); the opponent's on its own
    live turns.
    ``act_cell``: a stateful actor ``(states, h, draws) -> (actions, h')``
    in place of the sampling cell (the recurrent lookahead).  ``draws``
    (``train.self_play.Draws`` over ``generator`` by default) gives the
    random-opening counts, each ply's random legal move and the sampling
    uniforms; a tournament opponent samples from ``generator``."""
    device = resolve_device(device)
    if draws is None:
        draws = Draws(generator)
    eng = get_engine(cfg)
    states = eng.reset_batch(num_games, cfg, device)
    rand_left = draws.rand_left(num_games, init_rand_steps, device)
    h = torch.zeros(num_games, hidden_size, device=device)
    h_opp = torch.zeros(num_games, opp_hidden_size, device=device)
    cell = act_cell if act_cell is not None else net_sampling_cell(net)
    ply = 0
    while ply < cfg.num_actions and not bool(states.terminated.all()):
        a_net, h_new = cell(states, h, draws)
        if opp_cell is None:
            a_opp, h_opp_new = opp_policy(states, generator), h_opp
        else:
            a_opp, h_opp_new = opp_cell(states, h_opp, draws)
        a_rand = eng.random_legal(
            states, draws.legal_index(eng.legal_count(states)))
        net_turn = states.turn == net_color
        action = torch.where(rand_left > 0, a_rand,
                             torch.where(net_turn, a_net, a_opp))
        live = ~states.terminated
        h = torch.where((net_turn & live)[:, None], h_new, h)
        h_opp = torch.where((~net_turn & live)[:, None], h_opp_new, h_opp)
        states = eng.step_where(states, action, live, cfg)
        rand_left = torch.where(live, (rand_left - 1).clamp(min=0),
                                rand_left)
        ply += 1
    return states.winner


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
    t, b = net.trunk, net.board_size
    side = (b + 1) // 2                 # conv0's output side
    floats = (4 * b * b + side ** 2 * t.conv0.out_channels
              + max(side - 1, 0) ** 2 * t.conv1.out_channels
              + max(side - 2, 0) ** 2 * t.conv2.out_channels
              + net.fc.out_features + net.logits.out_features + 1)
    return 2 * 4 * floats + 4096


def _room(budget, kept: int, board: int, node: int):
    """The most pairs a level may expand within ``budget`` bytes when
    ``kept`` are held: each pair's ``node`` bytes while it expands, plus
    the forward over ``min(pairs, LEAF_SLICE)`` boards.  ``None``: no
    limit."""
    if budget is None:
        return None
    per = node + _KEPT_BYTES
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


def _replies(nodes, root_turn: torch.Tensor, cfg: EnvConfig, room):
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


def _lookahead(net, depth: int, beam_k: int, cfg: EnvConfig, state,
               budget):
    """``lookahead_search`` on one chunk of games within ``budget`` bytes
    (``None``: no limit); ``None`` when a level would not fit."""
    n = state.turn.shape[0]
    dev = state.turn.device
    board = _board_bytes(net)
    # A pair's bytes while its level expands: words, or a plane board and
    # the plane rules' temporaries.
    node = (scripted.PLANE_NODE_BYTES_PER_CELL * cfg.num_actions
            if isinstance(state, OthelloState) else scripted.NODE_BYTES)
    kept = 0
    got = expand_legal(state, state.legal, cfg,
                       _room(budget, kept, board, node))
    if got is None:
        return None
    p1, a1, c1, r1 = got
    t1 = state.turn[p1]
    kept += _KEPT_BYTES * p1.shape[0]
    if depth == 1:
        score1 = node_values(net, c1, r1, t1)
    elif depth == 2:
        got = _replies(c1, t1, cfg, _room(budget, kept, board, node))
        if got is None:
            return None
        p2, c2, r2, t2 = got
        best = _backup(node_values(net, c2, r2, t2), p2, p1.shape[0],
                       c1.turn == t1)
        score1 = torch.where(c1.terminated, r1, best)
    if depth < 3:
        scores = torch.full((n, cfg.num_actions), NEG, dtype=score1.dtype,
                            device=dev)
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
    cb, tb_ = index_games(c1, sel), t1[sel]
    got = _replies(cb, tb_, cfg, _room(budget, kept, board, node))
    if got is None:
        return None
    p2, c2, r2, t2 = got
    kept += _KEPT_BYTES * p2.shape[0]
    got = _replies(c2, t2, cfg, _room(budget, kept, board, node))
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
    scores = torch.full((n, cfg.num_actions), NEG, dtype=deep.dtype,
                        device=dev)
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
def lookahead_search(net: PolicyNet, state, cfg: EnvConfig,
                     depth: int = 1, beam_k: int = 8,
                     expand_chunk: int = 0):
    """``net_lookahead_policy``'s search on a batch of games.  Returns
    ``(action, scores, margin)``: int64 (N,) decisions; float32 (N, B*B)
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

    def act(state, generator=None) -> torch.Tensor:
        del generator
        return lookahead_search(net, state, cfg, depth, beam_k,
                                expand_chunk)[0]
    return act


class PPOSelfPlayTrainer:
    """``device``: where the games, the net and the update run (``None``:
    the current CUDA card; raises without one).  ``mesh`` raises (ROADMAP.md
    queue 1 item 13)."""

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
                                      "ported yet: ROADMAP.md queue 1 "
                                      "item 13")
        run = self.run_cfg
        # JAX's guards and wording (ppo_trainer.py:573-601, :710-726).
        if run.opponent_pool > 0 and run.pool_interval < 1:
            raise ValueError(
                f"pool_interval must be >= 1 when opponent_pool is on "
                f"(got {run.pool_interval})")
        if run.pool_anchors and run.opponent_pool <= 0:
            raise ValueError("pool_anchors requires opponent_pool > 0 "
                             "(anchors join the snapshot pool's draw)")
        stacked = run.frame_stack > 1
        if run.recurrent and stacked:
            raise ValueError("recurrent and frame_stack are mutually "
                             "exclusive (both thread policy state)")
        # Both paths ride the recurrent collector and update.
        self._rec_like = run.recurrent or stacked
        self._time_limited = run.max_episode_plies > 0
        if self._time_limited and self._rec_like:
            raise ValueError("max_episode_plies is feed-forward only")
        if run.lookahead_collect and (self._rec_like or self._time_limited):
            raise ValueError("lookahead_collect needs the plain "
                             "feed-forward collector (no recurrent/"
                             "frame-stack/max_episode_plies)")
        if self._rec_like and run.num_envs % self.ppo_cfg.num_mini_batch:
            raise ValueError(
                f"recurrent/frame-stack PPO needs num_envs "
                f"({run.num_envs}) divisible by num_mini_batch "
                f"({self.ppo_cfg.num_mini_batch})")
        if run.chain_updates > 1 and run.opponent_pool > 0:
            raise ValueError("chain_updates > 1 is incompatible with "
                             "opponent_pool (snapshots re-draw per "
                             "update on host)")
        mix = run.lookahead_mix
        if run.lookahead_collect and not 0.0 < mix <= 1.0:
            raise ValueError(f"lookahead_mix must be in (0, 1], got {mix}")
        self._mixed = run.lookahead_collect and mix < 1.0
        if self._mixed and run.chain_updates > 1:
            raise ValueError("lookahead_mix < 1 is incompatible with "
                             "chain_updates > 1 (the chain bakes one "
                             "collection mode)")
        self.device = resolve_device(device)
        use_float32()
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to train on the CPU")
        seed = run.seed
        self.net = make_network(self.env_cfg, run.hidden_size,
                                run.width_mult, seed, self.device,
                                recurrent=run.recurrent, bf16=run.bf16,
                                frame_stack=run.frame_stack).train()
        # What the collector and the update call: the net, or the
        # frame-stack cell over it; and the width of its state (0 for a
        # feed-forward net).
        self.policy = (FrameStackCell(self.net, run.frame_stack,
                                      self.env_cfg.board_size)
                       if stacked else self.net)
        self._state_size = (self.policy.hidden_size if self._rec_like
                            else 0)
        self._split_fns = (make_split_fns(self.net) if run.recurrent
                           else None)
        self.optimizer = self._make_optimizer()
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

    def _make_optimizer(self):
        """The update's optimizer over the net's parameters (PPO's clipped,
        scheduled Adam; a subclass's own)."""
        return make_optimizer(self.ppo_cfg, self.net.parameters())

    def _frozen_copy(self) -> torch.nn.Module:
        """A frozen copy of the training policy (the net, or its
        frame-stack cell)."""
        policy = copy.deepcopy(self.policy)
        policy.requires_grad_(False)
        return policy

    def _load_anchor(self, path: str) -> torch.nn.Module:
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
                anchor = self._frozen_copy()
                load_flax_params(params_net(anchor), params)
                return anchor
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
            run = self.run_cfg
            opp = self._draw_opponent() if run.opponent_pool > 0 else None
            if self._rec_like:
                self.sp_state = selfplay_init_recurrent(
                    self.policy, self.env_cfg, run.num_envs,
                    self._state_size, self.draws, run.init_rand_steps,
                    opp_net=opp)
                return
            self.sp_state = selfplay_init(
                self.net, self.env_cfg, run.num_envs, self.draws,
                run.init_rand_steps, opp_net=opp,
                act_override=self._override)
            if self._time_limited:
                # The init state's pending decision is ply 1.
                self.sp_state = (self.sp_state, torch.ones(
                    run.num_envs, dtype=torch.int32, device=self.device))

    def _draw_opponent(self) -> torch.nn.Module:
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

    def _sp(self):
        """The collector's ``SelfPlayState`` (the time-limited state pairs
        it with ``elapsed``)."""
        return self.sp_state[0] if self._time_limited else self.sp_state

    def _collect_and_update(self, opp_net) -> dict:
        """One collection, with the lookahead override where
        ``_pick_lookahead`` says so, and one PPO update: the recurrent
        collector and update for a recurrent or frame-stacked net, the
        time-limited collector and proper-time-limit GAE with
        ``max_episode_plies`` (metric ``truncations``).  Metrics are 0-d
        tensors and floats; ``lookahead`` is 1.0 where the collection used
        the override,
        ``collect_seconds``/``update_seconds`` are host wall times that end
        in a device synchronisation, ``collect_syncs`` the host reads of
        the collector's opponent loop."""
        run, ppo_cfg = self.run_cfg, self.ppo_cfg
        lookahead = self._pick_lookahead()
        syncs = self._sp().host_syncs
        self._sync()
        t0 = time.perf_counter()
        extra = {}
        if self._rec_like:
            self.sp_state, rollout, h0, masks, bootstrap = \
                collect_rollout_recurrent(
                    self.policy, self.sp_state, self.env_cfg, run.num_steps,
                    self.draws, run.init_rand_steps, opp_net=opp_net)
            self._sync()
            t1 = time.perf_counter()
            metrics = ppo_update_recurrent(
                self.policy, self.optimizer, rollout, h0, masks, bootstrap,
                ppo_cfg, generator=self.shuffle_generator,
                split_fns=self._split_fns)
        elif self._time_limited:
            sp, elapsed = self.sp_state
            sp, elapsed, rollout, bad, bootstrap = \
                collect_rollout_time_limited(
                    self.net, sp, elapsed, self.env_cfg, run.num_steps,
                    run.max_episode_plies, self.draws, run.init_rand_steps,
                    opp_net=opp_net)
            self.sp_state = (sp, elapsed)
            self._sync()
            t1 = time.perf_counter()
            words = draw_words(self.shuffle_generator, ppo_cfg.ppo_epochs)
            metrics = ppo_update(self.net, self.optimizer, rollout,
                                 bootstrap, words, ppo_cfg,
                                 bad_transition=bad)
            extra["truncations"] = bad.sum()
        else:
            self.sp_state, rollout, bootstrap = collect_rollout(
                self.net, self.sp_state, self.env_cfg, run.num_steps,
                self.draws, run.init_rand_steps, opp_net=opp_net,
                act_override=self._override if lookahead else None)
            self._sync()
            t1 = time.perf_counter()
            words = draw_words(self.shuffle_generator, ppo_cfg.ppo_epochs)
            metrics = ppo_update(self.net, self.optimizer, rollout,
                                 bootstrap, words, ppo_cfg)
        metrics.update(extra)
        episodes = rollout.done.sum()
        metrics["episode_return"] = (rollout.reward.sum()
                                     / episodes.clamp(min=1))
        metrics["episodes"] = episodes
        self._sync()
        metrics["collect_seconds"] = t1 - t0
        metrics["update_seconds"] = time.perf_counter() - t1
        metrics["collect_syncs"] = self._sp().host_syncs - syncs
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
        opening plies (rule_base_game, ppo_run_self_play.py:371-441); a
        recurrent or frame-stacked net through ``play_games_recurrent``."""
        n = self.run_cfg.num_test_games // 2
        rand_steps = self.run_cfg.test_init_rand_steps
        act = (None if self._rec_like else
               tournament.net_tournament_policy(self.net))
        results = {}
        for name, opp in (("rand", random_policy),
                          ("greedy", greedy_policy)):
            if self._rec_like:
                black, white = (play_games_recurrent(
                    self.env_cfg, self.policy, opp, n, color, rand_steps,
                    self._state_size, generator=self.generator,
                    device=self.device) for color in (-1, 1))
                wins = int((black == -1).sum()) + int((white == 1).sum())
            else:
                wins, _, _ = tournament.evaluate(
                    act, opp, 2 * n, rand_steps, generator=self.generator,
                    cfg=self.env_cfg, device=self.device)
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
        layout (another net, a recurrent tree for a feed-forward net or the
        reverse) raises before anything changes."""
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
        self.optimizer = self._make_optimizer()
        self.update_count = 0
