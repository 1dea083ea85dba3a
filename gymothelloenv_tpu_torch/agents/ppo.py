"""PPO with GAE — the port of ``agents/ppo.py`` (the vendored update rule,
a2c_ppo_acktr/algo/ppo.py:34-110 + storage.py:73-112): the feed-forward
update (with proper time limits or per-slot weights) and the recurrent one
(``ppo_update_recurrent``, the ``recurrent_generator`` path).

GAE is a reverse loop over T; the K-epoch minibatch loop indexes the flat
rollout with the epoch's hash permutation (``ops/shuffle.py``) and takes
one optimizer step per minibatch; the recurrent update's minibatches are
env subsets, each replaying the core over all T steps.  The TPU's gather workarounds
(``ops/gather.pack_rows``, one-hot selects) are not ported: the flat
tensors are indexed directly.

The optimizer reproduces ``optax.chain(clip_by_global_norm(max_norm),
adam(linear_schedule(lr -> 0), eps))``: the clip is written out
(``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, optax does
not), Adam keeps eps outside the square root as optax does, and the
learning rate is ``lr * (1 - step / total)`` with step 0 at the full rate.
Its state maps onto optax's for the JAX trainer's checkpoints
(``Optimizer.to_optax_state``/``load_optax_state``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gymothelloenv_tpu_torch.models.distributions import MaskedCategorical
from gymothelloenv_tpu_torch.ops.shuffle import (is_power_of_two,
                                                 minibatch_indices,
                                                 sort_perm)
from gymothelloenv_tpu_torch.parallel.sharding import (all_reduce_grads,
                                                       all_reduce_sum,
                                                       owned_rows)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyperparameters; defaults are the flagship trainer's hard-coded
    overrides (ppo_run_self_play.py:59-70) over get_args() defaults
    (arguments.py:6-161)."""
    lr: float = 1e-5
    adam_eps: float = 1e-5
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_param: float = 0.1
    ppo_epochs: int = 4
    num_mini_batch: int = 4
    value_loss_coef: float = 0.5
    entropy_coef: float = 0.0
    max_grad_norm: float = 0.5
    use_clipped_value_loss: bool = True
    use_linear_lr_decay: bool = True
    num_updates: int = 10000
    # "hash": keyed bijection per minibatch when T*N is a power of two,
    # else (and for "sort") a uniform permutation per epoch.
    shuffle: str = "hash"
    # Distillation (search-bootstrapped training): the clipped surrogate
    # becomes the cross-entropy to the taken action, -mean(logp), with the
    # value loss unchanged.  With the collector's lookahead override this
    # regresses the raw policy onto the searched actions.
    distill: bool = False

    def __post_init__(self):
        if self.shuffle not in ("hash", "sort"):
            raise ValueError(f"shuffle must be 'hash' or 'sort', got "
                             f"{self.shuffle!r}")


@dataclasses.dataclass
class Transition:
    """Rollout slots, shapes (T, N, ...) from the collector (or flat
    minibatch rows)."""
    obs: torch.Tensor     # int8 (..., 4, B, B) {0,1} planes
    action: torch.Tensor  # int64
    logp: torch.Tensor    # float32 behaviour log-prob
    value: torch.Tensor   # float32 behaviour value estimate
    reward: torch.Tensor  # float32
    done: torch.Tensor    # bool: the episode ended with this transition
    legal: torch.Tensor   # bool (..., B*B) legal mask at sample time


class Optimizer:
    """``make_optimizer``'s result: global-norm clip, then Adam with a
    linear learning-rate decay, over ``params``.  ``step()`` uses and
    leaves the parameters' ``.grad``; nothing synchronises with the
    host."""

    def __init__(self, params, cfg: PPOConfig):
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = cfg.max_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr,
                                     betas=(0.9, 0.999), eps=cfg.adam_eps)
        self.schedule = None
        if cfg.use_linear_lr_decay:
            total = cfg.num_updates * cfg.ppo_epochs * cfg.num_mini_batch
            if total <= 0:
                raise ValueError("linear lr decay needs num_updates, "
                                 "ppo_epochs and num_mini_batch > 0")
            self.schedule = torch.optim.lr_scheduler.LambdaLR(
                self.adam, lambda step: 1.0 - min(step, total) / total)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        clip_by_global_norm(self.params, self.max_norm)
        self.adam.step()
        if self.schedule is not None:
            self.schedule.step()

    def to_optax_state(self, to_tree) -> dict:
        """The state of JAX's ``make_optimizer`` chain as flax stores it:
        ``{"0": {} (clip), "1": {"0": {count, mu, nu} (adam), "1":
        {count} (schedule) or {} (constant lr)}}``, counts int32 0-d
        arrays (``adam_optax_state``).  ``to_tree`` maps one tensor per
        parameter, in ``self.params`` order, to the flax tree
        (``models.convert.flax_tree``)."""
        schedule = ({} if self.schedule is None else
                    {"count": np.asarray(self.schedule.last_epoch, np.int32)})
        return {"0": {}, "1": {
            "0": adam_optax_state(self.adam, self.params, to_tree),
            "1": schedule}}

    def load_optax_state(self, state, from_tree) -> None:
        """Set the optimizer from ``to_optax_state``'s layout (a JAX
        trainer's ``opt_state``): Adam's moments from ``mu``/``nu`` through
        ``from_tree`` (``models.convert.tensors_from_flax``), each
        parameter's ``step`` from adam's count, and the schedule's
        ``last_epoch`` from its count, with each group's ``lr`` recomputed
        to ``lr * (1 - k / total)``.  Another layout raises
        ``ValueError``: optax.flatten's flat vectors
        (``flatten_optimizer``), the tree of another net (a GRU where
        the net has none, or the reverse), or a schedule
        state where this optimizer has a constant rate (or none where it
        has one)."""
        kind = "a linear schedule" if self.schedule else "a constant lr"

        def bad(why):
            return ValueError(f"optimizer state is not the layout of optax "
                              f"clip_by_global_norm -> adam with {kind}: "
                              f"{why}")

        def keys(node, want, where):
            if not isinstance(node, dict) or set(node) != set(want):
                got = sorted(node) if isinstance(node, dict) else \
                    type(node).__name__
                raise bad(f"{where} holds {got}, expected {sorted(want)}")

        keys(state, ("0", "1"), "the chain")
        keys(state["0"], (), "clip_by_global_norm")
        keys(state["1"], ("0", "1"), "adam")
        adam = state["1"]["0"]
        keys(adam, ("count", "mu", "nu"), "scale_by_adam")
        keys(state["1"]["1"], ("count",) if self.schedule else (),
             "the schedule")
        try:
            load_adam_state(self.adam, self.params, adam, from_tree)
        except ValueError as err:
            raise bad(err) from err
        if self.schedule is not None:
            k = int(np.asarray(state["1"]["1"]["count"]))
            self.schedule.last_epoch = k
            for group, base, lam in zip(self.adam.param_groups,
                                        self.schedule.base_lrs,
                                        self.schedule.lr_lambdas):
                group["lr"] = base * lam(k)
            self.schedule._last_lr = [g["lr"] for g in
                                      self.adam.param_groups]


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax ``clip_by_global_norm`` on the params' ``.grad``, in place:
    ``g / norm * max_norm`` when ``norm >= max_norm``, else ``g``
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm, optax
    does not)."""
    grads = [p.grad for p in params]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    factor = torch.where(norm < max_norm, torch.ones_like(norm),
                         max_norm / norm)
    for g in grads:
        g.mul_(factor)


def adam_optax_state(adam: torch.optim.Adam, params, to_tree) -> dict:
    """optax ``scale_by_adam``'s state ``{count, mu, nu}`` of a
    ``torch.optim.Adam`` over ``params``: ``exp_avg``/``exp_avg_sq`` are
    ``mu``/``nu`` (through ``to_tree``) and each parameter's ``step`` the
    int32 ``count``; before the first step all are zero."""
    states = [adam.state.get(p, {}) for p in params]
    counts = {int(s["step"]) if "step" in s else 0 for s in states}
    if len(counts) != 1:
        raise ValueError(f"Adam steps differ between parameters: "
                         f"{sorted(counts)}")
    mu = to_tree([s.get("exp_avg", torch.zeros_like(p))
                  for p, s in zip(params, states)])
    nu = to_tree([s.get("exp_avg_sq", torch.zeros_like(p))
                  for p, s in zip(params, states)])
    return {"count": np.asarray(counts.pop(), np.int32), "mu": mu, "nu": nu}


def load_adam_state(adam: torch.optim.Adam, params, node, from_tree) -> None:
    """The inverse of ``adam_optax_state``: ``node``'s ``mu``/``nu``
    through ``from_tree`` (``models.convert.tensors_from_flax``) and its
    count as every parameter's ``step``.  A tree of another net raises
    ``ValueError``."""
    mu, nu = from_tree(node["mu"]), from_tree(node["nu"])
    step = torch.tensor(float(int(np.asarray(node["count"]))),
                        dtype=torch.float32)
    for p, m, v in zip(params, mu, nu, strict=True):
        adam.state[p] = {"step": step.clone(),
                         "exp_avg": m.to(p).contiguous(),
                         "exp_avg_sq": v.to(p).contiguous()}


class Adam:
    """optax ``adam(lr, b1, b2, eps)`` on ``.grad`` (``torch.optim.Adam``,
    whose eps sits outside the root as optax's does), with the DQN
    optimizer's interface: ``zero_grad``, ``step`` and the state in
    optax's tree, ``{"0": {count, mu, nu}, "1": {}}``.  Rainbow's
    optimizer, simple PPO's, GAIL's discriminator's and the BC
    warm-start's."""

    def __init__(self, params, lr: float, eps: float = 1e-8,
                 betas: tuple = (0.9, 0.999)):
        self.params = [p for p in params if p.requires_grad]
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=tuple(betas),
                                     eps=eps)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.adam.step()

    def to_optax_state(self, to_tree) -> dict:
        return {"0": adam_optax_state(self.adam, self.params, to_tree),
                "1": {}}

    def load_optax_state(self, state, from_tree) -> None:
        """The inverse of ``to_optax_state``; another layout raises
        ``ValueError``."""
        if (not isinstance(state, dict) or set(state) != {"0", "1"}
                or not isinstance(state["0"], dict)
                or set(state["0"]) != {"count", "mu", "nu"} or state["1"]):
            raise ValueError("optimizer state is not the layout of optax "
                             "adam ({'0': {count, mu, nu}, '1': {}})")
        load_adam_state(self.adam, self.params, state["0"], from_tree)


def make_optimizer(cfg: PPOConfig, params) -> Optimizer:
    return Optimizer(params, cfg)


@torch.no_grad()
def compute_gae(rollout: Transition, bootstrap_value: torch.Tensor,
                cfg: PPOConfig):
    """Returns ``(advantages, returns)``, both (T, N); storage.py:99-112
    without proper time limits.  ``mask_{t+1} = 1 - done_t``."""
    next_values = torch.cat([rollout.value[1:], bootstrap_value[None]], 0)
    next_mask = 1.0 - rollout.done.to(torch.float32)
    deltas = (rollout.reward + cfg.gamma * next_values * next_mask
              - rollout.value)
    adv = torch.empty_like(deltas)
    gae = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        # delta + (gamma * lambda * mask) * gae in ONE rounding: XLA
        # contracts the JAX recursion into a fused multiply-add, and
        # addcmul keeps the port bit-equal to it.
        gae = torch.addcmul(deltas[t], cfg.gamma * cfg.gae_lambda
                            * next_mask[t], gae)
        adv[t] = gae
    return adv, adv + rollout.value


@torch.no_grad()
def compute_gae_time_limits(rollout: Transition,
                            bad_transition: torch.Tensor,
                            bootstrap_value: torch.Tensor, cfg: PPOConfig):
    """GAE with proper time limits (storage.py:79-96): a transition cut by
    the step cap (``bad_transition``, (T, N) bool from
    ``envs.vec_wrappers.time_limit_step``) has its advantage zeroed and
    nothing bootstraps back through it.  With no truncation it equals
    ``compute_gae`` exactly."""
    next_values = torch.cat([rollout.value[1:], bootstrap_value[None]], 0)
    next_mask = 1.0 - rollout.done.to(torch.float32)
    bad_mask = 1.0 - bad_transition.to(torch.float32)
    deltas = (rollout.reward + cfg.gamma * next_values * next_mask
              - rollout.value)
    adv = torch.empty_like(deltas)
    gae = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        # (delta + c * mask * gae) * bad, the sum in one rounding as XLA's
        # fused multiply-add (see compute_gae).
        gae = torch.addcmul(deltas[t], cfg.gamma * cfg.gae_lambda
                            * next_mask[t], gae) * bad_mask[t]
        adv[t] = gae
    return adv, adv + rollout.value


@torch.no_grad()
def compute_gae_masked(rollout: Transition, weights: torch.Tensor,
                       bootstrap_value: torch.Tensor, cfg: PPOConfig):
    """GAE over streams with invalid (weight-0) slots, which are
    transparent: the recursion state and the successor value pass through
    them unchanged.  Returns ``(advantages, returns)``, (T, N), meaningful
    only where ``weights > 0``."""
    valid = weights > 0
    not_done = 1.0 - rollout.done.to(torch.float32)
    adv = torch.empty_like(rollout.value)
    gae = torch.zeros_like(bootstrap_value)
    v_next = bootstrap_value
    for t in range(adv.shape[0] - 1, -1, -1):
        v = rollout.value[t]
        delta = rollout.reward[t] + cfg.gamma * v_next * not_done[t] - v
        # One rounding for the recursion, as XLA's fused multiply-add
        # (see compute_gae).
        new_gae = torch.addcmul(delta, cfg.gamma * cfg.gae_lambda
                                * not_done[t], gae)
        adv[t] = new_gae
        gae = torch.where(valid[t], new_gae, gae)
        v_next = torch.where(valid[t], v, v_next)
    return adv, adv + rollout.value


def ppo_loss(net: torch.nn.Module, batch: Transition,
             advantages: torch.Tensor, returns: torch.Tensor,
             cfg: PPOConfig, weights: torch.Tensor | None = None,
             denom=None):
    """Clipped-surrogate PPO loss on a flat minibatch (algo/ppo.py:50-104);
    returns ``(total, {value_loss, action_loss, entropy})``."""
    logits, values = net(batch.obs.to(torch.float32))
    return ppo_loss_terms(logits, values, batch, advantages, returns, cfg,
                          weights, denom)


def ppo_loss_terms(logits: torch.Tensor, values: torch.Tensor,
                   batch: Transition, advantages: torch.Tensor,
                   returns: torch.Tensor, cfg: PPOConfig,
                   weights: torch.Tensor | None = None, denom=None):
    """The loss given the network's outputs on the minibatch; ``weights``
    (per-row 0/1) leave weight-0 rows out of every mean.  ``denom``: the
    means' denominator (the row count, or the weight sum clamped at 1)
    given from outside, as one rank's share of a minibatch spread over a
    mesh divides its sums by the whole minibatch's."""
    if weights is None and denom is None:
        def wmean(x):
            return x.mean()
    else:
        w = 1.0 if weights is None else weights
        if denom is None:
            denom = weights.sum().clamp(min=1.0)

        def wmean(x):
            return (x * w).sum() / denom

    dist = MaskedCategorical(logits=logits, mask=batch.legal)
    logp = dist.log_prob(batch.action)
    if cfg.distill:
        # Cross-entropy to the taken (search-improved) action; the
        # advantages are unused.
        action_loss = -wmean(logp)
    else:
        ratio = torch.exp(logp - batch.logp)
        surr1 = ratio * advantages
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param,
                            1.0 + cfg.clip_param) * advantages
        action_loss = -wmean(torch.minimum(surr1, surr2))

    if cfg.use_clipped_value_loss:
        value_clipped = batch.value + torch.clamp(
            values - batch.value, -cfg.clip_param, cfg.clip_param)
        value_loss = 0.5 * wmean(torch.maximum(
            (values - returns) ** 2, (value_clipped - returns) ** 2))
    else:
        value_loss = 0.5 * wmean((returns - values) ** 2)

    # Reference entropy bonus: the UNMASKED softmax (model.py:178-179).
    entropy = wmean(dist.entropy_full())
    total = (value_loss * cfg.value_loss_coef + action_loss
             - entropy * cfg.entropy_coef)
    return total, {"value_loss": value_loss, "action_loss": action_loss,
                   "entropy": entropy}


def _advantages(rollout: Transition, bootstrap_value: torch.Tensor,
                cfg: PPOConfig, weights=None, bad_transition=None,
                mesh=None):
    """GAE (plain, with proper time limits, or over weighted slots) and
    the normalised advantages (population std, as JAX's ``std``; the
    weighted mean and std with ``weights``), over every rank's games on
    a ``mesh``.  Returns ``(adv, returns)``."""
    if bad_transition is not None:
        if weights is not None:
            raise ValueError("weights and bad_transition are exclusive")
        adv, returns = compute_gae_time_limits(rollout, bad_transition,
                                               bootstrap_value, cfg)
    elif weights is None:
        adv, returns = compute_gae(rollout, bootstrap_value, cfg)
    else:
        adv, returns = compute_gae_masked(rollout, weights,
                                          bootstrap_value, cfg)
    return normalize_advantages(adv, weights, mesh), returns


def normalize_advantages(adv: torch.Tensor, weights=None, mesh=None):
    """``(adv - mean) / (std + 1e-5)``, population std as JAX's ``std``;
    weighted by ``weights`` where given.  On a ``mesh`` the moments are
    the global batch's: the weight, sum and sum of squares of every
    rank's advantages in one float64 ``all_reduce``."""
    if mesh is None:
        if weights is None:
            return (adv - adv.mean()) / (adv.std(correction=0) + 1e-5)
        denom = weights.sum().clamp(min=1.0)
        mean = (adv * weights).sum() / denom
        var = (((adv - mean) ** 2) * weights).sum() / denom
        return (adv - mean) / (torch.sqrt(var) + 1e-5)
    a = adv.to(torch.float64)
    w = (torch.ones_like(a) if weights is None
         else weights.to(torch.float64))
    moments = torch.stack([w.sum(), (w * a).sum(), (w * a * a).sum()])
    all_reduce_sum([moments], mesh)
    count = moments[0].clamp(min=1.0)
    mean = moments[1] / count
    var = (moments[2] / count - mean * mean).clamp(min=0.0)
    return ((adv - mean.to(adv.dtype))
            / (torch.sqrt(var).to(adv.dtype) + 1e-5))


def _mesh_step(optimizer, mesh, terms) -> torch.Tensor:
    """Sum the grads and the loss terms over the ranks in one collective,
    then take the optimizer step (the same on every rank); returns the
    summed terms."""
    all_reduce_grads(optimizer.params, mesh, [terms])
    optimizer.step()
    return terms


def ppo_update(net: torch.nn.Module, optimizer: Optimizer,
               rollout: Transition, bootstrap_value: torch.Tensor,
               epoch_words: torch.Tensor, cfg: PPOConfig,
               weights: torch.Tensor | None = None,
               bad_transition: torch.Tensor | None = None, mesh=None):
    """One full PPO update in place on ``net``: GAE, advantage
    normalisation, then ``ppo_epochs`` epochs of ``num_mini_batch``
    shuffled minibatches.

    ``epoch_words`` (ppo_epochs, 4): each epoch's shuffle key words (JAX:
    ``jax.random.bits(k, (4,))`` for each ``k`` in
    ``jax.random.split(key, ppo_epochs)``).  ``weights`` (optional (T, N)
    0/1) leave weight-0 slots out (``compute_gae_masked``);
    ``bad_transition`` (optional (T, N) bool, exclusive with ``weights``)
    switches GAE to ``compute_gae_time_limits``.  Returns the metrics
    averaged over every minibatch, as 0-d tensors on the rollout's
    device.

    ``mesh`` (a ``parallel.DataMesh``): the rollout holds this rank's
    games, the update computes the one-process update of the global
    batch: the advantages are normalised over every rank's, each
    minibatch is the same set of global rows as at world 1 (the
    permutation over ``T * N`` global rows), each rank sums the loss of
    the rows it holds over the whole minibatch's count (or weight) and
    the gradients are summed over the ranks before the step, which every
    rank then takes alike.  A rank whose share of a minibatch is empty
    still joins each collective."""
    if tuple(epoch_words.shape) != (cfg.ppo_epochs, 4):
        raise ValueError(f"epoch_words must be ({cfg.ppo_epochs}, 4), got "
                         f"{tuple(epoch_words.shape)}")
    adv, returns = _advantages(rollout, bootstrap_value, cfg, weights,
                               bad_transition, mesh)

    T, n_local = rollout.reward.shape
    N = n_local * (1 if mesh is None else mesh.world)
    batch_size = T * N
    mb_size = batch_size // cfg.num_mini_batch
    device = rollout.reward.device
    flat = {name: getattr(rollout, name).reshape(
        (T * n_local,) + getattr(rollout, name).shape[2:])
        for name in ("obs", "action", "logp", "value", "legal")}
    flat_adv, flat_ret = adv.reshape(-1), returns.reshape(-1)
    flat_w = None if weights is None else weights.reshape(-1)
    use_hash = cfg.shuffle == "hash" and is_power_of_two(batch_size)

    minibatches = []
    for words in epoch_words.tolist():
        perm = None if use_hash else sort_perm(words, batch_size, device)
        for mb in range(cfg.num_mini_batch):
            if use_hash:
                idx = minibatch_indices(words, batch_size, mb, mb_size,
                                        device)
            else:
                idx = perm[mb * mb_size:(mb + 1) * mb_size]
            minibatches.append(idx if mesh is None
                               else owned_rows(idx, N, mesh)[1])
    denoms = [None] * len(minibatches)
    if mesh is not None:
        # Each minibatch's global row count or weight, in one collective.
        if flat_w is None:
            denoms = [float(mb_size)] * len(minibatches)
        else:
            sums = torch.stack([flat_w[idx].sum() for idx in minibatches])
            all_reduce_sum([sums], mesh)
            denoms = list(sums.clamp(min=1.0))

    metrics = []
    for idx, denom in zip(minibatches, denoms):
        batch = Transition(reward=None, done=None,
                           **{k: v[idx] for k, v in flat.items()})
        w = None if flat_w is None else flat_w[idx]
        optimizer.zero_grad()
        if mesh is None:
            loss, terms = ppo_loss(net, batch, flat_adv[idx], flat_ret[idx],
                                   cfg, w)
            loss.backward()
            optimizer.step()
            metrics.append(torch.stack([t.detach() for t in terms.values()]))
            continue
        terms = torch.zeros(3, device=device)
        if idx.numel():
            loss, parts = ppo_loss(net, batch, flat_adv[idx],
                                   flat_ret[idx], cfg, w, denom)
            loss.backward()
            terms = torch.stack([t.detach() for t in parts.values()])
        metrics.append(_mesh_step(optimizer, mesh, terms))
    mean = torch.stack(metrics).mean(0)
    return dict(zip(("value_loss", "action_loss", "entropy"), mean))


def ppo_update_recurrent(net: torch.nn.Module, optimizer: Optimizer,
                         rollout: Transition, h0: torch.Tensor,
                         masks: torch.Tensor, bootstrap_value: torch.Tensor,
                         cfg: PPOConfig, perms=None,
                         generator: torch.Generator | None = None,
                         split_fns: tuple | None = None, mesh=None):
    """The recurrent PPO update (JAX ``ppo_update_recurrent``; the vendored
    ``recurrent_generator``, storage.py:159-216) in place on ``net``.

    Minibatches are env subsets, ``N // num_mini_batch`` envs each; every
    optimizer step replays the core over all ``T`` steps from each env's
    rollout-start hidden state ``h0`` (N, H), zeroing it where ``masks``
    (T, N) is 0 (``masks[t] = 1 - done[t-1]``, ``masks[0]`` the validity
    of ``h0``).  ``net(obs_t, h, mask_t) -> (logits, value, h')``.
    ``split_fns``: ``(features, core, heads)`` of ``net``
    (``PolicyNet.features/core/heads``); then the trunk runs once over all
    ``T * envs`` rows of a minibatch and only ``core`` steps through T.

    ``perms``: one env permutation (N,) per epoch (JAX draws
    ``jax.random.permutation(epoch_key, N)``); ``None`` draws them with
    ``torch.randperm`` from ``generator`` (on the CPU).  Returns the
    metrics averaged over every minibatch.

    ``mesh``: as ``ppo_update``'s, with games as the unit: the
    permutations run over the ``N`` global games, each rank replays the
    minibatch's games it holds and divides by the whole minibatch's
    ``T * envs`` rows, the gradients are summed over the ranks."""
    adv, returns = compute_gae(rollout, bootstrap_value, cfg)
    adv = normalize_advantages(adv, mesh=mesh)
    T, n_local = rollout.reward.shape
    N = n_local * (1 if mesh is None else mesh.world)
    if N % cfg.num_mini_batch:
        raise ValueError(
            f"num_envs ({N}) must divide by num_mini_batch "
            f"({cfg.num_mini_batch}) for the recurrent generator")
    envs_mb = N // cfg.num_mini_batch
    device = rollout.reward.device
    if perms is None:
        perms = [torch.randperm(N, generator=generator)
                 for _ in range(cfg.ppo_epochs)]
    if len(perms) != cfg.ppo_epochs:
        raise ValueError(f"perms must hold {cfg.ppo_epochs} permutations, "
                         f"got {len(perms)}")
    fields = ("obs", "action", "logp", "value", "legal")

    def replay(obs, mb_h0, mb_masks):
        """(logits (T*envs, A), values (T*envs,)) of the minibatch."""
        envs = obs.shape[1]
        if split_fns is not None:
            features, core, heads = split_fns
            feats = features(obs.reshape((T * envs,) + obs.shape[2:]))
            feats = feats.reshape(T, envs, -1)
            h, ys = mb_h0, []
            for t in range(T):
                y, h = core(feats[t], h, mb_masks[t])
                ys.append(y)
            return heads(torch.cat(ys))
        h, logits, values = mb_h0, [], []
        for t in range(T):
            lg, v, h = net(obs[t], h, mb_masks[t])
            logits.append(lg)
            values.append(v)
        return torch.cat(logits), torch.cat(values)

    metrics = []
    for perm in perms:
        perm = torch.as_tensor(perm, dtype=torch.int64, device=device)
        for mb in range(cfg.num_mini_batch):
            idx = perm[mb * envs_mb:(mb + 1) * envs_mb]
            if mesh is not None:
                per, off = mesh.shard(N)
                idx = idx[(idx >= off) & (idx < off + per)] - off
            optimizer.zero_grad()
            terms = torch.zeros(3, device=device)
            if idx.numel():
                part = {k: getattr(rollout, k)[:, idx] for k in fields}
                rows = T * idx.numel()
                batch = Transition(reward=None, done=None, **{
                    k: v.reshape((rows,) + v.shape[2:])
                    for k, v in part.items()})
                logits, values = replay(part["obs"].to(torch.float32),
                                        h0[idx], masks[:, idx])
                loss, parts = ppo_loss_terms(
                    logits, values, batch, adv[:, idx].reshape(-1),
                    returns[:, idx].reshape(-1), cfg,
                    denom=None if mesh is None else float(T * envs_mb))
                loss.backward()
                terms = torch.stack([t.detach() for t in parts.values()])
            if mesh is None:
                optimizer.step()
                metrics.append(terms)
            else:
                metrics.append(_mesh_step(optimizer, mesh, terms))
    mean = torch.stack(metrics).mean(0)
    return dict(zip(("value_loss", "action_loss", "entropy"), mean))
