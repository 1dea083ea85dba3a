"""Per-shard prioritized replay — the port of ``parallel/replay_shards.py``,
the scale-out alternative to the replicated replay the trainers default to.

Layout: every data index owns a private ring (``agents.replay.Replay``) of
``capacity / S`` rows (S: the data axis's size) holding only the
transitions its own games made, so capacity scales with the mesh and
inserts stay local.  JAX keeps the S rings as one stacked ``(S, ...)``
pytree sharded over ``data``; here each rank simply holds its own ring.
Sampling still follows the GLOBAL prioritized distribution (the reference
Memory's semantics, dqn.py:23-69) in two stages and one small collective a
batch:

  1. *owner draw* (the same on every rank): for each of the ``batch``
     slots, the owning shard from ``Categorical(P_1, ..., P_S)``, ``P_s``
     shard s's priority total (an all-gather of S floats), by inverse CDF
     on one shared uniform a slot;
  2. *local candidate draw*: every shard samples ``batch`` candidates from
     its own ring with the stratified proportional sampler of the
     single-device path (``replay_sample_idx``), on its row of an (S,
     batch) draw of uniforms that every rank makes whole;
  3. *assembly*: slot j's row is its owner's candidate, a masked all-reduce
     over the data axis (each shard adds its candidate's bytes where it
     owns the slot, zeros elsewhere), the bytes widened to int32 first:
     gloo's and NCCL's uint8 sums are not the exact byte sums the mask
     trick wants.

Marginals: P(slot j yields row i of shard s) = (P_s / P) (p_i / P_s) =
p_i / P, the global proportional distribution however the rows are spread
(``tests/test_torch_replay_shards.py`` holds the empirical marginals to it).

Priority refresh: the errors come from the assembled batch, all-gathered in
slot order, so every shard sees all ``batch`` of them and writes only the
slots it owns; the others go to the scratch row ``capacity``.

Streams to shards: a rank inserts the emissions of its own games, black's
and white's streams (``train.dqn_trainer``).  JAX's GSPMD splits its 2N
stream axis (black's N streams, then white's) in contiguous blocks, so its
shard s holds other streams than the port's rank s.  Both gates compare
the union of the rings with the replicated ring, which does not depend on
the assignment.
"""

from __future__ import annotations

import numpy as np
import torch

from gymothelloenv_tpu_torch.agents.dqn import data_parallel_loss
from gymothelloenv_tpu_torch.agents.replay import (Replay, ReplayConfig,
                                                   insert_emitted, pack_bytes,
                                                   replay_gather,
                                                   replay_sample_idx,
                                                   replay_update_priorities,
                                                   row_layout, unpack_bytes)
from gymothelloenv_tpu_torch.parallel.sharding import (all_gather_cat,
                                                       all_reduce_sum)


def local_priority_total(rb: Replay, cfg: ReplayConfig) -> torch.Tensor:
    """This shard's sampling weight, float32 0-d: its live rows' priority
    mass (prioritized) or its live size (uniform)."""
    if not cfg.prioritized:
        return rb.size.to(torch.float32)
    c = cfg.capacity
    live = torch.arange(c, device=rb.priority.device) < rb.size
    return torch.where(live, rb.priority[:c],
                       torch.zeros_like(rb.priority[:c])).sum()


def owner_draw(totals: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """int64 owner of each slot: the shard whose share of the cumulative
    ``totals`` (S,) holds ``u * total`` (``u`` (batch,) in [0, 1)); a
    shard with a total of 0 is never drawn."""
    cum = torch.cumsum(totals, 0)
    target = u * cum[-1]
    owner = (cum[None, :] <= target[:, None]).sum(-1)
    return owner.clamp(max=totals.shape[0] - 1)


def sharded_sample(rb: Replay, cfg: ReplayConfig, batch: int, draws, mesh):
    """``batch`` rows from the global distribution over every shard's
    ring.  Returns ``(rows, idx, owned)``: the rows as ``replay_gather``'s
    field tuple, the same on every rank; this shard's candidate indices
    (batch,); and the slots it owns (batch,) bool.  ``draws``: the owner
    uniforms (batch,) and the candidate uniforms (S * batch,) come from
    two ``replay_uniforms`` calls, the same on every rank (a
    ``ShardedDraws`` passes them whole, a test injects them)."""
    dev = rb.priority.device
    s = mesh.world
    totals = all_gather_cat(local_priority_total(rb, cfg).reshape(1), mesh)
    owned = owner_draw(totals, draws.replay_uniforms(batch, dev)) \
        == mesh.rank
    u = draws.replay_uniforms(s * batch, dev).reshape(s, batch)[mesh.rank]
    idx = replay_sample_idx(rb, cfg, u)
    rows = pack_bytes(replay_gather(rb, idx), 1)
    rows = torch.where(owned[:, None], rows, torch.zeros_like(rows))
    wide = rows.to(torch.int32)
    all_reduce_sum([wide], mesh)
    rows = unpack_bytes(wide.to(torch.uint8), row_layout(cfg.board_size))
    return rows, idx, owned


def sharded_update_priorities(rb: Replay, cfg: ReplayConfig,
                              idx: torch.Tensor, owned: torch.Tensor,
                              errors: torch.Tensor) -> Replay:
    """The PER refresh of the slots this shard owns, in place: ``errors``
    is the whole (batch,) vector; the slots it does not own write the
    scratch row ``capacity`` (never sampled)."""
    safe = torch.where(owned, idx, torch.full_like(idx, cfg.capacity))
    return replay_update_priorities(rb, cfg, safe, errors)


def global_size(rb: Replay, mesh) -> torch.Tensor:
    """int64 0-d: the live rows of every shard's ring."""
    size = rb.size.reshape(1).clone()
    all_reduce_sum([size], mesh)
    return size[0]


def pershard_insert(rb: Replay, cfg_per_shard: ReplayConfig,
                    emitted) -> torch.Tensor:
    """This rank's emissions (its games' ``Emitted`` pushes) into its own
    ring, in order (push, window slot, stream), so no emission bytes
    cross ranks.  Returns how many rows were valid (0-d)."""
    return insert_emitted(rb, cfg_per_shard, emitted)


def assert_ring_union_equal(ref_data, ref_size, shard_data, shard_sizes,
                            name: str = "per-shard rings") -> None:
    """The per-shard gate (JAX's comparator): after a chunk collected
    with the same params, the union of the shards' rings holds exactly the
    replicated ring's rows, none lost or doubled, and every shard holds
    some.  ``ref_data``: the replicated ring's packed rows
    (``agents.replay.ring_rows``), ``ref_size`` its live count;
    ``shard_data``: each shard's packed rows, ``shard_sizes`` theirs."""
    ref_rows = np.asarray(ref_data)[:int(ref_size)]
    sizes = np.asarray([int(x) for x in shard_sizes])
    assert sizes.sum() == ref_rows.shape[0] > 0, (name, sizes)
    assert (sizes > 0).all(), (name, sizes)
    rows = np.concatenate([np.asarray(d)[:n]
                           for d, n in zip(shard_data, sizes)])

    def sort_rows(r):
        return r[np.lexsort(r.T[::-1])]
    np.testing.assert_array_equal(sort_rows(ref_rows), sort_rows(rows),
                                  err_msg=name)


def pershard_train_batch(state, rb: Replay, cfg_per_shard: ReplayConfig,
                         batch_size: int, loss_grads, draws, mesh):
    """The per-shard minibatch update: the globally prioritized sample
    (``sharded_sample``), data-parallel gradients over contiguous slices
    of the assembled batch (``agents.dqn.data_parallel_loss``), the
    optimizer step, and the whole batch's errors scattered back to the
    owning shards.  ``loss_grads(rows, denom) -> (loss, errors)``
    supplies the algorithm (DQN's Huber TD or Rainbow's C51 KL).  Returns
    the loss (0-d)."""
    s = mesh.world
    if batch_size % s:
        raise ValueError(f"batch_size {batch_size} not divisible by data "
                         f"shards {s}")
    rows, idx, owned = sharded_sample(rb, cfg_per_shard, batch_size, draws,
                                      mesh)
    loss, err = data_parallel_loss(state, loss_grads, rows, mesh)
    state.optimizer.step()
    if cfg_per_shard.prioritized:
        sharded_update_priorities(rb, cfg_per_shard, idx, owned, err)
    return loss


def dqn_train_batch_pershard(state, rb: Replay, cfg,
                             cfg_per_shard: ReplayConfig, draws, mesh):
    """Per-shard drop-in for ``agents.dqn.dqn_train_batch``."""
    from gymothelloenv_tpu_torch.agents.dqn import dqn_loss_grads
    return pershard_train_batch(
        state, rb, cfg_per_shard, cfg.batch_size,
        lambda rows, denom: dqn_loss_grads(state, cfg, rows, denom),
        draws, mesh)


def rainbow_train_batch_pershard(state, rb: Replay, cfg,
                                 cfg_per_shard: ReplayConfig, draws, mesh):
    """Per-shard drop-in for ``agents.rainbow.rainbow_train_batch`` (the
    noise one draw a batch, the same on every rank, as the replicated
    layout's)."""
    from gymothelloenv_tpu_torch.agents.rainbow import rainbow_loss_grads
    return pershard_train_batch(
        state, rb, cfg_per_shard, cfg.batch_size,
        lambda rows, denom: rainbow_loss_grads(state, cfg, rows, draws,
                                               denom),
        draws, mesh)
