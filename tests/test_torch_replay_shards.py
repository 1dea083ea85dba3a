"""The port's per-shard prioritized replay (``parallel/replay_shards.py``)
against JAX's and against the single-device distribution, on the CPU.

Two rings of 64 rows each (global ids 0-127 in the action field,
lognormal priorities from a numpy seed) are built alike for both.  JAX's
``sharded_sample``, ``sharded_update_priorities`` and ``global_size`` run
as one ``shard_map`` program over ``make_mesh(2)`` on the suite's virtual
CPU devices; the port's on one spawned gloo cluster of two CPU ranks for
the module (``parallel.dryrun.spawn`` of
``torch_dp_tasks.shards_cluster_task``), each rank holding its own ring:

  * the empirical marginals of 150 batches of 256 slots, each side's
    against the global proportional distribution ``p_i / P`` to JAX's
    bounds (tests/test_replay_shards.py): every id within 6 sigma + 6 of
    its expected count, chi-square per degree of freedom under 2; each
    slot owned by exactly one shard, every rank assembling the same rows;
  * the priority refresh on JAX's sampled indices and owners and the same
    errors: equal to JAX's exactly at ``priority_a`` 1 (where both sides
    compute ``|err| + e`` with one float32 add), to one float32 spacing at
    the default 0.6 (torch's and XLA's ``pow`` round apart in ~1% of
    values); the slots a rank does not own write only the scratch row;
  * ``global_size`` equal to JAX's;
  * the owner draw's inverse CDF and the assembly's int32 widening, alone.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from gymothelloenv_tpu.agents import replay as jreplay
from gymothelloenv_tpu.parallel import make_mesh as jax_make_mesh
from gymothelloenv_tpu.parallel import replay_shards as jshards
from gymothelloenv_tpu_torch.agents import replay as rp
from gymothelloenv_tpu_torch.parallel import dryrun, replay_shards
from torch_dp_tasks import (A_EXACT, BATCH, CAP, PER, ROUNDS, S, _errors,
                            _port_ring, _priorities)
from torch_port_helpers import one_torch_thread  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
N_IDS = S * PER


def _jax_rings(a: float = 0.6):
    cfg = jreplay.ReplayConfig(capacity=CAP, prioritized=True, priority_a=a)
    rings = []
    for s in range(S):
        rb = jreplay.replay_init(cfg)
        z = jnp.zeros((PER, 8, 8), jnp.int8)
        t = jnp.zeros((PER,), jnp.int8)
        rb = jreplay.replay_insert(
            rb, cfg, z, t, jnp.arange(s * PER, (s + 1) * PER,
                                      dtype=jnp.int32),
            jnp.zeros((PER,)), z, t, jnp.zeros((PER,), bool),
            jnp.ones((PER,), bool))
        rings.append(rb.replace(priority=rb.priority.at[:PER].set(
            jnp.asarray(_priorities()[s]))))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *rings), cfg


@functools.cache
def _jax_run():
    """JAX's program: each round's sampled ids, indices and owners; then,
    on round 0's indices and owners, the refreshed priorities at the
    default ``priority_a`` and at ``A_EXACT``, and the global size."""
    mesh = jax_make_mesh(S)
    out = {}
    for a in (0.6, A_EXACT):
        stacked, cfg = _jax_rings(a)
        spec = jax.tree.map(lambda _: P("data"), stacked)

        @jax.jit
        @functools.partial(shard_map, mesh=mesh, in_specs=(spec, P()),
                           out_specs=(P(None), P("data"), P("data"), spec,
                                      P(None)),
                           check_rep=False)
        def program(stacked, key):
            rb = jax.tree.map(lambda x: x[0], stacked)
            rows, idx, owned = jshards.sharded_sample(rb, cfg, key, BATCH)
            ids = jreplay.unpack_rows(rows, cfg.board_size)[2]
            rb = jshards.sharded_update_priorities(
                rb, cfg, idx, owned, jnp.asarray(_errors()))
            return (ids[None], idx[None], owned[None],
                    jax.tree.map(lambda x: x[None], rb),
                    jshards.global_size(rb)[None])
        rounds = ROUNDS if a != A_EXACT else 1
        res = [jax.tree.map(np.asarray, program(
            stacked, jax.random.PRNGKey(100 + r))) for r in range(rounds)]
        out[a] = dict(ids=[r[0][0] for r in res], idx=res[0][1],
                      owned=res[0][2], priority=res[0][3].priority,
                      max_priority=res[0][3].max_priority,
                      size=int(res[0][4][0]))
    return out


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shards")
    rec = _jax_run()
    args = {str(a): {"idx": rec[a]["idx"].tolist(),
                     "owned": rec[a]["owned"].tolist()}
            for a in (0.6, A_EXACT)}
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([TESTS, env.get("PYTHONPATH", "")])
    ranks = dryrun.spawn(S, "torch_dp_tasks:shards_cluster_task", args,
                         backend="gloo", device="cpu",
                         out_dir=str(tmp / "cluster"), timeout_s=240,
                         env=env)
    for r in ranks:
        for a in (0.6, A_EXACT):
            r[str(a)]["priority"] = r[str(a)]["priority"].numpy()
    return dict(ranks=ranks, rec=rec)


def _expected():
    prio = _priorities().reshape(-1).astype(np.float64)
    return prio / prio.sum() * ROUNDS * BATCH


def _hold_to_marginals(ids):
    """JAX's bounds (tests/test_replay_shards.py:62): every id within 6
    sigma + 6 of its expected count, chi-square per dof under 2."""
    ids = np.concatenate([np.asarray(i).reshape(-1) for i in ids])
    assert ids.size == ROUNDS * BATCH
    assert ids.min() >= 0 and ids.max() < N_IDS
    counts = np.bincount(ids, minlength=N_IDS)
    expect = _expected()
    sigma = np.sqrt(np.maximum(expect, 1.0))
    assert np.all(np.abs(counts - expect) < 6 * sigma + 6), \
        np.abs((counts - expect) / sigma).max()
    chi2_dof = float(((counts - expect) ** 2 / np.maximum(expect, 1e-9))
                     .mean())
    assert chi2_dof < 2.0, chi2_dof
    return chi2_dof


@pytest.mark.parametrize("side", ["port", "jax"])
def test_sharded_sample_follows_the_global_distribution(cluster, side):
    if side == "jax":
        _hold_to_marginals(cluster["rec"][0.6]["ids"])
        return
    r0, r1 = cluster["ranks"]
    assert torch.equal(r0["ids"], r1["ids"])        # every rank assembles
    assert bool((r0["owned"] ^ r1["owned"]).all())  # one owner a slot
    _hold_to_marginals(r0["ids"])


@pytest.mark.parametrize("a", [0.6, A_EXACT])
def test_update_priorities_and_global_size_equal_jax(cluster, a):
    """On JAX's sampled indices and owners and the same errors: each
    rank's priorities equal JAX's shard's (exactly at ``A_EXACT``, to one
    float32 spacing at 0.6), the slots it does not own touch only the
    scratch row, and the global size is JAX's."""
    rec = cluster["rec"][a]
    for s, r in enumerate(cluster["ranks"]):
        got, want = r[str(a)]["priority"], rec["priority"][s]
        live = slice(0, CAP)
        if a == A_EXACT:
            np.testing.assert_array_equal(got[live], want[live])
            assert float(r[str(a)]["max_priority"]) == float(
                rec["max_priority"][s])
        else:
            np.testing.assert_allclose(got[live], want[live], rtol=2.4e-7,
                                       atol=0)
        before = _priorities()[s]
        touched = np.nonzero(got[:PER] != before)[0]
        mine = rec["idx"][s][rec["owned"][s]]
        assert set(touched) <= set(mine.tolist()) and len(touched) > 0
        assert r[str(a)]["size"] == rec["size"] == N_IDS


def test_owner_draw_and_assembly_alone():
    """The inverse CDF skips an empty shard and reaches the last; the
    int32 widening keeps bytes above 127 exact where a uint8 sum over
    the shards would be asked to carry them."""
    totals = torch.tensor([2.0, 0.0, 6.0])
    u = torch.tensor([0.0, 0.2499, 0.25, 0.9999, 0.999999])
    assert replay_shards.owner_draw(totals, u).tolist() == [0, 0, 2, 2, 2]
    rb, cfg = _port_ring(0)
    assert float(replay_shards.local_priority_total(rb, cfg)) == \
        pytest.approx(float(_priorities()[0].sum()), rel=1e-6)
    uni = rp.ReplayConfig(capacity=CAP)
    assert float(replay_shards.local_priority_total(rb, uni)) == PER
    rows = rp.pack_bytes(rp.replay_gather(rb, torch.arange(4)), 1)
    back = rp.unpack_bytes(rows.to(torch.int32).to(torch.uint8),
                           rp.row_layout(8))
    assert back[2].tolist() == [0, 1, 2, 3]


def test_cli_per_shard_under_torchrun(tmp_path):
    """``dqn_train --data-parallel 2 --replay-sharding per-shard`` as
    ``torchrun`` starts it (two CPU ranks over gloo, a rendezvous of its
    own): both ranks train a chunk, process 0 alone prints, and the run
    leaves its process group."""
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(TESTS),
                                         env.get("PYTHONPATH", "")])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m",
           "gymothelloenv_tpu_torch.cli.dqn_train", "--data-parallel", "2",
           "--dist-backend", "gloo", "--device", "cpu",
           "--replay-sharding", "per-shard", "--prioritized", "1",
           "--num-envs", "8", "--chunk-plies", "8", "--num-chunks", "2",
           "--replay-size", "4096", "--initial-replay-size", "0",
           "--batch-size", "16", "--num-test-games", "4",
           "--log-every", "1"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=180, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("final eval:") == 1
    assert out.stdout.count("device: cpu") == 1
    chunks = [line for line in out.stdout.splitlines()
              if line.startswith("[chunk 2]")]
    assert len(chunks) == 1 and "replay_size=" in chunks[0]
