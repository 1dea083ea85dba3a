"""Lane groups of the rollout kernel (K1/K3): each game's eight directions
are split over ``lanes`` threads.  The plain per-lane floods, ORed over the
lanes of a group, against the JAX ``legal_mask2``/``resolve_flips2`` on
reachable states (exact: integer logic); ``rollout_lanes``' rule; the
wrappers' refusal of unknown lanes and of configurations the kernel source
does not instantiate; and the Python table of built configurations against
``csrc/rollout.cu``."""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import bitboard as bb
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.ops import _build
from gymothelloenv_tpu_torch.ops import rollout as ro
from gymothelloenv_tpu_torch.scripts import bench_rollout_variants as brv
from torch_port_helpers import (legal_lists, one_torch_thread,  # noqa: F401
                                pair, random_states, word)

SOURCE = (_build.CSRC / "rollout.cu").read_text()


@pytest.fixture(scope="module")
def states():
    return random_states(96, seed=31)


def _or_over_lanes(fn, lanes):
    out = fn(0, lanes)
    for lane in range(1, lanes):
        out = out | fn(lane, lanes)
    return out


@pytest.mark.parametrize("lanes", ro.LANES)
def test_lane_directions_partition_the_eight(lanes):
    parts = [tb.lane_directions(lane, lanes) for lane in range(lanes)]
    assert all(len(p) == 8 // lanes for p in parts)
    assert sorted(d for p in parts for d in p) == sorted(tb.DIRECTIONS)
    # Lane j floods directions j, j + lanes, ... (csrc/bitboard.cuh).
    for lane, p in enumerate(parts):
        assert p == tuple(tb.DIRECTIONS[lane + k * lanes]
                          for k in range(8 // lanes))


@pytest.mark.parametrize("lane,lanes", [(0, 3), (2, 2), (-1, 4), (0, 16)])
def test_lane_directions_refuse_bad_lanes(lane, lanes):
    with pytest.raises(ValueError):
        tb.lane_directions(lane, lanes)


@pytest.mark.parametrize("lanes", ro.LANES)
def test_lane_legal_floods_or_to_jax_legal_mask2(lanes, states):
    for mine, opp in ((states.black, states.white),
                      (states.white, states.black)):
        want = pair(bb.legal_mask2(mine, opp))
        m, o = word(mine), word(opp)
        got = _or_over_lanes(
            lambda lane, n: tb.legal_mask_lane(m, o, lane, n), lanes)
        np.testing.assert_array_equal(tb.unpack_pair(got), want)


@pytest.mark.parametrize("lanes", ro.LANES)
def test_lane_flip_floods_or_to_jax_resolve_flips2(lanes, states):
    rng = np.random.RandomState(lanes)
    legal = legal_lists(states.legal)
    is_white = np.asarray(states.turn) == 1
    mine = np.where(is_white[:, None], pair(states.white), pair(states.black))
    opp = np.where(is_white[:, None], pair(states.black), pair(states.white))
    actions = np.array([rng.choice(np.nonzero(row)[0]) if row.any()
                        else rng.randint(64) for row in legal], np.int32)
    want = pair(bb.resolve_flips2(bb.action_bit2(jnp.asarray(actions)),
                                  (jnp.asarray(mine[:, 0]),
                                   jnp.asarray(mine[:, 1])),
                                  (jnp.asarray(opp[:, 0]),
                                   jnp.asarray(opp[:, 1]))))
    a = tb.action_bit(torch.from_numpy(actions))
    m, o = tb.pack_pair(mine), tb.pack_pair(opp)
    got = _or_over_lanes(
        lambda lane, n: tb.resolve_flips_lane(a, m, o, lane, n), lanes)
    np.testing.assert_array_equal(tb.unpack_pair(got), want)


@pytest.mark.parametrize("n,lanes", [
    (0, 8), (1, 8), (1024, 8), (2112, 8), (2113, 4), (4096, 4), (4224, 4),
    (4225, 2), (8192, 2), (8448, 2), (8449, 1), (16384, 1), (65536, 1),
    (1_000_003, 1)])
def test_rollout_lanes_rule(n, lanes):
    assert ro.rollout_lanes(n) == lanes
    # The most lanes whose threads fit one warp on each scheduler.
    assert n * lanes <= ro.SCHEDULER_THREADS or lanes == 1


def test_rollout_lanes_refuses_negative_n():
    with pytest.raises(ValueError):
        ro.rollout_lanes(-1)


def test_built_table_matches_the_kernel_source():
    """``ro.BUILT`` holds exactly the instantiations of ``kBuilt``, and
    ``built`` reads it."""
    names = {"kFull": "full", "kNoSample": "nosample",
             "kNoFlips": "noflips", "kNoPass": "nopass"}
    rows = re.findall(r"OTB_BUILT\((\w+), (\d), (\d)\)", SOURCE)
    in_source = {(names[v], int(u), int(lanes)) for v, u, lanes in rows}
    assert len(in_source) == len(rows) > 0
    assert in_source == ro.BUILT
    assert ro.BENCH_LANES == ro.rollout_lanes(4096)
    assert {knobs for knobs in itertools.product(ro.VARIANTS, ro.UNROLLS,
                                                 ro.LANES)
            if ro.built(*knobs)} == ro.BUILT


@pytest.mark.parametrize("lanes", [0, 3, 16, -4])
def test_wrappers_refuse_unknown_lanes(lanes):
    s = ro.rollout_init(8, device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        ro.rollout_chunk(s, 0, 4, lanes=lanes)
    with pytest.raises(ValueError, match="lanes"):
        ro.rollout_chunks(s, 0, 2, 4, lanes=lanes)
    with pytest.raises(ValueError, match="lanes"):
        ro.rollout_variant_chunk(s, 0, 4, "full", lanes=lanes)


def test_wrappers_count_no_launch_on_cpu_at_any_lanes():
    s = ro.rollout_init(8, device="cpu")
    before = (ro.rollout_chunk.launches, ro.rollout_variant_chunk.launches)
    for lanes in ro.LANES:
        ro.rollout_chunk(s, 0, 4, lanes=lanes)
        ro.rollout_variant_chunk(s, 0, 4, "full", lanes=lanes)
    assert (ro.rollout_chunk.launches,
            ro.rollout_variant_chunk.launches) == before


@pytest.mark.parametrize("knobs", [
    dict(variant="nosample", lanes=2),
    dict(variant="noflips", lanes=8),
    dict(variant="nopass", lanes=2),
    dict(variant="full", unroll=2, lanes=8),
    dict(variant="full", unroll=4, lanes=2),
    dict(variant="nosample", unroll=2, lanes=1),
])
def test_variant_wrapper_refuses_unbuilt_configurations(knobs):
    s = ro.rollout_init(8, device="cpu")
    with pytest.raises(ValueError, match="not built"):
        ro.rollout_variant_chunk(s, 0, 4, **knobs)


def test_profiler_configs_are_built_where_they_run():
    for lanes in ro.LANES:
        ok = all(ro.built(k["variant"], k.get("unroll", 1), k["lanes"])
                 for _, k in brv.configs(lanes))
        assert ok == (lanes in (1, ro.BENCH_LANES))
        if ok:
            brv.check_built(lanes)
        else:
            with pytest.raises(ValueError, match="runs at lanes 1 .*, 4 "):
                brv.check_built(lanes)
    assert len(brv.configs(1)) == len(brv.CONFIGS)


@pytest.mark.parametrize("batch", [1024, 8192])
def test_profiler_stops_before_timing_at_unbuilt_lanes(batch, monkeypatch):
    """At these batches K1 runs at lanes 8 and 2, where the stubs are not
    built: the profiler names the built lanes before any launch."""
    assert not ro.built("nosample", 1, ro.rollout_lanes(batch))
    before = ro.rollout_variant_chunk.launches
    with pytest.raises(ValueError, match="not built at lanes"):
        brv.run(batch, 8, 1, device="cpu", out=lambda line: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="pass one of them"):
        brv.main([str(batch), "8"])
    assert ro.rollout_variant_chunk.launches == before
