"""K3 (the rollout-variant kernel): the port's plain variant ply against the
JAX ``_ply_variant`` of ``scripts/bench_rollout_variants.py`` on the same
injected random words, the wrapper's knob checks, the profiler's
configurations, and — on a card only — each variant kernel against its
plain version and ``full`` at every knob against K1.  Tolerance: exact
(bit for bit) throughout; the functions are integer logic."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.ops import rollout as ro
from gymothelloenv_tpu_torch.scripts import bench_rollout_variants as brv
from torch_port_helpers import (one_torch_thread,  # noqa: F401
                                pair, random_states)

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "bench_rollout_variants.py")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.fixture(scope="module")
def jax_script():
    """The TPU profiling script, loaded by path (it is not a package
    module); its ``_ply_variant`` is plain jnp."""
    spec = importlib.util.spec_from_file_location("bench_rollout_variants",
                                                  SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def mover_view():
    states = random_states(64, seed=21)
    is_white = np.asarray(states.turn) == 1
    live = ~np.asarray(states.terminated)
    cur = np.where(is_white[:, None], pair(states.white), pair(states.black))
    opp = np.where(is_white[:, None], pair(states.black), pair(states.white))
    return cur[live], opp[live], pair(states.legal)[live]


@pytest.mark.parametrize("variant", ro.VARIANTS)
def test_plain_variant_ply_matches_jax(variant, jax_script, mover_view):
    """40 chained plies from reachable positions, same r each ply."""
    cur, opp, legal = mover_view
    rng = np.random.RandomState(ro.VARIANTS.index(variant))
    c, o, l = (tb.pack_pair(x) for x in (cur, opp, legal))
    j = [jnp.asarray(x[:, k]) for x in (cur, opp, legal) for k in (0, 1)]
    jply = jax.jit(jax_script._ply_variant, static_argnums=7)
    for step in range(40):
        r = rng.randint(0, 2 ** 32, (cur.shape[0],), np.uint64)
        out = jply(*j, jnp.asarray(r.astype(np.uint32)), variant)
        c, o, l, done = ro.ply(c, o, l, torch.from_numpy(r.astype(np.int64)),
                               variant)
        j = list(out[:6])
        for got, want in ((c, out[0:2]), (o, out[2:4]), (l, out[4:6])):
            np.testing.assert_array_equal(tb.unpack_pair(got), pair(want),
                                          err_msg=f"{variant} ply {step}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(out[6]))


def test_variant_chunk_on_cpu_is_the_plain_loop():
    n, steps = 40, 30
    g = torch.Generator().manual_seed(2)
    words = torch.randint(-2 ** 31, 2 ** 31, (steps, n), dtype=torch.int32,
                          generator=g)
    s0 = ro.rollout_init(n, device="cpu")
    before = ro.rollout_variant_chunk.launches
    for variant in ro.VARIANTS:
        got, got_eps = ro.rollout_variant_chunk(s0, 7, steps, variant,
                                                words=words)
        want, want_eps = ro.rollout_chunk_plain(s0, 7, steps, words,
                                                variant)
        for f in ("cur", "opp", "legal"):
            assert torch.equal(getattr(got, f), getattr(want, f))
        assert int(got_eps) == int(want_eps)
    # full with Philox is K1's plain chunk, whatever the knobs.
    k1, k1_eps = ro.rollout_chunk(s0, 7, steps)
    full, full_eps = ro.rollout_variant_chunk(s0, 7, steps, "full",
                                              unroll=4, threads=128)
    assert torch.equal(full.cur, k1.cur) and torch.equal(full.legal, k1.legal)
    assert int(full_eps) == int(k1_eps)
    assert ro.rollout_variant_chunk.launches == before


def test_stubbed_variants_differ_from_full():
    """Each stub changes the games (the profiler times different work)."""
    s0 = ro.rollout_init(64, device="cpu")
    full, _ = ro.rollout_chunk_plain(s0, 3, 20)
    for variant in ro.VARIANTS[1:3]:
        got, _ = ro.rollout_chunk_plain(s0, 3, 20, variant=variant)
        assert not torch.equal(got.cur, full.cur), variant
    # nopass differs only where a pass occurs; over 200 plies some do.
    full, full_eps = ro.rollout_chunk_plain(s0, 3, 200)
    nopass, nopass_eps = ro.rollout_chunk_plain(s0, 3, 200, variant="nopass")
    assert int(nopass_eps) >= int(full_eps)
    assert not torch.equal(nopass.cur, full.cur)


@pytest.mark.parametrize("knobs,err", [
    (dict(variant="nope"), ValueError),
    (dict(variant="full", threads=96), ValueError),
    (dict(variant="full", unroll=3), ValueError),
    (dict(variant="nosample", unroll=8), ValueError),
    (dict(variant="nosample", unroll=2), ValueError),
    (dict(variant="nopass", unroll=4), ValueError),
])
def test_variant_wrapper_rejects_bad_knobs(knobs, err):
    s = ro.rollout_init(8, device="cpu")
    with pytest.raises(err):
        ro.rollout_variant_chunk(s, 0, 4, **knobs)


def test_profiler_configs_mirror_the_tpu_script():
    names = [name for name, _ in brv.CONFIGS]
    assert names == ["full", "nosample", "noflips", "nopass", "full-grid2",
                     "full-grid4", "full-unroll2", "full-unroll4"]
    s = ro.rollout_init(8, device="cpu")
    for name, knobs in brv.CONFIGS:       # every knob set is accepted
        assert name.split("-")[0] == knobs["variant"]
        ro.rollout_variant_chunk(s, 0, 2, **knobs)


def test_profiler_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA card"):
        brv.main(["64", "8"])


def test_variant_kernels_match_plain_on_card():
    _need_card()
    dev = torch.device("cuda")
    n, steps = 333, 90
    g = torch.Generator().manual_seed(6)
    words = torch.randint(-2 ** 31, 2 ** 31, (steps, n), dtype=torch.int32,
                          generator=g)
    s0 = ro.rollout_init(n, device="cpu")
    s_dev = ro.RolloutState(*(x.to(dev) for x in (s0.cur, s0.opp, s0.legal)))
    for variant in ro.VARIANTS:
        want, we = ro.rollout_chunk_plain(s0, 3, steps, words, variant)
        for unroll in ro.UNROLLS if variant == "full" else (1,):
            got, ge = ro.rollout_variant_chunk(s_dev, 3, steps, variant,
                                               unroll=unroll,
                                               words=words.to(dev))
            for f in ("cur", "opp", "legal"):
                assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
            assert int(ge) == int(we)
    k1, k1_eps = ro.rollout_chunk(s_dev, 3, steps)
    for _, knobs in brv.CONFIGS:
        if knobs["variant"] != "full":
            continue
        got, ge = ro.rollout_variant_chunk(s_dev, 3, steps, **knobs)
        assert torch.equal(got.cur, k1.cur) and torch.equal(got.opp, k1.opp)
        assert int(ge) == int(k1_eps)


def test_variant_configs_match_plain_at_bench_lanes_on_card():
    """Every profiler configuration at the lanes K1 runs at for the bench
    (stubs, unroll, block size) against its variant's plain loop on
    Philox at a ragged N: exact."""
    _need_card()
    dev = torch.device("cuda")
    n, steps = 333, 90
    s0 = ro.rollout_init(n, device="cpu")
    s_dev = ro.RolloutState(*(x.to(dev) for x in (s0.cur, s0.opp, s0.legal)))
    plain = {v: ro.rollout_chunk_plain(s0, 4, steps, variant=v)
             for v in ro.VARIANTS}
    for name, knobs in brv.configs(ro.BENCH_LANES):
        want, we = plain[knobs["variant"]]
        got, ge = ro.rollout_variant_chunk(s_dev, 4, steps, **knobs)
        for f in ("cur", "opp", "legal"):
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), name
        assert int(ge) == int(we), name
