"""Port kernels' plain versions against the JAX Pallas kernels (K2 in
interpret mode, K1's ply on injected random words), the wrappers' input
checks, the nvcc build's failure path, and — on a card only — each CUDA
kernel against its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core import bitboard as bb
from gymothelloenv_tpu.ops import pallas_rollout as pr
from gymothelloenv_tpu.ops.pallas_bitboard import legal_mask_pallas
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.ops import _build
from gymothelloenv_tpu_torch.ops import rollout as ro
from gymothelloenv_tpu_torch.ops.legal_mask import legal_mask
from gymothelloenv_tpu_torch.scripts import bench_legal_mask as blm
from torch_port_helpers import pair, random_states, word


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.fixture(scope="module")
def states():
    return random_states(64, seed=10)


def test_k2_plain_matches_pallas_interpret():
    rng = np.random.RandomState(0)
    cells = rng.randint(0, 3, (300, 8, 8))      # not a multiple of BLOCK
    mine = bb.pack(jnp.asarray(cells == 1))
    opp = bb.pack(jnp.asarray(cells == 2))
    want = np.asarray(legal_mask_pallas(mine, opp, interpret=True))
    got = legal_mask(tb.pack_pair(mine), tb.pack_pair(opp))
    np.testing.assert_array_equal(tb.unpack_pair(got), want)


def test_k2_plain_matches_pallas_on_reachable_states(states):
    mine = jnp.stack(states.black, -1)
    opp = jnp.stack(states.white, -1)
    want = np.asarray(legal_mask_pallas(mine, opp, interpret=True))
    got = legal_mask(word(states.black), word(states.white))
    np.testing.assert_array_equal(tb.unpack_pair(got), want)


def test_k2_bench_parity_step_matches_pallas_interpret():
    """bench_legal_mask's boards are bench_pallas.py's, and its parity
    step returns the Pallas kernel's masks (CPU: K2's plain version)."""
    n = 300
    cells = np.random.RandomState(0).randint(0, 3, (n, 8, 8))
    mine = bb.pack(jnp.asarray(cells == 1))
    opp = bb.pack(jnp.asarray(cells == 2))
    got_mine, got_opp = blm.boards(n, 0, "cpu")
    np.testing.assert_array_equal(tb.unpack_pair(got_mine), mine)
    np.testing.assert_array_equal(tb.unpack_pair(got_opp), opp)
    want = np.asarray(legal_mask_pallas(mine, opp, interpret=True))
    got = blm.parity(got_mine, got_opp)
    np.testing.assert_array_equal(tb.unpack_pair(got), want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "device_mix"])
def test_k2_wrapper_rejects_bad_input(bad):
    w = torch.zeros(8, dtype=torch.int64)
    if bad == "dtype":
        args = (w.to(torch.int32), w.to(torch.int32))
        err = TypeError
    elif bad == "shape":
        args = (w, torch.zeros(9, dtype=torch.int64))
        err = ValueError
    else:
        args = (w, torch.zeros(8, dtype=torch.int64, device="meta"))
        err = ValueError
    with pytest.raises(err):
        legal_mask(*args)


def test_k2_wrapper_counts_no_cpu_launch():
    before = legal_mask.launches
    legal_mask(torch.zeros(4, dtype=torch.int64),
               torch.zeros(4, dtype=torch.int64))
    assert legal_mask.launches == before


def test_popcount32_and_opening_constants():
    rng = np.random.RandomState(1)
    v = rng.randint(0, 2 ** 32, (256,), np.uint64)
    got = ro.popcount32(torch.from_numpy(v.astype(np.int64)))
    want = np.asarray(pr._popcount(jnp.asarray(v.astype(np.uint32))))
    np.testing.assert_array_equal(got.numpy(), want)
    s = ro.rollout_init(3, device="cpu")
    ref = bb.bit_reset((3,))
    np.testing.assert_array_equal(tb.unpack_pair(s.cur), pair(ref.black))
    np.testing.assert_array_equal(tb.unpack_pair(s.opp), pair(ref.white))
    np.testing.assert_array_equal(tb.unpack_pair(s.legal), pair(ref.legal))


def _mover_view(states):
    is_white = np.asarray(states.turn) == 1
    live = ~np.asarray(states.terminated)
    cur = np.where(is_white[:, None], pair(states.white), pair(states.black))
    opp = np.where(is_white[:, None], pair(states.black), pair(states.white))
    legal = pair(states.legal)
    return cur[live], opp[live], legal[live]


def test_sample_legal_matches_pallas(states):
    cur, opp, legal = _mover_view(states)
    rng = np.random.RandomState(2)
    for _ in range(4):
        r = rng.randint(0, 2 ** 32, (legal.shape[0],), np.uint64)
        want = np.stack(pr._sample_legal(jnp.asarray(r.astype(np.uint32)),
                                         jnp.asarray(legal[:, 0]),
                                         jnp.asarray(legal[:, 1])), -1)
        got = ro.sample_legal(torch.from_numpy(r.astype(np.int64)),
                              tb.pack_pair(legal))
        np.testing.assert_array_equal(tb.unpack_pair(got), want)


def test_ply_matches_pallas_ply(states):
    """K1's plain ply == pallas_rollout._ply on the same injected r."""
    cur, opp, legal = _mover_view(states)
    rng = np.random.RandomState(3)
    c, o, l = (tb.pack_pair(x) for x in (cur, opp, legal))
    jc, jo, jl = ((jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]))
                  for x in (cur, opp, legal))
    jply = jax.jit(pr._ply)
    for step in range(70):
        r = rng.randint(0, 2 ** 32, (cur.shape[0],), np.uint64)
        out = jply(*jc, *jo, *jl, jnp.asarray(r.astype(np.uint32)))
        c, o, l, done = ro.ply(c, o, l, torch.from_numpy(r.astype(np.int64)))
        jc, jo, jl = out[0:2], out[2:4], out[4:6]
        for got, want in ((c, jc), (o, jo), (l, jl)):
            np.testing.assert_array_equal(tb.unpack_pair(got), pair(want),
                                          err_msg=f"ply {step}")
        np.testing.assert_array_equal(done.numpy(), np.asarray(out[6]))


def test_philox_known_answers():
    """Random123's Philox4x32-10 known-answer vectors."""
    def t(v):
        return torch.tensor([v], dtype=torch.int64)
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in cases:
        got = ro.philox4x32_10(tuple(map(t, ctr)), tuple(map(t, key)))
        assert tuple(int(x) for x in got) == want


def test_plain_chunk_invariants_and_episode_rate():
    """150 plies x 128 games: the invariants and the ~61-ply game length
    of tests/test_pallas_rollout.py."""
    n, steps = 128, 150
    state, eps = ro.rollout_chunk(ro.rollout_init(n, device="cpu"), 7, steps)
    c, o, legal = state.cur, state.opp, state.legal
    assert int(((c & o) != 0).sum()) == 0
    disks = (tb.popcount(c) + tb.popcount(o)).numpy()
    assert (disks >= 4).all() and (disks <= 64).all()
    assert torch.equal(legal, tb.legal_mask(c, o))
    assert bool((legal != 0).all())
    expect = n * steps / 61.0
    assert 0.6 * expect < int(eps) < 1.5 * expect, (int(eps), expect)


def test_plain_chunk_words_mode_equals_ply_loop():
    n, steps = 40, 30
    g = torch.Generator().manual_seed(4)
    words = torch.randint(-2 ** 31, 2 ** 31, (steps, n), dtype=torch.int32,
                          generator=g)
    s0 = ro.rollout_init(n, device="cpu")
    got, eps = ro.rollout_chunk(s0, 0, steps, words=words)
    c, o, l, total = s0.cur, s0.opp, s0.legal, 0
    for i in range(steps):
        c, o, l, done = ro.ply(c, o, l, words[i].to(torch.int64) & 0xFFFFFFFF)
        total += int(done.sum())
    assert torch.equal(got.cur, c) and torch.equal(got.legal, l)
    assert int(eps) == total


def test_rollout_chunks_matches_sequential_chunks():
    n, steps, chunks = 64, 40, 3
    got, total = ro.rollout_chunks(ro.rollout_init(n, device="cpu"), 9,
                                   chunks, steps)
    want = ro.rollout_init(n, device="cpu")
    want_total = 0
    for i in range(chunks):
        want, eps = ro.rollout_chunk(want, 9 + i, steps)
        want_total += int(eps)
    assert torch.equal(got.cur, want.cur) and torch.equal(got.opp, want.opp)
    assert total == want_total > 0


def test_rollout_wrapper_rejects_bad_words():
    s = ro.rollout_init(8, device="cpu")
    with pytest.raises(ValueError):
        ro.rollout_chunk(s, 0, 4, words=torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        ro.rollout_chunk(s, 0, 4, words=torch.zeros((4, 8)))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "LIBRARY", tmp_path / "libkernels.so")
    monkeypatch.setattr(_build, "_HASH_FILE", tmp_path / "libkernels.sha256")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_sources_and_flags():
    names = [p.name for p in _build.sources()]
    assert names == ["legal_mask.cu", "rollout.cu", "step.cu"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    assert len(_build.source_hash()) == 64


def test_k2_kernel_matches_plain_on_card(states):
    _need_card()
    dev = torch.device("cuda")
    mine = word(states.black).to(dev)
    opp = word(states.white).to(dev)
    before = legal_mask.launches
    got = legal_mask(mine, opp)
    assert legal_mask.launches == before + 1
    assert torch.equal(got.cpu(), tb.legal_mask(mine.cpu(), opp.cpu()))


def test_k1_kernel_matches_plain_on_card():
    _need_card()
    dev = torch.device("cuda")
    n, steps = 333, 90
    g = torch.Generator().manual_seed(5)
    words = torch.randint(-2 ** 31, 2 ** 31, (steps, n), dtype=torch.int32,
                          generator=g)
    s0 = ro.rollout_init(n, device="cpu")
    for w in (words, None):
        want, we = ro.rollout_chunk(s0, 3, steps, words=w)
        s_dev = ro.RolloutState(*(x.to(dev) for x in (s0.cur, s0.opp,
                                                      s0.legal)))
        got, ge = ro.rollout_chunk(s_dev, 3, steps,
                                   words=None if w is None else w.to(dev))
        assert torch.equal(got.cur.cpu(), want.cur)
        assert torch.equal(got.legal.cpu(), want.legal)
        assert int(ge) == int(we)


@pytest.mark.parametrize("lanes", ro.LANES)
def test_k1_kernel_matches_plain_at_every_lanes_on_card(lanes):
    """Each lane count on injected words and on Philox at a ragged N (not
    a multiple of 32) and at N = 1: exact, episodes too."""
    _need_card()
    dev = torch.device("cuda")
    for n, steps in ((4099, 64), (1, 64)):
        g = torch.Generator().manual_seed(n)
        words = torch.randint(-2 ** 31, 2 ** 31, (steps, n),
                              dtype=torch.int32, generator=g)
        s0 = ro.rollout_init(n, device="cpu")
        s_dev = ro.RolloutState(*(x.to(dev) for x in (s0.cur, s0.opp,
                                                      s0.legal)))
        for w in (words, None):
            want, we = ro.rollout_chunk_plain(s0, 8, steps, words=w)
            before = ro.rollout_chunk.launches
            got, ge = ro.rollout_chunk(
                s_dev, 8, steps, words=None if w is None else w.to(dev),
                lanes=lanes)
            assert ro.rollout_chunk.launches == before + 1
            for f in ("cur", "opp", "legal"):
                assert torch.equal(getattr(got, f).cpu(), getattr(want, f))
            assert int(ge) == int(we) > 0
