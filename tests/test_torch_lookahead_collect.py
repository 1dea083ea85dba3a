"""The collector's lookahead against JAX's (``lookahead_action_values``
and ``make_lookahead_override`` at tau 0 and tau > 0) and the lookahead
flags of ``cli/eval_checkpoint.py``, on the states and nets of
test_torch_lookahead.py: exact values with the stub value net, 1e-5 with
the seeded net; the override's argmax equal to JAX's, its samples equal to
a numpy model of the sampler at injected uniforms, and its distribution
equal to ``jax.random.categorical``'s by a chi-square test."""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from gymothelloenv_tpu.core.engine import get_engine
from gymothelloenv_tpu.train import self_play as jsp
from gymothelloenv_tpu_torch.cli import eval_checkpoint
from gymothelloenv_tpu_torch.core import bitboard as tb
from gymothelloenv_tpu_torch.train import self_play as sp
from test_chunked_search import _stub_apply
from test_torch_lookahead import (JRCFG, MIXED, RCFG, STUB, _jax,
                                  _jax_values, _pick, _port, _seeded)
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("net", ["stub", "seeded"])
def test_action_values_match_jax(net):
    """Exact with the stub, 1e-5 with the seeded net, at legal actions
    (JAX leaves the others unspecified; the port holds NEG there)."""
    idx = _pick(MIXED)
    port_net = STUB if net == "stub" else _seeded()[2]
    want = _jax_values(net)(_jax(idx))
    got = sp.lookahead_action_values(port_net, _port(idx), RCFG).numpy()
    legal = tb.unpack_flat(_port(idx).legal).numpy()
    np.testing.assert_allclose(got[legal], want[legal], rtol=0,
                               atol=0 if net == "stub" else 1e-5)
    assert (got[~legal] == sp.NEG).all()


def _jax_override(tau, idx, key):
    ov = jsp.make_lookahead_override(JRCFG, tau)
    env = _jax(idx)
    eng = get_engine(JRCFG)
    return np.asarray(jax.jit(lambda s, k: ov(
        None, _stub_apply, eng, s, k, eng.legal_flat(s)))(env, key))


def test_override_argmax_matches_jax():
    idx = _pick({"quirk": 8, "ending": 8, "plain": 16})
    state = _port(idx)
    ov = sp.make_lookahead_override(RCFG, 0.0)
    got = ov(STUB, state, tb.unpack_flat(state.legal), None)
    np.testing.assert_array_equal(
        got.numpy(), _jax_override(0.0, idx, jax.random.PRNGKey(0)))


def test_override_samples_with_injected_uniforms():
    """tau 2: each row's sample is the inverse CDF of softmax(values /
    tau) over its legal actions at the injected uniform (a numpy model in
    float64; rows whose uniform lands within 1e-5 of a CDF step are left
    out)."""
    idx = _pick({"quirk": 8, "ending": 8, "plain": 16})
    state = _port(idx)
    legal = tb.unpack_flat(state.legal)
    u = torch.from_numpy(np.random.RandomState(5).uniform(
        1e-3, 1.0, len(idx)).astype(np.float32))
    draws = sp.InjectedDraws([], [u])
    got = sp.make_lookahead_override(RCFG, 2.0)(STUB, state, legal, draws)
    vals = sp.lookahead_action_values(STUB, state, RCFG).double().numpy()
    checked = 0
    for i in range(len(idx)):
        moves = np.nonzero(legal[i].numpy())[0]
        w = np.exp((vals[i, moves] - vals[i, moves].max()) / 2.0)
        cdf = np.cumsum(w) / w.sum()
        if np.abs(cdf - float(u[i])).min() < 1e-5:
            continue
        assert int(got[i]) == moves[np.searchsorted(cdf, float(u[i]))]
        checked += 1
    assert checked >= len(idx) - 2


def test_override_distribution_matches_jax_categorical():
    """tau 4, one position repeated 20,000 times: the port's samples
    against ``jax.random.categorical``'s at the same values, chi-square
    two-sample test at p >= 1e-3."""
    from scipy.stats import chi2_contingency

    i = int(_pick({"plain": 1}, offset=3)[0])
    reps = 20_000
    idx = torch.full((reps,), i)
    state = _port(idx)
    legal = tb.unpack_flat(state.legal)
    draws = sp.Draws(torch.Generator().manual_seed(1))
    got = sp.make_lookahead_override(RCFG, 4.0)(STUB, state, legal, draws)
    want = _jax_override(4.0, idx, jax.random.PRNGKey(1))
    moves = np.nonzero(legal[0].numpy())[0]
    assert len(moves) >= 4
    table = np.array([[(got.numpy() == m).sum() for m in moves],
                      [(want == m).sum() for m in moves]])
    assert table.sum() == 2 * reps
    keep = table.sum(0) > 0
    assert chi2_contingency(table[:, keep])[1] >= 1e-3


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from gymothelloenv_tpu_torch.models.convert import flax_tree
    from gymothelloenv_tpu_torch.utils.checkpoint import save_checkpoint
    path = str(tmp_path_factory.mktemp("ckpt") / "seeded.msgpack")
    save_checkpoint(path, 0, flax_tree(_seeded()[2]))
    return path


def _eval(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = eval_checkpoint.main(argv)
    return result, out.getvalue().splitlines()


def test_eval_cli_lookahead_flags(tiny_ckpt, monkeypatch):
    """``--lookahead-depth`` > 1 implies ``--lookahead``; the search
    scores on the disk-difference scale; ``--opp-lookahead-depth`` arms a
    checkpoint opponent."""
    made = []
    real = eval_checkpoint.net_lookahead_policy

    def record(net, cfg, depth, beam_k, expand_chunk):
        made.append((cfg.num_disk_as_reward, depth, beam_k, expand_chunk))
        return real(net, cfg, depth, beam_k, expand_chunk)

    monkeypatch.setattr(eval_checkpoint, "net_lookahead_policy", record)
    base = ["--device", "cpu", "--load", tiny_ckpt, "--games", "4",
            "--init-rand-steps", "4", "--seed", "2"]
    (w, d, l), lines = _eval(base + ["--lookahead-depth", "3", "--beam-k",
                                     "2", "--opponent", "greedy"])
    assert made == [(True, 3, 2, 0)] and w + d + l == 4
    assert "over 4 games" in lines[-1]
    made.clear()
    (w, d, l), _ = _eval(base + ["--lookahead", "--opponent",
                                 f"ckpt:{tiny_ckpt}",
                                 "--opp-lookahead-depth", "1",
                                 "--expand-chunk", "3"])
    assert sorted(made) == [(True, 1, 8, 3), (True, 1, 8, 3)]
    assert w + d + l == 4


@pytest.mark.parametrize("argv", [
    ["--opponent", "greedy", "--opp-lookahead-depth", "1"],
    ["--lookahead-depth", "4"], ["--opp-lookahead-depth", "4"]])
def test_eval_cli_lookahead_errors(tiny_ckpt, argv):
    with pytest.raises(SystemExit) as err:
        _eval(["--device", "cpu", "--load", tiny_ckpt] + argv)
    assert err.value.code == 2
