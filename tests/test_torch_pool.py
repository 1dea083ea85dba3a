"""The port trainer's opponent pool against the JAX trainer's: the same
sequence of drawn opponents (anchors first, then the snapshot ring, pushed
every ``pool_interval`` updates and evicted beyond ``opponent_pool``), the
same anchor shape check and error text, and the same refusals.  The
training steps are stubbed out on both sides for the draw sequence; a
short real run on the CPU draws the same sequence."""

import pytest

from gymothelloenv_tpu.agents import ppo as jppo
from gymothelloenv_tpu.train.ppo_trainer import \
    PPOSelfPlayTrainer as JaxTrainer
from gymothelloenv_tpu.train.ppo_trainer import \
    SelfPlayConfig as JaxSelfPlayConfig
from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                       SelfPlayConfig)
from torch_port_helpers import one_torch_thread  # noqa: F401

SMALL = dict(num_envs=16, num_steps=8, hidden_size=32,
             test_interval=10 ** 9)


@pytest.fixture(scope="module")
def anchors(tmp_path_factory):
    """Two port checkpoints of the small net, and one of another width."""
    root = tmp_path_factory.mktemp("anchors")
    paths = []
    for i, hidden in enumerate((32, 32, 48)):
        trainer = PPOSelfPlayTrainer(
            run_cfg=SelfPlayConfig(**{**SMALL, "hidden_size": hidden,
                                      "seed": i}),
            log_fn=lambda *a: None, device="cpu")
        paths.append(str(root / f"anchor{i}.msgpack"))
        trainer.save(paths[-1])
    return paths


def _jax(run):
    return JaxTrainer(ppo_cfg=jppo.PPOConfig(num_updates=4),
                      run_cfg=JaxSelfPlayConfig(**{**SMALL, **run}),
                      log_fn=lambda *a: None)


def _port(run):
    return PPOSelfPlayTrainer(ppo_cfg=PPOConfig(num_updates=4),
                              run_cfg=SelfPlayConfig(**{**SMALL, **run}),
                              log_fn=lambda *a: None, device="cpu")


def _record(trainer, seq):
    """Wrap ``_draw_opponent`` to log (index drawn, candidates)."""
    real = trainer._draw_opponent

    def draw():
        opp = real()
        cands = trainer.anchors + trainer.pool
        seq.append((next(i for i, c in enumerate(cands) if c is opp),
                    len(cands)))
        return opp
    trainer._draw_opponent = draw


POOLS = [dict(opponent_pool=2, pool_interval=1),
         dict(opponent_pool=3, pool_interval=2, n_anchors=1),
         dict(opponent_pool=1, pool_interval=3, n_anchors=2, seed=9)]


@pytest.mark.parametrize("pool", POOLS, ids=["ring2", "anchor1",
                                             "anchors2-seed9"])
def test_draw_sequence_matches_jax(pool, anchors):
    run = dict(pool)
    run["pool_anchors"] = tuple(anchors[:run.pop("n_anchors", 0)])
    updates = 14
    jseq, pseq = [], []
    jt = _jax(run)
    _record(jt, jseq)
    jt._train_step = lambda p, o, s, k, opp=None: (p, o, s, {})
    jt._draw_opponent()                # ensure_initialized's draw
    for _ in range(updates):
        jt._do_update(jt.key)
        jt.update_count += 1
    port = _port(run)
    _record(port, pseq)
    port._collect_and_update = lambda opp: {}
    port._draw_opponent()
    for _ in range(updates):
        port._do_update()
        port.update_count += 1
    assert pseq == jseq
    assert len(port.pool) == len(jt.pool) == run["opponent_pool"]
    assert len({c for c, _ in jseq}) > 1        # several candidates drawn


def test_real_pool_run_draws_the_same_sequence(anchors):
    run = dict(opponent_pool=2, pool_interval=1, pool_anchors=(anchors[0],))
    stub, real = [], []
    port = _port(run)
    _record(port, stub)
    port._collect_and_update = lambda opp: {}
    port._draw_opponent()
    for _ in range(3):
        port._do_update()
        port.update_count += 1
    port = _port(run)
    _record(port, real)
    logged = []
    port.log_fn = lambda step, m: logged.append(m)
    port.train(3, log_every=1)
    assert real == stub and len(logged) == 3
    assert all(m["value_loss"] == m["value_loss"] for m in logged)
    # Snapshots are frozen copies, not the live net.
    assert all(c is not port.net for c in port.pool)
    assert not any(p.requires_grad for c in port.pool
                   for p in c.parameters())


@pytest.mark.parametrize("which", ["width", "missing"])
def test_anchor_mismatch_raises_jax_text(which, anchors, tmp_path):
    path = anchors[2] if which == "width" else str(tmp_path / "no.msgpack")
    run = dict(opponent_pool=2, pool_anchors=(path,))
    with pytest.raises(ValueError) as jerr:
        _jax(run)
    with pytest.raises(ValueError) as perr:
        _port(run)
    assert str(perr.value) == str(jerr.value)
    assert "does not match the training net architecture" in str(perr.value)


@pytest.mark.parametrize("run", [
    dict(opponent_pool=2, pool_interval=0),
    dict(pool_anchors=("a.msgpack",)),
    dict(opponent_pool=2, chain_updates=2),
], ids=["interval", "anchors-without-pool", "chain-with-pool"])
def test_pool_refusals_match_jax(run):
    with pytest.raises(ValueError) as jerr:
        _jax(run)
    with pytest.raises(ValueError) as perr:
        _port(run)
    assert str(perr.value) == str(jerr.value)
