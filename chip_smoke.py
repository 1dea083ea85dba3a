#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gymothelloenv_tpu_torch) on one card.

    python3 chip_smoke.py

Builds the port's kernels with nvcc, holds each kernel against its plain
PyTorch version, then drives the main paths, each with the launch counts
set to 0 just before it and read just after:

  * kernel K2's own benchmark, gymothelloenv_tpu_torch/scripts/
    bench_legal_mask.py (the port of scripts/bench_pallas.py, K2's only
    caller in the JAX package);
  * the fused random-play rollout (kernel K1) at the bench protocol, with
    each game on the lane group that ops/rollout.py rollout_lanes picks,
    and the wide2 policy net against the greedy opponent through the
    bitboard engine (the ply kernel, csrc/step.cu, on every ply; K2 once
    per bit_reset);
  * the rollout-variant profiler (kernel K3: K1 with one component stubbed
    out, or at another unroll / block size), every configuration of
    gymothelloenv_tpu_torch/scripts/bench_rollout_variants.py at the bench
    protocol;
  * PPO self-play training: PPOSelfPlayTrainer at wide2 with the tuned
    recipe (N 1024, T 64, lr 2.5e-4, entropy 0.01) for 3 updates and one
    200-game evaluation (the ply kernel on every ply and every reset of
    collection and evaluation; K2 once per bit_reset);
    then one ppo_update on the card against the same update on the CPU
    from the same params, rollout and shuffle words, at a reduced size;
  * checkpoint IO: the trained trainer saved in the JAX trainer's format
    (flax msgpack, written and read in pure Python) to a temporary
    directory, read back byte for byte, and loaded into a fresh trainer on
    the card bit for bit ([checkpoint]);
  * maximin-k (policies/scripted.py), whose tree expands one level a
    launch of the ply kernel: decisions at depth 1 and 2 on 4096 reachable
    states and at depth 3 on 256, the same on card and CPU, chunked and
    not ([maximin]);
  * the value-lookahead search (train/ppo_trainer.py net_lookahead_policy)
    on the wide2 net, whose every tree level is one launch of the ply
    kernel: decisions at depth 1 on 4096 reachable states, at depth 2 on
    256 and at beam-3 (k 8) on 64, the same on card and CPU wherever the
    decision's margin exceeds 1e-4, chunked and not, one launch a level,
    and ms a decision at 200 games with the device's share of it
    ([lookahead]);
  * search-bootstrapped training: PPOSelfPlayTrainer at wide2 on the
    lookahead-mix recipe (N 512, T 64, 10 random opening plies, tau 1.0,
    mix 0.25, 2 epochs, lr 5e-5 without decay) for 4 updates, updates 1-3
    collecting plainly and update 4 with the override, then one distill
    update at tau 2.0 ([lookahead_train]);
  * the evaluation CLIs: cli/eval_checkpoint.py on a wide2 checkpoint the
    script writes from its seeded net, against maximin-2 and against
    itself, raw and armed with the search (depth 2 against maximin-2,
    beam-3 against greedy, depth 1 against itself at depth 1), and
    cli/tournament.py greedy against maximin-2 ([eval_checkpoint]).

It reads no file outside gymothelloenv_tpu_torch/ (the nets are seeded
inits; the checkpoints it reads are the ones it wrote, in a temporary
directory) and exits non-zero on any failure, without a CUDA card, or when
run outside a checkout of the repository.

K1 is held against its plain version at every lane count (1, 2, 4, 8) on
injected words (also at a ragged N and at N = 1) and on Philox, and timed
at every lane count for N 1024 to 65,536 ([rollout_lanes], the grounds of
rollout_lanes).  The ply kernel and its reset_where are held bit for bit
against their plain versions in every mode, with both flags each way, on
reachable states with terminated games and actions of every class
([bit_step]); the main paths must not call those plain versions.

Output: one flushed line before and after every phase; then a JSON line
with every kernel's launches, error against its plain version, times and
bound; the total seconds; the card's name and power limit as nvidia-smi
reports them; and last {"ok": true, "device": {...}}.

Float32 throughout: the script sets no TF32 flag of its own.  The port's
entry points switch TF32 off (utils/device.py use_float32); before [train]
the script turns both flags on and checks that constructing the trainer
turns them off and that its net then agrees with a CPU copy.
"""

import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
# The peak table has no integer rate for the CUDA cores; its float32
# CUDA-core rate is used for 32-bit integer instructions.  That overstates
# the integer rate, so the bound below is a lower bound on the time.
INT_OPS_PER_S = 67e12
# 32-bit integer instructions, counted from csrc/bitboard.cuh: a
# Kogge-Stone direction is 5 shifts + 9 logic ops, a legal flood is 8
# directions + 10 ops = 166 64-bit ops (shifts with a column mask count
# 2), each 64-bit op two 32-bit instructions.
K2_OPS_PER_BOARD = 2 * 166
# The ply kernel (csrc/step.cu) a stepped game, counted the same way: one
# flips flood (187 64-bit ops), the opponent's legal flood (166) and the
# placement and selects (8), all x2, three popcounts (3 each) and the
# terminal rules (~25).  The mover's flood (2 x 166) runs only where the
# opponent has no move; it is counted from each run's data.
PLY_OPS_PER_GAME = 2 * (187 + 166 + 8) + 3 * 3 + 25
PLY_SECOND_FLOOD_OPS = 2 * 166
# One K1 ply: the flips of the sampled move (187 64-bit ops), the
# opponent's legal flood (166), state updates (10), all x2; plus ~35 for
# the sampler and a quarter of a Philox4x32-10 call (~100).  The mover's
# second flood runs only when the opponent must pass and is not counted.
K1_OPS_PER_PLY = 2 * (187 + 166 + 10) + 35 + 25
# K3's variants, K1's count with the stubbed term removed: nosample drops
# the sampler (35) and, its random word unused, the Philox share (25) for
# l & -l on 64 bits (2 x 2); noflips drops the flips flood (2 x 187);
# nopass drops the mover-again flood, which K1's count already leaves out.
K3_OPS_PER_PLY = {"full": K1_OPS_PER_PLY,
                  "nosample": K1_OPS_PER_PLY - 35 - 25 + 2 * 2,
                  "noflips": K1_OPS_PER_PLY - 2 * 187,
                  "nopass": K1_OPS_PER_PLY}

SEED = 0
LEGAL_BOARDS = 1_000_003      # odd on purpose: the ragged edge
BENCH_LEGAL_BATCH = 65_536    # scripts/bench_pallas.py's default
BIT_STEP_NS = (65_536, 1_025)  # [bit_step] parity: large, and ragged
BIT_STEP_TIME_NS = (512, 1024)  # the evaluation's and the collector's N
# SASS integer instructions (logic, shifts, adds) per clock per SM on
# compute capability 9.0 (CUDA C++ Programming Guide, throughput table).
INT_SASS_PER_CLOCK_PER_SM = 64
ROLLOUT_N = 4096              # bench protocol (BASELINE.json configs[1])
ROLLOUT_STEPS = 512
ROLLOUT_CHUNKS = 64
PARITY_STEPS = 256
RAGGED = ((4099, 64), (1, 64))  # (N, plies): a ragged N and a single game
LANES_NS = (1024, 2048, 4096, 8192, 16384, 65536)  # [rollout_lanes]
LANES_REPS = 8                # chained chunks per [rollout_lanes] time
EVAL_GAMES = 1024             # half as black, half as white
EVAL_RAND_STEPS = 10
WIDTH_MULT, HIDDEN = 2, 1024  # wide2 (data/selfplay/ppo_wide2_4k.msgpack)
VARIANT_REPS = 64             # chunks per timed K3 configuration
# Tuned training recipe (RESULTS.md: N 1024, lr 2.5e-4, entropy 0.01, T 64).
TRAIN_ENVS, TRAIN_STEPS, TRAIN_UPDATES = 1024, 64, 3
TRAIN_LR, TRAIN_ENTROPY = 2.5e-4, 0.01
TRAIN_TEST_GAMES = 200
REF_ENVS, REF_STEPS = 64, 16  # card-vs-CPU update, cut from N 1024, T 64
FP32_BATCH, FP32_PLIES = 256, 37  # the trainer net's card-vs-CPU forward
FP32_ATOL = 1e-4
# Card vs CPU, fp32 sums in other orders on the two devices.  A one-step
# update (1 epoch, 1 minibatch) moves each parameter by lr * g / (|g| +
# eps), so a gradient error dg moves it by at most lr * dg / eps: 2.5e-8
# for a dg of 1e-9 (1e-6 of the largest gradients).  The trainer's update
# (4 epochs x 4 minibatches) lets rounding grow through the ReLU and clip
# kinks over its 16 steps, so each parameter leaf is held relative to its
# own largest delta; the card's update with a planted fault (PLANTS: other
# shuffle words, another GAE lambda, another ratio clip, another
# gradient-norm clip) must read above that limit.
# The metrics (loss means) agree to rtol 1e-4 plus atol 1e-6: in the
# one-step update the action loss is the mean of ratio x normalised
# advantage over the whole batch, ~1e-8.
REF_ONE_STEP_ATOL = 1e-6
REF_PARAM_RTOL = 0.05
REF_METRIC_RTOL, REF_METRIC_ATOL = 1e-4, 1e-6
MAXIMIN_N = 4096              # [maximin]: states at depths 1 and 2
MAXIMIN_N3 = 256              # and at depth 3
MAXIMIN_CHUNK = 300           # a forced chunk that splits the states
MAXIMIN_TIME_N = 200          # decisions timed per depth
MAXIMIN_REPS = 5
EVALCK_GAMES = 200            # [eval_checkpoint] per opponent
# [eval_checkpoint]'s armed runs: (opponent, flags), the opponent "self"
# being the checkpoint itself.
EVALCK_ARMED = (("maximin-2", ("--lookahead-depth", "2")),
                ("greedy", ("--lookahead-depth", "3", "--beam-k", "8")),
                ("self", ("--lookahead", "--opp-lookahead-depth", "1")))
LOOKAHEAD_NS = {1: 4096, 2: 256, 3: 64}   # [lookahead] states per depth
LOOKAHEAD_BEAM = 8
LOOKAHEAD_CHUNK = 64          # a forced chunk that splits the depth-2 states
LOOKAHEAD_TIME_N = 200        # games a timed decision
LOOKAHEAD_REPS = 5
# Card vs CPU: decisions are held where the CPU's margin (best value over
# the second, and the beam's last kept depth-1 value over the first left
# out) exceeds LOOKAHEAD_MARGIN; values, fp32 sums in other orders, to
# LOOKAHEAD_ATOL.
LOOKAHEAD_MARGIN, LOOKAHEAD_ATOL = 1e-4, 1e-4
# [lookahead_train]: RESULTS.md's mix-0.25 recipe
# (data/logs/queue/75_mix25_seed17.log) at its N and T, 4 updates.
LA_ENVS, LA_STEPS, LA_RAND, LA_TAU, LA_MIX = 512, 64, 10, 1.0, 0.25
LA_EPOCHS, LA_LR, LA_UPDATES, LA_DISTILL_TAU = 2, 5e-5, 4, 2.0
TOURNAMENT_GAMES = 100
PLANTS = (("shuffle words", {}, SEED + 2),
          ("gae_lambda 0.9", {"gae_lambda": 0.9}, SEED + 1),
          ("clip_param 0.2", {"clip_param": 0.2}, SEED + 1),
          ("max_grad_norm 1.0", {"max_grad_norm": 1.0}, SEED + 1))
DEVICE_TYPE = "cuda"


def say(*parts):
    print(*parts, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def word_bits_err(tb, a, b):
    """Most differing bits in any word (0 = exact)."""
    return int(tb.popcount(a ^ b).max().item()) if a.numel() else 0


def main():
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "gymothelloenv_tpu_torch")):
        print("chip_smoke.py: gymothelloenv_tpu_torch/ is not beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from gymothelloenv_tpu_torch.core import bitboard as tb
    from gymothelloenv_tpu_torch.models.nets import make_policy_net
    from gymothelloenv_tpu_torch.ops import _build
    from gymothelloenv_tpu_torch.ops import rollout as ro
    from gymothelloenv_tpu_torch.ops import step
    from gymothelloenv_tpu_torch.ops.legal_mask import (legal_mask,
                                                        legal_mask_plain)
    from gymothelloenv_tpu_torch.policies.scripted import greedy_policy
    from gymothelloenv_tpu_torch.scripts import bench_legal_mask as blm
    from gymothelloenv_tpu_torch.scripts import bench_rollout_variants as brv
    from gymothelloenv_tpu_torch.train import tournament as tour
    from gymothelloenv_tpu_torch.utils import timing

    dev = torch.device(DEVICE_TYPE, 0)

    # 1. device -----------------------------------------------------------
    say("[device] start")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=10, check=True).stdout.strip().splitlines()[0]
    say(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build ------------------------------------------------------------
    say("[build] start: nvcc over gymothelloenv_tpu_torch/csrc/*.cu")
    info = _build.build()
    _build.load_library()
    kernels = 0
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"[build] ptxas {line.strip()}")
        kernels += "Compiling entry function" in line
        if "spill" in line:
            require(" 0 bytes spill stores, 0 bytes spill loads" in line,
                    f"a kernel spills registers: {line.strip()}")
    say(f"[build] ok: {'built' if info.built else 'reused'} {info.path.name} "
        f"({kernels} kernels, no spills) in {info.seconds:.2f} s")

    # 3. legal_mask (K2) --------------------------------------------------
    say(f"[legal_mask] start: K2 vs plain on {LEGAL_BOARDS} reachable "
        "boards and at the evaluation's 2 x 512 boards")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = ro.rollout_init(LEGAL_BOARDS, dev)
    cur, opp = state.cur.clone(), state.opp.clone()
    for i in range(8):       # snapshots after 9, 18, ... 72 random plies
        state, _ = ro.rollout_chunk(state, 1000 + i, 9)
        take = torch.rand(LEGAL_BOARDS, generator=gen,
                          device=dev) < 1 / (i + 2)
        cur = torch.where(take, state.cur, cur)
        opp = torch.where(take, state.opp, opp)
    got = legal_mask(cur, opp)
    want = legal_mask_plain(cur, opp)
    require(torch.equal(got, want), "K2 disagrees with its plain version")
    nbytes = 24 * LEGAL_BOARDS
    k2_big = dict(ms=timing.device_ms(lambda: legal_mask(cur, opp), 100),
                  plain_ms=timing.call_ms(lambda: legal_mask_plain(cur, opp),
                                   3))
    k2_big["bound_ms"], _ = bound_ms(nbytes, K2_OPS_PER_BOARD * LEGAL_BOARDS)
    # The main path's shape: bit_step stacks both sides of 512 games.
    m = torch.cat([cur[:512], opp[:512]])
    o = torch.cat([opp[:512], cur[:512]])
    got_s, want_s = legal_mask(m, o), legal_mask_plain(m, o)
    require(torch.equal(got_s, want_s), "K2 disagrees at the eval shape")
    k2 = dict(ms=timing.device_ms(lambda: legal_mask(m, o), 200),
              call_ms=timing.call_ms(lambda: legal_mask(m, o), 200),
              plain_ms=timing.call_ms(lambda: legal_mask_plain(m, o), 20))
    k2["bound_ms"], k2["bound_by"] = bound_ms(24 * 1024,
                                              K2_OPS_PER_BOARD * 1024)
    k2["max_abs_err"] = max(word_bits_err(tb, got, want),
                            word_bits_err(tb, got_s, want_s))
    k2_big.update(_sass_bound(torch, info.path, "legal_mask_kernel",
                              LEGAL_BOARDS))
    # K2's own path, the one the JAX package gives it (bench_pallas.py):
    # its count starts at 0 here.
    legal_mask.launches = 0
    bench = blm.run(BENCH_LEGAL_BATCH, dev,
                    out=lambda line: say(f"[legal_mask] bench: {line}"))
    bench["launches"] = legal_mask.launches
    require(bench["launches"] > 0, "K2 was not launched on its benchmark")
    sass = (f"{k2_big['sass_per_board']} SASS instructions a board, a bound "
            f"of {k2_big['sass_bound_ms']:.4f} ms at "
            f"{INT_SASS_PER_CLOCK_PER_SM} a clock per SM on "
            f"{k2_big['sms']} SMs at {k2_big['sm_clock_mhz']} MHz "
            f"({100 * k2_big['sass_bound_ms'] / k2_big['ms']:.1f}% of it)"
            if k2_big["sass_per_board"] else "cuobjdump not found: no SASS "
            "count, the formula's bound only")
    say(f"[legal_mask] ok: exact on {LEGAL_BOARDS} boards: kernel "
        f"{k2_big['ms']:.4f} ms, plain {k2_big['plain_ms']:.3f} ms, bound "
        f"{k2_big['bound_ms']:.4f} ms; {sass}; at 1024 boards: kernel "
        f"{k2['ms']:.4f} ms on the device, {k2['call_ms']:.4f} ms per "
        f"wrapper call, plain {k2['plain_ms']:.3f} ms; bench at "
        f"{BENCH_LEGAL_BATCH} random boards exact, {bench['launches']} "
        "launches")

    # 3b. bit_step (the ply kernel and reset_where) -------------------------
    ply = _bit_step_phase(torch, tb, ro, step, timing, dev, gen)

    # 4. rollout_parity (K1, injected words) -------------------------------
    say(f"[rollout_parity] start: K1 words mode vs plain ply loop at lanes "
        f"{ro.LANES}, {ROLLOUT_N} games x {PARITY_STEPS} plies, and "
        + ", ".join(f"{n} x {k}" for n, k in RAGGED))
    words = torch.randint(-2 ** 31, 2 ** 31, (PARITY_STEPS, ROLLOUT_N),
                          dtype=torch.int32, generator=gen, device=dev)
    words_eps = 0
    for n, steps in ((ROLLOUT_N, PARITY_STEPS),) + RAGGED:
        w = words if n == ROLLOUT_N else torch.randint(
            -2 ** 31, 2 ** 31, (steps, n), dtype=torch.int32, generator=gen,
            device=dev)
        s0 = ro.rollout_init(n, dev)
        want, want_eps = ro.rollout_chunk_plain(s0, 0, steps, words=w)
        require(int(want_eps) > 0, f"no game ended in {n} x {steps} plies")
        for lanes in ro.LANES:
            got, got_eps = ro.rollout_chunk(s0, 0, steps, words=w,
                                            lanes=lanes)
            for field in ("cur", "opp", "legal"):
                require(torch.equal(getattr(got, field), getattr(want, field)),
                        f"K1 (words, N {n}, lanes {lanes}) disagrees with "
                        f"plain on {field}")
            require(int(got_eps) == int(want_eps),
                    f"K1 (words, N {n}, lanes {lanes}) episodes "
                    f"{int(got_eps)} != plain {int(want_eps)}")
        if n == ROLLOUT_N:
            words_eps = int(want_eps)
    s0 = ro.rollout_init(ROLLOUT_N, dev)
    words_ms = timing.device_ms(lambda: ro.rollout_chunk(
        s0, 0, PARITY_STEPS, words=words), 5)
    say(f"[rollout_parity] ok: state and episodes exact at every lanes "
        f"({words_eps} episodes at N {ROLLOUT_N}); kernel {words_ms:.3f} ms "
        f"for {PARITY_STEPS} plies at lanes {ro.rollout_lanes(ROLLOUT_N)}")

    # 5. rollout (K1, Philox, bench protocol) ------------------------------
    k1, rollout_launches = _rollout_phase(torch, tb, ro, legal_mask_plain,
                                          dev)
    k1["lanes_ms"] = _rollout_lanes_phase(torch, ro, dev)

    # 6. eval (the ply kernel on every ply, K2 in bit_reset) -----------------
    say(f"[eval] start: wide2 PolicyNet (width_mult={WIDTH_MULT}, "
        f"hidden={HIDDEN}, seeded init) vs greedy, {EVAL_GAMES} games, "
        f"init_rand_steps={EVAL_RAND_STEPS}")
    net = make_policy_net(WIDTH_MULT, HIDDEN, seed=SEED, device=dev)
    # Main path: the counts of K2 and the ply kernel start at 0 here.
    legal_mask.launches = 0
    step.bit_step.launches = 0
    act = tour.net_tournament_policy(net)
    egen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _no_plain(tb) as plain_calls:
        wins, draws, losses = tour.evaluate(act, greedy_policy, EVAL_GAMES,
                                            EVAL_RAND_STEPS, generator=egen,
                                            device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = {"legal_mask": legal_mask.launches,
                "bit_step": step.bit_step.launches,
                "rollout": rollout_launches}
    require(wins + draws + losses == EVAL_GAMES, "eval lost games")
    for kname, count in launches.items():
        require(count > 0, f"kernel {kname} was not launched on the main path")
    require(not plain_calls, f"the evaluation ran the ply's plain version "
            f"on the card: {plain_calls[:3]}")
    say(f"[eval] ok: W/D/L {wins}/{draws}/{losses} in {eval_s:.2f} s; "
        f"main-path launches {launches}")

    # Card against CPU on the same deterministic games and net inputs.
    say("[eval_reference] start: card vs CPU on 256 state-determined games "
        "and the net's forward")
    pol = _index_policies(torch, tb)
    on_card = tour.play_games(pol(dev, 0), pol(dev, 1), 256, device=dev)
    on_cpu = tour.play_games(pol("cpu", 0), pol("cpu", 1), 256,
                             device="cpu")
    require(torch.equal(on_card.cpu(), on_cpu), "card and CPU games differ")
    from gymothelloenv_tpu_torch.core.featurize import make_state
    x = make_state(tb.bit_reset(8, dev))
    with torch.inference_mode():
        logits, value = net(x)
        net_cpu = make_policy_net(WIDTH_MULT, HIDDEN, seed=SEED,
                                  device="cpu")
        logits_c, value_c = net_cpu(x.cpu())
    net_err = max(float((logits.cpu() - logits_c).abs().max()),
                  float((value.cpu() - value_c).abs().max()))
    require(bool(torch.isfinite(logits).all()) and logits.shape == (8, 64),
            "net output not finite or misshapen")
    require(net_err <= 1e-4, f"net on card vs CPU: {net_err:.2e} > 1e-4")
    say(f"[eval_reference] ok: winners equal ({tour.tally(on_cpu)}); net "
        f"max abs err {net_err:.2e} (fp32, tolerance 1e-4)")

    # 8. variants (K3: parity, then the profiler as its main path) ----------
    k3 = _variants_phase(torch, tb, ro, brv, dev, words)

    # 9. train (the ply kernel on every ply) and 10. train_reference ----------
    train, trainer = _train_phase(torch, tb, legal_mask, step, timing, dev)
    _train_reference_phase(torch, dev)

    # 12. checkpoint, 13. maximin, 14. lookahead, 15. lookahead_train,
    # 16. eval_checkpoint ---------------------------------------------------
    _checkpoint_phase(torch, trainer, dev)
    mm = _maximin_phase(torch, tb, ro, step, dev, gen)
    la = _lookahead_phase(torch, tb, ro, step, net, dev, gen)
    la_train = _lookahead_train_phase(torch, tb, legal_mask, step, dev)
    evalck = _eval_checkpoint_phase(torch, tb, legal_mask, step, net, dev)

    # 11. kernels line --------------------------------------------------------
    rows = [
        dict(name="legal_mask", route="cuda",
             source="gymothelloenv_tpu_torch/csrc/legal_mask.cu",
             replaces="gymothelloenv_tpu/ops/pallas_bitboard.py:76",
             launches=(bench["launches"] + launches["legal_mask"]
                       + train["k2_launches"] + la_train["k2_launches"]
                       + evalck["k2_launches"]),
             launches_by_path={"bench": bench["launches"],
                               "eval": launches["legal_mask"],
                               "train": train["k2_launches"],
                               "lookahead_train": la_train["k2_launches"],
                               "eval_checkpoint": evalck["k2_launches"]},
             library_ms=None,
             equal=True, tolerance="exact", shape="2 x 512 boards",
             ms_1m=k2_big["ms"], plain_ms_1m=k2_big["plain_ms"],
             bound_ms_1m=k2_big["bound_ms"],
             sass_per_board=k2_big["sass_per_board"],
             sass_bound_ms_1m=k2_big["sass_bound_ms"],
             bench_boards=BENCH_LEGAL_BATCH, bench_ms=bench["ms"],
             bench_call_ms=bench["call_ms"],
             bench_plain_ms=bench["plain_ms"], **k2),
        dict(name="bit_step", route="cuda",
             source="gymothelloenv_tpu_torch/csrc/step.cu",
             replaces="no Pallas kernel: gymothelloenv_tpu/core/bitboard.py"
                      ":254 bit_step (XLA-fused); carries K2's flood on the "
                      "main path",
             launches=(launches["bit_step"] + train["bit_step_launches"]
                       + mm["launches"] + la["launches"]
                       + la_train["bit_step_launches"]
                       + evalck["bit_step_launches"]),
             launches_by_path={"eval": launches["bit_step"],
                               "train": train["bit_step_launches"],
                               "maximin": mm["launches"],
                               "lookahead": la["launches"],
                               "lookahead_train":
                                   la_train["bit_step_launches"],
                               "eval_checkpoint":
                                   evalck["bit_step_launches"]},
             library_ms=None, equal=True, tolerance="exact",
             shape="1024 games, where mode (the collector's)",
             train_ms=train["ply_ms"], maximin=mm["timing"],
             lookahead=la["timing"], lookahead_train=la_train["seconds"],
             **ply["bit_step"]),
        dict(name="reset_where", route="cuda",
             source="gymothelloenv_tpu_torch/csrc/step.cu",
             replaces="no Pallas kernel: gymothelloenv_tpu/core/engine.py"
                      ":120 BitEngine.reset_where (XLA-fused)",
             launches=train["reset_launches"] + la_train["reset_launches"],
             launches_by_path={"train": train["reset_launches"],
                               "lookahead_train":
                                   la_train["reset_launches"]},
             library_ms=None, equal=True, tolerance="exact",
             shape="1024 games (the collector's)",
             train_ms=train["reset_ms"], **ply["reset_where"]),
        dict(name="rollout", route="cuda",
             source="gymothelloenv_tpu_torch/csrc/rollout.cu",
             replaces="gymothelloenv_tpu/ops/pallas_rollout.py:193",
             launches=launches["rollout"], library_ms=None,
             equal=True, tolerance="exact",
             shape=f"{ROLLOUT_N} games x {ROLLOUT_STEPS} plies",
             words_ms=words_ms, words_plies=PARITY_STEPS, **k1),
        dict(name="rollout_variants", route="cuda",
             source="gymothelloenv_tpu_torch/csrc/rollout.cu",
             replaces="scripts/bench_rollout_variants.py:68",
             library_ms=None, equal=True, tolerance="exact",
             shape=f"{ROLLOUT_N} games x {ROLLOUT_STEPS} plies", **k3),
    ]
    say(json.dumps({"kernels": rows}))
    say(f"total_seconds {time.perf_counter() - t_start:.2f}")
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _rollout_phase(torch, tb, ro, legal_mask_plain, dev):
    """K1 on Philox: the 512-ply chunk from the opening at every lanes
    against the plain loop, then the bench protocol through rollout_chunks
    at the lanes rollout_lanes picks (the main path, launches counted from
    0), then the same protocol at lanes 1.  Returns the kernels-line fields
    and the main path's launch count."""
    lanes = ro.rollout_lanes(ROLLOUT_N)
    say(f"[rollout] start: N={ROLLOUT_N}, {ROLLOUT_STEPS} plies/chunk, "
        f"{ROLLOUT_CHUNKS} chunks after one warm-up chunk, lanes {lanes} "
        f"(rollout_lanes), then the same at lanes 1")
    s0 = ro.rollout_init(ROLLOUT_N, dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    plain, plain_eps = ro.rollout_chunk_plain(s0, SEED, ROLLOUT_STEPS)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    err = 0
    for each in ro.LANES:
        got, got_eps = ro.rollout_chunk(s0, SEED, ROLLOUT_STEPS, lanes=each)
        for field in ("cur", "opp", "legal"):
            require(torch.equal(getattr(got, field), getattr(plain, field)),
                    f"K1 (Philox, lanes {each}) disagrees with plain on "
                    f"{field}")
        require(int(got_eps) == int(plain_eps),
                f"K1 (Philox, lanes {each}) episode count disagrees with "
                "plain")
        err = max(err, max(word_bits_err(tb, getattr(got, f),
                                         getattr(plain, f))
                           for f in ("cur", "opp", "legal")))

    def protocol(lanes_):
        """(warm-up chunk, state, episodes, ms per chunk) of the bench."""
        warm, _ = ro.rollout_chunk(s0, SEED, ROLLOUT_STEPS, lanes=lanes_)
        torch.cuda.synchronize()
        start.record()
        final, total = ro.rollout_chunks(warm, SEED + 1, ROLLOUT_CHUNKS,
                                         ROLLOUT_STEPS, lanes=lanes_)
        end.record()
        torch.cuda.synchronize()
        return warm, final, total, start.elapsed_time(end) / ROLLOUT_CHUNKS

    # Main path: K1's count starts at 0 here.
    ro.rollout_chunk.launches = 0
    warm, final, total_eps, chunk_ms = protocol(lanes)
    launches = ro.rollout_chunk.launches
    require(launches == ROLLOUT_CHUNKS + 1,
            f"K1 launched {launches} times on the main path, expected "
            f"{ROLLOUT_CHUNKS + 1}")
    for field in ("cur", "opp", "legal"):
        require(torch.equal(getattr(warm, field), getattr(plain, field)),
                f"K1's warm-up chunk disagrees with plain on {field}")
    steps = ROLLOUT_N * ROLLOUT_STEPS * ROLLOUT_CHUNKS
    env_steps_per_s = steps / (chunk_ms * ROLLOUT_CHUNKS / 1e3)
    plies_per_episode = steps / total_eps
    require(55 <= plies_per_episode <= 67,
            f"{plies_per_episode:.2f} plies per episode, expected 55-67")
    require(int(((final.cur & final.opp) != 0).sum()) == 0,
            "rollout disks overlap")
    require(torch.equal(final.legal, legal_mask_plain(final.cur, final.opp)),
            "stored legal mask differs from a recomputed one")
    require(bool((final.legal != 0).all()), "a game has no legal move")
    _, final1, total1, chunk1_ms = protocol(1)
    require(torch.equal(final1.cur, final.cur) and total1 == total_eps,
            "the bench at lanes 1 played other games than at lanes "
            f"{lanes}")
    k1_ops = K1_OPS_PER_PLY * ROLLOUT_N * ROLLOUT_STEPS
    k1 = dict(ms=chunk_ms, plain_ms=plain_ms, max_abs_err=err, lanes=lanes,
              env_steps_per_sec=env_steps_per_s,
              plies_per_episode=plies_per_episode, ms_lanes1=chunk1_ms,
              env_steps_per_sec_lanes1=steps / (chunk1_ms * ROLLOUT_CHUNKS
                                                / 1e3))
    k1["bound_ms"], k1["bound_by"] = bound_ms(48 * ROLLOUT_N + 8, k1_ops)
    say(f"[rollout] ok: the {ROLLOUT_STEPS}-ply Philox chunk equal to plain "
        f"at lanes {ro.LANES}; lanes {lanes}: {chunk_ms:.4f} ms/chunk, "
        f"env_steps_per_sec={env_steps_per_s:.1f}, {launches} launches, "
        f"{total_eps} episodes, plies_per_episode={plies_per_episode:.3f}; "
        f"lanes 1 (same games): {chunk1_ms:.4f} ms/chunk, env_steps_per_sec="
        f"{k1['env_steps_per_sec_lanes1']:.1f}; plain chunk {plain_ms:.1f} ms")
    return k1, launches


def _rollout_lanes_phase(torch, ro, dev):
    """K1's ms per chained ROLLOUT_STEPS-ply chunk at every lanes for each
    N of LANES_NS: the grounds of rollout_lanes.  Returns {N: {lanes:
    ms}}."""
    say(f"[rollout_lanes] start: ms per {ROLLOUT_STEPS}-ply chunk at lanes "
        f"{ro.LANES} for N {LANES_NS}, {LANES_REPS} chained chunks each")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    table = {}
    for n in LANES_NS:
        row = {}
        for lanes in ro.LANES:
            state, _ = ro.rollout_chunk(ro.rollout_init(n, dev), SEED,
                                        ROLLOUT_STEPS, lanes=lanes)
            torch.cuda.synchronize()
            start.record()
            for i in range(LANES_REPS):
                state, _ = ro.rollout_chunk(state, SEED + 1 + i,
                                            ROLLOUT_STEPS, lanes=lanes)
            end.record()
            torch.cuda.synchronize()
            row[lanes] = start.elapsed_time(end) / LANES_REPS
        best = min(row, key=row.get)
        picked = ro.rollout_lanes(n)
        say(f"[rollout_lanes] N {n}: " + ", ".join(
            f"lanes {k} {v:.4f}" for k, v in row.items())
            + f" ms; fastest lanes {best}, rollout_lanes picks {picked} "
            f"({100 * (row[picked] / row[best] - 1):.1f}% above the fastest)")
        table[n] = row
    say("[rollout_lanes] ok")
    return table


def _variants_phase(torch, tb, ro, brv, dev, words):
    """K3: each built variant against its plain loop on injected words at
    lanes 1 and BENCH_LANES and on the profiler's own Philox chunk, full
    at every knob against K1, then every profiler configuration at the
    lanes K1 runs at.  Returns the kernels-line fields."""
    from gymothelloenv_tpu_torch.utils import timing
    steps = words.shape[0]
    lanes = ro.rollout_lanes(ROLLOUT_N)
    configs = brv.configs(lanes)
    say(f"[variants] start: K3 variants vs plain on {ROLLOUT_N} games x "
        f"{steps} plies of injected words at lanes 1 and {ro.BENCH_LANES} "
        f"and on a {ROLLOUT_STEPS}-ply Philox chunk at lanes {lanes}; full "
        "at every knob vs K1")
    s0 = ro.rollout_init(ROLLOUT_N, dev)
    err = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def same(got, got_eps, want, want_eps, what):
        for field in ("cur", "opp", "legal"):
            require(torch.equal(getattr(got, field), getattr(want, field)),
                    f"K3 {what} disagrees on {field}")
        require(int(got_eps) == int(want_eps),
                f"K3 {what}: {int(got_eps)} episodes, want {int(want_eps)}")
        return max(word_bits_err(tb, getattr(got, f), getattr(want, f))
                   for f in ("cur", "opp", "legal"))

    checked = 0
    for variant in ro.VARIANTS:
        want, want_eps = ro.rollout_chunk_plain(s0, 0, steps, words,
                                                variant)
        for unroll in ro.UNROLLS:
            for each in (1, ro.BENCH_LANES):
                if not ro.built(variant, unroll, each):
                    continue
                got, got_eps = ro.rollout_variant_chunk(
                    s0, 0, steps, variant, unroll=unroll, lanes=each,
                    words=words)
                err = max(err, same(got, got_eps, want, want_eps,
                                    f"{variant} unroll {unroll} lanes "
                                    f"{each} (words) vs plain"))
                checked += 1
    parity_ms = timing.device_ms(lambda: ro.rollout_variant_chunk(
        s0, 0, steps, "full", lanes=lanes, words=words), 5)
    # The profiler's kernels (Philox, ROLLOUT_STEPS plies from the
    # opening), each against its variant's plain loop; full's against K1.
    k1, k1_eps = ro.rollout_chunk(s0, SEED, ROLLOUT_STEPS)
    plain_ms = {}
    for variant in ro.VARIANTS:
        start.record()
        want, want_eps = ro.rollout_chunk_plain(s0, SEED, ROLLOUT_STEPS,
                                                variant=variant)
        end.record()
        torch.cuda.synchronize()
        plain_ms[variant] = start.elapsed_time(end)
        for name, knobs in configs:
            if knobs["variant"] != variant:
                continue
            got, got_eps = ro.rollout_variant_chunk(s0, SEED, ROLLOUT_STEPS,
                                                    **knobs)
            err = max(err, same(got, got_eps, want, want_eps,
                                f"{name} (Philox) vs plain"))
            if variant == "full":
                same(got, got_eps, k1, k1_eps, f"{name} vs K1")
    say(f"[variants] parity ok: {checked} kernels (4 variants, full at "
        f"unroll 1/2/4, at lanes 1 and {ro.BENCH_LANES}) exact vs plain on "
        f"{steps} plies of words (kernel {parity_ms:.4f} ms); all "
        f"{len(configs)} configurations at lanes {lanes} exact vs plain on "
        f"the {ROLLOUT_STEPS}-ply Philox chunk (plain "
        + ", ".join(f"{v} {ms:.1f} ms" for v, ms in plain_ms.items())
        + "); every full configuration equals K1")
    # K1 under the profiler's protocol (every chunk from the opening, not
    # chained as in [rollout]), to set K3's times beside K1's.
    total = torch.zeros((), dtype=torch.int64, device=dev)
    start.record()
    for i in range(VARIANT_REPS):
        ro.rollout_chunk(s0, 1000 + i, ROLLOUT_STEPS, episodes=total)
    end.record()
    torch.cuda.synchronize()
    k1_restart_ms = start.elapsed_time(end) / VARIANT_REPS
    say(f"[variants] K1 from the opening each chunk: {k1_restart_ms:.4f} "
        "ms/chunk")

    # Main path: the profiler's configurations.
    ro.rollout_variant_chunk.launches = 0
    results = brv.run(ROLLOUT_N, ROLLOUT_STEPS, VARIANT_REPS, dev,
                      out=lambda line: say(f"[variants] {line}"), lanes=lanes)
    launches = ro.rollout_variant_chunk.launches
    require(launches > 0, "kernel rollout_variants was not launched on "
            "its main path")
    rows = {}
    for name, knobs in configs:
        r = results[name]
        ops = K3_OPS_PER_PLY[knobs["variant"]]
        b_ms, b_by = bound_ms(48 * ROLLOUT_N + 8,
                              ops * ROLLOUT_N * ROLLOUT_STEPS)
        rows[name] = dict(ms=r["ms"], m_plies_per_s=r["plies_per_s"] / 1e6,
                             bound_ms=b_ms, bound_by=b_by, ops_per_ply=ops,
                             episodes=r["episodes"],
                             plain_ms=plain_ms[knobs["variant"]])
        say(f"[variants] {name:13s} bound {b_ms:.4f} ms ({b_by}, {ops} "
            f"int ops/ply); {100 * b_ms / r['ms']:.1f}% of bound")
    full = rows["full"]
    say(f"[variants] ok: {launches} launches on the profiler path")
    return dict(launches=launches, max_abs_err=err, ms=full["ms"],
                plain_ms=plain_ms["full"], parity_ms=parity_ms,
                parity_plies=steps, k1_restart_ms=k1_restart_ms,
                bound_ms=full["bound_ms"], bound_by=full["bound_by"],
                lanes=lanes, configs=rows)


def _sass_bound(torch, library, kernel, boards):
    """The integer-rate bound of a straight-line one-thread-a-board kernel
    from its compiled code: its SASS instructions (cuobjdump; NOPs and the
    closing self-branch left out) x boards over INT_SASS_PER_CLOCK_PER_SM
    x SMs x the card's top SM clock.  Fields None without cuobjdump."""
    out = dict(sass_per_board=None, sass_bound_ms=None,
               sms=torch.cuda.get_device_properties(0).multi_processor_count,
               sm_clock_mhz=None)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return out
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    body = sass.split("Function : ")
    found = [b for b in body[1:] if kernel in b.split("\n", 1)[0]]
    require(len(found) == 1, f"{kernel}: {len(found)} SASS functions")
    ops = [line.split("*/", 1)[1].split(";")[0].split()
           for line in found[0].splitlines()
           if line.strip().startswith("/*") and ";" in line]
    ops = [op for op in ops if op]
    names = [op[1] if op[0].startswith("@") else op[0] for op in ops]
    branches = [n for n in names if n.startswith("BRA")]
    require(len(branches) == 1, f"{kernel} branches {len(branches)} times: "
            "its SASS count is not a per-board count")
    count = sum(1 for n in names if n not in ("NOP", "BRA"))
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=10, check=True).stdout.split()[0]
    out["sm_clock_mhz"] = int(clock)
    out["sass_per_board"] = count
    out["sass_bound_ms"] = 1e3 * count * boards / (
        INT_SASS_PER_CLOCK_PER_SM * out["sms"] * int(clock) * 1e6)
    return out


@contextlib.contextmanager
def _no_plain(tb):
    """Record each call of the ply's plain versions (bit_step_plain,
    reset_where_plain) while the block runs: on the card a main path must
    make none."""
    calls = []
    real = (tb.bit_step_plain, tb.reset_where_plain)

    def counted(fn):
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    tb.bit_step_plain, tb.reset_where_plain = map(counted, real)
    try:
        yield calls
    finally:
        tb.bit_step_plain, tb.reset_where_plain = real


def _ply_inputs(torch, tb, ro, n, dev, gen):
    """``n`` reachable states (K1 games after a 512-ply warm-up, each
    taken at one of the next 64 plies, so every stage of a game is there)
    with a random mover, a tenth
    of them terminated; an action per game of one of six classes: legal
    (half), an empty cell that is not legal, an occupied cell, -1, 64 and
    100; and a random ``do`` and ``done``."""
    s, _ = ro.rollout_chunk(ro.rollout_init(n, dev), SEED, ROLLOUT_STEPS)
    cur, opp = s.cur.clone(), s.opp.clone()
    for i in range(64):      # a snapshot after each of 64 plies, uniformly
        s, _ = ro.rollout_chunk(s, 2000 + i, 1)
        take = torch.rand(n, generator=gen, device=dev) < 1 / (i + 2)
        cur = torch.where(take, s.cur, cur)
        opp = torch.where(take, s.opp, opp)

    def coin(p):
        return torch.rand(n, generator=gen, device=dev) < p

    def pick(word):
        return tb.random_legal_bit(
            word, tb.uniform_index(tb.popcount(word), gen))

    white, term = coin(0.5), coin(0.1)
    black_w = torch.where(white, opp, cur)
    white_w = torch.where(white, cur, opp)
    margin = tb.popcount(white_w) - tb.popcount(black_w)
    state = tb.BitState(
        black=black_w, white=white_w,
        turn=torch.where(white, 1, -1).to(torch.int8),
        legal=torch.where(term, 0, tb.legal_mask(cur, opp)),
        terminated=term,
        winner=torch.where(term, torch.sign(margin), 0).to(torch.int8))
    disks = black_w | white_w
    kind = torch.randint(0, 10, (n,), generator=gen, device=dev)
    action = pick(state.legal)                      # kinds 0-4
    for k, a in ((5, pick(~disks & ~state.legal)), (6, pick(disks)),
                 (7, -1), (8, 64), (9, 100)):
        action = torch.where(kind == k, a, action)
    return state, action, coin(0.7), coin(0.5)


def _ply_err(torch, tb, got, want):
    """Largest difference between two ply results (or two states): bits
    in a word, else the absolute difference of a field; 0 = exact."""
    pairs = [(got, want)] if not hasattr(got, "state") else [
        (got.state, want.state)]
    err = 0.0
    for g, w in pairs:
        for f in ("black", "white", "legal"):
            err = max(err, word_bits_err(tb, getattr(g, f), getattr(w, f)))
        for f in ("turn", "terminated", "winner"):
            err = max(err, float((getattr(g, f).to(torch.int32)
                                  - getattr(w, f).to(torch.int32)
                                  ).abs().max()))
    if hasattr(got, "state"):
        err = max(err, float((got.reward - want.reward).abs().max()),
                  float((got.done != want.done).sum()))
    return err


def _bit_step_phase(torch, tb, ro, step, timing, dev, gen):
    """The ply kernel in every mode with both flags each way, and
    reset_where, against their plain versions on BIT_STEP_NS games; then
    their times at BIT_STEP_TIME_NS.  Returns the kernels-line fields of
    both."""
    say(f"[bit_step] start: the ply kernel (plain, where, autoreset; both "
        f"flags each way) and reset_where vs plain, exact, on "
        f"{' and '.join(map(str, BIT_STEP_NS))} reachable states with "
        "terminated games and legal, empty-illegal, occupied, -1, 64 and "
        "100 actions")
    err, big = 0.0, None
    for n in BIT_STEP_NS:
        state, action, do, done = _ply_inputs(torch, tb, ro, n, dev, gen)
        if big is None:
            big = (state, action, do, done)
        checked = 0
        for sudden in (True, False):
            for disk in (False, True):
                for mode, kw in (("plain", {}), ("where", {"do": do}),
                                 ("autoreset", {"autoreset": True})):
                    got = step.bit_step(state, action, sudden, disk, **kw)
                    want = tb.bit_step_plain(state, action, sudden, disk,
                                             **kw)
                    e = _ply_err(torch, tb, got, want)
                    require(e == 0, f"the ply kernel ({mode}, sudden "
                            f"{sudden}, disk reward {disk}, N {n}) differs "
                            f"from plain by {e}")
                    err, checked = max(err, e), checked + 1
                    if (sudden, disk, mode) == (False, False, "plain"):
                        cover = _ply_coverage(torch, tb, state, action, want)
        e = _ply_err(torch, tb, step.reset_where(state, done),
                     tb.reset_where_plain(state, done))
        require(e == 0, f"reset_where (N {n}) differs from plain by {e}")
        say(f"[bit_step] N {n}: {checked} ply results and reset_where exact; "
            f"without sudden death: {cover}")
        if n == BIT_STEP_NS[0]:   # a stuck end is too rare to require
            require(min(v for k, v in cover.items() if k != "ended_stuck")
                    > 0, f"[bit_step] the inputs miss a case at N {n}: "
                    f"{cover}")
    state, action, do, done = big
    reset_err = 0.0
    rows = {"bit_step": {}, "reset_where": {}}
    for n in BIT_STEP_TIME_NS:
        st = tb.BitState(**{k: v[:n] for k, v in vars(state).items()})
        a, d, dn = action[:n], do[:n], done[:n]

        def run_ply():
            return step.bit_step(st, a, True, True, do=d)

        def reset():
            return step.reset_where(st, dn)

        want = tb.bit_step_plain(st, a, True, True, do=d)
        e = _ply_err(torch, tb, run_ply(), want)
        require(e == 0, f"the ply kernel (where, N {n}) differs from plain "
                f"by {e}")
        err = max(err, e)
        e = _ply_err(torch, tb, reset(), tb.reset_where_plain(st, dn))
        require(e == 0, f"reset_where (N {n}) differs from plain by {e}")
        reset_err = max(reset_err, e)
        is_white = st.turn == 1
        mine = torch.where(is_white, want.state.white, want.state.black)
        opp = torch.where(is_white, want.state.black, want.state.white)
        second = d & (tb.legal_mask(opp, mine) == 0)
        ops = (PLY_OPS_PER_GAME * int(d.sum())
               + PLY_SECOND_FLOOD_OPS * int(second.sum()))
        # Every game: state 27 B and do 1 B read, 32 B written.  Where the
        # game steps, its 8 B action is read and its terminated and winner
        # (2 B) are not.
        nbytes = 60 * n + 6 * int(d.sum())
        t = dict(ms=timing.device_ms(run_ply, 200),
                 call_ms=timing.call_ms(run_ply, 200),
                 plain_ms=timing.call_ms(
                     lambda: tb.bit_step_plain(st, a, True, True, do=d), 10))
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, ops)
        r = dict(ms=timing.device_ms(reset, 200),
                 call_ms=timing.call_ms(reset, 200),
                 plain_ms=timing.call_ms(
                     lambda: tb.reset_where_plain(st, dn), 10))
        # Every game: done 1 B read, 27 B written; the state's 27 B read
        # only where the game is not reset.
        r["bound_ms"], r["bound_by"] = bound_ms(
            28 * n + 27 * int((~dn).sum()), 0)
        suffix = "" if n == BIT_STEP_TIME_NS[-1] else f"_{n}"
        rows["bit_step"].update({k + suffix: v for k, v in t.items()})
        rows["reset_where"].update({k + suffix: v for k, v in r.items()})
        say(f"[bit_step] N {n} (where mode, exact vs plain): kernel "
            f"{t['ms']:.5f} ms on the "
            f"device, {t['call_ms']:.5f} ms per wrapper call, plain "
            f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.7f} ms "
            f"({t['bound_by']}); reset_where {r['ms']:.5f} ms, "
            f"{r['call_ms']:.5f} ms per call, plain {r['plain_ms']:.3f} ms")
    rows["bit_step"]["max_abs_err"] = err
    rows["reset_where"]["max_abs_err"] = reset_err
    say("[bit_step] ok")
    return rows


def _ply_coverage(torch, tb, state, action, res):
    """How many games of a ply (without sudden death) took each path."""
    valid = (state.legal & tb.action_bit(action)) != 0
    full = tb.popcount(res.state.black | res.state.white) == 64
    return dict(legal=int(valid.sum()),
                ended_full=int((res.done & full & valid).sum()),
                ended_stuck=int((res.done & ~full & valid).sum()),
                passes=int((~res.done & (res.state.turn == state.turn)).sum()),
                terminated_in=int(state.terminated.sum()))


def _train_phase(torch, tb, legal_mask, step, timing, dev):
    """PPOSelfPlayTrainer at wide2 with the tuned recipe: TRAIN_UPDATES
    updates and one evaluation, the counts of K2 and the ply kernel from
    0."""
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                           SelfPlayConfig)
    say(f"[train] start: PPOSelfPlayTrainer wide2 (width_mult={WIDTH_MULT}, "
        f"hidden={HIDDEN}), N={TRAIN_ENVS}, T={TRAIN_STEPS}, ppo_epochs 4, "
        f"num_mini_batch 4, lr {TRAIN_LR}, entropy {TRAIN_ENTROPY}, "
        f"{TRAIN_UPDATES} updates, then {TRAIN_TEST_GAMES}-game evals")
    ppo_cfg = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY,
                        ppo_epochs=4, num_mini_batch=4,
                        num_updates=TRAIN_UPDATES)
    run_cfg = SelfPlayConfig(num_envs=TRAIN_ENVS, num_steps=TRAIN_STEPS,
                             hidden_size=HIDDEN, width_mult=WIDTH_MULT,
                             num_test_games=TRAIN_TEST_GAMES,
                             test_interval=10 ** 9, seed=SEED)
    env_cfg = EnvConfig(num_disk_as_reward=True)
    records = []
    seen = [0, 0]

    def log_fn(update, metrics):
        now = [step.bit_step.launches, step.reset_where.launches]
        metrics = dict(metrics, step_launches=now[0] - seen[0],
                       reset_launches=now[1] - seen[1])
        seen[:] = now
        records.append(metrics)
        say(f"[train] update {update}: collect "
            f"{metrics['collect_seconds']:.3f} s, update "
            f"{metrics['update_seconds']:.3f} s, "
            f"transitions_per_sec={metrics['transitions_per_sec']:.1f}, "
            f"value_loss={metrics['value_loss']:.5g} "
            f"action_loss={metrics['action_loss']:.5g} "
            f"entropy={metrics['entropy']:.5g}, episodes "
            f"{int(metrics['episodes'])}, ply-kernel launches "
            f"{metrics['step_launches']} bit_step + "
            f"{metrics['reset_launches']} reset_where, collector host syncs "
            f"{metrics['collect_syncs']}")

    # F1: the trainer, not this script, switches TF32 off.  Both flags on
    # first (cuDNN's default; matmul's as a caller may leave it).
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    # Main path: the counts of K2 and the ply kernel start at 0 here.
    legal_mask.launches = 0
    step.bit_step.launches = 0
    step.reset_where.launches = 0
    with _no_plain(tb) as plain_calls:
        trainer = PPOSelfPlayTrainer(env_cfg, ppo_cfg, run_cfg,
                                     log_fn=log_fn, device=dev)
        _fp32_check(torch, trainer.net, dev)
        t0 = time.perf_counter()
        trainer.train(TRAIN_UPDATES, log_every=1)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rates = trainer.evaluate()
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    out = dict(k2_launches=legal_mask.launches,
               bit_step_launches=step.bit_step.launches,
               reset_launches=step.reset_where.launches)
    require(len(records) == TRAIN_UPDATES, "the trainer skipped an update")
    for m in records:
        for key in ("value_loss", "action_loss", "entropy"):
            require(math.isfinite(m[key]), f"{key} is not finite: {m[key]}")
        require(m["step_launches"] > 0 and m["reset_launches"] > 0,
                "the ply kernel was not launched in collection")
    require(all(0.0 <= r <= 1.0 for r in rates.values()), "bad win rate")
    for kname, count in out.items():
        require(count > 0, f"{kname}: not launched on the training path")
    require(not plain_calls, f"training ran the ply's plain version on the "
            f"card: {plain_calls[:3]}")
    # The ply kernel at the collector's state: every live game steps.
    b = trainer.sp_state.env
    action = tb.random_legal_bit(b.legal, torch.zeros_like(b.legal))
    live = ~b.terminated
    flags = (env_cfg.sudden_death_on_invalid_move, env_cfg.num_disk_as_reward)
    e = _ply_err(torch, tb, step.bit_step(b, action, *flags, do=live),
                 tb.bit_step_plain(b, action, *flags, do=live))
    e = max(e, _ply_err(torch, tb, step.reset_where(b, b.terminated),
                        tb.reset_where_plain(b, b.terminated)))
    require(e == 0, f"the ply kernel on the collector's state differs from "
            f"plain by {e}")
    out["ply_ms"] = timing.device_ms(lambda: step.bit_step(
        b, action, *flags, do=live), 200)
    out["reset_ms"] = timing.device_ms(
        lambda: step.reset_where(b, b.terminated), 200)
    share = [(r["step_launches"] * out["ply_ms"]
              + r["reset_launches"] * out["reset_ms"]) / 1e3
             / r["collect_seconds"] for r in records]
    say(f"[train] ok: {TRAIN_UPDATES} updates in {train_s:.2f} s; eval "
        f"win%(rand)={rates['rand']:.3f} win%(greedy)={rates['greedy']:.3f} "
        f"in {eval_s:.2f} s; on the training path bit_step "
        f"{out['bit_step_launches']}, reset_where {out['reset_launches']}, "
        f"K2 {out['k2_launches']} launches; the ply kernel and reset_where "
        f"exact vs plain on the collector's state, the ply kernel "
        f"{out['ply_ms']:.5f} ms and reset_where {out['reset_ms']:.5f} ms on "
        f"the device at {TRAIN_ENVS} games, ply-kernel device share of "
        f"collection {', '.join(f'{100 * x:.3f}%' for x in share)}")
    return out, trainer


def _checkpoint_phase(torch, trainer, dev):
    """The trained trainer saved (the JAX trainer's msgpack layout) to a
    temporary directory, read back, written again byte for byte, loaded
    into a fresh trainer on the card bit for bit, and loaded params-only
    (step 0, zero moments)."""
    from gymothelloenv_tpu_torch.train.ppo_trainer import PPOSelfPlayTrainer
    from gymothelloenv_tpu_torch.utils import checkpoint as ck
    say("[checkpoint] start: save the trainer, read the file back, load it "
        "into a fresh trainer on the card, then params only")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trainer_{step}.msgpack").format(
            step=trainer.update_count)
        t0 = time.perf_counter()
        trainer.save(path)
        save_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            raw = f.read()
        t0 = time.perf_counter()
        tree = ck.unpackb(raw)
        read_s = time.perf_counter() - t0
        require(ck.packb(tree) == raw, "the writer's bytes of the read-back "
                "payload differ from the file")
        require(tree["step"] == trainer.update_count, "stored step differs")
        fresh = PPOSelfPlayTrainer(trainer.env_cfg, trainer.ppo_cfg,
                                   trainer.run_cfg, device=dev)
        t0 = time.perf_counter()
        fresh.load(path)
        load_s = time.perf_counter() - t0
        opt_a, opt_b = trainer.optimizer, fresh.optimizer
        require(fresh.update_count == trainer.update_count,
                "update_count differs after load")
        for a, b in zip(trainer.net.parameters(), fresh.net.parameters()):
            require(b.device == a.device and torch.equal(a, b),
                    "params differ after load")
            sa, sb = opt_a.adam.state[a], opt_b.adam.state[b]
            for key in ("step", "exp_avg", "exp_avg_sq"):
                require(torch.equal(sa[key], sb[key].to(sa[key].device)),
                        f"Adam {key} differs after load")
        lrs = ([g["lr"] for g in opt_a.adam.param_groups],
               [g["lr"] for g in opt_b.adam.param_groups])
        require(lrs[0] == lrs[1], f"lr differs after load: {lrs}")
        require(opt_a.schedule.last_epoch == opt_b.schedule.last_epoch,
                "schedule position differs after load")
        # [train] ends its schedule at lr 0; under twice the schedule the
        # loaded position gives exactly half the rate.
        longer = PPOSelfPlayTrainer(
            trainer.env_cfg, dataclasses.replace(
                trainer.ppo_cfg,
                num_updates=2 * trainer.ppo_cfg.num_updates),
            trainer.run_cfg, device=dev)
        longer.load(path)
        half = longer.optimizer.adam.param_groups[0]["lr"]
        require(half == trainer.ppo_cfg.lr * 0.5,
                f"lr {half} under twice the schedule, want "
                f"{trainer.ppo_cfg.lr * 0.5}")
        fresh.load_params_only(path)
        zero = fresh.optimizer.to_optax_state(lambda ts: ts)
        require(fresh.update_count == 0
                and int(zero["1"]["0"]["count"]) == 0
                and not any(bool(t.any()) for t in zero["1"]["0"]["mu"]
                            + zero["1"]["0"]["nu"]),
                "load_params_only kept optimizer state")
        require(all(torch.equal(a, b) for a, b in zip(
            trainer.net.parameters(), fresh.net.parameters())),
            "params differ after load_params_only")
    say(f"[checkpoint] ok: {len(raw)} bytes at update "
        f"{trainer.update_count}, saved in {save_s:.3f} s, read in "
        f"{read_s:.3f} s, loaded in {load_s:.3f} s; written again byte for "
        f"byte; params, Adam moments and steps, lr {lrs[1][0]:.6g} and "
        f"update_count bit-equal on the card (lr {half:.6g} under twice the "
        "schedule); params only: step 0, zero moments")


def _maximin_phase(torch, tb, ro, step, dev, gen):
    """maximin_action on K1 snapshots with a random mover (passes and
    ended games among them): depth 1 and 2 on MAXIMIN_N states, depth 3 on
    MAXIMIN_N3, each on card and CPU, chunked and not; maximin-1 against
    greedy; argmax's tie rule on the card; then ms a decision for
    MAXIMIN_TIME_N games at each depth.  Returns the main path's ply-kernel
    launches and the timings."""
    from gymothelloenv_tpu_torch.policies import scripted
    say(f"[maximin] start: depths 1 and 2 on {MAXIMIN_N} reachable states, "
        f"depth 3 on {MAXIMIN_N3}, card vs CPU, chunk {MAXIMIN_CHUNK} vs "
        f"unchunked; then ms a decision for {MAXIMIN_TIME_N} games")
    ties = torch.randint(0, 3, (MAXIMIN_N, 64), generator=gen, device=dev)
    first = torch.from_numpy(ties.cpu().numpy().argmax(1))
    require(torch.equal(torch.argmax(ties, 1).cpu(), first),
            "argmax on the card does not take the first maximum")
    state, _, _, _ = _ply_inputs(torch, tb, ro, MAXIMIN_N, dev, gen)
    cpu = tb.BitState(**{k: v.cpu() for k, v in vars(state).items()})

    def sub(s, n):
        return tb.BitState(**{k: v[:n] for k, v in vars(s).items()})

    cases = ((1, MAXIMIN_N), (2, MAXIMIN_N), (3, MAXIMIN_N3))
    # Main path: the ply kernel's count starts at 0 here.
    step.bit_step.launches = 0
    card = {}
    with _no_plain(tb) as plain_calls:
        for depth, n in cases:
            card[depth] = scripted.maximin_action(sub(state, n), depth)
        chunked = scripted.maximin_action(sub(state, MAXIMIN_N), 2,
                                          MAXIMIN_CHUNK)
        whole = scripted.maximin_action(sub(state, MAXIMIN_N), 2, -1)
        greedy = scripted.greedy_policy(state)
    torch.cuda.synchronize()
    launches = step.bit_step.launches
    require(launches > 0, "the ply kernel was not launched on the maximin "
            "path")
    require(not plain_calls, f"maximin ran the ply's plain version on the "
            f"card: {plain_calls[:3]}")
    require(torch.equal(chunked, card[2]) and torch.equal(whole, card[2]),
            "chunked maximin differs from unchunked")
    require(torch.equal(card[1], greedy), "maximin-1 differs from greedy")
    for depth, n in cases:
        want = scripted.maximin_action(sub(cpu, n), depth)
        require(torch.equal(card[depth].cpu(), want),
                f"maximin-{depth} on the card differs from the CPU")
    # Coverage: ended games, and states with a move after which the reply
    # side has no move (the reference's pass quirk scores that child at
    # once), counted with the plain ply on the CPU.
    node, action = torch.nonzero(tb.unpack_flat(cpu.legal), as_tuple=True)
    child = tb.bit_step_plain(
        tb.BitState(**{k: v[node] for k, v in vars(cpu).items()}),
        action).state
    bounce = (child.turn == cpu.turn[node]) & ~child.terminated
    cover = dict(terminated=int(cpu.terminated.sum()),
                 quirk=len(set(node[bounce].tolist())),
                 ending_move=len(set(node[child.terminated].tolist())))
    require(min(cover.values()) > 0, f"[maximin] the states miss a case: "
            f"{cover}")
    timing = {}
    for depth in (1, 2, 3):
        s = sub(state, MAXIMIN_TIME_N)
        ms, counts = [], []
        for _ in range(MAXIMIN_REPS):
            before = step.bit_step.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scripted.maximin_action(s, depth)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            counts.append(step.bit_step.launches - before)
        timing[f"depth{depth}_ms"] = statistics.median(ms)
        timing[f"depth{depth}_launches"] = counts[-1]
    say(f"[maximin] ok: card = CPU at depths 1-3 ({cover}), chunked = "
        f"unchunked, maximin-1 = greedy, argmax takes the first maximum; "
        f"{launches} ply-kernel launches on the path, no plain ply; "
        f"{MAXIMIN_TIME_N} games a decision: " + ", ".join(
            f"depth {d} {timing[f'depth{d}_ms']:.2f} ms "
            f"({timing[f'depth{d}_launches']} launches)" for d in (1, 2, 3)))
    return dict(launches=launches, timing=timing)


def _device_seconds(torch, fn):
    """Summed device time (s) of the kernels ``fn`` runs, from
    torch.profiler; None where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    from gymothelloenv_tpu_torch.scripts.profile_train_step import device_us
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        events = [e for e in averages if device_us(e) > 0]
    total = sum(device_us(e) for e in events) / 1e6
    return total if total > 0 else None


def _lookahead_phase(torch, tb, ro, step, net, dev, gen):
    """net_lookahead_policy's search on the wide2 seeded net: card against
    CPU at each depth (LOOKAHEAD_NS states, K1 snapshots with a random
    mover), chunked against unchunked, one ply-kernel launch a tree level;
    then ms a decision for LOOKAHEAD_TIME_N games at each depth and the
    device's share of it.  Returns the main path's ply-kernel launches
    and the timings."""
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train import ppo_trainer
    from gymothelloenv_tpu_torch.train.self_play import NEG
    say(f"[lookahead] start: wide2 seeded net, card vs CPU at depth 1 on "
        f"{LOOKAHEAD_NS[1]} reachable states, depth 2 on {LOOKAHEAD_NS[2]} "
        f"and beam-3 (k {LOOKAHEAD_BEAM}) on {LOOKAHEAD_NS[3]}; chunk "
        f"{LOOKAHEAD_CHUNK} vs unchunked; then ms a decision for "
        f"{LOOKAHEAD_TIME_N} games")
    cfg = EnvConfig(num_disk_as_reward=True)
    state, _, _, _ = _ply_inputs(torch, tb, ro, LOOKAHEAD_NS[1], dev, gen)
    cpu_state = tb.BitState(**{k: v.cpu() for k, v in vars(state).items()})
    cpu_net = copy.deepcopy(net).cpu()

    def sub(s, n):
        return tb.BitState(**{k: v[:n] for k, v in vars(s).items()})

    def search(n, s, depth, chunk=0):
        return ppo_trainer.lookahead_search(n, s, cfg, depth,
                                            LOOKAHEAD_BEAM, chunk)

    # Main path: the ply kernel's count starts at 0 here.
    step.bit_step.launches = 0
    card = {}
    with _no_plain(tb) as plain_calls:
        for depth, n in LOOKAHEAD_NS.items():
            card[depth] = search(net, sub(state, n), depth)
        chunked = search(net, sub(state, LOOKAHEAD_NS[2]), 2,
                         LOOKAHEAD_CHUNK)
    torch.cuda.synchronize()
    launches = step.bit_step.launches
    require(launches > 0, "the ply kernel was not launched on the "
            "lookahead path")
    require(not plain_calls, f"the lookahead ran the ply's plain version "
            f"on the card: {plain_calls[:3]}")

    def compare(got, want, what):
        """(decisions held, exact decisions, largest value error)."""
        a, scores, _ = (t.cpu() for t in got)
        a_w, scores_w, margin = want
        clear = margin > LOOKAHEAD_MARGIN
        require(torch.equal(a[clear], a_w[clear]),
                f"{what}: {int((a[clear] != a_w[clear]).sum())} decisions "
                f"differ where the margin exceeds {LOOKAHEAD_MARGIN}")
        rows = clear[:, None] & (scores_w > NEG)
        require(torch.equal(scores[clear] > NEG, scores_w[clear] > NEG),
                f"{what}: other actions searched")
        err = float((scores - scores_w)[rows].abs().max()) if bool(
            rows.any()) else 0.0
        require(err <= LOOKAHEAD_ATOL, f"{what}: values differ by "
                f"{err:.2e} > {LOOKAHEAD_ATOL}")
        return int(clear.sum()), int((a == a_w).sum()), err

    report = {}
    for depth, n in LOOKAHEAD_NS.items():
        want = search(cpu_net, sub(cpu_state, n), depth)
        held, exact, err = compare(card[depth], want, f"depth {depth}")
        require(held >= 0.9 * n, f"depth {depth}: only {held} of {n} "
                f"decisions clear the margin")
        report[depth] = (n, held, exact, err)
    held, exact, err = compare(chunked, tuple(t.cpu() for t in card[2]),
                               f"chunk {LOOKAHEAD_CHUNK}")
    report["chunk"] = (LOOKAHEAD_NS[2], held, exact, err)
    timing = {}
    s = sub(state, LOOKAHEAD_TIME_N)
    for depth in LOOKAHEAD_NS:
        act = ppo_trainer.net_lookahead_policy(net, cfg, depth,
                                               LOOKAHEAD_BEAM)
        ms, counts = [], []
        for _ in range(LOOKAHEAD_REPS):
            before = step.bit_step.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            act(s)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            counts.append(step.bit_step.launches - before)
        require(set(counts) == {depth}, f"depth {depth}: {counts} ply-"
                "kernel launches a decision, expected one a level")
        device_s = _device_seconds(torch, lambda: act(s))
        timing[f"depth{depth}_ms"] = statistics.median(ms)
        timing[f"depth{depth}_launches"] = counts[-1]
        timing[f"depth{depth}_device_ms"] = (None if device_s is None
                                             else 1e3 * device_s)
        timing[f"depth{depth}_host_share"] = (
            None if device_s is None
            else 1.0 - 1e3 * device_s / timing[f"depth{depth}_ms"])
    say("[lookahead] card vs CPU (states, held by the margin, exactly equal, "
        "largest value error): " + "; ".join(
            f"{k if k == 'chunk' else f'depth {k}'} {v[0]}/{v[1]}/{v[2]}/"
            f"{v[3]:.2e}" for k, v in report.items()))
    say(f"[lookahead] ok: {launches} ply-kernel launches on the path, no "
        f"plain ply; {LOOKAHEAD_TIME_N} games a decision: " + ", ".join(
            f"depth {d} {timing[f'depth{d}_ms']:.2f} ms "
            f"({timing[f'depth{d}_launches']} launches, device "
            + ("not measured" if timing[f"depth{d}_device_ms"] is None else
               f"{timing[f'depth{d}_device_ms']:.3f} ms, host share "
               f"{100 * timing[f'depth{d}_host_share']:.1f}%") + ")"
            for d in LOOKAHEAD_NS))
    return dict(launches=launches, timing=timing, report=report)


def _lookahead_train_phase(torch, tb, legal_mask, step, dev):
    """PPOSelfPlayTrainer at wide2 on the lookahead-mix recipe: LA_UPDATES
    updates (updates 1-3 plain, 4 with the override), then one distill
    update at LA_DISTILL_TAU with every collection overridden; the counts
    of K2 and the ply kernel from 0.  Then the collector's lookahead
    values on its own state, card against CPU."""
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import (PPOSelfPlayTrainer,
                                                           SelfPlayConfig)
    from gymothelloenv_tpu_torch.train.self_play import (
        collect_rollout, lookahead_action_values, selfplay_init)
    say(f"[lookahead_train] start: PPOSelfPlayTrainer wide2, N={LA_ENVS}, "
        f"T={LA_STEPS}, init_rand_steps {LA_RAND}, lookahead_collect tau "
        f"{LA_TAU} mix {LA_MIX}, ppo_epochs {LA_EPOCHS}, lr {LA_LR} without "
        f"decay, {LA_UPDATES} updates; then 1 distill update at tau "
        f"{LA_DISTILL_TAU}")
    env_cfg = EnvConfig(num_disk_as_reward=True)
    ppo_cfg = PPOConfig(lr=LA_LR, ppo_epochs=LA_EPOCHS,
                        use_linear_lr_decay=False)
    run_cfg = SelfPlayConfig(num_envs=LA_ENVS, num_steps=LA_STEPS,
                             hidden_size=HIDDEN, width_mult=WIDTH_MULT,
                             init_rand_steps=LA_RAND, lookahead_collect=True,
                             lookahead_tau=LA_TAU, lookahead_mix=LA_MIX,
                             test_interval=10 ** 9, seed=SEED)
    records = []

    def log_fn(update, metrics):
        records.append(metrics)
        say(f"[lookahead_train] update {update}: "
            f"{'lookahead' if metrics['lookahead'] else 'plain'} "
            f"collection {metrics['collect_seconds']:.3f} s, update "
            f"{metrics['update_seconds']:.3f} s, value_loss="
            f"{metrics['value_loss']:.5g} action_loss="
            f"{metrics['action_loss']:.5g}, episodes "
            f"{int(metrics['episodes'])}, collector host syncs "
            f"{metrics['collect_syncs']}")

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    # Main path: the counts of K2 and the ply kernel start at 0 here.
    legal_mask.launches = 0
    step.bit_step.launches = 0
    step.reset_where.launches = 0
    with _no_plain(tb) as plain_calls:
        trainer = PPOSelfPlayTrainer(env_cfg, ppo_cfg, run_cfg,
                                     log_fn=log_fn, device=dev)
        _fp32_check(torch, trainer.net, dev)
        trainer.train(LA_UPDATES, log_every=1)
        distill = PPOSelfPlayTrainer(
            env_cfg, dataclasses.replace(ppo_cfg, distill=True),
            dataclasses.replace(run_cfg, lookahead_tau=LA_DISTILL_TAU,
                                lookahead_mix=1.0),
            log_fn=log_fn, device=dev)
        distill.train(1, log_every=1)
        torch.cuda.synchronize()
    out = dict(k2_launches=legal_mask.launches,
               bit_step_launches=step.bit_step.launches,
               reset_launches=step.reset_where.launches)
    require(len(records) == LA_UPDATES + 1, "the trainer skipped an update")
    modes = [m["lookahead"] for m in records]
    require(modes == [0.0, 0.0, 0.0, 1.0, 1.0],
            f"collection modes {modes}, expected plain x3 then lookahead")
    for m in records:
        for key in ("value_loss", "action_loss", "entropy"):
            require(math.isfinite(m[key]), f"{key} is not finite: {m[key]}")
    for kname, count in out.items():
        require(count > 0, f"{kname}: not launched on the lookahead "
                "training path")
    require(not plain_calls, f"lookahead training ran the ply's plain "
            f"version on the card: {plain_calls[:3]}")
    # The random openings' share of a plain collection: the trained net,
    # fresh games, with and without them.
    openings = {}
    for rand in (0, LA_RAND):
        sp_state = selfplay_init(trainer.net, env_cfg, LA_ENVS,
                                 trainer.draws, rand)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collect_rollout(trainer.net, sp_state, env_cfg, LA_STEPS,
                        trainer.draws, rand)
        torch.cuda.synchronize()
        openings[rand] = time.perf_counter() - t0
    env = trainer.sp_state.env
    cpu_env = tb.BitState(**{k: v.cpu() for k, v in vars(env).items()})
    got = lookahead_action_values(trainer.net, env, env_cfg).cpu()
    want = lookahead_action_values(copy.deepcopy(trainer.net).cpu(),
                                   cpu_env, env_cfg)
    legal = tb.unpack_flat(cpu_env.legal)
    err = float((got - want)[legal].abs().max())
    require(err <= LOOKAHEAD_ATOL, f"collector lookahead values card vs "
            f"CPU differ by {err:.2e} > {LOOKAHEAD_ATOL}")
    require(torch.equal(got[~legal], want[~legal]), "illegal actions' "
            "values differ")
    out["seconds"] = {
        "plain_collect": [m["collect_seconds"] for m in records[:3]],
        "lookahead_collect": records[3]["collect_seconds"],
        "distill_collect": records[4]["collect_seconds"],
        "update": [m["update_seconds"] for m in records],
        "plain_collect_without_openings": openings[0],
        "plain_collect_with_openings": openings[LA_RAND]}
    say(f"[lookahead_train] ok: collect plain "
        + ", ".join(f"{x:.3f}" for x in out["seconds"]["plain_collect"])
        + f" s, with the override {records[3]['collect_seconds']:.3f} s "
        f"(tau {LA_TAU}) and {records[4]['collect_seconds']:.3f} s (tau "
        f"{LA_DISTILL_TAU}, distill); fresh games, plain: "
        f"{openings[0]:.3f} s without random openings, "
        f"{openings[LA_RAND]:.3f} s with {LA_RAND}; "
        f"bit_step {out['bit_step_launches']}, "
        f"reset_where {out['reset_launches']}, K2 {out['k2_launches']} "
        f"launches, no plain ply, TF32 off; collector lookahead values on "
        f"its own {LA_ENVS} games: card = CPU to {err:.2e}")
    return out


def _eval_checkpoint_phase(torch, tb, legal_mask, step, net, dev):
    """cli.eval_checkpoint on a wide2 checkpoint written from ``net`` (the
    seeded net of [eval]) against maximin-2 and against itself, then armed
    with the search (EVALCK_ARMED), then cli.tournament greedy vs
    maximin-2, with the counts of K2 and the ply kernel from 0."""
    from gymothelloenv_tpu_torch.cli import eval_checkpoint, tournament
    from gymothelloenv_tpu_torch.models.convert import flax_tree
    from gymothelloenv_tpu_torch.utils.checkpoint import save_checkpoint
    say(f"[eval_checkpoint] start: eval_checkpoint on a wide2 checkpoint of "
        f"the seeded net vs maximin-2 and vs itself, then "
        + ", ".join(f"{' '.join(f)} vs {o}" for o, f in EVALCK_ARMED)
        + f", {EVALCK_GAMES} games each; tournament greedy vs maximin-2, "
        f"{TOURNAMENT_GAMES} games")
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wide2.msgpack")
        save_checkpoint(path, 0, flax_tree(net))
        # Main path: the counts of K2 and the ply kernel start at 0 here.
        legal_mask.launches = 0
        step.bit_step.launches = 0
        runs = [("maximin-2", ()), ("self", ())] + list(EVALCK_ARMED)
        launches = {}
        with _no_plain(tb) as plain_calls:
            for opp, flags in runs:
                spec = f"ckpt:{path}" if opp == "self" else opp
                label = " ".join((opp,) + flags)
                before = (legal_mask.launches, step.bit_step.launches)
                t0 = time.perf_counter()
                w, d, l = eval_checkpoint.main([
                    "--load", path, "--opponent", spec, *flags, "--games",
                    str(EVALCK_GAMES), "--seed", str(SEED), "--device",
                    DEVICE_TYPE])
                seconds[label] = time.perf_counter() - t0
                launches[label] = (legal_mask.launches - before[0],
                                   step.bit_step.launches - before[1])
                require(w + d + l == EVALCK_GAMES,
                        f"eval_checkpoint vs {label} lost games")
            t0 = time.perf_counter()
            results = tournament.main([
                "--black", "greedy", "--white", "maximin-2", "--games",
                str(TOURNAMENT_GAMES), "--seed", str(SEED), "--device",
                DEVICE_TYPE])
            seconds["tournament"] = time.perf_counter() - t0
        torch.cuda.synchronize()
    require(sum(results[("greedy", "maximin-2")]) == TOURNAMENT_GAMES,
            "the tournament lost games")
    out = dict(k2_launches=legal_mask.launches,
               bit_step_launches=step.bit_step.launches)
    for kname, count in out.items():
        require(count > 0, f"{kname}: not launched on the eval_checkpoint "
                "path")
    require(not plain_calls, f"eval_checkpoint ran the ply's plain version "
            f"on the card: {plain_calls[:3]}")
    say(f"[eval_checkpoint] ok: every game accounted for; wall seconds "
        "(K2, ply-kernel launches): "
        + ", ".join(f"{k} {v:.2f} {launches.get(k, '')}"
                    for k, v in seconds.items())
        + f"; K2 {out['k2_launches']}, ply kernel "
        f"{out['bit_step_launches']} launches")
    out["seconds"], out["by_run"] = seconds, launches
    return out


def _fp32_check(torch, net, dev):
    """F1's gate: the trainer left both TF32 flags off, and its net's
    forward on FP32_BATCH positions (FP32_PLIES random plies from the
    opening, made on the CPU) agrees with a CPU copy to FP32_ATOL."""
    from gymothelloenv_tpu_torch.core import bitboard as tb
    from gymothelloenv_tpu_torch.core.featurize import make_state
    from gymothelloenv_tpu_torch.ops import rollout as ro
    from gymothelloenv_tpu_torch.utils.device import FLOAT32
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    require(flags == (False, False),
            f"PPOSelfPlayTrainer left TF32 on (matmul, cuDNN) = {flags}")
    s, _ = ro.rollout_chunk(ro.rollout_init(FP32_BATCH, "cpu"), SEED,
                            FP32_PLIES)
    n = FP32_BATCH
    x = make_state(tb.BitState(
        black=s.cur, white=s.opp, legal=s.legal,
        turn=torch.full((n,), -1, dtype=torch.int8),
        terminated=torch.zeros(n, dtype=torch.bool),
        winner=torch.zeros(n, dtype=torch.int8)))
    cpu_net = copy.deepcopy(net).cpu()
    with torch.inference_mode():
        logits, value = net(x.to(dev))
        logits_c, value_c = cpu_net(x)
    err = max(float((logits.cpu() - logits_c).abs().max()),
              float((value.cpu() - value_c).abs().max()))
    require(bool(torch.isfinite(logits).all()), "trainer net not finite")
    require(err <= FP32_ATOL, f"trainer net on card vs CPU: {err:.2e} > "
            f"{FP32_ATOL}")
    say(f"[train] fp32: constructing PPOSelfPlayTrainer turned TF32 off for "
        f"matmul and cuDNN (both were on; {FLOAT32}); its net on "
        f"{FP32_BATCH} positions agrees with a CPU copy to {err:.2e} (atol "
        f"{FP32_ATOL})")


def _train_reference_phase(torch, dev):
    """ppo_update on the card and on the CPU from the same params, the
    same rollout (collected on the card) and the same shuffle words: once
    as a single optimizer step, once with the trainer's epochs and
    minibatches.  The latter is also run on the card with a planted fault
    (PLANTS) to show that its tolerance sees such a fault."""
    from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, Transition,
                                                    make_optimizer,
                                                    ppo_update)
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.ops.shuffle import draw_words
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    from gymothelloenv_tpu_torch.train.self_play import (Draws,
                                                         collect_rollout,
                                                         selfplay_init)
    say(f"[train_reference] start: ppo_update card vs CPU, wide2, "
        f"N={REF_ENVS}, T={REF_STEPS}: one step, then 4 epochs x 4 "
        "minibatches, then the latter with each planted fault on the card")
    env_cfg = EnvConfig(num_disk_as_reward=True)
    net = make_network(env_cfg, HIDDEN, WIDTH_MULT, SEED + 1, dev).train()
    draws = Draws(torch.Generator(dev).manual_seed(SEED + 1))
    sp = selfplay_init(net, env_cfg, REF_ENVS, draws)
    _, rollout, boot = collect_rollout(net, sp, env_cfg, REF_STEPS, draws)
    inputs = {dev: (rollout, boot),
              "cpu": (Transition(**{k: v.cpu() for k, v in
                                    vars(rollout).items()}), boot.cpu())}
    start = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}

    def update(device, cfg, word_seed=SEED + 1):
        """(param deltas on the CPU, metrics) of one ppo_update."""
        words = draw_words(torch.Generator().manual_seed(word_seed),
                           cfg.ppo_epochs)
        n = make_network(env_cfg, HIDDEN, WIDTH_MULT, SEED + 1,
                         device).train()
        n.load_state_dict(start)
        m = ppo_update(n, make_optimizer(cfg, n.parameters()),
                       *inputs[device], words, cfg)
        return ({k: v.cpu() - start[k] for k, v in n.state_dict().items()},
                {k: float(v) for k, v in m.items()})

    def leaf_rel(d_card, d_cpu):
        """Per leaf: the largest delta difference over the leaf's own
        largest CPU delta."""
        out = {}
        for k in start:
            big = float(d_cpu[k].abs().max())
            require(big > 0, f"the reference update did not move {k}")
            out[k] = float((d_card[k] - d_cpu[k]).abs().max()) / big
        return out

    def check_metrics(m_card, m_cpu):
        for k in m_cpu:
            require(abs(m_card[k] - m_cpu[k])
                    <= REF_METRIC_RTOL * abs(m_cpu[k]) + REF_METRIC_ATOL,
                    f"card vs CPU {k}: {m_card[k]:.8g} vs {m_cpu[k]:.8g}")
        return max(abs(m_card[k] - m_cpu[k]) for k in m_cpu)

    one = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY, num_updates=1,
                    ppo_epochs=1, num_mini_batch=1)
    (d_card, m_card), (d_cpu, m_cpu) = update(dev, one), update("cpu", one)
    merr1 = check_metrics(m_card, m_cpu)
    err1 = max(float((d_card[k] - d_cpu[k]).abs().max()) for k in start)
    big1 = max(float(d.abs().max()) for d in d_cpu.values())
    require(big1 > 1e-4, "the reference update did not move the params")
    require(err1 <= REF_ONE_STEP_ATOL,
            f"one step: card vs CPU param deltas differ by {err1:.3e} > "
            f"{REF_ONE_STEP_ATOL}")

    cfg = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY,
                    num_updates=TRAIN_UPDATES)
    (d_card, m_card), (d_cpu, m_cpu) = update(dev, cfg), update("cpu", cfg)
    merr = check_metrics(m_card, m_cpu)
    rel = leaf_rel(d_card, d_cpu)
    worst = max(rel, key=rel.get)
    planted = {}
    for name, change, word_seed in PLANTS:
        d_bad, _ = update(dev, dataclasses.replace(cfg, **change), word_seed)
        planted[name] = max(leaf_rel(d_bad, d_cpu).values())
    say(f"[train_reference] 4 x 4 minibatches, per-leaf |card - CPU| over "
        f"the leaf's largest delta: "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    say("[train_reference] planted faults on the card, the same reading: "
        + ", ".join(f"{k} {v:.3e}" for k, v in planted.items()))
    require(rel[worst] <= REF_PARAM_RTOL,
            f"card vs CPU deltas of {worst} differ by {rel[worst]:.3e} of "
            f"its largest delta > {REF_PARAM_RTOL}")
    for name, reading in planted.items():
        require(reading > REF_PARAM_RTOL,
                f"the planted fault '{name}' reads {reading:.3e}, inside "
                f"the tolerance {REF_PARAM_RTOL}: the check cannot see it")
    say(f"[train_reference] ok: one step: deltas (max {big1:.3e}) agree to "
        f"{err1:.3e} (atol {REF_ONE_STEP_ATOL}), metrics to {merr1:.3e}; "
        f"4 x 4 minibatches: deltas agree to {rel[worst]:.3e} of the "
        f"largest delta of each leaf (worst {worst}; rtol "
        f"{REF_PARAM_RTOL}), every planted fault above it (least "
        f"{min(planted.values()):.3e}), metrics to {merr:.3e} (rtol "
        f"{REF_METRIC_RTOL} + atol {REF_METRIC_ATOL}); fp32, TF32 off")


def _index_policies(torch, tb):
    """Deterministic per-game policies: the k-th legal move with
    k = (disks * a + b) mod count, a and b fixed per game."""
    a = torch.arange(256) % 13 + 1
    b = torch.arange(256) * 7 % 64

    def make(device, side):
        pa, pb = (a + 3 * side).to(device), (b + 5 * side).to(device)

        def act(state, generator=None):
            disks = tb.popcount(state.black | state.white)
            k = (disks * pa + pb) % tb.popcount(state.legal).clamp(min=1)
            return tb.random_legal_bit(state.legal, k)
        return act
    return make


if __name__ == "__main__":
    sys.exit(main())
