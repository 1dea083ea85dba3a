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
    bitboard engine (the ply kernel, csrc/step.cu, on every ply; no K2:
    bit_reset is the constant opening);
  * the rollout-variant profiler (kernel K3: K1 with one component stubbed
    out, or at another unroll / block size), every configuration of
    gymothelloenv_tpu_torch/scripts/bench_rollout_variants.py at the bench
    protocol;
  * PPO self-play training: PPOSelfPlayTrainer at wide2 with the tuned
    recipe (N 1024, T 64, lr 2.5e-4, entropy 0.01) for 3 updates and one
    200-game evaluation (the ply kernel on every ply and every reset of
    collection and evaluation; no K2);
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
    cli/tournament.py greedy against maximin-2 ([eval_checkpoint]);
  * recurrent (GRU) PPO on RESULTS.md's rec_wide2 recipe (width 2, hidden
    512, N 1024, T 32) for 3 updates, the ply kernel on every ply of the
    recurrent collector; then ppo_update_recurrent card vs CPU, one step
    and 4 x 4 minibatches per leaf, with three faults planted on the card
    (the mask reset dropped, h0 zeroed, a b_hr added) that must read above
    the tolerance ([recurrent_train]);
  * frame-stacked PPO (--frame-stack 4, wide2, N 1024, T 32, 2 updates)
    and its frame window after each slot against
    envs/vec_wrappers.frame_stack_step ([framestack_train]);
  * time-limited PPO (--max-episode-plies 16, wide2, N 1024, T 64, 2
    updates) with truncations, and compute_gae_time_limits card = CPU bit
    for bit ([time_limit_train]);
  * the wide2 net in bfloat16, card vs CPU with its trunk's activations
    bfloat16, and 2 --bf16 updates ([bf16]);
  * cli/eval_checkpoint.py on a rec_wide2 and a frame-stack-4 checkpoint
    written from seeded nets (raw vs greedy, --lookahead vs maximin-2,
    against itself armed at depth 1, the frame-stacked one vs greedy),
    and the recurrent lookahead card vs CPU, one B1 launch a decision
    ([recurrent_eval]);
  * the plane engine at other board sizes: 4096 games of random play to
    the end at B = 6 and 10 on the card, every state field equal to the
    CPU's at every ply, eager kernels and ms a plane ply at B = 6, 8
    (forced) and 10; and on 8x8 the force_plane collector (wide2, N 1024,
    T 16) equal to the BitEngine collector transition for transition,
    one B1 launch a plane ply ([plane]);
  * perft on the card, K2's launch for both sides' masks and B1's for the
    children of every level: depths 1-9 from the opening (4 ... 55092 at
    1-7, the C++ oracle native/othello_perft.cpp, built with g++, at 8
    and 9) and perft_from at depths 2-4 on midgame positions ([perft]);
  * cli/ppo_self_play.py --board-size 6 at wide2 (N 1024, T 64, 3
    updates), then its ppo_update card vs CPU ([plane_train]);
  * cli/tournament.py --board-size 10 (greedy vs random, maximin-1 vs
    greedy) and --board-size 6 (maximin-2 vs greedy), cli/eval_checkpoint
    .py --board-size 6 on a seeded board-6 wide2 checkpoint vs maximin-1,
    200 games each, and plane maximin card = CPU on 512 states
    ([plane_eval]);
  * the value-lookahead search on planes at B = 6 and 10 (depth 1, 2,
    beam-3 and the recurrent depth 1 card = CPU on a seeded wide2 net, ms
    a decision for 200 games), the 8x8 plane search = the bitboard one,
    one B1 launch a level, and 4 updates of cli/ppo_self_play.py
    --board-size 6 --lookahead-collect --lookahead-mix 0.25 at wide2, N
    512, T 32 ([plane_lookahead]);
  * cli/teacher_vs_student.py at JAX job 52's width (wide2, N 1024, T 32,
    the teacher warm-started from data/selfplay/ppo_wide2_4k.msgpack) for
    3 chunks, one B1 launch a ply, a save/load round trip, and the
    student's weighted update card vs CPU ([teacher_student]);
  * cli/dqn_train.py at JAX job 60's configuration (N 1024, 512 plies,
    batch 4096, PER, double, dueling, n-step 3, a 1M replay) for 2
    chunks, a checkpoint round trip, the PER sampler on the 1M ring and
    one update card vs CPU, and one chunk against the greedy opponent
    with the kernels of a ply ([dqn]);
  * cli/rainbow_train.py at JAX job 58's configuration (N 1024, 512
    plies, batch 4096, train interval 512, a 1M PER replay) for 2 chunks,
    the committed rainbow_pool_600 net card vs CPU, one C51 update card vs
    CPU with two faults planted on the card, and one chunk's collection in
    the opponent-pool mode ([rainbow]);
  * cli/a2c_train.py at RESULTS.md's A2C configuration (N 1024, T 16,
    GAE) for 5 updates, then one update card vs CPU ([a2c]);
  * cli/acktr_train.py at JAX job 08b's configuration (--net conv, N 1024,
    T 16, entropy 0.05, kl-clip 0.001) for 12 updates through an
    eigendecomposition refresh, one update card vs CPU on a refresh step,
    and 3 updates of --net mlp ([acktr]);
  * cli/run_self_play.py (simple PPO) at its defaults (N 64, T 32) for 4
    updates and its final evaluations, then one simple_ppo_update card vs
    CPU ([simple_ppo]);
  * the port's expert script (64 maximin-2 games on the card) and
    cli/gail_train.py on its file (N 256, T 64, 20 BC steps, 2 updates),
    then one discriminator step and one full GAIL update card vs CPU
    ([gail]);
  * the compat layer: 4 seeded cli/run.py games through OthelloEnv,
    card = CPU transcript, one B1 launch an env ply; the ms of a
    SimpleOthelloEnv ply; a .pth of the vendored Policy written by
    torch.save, imported and played by cli/eval_checkpoint.py against
    greedy ([compat]);
  * the remaining CLIs and utilities: cli/replay.py of the committed
    wide2 net (deterministic) against maximin-2, card = CPU page and one
    B1 launch a ply; one cli/enjoy.py episode against greedy with
    --live-html, card = CPU transcript; cli/sweep.py; a
    utils/profiling.trace of one wide2 PPO update (N 1024, T 64) whose
    summarize_trace names B1 and the update's kernels; cli/visualize.py
    load_run on its metrics ([cli]);
  * data-parallel training (parallel/): wide2 PPO (N 1024, T 64, 2
    updates) at world 1 under nccl against the single-process trainer
    (itself run twice by default and twice with cuDNN deterministic, to
    read the card's run-to-run drift), then on two gloo ranks sharing the
    card against that; one update of the small plain, time-limited and
    recurrent PPO, A2C, ACKTR, GAIL and teacher-student world 1 vs 2
    (parallel/dryrun.py); two planted faults that the gate must fail;
    rollout_chunk_sharded at N 4096 over the two ranks against the plain
    rollout on each slice ([dp]; the ranks are child processes, and one
    that fails fails the phase).
  * the measurement and evaluation tools (gymothelloenv_tpu_torch/
    scripts/), each through its main at a cut size, full widths: the
    traces of the PPO update, the train step, the collection and a DQN
    and a Rainbow chunk (the update names no B1, the others one B1 launch
    a traced ply, the trace's count equal to the wrapper's), the update,
    recurrent and train-step profiles, the replay benches (their insert
    and sample counts exact), the batch-scaling bench, bench_scaling at
    world 1 and on two gloo ranks sharing the card under torchrun,
    eval_snapshots = cli/eval_checkpoint at each snapshot's seed,
    tournament_big's tallies = cli/tournament's at chunk = games, and
    tournament_ci on its lines; every timing finite and positive
    ([tools]).

It reads two files outside gymothelloenv_tpu_torch/, the committed
data/selfplay/ppo_wide2_4k.msgpack (the teacher's warm start, and the
net of [cli]) and
data/selfplay/rainbow_pool_600.msgpack; its other nets are seeded inits
and the checkpoints it reads are the ones it wrote, in a temporary
directory (the expert file and the .pth of [gail] and [compat] too).
It exits non-zero on any failure, without a
CUDA card, or when run outside a checkout of the repository.

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
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

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
# [recurrent_train]: RESULTS.md's rec_wide2 recipe
# (data/logs/queue/11_recurrent_wide2.log:1: --recurrent --width-mult 2
# --num-envs 1024 --num-steps 32 --lr 2.5e-4 --entropy-coef 0.01, hidden
# 512), 3 updates (cut from 3000).
REC_WIDTH, REC_HIDDEN = 2, 512
REC_ENVS, REC_STEPS, REC_UPDATES = 1024, 32, 3
# Card-vs-CPU ppo_update_recurrent, cut from N 1024: the second rollout of
# fresh games, so h0 is not zero and games end inside it.
REC_REF_ENVS, REC_REF_STEPS = 64, 32
# Faults planted on the card's update that the per-leaf check must see:
# the mask reset dropped (masks all ones), h0 replaced by zeros, and a
# b_hr bias (0.1) added to the GRU's reset gate.
REC_PLANTS = ("mask reset dropped", "h0 zeros", "b_hr added")
# [framestack_train]: --frame-stack 4 at wide2, N 1024, T 32, 2 updates.
FS_STACK, FS_ENVS, FS_STEPS, FS_UPDATES = 4, 1024, 32, 2
# [time_limit_train]: --max-episode-plies 16 at wide2, N 1024, T 64.
TL_PLIES, TL_ENVS, TL_STEPS, TL_UPDATES = 16, 1024, 64, 2
# [bf16]: the wide2 net in bfloat16 on BF16_STATES reachable states, card
# against CPU.  Both round every layer's output to bfloat16 (8 bits of
# mantissa, a relative step of 2^-8) but sum in other orders, so a layer
# may round one step apart and the steps carry through the next layers:
# the outputs are held to BF16_RTOL of their largest magnitude (eight
# bf16 steps).  Then 2 PPO updates with --bf16 at N 1024, T 64.
BF16_STATES, BF16_RTOL = 4096, 2.0 ** -5
BF16_ENVS, BF16_STEPS, BF16_UPDATES = 1024, 64, 2
# [recurrent_eval]: eval_checkpoint on a rec_wide2 and a frame-stack-4
# checkpoint the script writes, 200 games a run; the recurrent lookahead
# card vs CPU on REC_LA_N reachable states with random hidden states.
REC_EVAL_GAMES = 200
REC_LA_N = 4096
# [plane]: PLANE_N games of random play to the end at each of PLANE_SIZES
# on the card and the CPU; kernels and ms a plane ply at N PLANE_N after
# PLANE_WARM random plies, timed over PLANE_TIME_REPS plies; the
# force_plane collector against the bit one (wide2, N 1024, 3 rollouts of
# T 16: games end and reset from the third).
PLANE_N, PLANE_SIZES, PLANE_WARM, PLANE_TIME_REPS = 4096, (6, 10), 10, 20
PLANE_FP_ENVS, PLANE_FP_STEPS, PLANE_FP_ROLLOUTS = 1024, 16, 3
# [perft]: depths 1-PERFT_DEPTH from the opening (the published counts to
# depth 7, the C++ oracle beyond), and perft_from at PERFT_FROM_DEPTHS on
# PERFT_MIDGAME positions of 20-44 random plies.
PERFT_DEPTH = 9
PERFT_KNOWN = {1: 4, 2: 12, 3: 56, 4: 244, 5: 1396, 6: 8200, 7: 55092}
PERFT_FROM_DEPTHS, PERFT_MIDGAME = (2, 3, 4), 8
# [plane_train]: ppo_self_play --board-size 6 at wide2, the tuned recipe's
# N and T, 3 updates (cut from a run's length); the card-vs-CPU update at
# REF_ENVS, REF_STEPS on the same board.
PLANE_TRAIN_BOARD = 6
# [plane_eval]: 200 games a run; plane maximin card vs CPU on
# PLANE_MAXIMIN_N states per (board, depth).
PLANE_EVAL_GAMES = 200
PLANE_MAXIMIN_N = 512
PLANE_MAXIMIN = ((6, 2), (10, 1))
# [plane_lookahead]: the search on planes at PLA_SIZES, PLA_GAMES games
# (decisions timed on all, card vs CPU on PLA_CMP[depth] of them), beam k
# PLA_BEAM; then ppo_self_play --board-size 6 --lookahead-collect
# --lookahead-mix LA_MIX at wide2, N PLA_ENVS, T PLA_STEPS, PLA_UPDATES
# updates (the mix's Bresenham step picks the 4th).
PLA_SIZES, PLA_GAMES, PLA_BEAM, PLA_REPS = (6, 10), 200, 8, 3
PLA_CMP = {1: 200, 2: 64, 3: 32}
PLA_ENVS, PLA_STEPS, PLA_UPDATES = 512, 32, 4
# [teacher_student]: JAX job 52's first recipe
# (data/queue/done/52_ts_strength.job) at its width, N and T, 3 chunks of
# its 1500; the student's update card vs CPU at N TS_REF_ENVS, T
# TS_REF_STEPS.
TS_TEACHER = "data/selfplay/ppo_wide2_4k.msgpack"
TS_ENVS, TS_STEPS, TS_CHUNKS = 1024, 32, 3
TS_REF_ENVS, TS_REF_STEPS = 64, 8
# [dqn]: JAX job 60 (data/queue/done/60_dqn_after.job), 2 chunks of its
# 60; one update card vs CPU: the loss and the refreshed priorities to
# DQN_REF_RTOL (fp32 sums over a 4096-row batch in other orders), the
# RMSprop step per leaf to DQN_STEP_RTOL of the leaf's largest.  With eps
# 0.01 inside the root the step is lr * g / sqrt(nu + eps), near linear in
# g, so it carries the gradients' relative error; the faults planted on
# the card's update (DQN_PLANTS) must read above that limit.
DQN_ENVS, DQN_PLIES, DQN_BATCH, DQN_INTERVAL = 1024, 512, 4096, 512
DQN_REPLAY, DQN_CHUNKS, DQN_REF_RTOL = 1_000_000, 2, 1e-4
DQN_STEP_RTOL = 1e-3
DQN_PLANTS = ("eps outside the root", "momentum 0.9", "gamma^1")
# [rainbow]: JAX job 58's training run (data/queue/done/58_rainbow_after.job:
# N 1024, 512 plies a chunk, batch 4096, train interval 512, no warm-up, a
# 1M PER replay, seed 4), RAINBOW_CHUNKS chunks of its 60.  The committed
# RAINBOW_CKPT's atom logits card vs CPU, noise off and on, to
# RAINBOW_FWD_RTOL of the largest; one update card vs CPU (the CPU
# replaying the card's rows, noise, ReLU masks and argmax), Adam's step per
# leaf to RAINBOW_STEP_RTOL of the leaf's largest, with RAINBOW_PLANTS on
# the card reading above it; a chunk's collection in job 07's pool mode
# (--opponent-pool 8).
RAINBOW_ENVS, RAINBOW_PLIES, RAINBOW_BATCH = 1024, 512, 4096
RAINBOW_INTERVAL, RAINBOW_CHUNKS = 512, 2
RAINBOW_FWD_RTOL, RAINBOW_STEP_RTOL = 1e-5, 1e-3
RAINBOW_CKPT = "data/selfplay/rainbow_pool_600.msgpack"
RAINBOW_PLANTS = ("per-sample noise", "projection without the clip")
# [a2c]: RESULTS.md's A2C run (N 1024, T 16, lr 7e-4, entropy 0.01, GAE),
# A2C_UPDATES updates; one update card vs CPU on a fresh rollout, the
# RMSprop step per leaf to A2C_STEP_RTOL of the leaf's largest.
A2C_ENVS, A2C_STEPS, A2C_UPDATES, A2C_STEP_RTOL = 1024, 16, 5, 1e-3
# [acktr]: JAX job 08b (data/queue/done/08b_acktr_confirm.job: --net conv,
# N 1024, T 16, entropy 0.05, kl-clip 0.001), ACKTR_UPDATES updates (t_inv
# 10: the eigendecompositions refresh at updates 0 and 10); one update
# card vs CPU on a refresh step, the K-FAC step per leaf to
# ACKTR_STEP_RTOL of the leaf's largest; then ACKTR_MLP_UPDATES of --net
# mlp.
ACKTR_ENVS, ACKTR_STEPS, ACKTR_UPDATES, ACKTR_MLP_UPDATES = 1024, 16, 12, 3
ACKTR_STEP_RTOL = 1e-3
# [simple_ppo]: cli/run_self_play.py at its defaults (N 64, T 32, batch 256,
# 5 epochs, lr 1e-3), SP_UPDATES updates and the final 200-game
# evaluations; then one simple_ppo_update card vs CPU on a fresh rollout
# (the CPU replaying the card's epoch permutations and ReLU masks), each
# parameter's delta to SP_REF_RTOL of the leaf's largest.  The compared
# update runs Adam at eps REF_EPS on both sides: at the default 1e-8 an
# entry whose gradient is near 0 steps by up to lr * sign(g), so rounding
# in the card's and the CPU's sums moves single entries by ~lr (the CPU
# tests measured 8.5e-3 of a leaf's largest delta after one step between
# XLA and torch); at 1e-3 the step is near linear in the gradient.
SP_ENVS, SP_STEPS, SP_UPDATES, SP_REF_RTOL = 64, 32, 4, 1e-4
REF_EPS = 1e-3
# [gail]: the port's expert script (GAIL_EXPERT_GAMES maximin-2 games on the
# card, openings unrecorded), then cli/gail_train.py (N 256, T 64, its
# defaults) with GAIL_BC BC steps and GAIL_UPDATES updates on it; one
# discriminator step and one full update (collection, the discriminator
# steps, the relabel, the PPO update) card vs CPU, the CPU replaying the
# card's draws, ReLU masks and shuffle words, every optimizer at eps
# REF_EPS, each delta to GAIL_REF_RTOL of its leaf's largest.
GAIL_EXPERT_GAMES, GAIL_BC, GAIL_ENVS, GAIL_STEPS = 64, 20, 256, 64
GAIL_UPDATES, GAIL_REF_RTOL = 2, 1e-4
# [compat]: COMPAT_GAMES seeded cli/run.py games (maximin-1 against the
# seeded random policy through OthelloEnv, 4 random opening plies) on the
# card and on the CPU, the same transcript; COMPAT_PLIES timed plies of
# one SimpleOthelloEnv; a .pth of the vendored Policy written by
# torch.save, imported (forward to COMPAT_FWD_ATOL) and played by
# cli/eval_checkpoint.py against greedy over COMPAT_EVAL_GAMES games.
COMPAT_GAMES, COMPAT_PLIES, COMPAT_EVAL_GAMES = 4, 60, 200
COMPAT_FWD_ATOL = 1e-5
# [cli]: cli/replay.py of the committed wide2 net (deterministic) against
# maximin-2, card = CPU page and one B1 launch a ply; one cli/enjoy.py
# episode of it against greedy with --live-html, card = CPU transcript;
# cli/sweep.py --format script; a utils/profiling.trace of one PPO
# update at wide2 (N CLI_TRACE_ENVS, T CLI_TRACE_STEPS) after a warm-up
# update, whose summarize_trace names B1 and the update's kernels; and
# cli/visualize.load_run on the traced run's metrics.jsonl.
CLI_TRACE_ENVS, CLI_TRACE_STEPS = 1024, 64
# [dp]: (a) DP_UPDATES wide2 PPO updates (N DP_ENVS, T DP_STEPS, the
# dryrun's PPO recipe: lr 3e-4, entropy 0.01) at world 1 under nccl
# against the mesh=None trainer; (b) the same on two gloo ranks sharing
# the card, each with N / 2 games, against (a); (c) one update of each of
# the dryrun's small families world 1 vs 2 (DP_FAMILIES); (d) rollout_chunk_sharded at N
# DP_ROLLOUT_N over two ranks, each rank = the plain rollout on its slice
# at seed + rank * 7919, the counts summed.  Parameters agree per leaf to
# DP_PARAM_RTOL of the leaf's largest change (the card's reductions run
# in other orders; the PPO update's ReLU and clip kinks amplify that), and
# to JAX's gate (rtol 5e-3, atol 1e-5) where the size is the dryrun's.
# (a) also runs the mesh=None trainer twice, and twice more with cuDNN's
# deterministic algorithms, to tell the card's run-to-run drift from the
# mesh path's own arithmetic (on the CPU the world-1 mesh path equals
# mesh=None to the last bits).  The cluster then plants each of DP_FAULTS
# into agents/ppo.py (_planted) and runs the wide and small PPO again:
# the gate must fail each of them at both sizes.  DP_PARAM_RTOL lies
# between the sound readings, the size of the card's run-to-run drift,
# and the planted faults' readings, which are larger by two orders
# (PERF.md section 6 has both).
DP_ENVS, DP_STEPS, DP_UPDATES = 1024, 64, 2
DP_PARAM_RTOL = 0.05
DP_FAMILIES = ("ppo", "ppo_time_limited", "ppo_recurrent", "a2c", "acktr",
               "gail", "teacher_student")
DP_FAULTS = ("unreduced_grads", "local_moments")
DP_ROLLOUT_N, DP_ROLLOUT_STEPS = 4096, 64
DP_TIMEOUT_S = 300
# [dp] (e)-(i), DQN and Rainbow under a mesh, per-shard replay and tensor
# parallelism: (e) DQN at JAX job 60's widths (N DP_OFF_ENVS, batch
# DQN_BATCH, train interval DQN_INTERVAL, PER, double, dueling, n-step 3,
# a DQN_REPLAY ring), one chunk of DP_OFF_PLIES plies (cut from job 60's
# 512 to fit the time) at world 1 under nccl against mesh=None; (f)
# Rainbow at job 58's widths the same way; (g) (e) and (f) on the two
# gloo ranks sharing the card, N / 2 games each, against (e) and (f): on
# the rows (e) and (f) sampled each leaf within DP_PARAM_RTOL of its
# largest change; sampling their own rows within DP_OFF_PARAM_RTOL; the
# rings equal exactly, the ranks bit-equal; (h) both per-shard, the
# union of the two
# rings equal to (e)'s and (f)'s ring exactly; (i) make_sharded_train_step
# on the 1 x 2 mesh of the two ranks, wide2 PPO (N DP_ENVS, T DP_STEPS),
# one step, against world 1: each leaf within DP_PARAM_RTOL, every clip's
# gradient norm within DP_TP_NORM_RTOL.  The planted faults of
# DP_OFF_FAULTS (an update stepping on unreduced gradients, an insert
# putting the gathered streams in reverse rank order) must fail (g)'s
# gate, and
# DP_TP_FAULT (a clip counting the split leaves twice) (i)'s.  NCCL puts
# one rank on a card and this machine has one, so no part measures a
# second GPU: the ranks share cuda:0 over gloo.
DP_OFF_ENVS, DP_OFF_PLIES = 1024, 64
DP_OFF_FAULTS = ("unreduced_offpolicy_grads", "reversed_ranks_insert")
DP_TP_FAULT = "clip_counts_split_leaves_twice"
DP_TP_NORM_RTOL = 1e-2
# Sampling its own rows, a chunk's 128 PER updates turn the rounding of
# a split batch into other rows (the priorities decide the next ones):
# DQN's worst leaf parts by 9.030e-2 of its change on the card, run
# after run, the size of the card's own run-to-run drift of (e) without
# deterministic cuDNN (8.791e-2); on (e)'s rows the same ranks read
# 3.5e-5, within DP_PARAM_RTOL.  The unreduced gradients' fault reads
# 1.085, so the bound below lies between (PERF.md section 6).
DP_OFF_PARAM_RTOL = 0.25
# [tools]: every measurement and evaluation tool of gymothelloenv_tpu_torch/
# scripts/ through its main at full widths, N and plies cut: TOOLS_N games
# and TOOLS_T slots or plies a trace and profile, bench_scaling at
# TOOLS_SCALE_ENVS games a rank and TOOLS_T slots, TOOLS_SNAPSHOT_GAMES
# games a snapshot, tournament_big on TOOLS_LINEUP (cut from its five
# policies: a pair's chunk costs its plies' host round trips whatever its
# games, ~0.5 s, and maximin-3's searches more) at TOOLS_TOURNAMENT_GAMES
# games a pair in chunks of TOOLS_TOURNAMENT_CHUNK.  The two gloo ranks
# of bench_scaling start first and run beside the other tools (their
# processes take ~30 s to start and meet).
TOOLS_N, TOOLS_T = 256, 8
TOOLS_SCALE_ENVS = 128
TOOLS_SNAPSHOT_GAMES = 200
TOOLS_LINEUP = ("rand", "maximin-1")
TOOLS_TOURNAMENT_GAMES, TOOLS_TOURNAMENT_CHUNK = 16, 8
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


def _require_no_k2(count, path):
    """The 8x8 paths flood inside B1 and reset to the constant opening:
    K2 runs on perft's levels and its own benchmark only."""
    require(count == 0, f"K2 launched {count} times on the {path} path, "
            "where every flood is inside the ply kernel")


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
    k2_big["max_abs_err"] = word_bits_err(tb, got, want)
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
        f"{k2_big['bound_ms']:.4f} ms; {sass}; bench at "
        f"{BENCH_LEGAL_BATCH} random boards exact, {bench['launches']} "
        "launches (perft's shape is held in [perft])")

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

    # 6. eval (the ply kernel on every ply; no K2) ---------------------------
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
    for kname in ("bit_step", "rollout"):
        require(launches[kname] > 0, f"kernel {kname} was not launched on "
                "the main path")
    _require_no_k2(launches["legal_mask"], "eval")
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

    # 17. recurrent_train, 18. framestack_train, 19. time_limit_train,
    # 20. bf16, 21. recurrent_eval ------------------------------------------
    slice7, wall = {}, {}
    for label, phase in (
            ("recurrent_train", lambda: _recurrent_train_phase(
                torch, tb, legal_mask, step, timing, dev)),
            ("framestack_train", lambda: _framestack_train_phase(
                torch, tb, legal_mask, step, dev)),
            ("time_limit_train", lambda: _time_limit_train_phase(
                torch, tb, legal_mask, step, dev)),
            ("bf16", lambda: _bf16_phase(torch, tb, ro, legal_mask, step,
                                         dev, gen, train["update_seconds"])),
            ("recurrent_eval", lambda: _recurrent_eval_phase(
                torch, tb, ro, legal_mask, step, dev, gen))):
        t0 = time.perf_counter()
        slice7[label] = phase()
        wall[label] = time.perf_counter() - t0
    rec = slice7["recurrent_train"]
    say("[recurrent slice] wall seconds of its phases: "
        + ", ".join(f"{k} {v:.2f}" for k, v in wall.items()))

    # 22. plane, 23. perft, 24. plane_train, 25. plane_eval -----------------
    slice8, wall = {}, {}
    for label, phase in (
            ("plane", lambda: _plane_phase(torch, tb, step, dev)),
            ("perft", lambda: _perft_phase(torch, tb, legal_mask, step,
                                           timing, dev)),
            ("plane_train", lambda: _plane_train_phase(
                torch, tb, legal_mask, step, dev)),
            ("plane_eval", lambda: _plane_eval_phase(
                torch, tb, legal_mask, step, dev))):
        t0 = time.perf_counter()
        slice8[label] = phase()
        wall[label] = time.perf_counter() - t0
    say("[plane slice] wall seconds of its phases: "
        + ", ".join(f"{k} {v:.2f}" for k, v in wall.items()))
    pf = slice8["perft"]

    # 26. plane_lookahead, 27. teacher_student, 28. dqn ---------------------
    slice9, wall = {}, {}
    for label, phase in (
            ("plane_lookahead", lambda: _plane_lookahead_phase(
                torch, tb, step, dev)),
            ("teacher_student", lambda: _teacher_student_phase(
                torch, tb, legal_mask, step, dev)),
            ("dqn", lambda: _dqn_phase(torch, tb, legal_mask, step, dev))):
        t0 = time.perf_counter()
        slice9[label] = phase()
        wall[label] = time.perf_counter() - t0
        say(f"[{label}] wall seconds {wall[label]:.2f}")
    say("[search and trainers slice] wall seconds of its phases: "
        + ", ".join(f"{k} {v:.2f}" for k, v in wall.items()))

    # 29. rainbow, 30. a2c, 31. acktr ----------------------------------------
    slice10, wall = {}, {}
    for label, phase in (
            ("rainbow", lambda: _rainbow_phase(torch, tb, legal_mask, step,
                                               dev)),
            ("a2c", lambda: _a2c_phase(torch, tb, legal_mask, step, dev)),
            ("acktr", lambda: _acktr_phase(torch, tb, legal_mask, step,
                                           dev))):
        t0 = time.perf_counter()
        slice10[label] = phase()
        wall[label] = time.perf_counter() - t0
        say(f"[{label}] wall seconds {wall[label]:.2f}")
    say("[rainbow, a2c and acktr slice] wall seconds of its phases: "
        + ", ".join(f"{k} {v:.2f}" for k, v in wall.items()))
    # 32. simple_ppo, 33. gail, 34. compat ---------------------------------
    slice11, wall = {}, {}
    for label, phase in (
            ("simple_ppo", lambda: _simple_ppo_phase(torch, tb, legal_mask,
                                                     step, dev)),
            ("gail", lambda: _gail_phase(torch, tb, legal_mask, step, dev)),
            ("compat", lambda: _compat_phase(torch, tb, legal_mask, step,
                                             dev))):
        t0 = time.perf_counter()
        slice11[label] = phase()
        wall[label] = time.perf_counter() - t0
        say(f"[{label}] wall seconds {wall[label]:.2f}")
    say("[simple_ppo, gail and compat slice] wall seconds of its phases: "
        + ", ".join(f"{k} {v:.2f}" for k, v in wall.items()))
    # The expert script's games and searches are a path of their own.
    slice11["gail_expert"] = slice11["gail"].pop("expert_counts")
    # 35. cli, 36. dp -------------------------------------------------------
    slice12, wall = {}, {}
    for label, phase in (
            ("cli", lambda: _cli_phase(torch, tb, legal_mask, step, dev)),
            ("dp", lambda: _dp_phase(torch, tb, ro, legal_mask, step,
                                     dev))):
        t0 = time.perf_counter()
        slice12[label] = phase()
        wall[label] = time.perf_counter() - t0
        say(f"[{label}] wall seconds {wall[label]:.2f}")
    say("[cli and dp slice] wall seconds of its phases: "
        + ", ".join(f"{k} {v:.2f}" for k, v in wall.items()))
    dp_rollout = slice12["dp"].pop("rollout")
    # 37. tools -------------------------------------------------------------
    t0 = time.perf_counter()
    slice13 = {"tools": _tools_phase(torch, tb, legal_mask, step)}
    say(f"[tools] wall seconds {time.perf_counter() - t0:.2f}")
    later = {**slice7, **slice8, **slice9, **slice10, **slice11, **slice12,
             **slice13}

    # 11. kernels line --------------------------------------------------------
    rows = [
        dict(name="legal_mask", route="cuda",
             source="gymothelloenv_tpu_torch/csrc/legal_mask.cu",
             replaces="gymothelloenv_tpu/ops/pallas_bitboard.py:76",
             launches=bench["launches"] + pf["k2_launches"],
             launches_by_path={"bench": bench["launches"],
                               "perft": pf["k2_launches"],
                               "eval": launches["legal_mask"],
                               "train": train["k2_launches"],
                               "lookahead_train": la_train["k2_launches"],
                               "eval_checkpoint": evalck["k2_launches"],
                               **{k: v["k2_launches"]
                                  for k, v in later.items()
                                  if k != "perft"}},
             library_ms=None, equal=True, tolerance="exact",
             shape=f"2 x {pf['k2']['boards'] // 2} boards (perft's depth-9 "
                   "level)",
             ms_1m=k2_big["ms"], plain_ms_1m=k2_big["plain_ms"],
             bound_ms_1m=k2_big["bound_ms"],
             sass_per_board=k2_big["sass_per_board"],
             sass_bound_ms_1m=k2_big["sass_bound_ms"],
             bench_boards=BENCH_LEGAL_BATCH, bench_ms=bench["ms"],
             bench_call_ms=bench["call_ms"],
             bench_plain_ms=bench["plain_ms"], **pf["k2"]),
        dict(name="bit_step", route="cuda",
             source="gymothelloenv_tpu_torch/csrc/step.cu",
             replaces="no Pallas kernel: gymothelloenv_tpu/core/bitboard.py"
                      ":254 bit_step (XLA-fused); carries K2's flood on the "
                      "main path",
             launches=(launches["bit_step"] + train["bit_step_launches"]
                       + mm["launches"] + la["launches"]
                       + la_train["bit_step_launches"]
                       + evalck["bit_step_launches"]
                       + sum(v["bit_step_launches"]
                             for v in later.values())),
             launches_by_path={"eval": launches["bit_step"],
                               "train": train["bit_step_launches"],
                               "maximin": mm["launches"],
                               "lookahead": la["launches"],
                               "lookahead_train":
                                   la_train["bit_step_launches"],
                               "eval_checkpoint":
                                   evalck["bit_step_launches"],
                               **{k: v["bit_step_launches"]
                                  for k, v in later.items()}},
             library_ms=None, equal=True, tolerance="exact",
             shape="1024 games, where mode (the collector's)",
             perft_seconds=pf["seconds"],
             plane_forced_ms=slice8["plane"]["ms_a_ply"][8],
             train_ms=train["ply_ms"], recurrent_train_ms=rec["ply_ms"],
             maximin=mm["timing"],
             lookahead=la["timing"], lookahead_train=la_train["seconds"],
             plane_lookahead=slice9["plane_lookahead"]["timing"],
             teacher_student={k: slice9["teacher_student"][k] for k in (
                 "collect_seconds", "update_seconds", "plies")},
             dqn={k: slice9["dqn"][k] for k in ("chunks", "greedy",
                                                "plies")},
             rainbow={k: slice10["rainbow"][k] for k in ("chunks", "pool",
                                                        "plies")},
             a2c={k: slice10["a2c"][k] for k in (
                 "collect_seconds", "update_seconds", "plies")},
             acktr={k: slice10["acktr"][k] for k in ("runs", "plies")},
             simple_ppo={k: slice11["simple_ppo"][k] for k in (
                 "collect_seconds", "update_seconds", "plies")},
             gail={k: slice11["gail"][k] for k in (
                 "collect_seconds", "disc_seconds", "relabel_seconds",
                 "update_seconds", "plies", "expert_launches")},
             compat={k: slice11["compat"][k] for k in (
                 "ms_a_ply", "plies", "eval_launches")},
             cli={k: slice12["cli"][k] for k in (
                 "replay_plies", "enjoy_plies", "trace_kernels")},
             dp={k: slice12["dp"][k] for k in (
                 "world1_seconds", "child_bit_step_launches")},
             tools=slice13["tools"]["b1"],
             **ply["bit_step"]),
        dict(name="reset_where", route="cuda",
             source="gymothelloenv_tpu_torch/csrc/step.cu",
             replaces="no Pallas kernel: gymothelloenv_tpu/core/engine.py"
                      ":120 BitEngine.reset_where (XLA-fused)",
             launches=(train["reset_launches"] + la_train["reset_launches"]
                       + sum(v["reset_launches"] for v in later.values()
                             if "reset_launches" in v)),
             launches_by_path={"train": train["reset_launches"],
                               "lookahead_train":
                                   la_train["reset_launches"],
                               **{k: v["reset_launches"]
                                  for k, v in later.items()
                                  if "reset_launches" in v}},
             library_ms=None, equal=True, tolerance="exact",
             shape="1024 games (the collector's)",
             train_ms=train["reset_ms"], recurrent_train_ms=rec["reset_ms"],
             **ply["reset_where"]),
        dict(name="rollout", route="cuda",
             source="gymothelloenv_tpu_torch/csrc/rollout.cu",
             replaces="gymothelloenv_tpu/ops/pallas_rollout.py:193",
             launches=launches["rollout"] + dp_rollout["launches"],
             launches_by_path={"bench": launches["rollout"],
                               "rollout_chunk_sharded":
                                   dp_rollout["launches"]},
             library_ms=None, equal=True, tolerance="exact",
             shape=f"{ROLLOUT_N} games x {ROLLOUT_STEPS} plies",
             words_ms=words_ms, words_plies=PARITY_STEPS,
             sharded=dp_rollout, **k1),
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
    reset_where_plain) and of K2's (the wrapper's legal_mask_plain) while
    the block runs: on the card a main path must make none."""
    from gymothelloenv_tpu_torch.ops import legal_mask as k2
    calls = []
    real = (tb.bit_step_plain, tb.reset_where_plain, k2.legal_mask_plain)

    def counted(fn):
        def wrapped(*args, **kwargs):
            calls.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapped

    (tb.bit_step_plain, tb.reset_where_plain,
     k2.legal_mask_plain) = map(counted, real)
    try:
        yield calls
    finally:
        tb.bit_step_plain, tb.reset_where_plain, k2.legal_mask_plain = real


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
    for kname in ("bit_step_launches", "reset_launches"):
        require(out[kname] > 0, f"{kname}: not launched on the training "
                "path")
    _require_no_k2(out["k2_launches"], "training")
    require(not plain_calls, f"training ran the ply's plain version on the "
            f"card: {plain_calls[:3]}")
    out["update_seconds"] = [m["update_seconds"] for m in records]
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


def _trace_ops(torch, fn):
    """The kernels ``fn`` runs (``utils/profiling``: a torch.profiler
    trace read by ``summarize_trace``), empty where the trace shows
    none."""
    from gymothelloenv_tpu_torch.utils import profiling
    with tempfile.TemporaryDirectory() as trace_dir:
        profiling.traced_call(fn, trace_dir)
        return profiling.summarize_trace(trace_dir)


def _device_seconds(torch, fn):
    """Summed device time (s) of the kernels ``fn`` runs, from
    torch.profiler; None where the trace shows no device time."""
    total = sum(o.total_us for o in _trace_ops(torch, fn)) / 1e6
    return total if total > 0 else None


def _cuda_kernels(torch, fn):
    """The number of kernels ``fn`` launches (torch.profiler); None where
    the trace shows none."""
    return sum(o.count for o in _trace_ops(torch, fn)) or None


def _compare_search(torch, got, want, what):
    """A search's card result ``got`` against the CPU's ``want``
    (``(action, scores, margin)``): decisions equal where the CPU's margin
    exceeds LOOKAHEAD_MARGIN, at least 90% of them held so; the same
    actions searched; values to LOOKAHEAD_ATOL.  Returns ``(states,
    held, exactly equal, largest value error)``."""
    from gymothelloenv_tpu_torch.train.self_play import NEG
    a, scores = got[0].cpu(), got[1].cpu()
    a_w, scores_w, margin = want[0], want[1], want[2]
    clear = margin > LOOKAHEAD_MARGIN
    require(torch.equal(a[clear], a_w[clear]),
            f"{what}: {int((a[clear] != a_w[clear]).sum())} decisions "
            f"differ where the margin exceeds {LOOKAHEAD_MARGIN}")
    require(torch.equal(scores[clear] > NEG, scores_w[clear] > NEG),
            f"{what}: other actions searched")
    rows = clear[:, None] & (scores_w > NEG)
    err = float((scores - scores_w)[rows].abs().max()) if bool(
        rows.any()) else 0.0
    require(err <= LOOKAHEAD_ATOL, f"{what}: values differ by {err:.2e} > "
            f"{LOOKAHEAD_ATOL}")
    require(int(clear.sum()) >= 0.9 * a.shape[0], f"{what}: only "
            f"{int(clear.sum())} of {a.shape[0]} decisions clear the margin")
    return a.shape[0], int(clear.sum()), int((a == a_w).sum()), err


def _lookahead_phase(torch, tb, ro, step, net, dev, gen):
    """net_lookahead_policy's search on the wide2 seeded net: card against
    CPU at each depth (LOOKAHEAD_NS states, K1 snapshots with a random
    mover), chunked against unchunked, one ply-kernel launch a tree level;
    then ms a decision for LOOKAHEAD_TIME_N games at each depth and the
    device's share of it.  Returns the main path's ply-kernel launches
    and the timings."""
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train import ppo_trainer
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

    report = {}
    for depth, n in LOOKAHEAD_NS.items():
        want = search(cpu_net, sub(cpu_state, n), depth)
        report[depth] = _compare_search(torch, card[depth], want,
                                        f"depth {depth}")
    report["chunk"] = _compare_search(
        torch, chunked, tuple(t.cpu() for t in card[2]),
        f"chunk {LOOKAHEAD_CHUNK}")
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
    for kname in ("bit_step_launches", "reset_launches"):
        require(out[kname] > 0, f"{kname}: not launched on the lookahead "
                "training path")
    _require_no_k2(out["k2_launches"], "lookahead training")
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
    require(out["bit_step_launches"] > 0, "bit_step: not launched on the "
            "eval_checkpoint path")
    _require_no_k2(out["k2_launches"], "eval_checkpoint")
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
    # A recurrent net or frame-stack cell from a zero state.
    state = ((torch.zeros(n, net.hidden_size), torch.ones(n))
             if getattr(net, "recurrent", False) else ())
    with torch.inference_mode():
        logits, value = net(x.to(dev), *(t.to(dev) for t in state))[:2]
        logits_c, value_c = cpu_net(x, *state)[:2]
    err = max(float((logits.cpu() - logits_c).abs().max()),
              float((value.cpu() - value_c).abs().max()))
    require(bool(torch.isfinite(logits).all()), "trainer net not finite")
    require(err <= FP32_ATOL, f"trainer net on card vs CPU: {err:.2e} > "
            f"{FP32_ATOL}")
    say(f"[train] fp32: constructing PPOSelfPlayTrainer turned TF32 off for "
        f"matmul and cuDNN (both were on; {FLOAT32}); its net on "
        f"{FP32_BATCH} positions agrees with a CPU copy to {err:.2e} (atol "
        f"{FP32_ATOL})")


def _train_reference_phase(torch, dev, board_size=8,
                           label="train_reference", collect=None,
                           shape=f"N={REF_ENVS}, T={REF_STEPS}",
                           record_free=True):
    """ppo_update on the card and on the CPU from the same params, the
    same rollout (collected on the card, on a ``board_size`` board) and
    the same shuffle words: once as a single optimizer step, once with the
    trainer's epochs and minibatches.  The latter is also run on the card
    with a planted fault (PLANTS) to show that its tolerance sees such a
    fault.  Off 8x8, and for a ``collect``ed rollout, the CPU replays the
    card's ReLU masks (``_relu_masks``): there a ReLU input that the two
    round to opposite signs was seen to move the one-step deltas by 5e-5
    and the 4 x 4 per-leaf reading to 11% of a leaf's largest delta, so
    the reference holds the rest of the computation to the same bounds.
    ``collect(net)`` (optional) gives ``(rollout, bootstrap, weights)`` on
    the card from the seeded net in place of the self-play collector: a
    weighted stream (``ppo_update(weights=)``).  ``record_free``: with the
    replay, also print the readings without it (not gated)."""
    from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, Transition,
                                                    make_optimizer,
                                                    ppo_update)
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.ops.shuffle import draw_words
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    from gymothelloenv_tpu_torch.train.self_play import (Draws,
                                                         collect_rollout,
                                                         selfplay_init)
    say(f"[{label}] start: ppo_update card vs CPU, wide2, board "
        f"{board_size}, {shape}: one step, then 4 "
        "epochs x 4 minibatches, then the latter with each planted fault "
        "on the card")
    env_cfg = EnvConfig(board_size=board_size, num_disk_as_reward=True)
    net = make_network(env_cfg, HIDDEN, WIDTH_MULT, SEED + 1, dev).train()
    if collect is None:
        draws = Draws(torch.Generator(dev).manual_seed(SEED + 1))
        sp = selfplay_init(net, env_cfg, REF_ENVS, draws)
        _, rollout, boot = collect_rollout(net, sp, env_cfg, REF_STEPS,
                                           draws)
        weights = None
    else:
        rollout, boot, weights = collect(net)
    inputs = {dev: (rollout, boot, weights),
              "cpu": (Transition(**{k: v.cpu() for k, v in
                                    vars(rollout).items()}), boot.cpu(),
                      None if weights is None else weights.cpu())}
    start = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}

    replay = board_size != 8 or collect is not None
    flips = []

    def update(device, cfg, word_seed=SEED + 1, masks=None):
        """(param deltas on the CPU, metrics) of one ppo_update; with
        ``masks`` the card records its ReLU masks there and the CPU
        replays them."""
        words = draw_words(torch.Generator().manual_seed(word_seed),
                           cfg.ppo_epochs)
        n = make_network(env_cfg, HIDDEN, WIDTH_MULT, SEED + 1,
                         device).train()
        n.load_state_dict(start)
        with (_relu_masks(torch, masks, device != "cpu", flips)
              if masks is not None else contextlib.nullcontext()):
            rollout, boot, weights = inputs[device]
            m = ppo_update(n, make_optimizer(cfg, n.parameters()), rollout,
                           boot, words, cfg, weights=weights)
        return ({k: v.cpu() - start[k] for k, v in n.state_dict().items()},
                {k: float(v) for k, v in m.items()})

    def pair(cfg):
        masks = [] if replay else None
        return update(dev, cfg, masks=masks), update("cpu", cfg, masks=masks)

    one = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY, num_updates=1,
                    ppo_epochs=1, num_mini_batch=1)
    (d_card, m_card), (d_cpu, m_cpu) = pair(one)
    merr1 = _check_metrics(m_card, m_cpu)
    err1 = max(float((d_card[k] - d_cpu[k]).abs().max()) for k in start)
    big1 = max(float(d.abs().max()) for d in d_cpu.values())
    require(big1 > 1e-4, "the reference update did not move the params")
    require(err1 <= REF_ONE_STEP_ATOL,
            f"one step: card vs CPU param deltas differ by {err1:.3e} > "
            f"{REF_ONE_STEP_ATOL}")
    if replay and record_free:
        # The same step without the replay, for the record (not gated).
        (d_free, _), (d_free_cpu, _) = update(dev, one), update("cpu", one)
        free = max(float((d_free[k] - d_free_cpu[k]).abs().max())
                   for k in start)
        say(f"[{label}] one step: the CPU replayed the card's ReLU masks, "
            f"{sum(flips)} of whose inputs the CPU rounds to the other "
            f"sign; without the replay the deltas differ by {free:.3e}")

    cfg = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY,
                    num_updates=TRAIN_UPDATES)
    (d_card, m_card), (d_cpu, m_cpu) = pair(cfg)
    merr = _check_metrics(m_card, m_cpu)
    rel = _leaf_rel(d_card, d_cpu)
    worst = max(rel, key=rel.get)
    if replay and record_free:
        free = max(_leaf_rel(update(dev, cfg)[0],
                             update("cpu", cfg)[0]).values())
        say(f"[{label}] 4 x 4 minibatches without the replay, for the "
            f"record (not gated): per-leaf reading {free:.3e}")
    planted = {}
    for name, change, word_seed in PLANTS:
        d_bad, _ = update(dev, dataclasses.replace(cfg, **change), word_seed)
        planted[name] = max(_leaf_rel(d_bad, d_cpu).values())
    say(f"[{label}] 4 x 4 minibatches, per-leaf |card - CPU| over "
        f"the leaf's largest delta: "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    say(f"[{label}] planted faults on the card, the same reading: "
        + ", ".join(f"{k} {v:.3e}" for k, v in planted.items()))
    require(rel[worst] <= REF_PARAM_RTOL,
            f"card vs CPU deltas of {worst} differ by {rel[worst]:.3e} of "
            f"its largest delta > {REF_PARAM_RTOL}")
    for name, reading in planted.items():
        require(reading > REF_PARAM_RTOL,
                f"the planted fault '{name}' reads {reading:.3e}, inside "
                f"the tolerance {REF_PARAM_RTOL}: the check cannot see it")
    say(f"[{label}] ok: one step: deltas (max {big1:.3e}) agree to "
        f"{err1:.3e} (atol {REF_ONE_STEP_ATOL}), metrics to {merr1:.3e}; "
        f"4 x 4 minibatches: deltas agree to {rel[worst]:.3e} of the "
        f"largest delta of each leaf (worst {worst}; rtol "
        f"{REF_PARAM_RTOL}), every planted fault above it (least "
        f"{min(planted.values()):.3e}), metrics to {merr:.3e} (rtol "
        f"{REF_METRIC_RTOL} + atol {REF_METRIC_ATOL}); fp32, TF32 off")
    return dict(one_step=err1, per_leaf=rel[worst],
                least_planted=min(planted.values()), relu_flips=sum(flips))


@contextlib.contextmanager
def _relu_masks(torch, masks, record, flips):
    """While the block runs, ``torch.relu`` records each call's mask
    (``record``: appended to ``masks`` in call order) or replays the
    recorded ones (``relu(x)`` is ``x * mask``, its gradient ``mask``),
    adding to ``flips`` the mask entries this device's own inputs would
    have set otherwise."""
    real, replayed = torch.relu, iter(masks)

    def relu(x):
        if record:
            masks.append((x > 0).detach())
            return real(x)
        mask = next(replayed).to(x.device)
        flips.append(int((mask != (x > 0)).sum()))
        return x * mask.to(x.dtype)

    torch.relu = relu
    try:
        yield
    finally:
        torch.relu = real


def _leaf_rel(d_card, d_cpu):
    """Per parameter leaf: the largest difference of the card's delta from
    the CPU's over the leaf's own largest CPU delta."""
    out = {}
    for k, d in d_cpu.items():
        big = float(d.abs().max())
        require(big > 0, f"the reference update did not move {k}")
        out[k] = float((d_card[k] - d).abs().max()) / big
    return out


def _check_metrics(m_card, m_cpu):
    for k in m_cpu:
        require(abs(m_card[k] - m_cpu[k])
                <= REF_METRIC_RTOL * abs(m_cpu[k]) + REF_METRIC_ATOL,
                f"card vs CPU {k}: {m_card[k]:.8g} vs {m_cpu[k]:.8g}")
    return max(abs(m_card[k] - m_cpu[k]) for k in m_cpu)


def _slice_trainer(torch, tb, legal_mask, step, dev, label, ppo_cfg,
                   run_cfg, updates, fp32=True):
    """A trainer of the recurrent/frame-stack/time-limit/bf16 slice on the
    card from its seeded net: both TF32 flags on first, ``updates``
    updates with the counts of K2 and the ply kernel from 0, no plain
    ply, finite losses, and after construction TF32 off (with ``fp32``
    its policy also agrees with a CPU copy).  Returns ``(trainer,
    records, counts)``."""
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import PPOSelfPlayTrainer
    records = []

    def log_fn(update, m):
        records.append(m)
        cut = (f", truncations {int(m['truncations'])}"
               if "truncations" in m else "")
        say(f"[{label}] update {update}: collect "
            f"{m['collect_seconds']:.3f} s, update "
            f"{m['update_seconds']:.3f} s, transitions_per_sec="
            f"{m['transitions_per_sec']:.1f}, value_loss="
            f"{m['value_loss']:.5g} action_loss={m['action_loss']:.5g} "
            f"entropy={m['entropy']:.5g}, episodes {int(m['episodes'])}"
            f"{cut}, collector host syncs {m['collect_syncs']}")

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    # Main path: the counts of K2 and the ply kernel start at 0 here.
    legal_mask.launches = 0
    step.bit_step.launches = 0
    step.reset_where.launches = 0
    with _no_plain(tb) as plain_calls:
        trainer = PPOSelfPlayTrainer(EnvConfig(num_disk_as_reward=True),
                                     ppo_cfg, run_cfg, log_fn=log_fn,
                                     device=dev)
        if fp32:
            _fp32_check(torch, trainer.policy, dev)
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        require(flags == (False, False), f"[{label}] the trainer left TF32 "
                f"on (matmul, cuDNN) = {flags}")
        trainer.train(updates, log_every=1)
        torch.cuda.synchronize()
    counts = dict(k2_launches=legal_mask.launches,
                  bit_step_launches=step.bit_step.launches,
                  reset_launches=step.reset_where.launches)
    require(len(records) == updates, f"[{label}] the trainer skipped an "
            "update")
    for m in records:
        for key in ("value_loss", "action_loss", "entropy"):
            require(math.isfinite(m[key]), f"[{label}] {key} is not finite: "
                    f"{m[key]}")
    for kname in ("bit_step_launches", "reset_launches"):
        require(counts[kname] > 0, f"[{label}] {kname}: not launched")
    _require_no_k2(counts["k2_launches"], label)
    require(not plain_calls, f"[{label}] ran the ply's plain version on the "
            f"card: {plain_calls[:3]}")
    counts["seconds"] = {k: [m[k] for m in records] for k in (
        "collect_seconds", "update_seconds", "transitions_per_sec")}
    return trainer, records, counts


def _recurrent_train_phase(torch, tb, legal_mask, step, timing, dev):
    """The rec_wide2 recipe for REC_UPDATES updates; the ply kernel and
    reset_where on its collector's state, against plain and timed; then
    ppo_update_recurrent card vs CPU (``_recurrent_reference``)."""
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
    say(f"[recurrent_train] start: PPOSelfPlayTrainer --recurrent, "
        f"width_mult {REC_WIDTH}, hidden {REC_HIDDEN}, N={REC_ENVS}, "
        f"T={REC_STEPS}, lr {TRAIN_LR}, entropy {TRAIN_ENTROPY}, "
        f"{REC_UPDATES} updates (the rec_wide2 recipe, cut from 3000)")
    ppo_cfg = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY,
                        num_updates=REC_UPDATES)
    run_cfg = SelfPlayConfig(num_envs=REC_ENVS, num_steps=REC_STEPS,
                             hidden_size=REC_HIDDEN, width_mult=REC_WIDTH,
                             recurrent=True, test_interval=10 ** 9,
                             seed=SEED)
    trainer, records, out = _slice_trainer(
        torch, tb, legal_mask, step, dev, "recurrent_train", ppo_cfg,
        run_cfg, REC_UPDATES)
    b = trainer.sp_state.env
    action = tb.random_legal_bit(b.legal, torch.zeros_like(b.legal))
    live = ~b.terminated
    e = _ply_err(torch, tb, step.bit_step(b, action, True, True, do=live),
                 tb.bit_step_plain(b, action, True, True, do=live))
    e = max(e, _ply_err(torch, tb, step.reset_where(b, b.terminated),
                        tb.reset_where_plain(b, b.terminated)))
    require(e == 0, f"a kernel on the recurrent collector's state differs "
            f"from plain ({e})")
    out["ply_ms"] = timing.device_ms(
        lambda: step.bit_step(b, action, True, True, do=live), 200)
    out["reset_ms"] = timing.device_ms(
        lambda: step.reset_where(b, b.terminated), 200)
    say(f"[recurrent_train] kernels on its states, exact vs plain: the ply "
        f"kernel {out['ply_ms']:.5f} ms, reset_where {out['reset_ms']:.5f} "
        f"ms at {REC_ENVS} games (device time); launches bit_step "
        f"{out['bit_step_launches']}, reset_where {out['reset_launches']}, "
        f"K2 {out['k2_launches']}, no plain ply, TF32 off")
    out["reference"] = _recurrent_reference(torch, dev)
    say(f"[recurrent_train] ok: collect "
        + ", ".join(f"{x:.3f}" for x in out["seconds"]["collect_seconds"])
        + " s, update "
        + ", ".join(f"{x:.3f}" for x in out["seconds"]["update_seconds"])
        + " s, transitions_per_sec "
        + ", ".join(f"{x:.1f}" for x in
                    out["seconds"]["transitions_per_sec"]))
    return out


def _recurrent_reference(torch, dev):
    """ppo_update_recurrent on the card and on the CPU from the same
    params, the same rollout (the second of fresh games, collected on the
    card, so h0 is not zero and games end in it) and the same env
    permutations: one optimizer step, then 4 epochs x 4 minibatches per
    leaf, also with each fault of REC_PLANTS on the card."""
    from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, Transition,
                                                    make_optimizer,
                                                    ppo_update_recurrent)
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import (make_network,
                                                           make_split_fns)
    from gymothelloenv_tpu_torch.train.self_play import (
        Draws, collect_rollout_recurrent, selfplay_init_recurrent)
    say(f"[recurrent_train] reference: ppo_update_recurrent card vs CPU, "
        f"rec_wide2, N={REC_REF_ENVS}, T={REC_REF_STEPS}: one step, then 4 "
        f"epochs x 4 minibatches, then the latter with each planted fault "
        f"({', '.join(REC_PLANTS)}) on the card")
    env_cfg = EnvConfig(num_disk_as_reward=True)

    def fresh_net(device):
        return make_network(env_cfg, REC_HIDDEN, REC_WIDTH, SEED + 3, device,
                            recurrent=True).train()

    net = fresh_net(dev)
    draws = Draws(torch.Generator(dev).manual_seed(SEED + 3))
    sp = selfplay_init_recurrent(net, env_cfg, REC_REF_ENVS, REC_HIDDEN,
                                 draws)
    sp, *_ = collect_rollout_recurrent(net, sp, env_cfg, REC_REF_STEPS, draws)
    _, rollout, h0, masks, boot = collect_rollout_recurrent(
        net, sp, env_cfg, REC_REF_STEPS, draws)
    require(float(h0.abs().max()) > 0 and bool((masks == 0).any()),
            "the reference rollout has a zero h0 or no ended game")
    inputs = {dev: (rollout, h0, masks, boot),
              "cpu": (Transition(**{k: v.cpu() for k, v in
                                    vars(rollout).items()}),
                      h0.cpu(), masks.cpu(), boot.cpu())}
    start = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}

    def update(device, cfg, fault=None):
        perms = [torch.randperm(REC_REF_ENVS, generator=torch.Generator()
                                .manual_seed(SEED + 3 + e))
                 for e in range(cfg.ppo_epochs)]
        n = fresh_net(device)
        n.load_state_dict(start)
        roll, h0_, masks_, boot_ = inputs[device]
        if fault == "mask reset dropped":
            masks_ = torch.ones_like(masks_)
        elif fault == "h0 zeros":
            h0_ = torch.zeros_like(h0_)
        elif fault == "b_hr added":
            hr = n.gru.hr
            n.gru.hr = torch.nn.Linear(hr.in_features, hr.out_features,
                                       device=device)
            with torch.no_grad():
                n.gru.hr.weight.copy_(hr.weight)
                n.gru.hr.bias.fill_(0.1)
        m = ppo_update_recurrent(n, make_optimizer(cfg, n.parameters()),
                                 roll, h0_, masks_, boot_, cfg, perms=perms,
                                 split_fns=make_split_fns(n))
        sd = n.state_dict()
        return ({k: sd[k].cpu() - start[k] for k in start},
                {k: float(v) for k, v in m.items()})

    one = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY, num_updates=1,
                    ppo_epochs=1, num_mini_batch=1)
    (d_card, m_card), (d_cpu, m_cpu) = update(dev, one), update("cpu", one)
    merr1 = _check_metrics(m_card, m_cpu)
    err1 = max(float((d_card[k] - d_cpu[k]).abs().max()) for k in start)
    big1 = max(float(d.abs().max()) for d in d_cpu.values())
    require(big1 > 1e-4, "the reference update did not move the params")
    require(err1 <= REF_ONE_STEP_ATOL,
            f"recurrent one step: card vs CPU param deltas differ by "
            f"{err1:.3e} > {REF_ONE_STEP_ATOL}")
    cfg = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY,
                    num_updates=REC_UPDATES)
    (d_card, m_card), (d_cpu, m_cpu) = update(dev, cfg), update("cpu", cfg)
    merr = _check_metrics(m_card, m_cpu)
    rel = _leaf_rel(d_card, d_cpu)
    worst = max(rel, key=rel.get)
    planted = {name: max(_leaf_rel(update(dev, cfg, name)[0],
                                   d_cpu).values()) for name in REC_PLANTS}
    say("[recurrent_train] reference, 4 x 4 minibatches, per-leaf |card - "
        "CPU| over the leaf's largest delta: "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    say("[recurrent_train] reference, planted faults on the card: "
        + ", ".join(f"{k} {v:.3e}" for k, v in planted.items()))
    require(rel[worst] <= REF_PARAM_RTOL,
            f"recurrent card vs CPU deltas of {worst} differ by "
            f"{rel[worst]:.3e} of its largest delta > {REF_PARAM_RTOL}")
    for name, reading in planted.items():
        require(reading > REF_PARAM_RTOL,
                f"the planted fault '{name}' reads {reading:.3e}, inside "
                f"the tolerance {REF_PARAM_RTOL}: the check cannot see it")
    say(f"[recurrent_train] reference ok: one step: deltas (max "
        f"{big1:.3e}) agree to {err1:.3e} (atol {REF_ONE_STEP_ATOL}), "
        f"metrics to {merr1:.3e}; 4 x 4: deltas to {rel[worst]:.3e} of the "
        f"largest delta of each leaf (worst {worst}; rtol "
        f"{REF_PARAM_RTOL}), every planted fault above it (least "
        f"{min(planted.values()):.3e}), metrics to {merr:.3e}")
    return dict(one_step_err=err1, leaf_rel=rel[worst], planted=planted)


def _framestack_train_phase(torch, tb, legal_mask, step, dev):
    """--frame-stack FS_STACK at wide2 for FS_UPDATES updates; then
    FS_STEPS more slots one at a time, each slot's frame window (the
    decision's state and its observation) against
    ``envs.vec_wrappers.frame_stack_step`` from the one before, on the
    card."""
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.envs.vec_wrappers import (FrameStackState,
                                                           frame_stack_step)
    from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
    from gymothelloenv_tpu_torch.train.self_play import (
        collect_rollout_recurrent)
    say(f"[framestack_train] start: --frame-stack {FS_STACK}, wide2, "
        f"N={FS_ENVS}, T={FS_STEPS}, {FS_UPDATES} updates; then the frame "
        f"window of {FS_STEPS} slots vs frame_stack_step")
    ppo_cfg = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY,
                        num_updates=FS_UPDATES)
    run_cfg = SelfPlayConfig(num_envs=FS_ENVS, num_steps=FS_STEPS,
                             hidden_size=HIDDEN, width_mult=WIDTH_MULT,
                             frame_stack=FS_STACK, test_interval=10 ** 9,
                             seed=SEED)
    trainer, _, out = _slice_trainer(torch, tb, legal_mask, step, dev,
                                     "framestack_train", ppo_cfg, run_cfg,
                                     FS_UPDATES)
    sp, ref, ends = trainer.sp_state, None, 0
    for _ in range(FS_STEPS):
        sp, roll, h_t, _, _ = collect_rollout_recurrent(
            trainer.policy, sp, trainer.env_cfg, 1, trainer.draws)
        obs = roll.obs[0].to(torch.float32)
        window = torch.cat([h_t.reshape(FS_ENVS, 4 * (FS_STACK - 1), 8, 8),
                            obs], 1)
        if ref is None:
            ref = FrameStackState(stacked=window, nstack=FS_STACK)
        else:
            ref = frame_stack_step(ref, obs, done)
            require(torch.equal(ref.stacked, window), "the collector's frame "
                    "window differs from frame_stack_step's")
        done = roll.done[0]
        ends += int(done.sum())
    require(ends > 0, "no episode ended in the frame-window check")
    say(f"[framestack_train] ok: the frame window equals frame_stack_step's "
        f"after each of {FS_STEPS} slots at N {FS_ENVS} ({ends} episode "
        f"ends); launches bit_step {out['bit_step_launches']}, reset_where "
        f"{out['reset_launches']}, K2 {out['k2_launches']}, no plain ply")
    return out


def _time_limit_train_phase(torch, tb, legal_mask, step, dev):
    """--max-episode-plies TL_PLIES at wide2 for TL_UPDATES updates
    (truncations in every one); then one more time-limited collection
    and its compute_gae_time_limits, card bit-equal to CPU."""
    from gymothelloenv_tpu_torch.agents.ppo import (PPOConfig, Transition,
                                                    compute_gae_time_limits)
    from gymothelloenv_tpu_torch.train.ppo_trainer import SelfPlayConfig
    from gymothelloenv_tpu_torch.train.self_play import (
        collect_rollout_time_limited)
    say(f"[time_limit_train] start: --max-episode-plies {TL_PLIES}, wide2, "
        f"N={TL_ENVS}, T={TL_STEPS}, {TL_UPDATES} updates; then "
        "compute_gae_time_limits card vs CPU on a collected rollout")
    ppo_cfg = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY,
                        num_updates=TL_UPDATES)
    run_cfg = SelfPlayConfig(num_envs=TL_ENVS, num_steps=TL_STEPS,
                             hidden_size=HIDDEN, width_mult=WIDTH_MULT,
                             max_episode_plies=TL_PLIES,
                             test_interval=10 ** 9, seed=SEED)
    trainer, records, out = _slice_trainer(
        torch, tb, legal_mask, step, dev, "time_limit_train", ppo_cfg,
        run_cfg, TL_UPDATES)
    require(all(m["truncations"] > 0 for m in records),
            "an update had no truncation")
    sp, elapsed = trainer.sp_state
    _, _, rollout, bad, boot = collect_rollout_time_limited(
        trainer.net, sp, elapsed, trainer.env_cfg, TL_STEPS, TL_PLIES,
        trainer.draws)
    require(bool(bad.any()), "the rollout has no truncated episode")
    adv, ret = compute_gae_time_limits(rollout, bad, boot, trainer.ppo_cfg)
    cpu = Transition(**{k: v.cpu() for k, v in vars(rollout).items()})
    adv_c, ret_c = compute_gae_time_limits(cpu, bad.cpu(), boot.cpu(),
                                           trainer.ppo_cfg)
    require(torch.equal(adv.cpu(), adv_c) and torch.equal(ret.cpu(), ret_c),
            "compute_gae_time_limits on the card differs from the CPU's")
    out["truncations"] = [int(m["truncations"]) for m in records]
    say(f"[time_limit_train] ok: truncations {out['truncations']}; "
        f"compute_gae_time_limits bit-equal card vs CPU on {int(bad.sum())} "
        f"truncated and {int((rollout.done & ~bad).sum())} finished "
        f"episodes; launches bit_step {out['bit_step_launches']}, "
        f"reset_where {out['reset_launches']}, K2 {out['k2_launches']}")
    return out


def _bf16_phase(torch, tb, ro, legal_mask, step, dev, gen, f32_update_s):
    """The wide2 net in bfloat16 on BF16_STATES states, card against CPU
    bfloat16 to BF16_RTOL, its trunk's activations bfloat16 (a forward
    hook) and its outputs off the float32 net's; then BF16_UPDATES PPO
    updates with --bf16, the update seconds beside [train]'s float32
    ones."""
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.core.featurize import make_state
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import (SelfPlayConfig,
                                                           make_network)
    say(f"[bf16] start: the wide2 net in bfloat16 on {BF16_STATES} states, "
        f"card vs CPU (rtol {BF16_RTOL} of the largest output); then "
        f"{BF16_UPDATES} --bf16 updates at N={BF16_ENVS}, T={BF16_STEPS}")
    env_cfg = EnvConfig(num_disk_as_reward=True)
    net = make_network(env_cfg, HIDDEN, WIDTH_MULT, SEED, dev,
                       bf16=True).eval()
    state, _, _, _ = _ply_inputs(torch, tb, ro, BF16_STATES, dev, gen)
    x = make_state(state)
    cpu_net = copy.deepcopy(net).cpu()
    f32_net = copy.deepcopy(net)
    f32_net.dtype = torch.float32
    seen = []
    hook = net.trunk.register_forward_hook(
        lambda module, args, out: seen.append(out.dtype))
    with torch.inference_mode():
        out = net(x)
        hook.remove()
        out_c = cpu_net(x.cpu())
        out_32 = f32_net(x)
    err = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
              for a, b in zip(out, out_c))
    off = max(float((a - b).abs().max()) for a, b in zip(out, out_32))
    require(seen == [torch.bfloat16],
            f"the trunk's activations are not bfloat16: {seen}")
    require(all(o.dtype == torch.float32 and bool(torch.isfinite(o).all())
                for o in out), "bf16 outputs not finite float32")
    require(err <= BF16_RTOL, f"bf16 card vs CPU: {err:.3e} of the largest "
            f"output > {BF16_RTOL}")
    require(off > 0, "the bf16 net's outputs equal the float32 net's")
    ppo_cfg = PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY,
                        num_updates=BF16_UPDATES)
    run_cfg = SelfPlayConfig(num_envs=BF16_ENVS, num_steps=BF16_STEPS,
                             hidden_size=HIDDEN, width_mult=WIDTH_MULT,
                             bf16=True, test_interval=10 ** 9, seed=SEED)
    _, _, counts = _slice_trainer(torch, tb, legal_mask, step, dev, "bf16",
                                  ppo_cfg, run_cfg, BF16_UPDATES, fp32=False)
    counts.update(card_cpu_rel=err, off_float32=off)
    say(f"[bf16] ok: trunk activations bfloat16 (hook), outputs float32; "
        f"card vs CPU {err:.3e} of the largest output (rtol {BF16_RTOL}); "
        f"off the float32 net by {off:.3e}; update seconds bf16 "
        + ", ".join(f"{t:.3f}" for t in counts["seconds"]["update_seconds"])
        + " against [train]'s float32 "
        + ", ".join(f"{t:.3f}" for t in f32_update_s)
        + f" (N {BF16_ENVS} vs {TRAIN_ENVS}, T {BF16_STEPS} vs "
        f"{TRAIN_STEPS}); no gain is claimed")
    return counts


def _recurrent_eval_phase(torch, tb, ro, legal_mask, step, dev, gen):
    """cli.eval_checkpoint on a rec_wide2 checkpoint and a frame-stack
    checkpoint written from seeded nets: raw vs greedy, --lookahead vs
    maximin-2, against itself armed at depth 1, and the frame-stacked one
    vs greedy; then the recurrent lookahead on REC_LA_N states card vs
    CPU (decisions where the margin exceeds LOOKAHEAD_MARGIN), one B1
    launch a decision."""
    from gymothelloenv_tpu_torch.cli import eval_checkpoint
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.models.convert import flax_tree
    from gymothelloenv_tpu_torch.train.ppo_trainer import (
        lookahead_recurrent, make_network)
    from gymothelloenv_tpu_torch.utils.checkpoint import save_checkpoint
    say(f"[recurrent_eval] start: eval_checkpoint on a rec_wide2 and a "
        f"frame-stack-{FS_STACK} checkpoint of seeded nets, "
        f"{REC_EVAL_GAMES} games a run; the recurrent lookahead card vs "
        f"CPU on {REC_LA_N} states")
    env_cfg = EnvConfig(num_disk_as_reward=True)
    rec = make_network(env_cfg, REC_HIDDEN, REC_WIDTH, SEED, dev,
                       recurrent=True).eval()
    stacked = make_network(env_cfg, HIDDEN, WIDTH_MULT, SEED, dev,
                           frame_stack=FS_STACK).eval()
    seconds, by_run = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        rec_path = os.path.join(tmp, "rec_wide2.msgpack")
        fs_path = os.path.join(tmp, "framestack.msgpack")
        save_checkpoint(rec_path, 0, flax_tree(rec))
        save_checkpoint(fs_path, 0, flax_tree(stacked))
        runs = (("rec raw vs greedy", rec_path, "greedy", ()),
                ("rec --lookahead vs maximin-2", rec_path, "maximin-2",
                 ("--lookahead",)),
                ("rec vs itself --opp-lookahead-depth 1", rec_path,
                 f"ckpt:{rec_path}", ("--opp-lookahead-depth", "1")),
                ("frame-stack vs greedy", fs_path, "greedy", ()))
        # Main path: the counts of K2 and the ply kernel start at 0 here.
        legal_mask.launches = 0
        step.bit_step.launches = 0
        with _no_plain(tb) as plain_calls:
            for label, path, opp, flags in runs:
                before = (legal_mask.launches, step.bit_step.launches)
                t0 = time.perf_counter()
                w, d, l = eval_checkpoint.main([
                    "--load", path, "--opponent", opp, *flags, "--games",
                    str(REC_EVAL_GAMES), "--seed", str(SEED), "--device",
                    DEVICE_TYPE])
                torch.cuda.synchronize()
                seconds[label] = time.perf_counter() - t0
                by_run[label] = (legal_mask.launches - before[0],
                                 step.bit_step.launches - before[1])
                require(w + d + l == REC_EVAL_GAMES,
                        f"eval_checkpoint {label} lost games")
    out = dict(k2_launches=legal_mask.launches,
               bit_step_launches=step.bit_step.launches)
    require(out["bit_step_launches"] > 0, "bit_step: not launched on the "
            "recurrent eval path")
    _require_no_k2(out["k2_launches"], "recurrent eval")
    require(not plain_calls, f"the recurrent eval ran the ply's plain "
            f"version on the card: {plain_calls[:3]}")
    state, _, _, _ = _ply_inputs(torch, tb, ro, REC_LA_N, dev, gen)
    h = torch.rand(REC_LA_N, REC_HIDDEN, generator=gen, device=dev) * 2 - 1
    before = step.bit_step.launches
    got = lookahead_recurrent(rec, state, h, env_cfg)
    per_decision = step.bit_step.launches - before
    cpu_state = tb.BitState(**{k: v.cpu() for k, v in vars(state).items()})
    want = lookahead_recurrent(copy.deepcopy(rec).cpu(), cpu_state, h.cpu(),
                               env_cfg)
    held = want[2] > LOOKAHEAD_MARGIN
    legal = tb.unpack_flat(cpu_state.legal)
    same = int((got[0].cpu() == want[0]).sum())
    val_err = float((got[1].cpu() - want[1])[legal].abs().max())
    h_err = float((got[3].cpu() - want[3]).abs().max())
    require(per_decision == 1, f"{per_decision} B1 launches a recurrent "
            "lookahead decision, expected 1")
    require(torch.equal(got[0].cpu()[held], want[0][held]),
            "recurrent lookahead decisions differ card vs CPU")
    require(val_err <= LOOKAHEAD_ATOL and h_err <= LOOKAHEAD_ATOL,
            f"recurrent lookahead values or state differ card vs CPU: "
            f"{val_err:.2e}, {h_err:.2e} > {LOOKAHEAD_ATOL}")
    out.update(seconds=seconds, by_run=by_run, la_held=int(held.sum()),
               la_same=same, la_value_err=val_err)
    say(f"[recurrent_eval] ok: wall seconds (K2, ply-kernel launches): "
        + ", ".join(f"{k} {v:.2f} {by_run[k]}" for k, v in seconds.items())
        + f"; no plain ply; the recurrent lookahead on {REC_LA_N} states: "
        f"{int(held.sum())} held by the margin, {same} equal, values to "
        f"{val_err:.2e}, state to {h_err:.2e}, {per_decision} B1 launch a "
        "decision")
    return out


def _plane_states(torch, eng, cfg, n, dev, gen, plies):
    """``n`` plane games on ``dev`` after up to ``plies`` random plies
    each (each game stops at its own ply count; ended games stay)."""
    from gymothelloenv_tpu_torch.core import bitboard as tb
    state = eng.reset_batch(n, cfg, dev)
    stop = torch.randint(0, plies + 1, (n,), generator=gen, device=dev)
    for ply in range(plies):
        t = tb.uniform_index(eng.legal_count(state), gen)
        live = ~state.terminated & (stop > ply)
        state = eng.step_where(state, eng.random_legal(state, t), live, cfg)
    return state


def _plane_phase(torch, tb, step, dev):
    """PlaneEngine on the card: PLANE_N games of random play to the end at
    each of PLANE_SIZES, every state field equal to the CPU's at every
    ply; eager kernels (torch.profiler) and ms of one plane ply at B = 6,
    8 (forced) and 10; then on 8x8 the force_plane collector against the
    BitEngine collector from the same draws, transition for
    transition."""
    from gymothelloenv_tpu_torch.core.engine import PlaneEngine
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    from gymothelloenv_tpu_torch.train.self_play import (Draws,
                                                         collect_rollout,
                                                         selfplay_init)
    say(f"[plane] start: PlaneEngine, {PLANE_N} games of random play to "
        f"the end at B = {PLANE_SIZES}, card vs CPU every ply; a plane ply "
        f"profiled at B = 6, 8 (forced), 10; force_plane vs BitEngine "
        f"collection on 8x8, wide2, N {PLANE_FP_ENVS}, T {PLANE_FP_STEPS}")
    eng = PlaneEngine()
    fields = ("board", "turn", "legal", "terminated", "winner")
    out = {"plies": {}, "winners": {}, "kernels_a_ply": {}, "ms_a_ply": {},
           "device_share": {}}
    step.bit_step.launches = 0
    for b in PLANE_SIZES:
        cfg = EnvConfig(board_size=b)
        gen = torch.Generator(dev).manual_seed(SEED + b)
        card = eng.reset_batch(PLANE_N, cfg, dev)
        cpu = eng.reset_batch(PLANE_N, cfg, "cpu")
        plies = 0
        while not bool(card.terminated.all()):
            require(plies < b * b, f"B = {b}: games outlive the board")
            t = tb.uniform_index(eng.legal_count(card), gen)
            action, live = eng.random_legal(card, t), ~card.terminated
            card = eng.step_where(card, action, live, cfg)
            cpu = eng.step_where(cpu, action.cpu(), live.cpu(), cfg)
            plies += 1
            for f in fields:
                require(torch.equal(getattr(card, f).cpu(), getattr(cpu, f)),
                        f"B = {b}: the card's {f} differs from the CPU's at "
                        f"ply {plies}")
        out["plies"][b] = plies
        out["winners"][b] = [int((card.winner == w).sum()) for w in (-1, 0, 1)]
    require(step.bit_step.launches == 0, "B1 ran on a board other than 8x8")
    for b in (6, 8, 10):
        cfg = EnvConfig(board_size=b)
        gen = torch.Generator(dev).manual_seed(SEED + 20 + b)
        state = _plane_states(torch, eng, cfg, PLANE_N, dev, gen, PLANE_WARM)
        t = tb.uniform_index(eng.legal_count(state), gen)
        live = ~state.terminated

        def ply():
            return eng.step_where(state, eng.random_legal(state, t), live,
                                  cfg)
        ply()
        torch.cuda.synchronize()
        before = step.bit_step.launches
        ops = _trace_ops(torch, ply)
        b1 = step.bit_step.launches - before
        kernels = sum(o.count for o in ops)
        device_s = sum(o.total_us for o in ops) / 1e6
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PLANE_TIME_REPS):
            ply()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / PLANE_TIME_REPS
        require(kernels > 0, f"B = {b}: the profiler saw no kernel")
        require(b1 == (1 if b == 8 else 0), f"B = {b}: {b1} B1 launches a "
                "plane ply")
        out["kernels_a_ply"][b], out["ms_a_ply"][b] = kernels, ms
        out["device_share"][b] = 1e3 * device_s / ms
    # force_plane on 8x8 against the bit engine, the same draws.
    cfg = EnvConfig(num_disk_as_reward=True)
    net = make_network(cfg, HIDDEN, WIDTH_MULT, SEED, dev).eval()
    runs = {}
    for force in (False, True):
        step.bit_step.launches = 0
        step.reset_where.launches = 0
        draws = Draws(torch.Generator(dev).manual_seed(SEED + 3))
        with _no_plain(tb) as plain_calls:
            sp = selfplay_init(net, cfg, PLANE_FP_ENVS, draws,
                               force_plane=force)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rolls = []
            for _ in range(PLANE_FP_ROLLOUTS):
                sp, roll, _ = collect_rollout(net, sp, cfg, PLANE_FP_STEPS,
                                              draws, force_plane=force)
                rolls.append(roll)
            torch.cuda.synchronize()
        require(not plain_calls, f"force_plane={force} ran a plain version "
                f"on the card: {plain_calls[:3]}")
        runs[force] = dict(rolls=rolls,
                           seconds=(time.perf_counter() - t0)
                           / PLANE_FP_ROLLOUTS,
                           b1=step.bit_step.launches,
                           resets=step.reset_where.launches)
    bit, plane = runs[False], runs[True]
    for got, want in zip(plane["rolls"], bit["rolls"]):
        for f in ("obs", "action", "reward", "done", "legal", "logp",
                  "value"):
            require(torch.equal(getattr(got, f), getattr(want, f)),
                    f"force_plane collection differs from BitEngine's in "
                    f"{f}")
    ends = sum(int(r.done.sum()) for r in bit["rolls"])
    require(ends > 0, "no game ended in the force_plane comparison")
    require(plane["b1"] == bit["b1"] > 0 and plane["resets"] == 0,
            f"B1 launches {plane['b1']} (plane) vs {bit['b1']} (bit), "
            f"reset_where {plane['resets']} on planes")
    out.update(bit_step_launches=plane["b1"] + bit["b1"],
               reset_launches=bit["resets"], k2_launches=0,
               collect_seconds={"bit": bit["seconds"],
                                "plane": plane["seconds"]})
    say(f"[plane] ok: card = CPU at every ply; plies to the end "
        f"{out['plies']}, (black, draw, white) wins {out['winners']}; a "
        f"plane ply at N {PLANE_N}: eager kernels {out['kernels_a_ply']}, "
        "ms " + ", ".join(f"B={k} {v:.3f}" for k, v in
                          out["ms_a_ply"].items())
        + ", device share " + ", ".join(
            f"B={k} {100 * v:.1f}%" for k, v in out["device_share"].items())
        + f" (B=8 forced: one B1 launch a ply); force_plane collection = "
        f"BitEngine's on all {PLANE_FP_ROLLOUTS} x {PLANE_FP_STEPS} x "
        f"{PLANE_FP_ENVS} transitions ({ends} episode ends), B1 launches "
        f"{plane['b1']} on each (one a ply), reset_where {bit['resets']} "
        f"(bit) and 0 (plane); collect a rollout {bit['seconds']:.3f} s "
        f"(bit), {plane['seconds']:.3f} s (plane)")
    return out


def _perft_oracle():
    """The C++ oracle native/othello_perft.cpp, built with g++ into the
    ignored build directory, as tests/test_perft.py builds it."""
    import ctypes
    build = os.path.join(HERE, "gymothelloenv_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    so = os.path.join(build, "libothello_perft.so")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", so,
                    os.path.join(HERE, "native", "othello_perft.cpp")],
                   check=True, timeout=120)
    lib = ctypes.CDLL(so)
    lib.othello_perft.restype = ctypes.c_ulonglong
    lib.othello_perft.argtypes = [ctypes.c_int]
    lib.othello_perft_from.restype = ctypes.c_ulonglong
    lib.othello_perft_from.argtypes = [ctypes.c_uint64, ctypes.c_uint64,
                                       ctypes.c_int]
    return lib


def _perft_phase(torch, tb, legal_mask, step, timing, dev):
    """core/perft.py on the card, the counts of K2 and B1 from 0: depths
    1-PERFT_DEPTH from the opening, then perft_from on midgame positions,
    against the published counts and the C++ oracle; then K2 at perft's
    largest level against its plain version, timed."""
    from gymothelloenv_tpu_torch.core import perft
    from gymothelloenv_tpu_torch.ops.legal_mask import legal_mask_plain
    say(f"[perft] start: depths 1-{PERFT_DEPTH} from the opening and "
        f"perft_from at depths {PERFT_FROM_DEPTHS} on {PERFT_MIDGAME} "
        "midgame positions, on the card against the C++ oracle")
    t0 = time.perf_counter()
    oracle = _perft_oracle()
    build_s = time.perf_counter() - t0
    real_k2 = perft.legal_mask
    largest = {}

    def recorded(mine, opp):
        if mine.shape[0] > largest.get("n", 0):
            largest.update(n=mine.shape[0], inputs=(mine, opp))
        return real_k2(mine, opp)

    seconds, oracle_s, levels = {}, {}, 0
    positions = _perft_positions(torch, tb,
                                 torch.Generator().manual_seed(SEED + 9))
    # Main path: the counts of K2 and the ply kernel start at 0 here.
    legal_mask.launches = 0
    step.bit_step.launches = 0
    perft.legal_mask = recorded
    try:
        with _no_plain(tb) as plain_calls:
            for d in range(1, PERFT_DEPTH + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = perft.perft(d, device=dev)
                torch.cuda.synchronize()
                seconds[d] = time.perf_counter() - t0
                levels += d
                t0 = time.perf_counter()
                want = int(oracle.othello_perft(d))
                oracle_s[d] = time.perf_counter() - t0
                require(got == want and PERFT_KNOWN.get(d, want) == want,
                        f"perft({d}) = {got}, oracle {want}, published "
                        f"{PERFT_KNOWN.get(d)}")
            for cur, opp in positions:
                for d in PERFT_FROM_DEPTHS:
                    got = perft.perft_from(cur, opp, d, device=dev)
                    want = int(oracle.othello_perft_from(cur, opp, d))
                    levels += d
                    require(got == want, f"perft_from({cur:#x}, {opp:#x}, "
                            f"{d}) = {got}, oracle {want}")
    finally:
        perft.legal_mask = real_k2
    out = dict(k2_launches=legal_mask.launches,
               bit_step_launches=step.bit_step.launches)
    require(not plain_calls, f"perft ran a plain version on the card: "
            f"{plain_calls[:3]}")
    require(out["k2_launches"] == out["bit_step_launches"] == levels,
            f"K2 {out['k2_launches']} and B1 {out['bit_step_launches']} "
            f"launches for {levels} levels, expected one each a level")
    mine, opp = largest["inputs"]
    got, want = legal_mask(mine, opp), legal_mask_plain(mine, opp)
    n = mine.shape[0]
    k2 = dict(boards=n, max_abs_err=word_bits_err(tb, got, want),
              ms=timing.device_ms(lambda: legal_mask(mine, opp), 100),
              call_ms=timing.call_ms(lambda: legal_mask(mine, opp), 100),
              plain_ms=timing.call_ms(lambda: legal_mask_plain(mine, opp),
                                      5))
    k2["bound_ms"], k2["bound_by"] = bound_ms(24 * n, K2_OPS_PER_BOARD * n)
    require(k2["max_abs_err"] == 0, "K2 differs from plain at perft's level")
    out.update(seconds=seconds, oracle_seconds=oracle_s, k2=k2,
               positions=len(positions), oracle_build_seconds=build_s)
    say(f"[perft] ok: depths 1-{PERFT_DEPTH} equal the published counts "
        f"and the oracle, perft_from equal on {len(positions)} positions at "
        f"depths {PERFT_FROM_DEPTHS}; K2 {out['k2_launches']} and B1 "
        f"{out['bit_step_launches']} launches ({levels} levels), no plain "
        "ply; seconds a depth "
        + ", ".join(f"{d}: {v:.3f}" for d, v in seconds.items())
        + " (oracle at 9: "
        f"{oracle_s[PERFT_DEPTH]:.3f} s); K2 at {n} boards (perft's "
        f"largest level) exact: {k2['ms']:.5f} ms on the device, "
        f"{k2['call_ms']:.4f} ms a call, plain {k2['plain_ms']:.3f} ms, "
        f"bound {k2['bound_ms']:.5f} ms ({k2['bound_by']})")
    return out


def _perft_positions(torch, tb, gen):
    """PERFT_MIDGAME positions (side to move, other side) as unsigned
    words, after 20-44 random plies from the opening on the CPU; games
    that end are skipped."""
    n = 4 * PERFT_MIDGAME
    state = tb.bit_reset(n, "cpu")
    stop = torch.randint(20, 45, (n,), generator=gen)
    for ply in range(44):
        live = ~state.terminated & (stop > ply)
        t = tb.uniform_index(tb.popcount(state.legal), gen)
        state = tb.bit_step_plain(state, tb.random_legal_bit(state.legal, t),
                                  do=live).state
    out = []
    for i in range(n):
        if bool(state.terminated[i]) or len(out) == PERFT_MIDGAME:
            continue
        mine, theirs = int(state.black[i]), int(state.white[i])
        if int(state.turn[i]) == 1:
            mine, theirs = theirs, mine
        out.append((mine & (2 ** 64 - 1), theirs & (2 ** 64 - 1)))
    require(len(out) == PERFT_MIDGAME, "too few midgame positions")
    return out


def _plane_train_phase(torch, tb, legal_mask, step, dev):
    """cli.ppo_self_play --board-size PLANE_TRAIN_BOARD at wide2 (N 1024,
    T 64, TRAIN_UPDATES updates) from both TF32 flags on, with the counts
    of K2 and B1 from 0 (none may run off 8x8); then its ppo_update card
    vs CPU (``_train_reference_phase`` on that board)."""
    from gymothelloenv_tpu_torch.cli import ppo_self_play
    from gymothelloenv_tpu_torch.core.state import OthelloState
    b = PLANE_TRAIN_BOARD
    say(f"[plane_train] start: ppo_self_play --board-size {b} --width-mult "
        f"{WIDTH_MULT} --hidden-size {HIDDEN} --num-envs {TRAIN_ENVS} "
        f"--num-steps {TRAIN_STEPS} --num-updates {TRAIN_UPDATES}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        # Main path: the counts of K2 and the ply kernel start at 0 here.
        legal_mask.launches = 0
        step.bit_step.launches = 0
        step.reset_where.launches = 0
        t0 = time.perf_counter()
        trainer = ppo_self_play.main([
            "--board-size", str(b), "--width-mult", str(WIDTH_MULT),
            "--hidden-size", str(HIDDEN), "--num-envs", str(TRAIN_ENVS),
            "--num-steps", str(TRAIN_STEPS), "--num-updates",
            str(TRAIN_UPDATES), "--lr", str(TRAIN_LR), "--entropy-coef",
            str(TRAIN_ENTROPY), "--log-every", "1", "--test-interval",
            str(10 ** 9), "--num-test-games", str(TRAIN_TEST_GAMES),
            "--seed", str(SEED), "--log-dir", tmp, "--device", DEVICE_TYPE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    require(flags == (False, False), f"[plane_train] TF32 on: {flags}")
    require(len(records) == TRAIN_UPDATES, "the trainer skipped an update")
    for m in records:
        for key in ("value_loss", "action_loss", "entropy"):
            require(math.isfinite(m[key]), f"[plane_train] {key} is not "
                    f"finite: {m[key]}")
    env = trainer.sp_state.env
    require(isinstance(env, OthelloState) and env.board.shape[1:] == (b, b)
            and env.board.device.type == "cuda"
            and trainer.net.logits.out_features == b * b,
            "[plane_train] not on the card's plane engine at the board")
    out = dict(k2_launches=legal_mask.launches,
               bit_step_launches=step.bit_step.launches,
               reset_launches=step.reset_where.launches, wall_seconds=wall,
               collect_seconds=[m["collect_seconds"] for m in records],
               update_seconds=[m["update_seconds"] for m in records],
               transitions_per_sec=[m["transitions_per_sec"]
                                    for m in records])
    require(out["k2_launches"] == out["bit_step_launches"]
            == out["reset_launches"] == 0, "a kernel of the 8x8 path ran "
            "on the 6x6 board")
    say(f"[plane_train] ok: {TRAIN_UPDATES} updates and the final 200-game "
        f"evals in {wall:.2f} s; collect "
        + ", ".join(f"{x:.3f}" for x in out["collect_seconds"])
        + " s, update " + ", ".join(f"{x:.3f}" for x in
                                    out["update_seconds"])
        + " s, transitions_per_sec " + ", ".join(
            f"{x:.1f}" for x in out["transitions_per_sec"])
        + "; losses finite, TF32 off, no B1 or K2 launch")
    out["reference"] = _train_reference_phase(torch, dev, b, "plane_train")
    return out


def _plane_eval_phase(torch, tb, legal_mask, step, dev):
    """cli.tournament --board-size 10 (greedy vs rand, maximin-1 vs
    greedy) and 6 (maximin-2 vs greedy), cli.eval_checkpoint --board-size
    6 on a seeded board-6 wide2 checkpoint vs maximin-1, PLANE_EVAL_GAMES
    games a run; then plane maximin card vs CPU on PLANE_MAXIMIN_N states
    per (board, depth)."""
    from gymothelloenv_tpu_torch.cli import eval_checkpoint, tournament
    from gymothelloenv_tpu_torch.core.engine import PlaneEngine
    from gymothelloenv_tpu_torch.core.state import (EnvConfig, OthelloState,
                                                    index_games)
    from gymothelloenv_tpu_torch.models.convert import flax_tree
    from gymothelloenv_tpu_torch.policies.scripted import maximin_action
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    from gymothelloenv_tpu_torch.utils.checkpoint import save_checkpoint
    say(f"[plane_eval] start: tournament --board-size 10 greedy vs rand and "
        f"maximin-1 vs greedy, --board-size 6 maximin-2 vs greedy; "
        f"eval_checkpoint --board-size 6 (seeded wide2) vs maximin-1; "
        f"{PLANE_EVAL_GAMES} games a run; plane maximin card vs CPU on "
        f"{PLANE_MAXIMIN_N} states at (board, depth) {PLANE_MAXIMIN}")
    seconds, results = {}, {}
    net = make_network(EnvConfig(board_size=6), HIDDEN, WIDTH_MULT, SEED,
                       dev).eval()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "board6_wide2.msgpack")
        save_checkpoint(path, 0, flax_tree(net))
        # Main path: the counts of K2 and the ply kernel start at 0 here.
        legal_mask.launches = 0
        step.bit_step.launches = 0
        for b, black, white in ((10, "greedy", "rand"),
                                (10, "maximin-1", "greedy"),
                                (6, "maximin-2", "greedy")):
            label = f"B={b} {black} vs {white}"
            t0 = time.perf_counter()
            res = tournament.main([
                "--board-size", str(b), "--black", black, "--white", white,
                "--games", str(PLANE_EVAL_GAMES), "--seed", str(SEED),
                "--device", DEVICE_TYPE])
            seconds[label] = time.perf_counter() - t0
            results[label] = res[(black, white)]
            require(sum(results[label]) == PLANE_EVAL_GAMES,
                    f"tournament {label} lost games")
        t0 = time.perf_counter()
        wdl = eval_checkpoint.main([
            "--board-size", "6", "--load", path, "--opponent", "maximin-1",
            "--games", str(PLANE_EVAL_GAMES), "--seed", str(SEED),
            "--device", DEVICE_TYPE])
        seconds["B=6 eval_checkpoint vs maximin-1"] = (time.perf_counter()
                                                       - t0)
        results["B=6 eval_checkpoint vs maximin-1"] = wdl
        require(sum(wdl) == PLANE_EVAL_GAMES, "eval_checkpoint lost games")
    out = dict(k2_launches=legal_mask.launches,
               bit_step_launches=step.bit_step.launches)
    require(out["k2_launches"] == out["bit_step_launches"] == 0,
            "a kernel of the 8x8 path ran on another board")
    eng, same = PlaneEngine(), {}
    for b, depth in PLANE_MAXIMIN:
        gen = torch.Generator(dev).manual_seed(SEED + 40 + b)
        state = _plane_states(torch, eng, EnvConfig(board_size=b),
                              PLANE_MAXIMIN_N, dev, gen, b * b - 8)
        state = index_games(state, ~state.terminated)
        got = maximin_action(state, depth)
        want = maximin_action(OthelloState(**{
            k: v.cpu() for k, v in vars(state).items()}), depth)
        require(torch.equal(got.cpu(), want), f"plane maximin-{depth} at "
                f"B = {b}: card and CPU decisions differ")
        same[(b, depth)] = int(got.shape[0])
    out.update(seconds=seconds, results=results, maximin_states=same)
    say(f"[plane_eval] ok: every game accounted for; "
        + ", ".join(f"{k} {results[k]} in {v:.2f} s"
                    for k, v in seconds.items())
        + "; plane maximin card = CPU on "
        + ", ".join(f"{n} live states at B={b} depth {d}"
                    for (b, d), n in same.items())
        + "; no B1 or K2 launch")
    return out


@contextlib.contextmanager
def _count_plies(cls):
    """Count the calls of ``cls.step_where`` and ``cls.reset_where`` (an
    engine's plies and resets) while the block runs."""
    calls = {"step_where": 0, "reset_where": 0}
    real = {k: getattr(cls, k) for k in calls}

    def counted(name):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return real[name](*args, **kwargs)
        return wrapped

    for k in calls:
        setattr(cls, k, counted(k))
    try:
        yield calls
    finally:
        for k, fn in real.items():
            setattr(cls, k, fn)


@contextlib.contextmanager
def _replay_argmax(torch, taken, record, flips):
    """As ``_relu_masks`` for ``torch.argmax``: record each call's result
    (``record``) or return the recorded one, adding to ``flips`` the rows
    where this device's own argmax differs."""
    real, replayed = torch.argmax, iter(taken)

    def argmax(x, *args, **kwargs):
        got = real(x, *args, **kwargs)
        if record:
            taken.append(got)
            return got
        want = next(replayed).to(got.device)
        flips.append(int((want != got).sum()))
        return want

    torch.argmax = argmax
    try:
        yield
    finally:
        torch.argmax = real


def _plane_lookahead_phase(torch, tb, step, dev):
    """The value-lookahead search on planes: on a seeded wide2 net at B = 6
    and 10, decisions at depth 1 (PLA_GAMES reachable states), depth 2 and
    beam-3 (k PLA_BEAM) on fewer, and the recurrent depth 1 (a seeded
    rec_wide2 net, random hidden states), card against CPU where the
    margin exceeds LOOKAHEAD_MARGIN; ms a decision for PLA_GAMES games at
    each depth with the device's share; no B1 launch off 8x8.  On 8x8
    planes (the force_plane layout) the search decides as the bitboard
    one, one B1 launch a level.  Then ppo_self_play --board-size 6
    --lookahead-collect --lookahead-mix 0.25 at wide2, N PLA_ENVS, T
    PLA_STEPS, PLA_UPDATES updates (the override fires at the 4th)."""
    from gymothelloenv_tpu_torch.cli import ppo_self_play
    from gymothelloenv_tpu_torch.core.engine import PlaneEngine
    from gymothelloenv_tpu_torch.core.state import (EnvConfig, OthelloState,
                                                    index_games)
    from gymothelloenv_tpu_torch.train import ppo_trainer
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    say(f"[plane_lookahead] start: wide2 seeded net at B = {PLA_SIZES}: "
        f"card vs CPU at depth 1 on {PLA_GAMES} states, depth 2 on "
        f"{PLA_CMP[2]}, beam-3 (k {PLA_BEAM}) on {PLA_CMP[3]}, the "
        f"recurrent depth 1 (rec_wide2) on {PLA_GAMES}; ms a decision for "
        f"{PLA_GAMES} games; 8x8 planes vs bitboard; then ppo_self_play "
        f"--board-size 6 --lookahead-collect --lookahead-mix {LA_MIX} at "
        f"N {PLA_ENVS}, T {PLA_STEPS}, {PLA_UPDATES} updates")
    eng = PlaneEngine()
    report, timing = {}, {}

    def cpu(state):
        return OthelloState(**{k: v.cpu() for k, v in vars(state).items()})

    # Main path: B1's count starts at 0 here (no launch off 8x8).
    step.bit_step.launches = 0
    with _no_plain(tb) as plain_calls:
        for b in PLA_SIZES:
            cfg = EnvConfig(board_size=b, num_disk_as_reward=True)
            gen = torch.Generator(dev).manual_seed(SEED + 60 + b)
            state = _plane_states(torch, eng, cfg, PLA_GAMES, dev, gen,
                                  b * b // 2)
            net = make_network(cfg, HIDDEN, WIDTH_MULT, SEED, dev).eval()
            cpu_net = copy.deepcopy(net).cpu()
            for depth in (1, 2, 3):
                sub = index_games(state, slice(0, PLA_CMP[depth]))
                got = ppo_trainer.lookahead_search(net, sub, cfg, depth,
                                                   PLA_BEAM)
                want = ppo_trainer.lookahead_search(cpu_net, cpu(sub), cfg,
                                                    depth, PLA_BEAM)
                report[(b, depth)] = _compare_search(
                    torch, got, want, f"B={b} depth {depth}")
                act = ppo_trainer.net_lookahead_policy(net, cfg, depth,
                                                       PLA_BEAM)
                ms = []
                for _ in range(PLA_REPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    act(state)
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
                device_s = _device_seconds(torch, lambda: act(state))
                med = statistics.median(ms)
                timing[f"B{b}_depth{depth}_ms"] = med
                timing[f"B{b}_depth{depth}_host_share"] = (
                    None if device_s is None else 1.0 - 1e3 * device_s / med)
            rnet = make_network(cfg, REC_HIDDEN, REC_WIDTH, SEED, dev,
                                recurrent=True).eval()
            h = torch.randn(PLA_GAMES, REC_HIDDEN, generator=gen,
                            device=dev).clamp(-1, 1)
            a, scores, _, h_cur = ppo_trainer.lookahead_recurrent(
                rnet, state, h, cfg)
            a_w, scores_w, margin, h_w = ppo_trainer.lookahead_recurrent(
                copy.deepcopy(rnet).cpu(), cpu(state), h.cpu(), cfg)
            report[(b, "recurrent")] = _compare_search(
                torch, (a, scores), (a_w, scores_w, margin),
                f"B={b} recurrent depth 1")
            herr = float((h_cur.cpu() - h_w).abs().max())
            require(herr <= LOOKAHEAD_ATOL, f"B={b} recurrent: the carried "
                    f"state differs by {herr:.2e}")
        torch.cuda.synchronize()
    require(step.bit_step.launches == 0, "B1 ran on a board other than 8x8")
    require(not plain_calls, f"[plane_lookahead] ran a plain ply on the "
            f"card: {plain_calls[:3]}")

    # 8x8 planes: decisions equal to the bitboard search's, one B1 a level.
    cfg8 = EnvConfig(num_disk_as_reward=True)
    gen = torch.Generator(dev).manual_seed(SEED + 68)
    planes = _plane_states(torch, eng, EnvConfig(), PLA_GAMES, dev, gen, 40)
    bits = tb.from_planes(planes.board, planes.turn, planes.legal,
                          planes.terminated, planes.winner)
    net8 = make_network(cfg8, HIDDEN, WIDTH_MULT, SEED, dev).eval()
    forced = {}
    step.bit_step.launches = 0
    with _no_plain(tb) as plain_calls:
        for depth in (1, 2, 3):
            before = step.bit_step.launches
            got = ppo_trainer.lookahead_search(net8, planes, cfg8, depth,
                                               PLA_BEAM)[0]
            forced[depth] = step.bit_step.launches - before
            want = ppo_trainer.lookahead_search(net8, bits, cfg8, depth,
                                                PLA_BEAM)[0]
            require(torch.equal(got, want), f"8x8 planes depth {depth}: "
                    "decisions differ from the bitboard search's")
        torch.cuda.synchronize()
    require(not plain_calls, "the 8x8 plane search ran a plain ply")
    require(forced == {1: 1, 2: 2, 3: 3}, f"8x8 planes: B1 launches a "
            f"decision {forced}, expected one a level")
    forced_launches = step.bit_step.launches

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    with tempfile.TemporaryDirectory() as tmp:
        step.bit_step.launches = 0
        t0 = time.perf_counter()
        ppo_self_play.main([
            "--board-size", "6", "--lookahead-collect", "--lookahead-mix",
            str(LA_MIX), "--width-mult", str(WIDTH_MULT), "--hidden-size",
            str(HIDDEN), "--num-envs", str(PLA_ENVS), "--num-steps",
            str(PLA_STEPS), "--num-updates", str(PLA_UPDATES), "--lr",
            str(TRAIN_LR), "--entropy-coef", str(TRAIN_ENTROPY),
            "--log-every", "1", "--test-interval", str(10 ** 9),
            "--num-test-games", str(TRAIN_TEST_GAMES), "--seed", str(SEED),
            "--log-dir", tmp, "--device", DEVICE_TYPE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    require(step.bit_step.launches == 0, "B1 ran in board-6 training")
    require([m["lookahead"] for m in records] == [0.0, 0.0, 0.0, 1.0],
            f"the override's updates: {[m['lookahead'] for m in records]}")
    for m in records:
        for key in ("value_loss", "action_loss", "entropy"):
            require(math.isfinite(m[key]), f"[plane_lookahead] {key} is not "
                    f"finite: {m[key]}")
    train = {k: [m[k] for m in records] for k in (
        "collect_seconds", "update_seconds", "transitions_per_sec")}
    say("[plane_lookahead] card vs CPU (states, held by the margin, exactly "
        "equal, largest value error): " + "; ".join(
            f"B={b} {d if d == 'recurrent' else f'depth {d}'} "
            f"{v[0]}/{v[1]}/{v[2]}/{v[3]:.2e}"
            for (b, d), v in report.items()))
    say("[plane_lookahead] ms a decision for "
        f"{PLA_GAMES} games (host share): " + ", ".join(
            f"B={b} depth {d} {timing[f'B{b}_depth{d}_ms']:.2f}"
            + ("" if timing[f"B{b}_depth{d}_host_share"] is None else
               f" ({100 * timing[f'B{b}_depth{d}_host_share']:.1f}%)")
            for b in PLA_SIZES for d in (1, 2, 3)))
    say(f"[plane_lookahead] ok: no B1 off 8x8, no plain ply; 8x8 planes = "
        f"bitboard, B1 launches a decision {forced}; board-6 lookahead "
        f"training {PLA_UPDATES} updates in {wall:.2f} s, collect "
        + ", ".join(f"{x:.3f}" for x in train["collect_seconds"])
        + " s (the 4th with the override), update "
        + ", ".join(f"{x:.3f}" for x in train["update_seconds"]) + " s")
    return dict(k2_launches=0, bit_step_launches=forced_launches,
                report={f"{b}-{d}": v for (b, d), v in report.items()},
                timing=timing, train=train, wall_seconds=wall)


def _teacher_student_phase(torch, tb, legal_mask, step, dev):
    """cli.teacher_vs_student at JAX job 52's width (wide2, N TS_ENVS, T
    TS_STEPS, lr 2.5e-4, entropy 0.01, seed 5), the teacher warm-started
    from TS_TEACHER, TS_CHUNKS chunks and the final 400-game student
    evaluation, from both TF32 flags on: finite losses for both roles,
    records of weight 1 in both streams, one B1 launch for every ply of
    BitEngine (collection and evaluation) and a B1 reset_where for each
    reset, no plain ply, no K2; then a save/load round trip, and one
    student update card vs CPU on a collected stream (N TS_REF_ENVS, T
    TS_REF_STEPS, the CPU replaying the card's ReLU masks)."""
    from gymothelloenv_tpu_torch.cli import teacher_vs_student
    from gymothelloenv_tpu_torch.core.engine import BitEngine
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train import teacher_student as ts
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    from gymothelloenv_tpu_torch.train.self_play import Draws
    teacher = os.path.join(HERE, TS_TEACHER)
    require(os.path.exists(teacher), f"{TS_TEACHER} is missing")
    say(f"[teacher_student] start: teacher_vs_student --width-mult "
        f"{WIDTH_MULT} --hidden-size {HIDDEN} --num-envs {TS_ENVS} "
        f"--num-steps {TS_STEPS} --teacher-load {TS_TEACHER} --num-chunks "
        f"{TS_CHUNKS}; student update card vs CPU at N {TS_REF_ENVS}, T "
        f"{TS_REF_STEPS}")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    argv = ["--num-envs", str(TS_ENVS), "--num-steps", str(TS_STEPS),
            "--lr", str(TRAIN_LR), "--entropy-coef", str(TRAIN_ENTROPY),
            "--width-mult", str(WIDTH_MULT), "--hidden-size", str(HIDDEN),
            "--test-interval", str(10 ** 9), "--teacher-test-interval",
            str(10 ** 9), "--num-test-games", str(TRAIN_TEST_GAMES),
            "--seed", "5", "--log-every", "1", "--device", DEVICE_TYPE]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ts")
        # Main path: the counts of K2 and the ply kernel start at 0 here.
        legal_mask.launches = 0
        step.bit_step.launches = 0
        step.reset_where.launches = 0
        t0 = time.perf_counter()
        with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as calls:
            trainer = teacher_vs_student.main(argv + [
                "--teacher-load", teacher, "--num-chunks", str(TS_CHUNKS),
                "--checkpoint", ckpt, "--log-dir", tmp])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(k2_launches=legal_mask.launches,
                      bit_step_launches=step.bit_step.launches,
                      reset_launches=step.reset_where.launches)
        with open(os.path.join(tmp, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        fresh = ts.TeacherStudentTrainer(trainer.env_cfg, trainer.ppo_cfg,
                                         trainer.run_cfg, device=dev)
        fresh.load(ckpt)
        fresh.save(ckpt + "2")
        for role in (".teacher", ".student"):
            with open(ckpt + role, "rb") as a, open(ckpt + "2" + role,
                                                    "rb") as b:
                require(a.read() == b.read(), f"[teacher_student] {role} "
                        "written again differs")
        for a, b in ((trainer.net_t, fresh.net_t),
                     (trainer.net_s, fresh.net_s)):
            require(all(torch.equal(x, y) for x, y in
                        zip(a.parameters(), b.parameters())),
                    "[teacher_student] loaded params differ")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    require(flags == (False, False), f"[teacher_student] TF32 on: {flags}")
    chunks = [m for m in records if "student_value_loss" in m]
    require(len(chunks) == TS_CHUNKS, "the trainer skipped a chunk")
    for m in chunks:
        for key in ("value_loss", "action_loss", "entropy"):
            for role in ("teacher", "student"):
                require(math.isfinite(m[f"{role}_{key}"]),
                        f"[teacher_student] {role}_{key} is not finite")
        require(m["teacher_records"] > 0 and m["student_records"] > 0,
                "[teacher_student] a stream has no record of weight 1")
    require(counts["bit_step_launches"] == calls["step_where"]
            >= 4 * TS_STEPS * TS_CHUNKS, f"[teacher_student] B1 launches "
            f"{counts['bit_step_launches']} for {calls['step_where']} plies")
    require(counts["reset_launches"] == calls["reset_where"]
            == TS_STEPS * TS_CHUNKS, "[teacher_student] resets: "
            f"{counts['reset_launches']} launches, {calls['reset_where']} "
            "calls")
    _require_no_k2(counts["k2_launches"], "teacher_student")
    require(not plain_calls, f"[teacher_student] ran a plain ply: "
            f"{plain_calls[:3]}")

    def collect(net):
        cfg = EnvConfig(num_disk_as_reward=True)
        draws = Draws(torch.Generator(dev).manual_seed(SEED + 3))
        teacher_net = make_network(cfg, HIDDEN, WIDTH_MULT, SEED + 2,
                                   dev).eval()
        state = ts.ts_init(cfg, TS_REF_ENVS, 0, draws, device=dev)
        _, _, (roll, w, boot) = ts.collect_ts_rollout(
            teacher_net, net, state, cfg, TS_REF_STEPS, 0, 0.0, draws)
        require(0 < float(w.sum()) < w.numel(), "[teacher_student] the "
                "reference stream has no bubbles or no records")
        return roll, boot, w

    out = dict(counts, wall_seconds=wall, plies=calls["step_where"],
               **{k: [m[k] for m in chunks] for k in (
                   "collect_seconds", "update_seconds",
                   "student_episode_return", "episodes")})
    say(f"[teacher_student] {TS_CHUNKS} chunks and the final evaluation in "
        f"{wall:.2f} s: collect " + ", ".join(
            f"{x:.3f}" for x in out["collect_seconds"]) + " s, update "
        + ", ".join(f"{x:.3f}" for x in out["update_seconds"])
        + f" s a chunk; {calls['step_where']} plies, "
        f"{counts['bit_step_launches']} B1 launches, "
        f"{counts['reset_launches']} reset_where; no K2, no plain ply; "
        "save/load byte for byte")
    out["reference"] = _train_reference_phase(
        torch, dev, 8, "teacher_student", collect=collect,
        shape=f"N={TS_REF_ENVS}, T={TS_REF_STEPS} slots (4T student rows)",
        record_free=False)
    ref = out["reference"]
    say(f"[teacher_student] ok: the student's update card vs CPU, one step "
        f"{ref['one_step']:.2e}, 4 x 4 per leaf {ref['per_leaf']:.2e}")
    return out


def _dqn_phase(torch, tb, legal_mask, step, dev):
    """cli.dqn_train at JAX job 60's configuration (N DQN_ENVS, DQN_PLIES
    plies a chunk, batch DQN_BATCH, train interval DQN_INTERVAL, PER,
    double, dueling, n-step 3, a 1M replay, no warm-up, seed 4), DQN_CHUNKS
    chunks and the final 400-game evaluation: seconds a chunk, updates/s
    and transitions/s; one B1 launch a BitEngine ply and a reset_where a
    collector ply, no plain ply, no K2; a checkpoint round trip.  Card vs
    CPU: the PER sampler on the 1M ring with power-of-two priorities, and
    one update (dqn_train_batch's steps on the rows the card samples) on
    the trained replay, its RMSprop step per leaf, with faults planted on
    the card (``_dqn_update_reference``).  Then one chunk's collection
    against --opponent
    greedy (its updates are the self-play chunk's), with the kernels of a
    collector ply and of one greedy decision (torch.profiler)."""
    from gymothelloenv_tpu_torch.agents import dqn as dqn_mod
    from gymothelloenv_tpu_torch.agents import replay as rp
    from gymothelloenv_tpu_torch.cli import dqn_train
    from gymothelloenv_tpu_torch.core.engine import BitEngine
    from gymothelloenv_tpu_torch.train.dqn_trainer import DQNTrainer
    say(f"[dqn] start: dqn_train --num-envs {DQN_ENVS} --chunk-plies "
        f"{DQN_PLIES} --batch-size {DQN_BATCH} --train-interval "
        f"{DQN_INTERVAL} --prioritized 1 --double 1 --dueling 1 --n-step 3 "
        f"--replay-size {DQN_REPLAY} --initial-replay-size 0 --num-chunks "
        f"{DQN_CHUNKS}; PER sampler and one update card vs CPU; one chunk "
        "against greedy")
    argv = ["--num-envs", str(DQN_ENVS), "--chunk-plies", str(DQN_PLIES),
            "--batch-size", str(DQN_BATCH), "--train-interval",
            str(DQN_INTERVAL), "--prioritized", "1", "--double", "1",
            "--dueling", "1", "--n-step", "3", "--initial-replay-size", "0",
            "--replay-size", str(DQN_REPLAY), "--test-interval",
            str(10 ** 9), "--num-test-games", str(TRAIN_TEST_GAMES),
            "--log-every", "1", "--seed", "4", "--device", DEVICE_TYPE]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "dqn.msgpack")
        _zero_counts(legal_mask, step)
        t0 = time.perf_counter()
        with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as calls:
            trainer = dqn_train.main(argv + [
                "--num-chunks", str(DQN_CHUNKS), "--checkpoint", ckpt,
                "--log-dir", tmp])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(legal_mask, step)
        records = _read_metrics(tmp)
        fresh = DQNTrainer(trainer.env_cfg, trainer.dqn_cfg, trainer.rb_cfg,
                           trainer.run_cfg, device=dev)
        fresh.load(ckpt)
        fresh.save(ckpt + "2")
        with open(ckpt, "rb") as a, open(ckpt + "2", "rb") as b:
            require(a.read() == b.read(), "[dqn] the checkpoint written "
                    "again differs")
        require(fresh.agent.t == trainer.agent.t and all(
            torch.equal(x, y) for x, y in zip(
                trainer.agent.net.parameters(),
                fresh.agent.net.parameters())), "[dqn] load differs")
    chunks = [m for m in records if "loss" in m]
    require(len(chunks) == DQN_CHUNKS, "[dqn] the trainer skipped a chunk")
    require(all(math.isfinite(m["loss"]) and m["updates"] > 0
                for m in chunks), "[dqn] no update or a loss not finite")
    require(counts["bit_step_launches"] == calls["step_where"]
            >= DQN_PLIES * DQN_CHUNKS, f"[dqn] B1 launches "
            f"{counts['bit_step_launches']} for {calls['step_where']} plies")
    require(counts["reset_launches"] == calls["reset_where"]
            == DQN_PLIES * DQN_CHUNKS, "[dqn] resets: "
            f"{counts['reset_launches']} launches, {calls['reset_where']} "
            "calls")
    _require_no_k2(counts["k2_launches"], "dqn")
    require(not plain_calls, f"[dqn] ran a plain ply: {plain_calls[:3]}")
    readings = _chunk_readings(chunks)

    # Card vs CPU: the PER sampler on the 1M ring, power-of-two
    # priorities (exact prefix sums on both).  A first draft drew them
    # from 2^-4 to 2^4, whose sums over the ring need 26 bits: the card's
    # and the CPU's block prefix sums rounded apart and indices differed.
    cfg = rp.ReplayConfig(capacity=DQN_REPLAY, prioritized=True)
    gen = torch.Generator(dev).manual_seed(SEED + 9)
    rb = rp.replay_init(cfg, dev)
    # Powers of two from 1 to 8: every prefix sum over the 1M ring is an
    # integer below 2^24, exact in float32 in any order of summation.
    rb.priority = 2.0 ** torch.randint(0, 4, (DQN_REPLAY + 1,),
                                       generator=gen, device=dev).float()
    rb.size = torch.tensor(DQN_REPLAY - 12_345, device=dev)
    u = torch.rand(DQN_BATCH, generator=gen, device=dev)
    idx = rp.replay_sample_idx(rb, cfg, u)
    rb_cpu = rp.replay_init(rp.ReplayConfig(capacity=DQN_REPLAY,
                                            prioritized=True), "cpu")
    rb_cpu.priority, rb_cpu.size = rb.priority.cpu(), rb.size.cpu()
    require(torch.equal(idx.cpu(), rp.replay_sample_idx(rb_cpu, cfg,
                                                        u.cpu())),
            "[dqn] the PER sampler's indices differ on the card")
    require(int(idx.max()) < DQN_REPLAY - 12_345, "[dqn] PER drew an "
            "unfilled row")

    # Card vs CPU: one update (dqn_train_batch's steps) on the trained
    # replay.  Both take the rows the card samples: the trained
    # priorities are not exact in float32, so the card's and the CPU's
    # prefix sums over the 1M ring round apart and a few samples land on
    # neighbouring rows (counted, not gated; the sampler is held exactly
    # above on exact priorities).
    ref = _dqn_update_reference(torch, trainer, dqn_mod, rp, gen, dev)

    # One chunk against greedy; the kernels of a collector ply and of one
    # greedy decision.
    g = DQNTrainer(trainer.env_cfg, trainer.dqn_cfg, trainer.rb_cfg,
                   dataclasses.replace(trainer.run_cfg, opponent="greedy"),
                   device=dev)
    _zero_counts(legal_mask, step)
    with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as gcalls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.collect_chunk()
        torch.cuda.synchronize()
        greedy_collect = time.perf_counter() - t0
    require(step.bit_step.launches == gcalls["step_where"] == DQN_PLIES,
            f"[dqn] greedy chunk: {step.bit_step.launches} B1 launches for "
            f"{gcalls['step_where']} plies")
    _require_no_k2(legal_mask.launches, "dqn greedy")
    require(not plain_calls, "[dqn] the greedy chunk ran a plain ply")
    greedy_b1 = step.bit_step.launches
    require(step.reset_where.launches == gcalls["reset_where"] == DQN_PLIES,
            "[dqn] greedy chunk: one reset_where a ply")
    greedy_resets = step.reset_where.launches
    eps = g._epsilon(g.agent.t).to(dev)
    ply_kernels = _cuda_kernels(torch, lambda: g._ply(g.roll, eps, None))
    greedy_kernels = _cuda_kernels(torch, lambda: g.eng.greedy(g.roll.env))
    out = dict(counts, bit_step_launches=counts["bit_step_launches"]
               + greedy_b1,
               reset_launches=counts["reset_launches"] + greedy_resets,
               wall_seconds=wall, chunks=readings,
               plies=calls["step_where"], per_sampler_equal=True,
               update=ref,
               greedy=dict(collect_seconds=greedy_collect,
                           kernels_a_ply=ply_kernels,
                           greedy_kernels=greedy_kernels))
    say("[dqn] chunks: " + "; ".join(
        f"collect {r['collect_seconds']:.3f} s, {r['updates']} updates in "
        f"{r['update_seconds']:.3f} s ({r['updates_per_sec']:.1f}/s), "
        f"{r['transitions_per_sec']:.1f} transitions/s" for r in readings))
    say(f"[dqn] ok: {DQN_CHUNKS} chunks and the final evaluation in "
        f"{wall:.2f} s; {calls['step_where']} plies, "
        f"{counts['bit_step_launches']} B1 launches, "
        f"{counts['reset_launches']} reset_where; PER indices card = CPU on "
        f"the 1M ring; one update card vs CPU: the step per leaf "
        f"{ref['step_rel']:.2e} of its largest (rtol {DQN_STEP_RTOL}), "
        f"every planted fault above it (least "
        f"{min(ref['planted'].values()):.2e}), loss {ref['loss_rel']:.2e}, "
        f"priorities {ref['priority_rel']:.2e} (rtol {DQN_REF_RTOL}); "
        f"checkpoint round trip byte for byte; "
        f"a chunk's collection against greedy {greedy_collect:.3f} s, "
        f"{ply_kernels} kernels a collector ply, {greedy_kernels} a greedy "
        "decision")
    return out


def _rmsprop_planted(torch, opt, eps_outside=False, momentum=None):
    """``agents.dqn.RMSprop.step`` with a planted fault: eps added outside
    the root (PyTorch's RMSprop), or another momentum."""
    m = opt.momentum if momentum is None else momentum
    with torch.no_grad():
        for p, nu, tr in zip(opt.params, opt.nu, opt.trace):
            g = p.grad
            nu.mul_(opt.decay).add_((1.0 - opt.decay) * (g * g))
            scale = (1.0 / (nu.sqrt() + opt.eps) if eps_outside
                     else torch.rsqrt(nu + opt.eps))
            tr.mul_(m).add_(scale * g * -opt.lr)
            p.add_(tr)


def _dqn_update_reference(torch, trainer, dqn_mod, rp, gen, dev):
    """One ``dqn_train_batch`` update (its sample, loss, gradients, RMSprop
    step and priority refresh) of the trained agent on the trained
    replay, on the card and on the CPU from the same state, the CPU
    replaying the card's rows, its ReLU masks and its Double-DQN argmax.
    The step is read from the momentum trace (``trace - momentum *
    trace_before``, the update the optimizer adds to it), per leaf over
    the leaf's largest CPU step; each parameter is held to the CPU's
    within the two traces' difference plus one float32 rounding of the
    parameter.  Then the card's update with each planted fault
    (DQN_PLANTS) must read above DQN_STEP_RTOL against the CPU's true
    one."""
    agent, cfg, rb_cfg = trainer.agent, trainer.dqn_cfg, trainer.rb_cfg
    cpu_agent = dqn_mod.dqn_init(cfg, 0, "cpu")
    cpu_agent.net.load_state_dict(agent.net.state_dict())
    cpu_agent.target.load_state_dict(agent.target.state_dict())
    for dst, src in ((cpu_agent.optimizer.nu, agent.optimizer.nu),
                     (cpu_agent.optimizer.trace, agent.optimizer.trace)):
        for d, s in zip(dst, src):
            d.copy_(s.cpu())
    names = [k for k, _ in agent.net.named_parameters()]
    params0 = [p.detach().clone() for p in agent.net.parameters()]
    nu0 = [t.clone() for t in agent.optimizer.nu]
    trace0 = [t.clone() for t in agent.optimizer.trace]
    momentum = agent.optimizer.momentum
    replay = trainer.replay
    cpu_replay = rp.Replay(**{k: v.cpu() for k, v in vars(replay).items()})
    card_replay = rp.Replay(**{k: v.clone() for k, v in
                               vars(replay).items()})
    u = torch.rand(DQN_BATCH, generator=gen, device=dev)
    idx = rp.replay_sample_idx(card_replay, rb_cfg, u)
    resampled = int((rp.replay_sample_idx(cpu_replay, rb_cfg, u.cpu())
                     != idx.cpu()).sum())
    argmax, masks, flips, relu_flips = [], [], [], []

    def update(a, r, i, record, plant=None):
        """The update on ``a``; returns (loss, per-leaf steps, params)."""
        c = dataclasses.replace(cfg, n_step=1) if plant == "gamma^1" else cfg
        with _replay_argmax(torch, argmax, record, flips), \
                _relu_masks(torch, masks, record, relu_flips):
            loss, td = dqn_mod.dqn_loss_grads(a, c, rp.replay_gather(r, i))
        before = [t.detach().cpu().clone() for t in a.optimizer.trace]
        if plant == "eps outside the root":
            _rmsprop_planted(torch, a.optimizer, eps_outside=True)
        elif plant == "momentum 0.9":
            _rmsprop_planted(torch, a.optimizer, momentum=0.9)
        else:
            a.optimizer.step()
        if plant is None:
            rp.replay_update_priorities(r, rb_cfg, i, td)
        steps = [t.detach().cpu() - momentum * b
                 for t, b in zip(a.optimizer.trace, before)]
        return (float(loss), steps,
                [p.detach().cpu().clone() for p in a.net.parameters()],
                [t.detach().cpu().clone() for t in a.optimizer.trace])

    loss, step_card, p_card, tr_card = update(agent, card_replay, idx, True)
    loss_c, step_cpu, p_cpu, tr_cpu = update(cpu_agent, cpu_replay,
                                             idx.cpu(), False)

    def step_rel(steps):
        out = {}
        for k, s, w in zip(names, steps, step_cpu):
            big = float(w.abs().max())
            require(big > 0, f"[dqn] the reference update did not move {k}")
            out[k] = float((s - w).abs().max()) / big
        return out
    rel = step_rel(step_card)
    worst = max(rel, key=rel.get)
    sizes = {k: float(w.abs().max()) for k, w in zip(names, step_cpu)}
    param_excess = max(float(((a - b).abs() - (ta - tb).abs()
                              - 2.0 ** -22 * b.abs()).max())
                       for a, b, ta, tb in zip(p_card, p_cpu, tr_card,
                                               tr_cpu))
    lerr = abs(loss - loss_c) / max(abs(loss_c), 1e-12)
    perr = float(((card_replay.priority.cpu() - cpu_replay.priority).abs()
                  / cpu_replay.priority.clamp(min=1e-12)).max())
    planted = {}
    for plant in DQN_PLANTS:
        with torch.no_grad():
            for p, p0 in zip(agent.net.parameters(), params0):
                p.copy_(p0)
            for dst, src in ((agent.optimizer.nu, nu0),
                             (agent.optimizer.trace, trace0)):
                for d, s0 in zip(dst, src):
                    d.copy_(s0)
        planted[plant] = max(step_rel(update(agent, card_replay, idx, False,
                                             plant)[1]).values())
    say(f"[dqn] one update: the CPU's step |u| per leaf from "
        f"{min(sizes.values()):.3e} to {max(sizes.values()):.3e} "
        f"(read from the momentum trace); card vs "
        f"CPU per leaf {rel[worst]:.3e} ({worst}); planted faults on the "
        "card: " + ", ".join(f"{k} {v:.3e}" for k, v in planted.items())
        + f"; {sum(flips)} of {DQN_BATCH} next actions and "
        f"{sum(relu_flips)} ReLU units the CPU's own arithmetic would "
        f"change; {resampled} of the CPU's own samples land elsewhere")
    require(rel[worst] <= DQN_STEP_RTOL, f"[dqn] one update: the step of "
            f"{worst} differs by {rel[worst]:.3e} of its largest > "
            f"{DQN_STEP_RTOL}")
    require(param_excess <= 0, f"[dqn] one update: a parameter differs by "
            f"{param_excess:.3e} more than its step and one rounding")
    for plant, reading in planted.items():
        require(reading > DQN_STEP_RTOL, f"[dqn] the planted fault "
                f"'{plant}' reads {reading:.3e}, inside {DQN_STEP_RTOL}")
    require(lerr <= DQN_REF_RTOL and perr <= DQN_REF_RTOL, f"[dqn] one "
            f"update: loss {lerr:.3e}, priorities {perr:.3e} (rtol "
            f"{DQN_REF_RTOL})")
    return dict(step_rel=rel[worst], worst_leaf=worst,
                step_size_max=max(sizes.values()),
                step_size_min=min(sizes.values()), planted=planted,
                loss_rel=lerr, priority_rel=perr, argmax_flips=sum(flips),
                relu_flips=sum(relu_flips), resampled=resampled)


def _chunk_readings(chunks):
    """Per chunk of a DQN-family run's metrics: collect and update
    seconds, updates, updates/s and transitions/s."""
    prev, readings = 0, []
    for m in chunks:
        new = m["transitions"] - prev
        prev = m["transitions"]
        readings.append(dict(
            collect_seconds=m["collect_seconds"],
            update_seconds=m["update_seconds"], updates=m["updates"],
            updates_per_sec=m["updates"] / m["update_seconds"],
            transitions_per_sec=new / (m["collect_seconds"]
                                       + m["update_seconds"])))
    return readings


def _read_metrics(tmp):
    with open(os.path.join(tmp, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _zero_counts(legal_mask, step):
    legal_mask.launches = 0
    step.bit_step.launches = 0
    step.reset_where.launches = 0


def _counts(legal_mask, step):
    return dict(k2_launches=legal_mask.launches,
                bit_step_launches=step.bit_step.launches,
                reset_launches=step.reset_where.launches)


def _rainbow_phase(torch, tb, legal_mask, step, dev):
    """cli.rainbow_train at JAX job 58's configuration (N RAINBOW_ENVS,
    RAINBOW_PLIES plies a chunk, batch RAINBOW_BATCH, train interval
    RAINBOW_INTERVAL, n-step 3, a 1M PER replay, no warm-up, seed 4),
    RAINBOW_CHUNKS chunks and the final 400-game evaluation: seconds a
    chunk, updates/s and transitions/s; one B1 launch a BitEngine ply and
    a reset_where a collector ply, no plain ply, no K2; finite losses.
    Card vs CPU: the committed RAINBOW_CKPT's atom logits on the trained
    replay's boards, noise off and on; one update
    (``_rainbow_update_reference``).  Then one chunk's collection in job
    07's pool mode (a frozen snapshot plays the other colour)."""
    from gymothelloenv_tpu_torch.agents import rainbow
    from gymothelloenv_tpu_torch.agents.dqn import featurize3
    from gymothelloenv_tpu_torch.cli import rainbow_train
    from gymothelloenv_tpu_torch.core.engine import BitEngine
    from gymothelloenv_tpu_torch.models.convert import load_flax_params
    from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer
    from gymothelloenv_tpu_torch.utils.checkpoint import load_checkpoint
    say(f"[rainbow] start: rainbow_train --num-envs {RAINBOW_ENVS} "
        f"--chunk-plies {RAINBOW_PLIES} --batch-size {RAINBOW_BATCH} "
        f"--train-interval {RAINBOW_INTERVAL} --initial-replay-size 0 "
        f"--seed 4 --num-chunks {RAINBOW_CHUNKS}; {RAINBOW_CKPT} and one "
        "update card vs CPU; one chunk in the pool mode")
    argv = ["--num-envs", str(RAINBOW_ENVS), "--chunk-plies",
            str(RAINBOW_PLIES), "--batch-size", str(RAINBOW_BATCH),
            "--train-interval", str(RAINBOW_INTERVAL),
            "--initial-replay-size", "0", "--test-interval", str(10 ** 9),
            "--num-test-games", str(TRAIN_TEST_GAMES), "--log-every", "1",
            "--seed", "4", "--device", DEVICE_TYPE,
            "--num-chunks", str(RAINBOW_CHUNKS)]
    with tempfile.TemporaryDirectory() as tmp:
        _zero_counts(legal_mask, step)
        t0 = time.perf_counter()
        with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as calls:
            trainer = rainbow_train.main(argv + ["--log-dir", tmp])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(legal_mask, step)
        records = _read_metrics(tmp)
    chunks = [m for m in records if "loss" in m]
    require(len(chunks) == RAINBOW_CHUNKS, "[rainbow] a chunk was skipped")
    require(all(math.isfinite(m["loss"]) and m["updates"] > 0
                and m["epsilon"] == 0.0 for m in chunks),
            "[rainbow] no update, a loss not finite or epsilon not 0")
    require(counts["bit_step_launches"] == calls["step_where"]
            >= RAINBOW_PLIES * RAINBOW_CHUNKS, f"[rainbow] B1 launches "
            f"{counts['bit_step_launches']} for {calls['step_where']} plies")
    require(counts["reset_launches"] == calls["reset_where"]
            == RAINBOW_PLIES * RAINBOW_CHUNKS, "[rainbow] resets: "
            f"{counts['reset_launches']} launches, {calls['reset_where']} "
            "calls")
    _require_no_k2(counts["k2_launches"], "rainbow")
    require(not plain_calls, f"[rainbow] ran a plain ply: {plain_calls[:3]}")
    readings = _chunk_readings(chunks)

    # The committed checkpoint on the trained replay's boards.
    _, params, _, _ = load_checkpoint(os.path.join(HERE, RAINBOW_CKPT))
    x = featurize3(trainer.replay.board[:RAINBOW_BATCH],
                   trainer.replay.turn[:RAINBOW_BATCH])
    net = load_flax_params(rainbow.RainbowNet().to(dev), params)
    net_cpu = load_flax_params(rainbow.RainbowNet(), params)
    noise = torch.randn(net.noise_size, device=dev,
                        generator=torch.Generator(dev).manual_seed(SEED))
    fwd = {}
    with torch.no_grad():
        for label, n in (("noise off", None), ("noise on", noise)):
            want = net_cpu(x.cpu(), None if n is None else n.cpu())
            got = net(x, n).cpu()
            fwd[label] = float((got - want).abs().max()
                               / want.abs().max())
            require(bool(torch.isfinite(got).all()) and fwd[label]
                    <= RAINBOW_FWD_RTOL, f"[rainbow] {RAINBOW_CKPT} "
                    f"{label}: card vs CPU {fwd[label]:.3e} of the largest")
    ref = _rainbow_update_reference(torch, trainer, rainbow, dev)

    # A chunk's collection in the pool mode.
    pool = RainbowTrainer(trainer.env_cfg, trainer.dqn_cfg, trainer.rb_cfg,
                          dataclasses.replace(trainer.run_cfg,
                                              opponent_pool=8,
                                              pool_interval=50),
                          device=dev)
    snap = pool._snapshot()
    _zero_counts(legal_mask, step)
    with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as pcalls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        added = pool.collect_chunk(snap)
        torch.cuda.synchronize()
        pool_collect = time.perf_counter() - t0
    pcounts = _counts(legal_mask, step)
    require(pcounts["bit_step_launches"] == pcalls["step_where"]
            == RAINBOW_PLIES and pcounts["reset_launches"] == RAINBOW_PLIES
            and added > 0, f"[rainbow] pool chunk: {pcounts} for "
            f"{pcalls['step_where']} plies, {added} transitions")
    _require_no_k2(pcounts["k2_launches"], "rainbow pool")
    require(not plain_calls, "[rainbow] the pool chunk ran a plain ply")
    out = dict(k2_launches=counts["k2_launches"] + pcounts["k2_launches"],
               wall_seconds=wall, chunks=readings,
               bit_step_launches=counts["bit_step_launches"]
               + pcounts["bit_step_launches"],
               reset_launches=counts["reset_launches"]
               + pcounts["reset_launches"],
               plies=calls["step_where"], forward_rel=fwd, update=ref,
               pool=dict(collect_seconds=pool_collect, transitions=added))
    say("[rainbow] chunks: " + "; ".join(
        f"collect {r['collect_seconds']:.3f} s, {r['updates']} updates in "
        f"{r['update_seconds']:.3f} s ({r['updates_per_sec']:.1f}/s), "
        f"{r['transitions_per_sec']:.1f} transitions/s" for r in readings))
    say(f"[rainbow] ok: {RAINBOW_CHUNKS} chunks and the final evaluation "
        f"in {wall:.2f} s; {calls['step_where']} plies, "
        f"{counts['bit_step_launches']} B1 launches, "
        f"{counts['reset_launches']} reset_where, no K2; losses finite; "
        f"{RAINBOW_CKPT} card vs CPU {fwd['noise off']:.2e} / "
        f"{fwd['noise on']:.2e} of the largest logit (noise off / on); one "
        f"update card vs CPU: Adam's step per leaf {ref['step_rel']:.2e} of "
        f"its largest (rtol {RAINBOW_STEP_RTOL}), every planted fault "
        f"above it (least {min(ref['planted'].values()):.2e}), loss "
        f"{ref['loss_rel']:.2e}, KL priorities {ref['priority_rel']:.2e}; "
        f"a pool-mode chunk's collection {pool_collect:.3f} s, "
        f"{added} transitions")
    return out


def _adam_steps(torch, opt):
    """The step each parameter took in ``opt``'s last ``torch.optim.Adam``
    step, from its state (torch's formula: ``lr / (1 - b1^t) * m /
    (sqrt(v) / sqrt(1 - b2^t) + eps)``), on the CPU."""
    adam = opt.adam
    group = adam.param_groups[0]
    b1, b2 = group["betas"]
    out = []
    for p in opt.params:
        s = adam.state[p]
        t = float(s["step"])
        denom = (s["exp_avg_sq"].sqrt() / math.sqrt(1 - b2 ** t)
                 + group["eps"])
        out.append((-group["lr"] / (1 - b1 ** t) * s["exp_avg"]
                    / denom).detach().cpu())
    return out


@contextlib.contextmanager
def _planted_rainbow(torch, rainbow, plant, dev):
    """While the block runs, Rainbow's update carries ``plant``: noise
    drawn per sample (the factorized sample of each row its own), or the
    projection without its clips (``tz`` unclamped, the interpolation
    kernel ``1 - |b - k|`` not cut at 0)."""
    real_fwd = rainbow.NoisyLinear.forward
    real_proj = rainbow._project_distribution
    gen = torch.Generator(dev).manual_seed(SEED + 13)
    f = rainbow._scale_noise

    def per_sample(self, x, noise=None):
        if noise is None:
            return real_fwd(self, x)
        n = x.shape[0]
        f_in = f(torch.randn(n, self.in_features, device=x.device,
                             generator=gen))
        f_out = f(torch.randn(n, self.out_features, device=x.device,
                              generator=gen))
        return (x @ self.w_mu + self.b_mu
                + ((x * f_in) @ self.w_sigma) * f_out
                + self.b_sigma * f_out)

    def unclipped(next_probs, rewards, not_done, cfg):
        z = cfg.support(next_probs.device)
        tz = rewards[:, None] + not_done[:, None] * cfg.gamma_n * z[None]
        dz = (cfg.v_max - cfg.v_min) / (cfg.num_atoms - 1)
        b = (tz - cfg.v_min) / dz
        k = torch.arange(cfg.num_atoms, dtype=torch.float32,
                         device=next_probs.device)
        w = 1.0 - torch.abs(b[:, :, None] - k[None, None, :])
        return torch.einsum("ns,nst->nt", next_probs, w)

    if plant == "per-sample noise":
        rainbow.NoisyLinear.forward = per_sample
    elif plant == "projection without the clip":
        rainbow._project_distribution = unclipped
    try:
        yield
    finally:
        rainbow.NoisyLinear.forward = real_fwd
        rainbow._project_distribution = real_proj


def _rainbow_update_reference(torch, trainer, rainbow, dev):
    """One ``rainbow_train_batch`` update of the trained agent on the
    trained replay, on the card and on the CPU from the same state: the
    rows the card samples, three noise vectors drawn on the card for both,
    the CPU replaying the card's ReLU masks and a* argmax.  Adam's step
    (``_adam_steps``) per leaf over the leaf's largest CPU step; each
    parameter held to the CPU's within the two steps' difference plus one
    float32 rounding of the parameter and of the step; the loss and the
    KL priorities to DQN_REF_RTOL.  Then the card's update with each
    planted fault (RAINBOW_PLANTS) must read above RAINBOW_STEP_RTOL."""
    from gymothelloenv_tpu_torch.agents import replay as rp
    from gymothelloenv_tpu_torch.train.self_play import InjectedDraws
    agent, cfg, rb_cfg = trainer.agent, trainer.dqn_cfg, trainer.rb_cfg
    cpu_agent = rainbow.rainbow_init(cfg, 0, "cpu")
    cpu_agent.net.load_state_dict(agent.net.state_dict())
    cpu_agent.target.load_state_dict(agent.target.state_dict())
    opt_state = copy.deepcopy(agent.optimizer.adam.state_dict())
    cpu_agent.optimizer.adam.load_state_dict(opt_state)
    params0 = [p.detach().clone() for p in agent.net.parameters()]
    names = [k for k, _ in agent.net.named_parameters()]
    gen = torch.Generator(dev).manual_seed(SEED + 12)
    u = torch.rand(cfg.batch_size, generator=gen, device=dev)
    noise = [torch.randn(agent.net.noise_size, generator=gen, device=dev)
             for _ in range(3)]
    replay = trainer.replay
    card_replay = rp.Replay(**{k: v.clone() for k, v in
                               vars(replay).items()})
    cpu_replay = rp.Replay(**{k: v.cpu() for k, v in vars(replay).items()})
    idx = rp.replay_sample_idx(card_replay, rb_cfg, u)
    taken, masks, flips, relu_flips = [], [], [], []

    def update(a, r, record, d):
        """The update on ``a``; returns (loss, steps, params)."""
        draws = InjectedDraws((), (), replay_uniforms=[u.to(d)],
                              normals=[n.to(d) for n in noise])
        real = rainbow.replay_sample_idx
        rainbow.replay_sample_idx = lambda *args: idx.to(d)
        try:
            with _replay_argmax(torch, taken, record, flips), \
                    _relu_masks(torch, masks, record, relu_flips):
                loss = rainbow.rainbow_train_batch(a, r, cfg, rb_cfg, draws)
        finally:
            rainbow.replay_sample_idx = real
        return (float(loss), _adam_steps(torch, a.optimizer),
                [p.detach().cpu().clone() for p in a.net.parameters()])

    loss, step_card, p_card = update(agent, card_replay, True, dev)
    loss_c, step_cpu, p_cpu = update(cpu_agent, cpu_replay, False, "cpu")
    n_flips, n_relu = sum(flips), sum(relu_flips)    # the CPU's replay

    def step_rel(steps):
        out = {}
        for k, s, w in zip(names, steps, step_cpu):
            big = float(w.abs().max())
            require(big > 0, f"[rainbow] the reference update did not "
                    f"move {k}")
            out[k] = float((s - w).abs().max()) / big
        return out
    rel = step_rel(step_card)
    worst = max(rel, key=rel.get)
    # The steps are recomputed from Adam's state, so each may sit one
    # rounding from the one applied: a float32 spacing of each parameter
    # and of each step.
    param_excess = max(float(((a - b).abs() - (sa - sb).abs()
                              - 2.0 ** -22 * (b.abs() + sb.abs())).max())
                       for a, b, sa, sb in zip(p_card, p_cpu, step_card,
                                               step_cpu))
    lerr = abs(loss - loss_c) / max(abs(loss_c), 1e-12)
    rows = idx.cpu()
    perr = float(((card_replay.priority.cpu()[rows]
                   - cpu_replay.priority[rows]).abs()
                  / cpu_replay.priority[rows].clamp(min=1e-12)).max())
    planted = {}
    for plant in RAINBOW_PLANTS:
        with torch.no_grad():
            for p, p0 in zip(agent.net.parameters(), params0):
                p.copy_(p0)
        agent.optimizer.adam.load_state_dict(copy.deepcopy(opt_state))
        scratch = rp.Replay(**{k: v.clone() for k, v in
                               vars(replay).items()})
        with _planted_rainbow(torch, rainbow, plant, dev):
            planted[plant] = max(step_rel(update(agent, scratch, False,
                                                 dev)[1]).values())
    say(f"[rainbow] one update: the CPU's Adam step per leaf up to "
        f"{max(float(w.abs().max()) for w in step_cpu):.3e}; card vs CPU "
        f"per leaf {rel[worst]:.3e} ({worst}); planted faults on the card: "
        + ", ".join(f"{k} {v:.3e}" for k, v in planted.items())
        + f"; {n_flips} of {cfg.batch_size} a* and {n_relu} ReLU units "
        "the CPU's own arithmetic would change")
    require(rel[worst] <= RAINBOW_STEP_RTOL, f"[rainbow] one update: the "
            f"step of {worst} differs by {rel[worst]:.3e} of its largest")
    require(param_excess <= 0, f"[rainbow] one update: a parameter "
            f"differs by {param_excess:.3e} more than its step and one "
            "rounding")
    for plant, reading in planted.items():
        require(reading > RAINBOW_STEP_RTOL, f"[rainbow] the planted fault "
                f"'{plant}' reads {reading:.3e}, inside {RAINBOW_STEP_RTOL}")
    require(lerr <= DQN_REF_RTOL and perr <= DQN_REF_RTOL, f"[rainbow] one "
            f"update: loss {lerr:.3e}, priorities {perr:.3e} (rtol "
            f"{DQN_REF_RTOL})")
    return dict(step_rel=rel[worst], worst_leaf=worst, planted=planted,
                loss_rel=lerr, priority_rel=perr, argmax_flips=n_flips,
                relu_flips=n_relu)


@contextlib.contextmanager
def _replay_sample(torch, taken, record, flips):
    """As ``_replay_argmax`` for ``MaskedCategorical.sample`` (the Fisher
    sample of ACKTR's update)."""
    from gymothelloenv_tpu_torch.models.distributions import \
        MaskedCategorical
    real, replayed = MaskedCategorical.sample, iter(taken)

    def sample(self, *args, **kwargs):
        got = real(self, *args, **kwargs)
        if record:
            taken.append(got)
            return got
        want = next(replayed).to(got.device)
        flips.append(int((want != got).sum()))
        return want

    MaskedCategorical.sample = sample
    try:
        yield
    finally:
        MaskedCategorical.sample = real


def _rel_steps(what, names, card, cpu, rtol):
    """Per leaf: the card's step less the CPU's over the CPU's largest;
    requires each within ``rtol`` and returns the worst."""
    rel = {}
    for k, s, w in zip(names, card, cpu):
        big = float(w.abs().max())
        require(big > 0, f"[{what}] the reference update did not move {k}")
        rel[k] = float((s.cpu() - w).abs().max()) / big
    worst = max(rel, key=rel.get)
    require(rel[worst] <= rtol, f"[{what}] one update: the step of {worst} "
            f"differs by {rel[worst]:.3e} of its largest > {rtol}")
    return worst, rel[worst]


def _a2c_phase(torch, tb, legal_mask, step, dev):
    """cli.a2c_train at RESULTS.md's A2C configuration (N A2C_ENVS, T
    A2C_STEPS, lr 7e-4, entropy 0.01, GAE) for A2C_UPDATES updates and the
    final 400-game evaluation: one B1 launch a BitEngine ply, no plain
    ply, no K2, finite losses; then one a2c_update card vs CPU on a fresh
    rollout of the trained net (the CPU replaying the card's ReLU masks):
    the RMSprop step per leaf (``-lr g / sqrt(nu + eps)`` from the clipped
    gradient and the new ``nu``) within A2C_STEP_RTOL of the leaf's
    largest."""
    from gymothelloenv_tpu_torch.agents import a2c
    from gymothelloenv_tpu_torch.cli import a2c_train
    from gymothelloenv_tpu_torch.core.engine import BitEngine
    from gymothelloenv_tpu_torch.train.self_play import collect_rollout
    say(f"[a2c] start: a2c_train --num-envs {A2C_ENVS} --num-steps "
        f"{A2C_STEPS} --use-gae --num-updates {A2C_UPDATES}; one update "
        "card vs CPU")
    with tempfile.TemporaryDirectory() as tmp:
        _zero_counts(legal_mask, step)
        t0 = time.perf_counter()
        with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as calls:
            trainer = a2c_train.main([
                "--num-envs", str(A2C_ENVS), "--num-steps", str(A2C_STEPS),
                "--use-gae", "--num-updates", str(A2C_UPDATES),
                "--log-every", "1", "--test-interval", str(10 ** 9),
                "--num-test-games", str(TRAIN_TEST_GAMES), "--seed",
                str(SEED), "--log-dir", tmp, "--device", DEVICE_TYPE])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(legal_mask, step)
        records = _read_metrics(tmp)
    require(len(records) == A2C_UPDATES and all(
        math.isfinite(m[k]) for m in records
        for k in ("value_loss", "action_loss", "entropy")),
        "[a2c] an update was skipped or a loss is not finite")
    require(counts["bit_step_launches"] == calls["step_where"] > 0
            and counts["reset_launches"] == calls["reset_where"],
            f"[a2c] {counts} for {calls}")
    _require_no_k2(counts["k2_launches"], "a2c")
    require(not plain_calls, f"[a2c] ran a plain ply: {plain_calls[:3]}")

    # One update card vs CPU on a fresh rollout of the trained net.
    run = trainer.run_cfg
    _, rollout, boot = collect_rollout(trainer.net, trainer.sp_state,
                                       trainer.env_cfg, run.num_steps,
                                       trainer.draws)
    net_cpu = copy.deepcopy(trainer.net).to("cpu")
    opt_cpu = a2c.make_a2c_optimizer(trainer.a2c_cfg, net_cpu.parameters())
    for d, s in zip(opt_cpu.rms.nu, trainer.optimizer.rms.nu):
        d.copy_(s.cpu())
    masks, flips = [], []

    def update(net, opt, roll, bt, record):
        with _relu_masks(torch, masks, record, flips):
            m = a2c.a2c_update(net, opt, roll, bt, trainer.a2c_cfg)
        rms = opt.rms
        return m, [(torch.rsqrt(nu + rms.eps) * p.grad * -rms.lr).cpu()
                   for p, nu in zip(rms.params, rms.nu)]
    m_card, s_card = update(trainer.net, trainer.optimizer, rollout, boot,
                            True)
    roll_cpu = type(rollout)(**{k: v.cpu() for k, v in
                                vars(rollout).items()})
    m_cpu, s_cpu = update(net_cpu, opt_cpu, roll_cpu, boot.cpu(), False)
    names = [k for k, _ in trainer.net.named_parameters()]
    worst, rel = _rel_steps("a2c", names, s_card, s_cpu, A2C_STEP_RTOL)
    _check_metrics({k: float(v) for k, v in m_card.items()},
                   {k: float(v) for k, v in m_cpu.items()})
    out = dict(counts, wall_seconds=wall, plies=calls["step_where"],
               collect_seconds=[m["collect_seconds"] for m in records],
               update_seconds=[m["update_seconds"] for m in records],
               transitions_per_sec=[m["transitions_per_sec"]
                                    for m in records],
               update=dict(step_rel=rel, worst_leaf=worst,
                           relu_flips=sum(flips)))
    say(f"[a2c] ok: {A2C_UPDATES} updates and the final evaluation in "
        f"{wall:.2f} s; collect " + ", ".join(
            f"{x:.3f}" for x in out["collect_seconds"]) + " s, update "
        + ", ".join(f"{x:.3f}" for x in out["update_seconds"])
        + f" s; {calls['step_where']} plies, {counts['bit_step_launches']} "
        f"B1 launches, no K2; one update card vs CPU: the step per leaf "
        f"{rel:.2e} of its largest ({worst}; rtol {A2C_STEP_RTOL}), "
        f"{sum(flips)} ReLU units the CPU's own arithmetic would change")
    return out


def _acktr_phase(torch, tb, legal_mask, step, dev):
    """cli.acktr_train at JAX job 08b's configuration (--net conv, N
    ACKTR_ENVS, T ACKTR_STEPS, entropy 0.05, kl-clip 0.001) for
    ACKTR_UPDATES updates, two of them refreshing the eigendecompositions,
    and the final 400-game evaluation: one B1 launch a BitEngine ply, no
    plain ply, no K2, finite losses.  Then one acktr_update card vs CPU on
    a fresh rollout, its K-FAC step count set to a refresh step (20): the
    Fisher sample's uniforms and the critic's normals drawn on the card
    for both, the CPU replaying the card's sampled actions and ReLU masks;
    each parameter's step less the momentum it carried (``lr`` times the
    scaled natural gradient) within ACKTR_STEP_RTOL of the leaf's
    largest.  Then ACKTR_MLP_UPDATES updates of --net mlp."""
    from gymothelloenv_tpu_torch.agents import kfac
    from gymothelloenv_tpu_torch.agents.a2c import A2CConfig, a2c_returns
    from gymothelloenv_tpu_torch.cli import acktr_train
    from gymothelloenv_tpu_torch.core.engine import BitEngine
    from gymothelloenv_tpu_torch.train.self_play import (InjectedDraws,
                                                         collect_rollout)
    say(f"[acktr] start: acktr_train --net conv --num-envs {ACKTR_ENVS} "
        f"--num-steps {ACKTR_STEPS} --entropy-coef 0.05 --kl-clip 0.001 "
        f"--num-updates {ACKTR_UPDATES}; one update card vs CPU on a "
        f"refresh step; {ACKTR_MLP_UPDATES} updates of --net mlp")
    base = ["--num-envs", str(ACKTR_ENVS), "--num-steps", str(ACKTR_STEPS),
            "--entropy-coef", "0.05", "--kl-clip", "0.001", "--log-every",
            "1", "--test-interval", str(10 ** 9), "--num-test-games",
            str(TRAIN_TEST_GAMES), "--seed", "32", "--device", DEVICE_TYPE]
    runs, total = {}, dict(k2_launches=0, bit_step_launches=0,
                           reset_launches=0)
    for net, n_up in (("conv", ACKTR_UPDATES), ("mlp", ACKTR_MLP_UPDATES)):
        with tempfile.TemporaryDirectory() as tmp:
            _zero_counts(legal_mask, step)
            t0 = time.perf_counter()
            with _no_plain(tb) as plain_calls, \
                    _count_plies(BitEngine) as calls:
                trainer = acktr_train.main(base + [
                    "--net", net, "--num-updates", str(n_up), "--log-dir",
                    tmp])
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts(legal_mask, step)
            records = _read_metrics(tmp)
        require(len(records) == n_up and all(
            math.isfinite(m[k]) for m in records
            for k in ("value_loss", "action_loss", "entropy")),
            f"[acktr] {net}: an update was skipped or a loss is not finite")
        require(trainer.agent.kfac_actor.step == n_up
                and trainer.agent.conv == (net == "conv"),
                f"[acktr] {net}: K-FAC step {trainer.agent.kfac_actor.step}")
        require(counts["bit_step_launches"] == calls["step_where"] > 0
                and counts["reset_launches"] == calls["reset_where"],
                f"[acktr] {net}: {counts} for {calls}")
        _require_no_k2(counts["k2_launches"], f"acktr {net}")
        require(not plain_calls, f"[acktr] {net} ran a plain ply")
        for k in total:
            total[k] += counts[k]
        runs[net] = dict(wall_seconds=wall, plies=calls["step_where"],
                         collect_seconds=[m["collect_seconds"]
                                          for m in records],
                         update_seconds=[m["update_seconds"]
                                         for m in records])
        if net == "conv":
            conv = trainer

    # One update card vs CPU on a refresh step.
    agent, cfg = conv.agent, conv.acktr_cfg
    run = conv.run_cfg
    _, rollout, boot = collect_rollout(agent, conv.sp_state, conv.env_cfg,
                                       run.num_steps, conv.draws)
    returns = a2c_returns(rollout, boot, A2CConfig(gamma=cfg.gamma))
    k = returns.numel()
    rows = (rollout.obs.reshape((k,) + rollout.obs.shape[2:]),
            rollout.legal.reshape(k, -1), rollout.action.reshape(k),
            returns.reshape(k))
    for state in (agent.kfac_actor, agent.kfac_critic):
        state.step = 2 * cfg.t_inv
    cpu = copy.deepcopy(agent).to("cpu")
    gen = torch.Generator(dev).manual_seed(SEED + 14)
    u = 1.0 - torch.rand(k, generator=gen, device=dev)
    normals = torch.randn(k, generator=gen, device=dev)
    taken, masks, flips, relu_flips = [], [], [], []

    def update(a, d, record):
        """The update on ``a``; returns (metrics, steps): each leaf's
        step less the momentum it carried, ``lr * (buf - m buf_before)``,
        the natural gradient's part."""
        draws = InjectedDraws((), [u.to(d)], normals=[normals.to(d)])
        layers = a.kfac_actor.layers + a.kfac_critic.layers
        before = [ls.momentum.clone() for ls in layers]
        with _replay_sample(torch, taken, record, flips), \
                _relu_masks(torch, masks, record, relu_flips):
            m = kfac.acktr_update(a, *(r.to(d) for r in rows), cfg, draws)
        steps = []
        for ls, b in zip(layers, before):
            s = (cfg.lr * (ls.momentum - cfg.momentum * b)).cpu()
            steps += [s[:-1], s[-1]]
        return m, steps
    m_card, s_card = update(agent, dev, True)
    m_cpu, s_cpu = update(cpu, "cpu", False)
    names = [f"{tower}.{i}.{leaf}" for tower in ("actor", "critic")
             for i in range(len(agent.actor.specs)) for leaf in ("w", "b")]
    worst, rel = _rel_steps("acktr", names, s_card, s_cpu,
                            ACKTR_STEP_RTOL)
    _check_metrics({k: float(v) for k, v in m_card.items()},
                   {k: float(v) for k, v in m_cpu.items()})
    out = dict(total, runs=runs, plies=sum(r["plies"] for r in
                                           runs.values()),
               update=dict(step_rel=rel, worst_leaf=worst,
                           sample_flips=sum(flips),
                           relu_flips=sum(relu_flips)))
    for net, r in runs.items():
        say(f"[acktr] --net {net}: collect " + ", ".join(
            f"{x:.3f}" for x in r["collect_seconds"]) + " s, update "
            + ", ".join(f"{x:.3f}" for x in r["update_seconds"])
            + f" s; {r['wall_seconds']:.2f} s with the final evaluation")
    say(f"[acktr] ok: {out['plies']} plies, {total['bit_step_launches']} "
        f"B1 launches, no K2; losses finite; one update card vs CPU on a "
        f"refresh step: the step per leaf {rel:.2e} of its largest "
        f"({worst}; rtol {ACKTR_STEP_RTOL}); {sum(flips)} Fisher actions "
        f"and {sum(relu_flips)} ReLU units the CPU's own arithmetic would "
        "change")
    return out


def _to_device(obj, device):
    """A copy of ``obj`` with every tensor moved to ``device``, through
    dataclasses, lists, tuples and dicts."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, torch.nn.Module):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return obj


class _RecordedDraws:
    """A draws object that keeps every tensor it hands out, by kind, for
    the CPU to replay (``injected``)."""

    KINDS = ("colors", "uniforms", "rand_left", "legal_index",
             "replay_uniforms", "normals", "row_indices", "mix_uniforms")

    def __init__(self, inner):
        self.inner = inner
        self.log = {k: [] for k in self.KINDS}

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        # A noisy net's noise replays as InjectedDraws' normals.
        kind = "normals" if name == "noise" else name
        if kind not in self.KINDS:
            return fn

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.log[kind].append(out)
            return out
        return recorded

    def injected(self, device):
        from gymothelloenv_tpu_torch.train.self_play import InjectedDraws
        return InjectedDraws(**{k: [t.to(device) for t in v]
                                for k, v in self.log.items()})


def _delta_rel(what, names, before, card, cpu_before, cpu, rtol):
    """Per leaf: the card's delta less the CPU's, beyond one float32
    spacing of the parameter (each side's ``p + u`` rounds to its own
    spacing), over the CPU's largest delta; requires each within
    ``rtol`` and returns ``(worst leaf, reading)``.  A leaf the CPU's
    update leaves unchanged must stay unchanged on the card."""
    rel = {}
    for k, b, c, bc, w in zip(names, before, card, cpu_before, cpu):
        d_card, d_cpu = (c - b).cpu(), w - bc
        big = float(d_cpu.abs().max())
        if big == 0:
            require(not bool(d_card.any()), f"[{what}] {k} moved on the "
                    "card only")
            continue
        excess = (d_card - d_cpu).abs() - 2.0 ** -22 * w.abs()
        rel[k] = max(float(excess.max()), 0.0) / big
    worst = max(rel, key=rel.get)
    require(rel[worst] <= rtol, f"[{what}] card vs CPU: the delta of "
            f"{worst} differs by {rel[worst]:.3e} of its largest > {rtol}")
    return worst, rel[worst]


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


def _simple_ppo_phase(torch, tb, legal_mask, step, dev):
    """cli.run_self_play at its defaults (N SP_ENVS, T SP_STEPS) for
    SP_UPDATES updates and the final 200-game evaluations: one B1 launch a
    BitEngine ply, no plain ply, no K2, finite losses; then one
    simple_ppo_update card vs CPU on a fresh rollout of the trained net
    (Adam at REF_EPS on both sides; the CPU replaying the card's epoch
    permutations and ReLU masks), each delta to SP_REF_RTOL of its leaf's
    largest."""
    from gymothelloenv_tpu_torch.agents import simple_ppo
    from gymothelloenv_tpu_torch.agents.ppo import Adam
    from gymothelloenv_tpu_torch.cli import run_self_play
    from gymothelloenv_tpu_torch.core.engine import BitEngine
    from gymothelloenv_tpu_torch.train.self_play import collect_rollout
    say(f"[simple_ppo] start: run_self_play --num-envs {SP_ENVS} "
        f"--num-steps {SP_STEPS} --num-updates {SP_UPDATES}; one update "
        "card vs CPU")
    with tempfile.TemporaryDirectory() as tmp:
        _zero_counts(legal_mask, step)
        t0 = time.perf_counter()
        with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as calls:
            trainer = run_self_play.main([
                "--num-envs", str(SP_ENVS), "--num-steps", str(SP_STEPS),
                "--num-updates", str(SP_UPDATES), "--log-every", "1",
                "--test-interval", str(10 ** 9), "--num-test-games",
                str(TRAIN_TEST_GAMES), "--seed", str(SEED), "--log-dir",
                tmp, "--device", DEVICE_TYPE])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(legal_mask, step)
        records = _read_metrics(tmp)
    require(len(records) == SP_UPDATES
            and all(math.isfinite(m["loss"]) for m in records),
            "[simple_ppo] an update was skipped or a loss is not finite")
    require(counts["bit_step_launches"] == calls["step_where"] > 0
            and counts["reset_launches"] == calls["reset_where"] > 0,
            f"[simple_ppo] {counts} for {calls}")
    _require_no_k2(counts["k2_launches"], "simple_ppo")
    require(not plain_calls, f"[simple_ppo] ran a plain ply: "
            f"{plain_calls[:3]}")

    # One update card vs CPU on a fresh rollout of the trained net.
    cfg = trainer.ppo_cfg
    _, rollout, _ = collect_rollout(trainer.net, trainer.sp_state,
                                    trainer.env_cfg, SP_STEPS, trainer.draws,
                                    logp_mode="full")
    gen = torch.Generator().manual_seed(SEED + 21)
    perms = [torch.randperm(SP_ENVS * SP_STEPS, generator=gen)
             for _ in range(cfg.k_epochs)]
    net_cpu = copy.deepcopy(trainer.net).to("cpu")
    names = [k for k, _ in trainer.net.named_parameters()]
    before, before_cpu = _params(trainer.net), _params(net_cpu)
    masks, flips = [], []
    t0 = time.perf_counter()
    with _relu_masks(torch, masks, True, flips):
        loss = simple_ppo.simple_ppo_update(
            trainer.net, Adam(trainer.net.parameters(), cfg.lr,
                              eps=REF_EPS), rollout, cfg, perms)
        torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    with _relu_masks(torch, masks, False, flips):
        loss_cpu = simple_ppo.simple_ppo_update(
            net_cpu, Adam(net_cpu.parameters(), cfg.lr, eps=REF_EPS),
            _to_device(rollout, "cpu"), cfg, perms)
    worst, rel = _delta_rel("simple_ppo", names, before,
                            _params(trainer.net), before_cpu,
                            _params(net_cpu), SP_REF_RTOL)
    _check_metrics({"loss": float(loss)}, {"loss": float(loss_cpu)})
    out = dict(counts, wall_seconds=wall, plies=calls["step_where"],
               collect_seconds=[m["collect_seconds"] for m in records],
               update_seconds=[m["update_seconds"] for m in records],
               transitions_per_sec=[m["transitions_per_sec"]
                                    for m in records],
               update=dict(delta_rel=rel, worst_leaf=worst,
                           relu_flips=sum(flips), seconds=ref_s))
    say(f"[simple_ppo] ok: {SP_UPDATES} updates and the final evaluations "
        f"in {wall:.2f} s; collect " + ", ".join(
            f"{x:.3f}" for x in out["collect_seconds"]) + " s, update "
        + ", ".join(f"{x:.3f}" for x in out["update_seconds"])
        + f" s; {calls['step_where']} plies, {counts['bit_step_launches']} "
        f"B1 launches, {counts['reset_launches']} reset_where, no K2; one "
        f"update card vs CPU: the delta per leaf {rel:.2e} of its largest "
        f"({worst}; rtol {SP_REF_RTOL}), {sum(flips)} ReLU units the CPU's "
        "own arithmetic would change")
    return out


def _gail_phase(torch, tb, legal_mask, step, dev):
    """The port's expert script (GAIL_EXPERT_GAMES maximin-2 games, B1 in
    every step and every search level), then cli.gail_train at N
    GAIL_ENVS, T GAIL_STEPS with GAIL_BC BC steps and GAIL_UPDATES updates
    and its evaluations: one B1 launch a BitEngine ply, no plain ply, no
    K2, finite losses; then one discriminator step and one full update
    card vs CPU (module docstring)."""
    from gymothelloenv_tpu_torch.agents import gail
    from gymothelloenv_tpu_torch.agents.ppo import Adam, make_optimizer
    from gymothelloenv_tpu_torch.cli import gail_train
    from gymothelloenv_tpu_torch.core.engine import BitEngine
    from gymothelloenv_tpu_torch.scripts import make_expert_dataset
    from gymothelloenv_tpu_torch.train.gail_trainer import GAILPPOTrainer
    say(f"[gail] start: make_expert_dataset --games {GAIL_EXPERT_GAMES} "
        f"(maximin-2), gail_train --num-envs {GAIL_ENVS} --num-steps "
        f"{GAIL_STEPS} --bc-updates {GAIL_BC} --num-updates {GAIL_UPDATES}; "
        "one discriminator step and one update card vs CPU")
    with tempfile.TemporaryDirectory() as tmp:
        expert = os.path.join(tmp, "expert.npz")
        _zero_counts(legal_mask, step)
        t0 = time.perf_counter()
        with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as calls:
            make_expert_dataset.main([
                "--games", str(GAIL_EXPERT_GAMES), "--search-depth", "2",
                "--seed", str(SEED), "--out", expert, "--device",
                DEVICE_TYPE])
            torch.cuda.synchronize()
        expert_s = time.perf_counter() - t0
        ex_counts = _counts(legal_mask, step)
        require(ex_counts["bit_step_launches"] > calls["step_where"] > 0
                and not plain_calls, f"[gail] the expert script: "
                f"{ex_counts} for {calls}, plain {plain_calls[:3]}")
        _require_no_k2(ex_counts["k2_launches"], "gail expert")
        _zero_counts(legal_mask, step)
        t0 = time.perf_counter()
        with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as calls:
            trainer = gail_train.main([
                "--expert", expert, "--num-envs", str(GAIL_ENVS),
                "--num-steps", str(GAIL_STEPS), "--num-updates",
                str(GAIL_UPDATES), "--bc-updates", str(GAIL_BC),
                "--num-trajectories", str(GAIL_EXPERT_GAMES), "--log-every",
                "1", "--test-interval", str(10 ** 9), "--num-test-games",
                str(TRAIN_TEST_GAMES), "--seed", str(SEED), "--log-dir", tmp,
                "--device", DEVICE_TYPE])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts(legal_mask, step)
        records = [m for m in _read_metrics(tmp) if "disc_loss" in m]
        twin = GAILPPOTrainer(expert_path=expert, gail_run=trainer.gail_run,
                              env_cfg=trainer.env_cfg,
                              ppo_cfg=trainer.ppo_cfg,
                              run_cfg=trainer.run_cfg, device="cpu")
    require(len(records) == GAIL_UPDATES and all(
        math.isfinite(m[k]) for m in records
        for k in ("disc_loss", "gail_reward", "value_loss", "action_loss")),
        "[gail] an update was skipped or a loss is not finite")
    require(counts["bit_step_launches"] == calls["step_where"] > 0
            and counts["reset_launches"] == calls["reset_where"] > 0,
            f"[gail] {counts} for {calls}")
    _require_no_k2(counts["k2_launches"], "gail")
    require(not plain_calls, f"[gail] ran a plain ply: {plain_calls[:3]}")

    # One discriminator step card vs CPU from the trained discriminator.
    stack = trainer.sample_expert()
    g_state = trainer.gail_state
    names = [k for k, _ in g_state.net.named_parameters()]
    alpha = torch.rand(stack.shape[1], generator=torch.Generator(
        dev).manual_seed(SEED + 22), device=dev)

    def disc_step(state, device):
        state = dataclasses.replace(
            state, net=copy.deepcopy(state.net).to(device))
        state.optimizer = Adam(state.net.parameters(), 1e-3, eps=REF_EPS)
        from gymothelloenv_tpu_torch.train.self_play import InjectedDraws
        before = _params(state.net)
        gail.gail_discriminator_update(
            state, trainer.gail_cfg, stack[0].to(device),
            stack[1].to(device),
            InjectedDraws((), (), mix_uniforms=[alpha.to(device)]))
        return before, _params(state.net)
    b_card, a_card = disc_step(g_state, dev)
    b_cpu, a_cpu = disc_step(g_state, "cpu")
    d_worst, d_rel = _delta_rel("gail disc", names, b_card, a_card, b_cpu,
                                a_cpu, GAIL_REF_RTOL)

    # One full update card vs CPU from the trained state.
    twin.net.load_state_dict(trainer.net.state_dict())
    twin.gail_state = dataclasses.replace(
        _to_device(g_state, "cpu"), net=copy.deepcopy(g_state.net).cpu())
    twin.sp_state = _to_device(trainer.sp_state, "cpu")
    twin._last_done = trainer._last_done.cpu()
    ref_cfg = dataclasses.replace(trainer.ppo_cfg, adam_eps=REF_EPS)
    for t in (trainer, twin):
        t.optimizer = make_optimizer(ref_cfg, t.net.parameters())
        t.gail_state.optimizer = Adam(t.gail_state.net.parameters(), 1e-3,
                                      eps=REF_EPS)
    rec = _RecordedDraws(trainer.draws)
    trainer.draws = rec
    words = torch.randint(0, 2 ** 32, (trainer.ppo_cfg.ppo_epochs, 4),
                          generator=torch.Generator().manual_seed(SEED + 23))
    pnames = [k for k, _ in trainer.net.named_parameters()]
    before = (_params(trainer.net), _params(trainer.gail_state.net))
    before_cpu = (_params(twin.net), _params(twin.gail_state.net))
    masks, flips = [], []
    with _relu_masks(torch, masks, True, flips):
        m_card = trainer.gail_update(stack, words)
    twin.draws = rec.injected("cpu")
    with _relu_masks(torch, masks, False, flips):
        m_cpu = twin.gail_update(stack.cpu(), words)
    require(torch.equal(trainer.sp_state.pending.action.cpu(),
                        twin.sp_state.pending.action), "[gail] the card's "
            "and the CPU's collections took other actions")
    p_worst, p_rel = _delta_rel("gail policy", pnames, before[0],
                                _params(trainer.net), before_cpu[0],
                                _params(twin.net), GAIL_REF_RTOL)
    u_worst, u_rel = _delta_rel("gail update disc", names, before[1],
                                _params(trainer.gail_state.net),
                                before_cpu[1], _params(twin.gail_state.net),
                                GAIL_REF_RTOL)
    # The return accumulator (one per game) over its largest magnitude.
    r_err = float((trainer.gail_state.returns.cpu()
                   - twin.gail_state.returns).abs().max()
                  / twin.gail_state.returns.abs().max())
    require(r_err <= GAIL_REF_RTOL, f"[gail] the return accumulator card vs "
            f"CPU: {r_err:.3e} of its largest")
    _check_metrics({k: float(m_card[k]) for k in ("disc_loss", "gail_reward",
                                                 "value_loss")},
                   {k: float(m_cpu[k]) for k in ("disc_loss", "gail_reward",
                                                "value_loss")})
    out = dict(counts, wall_seconds=wall, plies=calls["step_where"],
               expert_seconds=expert_s, expert_counts=ex_counts,
               expert_launches=ex_counts["bit_step_launches"],
               expert_rows=len(trainer.expert),
               **{k: [m[k] for m in records] for k in (
                   "collect_seconds", "disc_seconds", "relabel_seconds",
                   "update_seconds", "transitions_per_sec")},
               disc_step=dict(delta_rel=d_rel, worst_leaf=d_worst),
               update=dict(policy_rel=p_rel, policy_worst=p_worst,
                           disc_rel=u_rel, disc_worst=u_worst,
                           returns_rel=r_err, relu_flips=sum(flips)))
    share = [(m["disc_seconds"] + m["relabel_seconds"])
             / sum(m[k] for k in ("collect_seconds", "disc_seconds",
                                  "relabel_seconds", "update_seconds"))
             for m in records]
    out["disc_relabel_share"] = share
    say(f"[gail] ok: expert data {len(trainer.expert)} rows from "
        f"{GAIL_EXPERT_GAMES} games in {expert_s:.2f} s "
        f"({ex_counts['bit_step_launches']} B1 launches); BC, "
        f"{GAIL_UPDATES} updates and the evaluations in {wall:.2f} s; "
        "collect " + ", ".join(f"{x:.3f}" for x in out["collect_seconds"])
        + " s, discriminator " + ", ".join(
            f"{x:.3f}" for x in out["disc_seconds"]) + " s, relabel "
        + ", ".join(f"{x:.3f}" for x in out["relabel_seconds"])
        + " s, PPO update " + ", ".join(
            f"{x:.3f}" for x in out["update_seconds"]) + " s (discriminator "
        "and relabel " + ", ".join(f"{100 * x:.1f}%" for x in share)
        + f" of an update); {calls['step_where']} plies, "
        f"{counts['bit_step_launches']} B1 launches, no K2; card vs CPU: a "
        f"discriminator step {d_rel:.2e} ({d_worst}), a full update's "
        f"policy {p_rel:.2e} ({p_worst}) and discriminator {u_rel:.2e} "
        f"({u_worst}) of each leaf's largest delta, the return accumulator "
        f"{r_err:.2e} of its largest (rtol {GAIL_REF_RTOL}); {sum(flips)} "
        "ReLU units the "
        "CPU's own arithmetic would change")
    return out


def _compat_phase(torch, tb, legal_mask, step, dev):
    """The reference-API layer on the card: COMPAT_GAMES seeded cli.run
    games (maximin-1 against the seeded random policy) through OthelloEnv,
    one B1 launch an env ply, the same W/D/L and transcript as on the
    CPU; ms a SimpleOthelloEnv ply; a .pth of the vendored Policy's
    architecture written by torch.save, imported on the card (its forward
    to COMPAT_FWD_ATOL of the module's) and played by
    cli.eval_checkpoint against greedy."""
    import io
    import numpy as np
    from torch import nn
    from gymothelloenv_tpu_torch.cli import eval_checkpoint, run
    from gymothelloenv_tpu_torch.compat import envs
    from gymothelloenv_tpu_torch.compat.torch_import import (
        detect_and_import, load_torch_checkpoint)
    from gymothelloenv_tpu_torch.core.engine import BitEngine
    say(f"[compat] start: {COMPAT_GAMES} seeded cli.run games (maximin-1 "
        "vs rand) on the card and the CPU; a SimpleOthelloEnv game's plies; "
        f"a .pth of the vendored Policy vs greedy over {COMPAT_EVAL_GAMES} "
        "games")
    plies = {"n": 0}
    real_step = envs.OthelloBaseEnv.step

    def counted(self, action):
        plies["n"] += 1
        return real_step(self, action)

    def games(device):
        np.random.seed(SEED)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            wdl = run.play(-1, "maximin", "rand", num_rounds=COMPAT_GAMES,
                           protagonist_search_depth=1, rand_seed=SEED,
                           env_init_rand_steps=4, render=False,
                           device=device)
        return wdl, buf.getvalue()
    envs.OthelloBaseEnv.step = counted
    try:
        _zero_counts(legal_mask, step)
        t0 = time.perf_counter()
        with _no_plain(tb) as plain_calls:
            wdl, text = games(dev)
            torch.cuda.synchronize()
        games_s = time.perf_counter() - t0
        counts = _counts(legal_mask, step)
        env_plies = plies["n"]
    finally:
        envs.OthelloBaseEnv.step = real_step
    wdl_cpu, text_cpu = games("cpu")
    require(wdl == wdl_cpu and text == text_cpu and sum(wdl) == COMPAT_GAMES,
            f"[compat] card {wdl} vs CPU {wdl_cpu}")
    require(counts["bit_step_launches"] == env_plies > 0 and not plain_calls,
            f"[compat] {counts} for {env_plies} env plies, plain "
            f"{plain_calls[:3]}")
    _require_no_k2(counts["k2_launches"], "compat")
    env = envs.SimpleOthelloEnv(mute=True, device=dev)
    env.reset()
    rng = np.random.RandomState(SEED)
    ply_ms = []
    while len(ply_ms) < COMPAT_PLIES:
        if env.env.terminated:
            env.reset()
        moves = env.possible_moves
        t0 = time.perf_counter()
        env.step(moves[rng.randint(len(moves))])
        ply_ms.append(1e3 * (time.perf_counter() - t0))

    class RefPolicy(nn.Module):
        """The vendored Policy (CNNBase + critic_linear + dist.linear,
        model.py:288-314), as a reference checkpoint holds it."""

        def __init__(self):
            super().__init__()
            self.base = nn.Module()
            self.base.main = nn.Sequential(
                nn.Conv2d(4, 32, 3, stride=2, padding=1), nn.ReLU(),
                nn.Conv2d(32, 64, 2), nn.ReLU(), nn.Conv2d(64, 64, 2),
                nn.ReLU(), nn.Flatten(), nn.Linear(256, 512), nn.ReLU())
            self.base.critic_linear = nn.Linear(512, 1)
            self.dist = nn.Module()
            self.dist.linear = nn.Linear(512, 64)

        def forward(self, x):
            h = self.base.main(x)
            return self.dist.linear(h), self.base.critic_linear(h)[:, 0]
    torch.manual_seed(SEED)
    ref = RefPolicy().to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref_policy.pth")
        torch.save(ref.state_dict(), path)
        kind, net = detect_and_import(load_torch_checkpoint(path),
                                      device=dev)
        x = (torch.rand(256, 4, 8, 8, generator=torch.Generator(
            dev).manual_seed(SEED), device=dev) < 0.4).float()
        with torch.no_grad():
            err = max(float((a - b).abs().max())
                      for a, b in zip(net(x), ref(x)))
        require(kind == "policy" and err <= COMPAT_FWD_ATOL,
                f"[compat] the imported {kind} net vs its module: {err:.3e}")
        _zero_counts(legal_mask, step)
        with _no_plain(tb) as plain_calls, _count_plies(BitEngine) as calls, \
                contextlib.redirect_stdout(io.StringIO()) as out:
            w, d, l = eval_checkpoint.main([
                "--load", path, "--opponent", "greedy", "--games",
                str(COMPAT_EVAL_GAMES), "--seed", str(SEED), "--device",
                DEVICE_TYPE])
            torch.cuda.synchronize()
        eval_counts = _counts(legal_mask, step)
    require(w + d + l == COMPAT_EVAL_GAMES and "architecture: policy"
            in out.getvalue(), "[compat] the .pth evaluation")
    require(eval_counts["bit_step_launches"] == calls["step_where"] > 0
            and not plain_calls, f"[compat] eval {eval_counts} for {calls}")
    _require_no_k2(eval_counts["k2_launches"], "compat eval")
    total = dict(k2_launches=counts["k2_launches"]
                 + eval_counts["k2_launches"],
                 bit_step_launches=counts["bit_step_launches"]
                 + eval_counts["bit_step_launches"],
                 reset_launches=counts["reset_launches"]
                 + eval_counts["reset_launches"])
    out = dict(total, plies=env_plies, games_seconds=games_s, wdl=wdl,
               ms_a_ply=statistics.median(ply_ms[1:]),
               ms_a_ply_range=(min(ply_ms[1:]), max(ply_ms[1:])),
               forward_err=err, eval_wdl=(w, d, l),
               eval_launches=eval_counts["bit_step_launches"])
    say(f"[compat] ok: {COMPAT_GAMES} cli.run games W/D/L {wdl} in "
        f"{games_s:.2f} s, {env_plies} env plies = "
        f"{counts['bit_step_launches']} B1 launches, card = CPU transcript; "
        f"a SimpleOthelloEnv ply {out['ms_a_ply']:.3f} ms (median of "
        f"{COMPAT_PLIES - 1}, {out['ms_a_ply_range'][0]:.3f}-"
        f"{out['ms_a_ply_range'][1]:.3f}); the .pth policy's forward "
        f"{err:.2e} from its module, vs greedy {w}/{d}/{l} with "
        f"{eval_counts['bit_step_launches']} B1 launches, no K2")
    return out


def _cli_phase(torch, tb, legal_mask, step, dev):
    """The remaining CLIs and utilities on the card: cli.replay of the
    committed wide2 net (--deterministic) against maximin-2, its page
    equal to a CPU run's and one B1 launch a ply; one cli.enjoy episode
    of the net against greedy with --live-html, its transcript equal to a
    CPU run's; cli.sweep --format script; a utils.profiling.trace of one
    wide2 PPO update (N CLI_TRACE_ENVS, T CLI_TRACE_STEPS) whose
    summarize_trace names B1 (bit_step_kernel) and the update's kernels;
    cli.visualize.load_run on that run's metrics.jsonl, and its plot
    where matplotlib is installed."""
    import io
    from gymothelloenv_tpu_torch.agents.ppo import PPOConfig
    from gymothelloenv_tpu_torch.cli import enjoy, replay, sweep, visualize
    from gymothelloenv_tpu_torch.train.ppo_trainer import (
        PPOSelfPlayTrainer, SelfPlayConfig)
    from gymothelloenv_tpu_torch.utils import profiling
    from gymothelloenv_tpu_torch.utils.logging import MetricsLogger
    ckpt = os.path.join(HERE, TS_TEACHER)
    say(f"[cli] start: replay net:{TS_TEACHER} vs maximin-2, enjoy vs "
        f"greedy with --live-html, sweep, a traced wide2 update (N "
        f"{CLI_TRACE_ENVS}, T {CLI_TRACE_STEPS}), visualize.load_run")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--black", f"net:{ckpt}", "--white", "maximin-2",
                "--deterministic", "--seed", str(SEED)]
        pages = {}
        for device in (DEVICE_TYPE, "cpu"):
            path = os.path.join(tmp, f"replay_{device}.html")
            _zero_counts(legal_mask, step)
            with _no_plain(tb) as plain_calls, \
                    contextlib.redirect_stdout(io.StringIO()):
                frames = replay.main(argv + ["--device", device, "--out",
                                             path])
            if device == DEVICE_TYPE:
                torch.cuda.synchronize()
                counts = _counts(legal_mask, step)
                replay_plain = list(plain_calls)
            with open(path) as f:
                pages[device] = f.read()
        plies = len(frames) - 1
        require(pages[DEVICE_TYPE] == pages["cpu"],
                "[cli] the replay page on the card differs from the CPU's")
        require(counts["bit_step_launches"] == plies > 0,
                f"[cli] replay: {counts} for {plies} plies")
        _require_no_k2(counts["k2_launches"], "replay")
        require(not replay_plain, f"[cli] replay ran a plain ply: "
                f"{replay_plain[:3]}")
        out.update(replay_plies=plies, replay_counts=counts,
                   replay_final=frames[-1][3])

        live = os.path.join(tmp, "live.html")
        texts = {}
        for device in (DEVICE_TYPE, "cpu"):
            _zero_counts(legal_mask, step)
            with contextlib.redirect_stdout(io.StringIO()) as text:
                rewards = enjoy.main([
                    "--load", ckpt, "--opponent", "greedy",
                    "--deterministic", "--seed", str(SEED), "--device",
                    device, "--live-html", live])
            if device == DEVICE_TYPE:
                torch.cuda.synchronize()
                enjoy_counts = _counts(legal_mask, step)
            texts[device] = text.getvalue().replace(live, "LIVE")
        lines = texts[DEVICE_TYPE].splitlines()
        enjoy_plies = sum(" plays " in x for x in lines)
        require(texts[DEVICE_TYPE] == texts["cpu"],
                "[cli] the enjoy transcript on the card differs from the "
                "CPU's")
        with open(live) as f:
            page = f.read()
        require("game over" in page, "[cli] enjoy's live page is not the "
                "game-over page")
        require(enjoy_counts["bit_step_launches"] >= enjoy_plies > 0,
                f"[cli] enjoy: {enjoy_counts} for {enjoy_plies} plies")
        _require_no_k2(enjoy_counts["k2_launches"], "enjoy")
        out.update(enjoy_plies=enjoy_plies, enjoy_counts=enjoy_counts,
                   enjoy_reward=rewards[0])

        with contextlib.redirect_stdout(io.StringIO()):
            cmds = sweep.main(["--trainer", "ppo_self_play", "--num-seeds",
                               "2", "--out-dir", os.path.join(tmp, "sweep"),
                               "--", "--num-updates", "1"])
        with open(os.path.join(tmp, "sweep", "run_all.sh")) as f:
            script = f.read()
        require(script.count("gymothelloenv_tpu_torch.cli.ppo_self_play")
                == len(cmds) == 2 and "sleep" not in script,
                "[cli] the sweep script is not two runs without a pause")

        run_dir, trace_dir = (os.path.join(tmp, d) for d in ("run", "trace"))
        with MetricsLogger(run_dir, also_print=False) as log:
            trainer = PPOSelfPlayTrainer(
                ppo_cfg=PPOConfig(lr=TRAIN_LR, entropy_coef=TRAIN_ENTROPY,
                                  num_updates=10),
                run_cfg=SelfPlayConfig(
                    num_envs=CLI_TRACE_ENVS, num_steps=CLI_TRACE_STEPS,
                    width_mult=WIDTH_MULT, hidden_size=HIDDEN,
                    test_interval=10 ** 9, seed=SEED),
                log_fn=log.log, device=DEVICE_TYPE)
            trainer.train(1, log_every=1)
            timer = profiling.StepTimer(warmup=0)
            _zero_counts(legal_mask, step)
            with profiling.trace(trace_dir), \
                    timer.measure(list(trainer.net.parameters())):
                trainer.train(1, log_every=1)
            traced = _counts(legal_mask, step)
        ops = profiling.summarize_trace(trace_dir)
        names = [o.name for o in ops]
        # csrc/step.cu's kernels sit in an anonymous namespace.
        b1 = sum(o.count for o in ops if "bit_step_kernel" in o.name)
        update = [o for o in ops if "bit_step_kernel" not in o.name]
        backward = [o for o in update if "backward" in o.op]
        require(b1 == traced["bit_step_launches"] > 0,
                f"[cli] the trace holds {b1} bit_step_kernel runs for "
                f"{traced['bit_step_launches']} B1 launches")
        require(len(update) >= 3 and sum(o.total_us for o in update) > 0,
                f"[cli] the trace names too few of the update's kernels: "
                f"{names[:20]}")
        say("[cli] summarize_trace of one traced update:\n"
            + profiling.format_op_table(ops, top=12))
        series = visualize.load_run(run_dir)
        require(len(series["value_loss"][0]) == 2 and all(
            math.isfinite(v) for v in series["value_loss"][1]),
            f"[cli] load_run: {sorted(series)}")
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                visualize.main([run_dir, "--out",
                                os.path.join(tmp, "curves.png")])
            plot = "drawn"
        except ImportError as err:
            require("matplotlib" in str(err), f"[cli] visualize: {err}")
            plot = "not drawn: this machine has no matplotlib"
        paths = (counts, enjoy_counts, traced)
        out.update({k: sum(c[k] for c in paths) for k in traced})
        out.update(trace_kernels=len(ops), trace_b1=b1,
                   trace_backward_kernels=len(backward),
                   trace_update_seconds=timer.times[0],
                   trace_device_ms=sum(o.total_us for o in ops) / 1e3,
                   plot=plot)
    say(f"[cli] ok: replay {plies} plies = {counts['bit_step_launches']} "
        f"B1 launches, card = CPU page ({out['replay_final']}); enjoy "
        f"{enjoy_plies} plies, {enjoy_counts['bit_step_launches']} B1 "
        f"launches, card = CPU transcript, reward {rewards[0]}; sweep "
        f"script of 2 runs, no pause; trace of one update in "
        f"{timer.times[0]:.3f} s: {len(ops)} kernels, "
        f"{out['trace_device_ms']:.1f} device ms, bit_step_kernel x "
        f"{b1}, {len(backward)} kernels under backward ops; load_run "
        f"{sorted(series)[:4]}...; plot {plot}")
    return out


def _tool(label, main, argv, texts):
    """``main(argv)`` of a tool with its printed text kept in ``texts``;
    returns its result."""
    import io
    with contextlib.redirect_stdout(io.StringIO()) as text:
        out = main(argv)
    texts[label] = text.getvalue()
    return out


def _finite_positive(what, values):
    bad = {k: v for k, v in values.items()
           if not (isinstance(v, (int, float)) and math.isfinite(v)
                   and v > 0)}
    require(not bad, f"[tools] {what}: timings not finite and positive: "
            f"{bad}")


def _tools_phase(torch, tb, legal_mask, step):
    """The measurement and evaluation tools of gymothelloenv_tpu_torch/
    scripts/ on the card, each through its ``main`` at a cut size (full
    widths; N and plies cut, see TOOLS_*), with the gates of each: the
    collection, train-step, DQN and Rainbow traces count one B1 launch a
    traced ply in the trace, equal to the wrapper's count (for the chunks,
    one a ply), the update's trace none; every timing finite and
    positive; the replay bench's insert and sample counts exact;
    eval_snapshots = cli.eval_checkpoint at each snapshot's seed;
    tournament_big's tallies the games of each pair, and at chunk = games
    cli.tournament's; bench_scaling at world 1 on an nccl mesh and on two
    gloo ranks sharing the card under torchrun (started first, beside the
    rest).  The counts of K2 and the ply kernel run from 0 over the
    phase's own process."""
    t = str(TOOLS_T)
    say(f"[tools] start: the traces, profiles and benches at N {TOOLS_N}, "
        f"T {t}; bench_scaling at {TOOLS_SCALE_ENVS} games a rank; "
        f"eval_snapshots of two wide2 snapshots, {TOOLS_SNAPSHOT_GAMES} "
        f"games; tournament_big on {','.join(TOOLS_LINEUP)}")
    texts, seconds = {}, {}
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in child_env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    t_ranks = time.perf_counter()
    with tempfile.TemporaryFile("w+") as log:
        ranks = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m",
             "gymothelloenv_tpu_torch.scripts.bench_scaling",
             str(TOOLS_SCALE_ENVS), t, "--backend=gloo",
             f"--device={DEVICE_TYPE}:0"],
            cwd=HERE, env=child_env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            _zero_counts(legal_mask, step)
            out = _tools_in_process(torch, tb, legal_mask, step, texts,
                                    seconds)
            ranks.wait(timeout=max(1.0, DP_TIMEOUT_S - (
                time.perf_counter() - t_ranks)))
        except subprocess.TimeoutExpired:
            raise RuntimeError("[tools] bench_scaling under torchrun "
                               f"outlived {DP_TIMEOUT_S} s")
        finally:
            if ranks.poll() is None:
                os.killpg(ranks.pid, 9)
                ranks.wait()
        log.seek(0)
        scale2_text = log.read()
    seconds["bench_scaling_gloo2"] = time.perf_counter() - t_ranks
    texts["bench_scaling_gloo2"] = scale2_text
    eff = re.search(r"weak-scaling efficiency 1 -> 2 devices: "
                    r"([0-9.]+)%", scale2_text)
    require(ranks.returncode == 0 and eff is not None,
            f"[tools] bench_scaling on two gloo ranks: rc "
            f"{ranks.returncode}:\n{scale2_text[-3000:]}")
    _finite_positive("bench_scaling", {"world1": out.pop("scale1"),
                                       "efficiency": float(eff.group(1))})
    _finite_positive("wall seconds", seconds)
    say(f"[tools] ok: {out.pop('summary')}; bench_scaling efficiency 1 -> "
        f"2 gloo ranks {eff.group(1)}%; wall s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    out["seconds"] = seconds
    return out


def _tools_in_process(torch, tb, legal_mask, step, texts, seconds):
    """[tools]' tools in this process, their gates, and the counts of K2
    and the ply kernel from 0 (``_tools_phase``)."""
    from gymothelloenv_tpu_torch.cli import eval_checkpoint, tournament
    from gymothelloenv_tpu_torch.models.convert import flax_tree
    from gymothelloenv_tpu_torch.scripts import (
        bench_batch_scaling, bench_replay, bench_replay_parts,
        bench_scaling, eval_snapshots, profile_ppo_train, profile_recurrent,
        profile_update_breakdown, tournament_big, tournament_ci,
        trace_collect, trace_dqn_chunk, trace_rainbow_chunk,
        trace_train_step, trace_update)
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.ppo_trainer import make_network
    from gymothelloenv_tpu_torch.utils.checkpoint import save_checkpoint
    from gymothelloenv_tpu_torch.utils.profiling import (B1_KERNEL,
                                                         kernel_launches)
    n, t = str(TOOLS_N), str(TOOLS_T)
    dev_arg = f"--device={DEVICE_TYPE}"
    trace_dirs = []

    def timed(label, main, argv):
        t0 = time.perf_counter()
        result = _tool(label, main, argv, texts)
        seconds[label] = time.perf_counter() - t0
        return result

    with _no_plain(tb) as plain_calls, \
            tempfile.TemporaryDirectory() as tmp:
        # Traces.
        upd = timed("trace_update", trace_update.main, [t, n, dev_arg])
        ts = timed("trace_train_step", trace_train_step.main, [n, dev_arg])
        col = timed("trace_collect", trace_collect.main, [t, n, dev_arg])
        chunk_argv = [n, "--batch=4096", "--interval=512", f"--plies={t}",
                      dev_arg]
        dqn = timed("trace_dqn_chunk", trace_dqn_chunk.main, chunk_argv)
        rb = timed("trace_rainbow_chunk", trace_rainbow_chunk.main,
                   chunk_argv)
        for r in (upd, ts, col, dqn, rb):
            trace_dirs.append(r.pop("trace_dir"))
        b1_upd = kernel_launches(upd["ops"], B1_KERNEL)
        require(b1_upd == 0 and len(upd["ops"]) >= 3,
                f"[tools] trace_update: {b1_upd} B1 runs, "
                f"{len(upd['ops'])} kernels")
        for label, r in (("trace_train_step", ts), ("trace_collect", col)):
            require(r["b1_traced"] == r["b1_launches"] > 0,
                    f"[tools] {label}: the trace holds {r['b1_traced']} "
                    f"bit_step_kernel runs for {r['b1_launches']} B1 "
                    "launches")
        for label, r in (("trace_dqn_chunk", dqn),
                         ("trace_rainbow_chunk", rb)):
            require(r["b1_traced"] == r["b1_launches"] == r["plies"]
                    == TOOLS_T and r["updates"] > 0,
                    f"[tools] {label}: {r['b1_traced']} traced and "
                    f"{r['b1_launches']} counted B1 launches for "
                    f"{r['plies']} plies, {r['updates']} updates")
        _finite_positive("traces", {
            "update_wall": upd["wall_s"], "train_step_wall": ts["wall_s"],
            "collect_ms": col["ms_per_rollout"],
            "collect_device": col["device_s"], "dqn_device": dqn["device_s"],
            "rainbow_device": rb["device_s"]})
        # Profiles.
        pub = timed("profile_update_breakdown",
                    profile_update_breakdown.main, [t, n, dev_arg])
        prec = timed("profile_recurrent", profile_recurrent.main,
                     [t, n, dev_arg])
        ppt = timed("profile_ppo_train", profile_ppo_train.main,
                    [n, f"--num-steps={t}", dev_arg])
        _finite_positive("profile_update_breakdown", {
            k: v for k, v in pub.items() if k.endswith("_ms")})
        _finite_positive("profile_recurrent", {
            f"{r['what']}_{r.get('mini_batch', '')}": r["sec"]
            for r in prec})
        _finite_positive("profile_ppo_train", {
            k: v for k, v in ppt[0].items() if k != "num_envs"})
        # Benches.
        brp = timed("bench_replay", bench_replay.main, [dev_arg])
        for r in brp:
            require(r["inserted"] == r["inserted_want"]
                    and r["write_pos"] == r["write_pos_want"]
                    and r["sampled"] == r["sampled_want"]
                    and r["max_index"] < r["inserted"],
                    f"[tools] bench_replay counts: {r}")
            _finite_positive("bench_replay", {
                k: r[k] for k in ("insert_ms", "sample_ms")})
        parts = timed("bench_replay_parts", bench_replay_parts.main,
                      [dev_arg])
        _finite_positive("bench_replay_parts", {
            k: v for k, v in parts.items() if k.endswith("_ms")
            or "_ms_" in k})
        bbs = timed("bench_batch_scaling", bench_batch_scaling.main,
                    [f"--num-steps={t}", dev_arg, n])
        _finite_positive("bench_batch_scaling", {
            k: bbs[0][k] for k in ("ms_per_step", "trans_per_sec")})
        scale1 = timed("bench_scaling", bench_scaling.main,
                       [str(TOOLS_SCALE_ENVS), t, "--backend=nccl",
                        dev_arg])
        # Evaluation.
        glob_ = os.path.join(tmp, "run_{step}.msgpack")
        steps = (100, 200)
        for i, s in enumerate(steps):
            net = make_network(EnvConfig(), HIDDEN, WIDTH_MULT, seed=SEED + i,
                               device=DEVICE_TYPE)
            save_checkpoint(glob_.format(step=s), s, flax_tree(net))
        snaps = timed("eval_snapshots", eval_snapshots.main, [
            "--glob", glob_, "--steps", ",".join(map(str, steps)),
            "--opponent", "greedy", "--games", str(TOOLS_SNAPSHOT_GAMES),
            "--seed", str(SEED), "--device", DEVICE_TYPE])
        for s in steps:
            direct = _tool("eval_checkpoint", eval_checkpoint.main, [
                "--load", glob_.format(step=s), "--opponent", "greedy",
                "--games", str(TOOLS_SNAPSHOT_GAMES), "--seed",
                str(SEED + s), "--device", DEVICE_TYPE], texts)
            require(snaps[s] == tuple(direct) and sum(direct)
                    == TOOLS_SNAPSHOT_GAMES,
                    f"[tools] eval_snapshots step {s}: {snaps[s]}, "
                    f"eval_checkpoint --seed {SEED + s}: {direct}")
        real_lineup = tournament_big.LINEUP
        tournament_big.LINEUP = TOOLS_LINEUP
        try:
            games = str(TOOLS_TOURNAMENT_GAMES)
            big = timed("tournament_big", tournament_big.main, [
                "--games", games, "--chunk", str(TOOLS_TOURNAMENT_CHUNK),
                "--seed", str(SEED), "--device", DEVICE_TYPE])
            whole = _tool("tournament_big_whole", tournament_big.main, [
                "--games", games, "--chunk", games, "--maximin3-chunk",
                games, "--seed", str(SEED), "--device", DEVICE_TYPE],
                texts)
        finally:
            tournament_big.LINEUP = real_lineup
        cli = _tool("tournament", tournament.main, [
            "--games", games, "--lineup", ",".join(TOOLS_LINEUP), "--seed",
            str(SEED), "--device", DEVICE_TYPE], texts)
        require(all(sum(v) == TOOLS_TOURNAMENT_GAMES for v in big.values())
                and len(big) == len(TOOLS_LINEUP) ** 2,
                f"[tools] tournament_big tallies: {big}")
        require(whole == cli, f"[tools] tournament_big at chunk = games "
                f"{whole} differs from cli.tournament's {cli}")
        ci_path = os.path.join(tmp, "tournament_big.log")
        with open(ci_path, "w") as f:
            f.write(texts["tournament_big"])
        ci = _tool("tournament_ci", tournament_ci.main, [ci_path], texts)
        require(len(ci) == len(big) and "cells consistent with README"
                in texts["tournament_ci"], f"[tools] tournament_ci: {ci}")
        torch.cuda.synchronize()
    for d in trace_dirs:
        shutil.rmtree(d, ignore_errors=True)
    counts = _counts(legal_mask, step)
    require(not plain_calls, f"[tools] a plain ply ran on the card: "
            f"{plain_calls[:3]}")
    _require_no_k2(counts["k2_launches"], "tools")
    require(counts["bit_step_launches"] > 0, "[tools] no B1 launch")
    b1 = {label: {k: r[k] for k in ("b1_launches", "b1_traced")}
          for label, r in (("train_step", ts), ("collect", col),
                           ("dqn_chunk", dqn), ("rainbow_chunk", rb))}
    b1["update_traced"] = b1_upd
    summary = ("; ".join(
        f"{k} {v['b1_traced']} B1 runs traced = {v['b1_launches']} "
        f"counted" for k, v in b1.items() if isinstance(v, dict))
        + f"; update trace: {b1_upd} B1; device s: collect "
        f"{col['device_s']}, dqn chunk {dqn['device_s']}, rainbow chunk "
        f"{rb['device_s']}; replay insert/sample ms "
        + ", ".join(f"{'per' if r['prioritized'] else 'uniform'} "
                    f"{r['insert_ms']}/{r['sample_ms']}" for r in brp)
        + f"; eval_snapshots = eval_checkpoint at {steps}; tournament_big "
        f"{len(big)} pairs, whole = cli.tournament; tournament_ci "
        f"{len(ci)} cells")
    return dict(counts, b1=b1, scale1=scale1[1], summary=summary)


def _dp_phase(torch, tb, ro, legal_mask, step, dev):
    """Data-parallel training on the card (parallel/): (a) world 1 under
    nccl through the mesh path against the mesh=None trainer, which also
    runs twice by default and twice with cuDNN deterministic; (b) two
    gloo ranks sharing the card, N / 2 games each, against (a); (c) the
    dryrun's small families world 1 vs 2; the planted faults (DP_FAULTS)
    against (a) and (c)'s world 1; (d) rollout_chunk_sharded over the two
    ranks against the plain rollout on each slice; (e) DQN and (f)
    Rainbow at jobs 60's and 58's widths, one chunk cut to DP_OFF_PLIES
    plies, nccl world 1 against mesh=None, one B1 launch a ply; (g) both
    on the two gloo ranks, (h) both per-shard, (i) the tensor-parallel
    PPO step on the ranks' 1 x 2 mesh, and the faults of DP_OFF_FAULTS and
    DP_TP_FAULT against them (``_dp_offpolicy_gate``).  (b)-(d) and
    (g)-(i) run in one spawned cluster; a rank that fails fails the
    phase.  No part measures a second GPU: NCCL puts one rank on a card,
    and the machine has one."""
    import torch.distributed as dist
    from gymothelloenv_tpu_torch.parallel import dryrun, make_mesh
    from gymothelloenv_tpu_torch.parallel.sharding import (
        assert_tree_allclose)
    from gymothelloenv_tpu_torch.utils import timing
    wide = dryrun.Size(num_envs=DP_ENVS, num_steps=DP_STEPS,
                       hidden_size=HIDDEN, width_mult=WIDTH_MULT)
    say(f"[dp] start: (a) world 1 under nccl, wide2 PPO N {DP_ENVS}, T "
        f"{DP_STEPS}, {DP_UPDATES} updates vs mesh=None; (b) 2 gloo ranks "
        f"on {dev}, N {DP_ENVS // 2} each; (c) dryrun {DP_FAMILIES} world 1 "
        f"vs 2; (d) rollout_chunk_sharded N {DP_ROLLOUT_N} on 2 ranks; (e) "
        f"DQN and (f) Rainbow N {DP_OFF_ENVS}, {DP_OFF_PLIES} plies, world 1 "
        "under nccl vs mesh=None; (g) both on 2 gloo ranks; (h) per-shard; "
        "(i) make_sharded_train_step on 1 x 2; one card: no part measures "
        "a second GPU")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) world 1 under nccl: every collective of the mesh path.
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(backend="nccl", device=dev)
            require(mesh.distributed and mesh.world == 1,
                    f"[dp] nccl mesh {mesh}")
            _zero_counts(legal_mask, step)
            t0 = time.perf_counter()
            with _no_plain(tb) as plain_calls:
                nccl = dryrun.train_family("ppo", mesh, dev, DP_UPDATES,
                                           wide)
            torch.cuda.synchronize()
            out["world1_seconds"] = time.perf_counter() - t0
            counts = _counts(legal_mask, step)
            # (e), (f): one chunk of each off-policy family, nccl world 1.
            off_nccl = {}
            for fam in ("dqn", "rainbow"):
                _zero_counts(legal_mask, step)
                with _no_plain(tb) as off_plain:
                    off_nccl[fam] = _dp_off_run(fam, mesh, dev,
                                                _dp_off_size())
                off_nccl[fam]["counts"] = _counts(legal_mask, step)
                require(not off_plain, f"[dp] ({fam}) ran a plain ply: "
                        f"{off_plain[:3]}")
        finally:
            dist.destroy_process_group()
        require(not plain_calls, f"[dp] ran a plain ply: {plain_calls[:3]}")
        require(counts["bit_step_launches"] > 0, f"[dp] {counts}")
        _require_no_k2(counts["k2_launches"], "dp")
        out.update(counts)
        plain = dryrun.train_family("ppo", None, dev, DP_UPDATES, wide)
        again = dryrun.train_family("ppo", None, dev, DP_UPDATES, wide)
        init = dryrun.state_of("ppo", dryrun.build("ppo", None, dev, wide))
        repeat_equal = all(torch.equal(plain["state"][k], again["state"][k])
                           for k in plain["state"])
        was = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            det = [dryrun.train_family("ppo", None, dev, DP_UPDATES,
                                       wide)["state"] for _ in range(2)]
        finally:
            torch.backends.cudnn.deterministic = was
        det_equal = all(torch.equal(det[0][k], det[1][k]) for k in det[0])
        rel_repeat = _dp_worst("(a) mesh=None twice", plain["state"],
                               again["state"], init)
        rel_a = _dp_rel("(a) nccl world 1 vs mesh=None", plain["state"],
                        nccl["state"], init)
        off_none = {fam: _dp_off_run(fam, None, dev, _dp_off_size())
                    for fam in ("dqn", "rainbow")}
        off_init = {fam: _dp_off_run(fam, None, dev, _dp_off_size(),
                                     chunk=False)["state"]
                    for fam in ("dqn", "rainbow")}
        rel_ef = {}
        for part, fam in (("(e)", "dqn"), ("(f)", "rainbow")):
            got, want = off_nccl[fam], off_none[fam]
            c = got["counts"]
            require(c["bit_step_launches"] == c["reset_launches"]
                    == DP_OFF_PLIES, f"[dp] {part} {fam}: {c} for "
                    f"{DP_OFF_PLIES} plies")
            _require_no_k2(c["k2_launches"], f"dp {part}")
            require(got["size"] == want["size"] > 0 and torch.equal(
                got["rows"], want["rows"]), f"[dp] {part} {fam}: the "
                "nccl world-1 ring differs from mesh=None's")
            rel_ef[fam] = _dp_rel(f"{part} {fam} nccl world 1 vs mesh=None",
                                  want["state"], got["state"],
                                  off_init[fam])
            say(f"[dp] {part} {fam} at N {DP_OFF_ENVS}, one chunk of "
                f"{DP_OFF_PLIES} plies, {got['updates']} updates: nccl world "
                f"1 = mesh=None, per leaf {rel_ef[fam]:.3e} of its largest "
                f"change (rtol {DP_PARAM_RTOL}), rings equal ({got['size']} "
                f"rows), {c['bit_step_launches']} B1 launches, "
                f"{got['seconds']:.2f} s against {want['seconds']:.2f} s "
                "without a mesh")

        # (b), (c), (d): one cluster of two gloo ranks on this card.
        expert = dryrun.write_expert(os.path.join(tmp, "expert.npz"))
        rows_path = os.path.join(tmp, "offpolicy_rows.pt")
        torch.save({f: off_nccl[f].pop("sampled") for f in off_nccl},
                   rows_path)
        for res in off_none.values():
            res.pop("sampled")
        small = {"families": list(DP_FAMILIES), "updates": 1, "size": {},
                 "expert": expert}
        wide_ppo = {"families": ["ppo"], "updates": DP_UPDATES,
                    "size": dataclasses.asdict(wide)}
        tp_size = {"size": dataclasses.asdict(wide)}
        args = {"runs": {"wide": wide_ppo, "small": small},
                "rollout": {"num_games": DP_ROLLOUT_N,
                            "num_steps": DP_ROLLOUT_STEPS, "seed": SEED},
                "faults": list(DP_FAULTS),
                "fault_runs": {"wide": wide_ppo,
                               "small": dict(small, families=["ppo"])},
                "offpolicy": {"tp": tp_size, "size": _dp_off_size(),
                              "rows": rows_path}}
        t0 = time.perf_counter()
        ranks = dryrun.spawn(2, "chip_smoke:dp_cluster_task", args,
                             backend="gloo",
                             device=str(dev),
                             out_dir=os.path.join(tmp, "cluster"),
                             timeout_s=DP_TIMEOUT_S)
        out["cluster_seconds"] = time.perf_counter() - t0
        one = dryrun.families_task(make_mesh(backend="gloo", device=dev),
                                   dev, small)
        one_tp = dryrun.tp_task(make_mesh(backend="gloo", device=dev), dev,
                                tp_size)
        tp_init = dryrun.tp_init_state(dev, wide)
    out.update(_dp_offpolicy_gate(torch, ranks, off_nccl, off_init, one_tp,
                                  tp_init))
    out["offpolicy_world1"] = {
        fam: dict(rel=rel_ef[fam], seconds=off_nccl[fam]["seconds"],
                  seconds_no_mesh=off_none[fam]["seconds"],
                  updates=off_nccl[fam]["updates"],
                  rows=off_nccl[fam]["size"])
        for fam in ("dqn", "rainbow")}
    for k in ("bit_step_launches", "reset_launches", "k2_launches"):
        counts[k] += sum(off_nccl[f]["counts"][k] for f in off_nccl)
    dryrun.check_replicated([r["wide"]["ppo"] for r in ranks])
    rel_b = _dp_rel("(b) 2 gloo ranks vs (a)", nccl["state"],
                    ranks[0]["wide"]["ppo"]["state"], init)
    fam = {}
    for f in DP_FAMILIES:
        dryrun.check_replicated([r["small"][f] for r in ranks])
        got, want = ranks[0]["small"][f]["state"], one[f]["state"]
        assert_tree_allclose(want, got, name=f"[dp] {f}",
                             require_finite=True)
        fam[f] = max(float((got[k] - want[k]).abs().max()) for k in want)

    # The planted faults: each must fail the gate of its size.
    faults = {}
    for fault in DP_FAULTS:
        res = ranks[0]["faults"][fault]
        got, want = res["small"]["ppo"]["state"], one["ppo"]["state"]
        try:
            assert_tree_allclose(want, got, name=fault)
            small_caught = False
        except AssertionError:
            small_caught = True
        faults[fault] = dict(
            wide_rel=_dp_worst(fault, nccl["state"],
                               res["wide"]["ppo"]["state"], init),
            small_max_abs_diff=max(float((got[k] - want[k]).abs().max())
                                   for k in want),
            small_caught=small_caught)
        require(faults[fault]["wide_rel"] > DP_PARAM_RTOL,
                f"[dp] the gate misses the planted fault {fault} at the "
                f"wide size: {faults[fault]['wide_rel']:.3e} of the largest "
                f"change <= {DP_PARAM_RTOL}")
        require(small_caught, f"[dp] JAX's gate misses the planted fault "
                f"{fault} at the dryrun's size")

    # (d) each rank's rollout against the plain one on its slice.
    n, half = DP_ROLLOUT_N, DP_ROLLOUT_N // 2
    state = dryrun.rollout_init_state(n, SEED + 1, 20, dev)
    total = 0
    for rank, res in enumerate(ranks):
        r = res["rollout"]
        mine = ro.RolloutState(**{k: getattr(state, k)[rank * half:
                                                      (rank + 1) * half]
                                  for k in ("cur", "opp", "legal")})
        want, eps = ro.rollout_chunk_plain(
            mine, SEED + rank * ro.RANK_SEED_STRIDE, DP_ROLLOUT_STEPS)
        for k in ("cur", "opp", "legal"):
            require(torch.equal(r["state"][k], getattr(want, k).cpu()),
                    f"[dp] rank {rank}'s sharded rollout differs from the "
                    f"plain one on {k}")
        require(r["launches"] == 1, f"[dp] rank {rank}: {r['launches']} K1 "
                "launches for one chunk")
        total += int(eps)
    require(all(r["rollout"]["episodes"] == total > 0 for r in ranks),
            f"[dp] episode counts {[r['rollout']['episodes'] for r in ranks]}"
            f" for a sum of {total}")
    one_ms = timing.device_ms(lambda: ro.rollout_chunk(
        state, SEED, DP_ROLLOUT_STEPS), 5)
    rollout = dict(launches=sum(r["rollout"]["launches"] for r in ranks),
                   episodes=total, ranks_ms=[r["rollout"]["ms"]
                                             for r in ranks],
                   one_process_ms=one_ms, num_games=n,
                   num_steps=DP_ROLLOUT_STEPS)
    out.update(counts)
    out.update(rel_a=rel_a, rel_b=rel_b, rel_repeat=rel_repeat,
               repeat_bit_equal=repeat_equal,
               deterministic_repeat_bit_equal=det_equal,
               families_max_abs_diff=fam,
               faults=faults, rollout=rollout,
               child_bit_step_launches=sum(
                   r[k][f]["bit_step_launches"] for r in ranks
                   for k in ("wide", "small") for f in r[k])
               + sum(r["offpolicy"]["bit_step_launches"] for r in ranks))
    say(f"[dp] ok: (a) nccl world 1 = mesh=None, per leaf "
        f"{rel_a:.3e} of its largest change (rtol {DP_PARAM_RTOL}), "
        f"{counts['bit_step_launches']} B1 launches in "
        f"{out['world1_seconds']:.2f} s; mesh=None twice "
        f"{'bit-equal' if repeat_equal else 'not bit-equal'}, "
        f"{rel_repeat:.3e}, and with cuDNN deterministic "
        f"{'bit-equal' if det_equal else 'not bit-equal'}; (b) 2 gloo "
        f"ranks = (a), "
        f"{rel_b:.3e}, ranks replicated; (c) world 2 = world 1 "
        + ", ".join(f"{f} {d:.1e}" for f, d in fam.items())
        + " (rtol 5e-3, atol 1e-5); planted faults fail the gate: "
        + ", ".join(f"{f} wide {v['wide_rel']:.3e}, small max abs diff "
                    f"{v['small_max_abs_diff']:.1e}"
                    for f, v in faults.items())
        + f"; (d) rollout_chunk_sharded = plain on "
        f"each slice, {total} episodes summed, ms a chunk by rank "
        + ", ".join(f"{m:.3f}" for m in rollout["ranks_ms"])
        + f" (two ranks sharing the card) beside {one_ms:.3f} in one "
        f"process at N {n}; cluster {out['cluster_seconds']:.2f} s")
    return out


def _dp_worst(what, want, got, init):
    """The largest per-leaf |got - want| over the leaf's largest change
    from ``init`` (infinite where a leaf that ``want`` left alone moved);
    fails on a non-finite value."""
    worst = 0.0
    for k in want:
        change = float((want[k] - init[k]).abs().max())
        diff = float((got[k] - want[k]).abs().max())
        require(math.isfinite(diff), f"[dp] {what}: {k} is not finite")
        if change > 0:
            worst = max(worst, diff / change)
        elif diff:
            worst = math.inf
    return worst


def _dp_rel(what, want, got, init):
    """``_dp_worst``, failing above DP_PARAM_RTOL."""
    worst = _dp_worst(what, want, got, init)
    require(worst <= DP_PARAM_RTOL, f"[dp] {what}: a leaf differs by "
            f"{worst:.3e} of its largest change > {DP_PARAM_RTOL}")
    return worst


@contextlib.contextmanager
def _planted(fault):
    """A parallel fault patched in for [dp]'s gates to catch:
    ``unreduced_grads`` (agents/ppo.py), each rank steps on its own
    gradients (the loss terms are still summed); ``local_moments``, each
    rank normalises its advantages by its own games' moments;
    ``unreduced_offpolicy_grads`` (agents/dqn.py), the DQN and Rainbow
    update's own gradients; ``reversed_ranks_insert`` (the DQN trainer's
    gather before the replicated insert), the ranks' streams in reverse
    rank order;
    ``DP_TP_FAULT`` (parallel/dp.py), the clip's norm counting the split
    leaves' squares twice."""
    from gymothelloenv_tpu_torch.agents import dqn, ppo
    from gymothelloenv_tpu_torch.parallel import dp, sharding
    from gymothelloenv_tpu_torch.train.dqn_trainer import DQNTrainer
    module = ppo
    if fault == "unreduced_offpolicy_grads":
        module, name = dqn, "all_reduce_grads"

        def fake(params, mesh, extra=()):
            sharding.all_reduce_sum(list(extra), mesh)
    elif fault == "reversed_ranks_insert":
        module, name = DQNTrainer, "_gather_emissions"
        real_gather = DQNTrainer._gather_emissions

        def fake(self, ems):
            # Each push's gathered streams in reverse rank order: world
            # 1's rows, but not in its order.
            rows = real_gather(self, ems)
            per = rows[0].valid.shape[1] // self.mesh.world
            order = [j for r in reversed(range(self.mesh.world))
                     for j in range(r * per, (r + 1) * per)]
            return [types.SimpleNamespace(**{
                k: v[:, order] for k, v in vars(e).items()}) for e in rows]
    elif fault == DP_TP_FAULT:
        module, name = dp, "global_grad_norm"

        def fake(params, sharded, mesh):
            import torch
            sq = [sum(float(p.grad.pow(2).sum()) for p, c in
                      zip(params, sharded) if c == cut) for cut in (0, 1)]
            split = torch.tensor([sq[1]], device=params[0].device)
            sharding.all_reduce_sum([split], mesh, group="model")
            return torch.sqrt(sq[0] + 2.0 * split[0])
    elif fault == "unreduced_grads":
        name = "all_reduce_grads"

        def fake(params, mesh, extra=()):
            sharding.all_reduce_sum(list(extra), mesh)
    elif fault == "local_moments":
        name = "normalize_advantages"

        def fake(adv, weights=None, mesh=None):
            return real(adv, weights)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    real = getattr(module, name)
    setattr(module, name, fake)
    try:
        yield
    finally:
        setattr(module, name, real)


def dp_cluster_task(mesh, device, args):
    """[dp]'s ``parallel.dryrun.spawn`` task: ``dryrun.cluster_task``,
    then with each fault of ``args["faults"]`` planted, the runs of
    ``args["fault_runs"]`` (``dryrun.families_task`` args by name); then
    (g)-(i) and their faults (``_dp_offpolicy_task``)."""
    from gymothelloenv_tpu_torch.parallel import dryrun
    out = dryrun.cluster_task(mesh, device, args)
    out["faults"] = {}
    for fault in args["faults"]:
        with _planted(fault):
            out["faults"][fault] = {
                name: dryrun.families_task(mesh, device, run)
                for name, run in args["fault_runs"].items()}
    out["offpolicy"] = _dp_offpolicy_task(mesh, device, args["offpolicy"])
    return out


def _dp_off_size():
    """(e)-(h)'s sizes, handed to the ranks with their task."""
    return dict(envs=DP_OFF_ENVS, plies=DP_OFF_PLIES, replay=DQN_REPLAY,
                dqn=(DQN_BATCH, DQN_INTERVAL),
                rainbow=(RAINBOW_BATCH, RAINBOW_INTERVAL))


def _dp_off_trainer(family, mesh, dev, size, pershard=False):
    """(e)-(h)'s trainer (``size``: ``_dp_off_size()``): DQN at JAX job
    60's widths or Rainbow at job 58's (N 1024, batch 4096, train interval
    512, n-step 3, a 1M PER ring, no warm-up, seed 4), DP_OFF_PLIES plies
    a chunk; on ``mesh`` (``None``: ``dev`` alone), per-shard if
    asked."""
    from gymothelloenv_tpu_torch.agents.dqn import DQNConfig
    from gymothelloenv_tpu_torch.agents.rainbow import RainbowConfig
    from gymothelloenv_tpu_torch.agents.replay import ReplayConfig
    from gymothelloenv_tpu_torch.core.state import EnvConfig
    from gymothelloenv_tpu_torch.train.dqn_trainer import (DQNRunConfig,
                                                           DQNTrainer)
    from gymothelloenv_tpu_torch.train.rainbow_trainer import RainbowTrainer
    run = DQNRunConfig(num_envs=size["envs"], chunk_plies=size["plies"],
                       seed=4, num_test_games=4, test_interval=10 ** 9,
                       replay_sharding="per-shard" if pershard
                       else "replicated")
    rb = ReplayConfig(capacity=size["replay"], prioritized=True)
    batch, interval = size[family]
    kw = dict(log_fn=lambda *a: None, mesh=mesh,
              device=None if mesh is not None else dev)
    env = EnvConfig(num_disk_as_reward=True)
    if family == "dqn":
        return DQNTrainer(env, DQNConfig(
            batch_size=batch, train_interval=interval, n_step=3,
            double=True, dueling=True, initial_replay_size=0), rb, run, **kw)
    return RainbowTrainer(env, RainbowConfig(
        batch_size=batch, train_interval=interval, initial_replay_size=0),
        rb, run, **kw)


def _dp_off_run(family, mesh, dev, size, pershard=False, chunk=True,
                rows=None):
    """One chunk of ``_dp_off_trainer`` (none with ``chunk`` False) with
    cuDNN's deterministic algorithms: the net's state (CPU), the ring's
    live packed rows and priorities, its size, ``t``, the updates, the
    seconds, the B1 launches and the rows each update sampled
    (``sampled``, CPU).  ``rows``: such a list, the updates then taking
    those rows instead of sampling.  Deterministic, because the default
    weight gradient's run-to-run rounding, carried through a chunk's
    128 PER updates (the priorities decide the next rows), read 8.791e-2
    of a leaf's change between nccl world 1 and ``mesh=None``: the card's
    drift, not the mesh path's arithmetic (PERF.md section 6)."""
    import torch
    from gymothelloenv_tpu_torch.agents import dqn, rainbow
    from gymothelloenv_tpu_torch.agents.replay import ring_rows
    from gymothelloenv_tpu_torch.ops.step import bit_step
    tr = _dp_off_trainer(family, mesh, dev, size, pershard)
    launches = bit_step.launches
    module = dqn if family == "dqn" else rainbow
    real_sample, sampled = module.replay_sample_idx, []
    given = None if rows is None else iter(rows)

    def sample(rb, cfg, u):
        idx = (real_sample(rb, cfg, u) if given is None
               else next(given).to(u.device))
        sampled.append(idx)
        return idx
    module.replay_sample_idx = sample
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        metrics = tr.train_chunk() if chunk else {"updates": 0}
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = was
        module.replay_sample_idx = real_sample
    size = int(tr.replay.size)
    return {"state": {f"net.{k}": v.detach().cpu().clone()
                      for k, v in tr.agent.net.state_dict().items()},
            "rows": ring_rows(tr.replay)[:size].cpu(),
            "priority": tr.replay.priority[:size].cpu(), "size": size,
            "t": tr.agent.t, "updates": int(metrics["updates"]),
            "seconds": seconds, "sampled": [i.cpu() for i in sampled],
            "bit_step_launches": bit_step.launches - launches}


def _dp_offpolicy_task(mesh, device, args):
    """(g) DQN and Rainbow, sampling their own rows and (``g_rows``) on
    the rows (e) and (f) sampled (``args["rows"]``, a file), (h) both
    per-shard, (i) the tensor-parallel PPO step on the 1 x 2 mesh of the
    same ranks, then the faults of DP_OFF_FAULTS on (g)'s DQN on (e)'s
    rows and DP_TP_FAULT on (i); returns their results and the B1
    launches of (g)-(i)."""
    import torch
    from gymothelloenv_tpu_torch.ops.step import bit_step
    from gymothelloenv_tpu_torch.parallel import dryrun, make_mesh
    launches = bit_step.launches
    model = make_mesh(mesh.world, model_parallel=2, backend=mesh.backend,
                      device=mesh.device)
    size = args["size"]
    rows = torch.load(args["rows"], weights_only=False)
    out = {"g": {f: _dp_off_run(f, mesh, device, size)
                 for f in ("dqn", "rainbow")},
           "g_rows": {f: _dp_off_run(f, mesh, device, size, rows=rows[f])
                      for f in ("dqn", "rainbow")},
           "h": {f: _dp_off_run(f, mesh, device, size, pershard=True)
                 for f in ("dqn", "rainbow")},
           "i": dryrun.tp_task(model, device, args["tp"])}
    out["bit_step_launches"] = bit_step.launches - launches
    for part in ("g", "g_rows", "h"):
        for res in out[part].values():
            res.pop("sampled")
    out["faults"] = {}
    for fault in DP_OFF_FAULTS:
        with _planted(fault):
            out["faults"][fault] = _dp_off_run("dqn", mesh, device, size,
                                               rows=rows["dqn"])
            out["faults"][fault].pop("sampled")
    with _planted(DP_TP_FAULT):
        out["faults"][DP_TP_FAULT] = dryrun.tp_task(model, device,
                                                    args["tp"])
    return out


def _dp_offpolicy_gate(torch, ranks, off_nccl, off_init, one_tp, tp_init):
    """(g)-(i)'s gates and the planted faults', on the ranks' results
    against (e) and (f) and against world 1's tensor-parallel step;
    prints a reading a part and returns them."""
    from gymothelloenv_tpu_torch.parallel.replay_shards import (
        assert_ring_union_equal)
    res = [r["offpolicy"] for r in ranks]
    rel_g, rel_rows, ring_h = {}, {}, {}
    for fam in ("dqn", "rainbow"):
        want = off_nccl[fam]
        for part in ("g", "g_rows"):
            runs = [r[part][fam] for r in res]
            for r in runs[1:]:
                require(all(torch.equal(r["state"][k], runs[0]["state"][k])
                            for k in r["state"])
                        and torch.equal(r["rows"], runs[0]["rows"])
                        and torch.equal(r["priority"], runs[0]["priority"]),
                        f"[dp] ({part}) {fam}: the ranks are not bit-equal")
            require(runs[0]["t"] == want["t"] and torch.equal(
                runs[0]["rows"], want["rows"]), f"[dp] ({part}) {fam}: the "
                "ring differs from the world-1 ring")
        runs = [r["g"][fam] for r in res]
        rel_rows[fam] = _dp_rel(f"(g) {fam} 2 gloo ranks on (e)/(f)'s rows",
                                want["state"], res[0]["g_rows"][fam]["state"],
                                off_init[fam])
        rel_g[fam] = _dp_worst(f"(g) {fam}", want["state"], runs[0]["state"],
                               off_init[fam])
        require(rel_g[fam] <= DP_OFF_PARAM_RTOL, f"[dp] (g) {fam} 2 gloo "
                f"ranks sampling their own rows: a leaf differs by "
                f"{rel_g[fam]:.3e} of its largest change > "
                f"{DP_OFF_PARAM_RTOL}")
        shards = [r["h"][fam] for r in res]
        assert_ring_union_equal(want["rows"], want["size"],
                                [r["rows"] for r in shards],
                                [r["size"] for r in shards],
                                name=f"[dp] (h) {fam}")
        require(all(r["t"] == want["t"] for r in shards), f"[dp] (h) {fam}")
        require(all(bool(torch.isfinite(v).all()) for r in shards
                    for v in r["state"].values()), f"[dp] (h) {fam}: "
                "params not finite")
        ring_h[fam] = [r["size"] for r in shards]
        say(f"[dp] (g) {fam}: 2 gloo ranks on one card, N "
            f"{DP_OFF_ENVS // 2} each = (e)/(f): on its rows per leaf "
            f"{rel_rows[fam]:.3e} of its largest change (rtol "
            f"{DP_PARAM_RTOL}), sampling their own {rel_g[fam]:.3e} (rtol "
            f"{DP_OFF_PARAM_RTOL}), rings equal, ranks bit-equal, "
            + ", ".join(f"{r['seconds']:.2f}" for r in runs)
            + f" s by rank; (h) per-shard: ring union = the replicated ring "
            f"({want['size']} rows as {ring_h[fam]}), "
            + ", ".join(f"{r['seconds']:.2f}" for r in shards) + " s")
    tp = [r["i"] for r in res]
    for r in tp[1:]:
        require(all(torch.equal(r["state"][k], tp[0]["state"][k])
                    for k in r["state"]), "[dp] (i): ranks differ")
    rel_i = _dp_rel("(i) tensor-parallel 1 x 2 vs world 1",
                    one_tp["state"], tp[0]["state"], tp_init)
    norms = torch.tensor(tp[0]["norms"]) / torch.tensor(one_tp["norms"])
    norm_rel = float((norms - 1).abs().max())
    clipped = sum(n > 0.5 for n in one_tp["norms"])
    require(norm_rel <= DP_TP_NORM_RTOL, f"[dp] (i): a clip's norm differs "
            f"by {norm_rel:.3e} > {DP_TP_NORM_RTOL}")
    require(clipped > 0, "[dp] (i): the clip never acted")
    say(f"[dp] (i) make_sharded_train_step on 1 x 2 (wide2, N {DP_ENVS}, T "
        f"{DP_STEPS}, one step) = world 1: per leaf {rel_i:.3e} of its "
        f"largest change, clip norms within {norm_rel:.3e}, the clip acted "
        f"at {clipped} of {len(one_tp['norms'])} minibatches")
    faults = {}
    for fault in DP_OFF_FAULTS:
        got = res[0]["faults"][fault]
        want = off_nccl["dqn"]
        worst = _dp_worst(fault, want["state"], got["state"],
                          off_init["dqn"])
        rings_equal = torch.equal(got["rows"], want["rows"])
        faults[fault] = dict(rel=worst, ring_equal=rings_equal)
        require(worst > DP_PARAM_RTOL or not rings_equal, f"[dp] (g)'s gate "
                f"misses the planted fault {fault}: {worst:.3e}, rings "
                f"{'equal' if rings_equal else 'differ'}")
    got = res[0]["faults"][DP_TP_FAULT]
    worst = _dp_worst(DP_TP_FAULT, one_tp["state"], got["state"], tp_init)
    fault_norm = float((torch.tensor(got["norms"])
                        / torch.tensor(one_tp["norms"]) - 1).abs().max())
    faults[DP_TP_FAULT] = dict(rel=worst, norm_rel=fault_norm)
    require(worst > DP_PARAM_RTOL or fault_norm > DP_TP_NORM_RTOL,
            f"[dp] (i)'s gate misses the planted fault {DP_TP_FAULT}")
    say("[dp] planted faults fail the gates: " + ", ".join(
        f"{k} per leaf {v['rel']:.3e}" + (
            f", ring {'equal' if v['ring_equal'] else 'differs'}"
            if "ring_equal" in v else f", clip norms {v['norm_rel']:.3e}")
        for k, v in faults.items()))
    return dict(offpolicy_ranks=rel_g, offpolicy_ranks_on_rows=rel_rows,
                pershard_sizes=ring_h, tp_rel=rel_i,
                tp_norm_rel=norm_rel, tp_clipped=clipped,
                offpolicy_faults=faults)


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
