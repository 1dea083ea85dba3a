// The ply kernel: one whole bit_step for N games, and reset_where.
//
// Replaces JAX gymothelloenv_tpu/core/bitboard.py::bit_step (:254), which
// XLA fuses into one program and which no Pallas kernel implements, and
// with it the per-ply launch of kernel K2 (csrc/legal_mask.cu) on the
// port's main path: K2's two legal floods run here, inside the ply.  Plain
// versions: core/bitboard.py bit_step_plain and reset_where_plain;
// wrapper: ops/step.py.
//
// Bound on Hopper: at the main path's N (512 games in the evaluation, 1024
// in collection, up to a few thousand) the launch itself: a ply is a few
// warps of work, well under a microsecond of device time.  From tens of
// thousands of games on, bytes: each game reads 36 B (24 B of words, three
// 1-byte fields, an 8-byte action, a 1-byte `do`) and writes 32 B, against
// roughly 750 32-bit logic instructions.  Design: one thread per game, the
// whole ply in registers (the flips flood, the opponent's legal flood, the
// mover's flood only when the opponent must pass, three popcounts, the
// terminal rules), every input read once and every output written once,
// nothing allocated, nothing synchronised.  The select of step_where, the
// env's auto-reset and reset_where happen in the same pass, so a collector
// slot that took some 1,400 eager ops takes three launches.  Blocks of 32
// threads spread the few warps of a small N over as many SMs.  Lane groups
// (csrc/rollout.cu) are not used: at these N every game has a whole
// scheduler to itself already, and the launch, not a warp's chain, bounds
// the kernel.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitboard.cuh"

namespace {

constexpr int kThreads = 32;

// Modes of otb_bit_step; the values are ops/step.py's MODES.
constexpr int kPlain = 0;      // bit_step
constexpr int kWhere = 1;      // step_where: games with !do keep their state
constexpr int kAutoreset = 2;  // bitvec_step: finished games reset

struct StepIn {
  const uint64_t* black;
  const uint64_t* white;
  const uint64_t* legal;
  const int8_t* turn;
  const bool* terminated;
  const int8_t* winner;
};

// Output words: row r of a (3, n) array (black, white, legal); small
// fields: row r of a (rows, n) int8 array (turn, terminated, winner[, done]).
struct StepOut {
  uint64_t* words;
  int8_t* small;
};

__device__ __forceinline__ void store(const StepOut& o, long long i,
                                      long long n, uint64_t black,
                                      uint64_t white, uint64_t legal,
                                      int8_t turn, bool terminated,
                                      int8_t winner) {
  o.words[i] = black;
  o.words[n + i] = white;
  o.words[2 * n + i] = legal;
  o.small[i] = turn;
  o.small[n + i] = terminated;
  o.small[2 * n + i] = winner;
}

__device__ __forceinline__ void store_opening(const StepOut& o, long long i,
                                              long long n) {
  store(o, i, n, otb::kInitCur, otb::kInitOpp, otb::kInitLegal, -1, false,
        0);
}

__global__ void __launch_bounds__(kThreads)
bit_step_kernel(StepIn in, const int64_t* __restrict__ action,
                const bool* __restrict__ do_, StepOut out,
                float* __restrict__ reward, long long n, bool sudden_flag,
                bool disk_reward, int mode) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint64_t black = in.black[i], white = in.white[i];
  const uint64_t legal = in.legal[i];
  const int8_t mover = in.turn[i];
  if (mode == kWhere && !do_[i]) {
    store(out, i, n, black, white, legal, mover, in.terminated[i],
          in.winner[i]);
    out.small[3 * n + i] = false;
    reward[i] = 0.0f;
    return;
  }
  const long long a = action[i];
  const bool is_white = mover == 1;
  uint64_t mine = is_white ? white : black;
  uint64_t opp = is_white ? black : white;

  // Place the disk; an action outside [0, 64) is the empty word, illegal.
  const uint64_t onehot = (a >= 0 && a < 64) ? 1ull << a : 0ull;
  const bool valid = (legal & onehot) != 0;
  const uint64_t flips = otb::resolve_flips(onehot, mine, opp);
  if (valid) {
    mine |= onehot | flips;
    opp &= ~flips;
  }

  const bool board_full = __popcll(mine | opp) == 64;
  const bool sudden = sudden_flag && !valid;
  // legal_same is read only when the opponent has no move, so the mover's
  // flood runs only then.
  const uint64_t legal_opp = otb::legal_moves(opp, mine);
  const bool opp_has = legal_opp != 0;
  const uint64_t legal_same = opp_has ? 0ull : otb::legal_moves(mine, opp);
  const bool terminated =
      sudden || board_full || (!opp_has && legal_same == 0);

  const int8_t next_turn =
      (terminated || !opp_has) ? mover : (int8_t)(-mover);
  const uint64_t next_legal =
      terminated ? 0ull : (opp_has ? legal_opp : legal_same);

  const int mine_cnt = __popcll(mine), opp_cnt = __popcll(opp);
  int8_t winner = 0;
  float r = 0.0f;
  if (terminated) {
    const int margin = is_white ? mine_cnt - opp_cnt : opp_cnt - mine_cnt;
    winner = sudden ? (int8_t)(-mover) : (int8_t)((margin > 0) - (margin < 0));
    if (disk_reward) {
      r = sudden ? -64.0f
          : opp_cnt == 0 ? 64.0f : (float)(mine_cnt - opp_cnt);
    } else {
      r = (float)((int)winner * (int)mover);
    }
  }
  if (mode == kAutoreset && terminated) {
    store_opening(out, i, n);
  } else {
    store(out, i, n, is_white ? opp : mine, is_white ? mine : opp,
          next_legal, next_turn, terminated, winner);
  }
  out.small[3 * n + i] = terminated;
  reward[i] = r;
}

__global__ void __launch_bounds__(kThreads)
reset_where_kernel(StepIn in, const bool* __restrict__ done, StepOut out,
                   long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  if (done[i]) {
    store_opening(out, i, n);
  } else {
    store(out, i, n, in.black[i], in.white[i], in.legal[i], in.turn[i],
          in.terminated[i], in.winner[i]);
  }
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// words_out: (3, n) uint64 (black, white, legal); small_out: (4, n) int8
// (turn, terminated, winner, done); reward_out: (n,) float32.  `do_` may
// be null except in mode kWhere.  Returns cudaGetLastError().
extern "C" int otb_bit_step(const void* black, const void* white,
                            const void* legal, const void* turn,
                            const void* terminated, const void* winner,
                            const void* action, const void* do_,
                            void* words_out, void* small_out,
                            void* reward_out, long long n, int sudden,
                            int disk_reward, int mode, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (mode < kPlain || mode > kAutoreset || (mode == kWhere && !do_)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    StepIn in{(const uint64_t*)black, (const uint64_t*)white,
              (const uint64_t*)legal, (const int8_t*)turn,
              (const bool*)terminated, (const int8_t*)winner};
    StepOut out{(uint64_t*)words_out, (int8_t*)small_out};
    bit_step_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        in, (const int64_t*)action, (const bool*)do_, out,
        (float*)reward_out, n, sudden != 0, disk_reward != 0, mode);
  }
  return (int)cudaGetLastError();
}

// words_out: (3, n) uint64; small_out: (3, n) int8 (turn, terminated,
// winner).  Returns cudaGetLastError().
extern "C" int otb_reset_where(const void* black, const void* white,
                               const void* legal, const void* turn,
                               const void* terminated, const void* winner,
                               const void* done, void* words_out,
                               void* small_out, long long n, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    StepIn in{(const uint64_t*)black, (const uint64_t*)white,
              (const uint64_t*)legal, (const int8_t*)turn,
              (const bool*)terminated, (const int8_t*)winner};
    StepOut out{(uint64_t*)words_out, (int8_t*)small_out};
    reset_where_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        in, (const bool*)done, out, n);
  }
  return (int)cudaGetLastError();
}
