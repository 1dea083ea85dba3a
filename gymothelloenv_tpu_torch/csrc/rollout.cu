// Kernel K1: num_steps uniformly random legal plies for N games in one
// launch, with auto-reset to the opening; and kernel K3, the same kernel
// with one component stubbed out for cost attribution.
//
// K1 replaces gymothelloenv_tpu/ops/pallas_rollout.py::rollout_chunk
// (kernel _make_kernel -> _ply / _sample_legal / _popcount), which kept the
// state as (8, N/8) uint32 tiles in VMEM and drew its bits from the TPU's
// PRNG.  K3 replaces scripts/bench_rollout_variants.py::make_chunk (ply
// body _ply_variant), a profiling copy of K1.  Plain twins: ops/rollout.py
// ply / rollout_chunk_plain; wrappers: ops/rollout.py rollout_chunk (K1)
// and rollout_variant_chunk (K3).
//
// What bounds it: integer operations and their latency, not memory.  A
// ply is about 786 32-bit instructions (the sampled move's flips, the
// opponent's legal flood, the sampler and a quarter of a Philox call) on
// 24 B of state that never leaves registers; the state is read and
// written once per launch.  The plies of a game are a serial chain, so a
// game's ply costs the latency of that chain unless other warps fill the
// scheduler's gaps.  With one thread per game the bench's N = 4096 is 128
// warps on 132 SMs: one warp per SM, three of its four schedulers idle,
// and every dependent instruction pays its full latency.
//
// Lane groups: Lanes (1, 2, 4 or 8) threads of a warp play one game
// together.  Lane j floods directions j, j + Lanes, ... of both the flips
// and the legal floods (bitboard.cuh lane_dirs), so N x Lanes threads
// issue the eight independent directions side by side and N = 4096 fills
// 4-8 warps per SM; the group ORs its partial words with a shuffle
// butterfly after each flood, so every lane then holds the same (cur, opp,
// legal) and the pass branch and the reset are uniform within a group.
// What does not split: the sampler and Philox (every lane computes them,
// which costs no extra issue slot in a warp) and the reductions' latency.
// Both choices were measured against their alternatives on the H100
// (PERF.md, PR 6): __reduce_or_sync on each half was 4.37x slower than the
// butterfly, and sampling in the group's first lane and broadcasting the
// move 11% slower than sampling in every lane.  Lanes = 1 is the
// one-thread-per-game kernel of before, with compile-time shifts.
// ops/rollout.py rollout_lanes picks Lanes from N.
//
// Random bits: a Philox4x32-10 written into the kernel, keyed by (seed,
// game) with counter (ply / 4, game >> 32, 0, 0), word ply % 4: every
// Lanes, block size and unroll draws the same words and plays the same
// games.  The second legal flood (the mover again) runs only when the
// opponent must pass.  The episode count is a warp shuffle sum of each
// group's first lane and one atomicAdd per warp.
//
// Parity mode (kWords): the random word of ply i for game g is read from
// words[i * n + g] instead of Philox, so the kernel and the plain ply loop
// agree bit for bit on injected words.  Every kernel has both modes.
//
// K3's knobs are compile-time template parameters of the one kernel:
//   Variant  kFull      K1 itself (the only variant that plays real games);
//            kNoSample  the lowest set legal bit (l & -l) instead of the
//                       uniform pick; the random word goes unused;
//            kNoFlips   the flips are the placed disk only;
//            kNoPass    no mover-again flood: done = the opponent has no
//                       move.
//   Unroll   1, 2 or 4: #pragma unroll on the ply loop.
//   Lanes    1, 2, 4 or 8 threads a game.
// Only what is launched is instantiated (kBuilt below, the rows of
// ops/rollout.py BUILT): kFull at unroll 1 at every Lanes; the stubbed
// variants and unroll 2/4 at Lanes 1 and 4 (what rollout_lanes picks at
// the bench's N = 4096).  Threads per block (32, 64 or 128) is a launch
// parameter, the counterpart of the TPU script's `grid`.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitboard.cuh"

namespace {

// K1's launch: one warp per block, so the N x Lanes / 32 warps spread over
// the 132 SMs as evenly as their count allows (at N = 4096 and Lanes 4,
// 512 blocks: 3-4 warps on every SM, one on each scheduler).
constexpr int kK1Threads = 32;
constexpr int kMaxThreads = 128;

enum Variant : int { kFull = 0, kNoSample = 1, kNoFlips = 2, kNoPass = 3 };

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// _sample_legal: the move index is t = ((r >> 16) * cnt) >> 16, then a
// 5-level popcount search inside the 32-bit half that holds it.
__device__ __forceinline__ uint64_t sample_legal(uint32_t r, uint64_t l) {
  uint32_t l0 = (uint32_t)l, l1 = (uint32_t)(l >> 32);
  int cnt0 = __popc(l0);
  int cnt = cnt0 + __popc(l1);
  int t = (int)(((r >> 16) * (uint32_t)cnt) >> 16);
  bool in_w1 = t >= cnt0;
  if (in_w1) t -= cnt0;
  uint32_t w = in_w1 ? l1 : l0;
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    int cm = __popc(w & (((1u << width) - 1u) << pos));
    if (t >= cm) {
      pos += width;
      t -= cm;
    }
  }
  return 1ull << (pos + (in_w1 ? 32 : 0));
}

// OR of x over the Lanes lanes of a group (`mask`: the group's lanes), a
// shuffle butterfly of log2(Lanes) steps.
template <int Lanes>
__device__ __forceinline__ uint64_t group_or(uint64_t x, unsigned mask) {
#pragma unroll
  for (int off = Lanes / 2; off > 0; off >>= 1)
    x |= __shfl_xor_sync(mask, x, off, Lanes);
  return x;
}

// A group's view of one game: the lane's directions and the group's mask.
template <int Lanes>
struct Group {
  otb::LaneDirs<Lanes> dirs;
  unsigned mask;

  __device__ __forceinline__ uint64_t flips(uint64_t a, uint64_t m,
                                            uint64_t o) const {
    if constexpr (Lanes == 1) {
      return otb::resolve_flips(a, m, o);
    } else {
      return group_or<Lanes>(otb::resolve_flips_lane<Lanes>(a, m, o, dirs),
                             mask);
    }
  }

  __device__ __forceinline__ uint64_t legal(uint64_t m, uint64_t o) const {
    if constexpr (Lanes == 1) {
      return otb::legal_moves(m, o);
    } else {
      return group_or<Lanes>(otb::legal_moves_lane<Lanes>(m, o, dirs),
                             mask) & ~(m | o);
    }
  }
};

// _ply / _ply_variant: one move from the mover's side, `a` the placed disk;
// returns 1 when the game ended (the state is then reset to the opening).
template <Variant V, int Lanes>
__device__ __forceinline__ unsigned ply(uint64_t& c, uint64_t& o,
                                        uint64_t& l, uint64_t a,
                                        const Group<Lanes>& grp) {
  uint64_t f;
  if constexpr (V == kNoFlips) {
    f = a;
  } else {
    f = grp.flips(a, c, o);
  }
  uint64_t nc = c | a | f, no = o & ~f;
  uint64_t lo = grp.legal(no, nc);
  if (lo) {               // opponent to move
    c = no;
    o = nc;
    l = lo;
    return 0;
  }
  if constexpr (V != kNoPass) {
    uint64_t ls = grp.legal(nc, no);
    if (ls) {             // opponent passes, mover again
      c = nc;
      o = no;
      l = ls;
      return 0;
    }
  }
  c = otb::kInitCur;      // neither side can move: game over, reset
  o = otb::kInitOpp;
  l = otb::kInitLegal;
  return 1;
}

template <Variant V, int Unroll, bool kWords, int Lanes>
__global__ void __launch_bounds__(kMaxThreads)
rollout_kernel(const uint64_t* __restrict__ cur_in,
               const uint64_t* __restrict__ opp_in,
               const uint64_t* __restrict__ legal_in,
               uint64_t* __restrict__ cur_out,
               uint64_t* __restrict__ opp_out,
               uint64_t* __restrict__ legal_out,
               unsigned long long* __restrict__ episodes,
               const uint32_t* __restrict__ words, long long n,
               int num_steps, uint32_t seed) {
  // blockDim.x is a multiple of 32, so a group never straddles a warp.
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long g = t / Lanes;
  const int lane = (int)(threadIdx.x % Lanes);
  unsigned eps = 0;
  if (g < n) {            // the same for every lane of a group
    Group<Lanes> grp;
    if constexpr (Lanes > 1) {
      grp.dirs = otb::lane_dirs<Lanes>(lane);
      grp.mask = ((1u << Lanes) - 1u) << ((threadIdx.x & 31) & ~(Lanes - 1));
    }
    uint64_t c = cur_in[g], o = opp_in[g], l = legal_in[g];
    const uint2 key = make_uint2(seed, (uint32_t)g);
    uint4 rnd = make_uint4(0, 0, 0, 0);
#pragma unroll (Unroll)
    for (int i = 0; i < num_steps; ++i) {
      uint64_t a = 0;
      if constexpr (V == kNoSample) {
        a = l & (0ull - l);
      } else {
        uint32_t r;
        if constexpr (kWords) {
          r = words[(long long)i * n + g];
        } else {
          int w = i & 3;
          if (w == 0) {
            rnd = philox4x32_10(
                make_uint4((uint32_t)(i >> 2), (uint32_t)(g >> 32), 0u, 0u),
                key);
          }
          r = w == 0 ? rnd.x : w == 1 ? rnd.y : w == 2 ? rnd.z : rnd.w;
        }
        a = sample_legal(r, l);
      }
      eps += ply<V, Lanes>(c, o, l, a, grp);
    }
    if (lane == 0) {
      cur_out[g] = c;
      opp_out[g] = o;
      legal_out[g] = l;
    }
  }
  if (lane != 0) eps = 0;  // the group's first lane counts its games
  // Every lane of the warp reaches the shuffle, also past the ragged end.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    eps += __shfl_down_sync(0xffffffffu, eps, off);
  if ((threadIdx.x & 31) == 0 && eps)
    atomicAdd(episodes, (unsigned long long)eps);
}

using LaunchFn = void (*)(long long, int, cudaStream_t, const void*,
                          const void*, const void*, void*, void*, void*,
                          void*, const void*, int, unsigned);

template <Variant V, int Unroll, int Lanes>
void launch(long long n, int threads, cudaStream_t s, const void* cur,
            const void* opp, const void* legal, void* cur_out, void* opp_out,
            void* legal_out, void* episodes, const void* words,
            int num_steps, unsigned seed) {
  const unsigned blocks = (unsigned)((n * Lanes + threads - 1) / threads);
  auto* kernel = words ? &rollout_kernel<V, Unroll, true, Lanes>
                       : &rollout_kernel<V, Unroll, false, Lanes>;
  kernel<<<blocks, threads, 0, s>>>(
      (const uint64_t*)cur, (const uint64_t*)opp, (const uint64_t*)legal,
      (uint64_t*)cur_out, (uint64_t*)opp_out, (uint64_t*)legal_out,
      (unsigned long long*)episodes, (const uint32_t*)words, n, num_steps,
      seed);
}

struct Built {
  int variant, unroll, lanes;
  LaunchFn fn;
};

#define OTB_BUILT(V, U, L) \
  { V, U, L, &launch<V, U, L> }

// Every instantiation, and so every combination the C entries accept: the
// rows of ops/rollout.py BUILT.
const Built kBuilt[] = {
    OTB_BUILT(kFull, 1, 1),     OTB_BUILT(kFull, 1, 2),
    OTB_BUILT(kFull, 1, 4),     OTB_BUILT(kFull, 1, 8),
    OTB_BUILT(kNoSample, 1, 1), OTB_BUILT(kNoFlips, 1, 1),
    OTB_BUILT(kNoPass, 1, 1),   OTB_BUILT(kFull, 2, 1),
    OTB_BUILT(kFull, 4, 1),     OTB_BUILT(kNoSample, 1, 4),
    OTB_BUILT(kNoFlips, 1, 4),  OTB_BUILT(kNoPass, 1, 4),
    OTB_BUILT(kFull, 2, 4),     OTB_BUILT(kFull, 4, 4),
};

#undef OTB_BUILT

LaunchFn find_built(int variant, int unroll, int lanes) {
  for (const Built& b : kBuilt) {
    if (b.variant == variant && b.unroll == unroll && b.lanes == lanes)
      return b.fn;
  }
  return nullptr;
}

int run(LaunchFn fn, int threads, const void* cur, const void* opp,
        const void* legal, void* cur_out, void* opp_out, void* legal_out,
        void* episodes, const void* words, long long n, int num_steps,
        unsigned seed, int device, void* stream) {
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    fn(n, threads, (cudaStream_t)stream, cur, opp, legal, cur_out, opp_out,
       legal_out, episodes, words, num_steps, seed);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K1 at `lanes` threads a game (1, 2, 4 or 8).  Returns
// cudaErrorInvalidValue for any other lanes.
extern "C" int otb_rollout(const void* cur, const void* opp,
                           const void* legal, void* cur_out, void* opp_out,
                           void* legal_out, void* episodes, const void* words,
                           long long n, int num_steps, unsigned seed,
                           int lanes, int device, void* stream) {
  return run(find_built(kFull, 1, lanes), kK1Threads, cur, opp, legal,
             cur_out, opp_out, legal_out, episodes, words, n, num_steps,
             seed, device, stream);
}

// K3: variant 0-3 (kFull, kNoSample, kNoFlips, kNoPass), unroll 1, 2 or 4,
// threads per block 32, 64 or 128, lanes 1, 2, 4 or 8, as far as kBuilt
// holds the combination.  Returns cudaErrorInvalidValue for any other
// value.
extern "C" int otb_rollout_variant(const void* cur, const void* opp,
                                   const void* legal, void* cur_out,
                                   void* opp_out, void* legal_out,
                                   void* episodes, const void* words,
                                   long long n, int num_steps, unsigned seed,
                                   int variant, int unroll, int threads,
                                   int lanes, int device, void* stream) {
  if (threads != 32 && threads != 64 && threads != 128)
    return (int)cudaErrorInvalidValue;
  return run(find_built(variant, unroll, lanes), threads, cur, opp, legal,
             cur_out, opp_out, legal_out, episodes, words, n, num_steps,
             seed, device, stream);
}
