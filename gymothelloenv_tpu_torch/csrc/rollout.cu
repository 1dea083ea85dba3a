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
// Bound on Hopper: integer operations and their latency, not memory.  A
// ply is about 360 64-bit logic operations (the sampled move's flips and
// the opponent's legal flood), about 800 32-bit instructions, on 24 B of
// state that never leaves registers; the state is read and written once
// per launch.  Design: one thread per game, the mover-perspective (cur,
// opp, legal) words in registers across the whole ply loop; the second
// legal flood (the mover again) runs only when the opponent must pass; the
// random bits come from a Philox4x32-10 written into the kernel, keyed by
// (seed, game) with the ply as counter, one call per four plies; the
// episode count is a warp shuffle reduction and one atomicAdd per warp.
//
// Occupancy: at the bench's N = 4096 one thread per game is 128 warps on
// 132 SMs, at most one warp per SM, so the card is mostly idle and each ply
// pays the full latency of its dependency chain.  Correct first; spreading
// a game's eight directions over lanes is work for a later change.
//
// Parity mode (kWords): the random word of ply i for game g is read from
// words[i * n + g] instead of Philox, so the kernel and the plain ply loop
// agree bit for bit on injected words.  Every variant has both modes.
//
// K3's knobs are compile-time template parameters of the one kernel:
//   Variant  kFull      K1 itself (the only variant that plays real games);
//            kNoSample  the lowest set legal bit (l & -l) instead of the
//                       uniform pick; the random word goes unused;
//            kNoFlips   the flips are the placed disk only;
//            kNoPass    no mover-again flood: done = the opponent has no
//                       move.
//   Unroll   1, 2 or 4: #pragma unroll on the ply loop; 2 and 4 are
//            instantiated for kFull alone (the profiler's only unrolled
//            configurations), which halves the nvcc time.
// and threads per block (32, 64 or 128) is a launch parameter, the
// counterpart of the TPU script's `grid` (2 or 4 programs, each seeded
// with seed + program_id).  Philox here is keyed by (seed, game), not by
// block, so every block size gives the SAME words and the same result.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitboard.cuh"

namespace {

// K1's launch: one warp per block.  At N = 4096 that is 128 blocks, spread
// over 128 of the 132 SMs instead of packed four warps deep onto 32 of
// them.
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

// _ply / _ply_variant: one move from the mover's side; returns 1 when the
// game ended (the state is then reset to the opening).
template <Variant V>
__device__ __forceinline__ unsigned ply(uint64_t& c, uint64_t& o,
                                        uint64_t& l, uint32_t r) {
  uint64_t a;
  if constexpr (V == kNoSample) {
    a = l & (0ull - l);
  } else {
    a = sample_legal(r, l);
  }
  uint64_t f;
  if constexpr (V == kNoFlips) {
    f = a;
  } else {
    f = otb::resolve_flips(a, c, o);
  }
  uint64_t nc = c | a | f, no = o & ~f;
  uint64_t lo = otb::legal_moves(no, nc);
  if (lo) {               // opponent to move
    c = no;
    o = nc;
    l = lo;
    return 0;
  }
  if constexpr (V != kNoPass) {
    uint64_t ls = otb::legal_moves(nc, no);
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

template <Variant V, int Unroll, bool kWords>
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
  long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned eps = 0;
  if (g < n) {
    uint64_t c = cur_in[g], o = opp_in[g], l = legal_in[g];
    const uint2 key = make_uint2(seed, (uint32_t)g);
    uint4 rnd = make_uint4(0, 0, 0, 0);
#pragma unroll (Unroll)
    for (int i = 0; i < num_steps; ++i) {
      uint32_t r;
      if constexpr (kWords) {
        r = words[(long long)i * n + g];
      } else {
        int lane = i & 3;
        if (lane == 0) {
          rnd = philox4x32_10(
              make_uint4((uint32_t)(i >> 2), (uint32_t)(g >> 32), 0u, 0u),
              key);
        }
        r = lane == 0 ? rnd.x : lane == 1 ? rnd.y : lane == 2 ? rnd.z : rnd.w;
      }
      eps += ply<V>(c, o, l, r);
    }
    cur_out[g] = c;
    opp_out[g] = o;
    legal_out[g] = l;
  }
  // Every lane of the warp reaches the shuffle, also past the ragged end.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    eps += __shfl_down_sync(0xffffffffu, eps, off);
  if ((threadIdx.x & 31) == 0 && eps)
    atomicAdd(episodes, (unsigned long long)eps);
}

template <Variant V, int Unroll>
void launch(unsigned blocks, int threads, cudaStream_t s, const void* cur,
            const void* opp, const void* legal, void* cur_out, void* opp_out,
            void* legal_out, void* episodes, const void* words, long long n,
            int num_steps, unsigned seed) {
  if (words) {
    rollout_kernel<V, Unroll, true><<<blocks, threads, 0, s>>>(
        (const uint64_t*)cur, (const uint64_t*)opp, (const uint64_t*)legal,
        (uint64_t*)cur_out, (uint64_t*)opp_out, (uint64_t*)legal_out,
        (unsigned long long*)episodes, (const uint32_t*)words, n, num_steps,
        seed);
  } else {
    rollout_kernel<V, Unroll, false><<<blocks, threads, 0, s>>>(
        (const uint64_t*)cur, (const uint64_t*)opp, (const uint64_t*)legal,
        (uint64_t*)cur_out, (uint64_t*)opp_out, (uint64_t*)legal_out,
        (unsigned long long*)episodes, nullptr, n, num_steps, seed);
  }
}

}  // namespace

extern "C" int otb_rollout(const void* cur, const void* opp,
                           const void* legal, void* cur_out, void* opp_out,
                           void* legal_out, void* episodes, const void* words,
                           long long n, int num_steps, unsigned seed,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    unsigned blocks = (unsigned)((n + kK1Threads - 1) / kK1Threads);
    launch<kFull, 1>(blocks, kK1Threads, (cudaStream_t)stream, cur, opp,
                     legal, cur_out, opp_out, legal_out, episodes, words, n,
                     num_steps, seed);
  }
  return (int)cudaGetLastError();
}

// K3: variant 0-3 (kFull, kNoSample, kNoFlips, kNoPass), unroll 1, 2 or 4
// (2 and 4 with kFull only), threads per block 32, 64 or 128.  Returns
// cudaErrorInvalidValue for any other value.
extern "C" int otb_rollout_variant(const void* cur, const void* opp,
                                   const void* legal, void* cur_out,
                                   void* opp_out, void* legal_out,
                                   void* episodes, const void* words,
                                   long long n, int num_steps, unsigned seed,
                                   int variant, int unroll, int threads,
                                   int device, void* stream) {
  if (threads != 32 && threads != 64 && threads != 128)
    return (int)cudaErrorInvalidValue;
  if (unroll != 1 && unroll != 2 && unroll != 4)
    return (int)cudaErrorInvalidValue;
  if (variant < kFull || variant > kNoPass) return (int)cudaErrorInvalidValue;
  if (unroll != 1 && variant != kFull) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    unsigned blocks = (unsigned)((n + threads - 1) / threads);
    auto* fn = variant == kNoSample  ? &launch<kNoSample, 1>
               : variant == kNoFlips ? &launch<kNoFlips, 1>
               : variant == kNoPass  ? &launch<kNoPass, 1>
               : unroll == 4         ? &launch<kFull, 4>
               : unroll == 2         ? &launch<kFull, 2>
                                     : &launch<kFull, 1>;
    fn(blocks, threads, (cudaStream_t)stream, cur, opp, legal, cur_out,
       opp_out, legal_out, episodes, words, n, num_steps, seed);
  }
  return (int)cudaGetLastError();
}
