// Kernel K1: num_steps uniformly random legal plies for N games in one
// launch, with auto-reset to the opening.
//
// Replaces gymothelloenv_tpu/ops/pallas_rollout.py::rollout_chunk (kernel
// _make_kernel -> _ply / _sample_legal / _popcount), which kept the state
// as (8, N/8) uint32 tiles in VMEM and drew its bits from the TPU's PRNG.
// Plain twin: ops/rollout.py ply / rollout_chunk_plain; wrapper:
// ops/rollout.py rollout_chunk.
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
// agree bit for bit on injected words.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitboard.cuh"

namespace {

// One warp per block: at N = 4096 that is 128 blocks, spread over 128 of
// the 132 SMs instead of packed four warps deep onto 32 of them.
constexpr int kThreads = 32;

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

// _ply: one random legal move from the mover's side; returns 1 when the
// game ended (the state is then reset to the opening).
__device__ __forceinline__ unsigned ply(uint64_t& c, uint64_t& o,
                                        uint64_t& l, uint32_t r) {
  uint64_t a = sample_legal(r, l);
  uint64_t f = otb::resolve_flips(a, c, o);
  uint64_t nc = c | a | f, no = o & ~f;
  uint64_t lo = otb::legal_moves(no, nc);
  if (lo) {               // opponent to move
    c = no;
    o = nc;
    l = lo;
    return 0;
  }
  uint64_t ls = otb::legal_moves(nc, no);
  if (ls) {               // opponent passes, mover again
    c = nc;
    o = no;
    l = ls;
    return 0;
  }
  c = otb::kInitCur;      // neither side can move: game over, reset
  o = otb::kInitOpp;
  l = otb::kInitLegal;
  return 1;
}

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const uint64_t* __restrict__ cur_in,
               const uint64_t* __restrict__ opp_in,
               const uint64_t* __restrict__ legal_in,
               uint64_t* __restrict__ cur_out,
               uint64_t* __restrict__ opp_out,
               uint64_t* __restrict__ legal_out,
               unsigned long long* __restrict__ episodes,
               const uint32_t* __restrict__ words, long long n,
               int num_steps, uint32_t seed) {
  long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  unsigned eps = 0;
  if (g < n) {
    uint64_t c = cur_in[g], o = opp_in[g], l = legal_in[g];
    const uint2 key = make_uint2(seed, (uint32_t)g);
    uint4 rnd = make_uint4(0, 0, 0, 0);
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
      eps += ply(c, o, l, r);
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

}  // namespace

extern "C" int otb_rollout(const void* cur, const void* opp,
                           const void* legal, void* cur_out, void* opp_out,
                           void* legal_out, void* episodes, const void* words,
                           long long n, int num_steps, unsigned seed,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    cudaStream_t s = (cudaStream_t)stream;
    if (words) {
      rollout_kernel<true><<<blocks, kThreads, 0, s>>>(
          (const uint64_t*)cur, (const uint64_t*)opp, (const uint64_t*)legal,
          (uint64_t*)cur_out, (uint64_t*)opp_out, (uint64_t*)legal_out,
          (unsigned long long*)episodes, (const uint32_t*)words, n,
          num_steps, seed);
    } else {
      rollout_kernel<false><<<blocks, kThreads, 0, s>>>(
          (const uint64_t*)cur, (const uint64_t*)opp, (const uint64_t*)legal,
          (uint64_t*)cur_out, (uint64_t*)opp_out, (uint64_t*)legal_out,
          (unsigned long long*)episodes, nullptr, n, num_steps, seed);
    }
  }
  return (int)cudaGetLastError();
}
