// 8x8 Othello rules on one uint64_t per side, for the port's kernels.
//
// Bit k is cell k, row-major (the JAX word pair with w0 | w1 << 32).  The
// floods are the Kogge-Stone forms of gymothelloenv_tpu/core/bitboard.py
// (shift2k / _fill2 / legal_mask2 / resolve_flips2); their plain PyTorch
// twins are in gymothelloenv_tpu_torch/core/bitboard.py.  Everything is
// inlined with compile-time shifts, so a flood is a chain of 64-bit
// shift/and/or instructions in registers.
#pragma once

#include <cstdint>

namespace otb {

// Clears columns < k.
__host__ __device__ constexpr uint64_t col_hi(int k) {
  return k == 1 ? 0xFEFEFEFEFEFEFEFEull
       : k == 2 ? 0xFCFCFCFCFCFCFCFCull : 0xF0F0F0F0F0F0F0F0ull;
}

// Clears columns >= 8 - k.
__host__ __device__ constexpr uint64_t col_lo(int k) {
  return k == 1 ? 0x7F7F7F7F7F7F7F7Full
       : k == 2 ? 0x3F3F3F3F3F3F3F3Full : 0x0F0F0F0F0F0F0F0Full;
}

// Opening position from the mover's (black's) side.
constexpr uint64_t kInitCur = (1ull << 28) | (1ull << 35);
constexpr uint64_t kInitOpp = (1ull << 27) | (1ull << 36);
constexpr uint64_t kInitLegal =
    (1ull << 19) | (1ull << 26) | (1ull << 37) | (1ull << 44);

// Translate the set by K * (DR, DC) cells, dropping bits at the edges.
template <int DR, int DC, int K>
__device__ __forceinline__ uint64_t shift(uint64_t x) {
  constexpr int s = (8 * DR + DC) * K;
  if constexpr (s > 0) {
    x <<= s;
  } else if constexpr (s < 0) {
    x >>= -s;
  }
  if constexpr (DC == 1) {
    x &= col_hi(K);
  } else if constexpr (DC == -1) {
    x &= col_lo(K);
  }
  return x;
}

// The p cells reachable from a g cell by repeated (DR, DC) steps through p.
template <int DR, int DC>
__device__ __forceinline__ uint64_t fill(uint64_t g, uint64_t p) {
  g |= p & shift<DR, DC, 1>(g);
  uint64_t r = p & shift<DR, DC, 1>(p);
  g |= r & shift<DR, DC, 2>(g);
  r &= shift<DR, DC, 2>(r);
  g |= r & shift<DR, DC, 4>(g);
  return g & p;
}

template <int DR, int DC>
__device__ __forceinline__ uint64_t legal_dir(uint64_t m, uint64_t o) {
  return shift<DR, DC, 1>(fill<DR, DC>(m, o));
}

__device__ __forceinline__ uint64_t legal_moves(uint64_t m, uint64_t o) {
  uint64_t l = legal_dir<-1, -1>(m, o) | legal_dir<-1, 0>(m, o) |
               legal_dir<-1, 1>(m, o) | legal_dir<0, -1>(m, o) |
               legal_dir<0, 1>(m, o) | legal_dir<1, -1>(m, o) |
               legal_dir<1, 0>(m, o) | legal_dir<1, 1>(m, o);
  return l & ~(m | o);
}

template <int DR, int DC>
__device__ __forceinline__ uint64_t flips_dir(uint64_t a, uint64_t m,
                                              uint64_t o) {
  uint64_t f = fill<DR, DC>(a, o);
  return (shift<DR, DC, 1>(f) & m) ? f : 0ull;
}

// Disks flipped by placing the single bit a.
__device__ __forceinline__ uint64_t resolve_flips(uint64_t a, uint64_t m,
                                                  uint64_t o) {
  return flips_dir<-1, -1>(a, m, o) | flips_dir<-1, 0>(a, m, o) |
         flips_dir<-1, 1>(a, m, o) | flips_dir<0, -1>(a, m, o) |
         flips_dir<0, 1>(a, m, o) | flips_dir<1, -1>(a, m, o) |
         flips_dir<1, 0>(a, m, o) | flips_dir<1, 1>(a, m, o);
}

}  // namespace otb
