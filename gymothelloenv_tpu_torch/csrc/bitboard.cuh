// 8x8 Othello rules on one uint64_t per side, for the port's kernels.
//
// Bit k is cell k, row-major (the JAX word pair with w0 | w1 << 32).  The
// floods are the Kogge-Stone forms of gymothelloenv_tpu/core/bitboard.py
// (shift2k / _fill2 / legal_mask2 / resolve_flips2); their plain PyTorch
// twins are in gymothelloenv_tpu_torch/core/bitboard.py.  Everything is
// inlined with compile-time shifts, so a flood is a chain of 64-bit
// shift/and/or instructions in registers.
//
// The second half holds the same floods for a group of Lanes threads that
// share one game: lane j floods directions j, j + Lanes, ... of DIRECTIONS
// (core/bitboard.py lane_directions; plain twins legal_mask_lane and
// resolve_flips_lane), so the OR of the group's partial words is the whole
// flood.  A lane's directions are known only at run time, so their shifts
// and column masks live in registers (Dir); the direction's sign is a
// template parameter wherever it is the same for every lane.
#pragma once

#include <cstdint>
#include <utility>

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

// --- one game's directions spread over a group of Lanes threads ----------

// DIRECTIONS[d] = (dr, dc) of core/bitboard.py, d = 0..7.  Directions 0-3
// step towards lower bits, 4-7 towards higher, and 7 - d is d reversed.
__host__ __device__ constexpr int dir_dr(int d) {
  return d < 3 ? -1 : d < 5 ? 0 : 1;
}
__host__ __device__ constexpr int dir_dc(int d) {
  return (d == 1 || d == 6) ? 0 : (d == 2 || d == 4 || d == 7) ? 1 : -1;
}

// A direction held in registers: a 1-cell step is x << ls >> rs (one of the
// two is 0) masked with col[0]; 2- and 4-cell steps scale the shift and use
// col[1], col[2].  The same translation as shift<DR, DC, K>.
struct Dir {
  int ls, rs;
  uint64_t col[3];
};

__device__ __forceinline__ Dir make_dir(int d) {
  const int dc = dir_dc(d), s = 8 * dir_dr(d) + dc;
  Dir r;
  r.ls = s > 0 ? s : 0;
  r.rs = s < 0 ? -s : 0;
  r.col[0] = dc > 0 ? col_hi(1) : dc < 0 ? col_lo(1) : ~0ull;
  r.col[1] = dc > 0 ? col_hi(2) : dc < 0 ? col_lo(2) : ~0ull;
  r.col[2] = dc > 0 ? col_hi(4) : dc < 0 ? col_lo(4) : ~0ull;
  return r;
}

// Sign > 0: every lane's direction steps towards higher bits; < 0: lower;
// 0: it differs between lanes, so both shifts run (one of them by 0).
template <int Sign, int K>
__device__ __forceinline__ uint64_t vshift(uint64_t x, const Dir& d) {
  constexpr int i = K == 1 ? 0 : K == 2 ? 1 : 2;
  if constexpr (Sign > 0) {
    x <<= d.ls * K;
  } else if constexpr (Sign < 0) {
    x >>= d.rs * K;
  } else {
    x = (x << (d.ls * K)) >> (d.rs * K);
  }
  return x & d.col[i];
}

template <int Sign>
__device__ __forceinline__ uint64_t vfill(uint64_t g, uint64_t p,
                                          const Dir& d) {
  g |= p & vshift<Sign, 1>(g, d);
  uint64_t r = p & vshift<Sign, 1>(p, d);
  g |= r & vshift<Sign, 2>(g, d);
  r &= vshift<Sign, 2>(r, d);
  g |= r & vshift<Sign, 4>(g, d);
  return g & p;
}

// Lane `lane`'s directions: dir[k] is DIRECTIONS[lane + k * Lanes].
template <int Lanes>
struct LaneDirs {
  Dir dir[8 / Lanes];
};

template <int Lanes>
__device__ __forceinline__ LaneDirs<Lanes> lane_dirs(int lane) {
  LaneDirs<Lanes> r;
#pragma unroll
  for (int k = 0; k < 8 / Lanes; ++k) r.dir[k] = make_dir(lane + k * Lanes);
  return r;
}

// The sign of direction lane + k * Lanes, for every lane at once: with
// Lanes <= 4 the first 4 / Lanes of a lane's directions step towards lower
// bits and the rest towards higher; with Lanes == 8 it depends on the lane.
template <int Lanes, int k>
__host__ __device__ constexpr int lane_sign() {
  return Lanes == 8 ? 0 : (k < 4 / Lanes ? -1 : 1);
}

// The lane's share of legal_moves, before the mask of empty cells: OR over
// the group and then `& ~(m | o)` is legal_moves(m, o).
template <int Lanes, std::size_t... k>
__device__ __forceinline__ uint64_t legal_moves_part(
    uint64_t m, uint64_t o, const LaneDirs<Lanes>& ld,
    std::index_sequence<k...>) {
  return (0ull | ... |
          vshift<lane_sign<Lanes, k>(), 1>(
              vfill<lane_sign<Lanes, k>()>(m, o, ld.dir[k]), ld.dir[k]));
}

template <int Lanes>
__device__ __forceinline__ uint64_t legal_moves_lane(
    uint64_t m, uint64_t o, const LaneDirs<Lanes>& ld) {
  return legal_moves_part<Lanes>(m, o, ld,
                                 std::make_index_sequence<8 / Lanes>{});
}

template <int Sign>
__device__ __forceinline__ uint64_t flips_vdir(uint64_t a, uint64_t m,
                                               uint64_t o, const Dir& d) {
  uint64_t f = vfill<Sign>(a, o, d);
  return (vshift<Sign, 1>(f, d) & m) ? f : 0ull;
}

// The lane's share of resolve_flips: OR over the group is the flips.
template <int Lanes, std::size_t... k>
__device__ __forceinline__ uint64_t resolve_flips_part(
    uint64_t a, uint64_t m, uint64_t o, const LaneDirs<Lanes>& ld,
    std::index_sequence<k...>) {
  return (0ull | ... | flips_vdir<lane_sign<Lanes, k>()>(a, m, o, ld.dir[k]));
}

template <int Lanes>
__device__ __forceinline__ uint64_t resolve_flips_lane(
    uint64_t a, uint64_t m, uint64_t o, const LaneDirs<Lanes>& ld) {
  return resolve_flips_part<Lanes>(a, m, o, ld,
                                   std::make_index_sequence<8 / Lanes>{});
}

}  // namespace otb
