// Kernel K2: legal placements for N boards.
//
// Replaces gymothelloenv_tpu/ops/pallas_bitboard.py::legal_mask_pallas
// (kernel _legal_kernel), an 8-direction occluded dumb7fill over (2, N)
// uint32 tiles padded to 1024 boards.  Plain twin: core/bitboard.py
// legal_mask; wrapper: ops/legal_mask.py.
//
// Bound on Hopper: memory.  Each board reads 16 B and writes 8 B, against
// about 160 64-bit logic operations (8 directions x one 3-level
// Kogge-Stone flood), so at one thread per board the integer pipes idle
// behind device memory for large N; at the evaluation's N of about a
// thousand boards the launch itself dominates.  Design: one thread per
// board, one coalesced 8 B load per side and one 8 B store, the whole
// flood in registers (Kogge-Stone: 3 doubling steps instead of the TPU
// kernel's 6 single steps); the ragged tail is masked, so nothing is
// padded and nothing is allocated.  Launches on the caller's stream.
#include <cuda_runtime.h>

#include <cstdint>

#include "bitboard.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
legal_mask_kernel(const uint64_t* __restrict__ mine,
                  const uint64_t* __restrict__ opp,
                  uint64_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = otb::legal_moves(mine[i], opp[i]);
}

}  // namespace

extern "C" int otb_legal_mask(const void* mine, const void* opp, void* out,
                              long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    legal_mask_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const uint64_t*)mine, (const uint64_t*)opp, (uint64_t*)out, n);
  }
  return (int)cudaGetLastError();
}
