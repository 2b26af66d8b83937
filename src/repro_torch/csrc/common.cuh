// Shared pieces of the port's CUDA kernels: the C error-string export
// every library carries, a block-wide inclusive scan, and the 4 x 4
// byte-block transpose.  Each library compiles exactly one .cu that includes this.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace repro {

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Inclusive scan of one value per thread over a block of NT threads
// (warp shuffles, then one warp scans the warp totals).  Unsigned T: the
// sums wrap modulo 2^bits, which is two's-complement addition of the
// signed values.  `total` gets the block's sum.  Every thread of the
// block must call it; `warp_sums` is shared scratch of NT / 32 values.
template <typename T, int NT>
__device__ __forceinline__ T block_inclusive_scan(T v, T* warp_sums, T& total) {
  static_assert(NT % 32 == 0 && NT / 32 <= 32, "block of 32..1024 threads");
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T w = lane < NW ? warp_sums[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < NW) warp_sums[lane] = w;
  }
  __syncthreads();
  total = warp_sums[NW - 1];
  const T out = v + (warp ? warp_sums[warp - 1] : T(0));
  __syncthreads();  // warp_sums is reused by the next call
  return out;
}

// 4 x 4 byte-block transpose in registers (eight `prmt`): on entry word i
// of `w` is row i; on exit word j holds byte j of rows 0..3, row i in its
// byte i.  __byte_perm(x, y, s) takes result byte n from byte (s >> 4n) &
// 7 of the pair, x's bytes numbered 0-3 and y's 4-7.
__device__ __forceinline__ void transpose4x4(uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);  // a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);  // c0 d0 c1 d1
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);  // c2 d2 c3 d3
  w[0] = __byte_perm(t0, t2, 0x5410);                   // a0 b0 c0 d0
  w[1] = __byte_perm(t0, t2, 0x7632);                   // a1 b1 c1 d1
  w[2] = __byte_perm(t1, t3, 0x5410);                   // a2 b2 c2 d2
  w[3] = __byte_perm(t1, t3, 0x7632);                   // a3 b3 c3 d3
}

}  // namespace repro
