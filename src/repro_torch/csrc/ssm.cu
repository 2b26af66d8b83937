// K7 and K8: the recurrent scans of the serve path, for sm_90a.
//
// K7 repro_rwkv6_scan replaces the Pallas `rwkv6_scan`
// (src/repro/kernels/rwkv6_scan.py): the RWKV-6 wkv recurrence per
// (b, h) with a (Dk, Dv) state,
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t.
// K8 repro_mamba2_ssd replaces the Pallas `mamba2_ssd`
// (src/repro/kernels/mamba2_ssd.py): the Mamba-2 SSD recurrence per (b, h)
// with an (N, P) state and a scalar decay,
//     H_t = exp(a_t) H_{t-1} + B_t^T x_t,  y_t = C_t H_t   (no D skip).
//
// On the TPU both run the chunked matrix form: the grid walks T's chunks
// in order with the state in VMEM scratch, and the intra-chunk terms are
// MXU products over (C, C) decay ratios built from cumulative sums of
// log-decay.  Here the state never leaves registers: one block per (b, h),
// thread j owns column j of the state (Dk or N floats), and the block
// walks T step by step, staging TC = 16 steps of its inputs in shared
// memory at a time (r/k/w/u*k for K7, B/C/exp(a) for K8 are read by every
// thread at the same address: broadcasts).  A step costs each thread
// 2 multiply-adds per state row, with no reduction across threads, and
// every factor it multiplies the state by is a decay in [0, 1]: there are
// no ratios of cumulative products, so a decay of exactly 0 (which makes
// the Pallas K7's log-space ratios -inf - -inf = NaN) gives finite output,
// and any T works (the tail tile is just shorter: the Pallas kernels assert
// T % chunk == 0).  Bound on the card: bytes (each input read once, each
// output written once); this version runs fp32 FMAs, and the chunked
// tensor-core form (mma/wgmma over the chunk's decay-ratio products) is
// later work.
//
// Both take fp32 or bf16 (dtype 0 / 1) for r/k/v/w/u and x, with outputs
// in v's / x's type; log_a, B and C are fp32; the final states are fp32.
// State widths (Dk for K7, N for K8) 16, 32, 64 and 128; Dv and P up to
// 1024.  Every launcher returns cudaGetLastError() (0 = success).

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// Time steps staged in shared memory per tile.  16 keeps a block's stage
// at 20 KB (K7, Dk = Dv = 64) and 12 KB (K8, N = P = 64), so registers,
// not shared memory, bound the blocks an SM holds (10 at ~96 registers):
// the serve shapes' 1,024 and 1,280 blocks then fit in one wave of the
// H100's 132 SMs.  32 steps (40 KB, 25 KB) allowed 5 and 9 blocks: two
// waves.
constexpr int TC = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

inline int threads_for(int cols) { return (cols + 31) / 32 * 32; }

// ---------------------------------------------------------------------------
// K7 RWKV-6 wkv

template <int DK>
size_t rwkv6_smem(int dv) {
  // R, K, W and U*K [TC][DK], V [TC][dv]
  return sizeof(float) * ((size_t)4 * TC * DK + (size_t)TC * dv);
}

template <typename T, int DK>
__global__ void rwkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ w,
                          const T* __restrict__ u, T* __restrict__ o,
                          float* __restrict__ state, int H, int nt, int dv) {
  static_assert(DK % 4 == 0, "state rows in float4 groups");
  extern __shared__ float4 smem4[];
  float* Rs = reinterpret_cast<float*>(smem4);
  float* Ks = Rs + TC * DK;
  float* Ws = Ks + TC * DK;
  float* Us = Ws + TC * DK;
  float* Vs = Us + TC * DK;

  const int bh = blockIdx.x, h = bh % H;
  const int j = threadIdx.x;
  const bool active = j < dv;
  const size_t kb = (size_t)bh * nt * DK, vb = (size_t)bh * nt * dv;
  const T* ub = u + (size_t)h * DK;

  float S[DK];
#pragma unroll
  for (int c = 0; c < DK; ++c) S[c] = 0.f;

  for (int t0 = 0; t0 < nt; t0 += TC) {
    const int n = min(TC, nt - t0);
    __syncthreads();  // the last tile's reads are done
    for (int i = threadIdx.x; i < n * DK; i += blockDim.x) {
      const size_t gi = kb + (size_t)t0 * DK + i;
      const float kk = to_f(k[gi]);
      Rs[i] = to_f(r[gi]);
      Ks[i] = kk;
      Ws[i] = to_f(w[gi]);
      Us[i] = to_f(ub[i % DK]) * kk;
    }
    for (int i = threadIdx.x; i < n * dv; i += blockDim.x)
      Vs[i] = to_f(v[vb + (size_t)t0 * dv + i]);
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < n; ++tt) {
      const float vv = Vs[tt * dv + j];
      const float4* r4 = reinterpret_cast<const float4*>(Rs + tt * DK);
      const float4* k4 = reinterpret_cast<const float4*>(Ks + tt * DK);
      const float4* w4 = reinterpret_cast<const float4*>(Ws + tt * DK);
      const float4* u4 = reinterpret_cast<const float4*>(Us + tt * DK);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c4 = 0; c4 < DK / 4; ++c4) {
        const float4 rr = r4[c4], kk = k4[c4], ww = w4[c4], uk = u4[c4];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
        const float uv[4] = {uk.x, uk.y, uk.z, uk.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s = S[4 * c4 + e];
          // o += r (S + u k v), then S = w S + k v
          acc[e] = fmaf(rv[e], fmaf(uv[e], vv, s), acc[e]);
          s = fmaf(wv[e], s, kv[e] * vv);
        }
      }
      o[vb + (size_t)(t0 + tt) * dv + j] =
          from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  if (active) {
    float* sb = state + (size_t)bh * DK * dv;
#pragma unroll
    for (int c = 0; c < DK; ++c) sb[(size_t)c * dv + j] = S[c];
  }
}

template <typename T, int DK>
int launch_rwkv6(const void* r, const void* k, const void* v, const void* w,
                 const void* u, void* o, float* state, int64_t B, int64_t H,
                 int64_t nt, int dv, cudaStream_t stream) {
  const size_t smem = rwkv6_smem<DK>(dv);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_fwd<T, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  rwkv6_fwd<T, DK><<<(unsigned)(B * H), threads_for(dv), smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<T*>(o), state, (int)H, (int)nt, dv);
  return cudaGetLastError();
}

template <typename T>
int rwkv6_by_dim(int dk, const void* r, const void* k, const void* v,
                 const void* w, const void* u, void* o, float* state,
                 int64_t B, int64_t H, int64_t nt, int dv, cudaStream_t st) {
  switch (dk) {
    case 16: return launch_rwkv6<T, 16>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 32: return launch_rwkv6<T, 32>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 64: return launch_rwkv6<T, 64>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 128: return launch_rwkv6<T, 128>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K8 Mamba-2 SSD

template <int N>
size_t ssd_smem(int p) {
  // B, C [TC][N], X [TC][p], exp(a) [TC]
  return sizeof(float) * ((size_t)2 * TC * N + (size_t)TC * p + TC);
}

template <typename T, int N>
__global__ void ssd_fwd(const T* __restrict__ x, const float* __restrict__ la,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm, T* __restrict__ y,
                        float* __restrict__ state, int H, int nt, int p) {
  static_assert(N % 4 == 0, "state rows in float4 groups");
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);
  float* Cs = Bs + TC * N;
  float* Xs = Cs + TC * N;
  float* As = Xs + TC * p;

  const int bh = blockIdx.x, b = bh / H;
  const int j = threadIdx.x;
  const bool active = j < p;
  const size_t xb = (size_t)bh * nt * p;
  const size_t nb = (size_t)b * nt * N;  // B and C are shared by the heads
  const float* lb = la + (size_t)bh * nt;

  float S[N];
#pragma unroll
  for (int c = 0; c < N; ++c) S[c] = 0.f;

  for (int t0 = 0; t0 < nt; t0 += TC) {
    const int n = min(TC, nt - t0);
    __syncthreads();  // the last tile's reads are done
    for (int i = threadIdx.x; i < n * N; i += blockDim.x) {
      const size_t gi = nb + (size_t)t0 * N + i;
      Bs[i] = Bm[gi];
      Cs[i] = Cm[gi];
    }
    for (int i = threadIdx.x; i < n * p; i += blockDim.x)
      Xs[i] = to_f(x[xb + (size_t)t0 * p + i]);
    for (int i = threadIdx.x; i < n; i += blockDim.x) As[i] = expf(lb[t0 + i]);
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < n; ++tt) {
      const float xv = Xs[tt * p + j], a = As[tt];
      const float4* b4 = reinterpret_cast<const float4*>(Bs + tt * N);
      const float4* c4p = reinterpret_cast<const float4*>(Cs + tt * N);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c4 = 0; c4 < N / 4; ++c4) {
        const float4 bb = b4[c4], cc = c4p[c4];
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
        const float cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& s = S[4 * c4 + e];
          // H = exp(a) H + B x, then y += C H
          s = fmaf(a, s, bv[e] * xv);
          acc[e] = fmaf(cv[e], s, acc[e]);
        }
      }
      y[xb + (size_t)(t0 + tt) * p + j] =
          from_f<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  if (active) {
    float* sb = state + (size_t)bh * N * p;
#pragma unroll
    for (int c = 0; c < N; ++c) sb[(size_t)c * p + j] = S[c];
  }
}

template <typename T, int N>
int launch_ssd(const void* x, const float* la, const float* Bm,
               const float* Cm, void* y, float* state, int64_t B, int64_t H,
               int64_t nt, int p, cudaStream_t stream) {
  const size_t smem = ssd_smem<N>(p);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ssd_fwd<T, N><<<(unsigned)(B * H), threads_for(p), smem, stream>>>(
      static_cast<const T*>(x), la, Bm, Cm, static_cast<T*>(y), state, (int)H,
      (int)nt, p);
  return cudaGetLastError();
}

template <typename T>
int ssd_by_dim(int n, const void* x, const float* la, const float* Bm,
               const float* Cm, void* y, float* state, int64_t B, int64_t H,
               int64_t nt, int p, cudaStream_t st) {
  switch (n) {
    case 16: return launch_ssd<T, 16>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 32: return launch_ssd<T, 32>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 64: return launch_ssd<T, 64>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 128: return launch_ssd<T, 128>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// (r, k, v, w, u, o, state, B, H, T, Dk, Dv, dtype, stream): r/k/w
// (B, H, T, Dk), v/o (B, H, T, Dv), u (H, Dk), state (B, H, Dk, Dv) fp32
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* w, const void* u, void* o,
                                void* state, int64_t B, int64_t H, int64_t T,
                                int dk, int dv, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(state);
  if (dv < 1 || dv > 1024) return cudaErrorInvalidValue;
  if (dtype == 0)
    return rwkv6_by_dim<float>(dk, r, k, v, w, u, o, s, B, H, T, dv, st);
  if (dtype == 1)
    return rwkv6_by_dim<__nv_bfloat16>(dk, r, k, v, w, u, o, s, B, H, T, dv, st);
  return cudaErrorInvalidValue;
}

// (x, log_a, Bm, Cm, y, state, B, H, T, N, P, dtype, stream): x/y
// (B, H, T, P), log_a (B, H, T) fp32, Bm/Cm (B, T, N) fp32, state
// (B, H, N, P) fp32
extern "C" int repro_mamba2_ssd(const void* x, const void* log_a,
                                const void* Bm, const void* Cm, void* y,
                                void* state, int64_t B, int64_t H, int64_t T,
                                int n, int p, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* bm = static_cast<const float*>(Bm);
  const float* cm = static_cast<const float*>(Cm);
  float* s = static_cast<float*>(state);
  if (p < 1 || p > 1024) return cudaErrorInvalidValue;
  if (dtype == 0)
    return ssd_by_dim<float>(n, x, la, bm, cm, y, s, B, H, T, p, st);
  if (dtype == 1)
    return ssd_by_dim<__nv_bfloat16>(n, x, la, bm, cm, y, s, B, H, T, p, st);
  return cudaErrorInvalidValue;
}
