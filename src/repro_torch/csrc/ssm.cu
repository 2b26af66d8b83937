// K7 and K8: the recurrent scans of the serve path, for sm_90a.
//
// K7 repro_rwkv6_scan replaces the Pallas `rwkv6_scan`
// (src/repro/kernels/rwkv6_scan.py): the RWKV-6 wkv recurrence per (b, h)
// with a (Dk, Dv) state,
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),  S_t = diag(w_t) S_{t-1} + k_t^T v_t.
// K8 repro_mamba2_ssd replaces the Pallas `mamba2_ssd`
// (src/repro/kernels/mamba2_ssd.py): the Mamba-2 SSD recurrence per (b, h)
// with an (N, P) state and a scalar decay,
//     H_t = exp(a_t) H_{t-1} + B_t^T x_t,  y_t = C_t H_t   (no D skip).
//
// Bound on the card: bytes (each input read once, each output written
// once); at the serve shapes 0.20 ms (K7) and 0.11 ms (K8).
//
// K7, and K8 with fp32 x ("simt steps"): the state never leaves
// registers.  One block per (b, h), thread j owns column j of the state
// (Dk or N floats), and the block walks T step by step, staging TC = 16
// steps of its inputs in shared memory at a time (r/k/w/u*k for K7,
// B/C/exp(a) for K8 are read by every thread at the same address:
// broadcasts).  A step costs each thread 2 multiply-adds per state row,
// a dependent chain on the CUDA cores, which bounds these kernels well
// above the bytes.  Every factor the state is multiplied by is a decay in
// [0, 1]: a decay of exactly 0 (which makes the Pallas K7's log-space
// ratios -inf - -inf = NaN) gives finite output, and any T works (the
// Pallas kernels assert T % chunk == 0).  K8's fp32 route stays here:
// fp32 x is not exact in bf16, and its output is held to 1e-4, finer
// than the bf16 route's two-piece operands keep.
//
// K8 with bf16 x, the serve dtype ("chunked split-bf16 mma",
// ssd_chunked): the chunked matrix form of the TPU kernel, on the tensor
// cores.  Per chunk of Q = 64 steps from `start`, with
// seg(t, s) = sum_{k=s+1..t} a_k,
//     y  = ((C B^T) o L) x + diag(e^{seg(t, start)}) C H,  L[t,s] = e^{seg(t,s)}, s <= t
//     H <- e^{seg(end, start)} H + (B o e^{seg(end, s)})^T x.
// A block takes (b, HG heads, a 64-wide tile of P): columns of P are
// independent, so P up to 1024 is grid size.  Four warps per head; warp w
// owns rows 16w..16w+15 of the chunk's y and state row tiles w, w + 4, ...
// of (N, 64), with w rotated by the head so that each of the SM's four
// schedulers gets a mix of the causal work.  The state stays in fp32
// accumulator registers across the chunks; a copy in two bf16 pieces
// goes to shared memory for the next chunk's C H.  B and C are shared by
// every head of a sequence: each chunk's B, C, x and a are staged once
// per block by cp.async into a 2-stage ring, and C B^T is computed once
// per block, its 32 tiles spread over all the block's warps, in the same
// pass over n as each warp's C H (one set of C fragments feeds both).
// Products run as mma.sync m16n8k16 bf16 with fp32 accumulation; x is
// bf16, exact, and its fragments (and the state's) come by ldmatrix.  B,
// C and the state are fp32: each enters a product as bf16 pieces (the
// rounding, then the rounding of the rest, ...).  C B^T and C H take two
// pieces a side (~16 bits) and the three products hi hi + hi lo + lo hi;
// (C B^T o L) x and the state update (B o decay)^T x take two pieces of
// their fp32 factor.  Two pieces of B o decay leave the final state at
// ~0.4 of its 1e-4 tolerance; three (all 24 bits) hold it at ~0.01 but
// made the kernel 4.7 % slower (PERF.md §6).  One rounding instead misses
// the tolerances by 7-12x (a CPU emulation of this algorithm,
// tests/test_torch_ssm.py); TF32 operands, as the products of m16n8k8,
// miss y's 1e-2 too unless split, and split they cost twice the
// instructions of bf16 pieces.  Decays: sums of a within
// the chunk in fp64, every decay from an fp64 difference of two sums (in
// fp32 a difference at a ~ -1e4 loses 1e-3); each a is floored at -128
// first, whose e^{-128} is 0 in fp32 as e^{a} of any smaller a is, so
// a = -inf gives a decay of exactly 0 and no NaN (for a <= 0, as the
// model gives).  Any T: the last chunk is padded with a = 0, B = C = 0,
// x = 0 (the state is untouched) and only rows < T are stored.  What
// bounds it: the instruction issue of the fragments' splits and loads
// and the barriers of each chunk (three), at 12 warps an SM (one block,
// 168 registers a thread), not the tensor pipe.

// K7 takes fp32 or bf16 (dtype 0 / 1) for r/k/v/w/u, K8 fp32 or bf16 x;
// outputs in v's / x's type; log_a, B and C are fp32; the final states
// are fp32.  State widths (Dk for K7, N for K8) 16, 32, 48, 64 and 128;
// Dv and P up to 1024.  Every launcher returns cudaGetLastError() (0 =
// success).

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
    case 48: return launch_rwkv6<T, 48>(r, k, v, w, u, o, state, B, H, nt, dv, st);
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

// fp32 x: the step kernel
int ssd_steps_by_dim(int n, const void* x, const float* la, const float* Bm,
                     const float* Cm, void* y, float* state, int64_t B,
                     int64_t H, int64_t nt, int p, cudaStream_t st) {
  switch (n) {
    case 16: return launch_ssd<float, 16>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 32: return launch_ssd<float, 32>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 48: return launch_ssd<float, 48>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 64: return launch_ssd<float, 64>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 128: return launch_ssd<float, 128>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K8 with bf16 x: the chunked SSD on the tensor cores (see the note above)

constexpr int SQ = 64;              // steps per chunk
constexpr int SP = 64;              // state columns (of P) per block
constexpr int kSmemMax = 232448;    // dynamic shared memory a block can use
constexpr double kLogDecayFloor = -128.0;

// Shared memory of one block of HG heads, in floats.  Per head: the
// state's two bf16 pieces [n][p] (HST bf16 a row each); then C B^T
// [t][s] fp32; then the two stages, each C [t][n], B [t][n] fp32 and per
// head x [s][p] (bf16) and a [t].  The strides keep the fragment loads
// free of bank conflicts (C B^T's own B operand: 2-way).
template <int N>
struct SsdSmem {
  static constexpr int CST = N + 8, BST = N + 4, GST = SQ + 8, XST = SP + 8,
                       HST = SP + 8;
  static constexpr int kC = SQ * CST, kB = SQ * BST, kX = SQ * XST / 2, kA = SQ;
  static constexpr int kHead = N * HST;  // two bf16 planes
  __host__ __device__ static constexpr int stage(int hg) { return kC + kB + hg * (kX + kA); }
  __host__ __device__ static constexpr size_t bytes(int hg) {
    return sizeof(float) * ((size_t)2 * stage(hg) + SQ * GST + (size_t)hg * kHead);
  }
};

// the most heads a block can take: shared memory, and at N >= 48 the
// registers of 384 threads (the state tiles and y's accumulators)
template <int N>
constexpr int ssd_heads_max() {
  static_assert(SsdSmem<N>::bytes(1) <= kSmemMax, "one head's 2-stage ring must fit");
  return N < 48 && SsdSmem<N>::bytes(4) <= kSmemMax ? 4
         : SsdSmem<N>::bytes(3) <= kSmemMax ? 3
         : SsdSmem<N>::bytes(2) <= kSmemMax ? 2
                                            : 1;
}

// bf16x2 of (lo, hi) (lo in the low half) and its two values back
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// (a, b) = p[0] + p[1] elementwise, two bf16x2 pieces: the rounding,
// then the rounding of what it leaves (~16 bits of an fp32 value)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t (&p)[2]) {
  p[0] = pack_bf16(a, b);
  p[1] = pack_bf16(a - bf16_lo(p[0]), b - bf16_hi(p[0]));
}

// d += a b: m16n8k16, a row-major 16 x 16, b col-major 16 x 8, bf16 in,
// fp32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
// Four 8x8 bf16 tiles, transposed: r[m] holds tile m's elements
// (2q, g) and (2q + 1, g) (q = lane % 4, g = lane / 4) in its low and high
// halves; lane i gives the address of row i % 8 of tile i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// the 128 threads of one head
__device__ __forceinline__ void head_barrier(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

template <int N, int HG>
__global__ void __launch_bounds__(128 * HG)
ssd_chunked(const __nv_bfloat16* __restrict__ x, const float* __restrict__ la,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            __nv_bfloat16* __restrict__ y, float* __restrict__ state, int H,
            int T, int P) {
  using L = SsdSmem<N>;
  constexpr int CST = L::CST, BST = L::BST, GST = L::GST, XST = L::XST, HST = L::HST;
  constexpr int NT = N / 16;             // state row tiles
  constexpr int MY = (NT + 3) / 4;       // of them per warp, at most
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  // head of the block, and row slice of the head: rotated by the head, so
  // that each of the SM's four schedulers (warp % 4) gets a mix of the
  // slices, whose causal work grows with w
  const int slot = warp >> 2, w = (warp + slot) & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y * HG + slot;
  const bool active = h < H;
  const int p0 = blockIdx.x * SP;
  const int nchunks = (T + SQ - 1) / SQ;
  const bool xvec = P % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool yvec = P % 8 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const bool spair = P % 2 == 0;

  // this head's state, two bf16 pieces [n][p]
  __nv_bfloat16* Hhi = reinterpret_cast<__nv_bfloat16*>(smem + slot * L::kHead);
  __nv_bfloat16* Hlo = Hhi + N * HST;
  float* Gs = smem + HG * L::kHead;
  float* stages = Gs + SQ * GST;

  auto c_of = [&](int st) { return stages + st * L::stage(HG); };
  auto b_of = [&](int st) { return c_of(st) + L::kC; };
  auto x_of = [&](int st, int hs) {
    return reinterpret_cast<__nv_bfloat16*>(b_of(st) + L::kB + hs * (L::kX + L::kA));
  };
  auto a_of = [&](int st, int hs) { return b_of(st) + L::kB + hs * (L::kX + L::kA) + L::kX; };

  // chunk c's B, C and each head's x tile and a into stage st; rows past
  // T (and columns past P) are zeros
  auto load_chunk = [&](int c, int st) {
    const int t0 = c * SQ;
    constexpr int V = N / 4;
    float* cs = c_of(st);
    float* bs = b_of(st);
    for (int i = threadIdx.x; i < SQ * V; i += 128 * HG) {
      const int r = i / V, v = i % V, t = t0 + r;
      float* dc = cs + r * CST + 4 * v;
      float* db = bs + r * BST + 4 * v;
      if (t < T) {
        const size_t gi = ((size_t)b * T + t) * N + 4 * v;
        cp_async16(dc, Cm + gi);
        cp_async16(db, Bm + gi);
      } else {
        *reinterpret_cast<float4*>(dc) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(db) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int hs = 0; hs < HG; ++hs) {
      const int hh = blockIdx.y * HG + hs;
      if (hh >= H) break;
      const size_t row0 = ((size_t)b * H + hh) * T;
      __nv_bfloat16* xs = x_of(st, hs);
      for (int i = threadIdx.x; i < SQ * (SP / 8); i += 128 * HG) {
        const int r = i / (SP / 8), v = i % (SP / 8), t = t0 + r, p = p0 + 8 * v;
        __nv_bfloat16* d = xs + r * XST + 8 * v;
        if (t < T && xvec && p + 8 <= P) {
          cp_async16(d, x + (row0 + t) * P + p);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            d[e] = t < T && p + e < P ? x[(row0 + t) * P + p + e] : __float2bfloat16(0.f);
        }
      }
      if (threadIdx.x < SQ) {
        const int i = threadIdx.x;
        float* as = a_of(st, hs);
        if (t0 + i < T) cp_async4(as + i, la + row0 + t0 + i);
        else as[i] = 0.f;
      }
    }
    cp_async_commit();
  };

  float S[MY][8][4];  // state rows 16 (w + 4 m) + g (+8), columns 8 j + 2 q (+1)
#pragma unroll
  for (int m = 0; m < MY; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[m][j][e] = 0.f;

  const int tr = 16 * w + g;  // this thread's rows of y: tr and tr + 8
  load_chunk(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int st = c & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; the last chunk's G and stage are done
    if (c + 1 < nchunks) load_chunk(c + 1, st ^ 1);
    const float* cs = c_of(st);
    const float* bs = b_of(st);

    // The head's decays, in every warp: lane l holds the fp64 inclusive
    // sums cum[2l], cum[2l + 1] of the chunk's log-decays (each floored),
    // and the state's decays e^{cum_end - cum_s} of s = 2l, 2l + 1.
    double cu0 = 0.0, cu1 = 0.0, cend = 0.0;
    if (active) {
      const float2 a2 = *reinterpret_cast<const float2*>(a_of(st, slot) + 2 * lane);
      const double v0 = fmax((double)a2.x, kLogDecayFloor);
      const double v1 = fmax((double)a2.y, kLogDecayFloor);
      double incl = v0 + v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(kAll, incl, o);
        if (lane >= o) incl += u;
      }
      double excl = __shfl_up_sync(kAll, incl, 1);
      if (lane == 0) excl = 0.0;
      cu0 = excl + v0;
      cu1 = cu0 + v1;
      cend = __shfl_sync(kAll, cu1, 31);
    }
    const float bd0 = __expf((float)(cend - cu0)), bd1 = __expf((float)(cend - cu1));
    // cum[i] of any i, from the lane that holds it
    auto cum_at = [&](int i) {
      const double lo = __shfl_sync(kAll, cu0, i >> 1);
      const double hi = __shfl_sync(kAll, cu1, i >> 1);
      return (i & 1) ? hi : lo;
    };
    const double ct0 = cum_at(tr), ct1 = cum_at(tr + 8);

    // One pass over n, 16 at a time: C's fragments (rows tr, tr + 8) feed
    // both G = C B^T (column tiles warp / 4 + HG i, shared by the block's
    // heads) and, after the first chunk, C H; both as the three products
    // of two bf16 pieces a side.
    constexpr int NJ = (8 + HG - 1) / HG;
    const int j0 = warp >> 2;
    float acc[NJ][4];
    float Y[8][4];  // y rows tr (+8), columns 8 j + 2 q (+1)
#pragma unroll
    for (int i = 0; i < NJ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) Y[j][e] = 0.f;
    const bool with_h = active && c > 0;  // H = 0 before the first chunk
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int n = 16 * kk + 2 * q;
      uint32_t a0[2], a1[2], a2[2], a3[2];
      {
        const float2 c00 = *reinterpret_cast<const float2*>(cs + tr * CST + n);
        const float2 c10 = *reinterpret_cast<const float2*>(cs + (tr + 8) * CST + n);
        const float2 c01 = *reinterpret_cast<const float2*>(cs + tr * CST + n + 8);
        const float2 c11 = *reinterpret_cast<const float2*>(cs + (tr + 8) * CST + n + 8);
        split_bf16(c00.x, c00.y, a0);
        split_bf16(c10.x, c10.y, a1);
        split_bf16(c01.x, c01.y, a2);
        split_bf16(c11.x, c11.y, a3);
      }
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        const int j = j0 + HG * i;
        if (j >= 8) break;
        // B^T's rows n (+1), (+8, +9), column s = 8 j + g
        const float2 bb0 = *reinterpret_cast<const float2*>(bs + (8 * j + g) * BST + n);
        const float2 bb1 = *reinterpret_cast<const float2*>(bs + (8 * j + g) * BST + n + 8);
        uint32_t b0[2], b1[2];
        split_bf16(bb0.x, bb0.y, b0);
        split_bf16(bb1.x, bb1.y, b1);
        mma_bf16(acc[i], a0[0], a1[0], a2[0], a3[0], b0[0], b1[0]);
        mma_bf16(acc[i], a0[0], a1[0], a2[0], a3[0], b0[1], b1[1]);
        mma_bf16(acc[i], a0[1], a1[1], a2[1], a3[1], b0[0], b1[0]);
      }
      if (with_h) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          // both pieces of H[n (+1)][p] and H[n + 8 (+9)][p], p = 8 j + g,
          // j = 2 jp, 2 jp + 1: tile m of the ldmatrix is n half m & 1 of
          // column tile 2 jp + m / 2
          const int m = lane >> 3;
          const int o = (16 * kk + 8 * (m & 1) + (lane & 7)) * HST + 8 * (2 * jp + (m >> 1));
          uint32_t hh[4], hl[4];
          ldmatrix_x4_trans(hh, Hhi + o);
          ldmatrix_x4_trans(hl, Hlo + o);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float (&yj)[4] = Y[2 * jp + u];
            mma_bf16(yj, a0[0], a1[0], a2[0], a3[0], hh[2 * u], hh[2 * u + 1]);
            mma_bf16(yj, a0[0], a1[0], a2[0], a3[0], hl[2 * u], hl[2 * u + 1]);
            mma_bf16(yj, a0[1], a1[1], a2[1], a3[1], hh[2 * u], hh[2 * u + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int j = j0 + HG * i;
      if (j >= 8) break;
      *reinterpret_cast<float2*>(Gs + tr * GST + 8 * j + 2 * q) = make_float2(acc[i][0], acc[i][1]);
      *reinterpret_cast<float2*>(Gs + (tr + 8) * GST + 8 * j + 2 * q) =
          make_float2(acc[i][2], acc[i][3]);
    }
    __syncthreads();  // G is ready
    if (!active) continue;

    {  // C H's rows scale by e^{cum_t}; the state decays by e^{cum_end}
      const float e0 = expf((float)ct0), e1 = expf((float)ct1), de = expf((float)cend);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        Y[j][0] *= e0;
        Y[j][1] *= e0;
        Y[j][2] *= e1;
        Y[j][3] *= e1;
      }
#pragma unroll
      for (int m = 0; m < MY; ++m)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) S[m][j][e] *= de;
    }

    // over the chunk's steps s, 16 at a time: y += (G o L) x and
    // S += (B o e^{cum_end - cum_s})^T x, x's fragments loaded once
    const __nv_bfloat16* xs = x_of(st, slot);
#pragma unroll
    for (int kk = 0; kk < SQ / 16; ++kk) {
      // xb[j][0] = x[s (+1)][p], xb[j][1] = x[s + 8 (+9)][p], s = 16 kk + 2 q,
      // p = 8 j + g
      uint32_t xb[8][2];
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        const int m = lane >> 3;  // tile: s half m & 1, column tile 2 jp + m / 2
        ldmatrix_x4_trans(r, xs + (16 * kk + 8 * (m & 1) + (lane & 7)) * XST +
                                 8 * (2 * jp + (m >> 1)));
        xb[2 * jp][0] = r[0];
        xb[2 * jp][1] = r[1];
        xb[2 * jp + 1][0] = r[2];
        xb[2 * jp + 1][1] = r[3];
      }
      const int s = 16 * kk + 2 * q;
      if (kk <= w) {  // causal: rows tr (+8) see s <= t
        // cum of s, s + 1 (lane 8 kk + q) and s + 8, s + 9 (lane 8 kk + q + 4)
        const double cs0 = __shfl_sync(kAll, cu0, 8 * kk + q);
        const double cs1 = __shfl_sync(kAll, cu1, 8 * kk + q);
        const double cs8 = __shfl_sync(kAll, cu0, 8 * kk + q + 4);
        const double cs9 = __shfl_sync(kAll, cu1, 8 * kk + q + 4);
        auto gl = [&](const float* grow, int t, double ct, float (&v)[4]) {
          const float2 ga = *reinterpret_cast<const float2*>(grow + s);
          const float2 gb = *reinterpret_cast<const float2*>(grow + s + 8);
          v[0] = s <= t ? ga.x * __expf((float)(ct - cs0)) : 0.f;
          v[1] = s + 1 <= t ? ga.y * __expf((float)(ct - cs1)) : 0.f;
          v[2] = s + 8 <= t ? gb.x * __expf((float)(ct - cs8)) : 0.f;
          v[3] = s + 9 <= t ? gb.y * __expf((float)(ct - cs9)) : 0.f;
        };
        float v0[4], v1[4];
        gl(Gs + tr * GST, tr, ct0, v0);
        gl(Gs + (tr + 8) * GST, tr + 8, ct1, v1);
        uint32_t a0[2], a1[2], a2[2], a3[2];
        split_bf16(v0[0], v0[1], a0);
        split_bf16(v1[0], v1[1], a1);
        split_bf16(v0[2], v0[3], a2);
        split_bf16(v1[2], v1[3], a3);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mma_bf16(Y[j], a0[0], a1[0], a2[0], a3[0], xb[j][0], xb[j][1]);
          mma_bf16(Y[j], a0[1], a1[1], a2[1], a3[1], xb[j][0], xb[j][1]);
        }
      }
      // the state's decays of s, s + 1, s + 8, s + 9
      const float d0 = __shfl_sync(kAll, bd0, 8 * kk + q);
      const float d1 = __shfl_sync(kAll, bd1, 8 * kk + q);
      const float d8 = __shfl_sync(kAll, bd0, 8 * kk + q + 4);
      const float d9 = __shfl_sync(kAll, bd1, 8 * kk + q + 4);
#pragma unroll
      for (int m = 0; m < MY; ++m) {
        const int tile = w + 4 * m;
        if (tile >= NT) break;
        const int n = 16 * tile + g;
        // A = (B o decay)^T: rows n (+8), columns s (+1), (+8, +9); two pieces
        uint32_t a0[2], a1[2], a2[2], a3[2];
        split_bf16(bs[s * BST + n] * d0, bs[(s + 1) * BST + n] * d1, a0);
        split_bf16(bs[s * BST + n + 8] * d0, bs[(s + 1) * BST + n + 8] * d1, a1);
        split_bf16(bs[(s + 8) * BST + n] * d8, bs[(s + 9) * BST + n] * d9, a2);
        split_bf16(bs[(s + 8) * BST + n + 8] * d8, bs[(s + 9) * BST + n + 8] * d9, a3);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            mma_bf16(S[m][j], a0[k], a1[k], a2[k], a3[k], xb[j][0], xb[j][1]);
      }
    }

    // The state goes back to shared memory in two bf16 pieces (every
    // read of the last one was before the block barrier above); once
    // every warp of the head has read x, each warp puts its rows of y
    // (bf16) into this stage's x tile and stores them in 16-byte pieces.
#pragma unroll
    for (int m = 0; m < MY; ++m) {
      const int tile = w + 4 * m;
      if (tile >= NT) break;
      const int n = 16 * tile + g;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int o = (n + 8 * half) * HST + 8 * j + 2 * q;
          uint32_t pc[2];
          split_bf16(S[m][j][2 * half], S[m][j][2 * half + 1], pc);
          *reinterpret_cast<uint32_t*>(Hhi + o) = pc[0];
          *reinterpret_cast<uint32_t*>(Hlo + o) = pc[1];
        }
    }
    __nv_bfloat16* ys = x_of(st, slot);
    head_barrier(1 + slot);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(ys + tr * XST + 8 * j + 2 * q) = pack_bf16(Y[j][0], Y[j][1]);
      *reinterpret_cast<uint32_t*>(ys + (tr + 8) * XST + 8 * j + 2 * q) =
          pack_bf16(Y[j][2], Y[j][3]);
    }
    __syncwarp();
    {  // the warp's rows 16 w .. 16 w + 15, those < T, columns < P
      const size_t row0 = ((size_t)b * H + h) * T;
#pragma unroll
      for (int i = 0; i < 16 * (SP / 8) / 32; ++i) {
        const int r = 16 * w + (lane >> 3) + 4 * i, v = lane & 7;
        const int t = c * SQ + r, p = p0 + 8 * v;
        if (t >= T) continue;
        const __nv_bfloat16* src = ys + r * XST + 8 * v;
        __nv_bfloat16* dst = y + (row0 + t) * P + p;
        if (yvec && p + 8 <= P) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && p + e < P; ++e) dst[e] = src[e];
        }
      }
    }
  }
  if (!active) return;
  float* sb = state + ((size_t)b * H + h) * N * P;
#pragma unroll
  for (int m = 0; m < MY; ++m) {
    const int tile = w + 4 * m;
    if (tile >= NT) break;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* sr = sb + (size_t)(16 * tile + g + 8 * half) * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + 8 * j + 2 * q;
        const float v0 = S[m][j][2 * half], v1 = S[m][j][2 * half + 1];
        if (spair && p + 1 < P) {
          *reinterpret_cast<float2*>(sr + p) = make_float2(v0, v1);
        } else {
          if (p < P) sr[p] = v0;
          if (p + 1 < P) sr[p + 1] = v1;
        }
      }
    }
  }
}

template <int N>
int launch_ssd_chunked(const void* x, const float* la, const float* Bm,
                       const float* Cm, void* y, float* state, int64_t B,
                       int64_t H, int64_t nt, int p, cudaStream_t stream) {
  constexpr int HG = ssd_heads_max<N>();
  if (!repro::aligned(Bm, 16) || !repro::aligned(Cm, 16) || B > 65535)
    return cudaErrorInvalidValue;
  const size_t smem = SsdSmem<N>::bytes(HG);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_chunked<N, HG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((p + SP - 1) / SP), (unsigned)((H + HG - 1) / HG), (unsigned)B);
  ssd_chunked<N, HG><<<grid, 128 * HG, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), la, Bm, Cm,
      static_cast<__nv_bfloat16*>(y), state, (int)H, (int)nt, p);
  return cudaGetLastError();
}

// bf16 x: the chunked kernel
int ssd_chunked_by_dim(int n, const void* x, const float* la, const float* Bm,
                       const float* Cm, void* y, float* state, int64_t B,
                       int64_t H, int64_t nt, int p, cudaStream_t st) {
  switch (n) {
    case 16: return launch_ssd_chunked<16>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 32: return launch_ssd_chunked<32>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 48: return launch_ssd_chunked<48>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 64: return launch_ssd_chunked<64>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
    case 128: return launch_ssd_chunked<128>(x, la, Bm, Cm, y, state, B, H, nt, p, st);
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
// (B, H, T, P), log_a (B, H, T) fp32, Bm/Cm (B, T, N) fp32 (16-byte
// aligned), state (B, H, N, P) fp32; dtype 0 (fp32 x) runs the step
// kernel, 1 (bf16 x) the chunked one
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
    return ssd_steps_by_dim(n, x, la, bm, cm, y, s, B, H, T, p, st);
  if (dtype == 1)
    return ssd_chunked_by_dim(n, x, la, bm, cm, y, s, B, H, T, p, st);
  return cudaErrorInvalidValue;
}
