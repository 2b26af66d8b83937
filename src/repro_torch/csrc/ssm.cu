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
// Their gradients, for training, are repro_rwkv6_scan_bwd and
// repro_mamba2_ssd_bwd ("K7's and K8's backward" below).
//
// Bound on the card: bytes (each input read once, each output written
// once); at the serve shapes 0.20 ms (K7) and 0.11 ms (K8).
//
// K7 with fp32 inputs and K8 with fp32 x ("simt steps"): the state never
// leaves registers.  One block per (b, h), thread j owns column j of the state
// (Dk or N floats), and the block walks T step by step, staging TC = 16
// steps of its inputs in shared memory at a time (r/k/w/u*k for K7,
// B/C/exp(a) for K8 are read by every thread at the same address:
// broadcasts).  A step costs each thread 2 multiply-adds per state row,
// a dependent chain on the CUDA cores, which bounds these kernels well
// above the bytes.  Every factor the state is multiplied by is a decay in
// [0, 1]: a decay of exactly 0 (which makes the Pallas K7's log-space
// ratios -inf - -inf = NaN) gives finite output, and any T works (the
// Pallas kernels assert T % chunk == 0).  The fp32 routes stay here:
// fp32 inputs are not exact in bf16, and their outputs are held to 1e-4,
// finer than the bf16 routes' two-piece operands keep.
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
//
// K7 with bf16 inputs, the serve dtype ("chunked split-bf16 mma, state
// every 16 steps", wkv_chunked): the chunked form of the TPU kernel on
// the tensor cores, with the state carried every WT = 16 steps.  Per
// sub-chunk, every decay is a product of w in fp32 taken from a boundary
// of the sub-chunk or of its halves, so each lies in [0, 1], w = 0 gives
// exact zeros and nothing overflows (no log ratios, unlike the Pallas
// kernel):
//     rP_t = r_t o prod_{q<t} w_q,  K'_s = k_s o prod_{q>s} w_q,  W = prod_q w_q,
//     A[t][s] = sum_c r_tc k_sc prod_{s<q<t} w_qc (s < t),  A[t][t] = sum_c r_tc u_c k_tc,
//     o = rP S + A v,  S <- diag(W) S + K'^T v.
// The per-channel decay makes A no single product.  Its quadrant t >= 8 >
// s (64 of its 120 pairs) is one: r''_t = r_t o prod_{8<=q<t} w_q times
// k''_s = k_s o prod_{s<q<8} w_q, on the tensor cores (one warp, the
// m16n8k16's rows 0-7 zero).  The two 8 x 8 blocks left are pairwise on
// the CUDA cores: a thread takes the steps s and 7 - s of one (7 running
// products: balanced) over 1/16 of the channels, the 16 channel groups
// reduced by a shuffle reduce-scatter.  A block takes one (b, h) and a
// 64-wide tile of Dv (Dv up to 1024 is grid size); warp w owns 16 state
// columns and keeps S^T (its columns by Dk) in fp32 mma accumulators
// across the whole sequence: no state crosses warps, and the
// accumulators of V^T K' are, split, the B operand of rP S (the
// flash-attention register reuse).  Each sub-chunk the block prepares the
// next one's operands, shared by its warps in a double-buffered stage,
// from a 3-stage cp.async ring of raw r, k, w, v: the forward and
// backward products (rP, K', W, r'', k''; one thread a channel pair and
// direction), a barrier, then A; meanwhile each warp runs the products of
// the current one: 44 mma.sync m16n8k16 a warp at Dk = 64 (rP S as the
// three products hi hi + hi lo + lo hi of two bf16 pieces a side, A v and
// K'^T v two, v being exact).  One bf16 rounding per operand instead
// misses the tolerances by 14x (outputs) and 83x (states) at Dk = 64
// over 256 steps (tests/test_torch_ssm.py's emulation of this algorithm).
// The other chunked form, 64-step chunks with decay-scaled off-diagonal
// 16 x 16 blocks, was not built: per warp and 64 steps it needs 236 mma
// against 176 (rP S has a row a step in both forms) and no less
// per-channel work, saving only barriers and state splits.  The choice
// rests on that count, not on a timing.  Any T: rows past T are r = k =
// v = 0, w = 1 (the state is untouched) and only rows < T are stored.
// What bounds it: the instructions the warps must dispatch, not the
// bytes (2.6x them at the serve shape, PERF.md §6) nor the tensor pipe.
// At 128 registers and 54,528 bytes of shared memory a block, an SM
// holds 4 blocks (16 warps): the serve shape's 1,024 blocks run in two
// near-full waves.  Of its time, timed against edited copies with a part
// taken out: the per-channel diagonal block (before the quadrant went to
// the tensor cores) ~37 %, the forward and backward products ~14 %, the
// second bf16 piece of every operand ~23 %.

// K7 takes fp32 or bf16 (dtype 0 / 1: the step or the chunked kernel)
// for r/k/v/w/u, K8 fp32 or bf16 x;
// outputs in v's / x's type; log_a, B and C are fp32; the final states
// are fp32.  State widths (Dk for K7, N for K8) 16, 32, 48, 64 and 128;
// Dv and P up to 1024.  Every launcher returns cudaGetLastError() (0 =
// success).

#include <cuda_bf16.h>

#include <algorithm>

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

// The step kernels take the state's columns in tiles of at most kStepCols
// threads (blockIdx.y): 1,024 threads of ~170 registers (Dk or N = 128)
// would not launch.
constexpr int kStepCols = 128;
inline int threads_for(int cols) { return (min(cols, kStepCols) + 31) / 32 * 32; }
inline unsigned col_tiles(int cols) { return (unsigned)((cols + kStepCols - 1) / kStepCols); }

// ---------------------------------------------------------------------------
// K7 RWKV-6 wkv

template <int DK>
size_t rwkv6_smem(int cols) {
  // R, K, W and U*K [TC][DK], V [TC][cols] (this block's columns)
  return sizeof(float) * ((size_t)4 * TC * DK + (size_t)TC * cols);
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
  const int col0 = blockIdx.y * blockDim.x, cw = min((int)blockDim.x, dv - col0);
  const int j = col0 + threadIdx.x;  // this thread's state column
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
    for (int i = threadIdx.x; i < n * cw; i += blockDim.x)
      Vs[i / cw * blockDim.x + i % cw] = to_f(v[vb + (size_t)(t0 + i / cw) * dv + col0 + i % cw]);
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < n; ++tt) {
      const float vv = Vs[tt * blockDim.x + threadIdx.x];
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
  const size_t smem = rwkv6_smem<DK>(threads_for(dv));
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_fwd<T, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  rwkv6_fwd<T, DK><<<dim3((unsigned)(B * H), col_tiles(dv)), threads_for(dv), smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<T*>(o), state, (int)H, (int)nt, dv);
  return cudaGetLastError();
}

// fp32 inputs: the step kernel
int rwkv6_steps_by_dim(int dk, const void* r, const void* k, const void* v,
                       const void* w, const void* u, void* o, float* state,
                       int64_t B, int64_t H, int64_t nt, int dv, cudaStream_t st) {
  switch (dk) {
    case 16: return launch_rwkv6<float, 16>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 32: return launch_rwkv6<float, 32>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 48: return launch_rwkv6<float, 48>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 64: return launch_rwkv6<float, 64>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 128: return launch_rwkv6<float, 128>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K8 Mamba-2 SSD

template <int N>
size_t ssd_smem(int cols) {
  // B, C [TC][N], X [TC][cols] (this block's columns), exp(a) [TC]
  return sizeof(float) * ((size_t)2 * TC * N + (size_t)TC * cols + TC);
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
  float* As = Xs + TC * blockDim.x;

  const int bh = blockIdx.x, b = bh / H;
  const int col0 = blockIdx.y * blockDim.x, cw = min((int)blockDim.x, p - col0);
  const int j = col0 + threadIdx.x;  // this thread's state column
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
    for (int i = threadIdx.x; i < n * cw; i += blockDim.x)
      Xs[i / cw * blockDim.x + i % cw] = to_f(x[xb + (size_t)(t0 + i / cw) * p + col0 + i % cw]);
    for (int i = threadIdx.x; i < n; i += blockDim.x) As[i] = expf(lb[t0 + i]);
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < n; ++tt) {
      const float xv = Xs[tt * blockDim.x + threadIdx.x], a = As[tt];
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
  const size_t smem = ssd_smem<N>(threads_for(p));
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ssd_fwd<T, N><<<dim3((unsigned)(B * H), col_tiles(p)), threads_for(p), smem, stream>>>(
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
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
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

// ---------------------------------------------------------------------------
// K7 with bf16 inputs: the chunked wkv on the tensor cores (see the note above)

// bf16 pieces of every fp32 operand (one misses the tolerances:
// tests/test_torch_ssm.py)
constexpr int kWkvPieces = 2;

constexpr int WT = 16;    // steps per sub-chunk: the state is carried every WT steps
constexpr int WV = 64;    // state columns (of Dv) per block, 16 per warp
constexpr int WNST = 3;   // stages of the raw input ring

// Four 8x8 bf16 tiles: r[m] holds tile m's elements (g, 2q) and (g, 2q + 1)
// (q = lane % 4, g = lane / 4); lane i gives the address of row i % 8 of
// tile i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Shared memory of one block, in bf16 elements after 3 DK floats (u as
// bf16 in the first, and the two stages' W).  Raw stage: r, k, w [WT][RS]
// and v [WT][VS].  Prepared stage: rP and K' in pieces [WT][RS], A in
// pieces [WT][AS].  Then, once: the quadrant's r'' and k'' in pieces
// [8][RS].  The strides keep every ldmatrix free of bank conflicts.
template <int DK>
struct WkvSmem {
  static constexpr int RS = DK + 8, VS = WV + 8, AS = WT + 8;
  static constexpr int kRaw = 3 * WT * RS + WT * VS;
  static constexpr int kPrep = 2 * kWkvPieces * WT * RS + kWkvPieces * WT * AS;
  static constexpr int kQuad = 2 * kWkvPieces * (WT / 2) * RS;
  static constexpr size_t bytes = sizeof(float) * 3 * DK +
                                  2 * ((size_t)WNST * kRaw + 2 * (size_t)kPrep + kQuad);
};

// One level of a reduce-scatter over 16 lanes (xor O, O >= HALF): v[i]
// and v[i + HALF], i < HALF, are two values; afterwards v[i] holds the
// pair of lanes' sum of the one picked by (lane & O).
template <int O, int HALF>
__device__ __forceinline__ void reduce_scatter_level(float* v, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// NC channels grp + 16 j of row p, as floats; pairs 2 (grp + 16 j) where
// NC is even
template <int NC>
__device__ __forceinline__ void load_channels(const __nv_bfloat16* p, int grp, float* out) {
  if constexpr (NC % 2 == 0) {
#pragma unroll
    for (int j = 0; j < NC / 2; ++j) {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(p + 2 * (grp + 16 * j));
      out[2 * j] = bf16_lo(x);
      out[2 * j + 1] = bf16_hi(x);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NC; ++j) out[j] = __bfloat162float(p[grp + 16 * j]);
  }
}

// a pair of fp32 values as two bf16x2 pieces at p and p + stride
__device__ __forceinline__ void put_pieces(__nv_bfloat16* p, int stride, float a, float b) {
  uint32_t pc[2];
  split_bf16(a, b, pc);
  *reinterpret_cast<uint32_t*>(p) = pc[0];
  *reinterpret_cast<uint32_t*>(p + stride) = pc[1];
}

// The prepared operands of one sub-chunk, from its raw r, k, w rows (rs,
// stride RS) into a prepared stage pp (rP and K' in pieces, then A's
// pieces), the quadrant's r'' and k'' (rq, kq) and W (Wd); all products of
// w in fp32 within the sub-chunk, each in [0, 1]:
//   rP[t] = r_t o prod_{q<t} w_q,  K'[s] = k_s o prod_{q>s} w_q,  W = prod_q w_q,
//   A[t][s] = sum_c r_tc k_sc prod_{s<q<t} w_qc (s < t),
//   A[t][t] = sum_c r_tc u_c k_tc,  A[t][s] = 0 (s > t, never written).
// First (chains) the products along the sub-chunk, and the quadrant's
// operands r''[t] = r_t o prod_{8<=q<t} w_q (t >= 8) and k''[s] = k_s o
// prod_{s<q<8} w_q (s < 8); after a block barrier (diagonal) A: its
// quadrant t >= 8 > s is r'' k''^T on the tensor cores, the rest per
// channel.  Both take a block of 128 threads.
template <int DK>
__device__ __forceinline__ void wkv_prepare_chains(const __nv_bfloat16* rs, __nv_bfloat16* pp,
                                                   __nv_bfloat16* rq, __nv_bfloat16* kq,
                                                   float* Wd) {
  constexpr int RS = WkvSmem<DK>::RS, HT = WT / 2;
  const __nv_bfloat16* ks = rs + WT * RS;
  const __nv_bfloat16* ws = ks + WT * RS;
  const int x = threadIdx.x;
  if (x >= DK) return;
  // threads 0 .. DK/2 - 1: the forward products of a channel pair;
  // DK/2 .. DK - 1: the backward ones
  const bool fwd = x < DK / 2;
  const int c = 2 * (fwd ? x : x - DK / 2);
  const __nv_bfloat16* src = fwd ? rs : ks;
  __nv_bfloat16* dst = pp + (fwd ? 0 : kWkvPieces * WT * RS);
  __nv_bfloat16* qdst = fwd ? rq - HT * RS : kq;  // rows t - 8 / s
  float p0v = 1.f, p1v = 1.f, h0 = 1.f, h1 = 1.f;
#pragma unroll
  for (int j = 0; j < WT; ++j) {
    const int t = fwd ? j : WT - 1 - j;
    const uint32_t xv = *reinterpret_cast<const uint32_t*>(src + t * RS + c);
    const uint32_t wv = *reinterpret_cast<const uint32_t*>(ws + t * RS + c);
    const float x0 = bf16_lo(xv), x1 = bf16_hi(xv), w0 = bf16_lo(wv), w1 = bf16_hi(wv);
    put_pieces(dst + t * RS + c, WT * RS, x0 * p0v, x1 * p1v);
    if (j >= HT) put_pieces(qdst + t * RS + c, HT * RS, x0 * h0, x1 * h1);
    p0v *= w0;
    p1v *= w1;
    if (j >= HT) {
      h0 *= w0;
      h1 *= w1;
    }
  }
  if (fwd) *reinterpret_cast<float2*>(Wd + c) = make_float2(p0v, p1v);
}

template <int DK>
__device__ __forceinline__ void wkv_prepare_diagonal(const __nv_bfloat16* rs, __nv_bfloat16* pp,
                                                     const __nv_bfloat16* rq,
                                                     const __nv_bfloat16* kq,
                                                     const __nv_bfloat16* us_bf) {
  constexpr int RS = WkvSmem<DK>::RS, AS = WkvSmem<DK>::AS, KT = DK / 16, HT = WT / 2;
  constexpr int NC = DK / 16;  // channels of each thread in the diagonal blocks
  constexpr unsigned kAll = 0xffffffffu;
  const __nv_bfloat16* ks = rs + WT * RS;
  const __nv_bfloat16* ws = ks + WT * RS;
  __nv_bfloat16* ap = pp + 2 * kWkvPieces * WT * RS;  // [piece][WT][AS]
  const int x = threadIdx.x, warp = x >> 5, g = (x & 31) >> 2, q = x & 3;
  // The two 8 x 8 diagonal blocks: each thread the steps s and 7 - s of
  // one (7 running products: balanced) over NC channels
  // (load_channels); the 16 channel groups of a pair are 16 lanes of one
  // warp.
  const int grp = x & 15, pu = x >> 4, base = HT * (pu >> 2), jj = pu & 3;
  const int s1 = base + jj, s2 = base + HT - 1 - jj;
  float kr[NC], k2[NC], rr[NC], uu[NC];
  float d1 = 0.f, d2 = 0.f;
  load_channels<NC>(us_bf, grp, uu);
  load_channels<NC>(ks + s1 * RS, grp, kr);
  load_channels<NC>(rs + s1 * RS, grp, rr);
#pragma unroll
  for (int j = 0; j < NC; ++j) d1 = fmaf(rr[j] * uu[j], kr[j], d1);
  load_channels<NC>(ks + s2 * RS, grp, k2);
  load_channels<NC>(rs + s2 * RS, grp, rr);
#pragma unroll
  for (int j = 0; j < NC; ++j) d2 = fmaf(rr[j] * uu[j], k2[j], d2);
  // acc[jt]: (t, s) = (s1 + 1 + jt, s1) or, from jt = 7 - jj, (base + 1 + jt, s2)
  float acc[HT];
#pragma unroll
  for (int jt = 0; jt < HT - 1; ++jt) {
    const int t = jt < HT - 1 - jj ? s1 + 1 + jt : base + 1 + jt;
    if (jt == HT - 1 - jj) {
#pragma unroll
      for (int j = 0; j < NC; ++j) kr[j] = k2[j];
    }
    float wr[NC];
    load_channels<NC>(rs + t * RS, grp, rr);
    load_channels<NC>(ws + t * RS, grp, wr);
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      a = fmaf(rr[j], kr[j], a);
      kr[j] *= wr[j];
    }
    acc[jt] = a;
  }
  acc[HT - 1] = d1;
  // lanes grp and grp ^ 1 end with the 16 lanes' sum of acc[grp / 2]
  reduce_scatter_level<8, 4>(acc, grp);
  reduce_scatter_level<4, 2>(acc, grp);
  reduce_scatter_level<2, 1>(acc, grp);
  acc[0] += __shfl_xor_sync(kAll, acc[0], 1);
#pragma unroll
  for (int o2 = 8; o2 >= 1; o2 >>= 1) d2 += __shfl_xor_sync(kAll, d2, o2);
  auto put = [&](int t, int s, float val) {
    const __nv_bfloat16 hi = __float2bfloat16(val);
    ap[t * AS + s] = hi;
    ap[(WT + t) * AS + s] = __float2bfloat16(val - __bfloat162float(hi));
  };
  const int idx = grp >> 1;
  if (!(grp & 1)) {
    if (idx == HT - 1) put(s1, s1, acc[0]);
    else if (idx < HT - 1 - jj) put(s1 + 1 + idx, s1, acc[0]);
    else put(base + 1 + idx, s2, acc[0]);
  } else if (grp == 1) {
    put(s2, s2, d2);
  }
  // the quadrant t >= 8 > s, by warp 0: rows 8 + g of an m16n8k16 whose
  // rows 0-7 are zero
  if (warp == 0) {
    float qa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t ra[kWkvPieces][2], kb[kWkvPieces][2];
#pragma unroll
      for (int pc = 0; pc < kWkvPieces; ++pc)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int off = pc * HT * RS + g * RS + 16 * kt + 8 * e + 2 * q;
          ra[pc][e] = *reinterpret_cast<const uint32_t*>(rq + off);
          kb[pc][e] = *reinterpret_cast<const uint32_t*>(kq + off);
        }
      mma_bf16(qa, 0u, ra[0][0], 0u, ra[0][1], kb[0][0], kb[0][1]);
      mma_bf16(qa, 0u, ra[0][0], 0u, ra[0][1], kb[1][0], kb[1][1]);
      mma_bf16(qa, 0u, ra[1][0], 0u, ra[1][1], kb[0][0], kb[0][1]);
    }
    put_pieces(ap + (HT + g) * AS + 2 * q, WT * AS, qa[2], qa[3]);
  }
}

template <int DK>
__global__ void __launch_bounds__(128, DK <= 64 ? 4 : 2)
wkv_chunked(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ w,
            const __nv_bfloat16* __restrict__ u, __nv_bfloat16* __restrict__ o,
            float* __restrict__ state, int H, int T, int Dv) {
  using L = WkvSmem<DK>;
  constexpr int RS = L::RS, VS = L::VS, AS = L::AS, KT = DK / 16, HT = WT / 2;
  extern __shared__ float4 smem4[];
  float* us = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* us_bf = reinterpret_cast<__nv_bfloat16*>(us);  // u, DK bf16
  float* Wst = us + DK;  // [2][DK]: the prepared stages' whole-sub-chunk decays
  __nv_bfloat16* raw0 = reinterpret_cast<__nv_bfloat16*>(us + 3 * DK);
  __nv_bfloat16* prep0 = raw0 + WNST * L::kRaw;
  __nv_bfloat16* rq = prep0 + 2 * L::kPrep;     // r'' [piece][8][RS]
  __nv_bfloat16* kq = rq + kWkvPieces * HT * RS;  // k'' [piece][8][RS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int p0 = blockIdx.x * WV;
  const int c0 = p0 + 16 * warp;  // the warp's first state column
  const bool cols = c0 < Dv;
  const int ns = (T + WT - 1) / WT;
  const size_t row0 = ((size_t)b * H + h) * T;
  const bool kvec = ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  const bool vvec = Dv % 8 == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  const bool opair = Dv % 2 == 0 && (reinterpret_cast<uintptr_t>(o) & 3) == 0;

  auto raw = [&](int st) { return raw0 + st * L::kRaw; };
  auto prep = [&](int st) { return prep0 + st * L::kPrep; };

  // sub-chunk i's r, k, w and the block's v columns into raw stage st;
  // rows past T are r = k = v = 0 and w = 1 (the state is untouched)
  auto load_stage = [&](int i, int st) {
    const int t0 = i * WT;
    __nv_bfloat16* rs = raw(st);
    constexpr int CH = DK / 8;  // 16-byte pieces of a row
    for (int idx = threadIdx.x; idx < 3 * WT * CH; idx += 128) {
      const int a = idx / (WT * CH), row = idx % (WT * CH) / CH, ch = idx % CH;
      const int t = t0 + row;
      __nv_bfloat16* dst = rs + (a * WT + row) * RS + 8 * ch;
      const __nv_bfloat16* src = (a == 0 ? r : a == 1 ? k : w) + (row0 + t) * DK + 8 * ch;
      if (t < T && kvec) {
        cp_async16(dst, src);
      } else if (t < T) {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      } else {
        const uint32_t fill = a == 2 ? 0x3f803f80u : 0u;  // bf16 1.0 pairs
        *reinterpret_cast<uint4*>(dst) = make_uint4(fill, fill, fill, fill);
      }
    }
    __nv_bfloat16* vs = rs + 3 * WT * RS;
    for (int idx = threadIdx.x; idx < WT * (WV / 8); idx += 128) {
      const int row = idx / (WV / 8), col = p0 + 8 * (idx % (WV / 8)), t = t0 + row;
      __nv_bfloat16* dst = vs + row * VS + col - p0;
      if (t < T && vvec && col + 8 <= Dv) {
        cp_async16(dst, v + (row0 + t) * Dv + col);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = t < T && col + e < Dv ? v[(row0 + t) * Dv + col + e] : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  auto prepare_chains = [&](int st, int ps) {
    wkv_prepare_chains<DK>(raw(st), prep(ps), rq, kq, Wst + ps * DK);
  };
  auto prepare_diagonal = [&](int st, int ps) {
    wkv_prepare_diagonal<DK>(raw(st), prep(ps), rq, kq, us_bf);
  };

  // zero the A tiles (their upper triangles are never written) and load u
  for (int i = threadIdx.x; i < 2 * kWkvPieces * WT * AS; i += 128) {
    const int ps = i / (kWkvPieces * WT * AS), e = i % (kWkvPieces * WT * AS);
    prep(ps)[2 * kWkvPieces * WT * RS + e] = __float2bfloat16(0.f);
  }
  for (int c = threadIdx.x; c < DK; c += 128) us_bf[c] = u[(size_t)h * DK + c];

  // S^T: this warp's state columns c0 + g (+8) by rows 8 nt + 2q (+1):
  // the accumulator layout of V^T K' and, split, the B operand of rP S
  float St[DK / 8][4];
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) St[n][e] = 0.f;

  if (ns > 0) {
    load_stage(0, 0);
    if (ns > 1) load_stage(1, 1);
    else cp_async_commit();
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();  // stage 0, u and the zeroed A tiles
    prepare_chains(0, 0);
    __syncthreads();
    prepare_diagonal(0, 0);
  }
  for (int i = 0; i < ns; ++i) {
    cp_async_wait_all();
    __syncthreads();  // sub-chunk i prepared, i + 1 landed; i - 1 done
    if (i + 2 < ns) load_stage(i + 2, (i + 2) % WNST);
    if (i + 1 < ns) prepare_chains((i + 1) % WNST, (i + 1) & 1);
    __syncthreads();  // r'' and k'' of sub-chunk i + 1
    if (i + 1 < ns) prepare_diagonal((i + 1) % WNST, (i + 1) & 1);
    if (!cols) continue;

    const __nv_bfloat16* vs = raw(i % WNST) + 3 * WT * RS;
    const __nv_bfloat16* rp = prep(i & 1);
    const __nv_bfloat16* kp = rp + kWkvPieces * WT * RS;
    const __nv_bfloat16* ap = kp + kWkvPieces * WT * RS;
    const float* Wi = Wst + (i & 1) * DK;
    const int m = lane >> 3;
    // V^T's A fragments (v[s][c0 + ...], s 0-7 / 8-15 by columns 0-7 /
    // 8-15), which are also V's B fragments: va[0], va[2] for columns
    // 0-7, va[1], va[3] for 8-15
    uint32_t va[4];
    ldmatrix_x4_trans(va, vs + (8 * (m >> 1) + (lane & 7)) * VS + 16 * warp + 8 * (m & 1));

    // o = rP S + A V: rows g (+8) of the sub-chunk, columns 8 nb + 2q (+1)
    float oc[2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) oc[nb][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      // rP's A fragments (rows t, columns 16 kt ..) and S's B fragments
      // sf[nb][half][piece]: S rows 16 kt + 8 half + 2q (+1), column 8 nb + g
      const int off = (8 * (m & 1) + (lane & 7)) * RS + 16 * kt + 8 * (m >> 1);
      uint32_t ra[kWkvPieces][4], sf[2][2][2];
#pragma unroll
      for (int pc = 0; pc < kWkvPieces; ++pc) ldmatrix_x4(ra[pc], rp + pc * WT * RS + off);
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* sv = St[2 * kt + half];
          split_bf16(sv[2 * nb], sv[2 * nb + 1], sf[nb][half]);
        }
      // the products hi hi + hi lo + lo hi
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        const uint32_t *a0 = ra[0], *a1 = ra[1];
        mma_bf16(oc[nb], a0[0], a0[1], a0[2], a0[3], sf[nb][0][0], sf[nb][1][0]);
        mma_bf16(oc[nb], a0[0], a0[1], a0[2], a0[3], sf[nb][0][1], sf[nb][1][1]);
        mma_bf16(oc[nb], a1[0], a1[1], a1[2], a1[3], sf[nb][0][0], sf[nb][1][0]);
      }
    }
#pragma unroll
    for (int pc = 0; pc < kWkvPieces; ++pc) {
      uint32_t aa[4];
      ldmatrix_x4(aa, ap + pc * WT * AS + (8 * (m & 1) + (lane & 7)) * AS + 8 * (m >> 1));
      mma_bf16(oc[0], aa[0], aa[1], aa[2], aa[3], va[0], va[2]);
      mma_bf16(oc[1], aa[0], aa[1], aa[2], aa[3], va[1], va[3]);
    }
    {  // store o's rows < T, columns < Dv
      const int t0 = i * WT;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = t0 + g + 8 * half, c = c0 + 8 * nb + 2 * q;
          if (t >= T) continue;
          __nv_bfloat16* dst = o + (row0 + t) * Dv + c;
          const float v0 = oc[nb][2 * half], v1 = oc[nb][2 * half + 1];
          if (opair && c + 1 < Dv) {
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
          } else {
            if (c < Dv) dst[0] = __float2bfloat16(v0);
            if (c + 1 < Dv) dst[1] = __float2bfloat16(v1);
          }
        }
    }

    // S^T <- S^T diag(W) + V^T K'
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const float2 wv = *reinterpret_cast<const float2*>(Wi + 8 * n + 2 * q);
      St[n][0] *= wv.x;
      St[n][1] *= wv.y;
      St[n][2] *= wv.x;
      St[n][3] *= wv.y;
    }
#pragma unroll
    for (int pc = 0; pc < kWkvPieces; ++pc)
#pragma unroll
      for (int np = 0; np < KT; ++np) {
        // K' rows s 0-7 / 8-15 of columns 16 np (+8): B fragments of n tiles 2 np, 2 np + 1
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kp + pc * WT * RS + (8 * (m & 1) + (lane & 7)) * RS + 16 * np +
                                  8 * (m >> 1));
        mma_bf16(St[2 * np], va[0], va[1], va[2], va[3], kb[0], kb[1]);
        mma_bf16(St[2 * np + 1], va[0], va[1], va[2], va[3], kb[2], kb[3]);
      }
  }
  if (!cols) return;
  float* sb = state + ((size_t)b * H + h) * DK * Dv;
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + g + 8 * (e >> 1);
      if (c < Dv) sb[(size_t)(8 * n + 2 * q + (e & 1)) * Dv + c] = St[n][e];
    }
}

template <int DK>
int launch_wkv_chunked(const void* r, const void* k, const void* v, const void* w,
                       const void* u, void* o, float* state, int64_t B, int64_t H,
                       int64_t nt, int dv, cudaStream_t stream) {
  if (B > 65535 || H > 65535) return cudaErrorInvalidValue;
  const size_t smem = WkvSmem<DK>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      wkv_chunked<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((dv + WV - 1) / WV), (unsigned)H, (unsigned)B);
  using B16 = __nv_bfloat16;
  wkv_chunked<DK><<<grid, 128, smem, stream>>>(
      static_cast<const B16*>(r), static_cast<const B16*>(k), static_cast<const B16*>(v),
      static_cast<const B16*>(w), static_cast<const B16*>(u), static_cast<B16*>(o), state,
      (int)H, (int)nt, dv);
  return cudaGetLastError();
}

// bf16 inputs: the chunked kernel
int wkv_chunked_by_dim(int dk, const void* r, const void* k, const void* v,
                       const void* w, const void* u, void* o, float* state,
                       int64_t B, int64_t H, int64_t nt, int dv, cudaStream_t st) {
  switch (dk) {
    case 16: return launch_wkv_chunked<16>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 32: return launch_wkv_chunked<32>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 48: return launch_wkv_chunked<48>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 64: return launch_wkv_chunked<64>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    case 128: return launch_wkv_chunked<128>(r, k, v, w, u, o, state, B, H, nt, dv, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K7's and K8's backward
//
// repro_rwkv6_scan_bwd and repro_mamba2_ssd_bwd replace no pallas_call:
// the reference's training differentiates the op entries
// (src/repro/kernels/rwkv6_scan.py:82, src/repro/kernels/mamba2_ssd.py:70;
// on the CPU its jnp oracles, src/repro/kernels/ref.py::rwkv6_ref,
// mamba2_ref).  These are those gradients, with G_t = dL/dS_t (dL/dH_t)
// started from the final state's cotangent:
//
//   K7: G_{t-1} = diag(w_t) G_t + r_t^T do_t
//       dr_t = S_{t-1} do_t + (u o k_t)(v_t . do_t)
//       dk_t = G_t v_t + (r_t o u)(v_t . do_t)
//       dv_t = k_t^T G_t + (sum r_t o u o k_t) do_t
//       dw_t = rowsum(G_t o S_{t-1}),  du = sum_{b,t} r_t o k_t (v_t . do_t)
//   K8: G_t = C_t^T dy_t + a_{t+1} G_{t+1}        (a = exp(log_a))
//       dx_t = B_t G_t,  dB_t = sum_h G_t x_t^T,  dC_t = sum_h H_t dy_t^T
//       dlog_a_t = a_t sum(G_t o H_{t-1})
//
// Bound on the card: bytes (the forward's inputs, the cotangents and the
// gradients each moved once); at the training shapes 0.183 ms (K7, rwkv6-7b
// (8, 64, 1024, 64, 64)) and 0.082 ms (K8, zamba2-2.7b (8, 80, 1024, 64,
// 64)).  Nothing divides by a decay, so w = 0 and log_a = -inf give finite
// gradients, and no sum crosses blocks by float atomics: the partials are
// added in a fixed order by a last launch, the same bits run to run.  One
// counted launch a call, whatever it launches inside; the workspace (the
// stored states and the partials) lives for the call only, so remat's
// memory stays what the dry-run counts (kernels/meta.py).  Every gradient
// in its input's dtype.  Two routes, by the inputs' dtype:
//
// bf16 inputs (the train path): the chunked reverse scans on the tensor
// cores, below ("The bf16 routes").
//
// fp32 inputs ("simt reverse scans"): a block takes one (b, h) and a tile
// of 32 state columns (Dv or P; any width up to 1024 is grid size), one
// thread a state ROW (Dk or N threads), so the sums over columns (dr, dk,
// dw; dB, dC, dlog_a) are each thread's own and only dv / dx are summed
// over the rows, in shared memory.  The state and G stay in registers, in
// fp64.  A first pass walks forward and stores the state at the start of
// every chunk of BW_CHUNK steps; the reverse pass takes the chunks last to
// first and for each step recomputes S_{t-1} from its chunk's stored state
// (at most BW_CHUNK - 1 state updates).  Every sum that ends in a gradient
// runs in fp64 and the stored states are fp64: with fp32 states, K8's
// dlog_a (4,096 products G H a step that cancel) missed 2e-5 (1 + |g|) by
// up to 6x at T = 1,000, the state's own rounding, which no summation
// order removes.

constexpr int BW_CHUNK = 16;  // steps between stored states

// the state's type (A) and the state columns a block takes (NC) of the
// simt reverse scans, by the inputs' type (fp32 only: bf16 takes the
// chunked route)
template <typename T>
struct BwRoute;
template <>
struct BwRoute<float> {
  typedef double A;
  static constexpr int NC = 32;
};

__host__ __device__ inline int64_t bw_tiles(int cols, int nc) {
  return (cols + nc - 1) / nc;
}
__host__ __device__ inline int64_t bw_chunks(int64_t nt) {
  return (nt + BW_CHUNK - 1) / BW_CHUNK;
}

// workspace of either backward, in floats: the stored states (A), padded to
// an even count, then the fp64 partial sums
template <typename T>
__host__ __device__ inline int64_t bw_states(int64_t BH, int64_t nt, int rows,
                                             int cols) {
  constexpr int NC = BwRoute<T>::NC;
  return (BH * bw_tiles(cols, NC) * bw_chunks(nt) * NC * rows *
              (int64_t)(sizeof(typename BwRoute<T>::A) / 4) +
          1) / 2 * 2;
}
template <typename T>
inline int64_t wkv_bwd_floats(int64_t BH, int64_t nt, int dk, int dv) {
  const int64_t tiles = bw_tiles(dv, BwRoute<T>::NC);
  return bw_states<T>(BH, nt, dk, dv) +
         2 * (tiles * BH * nt * (3 * dk + 1)  // dr, dk, dw, v.do
              + BH * tiles * dk);             // du
}
template <typename T>
inline int64_t ssd_bwd_floats(int64_t BH, int64_t nt, int n, int p) {
  const int64_t tiles = bw_tiles(p, BwRoute<T>::NC);
  return bw_states<T>(BH, nt, n, p) +
         2 * tiles * BH * nt * (2 * n + 1);  // dB, dC, sum G o H
}

template <typename T, int DK>
size_t wkv_bwd_smem() {
  using A = typename BwRoute<T>::A;
  constexpr int NC = BwRoute<T>::NC;
  // v . dO [BW_CHUNK] (fp64), the chunk's state [NC][DK] and the column
  // sums [DK][NC + 1] (A), then R, K, W [BW_CHUNK][DK] and V, dO
  // [BW_CHUNK][NC] (fp32)
  return sizeof(double) * BW_CHUNK + sizeof(A) * (NC * DK + DK * (NC + 1)) +
         sizeof(float) * (3 * BW_CHUNK * DK + 2 * BW_CHUNK * NC);
}

// rows [t0, t0 + n) of a (T, DK) input -> shared [n][DK] (fp32)
template <typename T, int DK>
__device__ __forceinline__ void stage_rows(float* s, const T* __restrict__ g,
                                           int t0, int n) {
  for (int i = threadIdx.x; i < n * DK; i += blockDim.x)
    s[i] = to_f(g[(size_t)t0 * DK + i]);
}

// rows [t0, t0 + n), columns [col0, col0 + NC) of a (T, cols) input ->
// shared [BW_CHUNK][NC], zeros past the columns and rows
template <typename T, int NC>
__device__ __forceinline__ void stage_cols(float* s, const T* __restrict__ g,
                                           int t0, int n, int cols, int col0) {
  for (int i = threadIdx.x; i < BW_CHUNK * NC; i += blockDim.x) {
    const int tt = i / NC, j = col0 + i % NC;
    s[i] = tt < n && j < cols ? to_f(g[(size_t)(t0 + tt) * cols + j]) : 0.f;
  }
}

template <typename T, int DK>
__global__ void __launch_bounds__(128)
wkv_bwd(const T* __restrict__ r, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ w,
        const T* __restrict__ u, const T* __restrict__ dout,
        const float* __restrict__ dstate, T* __restrict__ dv_out,
        float* __restrict__ ws, int BH, int H, int nt, int dv) {
  using A = typename BwRoute<T>::A;
  constexpr int NC = BwRoute<T>::NC, RP = NC + 1;
  extern __shared__ float4 smem4[];
  double* VD = reinterpret_cast<double*>(smem4);  // this tile's v . dO
  A* CK = reinterpret_cast<A*>(VD + BW_CHUNK);    // the chunk's first S_{t-1}, [col][row]
  A* RED = CK + NC * DK;                          // the rows' dv terms, [row][col]
  float* Rs = reinterpret_cast<float*>(RED + DK * RP);
  float* Ks = Rs + BW_CHUNK * DK;
  float* Ws = Ks + BW_CHUNK * DK;
  float* Vs = Ws + BW_CHUNK * DK;
  float* Os = Vs + BW_CHUNK * NC;  // dO

  const int bh = blockIdx.x, h = bh % H, tile = blockIdx.y, tiles = gridDim.y;
  const int c = threadIdx.x;  // this thread's state row
  const int col0 = tile * NC, cw = min(NC, dv - col0);
  const int nch = (int)bw_chunks(nt);
  const size_t kb = (size_t)bh * nt * DK, vb = (size_t)bh * nt * dv;
  A* ckpt = reinterpret_cast<A*>(ws) + ((size_t)bh * tiles + tile) * nch * NC * DK;
  double* sums = reinterpret_cast<double*>(
      ws + bw_states<T>(BH, nt, DK, dv));
  const size_t n_part = (size_t)BH * nt * DK;
  double* part = sums + (size_t)tile * 3 * n_part + (size_t)bh * nt * DK;
  double* vdo_part = sums + (size_t)tiles * 3 * n_part +
                     ((size_t)tile * BH + bh) * nt;
  double* du_part = sums + (size_t)tiles * BH * nt * (3 * DK + 1) +
                    ((size_t)bh * tiles + tile) * DK;
  const float uc = to_f(u[(size_t)h * DK + c]);

  // pass 1: S_{t0-1} of every chunk
  A S[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) S[j] = 0;
  for (int ci = 0; ci < nch; ++ci) {
    A* ck = ckpt + (size_t)ci * NC * DK;
#pragma unroll
    for (int j = 0; j < NC; ++j) ck[j * DK + c] = S[j];
    if (ci + 1 == nch) break;
    const int t0 = ci * BW_CHUNK;
    __syncthreads();  // the last chunk's reads are done
    stage_rows<T, DK>(Ks, k + kb, t0, BW_CHUNK);
    stage_rows<T, DK>(Ws, w + kb, t0, BW_CHUNK);
    stage_cols<T, NC>(Vs, v + vb, t0, BW_CHUNK, dv, col0);
    __syncthreads();
    for (int tt = 0; tt < BW_CHUNK; ++tt) {
      const A kc = Ks[tt * DK + c], wc = Ws[tt * DK + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) S[j] = fma(wc, S[j], kc * Vs[tt * NC + j]);
    }
  }

  // pass 2: the chunks last to first, G = dL/dS_t in registers
  A G[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
    G[j] = dstate != nullptr && j < cw
               ? dstate[((size_t)bh * DK + c) * dv + col0 + j] : 0.f;
  double du = 0.0;
  for (int ci = nch - 1; ci >= 0; --ci) {
    const int t0 = ci * BW_CHUNK, n = min(BW_CHUNK, nt - t0);
    __syncthreads();  // the last chunk's reads are done
    stage_rows<T, DK>(Rs, r + kb, t0, n);
    stage_rows<T, DK>(Ks, k + kb, t0, n);
    stage_rows<T, DK>(Ws, w + kb, t0, n);
    stage_cols<T, NC>(Vs, v + vb, t0, n, dv, col0);
    stage_cols<T, NC>(Os, dout + vb, t0, n, dv, col0);
    const A* ck = ckpt + (size_t)ci * NC * DK;
    for (int i = c; i < NC * DK; i += DK) CK[i] = ck[i];
    __syncthreads();
    for (int tt = c; tt < n; tt += DK) {  // this tile's v . dO
      double s = 0.0;
#pragma unroll 8
      for (int j = 0; j < NC; ++j)
        s = fma((double)Vs[tt * NC + j], (double)Os[tt * NC + j], s);
      VD[tt] = s;
    }
    __syncthreads();
    for (int tt = n - 1; tt >= 0; --tt) {
      // S = S_{t-1}: the chunk's stored state, then its steps before tt
#pragma unroll
      for (int j = 0; j < NC; ++j) S[j] = CK[j * DK + c];
      for (int q = 0; q < tt; ++q) {
        const A kc = Ks[q * DK + c], wc = Ws[q * DK + c];
#pragma unroll
        for (int j = 0; j < NC; ++j) S[j] = fma(wc, S[j], kc * Vs[q * NC + j]);
      }
      const A rc = Rs[tt * DK + c], kc = Ks[tt * DK + c],
              wc = Ws[tt * DK + c], ruk = rc * (A)uc * kc;
      const float* vt = Vs + tt * NC;
      const float* ot = Os + tt * NC;
      double dr = 0.0, dkk = 0.0, dw = 0.0;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        dr = fma((double)S[j], (double)ot[j], dr);
        dkk = fma((double)G[j], (double)vt[j], dkk);
        dw = fma((double)G[j], (double)S[j], dw);
        RED[c * RP + j] = fma(kc, G[j], ruk * ot[j]);
        G[j] = fma(wc, G[j], rc * ot[j]);
      }
      const size_t at = (size_t)(t0 + tt) * DK + c;
      part[at] = dr;
      part[n_part + at] = dkk;
      part[2 * n_part + at] = dw;
      du = fma((double)rc * kc, VD[tt], du);
      if (c == 0) vdo_part[t0 + tt] = VD[tt];
      __syncthreads();
      for (int j = c; j < cw; j += DK) {  // dv_t: the rows' sum
        double s = 0.0;
#pragma unroll 8
        for (int i = 0; i < DK; ++i) s += RED[i * RP + j];
        dv_out[vb + (size_t)(t0 + tt) * dv + col0 + j] = from_f<T>((float)s);
      }
      __syncthreads();
    }
  }
  du_part[c] = du;
}

// dr, dk, dw: the tiles' partial sums plus the u terms, and du: the
// partials of every (b, tile), each in a fixed order
template <typename T>
__global__ void __launch_bounds__(256)
wkv_bwd_finish(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ u, const float* __restrict__ ws,
               T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dw,
               T* __restrict__ du, int B, int H, int nt, int DK, int dv) {
  constexpr int NC = BwRoute<T>::NC;
  const int64_t BH = (int64_t)B * H, tiles = bw_tiles(dv, NC);
  const int64_t n_part = BH * nt * DK;
  const double* part = reinterpret_cast<const double*>(
      ws + bw_states<T>(BH, nt, DK, dv));
  const double* vdo_part = part + tiles * 3 * n_part;
  const double* du_part = vdo_part + tiles * BH * nt;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_part;
       i += stride) {
    const int64_t row = i / DK;  // (b h, t)
    const int c = (int)(i % DK), h = (int)(row / nt % H);
    double vdo = 0.0, a = 0.0, b = 0.0, d = 0.0;
    for (int64_t ti = 0; ti < tiles; ++ti) {
      vdo += vdo_part[ti * BH * nt + row];
      a += part[ti * 3 * n_part + i];
      b += part[(ti * 3 + 1) * n_part + i];
      d += part[(ti * 3 + 2) * n_part + i];
    }
    const double uc = to_f(u[(int64_t)h * DK + c]);
    dr[i] = from_f<T>((float)fma(uc * to_f(k[i]), vdo, a));
    dk[i] = from_f<T>((float)fma(to_f(r[i]) * uc, vdo, b));
    dw[i] = from_f<T>((float)d);
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < (int64_t)H * DK; i += stride) {
    const int h = (int)(i / DK), c = (int)(i % DK);
    double s = 0.0;
    for (int bb = 0; bb < B; ++bb)
      for (int64_t ti = 0; ti < tiles; ++ti)
        s += du_part[(((int64_t)bb * H + h) * tiles + ti) * DK + c];
    du[i] = from_f<T>((float)s);
  }
}

template <typename T, int DK>
int launch_wkv_bwd(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* dout, const float* dstate,
                   void* dr, void* dk, void* dv_out, void* dw, void* du,
                   float* ws, int64_t B, int64_t H, int64_t nt, int dv,
                   cudaStream_t stream) {
  const size_t smem = wkv_bwd_smem<T, DK>();
  cudaError_t e = cudaFuncSetAttribute(
      wkv_bwd<T, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  wkv_bwd<T, DK><<<dim3((unsigned)(B * H), (unsigned)bw_tiles(dv, BwRoute<T>::NC)),
                   DK, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const T*>(dout), dstate,
      static_cast<T*>(dv_out), ws, (int)(B * H), (int)H, (int)nt, dv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int64_t n = B * H * nt * DK;
  wkv_bwd_finish<T><<<(unsigned)std::min<int64_t>((n + 255) / 256, 4096), 256,
                      0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(u), ws, static_cast<T*>(dr), static_cast<T*>(dk),
      static_cast<T*>(dw), static_cast<T*>(du), (int)B, (int)H, (int)nt, DK, dv);
  return cudaGetLastError();
}

template <typename T>
int wkv_bwd_by_dim(int dk, const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* dout,
                   const float* dstate, void* dr, void* dkk, void* dv_out,
                   void* dw, void* du, float* ws, int64_t B, int64_t H,
                   int64_t nt, int dv, cudaStream_t st) {
  switch (dk) {
    case 16: return launch_wkv_bwd<T, 16>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, nt, dv, st);
    case 32: return launch_wkv_bwd<T, 32>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, nt, dv, st);
    case 48: return launch_wkv_bwd<T, 48>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, nt, dv, st);
    case 64: return launch_wkv_bwd<T, 64>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, nt, dv, st);
    case 128: return launch_wkv_bwd<T, 128>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, nt, dv, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int N>
size_t ssd_bwd_smem() {
  using A = typename BwRoute<T>::A;
  constexpr int NC = BwRoute<T>::NC;
  // each row's sum of G o H_{t-1} [N] (fp64), the chunk's state [NC][N],
  // the column sums [N][NC + 1] and exp(log_a) [BW_CHUNK] (A), then B, C
  // [BW_CHUNK][N] and x, dy [BW_CHUNK][NC] (fp32)
  return sizeof(double) * N + sizeof(A) * (NC * N + N * (NC + 1) + BW_CHUNK) +
         sizeof(float) * (2 * BW_CHUNK * N + 2 * BW_CHUNK * NC);
}

template <typename T, int N>
__global__ void __launch_bounds__(128)
ssd_bwd(const T* __restrict__ x, const float* __restrict__ la,
        const float* __restrict__ Bm, const float* __restrict__ Cm,
        const T* __restrict__ dy, const float* __restrict__ dstate,
        T* __restrict__ dx, float* __restrict__ ws, int BH, int H, int nt,
        int p) {
  using A = typename BwRoute<T>::A;
  constexpr int NC = BwRoute<T>::NC, RP = NC + 1;
  extern __shared__ float4 smem4[];
  double* GH = reinterpret_cast<double*>(smem4);  // each row's sum of G o H
  A* CK = reinterpret_cast<A*>(GH + N);           // the chunk's first H_{t-1}, [col][row]
  A* RED = CK + NC * N;                           // the rows' dx terms, [row][col]
  A* As = RED + N * RP;                           // exp(log_a)
  float* Bs = reinterpret_cast<float*>(As + BW_CHUNK);
  float* Cs = Bs + BW_CHUNK * N;
  float* Xs = Cs + BW_CHUNK * N;
  float* Ys = Xs + BW_CHUNK * NC;  // dy

  const int bh = blockIdx.x, b = bh / H, tile = blockIdx.y, tiles = gridDim.y;
  const int c = threadIdx.x;  // this thread's state row
  const int col0 = tile * NC, cw = min(NC, p - col0);
  const int nch = (int)bw_chunks(nt);
  const size_t xb = (size_t)bh * nt * p;
  const size_t nb = (size_t)b * nt * N;  // B and C are shared by the heads
  const float* lb = la + (size_t)bh * nt;
  A* ckpt = reinterpret_cast<A*>(ws) + ((size_t)bh * tiles + tile) * nch * NC * N;
  double* sums = reinterpret_cast<double*>(
      ws + bw_states<T>(BH, nt, N, p));
  const size_t n_part = (size_t)BH * nt * N;
  double* part = sums + (size_t)tile * 2 * n_part + (size_t)bh * nt * N;
  double* gh_part = sums + (size_t)tiles * 2 * n_part +
                    ((size_t)tile * BH + bh) * nt;

  // pass 1: H_{t0-1} of every chunk
  A S[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) S[j] = 0;
  for (int ci = 0; ci < nch; ++ci) {
    A* ck = ckpt + (size_t)ci * NC * N;
#pragma unroll
    for (int j = 0; j < NC; ++j) ck[j * N + c] = S[j];
    if (ci + 1 == nch) break;
    const int t0 = ci * BW_CHUNK;
    __syncthreads();  // the last chunk's reads are done
    for (int i = c; i < BW_CHUNK * N; i += N) Bs[i] = Bm[nb + (size_t)t0 * N + i];
    stage_cols<T, NC>(Xs, x + xb, t0, BW_CHUNK, p, col0);
    for (int i = c; i < BW_CHUNK; i += N) As[i] = exp((A)lb[t0 + i]);
    __syncthreads();
    for (int tt = 0; tt < BW_CHUNK; ++tt) {
      const A bc = Bs[tt * N + c], a = As[tt];
#pragma unroll
      for (int j = 0; j < NC; ++j) S[j] = fma(a, S[j], bc * Xs[tt * NC + j]);
    }
  }

  // pass 2: the chunks last to first, G = a_{t+1} dL/dH_{t+1} in registers
  A G[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
    G[j] = dstate != nullptr && j < cw
               ? dstate[((size_t)bh * N + c) * p + col0 + j] : 0.f;
  for (int ci = nch - 1; ci >= 0; --ci) {
    const int t0 = ci * BW_CHUNK, n = min(BW_CHUNK, nt - t0);
    __syncthreads();  // the last chunk's reads are done
    for (int i = c; i < n * N; i += N) {
      Bs[i] = Bm[nb + (size_t)t0 * N + i];
      Cs[i] = Cm[nb + (size_t)t0 * N + i];
    }
    stage_cols<T, NC>(Xs, x + xb, t0, n, p, col0);
    stage_cols<T, NC>(Ys, dy + xb, t0, n, p, col0);
    for (int i = c; i < n; i += N) As[i] = exp((A)lb[t0 + i]);
    const A* ck = ckpt + (size_t)ci * NC * N;
    for (int i = c; i < NC * N; i += N) CK[i] = ck[i];
    __syncthreads();
    for (int tt = n - 1; tt >= 0; --tt) {
      // S = H_{t-1}: the chunk's stored state, then its steps before tt
#pragma unroll
      for (int j = 0; j < NC; ++j) S[j] = CK[j * N + c];
      for (int q = 0; q < tt; ++q) {
        const A bc = Bs[q * N + c], a = As[q];
#pragma unroll
        for (int j = 0; j < NC; ++j) S[j] = fma(a, S[j], bc * Xs[q * NC + j]);
      }
      const A bc = Bs[tt * N + c], cc = Cs[tt * N + c], a = As[tt];
      const float* xt = Xs + tt * NC;
      const float* yt = Ys + tt * NC;
      double db = 0.0, dc = 0.0, gh = 0.0;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const A g = fma(cc, (A)yt[j], G[j]);       // G_t
        const A ht = fma(a, S[j], bc * xt[j]);     // H_t
        dc = fma((double)yt[j], (double)ht, dc);
        db = fma((double)g, (double)xt[j], db);
        gh = fma((double)g, (double)S[j], gh);
        RED[c * RP + j] = bc * g;
        G[j] = a * g;
      }
      GH[c] = gh;
      const size_t at = (size_t)(t0 + tt) * N + c;
      part[at] = db;
      part[n_part + at] = dc;
      __syncthreads();
      for (int j = c; j <= NC; j += N) {  // dx_t and sum G o H_{t-1}
        if (j < NC && j >= cw) continue;
        double s = 0.0;
        if (j < NC) {
#pragma unroll 8
          for (int i = 0; i < N; ++i) s += RED[i * RP + j];
          dx[xb + (size_t)(t0 + tt) * p + col0 + j] = from_f<T>((float)s);
        } else {
          for (int i = 0; i < N; ++i) s += GH[i];
          gh_part[t0 + tt] = s;
        }
      }
      __syncthreads();
    }
  }
}

// dB, dC: the heads' and tiles' partial sums; dlog_a = exp(log_a) times
// the tiles' sums of G o H_{t-1}; each in a fixed order
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_finish(const float* __restrict__ la, const float* __restrict__ ws,
               float* __restrict__ dla, float* __restrict__ dB,
               float* __restrict__ dC, int B, int H, int nt, int N, int p) {
  const int64_t BH = (int64_t)B * H, tiles = bw_tiles(p, BwRoute<T>::NC);
  const int64_t n_part = BH * nt * N;
  const double* part = reinterpret_cast<const double*>(
      ws + bw_states<T>(BH, nt, N, p));
  const double* gh_part = part + tiles * 2 * n_part;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t per_b = (int64_t)nt * N;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < B * per_b; i += stride) {
    const int64_t b = i / per_b, tn = i % per_b;
    double sb = 0.0, sc = 0.0;
    for (int64_t ti = 0; ti < tiles; ++ti)
      for (int h = 0; h < H; ++h) {
        const int64_t at = (b * H + h) * per_b + tn;
        sb += part[ti * 2 * n_part + at];
        sc += part[(ti * 2 + 1) * n_part + at];
      }
    dB[i] = (float)sb;
    dC[i] = (float)sc;
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < BH * nt;
       i += stride) {
    double s = 0.0;
    for (int64_t ti = 0; ti < tiles; ++ti) s += gh_part[ti * BH * nt + i];
    dla[i] = (float)(exp((double)la[i]) * s);  // a decay of 0 gives 0, not 0 * inf
  }
}

template <typename T, int N>
int launch_ssd_bwd(const void* x, const float* la, const float* Bm,
                   const float* Cm, const void* dy, const float* dstate,
                   void* dx, float* dla, float* dB, float* dC, float* ws,
                   int64_t B, int64_t H, int64_t nt, int p,
                   cudaStream_t stream) {
  constexpr int NC = BwRoute<T>::NC;
  const size_t smem = ssd_bwd_smem<T, N>();
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ssd_bwd<T, N><<<dim3((unsigned)(B * H), (unsigned)bw_tiles(p, NC)), N, smem,
                  stream>>>(
      static_cast<const T*>(x), la, Bm, Cm, static_cast<const T*>(dy), dstate,
      static_cast<T*>(dx), ws, (int)(B * H), (int)H, (int)nt, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int64_t n = B * nt * N;
  ssd_bwd_finish<T><<<(unsigned)std::min<int64_t>((n + 255) / 256, 4096), 256,
                      0, stream>>>(la, ws, dla, dB, dC, (int)B, (int)H,
                                   (int)nt, N, p);
  return cudaGetLastError();
}

template <typename T>
int ssd_bwd_by_dim(int n, const void* x, const float* la, const float* Bm,
                   const float* Cm, const void* dy, const float* dstate,
                   void* dx, float* dla, float* dB, float* dC, float* ws,
                   int64_t B, int64_t H, int64_t nt, int p, cudaStream_t st) {
  switch (n) {
    case 16: return launch_ssd_bwd<T, 16>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, nt, p, st);
    case 32: return launch_ssd_bwd<T, 32>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, nt, p, st);
    case 48: return launch_ssd_bwd<T, 48>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, nt, p, st);
    case 64: return launch_ssd_bwd<T, 64>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, nt, p, st);
    case 128: return launch_ssd_bwd<T, 128>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, nt, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The bf16 routes of K7's and K8's backward ("chunked reverse scans on
// mma"): the forwards' chunked algebra (ssd_chunked, wkv_chunked)
// transposed, every fp32 operand of a tensor-core product in two bf16
// pieces (the products hi hi + hi lo + lo hi; x, dy, v and dO are exact in
// bf16), fp32 sums.  One rounding a side misses 1e-2 (1 + |g|) by 7-24x
// (tests/test_torch_ssm_bwd_chunked.py, a plain emulation of both
// algorithms that rounds where they round).  Products are mma.sync
// m16n8k16: the pair blocks of K7 are 16 wide, and K8's 64-row products
// run as 16-row warp tiles of the same instruction (no wgmma yet).

// mma.sync m16n8k16 fragments, lane = 4 g + q: A (16 x 16, row i, column
// j): a[0] (g, 2q..2q+1), a[1] (g + 8, ..), a[2] (g, 2q + 8..), a[3]
// (g + 8, 2q + 8..); B (16 x 8, row k, column n): b[0] (2q..2q+1, g), b[1]
// (2q + 8.., g); C (16 x 8): c[0..1] (g, 2q..2q+1), c[2..3] (g + 8, ..).
// The frag_* helpers build a fragment from f(row, column) of the tile:
// "2" in two bf16 pieces (split_bf16), "1" rounded once (for values that
// are exact in bf16: x, dy, v, dO).

template <class F>
__device__ __forceinline__ void frag_a2(F f, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = g + 8 * (r & 1), j = 2 * q + 8 * (r >> 1);
    uint32_t p[2];
    split_bf16(f(i, j), f(i, j + 1), p);
    hi[r] = p[0];
    lo[r] = p[1];
  }
}
template <class F>
__device__ __forceinline__ void frag_a1(F f, uint32_t (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = g + 8 * (r & 1), j = 2 * q + 8 * (r >> 1);
    a[r] = pack_bf16(f(i, j), f(i, j + 1));
  }
}
template <class F>
__device__ __forceinline__ void frag_b2(F f, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = 2 * q + 8 * r;
    uint32_t p[2];
    split_bf16(f(k, g), f(k + 1, g), p);
    hi[r] = p[0];
    lo[r] = p[1];
  }
}
template <class F>
__device__ __forceinline__ void frag_b1(F f, uint32_t (&b)[2]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) b[r] = pack_bf16(f(2 * q + 8 * r, g), f(2 * q + 8 * r + 1, g));
}

// d += a b: both sides in pieces (hi hi + hi lo + lo hi), one side in
// pieces and the other exact, or both exact
__device__ __forceinline__ void mma_pp(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                       const uint32_t (&bl)[2]) {
  mma_bf16(d, ah[0], ah[1], ah[2], ah[3], bh[0], bh[1]);
  mma_bf16(d, ah[0], ah[1], ah[2], ah[3], bl[0], bl[1]);
  mma_bf16(d, al[0], al[1], al[2], al[3], bh[0], bh[1]);
}
__device__ __forceinline__ void mma_pe(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&b)[2]) {
  mma_bf16(d, ah[0], ah[1], ah[2], ah[3], b[0], b[1]);
  mma_bf16(d, al[0], al[1], al[2], al[3], b[0], b[1]);
}
__device__ __forceinline__ void mma_ep(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  mma_bf16(d, a[0], a[1], a[2], a[3], bh[0], bh[1]);
  mma_bf16(d, a[0], a[1], a[2], a[3], bl[0], bl[1]);
}
__device__ __forceinline__ void mma_ee(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  mma_bf16(d, a[0], a[1], a[2], a[3], b[0], b[1]);
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }

// By one whole warp, as ssd_chunked: the fp64 inclusive sums of a chunk's
// log-decays la[0 .. SQ) in shared memory (each floored at kLogDecayFloor;
// the rows past T staged as 0), lane l holding those of steps 2l and 2l + 1
// in cu0 and cu1; returns the chunk's whole sum (cum[63]) in every lane
__device__ __forceinline__ double chunk_cum(const float* la, double& cu0, double& cu1) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const double v0 = fmax((double)la[2 * lane], kLogDecayFloor);
  const double v1 = fmax((double)la[2 * lane + 1], kLogDecayFloor);
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
  return __shfl_sync(kAll, cu1, 31);
}

// -- K8's backward, bf16 x: three launches
//
// (1) ssd_bwd_states, a block per (P tile, b h, direction), 4 warps, the
//     64-step chunks walked first to last (H, from 0) or last to first
//     (dH, from dstate) with the state in mma accumulators as ssd_chunked
//     keeps it, a 2-stage cp.async ring of B (C), x (dy) and log_a: the
//     state at every chunk boundary is stored (H_start, dH_end: fp32
//     [b h][chunk][N][P]), then H <- e^{cend} H + (B o e^{cend-cum_s})^T x
//     or dH <- e^{cend} dH + (C o e^{cum_t})^T dy;
// (2) ssd_bwd_chunk, a block per (chunk, P tile, b, group of kBwHeads
//     heads), 8 warps (16 rows by half the columns each), the group's heads
//     one after another: C B^T once, then per head
//         dX = M^T dy + (B o e^{cend-cum_s}) dH_end,  M = C B^T o L
//         dC = (dM o L) B + diag(e^{cum_t}) dy H_start^T,  dM = dy x^T
//         dB = (dM o L)^T C + diag(e^{cend-cum_s}) x dH_end^T
//         dlog_a_t = sum_{tau>=t, s<t} (M o dM)[tau, s] + sum_{tau>=t} z_tau
//                    + sum_{s<t} w_s + e^{cend} <dH_end, H_start>,
//     z_t = C_t . (dC's state part)_t, w_s = B_s . (dB's state part)_s:
//     dlog_a in its direct form (every exponent spans a_t, none is
//     positive, nothing is divided, no differences that cancel), the box
//     sums of M o dM as a column pass then a row pass in fp32; dB and dC
//     summed over the group's heads in registers; decays from the fp64
//     sums of log_a floored at -128, as the forward's;
// (3) ssd_bwd_sum: dB and dC over the groups and P tiles, dlog_a over the
//     P tiles, in a fixed order.
// What bounds it (edited copies with a part taken out, PERF.md §6): the
// chunk kernel waits on its inputs and its box sums more than on its
// products (dB and dC took 0.20 ms of 1.65 at zamba2-2.7b's training
// shape before the head prefetch), one block an SM; the walks store
// 0.67 GB a launch (0.28 ms).
constexpr int kBwHeads = 8;

template <int N>
struct SsdBwSmem {
  static constexpr int BST = N + 4, GST = SQ + 4, HST = SP + 4, XST = SP + 8;
  // ssd_bwd_states: two stages, each B or C [SQ][BST], x or dy [SQ][XST]
  // bf16 and log_a [SQ]; then the rows' decays [SQ] and e^{cend}
  static constexpr int kStage = SQ * BST + SQ * XST / 2 + SQ;
  static constexpr size_t states_bytes = sizeof(float) * (2 * kStage + SQ + 4);
  // ssd_bwd_chunk, shared by the heads: C, B [SQ][BST]; G, M, dM o L
  // [SQ][GST]; z, w [2][SQ] (the two column halves); the box sums' segment
  // totals and the row sums' parts [4][SQ]; 8 warps' <dH_end, H_start>.
  // Then a buffer per head in flight (two where they fit: the next head's
  // lands while this one runs): H_start, dH_end [N][HST], x, dy [SQ][XST]
  // bf16, log_a [SQ].
  static constexpr int kC = 0, kB = SQ * BST, kG = 2 * SQ * BST, kM = kG + SQ * GST,
                       kD = kM + SQ * GST, kZ = kD + SQ * GST, kW = kZ + 2 * SQ,
                       kTot = kW + 2 * SQ, kPart = kTot + 4 * SQ, kRed = kPart + 4 * SQ,
                       kBuf0 = kRed + 8;
  static constexpr int kH = 0, kdH = N * HST, kX = 2 * N * HST, kLa = kX + SQ * XST,
                       kBuf = kLa + SQ;
  static constexpr size_t chunk_bytes_for(int bufs) {
    return sizeof(float) * (kBuf0 + (size_t)bufs * kBuf);
  }
  static constexpr int kBufs = chunk_bytes_for(2) <= kSmemMax ? 2 : 1;
  static constexpr size_t chunk_bytes = chunk_bytes_for(kBufs);
};

template <int N>
__global__ void __launch_bounds__(128)
ssd_bwd_states(const __nv_bfloat16* __restrict__ x, const float* __restrict__ la,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               const __nv_bfloat16* __restrict__ dy, const float* __restrict__ dstate,
               float* __restrict__ Hs, float* __restrict__ dHs, int H, int T, int P) {
  using L = SsdBwSmem<N>;
  constexpr int BST = L::BST, XST = L::XST, NT = N / 16, MY = (NT + 3) / 4;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* dcy = sm + 2 * L::kStage;  // [SQ] the rows' decays, [SQ] e^{cend}

  // z = 0: the chunks first to last, H (from 0) before each; z = 1: last to
  // first, dH (from dstate) after each
  const bool rev = blockIdx.z == 1;
  const float* rows = rev ? Cm : Bm;
  const __nv_bfloat16* cols = rev ? dy : x;
  float* out = rev ? dHs : Hs;
  const int p0 = blockIdx.x * SP, bh = blockIdx.y, b = bh / H;
  const int nch = (T + SQ - 1) / SQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const size_t row0 = (size_t)bh * T;
  const bool rvec = (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  const bool xvec = P % 8 == 0 && (reinterpret_cast<uintptr_t>(cols) & 15) == 0;

  auto rows_of = [&](int st) { return sm + st * L::kStage; };
  auto cols_of = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(rows_of(st) + SQ * BST);
  };
  auto la_of = [&](int st) { return rows_of(st) + SQ * BST + SQ * XST / 2; };
  // chunk c's B (C), x (dy) tile and log_a into stage st; rows past T zero
  auto load_chunk = [&](int c, int st) {
    const int t0 = c * SQ;
    float* rs = rows_of(st);
    for (int i = threadIdx.x; i < SQ * N / 4; i += 128) {
      const int r = i / (N / 4), v = i % (N / 4), t = t0 + r;
      float* d = rs + r * BST + 4 * v;
      const float* src = rows + ((size_t)b * T + t) * N + 4 * v;
      if (t < T && rvec) {
        cp_async16(d, src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = t < T ? src[e] : 0.f;
      }
    }
    __nv_bfloat16* xs = cols_of(st);
    for (int i = threadIdx.x; i < SQ * (SP / 8); i += 128) {
      const int r = i / (SP / 8), v = i % (SP / 8), t = t0 + r, p = p0 + 8 * v;
      __nv_bfloat16* d = xs + r * XST + 8 * v;
      if (t < T && xvec && p + 8 <= P) {
        cp_async16(d, cols + (row0 + t) * P + p);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = t < T && p + e < P ? cols[(row0 + t) * P + p + e] : __float2bfloat16(0.f);
      }
    }
    if (threadIdx.x < SQ) {
      float* ls = la_of(st);
      const int i = threadIdx.x;
      if (t0 + i < T) cp_async4(ls + i, la + row0 + t0 + i);
      else ls[i] = 0.f;
    }
    cp_async_commit();
  };

  // the state: rows 16 (warp + 4 m) + g (+8), columns 8 j + 2q (+1), as
  // ssd_chunked's
  float S[MY][8][4];
#pragma unroll
  for (int m = 0; m < MY; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * (warp + 4 * m) + g + 8 * (e >> 1), p = p0 + 8 * j + 2 * q + (e & 1);
        S[m][j][e] = rev && dstate != nullptr && n < N && p < P
                         ? dstate[((size_t)bh * N + n) * P + p] : 0.f;
      }

  load_chunk(rev ? nch - 1 : 0, 0);
  for (int i = 0; i < nch; ++i) {
    const int c = rev ? nch - 1 - i : i, st = i & 1;
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; the last chunk's reads are done
    if (i + 1 < nch) load_chunk(rev ? c - 1 : c + 1, st ^ 1);
    if (warp == 0) {  // e^{cend - cum_s} (B's) or e^{cum_t} (C's), and e^{cend}
      double cu0, cu1;
      const double cend = chunk_cum(la_of(st), cu0, cu1);
      dcy[2 * lane] = rev ? expf((float)cu0) : __expf((float)(cend - cu0));
      dcy[2 * lane + 1] = rev ? expf((float)cu1) : __expf((float)(cend - cu1));
      if (lane == 0) dcy[SQ] = expf((float)cend);
    }
    {  // the state at this chunk's boundary
      float* ob = out + ((size_t)bh * nch + c) * N * P;
#pragma unroll
      for (int m = 0; m < MY; ++m) {
        const int tile = warp + 4 * m;
        if (tile >= NT) break;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int n = 16 * tile + g + 8 * (e >> 1), p = p0 + 8 * j + 2 * q + (e & 1);
            if (p < P) ob[(size_t)n * P + p] = S[m][j][e];
          }
      }
    }
    __syncthreads();  // the decays
    const float de = dcy[SQ];
#pragma unroll
    for (int m = 0; m < MY; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[m][j][e] *= de;
    // S += (rows o decay)^T cols over the chunk's steps, 16 at a time
    const float* rs = rows_of(st);
    const __nv_bfloat16* xs = cols_of(st);
#pragma unroll
    for (int kk = 0; kk < SQ / 16; ++kk) {
      uint32_t xb[8][2];  // cols[s (+1)][p], [s + 8 (+9)][p], s = 16 kk + 2 q, p = 8 j + g
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t r[4];
        const int mm = lane >> 3;
        ldmatrix_x4_trans(r, xs + (16 * kk + 8 * (mm & 1) + (lane & 7)) * XST +
                                 8 * (2 * jp + (mm >> 1)));
        xb[2 * jp][0] = r[0];
        xb[2 * jp][1] = r[1];
        xb[2 * jp + 1][0] = r[2];
        xb[2 * jp + 1][1] = r[3];
      }
      const int s = 16 * kk + 2 * q;
      const float d0 = dcy[s], d1 = dcy[s + 1], d8 = dcy[s + 8], d9 = dcy[s + 9];
#pragma unroll
      for (int m = 0; m < MY; ++m) {
        const int tile = warp + 4 * m;
        if (tile >= NT) break;
        const int n = 16 * tile + g;
        uint32_t a0[2], a1[2], a2[2], a3[2];
        split_bf16(rs[s * BST + n] * d0, rs[(s + 1) * BST + n] * d1, a0);
        split_bf16(rs[s * BST + n + 8] * d0, rs[(s + 1) * BST + n + 8] * d1, a1);
        split_bf16(rs[(s + 8) * BST + n] * d8, rs[(s + 9) * BST + n] * d9, a2);
        split_bf16(rs[(s + 8) * BST + n + 8] * d8, rs[(s + 9) * BST + n + 8] * d9, a3);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            mma_bf16(S[m][j], a0[k], a1[k], a2[k], a3[k], xb[j][0], xb[j][1]);
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(256)
ssd_bwd_chunk(const __nv_bfloat16* __restrict__ x, const float* __restrict__ la,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              const __nv_bfloat16* __restrict__ dy, const float* __restrict__ Hs,
              const float* __restrict__ dHs, __nv_bfloat16* __restrict__ dx,
              float* __restrict__ pla, float* __restrict__ pbc, int Bn, int H, int T, int P) {
  using L = SsdBwSmem<N>;
  constexpr int BST = L::BST, GST = L::GST, HST = L::HST, XST = L::XST, NB = L::kBufs;
  constexpr int NJ = N / 16;  // 8-wide tiles of n in a warp's half of N
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* Cs = sm + L::kC;
  float* Bs = sm + L::kB;
  float* Gs = sm + L::kG;
  float* Ms = sm + L::kM;
  float* Ds = sm + L::kD;
  float* zp = sm + L::kZ;
  float* wp = sm + L::kW;
  float* tot = sm + L::kTot;
  float* part = sm + L::kPart;
  float* red = sm + L::kRed;
  auto buf = [&](int k) { return sm + L::kBuf0 + k * L::kBuf; };

  const int c = blockIdx.x, nch = gridDim.x, pt = blockIdx.y, ptiles = gridDim.y;
  const int groups = (H + kBwHeads - 1) / kBwHeads;
  const int b = blockIdx.z / groups, grp = blockIdx.z % groups;
  const int nheads = min(kBwHeads, H - grp * kBwHeads);
  const int p0 = pt * SP, t0 = c * SQ, nrows = min(SQ, T - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int rw = warp & 3, hf = warp >> 2;
  const int tr = 16 * rw;        // the warp's rows (t or s) tr .. tr + 15
  const int n0 = (N / 2) * hf;   // its columns of n in dB and dC
  const int pc0 = 32 * hf;       // its columns of the P tile in dX
  const size_t NP = (size_t)N * P;
  const bool xvec = P % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) & 15) == 0;
  const bool hvec = P % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(Hs) | reinterpret_cast<uintptr_t>(dHs)) & 15) == 0;

  // head hs's x, dy, H_start, dH_end and log_a into buffer k (cp.async);
  // rows past T and columns past P are zeros
  auto load_head = [&](int hs, int k) {
    const size_t bh = (size_t)b * H + grp * kBwHeads + hs, row0 = bh * T;
    float* bk = buf(k);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(bk + L::kX);
    constexpr int XV = SQ * (SP / 8);  // 16-byte pieces of a tile
    for (int i = threadIdx.x; i < 2 * XV; i += 256) {
      const int a = i / XV, r = i % XV / (SP / 8), v = i % (SP / 8);
      const int t = t0 + r, p = p0 + 8 * v;
      const __nv_bfloat16* src = a ? dy : x;
      __nv_bfloat16* d = xs + (a * SQ + r) * XST + 8 * v;
      if (t < T && xvec && p + 8 <= P) {
        cp_async16(d, src + (row0 + t) * P + p);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d[e] = t < T && p + e < P ? src[(row0 + t) * P + p + e] : __float2bfloat16(0.f);
      }
    }
    constexpr int HV = N * (SP / 4);
    for (int i = threadIdx.x; i < 2 * HV; i += 256) {
      const int a = i / HV, n = i % HV / (SP / 4), v = i % (SP / 4), p = p0 + 4 * v;
      const float* src = (a ? dHs : Hs) + (bh * nch + c) * NP + (size_t)n * P;
      float* d = bk + (a ? L::kdH : L::kH) + n * HST + 4 * v;
      if (hvec && p + 4 <= P) {
        cp_async16(d, src + p);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = p + e < P ? src[p + e] : 0.f;
      }
    }
    if (threadIdx.x < SQ) {
      const int i = threadIdx.x;
      if (t0 + i < T) cp_async4(bk + L::kLa + i, la + row0 + t0 + i);
      else bk[L::kLa + i] = 0.f;
    }
    cp_async_commit();
  };

  if (NB == 2) load_head(0, 0);
  for (int i = threadIdx.x; i < SQ * N; i += 256) {
    const int r = i / N, n = i % N;
    const size_t gi = ((size_t)b * T + t0 + r) * N + n;
    Cs[r * BST + n] = r < nrows ? Cm[gi] : 0.f;
    Bs[r * BST + n] = r < nrows ? Bm[gi] : 0.f;
  }
  __syncthreads();
  // G = C B^T on the warp's causal tiles: rows tr.., columns 32 hf + 8 j
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s0 = pc0 + 8 * j;
    if (s0 > tr + 15) break;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kn = 0; kn < N / 16; ++kn) {
      uint32_t ah[4], al[4], bh_[2], bl[2];
      frag_a2([&](int i, int jj) { return Cs[(tr + i) * BST + 16 * kn + jj]; }, ah, al);
      frag_b2([&](int k, int n) { return Bs[(s0 + n) * BST + 16 * kn + k]; }, bh_, bl);
      mma_pp(acc, ah, al, bh_, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Gs[(tr + g + 8 * (e >> 1)) * GST + s0 + 2 * q + (e & 1)] = acc[e];
  }

  float dCa[NJ][4], dBa[NJ][4];  // rows tr.., columns n0 + 8 j
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dCa[j][e] = dBa[j][e] = 0.f;

  for (int hs = 0; hs < nheads; ++hs) {
    const size_t bh = (size_t)b * H + grp * kBwHeads + hs, row0 = bh * T;
    const int k = NB == 2 ? hs & 1 : 0;
    __syncthreads();  // G is ready; the last head's reads are done
    if (NB == 1) load_head(hs, 0);
    else if (hs + 1 < nheads) load_head(hs + 1, k ^ 1);
    if (NB == 2 && hs + 1 < nheads) cp_async_wait_one();
    else cp_async_wait_all();
    __syncthreads();  // head hs landed
    const float* bk = buf(k);
    const float* Hm = bk + L::kH;
    const float* dHm = bk + L::kdH;
    const __nv_bfloat16* Xs = reinterpret_cast<const __nv_bfloat16*>(bk + L::kX);
    const __nv_bfloat16* Ys = Xs + SQ * XST;

    // the chunk's fp64 sums of floored log-decays, in every warp (lane l
    // holds those of steps 2l, 2l + 1), and the decays of this thread's
    // rows tr + g, tr + g + 8
    double cu0, cu1;
    const double cend = chunk_cum(bk + L::kLa, cu0, cu1);
    auto cum_at = [&](int i) {
      const double lo = __shfl_sync(kAll, cu0, i >> 1), hi = __shfl_sync(kAll, cu1, i >> 1);
      return (i & 1) ? hi : lo;
    };
    const double ct0 = cum_at(tr + g), ct1 = cum_at(tr + g + 8);
    const float eT0 = expf((float)ct0), eT1 = expf((float)ct1);
    const float eL0 = __expf((float)(cend - ct0)), eL1 = __expf((float)(cend - ct1));
    const float de = expf((float)cend);

    // dy's fragments as A (rows tr.., columns 16 kp ..), shared by dM and
    // dC's state part
    uint32_t ya[SP / 16][4];
#pragma unroll
    for (int kp = 0; kp < SP / 16; ++kp)
      frag_a1([&](int i, int jj) { return bf(Ys[(tr + i) * XST + 16 * kp + jj]); }, ya[kp]);

    // dM = dy x^T on the warp's causal tiles -> Ds = dM o L and Ms = G o L,
    // zero above the diagonal
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s0 = pc0 + 8 * j;
      if (s0 > tr + 15) break;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kp = 0; kp < SP / 16; ++kp) {
        uint32_t bb[2];
        frag_b1([&](int kx, int n) { return bf(Xs[(s0 + n) * XST + 16 * kp + kx]); }, bb);
        mma_ee(acc, ya[kp], bb);
      }
      const double cs0 = cum_at(s0 + 2 * q), cs1 = cum_at(s0 + 2 * q + 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = tr + g + 8 * (e >> 1), s = s0 + 2 * q + (e & 1);
        float dm = 0.f, mm = 0.f;
        if (s <= t) {
          const float l = __expf((float)(((e >> 1) ? ct1 : ct0) - ((e & 1) ? cs1 : cs0)));
          dm = acc[e] * l;
          mm = Gs[t * GST + s] * l;
        }
        Ds[t * GST + s] = dm;
        Ms[t * GST + s] = mm;
      }
    }
    __syncthreads();

    {  // dX: rows tr.., columns pc0 + 8 j of the tile
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int kk = rw; kk < SQ / 16; ++kk) {  // M^T dy: s >= t
        uint32_t ah[4], al[4];
        frag_a2([&](int i, int jj) { return Ms[(16 * kk + jj) * GST + tr + i]; }, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bb[2];
          frag_b1([&](int kx, int n) { return bf(Ys[(16 * kk + kx) * XST + pc0 + 8 * j + n]); },
                  bb);
          mma_pe(acc[j], ah, al, bb);
        }
      }
#pragma unroll
      for (int kn = 0; kn < N / 16; ++kn) {  // (B o e^{cend - cum_t}) dH_end
        uint32_t ah[4], al[4];
        frag_a2([&](int i, int jj) {
          return Bs[(tr + i) * BST + 16 * kn + jj] * (i < 8 ? eL0 : eL1);
        }, ah, al);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh_[2], bl[2];
          frag_b2([&](int kx, int n) { return dHm[(16 * kn + kx) * HST + pc0 + 8 * j + n]; },
                  bh_, bl);
          mma_pp(acc[j], ah, al, bh_, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = t0 + tr + g + 8 * (e >> 1), p = p0 + pc0 + 8 * j + 2 * q + (e & 1);
          if (t < T && p < P) dx[(row0 + t) * P + p] = __float2bfloat16(acc[j][e]);
        }
    }

    {  // dC: its state part first (with C its row sums z), then (dM o L) B
      float st[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < SP / 16; ++kp)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t bh_[2], bl[2];
          frag_b2([&](int kx, int n) { return Hm[(n0 + 8 * j + n) * HST + 16 * kp + kx]; }, bh_,
                  bl);
          mma_ep(st[j], ya[kp], bh_, bl);
        }
      float z0 = 0.f, z1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = tr + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * q + (e & 1);
          const float v = st[j][e] * ((e >> 1) ? eT1 : eT0);
          dCa[j][e] += v;
          if (e >> 1) z1 = fmaf(Cs[row * BST + n], v, z1);
          else z0 = fmaf(Cs[row * BST + n], v, z0);
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        z0 += __shfl_xor_sync(kAll, z0, o);
        z1 += __shfl_xor_sync(kAll, z1, o);
      }
      if (q == 0) {
        zp[hf * SQ + tr + g] = z0;
        zp[hf * SQ + tr + g + 8] = z1;
      }
      for (int kk = 0; kk <= rw; ++kk) {  // s <= t
        uint32_t ah[4], al[4];
        frag_a2([&](int i, int jj) { return Ds[(tr + i) * GST + 16 * kk + jj]; }, ah, al);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t bh_[2], bl[2];
          frag_b2([&](int kx, int n) { return Bs[(16 * kk + kx) * BST + n0 + 8 * j + n]; }, bh_,
                  bl);
          mma_pp(dCa[j], ah, al, bh_, bl);
        }
      }
    }

    {  // dB: its state part first (with B its row sums w), then (dM o L)^T C
      float st[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
      for (int kp = 0; kp < SP / 16; ++kp) {
        uint32_t a[4];
        frag_a1([&](int i, int jj) { return bf(Xs[(tr + i) * XST + 16 * kp + jj]); }, a);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t bh_[2], bl[2];
          frag_b2([&](int kx, int n) { return dHm[(n0 + 8 * j + n) * HST + 16 * kp + kx]; },
                  bh_, bl);
          mma_ep(st[j], a, bh_, bl);
        }
      }
      float w0 = 0.f, w1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = tr + g + 8 * (e >> 1), n = n0 + 8 * j + 2 * q + (e & 1);
          const float v = st[j][e] * ((e >> 1) ? eL1 : eL0);
          dBa[j][e] += v;
          if (e >> 1) w1 = fmaf(Bs[row * BST + n], v, w1);
          else w0 = fmaf(Bs[row * BST + n], v, w0);
        }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        w0 += __shfl_xor_sync(kAll, w0, o);
        w1 += __shfl_xor_sync(kAll, w1, o);
      }
      if (q == 0) {
        wp[hf * SQ + tr + g] = w0;
        wp[hf * SQ + tr + g + 8] = w1;
      }
      for (int kk = rw; kk < SQ / 16; ++kk) {  // t >= s
        uint32_t ah[4], al[4];
        frag_a2([&](int i, int jj) { return Ds[(16 * kk + jj) * GST + tr + i]; }, ah, al);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          uint32_t bh_[2], bl[2];
          frag_b2([&](int kx, int n) { return Cs[(16 * kk + kx) * BST + n0 + 8 * j + n]; }, bh_,
                  bl);
          mma_pp(dBa[j], ah, al, bh_, bl);
        }
      }
    }

    {  // <dH_end, H_start> over the tile
      float hh = 0.f;
      for (int i = threadIdx.x; i < N * SP; i += 256) {
        const int o = i / SP * HST + i % SP;
        hh = fmaf(dHm[o], Hm[o], hh);
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) hh += __shfl_xor_sync(kAll, hh, o);
      if (lane == 0) red[warp] = hh;
    }
    __syncthreads();  // M is no longer read; z, w and the dots are whole
    // The box sums of M o dM = G o Ds, dlog_a's first term, over all
    // threads: (s, segment) first sums rows t > s of its 16-row segment
    // from the bottom, Ms[t][s] <- sum_{t <= tau in the segment} G Ds, and
    // the segment's total; then (t, part) sums its part's columns s < t of
    // Ms[t][s] plus the totals of the segments below t's, with its part of
    // the sums of w (s < t) and z (tau >= t)
    {
      const int s = threadIdx.x & (SQ - 1), seg = threadIdx.x >> 6;
      float acc = 0.f;
      for (int t = 16 * seg + 15; t >= 16 * seg && t > s; --t) {
        acc = fmaf(Gs[t * GST + s], Ds[t * GST + s], acc);
        Ms[t * GST + s] = acc;
      }
      tot[seg * SQ + s] = acc;
    }
    __syncthreads();
    {
      const int t = threadIdx.x & (SQ - 1), pp = threadIdx.x >> 6;
      float a = 0.f;
      for (int s = 16 * pp; s < 16 * pp + 16 && s < t; ++s) {
        float below = 0.f;
        for (int sg = (t >> 4) + 1; sg < 4; ++sg) below += tot[sg * SQ + s];
        a += (Ms[t * GST + s] + below) + (wp[s] + wp[SQ + s]);
      }
      for (int tau = max(t, 16 * pp); tau < 16 * pp + 16; ++tau) a += zp[tau] + zp[SQ + tau];
      part[pp * SQ + t] = a;
    }
    __syncthreads();
    if (threadIdx.x < SQ) {
      const int t = threadIdx.x;
      float a4 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) a4 += red[i];
      if (t0 + t < T)
        pla[((size_t)pt * Bn * H + bh) * T + t0 + t] =
            ((part[t] + part[SQ + t]) + (part[2 * SQ + t] + part[3 * SQ + t])) + de * a4;
    }
  }

  // the group's partial sums of dB and dC: [group, P tile][2][b][t][n]
  const size_t plane = (size_t)Bn * T * N;
  float* pB = pbc + (size_t)(grp * ptiles + pt) * 2 * plane;
  float* pC = pB + plane;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + tr + g + 8 * half;
      if (t >= T) continue;
      const size_t o = ((size_t)b * T + t) * N + n0 + 8 * j + 2 * q;
      *reinterpret_cast<float2*>(pB + o) = make_float2(dBa[j][2 * half], dBa[j][2 * half + 1]);
      *reinterpret_cast<float2*>(pC + o) = make_float2(dCa[j][2 * half], dCa[j][2 * half + 1]);
    }
}

__global__ void __launch_bounds__(256)
ssd_bwd_sum(const float* __restrict__ pla, const float* __restrict__ pbc,
            float* __restrict__ dla, float* __restrict__ dB, float* __restrict__ dC,
            int64_t plane, int64_t bht, int parts, int ptiles) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < plane; i += stride) {
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < parts; ++k) {
      sb += pbc[2 * k * plane + i];
      sc += pbc[(2 * k + 1) * plane + i];
    }
    dB[i] = sb;
    dC[i] = sc;
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < bht; i += stride) {
    float s = 0.f;
    for (int k = 0; k < ptiles; ++k) s += pla[k * bht + i];
    dla[i] = s;
  }
}

// the workspace of K8's bf16 backward, in floats: H_start and dH_end of
// every (b h, chunk) [N][P], then the partial sums (dB and dC of every
// (head group, P tile), dlog_a of every P tile)
inline int64_t ssd_bwd_chunked_floats(int64_t B, int64_t H, int64_t T, int n, int p) {
  const int64_t nch = (T + SQ - 1) / SQ, ptiles = (p + SP - 1) / SP;
  const int64_t groups = (H + kBwHeads - 1) / kBwHeads;
  const int64_t f =
      2 * B * H * nch * n * p + 2 * groups * ptiles * B * T * n + ptiles * B * H * T;
  return (f + 1) / 2 * 2;
}

template <int N>
int launch_ssd_bwd_chunked(const void* x, const float* la, const float* Bm, const float* Cm,
                           const void* dy, const float* dstate, void* dx, float* dla, float* dB,
                           float* dC, float* ws, int64_t B, int64_t H, int64_t T, int p,
                           cudaStream_t stream) {
  using L = SsdBwSmem<N>;
  using B16 = __nv_bfloat16;
  const int64_t nch = (T + SQ - 1) / SQ, ptiles = (p + SP - 1) / SP, BH = B * H;
  const int64_t groups = (H + kBwHeads - 1) / kBwHeads;
  if (BH > 65535 || B * groups > 65535 || nch > INT32_MAX) return cudaErrorInvalidValue;
  float* Hs = ws;
  float* dHs = Hs + BH * nch * N * p;
  float* pbc = dHs + BH * nch * N * p;  // float2 stores: an even offset
  float* pla = pbc + 2 * groups * ptiles * B * T * N;
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_states<N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L::states_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ssd_bwd_chunk<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L::chunk_bytes);
  if (e != cudaSuccess) return e;
  ssd_bwd_states<N><<<dim3((unsigned)ptiles, (unsigned)BH, 2), 128, L::states_bytes, stream>>>(
      static_cast<const B16*>(x), la, Bm, Cm, static_cast<const B16*>(dy), dstate, Hs, dHs,
      (int)H, (int)T, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_chunk<N><<<dim3((unsigned)nch, (unsigned)ptiles, (unsigned)(B * groups)), 256,
                     L::chunk_bytes, stream>>>(
      static_cast<const B16*>(x), la, Bm, Cm, static_cast<const B16*>(dy), Hs, dHs,
      static_cast<B16*>(dx), pla, pbc, (int)B, (int)H, (int)T, p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int64_t plane = B * T * N;
  ssd_bwd_sum<<<(unsigned)std::min<int64_t>((std::max(plane, BH * T) + 255) / 256, 4096), 256,
                0, stream>>>(pla, pbc, dla, dB, dC, plane, BH * T, (int)(groups * ptiles),
                             (int)ptiles);
  return cudaGetLastError();
}

int ssd_bwd_chunked_by_dim(int n, const void* x, const float* la, const float* Bm,
                           const float* Cm, const void* dy, const float* dstate, void* dx,
                           float* dla, float* dB, float* dC, float* ws, int64_t B, int64_t H,
                           int64_t T, int p, cudaStream_t st) {
  switch (n) {
    case 16: return launch_ssd_bwd_chunked<16>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, T, p, st);
    case 32: return launch_ssd_bwd_chunked<32>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, T, p, st);
    case 48: return launch_ssd_bwd_chunked<48>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, T, p, st);
    case 64: return launch_ssd_bwd_chunked<64>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, T, p, st);
    case 128: return launch_ssd_bwd_chunked<128>(x, la, Bm, Cm, dy, dstate, dx, dla, dB, dC, ws, B, H, T, p, st);
    default: return cudaErrorInvalidValue;
  }
}

// -- K7's backward, bf16 inputs: three launches, one counted call
//
// (1) wkv_bwd_states, a block per (Dv tile, h, b) as wkv_chunked: the
//     state at the start of every sub-chunk of WT steps, S <- diag(W) S +
//     K'^T v on mma (K' in two pieces, v exact), stored in fp32
//     [b h][sub-chunk][Dk][Dv];
// (2) wkv_bwd_chunks, a block per (Dv tile, h, b): the sub-chunks last to
//     first with dS, the cotangent of the state at the sub-chunk's end,
//     in fp32 mma accumulators, warp w owning 16 of its columns (as
//     wkv_chunked owns S's: the same 3-stage ring of raw rows and the same
//     prepared operands rP, K', W and A, wkv_prepare_chains / _diagonal).
//     Per sub-chunk, on the tensor cores, every fp32 operand in two pieces:
//         dv = A^T dO + K' dS_end,  dS_start = diag(W) dS_end + rP^T dO   (per warp)
//         X = dO S_start^T, Y = V dS_end^T (16 x Dk), D = dO V^T (16 x 16),
//         rowdot_c = <S_start[c], dS_end[c]>         (over the block's columns)
//     then a thread a channel on the CUDA cores, every decay a running
//     product of w in fp32, in Horner form, nothing divided (w = 0 gives
//     exact zeros):
//         dr_t = (prod_{q<t} w) X[t] + sum_{s<t} D[t][s] k_s prod_{s<q<t} w
//         dk_s = (prod_{q>s} w) Y[s] + sum_{t>s} D[t][s] r_t prod_{s<q<t} w
//         dw_q = sum_j dS_q[c, j] S_{q-1}[c, j], directly: sources S_start or
//                a step s < q, sinks dS_end or a step t > q, each term with
//                a decay product that skips w_q,
//     plus the u terms u k_t D[t][t] and u r_s D[s][s], and du_c += sum_t
//     r_t k_t D[t][t] (one partial per (b h, Dv tile));
// (3) wkv_bwd_sum: du over b and the tiles; with more than one Dv tile also
//     dr, dk and dw (each tile's partial; the u terms with D[t][t] summed
//     over the tiles), in a fixed order.  With one tile (Dv <= 64) the
//     second launch writes dr, dk and dw itself.
// Unlike the forward's A, the pair sums of dr and dk run over the steps
// of one channel, with no sum across channels: in Horner form 120 fmaf a
// channel each, so none of the pair block goes to the tensor cores.  What
// bounds it (edited copies with a part taken out, PERF.md §6): the
// per-channel part and the products over columns, each ~0.33 ms of 1.36
// at rwkv6-7b's training shape, run one after the other behind barriers,
// 8 warps an SM (255 registers); storing the states takes 0.28 ms.

template <int DK>
struct WkvBwSmem {
  using F = WkvSmem<DK>;
  static constexpr int RS = F::RS, VS = F::VS, AS = F::AS, DST = WV + 8, DS = WT + 1;
  static constexpr int kRaw = 3 * WT * RS + 2 * WT * VS;  // r, k, w; v, dO
  // floats: u (as bf16) and W [2][DK]; X [WT][DK]; Y [WT][DK]; D [WT][DS];
  // the row dots [DK]
  static constexpr int kFloats = 3 * DK + 2 * WT * DK + WT * DS + DK;
  // then bf16: the raw ring, two prepared stages, r'' and k'', and dS_end's
  // two pieces [DK][DST]
  static constexpr size_t bytes =
      sizeof(float) * kFloats +
      2 * ((size_t)WNST * kRaw + 2 * (size_t)F::kPrep + F::kQuad + 2 * (size_t)DK * DST);
  // wkv_bwd_states: W [DK] fp32; K' [piece][WT][RS]; two stages of k, w
  // [WT][RS] and v [WT][VS]
  static constexpr int kStage = 2 * WT * RS + WT * VS;
  static constexpr size_t states_bytes =
      sizeof(float) * DK + 2 * ((size_t)kWkvPieces * WT * RS + 2 * (size_t)kStage);
};

template <int DK>
__global__ void __launch_bounds__(128)
wkv_bwd_states(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ w, float* __restrict__ states, int H, int T,
               int Dv) {
  using L = WkvBwSmem<DK>;
  constexpr int RS = L::RS, VS = L::VS, KT = DK / 16, kStage = L::kStage;
  extern __shared__ float4 smem4[];
  float* Wd = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* kp = reinterpret_cast<__nv_bfloat16*>(Wd + DK);  // K' [piece][WT][RS]
  __nv_bfloat16* raw0 = kp + kWkvPieces * WT * RS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, mm = lane >> 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int p0 = blockIdx.x * WV, c0 = p0 + 16 * warp;
  const int ns = (T + WT - 1) / WT;
  const size_t bh = (size_t)b * H + h, row0 = bh * T;
  const bool kvec =
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  const bool vvec = Dv % 8 == 0 && (reinterpret_cast<uintptr_t>(v) & 15) == 0;

  // sub-chunk i's k, w and the block's v columns into stage st; rows past
  // T are k = v = 0 and w = 1
  auto load_stage = [&](int i, int st) {
    const int t0 = i * WT;
    __nv_bfloat16* rs = raw0 + st * kStage;
    constexpr int CH = DK / 8;
    for (int idx = threadIdx.x; idx < 2 * WT * CH; idx += 128) {
      const int a = idx / (WT * CH), row = idx % (WT * CH) / CH, ch = idx % CH;
      const int t = t0 + row;
      __nv_bfloat16* dst = rs + (a * WT + row) * RS + 8 * ch;
      const __nv_bfloat16* src = (a == 0 ? k : w) + (row0 + t) * DK + 8 * ch;
      if (t < T && kvec) {
        cp_async16(dst, src);
      } else if (t < T) {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      } else {
        const uint32_t fill = a == 1 ? 0x3f803f80u : 0u;  // bf16 1.0 pairs
        *reinterpret_cast<uint4*>(dst) = make_uint4(fill, fill, fill, fill);
      }
    }
    __nv_bfloat16* vs = rs + 2 * WT * RS;
    for (int idx = threadIdx.x; idx < WT * (WV / 8); idx += 128) {
      const int row = idx / (WV / 8), col = p0 + 8 * (idx % (WV / 8)), t = t0 + row;
      __nv_bfloat16* dst = vs + row * VS + col - p0;
      if (t < T && vvec && col + 8 <= Dv) {
        cp_async16(dst, v + (row0 + t) * Dv + col);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = t < T && col + e < Dv ? v[(row0 + t) * Dv + col + e] : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };

  float St[DK / 8][4];  // S^T, as wkv_chunked's
#pragma unroll
  for (int n = 0; n < DK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) St[n][e] = 0.f;

  if (ns > 0) load_stage(0, 0);
  for (int i = 0; i < ns; ++i) {
    const __nv_bfloat16* rs = raw0 + (i & 1) * kStage;
    cp_async_wait_all();
    __syncthreads();  // stage i landed; the last K' and stage are read
    if (i + 1 < ns) load_stage(i + 1, (i + 1) & 1);
    if (threadIdx.x < DK / 2) {  // K' and W of a channel pair
      const int c = 2 * threadIdx.x;
      float q0 = 1.f, q1 = 1.f;
#pragma unroll
      for (int j = 0; j < WT; ++j) {
        const int t = WT - 1 - j;
        const uint32_t kv = *reinterpret_cast<const uint32_t*>(rs + t * RS + c);
        const uint32_t wv = *reinterpret_cast<const uint32_t*>(rs + (WT + t) * RS + c);
        put_pieces(kp + t * RS + c, WT * RS, bf16_lo(kv) * q0, bf16_hi(kv) * q1);
        q0 *= bf16_lo(wv);
        q1 *= bf16_hi(wv);
      }
      *reinterpret_cast<float2*>(Wd + c) = make_float2(q0, q1);
    }
    {  // the state before sub-chunk i
      float* sb = states + (bh * ns + i) * DK * Dv;
#pragma unroll
      for (int n = 0; n < DK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * q + (e & 1), col = c0 + g + 8 * (e >> 1);
          if (col < Dv) sb[(size_t)c * Dv + col] = St[n][e];
        }
    }
    __syncthreads();  // K' and W
    // S^T <- S^T diag(W) + V^T K'
    uint32_t va[4];
    ldmatrix_x4_trans(va, rs + 2 * WT * RS + (8 * (mm >> 1) + (lane & 7)) * VS + 16 * warp +
                              8 * (mm & 1));
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const float2 wv = *reinterpret_cast<const float2*>(Wd + 8 * n + 2 * q);
      St[n][0] *= wv.x;
      St[n][1] *= wv.y;
      St[n][2] *= wv.x;
      St[n][3] *= wv.y;
    }
#pragma unroll
    for (int pc = 0; pc < kWkvPieces; ++pc)
#pragma unroll
      for (int np = 0; np < KT; ++np) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kp + pc * WT * RS + (8 * (mm & 1) + (lane & 7)) * RS + 16 * np +
                                  8 * (mm >> 1));
        mma_bf16(St[2 * np], va[0], va[1], va[2], va[3], kb[0], kb[1]);
        mma_bf16(St[2 * np + 1], va[0], va[1], va[2], va[3], kb[2], kb[3]);
      }
  }
}

template <int DK>
__global__ void __launch_bounds__(128)
wkv_bwd_chunks(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ w,
               const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ dstate, const float* __restrict__ states,
               __nv_bfloat16* __restrict__ dr_out, __nv_bfloat16* __restrict__ dk_out,
               __nv_bfloat16* __restrict__ dv_out, __nv_bfloat16* __restrict__ dw_out,
               float* __restrict__ part, float* __restrict__ du_part, int H, int T, int Dv) {
  using L = WkvBwSmem<DK>;
  constexpr int RS = L::RS, VS = L::VS, AS = L::AS, DST = L::DST, DS = L::DS;
  constexpr int KT = DK / 16, NT8 = DK / 8, HT = WT / 2;
  // the per-channel roles: at Dk <= 64, threads 0-63 take dr and dk (and
  // du), 64-127 dw; at 128 every thread all three
  constexpr int CH = DK <= 64 ? 64 : 128;
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 smem4[];
  float* us = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* us_bf = reinterpret_cast<__nv_bfloat16*>(us);  // u, DK bf16
  float* Wst = us + DK;         // [2][DK]
  float* Xm = Wst + 2 * DK;     // X [t][c]
  float* Ym = Xm + WT * DK;     // Y [s][c]
  float* Dm = Ym + WT * DK;     // D [t][s]
  float* rd = Dm + WT * DS;     // the row dots [c]
  __nv_bfloat16* raw0 = reinterpret_cast<__nv_bfloat16*>(us + L::kFloats);
  __nv_bfloat16* prep0 = raw0 + WNST * L::kRaw;
  __nv_bfloat16* rq = prep0 + 2 * WkvSmem<DK>::kPrep;
  __nv_bfloat16* kq = rq + kWkvPieces * HT * RS;
  __nv_bfloat16* dSh = kq + kWkvPieces * HT * RS;  // dS_end's pieces [c][column]
  __nv_bfloat16* dSl = dSh + DK * DST;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3, mm = lane >> 3;
  const int b = blockIdx.z, h = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int p0 = tile * WV, c0 = p0 + 16 * warp;
  const int ns = (T + WT - 1) / WT;
  const size_t bh = (size_t)b * H + h, BH = (size_t)gridDim.z * H, row0 = bh * T;
  const bool direct = tiles == 1;
  const bool kvec = ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                      reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  const bool vvec = Dv % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  const bool opair = Dv % 2 == 0 && (reinterpret_cast<uintptr_t>(dv_out) & 3) == 0;

  auto raw = [&](int st) { return raw0 + st * L::kRaw; };
  auto prep = [&](int st) { return prep0 + st * WkvSmem<DK>::kPrep; };

  // sub-chunk i's r, k, w and the block's v and dO columns into raw stage
  // st; rows past T are r = k = v = dO = 0 and w = 1
  auto load_stage = [&](int i, int st) {
    const int t0 = i * WT;
    __nv_bfloat16* rs = raw(st);
    constexpr int CHK = DK / 8;  // 16-byte pieces of a row
    for (int idx = threadIdx.x; idx < 3 * WT * CHK; idx += 128) {
      const int a = idx / (WT * CHK), row = idx % (WT * CHK) / CHK, ch = idx % CHK;
      const int t = t0 + row;
      __nv_bfloat16* dst = rs + (a * WT + row) * RS + 8 * ch;
      const __nv_bfloat16* src = (a == 0 ? r : a == 1 ? k : w) + (row0 + t) * DK + 8 * ch;
      if (t < T && kvec) {
        cp_async16(dst, src);
      } else if (t < T) {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      } else {
        const uint32_t fill = a == 2 ? 0x3f803f80u : 0u;  // bf16 1.0 pairs
        *reinterpret_cast<uint4*>(dst) = make_uint4(fill, fill, fill, fill);
      }
    }
    for (int idx = threadIdx.x; idx < 2 * WT * (WV / 8); idx += 128) {
      const int a = idx / (WT * (WV / 8)), rest = idx % (WT * (WV / 8));
      const int row = rest / (WV / 8), col = p0 + 8 * (rest % (WV / 8)), t = t0 + row;
      const __nv_bfloat16* src = a == 0 ? v : dout;
      __nv_bfloat16* dst = rs + 3 * WT * RS + (a * WT + row) * VS + col - p0;
      if (t < T && vvec && col + 8 <= Dv) {
        cp_async16(dst, src + (row0 + t) * Dv + col);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = t < T && col + e < Dv ? src[(row0 + t) * Dv + col + e] : __float2bfloat16(0.f);
      }
    }
    cp_async_commit();
  };
  auto prepare_chains = [&](int st, int ps) {
    wkv_prepare_chains<DK>(raw(st), prep(ps), rq, kq, Wst + ps * DK);
  };
  auto prepare_diagonal = [&](int st, int ps) {
    wkv_prepare_diagonal<DK>(raw(st), prep(ps), rq, kq, us_bf);
  };

  // zero the A tiles (their upper triangles are never written) and load u
  for (int i = threadIdx.x; i < 2 * kWkvPieces * WT * AS; i += 128) {
    const int ps = i / (kWkvPieces * WT * AS), e = i % (kWkvPieces * WT * AS);
    prep(ps)[2 * kWkvPieces * WT * RS + e] = __float2bfloat16(0.f);
  }
  for (int c = threadIdx.x; c < DK; c += 128) us_bf[c] = u[(size_t)h * DK + c];

  // dS^T: this warp's columns c0 + g (+8) by rows 8 n + 2q (+1), from the
  // final state's cotangent
  float dSt[NT8][4];
#pragma unroll
  for (int n = 0; n < NT8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * n + 2 * q + (e & 1), col = c0 + g + 8 * (e >> 1);
      dSt[n][e] = dstate != nullptr && col < Dv ? dstate[(bh * DK + c) * Dv + col] : 0.f;
    }
  float du = 0.f;
  const int cc = threadIdx.x % CH;  // this thread's channel in the per-channel part
  const bool role_rk = threadIdx.x < CH, role_w = threadIdx.x >= CH || CH == 128;

  // the last sub-chunk first
  load_stage(ns - 1, 0);
  if (ns > 1) load_stage(ns - 2, 1);
  else cp_async_commit();
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncthreads();  // stage 0, u and the zeroed A tiles
  prepare_chains(0, 0);
  __syncthreads();
  prepare_diagonal(0, 0);
  for (int m = 0; m < ns; ++m) {
    const int i = ns - 1 - m;  // the sub-chunk
    cp_async_wait_all();
    __syncthreads();  // sub-chunk i prepared, i - 1 landed; i + 1 done
    if (m + 2 < ns) load_stage(i - 2, (m + 2) % WNST);
    if (m + 1 < ns) prepare_chains((m + 1) % WNST, (m + 1) & 1);
    __syncthreads();  // r'' and k'' of sub-chunk i - 1
    if (m + 1 < ns) prepare_diagonal((m + 1) % WNST, (m + 1) & 1);

    const __nv_bfloat16* rs = raw(m % WNST);
    const __nv_bfloat16* vs = rs + 3 * WT * RS;
    const __nv_bfloat16* os = vs + WT * VS;
    const __nv_bfloat16* rp = prep(m & 1);
    const __nv_bfloat16* kp = rp + kWkvPieces * WT * RS;
    const __nv_bfloat16* ap = kp + kWkvPieces * WT * RS;
    const float* Wi = Wst + (m & 1) * DK;
    const int t0 = i * WT;

    // dS_end in two bf16 pieces [c][column], for the products over columns
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * q + (e & 1), col = 16 * warp + g + 8 * (e >> 1);
        const __nv_bfloat16 hi = __float2bfloat16(dSt[n][e]);
        dSh[c * DST + col] = hi;
        dSl[c * DST + col] = __float2bfloat16(dSt[n][e] - bf(hi));
      }
    // dO's fragments: as A of dO^T (columns by t) and as B of dO
    uint32_t oa[4];
    ldmatrix_x4_trans(oa, os + (8 * (mm >> 1) + (lane & 7)) * VS + 16 * warp + 8 * (mm & 1));

    {  // dv = K' dS_end + A^T dO: rows g (+8) of the sub-chunk, columns 8 nb + 2q (+1)
      float dvc[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) dvc[nb][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        const int off = (8 * (mm & 1) + (lane & 7)) * RS + 16 * kt + 8 * (mm >> 1);
        uint32_t ka[kWkvPieces][4], sf[2][2][2];
#pragma unroll
        for (int pc = 0; pc < kWkvPieces; ++pc) ldmatrix_x4(ka[pc], kp + pc * WT * RS + off);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            split_bf16(dSt[2 * kt + half][2 * nb], dSt[2 * kt + half][2 * nb + 1], sf[nb][half]);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const uint32_t *a0 = ka[0], *a1 = ka[1];
          mma_bf16(dvc[nb], a0[0], a0[1], a0[2], a0[3], sf[nb][0][0], sf[nb][1][0]);
          mma_bf16(dvc[nb], a0[0], a0[1], a0[2], a0[3], sf[nb][0][1], sf[nb][1][1]);
          mma_bf16(dvc[nb], a1[0], a1[1], a1[2], a1[3], sf[nb][0][0], sf[nb][1][0]);
        }
      }
#pragma unroll
      for (int pc = 0; pc < kWkvPieces; ++pc) {
        // A^T's fragments: A's 8 x 8 tiles (t, s) transposed
        uint32_t aa[4];
        ldmatrix_x4_trans(aa, ap + pc * WT * AS + (8 * (mm >> 1) + (lane & 7)) * AS + 8 * (mm & 1));
        mma_bf16(dvc[0], aa[0], aa[1], aa[2], aa[3], oa[0], oa[2]);
        mma_bf16(dvc[1], aa[0], aa[1], aa[2], aa[3], oa[1], oa[3]);
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = t0 + g + 8 * half, c = c0 + 8 * nb + 2 * q;
          if (t >= T) continue;
          __nv_bfloat16* dst = dv_out + (row0 + t) * Dv + c;
          const float v0 = dvc[nb][2 * half], v1 = dvc[nb][2 * half + 1];
          if (opair && c + 1 < Dv) {
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
          } else {
            if (c < Dv) dst[0] = __float2bfloat16(v0);
            if (c + 1 < Dv) dst[1] = __float2bfloat16(v1);
          }
        }
    }

    // dS_start = diag(W) dS_end + rP^T dO, as dS^T <- dS^T diag(W) + dO^T rP
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      const float2 wv = *reinterpret_cast<const float2*>(Wi + 8 * n + 2 * q);
      dSt[n][0] *= wv.x;
      dSt[n][1] *= wv.y;
      dSt[n][2] *= wv.x;
      dSt[n][3] *= wv.y;
    }
#pragma unroll
    for (int pc = 0; pc < kWkvPieces; ++pc)
#pragma unroll
      for (int np = 0; np < KT; ++np) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, rp + pc * WT * RS + (8 * (mm & 1) + (lane & 7)) * RS + 16 * np +
                                  8 * (mm >> 1));
        mma_bf16(dSt[2 * np], oa[0], oa[1], oa[2], oa[3], kb[0], kb[1]);
        mma_bf16(dSt[2 * np + 1], oa[0], oa[1], oa[2], oa[3], kb[2], kb[3]);
      }
    __syncthreads();  // dS_end's pieces are whole

    {  // X, Y and the row dots by channel tiles of 8 (warp, warp + 4, ..);
       // D by warp 0; each over the block's 64 columns
      uint32_t oA[WV / 16][4], vA[WV / 16][4];  // dO and V as A: rows t / s, columns 16 kc ..
#pragma unroll
      for (int kc = 0; kc < WV / 16; ++kc) {
        const int off = (8 * (mm & 1) + (lane & 7)) * VS + 16 * kc + 8 * (mm >> 1);
        ldmatrix_x4(oA[kc], os + off);
        ldmatrix_x4(vA[kc], vs + off);
      }
      const float* sst = states + (bh * ns + i) * DK * Dv;  // S_start [c][column]
      for (int nt = warp; nt < NT8; nt += 4) {
        const int cr = 8 * nt + g;  // the channel of this lane's B values
        float xa[4] = {0.f, 0.f, 0.f, 0.f}, ya[4] = {0.f, 0.f, 0.f, 0.f}, rdot = 0.f;
#pragma unroll
        for (int kc = 0; kc < WV / 16; ++kc) {
          float sv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = p0 + 16 * kc + 2 * q + (e & 1) + 8 * (e >> 1);
            sv[e] = col < Dv ? sst[(size_t)cr * Dv + col] : 0.f;
          }
          uint32_t s0[2], s1[2];
          split_bf16(sv[0], sv[1], s0);
          split_bf16(sv[2], sv[3], s1);
          const uint32_t* a = oA[kc];
          mma_bf16(xa, a[0], a[1], a[2], a[3], s0[0], s1[0]);
          mma_bf16(xa, a[0], a[1], a[2], a[3], s0[1], s1[1]);
          const int o = cr * DST + 16 * kc + 2 * q;
          const uint32_t h0 = *reinterpret_cast<const uint32_t*>(dSh + o);
          const uint32_t h1 = *reinterpret_cast<const uint32_t*>(dSh + o + 8);
          const uint32_t l0 = *reinterpret_cast<const uint32_t*>(dSl + o);
          const uint32_t l1 = *reinterpret_cast<const uint32_t*>(dSl + o + 8);
          const uint32_t* va = vA[kc];
          mma_bf16(ya, va[0], va[1], va[2], va[3], h0, h1);
          mma_bf16(ya, va[0], va[1], va[2], va[3], l0, l1);
          rdot = fmaf(sv[0], bf16_lo(h0) + bf16_lo(l0), rdot);
          rdot = fmaf(sv[1], bf16_hi(h0) + bf16_hi(l0), rdot);
          rdot = fmaf(sv[2], bf16_lo(h1) + bf16_lo(l1), rdot);
          rdot = fmaf(sv[3], bf16_hi(h1) + bf16_hi(l1), rdot);
        }
        rdot += __shfl_xor_sync(kAll, rdot, 1);
        rdot += __shfl_xor_sync(kAll, rdot, 2);
        if (q == 0) rd[cr] = rdot;
        const int cx = 8 * nt + 2 * q;
        *reinterpret_cast<float2*>(Xm + g * DK + cx) = make_float2(xa[0], xa[1]);
        *reinterpret_cast<float2*>(Xm + (g + 8) * DK + cx) = make_float2(xa[2], xa[3]);
        *reinterpret_cast<float2*>(Ym + g * DK + cx) = make_float2(ya[0], ya[1]);
        *reinterpret_cast<float2*>(Ym + (g + 8) * DK + cx) = make_float2(ya[2], ya[3]);
      }
      if (warp == 0) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {  // s tile nb: V's A tiles (s half nb, columns 0-7 / 8-15)
          float da[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kc = 0; kc < WV / 16; ++kc) {
            const uint32_t* a = oA[kc];
            mma_bf16(da, a[0], a[1], a[2], a[3], vA[kc][nb], vA[kc][nb + 2]);
          }
          Dm[g * DS + 8 * nb + 2 * q] = da[0];
          Dm[g * DS + 8 * nb + 2 * q + 1] = da[1];
          Dm[(g + 8) * DS + 8 * nb + 2 * q] = da[2];
          Dm[(g + 8) * DS + 8 * nb + 2 * q + 1] = da[3];
        }
      }
    }
    __syncthreads();  // X, Y, D and the row dots

    if (!direct && threadIdx.x < WT && t0 + threadIdx.x < T)  // v_t . dO_t of this tile
      part[3 * (size_t)tiles * BH * T * DK + ((size_t)tile * BH + bh) * T + t0 + threadIdx.x] =
          Dm[threadIdx.x * DS + threadIdx.x];
    if (cc < DK) {  // per channel
      float rr[WT], kk[WT], ww[WT];
#pragma unroll
      for (int t = 0; t < WT; ++t) {
        rr[t] = bf(rs[t * RS + cc]);
        kk[t] = bf(rs[(WT + t) * RS + cc]);
        ww[t] = bf(rs[(2 * WT + t) * RS + cc]);
      }
      const float uc = bf(us_bf[cc]);
      const size_t np = (size_t)tiles * BH * T * DK;
      auto put = [&](__nv_bfloat16* out, int which, int t, float val, float with_u) {
        if (t0 + t >= T) return;
        const size_t at = (row0 + t0 + t) * DK + cc;
        if (direct) out[at] = __float2bfloat16(val + with_u);
        else part[which * np + (((size_t)tile * BH + bh) * T + t0 + t) * DK + cc] = val;
      };
      if (role_rk) {
        float pre = 1.f;  // prod_{q<t} w_q
#pragma unroll
        for (int t = 0; t < WT; ++t) {
          float acc = 0.f;
#pragma unroll
          for (int s = 0; s < t; ++s) acc = fmaf(acc, ww[s], Dm[t * DS + s] * kk[s]);
          const float dd = Dm[t * DS + t];
          du = fmaf(rr[t] * kk[t], dd, du);
          put(dr_out, 0, t, fmaf(pre, Xm[t * DK + cc], acc), uc * kk[t] * dd);
          pre *= ww[t];
        }
        float suf = 1.f;  // prod_{q>s} w_q
#pragma unroll
        for (int s = WT - 1; s >= 0; --s) {
          float acc = 0.f;
#pragma unroll
          for (int t = WT - 1; t > s; --t) acc = fmaf(acc, ww[t], Dm[t * DS + s] * rr[t]);
          put(dk_out, 1, s, fmaf(suf, Ym[s * DK + cc], acc), rr[s] * uc * Dm[s * DS + s]);
          suf *= ww[s];
        }
      }
      if (role_w) {
        // pre[q] = prod_{q'<q} w, suf[q] = prod_{q'>q} w, F[q] = sum_{t>q}
        // prod_{q<q'<t} w r_t X[t] (sinks t > q of S_start's rows)
        float pre[WT], suf[WT], F[WT];
        pre[0] = 1.f;
        suf[WT - 1] = 1.f;
        F[WT - 1] = 0.f;
#pragma unroll
        for (int t = 1; t < WT; ++t) {
          pre[t] = pre[t - 1] * ww[t - 1];
          suf[WT - 1 - t] = suf[WT - t] * ww[WT - t];
          F[WT - 1 - t] = fmaf(ww[WT - t], F[WT - t], rr[WT - t] * Xm[(WT - t) * DK + cc]);
        }
        const float rdv = rd[cc];
        // bq = sum_{s<q} prod_{s<q'<q} w k_s Y[s] (sources s < q into dS_end);
        // Z[t] = sum_{s<q} prod_{s<q'<q} w k_s D[t][s] (into the steps t > q)
        float Z[WT], bq = 0.f;
#pragma unroll
        for (int t = 0; t < WT; ++t) Z[t] = 0.f;
#pragma unroll
        for (int qq = 0; qq < WT; ++qq) {
          float a4 = 0.f;
#pragma unroll
          for (int t = WT - 1; t > qq; --t) a4 = fmaf(a4, ww[t], rr[t] * Z[t]);
          put(dw_out, 2, qq, fmaf(pre[qq], fmaf(suf[qq], rdv, F[qq]), fmaf(suf[qq], bq, a4)),
              0.f);
          bq = fmaf(ww[qq], bq, kk[qq] * Ym[qq * DK + cc]);
#pragma unroll
          for (int t = qq + 2; t < WT; ++t) Z[t] = fmaf(ww[qq], Z[t], kk[qq] * Dm[t * DS + qq]);
        }
      }
    }
  }
  if (role_rk && cc < DK) du_part[(bh * tiles + tile) * DK + cc] = du;
}

__global__ void __launch_bounds__(256)
wkv_bwd_sum(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ u, const float* __restrict__ part,
            const float* __restrict__ du_part, __nv_bfloat16* __restrict__ dr,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dw,
            __nv_bfloat16* __restrict__ du, int B, int H, int T, int DK, int tiles) {
  const int64_t BH = (int64_t)B * H, n = BH * T * DK, np = (int64_t)tiles * n;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (tiles > 1) {
    const float* pv = part + 3 * np;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
      const int64_t row = i / DK;  // (b h, t)
      const int c = (int)(i % DK), h = (int)(row / T % H);
      float vdo = 0.f, a = 0.f, bb = 0.f, d = 0.f;
      for (int ti = 0; ti < tiles; ++ti) {
        vdo += pv[ti * BH * T + row];
        a += part[ti * n + i];
        bb += part[np + ti * n + i];
        d += part[2 * np + ti * n + i];
      }
      const float uc = bf(u[(int64_t)h * DK + c]);
      dr[i] = __float2bfloat16(a + uc * bf(k[i]) * vdo);
      dk[i] = __float2bfloat16(bb + bf(r[i]) * uc * vdo);
      dw[i] = __float2bfloat16(d);
    }
  }
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < (int64_t)H * DK;
       i += stride) {
    const int h = (int)(i / DK), c = (int)(i % DK);
    float s = 0.f;
    for (int bb = 0; bb < B; ++bb)
      for (int ti = 0; ti < tiles; ++ti) s += du_part[(((int64_t)bb * H + h) * tiles + ti) * DK + c];
    du[i] = __float2bfloat16(s);
  }
}

// the workspace of K7's bf16 backward, in floats: the state at the start
// of every (b h, sub-chunk) [Dk][Dv]; with more than one Dv tile the
// tiles' partial dr, dk, dw [tile][b h][t][Dk] and v . dO [tile][b h][t];
// du of every (b h, tile)
inline int64_t wkv_bwd_chunked_floats(int64_t BH, int64_t T, int dk, int dv) {
  const int64_t ns = (T + WT - 1) / WT, tiles = (dv + WV - 1) / WV;
  const int64_t f = BH * ns * dk * dv + (tiles > 1 ? tiles * BH * T * (3 * dk + 1) : 0) +
                    BH * tiles * dk;
  return (f + 1) / 2 * 2;
}

template <int DK>
int launch_wkv_bwd_chunked(const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* dout, const float* dstate, void* dr,
                           void* dkk, void* dv_out, void* dw, void* du, float* ws, int64_t B,
                           int64_t H, int64_t T, int dv, cudaStream_t stream) {
  using L = WkvBwSmem<DK>;
  using B16 = __nv_bfloat16;
  if (B > 65535 || H > 65535) return cudaErrorInvalidValue;
  const int64_t ns = (T + WT - 1) / WT, tiles = (dv + WV - 1) / WV, BH = B * H;
  float* states = ws;
  float* part = states + BH * ns * DK * dv;
  float* du_part = part + (tiles > 1 ? tiles * BH * T * (3 * DK + 1) : 0);
  cudaError_t e = cudaFuncSetAttribute(wkv_bwd_states<DK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L::states_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(wkv_bwd_chunks<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)L::bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)tiles, (unsigned)H, (unsigned)B);
  wkv_bwd_states<DK><<<grid, 128, L::states_bytes, stream>>>(
      static_cast<const B16*>(k), static_cast<const B16*>(v), static_cast<const B16*>(w),
      states, (int)H, (int)T, dv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  wkv_bwd_chunks<DK><<<grid, 128, L::bytes, stream>>>(
      static_cast<const B16*>(r), static_cast<const B16*>(k), static_cast<const B16*>(v),
      static_cast<const B16*>(w), static_cast<const B16*>(u), static_cast<const B16*>(dout),
      dstate, states, static_cast<B16*>(dr), static_cast<B16*>(dkk), static_cast<B16*>(dv_out),
      static_cast<B16*>(dw), part, du_part, (int)H, (int)T, dv);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int64_t n = tiles > 1 ? BH * T * DK : H * DK;
  wkv_bwd_sum<<<(unsigned)std::min<int64_t>((n + 255) / 256, 4096), 256, 0, stream>>>(
      static_cast<const B16*>(r), static_cast<const B16*>(k), static_cast<const B16*>(u), part,
      du_part, static_cast<B16*>(dr), static_cast<B16*>(dkk), static_cast<B16*>(dw),
      static_cast<B16*>(du), (int)B, (int)H, (int)T, DK, (int)tiles);
  return cudaGetLastError();
}

int wkv_bwd_chunked_by_dim(int dk, const void* r, const void* k, const void* v, const void* w,
                           const void* u, const void* dout, const float* dstate, void* dr,
                           void* dkk, void* dv_out, void* dw, void* du, float* ws, int64_t B,
                           int64_t H, int64_t T, int dv, cudaStream_t st) {
  switch (dk) {
    case 16: return launch_wkv_bwd_chunked<16>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, T, dv, st);
    case 32: return launch_wkv_bwd_chunked<32>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, T, dv, st);
    case 48: return launch_wkv_bwd_chunked<48>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, T, dv, st);
    case 64: return launch_wkv_bwd_chunked<64>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, T, dv, st);
    case 128: return launch_wkv_bwd_chunked<128>(r, k, v, w, u, dout, dstate, dr, dkk, dv_out, dw, du, ws, B, H, T, dv, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// (r, k, v, w, u, o, state, B, H, T, Dk, Dv, dtype, stream): r/k/w
// (B, H, T, Dk), v/o (B, H, T, Dv), u (H, Dk), state (B, H, Dk, Dv) fp32;
// dtype 0 (fp32) runs the step kernel, 1 (bf16) the chunked one
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const void* w, const void* u, void* o,
                                void* state, int64_t B, int64_t H, int64_t T,
                                int dk, int dv, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* s = static_cast<float*>(state);
  if (dv < 1 || dv > 1024) return cudaErrorInvalidValue;
  if (dtype == 0)
    return rwkv6_steps_by_dim(dk, r, k, v, w, u, o, s, B, H, T, dv, st);
  if (dtype == 1)
    return wkv_chunked_by_dim(dk, r, k, v, w, u, o, s, B, H, T, dv, st);
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

// (B, H, T, Dk, Dv, dtype) -> the fp32 floats of the workspace
// repro_rwkv6_scan_bwd takes (the stored states and partial sums), -1 for
// an unknown dtype
extern "C" int64_t repro_rwkv6_scan_bwd_ws(int64_t B, int64_t H, int64_t T,
                                           int dk, int dv, int dtype) {
  if (dtype == 0) return wkv_bwd_floats<float>(B * H, T, dk, dv);
  if (dtype == 1) return wkv_bwd_chunked_floats(B * H, T, dk, dv);
  return -1;
}

// (B, H, T, N, P, dtype) -> the fp32 floats of repro_mamba2_ssd_bwd's
// workspace, -1 for an unknown dtype
extern "C" int64_t repro_mamba2_ssd_bwd_ws(int64_t B, int64_t H, int64_t T,
                                           int n, int p, int dtype) {
  if (dtype == 0) return ssd_bwd_floats<float>(B * H, T, n, p);
  if (dtype == 1) return ssd_bwd_chunked_floats(B, H, T, n, p);
  return -1;
}

// (r, k, v, w, u, dout, dstate, dr, dk, dv, dw, du, ws, ws_floats, B, H, T,
// Dk, Dv, dtype, stream): K7's backward at the cotangents dout (B, H, T,
// Dv) of the output and dstate (B, H, Dk, Dv) fp32 (null: zero) of the
// final state; the gradients in their inputs' shapes and dtype (all fp32
// or all bf16, dtype 0 / 1); ws an fp32 workspace of ws_floats >=
// repro_rwkv6_scan_bwd_ws's floats
extern "C" int repro_rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                                    const void* w, const void* u, const void* dout,
                                    const void* dstate, void* dr, void* dk,
                                    void* dv_out, void* dw, void* du, void* ws,
                                    int64_t ws_floats, int64_t B, int64_t H,
                                    int64_t T, int dk_, int dv, int dtype,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ds = static_cast<const float*>(dstate);
  float* w_ = static_cast<float*>(ws);
  if (dv < 1 || dv > 1024 ||
      ws_floats < repro_rwkv6_scan_bwd_ws(B, H, T, dk_, dv, dtype))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return wkv_bwd_by_dim<float>(dk_, r, k, v, w, u, dout, ds, dr, dk, dv_out,
                                 dw, du, w_, B, H, T, dv, st);
  if (dtype == 1)
    return wkv_bwd_chunked_by_dim(dk_, r, k, v, w, u, dout, ds, dr, dk, dv_out, dw, du,
                                  w_, B, H, T, dv, st);
  return cudaErrorInvalidValue;
}

// (x, log_a, Bm, Cm, dy, dstate, dx, dlog_a, dBm, dCm, ws, ws_floats, B, H,
// T, N, P, dtype, stream): K8's backward at the cotangents dy (B, H, T, P)
// in x's dtype and dstate (B, H, N, P) fp32 (null: zero); dx in x's dtype
// (fp32 or bf16, dtype 0 / 1), dlog_a (B, H, T), dBm and dCm (B, T, N) fp32;
// ws an fp32 workspace of ws_floats >= repro_mamba2_ssd_bwd_ws's floats
extern "C" int repro_mamba2_ssd_bwd(const void* x, const void* log_a,
                                    const void* Bm, const void* Cm, const void* dy,
                                    const void* dstate, void* dx, void* dla,
                                    void* dB, void* dC, void* ws,
                                    int64_t ws_floats, int64_t B, int64_t H,
                                    int64_t T, int n, int p, int dtype,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* la = static_cast<const float*>(log_a);
  const float* bm = static_cast<const float*>(Bm);
  const float* cm = static_cast<const float*>(Cm);
  const float* ds = static_cast<const float*>(dstate);
  float* w_ = static_cast<float*>(ws);
  if (p < 1 || p > 1024 ||
      ws_floats < repro_mamba2_ssd_bwd_ws(B, H, T, n, p, dtype))
    return cudaErrorInvalidValue;
  float* o_la = static_cast<float*>(dla);
  float* o_b = static_cast<float*>(dB);
  float* o_c = static_cast<float*>(dC);
  if (dtype == 0)
    return ssd_bwd_by_dim<float>(n, x, la, bm, cm, dy, ds, dx, o_la, o_b, o_c,
                                 w_, B, H, T, p, st);
  if (dtype == 1)
    return ssd_bwd_chunked_by_dim(n, x, la, bm, cm, dy, ds, dx, o_la, o_b, o_c, w_, B,
                                  H, T, p, st);
  return cudaErrorInvalidValue;
}
