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

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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

template <int DK>
__global__ void __launch_bounds__(128, DK <= 64 ? 4 : 2)
wkv_chunked(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ w,
            const __nv_bfloat16* __restrict__ u, __nv_bfloat16* __restrict__ o,
            float* __restrict__ state, int H, int T, int Dv) {
  using L = WkvSmem<DK>;
  constexpr int RS = L::RS, VS = L::VS, AS = L::AS, KT = DK / 16, HT = WT / 2;
  constexpr int NC = DK / 16;  // channels of each thread in the diagonal blocks
  constexpr unsigned kAll = 0xffffffffu;
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

  // The prepared operands of raw stage st into prepared stage ps, all
  // products of w in fp32 within the sub-chunk, each in [0, 1]:
  //   rP[t] = r_t o prod_{q<t} w_q,  K'[s] = k_s o prod_{q>s} w_q,  W = prod_q w_q,
  //   A[t][s] = sum_c r_tc k_sc prod_{s<q<t} w_qc (s < t),
  //   A[t][t] = sum_c r_tc u_c k_tc,  A[t][s] = 0 (s > t, never written).
  // First (chains) the products along the sub-chunk, and the quadrant's
  // operands r''[t] = r_t o prod_{8<=q<t} w_q (t >= 8) and k''[s] = k_s o
  // prod_{s<q<8} w_q (s < 8); after a barrier (diagonal) A: its quadrant
  // t >= 8 > s is r'' k''^T on the tensor cores, the rest per channel.
  auto prepare_chains = [&](int st, int ps) {
    const __nv_bfloat16* rs = raw(st);
    const __nv_bfloat16* ks = rs + WT * RS;
    const __nv_bfloat16* ws = ks + WT * RS;
    const int x = threadIdx.x;
    if (x >= DK) return;
    // threads 0 .. DK/2 - 1: the forward products of a channel pair;
    // DK/2 .. DK - 1: the backward ones
    const bool fwd = x < DK / 2;
    const int c = 2 * (fwd ? x : x - DK / 2);
    const __nv_bfloat16* src = fwd ? rs : ks;
    __nv_bfloat16* dst = prep(ps) + (fwd ? 0 : kWkvPieces * WT * RS);
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
    if (fwd) *reinterpret_cast<float2*>(Wst + (ps * DK) + c) = make_float2(p0v, p1v);
  };
  auto prepare_diagonal = [&](int st, int ps) {
    const __nv_bfloat16* rs = raw(st);
    const __nv_bfloat16* ks = rs + WT * RS;
    const __nv_bfloat16* ws = ks + WT * RS;
    __nv_bfloat16* ap = prep(ps) + 2 * kWkvPieces * WT * RS;  // [piece][WT][AS]
    const int x = threadIdx.x;
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
