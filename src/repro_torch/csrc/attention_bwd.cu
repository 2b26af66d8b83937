// K5's backward: dQ, dK and dV of the port's flash attention, for sm_90a.
//
// The reference has no backward kernel: `flash_attention`
// (src/repro/kernels/flash_attention.py) carries no custom_vjp, so its
// training differentiates whatever the op entry runs (on the CPU the jnp
// oracle, src/repro/kernels/ref.py::flash_attention_ref).  This is the
// hand-written counterpart of that gradient for
//
//     O = softmax(scale * Q K^T, causal / window mask) V
//
// with q, o, dO (B, H, Sq, D), k, v (B, G, Sk, D), GQA heads h -> h / (H / G),
// query row i at position i + Sk - Sq and padded kv columns masked, as the
// forward does.  K5's forward hands over each row's log-sum-exp (natural
// log, -inf for a row that sees no key), so P = exp(scale * Q K^T - LSE)
// needs no pass of its own.  With Delta_i = sum_d dO[i][d] O[i][d]:
//
//     dV = P^T dO,   dP = dO V^T,   dS = P o (dP - Delta),
//     dQ = scale * dS K,   dK = scale * dS^T Q,
//
// dK and dV summed over the H / G query heads of a kv group.  The design is
// FlashAttention-2's split into two launches with no atomics, so the result
// is bit-deterministic from run to run:
//
//  - launch A, one block per (q tile, h, b), the longest causal tiles
//    first: Delta of its rows into an fp32 workspace, then P, dP and dS per
//    visible kv tile and dQ accumulated in registers.
//  - launch B, one block per (kv tile, g, b): K and V stay in shared
//    memory while the block loops over the group's heads and the q tiles
//    that can see the tile, and accumulates dV += P^T dO and dK += dS^T Q
//    in registers.
//
// Each dtype has its own pair of kernels, picked by the C dispatcher:
//
//  - bf16 (the train path): bwd_dq_wgmma / bwd_dkv_wgmma, every product
//    on the tensor cores as wgmma with fp32 accumulators (helpers in
//    hopper.cuh).  A block is one consumer warpgroup of 64 rows (q rows in
//    A, kv rows in B) and a producer warp; two blocks share an SM up to
//    D = 80, so one block's softmax-like pass runs under the other's
//    products.  The resident pair of 64-row tiles (A: Q, dO; B: K, V)
//    arrives by TMA once; the producer streams the other pair (A: K, V; B:
//    Q, dO, with the rows' LSE and Delta, which its 32 lanes copy) through a
//    3-stage ring, mbarriers handing stages over.  A computes S = Q K^T and
//    dP = dO V^T, B S^T = K Q^T and dP^T = V dO^T (wgmma SS, K-major
//    operands), so that P (P^T) and dS (dS^T) come out as accumulator
//    fragments whose rows are the next product's M: split in registers into
//    two bf16 pieces (the rounding and the rounding of the rest), they are
//    the A operand of dQ += dS K, dV += P^T dO and dK += dS^T Q (wgmma RS,
//    the tile the MN-major B operand).  The gradients then carry only their
//    own bf16 rounding.  Masks apply only to the tiles that straddle the
//    diagonal, the window edge or Sk.  D = 80 runs a 64-wide and a 16-wide
//    column block, as the forward does.
//  - fp32: bwd_dq / bwd_dkv, fp32 FMAs on the CUDA cores (a tensor-core
//    route would be TF32, too coarse for the fp32 tolerance).  A block of
//    256 threads is a 16 x 16 grid, each thread owning a 4 x 4 piece of a
//    64 x 64 score tile (rows ty + 16 r, columns tx + 16 c) or 4 rows x
//    D / 16 columns of an output tile; tiles sit in shared memory as fp32
//    rows with an odd pitch (D + 1), so the 16 lanes that read 16 rows
//    hit 16 banks.
//
// Bound on the card at the training shape: operations (five products of
// 2 D FLOP per visible (query, key) pair, 989 TFLOP/s on the bf16 tensor
// cores); the bf16 route runs ten (the second pieces, S again in B).  Of
// the forms timed (PERF.md §6), two one-warpgroup blocks an SM beat one
// block of two warpgroups that share each stage.  Head
// dims 32, 64, 80 and 128 (D = 256 does not fit the fp32 route's four tiles
// in shared memory).  A query row that sees no key gets zero gradients
// (the plain version gives NaN there, as the forward's does).  The launcher
// returns cudaGetLastError() (0 = success), or cudaErrorInvalidValue when a
// tensor map cannot be made.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;  // hopper.cuh: mbarriers, TMA, wgmma, tensor maps

constexpr int BT = 64;           // rows of every tile: q rows, kv rows
constexpr int NT = 256;          // threads: a 16 x 16 grid
constexpr int SP = BT + 1;       // pitch of a score tile in shared memory
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool visible(int qpos, int kpos, int sk, int causal,
                                        int window) {
  return kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// rows [r0, r0 + BT) of a (n, D) matrix -> shared [BT][D + 1], zeros past
// row n
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < BT * D; i += NT) {
    const int r = i / D, c = i - r * D;
    s[r * (D + 1) + c] = r0 + r < n ? g[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// acc[r][c] += sum_d A[ty + 16 r][d] B[tx + 16 c][d]   (A B^T, 64 x 64)
template <int D>
__device__ __forceinline__ void mm_abt(float (&acc)[4][4], const float* A,
                                       const float* B, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// acc[r][c] += sum_j S[ty + 16 r][j] X[j][tx + 16 c]   (S X, 64 x D)
template <int D>
__device__ __forceinline__ void mm_ab(float (&acc)[4][D / 16], const float* S,
                                      const float* X, int ty, int tx) {
#pragma unroll 4
  for (int j = 0; j < BT; ++j) {
    float s[4], x[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r] = S[(ty + 16 * r) * SP + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = X[j * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(s[r], x[c], acc[r][c]);
  }
}

// acc[r][c] += sum_i S[i][ty + 16 r] X[i][tx + 16 c]   (S^T X, 64 x D)
template <int D>
__device__ __forceinline__ void mm_atb(float (&acc)[4][D / 16], const float* S,
                                       const float* X, int ty, int tx) {
#pragma unroll 4
  for (int i = 0; i < BT; ++i) {
    float s[4], x[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r] = S[i * SP + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = X[i * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(s[r], x[c], acc[r][c]);
  }
}

// shared memory of either fp32 kernel: four [BT][D + 1] tiles, one
// [BT][BT + 1] score tile and two rows of BT statistics
template <int D>
constexpr size_t bwd_smem() {
  return sizeof(float) * (4 * BT * (D + 1) + BT * SP + 2 * BT);
}

// ---------------------------------------------------------------------------
// fp32, launch A: dQ, and each row's Delta

template <int D>
__global__ void __launch_bounds__(NT)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ o,
       const float* __restrict__ dout, const float* __restrict__ lse,
       float* __restrict__ dq, float* __restrict__ delta_out, int H, int G,
       int sq, int sk, int causal, int window, float scale) {
  constexpr int P = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * P;
  float* Ks = dOs + BT * P;  // O first, for Delta
  float* Vs = Ks + BT * P;
  float* Ss = Vs + BT * P;   // dS
  float* delta_s = Ss + BT * SP;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = sk - sq;
  const size_t bh = (size_t)b * H + h;
  const float* kb = k + ((size_t)b * G + g) * sk * D;
  const float* vb = v + ((size_t)b * G + g) * sk * D;

  load_tile<D>(Qs, q + bh * sq * D, q0, sq);
  load_tile<D>(dOs, dout + bh * sq * D, q0, sq);
  load_tile<D>(Ks, o + bh * sq * D, q0, sq);
  __syncthreads();
  if (tid < BT) {
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(dOs[tid * P + d], Ks[tid * P + d], s);
    delta_s[tid] = s;
    if (q0 + tid < sq) delta_out[bh * sq + q0 + tid] = s;
  }

  // the kv tiles any row of this tile can see
  const int rows = min(BT, sq - q0);
  const int qlo = q0 + off, qhi = q0 + rows - 1 + off;
  const int k_end = causal ? min(sk, qhi + 1) : sk;
  const int k_begin = window > 0 ? max(0, qlo - window + 1) / BT * BT : 0;

  // each row's log-sum-exp, from the forward (-inf: no row, no visible key)
  float L[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    L[r] = row < sq ? lse[bh * sq + row] : -CUDART_INF_F;
  }

  // P from the LSE, dS = P o (dP - Delta), dQ += dS K
  float acc[4][D / 16] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += BT) {
    __syncthreads();  // the last reads of Ks, Vs and Ss are done
    load_tile<D>(Ks, kb, k0, sk);
    load_tile<D>(Vs, vb, k0, sk);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_abt<D>(s, Qs, Ks, ty, tx);
    mm_abt<D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r + off;
      const float dl = delta_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = L[r] > -CUDART_INF_F &&
                        visible(qpos, k0 + tx + 16 * c, sk, causal, window);
        const float p = ok ? expf(s[r][c] * scale - L[r]) : 0.f;
        Ss[(ty + 16 * r) * SP + tx + 16 * c] = p * (dp[r][c] - dl);
      }
    }
    __syncthreads();
    mm_ab<D>(acc, Ss, Ks, ty, tx);
  }

  float* dqb = dq + bh * sq * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row < sq) {
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        dqb[(size_t)row * D + tx + 16 * c] = acc[r][c] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, launch B: dK and dV of one kv tile over the group's heads

template <int D>
__global__ void __launch_bounds__(NT)
bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int H, int G, int sq, int sk,
        int causal, int window, float scale) {
  constexpr int P = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * P;
  float* Qs = Vs + BT * P;
  float* dOs = Qs + BT * P;
  float* Ps = dOs + BT * P;  // P, then dS
  float* lse_s = Ps + BT * SP;
  float* delta_s = lse_s + BT;

  const int k0 = blockIdx.x * BT;
  const int g = blockIdx.y, b = blockIdx.z;
  const int hg = H / G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = sk - sq;
  const size_t bg = (size_t)b * G + g;

  load_tile<D>(Ks, k + bg * sk * D, k0, sk);
  load_tile<D>(Vs, v + bg * sk * D, k0, sk);

  // the q rows that can see a key of this tile
  const int kmax = min(sk, k0 + BT) - 1;
  const int i_begin = causal ? max(0, k0 - off) : 0;
  const int i_end = window > 0 ? min(sq, kmax + window - off) : sq;

  float dk_acc[4][D / 16] = {}, dv_acc[4][D / 16] = {};
  for (int hh = 0; hh < hg; ++hh) {
    const size_t bh = (size_t)b * H + g * hg + hh;
    for (int i0 = i_begin; i0 < i_end; i0 += BT) {
      __syncthreads();  // the last reads of Qs, dOs and Ps are done
      load_tile<D>(Qs, q + bh * sq * D, i0, sq);
      load_tile<D>(dOs, dout + bh * sq * D, i0, sq);
      if (tid < BT) {
        const int row = i0 + tid;
        lse_s[tid] = row < sq ? lse[bh * sq + row] : -CUDART_INF_F;
        delta_s[tid] = row < sq ? delta[bh * sq + row] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      mm_abt<D>(s, Qs, Ks, ty, tx);   // rows: queries, columns: keys
      mm_abt<D>(dp, dOs, Vs, ty, tx);
      float p[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = i0 + ty + 16 * r;
        const float L = lse_s[ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool ok = row < sq && L > -CUDART_INF_F &&
                          visible(row + off, k0 + tx + 16 * c, sk, causal, window);
          p[r][c] = ok ? expf(s[r][c] * scale - L) : 0.f;
          Ps[(ty + 16 * r) * SP + tx + 16 * c] = p[r][c];
        }
      }
      __syncthreads();
      mm_atb<D>(dv_acc, Ps, dOs, ty, tx);  // dV += P^T dO
      __syncthreads();                     // the reads of P are done
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float dl = delta_s[ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          Ps[(ty + 16 * r) * SP + tx + 16 * c] = p[r][c] * (dp[r][c] - dl);
      }
      __syncthreads();
      mm_atb<D>(dk_acc, Ps, Qs, ty, tx);   // dK += dS^T Q
    }
  }

  float* dkb = dk + bg * sk * D;
  float* dvb = dv + bg * sk * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row < sk) {
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        dkb[(size_t)row * D + tx + 16 * c] = dk_acc[r][c] * scale;
        dvb[(size_t)row * D + tx + 16 * c] = dv_acc[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WT = 64;           // rows of every tile: one warpgroup's 64
constexpr int BW_THREADS = 160;  // a consumer warpgroup, then the producer warp
constexpr int BW_NS = 3;         // stages of the TMA ring

// Shared memory of either bf16 kernel, from a 1024-byte aligned base: the
// resident pair of 64-row tiles (dQ: Q, dO; dK/dV: K, V), BW_NS stages of
// the streamed pair (dQ: K, V; dK/dV: Q, dO), fp32 rows (dQ: the tile's
// Delta; dK/dV: each stage's base-2 LSE and Delta), then the barriers.
template <int D>
struct BwTile {
  static constexpr int TILE = WT * D * 2;
  static constexpr int STAGE_OFF = 2 * TILE;
  static constexpr int ROWS_OFF = STAGE_OFF + BW_NS * 2 * TILE;
  static constexpr int BAR_OFF = ROWS_OFF + BW_NS * 2 * WT * 4;
  // barriers: resident full, full[BW_NS], empty[BW_NS]; 1024 bytes to
  // align the base
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * BW_NS) + 1024;
  // two blocks an SM up to D = 80: ptxas then holds a thread to 168
  // registers (two blocks' ten warps put three on one SM sub-partition, of
  // 16,384 registers); D = 128's dK/dV kernel holds 128 accumulators a
  // thread and takes one block (254 registers)
  static constexpr int MIN_BLOCKS = D <= 80 ? 2 : 1;
  static_assert(TILE % 1024 == 0, "swizzled blocks must stay 1024-byte aligned");
};

// one 64-row tile (rows [row, row + 64) of head `head`, zeros past the
// map's rows) into shared memory at `dst`, completion on `bar`; m1 is the
// map of D = 80's 16-wide block
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* m0,
                                         const CUtensorMap* m1, uint32_t bar,
                                         int row, int head) {
#pragma unroll
  for (int c = 0; c < Cols<D>::NB; ++c)
    tma_load_3d(dst + WT * 128 * c, c == 1 && D == 80 ? m1 : m0, bar, 64 * c,
                row, head);
}

// x (a 64 x 64 accumulator fragment) -> the A fragments of its four
// 16-column blocks in two bf16 pieces: hi, the rounding, and lo, the
// rounding of what hi leaves (~16 bits of each value; one piece,
// FlashAttention's rounding, drifted past the card check's 1e-2 (1 + |g|)
// at the training shape)
__device__ __forceinline__ void split_pieces(uint32_t (*hi)[4], uint32_t (*lo)[4],
                                             const float* x) {
#pragma unroll
  for (int kk = 0; kk < WT / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = x[8 * kk + 2 * r], b = x[8 * kk + 2 * r + 1];
      const uint32_t h = pack_bf16(a, b);
      hi[kk][r] = h;
      lo[kk][r] = pack_bf16(a - __uint_as_float(h << 16),
                            b - __uint_as_float(h & 0xffff0000u));
    }
}

// acc += A X over the 64 k rows of X, A in two pieces (hi, then lo)
template <int D>
__device__ __forceinline__ void rs_pieces(float* acc, uint32_t (*hi)[4],
                                          uint32_t (*lo)[4], uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < WT / 16; ++kk) {
    rs_tile<D, WT>(acc, hi[kk], x, kk);
    rs_tile<D, WT>(acc, lo[kk], x, kk);
  }
}

__device__ __forceinline__ void consumers_sync() {  // the warpgroup's 128 threads
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// this warp is done with a buffer
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// a row's log-sum-exp in base 2; +inf where P must be 0 (a padded row, a
// row that sees no key), so that exp2(s - L) is 0 without a mask
__device__ __forceinline__ float lse2(const float* lse, size_t row0, int i, int sq) {
  if (i >= sq) return CUDART_INF_F;
  const float x = lse[row0 + i];
  return x > -CUDART_INF_F ? x * LOG2E : CUDART_INF_F;
}

// a row of 64 x D accumulator fragments (rows `row`, `row` + 8) -> bf16 in
// global memory, times `mul`
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const float* acc, int row,
                                           int n, int quad, float mul) {
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * quad;
    if (row < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + col) =
          __floats2bfloat162_rn(acc[4 * jj] * mul, acc[4 * jj + 1] * mul);
    if (row + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * D + col) =
          __floats2bfloat162_rn(acc[4 * jj + 2] * mul, acc[4 * jj + 3] * mul);
  }
}

// launch A: dQ of one q tile, and its rows' Delta.  Q and dO stay in shared
// memory; the producer warp streams the visible K/V tiles.
template <int D>
__global__ void __launch_bounds__(BW_THREADS, BwTile<D>::MIN_BLOCKS)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq0,
             const __grid_constant__ CUtensorMap tq1,
             const __grid_constant__ CUtensorMap tdo0,
             const __grid_constant__ CUtensorMap tdo1,
             const __grid_constant__ CUtensorMap tk0,
             const __grid_constant__ CUtensorMap tk1,
             const __grid_constant__ CUtensorMap tv0,
             const __grid_constant__ CUtensorMap tv1,
             const bf16* __restrict__ o, const bf16* __restrict__ dout,
             const float* __restrict__ lse, bf16* __restrict__ dq,
             float* __restrict__ delta, int B, int H, int G, int sq, int sk,
             int causal, int window, float scale) {
  using L = BwTile<D>;
  extern __shared__ uint8_t bw_smem[];
  const uint32_t raw = smem_u32(bw_smem);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* delta_s = reinterpret_cast<float*>(bw_smem + (sbase - raw) + L::ROWS_OFF);
  const uint32_t res_full = sbase + L::BAR_OFF;
  auto full = [&](int s) { return res_full + 8u * (1 + s); };
  auto empty = [&](int s) { return res_full + 8u * (1 + BW_NS + s); };

  // block -> (q tile, b, h): the last q tiles (the longest causal rows) first
  const int n_qt = (sq + WT - 1) / WT;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_qt - 1 - (int)blockIdx.x / (B * H)) * WT;
  const int b = bh / H, g = (bh % H) / (H / G);
  const int off = sk - sq;
  const int rows = min(WT, sq - q0);
  const int qlo = q0 + off, qhi = q0 + rows - 1 + off;
  const int k_end = causal ? min(sk, qhi + 1) : sk;
  const int k_begin = window > 0 ? max(0, qlo - window + 1) : 0;
  const int t_begin = k_begin / WT;
  const int n_tiles =
      k_end > t_begin * WT ? (k_end - t_begin * WT + WT - 1) / WT : 0;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < BW_NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(res_full, 2 * L::TILE);
      tma_tile<D>(sbase, &tq0, &tq1, res_full, q0, bh);
      tma_tile<D>(sbase + L::TILE, &tdo0, &tdo1, res_full, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % BW_NS;
        mbar_wait(empty(s), ((i / BW_NS) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full(s), 2 * L::TILE);
        const uint32_t dst = sbase + L::STAGE_OFF + s * 2 * L::TILE;
        const int k0 = (t_begin + i) * WT;
        tma_tile<D>(dst, &tk0, &tk1, full(s), k0, b * G + g);
        tma_tile<D>(dst + L::TILE, &tv0, &tv1, full(s), k0, b * G + g);
      }
    }
    return;  // no block-wide barrier follows
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8

  // Delta_i = dO_i . O_i from O and dO as stored, two threads a row, while
  // the producer's first copies are in flight
  {
    const int r = tid / 2, half = tid % 2;
    float s = 0.f;
    if (q0 + r < sq) {
      const size_t at = ((size_t)bh * sq + q0 + r) * D + half * (D / 2);
      const uint4* op = reinterpret_cast<const uint4*>(o + at);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const uint4 x = op[j], y = dp[j];
        const bf16* xe = reinterpret_cast<const bf16*>(&x);
        const bf16* ye = reinterpret_cast<const bf16*>(&y);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          s = fmaf(__bfloat162float(ye[e]), __bfloat162float(xe[e]), s);
      }
    }
    s += __shfl_xor_sync(FULL, s, 1);
    if (half == 0) {
      delta_s[r] = s;
      if (q0 + r < sq) delta[(size_t)bh * sq + q0 + r] = s;
    }
  }
  consumers_sync();
  const float dl0 = delta_s[r0], dl1 = delta_s[r0 + 8];
  const float L0 = lse2(lse, (size_t)bh * sq, q0 + r0, sq);
  const float L1 = lse2(lse, (size_t)bh * sq, q0 + r0 + 8, sq);
  const float sl2 = scale * LOG2E;
  const int qp0 = q0 + r0 + off, qp1 = qp0 + 8;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[WT / 2], dp[WT / 2];
  uint32_t hi[WT / 16][4], lo[WT / 16][4];
  mbar_wait(res_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % BW_NS;
    mbar_wait(full(s), (i / BW_NS) & 1);
    const uint32_t kt = sbase + L::STAGE_OFF + s * 2 * L::TILE;
    wg_fence();
    ss_tile<D, WT>(sc, sbase, WT, 0, kt);                   // S = Q K^T
    ss_tile<D, WT>(dp, sbase + L::TILE, WT, 0, kt + L::TILE);  // dP = dO V^T
    wg_commit();
    wg_wait<0>();
    reg_fence<WT / 2>(sc);
    reg_fence<WT / 2>(dp);
    // P = exp2(S scale log2 e - L), dS = P o (dP - Delta); masks only
    // where the tile straddles the diagonal, the window edge or Sk
    const int k0 = (t_begin + i) * WT;
    const bool edge = k0 + WT > sk || (causal && k0 + WT - 1 > qlo) ||
                      (window > 0 && k0 <= qhi - window);
#pragma unroll
    for (int j = 0; j < WT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        float p = ex2(sc[x] * sl2 - (e < 2 ? L0 : L1));
        if (edge && !visible(e < 2 ? qp0 : qp1, k0 + 8 * j + 2 * quad + (e & 1),
                             sk, causal, window))
          p = 0.f;
        dp[x] = p * (dp[x] - (e < 2 ? dl0 : dl1));
      }
    split_pieces(hi, lo, dp);
    wg_fence();
    rs_pieces<D>(acc, hi, lo, kt);  // dQ += dS K
    wg_commit();
    wg_wait<0>();
    reg_fence<D / 2>(acc);
    release(empty(s), lane);
  }
  store_rows<D>(dq + (size_t)bh * sq * D, acc, q0 + r0, sq, quad, scale);
}

// launch B: dK and dV of one kv tile over its group's heads.  K and V stay
// in shared memory; the producer warp streams the Q and dO tiles that can
// see the kv tile, with their rows' LSE and Delta.
template <int D>
__global__ void __launch_bounds__(BW_THREADS, BwTile<D>::MIN_BLOCKS)
bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq0,
              const __grid_constant__ CUtensorMap tq1,
              const __grid_constant__ CUtensorMap tdo0,
              const __grid_constant__ CUtensorMap tdo1,
              const __grid_constant__ CUtensorMap tk0,
              const __grid_constant__ CUtensorMap tk1,
              const __grid_constant__ CUtensorMap tv0,
              const __grid_constant__ CUtensorMap tv1,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, int G,
              int sq, int sk, int causal, int window, float scale) {
  using L = BwTile<D>;
  extern __shared__ uint8_t bw_smem[];
  const uint32_t raw = smem_u32(bw_smem);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  float* rows_s = reinterpret_cast<float*>(bw_smem + (sbase - raw) + L::ROWS_OFF);
  const uint32_t res_full = sbase + L::BAR_OFF;
  auto full = [&](int s) { return res_full + 8u * (1 + s); };
  auto empty = [&](int s) { return res_full + 8u * (1 + BW_NS + s); };

  // block -> (kv tile, b, g): the first kv tiles (seen by the most causal
  // rows) first
  const int bg = blockIdx.x % (B * G);
  const int k0 = (int)blockIdx.x / (B * G) * WT;
  const int b = bg / G, g = bg % G;
  const int hg = H / G, off = sk - sq;
  // the q rows that can see a key of this tile, in tiles of 64, per head
  const int kmax = min(sk, k0 + WT) - 1;
  const int i_begin = causal ? max(0, k0 - off) : 0;
  const int i_end = window > 0 ? min(sq, kmax + window - off) : sq;
  const int n_qt = i_end > i_begin ? (i_end - i_begin + WT - 1) / WT : 0;
  const int n_it = hg * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < BW_NS; ++s) {
      mbar_init(full(s), 33);  // the copies' byte count, then every
                               // producer lane (LSE and Delta rows)
      mbar_init(empty(s), 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_expect_tx(res_full, 2 * L::TILE);
      tma_tile<D>(sbase, &tk0, &tk1, res_full, k0, bg);
      tma_tile<D>(sbase + L::TILE, &tv0, &tv1, res_full, k0, bg);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % BW_NS;
      const int bh = b * H + g * hg + it / n_qt;
      const int i0 = i_begin + (it % n_qt) * WT;
      // the stage's LSE and Delta rows, loaded while the slot drains
      float l_rows[WT / 32], d_rows[WT / 32];
#pragma unroll
      for (int u = 0; u < WT / 32; ++u) {
        const int i = i0 + lane + 32 * u;
        l_rows[u] = lse2(lse, (size_t)bh * sq, i, sq);
        d_rows[u] = i < sq ? delta[(size_t)bh * sq + i] : 0.f;
      }
      mbar_wait(empty(s), ((it / BW_NS) & 1) ^ 1);  // round 0 passes at once
      if (lane == 0) {  // the copies first: they take longest
        mbar_expect_tx(full(s), 2 * L::TILE);
        const uint32_t dst = sbase + L::STAGE_OFF + s * 2 * L::TILE;
        tma_tile<D>(dst, &tq0, &tq1, full(s), i0, bh);
        tma_tile<D>(dst + L::TILE, &tdo0, &tdo1, full(s), i0, bh);
      }
      float* Ls = rows_s + s * 2 * WT;
#pragma unroll
      for (int u = 0; u < WT / 32; ++u) {
        Ls[lane + 32 * u] = l_rows[u];
        Ls[WT + lane + 32 * u] = d_rows[u];
      }
      mbar_arrive(full(s));  // releases this lane's rows
    }
    return;  // no block-wide barrier follows
  }

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, quad = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's kv rows: r0, r0 + 8
  const int kp0 = k0 + r0, kp1 = kp0 + 8;
  const float sl2 = scale * LOG2E;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float st[WT / 2], dpt[WT / 2];
  uint32_t ph[WT / 16][4], pl[WT / 16][4], dh[WT / 16][4], dl[WT / 16][4];
  mbar_wait(res_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % BW_NS;
    mbar_wait(full(s), (it / BW_NS) & 1);
    const int i0 = i_begin + (it % n_qt) * WT;
    const uint32_t qt = sbase + L::STAGE_OFF + s * 2 * L::TILE, dot = qt + L::TILE;
    const float* Ls = rows_s + s * 2 * WT;
    const float* Ds = Ls + WT;
    wg_fence();
    ss_tile<D, WT>(st, sbase, WT, 0, qt);            // S^T = K Q^T
    ss_tile<D, WT>(dpt, sbase + L::TILE, WT, 0, dot);  // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    reg_fence<WT / 2>(st);
    reg_fence<WT / 2>(dpt);
    // P^T and dS^T on the fragments: rows kv, columns q rows i0 + c
    const bool edge = k0 + WT > sk || (causal && k0 + WT - 1 > i0 + off) ||
                      (window > 0 && k0 <= i0 + WT - 1 + off - window);
#pragma unroll
    for (int j = 0; j < WT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e, c = 8 * j + 2 * quad + (e & 1);
        float p = ex2(st[x] * sl2 - Ls[c]);
        if (edge && !visible(i0 + c + off, e < 2 ? kp0 : kp1, sk, causal, window))
          p = 0.f;
        dpt[x] = p * (dpt[x] - Ds[c]);
        st[x] = p;
      }
    split_pieces(ph, pl, st);
    split_pieces(dh, dl, dpt);
    wg_fence();
    rs_pieces<D>(dva, ph, pl, dot);  // dV += P^T dO
    rs_pieces<D>(dka, dh, dl, qt);   // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    reg_fence<D / 2>(dka);
    reg_fence<D / 2>(dva);
    release(empty(s), lane);
  }
  store_rows<D>(dk + (size_t)bg * sk * D, dka, kp0, sk, quad, scale);
  store_rows<D>(dv + (size_t)bg * sk * D, dva, kp0, sk, quad, 1.f);
}

template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* dq, void* dk,
                     void* dv, float* delta, int64_t B, int64_t H, int64_t G,
                     int64_t sq, int64_t sk, int causal, int window,
                     float scale, cudaStream_t stream) {
  using L = BwTile<D>;
  constexpr int w0 = Cols<D>::width(0);
  // q, dO over (B H, Sq, D); k, v over (B G, Sk, D); boxes of 64 rows; the
  // odd ones are D = 80's 16-wide block
  CUtensorMap m[8];
  std::memset(m, 0, sizeof(m));
  const void* base[4] = {q, dout, k, v};
  for (int t = 0; t < 4; ++t) {
    const int64_t rows = t < 2 ? sq : sk, heads = t < 2 ? B * H : B * G;
    int e = make_map(&m[2 * t], base[t], rows, heads, D, w0, WT);
    if (e) return e;
    if (D == 80) {
      if ((e = make_map(&m[2 * t + 1], base[t], rows, heads, D, 16, WT))) return e;
    } else {
      m[2 * t + 1] = m[2 * t];
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dkv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned n_dq = (unsigned)((sq + WT - 1) / WT * B * H);
  bwd_dq_wgmma<D><<<n_dq, BW_THREADS, L::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7],
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      static_cast<bf16*>(dq), delta, (int)B, (int)H, (int)G, (int)sq, (int)sk,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned n_dkv = (unsigned)((sk + WT - 1) / WT * B * G);
  bwd_dkv_wgmma<D><<<n_dkv, BW_THREADS, L::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), (int)B, (int)H, (int)G,
      (int)sq, (int)sk, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk, void* dv,
               float* delta, int64_t B, int64_t H, int64_t G, int64_t sq,
               int64_t sk, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = bwd_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dkv<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  bwd_dq<D><<<dim3((unsigned)((sq + BT - 1) / BT), (unsigned)H, (unsigned)B),
              NT, smem, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), dot, lse, static_cast<float*>(dq),
      delta, (int)H, (int)G, (int)sq, (int)sk, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkv<D><<<dim3((unsigned)((sk + BT - 1) / BT), (unsigned)G, (unsigned)B),
               NT, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      (int)H, (int)G, (int)sq, (int)sk, causal, window, scale);
  return cudaGetLastError();
}

// each dtype has one pair of kernels: fp32 the SIMT pair, bf16 the wgmma pair
int bwd_by_dim(int D, int dtype, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse, void* dq,
               void* dk, void* dv, float* delta, int64_t B, int64_t H,
               int64_t G, int64_t sq, int64_t sk, int causal, int window,
               float scale, cudaStream_t st) {
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_bwd<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 64: return launch_bwd<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 80: return launch_bwd<80>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 128: return launch_bwd<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bwd_wgmma<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 64: return launch_bwd_wgmma<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 80: return launch_bwd_wgmma<80>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 128: return launch_bwd_wgmma<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// (q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, Sq, Sk, D, dtype,
//  causal, window, scale, stream); lse is the forward's (B, H, Sq) fp32
// natural-log log-sum-exp of each row's scaled, masked scores, delta (B, H,
// Sq) fp32 workspace; window <= 0 disables the window
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int64_t B, int64_t H, int64_t G, int64_t sq, int64_t sk,
    int D, int dtype, int causal, int window, float scale, void* stream) {
  return bwd_by_dim(D, dtype, q, k, v, o, dout, static_cast<const float*>(lse),
                    dq, dk, dv, static_cast<float*>(delta), B, H, G, sq, sk,
                    causal, window, scale, static_cast<cudaStream_t>(stream));
}
