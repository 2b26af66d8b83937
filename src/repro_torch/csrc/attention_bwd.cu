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
// with q (B, H, Sq, D), o, dO (B, H, Sq, DV), k (B, G, Sk, D), v (B, G, Sk,
// DV) (DV = D, or MLA's 64 at D = 96), GQA heads h -> h / (H / G),
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
//  - bf16 (the train path), every product on the tensor cores as wgmma
//    with fp32 accumulators (helpers in hopper.cuh).  S = Q K^T and dP =
//    dO V^T (dK/dV: S^T = K Q^T and dP^T = V dO^T) run as wgmma SS on
//    K-major tiles, so that P (P^T) and dS (dS^T) come out as accumulator
//    fragments whose rows are the next product's M: split in registers
//    into two bf16 pieces (the rounding and the rounding of the rest),
//    they are the A operand of dQ += dS K, dV += P^T dO and dK += dS^T Q
//    (wgmma RS, the tile the MN-major B operand).  The gradients then
//    carry only their own bf16 rounding.  Masks apply only to the tiles
//    that straddle the diagonal, the window edge or Sk.  Tiles arrive by
//    TMA; mbarriers hand stages over.  Three forms, by head dim:
//     - D = 80, 128 and MLA's q/k 96 with v 64: the pair route,
//       bwd_dq_wgmma_pair / bwd_dkv_wgmma_pair (see there).  Each launch
//       is one persistent block an SM of two consumer warpgroups and a
//       producer warpgroup that hands its registers over (setmaxnreg),
//       walking items of 128 rows (q rows for dQ, kv rows for dK/dV) of
//       which each consumer owns 64; both read each stage of the streamed pair, and one's
//       exp2 and piece pass runs under the other's products.  Tiles of
//       80 and 96 columns run as 16- and 32-wide blocks, so that each
//       product is one wgmma; the kernels are templated on (D, DV): S,
//       dQ and dK are D wide, dP, dV and Delta's rowsum DV wide.
//     - D = 32 and 64: bwd_dq_wgmma / bwd_dkv_wgmma, a block of one
//       consumer warpgroup of 64 rows (q rows in A, kv rows in B) and a
//       producer warp, two blocks an SM so that one block's softmax-like
//       pass runs under the other's products.  The resident pair of 64-row
//       tiles (A: Q, dO; B: K, V) arrives once; the producer streams the
//       other pair (A: K, V; B: Q, dO, with the rows' LSE and Delta, which
//       its 32 lanes copy) through a 3-stage ring.
//     - D = 256: bwd_dq_wgmma256 / bwd_dkv_wgmma256 (see there), each one
//       persistent block an SM whose two consumer warpgroups split a 64-row
//       tile's work by role: one forms S (S^T) and P and hands P over in
//       fp32 through shared memory, the other forms dP (dP^T) and dS; dK/dV
//       sums dV in the first and dK in the second, and the two blocks that
//       share a kv tile when an even group splits its heads add their fp32
//       sums in the dK/dV launch itself (the second to finish adds).
//  - fp32: bwd_dq / bwd_dkv, fp32 FMAs on the CUDA cores (a tensor-core
//    route would be TF32, too coarse for the fp32 tolerance).  A block of
//    256 threads is a 16 x 16 grid, each thread owning a 4 x 4 piece of a
//    64 x 64 score tile (rows ty + 16 r, columns tx + 16 c) or 4 rows x
//    D / 16 columns of an output tile; tiles sit in shared memory as fp32
//    rows with an odd pitch (D + 1), so the 16 lanes that read 16 rows
//    hit 16 banks.  At D = 256 the tiles are 32 rows (2 x 2 pieces), so
//    that the four [32][257] tiles fit (136 KB).
//
// Bound on the card at the training shape: operations (five products of
// 2 D FLOP per visible (query, key) pair, 989 TFLOP/s on the bf16 tensor
// cores); the bf16 route runs ten (the second pieces, S again in B).  Of
// the one-warpgroup forms timed at D = 64 (PERF.md §6), two blocks an SM
// beat one block of two warpgroups that share each stage; at D = 80, 128
// and 96 / 64, where a thread's accumulators and pieces outgrow 168
// registers, the pair route's 240 and persistent blocks took over.  Head dims 32,
// 64, 80, 128 and 256 with DV = D, and q/k 96 with v 64.  A query row that
// sees no key gets zero gradients (the plain version gives NaN there, as
// the forward's does).  The launcher returns cudaGetLastError() (0 =
// success), or cudaErrorInvalidValue when a tensor map cannot be made.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;  // hopper.cuh: mbarriers, TMA, wgmma, tensor maps

constexpr int NT = 256;          // threads: a 16 x 16 grid
constexpr unsigned FULL = 0xffffffffu;

// rows of every fp32 tile (q rows, kv rows): 64, or 32 at D = 256, where
// four [64][257] fp32 tiles (263 KB) would not fit in shared memory
template <int D>
__host__ __device__ constexpr int fp_bt() { return D <= 128 ? 64 : 32; }

__device__ __forceinline__ bool visible(int qpos, int kpos, int sk, int causal,
                                        int window) {
  return kpos < sk && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// rows [r0, r0 + BT) of a (n, D) matrix -> shared [BT][D + 1], zeros past
// row n (D: the matrix's width, q/k's or v's)
template <int D, int BT>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g,
                                          int r0, int n) {
  for (int i = threadIdx.x; i < BT * D; i += NT) {
    const int r = i / D, c = i - r * D;
    s[r * (D + 1) + c] = r0 + r < n ? g[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// acc[r][c] += sum_d A[ty + 16 r][d] B[tx + 16 c][d]   (A B^T, BT x BT;
// R = BT / 16 rows and columns a thread; A and B D wide)
template <int D, int R>
__device__ __forceinline__ void mm_abt(float (&acc)[R][R], const float* A,
                                       const float* B, int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = A[(ty + 16 * r) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < R; ++c) b[c] = B[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// acc[r][c] += sum_j S[ty + 16 r][j] X[j][tx + 16 c]   (S X, BT x D)
template <int D, int R>
__device__ __forceinline__ void mm_ab(float (&acc)[R][D / 16], const float* S,
                                      const float* X, int ty, int tx) {
  constexpr int BT = 16 * R, SP = BT + 1;
#pragma unroll 4
  for (int j = 0; j < BT; ++j) {
    float s[R], x[D / 16];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = S[(ty + 16 * r) * SP + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = X[j * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(s[r], x[c], acc[r][c]);
  }
}

// acc[r][c] += sum_i S[i][ty + 16 r] X[i][tx + 16 c]   (S^T X, BT x D)
template <int D, int R>
__device__ __forceinline__ void mm_atb(float (&acc)[R][D / 16], const float* S,
                                       const float* X, int ty, int tx) {
  constexpr int BT = 16 * R, SP = BT + 1;
#pragma unroll 4
  for (int i = 0; i < BT; ++i) {
    float s[R], x[D / 16];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = S[i * SP + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = X[i * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(s[r], x[c], acc[r][c]);
  }
}

// shared memory of either fp32 kernel: two [BT][D + 1] tiles (q, k), two
// [BT][DV + 1] (v, dO), one [BT][BT + 1] score tile and two rows of BT
// statistics (D = 256: 136 KB)
template <int D, int DV>
constexpr size_t bwd_smem() {
  constexpr int BT = fp_bt<D>();
  return sizeof(float) *
         (2 * BT * (D + 1) + 2 * BT * (DV + 1) + BT * (BT + 1) + 2 * BT);
}

// ---------------------------------------------------------------------------
// fp32, launch A: dQ, and each row's Delta.  q/k head dim D, v's (and o's,
// dO's) DV.

template <int D, int DV>
__global__ void __launch_bounds__(NT)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ o,
       const float* __restrict__ dout, const float* __restrict__ lse,
       float* __restrict__ dq, float* __restrict__ delta_out, int H, int G,
       int sq, int sk, int causal, int window, float scale) {
  constexpr int BT = fp_bt<D>(), R = BT / 16, SP = BT + 1, P = D + 1,
                PV = DV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BT * P;
  float* dOs = Ks + BT * P;
  float* Vs = dOs + BT * PV;  // O first, for Delta
  float* Ss = Vs + BT * PV;   // dS
  float* delta_s = Ss + BT * SP;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = sk - sq;
  const size_t bh = (size_t)b * H + h;
  const float* kb = k + ((size_t)b * G + g) * sk * D;
  const float* vb = v + ((size_t)b * G + g) * sk * DV;

  load_tile<D, BT>(Qs, q + bh * sq * D, q0, sq);
  load_tile<DV, BT>(dOs, dout + bh * sq * DV, q0, sq);
  load_tile<DV, BT>(Vs, o + bh * sq * DV, q0, sq);
  __syncthreads();
  if (tid < BT) {
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < DV; ++d) s = fmaf(dOs[tid * PV + d], Vs[tid * PV + d], s);
    delta_s[tid] = s;
    if (q0 + tid < sq) delta_out[bh * sq + q0 + tid] = s;
  }

  // the kv tiles any row of this tile can see
  const int rows = min(BT, sq - q0);
  const int qlo = q0 + off, qhi = q0 + rows - 1 + off;
  const int k_end = causal ? min(sk, qhi + 1) : sk;
  const int k_begin = window > 0 ? max(0, qlo - window + 1) / BT * BT : 0;

  // each row's log-sum-exp, from the forward (-inf: no row, no visible key)
  float L[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = q0 + ty + 16 * r;
    L[r] = row < sq ? lse[bh * sq + row] : -CUDART_INF_F;
  }

  // P from the LSE, dS = P o (dP - Delta), dQ += dS K
  float acc[R][D / 16] = {};
  for (int k0 = k_begin; k0 < k_end; k0 += BT) {
    __syncthreads();  // the last reads of Ks, Vs (O, the first time) and Ss are done
    load_tile<D, BT>(Ks, kb, k0, sk);
    load_tile<DV, BT>(Vs, vb, k0, sk);
    __syncthreads();
    float s[R][R] = {}, dp[R][R] = {};
    mm_abt<D, R>(s, Qs, Ks, ty, tx);
    mm_abt<DV, R>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + ty + 16 * r + off;
      const float dl = delta_s[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const bool ok = L[r] > -CUDART_INF_F &&
                        visible(qpos, k0 + tx + 16 * c, sk, causal, window);
        const float p = ok ? expf(s[r][c] * scale - L[r]) : 0.f;
        Ss[(ty + 16 * r) * SP + tx + 16 * c] = p * (dp[r][c] - dl);
      }
    }
    __syncthreads();
    mm_ab<D, R>(acc, Ss, Ks, ty, tx);
  }

  float* dqb = dq + bh * sq * D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
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

template <int D, int DV>
__global__ void __launch_bounds__(NT)
bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int H, int G, int sq, int sk,
        int causal, int window, float scale) {
  constexpr int BT = fp_bt<D>(), R = BT / 16, SP = BT + 1, P = D + 1,
                PV = DV + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Qs = Ks + BT * P;
  float* Vs = Qs + BT * P;
  float* dOs = Vs + BT * PV;
  float* Ps = dOs + BT * PV;  // P, then dS
  float* lse_s = Ps + BT * SP;
  float* delta_s = lse_s + BT;

  const int k0 = blockIdx.x * BT;
  const int g = blockIdx.y, b = blockIdx.z;
  const int hg = H / G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = sk - sq;
  const size_t bg = (size_t)b * G + g;

  load_tile<D, BT>(Ks, k + bg * sk * D, k0, sk);
  load_tile<DV, BT>(Vs, v + bg * sk * DV, k0, sk);

  // the q rows that can see a key of this tile
  const int kmax = min(sk, k0 + BT) - 1;
  const int i_begin = causal ? max(0, k0 - off) : 0;
  const int i_end = window > 0 ? min(sq, kmax + window - off) : sq;

  // each (head, q tile)'s products accumulate apart and are then added to
  // the totals: a sum over the group's H / G heads of up to Sq rows would
  // otherwise be one FMA chain of (H / G) Sq terms (8,192 at gemma-2b's
  // 8:1 MQA), whose rounding reached 1.03x the 2e-5 tolerance of dv
  float dk_acc[R][D / 16] = {}, dv_acc[R][DV / 16] = {};
  for (int hh = 0; hh < hg; ++hh) {
    const size_t bh = (size_t)b * H + g * hg + hh;
    for (int i0 = i_begin; i0 < i_end; i0 += BT) {
      __syncthreads();  // the last reads of Qs, dOs and Ps are done
      load_tile<D, BT>(Qs, q + bh * sq * D, i0, sq);
      load_tile<DV, BT>(dOs, dout + bh * sq * DV, i0, sq);
      if (tid < BT) {
        const int row = i0 + tid;
        lse_s[tid] = row < sq ? lse[bh * sq + row] : -CUDART_INF_F;
        delta_s[tid] = row < sq ? delta[bh * sq + row] : 0.f;
      }
      __syncthreads();
      float s[R][R] = {}, dp[R][R] = {};
      mm_abt<D, R>(s, Qs, Ks, ty, tx);   // rows: queries, columns: keys
      mm_abt<DV, R>(dp, dOs, Vs, ty, tx);
      float p[R][R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = i0 + ty + 16 * r;
        const float L = lse_s[ty + 16 * r];
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const bool ok = row < sq && L > -CUDART_INF_F &&
                          visible(row + off, k0 + tx + 16 * c, sk, causal, window);
          p[r][c] = ok ? expf(s[r][c] * scale - L) : 0.f;
          Ps[(ty + 16 * r) * SP + tx + 16 * c] = p[r][c];
        }
      }
      __syncthreads();
      float dk_t[R][D / 16] = {}, dv_t[R][DV / 16] = {};
      mm_atb<DV, R>(dv_t, Ps, dOs, ty, tx);  // dV += P^T dO
      __syncthreads();                      // the reads of P are done
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dl = delta_s[ty + 16 * r];
#pragma unroll
        for (int c = 0; c < R; ++c)
          Ps[(ty + 16 * r) * SP + tx + 16 * c] = p[r][c] * (dp[r][c] - dl);
      }
      __syncthreads();
      mm_atb<D, R>(dk_t, Ps, Qs, ty, tx);   // dK += dS^T Q
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < D / 16; ++c) dk_acc[r][c] += dk_t[r][c];
#pragma unroll
        for (int c = 0; c < DV / 16; ++c) dv_acc[r][c] += dv_t[r][c];
      }
    }
  }

  float* dkb = dk + bg * sk * D;
  float* dvb = dv + bg * sk * DV;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row < sk) {
#pragma unroll
      for (int c = 0; c < D / 16; ++c)
        dkb[(size_t)row * D + tx + 16 * c] = dk_acc[r][c] * scale;
#pragma unroll
      for (int c = 0; c < DV / 16; ++c)
        dvb[(size_t)row * DV + tx + 16 * c] = dv_acc[r][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int WT = 64;           // rows of every tile: one warpgroup's 64
constexpr int BW_THREADS = 160;  // a consumer warpgroup, then the producer warp

// Shared memory of either bf16 kernel, from a 1024-byte aligned base: the
// resident pair of 64-row tiles (dQ: Q, dO; dK/dV: K, V), NS stages of the
// streamed pair (dQ: K, V; dK/dV: Q, dO), fp32 rows (dQ: the tile's Delta;
// dK/dV: each stage's base-2 LSE and Delta), then the barriers.
template <int D>
struct BwTile {
  static constexpr int TILE = WT * D * 2;  // a 64-row Q, K, V or dO tile
  static constexpr int PAIR = 2 * TILE;
  static constexpr int NS = 3;  // stages of the TMA ring
  static constexpr int STAGE_OFF = PAIR;
  static constexpr int ROWS_OFF = STAGE_OFF + NS * PAIR;
  static constexpr int BAR_OFF = ROWS_OFF + NS * 2 * WT * 4;
  // barriers: resident full, full[NS], empty[NS]; 1024 bytes to align the
  // base
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * NS) + 1024;
  // two blocks an SM (these kernels serve D = 32 and 64): ptxas then holds
  // a thread to 168 registers (two blocks' ten warps put three on one SM
  // sub-partition, of 16,384 registers).  D = 80, 128 and 96 / 64 take the
  // pair route (BwPair), D = 256 its own (Bw256).
  static constexpr int MIN_BLOCKS = 2;
  static_assert(D <= 64, "the one-warpgroup kernels serve D = 32 and 64");
  static_assert(TILE % 1024 == 0, "swizzled blocks must stay 1024-byte aligned");
};

// one 64-row tile of width W (rows [row, row + 64) of head `head`, zeros
// past the map's rows) into shared memory at `dst`, completion on `bar`;
// m1 is the map of the narrower second block (W = 80: 16 wide, 96: 32)
template <int W>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* m0,
                                         const CUtensorMap* m1, uint32_t bar,
                                         int row, int head) {
#pragma unroll
  for (int c = 0; c < Cols<W>::NB; ++c)
    tma_load_3d(dst + WT * 128 * c, c == 1 && Cols<W>::TAIL ? m1 : m0, bar,
                64 * c, row, head);
}

// x (a 64 x N accumulator fragment) -> the A fragments of its N / 16
// 16-column blocks in two bf16 pieces: hi, the rounding, and lo, the
// rounding of what hi leaves (~16 bits of each value; one piece,
// FlashAttention's rounding, drifted past the card check's 1e-2 (1 + |g|)
// at the training shape)
template <int N = WT>
__device__ __forceinline__ void split_pieces(uint32_t (*hi)[4], uint32_t (*lo)[4],
                                             const float* x) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
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

// a row of 64 x N accumulator fragments (rows `row`, `row` + 8) -> bf16 in
// global memory (rows `stride` elements apart), times `mul`
template <int N, int STRIDE = N>
__device__ __forceinline__ void store_rows(bf16* out, const float* acc, int row,
                                           int n, int quad, float mul) {
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    const int col = 8 * jj + 2 * quad;
    if (row < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * STRIDE + col) =
          __floats2bfloat162_rn(acc[4 * jj] * mul, acc[4 * jj + 1] * mul);
    if (row + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row + 8) * STRIDE + col) =
          __floats2bfloat162_rn(acc[4 * jj + 2] * mul, acc[4 * jj + 3] * mul);
  }
}

// the same rows in fp32
template <int N, int STRIDE>
__device__ __forceinline__ void store_rows_f32(float* out, const float* acc,
                                               int row, int n, int quad) {
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    const int col = 8 * jj + 2 * quad;
    if (row < n)
      *reinterpret_cast<float2*>(out + (size_t)row * STRIDE + col) =
          make_float2(acc[4 * jj], acc[4 * jj + 1]);
    if (row + 8 < n)
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * STRIDE + col) =
          make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
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
  constexpr int NS = L::NS;
  auto full = [&](int s) { return res_full + 8u * (1 + s); };
  auto empty = [&](int s) { return res_full + 8u * (1 + NS + s); };

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
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(res_full, L::PAIR);
      tma_tile<D>(sbase, &tq0, &tq1, res_full, q0, bh);
      tma_tile<D>(sbase + L::TILE, &tdo0, &tdo1, res_full, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        mbar_wait(empty(s), ((i / NS) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full(s), L::PAIR);
        const uint32_t dst = sbase + L::STAGE_OFF + s * L::PAIR;
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
    const int s = i % NS;
    mbar_wait(full(s), (i / NS) & 1);
    const uint32_t kt = sbase + L::STAGE_OFF + s * L::PAIR;
    wg_fence();
    ss_tile<D, WT>(sc, sbase, WT, 0, kt);                       // S = Q K^T
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
  constexpr int NS = L::NS;
  auto full = [&](int s) { return res_full + 8u * (1 + s); };
  auto empty = [&](int s) { return res_full + 8u * (1 + NS + s); };

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
    for (int s = 0; s < NS; ++s) {
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
      mbar_expect_tx(res_full, L::PAIR);
      tma_tile<D>(sbase, &tk0, &tk1, res_full, k0, bg);
      tma_tile<D>(sbase + L::TILE, &tv0, &tv1, res_full, k0, bg);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % NS;
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
      mbar_wait(empty(s), ((it / NS) & 1) ^ 1);  // round 0 passes at once
      if (lane == 0) {  // the copies first: they take longest
        mbar_expect_tx(full(s), L::PAIR);
        const uint32_t dst = sbase + L::STAGE_OFF + s * L::PAIR;
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
  for (int i = 0; i < D / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dva[i] = 0.f;
  float st[WT / 2], dpt[WT / 2];
  uint32_t ph[WT / 16][4], pl[WT / 16][4], dh[WT / 16][4], dl[WT / 16][4];
  mbar_wait(res_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % NS;
    mbar_wait(full(s), (it / NS) & 1);
    const int i0 = i_begin + (it % n_qt) * WT;
    const uint32_t qt = sbase + L::STAGE_OFF + s * L::PAIR, dot = qt + L::TILE;
    const float* Ls = rows_s + s * 2 * WT;
    const float* Ds = Ls + WT;
    wg_fence();
    ss_tile<D, WT>(st, sbase, WT, 0, qt);              // S^T = K Q^T
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
    rs_pieces<D>(dka, dh, dl, qt);    // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    reg_fence<D / 2>(dka);
    reg_fence<D / 2>(dva);
    release(empty(s), lane);
  }
  store_rows<D>(dk + (size_t)bg * sk * D, dka, kp0, sk, quad, scale);
  store_rows<D>(dv + (size_t)bg * sk * D, dva, kp0, sk, quad, 1.f);
}

// byte offset of element (row, col) (col even) in a 64 x 64 bf16 tile laid
// out as TMA's 128-byte swizzle lays it: 128-byte rows, the 16-byte chunk
// index XORed with the row's low three bits
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// ---------------------------------------------------------------------------
// bf16 at D = 80 and 128 (DV = D) and at MLA's q/k 96 with v 64: the pair
// route.  Both kernels are one
// persistent block an SM of two consumer warpgroups and a producer
// warpgroup, which gives its registers away (setmaxnreg 24; the consumers
// take 240, where the one-warpgroup kernels were held to 168 and, at D =
// 80 and 96 / 64, serialized their wgmma).  A block walks work items (a 128-row q
// block for dQ, a 128-row kv block for dK/dV; head by head, so that the
// blocks in flight share a head's tiles in L2) in a snake order over the
// grid: round r gives block x item r * grid + x, or r * grid + grid - 1 -
// x when r is odd (snake_item).  Warpgroup w owns
// rows [64 w, 64 w + 64) of the item, whose tiles (dQ: Q and dO; dK/dV: K
// and V) the producer's thread 0 loads by TMA into a slot (two slots: the
// next item's tiles arrive while this one runs; a slot is freed once its
// tiles' last product has read them), and both warpgroups read each stage
// of the other pair that it streams through an NS-stage ring (dQ: K and V;
// dK/dV: Q and dO, with the 64 rows' base-2 LSE and Delta, which the
// producer's 128 threads write, one value each).  A warpgroup skips the
// stages its rows cannot see (the diagonal, a window) but still waits for
// and releases each, so that neither runs ahead by a round.  With two
// warpgroups an SM, one's exp2, mask and piece pass runs under the other's
// products.  Per visible tile a warpgroup does what the one-warpgroup
// kernels do, in the same roundings: S (S^T) and dP (dP^T) as wgmma SS, P
// and dS in two bf16 pieces as the A operand of the products that sum dQ,
// dK (N = D) and dV (N = DV), each one wgmma a piece and 16 k rows
// (PairCols: D = 80's tiles are five 16-wide blocks with the 32-byte
// swizzle, D = 96's three 32-wide blocks with the 64-byte swizzle, not the
// forward's 64 + 16 or 64 + 32).  The kernels are templated on (D, DV):
// Q, K, S, dQ and dK are D wide; V, dO, O (Delta's rowsum), dP and dV DV
// wide.  dQ and the dK/dV of D = 80 and 96 / 64 (80 accumulators a
// thread either way) keep the pieces in registers (RS); D = 128's dK/dV writes P^T's and
// dS^T's to shared memory in the 128-byte swizzle and reads them back as
// SS operands, so that only its 128 accumulators stay in registers beside
// S^T and dP^T (in registers the pieces serialized its wgmma, C7512).
// Forms that were timed and were slower are in PERF.md §6 (the next
// tile's S and dP queued behind this tile's products; Delta from O loaded
// by TMA).  The sums start at an item's first visible tile and end at its
// last, as the one-warpgroup kernels' do; no atomics.
constexpr int BWP_THREADS = 384;  // two consumer warpgroups, then the producer's
constexpr int QB = 2 * WT;        // rows of an item: a q block or a kv block

// Shared memory of a pair kernel (DKV: the dK/dV one), from a 1024-byte
// aligned base: NSLOT slots of both warpgroups' resident pairs, NS stages
// of the streamed pair, dK/dV's P^T and dS^T pieces when they go through
// shared memory (each warpgroup's four 64 x 64 bf16 tiles: P^T hi, lo,
// dS^T hi, lo), fp32 rows (dK/dV: each stage's base-2 LSE and Delta),
// barriers.
template <int D, int DV, bool DKV>
struct BwPair {
  static constexpr int TILE = WT * D * 2;     // a 64-row Q or K tile
  static constexpr int TILE_V = WT * DV * 2;  // a 64-row V or dO tile
  static constexpr int PAIR = TILE + TILE_V;  // (Q, dO) or (K, V)
  static constexpr int SLOT = 2 * PAIR;       // warpgroup 0's pair, then 1's
  static constexpr int PIECE = WT * WT * 2;
  // dK/dV's pieces go through shared memory at D = 128: in registers,
  // beside 128 accumulators and S^T and dP^T, ptxas serialized the wgmma
  // (C7512); at D = 80 and 96 / 64 they stay in registers (faster there,
  // no spill)
  static constexpr bool SMEM_PIECES = DKV && D == 128;
  // slots of the resident pairs: two (the next item's arrive while this
  // one runs), one for D = 128's dK/dV, whose pieces take the room of the
  // other (its items are long: a group's heads over up to 16 q tiles)
  static constexpr int NSLOT = SMEM_PIECES ? 1 : 2;
  // stages of the ring: D = 128's dQ two (two 64 KB slots beside them)
  static constexpr int NS = D == 128 ? (DKV ? 3 : 2) : 4;
  static constexpr int STAGE_OFF = NSLOT * SLOT;
  static constexpr int PIECE_OFF = STAGE_OFF + NS * PAIR;
  static constexpr int ROWS_OFF = PIECE_OFF + (SMEM_PIECES ? 8 * PIECE : 0);
  // dK/dV's rows: each stage's 64 base-2 LSE, then 64 Delta
  static constexpr int BAR_OFF = ROWS_OFF + (DKV ? NS * 2 * WT * 4 : 0);
  // barriers: res_full[2], res_empty[2], full[NS], empty[NS]; 1024 bytes
  // to align the base
  static constexpr int SMEM = BAR_OFF + 8 * (4 + 2 * NS) + 1024;
  static_assert(TILE % 1024 == 0 && TILE_V % 1024 == 0,
                "swizzled blocks must stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

__device__ __forceinline__ void wg_sync(int wg) {  // one consumer warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// acc (64 x 128) += A X over the 64 k rows of X: A two 64 x 64 bf16 pieces
// in shared memory (hi at `a`, lo one PIECE on; K-major, 128-byte
// swizzle), X a 64-row D = 128 tile (MN-major): one N = 128 wgmma a piece
// and 16 k rows
__device__ __forceinline__ void ss_pieces(float* acc, uint32_t a, uint32_t x) {
#pragma unroll
  for (int kk = 0; kk < WT / 16; ++kk)
#pragma unroll
    for (int pc = 0; pc < 2; ++pc)  // hi, then lo
      wgmma_ss_mn<128>(acc, gmma_desc(a + pc * WT * WT * 2 + 32 * kk, 128, false),
                       gmma_desc_mn(x + kk * 16 * 128, 128, WT * 128));
}

// a warpgroup's 64 x 32 fragment x (rows r0, r0 + 8 of each thread,
// columns cw + 8 j + 2 quad + e) -> two bf16 pieces, hi (the rounding) and
// lo (the rounding of the rest), into the swizzled tiles at the shared
// addresses hi_t and lo_t (32-bit addresses: with 64-bit generic pointers
// the pair route's dK/dV at D = 128 spilled)
__device__ __forceinline__ void put_pieces_s(uint32_t hi_t, uint32_t lo_t,
                                             const float* x, int r0, int cw,
                                             int quad) {
#pragma unroll
  for (int j = 0; j < WT / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows r0, r0 + 8
      const uint32_t at = swz128(r0 + 8 * h, cw + 8 * j + 2 * quad);
      const float a = x[4 * j + 2 * h], b = x[4 * j + 2 * h + 1];
      const uint32_t hi = pack_bf16(a, b);
      const uint32_t lo = pack_bf16(a - __uint_as_float(hi << 16),
                                    b - __uint_as_float(hi & 0xffff0000u));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hi_t + at), "r"(hi) : "memory");
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(lo_t + at), "r"(lo) : "memory");
    }
}

// The pair route's tiles of width W: column blocks of BW columns with the
// swizzle of their row bytes (RB), each 64 rows (BLOCK bytes) after the
// last: W = 64 and 128 as Cols<W> (64-wide blocks, the 128-byte swizzle),
// W = 80 as five 16-wide blocks (the 32-byte swizzle), W = 96 as three
// 32-wide blocks (the 64-byte swizzle), one box of the map of that width
// each, so that a product whose N is W is one wgmma (N = 80 or 96), where
// Cols<80>'s 64 + 16 and Cols<96>'s 64 + 32 took two.
template <int W>
struct PairCols {
  static constexpr int BW = W == 80 ? 16 : W == 96 ? 32 : 64;
  static constexpr int NB = W / BW;
  static constexpr int RB = 2 * BW;
  static constexpr int BLOCK = WT * RB;
  static_assert(NB * BW == W, "a tile is whole blocks");
};

// a 64-row tile of width W by TMA: m0 is the map of 64-wide boxes, m1 of
// the narrower second block's (make_maps: 16 wide at W = 80, 32 at 96)
template <int W>
__device__ __forceinline__ void pair_tma(uint32_t dst, const CUtensorMap* m0,
                                         const CUtensorMap* m1, uint32_t bar,
                                         int row, int head) {
  using P = PairCols<W>;
#pragma unroll
  for (int c = 0; c < P::NB; ++c)
    tma_load_3d(dst + c * P::BLOCK, P::BW == 64 ? m0 : m1, bar, P::BW * c, row,
                head);
}

// acc (64 x 64) = A B^T over W, A and B 64-row tiles (K-major)
template <int W>
__device__ __forceinline__ void pair_ss(float* acc, uint32_t a, uint32_t b) {
  using P = PairCols<W>;
#pragma unroll
  for (int c = 0; c < P::NB; ++c)
#pragma unroll
    for (int kk = 0; kk < P::BW / 16; ++kk)
      wgmma_ss<WT>(acc, gmma_desc(a + c * P::BLOCK + 32 * kk, P::RB, false),
                   gmma_desc(b + c * P::BLOCK + 32 * kk, P::RB, false),
                   c > 0 || kk > 0);
}

// acc (64 x W) += A X over the 64 k rows of X, A in two bf16 pieces in
// registers (hi, then lo), X a 64-row tile of width W (MN-major, its
// blocks the swizzle atoms along N): one wgmma a piece and 16 k rows
template <int W>
__device__ __forceinline__ void pair_rs(float* acc, uint32_t (*hi)[4],
                                        uint32_t (*lo)[4], uint32_t x) {
  using P = PairCols<W>;
#pragma unroll
  for (int kk = 0; kk < WT / 16; ++kk) {
    const uint64_t db = gmma_desc_mn(x + kk * 16 * P::RB, P::RB, P::BLOCK);
    wgmma_rs<W>(acc, hi[kk], db);
    wgmma_rs<W>(acc, lo[kk], db);
  }
}

// a pair kernel's shared-memory layout from the dynamic base: the 1024-byte
// aligned base, dK/dV's rows and the barriers
template <class L>
struct PairSmem {
  uint32_t sbase, bars;
  float* rows;
  __device__ explicit PairSmem(uint8_t* smem) {
    const uint32_t raw = smem_u32(smem);
    sbase = (raw + 1023u) & ~1023u;
    rows = reinterpret_cast<float*>(smem + (sbase - raw) + L::ROWS_OFF);
    bars = sbase + L::BAR_OFF;
  }
  __device__ uint32_t res_full(int slot) const { return bars + 8u * slot; }
  __device__ uint32_t res_empty(int slot) const { return bars + 8u * (2 + slot); }
  __device__ uint32_t full(int s) const { return bars + 8u * (4 + s); }
  __device__ uint32_t empty(int s) const { return bars + 8u * (4 + L::NS + s); }
};

// this block's n-th item in the snake order, or -1 past the last
__device__ __forceinline__ int snake_item(int n, int n_items) {
  const int g = gridDim.x, x = blockIdx.x;
  const int item = n * g + ((n & 1) ? g - 1 - x : x);
  return item < n_items ? item : -1;
}

// a dQ item: q block q0 of head bh and the kv tiles [t_begin, t_begin +
// n_tiles) that any of its rows can see.  Items run head by head (a
// head's q blocks the last, the longest causal rows, first), so that the
// blocks in flight share their heads' K and V in L2: ordered by q block
// over all heads, they read each head's K and V from memory again for
// each of its q blocks
struct DqItem {
  int bh, q0, t_begin, n_tiles;
};

__device__ __forceinline__ DqItem dq_item(int item, int sq, int sk,
                                          int causal, int window) {
  DqItem w;
  const int n_qb = (sq + QB - 1) / QB;
  w.bh = item / n_qb;
  w.q0 = (n_qb - 1 - item % n_qb) * QB;
  const int off = sk - sq, rows = min(QB, sq - w.q0);
  const int k_end = causal ? min(sk, w.q0 + rows + off) : sk;
  const int k_begin = window > 0 ? max(0, w.q0 + off - window + 1) : 0;
  w.t_begin = k_begin / WT;
  w.n_tiles = k_end > w.t_begin * WT ? (k_end - w.t_begin * WT + WT - 1) / WT : 0;
  return w;
}

// a dK/dV item: kv block k0 of group bg and its q tiles i_begin + 64 t,
// t < n_qt, per head of the group; group by group (a group's first kv
// blocks, seen by the most causal rows, first), so that the blocks in
// flight share their groups' Q and dO in L2
struct DkvItem {
  int bg, k0, i_begin, n_qt;
};

__device__ __forceinline__ DkvItem dkv_item(int item, int sq, int sk,
                                            int causal, int window) {
  DkvItem w;
  const int n_kb = (sk + QB - 1) / QB;
  w.bg = item / n_kb;
  w.k0 = item % n_kb * QB;
  const int off = sk - sq, kmax = min(sk, w.k0 + QB) - 1;
  w.i_begin = causal ? max(0, w.k0 - off) : 0;
  const int i_end = window > 0 ? min(sq, kmax + window - off) : sq;
  w.n_qt = i_end > w.i_begin ? (i_end - w.i_begin + WT - 1) / WT : 0;
  return w;
}

// Delta of this thread's rows i and i + 8 (rows `row0` + i of o and dO,
// D wide: the pair route passes DV): the quad's four threads each take a
// quarter of both rows and add theirs by shuffles; quad 0 stores them to
// `delta` as well
template <int D>
__device__ __forceinline__ void quad_delta(float& d0, float& d1, const bf16* o,
                                           const bf16* dout, float* delta,
                                           size_t row0, int i, int sq, int quad) {
  constexpr int NQ = D / 16;  // 4-value loads in a quarter row
  uint2 x[2][NQ], y[2][NQ];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = (row0 + i + 8 * h) * D + quad * (D / 4);
    const uint2* op = reinterpret_cast<const uint2*>(o + at);
    const uint2* dp = reinterpret_cast<const uint2*>(dout + at);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const bool in = i + 8 * h < sq;
      x[h][j] = in ? op[j] : make_uint2(0u, 0u);
      y[h][j] = in ? dp[j] : make_uint2(0u, 0u);
    }
  }
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const bf16* xe = reinterpret_cast<const bf16*>(&x[h][j]);
      const bf16* ye = reinterpret_cast<const bf16*>(&y[h][j]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[h] = fmaf(__bfloat162float(ye[e]), __bfloat162float(xe[e]), s[h]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(FULL, s[h], 1);
    s[h] += __shfl_xor_sync(FULL, s[h], 2);
    if (quad == 0 && i + 8 * h < sq) delta[row0 + i + 8 * h] = s[h];
  }
  d0 = s[0];
  d1 = s[1];
}

// dQ and each row's Delta, 128 q rows an item: warpgroup w's Q and dO tiles
// (rows q0 + 64 w) stay in their slot; the producer streams the item's
// visible K/V tiles.  Each consumer works out its rows' Delta from O and dO
// in global memory at the item's start (quad_delta: its rows' Delta and
// LSE in registers, no barrier).
template <int D, int DV>
__global__ void __launch_bounds__(BWP_THREADS, 1)
bwd_dq_wgmma_pair(const __grid_constant__ CUtensorMap tq0,
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
  using L = BwPair<D, DV, false>;
  constexpr int NS = L::NS;
  extern __shared__ uint8_t bw_smem[];
  const uint32_t raw = smem_u32(bw_smem);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const uint32_t bars = sbase + L::BAR_OFF;
  auto res_full = [&](int slot) { return bars + 8u * slot; };
  auto res_empty = [&](int slot) { return bars + 8u * (2 + slot); };
  auto full = [&](int s) { return bars + 8u * (4 + s); };
  auto empty = [&](int s) { return bars + 8u * (4 + NS + s); };

  if (threadIdx.x == 0) {
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(res_full(slot), 1);
      mbar_init(res_empty(slot), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer: its thread 0 issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const int n_items = (sq + QB - 1) / QB * B * H;
      int it = 0;
      for (int n = 0;; ++n) {
        const int item = snake_item(n, n_items);
        if (item < 0) break;
        const DqItem w = dq_item(item, sq, sk, causal, window);
        const int slot = n % L::NSLOT;
        mbar_wait(res_empty(slot), ((n / L::NSLOT) & 1) ^ 1);  // rounds 0 pass at once
        mbar_expect_tx(res_full(slot), L::SLOT);
        const uint32_t dst = sbase + slot * L::SLOT;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          pair_tma<D>(dst + c * L::PAIR, &tq0, &tq1, res_full(slot),
                      w.q0 + WT * c, w.bh);
          pair_tma<DV>(dst + c * L::PAIR + L::TILE, &tdo0, &tdo1,
                       res_full(slot), w.q0 + WT * c, w.bh);
        }
        const int bg = w.bh / H * G + w.bh % H / (H / G);
        for (int i = 0; i < w.n_tiles; ++i, ++it) {
          const int s = it % NS;
          mbar_wait(empty(s), ((it / NS) & 1) ^ 1);
          mbar_expect_tx(full(s), L::PAIR);
          const uint32_t st = sbase + L::STAGE_OFF + s * L::PAIR;
          const int k0 = (w.t_begin + i) * WT;
          pair_tma<D>(st, &tk0, &tk1, full(s), k0, bg);
          pair_tma<DV>(st + L::TILE, &tv0, &tv1, full(s), k0, bg);
        }
      }
    }
    return;  // no block-wide barrier follows
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int n_items = (sq + QB - 1) / QB * B * H;

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const int off = sk - sq;
  const float sl2 = scale * LOG2E;
  int it = 0;
  for (int n = 0;; ++n) {
    const int item = snake_item(n, n_items);
    if (item < 0) break;
    const DqItem w = dq_item(item, sq, sk, causal, window);
    const int slot = n % L::NSLOT;
    // this warpgroup's rows and the kv positions they can see
    const int qw0 = w.q0 + WT * wg, rows = min(WT, sq - qw0);
    const int qlo = qw0 + off, qhi = qw0 + rows - 1 + off;
    const int k_begin = window > 0 ? max(0, qlo - window + 1) : 0;
    const int k_end = rows <= 0 ? 0 : causal ? min(sk, qhi + 1) : sk;
    const size_t row0 = (size_t)w.bh * sq;
    float dl0, dl1;
    quad_delta<DV>(dl0, dl1, o, dout, delta, row0, qw0 + r0, sq, quad);
    const float L0 = lse2(lse, row0, qw0 + r0, sq);
    const float L1 = lse2(lse, row0, qw0 + r0 + 8, sq);
    const int qp0 = qw0 + r0 + off, qp1 = qp0 + 8;
    mbar_wait(res_full(slot), (n / L::NSLOT) & 1);
    const uint32_t qa = sbase + slot * L::SLOT + wg * L::PAIR, doa = qa + L::TILE;
    if (w.n_tiles == 0) release(res_empty(slot), lane);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < w.n_tiles; ++i, ++it) {
      const int s = it % NS;
      const bool last = i + 1 == w.n_tiles;
      mbar_wait(full(s), (it / NS) & 1);
      const int k0 = (w.t_begin + i) * WT;
      if (k0 < k_end && k0 + WT > k_begin) {
        const uint32_t kt = sbase + L::STAGE_OFF + s * L::PAIR;
        float sc[WT / 2], dp[WT / 2];
        uint32_t hi[WT / 16][4], lo[WT / 16][4];
        wg_fence();
        pair_ss<D>(sc, qa, kt);             // S = Q K^T
        pair_ss<DV>(dp, doa, kt + L::TILE);  // dP = dO V^T
        wg_commit();
        wg_wait<0>();
        reg_fence<WT / 2>(sc);
        reg_fence<WT / 2>(dp);
        if (last) release(res_empty(slot), lane);  // Q and dO are read
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
        pair_rs<D>(acc, hi, lo, kt);  // dQ += dS K
        wg_commit();
        wg_wait<0>();
        reg_fence<D / 2>(acc);
      } else if (last) {
        release(res_empty(slot), lane);
      }
      release(empty(s), lane);
    }
    store_rows<D>(dq + row0 * D, acc, qw0 + r0, sq, quad, scale);
  }
}

// dK and dV, 128 kv rows an item over the group's heads: warpgroup w's K
// and V tiles (rows k0 + 64 w) stay in their slot; the producer streams
// the Q and dO tiles that can see the block, and its 128 threads write
// each stage's rows' base-2 LSE (threads 0-63) and Delta (64-127).
template <int D, int DV>
__global__ void __launch_bounds__(BWP_THREADS, 1)
bwd_dkv_wgmma_pair(const __grid_constant__ CUtensorMap tq0,
                   const __grid_constant__ CUtensorMap tq1,
                   const __grid_constant__ CUtensorMap tdo0,
                   const __grid_constant__ CUtensorMap tdo1,
                   const __grid_constant__ CUtensorMap tk0,
                   const __grid_constant__ CUtensorMap tk1,
                   const __grid_constant__ CUtensorMap tv0,
                   const __grid_constant__ CUtensorMap tv1,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H,
                   int G, int sq, int sk, int causal, int window, float scale) {
  using L = BwPair<D, DV, true>;
  constexpr int NS = L::NS;
  extern __shared__ uint8_t bw_smem[];
  // the layout (PairSmem) and counts are worked out in each role past its
  // setmaxnreg (values held across it were spilled), the item count anew
  // each item from the parameters (held through the loop, it was)
  auto n_items = [&] {
    int b = B;
    asm volatile("" : "+r"(b));
    return (sk + QB - 1) / QB * b * G;
  };
  if (threadIdx.x == 0) {
    const PairSmem<L> m(bw_smem);
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(m.res_full(slot), 1);
      mbar_init(m.res_empty(slot), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(m.full(s), 1 + 128);  // the copies' byte count, then
                                      // every producer thread (its row)
      mbar_init(m.empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer: thread 0 issues every copy, thread t
                  // writes row t's LSE (t < 64) or Delta of each stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const PairSmem<L> m(bw_smem);
    const int hg = H / G;
    const int pt = threadIdx.x - 256;
    int it = 0;
    for (int n = 0;; ++n) {
      const int item = snake_item(n, n_items());
      if (item < 0) break;
      const DkvItem w = dkv_item(item, sq, sk, causal, window);
      if (pt == 0) {
        const int slot = n % L::NSLOT;
        mbar_wait(m.res_empty(slot), ((n / L::NSLOT) & 1) ^ 1);  // rounds 0 pass at once
        mbar_expect_tx(m.res_full(slot), L::SLOT);
        const uint32_t dst = m.sbase + slot * L::SLOT;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          pair_tma<D>(dst + c * L::PAIR, &tk0, &tk1, m.res_full(slot),
                      w.k0 + WT * c, w.bg);
          pair_tma<DV>(dst + c * L::PAIR + L::TILE, &tv0, &tv1,
                       m.res_full(slot), w.k0 + WT * c, w.bg);
        }
      }
      const int h0 = w.bg / G * H + w.bg % G * hg;  // the group's first head
      const int n_it = hg * w.n_qt;
      for (int j = 0; j < n_it; ++j, ++it) {
        const int s = it % NS;
        const int bh = h0 + j / w.n_qt;
        const int i0 = w.i_begin + j % w.n_qt * WT;
        const int i = i0 + pt % WT;
        const float val = pt < WT ? lse2(lse, (size_t)bh * sq, i, sq)
                                  : (i < sq ? delta[(size_t)bh * sq + i] : 0.f);
        mbar_wait(m.empty(s), ((it / NS) & 1) ^ 1);  // round 0 passes at once
        if (pt == 0) {
          mbar_expect_tx(m.full(s), L::PAIR);
          const uint32_t st = m.sbase + L::STAGE_OFF + s * L::PAIR;
          pair_tma<D>(st, &tq0, &tq1, m.full(s), i0, bh);
          pair_tma<DV>(st + L::TILE, &tdo0, &tdo1, m.full(s), i0, bh);
        }
        m.rows[s * 2 * WT + pt] = val;
        mbar_arrive(m.full(s));  // releases this thread's row
      }
    }
    return;  // no block-wide barrier follows
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const PairSmem<L> m(bw_smem);
  const int hg = H / G, off = sk - sq;

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's kv rows: r0, r0 + 8
  const float sl2 = scale * LOG2E;
  // this warpgroup's pieces when they go through shared memory: P^T hi,
  // lo, dS^T hi, lo
  const uint32_t pieces = m.sbase + L::PIECE_OFF + wg * 4 * L::PIECE;
  int it = 0;
  for (int n = 0;; ++n) {
    const int item = snake_item(n, n_items());
    if (item < 0) break;
    const DkvItem w = dkv_item(item, sq, sk, causal, window);
    const int slot = n % L::NSLOT;
    // this warpgroup's kv rows and the q rows that can see them
    const int kw0 = w.k0 + WT * wg;
    const int kp0 = kw0 + r0, kp1 = kp0 + 8;
    const int kmax = min(sk, kw0 + WT) - 1;
    const int i_begin = causal ? max(0, kw0 - off) : 0;
    const int i_end = kw0 >= sk ? 0 : window > 0 ? min(sq, kmax + window - off) : sq;
    const int n_it = hg * w.n_qt;

    mbar_wait(m.res_full(slot), (n / L::NSLOT) & 1);
    const uint32_t ka = m.sbase + slot * L::SLOT + wg * L::PAIR, va = ka + L::TILE;
    if (n_it == 0) release(m.res_empty(slot), lane);

    float dka[D / 2], dva[DV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;
    for (int j = 0; j < n_it; ++j, ++it) {
      const int s = it % NS;
      const bool last = j + 1 == n_it;
      mbar_wait(m.full(s), (it / NS) & 1);
      const int i0 = w.i_begin + j % w.n_qt * WT;
      if (i0 < i_end && i0 + WT > i_begin) {
        const uint32_t qt = m.sbase + L::STAGE_OFF + s * L::PAIR, dot = qt + L::TILE;
        const float* Ls = m.rows + s * 2 * WT;
        const float* Ds = Ls + WT;
        float st[WT / 2], dpt[WT / 2];
        wg_fence();
        pair_ss<D>(st, ka, qt);    // S^T = K Q^T
        pair_ss<DV>(dpt, va, dot);  // dP^T = V dO^T
        wg_commit();
        wg_wait<0>();
        reg_fence<WT / 2>(st);
        reg_fence<WT / 2>(dpt);
        if (last) release(m.res_empty(slot), lane);  // K and V are read
        // P^T and dS^T on the fragments: rows kv, columns q rows i0 + c
        const bool edge = kw0 + WT > sk || (causal && kw0 + WT - 1 > i0 + off) ||
                          (window > 0 && kw0 <= i0 + WT - 1 + off - window);
#pragma unroll
        for (int jj = 0; jj < WT / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * jj + e, c = 8 * jj + 2 * quad + (e & 1);
            float p = ex2(st[x] * sl2 - Ls[c]);
            if (edge && !visible(i0 + c + off, e < 2 ? kp0 : kp1, sk, causal, window))
              p = 0.f;
            dpt[x] = p * (dpt[x] - Ds[c]);
            st[x] = p;
          }
        if constexpr (L::SMEM_PIECES) {
          // the last tile's products, the pieces' last readers, are done
          // (its wait); each warp writes the 16 rows its part of them read
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // q columns [32 h, 32 h + 32)
            put_pieces_s(pieces, pieces + L::PIECE, st + 16 * h, r0, 32 * h, quad);
            put_pieces_s(pieces + 2 * L::PIECE, pieces + 3 * L::PIECE, dpt + 16 * h,
                         r0, 32 * h, quad);
          }
          // the pieces, written by the generic proxy, are read by wgmma's
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          wg_sync(wg);
          wg_fence();
          ss_pieces(dva, pieces, dot);                // dV += P^T dO
          ss_pieces(dka, pieces + 2 * L::PIECE, qt);  // dK += dS^T Q
          wg_commit();
        } else {
          uint32_t hi[WT / 16][4], lo[WT / 16][4];
          split_pieces(hi, lo, st);  // P^T
          wg_fence();
          pair_rs<DV>(dva, hi, lo, dot);  // dV += P^T dO
          wg_commit();
          uint32_t dh[WT / 16][4], dl[WT / 16][4];
          split_pieces(dh, dl, dpt);  // dS^T, while dV's products run
          wg_fence();
          pair_rs<D>(dka, dh, dl, qt);  // dK += dS^T Q
          wg_commit();
        }
        wg_wait<0>();
        reg_fence<D / 2>(dka);
        reg_fence<DV / 2>(dva);
      } else if (last) {
        release(m.res_empty(slot), lane);
      }
      release(m.empty(s), lane);
    }
    store_rows<D>(dk + (size_t)w.bg * sk * D, dka, kp0, sk, quad, scale);
    store_rows<DV>(dv + (size_t)w.bg * sk * DV, dva, kp0, sk, quad, 1.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 256 (gemma-2b): two persistent kernels of one block an SM,
// two consumer warpgroups and a producer warpgroup (setmaxnreg 24 / 240,
// as the pair route), items in the snake order, the longest first.  A
// 64-row tile's 128 accumulators a thread leave a warpgroup no room for
// S, dP and their pieces beside them (with S^T and dP^T split by 32 q
// columns over two warpgroups that each own half of dK's and dV's columns
// instead, ptxas spilled and serialized the wgmma, C7512), so the two
// kernels take two different ways out:
//
//  - dK/dV (bwd_dkv_wgmma256) splits a tile's work by role.  An item is a
//    64-row kv tile of a group and half of its heads (when H / G is even;
//    all of them when it is odd), items kv tile by kv tile.  Warpgroup 0
//    forms S^T = K Q^T (N = 64, K = 256) and P^T and hands P^T over in
//    fp32 through one of two 16 KB shared-memory buffers, in the
//    accumulator fragments' own order (a float4 a thread at a time,
//    neighbouring threads on neighbouring addresses), then sums all of dV
//    += P^T dO (P^T's two bf16 pieces in registers, one N = 256 wgmma a
//    piece and 16 rows).  Warpgroup 1 forms dP^T = V dO^T meanwhile,
//    waits for P^T alone (one way: an mbarrier full, one empty, per
//    buffer), forms dS^T and sums dK += dS^T Q in the same form.  The
//    roundings are the one-warpgroup kernels' (P^T crosses in fp32).  K
//    and V are one slot, freed after an item's last S^T and dP^T, so that
//    the next item's arrive under its last products; Q and dO (with the
//    rows' base-2 LSE and Delta) run through two 64 KB stages.  The two
//    blocks of a kv tile add their sums without a third launch: each
//    warpgroup takes a ticket (an integer counter a kv tile and
//    warpgroup, which the dQ launch zeroes); the first stores its fp32
//    sum, the second waits for it, adds it to its own (two terms add the
//    same in either order: the result is deterministic) and stores the
//    bf16 result.
//  - dQ (bwd_dq_wgmma256) splits the rows, as the pair route does: an
//    item is 128 q rows of a head (the last, longest causal rows first),
//    warpgroup w owns rows [64 w, 64 w + 64) with their Q and dO resident
//    and their 128 accumulators, and the producer streams the visible K
//    and V in stages of 32 rows (three fit beside the resident 128 KB), so
//    that S and dP are N = 32 products (16 accumulators each) and dS's
//    pieces fit in registers as the A operand of dQ += dS K (one N = 256
//    wgmma a piece and 16 rows).  The warpgroups share each stage and
//    nothing else, so one's exp2 and piece pass runs under the other's
//    products.  A row's Delta reads O from memory and dO from the slot.
//    (Forms that were timed and were slower are in PERF.md §6: dQ's tile
//    split by role, as dK/dV's is; the next item's Q, dO and O prefetched
//    into the L2; the next stage's S and dP issued ahead of this stage's
//    dQ products, which spilled.)
constexpr int B256_THREADS = 384;  // two consumer warpgroups, then the producer's

// Shared memory of bwd_dkv_wgmma256, from a 1024-byte aligned base: K and
// V, NS stages of Q and dO, the two fp32 P^T buffers, each stage's 64
// base-2 LSE and 64 Delta, barriers, a ticket word a consumer warpgroup.
struct Bw256 {
  static constexpr int D = 256;
  static constexpr int TILE = WT * D * 2;  // a 64-row tile: 32 KB
  static constexpr int PAIR = 2 * TILE;
  static constexpr int NS = 2;
  static constexpr int STAGE_OFF = PAIR;
  static constexpr int XFER = WT * WT * 4;  // a 64 x 64 fp32 tile
  static constexpr int XFER_OFF = STAGE_OFF + NS * PAIR;
  static constexpr int ROWS_OFF = XFER_OFF + 2 * XFER;
  static constexpr int BAR_OFF = ROWS_OFF + NS * 2 * WT * 4;
  // res_full, res_empty, full[NS], empty[NS], xfull[2], xempty[2]
  static constexpr int NBAR = 2 + 2 * NS + 4;
  static constexpr int SMEM = BAR_OFF + 8 * NBAR + 8 + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

// Shared memory of bwd_dq_wgmma256: the slot (warpgroup 0's Q and dO,
// then 1's), NS stages of 32 K rows and 32 V rows (each four 64-wide
// blocks with the 128-byte swizzle), barriers.
struct Bw256Q {
  static constexpr int D = 256;
  static constexpr int TILE = WT * D * 2;  // 64 rows of Q or dO: 32 KB
  static constexpr int PAIR = 2 * TILE;
  static constexpr int SLOT = 2 * PAIR;
  static constexpr int KR = 32;             // kv rows a stage
  static constexpr int KTILE = KR * D * 2;  // 32 rows of K or V: 16 KB
  static constexpr int NS = 3;
  static constexpr int STAGE_OFF = SLOT;
  static constexpr int ROWS_OFF = STAGE_OFF + NS * 2 * KTILE;  // none
  static constexpr int BAR_OFF = ROWS_OFF;
  // res_full, res_empty, full[NS], empty[NS]
  static constexpr int NBAR = 2 + 2 * NS;
  static constexpr int SMEM = BAR_OFF + 8 * NBAR + 8 + 1024;
  static_assert(KTILE % 1024 == 0, "swizzled blocks must stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "more shared memory than a block can have");
};

template <class L>
struct Smem256 {
  uint32_t sbase, bars;
  float* rows;
  int* ticket;  // one a consumer warpgroup
  __device__ explicit Smem256(uint8_t* smem) {
    const uint32_t raw = smem_u32(smem);
    sbase = (raw + 1023u) & ~1023u;
    rows = reinterpret_cast<float*>(smem + (sbase - raw) + L::ROWS_OFF);
    ticket = reinterpret_cast<int*>(smem + (sbase - raw) + L::BAR_OFF + 8 * L::NBAR);
    bars = sbase + L::BAR_OFF;
  }
  __device__ uint32_t res_full() const { return bars; }
  __device__ uint32_t res_empty() const { return bars + 8u; }
  __device__ uint32_t full(int s) const { return bars + 8u * (2 + s); }
  __device__ uint32_t empty(int s) const { return bars + 8u * (2 + L::NS + s); }
  __device__ uint32_t xfull(int x) const { return bars + 8u * (2 + 2 * L::NS + x); }
  __device__ uint32_t xempty(int x) const { return bars + 8u * (4 + 2 * L::NS + x); }
};

// a warpgroup's 64 x 64 fp32 fragment x <-> the hand-over buffer at `buf`
// (shared address), in the fragment's order: float4 j of thread tid at
// (128 j + tid) 16 bytes
__device__ __forceinline__ void put_fragment(uint32_t buf, const float* x, int tid) {
#pragma unroll
  for (int j = 0; j < WT / 8; ++j)
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(buf + (128 * j + tid) * 16),
                 "f"(x[4 * j]), "f"(x[4 * j + 1]), "f"(x[4 * j + 2]), "f"(x[4 * j + 3])
                 : "memory");
}

// element e of a float4 (e a constant once unrolled: no local memory)
__device__ __forceinline__ float f4_at(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// float4 j of thread tid's fragment from the buffer at `buf`
__device__ __forceinline__ float4 get_fragment(uint32_t buf, int j, int tid) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(buf + (128 * j + tid) * 16)
               : "memory");
  return v;
}

// a D = 256 dK/dV item: kv tile kt of group bg, the heads [h0, h0 + nh)
// (half hs of the group's when it splits), and its q tiles i_begin + 64 t,
// t < n_qt, per head.  Items run kv tile by kv tile, the first (seen by
// the most causal rows) first; flash_attention.bwd256_items mirrors them.
struct Dkv256Item {
  int bg, kt, h0, nh, i_begin, n_qt;
};

__device__ __forceinline__ Dkv256Item dkv256_item(int item, int split, int B, int H,
                                                  int G, int sq, int sk, int causal,
                                                  int window) {
  Dkv256Item w;
  const int hg = H / G, hs = item % split;
  w.bg = item / split % (B * G);
  w.kt = item / split / (B * G);
  w.nh = hg / split;
  w.h0 = w.bg / G * H + w.bg % G * hg + hs * w.nh;
  const int k0 = w.kt * WT, off = sk - sq, kmax = min(sk, k0 + WT) - 1;
  w.i_begin = causal ? max(0, k0 - off) : 0;
  const int i_end = window > 0 ? min(sq, kmax + window - off) : sq;
  w.n_qt = i_end > w.i_begin ? (i_end - w.i_begin + WT - 1) / WT : 0;
  return w;
}

// a D = 256 dQ item: q block q0 (128 rows) of head bh and the 32-row kv
// stages [t_begin, t_begin + n_tiles) that any of its rows can see; the
// last q blocks (the longest causal rows) of every head first
__device__ __forceinline__ DqItem dq256_item(int item, int BH, int sq, int sk,
                                             int causal, int window) {
  constexpr int KR = 32;
  DqItem w;
  const int n_qb = (sq + QB - 1) / QB;
  w.bh = item % BH;
  w.q0 = (n_qb - 1 - item / BH) * QB;
  const int off = sk - sq, rows = min(QB, sq - w.q0);
  const int k_end = causal ? min(sk, w.q0 + rows + off) : sk;
  const int k_begin = window > 0 ? max(0, w.q0 + off - window + 1) : 0;
  w.t_begin = k_begin / KR;
  w.n_tiles = k_end > w.t_begin * KR ? (k_end - w.t_begin * KR + KR - 1) / KR : 0;
  return w;
}

// spin until *p == want (a ticket's other half stored); a wait of more than
// 4 s traps, as mbar_wait does
__device__ __forceinline__ void spin_until(const int* p, int want) {
  uint64_t t0 = 0;
  while (true) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    if (v == want) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > 4000000000ull)
      __trap();
  }
}

// acc (a 64 x D fragment, rows `row`, `row` + 8) += the fp32 rows at `in`
// (rows D apart) below n, read past the L1 (another SM wrote them)
template <int D>
__device__ __forceinline__ void add_rows_f32(float* acc, const float* in, int row,
                                             int n, int quad) {
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    const int col = 8 * jj + 2 * quad;
    if (row < n) {
      const float2 a = __ldcg(reinterpret_cast<const float2*>(in + (size_t)row * D + col));
      acc[4 * jj] += a.x;
      acc[4 * jj + 1] += a.y;
    }
    if (row + 8 < n) {
      const float2 a =
          __ldcg(reinterpret_cast<const float2*>(in + (size_t)(row + 8) * D + col));
      acc[4 * jj + 2] += a.x;
      acc[4 * jj + 3] += a.y;
    }
  }
}

// dK and dV: warpgroup 0 sums dV, warpgroup 1 dK, of an item's kv tile.
// part (when an even group splits its heads): 2 B G Sk D fp32 (the first
// finisher's dV, then its dK), then 2 B G ceil(Sk / 64) int tickets.
__global__ void __launch_bounds__(B256_THREADS, 1)
bwd_dkv_wgmma256(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                 float* __restrict__ part, int B, int H, int G, int sq, int sk,
                 int causal, int window, float scale) {
  using L = Bw256;
  constexpr int D = L::D, NS = L::NS;
  extern __shared__ uint8_t bw_smem[];
  // the layout and counts are worked out in each role past its setmaxnreg
  // (values held across it are spilled), the item count anew each item
  auto n_items = [&] {
    int b = B;
    asm volatile("" : "+r"(b));
    return (sk + WT - 1) / WT * b * G * (part != nullptr ? 2 : 1);
  };
  if (threadIdx.x == 0) {
    const Smem256<L> m(bw_smem);
    mbar_init(m.res_full(), 1);
    mbar_init(m.res_empty(), 8);  // lane 0 of each consumer warp
    for (int s = 0; s < NS; ++s) {
      mbar_init(m.full(s), 1 + 128);  // the copies' byte count, then every
                                      // producer thread (its row)
      mbar_init(m.empty(s), 8);
    }
    for (int x = 0; x < 2; ++x) {
      mbar_init(m.xfull(x), 128);  // every thread of warpgroup 0
      mbar_init(m.xempty(x), 4);   // lane 0 of each warp of warpgroup 1
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer: thread 0 issues every copy, thread t
                  // writes row t's LSE (t < 64) or Delta of each stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const Smem256<L> m(bw_smem);
    const int pt = threadIdx.x - 256, split = part != nullptr ? 2 : 1;
    int it = 0;
    for (int n = 0;; ++n) {
      const int item = snake_item(n, n_items());
      if (item < 0) break;
      const Dkv256Item w = dkv256_item(item, split, B, H, G, sq, sk, causal, window);
      if (pt == 0) {
        mbar_wait(m.res_empty(), (n & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(m.res_full(), L::PAIR);
        tma_tile<D>(m.sbase, &tk, &tk, m.res_full(), w.kt * WT, w.bg);
        tma_tile<D>(m.sbase + L::TILE, &tv, &tv, m.res_full(), w.kt * WT, w.bg);
      }
      const int n_it = w.nh * w.n_qt;
      for (int j = 0; j < n_it; ++j, ++it) {
        const int s = it % NS;
        const int bh = w.h0 + j / w.n_qt;
        const int i0 = w.i_begin + j % w.n_qt * WT, i = i0 + pt % WT;
        const float val = pt < WT ? lse2(lse, (size_t)bh * sq, i, sq)
                                  : (i < sq ? delta[(size_t)bh * sq + i] : 0.f);
        mbar_wait(m.empty(s), ((it / NS) & 1) ^ 1);
        if (pt == 0) {
          mbar_expect_tx(m.full(s), L::PAIR);
          const uint32_t st = m.sbase + L::STAGE_OFF + s * L::PAIR;
          tma_tile<D>(st, &tq, &tq, m.full(s), i0, bh);
          tma_tile<D>(st + L::TILE, &tdo, &tdo, m.full(s), i0, bh);
        }
        m.rows[s * 2 * WT + pt] = val;
        mbar_arrive(m.full(s));  // releases this thread's row
      }
    }
    return;  // no block-wide barrier follows
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const Smem256<L> m(bw_smem);
  const int split = part != nullptr ? 2 : 1, off = sk - sq;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's kv rows: r0, r0 + 8
  const float sl2 = scale * LOG2E;
  int it = 0;
  for (int n = 0;; ++n) {
    const int item = snake_item(n, n_items());
    if (item < 0) break;
    const Dkv256Item w = dkv256_item(item, split, B, H, G, sq, sk, causal, window);
    const int k0 = w.kt * WT, kp0 = k0 + r0, kp1 = kp0 + 8;
    const int n_it = w.nh * w.n_qt;
    mbar_wait(m.res_full(), n & 1);
    if (n_it == 0) release(m.res_empty(), lane);

    float acc[D / 2];  // warpgroup 0: dV; 1: dK (unscaled)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int j = 0; j < n_it; ++j, ++it) {
      const int s = it % NS, x = it % 2;
      mbar_wait(m.full(s), (it / NS) & 1);
      const int i0 = w.i_begin + j % w.n_qt * WT;
      const uint32_t qt = m.sbase + L::STAGE_OFF + s * L::PAIR, dot = qt + L::TILE;
      const float* Ls = m.rows + s * 2 * WT;
      float sx[WT / 2];  // warpgroup 0: S^T, then P^T; 1: dP^T, then dS^T
      wg_fence();
      pair_ss<D>(sx, m.sbase + wg * L::TILE, wg ? dot : qt);  // K Q^T or V dO^T
      wg_commit();
      wg_wait<0>();
      reg_fence<WT / 2>(sx);
      if (j + 1 == n_it) release(m.res_empty(), lane);  // K and V are read
      // rows kv, columns q rows i0 + c; P^T one way, warpgroup 0 to 1
      const uint32_t buf = m.sbase + L::XFER_OFF + x * L::XFER;
      mbar_wait(wg ? m.xfull(x) : m.xempty(x), ((it / 2) & 1) ^ (wg ? 0 : 1));
      if (wg == 0) {
        const bool edge = k0 + WT > sk || (causal && k0 + WT - 1 > i0 + off) ||
                          (window > 0 && k0 <= i0 + WT - 1 + off - window);
#pragma unroll
        for (int jj = 0; jj < WT / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int y = 4 * jj + e, c = 8 * jj + 2 * quad + (e & 1);
            float p = ex2(sx[y] * sl2 - Ls[c]);
            if (edge && !visible(i0 + c + off, e < 2 ? kp0 : kp1, sk, causal, window))
              p = 0.f;
            sx[y] = p;
          }
        put_fragment(buf, sx, tid);
        mbar_arrive(m.xfull(x));
      } else {
        const float* Ds = Ls + WT;
#pragma unroll
        for (int jj = 0; jj < WT / 8; ++jj) {
          const float4 p = get_fragment(buf, jj, tid);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int y = 4 * jj + e;
            sx[y] = f4_at(p, e) * (sx[y] - Ds[8 * jj + 2 * quad + (e & 1)]);
          }
        }
        release(m.xempty(x), lane);
      }
      uint32_t hi[WT / 16][4], lo[WT / 16][4];
      split_pieces(hi, lo, sx);
      wg_fence();
      pair_rs<D>(acc, hi, lo, wg ? qt : dot);  // dV += P^T dO or dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      reg_fence<D / 2>(acc);
      release(m.empty(s), lane);
    }
    const size_t at = (size_t)w.bg * sk * D;
    bf16* out = (wg ? dk : dv) + at;
    const float mul = wg ? scale : 1.f;
    if (split == 1) {
      store_rows<D>(out, acc, kp0, sk, quad, mul);
      continue;
    }
    // the kv tile's two halves: the first to take the ticket stores its
    // fp32 sum, then adds 2; the second waits for both tickets and the 2
    const size_t n_all = (size_t)B * G * sk * D;
    float* ws = part + wg * n_all + at;
    int* cnt = reinterpret_cast<int*>(part + 2 * n_all) + 2 * (w.kt * B * G + w.bg) + wg;
    if (tid == 0) m.ticket[wg] = atomicAdd(cnt, 1);
    wg_sync(wg);
    const int first = *reinterpret_cast<volatile int*>(&m.ticket[wg]) == 0;
    wg_sync(wg);  // every thread has read the ticket before the next item's
    if (first) {
      store_rows_f32<D, D>(ws, acc, kp0, sk, quad);
      __threadfence();
      wg_sync(wg);
      if (tid == 0) {
        __threadfence();  // every thread's stores before the 2
        atomicAdd(cnt, 2);
      }
    } else {
      if (tid == 0) spin_until(cnt, 4);
      wg_sync(wg);
      __threadfence();
      add_rows_f32<D>(acc, ws, kp0, sk, quad);
      store_rows<D>(out, acc, kp0, sk, quad, mul);
    }
  }
}

// this thread's quarter (columns [D/4 quad, D/4 quad + D/4)) of rows i
// and i + 8 of a (rows, D) bf16 tensor (rows `row0` + i on; 0 past sq)
template <int D>
__device__ __forceinline__ void quad_rows(uint2 (&x)[2][D / 16], const bf16* t,
                                          size_t row0, int i, int sq, int quad) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint2* p = reinterpret_cast<const uint2*>(t + (row0 + i + 8 * h) * D +
                                                    quad * (D / 4));
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      x[h][j] = i + 8 * h < sq ? p[j] : make_uint2(0u, 0u);
  }
}

// quad_delta with O's quarter rows already loaded (ox, quad_rows) and dO
// from its 64-row tile in shared memory (`tile`: 64-wide blocks in the
// 128-byte swizzle; this thread's rows r, r + 8 of it, its quarter one
// block at D = 256), in quad_delta's order of sums
template <int D>
__device__ __forceinline__ void quad_delta_s(float& d0, float& d1,
                                             const uint2 (&ox)[2][D / 16],
                                             uint32_t tile, float* delta,
                                             size_t row0, int i, int r, int sq,
                                             int quad) {
  static_assert(D == 256, "a quarter row is one 64-wide block");
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = r + 8 * h;
    const uint32_t row = tile + quad * WT * 128 + rr * 128;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {  // 16-byte chunk j / 2, swizzled
      uint2 y;
      asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                   : "=r"(y.x), "=r"(y.y)
                   : "r"(row + ((((j >> 1) ^ rr) & 7) << 4) + (j & 1) * 8));
      const bf16* xe = reinterpret_cast<const bf16*>(&ox[h][j]);
      const bf16* ye = reinterpret_cast<const bf16*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[h] = fmaf(__bfloat162float(ye[e]), __bfloat162float(xe[e]), s[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(FULL, s[h], 1);
    s[h] += __shfl_xor_sync(FULL, s[h], 2);
    if (quad == 0 && i + 8 * h < sq) delta[row0 + i + 8 * h] = s[h];
  }
  d0 = s[0];
  d1 = s[1];
}

// dQ and each row's Delta, 128 q rows an item: warpgroup w owns rows q0 +
// 64 w (their Q and dO stay in the slot, their 128 accumulators are the
// whole width of their dQ) and works out their Delta at the item's start
// (quad_rows, quad_delta_s); the producer streams the item's visible K/V
// rows in stages of 32 (three fit beside the slot), and each warpgroup
// skips the stages its rows cannot see.  tickets (n_tickets ints, or
// null): the dK/dV launch's, zeroed here (that launch runs after this
// one).
__global__ void __launch_bounds__(B256_THREADS, 1)
bwd_dq_wgmma256(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const bf16* __restrict__ o, const bf16* __restrict__ dout,
                const float* __restrict__ lse, bf16* __restrict__ dq,
                float* __restrict__ delta, int* __restrict__ tickets, int n_tickets,
                int B, int H, int G, int sq, int sk, int causal, int window,
                float scale) {
  using L = Bw256Q;
  constexpr int D = L::D, NS = L::NS, KR = L::KR;
  extern __shared__ uint8_t bw_smem[];
  for (int i = blockIdx.x * B256_THREADS + threadIdx.x; i < n_tickets;
       i += gridDim.x * B256_THREADS)
    tickets[i] = 0;
  auto n_items = [&] {
    int b = B;
    asm volatile("" : "+r"(b));
    return (sq + QB - 1) / QB * b * H;
  };
  if (threadIdx.x == 0) {
    const Smem256<L> m(bw_smem);
    mbar_init(m.res_full(), 1);
    mbar_init(m.res_empty(), 8);  // lane 0 of each consumer warp
    for (int s = 0; s < NS; ++s) {
      mbar_init(m.full(s), 1);
      mbar_init(m.empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer: its thread 0 issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      const Smem256<L> m(bw_smem);
      int it = 0;
      for (int n = 0;; ++n) {
        const int item = snake_item(n, n_items());
        if (item < 0) break;
        const DqItem w = dq256_item(item, B * H, sq, sk, causal, window);
        mbar_wait(m.res_empty(), (n & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(m.res_full(), L::SLOT);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tma_tile<D>(m.sbase + c * L::PAIR, &tq, &tq, m.res_full(), w.q0 + WT * c,
                      w.bh);
          tma_tile<D>(m.sbase + c * L::PAIR + L::TILE, &tdo, &tdo, m.res_full(),
                      w.q0 + WT * c, w.bh);
        }
        const int bg = w.bh / H * G + w.bh % H / (H / G);
        for (int i = 0; i < w.n_tiles; ++i, ++it) {
          const int s = it % NS;
          mbar_wait(m.empty(s), ((it / NS) & 1) ^ 1);
          mbar_expect_tx(m.full(s), 2 * L::KTILE);
          const uint32_t st = m.sbase + L::STAGE_OFF + s * 2 * L::KTILE;
          const int k0 = (w.t_begin + i) * KR;
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {  // 32-row boxes of 64 columns
            tma_load_3d(st + c * KR * 128, &tk, m.full(s), 64 * c, k0, bg);
            tma_load_3d(st + L::KTILE + c * KR * 128, &tv, m.full(s), 64 * c, k0, bg);
          }
        }
      }
    }
    return;  // no block-wide barrier follows
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const Smem256<L> m(bw_smem);
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  const int off = sk - sq;
  const float sl2 = scale * LOG2E;
  int it = 0;
  for (int n = 0;; ++n) {
    const int item = snake_item(n, n_items());
    if (item < 0) break;
    const DqItem w = dq256_item(item, B * H, sq, sk, causal, window);
    // this warpgroup's rows and the kv positions they can see
    const int qw0 = w.q0 + WT * wg, rows = min(WT, sq - qw0);
    const int qlo = qw0 + off, qhi = qw0 + rows - 1 + off;
    const int k_begin = window > 0 ? max(0, qlo - window + 1) : 0;
    const int k_end = rows <= 0 ? 0 : causal ? min(sk, qhi + 1) : sk;
    const size_t row0 = (size_t)w.bh * sq;
    // Delta of this thread's rows from O (its loads issued before the wait
    // for the slot) and the slot's dO (read from memory too, as quad_delta
    // reads it, it held the launch up: PERF.md §6)
    uint2 ox[2][D / 16];
    quad_rows<D>(ox, o, row0, qw0 + r0, sq, quad);
    const float L0 = lse2(lse, row0, qw0 + r0, sq);
    const float L1 = lse2(lse, row0, qw0 + r0 + 8, sq);
    const int qp0 = qw0 + r0 + off, qp1 = qp0 + 8;
    mbar_wait(m.res_full(), n & 1);
    const uint32_t qa = m.sbase + wg * L::PAIR, doa = qa + L::TILE;
    float dl0, dl1;
    quad_delta_s<D>(dl0, dl1, ox, doa, delta, row0, qw0 + r0, r0, sq, quad);
    if (w.n_tiles == 0) release(m.res_empty(), lane);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int i = 0; i < w.n_tiles; ++i, ++it) {
      const int s = it % NS;
      const bool last = i + 1 == w.n_tiles;
      mbar_wait(m.full(s), (it / NS) & 1);
      const int k0 = (w.t_begin + i) * KR;
      if (k0 < k_end && k0 + KR > k_begin) {
        const uint32_t kt = m.sbase + L::STAGE_OFF + s * 2 * L::KTILE;
        float sc[KR / 2], dp[KR / 2];
        uint32_t hi[KR / 16][4], lo[KR / 16][4];
        wg_fence();
        ss_tile<D, KR>(sc, qa, WT, 0, kt);               // S = Q K^T
        ss_tile<D, KR>(dp, doa, WT, 0, kt + L::KTILE);   // dP = dO V^T
        wg_commit();
        wg_wait<0>();
        reg_fence<KR / 2>(sc);
        reg_fence<KR / 2>(dp);
        if (last) release(m.res_empty(), lane);  // Q and dO are read
        const bool edge = k0 + KR > sk || (causal && k0 + KR - 1 > qlo) ||
                          (window > 0 && k0 <= qhi - window);
#pragma unroll
        for (int j = 0; j < KR / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            float p = ex2(sc[x] * sl2 - (e < 2 ? L0 : L1));
            if (edge && !visible(e < 2 ? qp0 : qp1, k0 + 8 * j + 2 * quad + (e & 1),
                                 sk, causal, window))
              p = 0.f;
            dp[x] = p * (dp[x] - (e < 2 ? dl0 : dl1));
          }
        split_pieces<KR>(hi, lo, dp);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < KR / 16; ++kk) {  // dQ += dS K: one N = 256 wgmma a piece
          const uint64_t db = gmma_desc_mn(kt + kk * 16 * 128, 128, KR * 128);
          wgmma_rs<D>(acc, hi[kk], db);
          wgmma_rs<D>(acc, lo[kk], db);
        }
        wg_commit();
        wg_wait<0>();
        reg_fence<D / 2>(acc);
      } else if (last) {
        release(m.res_empty(), lane);
      }
      release(m.empty(s), lane);
    }
    store_rows<D>(dq + row0 * D, acc, qw0 + r0, sq, quad, scale);
  }
}

// the two maps of a (heads, rows, W) bf16 tensor, boxes of 64 rows: its
// first column block, then its narrower second one (W = 80, 96; else the
// first again)
template <int W>
int make_maps(CUtensorMap* m, const void* base, int64_t rows, int64_t heads) {
  using C = Cols<W>;
  int e = make_map(&m[0], base, rows, heads, W, C::width(0), WT);
  if (e || !C::TAIL) {
    m[1] = m[0];
    return e;
  }
  return make_map(&m[1], base, rows, heads, W, C::width(1), WT);
}

template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* dq, void* dk,
                     void* dv, float* delta, int64_t B, int64_t H, int64_t G,
                     int64_t sq, int64_t sk, int causal, int window, float scale,
                     cudaStream_t stream) {
  using L = BwTile<D>;
  // q, dO over (B H, Sq, D); k, v over (B G, Sk, D); boxes of 64 rows
  CUtensorMap m[8];
  std::memset(m, 0, sizeof(m));
  int e = make_maps<D>(&m[0], q, sq, B * H);
  if (!e) e = make_maps<D>(&m[2], dout, sq, B * H);
  if (!e) e = make_maps<D>(&m[4], k, sk, B * G);
  if (!e) e = make_maps<D>(&m[6], v, sk, B * G);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
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
  err = cudaFuncSetAttribute(bwd_dkv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  bwd_dkv_wgmma<D><<<n_dkv, BW_THREADS, L::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), (int)B, (int)H, (int)G,
      (int)sq, (int)sk, causal, window, scale);
  return cudaGetLastError();
}

// the pair route (D = 80, 128 and 96 / 64): both kernels persistent, one
// block an SM
template <int D, int DV = D>
int launch_bwd_pair(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* lse, void* dq, void* dk,
                    void* dv, float* delta, int64_t B, int64_t H, int64_t G,
                    int64_t sq, int64_t sk, int causal, int window, float scale,
                    cudaStream_t stream) {
  using LQ = BwPair<D, DV, false>;
  using LK = BwPair<D, DV, true>;
  CUtensorMap m[8];
  std::memset(m, 0, sizeof(m));
  int e = make_maps<D>(&m[0], q, sq, B * H);
  if (!e) e = make_maps<DV>(&m[2], dout, sq, B * H);
  if (!e) e = make_maps<D>(&m[4], k, sk, B * G);
  if (!e) e = make_maps<DV>(&m[6], v, sk, B * G);
  if (e) return e;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_wgmma_pair<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkv_wgmma_pair<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LK::SMEM);
  if (err != cudaSuccess) return err;
  const int64_t n_dq = (sq + QB - 1) / QB * B * H;
  bwd_dq_wgmma_pair<D, DV><<<(unsigned)(n_dq < n_sm ? n_dq : n_sm), BWP_THREADS,
                         LQ::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7],
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      static_cast<bf16*>(dq), delta, (int)B, (int)H, (int)G, (int)sq, (int)sk,
      causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t n_dkv = (sk + QB - 1) / QB * B * G;
  bwd_dkv_wgmma_pair<D, DV><<<(unsigned)(n_dkv < n_sm ? n_dkv : n_sm), BWP_THREADS,
                          LK::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), (int)B, (int)H, (int)G,
      (int)sq, (int)sk, causal, window, scale);
  return cudaGetLastError();
}

// D = 256 (bf16): both kernels persistent, one block an SM; part (2 B G
// Sk D fp32, then the tickets) when an even group splits its heads
int launch_bwd_256(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, void* dq, void* dk, void* dv,
                   float* delta, float* part, int64_t B, int64_t H, int64_t G,
                   int64_t sq, int64_t sk, int causal, int window, float scale,
                   cudaStream_t stream) {
  constexpr int D = 256;
  using LQ = Bw256Q;
  using LK = Bw256;
  // q, dO over (B H, Sq, D); k, v over (B G, Sk, D), boxes of 64 rows;
  // then k and v in boxes of dQ's 32-row stages
  CUtensorMap m[6];
  std::memset(m, 0, sizeof(m));
  int e = make_map(&m[0], q, sq, B * H, D, 64, WT);
  if (!e) e = make_map(&m[1], dout, sq, B * H, D, 64, WT);
  if (!e) e = make_map(&m[2], k, sk, B * G, D, 64, WT);
  if (!e) e = make_map(&m[3], v, sk, B * G, D, 64, WT);
  if (!e) e = make_map(&m[4], k, sk, B * G, D, 64, LQ::KR);
  if (!e) e = make_map(&m[5], v, sk, B * G, D, 64, LQ::KR);
  if (e) return e;
  const bool split = (H / G) % 2 == 0;
  if (split && part == nullptr) return cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dq_wgmma256,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LQ::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_dkv_wgmma256,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, LK::SMEM);
  if (err != cudaSuccess) return err;
  const int64_t n_kt = (sk + WT - 1) / WT;
  int* tickets = split ? reinterpret_cast<int*>(part + 2 * B * G * sk * D) : nullptr;
  const int64_t n_dq = (sq + QB - 1) / QB * B * H;
  bwd_dq_wgmma256<<<(unsigned)(n_dq < n_sm ? n_dq : n_sm), B256_THREADS, LQ::SMEM,
                    stream>>>(
      m[0], m[1], m[4], m[5], static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), delta, tickets,
      split ? (int)(2 * n_kt * B * G) : 0, (int)B, (int)H, (int)G, (int)sq, (int)sk,
      causal, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t n_dkv = n_kt * B * G * (split ? 2 : 1);
  bwd_dkv_wgmma256<<<(unsigned)(n_dkv < n_sm ? n_dkv : n_sm), B256_THREADS,
                     LK::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), split ? part : nullptr, (int)B, (int)H, (int)G,
      (int)sq, (int)sk, causal, window, scale);
  return cudaGetLastError();
}

template <int D, int DV = D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, void* dq, void* dk, void* dv,
               float* delta, int64_t B, int64_t H, int64_t G, int64_t sq,
               int64_t sk, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = bwd_smem<D, DV>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dq<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dkv<D, DV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  constexpr int BT = fp_bt<D>();
  bwd_dq<D, DV><<<dim3((unsigned)((sq + BT - 1) / BT), (unsigned)H, (unsigned)B),
                  NT, smem, stream>>>(
      qt, kt, vt, static_cast<const float*>(o), dot, lse, static_cast<float*>(dq),
      delta, (int)H, (int)G, (int)sq, (int)sk, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkv<D, DV><<<dim3((unsigned)((sk + BT - 1) / BT), (unsigned)G, (unsigned)B),
                   NT, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      (int)H, (int)G, (int)sq, (int)sk, causal, window, scale);
  return cudaGetLastError();
}

// each dtype has one pair of kernels a head dim: fp32 the SIMT pair, bf16
// the one-warpgroup wgmma kernels at D = 32 and 64, the pair route at D =
// 80, 128 and 96 / 64, the D = 256 kernels at 256; v as wide as q/k at
// every built head dim, or MLA's narrow v (96 / 64)
int bwd_by_dim(int D, int DV, int dtype, const void* q, const void* k,
               const void* v, const void* o, const void* dout, const float* lse,
               void* dq, void* dk, void* dv, float* delta, float* part,
               int64_t B, int64_t H, int64_t G, int64_t sq, int64_t sk,
               int causal, int window, float scale, cudaStream_t st) {
  if (DV != D) {
    if (D != 96 || DV != 64) return cudaErrorInvalidValue;
    if (dtype == 0) return launch_bwd<96, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
    if (dtype == 1) return launch_bwd_pair<96, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
    return cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_bwd<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 64: return launch_bwd<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 80: return launch_bwd<80>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 128: return launch_bwd<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 256: return launch_bwd<256>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bwd_wgmma<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 64: return launch_bwd_wgmma<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 80: return launch_bwd_pair<80>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 128: return launch_bwd_pair<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
      case 256: return launch_bwd_256(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, H, G, sq, sk, causal, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// (q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, H, G, Sq, Sk, D, Dv,
//  dtype, causal, window, scale, stream); v, o, dout and dv have head dim
// Dv (= D, or 64 at D = 96); lse is the forward's (B, H, Sq)
// fp32 natural-log log-sum-exp of each row's scaled, masked scores, delta
// (B, H, Sq) fp32 workspace, part the workspace that bf16 at D = 256 needs
// when H / G is even (else unused, may be null): 2 B G Sk D fp32 (the
// first of a kv tile's two blocks' sums), then 2 B G ceil(Sk / 64) int32
// tickets, which the dQ launch zeroes; window <= 0 disables the window
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* delta, void* part, int64_t B, int64_t H, int64_t G, int64_t sq,
    int64_t sk, int D, int DV, int dtype, int causal, int window, float scale,
    void* stream) {
  return bwd_by_dim(D, DV, dtype, q, k, v, o, dout, static_cast<const float*>(lse),
                    dq, dk, dv, static_cast<float*>(delta),
                    static_cast<float*>(part), B, H, G, sq, sk, causal, window,
                    scale, static_cast<cudaStream_t>(stream));
}
