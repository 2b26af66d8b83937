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
//    column block, as the forward does, and q/k at 96 (MLA) a 64-wide and a
//    32-wide one; every kernel is templated on (D, DV): S, dQ and dK are D
//    wide, dP, dV and Delta's rowsum DV wide.  At D = 256 the ring has two
//    stages (64 KB each), dQ takes one block an SM (its 128 accumulators
//    beside S and dP), and dK/dV is bwd_dkv_wgmma2: two consumer
//    warpgroups own a 128-column half of dK and dV each and share S^T and
//    dP^T through shared memory, and an even group's heads split over two
//    blocks a kv tile whose fp32 sums a third launch, bwd_dkv_sum, adds
//    (see there).
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
// the forms timed (PERF.md §6), two one-warpgroup blocks an SM beat one
// block of two warpgroups that share each stage.  Head dims 32, 64, 80,
// 128 and 256 with DV = D, and q/k 96 with v 64.  A query row that sees no key gets zero gradients
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
// dK/dV: each stage's base-2 LSE and Delta), then the barriers.  A pair is
// a q/k tile (D wide) and then a v/dO tile (DV wide).
template <int D, int DV = D>
struct BwTile {
  static constexpr int TILE = WT * D * 2;     // Q or K
  static constexpr int TILE_V = WT * DV * 2;  // V or dO
  static constexpr int PAIR = TILE + TILE_V;
  // stages of the TMA ring: three, two at D = 256 (64 KB a stage)
  static constexpr int NS = D <= 128 ? 3 : 2;
  static constexpr int STAGE_OFF = PAIR;
  static constexpr int ROWS_OFF = STAGE_OFF + NS * PAIR;
  static constexpr int BAR_OFF = ROWS_OFF + NS * 2 * WT * 4;
  // barriers: resident full, full[NS], empty[NS]; 1024 bytes to align the
  // base
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * NS) + 1024;
  // two blocks an SM up to D = 80 and at MLA's 96 / 64 (the dK/dV
  // kernel's 80 accumulators a thread either way): ptxas then holds a
  // thread to 168 registers (two blocks' ten warps put three on one SM
  // sub-partition, of 16,384 registers); from D = 128 one block (up to 255
  // registers: D = 128's dK/dV kernel holds 128 accumulators a thread, D =
  // 256's dQ kernel 128 beside S and dP)
  static constexpr int MIN_BLOCKS = D + DV <= 160 ? 2 : 1;
  static_assert(TILE % 1024 == 0 && TILE_V % 1024 == 0,
                "swizzled blocks must stay 1024-byte aligned");
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
// memory; the producer warp streams the visible K/V tiles.  q/k head dim D,
// v's (o's, dO's) DV.
template <int D, int DV>
__global__ void __launch_bounds__(BW_THREADS, BwTile<D, DV>::MIN_BLOCKS)
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
  using L = BwTile<D, DV>;
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
      tma_tile<DV>(sbase + L::TILE, &tdo0, &tdo1, res_full, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        mbar_wait(empty(s), ((i / NS) & 1) ^ 1);  // round 0 passes at once
        mbar_expect_tx(full(s), L::PAIR);
        const uint32_t dst = sbase + L::STAGE_OFF + s * L::PAIR;
        const int k0 = (t_begin + i) * WT;
        tma_tile<D>(dst, &tk0, &tk1, full(s), k0, b * G + g);
        tma_tile<DV>(dst + L::TILE, &tv0, &tv1, full(s), k0, b * G + g);
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
      const size_t at = ((size_t)bh * sq + q0 + r) * DV + half * (DV / 2);
      const uint4* op = reinterpret_cast<const uint4*>(o + at);
      const uint4* dp = reinterpret_cast<const uint4*>(dout + at);
#pragma unroll
      for (int j = 0; j < DV / 16; ++j) {
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
    ss_tile<DV, WT>(dp, sbase + L::TILE, WT, 0, kt + L::TILE);  // dP = dO V^T
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
template <int D, int DV>
__global__ void __launch_bounds__(BW_THREADS, BwTile<D, DV>::MIN_BLOCKS)
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
  using L = BwTile<D, DV>;
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
      tma_tile<DV>(sbase + L::TILE, &tv0, &tv1, res_full, k0, bg);
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
        tma_tile<DV>(dst + L::TILE, &tdo0, &tdo1, full(s), i0, bh);
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

  float dka[D / 2], dva[DV / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dva[i] = 0.f;
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
    ss_tile<DV, WT>(dpt, sbase + L::TILE, WT, 0, dot);  // dP^T = V dO^T
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
    rs_pieces<DV>(dva, ph, pl, dot);  // dV += P^T dO
    rs_pieces<D>(dka, dh, dl, qt);    // dK += dS^T Q
    wg_commit();
    wg_wait<0>();
    reg_fence<D / 2>(dka);
    reg_fence<DV / 2>(dva);
    release(empty(s), lane);
  }
  store_rows<D>(dk + (size_t)bg * sk * D, dka, kp0, sk, quad, scale);
  store_rows<DV>(dv + (size_t)bg * sk * DV, dva, kp0, sk, quad, 1.f);
}

// D = 256's dK and dV: 128 accumulators a thread of each in one warpgroup
// will not fit, so two consumer warpgroups share a kv tile, each owning a
// 128-column half of dK and dV (64 + 64 accumulators), and a producer
// warpgroup streams Q and dO through a 2-stage ring (one thread issues the
// copies; each of the 128 writes one of the stage's 64 rows' base-2 LSE
// or Delta into shared memory; setmaxnreg hands its registers to the
// consumers).  S^T = K Q^T and dP^T = V dO^T (64 x 64, over all of D) are
// formed once: warpgroup w takes q columns [32 w, 32 w + 32) (wgmma SS, N
// = 32).  Its P^T and dS^T go to shared memory as two bf16 pieces each,
// four 64 x 64 tiles in the 128-byte swizzle a K-major operand reads, and
// both warpgroups then take the whole tiles as the A operand of dV[:,
// half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half] (wgmma SS,
// the streamed tile MN-major).  The 128 accumulators leave too few of the
// 240 registers for S^T and dP^T (ptxas serializes their products and
// spills one while the other forms); the rows in shared memory, in place
// of 16 loads a thread and tile, took 12 % off the launch.  A kv tile's
// work grows with the q tiles that see it (causal: 16 down to 1 at Sq =
// Sk = 1024), and at gemma-2b's shape there are only B G Sk / 64 = 128
// tiles for 132 SMs, so the first tile's block set the launch's time:
// when H / G is even each tile takes two blocks, one a half of the group's
// heads, which store fp32 sums for bwd_dkv_sum to add (two terms add the
// same in either order, so the result stays deterministic); that took the
// launch from 0.80 to 0.47 ms (PERF.md §6).
constexpr int BW2_THREADS = 384;  // two consumer warpgroups, then the producer's

struct Bw256 {
  static constexpr int D = 256;
  static constexpr int TILE = WT * D * 2;            // 32 KB
  static constexpr int NS = 2;                       // stages of Q and dO
  static constexpr int STAGE_OFF = 2 * TILE;         // after K and V
  static constexpr int PIECE = WT * WT * 2;          // a 64 x 64 bf16 tile
  // P^T hi, P^T lo, dS^T hi, dS^T lo
  static constexpr int PIECE_OFF = STAGE_OFF + NS * 2 * TILE;
  // each stage's q rows' base-2 LSE and Delta (fp32), written by the
  // producer warpgroup's 128 threads
  static constexpr int ROWS_OFF = PIECE_OFF + 4 * PIECE;
  static constexpr int BAR_OFF = ROWS_OFF + NS * 2 * WT * 4;
  // barriers: resident full, full[NS], empty[NS]; 1024 bytes to align the
  // base (231,464 bytes of the 232,448 a block can have)
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * NS) + 1024;
  static_assert(PIECE_OFF % 1024 == 0, "swizzled tiles must stay 1024-byte aligned");
};

// byte offset of element (row, col) (col even) in a 64 x 64 bf16 tile laid
// out as TMA's 128-byte swizzle lays it: 128-byte rows, the 16-byte chunk
// index XORed with the row's low three bits
__device__ __forceinline__ uint32_t swz128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// a warpgroup's 64 x 32 fragment x (rows r0, r0 + 8 of each thread,
// columns cw + 8 j + 2 quad + e) -> two bf16 pieces, hi (the rounding) and
// lo (the rounding of the rest), into the swizzled tiles at hi_t and lo_t
__device__ __forceinline__ void put_pieces(uint8_t* hi_t, uint8_t* lo_t,
                                           const float* x, int r0, int cw,
                                           int quad) {
#pragma unroll
  for (int j = 0; j < WT / 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows r0, r0 + 8
      const uint32_t at = swz128(r0 + 8 * h, cw + 8 * j + 2 * quad);
      const float a = x[4 * j + 2 * h], b = x[4 * j + 2 * h + 1];
      const uint32_t hi = pack_bf16(a, b);
      *reinterpret_cast<uint32_t*>(hi_t + at) = hi;
      *reinterpret_cast<uint32_t*>(lo_t + at) =
          pack_bf16(a - __uint_as_float(hi << 16),
                    b - __uint_as_float(hi & 0xffff0000u));
    }
}

__device__ __forceinline__ void pair_sync() {  // both consumer warpgroups
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

__global__ void __launch_bounds__(BW2_THREADS, 1)
bwd_dkv_wgmma2(const __grid_constant__ CUtensorMap tq,
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
  const uint32_t raw = smem_u32(bw_smem);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  uint8_t* pieces_g = bw_smem + (sbase - raw) + L::PIECE_OFF;
  float* rows_s = reinterpret_cast<float*>(bw_smem + (sbase - raw) + L::ROWS_OFF);
  const uint32_t pieces = sbase + L::PIECE_OFF;
  const uint32_t res_full = sbase + L::BAR_OFF;
  auto full = [&](int s) { return res_full + 8u * (1 + s); };
  auto empty = [&](int s) { return res_full + 8u * (1 + NS + s); };

  // block -> (kv tile, b, g, half of the group's heads when it splits):
  // the first kv tiles (seen by the most causal rows) first
  const int hg = H / G, off = sk - sq;
  const int split = part != nullptr ? 2 : 1, hs = (int)blockIdx.x % split;
  const int bg = (int)blockIdx.x / split % (B * G);
  const int k0 = (int)blockIdx.x / split / (B * G) * WT;
  const int b = bg / G, g = bg % G;
  const int h0 = b * H + g * hg + hs * (hg / split);  // this block's first head
  // the q rows that can see a key of this tile, in tiles of 64, per head
  const int kmax = min(sk, k0 + WT) - 1;
  const int i_begin = causal ? max(0, k0 - off) : 0;
  const int i_end = window > 0 ? min(sq, kmax + window - off) : sq;
  const int n_qt = i_end > i_begin ? (i_end - i_begin + WT - 1) / WT : 0;
  const int n_it = hg / split * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1 + 128);  // the copies' byte count, then every
                                    // producer thread (its row value)
      mbar_init(empty(s), 8);       // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer: thread 0 issues every copy, and thread
                  // t writes row t's LSE (t < 64) or Delta of each stage
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      mbar_expect_tx(res_full, 2 * L::TILE);
      tma_tile<D>(sbase, &tk, &tk, res_full, k0, bg);
      tma_tile<D>(sbase + L::TILE, &tv, &tv, res_full, k0, bg);
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % NS;
      const int bh = h0 + it / n_qt;
      const int i0 = i_begin + (it % n_qt) * WT;
      const int i = i0 + pt % WT;
      const float val = pt < WT ? lse2(lse, (size_t)bh * sq, i, sq)
                                : (i < sq ? delta[(size_t)bh * sq + i] : 0.f);
      mbar_wait(empty(s), ((it / NS) & 1) ^ 1);  // round 0 passes at once
      if (pt == 0) {
        mbar_expect_tx(full(s), 2 * L::TILE);
        const uint32_t dst = sbase + L::STAGE_OFF + s * 2 * L::TILE;
        tma_tile<D>(dst, &tq, &tq, full(s), i0, bh);
        tma_tile<D>(dst + L::TILE, &tdo, &tdo, full(s), i0, bh);
      }
      rows_s[s * 2 * WT + pt] = val;
      mbar_arrive(full(s));  // releases this thread's row
    }
    return;  // no block-wide barrier follows
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");

  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int r0 = 16 * warp + lane / 4;  // this thread's kv rows: r0, r0 + 8
  const int kp0 = k0 + r0, kp1 = kp0 + 8;
  const int cw = 32 * wg;               // this warpgroup's q columns of S^T
  const float sl2 = scale * LOG2E;

  // dK[:, 128 wg + ...] and dV[:, ...]: two 64-wide column blocks each
  constexpr int NJ = WT / 16;  // 8-column groups of a 32-column half
  float dka[D / 4], dva[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dka[i] = dva[i] = 0.f;
  float st[WT / 4], dpt[WT / 4];
  mbar_wait(res_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % NS;
    const int i0 = i_begin + (it % n_qt) * WT;
    mbar_wait(full(s), (it / NS) & 1);
    const uint32_t qt = sbase + L::STAGE_OFF + s * 2 * L::TILE, dot = qt + L::TILE;
    wg_fence();
    ss_tile<D, WT / 2>(st, sbase, WT, 0, qt, WT, cw);            // S^T = K Q^T
    ss_tile<D, WT / 2>(dpt, sbase + L::TILE, WT, 0, dot, WT, cw);  // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    reg_fence<WT / 4>(st);
    reg_fence<WT / 4>(dpt);
    // P^T and dS^T on the fragments: rows kv, columns q rows i0 + c
    const float* Ls = rows_s + s * 2 * WT;
    const float* Ds = Ls + WT;
    const bool edge = k0 + WT > sk || (causal && k0 + WT - 1 > i0 + off) ||
                      (window > 0 && k0 <= i0 + WT - 1 + off - window);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e, c = cw + 8 * j + 2 * quad + (e & 1);
        float p = ex2(st[x] * sl2 - Ls[c]);
        if (edge && !visible(i0 + c + off, e < 2 ? kp0 : kp1, sk, causal, window))
          p = 0.f;
        dpt[x] = p * (dpt[x] - Ds[c]);
        st[x] = p;
      }
    pair_sync();  // both warpgroups' products of the last tile read the pieces
    put_pieces(pieces_g, pieces_g + L::PIECE, st, r0, cw, quad);  // P^T
    put_pieces(pieces_g + 2 * L::PIECE, pieces_g + 3 * L::PIECE, dpt, r0, cw,
               quad);                                               // dS^T
    // the pieces, written by the generic proxy, are read by wgmma's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    pair_sync();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < WT / 16; ++kk)
#pragma unroll
      for (int pc = 0; pc < 2; ++pc) {  // hi, then lo
        const uint64_t pa = gmma_desc(pieces + pc * L::PIECE + 32 * kk, 128, false);
        const uint64_t da = gmma_desc(pieces + (2 + pc) * L::PIECE + 32 * kk, 128, false);
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {  // this half's two 64-wide blocks
          const uint32_t blk = (2 * wg + cb) * WT * 128 + kk * 16 * 128;
          wgmma_ss_mn<64>(dva + 32 * cb, pa, gmma_desc(dot + blk, 128, true));
          wgmma_ss_mn<64>(dka + 32 * cb, da, gmma_desc(qt + blk, 128, true));
        }
      }
    wg_commit();
    wg_wait<0>();
    reg_fence<D / 4>(dka);
    reg_fence<D / 4>(dva);
    release(empty(s), lane);
  }
  const size_t at = (size_t)bg * sk * D + 128 * wg;
  if (split == 1) {
    store_rows<D / 2, D>(dk + at, dka, kp0, sk, quad, scale);
    store_rows<D / 2, D>(dv + at, dva, kp0, sk, quad, 1.f);
    return;
  }
  // this half's sums, unscaled, for bwd_dkv_sum: part[0 or 1] dK of head
  // half 0 or 1, part[2 or 3] dV
  const size_t n = (size_t)B * G * sk * D;
  store_rows_f32<D / 2, D>(part + hs * n + at, dka, kp0, sk, quad);
  store_rows_f32<D / 2, D>(part + (2 + hs) * n + at, dva, kp0, sk, quad);
}

// dK = (half 0 + half 1) scale and dV = half 0 + half 1 from
// bwd_dkv_wgmma2's fp32 sums, four values a thread.  Two terms add the
// same in either order, so the result does not depend on which block
// finished first.
__global__ void __launch_bounds__(256)
bwd_dkv_sum(const float4* __restrict__ part, bf16* __restrict__ dk,
            bf16* __restrict__ dv, int64_t n4, float scale) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n4) return;
  const float4 a = part[i], b = part[n4 + i], c = part[2 * n4 + i],
               d = part[3 * n4 + i];
  uint2 k, v;
  k.x = pack_bf16((a.x + b.x) * scale, (a.y + b.y) * scale);
  k.y = pack_bf16((a.z + b.z) * scale, (a.w + b.w) * scale);
  v.x = pack_bf16(c.x + d.x, c.y + d.y);
  v.y = pack_bf16(c.z + d.z, c.w + d.w);
  reinterpret_cast<uint2*>(dk)[i] = k;
  reinterpret_cast<uint2*>(dv)[i] = v;
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

template <int D, int DV = D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, void* dq, void* dk,
                     void* dv, float* delta, float* part, int64_t B, int64_t H,
                     int64_t G, int64_t sq, int64_t sk, int causal, int window,
                     float scale, cudaStream_t stream) {
  using L = BwTile<D, DV>;
  // q, dO over (B H, Sq, D or DV); k, v over (B G, Sk, D or DV); boxes of
  // 64 rows; the odd ones are the narrower second blocks
  CUtensorMap m[8];
  std::memset(m, 0, sizeof(m));
  int e = make_maps<D>(&m[0], q, sq, B * H);
  if (!e) e = make_maps<DV>(&m[2], dout, sq, B * H);
  if (!e) e = make_maps<D>(&m[4], k, sk, B * G);
  if (!e) e = make_maps<DV>(&m[6], v, sk, B * G);
  if (e) return e;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_wgmma<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  const unsigned n_dq = (unsigned)((sq + WT - 1) / WT * B * H);
  bwd_dq_wgmma<D, DV><<<n_dq, BW_THREADS, L::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7],
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
      static_cast<bf16*>(dq), delta, (int)B, (int)H, (int)G, (int)sq, (int)sk,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned n_dkv = (unsigned)((sk + WT - 1) / WT * B * G);
  if constexpr (D == 256) {
    // an even group splits its heads over two blocks a kv tile, summed by
    // bwd_dkv_sum from the fp32 workspace `part` (4 B G Sk D values)
    const bool split = (H / G) % 2 == 0;
    if (split && part == nullptr) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(bwd_dkv_wgmma2,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Bw256::SMEM);
    if (err != cudaSuccess) return err;
    bwd_dkv_wgmma2<<<n_dkv * (split ? 2 : 1), BW2_THREADS, Bw256::SMEM,
                     stream>>>(
        m[0], m[2], m[4], m[6], lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), split ? part : nullptr, (int)B, (int)H,
        (int)G, (int)sq, (int)sk, causal, window, scale);
    if (split) {
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      const int64_t n4 = B * G * sk * D / 4;
      bwd_dkv_sum<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
          reinterpret_cast<const float4*>(part), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), n4, scale);
    }
  } else {
    err = cudaFuncSetAttribute(bwd_dkv_wgmma<D, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return err;
    bwd_dkv_wgmma<D, DV><<<n_dkv, BW_THREADS, L::SMEM, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], m[6], m[7], lse, delta,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), (int)B, (int)H, (int)G,
        (int)sq, (int)sk, causal, window, scale);
  }
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

// each dtype has one pair of kernels: fp32 the SIMT pair, bf16 the wgmma
// pair; v as wide as q/k at every built head dim, or MLA's narrow v (96 / 64)
int bwd_by_dim(int D, int DV, int dtype, const void* q, const void* k,
               const void* v, const void* o, const void* dout, const float* lse,
               void* dq, void* dk, void* dv, float* delta, float* part,
               int64_t B, int64_t H, int64_t G, int64_t sq, int64_t sk,
               int causal, int window, float scale, cudaStream_t st) {
  if (DV != D) {
    if (D != 96 || DV != 64) return cudaErrorInvalidValue;
    if (dtype == 0) return launch_bwd<96, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, G, sq, sk, causal, window, scale, st);
    if (dtype == 1) return launch_bwd_wgmma<96, 64>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, H, G, sq, sk, causal, window, scale, st);
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
      case 32: return launch_bwd_wgmma<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, H, G, sq, sk, causal, window, scale, st);
      case 64: return launch_bwd_wgmma<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, H, G, sq, sk, causal, window, scale, st);
      case 80: return launch_bwd_wgmma<80>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, H, G, sq, sk, causal, window, scale, st);
      case 128: return launch_bwd_wgmma<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, H, G, sq, sk, causal, window, scale, st);
      case 256: return launch_bwd_wgmma<256>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, H, G, sq, sk, causal, window, scale, st);
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
// (B, H, Sq) fp32 workspace, part a 4 B G Sk D fp32 workspace that bf16 at
// D = 256 needs when H / G is even (else unused, may be null); window <= 0
// disables the window
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
