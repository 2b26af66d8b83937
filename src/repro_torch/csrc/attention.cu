// K5 and K6: the attention kernels of the serve path, for sm_90a.
//
// K5 repro_flash_attention replaces the Pallas `flash_attention`
// (src/repro/kernels/flash_attention.py): online-softmax attention of
// q (B, H, Sq, D) over k/v (B, G, Sk, D), GQA heads h -> h / (H / G),
// query row i at position i + Sk - Sq, causal and window masks, fp32
// statistics and accumulator.  On the TPU the kv blocks are the innermost,
// sequential grid axis and the running (m, l, acc) live in VMEM across
// grid steps; here one block owns a tile of query rows of one (b, h) and
// loops over the kv tiles itself, holding (m, l, acc) in registers.  It
// skips the kv tiles that lie wholly above the causal diagonal or wholly
// outside the window (the TPU masks them), and masks k_pos < Sk explicitly
// (the Pallas kernel leaves padded kv columns unmasked when causal is off).
// A query row that sees no key gives 0.  Where the caller asks for it (the
// train path's calls, whose backward takes it), each query row's
// log-sum-exp of its scaled, masked scores goes out too, in natural log
// (-inf for a row that sees no key), from the (m, l) the epilogue holds.
// Bound on the card at the prefill
// shapes: operations at D = 64 (4 B H Sq Sk_eff D on the bf16 tensor
// cores), bytes at D = 80 (q, k, v and o of 32 kv heads).  Each dtype has
// exactly one kernel, picked by the C dispatcher:
//  - bf16 (the serve path): flash_fwd_wgmma.  Both products run on the
//    tensor cores as wgmma with fp32 accumulators.  One persistent block
//    per SM walks work tiles of 128 query rows of one (b, h), longest
//    causal tile first, so the short ones fill the tail.  A producer
//    warpgroup (one thread, registers given away with setmaxnreg) streams
//    each tile's Q and a ring of 2-3 K/V tile stages with TMA (tensor maps
//    over (B*G, Sk, D): rows past Sk arrive as zeros) into 128/64/32-byte
//    swizzled column blocks; mbarriers hand Q (two buffers where they fit:
//    the next tile's Q loads under this one's last products) and the
//    stages over, and the ring runs on from one work tile into the next.
//    Two consumer
//    warpgroups each own 64 rows: S = Q K^T as wgmma m64nBKk16 from shared
//    memory, the online softmax on the accumulator fragment (scale * log2 e
//    folded, exp2, masks only on the tiles that straddle the diagonal, the
//    window edge or Sk), P rounded to bf16 in registers and fed as the A
//    operand of O += P V (V the MN-major B operand), O in fp32 registers.
//    The products of one tile overlap the softmax of the next: a
//    warpgroup issues S_i = Q K_i^T and P_{i-1} V_{i-1}, waits for S_i
//    alone, and runs the softmax of S_i while P_{i-1} V_{i-1} is on the
//    tensor cores.
//    D = 80 takes a 64-wide block with the 128-byte swizzle and a 16-wide
//    one with the 32-byte swizzle; D = 32 the 64-byte swizzle.
//  - fp32: flash_fwd, fp32 FMAs on the CUDA cores.  A tensor-core route
//    would be TF32, which keeps about three decimal digits: the fp32
//    results are held to 2e-5.
//
// K6 repro_decode_attention replaces the Pallas `decode_attention`
// (src/repro/kernels/decode_attention.py): one query token per sequence
// against a KV cache with per-sequence valid `length` (read on the card,
// no host sync) and an optional window (pos >= length - window).  Bound
// on the card: bytes (the cache read once).  Split-K flash-decoding: one
// block of 4-8 warps per (cache chunk, kv group, group of up to 8 query
// heads, b) reads each K/V row once for the heads of its group (the TPU
// kernel's grid (b, h, nk) reloads it per head).  Each warp stages its
// rows unconverted, in the input's type, with 16-byte cp.async into its
// own 3-stage ring and waits on its own copies (no block barrier in the
// loop).  A lane owns a 16-byte slice of a row (D = 80 in bf16: ten lanes
// a row, three rows a warp), the heads' q slices and running (m, l, acc)
// sit in registers, and a score is a shuffle sum over the row's lanes.
// The warps' partials merge in shared memory.  A cache in one chunk
// writes its result there; split into more, each chunk writes fp32
// partials and the last block of each (b, head group) to finish, found
// with an atomic counter, combines them.  Chunks past `length` (or before
// the window) skip the work.  The wrapper splits only as far as half the
// SMs need: each chunk adds a block's start-up and the combine.

// Both take fp32 or bf16 inputs (dtype 0 / 1) with the output in the
// input's type, and head dims 32, 64, 80, 128 and 256.  Every launcher
// returns cudaGetLastError() (0 = success), or cudaErrorInvalidValue when
// a tensor map cannot be made.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;  // hopper.cuh: mbarriers, TMA, wgmma, tensor maps

constexpr float NEG = -1e30f;  // the running max before any key, as on the TPU
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// K5, fp32: fp32 FMAs on the CUDA cores

constexpr int FA_BQ = 64;                  // q rows per block
constexpr int FA_WARPS = 8;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_ROWS = FA_BQ / FA_WARPS;  // q rows per warp

// kv rows per tile: K and V tiles in fp32 stay under ~130 KB of shared memory
template <int D>
__host__ __device__ constexpr int fa_bk() { return D <= 128 ? 64 : 32; }

template <int D>
constexpr size_t fa_smem() {
  // Q [BQ][D] (pre-scaled), K [BK][D + 1] (padded: lanes read rows), V [BK][D]
  return sizeof(float) * (FA_BQ * D + fa_bk<D>() * (D + 1) + fa_bk<D>() * D);
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int H, int G, int sq, int sk, int causal,
          int window, float scale) {
  constexpr int BK = fa_bk<D>();
  constexpr int NC = BK / 32;  // score columns per lane
  constexpr int ND = (D + 31) / 32;  // output dims per lane (the last guarded)
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + FA_BQ * D;
  float* Vs = Ks + BK * (D + 1);

  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q_offset = sk - sq;
  const float* qb = q + ((size_t)b * H + h) * sq * D;
  const float* kb = k + ((size_t)b * G + g) * sk * D;
  const float* vb = v + ((size_t)b * G + g) * sk * D;
  float* ob = o + ((size_t)b * H + h) * sq * D;

  for (int i = threadIdx.x; i < FA_BQ * D; i += FA_THREADS) {
    Qs[i] = q0 + i / D < sq ? qb[(size_t)q0 * D + i] * scale : 0.f;
  }

  // the kv range any row of this tile can see
  const int rows = min(FA_BQ, sq - q0);
  const int qpos_lo = q0 + q_offset, qpos_hi = q0 + rows - 1 + q_offset;
  const int k_end = causal ? min(sk, qpos_hi + 1) : sk;
  const int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][ND];
#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < ND; ++e) acc[r][e] = 0.f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q is written; the last tile's K/V reads are done
    for (int i = threadIdx.x; i < BK * D; i += FA_THREADS) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < sk;
      const size_t gi = (size_t)(k0 + r) * D + c;
      Ks[r * (D + 1) + c] = in ? kb[gi] : 0.f;
      Vs[i] = in ? vb[gi] : 0.f;
    }
    __syncthreads();

    // scores: lane owns columns lane + 32 j of its warp's FA_ROWS rows
    float s[FA_ROWS][NC];
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) kv[j] = Ks[(lane + 32 * j) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < FA_ROWS; ++r) {
        const float qv = Qs[(warp * FA_ROWS + r) * D + d];
#pragma unroll
        for (int j = 0; j < NC; ++j) s[r][j] = fmaf(qv, kv[j], s[r][j]);
      }
    }

    // masks and the online softmax, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < FA_ROWS; ++r) {
      const int qpos = q0 + warp * FA_ROWS + r + q_offset;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int kpos = k0 + lane + 32 * j;
        const bool ok = kpos < sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[r][j] = ok ? s[r][j] : -CUDART_INF_F;
        mx = fmaxf(mx, s[r][j]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));  // finite: >= NEG
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        s[r][j] = expf(s[r][j] - m_new);  // masked: exp(-inf) = 0
        sum += s[r][j];
      }
      l[r] = l[r] * alpha + warp_sum(sum);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < ND; ++e) acc[r][e] *= alpha;
    }

    // acc += P V: column c's probabilities come from lane c % 32
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      for (int cc = 0; cc < 32; ++cc) {
        const float* vrow = Vs + (j * 32 + cc) * D + lane;
        float vv[ND];
#pragma unroll
        for (int e = 0; e < ND; ++e)
          vv[e] = (D % 32 == 0 || lane + 32 * e < D) ? vrow[32 * e] : 0.f;
#pragma unroll
        for (int r = 0; r < FA_ROWS; ++r) {
          const float p = __shfl_sync(FULL, s[r][j], cc);
#pragma unroll
          for (int e = 0; e < ND; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < FA_ROWS; ++r) {
    const int row = q0 + warp * FA_ROWS + r;
    if (row < sq) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no visible key -> 0
#pragma unroll
      for (int e = 0; e < ND; ++e)
        if (D % 32 == 0 || lane + 32 * e < D)
          ob[(size_t)row * D + lane + 32 * e] = acc[r][e] * inv;
      if (lse != nullptr && lane == 0)  // natural log; no visible key: -inf
        lse[((size_t)b * H + h) * sq + row] =
            l[r] > 0.f ? m[r] + logf(l[r]) : -CUDART_INF_F;
    }
  }
}

template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int64_t B, int64_t H, int64_t G, int64_t sq,
                 int64_t sk, int causal, int window, float scale,
                 cudaStream_t stream) {
  constexpr size_t smem = fa_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((sq + FA_BQ - 1) / FA_BQ), (unsigned)H,
                  (unsigned)B);
  flash_fwd<D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, (int)H, (int)G,
      (int)sq, (int)sk, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5, bf16: tensor cores (wgmma), TMA, mbarriers (helpers in hopper.cuh)

constexpr int WG_BQ = 128;       // query rows per block: two warpgroups of 64
constexpr int WG_THREADS = 384;  // two consumer warpgroups + the producer's

template <int D>
struct WgTile {
  static constexpr int BK = D <= 128 ? 128 : 64;  // kv rows per stage
  static constexpr int NS = D <= 128 ? 3 : 2;     // stages in the ring
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  // Q buffers: two where they fit, so the next work tile's Q loads while
  // this one's last products run
  static constexpr int QB = D <= 80 ? 2 : 1;
  static constexpr int KV_BYTES = BK * D * 2;  // K (or V) of one stage
  static constexpr int K_OFF = QB * Q_BYTES;   // stage s: K, then V
  static constexpr int BAR_OFF = K_OFF + NS * 2 * KV_BYTES;
  // barriers: Q full[QB], Q empty[QB], full[NS], empty[NS]; 1024 bytes to
  // align the base
  static constexpr int SMEM = BAR_OFF + 8 * (2 * QB + 2 * NS) + 1024;
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0,
                "swizzled blocks must stay 1024-byte aligned");
};

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq0,
                const __grid_constant__ CUtensorMap tq1,
                const __grid_constant__ CUtensorMap tk0,
                const __grid_constant__ CUtensorMap tk1,
                const __grid_constant__ CUtensorMap tv0,
                const __grid_constant__ CUtensorMap tv1,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int B,
                int H, int G, int sq, int sk, int causal, int window,
                float scale_log2) {
  using L = WgTile<D>;
  using C = Cols<D>;
  constexpr int BK = L::BK, NS = L::NS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  // barriers: Q full[QB], Q empty[QB], then full[NS], empty[NS]
  constexpr int QB = L::QB;
  const uint32_t bars = sbase + L::BAR_OFF;
  auto q_full = [&](int t) { return bars + 8u * (t % QB); };
  auto q_empty = [&](int t) { return bars + 8u * (QB + t % QB); };
  auto q_smem = [&](int t) { return sbase + (t % QB) * L::Q_BYTES; };
  auto full = [&](int s) { return bars + 8u * (2 * QB + s); };
  auto empty = [&](int s) { return bars + 8u * (2 * QB + NS + s); };

  // persistent: block x takes work tiles x, x + gridDim.x, ...; tile j is
  // (query tile n_qt - 1 - j / (B H), (b, h) = j % (B H)), so the longest
  // causal tiles go first and the short ones fill the tail
  const int n_qt = (sq + WG_BQ - 1) / WG_BQ;
  const int n_work = n_qt * B * H;
  const int q_offset = sk - sq;
  int b = 0, h = 0, q0 = 0, qpos_lo = 0, qpos_hi = 0, t_begin = 0, n_tiles = 0;
  auto work = [&](int j) {  // this work tile's (b, h, rows, kv tiles)
    const int bh = j % (B * H);
    b = bh / H;
    h = bh % H;
    q0 = (n_qt - 1 - j / (B * H)) * WG_BQ;
    // the kv range any row of this tile can see, in whole tiles
    const int rows = min(WG_BQ, sq - q0);
    qpos_lo = q0 + q_offset;
    qpos_hi = q0 + rows - 1 + q_offset;
    const int k_end = causal ? min(sk, qpos_hi + 1) : sk;
    const int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;
    t_begin = k_begin / BK;
    n_tiles = k_end > t_begin * BK ? (k_end - t_begin * BK + BK - 1) / BK : 0;
  };

  if (threadIdx.x == 0) {
    for (int t = 0; t < QB; ++t) {
      mbar_init(q_full(t), 1);
      mbar_init(q_empty(t), 8);  // lane 0 of each consumer warp
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every copy; the ring's stages run on
    // across work tiles (kv counts every kv tile this block loaded)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int kv = 0, t = 0;
      for (int j = blockIdx.x; j < n_work; j += gridDim.x, ++t) {
        work(j);
        const int g = h / (H / G);
        if (t >= QB)  // the Q buffer's last work tile is done with it
          mbar_wait(q_empty(t), ((t / QB) - 1) & 1);
        mbar_expect_tx(q_full(t), L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NB; ++c)
          tma_load_3d(q_smem(t) + WG_BQ * 128 * c, c == 1 && D == 80 ? &tq1 : &tq0,
                      q_full(t), 64 * c, q0, b * H + h);
        for (int i = 0; i < n_tiles; ++i, ++kv) {
          const int s = kv % NS;
          mbar_wait(empty(s), ((kv / NS) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(full(s), 2 * L::KV_BYTES);
          const uint32_t kdst = sbase + L::K_OFF + s * 2 * L::KV_BYTES;
          const int k0 = (t_begin + i) * BK;
#pragma unroll
          for (int c = 0; c < C::NB; ++c) {
            const bool tail = c == 1 && D == 80;
            tma_load_3d(kdst + BK * 128 * c, tail ? &tk1 : &tk0, full(s),
                        64 * c, k0, b * G + g);
            tma_load_3d(kdst + L::KV_BYTES + BK * 128 * c, tail ? &tv1 : &tv0,
                        full(s), 64 * c, k0, b * G + g);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, quad = lane % 4;
    // this thread's rows of a work tile's accumulators: r0 and r0 + 8
    const int r0 = wg * 64 + warp * 16 + lane / 4;

    float oacc[D / 2];
    float sc[BK / 2];                         // scores of the newest tile
    uint32_t pa[BK / 16][4], pb[BK / 16][4];  // P of two tiles, bf16 pairs
    float m0, m1, l0, l1;      // l: this thread's columns
    float a0 = 1.f, a1 = 1.f;  // O's rescale owed to the last softmax
    int qp0 = 0, qp1 = 0;      // positions of rows r0, r0 + 8
    int kv0 = 0;               // the block's kv tiles before this work tile
    int t = 0;                 // this block's work tiles before this one

    // S = Q K_i^T (64 x BK), K-major operands; committed, not waited
    auto issue_qk = [&](int i) {
      const int s = (kv0 + i) % NS;
      mbar_wait(full(s), ((kv0 + i) / NS) & 1);
      const uint32_t kt = sbase + L::K_OFF + s * 2 * L::KV_BYTES;
      wg_fence();
      ss_tile<D, BK>(sc, q_smem(t), WG_BQ, wg * 64, kt);
      wg_commit();
    };
    // O = O * alpha + P V_i, V the MN-major operand; committed, not waited
    auto issue_pv = [&](uint32_t (*p)[4], int i) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[4 * j] *= a0;
        oacc[4 * j + 1] *= a0;
        oacc[4 * j + 2] *= a1;
        oacc[4 * j + 3] *= a1;
      }
      const uint32_t vt =
          sbase + L::K_OFF + ((kv0 + i) % NS) * 2 * L::KV_BYTES + L::KV_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) rs_tile<D, BK>(oacc, p[kk], vt, kk);
      wg_commit();
    };
    // the online softmax of tile i's scores: rows r0 (e = 0, 1) and r0 + 8
    // (e = 2, 3), a row's columns spread over the 4 lanes of a quad; P in
    // bf16 straight from the accumulator layout into A fragments
    auto softmax = [&](uint32_t (*p)[4], int i) {
      const int k0 = (t_begin + i) * BK;
      // scale into log2 units; mask only where the tile straddles an edge
      const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qpos_lo) ||
                        (window > 0 && k0 < qpos_hi - window + 1);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * quad + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            const bool ok = kpos < sk && (!causal || kpos <= qp) &&
                            (window <= 0 || kpos > qp - window);
            sc[4 * j + e] = ok ? sc[4 * j + e] * scale_log2 : -CUDART_INF_F;
          }
      } else {
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] *= scale_log2;
      }
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
      a0 = ex2(m0 - mn0);
      a1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j] = ex2(sc[4 * j] - mn0);  // masked: ex2(-inf) = 0
        sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn1);
        ps0 += sc[4 * j] + sc[4 * j + 1];
        ps1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    auto release = [&](uint32_t bar) {  // this warp is done with a buffer
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // tile i: S_i = Q K_i^T and P_{i-1} V_{i-1} run on the tensor cores
    // while the softmax of S_i runs on the CUDA cores
    auto step = [&](uint32_t (*p_prev)[4], uint32_t (*p_new)[4], int i) {
      issue_qk(i);
      issue_pv(p_prev, i - 1);
      wg_wait<1>();  // S_i (the older group) is done
      reg_fence<BK / 2>(sc);
      softmax(p_new, i);
      wg_wait<0>();  // P_{i-1} V_{i-1} is done
      reg_fence<D / 2>(oacc);
      release(empty((kv0 + i - 1) % NS));
    };

    for (int j = blockIdx.x; j < n_work; j += gridDim.x, ++t) {
      work(j);
      qp0 = q0 + r0 + q_offset;
      qp1 = qp0 + 8;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
      m0 = m1 = NEG;
      l0 = l1 = 0.f;
      mbar_wait(q_full(t), (t / QB) & 1);
      if (n_tiles > 0) {
        issue_qk(0);
        wg_wait<0>();
        reg_fence<BK / 2>(sc);
        softmax(pa, 0);
        // tile i's P lands in pa for even i, in pb for odd i
        for (int i = 1; i < n_tiles; i += 2) {
          step(pa, pb, i);
          if (i + 1 < n_tiles) step(pb, pa, i + 1);
        }
        if ((n_tiles - 1) & 1)
          issue_pv(pb, n_tiles - 1);
        else
          issue_pv(pa, n_tiles - 1);
        wg_wait<0>();
        reg_fence<D / 2>(oacc);
        release(empty((kv0 + n_tiles - 1) % NS));
      }
      release(q_empty(t));  // the producer may refill this Q buffer
      kv0 += n_tiles;

      l0 += __shfl_xor_sync(FULL, l0, 1);
      l0 += __shfl_xor_sync(FULL, l0, 2);
      l1 += __shfl_xor_sync(FULL, l1, 1);
      l1 += __shfl_xor_sync(FULL, l1, 2);
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // no visible key -> 0
      const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      const int row0 = q0 + r0, row1 = row0 + 8;
      __nv_bfloat16* ob = o + (size_t)(b * H + h) * sq * D;
      if (lse != nullptr && quad == 0) {  // natural log; no visible key: -inf
        float* lb = lse + (size_t)(b * H + h) * sq;
        if (row0 < sq) lb[row0] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : -CUDART_INF_F;
        if (row1 < sq) lb[row1] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : -CUDART_INF_F;
      }
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * quad;
        if (row0 < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * D + col) =
              __floats2bfloat162_rn(oacc[4 * jj] * inv0,
                                    oacc[4 * jj + 1] * inv0);
        if (row1 < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * D + col) =
              __floats2bfloat162_rn(oacc[4 * jj + 2] * inv1,
                                    oacc[4 * jj + 3] * inv1);
      }
    }
  }
}

template <int D>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int64_t B, int64_t H, int64_t G, int64_t sq,
                       int64_t sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  using L = WgTile<D>;
  constexpr int w0 = Cols<D>::width(0);
  CUtensorMap m[6];
  std::memset(m, 0, sizeof(m));
  int e;
  if ((e = make_map(&m[0], q, sq, B * H, D, w0, WG_BQ))) return e;
  if ((e = make_map(&m[2], k, sk, B * G, D, w0, L::BK))) return e;
  if ((e = make_map(&m[4], v, sk, B * G, D, w0, L::BK))) return e;
  if (D == 80) {  // the 16-wide second block
    if ((e = make_map(&m[1], q, sq, B * H, D, 16, WG_BQ))) return e;
    if ((e = make_map(&m[3], k, sk, B * G, D, 16, L::BK))) return e;
    if ((e = make_map(&m[5], v, sk, B * G, D, 16, L::BK))) return e;
  } else {
    m[1] = m[0];
    m[3] = m[2];
    m[5] = m[4];
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (err != cudaSuccess) return err;
  // one resident block per SM walks the work tiles
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int64_t n_work = (sq + WG_BQ - 1) / WG_BQ * B * H;
  const unsigned grid = (unsigned)(n_work < sms ? n_work : sms);
  flash_fwd_wgmma<D><<<grid, WG_THREADS, L::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], m[4], m[5], static_cast<__nv_bfloat16*>(o), lse,
      (int)B, (int)H, (int)G, (int)sq, (int)sk, causal, window,
      scale * LOG2E);
  return cudaGetLastError();
}

// each dtype has one kernel: fp32 the SIMT one, bf16 the wgmma one
int flash_by_dim(int D, int dtype, const void* q, const void* k,
                 const void* v, void* o, float* lse, int64_t B, int64_t H, int64_t G,
                 int64_t sq, int64_t sk, int causal, int window, float scale,
                 cudaStream_t st) {
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_flash<32>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      case 64: return launch_flash<64>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      case 80: return launch_flash<80>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      case 128: return launch_flash<128>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      case 256: return launch_flash<256>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_flash_wgmma<32>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      case 64: return launch_flash_wgmma<64>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      case 80: return launch_flash_wgmma<80>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      case 128: return launch_flash_wgmma<128>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      case 256: return launch_flash_wgmma<256>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K6 decode attention

// warps per block: 4, or up to 16 (decode_attention.py picks) when the
// heads of a block fit in 128 registers a thread
template <int HGP>
__host__ __device__ constexpr int da_max_threads() {
  return HGP <= 4 ? 512 : 128;
}
constexpr int DA_STAGES = 3;  // cp.async ring per warp
constexpr int DA_MAX_CHUNKS = 256;  // chunks per cache (decode_attention.py)

// cache rows a warp stages per step (~2 KB of K and of V in bf16); a
// block's step is its warps times this (TILE_ROWS in decode_attention.py:
// 4 warps)
template <int D>
__host__ __device__ constexpr int da_warp_rows() {
  return D == 32 ? 32 : D == 64 ? 16 : D == 80 ? 12 : D == 128 ? 8 : 4;
}

// A lane owns E consecutive elements (16 bytes; 32 for fp32 at D = 256) of
// a row; NS lanes make a row, a warp reads RPW rows at once.
template <typename T, int D>
struct DaGeom {
  static constexpr int ROW_BYTES = D * (int)sizeof(T);
  static constexpr int VPL = (ROW_BYTES / 16 + 31) / 32;  // 16-byte vectors
  static constexpr int E = VPL * 16 / (int)sizeof(T);
  static constexpr int NS = D / E;
  static constexpr int RPW = 32 / NS;
  static constexpr int WR = da_warp_rows<D>();
  static constexpr int STAGE_BYTES = 2 * WR * ROW_BYTES;  // K rows, V rows
  static_assert(D % E == 0 && NS <= 32 && WR % RPW == 0, "lane mapping");
};

template <typename T, int D, int HGP>
size_t da_smem(int warps) {
  using Gm = DaGeom<T, D>;
  const size_t ring = (size_t)warps * DA_STAGES * Gm::STAGE_BYTES;
  // the block's partials (m, l, acc) of each row group, merged at the end
  const size_t merge =
      sizeof(float) * (warps * Gm::RPW * HGP * (D + 2) + 2 * HGP);
  const size_t combine = sizeof(float) * (2 * HGP * DA_MAX_CHUNKS + HGP);
  const size_t most = ring > merge ? ring : merge;
  return most > combine ? most : combine;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// E elements of type T at p (shared memory, 16-byte aligned) as floats
template <typename T, int E>
__device__ __forceinline__ void load_row_slice(const uint8_t* p, float* f) {
#pragma unroll
  for (int u = 0; u < E * (int)sizeof(T) / 16; ++u) {
    const uint4 w = *reinterpret_cast<const uint4*>(p + 16 * u);
    if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 x = __bfloat1622float2(h[j]);
        f[8 * u + 2 * j] = x.x;
        f[8 * u + 2 * j + 1] = x.y;
      }
    } else {
      f[4 * u] = __uint_as_float(w.x);
      f[4 * u + 1] = __uint_as_float(w.y);
      f[4 * u + 2] = __uint_as_float(w.z);
      f[4 * u + 3] = __uint_as_float(w.w);
    }
  }
}

// the sum of x over the NS lanes of this lane's row group (sl = its index
// in the group), on every lane of the group: a butterfly when NS is a
// power of 2, else a tree down to the group's first lane and a broadcast
template <int NS>
__device__ __forceinline__ float row_sum(float x, int lane, int sl) {
  if constexpr ((NS & (NS - 1)) == 0) {
#pragma unroll
    for (int off = NS / 2; off > 0; off >>= 1)
      x += __shfl_xor_sync(FULL, x, off);
    return x;
  } else {
#pragma unroll
    for (int off = 1; off < NS; off <<= 1) {
      const float t = __shfl_down_sync(FULL, x, off);
      if ((sl & (2 * off - 1)) == 0 && sl + off < NS) x += t;
    }
    return __shfl_sync(FULL, x, lane - sl);
  }
}

template <typename T, int D, int HGP>
__global__ void __launch_bounds__(da_max_threads<HGP>())
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ length,
               T* __restrict__ o, float* __restrict__ pm,
               float* __restrict__ pl, float* __restrict__ pacc,
               int* __restrict__ counters, int H, int G, int S, int chunk,
               int nch, int window, float scale_log2) {
  using Gm = DaGeom<T, D>;
  constexpr int E = Gm::E, NS = Gm::NS, RPW = Gm::RPW, WR = Gm::WR;
  constexpr int RB = Gm::ROW_BYTES, NP = WR / RPW;  // NP: rows a lane takes per step
  const int c = blockIdx.x, b = blockIdx.z;
  const int hg = H / G;
  const int nhp = (hg + HGP - 1) / HGP;  // head groups of this kv group
  const int g = blockIdx.y / nhp, hp = blockIdx.y % nhp;
  const int h0 = g * hg + hp * HGP;  // first query head of this block
  const int nh = min(HGP, hg - hp * HGP);
  extern __shared__ __align__(16) uint8_t dsmem[];

  const int len = min(length[b], S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int c1 = min(min((c + 1) * chunk, S), len);
  const int start = max(c * chunk, lo);
  if (start >= c1) {  // no visible position in this chunk: weight 0
    if (nch == 1) {  // no visible position at all: 0
      for (int idx = threadIdx.x; idx < nh * D; idx += blockDim.x)
        o[((size_t)b * H + h0) * D + idx] = from_f<T>(0.f);
      return;
    }
    if (threadIdx.x < nh) {
      const size_t idx = ((size_t)b * H + h0 + threadIdx.x) * nch + c;
      pm[idx] = NEG;
      pl[idx] = 0.f;
    }
  } else {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rr = lane / NS, sl = lane % NS;  // rr >= RPW: an idle lane
  const bool active = rr < RPW;
  float qv[HGP][E], acc[HGP][E], m[HGP], l[HGP];
#pragma unroll
  for (int i = 0; i < HGP; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    const bool use = active && i < nh;
    const T* qr = q + ((size_t)b * H + h0 + i) * D + sl * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qv[i][e] = use ? to_f(qr[e]) * scale_log2 : 0.f;
      acc[i][e] = 0.f;
    }
  }

  // warp w of nw takes the steps of WR rows at start + (t nw + w) WR
  const int nw = blockDim.x >> 5;
  const int first = start + warp * WR;
  const int nsteps = first < c1 ? (c1 - first + nw * WR - 1) / (nw * WR) : 0;
  uint8_t* ring = dsmem + (size_t)warp * DA_STAGES * Gm::STAGE_BYTES;
  const T* kb = k + ((size_t)b * G + g) * S * D;
  const T* vb = v + ((size_t)b * G + g) * S * D;
  auto issue = [&](int t) {  // an empty group past the last step
    if (t < nsteps) {
      const int r0 = first + t * nw * WR;
      uint8_t* dst = ring + (t % DA_STAGES) * Gm::STAGE_BYTES;
#pragma unroll
      for (int i = lane; i < WR * RB / 16; i += 32) {
        const int r = i / (RB / 16), off = (i % (RB / 16)) * 16;
        const bool in = r0 + r < c1;  // rows past the chunk read as 0
        const size_t row = (size_t)(in ? r0 + r : start) * D;
        cp_async16(dst + 16 * i, reinterpret_cast<const uint8_t*>(kb + row) + off, in);
        cp_async16(dst + WR * RB + 16 * i,
                   reinterpret_cast<const uint8_t*>(vb + row) + off, in);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < DA_STAGES - 1; ++t) issue(t);

  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<DA_STAGES - 2>();  // this lane's copies of step t landed
    __syncwarp();                    // ... and every lane's
    const uint8_t* st = ring + (t % DA_STAGES) * Gm::STAGE_BYTES;
    const int r0 = first + t * nw * WR;
    // the step's NP rows of this lane: scores first (independent), then
    // one rescale per head and step
    float sp[HGP][NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float kf[E];
      if (active) {
        load_row_slice<T, E>(st + (p * RPW + rr) * RB + sl * E * sizeof(T), kf);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < HGP; ++i) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qv[i][e], kf[e], part);
        sp[i][p] = part;
      }
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const bool ok = active && r0 + p * RPW + rr < c1;
#pragma unroll
      for (int i = 0; i < HGP; ++i) {
        const float x = row_sum<NS>(sp[i][p], lane, sl);
        sp[i][p] = ok ? x : -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int i = 0; i < HGP; ++i) {
      float mx = sp[i][0];
#pragma unroll
      for (int p = 1; p < NP; ++p) mx = fmaxf(mx, sp[i][p]);
      const float mn = fmaxf(m[i], mx);  // finite: >= NEG
      const float a = ex2(m[i] - mn);
      m[i] = mn;
      l[i] *= a;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= a;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float vf[E];
      if (active) {
        load_row_slice<T, E>(st + WR * RB + (p * RPW + rr) * RB + sl * E * sizeof(T), vf);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) vf[e] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < HGP; ++i) {
        const float pr = ex2(sp[i][p] - m[i]);  // rows past c1: 0
        l[i] += pr;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pr, vf[e], acc[i][e]);
      }
    }
    __syncwarp();  // every lane has read the stage before it is refilled
    issue(t + DA_STAGES - 1);
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: reuse them for the merge

  // a warp's row groups merge by shuffles where they sit at power-of-2
  // lane offsets; then the block's P partials merge in shared memory
  constexpr bool WARP_MERGE = (NS & (NS - 1)) == 0 && RPW > 1;
  if constexpr (WARP_MERGE) {
#pragma unroll
    for (int off = NS; off < NS * RPW; off <<= 1) {
#pragma unroll
      for (int i = 0; i < HGP; ++i) {
        const float mo = __shfl_xor_sync(FULL, m[i], off);
        const float lo = __shfl_xor_sync(FULL, l[i], off);
        const float mn = fmaxf(m[i], mo);
        const float wa = ex2(m[i] - mn), wb = ex2(mo - mn);
        l[i] = l[i] * wa + lo * wb;
        m[i] = mn;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[i][e] = acc[i][e] * wa + __shfl_xor_sync(FULL, acc[i][e], off) * wb;
      }
    }
  }
  const int P = WARP_MERGE ? nw : nw * RPW;
  float* sm_m = reinterpret_cast<float*>(dsmem);
  float* sm_l = sm_m + P * HGP;
  float* sm_acc = sm_l + P * HGP;
  if (active && (!WARP_MERGE || rr == 0)) {
    const int pidx = WARP_MERGE ? warp : warp * RPW + rr;
#pragma unroll
    for (int i = 0; i < HGP; ++i) {
      if (sl == 0) {
        sm_m[pidx * HGP + i] = m[i];
        sm_l[pidx * HGP + i] = l[i];
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        sm_acc[(pidx * HGP + i) * D + sl * E + e] = acc[i][e];
    }
  }
  __syncthreads();
  float* sm_stat = sm_acc + P * HGP * D;  // per head: M, 1 / L
  if (threadIdx.x < nh) {  // each row group's weight exp2(m - M) in sm_m
    const int i = threadIdx.x;
    float M = NEG;
    for (int p = 0; p < P; ++p)
      if (sm_l[p * HGP + i] > 0.f) M = fmaxf(M, sm_m[p * HGP + i]);
    float L = 0.f;
    for (int p = 0; p < P; ++p) {
      const float lp = sm_l[p * HGP + i];  // 0: the group saw no row
      const float w = lp > 0.f ? exp2f(sm_m[p * HGP + i] - M) : 0.f;
      sm_m[p * HGP + i] = w;
      L += lp * w;
    }
    sm_stat[2 * i] = M;
    sm_stat[2 * i + 1] = L;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nh * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    float A = 0.f;
    for (int p = 0; p < P; ++p)
      A = fmaf(sm_m[p * HGP + i], sm_acc[(p * HGP + i) * D + d], A);
    const float L = sm_stat[2 * i + 1];
    if (nch == 1) {  // the one chunk: the result itself
      o[((size_t)b * H + h0 + i) * D + d] = from_f<T>(L > 0.f ? A / L : 0.f);
      continue;
    }
    const size_t hidx = ((size_t)b * H + h0 + i) * nch + c;
    pacc[hidx * D + d] = A;
    if (d == 0) {
      pm[hidx] = sm_stat[2 * i];
      pl[hidx] = L;
    }
  }
  }
  if (nch == 1) return;

  // the last block of this (b, head group) to finish combines the chunks
  // (the counter, zero before the launch, is zero again after it)
  __shared__ int ticket;
  __syncthreads();  // the block's partials are written (block order) ...
  int* counter = counters + (size_t)b * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) {
    __threadfence();  // ... and visible on the card before the ticket
    ticket = atomicAdd(counter, 1);
    __threadfence();  // the last block sees every other block's partials
  }
  __syncthreads();
  if (ticket != nch - 1) return;
  // every chunk's (m, l) of this block's heads into shared memory (the
  // other blocks wrote them: read through L2), then each head's weights
  float* cm = reinterpret_cast<float*>(dsmem);  // [nh][nch]: m, then weight
  float* cl = cm + HGP * DA_MAX_CHUNKS;          // [nh][nch]: l
  float* cinv = cl + HGP * DA_MAX_CHUNKS;        // [nh]: 1 / L
  for (int idx = threadIdx.x; idx < nh * nch; idx += blockDim.x) {
    const size_t g_idx = ((size_t)b * H + h0) * nch + idx;
    cm[idx] = __ldcg(pm + g_idx);
    cl[idx] = __ldcg(pl + g_idx);
  }
  __syncthreads();
  if (threadIdx.x < nh) {
    const int i = threadIdx.x;
    float M = NEG;
    for (int cc = 0; cc < nch; ++cc)
      if (cl[i * nch + cc] > 0.f) M = fmaxf(M, cm[i * nch + cc]);
    float L = 0.f;
    for (int cc = 0; cc < nch; ++cc) {
      const float lc = cl[i * nch + cc];  // an empty chunk wrote no acc
      const float w = lc > 0.f ? exp2f(cm[i * nch + cc] - M) : 0.f;
      cm[i * nch + cc] = w;
      L += lc * w;
    }
    cinv[i] = L > 0.f ? 1.f / L : 0.f;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nh * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    const float* pa = pacc + ((size_t)b * H + h0 + i) * nch * D + d;
    float a = 0.f;
#pragma unroll 8
    for (int cc = 0; cc < nch; ++cc) {
      const float x = __ldcg(pa + (size_t)cc * D);  // unwritten when w == 0
      const float w = cm[i * nch + cc];
      a += w > 0.f ? x * w : 0.f;
    }
    o[((size_t)b * H + h0 + i) * D + d] = from_f<T>(a * cinv[i]);
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <typename T, int D, int HGP>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* length, void* o, float* pm, float* pl,
                  float* pacc, int* counters, int64_t B, int64_t H, int64_t G, int64_t S,
                  int chunk, int nch, int warps, int window, float scale,
                  cudaStream_t stream) {
  if (nch > DA_MAX_CHUNKS || warps < 1 || 32 * warps > da_max_threads<HGP>())
    return cudaErrorInvalidValue;
  const size_t smem = da_smem<T, D, HGP>(warps);
  cudaError_t e = cudaFuncSetAttribute(
      decode_partial<T, D, HGP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const int64_t nhp = (H / G + HGP - 1) / HGP;
  decode_partial<T, D, HGP>
      <<<dim3((unsigned)nch, (unsigned)(G * nhp), (unsigned)B), 32 * warps,
         smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), length, static_cast<T*>(o),
                         pm, pl, pacc, counters, (int)H, (int)G, (int)S,
                         chunk, nch, window, scale * LOG2E);
  return cudaGetLastError();
}

// heads of a kv group held in registers per block: 1, 2, 3, 4 or 8
template <typename T, int D>
int decode_by_heads(const void* q, const void* k, const void* v,
                    const int* length, void* o, float* pm, float* pl,
                    float* pacc, int* counters, int64_t B, int64_t H, int64_t G, int64_t S,
                    int chunk, int nch, int warps, int window, float scale,
                    cudaStream_t st) {
  const int64_t hg = H / G;
  if (hg <= 1) return launch_decode<T, D, 1>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, st);
  if (hg <= 2) return launch_decode<T, D, 2>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, st);
  if (hg <= 3) return launch_decode<T, D, 3>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, st);
  if (hg <= 4) return launch_decode<T, D, 4>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, st);
  return launch_decode<T, D, 8>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, st);
}

template <typename T>
int decode_by_dim(int D, const void* q, const void* k, const void* v,
                  const int* length, void* o, float* pm, float* pl,
                  float* pacc, int* counters, int64_t B, int64_t H, int64_t G, int64_t S,
                  int chunk, int nch, int warps, int window, float scale,
                  cudaStream_t stream) {
  switch (D) {
    case 32: return decode_by_heads<T, 32>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, stream);
    case 64: return decode_by_heads<T, 64>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, stream);
    case 80: return decode_by_heads<T, 80>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, stream);
    case 128: return decode_by_heads<T, 128>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, stream);
    case 256: return decode_by_heads<T, 256>(q, k, v, length, o, pm, pl, pacc, counters, B, H, G, S, chunk, nch, warps, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// (q, k, v, o, lse, B, H, G, Sq, Sk, D, dtype, causal, window, scale,
// stream); lse is null or (B, H, Sq) fp32, each query row's natural-log
// log-sum-exp of its scaled, masked scores (-inf where it sees no key);
// window <= 0 disables the window
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int64_t B, int64_t H, int64_t G,
                                     int64_t sq, int64_t sk, int D, int dtype,
                                     int causal, int window, float scale,
                                     void* stream) {
  return flash_by_dim(D, dtype, q, k, v, o, static_cast<float*>(lse), B, H, G,
                      sq, sk, causal, window, scale,
                      static_cast<cudaStream_t>(stream));
}

// (q, k, v, length, o, part_m, part_l, part_acc, counters, B, H, G, S, D,
//  dtype, chunk, n_chunks, warps, window, scale, stream); part_m/part_l are (B, H,
// n_chunks) fp32 scratch, part_acc (B, H, n_chunks, D), counters B H int32
// zeros (zero again when the launch ends; one set per stream)
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* length,
                                      void* o, void* pm, void* pl, void* pacc,
                                      void* counters, int64_t B, int64_t H, int64_t G,
                                      int64_t S, int D, int dtype, int chunk,
                                      int nch, int warps, int window,
                                      float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  float* acc = static_cast<float*>(pacc);
  int* cnt = static_cast<int*>(counters);
  if (dtype == 0)
    return decode_by_dim<float>(D, q, k, v, len, o, m, l, acc, cnt, B, H, G, S, chunk, nch, warps, window, scale, st);
  if (dtype == 1)
    return decode_by_dim<__nv_bfloat16>(D, q, k, v, len, o, m, l, acc, cnt, B, H, G, S, chunk, nch, warps, window, scale, st);
  return cudaErrorInvalidValue;
}
