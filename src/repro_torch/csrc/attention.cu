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
// cores), bytes at D = 80 (q, k, v and o of 32 kv heads).  The C
// dispatcher picks the kernel by dtype (bf16's route by head dim):
//  - bf16 (the serve path): flash_fwd_wgmma at D <= 96.  Both products
//    run on the tensor cores as wgmma with fp32 accumulators.  One persistent block
//    per SM walks work tiles of 128 query rows of one (b, h): head by
//    head (a head's query tiles one after another, so that the blocks in
//    flight share its K and V in L2) in a snake order over the grid that
//    pairs a long causal tile with a short one on each block, where K and
//    V outgrow the L2; else the longest causal tiles of every head first,
//    so the short ones fill the tail.  A producer
//    warpgroup (one thread, registers given away with setmaxnreg) streams
//    each tile's Q and a ring of 3 K/V tile stages with TMA (tensor maps
//    over (B*G, Sk, D): rows past Sk arrive as zeros) into 128/64/32-byte
//    swizzled column blocks; mbarriers hand Q (two buffers: the next
//    tile's Q loads under this one's last products) and the stages over,
//    and the ring runs on from one work tile into the next.
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
//    At D = 128 and 256 the split route flash_fwd_wgmma_split runs the
//    same blocks, kv tiles of 128 rows (64 at 256) in a ring of two, with
//    two changes, each measured on an H100 against the route above at
//    those head dims: a stage's K and V on barriers of their own (K_i is
//    freed with V_{i-1}, a step before its stage's V, so that the ring
//    loads the next tile's K and V under this tile's products: with one
//    barrier pair a stage, the K of each tile at D = 256 was loaded only
//    once it was due); and O leaves through the work tile's
//    own Q buffer, written in Q's swizzled layout and stored by TMA boxes
//    of whole 128-byte rows (the 4-byte stores from registers took about
//    a fifth of the time at D = 256), the Q buffer freed once the boxes
//    have read it (two Q buffers at D = 128, so that the next work tile's
//    Q loads meanwhile).  Multicasting each K/V stage to a cluster of two
//    blocks on two query heads of a kv group halved the L2 reads but ran
//    1.2-1.5x slower, its no-math skeleton too.
//    flash_fwd_wgmma and flash_fwd are templated on (D, DV), v's and the
//    output's head dim:
//    DV = D at every head dim, and MLA's prefill (minicpm3-4b) at q/k
//    D = 96 (a 64-wide block with the 128-byte swizzle, then a 32-wide one
//    with the 64-byte swizzle) and v DV = 64: a stage holds K at 96 and V
//    at 64 columns, P V is a 64-wide product and O 64 fp32 columns.
//  - fp32: flash_fwd, fp32 FMAs on the CUDA cores.  A tensor-core route
//    would be TF32, which keeps about three decimal digits: the fp32
//    results are held to 2e-5.
//
// K6 repro_decode_attention replaces the Pallas `decode_attention`
// (src/repro/kernels/decode_attention.py): one query token per sequence
// against a KV cache with per-sequence valid `length` (read on the card,
// no host sync) and an optional window (pos >= length - window).  Bound
// on the card: bytes (the cache read once; its operations, 4 B H L D,
// take 1/37 of the bytes' time on the bf16 tensor cores at gemma-2b's
// decode).  Split-K flash-decoding: one block per (cache chunk, kv group,
// b) reads each K/V row once for the heads of its group (the TPU kernel's
// grid (b, h, nk) reloads it per head).  A cache in one chunk writes its result there;
// split into more, each chunk writes fp32 partials and the last block of
// each (b, head group) to finish, found with an atomic counter, combines
// them.  Chunks past `length` (or before the window) skip the work.  The
// C entry picks one of two kernels (decode_mma_route; decode_attention.py
// mirrors it in decode_route):
//  - bf16 at D = 128 and 256 with 4-8 query heads a kv group (gemma-2b's
//    8 over one kv head of 256, chameleon-34b's and mixtral-8x22b's 8 and
//    6 of 128): decode_mma.  On the ring below these groups cost a 5-level
//    shuffle sum per score and 8 x 8 FMAs per row and head on the CUDA
//    cores, ~1,100 instructions a warp per 4 KB of K/V at D = 256, at one
//    warp per sub-partition: 9.0x the byte bound at gemma-2b's decode on
//    an H100.
//    Here the scores and P V run on the tensor cores as mma.sync m16n8k16
//    with the group's heads as N = 8 (S^T = K Q^T, O^T += V^T P^T; ~160
//    instructions a warp per 16-row slice, 16 KB of K/V at D = 256, where
//    the ring spends ~4,400), and each warp's lane 0 loads 16-row slices
//    of K and V by TMA (64-column boxes, 128-byte swizzle: conflict-free
//    ldmatrix) into a ring of its own, 192 KB a block, so that a block
//    has its whole chunk in flight at gemma-2b's decode.  The
//    grid is one wave of one block an SM (on an H100 a second wave of 12
//    blocks took 1.33x as long there); the last block's combine merges each chunk's (m, l,
//    acc) in registers in one pass over L2.
//  - every other call, fp32 among them (a tensor-core form would be TF32;
//    fp32 is held to 2e-5): decode_partial, one block of 4-8 warps per
//    (chunk, kv group, group of up to 8 query heads, b).  Each warp stages
//    its rows unconverted, in the input's type, with 16-byte cp.async into
//    its own 3-stage ring and waits on its own copies (no block barrier in
//    the loop).  A lane owns a 16-byte slice of a row (D = 80 in bf16: ten
//    lanes a row, three rows a warp), the heads' q slices and running (m,
//    l, acc) sit in registers, and a score is a shuffle sum over the row's
//    lanes.  The warps' partials merge in shared memory.  The wrapper
//    splits only as far as half the SMs need: each chunk adds a block's
//    start-up and the combine.  With 1-3 heads a group, or narrow heads, a
//    score is a short shuffle sum and the ring stays within 1.04-1.11x
//    SDPA on an H100 (smollm-360m, zamba2-2.7b).

// Both take fp32 or bf16 inputs (dtype 0 / 1) with the output in the
// input's type, and head dims 32, 64, 80, 128 and 256; K5 also q/k 96
// with v 64.  Every launcher
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

template <int D, int DV>
constexpr size_t fa_smem() {
  // Q [BQ][D] (pre-scaled), K [BK][D + 1] (padded: lanes read rows), V [BK][DV]
  return sizeof(float) * (FA_BQ * D + fa_bk<D>() * (D + 1) + fa_bk<D>() * DV);
}

// q/k head dim D, v and output head dim DV (DV = D but for MLA's 96 / 64)
template <int D, int DV>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int H, int G, int sq, int sk, int causal,
          int window, float scale) {
  constexpr int BK = fa_bk<D>();
  constexpr int NC = BK / 32;  // score columns per lane
  constexpr int ND = (DV + 31) / 32;  // output dims per lane (the last guarded)
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
  const float* vb = v + ((size_t)b * G + g) * sk * DV;
  float* ob = o + ((size_t)b * H + h) * sq * DV;

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
      if constexpr (DV == D) Vs[i] = in ? vb[gi] : 0.f;
    }
    if constexpr (DV != D) {
      for (int i = threadIdx.x; i < BK * DV; i += FA_THREADS)
        Vs[i] = k0 + i / DV < sk ? vb[(size_t)k0 * DV + i] : 0.f;
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
        const float* vrow = Vs + (j * 32 + cc) * DV + lane;
        float vv[ND];
#pragma unroll
        for (int e = 0; e < ND; ++e)
          vv[e] = (DV % 32 == 0 || lane + 32 * e < DV) ? vrow[32 * e] : 0.f;
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
        if (DV % 32 == 0 || lane + 32 * e < DV)
          ob[(size_t)row * DV + lane + 32 * e] = acc[r][e] * inv;
      if (lse != nullptr && lane == 0)  // natural log; no visible key: -inf
        lse[((size_t)b * H + h) * sq + row] =
            l[r] > 0.f ? m[r] + logf(l[r]) : -CUDART_INF_F;
    }
  }
}

template <int D, int DV = D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 float* lse, int64_t B, int64_t H, int64_t G, int64_t sq,
                 int64_t sk, int causal, int window, float scale,
                 cudaStream_t stream) {
  constexpr size_t smem = fa_smem<D, DV>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((sq + FA_BQ - 1) / FA_BQ), (unsigned)H,
                  (unsigned)B);
  flash_fwd<D, DV><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, (int)H, (int)G,
      (int)sq, (int)sk, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5, bf16: tensor cores (wgmma), TMA, mbarriers (helpers in hopper.cuh)

constexpr int WG_BQ = 128;       // query rows per block: two warpgroups of 64
constexpr int WG_THREADS = 384;  // two consumer warpgroups + the producer's

// q/k head dim D, v and output head dim DV (DV = D but for MLA's 96 / 64);
// D <= 96 (128 and 256 take the split route)
template <int D, int DV>
struct WgTile {
  static constexpr int BK = 128;  // kv rows per stage
  static constexpr int NS = 3;    // stages in the ring
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  // two Q buffers, so the next work tile's Q loads while this one's last
  // products run
  static constexpr int QB = 2;
  static constexpr int K_BYTES = BK * D * 2;   // K of one stage
  static constexpr int V_BYTES = BK * DV * 2;  // V of one stage
  static constexpr int STAGE = K_BYTES + V_BYTES;
  static constexpr int K_OFF = QB * Q_BYTES;   // stage s: K, then V
  static constexpr int BAR_OFF = K_OFF + NS * STAGE;
  // barriers: Q full[QB], Q empty[QB], full[NS], empty[NS]; 1024 bytes to
  // align the base
  static constexpr int SMEM = BAR_OFF + 8 * (2 * QB + 2 * NS) + 1024;
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0 &&
                    V_BYTES % 1024 == 0,
                "swizzled blocks must stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "over the block's shared memory");
  static_assert(D <= 96, "the split route takes D = 128 and 256");
};

template <int D, int DV, bool BY_HEAD>
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
  using L = WgTile<D, DV>;
  using C = Cols<D>;
  using CV = Cols<DV>;
  static_assert(CV::NB <= C::NB, "v no wider than q/k");
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

  // persistent: block x takes work tiles x, x + gridDim.x, ... (round n
  // holds tiles [n grid, n grid + grid)); the launcher picks their order
  // (an instance each: a flag read at run time cost 2-5 % at 96 / 64).
  // BY_HEAD: round n's tiles run in a snake order over the grid (reversed
  // when n is odd), and tile j is (b, h) = j / n_qt, query tile n_qt - 1 -
  // j % n_qt: a head's query tiles run one after another, the longest
  // causal one first, so that the blocks in flight (about grid / n_qt
  // heads) share their heads' K and V in L2, and the snake pairs a block's
  // tiles so that their causal lengths sum to about n_qt + 1 (at n_qt = 8
  // and 132 blocks, query tiles i and 7 - i).  Otherwise tile j is (query
  // tile n_qt - 1 - j / (B H), (b, h) = j % (B H)): the longest causal
  // tiles of every head first.  That order reads each head's K and V from
  // memory again for each of its query tiles once they outgrow the L2
  // (MLA's 40 kv heads: 4.5 times); where they fit (smollm-360m's and
  // chameleon-34b's GQA heads) the head order ran up to 5 % slower.  The
  // counts are worked out from the parameters where they are used, past
  // each role's setmaxnreg (held across it, values were spilled at D =
  // 128).
  auto n_qt = [&] { return (sq + WG_BQ - 1) / WG_BQ; };
  auto n_work = [&] { return n_qt() * B * H; };
  int b = 0, h = 0, q0 = 0, qpos_lo = 0, qpos_hi = 0, t_begin = 0, n_tiles = 0;
  auto work = [&](int j, int n) {  // work tile j, this block's n-th
    int bh, qt;
    if constexpr (BY_HEAD) {
      const int g = gridDim.x, x = blockIdx.x;
      const int in_round = min(g, n_work() - n * g);  // the last is partial
      const int i = n * g + ((n & 1) ? in_round - 1 - x : x);
      bh = i / n_qt();
      qt = i % n_qt();
    } else {
      bh = j % (B * H);
      qt = j / (B * H);
    }
    b = bh / H;
    h = bh % H;
    q0 = (n_qt() - 1 - qt) * WG_BQ;
    // the kv range any row of this tile can see, in whole tiles
    const int rows = min(WG_BQ, sq - q0);
    qpos_lo = q0 + sk - sq;
    qpos_hi = qpos_lo + rows - 1;
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
      for (int j = blockIdx.x; j < n_work(); j += gridDim.x, ++t) {
        work(j, t);
        const int g = h / (H / G);
        if (t >= QB)  // the Q buffer's last work tile is done with it
          mbar_wait(q_empty(t), ((t / QB) - 1) & 1);
        mbar_expect_tx(q_full(t), L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NB; ++c)
          tma_load_3d(q_smem(t) + WG_BQ * 128 * c,
                      c == 1 && C::TAIL ? &tq1 : &tq0, q_full(t), 64 * c, q0,
                      b * H + h);
        for (int i = 0; i < n_tiles; ++i, ++kv) {
          const int s = kv % NS;
          mbar_wait(empty(s), ((kv / NS) & 1) ^ 1);  // round 0 passes at once
          mbar_expect_tx(full(s), L::STAGE);
          const uint32_t kdst = sbase + L::K_OFF + s * L::STAGE;
          const int k0 = (t_begin + i) * BK;
#pragma unroll
          for (int c = 0; c < C::NB; ++c) {
            tma_load_3d(kdst + BK * 128 * c, c == 1 && C::TAIL ? &tk1 : &tk0,
                        full(s), 64 * c, k0, b * G + g);
            if (c < CV::NB)
              tma_load_3d(kdst + L::K_BYTES + BK * 128 * c,
                          c == 1 && CV::TAIL ? &tv1 : &tv0, full(s), 64 * c,
                          k0, b * G + g);
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

    float oacc[DV / 2];
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
      const uint32_t kt = sbase + L::K_OFF + s * L::STAGE;
      wg_fence();
      ss_tile<D, BK>(sc, q_smem(t), WG_BQ, wg * 64, kt);
      wg_commit();
    };
    // O = O * alpha + P V_i, V the MN-major operand; committed, not waited
    auto issue_pv = [&](uint32_t (*p)[4], int i) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        oacc[4 * j] *= a0;
        oacc[4 * j + 1] *= a0;
        oacc[4 * j + 2] *= a1;
        oacc[4 * j + 3] *= a1;
      }
      const uint32_t vt =
          sbase + L::K_OFF + ((kv0 + i) % NS) * L::STAGE + L::K_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) rs_tile<DV, BK>(oacc, p[kk], vt, kk);
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
      reg_fence<DV / 2>(oacc);
      release(empty((kv0 + i - 1) % NS));
    };

    for (int j = blockIdx.x; j < n_work(); j += gridDim.x, ++t) {
      work(j, t);
      qp0 = q0 + r0 + sk - sq;
      qp1 = qp0 + 8;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
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
        reg_fence<DV / 2>(oacc);
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
      __nv_bfloat16* ob = o + (size_t)(b * H + h) * sq * DV;
      if (lse != nullptr && quad == 0) {  // natural log; no visible key: -inf
        float* lb = lse + (size_t)(b * H + h) * sq;
        if (row0 < sq) lb[row0] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : -CUDART_INF_F;
        if (row1 < sq) lb[row1] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : -CUDART_INF_F;
      }
#pragma unroll
      for (int jj = 0; jj < DV / 8; ++jj) {
        const int col = 8 * jj + 2 * quad;
        if (row0 < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row0 * DV + col) =
              __floats2bfloat162_rn(oacc[4 * jj] * inv0,
                                    oacc[4 * jj + 1] * inv0);
        if (row1 < sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row1 * DV + col) =
              __floats2bfloat162_rn(oacc[4 * jj + 2] * inv1,
                                    oacc[4 * jj + 3] * inv1);
      }
    }
  }
}

template <int D, int DV = D>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int64_t B, int64_t H, int64_t G, int64_t sq,
                       int64_t sk, int causal, int window, float scale,
                       cudaStream_t stream) {
  using L = WgTile<D, DV>;
  using C = Cols<D>;
  using CV = Cols<DV>;
  CUtensorMap m[6];
  std::memset(m, 0, sizeof(m));
  int e;
  if ((e = make_map(&m[0], q, sq, B * H, D, C::width(0), WG_BQ))) return e;
  if ((e = make_map(&m[2], k, sk, B * G, D, C::width(0), L::BK))) return e;
  if ((e = make_map(&m[4], v, sk, B * G, DV, CV::width(0), L::BK))) return e;
  m[1] = m[0];
  m[3] = m[2];
  m[5] = m[4];
  if (C::TAIL) {  // the narrower second block of q and k (D = 80, 96)
    if ((e = make_map(&m[1], q, sq, B * H, D, C::width(1), WG_BQ))) return e;
    if ((e = make_map(&m[3], k, sk, B * G, D, C::width(1), L::BK))) return e;
  }
  if (CV::TAIL)  // and of v
    if ((e = make_map(&m[5], v, sk, B * G, DV, CV::width(1), L::BK))) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D, DV, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma<D, DV, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM);
  if (err != cudaSuccess) return err;
  // one resident block per SM walks the work tiles
  int dev = 0, sms = 0, l2 = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev)) !=
          cudaSuccess)
    return err;
  const int64_t n_work = (sq + WG_BQ - 1) / WG_BQ * B * H;
  const unsigned grid = (unsigned)(n_work < sms ? n_work : sms);
  // head by head where K and V outgrow the L2, or where the tiles make
  // fewer than four rounds of the grid (the snake then balances the
  // blocks better than the stride: gemma-2b's training shape, 3.9 rounds)
  const bool by_head = B * G * sk * (D + DV) * 2 > (int64_t)l2 ||
                       n_work < 4 * (int64_t)grid;
  if (by_head)
    flash_fwd_wgmma<D, DV, true><<<grid, WG_THREADS, L::SMEM, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], static_cast<__nv_bfloat16*>(o), lse,
        (int)B, (int)H, (int)G, (int)sq, (int)sk, causal, window,
        scale * LOG2E);
  else
    flash_fwd_wgmma<D, DV, false><<<grid, WG_THREADS, L::SMEM, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], static_cast<__nv_bfloat16*>(o), lse,
        (int)B, (int)H, (int)G, (int)sq, (int)sk, causal, window,
        scale * LOG2E);
  return cudaGetLastError();
}

// the split route's shared memory (D = 128 and 256): Q buffers, the ring's
// stages (K, then V), the barriers
template <int D>
struct SplitTile {
  static constexpr int BK = D <= 128 ? 128 : 64;  // kv rows per stage
  static constexpr int NS = 2;                    // stages in the ring
  // Q buffers: two at D = 128, so that the next work tile's Q loads while
  // this one's O leaves through its own
  static constexpr int QB = D <= 128 ? 2 : 1;
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  static constexpr int K_BYTES = BK * D * 2;  // K (or V) of one stage
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int K_OFF = QB * Q_BYTES;  // stage s: K, then V
  static constexpr int BAR_OFF = K_OFF + NS * STAGE;
  // barriers: Q full[QB], Q empty[QB], K full[NS], K empty[NS], V full[NS],
  // V empty[NS]; 1024 bytes to align the base
  static constexpr int SMEM = BAR_OFF + 8 * (2 * QB + 4 * NS) + 1024;
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0,
                "swizzled blocks must stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "over the block's shared memory");
};

// The bf16 forward's split route (D = 128 and 256): flash_fwd_wgmma with
// a stage's K and V on barriers of their own, so that the consumers free
// tile i's K with tile i - 1's V, a tile before the stage's V, and the
// producer loads the next tile's K and V a whole tile ahead (with one
// full/empty pair a stage, a ring of two frees a stage only as its next
// tile is due); and O stored by TMA from the work tile's Q buffer.  Its
// work order and its consumers' products and softmax are flash_fwd_wgmma's,
// repeated: one body for both routes changed flash_fwd_wgmma's SASS.
template <int D, bool BY_HEAD>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_split(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int B, int H, int G, int sq, int sk, int causal,
                      int window, float scale_log2) {
  using L = SplitTile<D>;
  using C = Cols<D>;
  constexpr int DV = D;
  constexpr int BK = L::BK, NS = L::NS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  // barriers: Q full[QB], Q empty[QB], then K's full[NS], empty[NS], then
  // V's vfull[NS], vempty[NS]
  constexpr int QB = L::QB;
  const uint32_t bars = sbase + L::BAR_OFF;
  auto q_full = [&](int t) { return bars + 8u * (t % QB); };
  auto q_empty = [&](int t) { return bars + 8u * (QB + t % QB); };
  auto q_smem = [&](int t) { return sbase + (t % QB) * L::Q_BYTES; };
  auto full = [&](int s) { return bars + 8u * (2 * QB + s); };
  auto empty = [&](int s) { return bars + 8u * (2 * QB + NS + s); };
  auto vfull = [&](int s) { return bars + 8u * (2 * QB + 2 * NS + s); };
  auto vempty = [&](int s) { return bars + 8u * (2 * QB + 3 * NS + s); };

  // persistent, the work tiles in flash_fwd_wgmma's orders (BY_HEAD: head
  // by head in a snake order; else the longest causal tiles of every head
  // first); the counts worked out from the parameters where they are used
  auto n_qt = [&] { return (sq + WG_BQ - 1) / WG_BQ; };
  auto n_work = [&] { return n_qt() * B * H; };
  int b = 0, h = 0, q0 = 0, qpos_lo = 0, qpos_hi = 0, t_begin = 0, n_tiles = 0;
  auto work = [&](int j, int n) {  // work tile j, this block's n-th
    int bh, qt;
    if constexpr (BY_HEAD) {
      const int g = gridDim.x, x = blockIdx.x;
      const int in_round = min(g, n_work() - n * g);  // the last is partial
      const int i = n * g + ((n & 1) ? in_round - 1 - x : x);
      bh = i / n_qt();
      qt = i % n_qt();
    } else {
      bh = j % (B * H);
      qt = j / (B * H);
    }
    b = bh / H;
    h = bh % H;
    q0 = (n_qt() - 1 - qt) * WG_BQ;
    // the kv range any row of this tile can see, in whole tiles
    const int rows = min(WG_BQ, sq - q0);
    qpos_lo = q0 + sk - sq;
    qpos_hi = qpos_lo + rows - 1;
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
      mbar_init(vfull(s), 1);
      mbar_init(vempty(s), 8);
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
      for (int j = blockIdx.x; j < n_work(); j += gridDim.x, ++t) {
        work(j, t);
        const int g = h / (H / G);
        if (t >= QB)  // the Q buffer's last work tile is done with it
          mbar_wait(q_empty(t), ((t / QB) - 1) & 1);
        mbar_expect_tx(q_full(t), L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::NB; ++c)
          tma_load_3d(q_smem(t) + WG_BQ * 128 * c, &tq, q_full(t), 64 * c, q0,
                      b * H + h);
        for (int i = 0; i < n_tiles; ++i, ++kv) {
          const int s = kv % NS;
          const uint32_t ph = ((kv / NS) & 1) ^ 1;  // round 0 passes at once
          const uint32_t kdst = sbase + L::K_OFF + s * L::STAGE;
          const int k0 = (t_begin + i) * BK;
          // K once the tile NS before has freed its K, then V once it has
          // freed its V, each on its own barriers
          mbar_wait(empty(s), ph);
          mbar_expect_tx(full(s), L::K_BYTES);
#pragma unroll
          for (int c = 0; c < C::NB; ++c)
            tma_load_3d(kdst + BK * 128 * c, &tk, full(s), 64 * c, k0, b * G + g);
          mbar_wait(vempty(s), ph);
          mbar_expect_tx(vfull(s), L::K_BYTES);
#pragma unroll
          for (int c = 0; c < C::NB; ++c)
            tma_load_3d(kdst + L::K_BYTES + BK * 128 * c, &tv, vfull(s), 64 * c,
                        k0, b * G + g);
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

    float oacc[DV / 2];
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
      const uint32_t kt = sbase + L::K_OFF + s * L::STAGE;
      wg_fence();
      ss_tile<D, BK>(sc, q_smem(t), WG_BQ, wg * 64, kt);
      wg_commit();
    };
    // O = O * alpha + P V_i, V the MN-major operand; committed, not waited
    auto issue_pv = [&](uint32_t (*p)[4], int i) {
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        oacc[4 * j] *= a0;
        oacc[4 * j + 1] *= a0;
        oacc[4 * j + 2] *= a1;
        oacc[4 * j + 3] *= a1;
      }
      const uint32_t vt =
          sbase + L::K_OFF + ((kv0 + i) % NS) * L::STAGE + L::K_BYTES;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) rs_tile<DV, BK>(oacc, p[kk], vt, kk);
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
    // V of tile i has landed
    auto wait_v = [&](int i) {
      mbar_wait(vfull((kv0 + i) % NS), ((kv0 + i) / NS) & 1);
    };
    // tile i: S_i = Q K_i^T and P_{i-1} V_{i-1} run on the tensor cores
    // while the softmax of S_i runs on the CUDA cores; then K_i and
    // V_{i-1} are free
    auto step = [&](uint32_t (*p_prev)[4], uint32_t (*p_new)[4], int i) {
      wait_v(i - 1);  // before any product is in flight
      issue_qk(i);
      issue_pv(p_prev, i - 1);
      wg_wait<1>();  // S_i (the older group) is done
      reg_fence<BK / 2>(sc);
      softmax(p_new, i);
      wg_wait<0>();  // P_{i-1} V_{i-1} is done
      reg_fence<DV / 2>(oacc);
      release(empty((kv0 + i) % NS));
      release(vempty((kv0 + i - 1) % NS));
    };

    for (int j = blockIdx.x; j < n_work(); j += gridDim.x, ++t) {
      work(j, t);
      qp0 = q0 + r0 + sk - sq;
      qp1 = qp0 + 8;
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) oacc[i] = 0.f;
      m0 = m1 = NEG;
      l0 = l1 = 0.f;
      mbar_wait(q_full(t), (t / QB) & 1);
      if (n_tiles > 0) {
        issue_qk(0);
        wg_wait<0>();
        reg_fence<BK / 2>(sc);
        release(empty(kv0 % NS));
        softmax(pa, 0);
        // tile i's P lands in pa for even i, in pb for odd i
        for (int i = 1; i < n_tiles; i += 2) {
          step(pa, pb, i);
          if (i + 1 < n_tiles) step(pb, pa, i + 1);
        }
        wait_v(n_tiles - 1);
        if ((n_tiles - 1) & 1)
          issue_pv(pb, n_tiles - 1);
        else
          issue_pv(pa, n_tiles - 1);
        wg_wait<0>();
        reg_fence<DV / 2>(oacc);
        release(vempty((kv0 + n_tiles - 1) % NS));
      }
      kv0 += n_tiles;

      l0 += __shfl_xor_sync(FULL, l0, 1);
      l0 += __shfl_xor_sync(FULL, l0, 2);
      l1 += __shfl_xor_sync(FULL, l1, 1);
      l1 += __shfl_xor_sync(FULL, l1, 2);
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;  // no visible key -> 0
      const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      const int row0 = q0 + r0, row1 = row0 + 8;
      if (lse != nullptr && quad == 0) {  // natural log; no visible key: -inf
        float* lb = lse + (size_t)(b * H + h) * sq;
        if (row0 < sq) lb[row0] = l0 > 0.f ? (m0 + log2f(l0)) * LN2 : -CUDART_INF_F;
        if (row1 < sq) lb[row1] = l1 > 0.f ? (m1 + log2f(l1)) * LN2 : -CUDART_INF_F;
      }
      // O in bf16 into this warpgroup's 64 rows of the work tile's Q
      // buffer (Q's layout: 64-column blocks in the 128-byte swizzle), then
      // a TMA box a column block (rows past Sq are not written): the rows
      // leave in whole 128-byte lines, not 4 bytes a thread.  The Q buffer
      // frees once the boxes have read it.  This thread's rows r0 and r0 +
      // 8 share a swizzle phase; their addresses are worked out here
      // (hoisted out of the work-tile loop and held across it, they spilled)
      uint32_t base = q_smem(t) + r0 * 128 + 4 * quad, phase = lane / 4;
      asm volatile("" : "+r"(base), "+r"(phase));
#pragma unroll
      for (int jj = 0; jj < DV / 8; ++jj) {
        const uint32_t a = base + (jj / 8) * WG_BQ * 128 + (((jj % 8) ^ phase) << 4);
        st_shared_u32(a, pack_bf16(oacc[4 * jj] * inv0, oacc[4 * jj + 1] * inv0));
        st_shared_u32(a + 8 * 128, pack_bf16(oacc[4 * jj + 2] * inv1,
                                             oacc[4 * jj + 3] * inv1));
      }
      fence_async_shared();
      warpgroup_sync(1 + wg);
      if (tid == 0) {
        const uint32_t rows = q_smem(t) + 64 * wg * 128;
#pragma unroll
        for (int c = 0; c < C::NB; ++c)
          tma_store_3d(&to, rows + c * WG_BQ * 128, 64 * c, q0 + 64 * wg,
                       b * H + h);
        bulk_commit();
        bulk_wait_read();  // (a wait for the stores' writes, after the
                           // loop, made ptxas spill and serialize wgmma)
        mbar_arrive_n(q_empty(t), 4);  // for this warpgroup's 4 warps
      }
    }
  }
}

template <int D>
int launch_flash_wgmma_split(const void* q, const void* k, const void* v,
                             void* o, float* lse, int64_t B, int64_t H,
                             int64_t G, int64_t sq, int64_t sk, int causal,
                             int window, float scale, cudaStream_t stream) {
  using L = SplitTile<D>;
  CUtensorMap m[4];  // q, k, v, and o (stored by 64-row boxes)
  std::memset(m, 0, sizeof(m));
  int e;
  if ((e = make_map(&m[0], q, sq, B * H, D, 64, WG_BQ))) return e;
  if ((e = make_map(&m[1], k, sk, B * G, D, 64, L::BK))) return e;
  if ((e = make_map(&m[2], v, sk, B * G, D, 64, L::BK))) return e;
  if ((e = make_map(&m[3], o, sq, B * H, D, 64, 64))) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_split<D, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_fwd_wgmma_split<D, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, l2 = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev)) !=
          cudaSuccess)
    return err;
  // launch_flash_wgmma's grid and order
  const int64_t n_work = (sq + WG_BQ - 1) / WG_BQ * B * H;
  const unsigned grid = (unsigned)(n_work < sms ? n_work : sms);
  const bool by_head = B * G * sk * 2 * D * 2 > (int64_t)l2 ||
                       n_work < 4 * (int64_t)grid;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  if (by_head)
    flash_fwd_wgmma_split<D, true><<<grid, WG_THREADS, L::SMEM, stream>>>(
        m[0], m[1], m[2], m[3], out, lse, (int)B, (int)H, (int)G, (int)sq,
        (int)sk, causal, window, scale * LOG2E);
  else
    flash_fwd_wgmma_split<D, false><<<grid, WG_THREADS, L::SMEM, stream>>>(
        m[0], m[1], m[2], m[3], out, lse, (int)B, (int)H, (int)G, (int)sq,
        (int)sk, causal, window, scale * LOG2E);
  return cudaGetLastError();
}

// each dtype has one kernel: fp32 the SIMT one, bf16 the wgmma one (its
// split route at D = 128 and 256); v as wide as q/k at every built head
// dim, or MLA's narrow v (96 / 64)
int flash_by_dim(int D, int DV, int dtype, const void* q, const void* k,
                 const void* v, void* o, float* lse, int64_t B, int64_t H, int64_t G,
                 int64_t sq, int64_t sk, int causal, int window, float scale,
                 cudaStream_t st) {
  if (DV != D) {
    if (D != 96 || DV != 64) return cudaErrorInvalidValue;
    if (dtype == 0) return launch_flash<96, 64>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
    if (dtype == 1) return launch_flash_wgmma<96, 64>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
    return cudaErrorInvalidValue;
  }
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
      case 128: return launch_flash_wgmma_split<128>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
      case 256: return launch_flash_wgmma_split<256>(q, k, v, o, lse, B, H, G, sq, sk, causal, window, scale, st);
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

// ---------------------------------------------------------------------------
// K6's tensor-core route: bf16 at head dims 128 and 256 with 4-8 query heads
// a kv group (decode_route in decode_attention.py mirrors decode_mma_route)

constexpr int DM_ROWS = 16;   // cache rows of a slice: the M of S^T, the K of P V
constexpr int DM_HEADS = 8;   // a group's query heads, padded: the N of both
constexpr int DM_ITEMS = 4;   // four-column pieces a thread of the combine
constexpr int DM_MAX_SLOTS = 24;
constexpr int DM_WARPS = 4;   // warps a block

// slices in flight a block, split over its warps: 192 KB of K and V
template <int D>
__host__ __device__ constexpr int dm_slots() {
  return D == 128 ? 24 : 12;
}

__host__ __device__ constexpr bool decode_mma_route(int dtype, int D, int hg) {
  return dtype == 1 && (D == 128 || D == 256) && hg >= 4 && hg <= DM_HEADS;
}

template <int D>
struct DmGeom {
  static constexpr int NB = D / 64;                  // 64-column blocks
  static constexpr int BOX_BYTES = DM_ROWS * 128;    // one TMA box: 16 rows x 64
  static constexpr int K_BYTES = NB * BOX_BYTES;     // a slice's K, then its V
  static constexpr int SLICE_BYTES = 2 * K_BYTES;
  static constexpr int KSTEPS = D / 16;              // k-steps of S^T, row blocks of O^T
  static constexpr int ACC_STRIDE = D + 4;           // merge rows: no bank conflicts
};

template <int D>
size_t dm_smem() {
  using Gm = DmGeom<D>;
  constexpr int W = DM_WARPS;
  const size_t ring = (size_t)dm_slots<D>() / W * W * Gm::SLICE_BYTES;
  const size_t merge =
      sizeof(float) * (2 * W * DM_HEADS + W * DM_HEADS * Gm::ACC_STRIDE +
                       2 * DM_HEADS);
  return (ring > merge ? ring : merge) + 1024;  // the ring's 1024-byte alignment
}

// d += a b: m16n8k16, a row-major 16 x 16, b col-major 16 x 8, bf16 in,
// fp32 sum
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// four 8 x 8 bf16 tiles: lane i gives the address of row i % 8 of tile
// i / 8; r[t] holds tile t's (g, 2 q) and (g, 2 q + 1) (g = lane / 4, q =
// lane % 4), or with .trans its (2 q, g) and (2 q + 1, g)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// an 8 x 8 bf16 tile held as (g, 2 q), (g, 2 q + 1), transposed in registers
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// One block per (cache chunk, kv group, sequence), the chunk slowest (the
// chunks past a short length come last); DM_WARPS warps, each of which takes
// the chunk's 16-row slices warp, warp + DM_WARPS, ... through a ring of its
// own of dm_slots / DM_WARPS slots: its lane 0 loads a slice's K and V by TMA
// (64-column boxes, 128-byte swizzle; rows past S arrive as zeros) and the
// warp waits on the slot's mbarrier.  A lane holds, of the group's heads
// kq and kq + 1 (kq = 2 (lane % 4)), the running max and sum, and of O^T
// (D x 8) rows 16 i + lane / 4 (+ 8).  A slice: S^T (16 x 8) = K Q^T on
// mma.sync (Q^T's fragments in registers), masked past the chunk's end,
// the max over the slice by 3 shuffles, P rounded to bf16 and turned into
// P^T's B fragments by movmatrix, O^T += V^T P^T (V^T by ldmatrix.trans).
// The warps merge in shared memory; a split cache writes fp32 partials and
// the last block of its (b, group), by ticket, merges them in one pass.
template <int D>
__global__ void __launch_bounds__(32 * DM_WARPS)
decode_mma(const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __nv_bfloat16* __restrict__ q, const int* __restrict__ length,
           __nv_bfloat16* __restrict__ o, float* __restrict__ pm,
           float* __restrict__ pl, float* __restrict__ pacc,
           int* __restrict__ counters, int B, int H, int G, int S, int chunk,
           int nch, int window, float scale_log2) {
  using Gm = DmGeom<D>;
  constexpr int KS = Gm::KSTEPS;
  const int bg = blockIdx.x % (B * G), c = blockIdx.x / (B * G);
  const int b = bg / G, g = bg % G;
  const int hg = H / G, h0 = g * hg;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int nw = DM_WARPS, nslot = dm_slots<D>() / nw;
  extern __shared__ uint8_t dsmem[];
  uint8_t* base = dsmem + ((1024u - (smem_u32(dsmem) & 1023u)) & 1023u);
  __shared__ __align__(8) uint64_t full[DM_MAX_SLOTS];
  __shared__ int ticket;

  const int len = min(length[b], S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int c1 = min(min((c + 1) * chunk, S), len);
  const int start = max(c * chunk, lo);
  const int nsl = start < c1 ? (c1 - start + DM_ROWS - 1) / DM_ROWS : 0;
  if (nsl == 0) {  // no visible position in this chunk: weight 0
    if (nch == 1) {  // no visible position at all: 0
      for (int idx = threadIdx.x; idx < hg * D; idx += blockDim.x)
        o[((size_t)b * H + h0) * D + idx] = __float2bfloat16(0.f);
      return;
    }
    if (threadIdx.x < hg) {
      const size_t idx = ((size_t)b * H + h0 + threadIdx.x) * nch + c;
      pm[idx] = NEG;
      pl[idx] = 0.f;
    }
  } else {
  if (threadIdx.x == 0) {
    for (int i = 0; i < nw * nslot; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this warp's slices: warp + i nw, i < mine, in slot i % nslot
  const int mine = nsl > warp ? (nsl - warp + nw - 1) / nw : 0;
  uint8_t* ring = base + (size_t)warp * nslot * Gm::SLICE_BYTES;
  auto load_slice = [&](int i) {
    const int slot = i % nslot;
    const uint32_t bar = smem_u32(&full[warp * nslot + slot]);
    const uint32_t dst = smem_u32(ring + slot * Gm::SLICE_BYTES);
    const int r0 = start + (warp + i * nw) * DM_ROWS;
    mbar_expect_tx(bar, Gm::SLICE_BYTES);
#pragma unroll
    for (int cb = 0; cb < Gm::NB; ++cb) {
      tma_load_3d(dst + cb * Gm::BOX_BYTES, &tk, bar, 64 * cb, r0, bg);
      tma_load_3d(dst + Gm::K_BYTES + cb * Gm::BOX_BYTES, &tv, bar, 64 * cb, r0, bg);
    }
  };
  if (lane == 0)
    for (int i = 0; i < min(mine, nslot); ++i) load_slice(i);

  // Q^T's B fragments: head n = lane / 4 (zero past the group), rows
  // 16 kk + kq (+ 8) of D
  const int n = lane >> 2, kq = (lane & 3) * 2;
  uint32_t qf[KS][2];
  {
    const bool in = n < hg;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        q + ((size_t)b * H + h0 + (in ? n : 0)) * D + kq);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][0] = in ? qr[8 * kk] : 0u;
      qf[kk][1] = in ? qr[8 * kk + 4] : 0u;
    }
  }
  float acc[KS][4];  // O^T: d = 16 dm + n (+ 8 at j >= 2), head kq + (j & 1)
#pragma unroll
  for (int dm = 0; dm < KS; ++dm)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[dm][j] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // heads kq, kq + 1

  // ldmatrix addresses within a slot: K as the A operand (rows r_k, the
  // k-step's 16-byte chunk ck + 2 (kk % 4)), V^T by .trans (rows r_v,
  // chunk cv + 2 (dm % 4)); the 128-byte swizzle XORs the chunk with the
  // row % 8, which is lane % 8 for both
  const int r_k = (lane & 7) + ((lane >> 3) & 1) * 8, ck = lane >> 4;
  const int r_v = (lane & 7) + (lane >> 4) * 8, cv = (lane >> 3) & 1;
  for (int i = 0; i < mine; ++i) {
    const int slot = i % nslot;
    mbar_wait(smem_u32(&full[warp * nslot + slot]), (i / nslot) & 1);
    const uint32_t kt = smem_u32(ring + slot * Gm::SLICE_BYTES);
    const uint32_t vt = kt + Gm::K_BYTES;
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      const int ch = ((kk & 3) << 1) + ck;
      ldmatrix_x4(a, kt + (kk >> 2) * Gm::BOX_BYTES + r_k * 128 +
                         ((ch ^ (lane & 7)) << 4));
      mma_bf16(sc[kk & 1], a, qf[kk][0], qf[kk][1]);
    }
    const int ra = start + (warp + i * nw) * DM_ROWS + n;  // rows ra, ra + 8
    const bool oka = ra < c1, okb = ra + 8 < c1;
    const float x0 = oka ? (sc[0][0] + sc[1][0]) * scale_log2 : -CUDART_INF_F;
    const float x1 = oka ? (sc[0][1] + sc[1][1]) * scale_log2 : -CUDART_INF_F;
    const float x2 = okb ? (sc[0][2] + sc[1][2]) * scale_log2 : -CUDART_INF_F;
    const float x3 = okb ? (sc[0][3] + sc[1][3]) * scale_log2 : -CUDART_INF_F;
    float mx0 = fmaxf(x0, x2), mx1 = fmaxf(x1, x3);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: >= NEG
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    const float p0 = ex2(x0 - mn0), p1 = ex2(x1 - mn1);  // masked rows: 0
    const float p2 = ex2(x2 - mn0), p3 = ex2(x3 - mn1);
    l0 = l0 * a0 + (p0 + p2);
    l1 = l1 * a1 + (p1 + p3);
#pragma unroll
    for (int dm = 0; dm < KS; ++dm) {
      acc[dm][0] *= a0;
      acc[dm][1] *= a1;
      acc[dm][2] *= a0;
      acc[dm][3] *= a1;
    }
    // P^T's B fragments: the (row, head) tiles of rows 0-7 and 8-15,
    // rounded to bf16 and transposed
    const uint32_t b0 = movmatrix_trans(pack_bf16(p0, p1));
    const uint32_t b1 = movmatrix_trans(pack_bf16(p2, p3));
#pragma unroll
    for (int dm = 0; dm < KS; ++dm) {
      uint32_t a[4];
      const int ch = ((dm & 3) << 1) + cv;
      ldmatrix_x4_trans(a, vt + (dm >> 2) * Gm::BOX_BYTES + r_v * 128 +
                               ((ch ^ (lane & 7)) << 4));
      mma_bf16(acc[dm], a, b0, b1);
    }
    __syncwarp();  // every lane has read the slot before it is refilled
    if (lane == 0 && i + nslot < mine) load_slice(i + nslot);
  }
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {  // the sums over the 16-row groups
    l0 += __shfl_xor_sync(FULL, l0, off);
    l1 += __shfl_xor_sync(FULL, l1, off);
  }
  __syncthreads();  // the rings are drained: reuse them for the merge

  float* sm_m = reinterpret_cast<float*>(base);  // [nw][8]: max, then weight
  float* sm_l = sm_m + nw * DM_HEADS;             // [nw][8]
  float* sm_acc = sm_l + nw * DM_HEADS;           // [nw][8][ACC_STRIDE]
  float* stat = sm_acc + nw * DM_HEADS * Gm::ACC_STRIDE;  // [8] M, [8] L
  if (lane < 4) {
    sm_m[warp * DM_HEADS + kq] = m0;
    sm_m[warp * DM_HEADS + kq + 1] = m1;
    sm_l[warp * DM_HEADS + kq] = l0;
    sm_l[warp * DM_HEADS + kq + 1] = l1;
  }
  {
    float* wa = sm_acc + warp * DM_HEADS * Gm::ACC_STRIDE;
#pragma unroll
    for (int dm = 0; dm < KS; ++dm)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wa[(kq + (j & 1)) * Gm::ACC_STRIDE + 16 * dm + n + 8 * (j >> 1)] = acc[dm][j];
  }
  __syncthreads();
  if (threadIdx.x < hg) {  // each warp's weight exp2(m - M) in sm_m
    const int i = threadIdx.x;
    float M = NEG;
    for (int w = 0; w < nw; ++w)
      if (sm_l[w * DM_HEADS + i] > 0.f) M = fmaxf(M, sm_m[w * DM_HEADS + i]);
    float L = 0.f;
    for (int w = 0; w < nw; ++w) {
      const float lw = sm_l[w * DM_HEADS + i];  // 0: the warp saw no row
      const float wt = lw > 0.f ? exp2f(sm_m[w * DM_HEADS + i] - M) : 0.f;
      sm_m[w * DM_HEADS + i] = wt;
      L += lw * wt;
    }
    stat[i] = M;
    stat[DM_HEADS + i] = L;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < hg * D; idx += blockDim.x) {
    const int i = idx / D, d = idx % D;
    float A = 0.f;
    for (int w = 0; w < nw; ++w)
      A = fmaf(sm_m[w * DM_HEADS + i],
               sm_acc[(w * DM_HEADS + i) * Gm::ACC_STRIDE + d], A);
    const float L = stat[DM_HEADS + i];
    if (nch == 1) {  // the one chunk: the result itself
      o[((size_t)b * H + h0 + i) * D + d] = __float2bfloat16(L > 0.f ? A / L : 0.f);
      continue;
    }
    const size_t hidx = ((size_t)b * H + h0 + i) * nch + c;
    pacc[hidx * D + d] = A;
    if (d == 0) {
      pm[hidx] = stat[i];
      pl[hidx] = L;
    }
  }
  }
  if (nch == 1) return;

  // the last block of this (b, kv group) to finish combines the chunks
  // (the counter, zero before the launch, is zero again after it)
  __syncthreads();  // the block's partials are written (block order) ...
  int* counter = counters + bg;
  if (threadIdx.x == 0) {
    __threadfence();  // ... and visible on the card before the ticket
    ticket = atomicAdd(counter, 1);
    __threadfence();  // the last block sees every other block's partials
  }
  __syncthreads();
  if (ticket != nch - 1) return;
  // each thread merges every chunk's partials of DM_ITEMS four-column
  // pieces itself, a running (M, L, acc) in registers: a chunk's m, l and
  // piece load together, four chunks' at once, in one pass over L2
  constexpr int D4 = D / 4;
  const size_t hb = ((size_t)b * H + h0) * nch;  // (head h0, chunk 0)
  for (int i0 = threadIdx.x; i0 < hg * D4; i0 += DM_ITEMS * blockDim.x) {
    float4 a[DM_ITEMS];
    float M[DM_ITEMS], L[DM_ITEMS];
    int hi[DM_ITEMS], di[DM_ITEMS];
#pragma unroll
    for (int j = 0; j < DM_ITEMS; ++j) {
      const int idx = min(i0 + j * (int)blockDim.x, hg * D4 - 1);
      hi[j] = idx / D4;
      di[j] = idx % D4;
      a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      M[j] = NEG;
      L[j] = 0.f;
    }
#pragma unroll 4
    for (int cc = 0; cc < nch; ++cc) {
#pragma unroll
      for (int j = 0; j < DM_ITEMS; ++j) {
        const size_t hc = hb + (size_t)hi[j] * nch + cc;
        const float mc = __ldcg(pm + hc), lc = __ldcg(pl + hc);
        const float4 x = __ldcg(reinterpret_cast<const float4*>(pacc + hc * D) + di[j]);
        if (lc > 0.f) {  // an empty chunk wrote no partial
          const float mn = fmaxf(M[j], mc);
          const float s0 = ex2(M[j] - mn), s1 = ex2(mc - mn);
          a[j].x = a[j].x * s0 + x.x * s1;
          a[j].y = a[j].y * s0 + x.y * s1;
          a[j].z = a[j].z * s0 + x.z * s1;
          a[j].w = a[j].w * s0 + x.w * s1;
          L[j] = L[j] * s0 + lc * s1;
          M[j] = mn;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < DM_ITEMS; ++j) {
      const int idx = i0 + j * (int)blockDim.x;
      if (idx >= hg * D4) break;
      const float inv = L[j] > 0.f ? 1.f / L[j] : 0.f;
      uint2 out;
      out.x = pack_bf16(a[j].x * inv, a[j].y * inv);
      out.y = pack_bf16(a[j].z * inv, a[j].w * inv);
      *reinterpret_cast<uint2*>(o + ((size_t)b * H + h0) * D + 4 * idx) = out;
    }
  }
  if (threadIdx.x == 0) *counter = 0;
}

template <int D>
int launch_decode_mma(const void* q, const void* k, const void* v,
                      const int* length, void* o, float* pm, float* pl,
                      float* pacc, int* counters, int64_t B, int64_t H, int64_t G,
                      int64_t S, int chunk, int nch, int window, float scale,
                      cudaStream_t stream) {
  if (nch > DA_MAX_CHUNKS || chunk < 1) return cudaErrorInvalidValue;
  CUtensorMap m[2];  // k, v: 16-row boxes of 64 columns
  int e;
  if ((e = make_map(&m[0], k, S, B * G, D, 64, DM_ROWS))) return e;
  if ((e = make_map(&m[1], v, S, B * G, D, 64, DM_ROWS))) return e;
  const size_t smem = dm_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_mma<D><<<(unsigned)(nch * B * G), 32 * DM_WARPS, smem, stream>>>(
      m[0], m[1], static_cast<const __nv_bfloat16*>(q), length,
      static_cast<__nv_bfloat16*>(o), pm, pl, pacc, counters, (int)B, (int)H,
      (int)G, (int)S, chunk, nch, window, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace

// (q, k, v, o, lse, B, H, G, Sq, Sk, D, Dv, dtype, causal, window, scale,
// stream); v and o have head dim Dv (= D, or 64 at D = 96); lse is null or
// (B, H, Sq) fp32, each query row's natural-log log-sum-exp of its scaled,
// masked scores (-inf where it sees no key); window <= 0 disables the window
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int64_t B, int64_t H, int64_t G,
                                     int64_t sq, int64_t sk, int D, int DV,
                                     int dtype, int causal, int window,
                                     float scale, void* stream) {
  return flash_by_dim(D, DV, dtype, q, k, v, o, static_cast<float*>(lse), B, H, G,
                      sq, sk, causal, window, scale,
                      static_cast<cudaStream_t>(stream));
}

// (q, k, v, length, o, part_m, part_l, part_acc, counters, B, H, G, S, D,
//  dtype, chunk, n_chunks, warps, window, scale, stream); part_m/part_l are (B, H,
// n_chunks) fp32 scratch, part_acc (B, H, n_chunks, D), counters B H int32
// zeros (zero again when the launch ends; one set per stream); bf16 at D =
// 128 and 256 with 4-8 query heads a kv group takes decode_mma (DM_WARPS
// warps a block; `warps` is ignored), every other call the cp.async ring
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
  if (G > 0 && decode_mma_route(dtype, D, (int)(H / G))) {
    if (D == 128)
      return launch_decode_mma<128>(q, k, v, len, o, m, l, acc, cnt, B, H, G, S, chunk, nch, window, scale, st);
    return launch_decode_mma<256>(q, k, v, len, o, m, l, acc, cnt, B, H, G, S, chunk, nch, window, scale, st);
  }
  if (dtype == 0)
    return decode_by_dim<float>(D, q, k, v, len, o, m, l, acc, cnt, B, H, G, S, chunk, nch, warps, window, scale, st);
  if (dtype == 1)
    return decode_by_dim<__nv_bfloat16>(D, q, k, v, len, o, m, l, acc, cnt, B, H, G, S, chunk, nch, warps, window, scale, st);
  return cudaErrorInvalidValue;
}
