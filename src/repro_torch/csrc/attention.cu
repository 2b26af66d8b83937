// K5 and K6: the attention kernels of the serve path, for sm_90a.
//
// K5 repro_flash_attention replaces the Pallas `flash_attention`
// (src/repro/kernels/flash_attention.py): online-softmax attention of
// q (B, H, Sq, D) over k/v (B, G, Sk, D), GQA heads h -> h / (H / G),
// query row i at position i + Sk - Sq, causal and window masks, fp32
// statistics and accumulator.  On the TPU the kv blocks are the innermost,
// sequential grid axis and the running (m, l, acc) live in VMEM across
// grid steps; here one block owns a 64-row q tile of one (b, h) and loops
// over the kv tiles itself, holding (m, l, acc) in registers.  It skips
// the kv tiles that lie wholly above the causal diagonal or wholly outside
// the window (the TPU masks them), and masks k_pos < Sk explicitly (the
// Pallas kernel leaves padded kv columns unmasked when causal is off).
// Bound on the card: operations (4 B H Sq Sk_eff D) at the prefill shapes;
// this first version runs its products as fp32 FMAs from shared memory,
// not on the tensor cores (mma/wgmma is later work).
//
// K6 repro_decode_attention replaces the Pallas `decode_attention`
// (src/repro/kernels/decode_attention.py): one query token per sequence
// against a KV cache with per-sequence valid `length` (read on the card,
// no host sync) and an optional window (pos >= length - window).  Split-K
// flash-decoding: one block per (cache chunk, kv group, b) loads each K/V
// row once for all H / G query heads of its group (the TPU kernel's grid
// (b, h, nk) reloads it per head) and writes partial (m, l, acc) in fp32;
// a second kernel combines the chunks.  Chunks past `length` (or before the
// window) exit at once.  Bound on the card: bytes (the cache read once).
//
// Both take fp32 or bf16 inputs (dtype 0 / 1) with the output in the
// input's type, and head dims 32, 64, 80 (zamba2's shared attention: a
// lane's last output dim is guarded, D % 32 != 0), 128 and 256.  Every launcher returns
// cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr float NEG = -1e30f;  // the running max before any key, as on the TPU
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
// K5 flash attention

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

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int H, int G, int sq,
          int sk, int causal, int window, float scale) {
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
  const T* qb = q + ((size_t)b * H + h) * sq * D;
  const T* kb = k + ((size_t)b * G + g) * sk * D;
  const T* vb = v + ((size_t)b * G + g) * sk * D;
  T* ob = o + ((size_t)b * H + h) * sq * D;

  for (int i = threadIdx.x; i < FA_BQ * D; i += FA_THREADS) {
    Qs[i] = q0 + i / D < sq ? to_f(qb[(size_t)q0 * D + i]) * scale : 0.f;
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
      Ks[r * (D + 1) + c] = in ? to_f(kb[gi]) : 0.f;
      Vs[i] = in ? to_f(vb[gi]) : 0.f;
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
          ob[(size_t)row * D + lane + 32 * e] = from_f<T>(acc[r][e] * inv);
    }
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 int64_t B, int64_t H, int64_t G, int64_t sq, int64_t sk,
                 int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = fa_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((sq + FA_BQ - 1) / FA_BQ), (unsigned)H,
                  (unsigned)B);
  flash_fwd<T, D><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)H, (int)G, (int)sq,
      (int)sk, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int flash_by_dim(int D, const void* q, const void* k, const void* v, void* o,
                 int64_t B, int64_t H, int64_t G, int64_t sq, int64_t sk,
                 int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_flash<T, 32>(q, k, v, o, B, H, G, sq, sk, causal, window, scale, stream);
    case 64: return launch_flash<T, 64>(q, k, v, o, B, H, G, sq, sk, causal, window, scale, stream);
    case 80: return launch_flash<T, 80>(q, k, v, o, B, H, G, sq, sk, causal, window, scale, stream);
    case 128: return launch_flash<T, 128>(q, k, v, o, B, H, G, sq, sk, causal, window, scale, stream);
    case 256: return launch_flash<T, 256>(q, k, v, o, B, H, G, sq, sk, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K6 decode attention

constexpr int DA_THREADS = 128;

// cache rows per tile staged in shared memory
template <int D>
__host__ __device__ constexpr int da_tk() { return D <= 128 ? 64 : 32; }

template <int D>
size_t da_smem(int hg) {
  constexpr int TK = da_tk<D>();
  // Q [hg][D], K [TK][D + 1], V [TK][D], P [hg][TK], acc [hg][D], m, l, alpha [hg]
  return sizeof(float) *
         ((size_t)hg * D + TK * (D + 1) + TK * D + (size_t)hg * TK +
          (size_t)hg * D + 3 * (size_t)hg);
}

template <typename T, int D>
__global__ void __launch_bounds__(DA_THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ length,
               float* __restrict__ pm, float* __restrict__ pl,
               float* __restrict__ pacc, int H, int G, int S, int chunk,
               int nch, int window, float scale) {
  constexpr int TK = da_tk<D>();
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int hg = H / G;
  const int h0 = g * hg;  // first query head of this kv group
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + hg * D;
  float* Vs = Ks + TK * (D + 1);
  float* Ps = Vs + TK * D;
  float* Acc = Ps + hg * TK;
  float* Mr = Acc + hg * D;
  float* Lr = Mr + hg;
  float* Al = Lr + hg;

  const int len = min(length[b], S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int c1 = min(min((c + 1) * chunk, S), len);
  const int start = max(c * chunk, lo);
  if (start >= c1) {  // no visible position in this chunk: weight 0
    for (int i = threadIdx.x; i < hg; i += DA_THREADS) {
      const size_t idx = ((size_t)b * H + h0 + i) * nch + c;
      pm[idx] = NEG;
      pl[idx] = 0.f;
    }
    return;
  }

  const T* qb = q + ((size_t)b * H + h0) * D;
  for (int i = threadIdx.x; i < hg * D; i += DA_THREADS) {
    Qs[i] = to_f(qb[i]) * scale;
    Acc[i] = 0.f;
  }
  for (int i = threadIdx.x; i < hg; i += DA_THREADS) {
    Mr[i] = NEG;
    Lr[i] = 0.f;
  }
  const T* kb = k + ((size_t)b * G + g) * S * D;
  const T* vb = v + ((size_t)b * G + g) * S * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int t0 = start; t0 < c1; t0 += TK) {
    const int n = min(TK, c1 - t0);
    __syncthreads();  // Q/acc are written; the last tile's reads are done
    for (int i = threadIdx.x; i < TK * D; i += DA_THREADS) {
      const int r = i / D, col = i % D;
      const bool in = r < n;
      const size_t gi = (size_t)(t0 + r) * D + col;
      Ks[r * (D + 1) + col] = in ? to_f(kb[gi]) : 0.f;
      Vs[i] = in ? to_f(vb[gi]) : 0.f;
    }
    __syncthreads();
    // scores: a warp takes 32 consecutive rows of one head
    for (int i = threadIdx.x; i < hg * TK; i += DA_THREADS) {
      const int hh = i / TK, r = i % TK;
      float s = -CUDART_INF_F;
      if (r < n) {
        s = 0.f;
        const float* qr = Qs + hh * D;
        const float* kr = Ks + r * (D + 1);
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      }
      Ps[i] = s;
    }
    __syncthreads();
    // online softmax: one warp per head
    for (int hh = warp; hh < hg; hh += DA_THREADS / 32) {
      float* ph = Ps + hh * TK;
      float mx = NEG;
      for (int r = lane; r < TK; r += 32) mx = fmaxf(mx, ph[r]);
      const float m_old = Mr[hh];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < TK; r += 32) {
        const float p = expf(ph[r] - m_new);  // rows past n: exp(-inf) = 0
        ph[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        Al[hh] = a;
        Lr[hh] = Lr[hh] * a + sum;
        Mr[hh] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V: consecutive threads take consecutive dims
    for (int i = threadIdx.x; i < hg * D; i += DA_THREADS) {
      const int hh = i / D, d = i % D;
      const float* ph = Ps + hh * TK;
      float a = Acc[i] * Al[hh];
      for (int r = 0; r < n; ++r) a = fmaf(ph[r], Vs[r * D + d], a);
      Acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hg; i += DA_THREADS) {
    const size_t idx = ((size_t)b * H + h0 + i) * nch + c;
    pm[idx] = Mr[i];
    pl[idx] = Lr[i];
  }
  for (int i = threadIdx.x; i < hg * D; i += DA_THREADS) {
    const int hh = i / D, d = i % D;
    pacc[(((size_t)b * H + h0 + hh) * nch + c) * D + d] = Acc[i];
  }
}

// one block per (h, b), one thread per output dim
template <typename T>
__global__ void decode_combine(const float* __restrict__ pm,
                               const float* __restrict__ pl,
                               const float* __restrict__ pacc,
                               T* __restrict__ o, int nch) {
  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x, D = blockDim.x;
  const int d = threadIdx.x;
  const size_t base = ((size_t)b * H + h) * nch;
  float M = NEG;
  for (int c = 0; c < nch; ++c)
    if (pl[base + c] > 0.f) M = fmaxf(M, pm[base + c]);
  float L = 0.f, a = 0.f;
  for (int c = 0; c < nch; ++c) {
    const float lc = pl[base + c];
    if (lc > 0.f) {  // an empty chunk wrote no acc
      const float w = expf(pm[base + c] - M);
      L += lc * w;
      a += pacc[(base + c) * D + d] * w;
    }
  }
  o[((size_t)b * H + h) * D + d] = from_f<T>(L > 0.f ? a / L : 0.f);
}

template <typename T, int D>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* length, void* o, float* pm, float* pl,
                  float* pacc, int64_t B, int64_t H, int64_t G, int64_t S,
                  int chunk, int nch, int window, float scale,
                  cudaStream_t stream) {
  const size_t smem = da_smem<D>((int)(H / G));
  cudaError_t e = cudaFuncSetAttribute(
      decode_partial<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  decode_partial<T, D><<<dim3((unsigned)nch, (unsigned)G, (unsigned)B),
                         DA_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, pm, pl, pacc, (int)H, (int)G, (int)S,
      chunk, nch, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine<T><<<dim3((unsigned)H, (unsigned)B), D, 0, stream>>>(
      pm, pl, pacc, static_cast<T*>(o), nch);
  return cudaGetLastError();
}

template <typename T>
int decode_by_dim(int D, const void* q, const void* k, const void* v,
                  const int* length, void* o, float* pm, float* pl,
                  float* pacc, int64_t B, int64_t H, int64_t G, int64_t S,
                  int chunk, int nch, int window, float scale,
                  cudaStream_t stream) {
  switch (D) {
    case 32: return launch_decode<T, 32>(q, k, v, length, o, pm, pl, pacc, B, H, G, S, chunk, nch, window, scale, stream);
    case 64: return launch_decode<T, 64>(q, k, v, length, o, pm, pl, pacc, B, H, G, S, chunk, nch, window, scale, stream);
    case 80: return launch_decode<T, 80>(q, k, v, length, o, pm, pl, pacc, B, H, G, S, chunk, nch, window, scale, stream);
    case 128: return launch_decode<T, 128>(q, k, v, length, o, pm, pl, pacc, B, H, G, S, chunk, nch, window, scale, stream);
    case 256: return launch_decode<T, 256>(q, k, v, length, o, pm, pl, pacc, B, H, G, S, chunk, nch, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// (q, k, v, o, B, H, G, Sq, Sk, D, dtype, causal, window, scale, stream);
// window <= 0 disables the window
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int64_t B,
                                     int64_t H, int64_t G, int64_t sq,
                                     int64_t sk, int D, int dtype, int causal,
                                     int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flash_by_dim<float>(D, q, k, v, o, B, H, G, sq, sk, causal, window, scale, st);
  if (dtype == 1)
    return flash_by_dim<__nv_bfloat16>(D, q, k, v, o, B, H, G, sq, sk, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

// (q, k, v, length, o, part_m, part_l, part_acc, B, H, G, S, D, dtype,
//  chunk, n_chunks, window, scale, stream); part_m/part_l are (B, H,
// n_chunks) fp32 scratch, part_acc (B, H, n_chunks, D)
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* length,
                                      void* o, void* pm, void* pl, void* pacc,
                                      int64_t B, int64_t H, int64_t G,
                                      int64_t S, int D, int dtype, int chunk,
                                      int nch, int window, float scale,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(length);
  float* m = static_cast<float*>(pm);
  float* l = static_cast<float*>(pl);
  float* acc = static_cast<float*>(pacc);
  if (dtype == 0)
    return decode_by_dim<float>(D, q, k, v, len, o, m, l, acc, B, H, G, S, chunk, nch, window, scale, st);
  if (dtype == 1)
    return decode_by_dim<__nv_bfloat16>(D, q, k, v, len, o, m, l, acc, B, H, G, S, chunk, nch, window, scale, st);
  return cudaErrorInvalidValue;
}
