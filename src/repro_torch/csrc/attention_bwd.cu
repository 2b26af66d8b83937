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
// forward does.  With P = softmax(...), Delta_i = sum_d dO[i][d] O[i][d]:
//
//     dV = P^T dO,   dP = dO V^T,   dS = P o (dP - Delta),
//     dQ = scale * dS K,   dK = scale * dS^T Q,
//
// dK and dV summed over the H / G query heads of a kv group.  The design is
// FlashAttention-2's split into two launches with no atomics, so the result
// is deterministic:
//
//  - bwd_dq, one block per (q tile of 64 rows, h, b): a first pass over the
//    visible kv tiles recomputes each row's log-sum-exp (the forward keeps
//    none yet), a second recomputes P from it, forms dP and dS and
//    accumulates dQ in registers.  It writes dQ, and the rows' LSE and
//    Delta into an fp32 workspace.  The longest causal tiles start first.
//  - bwd_dkv, one block per (kv tile of 64 rows, g, b): K and V stay in
//    shared memory while the block loops over the group's heads and the q
//    tiles that can see the tile, recomputes P from the workspace's LSE,
//    and accumulates dV += P^T dO and dK += dS^T Q in registers.
//
// Each dtype has its own pair of kernels, picked by the C dispatcher:
//
//  - bf16 (the train path): bwd_dq_tc / bwd_dkv_tc, every product on the
//    tensor cores as mma.sync m16n8k16 bf16 with fp32 accumulators.  A
//    block is 4 warps, each owning 16 rows of the block's 64 (q rows in
//    bwd_dq_tc, kv rows in bwd_dkv_tc); the other side's 64-row tiles
//    stream through a 2-stage cp.async ring in shared memory as bf16 rows
//    of pitch D + 8 (ldmatrix reads 8 rows at once without a bank
//    conflict).  Scores and dP come out as accumulator fragments; P and dS
//    are split in registers into two bf16 pieces (the rounding and the
//    rounding of the rest) and fed back as the A operand of the next
//    product (dQ += dS K; dV += P^T dO and dK += dS^T Q, bwd_dkv_tc
//    computing S^T = K Q^T so that its fragments are already P^T's rows):
//    the gradients then carry only their own bf16 rounding.
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
// cores).  A wgmma/TMA form, and an LSE output from the forward that drops
// the dQ kernels' first pass, are later work.  Head dims 32, 64, 80 and
// 128 (D = 256 does not fit the fp32 route's four tiles in shared
// memory).  A query row that sees no key gets zero gradients (the plain
// version gives NaN there, as the forward's does).  The launcher returns
// cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

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

// shared memory of either kernel: four [BT][D + 1] tiles, one [BT][BT + 1]
// score tile and two rows of BT statistics
template <int D>
constexpr size_t bwd_smem() {
  return sizeof(float) * (4 * BT * (D + 1) + BT * SP + 2 * BT);
}

// ---------------------------------------------------------------------------
// launch A: dQ, and each row's LSE and Delta

template <int D>
__global__ void __launch_bounds__(NT)
bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, const float* __restrict__ o,
       const float* __restrict__ dout, float* __restrict__ dq,
       float* __restrict__ lse_out, float* __restrict__ delta_out, int H,
       int G, int sq, int sk, int causal, int window, float scale) {
  constexpr int P = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * P;
  float* Ks = dOs + BT * P;  // O first, for Delta
  float* Vs = Ks + BT * P;
  float* Ss = Vs + BT * P;   // dS
  float* lse_s = Ss + BT * SP;
  float* delta_s = lse_s + BT;

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
  }

  // the kv tiles any row of this tile can see
  const int rows = min(BT, sq - q0);
  const int qlo = q0 + off, qhi = q0 + rows - 1 + off;
  const int k_end = causal ? min(sk, qhi + 1) : sk;
  const int k_begin = window > 0 ? max(0, qlo - window + 1) / BT * BT : 0;

  // pass 1: each row's log-sum-exp, per thread over its columns, then
  // merged across the 16 threads of the row
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
  }
  for (int k0 = k_begin; k0 < k_end; k0 += BT) {
    __syncthreads();  // the last reads of Ks are done
    load_tile<D>(Ks, kb, k0, sk);
    __syncthreads();
    float s[4][4] = {};
    mm_abt<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r + off;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = visible(qpos, k0 + tx + 16 * c, sk, causal, window)
                      ? s[r][c] * scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[r][c]);
      }
      if (mx > -CUDART_INF_F) {
        const float mn = fmaxf(m[r], mx);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) sum += expf(s[r][c] - mn);  // masked: 0
        l[r] = l[r] * expf(m[r] - mn) + sum;  // m = -inf: l = 0 anyway
        m[r] = mn;
      }
    }
  }
  float lse[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float mr = m[r], lr = l[r];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) {  // the row's threads: lanes tx ^ w
      const float m2 = __shfl_xor_sync(FULL, mr, w);
      const float l2 = __shfl_xor_sync(FULL, lr, w);
      const float mn = fmaxf(mr, m2);
      lr = (mr == -CUDART_INF_F ? 0.f : lr * expf(mr - mn)) +
           (m2 == -CUDART_INF_F ? 0.f : l2 * expf(m2 - mn));
      mr = mn;
    }
    lse[r] = mr == -CUDART_INF_F ? -CUDART_INF_F : mr + logf(lr);
    if (tx == 0) lse_s[ty + 16 * r] = lse[r];
  }

  // pass 2: P from the LSE, dS = P o (dP - Delta), dQ += dS K
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
        const bool ok = lse[r] > -CUDART_INF_F &&
                        visible(qpos, k0 + tx + 16 * c, sk, causal, window);
        const float p = ok ? expf(s[r][c] * scale - lse[r]) : 0.f;
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
  __syncthreads();  // lse_s is written
  if (tid < BT && q0 + tid < sq) {
    lse_out[bh * sq + q0 + tid] = lse_s[tid];
    delta_out[bh * sq + q0 + tid] = delta_s[tid];
  }
}

// ---------------------------------------------------------------------------
// launch B: dK and dV of one kv tile over the group's heads

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
// bf16: the tensor-core route

// -- PTX helpers

// bf16x2 of (lo, hi), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// Four 8x8 bf16 tiles: r[m] holds tile m's elements (g, 2q) and (g, 2q + 1)
// (q = lane % 4, g = lane / 4); lane i gives the address of row i % 8 of
// tile i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// the same, transposed: r[m] holds tile m's elements (2q, g), (2q + 1, g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += a b: m16n8k16, a row-major 16 x 16, b col-major 16 x 8, bf16 in,
// fp32 sum
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- end of PTX helpers

typedef __nv_bfloat16 bf16;
constexpr int TC_NT = 128;  // 4 warps, 16 rows of the block's 64 each
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem() {  // six [64][D + 8] bf16 tiles, 4 x 64 floats
  return sizeof(bf16) * 6 * BT * (D + 8) + sizeof(float) * 4 * BT;
}

// rows [r0, r0 + 64) of a (n, D) bf16 matrix -> shared [64][D + 8]: 16
// bytes a thread by cp.async, zeros past row n
template <int D>
__device__ __forceinline__ void tc_load(bf16* s, const bf16* __restrict__ g,
                                        int r0, int n) {
  constexpr int CH = D / 8, P = D + 8;
  for (int c = threadIdx.x; c < BT * CH; c += TC_NT) {
    const int r = c / CH, k = c - r * CH;
    bf16* dst = s + r * P + 8 * k;
    if (r0 + r < n) {
      cp_async16(dst, g + (size_t)(r0 + r) * D + 8 * k);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// A fragments of rows [row0, row0 + 16), columns [16 kk, 16 kk + 16) of a
// shared [rows][P] tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int P,
                                       int row0, int kk, int lane) {
  ldmatrix_x4(a, s + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * P +
                     16 * kk + 8 * (lane >> 4));
}
// B fragments of two n-tiles (rows [n0, n0 + 16) of a shared [n][k] tile)
// over k [16 kk, 16 kk + 16): b[0], b[1] of the first, b[2], b[3] of the
// second
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* s,
                                          int P, int n0, int kk, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + 8 * (lane >> 4)) * P + 16 * kk +
                     8 * ((lane >> 3) & 1));
}
// B fragments of two n-tiles (columns [n0, n0 + 16) of a shared [k][n]
// tile) over k rows [k0, k0 + 16)
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* s,
                                          int P, int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * P +
                           n0 + 8 * (lane >> 4));
}

// acc (16 x 64, 8 n-tiles) = A B^T over D: A's rows [16 warp, +16) of a
// [64][P] tile, B a [64][P] tile of the 64 columns
template <int D>
__device__ __forceinline__ void tc_abt(float (&acc)[8][4], const bf16* A,
                                       const bf16* B, int warp, int lane) {
  constexpr int P = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    frag_a(a, A, P, 16 * warp, kk, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      frag_b_nk(b, B, P, 16 * np, kk, lane);
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// the A fragments of x's columns [16 kj, 16 kj + 16) (accumulator
// fragments of n-tiles 2 kj, 2 kj + 1) in two bf16 pieces: hi, the
// rounding, and lo, the rounding of what it leaves (~16 bits of each value)
__device__ __forceinline__ void split_frag(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                           const float (&x)[8][4], int kj) {
  const float* e[4][2] = {{&x[2 * kj][0], &x[2 * kj][1]},
                          {&x[2 * kj][2], &x[2 * kj][3]},
                          {&x[2 * kj + 1][0], &x[2 * kj + 1][1]},
                          {&x[2 * kj + 1][2], &x[2 * kj + 1][3]}};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = *e[i][0], b = *e[i][1];
    hi[i] = pack_bf16(a, b);
    lo[i] = pack_bf16(a - __uint_as_float(hi[i] << 16),
                      b - __uint_as_float(hi[i] & 0xffff0000u));
  }
}

// acc (16 x D) += X Y: X (16 x 64, P or dS) in accumulator fragments (8
// n-tiles), fed as A fragments in two bf16 pieces (with one piece,
// FlashAttention-2's rounding, bf16 gradients at the training shape drifted
// past the card check's 1e-2 (1 + |g|) of the fp32 ones); Y a [64][P] tile
// of bf16 inputs, exact
template <int D>
__device__ __forceinline__ void tc_xy(float (&acc)[D / 8][4],
                                      const float (&x)[8][4], const bf16* Y,
                                      int lane) {
  constexpr int P = D + 8;
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    uint32_t hi[4], lo[4];
    split_frag(hi, lo, x, kj);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      frag_b_kn(b, Y, P, 16 * kj, 16 * np, lane);
      mma_bf16(acc[2 * np], hi, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * np], lo, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
    }
  }
}

// a row of 16 x D accumulator fragments (rows g and g + 8) -> bf16 in
// global memory, times `mul`
template <int D>
__device__ __forceinline__ void tc_store(bf16* out, const float (&acc)[D / 8][4],
                                         int row, int n, int tq, float mul) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r < n) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)(row + 8 * r) * D);
#pragma unroll
      for (int t = 0; t < D / 8; ++t)
        dst[4 * t + tq] = pack_bf16(acc[t][2 * r] * mul, acc[t][2 * r + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, bf16* __restrict__ dq,
          float* __restrict__ lse_out, float* __restrict__ delta_out, int H,
          int G, int sq, int sk, int causal, int window, float scale) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem_raw);
  bf16* dOs = Qs + BT * P;
  bf16* Ks = dOs + BT * P;  // two stages
  bf16* Vs = Ks + 2 * BT * P;
  float* delta_s = reinterpret_cast<float*>(Vs + 2 * BT * P);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int off = sk - sq;
  const size_t bh = (size_t)b * H + h;
  const bf16* kb = k + ((size_t)b * G + g) * sk * D;
  const bf16* vb = v + ((size_t)b * G + g) * sk * D;

  tc_load<D>(Qs, q + bh * sq * D, q0, sq);
  tc_load<D>(dOs, dout + bh * sq * D, q0, sq);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (tid < BT) {  // Delta_i = dO_i . O_i, O rounded as stored
    float s = 0.f;
    if (q0 + tid < sq) {
      const bf16* orow = o + (bh * sq + q0 + tid) * D;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        s = fmaf(__bfloat162float(dOs[tid * P + d]), __bfloat162float(orow[d]), s);
    }
    delta_s[tid] = s;
  }

  const int rows = min(BT, sq - q0);
  const int qlo = q0 + off, qhi = q0 + rows - 1 + off;
  const int k_end = causal ? min(sk, qhi + 1) : sk;
  const int k_begin = window > 0 ? max(0, qlo - window + 1) / BT * BT : 0;
  const int row = 16 * warp + gq;  // this thread's rows: row, row + 8
  const float sl2 = scale * LOG2E;

  // pass 1: each row's log-sum-exp (base 2, of the scaled scores)
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  if (k_begin < k_end) {
    tc_load<D>(Ks, kb, k_begin, sk);
    cp_async_commit();
  }
  int st = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BT, st ^= 1) {
    if (k0 + BT < k_end) {
      tc_load<D>(Ks + (st ^ 1) * BT * P, kb, k0 + BT, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4] = {};
    tc_abt<D>(s, Qs, Ks + st * BT * P, warp, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + row + 8 * r + off;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * t + 2 * tq + e;
          float& x = s[t][2 * r + e];
          x = visible(qpos, kpos, sk, causal, window) ? x * sl2 : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      if (mx > -CUDART_INF_F) {
        const float mn = fmaxf(m[r], mx);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t)
          sum += exp2f(s[t][2 * r] - mn) + exp2f(s[t][2 * r + 1] - mn);
        l[r] = l[r] * exp2f(m[r] - mn) + sum;
        m[r] = mn;
      }
    }
    __syncthreads();  // the stage is read before the next load overwrites it
  }
  float L[2];  // base-2 LSE of the scaled scores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mr = m[r], lr = l[r];
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {  // the row's 4 threads of the quad
      const float m2 = __shfl_xor_sync(FULL, mr, w);
      const float l2 = __shfl_xor_sync(FULL, lr, w);
      const float mn = fmaxf(mr, m2);
      lr = (mr == -CUDART_INF_F ? 0.f : lr * exp2f(mr - mn)) +
           (m2 == -CUDART_INF_F ? 0.f : l2 * exp2f(m2 - mn));
      mr = mn;
    }
    L[r] = mr == -CUDART_INF_F ? -CUDART_INF_F : mr + log2f(lr);
  }
  const float dl[2] = {delta_s[row], delta_s[row + 8]};

  // pass 2: P from the LSE, dS = P o (dP - Delta), dQ += dS K
  float acc[D / 8][4] = {};
  if (k_begin < k_end) {
    tc_load<D>(Ks, kb, k_begin, sk);
    tc_load<D>(Vs, vb, k_begin, sk);
    cp_async_commit();
  }
  st = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BT, st ^= 1) {
    if (k0 + BT < k_end) {
      tc_load<D>(Ks + (st ^ 1) * BT * P, kb, k0 + BT, sk);
      tc_load<D>(Vs + (st ^ 1) * BT * P, vb, k0 + BT, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kst = Ks + st * BT * P;
    float s[8][4] = {}, dp[8][4] = {};
    tc_abt<D>(s, Qs, Kst, warp, lane);
    tc_abt<D>(dp, dOs, Vs + st * BT * P, warp, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + row + 8 * r + off;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * t + 2 * tq + e;
          const bool ok = L[r] > -CUDART_INF_F &&
                          visible(qpos, kpos, sk, causal, window);
          const float p = ok ? exp2f(s[t][2 * r + e] * sl2 - L[r]) : 0.f;
          s[t][2 * r + e] = p * (dp[t][2 * r + e] - dl[r]);  // dS
        }
    }
    tc_xy<D>(acc, s, Kst, lane);
    __syncthreads();
  }

  tc_store<D>(dq + bh * sq * D, acc, q0 + row, sq, tq, scale);
  if (tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + row + 8 * r;
      if (i < sq) {
        lse_out[bh * sq + i] = L[r] == -CUDART_INF_F ? -CUDART_INF_F : L[r] / LOG2E;
        delta_out[bh * sq + i] = dl[r];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int G, int sq,
           int sk, int causal, int window, float scale) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char tc_smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem_raw);
  bf16* Vs = Ks + BT * P;
  bf16* Qs = Vs + BT * P;     // two stages
  bf16* dOs = Qs + 2 * BT * P;  // two stages
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BT * P);  // [2][BT], base 2
  float* delta_s = lse_s + 2 * BT;                           // [2][BT]

  const int k0 = blockIdx.x * BT;
  const int g = blockIdx.y, b = blockIdx.z;
  const int hg = H / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int off = sk - sq;
  const size_t bg = (size_t)b * G + g;
  const float sl2 = scale * LOG2E;

  // the q rows that can see a key of this tile, in tiles of 64, per head
  const int kmax = min(sk, k0 + BT) - 1;
  const int i_begin = causal ? max(0, k0 - off) : 0;
  const int i_end = window > 0 ? min(sq, kmax + window - off) : sq;
  const int n_qt = i_end > i_begin ? (i_end - i_begin + BT - 1) / BT : 0;
  const int n_it = hg * n_qt;

  // stage `st` <- the Q and dO tiles, LSE and Delta of iteration `it`
  auto load_stage = [&](int st, int it) {
    const size_t bh = (size_t)b * H + g * hg + it / n_qt;
    const int i0 = i_begin + (it % n_qt) * BT;
    tc_load<D>(Qs + st * BT * P, q + bh * sq * D, i0, sq);
    tc_load<D>(dOs + st * BT * P, dout + bh * sq * D, i0, sq);
    if (tid < BT) {
      const int i = i0 + tid;
      lse_s[st * BT + tid] = i < sq ? lse[bh * sq + i] * LOG2E : -CUDART_INF_F;
      delta_s[st * BT + tid] = i < sq ? delta[bh * sq + i] : 0.f;
    }
  };

  tc_load<D>(Ks, k + bg * sk * D, k0, sk);
  tc_load<D>(Vs, v + bg * sk * D, k0, sk);
  if (n_it > 0) load_stage(0, 0);
  cp_async_commit();

  const int row = 16 * warp + gq;  // this thread's kv rows: row, row + 8
  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  int st = 0;
  for (int it = 0; it < n_it; ++it, st ^= 1) {
    if (it + 1 < n_it) {
      load_stage(st ^ 1, it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i0 = i_begin + (it % n_qt) * BT;
    const bf16* Qst = Qs + st * BT * P;
    const bf16* dOst = dOs + st * BT * P;
    const float* Ls = lse_s + st * BT;
    const float* Ds = delta_s + st * BT;
    float s[8][4] = {}, dp[8][4] = {};
    tc_abt<D>(s, Ks, Qst, warp, lane);   // S^T: rows kv, columns q
    tc_abt<D>(dp, Vs, dOst, warp, lane); // dP^T
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = k0 + row + 8 * r;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * t + 2 * tq + e, i = i0 + c;
          const float Lc = Ls[c];
          const bool ok = i < sq && Lc > -CUDART_INF_F &&
                          visible(i + off, kpos, sk, causal, window);
          const float p = ok ? exp2f(s[t][2 * r + e] * sl2 - Lc) : 0.f;
          s[t][2 * r + e] = p;                              // P^T
          dp[t][2 * r + e] = p * (dp[t][2 * r + e] - Ds[c]);  // dS^T
        }
    }
    tc_xy<D>(dv_acc, s, dOst, lane);   // dV += P^T dO
    tc_xy<D>(dk_acc, dp, Qst, lane);   // dK += dS^T Q
    __syncthreads();
  }
  cp_async_wait<0>();

  tc_store<D>(dk + bg * sk * D, dk_acc, k0 + row, sk, tq, scale);
  tc_store<D>(dv + bg * sk * D, dv_acc, k0 + row, sk, tq, 1.f);
}

template <int D>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, void* dq, void* dk, void* dv, float* lse,
                  float* delta, int64_t B, int64_t H, int64_t G, int64_t sq,
                  int64_t sk, int causal, int window, float scale,
                  cudaStream_t stream) {
  const size_t smem = tc_smem<D>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dq_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(bwd_dkv_tc<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  bwd_dq_tc<D><<<dim3((unsigned)((sq + BT - 1) / BT), (unsigned)H, (unsigned)B),
                 TC_NT, smem, stream>>>(
      qt, kt, vt, static_cast<const bf16*>(o), dot, static_cast<bf16*>(dq),
      lse, delta, (int)H, (int)G, (int)sq, (int)sk, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkv_tc<D><<<dim3((unsigned)((sk + BT - 1) / BT), (unsigned)G, (unsigned)B),
                  TC_NT, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), (int)H, (int)G, (int)sq, (int)sk, causal, window,
      scale);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, void* dq, void* dk, void* dv, float* lse,
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
      qt, kt, vt, static_cast<const float*>(o), dot, static_cast<float*>(dq), lse,
      delta, (int)H, (int)G, (int)sq, (int)sk, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bwd_dkv<D><<<dim3((unsigned)((sk + BT - 1) / BT), (unsigned)G, (unsigned)B),
                  NT, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      (int)H, (int)G, (int)sq, (int)sk, causal, window, scale);
  return cudaGetLastError();
}

int bwd_by_dim(int D, const void* q, const void* k, const void* v,
               const void* o, const void* dout, void* dq, void* dk, void* dv,
               float* lse, float* delta, int64_t B, int64_t H, int64_t G,
               int64_t sq, int64_t sk, int causal, int window, float scale,
               cudaStream_t st) {
  switch (D) {
    case 32: return launch_bwd<32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, G, sq, sk, causal, window, scale, st);
    case 64: return launch_bwd<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, G, sq, sk, causal, window, scale, st);
    case 80: return launch_bwd<80>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, G, sq, sk, causal, window, scale, st);
    case 128: return launch_bwd<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, G, sq, sk, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

int bwd_tc_by_dim(int D, const void* q, const void* k, const void* v,
                  const void* o, const void* dout, void* dq, void* dk,
                  void* dv, float* lse, float* delta, int64_t B, int64_t H,
                  int64_t G, int64_t sq, int64_t sk, int causal, int window,
                  float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch_bwd_tc<32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, G, sq, sk, causal, window, scale, st);
    case 64: return launch_bwd_tc<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, G, sq, sk, causal, window, scale, st);
    case 80: return launch_bwd_tc<80>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, G, sq, sk, causal, window, scale, st);
    case 128: return launch_bwd_tc<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, G, sq, sk, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// (q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, G, Sq, Sk, D, dtype,
//  causal, window, scale, stream); lse and delta are (B, H, Sq) fp32
// workspace; window <= 0 disables the window
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int64_t B, int64_t H, int64_t G, int64_t sq, int64_t sk, int D, int dtype,
    int causal, int window, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return bwd_by_dim(D, q, k, v, o, dout, dq, dk, dv, l, dl, B, H, G, sq, sk, causal, window, scale, st);
  if (dtype == 1)
    return bwd_tc_by_dim(D, q, k, v, o, dout, dq, dk, dv, l, dl, B, H, G, sq, sk, causal, window, scale, st);
  return cudaErrorInvalidValue;
}
