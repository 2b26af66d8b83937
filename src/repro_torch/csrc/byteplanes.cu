// Page-wise byte-plane transposes of the RNT-J split encoding.
//
// K2 repro_byteshuffle_pages: (P, per, nb) uint8 -> (P, nb, per)
//   replaces byteshuffle_pages (src/repro/kernels/byteshuffle.py, the
//   Pallas kernel of the seal path's page-wise split).
// K3 repro_unsplit_pages:     (P, nb, per) uint8 -> (P, per, nb)
//   replaces unsplit_pages (src/repro/kernels/decode_pages.py, the
//   Pallas kernel of the device read-back of split columns).
// K9 repro_byteshuffle:       (N, nb) uint8 -> (nb, N), any nb >= 1
//   replaces byteshuffle (src/repro/kernels/byteshuffle.py, the Pallas
//   single-buffer split behind ops.byteshuffle).  One page of per = N
//   through K2's code: the vector path for nb in {1, 2, 4, 8}, the
//   scalar path (runtime nb) for other widths, ragged N or unaligned
//   pointers.  Bound: 2 N nb bytes (2^24 x 8 bytes: 268 MB, 0.080 ms).
//
// Bound on an H100 (3.35 TB/s): bytes.  Each kernel reads every byte once
// and writes it once and computes nothing: 2 * P * per * nb bytes.  On the
// main path (64 KiB pages, clusters of about 300k entries) one 8-byte
// column moves about 4.8 MB (about 1.4 us) and the float32 column about
// 12 MB (about 3.6 us): less than one PCIe copy of the same bytes, so on
// the seal path the host entry's copies, not the kernel, set the time.
// chip_smoke.py computes each launch's bound from its own shapes.
//
// Design: a page is its own transpose, so a block takes (page, chunk of
// elements) and never crosses a page.  With nb <= 8 a 16-byte vector holds
// 16 / nb whole elements, so the transpose happens in registers: each
// thread moves one 16-byte vector of the element-major side (one load for
// K2, one store for K3) and 16 / nb bytes of each of the nb planes (one
// word per plane).  Consecutive threads take consecutive vectors, so both
// sides are coalesced and no shared memory is needed.  When `per` is not
// a multiple of 16 / nb or a pointer is not 16-byte aligned, a scalar
// kernel moves one element per thread and masks the ragged chunk itself.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kVecsPerBlock = kThreads * 4;    // vector path
constexpr int64_t kElemsPerBlock = kThreads * 4;   // scalar path

template <int NB> struct PlaneWord;
template <> struct PlaneWord<1> { using T = uint4; };
template <> struct PlaneWord<2> { using T = unsigned long long; };
template <> struct PlaneWord<4> { using T = unsigned int; };
template <> struct PlaneWord<8> { using T = unsigned short; };

// K2, vector path: element-major 16-byte vectors -> one word per plane.
template <int NB>
__global__ void __launch_bounds__(kThreads)
shuffle_vec(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            int64_t per, int64_t chunks) {
  constexpr int EPV = 16 / NB;
  using W = typename PlaneWord<NB>::T;
  const int64_t page = blockIdx.x / chunks;
  const int64_t v0 = (blockIdx.x % chunks) * kVecsPerBlock;
  const int64_t nv = per / EPV;
  const int64_t v1 = v0 + kVecsPerBlock < nv ? v0 + kVecsPerBlock : nv;
  const uint4* src = reinterpret_cast<const uint4*>(in + page * per * NB);
  uint8_t* dst = out + page * per * NB;  // plane j at dst + j * per
  for (int64_t v = v0 + threadIdx.x; v < v1; v += kThreads) {
    repro::V16 x;
    x.v = src[v];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      repro::Word<W, EPV> w;
#pragma unroll
      for (int k = 0; k < EPV; ++k) w.b[k] = x.b[k * NB + j];
      reinterpret_cast<W*>(dst + j * per)[v] = w.w;
    }
  }
}

// K3, vector path: one word per plane -> element-major 16-byte vectors.
template <int NB>
__global__ void __launch_bounds__(kThreads)
unsplit_vec(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            int64_t per, int64_t chunks) {
  constexpr int EPV = 16 / NB;
  using W = typename PlaneWord<NB>::T;
  const int64_t page = blockIdx.x / chunks;
  const int64_t v0 = (blockIdx.x % chunks) * kVecsPerBlock;
  const int64_t nv = per / EPV;
  const int64_t v1 = v0 + kVecsPerBlock < nv ? v0 + kVecsPerBlock : nv;
  const uint8_t* src = in + page * per * NB;  // plane j at src + j * per
  uint4* dst = reinterpret_cast<uint4*>(out + page * per * NB);
  for (int64_t v = v0 + threadIdx.x; v < v1; v += kThreads) {
    repro::V16 x;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      repro::Word<W, EPV> w;
      w.w = reinterpret_cast<const W*>(src + j * per)[v];
#pragma unroll
      for (int k = 0; k < EPV; ++k) x.b[k * NB + j] = w.b[k];
    }
    dst[v] = x.v;
  }
}

// Both directions, scalar path: one element per thread, any alignment.
template <bool SHUFFLE>
__global__ void __launch_bounds__(kThreads)
transpose_scalar(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int64_t per, int nb, int64_t chunks) {
  const int64_t page = blockIdx.x / chunks;
  const int64_t e0 = (blockIdx.x % chunks) * kElemsPerBlock;
  const int64_t e1 = e0 + kElemsPerBlock < per ? e0 + kElemsPerBlock : per;
  const int64_t base = page * per * nb;
  for (int64_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
    for (int j = 0; j < nb; ++j) {
      const int64_t rowmajor = base + e * nb + j;   // (per, nb) side
      const int64_t planar = base + j * per + e;    // (nb, per) side
      if (SHUFFLE) out[planar] = in[rowmajor];
      else out[rowmajor] = in[planar];
    }
  }
}

template <bool SHUFFLE>
int launch_scalar(const uint8_t* in, uint8_t* out, int64_t n_pages,
                  int64_t per, int nb, cudaStream_t stream) {
  const int64_t chunks = (per + kElemsPerBlock - 1) / kElemsPerBlock;
  const dim3 grid(static_cast<unsigned>(n_pages * chunks));
  transpose_scalar<SHUFFLE><<<grid, kThreads, 0, stream>>>(in, out, per, nb, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <int NB, bool SHUFFLE>
int launch(const uint8_t* in, uint8_t* out, int64_t n_pages, int64_t per,
           cudaStream_t stream) {
  constexpr int EPV = 16 / NB;
  if (per % EPV != 0 || !repro::aligned(in, 16) || !repro::aligned(out, 16))
    return launch_scalar<SHUFFLE>(in, out, n_pages, per, NB, stream);
  const int64_t chunks = (per / EPV + kVecsPerBlock - 1) / kVecsPerBlock;
  const dim3 grid(static_cast<unsigned>(n_pages * chunks));
  if (SHUFFLE) shuffle_vec<NB><<<grid, kThreads, 0, stream>>>(in, out, per, chunks);
  else unsplit_vec<NB><<<grid, kThreads, 0, stream>>>(in, out, per, chunks);
  return static_cast<int>(cudaGetLastError());
}

template <bool SHUFFLE>
int dispatch(const void* in, void* out, int64_t n_pages, int64_t per, int nb,
             void* stream) {
  if (n_pages <= 0 || per <= 0) return 0;
  const auto* i = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (nb) {
    case 1: return launch<1, SHUFFLE>(i, o, n_pages, per, s);
    case 2: return launch<2, SHUFFLE>(i, o, n_pages, per, s);
    case 4: return launch<4, SHUFFLE>(i, o, n_pages, per, s);
    case 8: return launch<8, SHUFFLE>(i, o, n_pages, per, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_byteshuffle_pages(const void* in, void* out,
                                       int64_t n_pages, int64_t per, int nb,
                                       void* stream) {
  return dispatch<true>(in, out, n_pages, per, nb, stream);
}

extern "C" int repro_unsplit_pages(const void* in, void* out, int64_t n_pages,
                                   int64_t per, int nb, void* stream) {
  return dispatch<false>(in, out, n_pages, per, nb, stream);
}

extern "C" int repro_byteshuffle(const void* in, void* out, int64_t n, int nb,
                                 void* stream) {
  if (nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  switch (nb) {
    case 1: case 2: case 4: case 8:
      return dispatch<true>(in, out, 1, n, nb, stream);
    default:
      return launch_scalar<true>(static_cast<const uint8_t*>(in),
                                 static_cast<uint8_t*>(out), 1, n, nb,
                                 static_cast<cudaStream_t>(stream));
  }
}
