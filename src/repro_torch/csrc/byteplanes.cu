// Page-wise byte-plane transposes of the RNT-J split encoding.
//
// K2 repro_byteshuffle_pages: (P, per, nb) uint8 -> (P, nb, per)
//   replaces byteshuffle_pages (src/repro/kernels/byteshuffle.py,
//   `byteshuffle_pages` / `_shuffle_pages_kernel`, the Pallas kernel of
//   the seal path's page-wise split).
// K3 repro_unsplit_pages:     (P, nb, per) uint8 -> (P, per, nb)
//   replaces unsplit_pages (src/repro/kernels/decode_pages.py, the
//   Pallas kernel of the device read-back of split columns).
// K9 repro_byteshuffle:       (N, nb) uint8 -> (nb, N), any nb >= 1
//   replaces byteshuffle (src/repro/kernels/byteshuffle.py, the Pallas
//   single-buffer split behind ops.byteshuffle).  One page of per = N
//   through K2's code: the register form for nb in {1, 2, 4, 8}, the
//   scalar path (runtime nb) for other widths, N % 16 != 0 or unaligned
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
// A page is its own transpose, so no thread's work crosses a page.
//
// K2 (and K9, one page of per = N), register form.  The first design
// gave each thread one 16-byte vector of 16 / nb elements at a time and
// stored it as nb words of 16 / nb bytes (2-byte stores at nb = 8: eight
// stores for every 16 bytes read), walking 4 vectors in series per
// thread in blocks of 256: at (36, 8192, 8) 144 blocks with about a
// quarter of the 2.36 MB requested at once.  Now a thread owns 16
// consecutive elements of one page and writes nb full 16-byte vectors,
// one to each plane (neighbouring threads write neighbouring vectors of a
// plane), after transposing its 16 x nb byte matrix in registers with
// `prmt` (__byte_perm: 4 x 4 byte-block transposes at nb = 4 and 8, one
// two-word gather per plane word at nb = 2).  Its warp first issues all
// of its loads at once, coalesced (lane l takes 16-byte chunk 32 k + l of
// the warp's 32 nb), and stages them in shared memory under an XOR
// swizzle (slot = chunk ^ bits 3-5 of the chunk: no bank conflict when
// storing or when each thread reads back its own nb chunks).  Loading a
// thread's own 16 nb bytes straight from global memory instead puts 32
// cache lines in every warp request (16 nb bytes apart): 0.00650 against
// 0.00614 ms at (36, 8192, 8) and 0.1010 against 0.0949 ms at (2^24, 8),
// 128-thread blocks, on an H100 80GB HBM3 at 700 W.  A block
// has 256 / nb threads, 4 KB each way: at nb 8, one warp a block (576
// blocks at (36, 8192, 8)) beat 64- and 128-thread blocks; at nb 4, 64
// threads (1,456 blocks at (91, 16384, 4)) beat 32 and tied 128.  It
// takes per % 16 == 0 and 16-byte aligned pointers; any other page width
// or pointer takes the scalar kernel, a route of its own (one element a
// thread, any nb, any alignment).
// Measured (`python -m repro_torch.launch.scan_builds`, interleaved with
// the first design; NVIDIA H100 80GB HBM3, 700 W): 0.00582 against
// 0.00624 ms at (36, 8192, 8) and 0.00661 against 0.00722 at (91, 16384,
// 4); K9 0.0947 against 0.0963 ms at (2^24, 8).  Every time sits on a
// launch floor of 0.0053 ms (the same entry at (1, 16, 8), timed the same
// way), so the part above the floor fell from 0.0010 to 0.0005 ms and
// from 0.0019 to 0.0013 ms.  Staging through TMA (cp.async.bulk) was not
// built: at 1.10-1.25x the floor there is little left for it to take.
//
// K3, register form: K2's design run backwards.  The first design gave
// each thread one 16-byte vector of the element-major side and one word of
// 16 / nb bytes from each plane (4-byte loads at nb = 4, 2-byte at nb =
// 8).  Now a thread owns 16 consecutive elements of one page and reads nb
// full 16-byte vectors, one from each plane (neighbouring threads read
// neighbouring vectors of a plane: coalesced), transposes the 16 x nb
// bytes in registers with `prmt` (elems_of, the inverse of planes_of), and
// stages its nb element-major chunks in shared memory under K2's XOR
// swizzle, from which lane l of its warp stores chunk 32 k + l of the
// warp's 32 nb (coalesced 16-byte stores).  Blocks of 256 / nb threads, as
// K2's.  It takes per % 16 == 0 and 16-byte aligned pointers; any other
// page width or pointer takes the scalar kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kElemsPerBlock = kThreads * 4;   // scalar path
constexpr int kRegElems = 16;                      // K2, K3: elements a thread
// K2's and K3's threads a block: 256 / nb, so a block moves 4 KB each way
// at every element width (one warp at nb = 8)
template <int NB> constexpr int kRegBlock = 256 / NB;

// The 16 x NB byte matrix of a thread's 16 elements, as 4 NB words in
// element-major order (`w`: element e's bytes at bytes e NB .. e NB + NB -
// 1), -> its NB planes of 16 bytes (`o[j]`: byte j of elements 0..15).
template <int NB>
__device__ __forceinline__ void planes_of(const uint32_t (&w)[4 * NB],
                                          uint32_t (&o)[NB][4]) {
  if constexpr (NB == 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) o[0][q] = w[q];
  } else if constexpr (NB == 2) {
    // word i holds elements 2i and 2i + 1; plane word q gathers byte j
    // of elements 4q..4q+3 from words 2q and 2q + 1
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[0][q] = __byte_perm(w[2 * q], w[2 * q + 1], 0x6420);
      o[1][q] = __byte_perm(w[2 * q], w[2 * q + 1], 0x7531);
    }
  } else if constexpr (NB == 4) {
    // word e is element e: one 4 x 4 block per 4 elements
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t b[4] = {w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]};
      repro::transpose4x4(b);
#pragma unroll
      for (int m = 0; m < 4; ++m) o[m][q] = b[m];
    }
  } else {
    static_assert(NB == 8, "element widths 1, 2, 4 and 8");
    // words 2e and 2e + 1 are element e's bytes 0-3 and 4-7: one 4 x 4
    // block per 4 elements and half
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4] = {w[8 * q + h], w[8 * q + 2 + h], w[8 * q + 4 + h],
                         w[8 * q + 6 + h]};
        repro::transpose4x4(b);
#pragma unroll
        for (int m = 0; m < 4; ++m) o[4 * h + m][q] = b[m];
      }
    }
  }
}

// K2, register form: thread g takes elements [16 g, 16 g + 16) of the
// (P * per) element rows, all in page g / (per / 16).
template <int NB>
__global__ void __launch_bounds__(kRegBlock<NB>)
shuffle_reg(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            int64_t per, int64_t n_threads) {
  // the warp's 32 NB chunks of 16 bytes: loaded coalesced (lane l takes
  // chunk 32 k + l), staged in shared memory with the 16-byte slot XORed
  // by bits 3-5 of the chunk (no bank conflict either way), read back as
  // each thread's own NB chunks
  __shared__ uint4 stage[kRegBlock<NB> / 32][32 * NB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t g = int64_t(blockIdx.x) * kRegBlock<NB> + threadIdx.x;
  const int64_t c0 = (g - lane) * NB;  // the warp's first chunk
  const int64_t n_chunks = n_threads * NB;
  const uint4* src = reinterpret_cast<const uint4*>(in);
  uint4 v[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {  // every load before any arithmetic
    const int64_t c = c0 + 32 * k + lane;
    v[k] = c < n_chunks ? src[c] : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int c = 32 * k + lane;
    stage[warp][c ^ ((c >> 3) & 7)] = v[k];
  }
  __syncwarp();
  if (g >= n_threads) return;
  const int64_t groups = per / kRegElems;  // threads a page
  const int64_t page = g / groups;
  const int64_t e0 = (g - page * groups) * kRegElems;
  uint32_t w[4 * NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int c = NB * lane + k;
    const uint4 x = stage[warp][c ^ ((c >> 3) & 7)];
    w[4 * k] = x.x;
    w[4 * k + 1] = x.y;
    w[4 * k + 2] = x.z;
    w[4 * k + 3] = x.w;
  }
  uint32_t o[NB][4];
  planes_of<NB>(w, o);
  uint8_t* dst = out + page * per * NB + e0;  // plane j at dst + j * per
#pragma unroll
  for (int j = 0; j < NB; ++j)
    *reinterpret_cast<uint4*>(dst + j * per) = make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
}

// The inverse of planes_of: NB planes of 16 bytes (`o[j]`: byte j of
// elements 0..15) -> the 16 x NB byte matrix as 4 NB element-major words
// (`w`: element e's bytes at bytes e NB .. e NB + NB - 1).
template <int NB>
__device__ __forceinline__ void elems_of(const uint32_t (&o)[NB][4],
                                         uint32_t (&w)[4 * NB]) {
  if constexpr (NB == 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = o[0][q];
  } else if constexpr (NB == 2) {
    // plane word q holds byte j of elements 4q..4q+3; words 2q and 2q + 1
    // interleave the two planes' bytes
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[2 * q] = __byte_perm(o[0][q], o[1][q], 0x5140);
      w[2 * q + 1] = __byte_perm(o[0][q], o[1][q], 0x7362);
    }
  } else if constexpr (NB == 4) {
    // one 4 x 4 block per 4 elements: rows the planes, columns the elements
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t b[4] = {o[0][q], o[1][q], o[2][q], o[3][q]};
      repro::transpose4x4(b);
#pragma unroll
      for (int m = 0; m < 4; ++m) w[4 * q + m] = b[m];
    }
  } else {
    static_assert(NB == 8, "element widths 1, 2, 4 and 8");
    // planes 4h..4h+3 of elements 4q..4q+3 -> words 2e + h
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4] = {o[4 * h][q], o[4 * h + 1][q], o[4 * h + 2][q],
                         o[4 * h + 3][q]};
        repro::transpose4x4(b);
#pragma unroll
        for (int m = 0; m < 4; ++m) w[8 * q + 2 * m + h] = b[m];
      }
    }
  }
}

// K3, register form: thread g takes elements [16 g, 16 g + 16) of the
// (P * per) element rows, all in page g / (per / 16).
template <int NB>
__global__ void __launch_bounds__(kRegBlock<NB>)
unsplit_reg(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
            int64_t per, int64_t n_threads) {
  // the warp's 32 NB output chunks of 16 bytes: each thread stages its own
  // NB (chunks NB lane + k) with the slot XORed by bits 3-5 of the chunk,
  // lane l stores chunks 32 k + l
  __shared__ uint4 stage[kRegBlock<NB> / 32][32 * NB];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t g = int64_t(blockIdx.x) * kRegBlock<NB> + threadIdx.x;
  if (g < n_threads) {
    const int64_t groups = per / kRegElems;  // threads a page
    const int64_t page = g / groups;
    const int64_t e0 = (g - page * groups) * kRegElems;
    const uint8_t* src = in + page * per * NB + e0;  // plane j at src + j * per
    uint32_t o[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {  // every load before any arithmetic
      const uint4 x = *reinterpret_cast<const uint4*>(src + j * per);
      o[j][0] = x.x;
      o[j][1] = x.y;
      o[j][2] = x.z;
      o[j][3] = x.w;
    }
    uint32_t w[4 * NB];
    elems_of<NB>(o, w);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int c = NB * lane + k;
      stage[warp][c ^ ((c >> 3) & 7)] =
          make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    }
  }
  __syncwarp();
  const int64_t c0 = (g - lane) * NB;  // the warp's first chunk
  const int64_t n_chunks = n_threads * NB;
  uint4* dst = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const int c = 32 * k + lane;
    if (c0 + c < n_chunks) dst[c0 + c] = stage[warp][c ^ ((c >> 3) & 7)];
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

template <int NB>
int launch_shuffle(const uint8_t* in, uint8_t* out, int64_t n_pages, int64_t per,
                   cudaStream_t stream) {
  if (per % kRegElems != 0 || !repro::aligned(in, 16) || !repro::aligned(out, 16))
    return launch_scalar<true>(in, out, n_pages, per, NB, stream);
  const int64_t threads = n_pages * (per / kRegElems);
  const dim3 grid(static_cast<unsigned>((threads + kRegBlock<NB> - 1) / kRegBlock<NB>));
  shuffle_reg<NB><<<grid, kRegBlock<NB>, 0, stream>>>(in, out, per, threads);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int launch_unsplit(const uint8_t* in, uint8_t* out, int64_t n_pages, int64_t per,
                   cudaStream_t stream) {
  if (per % kRegElems != 0 || !repro::aligned(in, 16) || !repro::aligned(out, 16))
    return launch_scalar<false>(in, out, n_pages, per, NB, stream);
  const int64_t threads = n_pages * (per / kRegElems);
  const dim3 grid(static_cast<unsigned>((threads + kRegBlock<NB> - 1) / kRegBlock<NB>));
  unsplit_reg<NB><<<grid, kRegBlock<NB>, 0, stream>>>(in, out, per, threads);
  return static_cast<int>(cudaGetLastError());
}

template <int NB, bool SHUFFLE>
int launch(const uint8_t* in, uint8_t* out, int64_t n_pages, int64_t per,
           cudaStream_t stream) {
  return SHUFFLE ? launch_shuffle<NB>(in, out, n_pages, per, stream)
                 : launch_unsplit<NB>(in, out, n_pages, per, stream);
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
