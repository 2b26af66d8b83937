// Scans and delta codes of the RNT-J offset columns.
//
// K1 repro_offsets_scan_i64: (N,) int64 sizes -> (N,) int64 inclusive scan
//   replaces offsets_scan (src/repro/kernels/offsets_scan.py, the Pallas
//   kernel that integrates a fill batch's collection sizes into end
//   offsets).
// K4 repro_decode_offset_pages: (P, 8, per) uint8 -> (P, per) int32
//   replaces decode_offset_pages (src/repro/kernels/decode_pages.py, the
//   Pallas kernel of the device read-back of offset columns).
// K10 repro_delta_zigzag_i32 / _i64: (N,) int32 -> uint32, int64 -> uint64
//   replaces delta_zigzag (src/repro/kernels/delta_zigzag.py, the Pallas
//   kernel behind ops.delta_zigzag): z[i] = zigzag(x[i] - x[i-1]) with
//   x[-1] = 0, the encode side of K4's unzigzag.
//
// Bound on an H100 (3.35 TB/s): bytes; the adds are far below the card's
// integer rate.  K1 reads 8 N and writes 8 N bytes: a fill batch of 100k
// sizes is 1.6 MB, about 0.5 us.  K4 reads the four low byte planes
// (4 P per bytes) and writes 4 P per bytes of int32: for one cluster's
// offset column of about 300k entries, 2.4 MB, about 0.7 us.  Both are
// far below a launch plus the PCIe copies around them.  K10 reads and
// writes each element once: 2^24 int64 move 268 MB, 0.080 ms.
//
// Design.  The TPU kernels walk a sequential grid with a running carry in
// SMEM; blocks on the card run in no order, so:
// * K1 is a three-pass scan.  Pass 1: each block scans its tile of 4096
//   values (16 rounds of a 256-thread block scan with a carry between
//   rounds; loads and stores coalesced) and writes the tile's total.
//   Pass 2: one block scans the tile totals into exclusive prefixes.
//   Pass 3: each block after the first adds its prefix to its tile.  The
//   adds are in uint64, i.e. two's-complement int64, so the result equals
//   numpy's int64 cumsum bit for bit.
// * K4 needs no carry across blocks: pages restart their deltas.  One
//   block takes one page and loops over it in rounds of 1024 elements;
//   each thread gathers bytes 0-3 of four consecutive elements from the
//   four low planes (one 4-byte load per plane where aligned),
//   un-zigzags, scans its four values, and the block scan adds the
//   running carry of the page.  int32 is exact under the reader's route
//   guard (the cluster's child total is below 2^31).
// * K10 needs no carry at all: the Pallas kernel carries the previous
//   block's last element across its sequential grid, but each element's
//   delta needs only its predecessor.  A thread takes 16 bytes (four
//   int32 or two int64; one vector load and store where both pointers
//   are 16-byte aligned, scalar loads otherwise) and reads the element
//   before them itself (its neighbour's, from L1/L2).  The subtraction
//   and the shift run in the unsigned type, where they wrap as the
//   reference's int32/int64 jnp ops do (signed overflow is undefined in
//   C++); the sign mask is the arithmetic shift of the signed delta.
#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kScanThreads = 256;
constexpr int kScanRounds = 16;
constexpr int64_t kScanTile = int64_t(kScanThreads) * kScanRounds;  // 4096

__global__ void __launch_bounds__(kScanThreads)
scan_tiles(const u64* __restrict__ in, u64* __restrict__ out,
           u64* __restrict__ tile_sums, int64_t n) {
  __shared__ u64 ws[kScanThreads / 32];
  const int64_t base = int64_t(blockIdx.x) * kScanTile;
  u64 carry = 0;
  for (int r = 0; r < kScanRounds; ++r) {
    const int64_t start = base + int64_t(r) * kScanThreads;
    if (start >= n) break;  // uniform across the block
    const int64_t i = start + threadIdx.x;
    const u64 v = i < n ? in[i] : 0ull;
    u64 total;
    const u64 s = repro::block_inclusive_scan<u64, kScanThreads>(v, ws, total);
    if (i < n) out[i] = s + carry;
    carry += total;
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = carry;
}

// One block: tile totals -> exclusive prefixes, in place.
__global__ void __launch_bounds__(kScanThreads)
scan_tile_sums(u64* __restrict__ sums, int64_t m) {
  __shared__ u64 ws[kScanThreads / 32];
  u64 carry = 0;
  for (int64_t start = 0; start < m; start += kScanThreads) {
    const int64_t i = start + threadIdx.x;
    const u64 v = i < m ? sums[i] : 0ull;
    u64 total;
    const u64 s = repro::block_inclusive_scan<u64, kScanThreads>(v, ws, total);
    if (i < m) sums[i] = carry + s - v;
    carry += total;
  }
}

// Block b adds the prefix of tile b + 1 (tile 0's prefix is 0).
__global__ void __launch_bounds__(kScanThreads)
add_tile_prefix(u64* __restrict__ out, const u64* __restrict__ sums, int64_t n) {
  const int64_t tile = int64_t(blockIdx.x) + 1;
  const u64 add = sums[tile];
  const int64_t base = tile * kScanTile;
  const int64_t end = base + kScanTile < n ? base + kScanTile : n;
  for (int64_t i = base + threadIdx.x; i < end; i += kScanThreads) out[i] += add;
}

constexpr int kDecThreads = 256;
constexpr int kDecItems = 4;
constexpr int64_t kDecRound = int64_t(kDecThreads) * kDecItems;  // 1024

__device__ __forceinline__ unsigned unzigzag(unsigned z) {
  return (z >> 1) ^ (0u - (z & 1u));
}

__global__ void __launch_bounds__(kDecThreads)
decode_offsets(const uint8_t* __restrict__ planes, int32_t* __restrict__ out,
               int64_t per, bool vec) {
  __shared__ unsigned ws[kDecThreads / 32];
  const int64_t page = blockIdx.x;
  const uint8_t* p = planes + page * 8 * per;  // plane j at p + j * per
  int32_t* o = out + page * per;
  unsigned carry = 0;
  for (int64_t r0 = 0; r0 < per; r0 += kDecRound) {
    const int64_t e0 = r0 + int64_t(threadIdx.x) * kDecItems;
    const bool full = vec && e0 + kDecItems <= per;
    unsigned s[kDecItems];
    if (full) {
      const uchar4 b0 = *reinterpret_cast<const uchar4*>(p + e0);
      const uchar4 b1 = *reinterpret_cast<const uchar4*>(p + per + e0);
      const uchar4 b2 = *reinterpret_cast<const uchar4*>(p + 2 * per + e0);
      const uchar4 b3 = *reinterpret_cast<const uchar4*>(p + 3 * per + e0);
      s[0] = unzigzag(b0.x | (b1.x << 8) | (b2.x << 16) | (unsigned(b3.x) << 24));
      s[1] = unzigzag(b0.y | (b1.y << 8) | (b2.y << 16) | (unsigned(b3.y) << 24));
      s[2] = unzigzag(b0.z | (b1.z << 8) | (b2.z << 16) | (unsigned(b3.z) << 24));
      s[3] = unzigzag(b0.w | (b1.w << 8) | (b2.w << 16) | (unsigned(b3.w) << 24));
    } else {
#pragma unroll
      for (int k = 0; k < kDecItems; ++k) {
        const int64_t e = e0 + k;
        s[k] = e < per
                   ? unzigzag(p[e] | (p[per + e] << 8) | (p[2 * per + e] << 16) |
                              (unsigned(p[3 * per + e]) << 24))
                   : 0u;
      }
    }
#pragma unroll
    for (int k = 1; k < kDecItems; ++k) s[k] += s[k - 1];
    unsigned total;
    const unsigned incl =
        repro::block_inclusive_scan<unsigned, kDecThreads>(s[kDecItems - 1], ws, total);
    const unsigned pre = carry + incl - s[kDecItems - 1];
    if (full) {
      *reinterpret_cast<int4*>(o + e0) =
          make_int4(int(pre + s[0]), int(pre + s[1]), int(pre + s[2]), int(pre + s[3]));
    } else {
#pragma unroll
      for (int k = 0; k < kDecItems; ++k)
        if (e0 + k < per) o[e0 + k] = int(pre + s[k]);
    }
    carry += total;
  }
}

template <typename S> struct Unsigned;
template <> struct Unsigned<int32_t> { using T = uint32_t; };
template <> struct Unsigned<int64_t> { using T = u64; };

template <typename S>
__device__ __forceinline__ typename Unsigned<S>::T zigzag_delta(S cur, S prev) {
  using U = typename Unsigned<S>::T;
  const U d = static_cast<U>(cur) - static_cast<U>(prev);
  return (d << 1) ^ static_cast<U>(static_cast<S>(d) >> (sizeof(S) * 8 - 1));
}

constexpr int kDzThreads = 256;

// Thread t takes the 16 bytes of elements [t EPV, t EPV + EPV); the last
// thread may hold a ragged tail.
template <typename S>
__global__ void __launch_bounds__(kDzThreads)
delta_zigzag(const S* __restrict__ in, typename Unsigned<S>::T* __restrict__ out,
             int64_t n, bool vec) {
  using U = typename Unsigned<S>::T;
  constexpr int EPV = 16 / sizeof(S);
  const int64_t e0 = (int64_t(blockIdx.x) * kDzThreads + threadIdx.x) * EPV;
  if (e0 >= n) return;
  S prev = e0 ? in[e0 - 1] : S(0);
  if (vec && e0 + EPV <= n) {
    union { uint4 v; S s[EPV]; } x;
    union { uint4 v; U u[EPV]; } z;
    x.v = *reinterpret_cast<const uint4*>(in + e0);
#pragma unroll
    for (int k = 0; k < EPV; ++k) {
      z.u[k] = zigzag_delta(x.s[k], prev);
      prev = x.s[k];
    }
    *reinterpret_cast<uint4*>(out + e0) = z.v;
  } else {
    const int64_t e1 = e0 + EPV < n ? e0 + EPV : n;
    for (int64_t e = e0; e < e1; ++e) {
      const S cur = in[e];
      out[e] = zigzag_delta(cur, prev);
      prev = cur;
    }
  }
}

template <typename S>
int launch_delta_zigzag(const void* in, void* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  constexpr int EPV = 16 / sizeof(S);
  const int64_t threads = (n + EPV - 1) / EPV;
  const dim3 grid(static_cast<unsigned>((threads + kDzThreads - 1) / kDzThreads));
  const bool vec = repro::aligned(in, 16) && repro::aligned(out, 16);
  delta_zigzag<S><<<grid, kDzThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(in), static_cast<typename Unsigned<S>::T*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_delta_zigzag_i32(const void* in, void* out, int64_t n,
                                      void* stream) {
  return launch_delta_zigzag<int32_t>(in, out, n, stream);
}

extern "C" int repro_delta_zigzag_i64(const void* in, void* out, int64_t n,
                                      void* stream) {
  return launch_delta_zigzag<int64_t>(in, out, n, stream);
}

extern "C" int repro_offsets_scan_i64(const void* in, void* out, void* tile_sums,
                                      int64_t n, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* i = static_cast<const u64*>(in);
  auto* o = static_cast<u64*>(out);
  auto* sums = static_cast<u64*>(tile_sums);
  const int64_t tiles = (n + kScanTile - 1) / kScanTile;
  scan_tiles<<<static_cast<unsigned>(tiles), kScanThreads, 0, s>>>(i, o, sums, n);
  if (tiles > 1) {
    scan_tile_sums<<<1, kScanThreads, 0, s>>>(sums, tiles);
    add_tile_prefix<<<static_cast<unsigned>(tiles - 1), kScanThreads, 0, s>>>(o, sums, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_offsets_scan_tile() { return static_cast<int>(kScanTile); }

extern "C" int repro_decode_offset_pages(const void* planes, void* out,
                                         int64_t n_pages, int64_t per, void* stream) {
  if (n_pages <= 0 || per <= 0) return 0;
  const auto* p = static_cast<const uint8_t*>(planes);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = per % kDecItems == 0 && repro::aligned(p, 4) && repro::aligned(o, 16);
  decode_offsets<<<static_cast<unsigned>(n_pages), kDecThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(p, o, per, vec);
  return static_cast<int>(cudaGetLastError());
}
