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
// sizes is 1.6 MB, about 0.5 us, less than one launch, so what K1 costs
// is its launches and the latency chain of one (ticket, load, block scan,
// look-back over L2, store).  K4 reads the four low byte planes (4 P per bytes) and
// writes 4 P per bytes of int32: for one cluster's offset column of about
// 300k entries, 2.4 MB, about 0.7 us.  K10 reads and writes each element
// once: 2^24 int64 move 268 MB, 0.080 ms.
//
// Design.  The TPU kernels walk a sequential grid with a running carry in
// SMEM; blocks on the card run in no order, so:
// * K1 is ONE launch, a single-pass scan with decoupled look-back (no
//   second pass over the output, no memset or init kernel).  A block
//   takes a tile of 2,048 values (256 threads x 8, loaded and stored as
//   16-byte vectors where aligned), scans it in registers and shared
//   memory, publishes the tile's aggregate, and one warp looks back over
//   the predecessors' published aggregates and inclusive prefixes, 32
//   tiles at a time, until it meets a prefix; the block then publishes
//   its own inclusive prefix and writes its tile once.  Forward progress:
//   a block takes its tile from a ticket (atomicAdd on a counter), not
//   from blockIdx, so it only ever waits on tiles that blocks already
//   running own; while the ticket's atomic is in flight the block loads
//   the tile of its launch order, which the ticket names almost always
//   (else it loads the right one).  No reset: the workspace (tickets and per-tile status
//   words) belongs to K1 alone, one per (device, stream), zeroed once
//   when it is made; the counter is never reset (the wrapper passes the
//   tiles issued on it so far as the base: tile = ticket - base), and a
//   status word is epoch << 2 | flag with a per-call epoch from the
//   wrapper, so a word left by an earlier call never reads as ready.
//   A tile's status and value share one 16-byte slot, stored and loaded
//   as one aligned 16-byte vector access, so no fence stands between a
//   value and its flag.  This relies on the hardware making such an
//   access single-copy atomic, as CUB's look-back does; the PTX memory
//   model does not promise it (it orders a vector access as separate
//   scalar ones).  The model's own way, the value and then its status by
//   a release store, the status read by an acquire and then the value,
//   made K1 13 % slower (PERF.md §6).  The adds are in uint64,
//   i.e. two's-complement int64, so the result equals numpy's int64
//   cumsum bit for bit.
// * K4 (replaces `decode_offset_pages` / `_offsets_decode_kernel` of
//   src/repro/kernels/decode_pages.py) needs no carry across pages:
//   pages restart their deltas.  Bound: bytes, 8 P per (the four low
//   planes in, int32 out): 0.0007 ms at the read path's (36, 8, 8192).
//   The first design ran one block of 256 per page (36 blocks at (36, 8,
//   8192) on 132 SMs) and walked the page in 8 serial rounds of 1,024,
//   each a 4-byte load per plane, a block scan and a store: the load
//   latency paid 8 times in series, 0.0102 ms.  Now a page is one thread-
//   block cluster of C <= 8 blocks (a launch attribute, grid P C: 288
//   blocks at (36, 8, 8192)); rank r takes the r-th tile of 1,024
//   elements of each round of C tiles.  A thread loads its 8 elements'
//   bytes from the four low planes at once (one 8-byte load each), turns
//   them into 8 words with two 4 x 4 byte transposes, un-zigzags and
//   scans them, and the block scans its threads' totals; the block's
//   total goes to shared memory, `cluster.sync()`, and each warp reads
//   the C totals over distributed shared memory (lane q reads rank q's,
//   `map_shared_rank`) and sums those of the ranks before its own; the
//   thread writes its 8 int32 ends as two 16-byte vectors.  A page longer
//   than C tiles loops, every rank adding the earlier rounds' totals as a
//   running carry; the totals alternate between two slots, so one sync a
//   round suffices, and a last `cluster.sync()` keeps every block's
//   shared memory alive until its cluster has read it.  No workspace, no
//   atomics, one launch.  int32 is exact under the reader's route guard
//   (the cluster's child total is below 2^31); the sums run in uint32,
//   wrapping as two's-complement int32.  Measured (`python -m
//   repro_torch.launch.scan_builds`, interleaved with the first design;
//   NVIDIA H100 80GB HBM3, 700 W): 0.00773 against 0.00994 ms at (36, 8,
//   8192) and 0.00704 against 0.00989 at (12, 8, 8192); L2-cold 0.0086
//   against 0.0132 ms.  A cluster launch has a floor of its own: 0.0067
//   ms at (1, 8, 16) against 0.0055 for a plain launch of one block, so
//   above the plain floor the time fell from 0.0044 to 0.0022 ms.  Timed
//   and not kept: the cluster dims fixed at compile time (the same),
//   blocks of 256 threads and C = 4 (0.0082), 64 threads x 16 elements
//   (0.0084), one block of 1,024 threads a page (0.0078), and no cluster
//   with each block summing the tiles before its own again from L2
//   (0.0076 at (36, 8, 8192) but 0.0073 against 0.0070 at (12, 8,
//   8192), and no bound on long pages).
// * K10 needs no carry at all: the Pallas kernel carries the previous
//   block's last element across its sequential grid, but each element's
//   delta needs only its predecessor.  A thread takes 16 bytes (four
//   int32 or two int64; one vector load and store where both pointers
//   are 16-byte aligned, scalar loads otherwise) and reads the element
//   before them itself (its neighbour's, from L1/L2).  The subtraction
//   and the shift run in the unsigned type, where they wrap as the
//   reference's int32/int64 jnp ops do (signed overflow is undefined in
//   C++); the sign mask is the arithmetic shift of the signed delta.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;  // four 16-byte vectors a thread
constexpr int64_t kScanTile = int64_t(kScanThreads) * kScanItems;  // 2048

// Flags of a tile's status word (epoch << 2 | flag).
constexpr u64 kAggregate = 1, kPrefix = 2;

// A tile's slot is 16 bytes, {status, value}, written and read whole (one
// 16-byte access, as CUB's look-back keeps an 8-byte value beside its
// status): a reader that sees a status sees the value written with it,
// with no fence between two separate words, as long as the card performs
// an aligned 16-byte access as one (see the note at the top).
__device__ __forceinline__ void store_slot(ulonglong2* p, u64 status, u64 value) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(p), "l"(status), "l"(value)
               : "memory");
}
__device__ __forceinline__ ulonglong2 load_slot(const ulonglong2* p) {
  ulonglong2 v;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(v.x), "=l"(v.y) : "l"(p)
               : "memory");
  return v;
}

// Workspace of `cap` tiles: [counter, pad, slot[cap]], a slot {status,
// value} of two u64: value the tile's aggregate (flag kAggregate) or its
// inclusive prefix (flag kPrefix).
__global__ void __launch_bounds__(kScanThreads)
scan_lookback(const u64* __restrict__ in, u64* __restrict__ out, u64* ws,
              int64_t cap, int64_t n, u64 epoch, u64 base, bool vec) {
  __shared__ u64 warp_sums[kScanThreads / 32];
  __shared__ u64 shared_tile, shared_prefix;
  u64* counter = ws;
  ulonglong2* slot = reinterpret_cast<ulonglong2*>(ws + 2);
  // The tile comes from the ticket.  Blocks mostly start in launch
  // order, so the loads of tile blockIdx.x go out while the ticket is in
  // flight, and a block whose ticket names another tile loads that one.
  if (threadIdx.x == 0) shared_tile = atomicAdd(counter, 1ull) - base;
  u64 v[kScanItems];
  auto load = [&](int64_t t) {
    const int64_t e = t * kScanTile + int64_t(threadIdx.x) * kScanItems;
    if (vec && e + kScanItems <= n) {
      const ulonglong2* p = reinterpret_cast<const ulonglong2*>(in + e);
#pragma unroll
      for (int q = 0; q < kScanItems / 2; ++q) {
        const ulonglong2 w = p[q];
        v[2 * q] = w.x;
        v[2 * q + 1] = w.y;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kScanItems; ++k) v[k] = e + k < n ? in[e + k] : 0ull;
    }
  };
  load(blockIdx.x);
  __syncthreads();
  const int64_t tile = static_cast<int64_t>(shared_tile);
  if (tile != int64_t(blockIdx.x)) load(tile);  // uniform across the block
  const int64_t e0 = tile * kScanTile + int64_t(threadIdx.x) * kScanItems;
  const bool full = vec && e0 + kScanItems <= n;
#pragma unroll
  for (int k = 1; k < kScanItems; ++k) v[k] += v[k - 1];
  u64 total;
  const u64 incl =
      repro::block_inclusive_scan<u64, kScanThreads>(v[kScanItems - 1], warp_sums, total);
  const u64 before = incl - v[kScanItems - 1];  // the thread's exclusive offset

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    u64 exclusive = 0;
    if (tile == 0) {
      if (lane == 0) store_slot(&slot[0], epoch << 2 | kPrefix, total);
    } else {
      if (lane == 0) store_slot(&slot[tile], epoch << 2 | kAggregate, total);
      // Lane i reads tile end - i; tiles below 0 never come into a
      // window, since tile 0 publishes its prefix.
      int64_t end = tile - 1;
      while (true) {
        const int64_t i = end - lane;
        u64 flag = kPrefix, val = 0;
        if (i >= 0) {
          ulonglong2 sv;
          do {
            sv = load_slot(&slot[i]);
          } while ((sv.x >> 2) != epoch);
          flag = sv.x & 3;
          val = sv.y;
        }
        const unsigned found = __ballot_sync(0xffffffffu, flag == kPrefix);
        // The nearest predecessor with a prefix ends the look-back: sum
        // the lanes up to it; without one, all 32 aggregates count.
        const int last = found ? __ffs(found) - 1 : 31;
        u64 s = lane <= last ? val : 0ull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        exclusive += s;
        if (found) break;
        end -= 32;
      }
      if (lane == 0) store_slot(&slot[tile], epoch << 2 | kPrefix, exclusive + total);
    }
    if (lane == 0) shared_prefix = exclusive;
  }
  __syncthreads();
  const u64 add = shared_prefix + before;
  if (full) {
    ulonglong2* p = reinterpret_cast<ulonglong2*>(out + e0);
#pragma unroll
    for (int q = 0; q < kScanItems / 2; ++q)
      p[q] = make_ulonglong2(add + v[2 * q], add + v[2 * q + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      if (e0 + k < n) out[e0 + k] = add + v[k];
  }
}

constexpr int kDecThreads = 128;
constexpr int kDecItems = 8;  // one 8-byte load per plane a thread and round
constexpr int64_t kDecTile = int64_t(kDecThreads) * kDecItems;  // 1024
constexpr int kDecMaxCluster = 8;  // the portable cluster size

__device__ __forceinline__ unsigned unzigzag(unsigned z) {
  return (z >> 1) ^ (0u - (z & 1u));
}

// One page per cluster of C blocks (grid P * C, cluster rank r = block
// rank).  Round i covers elements [i C tile, (i + 1) C tile) of the page;
// rank r takes its r-th tile.  The page restarts its sum at 0 (pages
// restart their deltas); `carry` is the sum of the page's earlier rounds.
__global__ void __launch_bounds__(kDecThreads)
decode_offsets_cluster(const uint8_t* __restrict__ planes, int32_t* __restrict__ out,
                       int64_t per, bool vec) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ unsigned warp_sums[kDecThreads / 32];
  __shared__ unsigned totals[2];  // this block's total of the last two rounds
  const unsigned c = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int64_t page = blockIdx.x / c;
  const uint8_t* p = planes + page * 8 * per;  // plane j at p + j * per
  int32_t* o = out + page * per;
  const int lane = threadIdx.x & 31;
  unsigned carry = 0;
  int parity = 0;
  for (int64_t r0 = 0; r0 < per; r0 += c * kDecTile, parity ^= 1) {
    const int64_t e0 = r0 + rank * kDecTile + int64_t(threadIdx.x) * kDecItems;
    const bool full = vec && e0 + kDecItems <= per;
    unsigned s[kDecItems];
    if (full) {
      // bytes 0-3 of 8 elements: one 8-byte load from each low plane, all
      // four in flight at once, then two 4 x 4 byte transposes
      const uint2 b0 = *reinterpret_cast<const uint2*>(p + e0);
      const uint2 b1 = *reinterpret_cast<const uint2*>(p + per + e0);
      const uint2 b2 = *reinterpret_cast<const uint2*>(p + 2 * per + e0);
      const uint2 b3 = *reinterpret_cast<const uint2*>(p + 3 * per + e0);
      uint32_t lo[4] = {b0.x, b1.x, b2.x, b3.x};
      uint32_t hi[4] = {b0.y, b1.y, b2.y, b3.y};
      repro::transpose4x4(lo);
      repro::transpose4x4(hi);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[k] = unzigzag(lo[k]);
        s[k + 4] = unzigzag(hi[k]);
      }
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
    const unsigned incl = repro::block_inclusive_scan<unsigned, kDecThreads>(
        s[kDecItems - 1], warp_sums, total);
    if (threadIdx.x == 0) totals[parity] = total;
    // every rank's total of this round is published; slot `parity` is
    // written again two rounds on, after the next sync, which no block
    // reaches before it has read this round's slots
    cluster.sync();
    // lane q < C reads rank q's total over distributed shared memory;
    // each warp sums the ranks before this one, and all C
    unsigned t = lane < int(c) ? *cluster.map_shared_rank(&totals[parity], lane) : 0u;
    unsigned before = lane < int(rank) ? t : 0u;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      t += __shfl_xor_sync(0xffffffffu, t, m);
      before += __shfl_xor_sync(0xffffffffu, before, m);
    }
    const unsigned pre = carry + before + incl - s[kDecItems - 1];
    if (full) {
      int4* q = reinterpret_cast<int4*>(o + e0);
      q[0] = make_int4(int(pre + s[0]), int(pre + s[1]), int(pre + s[2]), int(pre + s[3]));
      q[1] = make_int4(int(pre + s[4]), int(pre + s[5]), int(pre + s[6]), int(pre + s[7]));
    } else {
#pragma unroll
      for (int k = 0; k < kDecItems; ++k)
        if (e0 + k < per) o[e0 + k] = int(pre + s[k]);
    }
    carry += t;
  }
  // no block may exit while a rank of its cluster can still read its
  // shared memory: the last round's reads happen before this sync
  cluster.sync();
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

// (in, out, workspace, capacity in tiles, n, epoch, base, stream): one
// launch of ceil(n / tile) blocks.  The caller serialises calls on one
// workspace in stream order, gives each a fresh epoch (>= 1) and the
// count of tiles issued on the workspace before it as the base.
extern "C" int repro_offsets_scan_i64(const void* in, void* out, void* workspace,
                                      int64_t capacity, int64_t n, int64_t epoch,
                                      int64_t base, void* stream) {
  if (n <= 0) return 0;
  const int64_t tiles = (n + kScanTile - 1) / kScanTile;
  if (tiles > capacity || epoch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = repro::aligned(in, 16) && repro::aligned(out, 16);
  scan_lookback<<<static_cast<unsigned>(tiles), kScanThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u64*>(in), static_cast<u64*>(out), static_cast<u64*>(workspace),
      capacity, n, static_cast<u64>(epoch), static_cast<u64>(base), vec);
  return static_cast<int>(cudaGetLastError());
}

// Values per tile: the wrapper sizes the workspace and counts tickets in
// these units.
extern "C" int repro_offsets_scan_tile() { return static_cast<int>(kScanTile); }

// (planes, out, n_pages, per, cluster, tile, stream): one launch of
// n_pages * cluster blocks in clusters of `cluster` (1..8), each block
// taking `tile` elements a round; the wrapper computes both
// (decode_pages.launch_shape) and this refuses a tile it was not built
// for.  A refused cluster launch returns its CUDA error.
extern "C" int repro_decode_offset_pages(const void* planes, void* out,
                                         int64_t n_pages, int64_t per, int cluster,
                                         int64_t tile, void* stream) {
  if (n_pages <= 0 || per <= 0) return 0;
  if (cluster < 1 || cluster > kDecMaxCluster || tile != kDecTile)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const uint8_t*>(planes);
  auto* o = static_cast<int32_t*>(out);
  const bool vec = per % kDecItems == 0 && repro::aligned(p, 8) && repro::aligned(o, 16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_pages * cluster));
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, decode_offsets_cluster, p, o, per, vec);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(launched != cudaSuccess ? launched : last);
}
