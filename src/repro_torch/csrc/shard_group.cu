// Group the lanes of a batch by shard or by key range, for Hopper (sm_90a),
// plain C interface.
//
// Replaces no TPU kernel.  It gives the walks of traverse.cu and
// validated_traverse.cu a lane order in which a warp's lanes read nearby
// records, without a library sort or a host sync.  Both entry points are
// stable counting sorts built from the same three passes (the one-digit pass
// of a radix sort).  The order key, the block min/max and scan and the
// span's shift live in tile_sort.cuh, which traverse.cu's tile-sorted K5/K6
// share:
//
//   group_by_shard_launch (K3/K4): the lanes by shard id over S+1 buckets,
//       bucket S taking every lane whose id is outside [0, S); the order the
//       reference's clustered plan gets from a stable argsort
//       (repro/kernels/ops.py cluster_queries).
//   group_by_key_launch (K1/K2/K8): the lanes of a monolithic batch by key
//       bucket (u(q) - lo) >> shift, u(q) = q ^ 0x80000000 (int32 onto
//       uint32, order kept), lo the batch's least u and shift the least that
//       leaves at most 2^13 = 8192 buckets.  The bucket is monotone in
//       q, so each bucket is one key range; the difference is unsigned, so a
//       span from KEY_MIN to KEY_MAX does not overflow.  lo and shift come
//       from a min/max pass on the device (no host read).  8192 buckets
//       take two digit passes, low 7 bits then high 6 (LSD, each stable, so
//       the result is stable by the whole bucket): one pass over 8193
//       buckets would make a [8193, B / 2048] count table, 16 MB at 2^20
//       lanes, for a one-block scan.  The bucket is computed from q inside
//       each pass, so no bucket array is written.
//
// The three passes, on one stream:
//
//   (a) histogram: block j counts its tile of kTile lanes into a shared
//       histogram and writes it to column j of a bucket-major [S+1, nblocks]
//       count table (no global atomics);
//   (b) scan, in one block: each warp takes whole rows of the table and
//       writes their exclusive prefix along the row (block j's first rank
//       within bucket b) to a second table; then the exclusive prefix of the
//       row totals gives offsets [S+2], where each bucket starts (bucket b's
//       lanes are perm[offsets[b] : offsets[b+1]]);
//   (c) scatter: block j re-reads its tile, sorts it stably by bucket in
//       shared memory, and writes q_sorted, sid_sorted (shard mode: the
//       lane's own id, so a lane outside [0, S) still reads as one) and perm
//       (the lane's batch index, or in the key sort's second digit pass the
//       index the first pass carried) from there: the tile's lanes of bucket
//       b go to the consecutive ranks from offsets[b] + scanned[b, j], so the
//       stores are coalesced runs.  A lane's slot in the tile is the running
//       count of its bucket, plus its lower peers in its warp; the warps of a
//       round take their counts in warp order.
//
// Stable: in shard mode perm equals torch.argsort(where(0 <= sid < S, sid,
// S), stable=True); in key mode torch.argsort(bucket, stable=True).  The
// order is the same every run.
//
// Contention: lanes of one bucket in a warp are found with one
// __match_any_sync and counted with __popc, and only the group's leader
// touches the shared counter.  On a hot bucket (93.6% of a Zipf batch on
// shard 0; most of a Zipf key batch in the lowest key buckets) a warp makes
// one shared update, not 32 conflicting atomics.  The warps of a round
// update the running counts in warp order, one warp between two barriers,
// which keeps the slots stable with S+1 counters and no per-warp table.
// Shared memory: (S+1) ints in (a) and (b), 2 (S+1) + 3 kTile ints in (c); S
// is capped at 8192 (88 KB in (c), which opts in above the default 48 KB).
//
// What bounds it: bytes, in principle.  Shard mode reads sid twice and q
// once and writes three int32 arrays, 20 bytes a lane: 21 MB at 2^20 lanes,
// ~6 us at 3.35 TB/s.  Key mode reads q three times (min/max, the first
// pass's histogram and scatter) and the first pass's q and index once or
// twice, and writes q and the index twice: 40 bytes a lane, 42 MB at 2^20
// lanes (the function itself needs 12: q in, q_sorted and perm out).  In
// practice the launches (three a pass, plus the min/max pass), the barriers
// of (c) and the one-block scan of 2 (S+1) * B / kTile entries add to that.

#include <cuda_runtime.h>

#include "tile_sort.cuh"

namespace {

using tile_sort::block_exclusive_scan;
using tile_sort::block_min_max;
using tile_sort::order_key;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                 // lanes a block
constexpr int kRounds = kTile / kThreads;
constexpr int kScanThreads = 1024;
constexpr int kSegItems = 16;               // row entries a lane loads
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;
// Key mode: 2^13 buckets as a low digit of 7 bits and a high one of 6.
constexpr int kKeyBucketBits = 13;
constexpr int kLowDigitBits = 7;
constexpr int kSpanItems = 16;              // keys a thread of (m) loads
constexpr int kMaxSpanBlocks = 256;         // blocks of (m), at most

__device__ __forceinline__ int bucket_of(int s, int shards) {
  return (s >= 0 && s < shards) ? s : shards;
}

// Key mode's digit of q: bits [digit_shift, digit_shift + log2(radix)) of
// the bucket (u(q) - lo) >> shift; span = {lo, shift}.
__device__ __forceinline__ int key_digit(int q, const unsigned* span,
                                         int digit_shift, int radix) {
  const unsigned b = (order_key(q) - span[0]) >> span[1];
  return (int)((b >> digit_shift) & (unsigned)(radix - 1));
}

// Key mode: reduce the min/max pass's partials (n pairs, least and greatest
// u) to span = {lo, shift} in shared memory; every thread of the block
// calls it, and it ends in a barrier.
__device__ void block_key_span(const unsigned* __restrict__ partials, int n,
                               unsigned* span) {
  __shared__ unsigned lo_w[kWarps], hi_w[kWarps];
  unsigned lo = 0xffffffffu, hi = 0u;
  for (int g = threadIdx.x; g < n; g += kThreads) {
    lo = min(lo, __ldg(partials + 2 * g));
    hi = max(hi, __ldg(partials + 2 * g + 1));
  }
  block_min_max<kWarps>(lo, hi, lo_w, hi_w);
  if (threadIdx.x == 0) {
    span[0] = lo;
    span[1] = tile_sort::span_shift(lo, hi, kKeyBucketBits);
  }
  __syncthreads();
}

// (m) Key mode: block g writes the least and greatest u(q) of its share of
// the batch to partials[2g], partials[2g + 1].
__global__ void __launch_bounds__(kThreads)
key_span_kernel(const int* __restrict__ queries,
                unsigned* __restrict__ partials, long long batch) {
  __shared__ unsigned lo_w[kWarps], hi_w[kWarps];
  const long long stride = (long long)gridDim.x * kThreads * kSpanItems;
  unsigned lo = 0xffffffffu, hi = 0u;
  for (long long base = (long long)blockIdx.x * kThreads * kSpanItems +
                        threadIdx.x;
       base < batch; base += stride) {
    int v[kSpanItems];
#pragma unroll
    for (int k = 0; k < kSpanItems; ++k) {  // coalesced, all in flight
      const long long i = base + (long long)k * kThreads;
      v[k] = i < batch ? __ldg(queries + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < kSpanItems; ++k)
      if (base + (long long)k * kThreads < batch) {
        lo = min(lo, order_key(v[k]));
        hi = max(hi, order_key(v[k]));
      }
  }
  block_min_max<kWarps>(lo, hi, lo_w, hi_w);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = lo;
    partials[2 * blockIdx.x + 1] = hi;
  }
}

// (a) Block j's count of each bucket, into column j of counts [S+1, nblocks].
// Shard mode reads sids; key mode (kKeyed) takes digit (digit_shift, radix
// `shards`) of each query's key bucket, the span reduced from `partials`.
// One template, so each mode compiles without the other's branches.
template <bool kKeyed>
__global__ void __launch_bounds__(kThreads)
group_histogram_kernel(const int* __restrict__ sids,
                       const int* __restrict__ queries,
                       const unsigned* __restrict__ partials, int n_partials,
                       int digit_shift, int* __restrict__ counts,
                       long long batch, int shards, int nblocks) {
  extern __shared__ int hist[];             // [shards + 1]
  __shared__ unsigned span[2];
  const int* src = kKeyed ? queries : sids;
  const int buckets = shards + 1;
  for (int b = threadIdx.x; b < buckets; b += kThreads) hist[b] = 0;
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  int v[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {       // every load in flight at once
    const long long i = base + (long long)r * kThreads;
    v[r] = i < batch ? __ldg(src + i) : 0;
  }
  if constexpr (kKeyed) block_key_span(partials, n_partials, span);
  int bk[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const bool live = base + (long long)r * kThreads < batch;
    bk[r] = !live ? -1 : kKeyed ? key_digit(v[r], span, digit_shift, shards)
                                : bucket_of(v[r], shards);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned peers = __match_any_sync(kFull, bk[r]);
    if (bk[r] >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&hist[bk[r]], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += kThreads)
    counts[(size_t)b * nblocks + blockIdx.x] = hist[b];
}

// (b) One block.  Each warp takes whole rows b of counts and writes their
// exclusive prefix along the row to scanned (the lanes of bucket b in
// blocks before j); then offsets = the exclusive prefix of the row totals
// (where bucket b starts), and offsets[S+1] = the batch.
__global__ void __launch_bounds__(kScanThreads)
group_scan_kernel(const int* __restrict__ counts, int* __restrict__ scanned,
                  int* __restrict__ offsets, int nblocks, int shards) {
  extern __shared__ int totals[];           // [shards + 1]
  __shared__ int warp_sums[kScanThreads / 32];
  const int buckets = shards + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < buckets; b += kScanThreads / 32) {
    const int* row = counts + (size_t)b * nblocks;
    int* out = scanned + (size_t)b * nblocks;
    int carry = 0;
    for (int seg = 0; seg < nblocks; seg += 32 * kSegItems) {
      int v[kSegItems];
#pragma unroll
      for (int k = 0; k < kSegItems; ++k) {   // coalesced, all in flight
        const int j = seg + k * 32 + lane;
        v[k] = j < nblocks ? __ldg(row + j) : 0;
      }
      int x[kSegItems];                       // the 16 warp scans side by side
#pragma unroll
      for (int k = 0; k < kSegItems; ++k) x[k] = v[k];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int k = 0; k < kSegItems; ++k) {
          const int y = __shfl_up_sync(kFull, x[k], d);
          if (lane >= d) x[k] += y;
        }
      }
#pragma unroll
      for (int k = 0; k < kSegItems; ++k) {   // then in order, with the carry
        const int j = seg + k * 32 + lane;
        if (j < nblocks) out[j] = carry + x[k] - v[k];
        carry += __shfl_sync(kFull, x[k], 31);
      }
    }
    if (lane == 0) totals[b] = carry;
  }
  __syncthreads();
  const int per = (buckets + kScanThreads - 1) / kScanThreads;
  const int b0 = threadIdx.x * per;
  int sum = 0;
  for (int k = 0; k < per; ++k)
    if (b0 + k < buckets) sum += totals[b0 + k];
  int total;
  int run = block_exclusive_scan<kScanThreads / 32>(sum, warp_sums, total);
  for (int k = 0; k < per; ++k)
    if (b0 + k < buckets) {
      offsets[b0 + k] = run;
      run += totals[b0 + k];
    }
  if (threadIdx.x == 0) offsets[buckets] = total;
}

// (c) Block j sorts its tile by bucket in shared memory (stable), then
// writes it out: the tile's lanes of bucket b go to consecutive ranks from
// offsets[b] + scanned[b, j], so the stores are coalesced runs.  Shard mode
// writes sid_sorted; key mode (kKeyed) keeps each lane's digit in the tile
// instead and writes no sid.  perm gets idx_in[i] (key mode), or i when
// idx_in is null.
template <bool kKeyed>
__global__ void __launch_bounds__(kThreads)
group_scatter_kernel(const int* __restrict__ sids,
                     const int* __restrict__ queries,
                     const int* __restrict__ idx_in,
                     const unsigned* __restrict__ partials, int n_partials,
                     int digit_shift,
                     const int* __restrict__ counts,
                     const int* __restrict__ scanned,
                     const int* __restrict__ offsets,
                     int* __restrict__ q_sorted, int* __restrict__ sid_sorted,
                     int* __restrict__ perm, long long batch, int shards,
                     int nblocks) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[kWarps];
  __shared__ unsigned span[2];
  const int buckets = shards + 1;
  int* next = smem;                         // [buckets] next tile slot
  int* delta = smem + buckets;              // [buckets] rank - tile slot
  int* t_q = smem + 2 * buckets;            // [kTile] the tile, sorted
  int* t_aux = t_q + kTile;                 // its sids, or its digits
  int* t_idx = t_aux + kTile;
  const int j = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)j * kTile;

  int sv[kRounds], qv[kRounds], iv[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {       // every load in flight at once
    const long long i = base + (long long)r * kThreads + threadIdx.x;
    const bool live = i < batch;
    sv[r] = live && !kKeyed ? __ldg(sids + i) : 0;
    qv[r] = live ? __ldg(queries + i) : 0;
    iv[r] = kKeyed && live && idx_in != nullptr ? __ldg(idx_in + i) : (int)i;
  }
  if constexpr (kKeyed) block_key_span(partials, n_partials, span);
  // Tile slots: the exclusive prefix of the tile's counts over buckets.
  const int per = (buckets + kThreads - 1) / kThreads;
  const int b0 = threadIdx.x * per;
  int sum = 0;
  for (int k = 0; k < per; ++k)
    if (b0 + k < buckets) sum += __ldg(counts + (size_t)(b0 + k) * nblocks + j);
  int total;
  int run = block_exclusive_scan<kWarps>(sum, warp_sums, total);
  for (int k = 0; k < per; ++k) {
    const int b = b0 + k;
    if (b < buckets) {
      const size_t e = (size_t)b * nblocks + j;
      next[b] = run;
      delta[b] = __ldg(offsets + b) + __ldg(scanned + e) - run;
      run += __ldg(counts + e);
    }
  }
  __syncthreads();

  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const long long i = base + (long long)r * kThreads + threadIdx.x;
    const bool live = i < batch;
    const int b = !live ? -1 : kKeyed ? key_digit(qv[r], span, digit_shift,
                                                  shards)
                                      : bucket_of(sv[r], shards);
    const unsigned peers = __match_any_sync(kFull, b);
    const int leader = __ffs(peers) - 1;
    int slot = 0;
    for (int w = 0; w < kWarps; ++w) {      // warp order keeps it stable
      if (warp == w && lane == leader && live) {
        slot = next[b];
        next[b] = slot + __popc(peers);
      }
      __syncthreads();
    }
    slot = __shfl_sync(kFull, slot, leader) + __popc(peers & lower);
    if (live) {
      t_q[slot] = qv[r];
      t_aux[slot] = kKeyed ? b : sv[r];
      t_idx[slot] = iv[r];
    }
  }
  __syncthreads();
  const int n = (int)min((long long)kTile, batch - base);
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int a = t_aux[p];
    const int g = p + delta[kKeyed ? a : bucket_of(a, shards)];
    q_sorted[g] = t_q[p];
    if (!kKeyed) sid_sorted[g] = a;
    perm[g] = t_idx[p];
  }
}

// One counting-sort pass (a)-(c) on `stream`; the first error, else 0.
// kKeyed: key mode (sids null), else shard mode (partials, idx_in null).
template <bool kKeyed>
int sort_pass(const int* sids, const int* queries, const int* idx_in,
              const unsigned* partials, int n_partials, int digit_shift,
              int* counts, int* scanned, int* offsets, int* q_sorted,
              int* sid_sorted, int* perm, long long batch, int shards,
              cudaStream_t st) {
  const int nblocks = (int)((batch + kTile - 1) / kTile);
  const size_t counters = (size_t)(shards + 1) * sizeof(int);
  const size_t scatter_smem = 2 * counters + 3 * kTile * sizeof(int);
  int err;
  if (scatter_smem > kDefaultSmem) {        // above 48 KB only by opting in
    err = (int)cudaFuncSetAttribute(
        group_scatter_kernel<kKeyed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scatter_smem);
    if (err != 0) return err;
  }
  group_histogram_kernel<kKeyed><<<nblocks, kThreads, counters, st>>>(
      sids, queries, partials, n_partials, digit_shift, counts, batch, shards,
      nblocks);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  group_scan_kernel<<<1, kScanThreads, counters, st>>>(
      counts, scanned, offsets, nblocks, shards);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  group_scatter_kernel<kKeyed><<<nblocks, kThreads, scatter_smem, st>>>(
      sids, queries, idx_in, partials, n_partials, digit_shift, counts,
      scanned, offsets, q_sorted, sid_sorted, perm, batch, shards, nblocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues the three passes on `stream`; returns the first launch's
// cudaGetLastError() that is not cudaSuccess, else cudaSuccess.  `batch`
// must be positive and `shards` in [1, 8192]; `counts` and `scanned` hold
// (shards + 1) * ceil(batch / 2048) ints each and `offsets` shards + 2.
int group_by_shard_launch(const void* sids, const void* queries, void* counts,
                          void* scanned, void* offsets, void* q_sorted,
                          void* sid_sorted, void* perm, long long batch,
                          int shards, void* stream) {
  return sort_pass<false>((const int*)sids, (const int*)queries, nullptr,
                          nullptr, 0, 0, (int*)counts, (int*)scanned,
                          (int*)offsets, (int*)q_sorted, (int*)sid_sorted,
                          (int*)perm, batch, shards, (cudaStream_t)stream);
}

// The lanes by key bucket: the min/max pass, then the low-digit pass into
// (q_mid, perm_mid) and the high-digit pass into (q_sorted, perm).  Same
// return as above; `batch` must be positive.  `partials` holds
// 512 uints; `counts` and `scanned` hold
// (2^7 + 1) * ceil(batch / 2048) ints each (the second pass reuses them)
// and `offsets` 2^7 + 2; `q_mid` and `perm_mid` batch ints each.  The
// min/max pass takes ceil(batch / 4096) blocks, at most 256.
int group_by_key_launch(const void* queries, void* partials, void* counts,
                        void* scanned, void* offsets, void* q_mid,
                        void* perm_mid, void* q_sorted, void* perm,
                        long long batch, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long per_block = (long long)kThreads * kSpanItems;
  const int n_partials =
      (int)min((batch + per_block - 1) / per_block, (long long)kMaxSpanBlocks);
  key_span_kernel<<<n_partials, kThreads, 0, st>>>(
      (const int*)queries, (unsigned*)partials, batch);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  err = sort_pass<true>(nullptr, (const int*)queries, nullptr,
                        (const unsigned*)partials, n_partials, 0,
                        (int*)counts, (int*)scanned, (int*)offsets,
                        (int*)q_mid, nullptr, (int*)perm_mid, batch,
                        1 << kLowDigitBits, st);
  if (err != 0) return err;
  return sort_pass<true>(nullptr, (const int*)q_mid, (const int*)perm_mid,
                         (const unsigned*)partials, n_partials,
                         kLowDigitBits, (int*)counts, (int*)scanned,
                         (int*)offsets, (int*)q_sorted, nullptr, (int*)perm,
                         batch, 1 << (kKeyBucketBits - kLowDigitBits), st);
}

}  // extern "C"
