// Group the lanes of a batch by shard, for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel.  It gives the dense sharded walks (K3/K4 in
// traverse.cu) the lane order the reference's clustered plan gets from a
// stable argsort (repro/kernels/ops.py cluster_queries), without a library
// sort or a host sync: a counting sort of the lanes by shard id over S+1
// buckets, the one-digit pass of a radix sort.  Bucket S takes every lane
// whose id is outside [0, S).  Three launches on one stream:
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
//       shared memory, and writes q_sorted, sid_sorted (the lane's own id, so
//       a lane outside [0, S) still reads as one) and perm (its batch index)
//       from there: the tile's lanes of bucket b go to the consecutive ranks
//       from offsets[b] + scanned[b, j], so the stores are coalesced runs.
//       A lane's slot in the tile is the running count of its bucket, plus
//       its lower peers in its warp; the warps of a round take their counts
//       in warp order.
//
// Stable: perm equals torch.argsort(where(0 <= sid < S, sid, S),
// stable=True), so the order is the reference's and is the same every run.
//
// Contention: lanes of one bucket in a warp are found with one
// __match_any_sync and counted with __popc, and only the group's leader
// touches the shared counter.  On a hot shard (93.6% of a Zipf batch on
// shard 0) a warp makes one shared update, not 32 conflicting atomics.
// The warps of a round update the running counts in warp order, one warp
// between two barriers, which keeps the slots stable with S+1 counters and
// no per-warp table.  Shared memory: (S+1) ints in (a) and (b), 2 (S+1) + 3
// kTile ints in (c); S is capped at 8192 (88 KB in (c), which opts in above
// the default 48 KB).
//
// What bounds it: bytes, in principle.  It reads sid twice and q once and
// writes three int32 arrays, 20 bytes a lane: 21 MB at 2^20 lanes, ~6 us at
// 3.35 TB/s.  In practice three launches, the barriers of (c) and the
// one-block scan of 2 (S+1) * B / kTile entries add to that.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 2048;                 // lanes a block
constexpr int kRounds = kTile / kThreads;
constexpr int kScanThreads = 1024;
constexpr int kSegItems = 16;               // row entries a lane loads
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int bucket_of(int s, int shards) {
  return (s >= 0 && s < shards) ? s : shards;
}

// Exclusive prefix of v over a block of kN warps; total is the block's sum.
template <int kN>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kN ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kN) warp_sums[lane] = w;
  }
  __syncthreads();
  const int prefix = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  total = warp_sums[kN - 1];
  __syncthreads();                          // warp_sums is reused next call
  return prefix;
}

// (a) Block j's count of each bucket, into column j of counts [S+1, nblocks].
__global__ void __launch_bounds__(kThreads)
group_histogram_kernel(const int* __restrict__ sids, int* __restrict__ counts,
                       long long batch, int shards, int nblocks) {
  extern __shared__ int hist[];             // [shards + 1]
  const int buckets = shards + 1;
  for (int b = threadIdx.x; b < buckets; b += kThreads) hist[b] = 0;
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  int bk[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {       // every load in flight at once
    const long long i = base + (long long)r * kThreads;
    bk[r] = i < batch ? bucket_of(__ldg(sids + i), shards) : -1;
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
// offsets[b] + scanned[b, j], so the stores are coalesced runs.
__global__ void __launch_bounds__(kThreads)
group_scatter_kernel(const int* __restrict__ sids,
                     const int* __restrict__ queries,
                     const int* __restrict__ counts,
                     const int* __restrict__ scanned,
                     const int* __restrict__ offsets,
                     int* __restrict__ q_sorted, int* __restrict__ sid_sorted,
                     int* __restrict__ perm, long long batch, int shards,
                     int nblocks) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[kWarps];
  const int buckets = shards + 1;
  int* next = smem;                         // [buckets] next tile slot
  int* delta = smem + buckets;              // [buckets] rank - tile slot
  int* t_q = smem + 2 * buckets;            // [kTile] the tile, sorted
  int* t_sid = t_q + kTile;
  int* t_idx = t_sid + kTile;
  const int j = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)j * kTile;

  int sv[kRounds], qv[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {       // every load in flight at once
    const long long i = base + (long long)r * kThreads + threadIdx.x;
    sv[r] = i < batch ? __ldg(sids + i) : 0;
    qv[r] = i < batch ? __ldg(queries + i) : 0;
  }
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
    const int b = live ? bucket_of(sv[r], shards) : -1;
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
      t_sid[slot] = sv[r];
      t_idx[slot] = (int)i;
    }
  }
  __syncthreads();
  const int n = (int)min((long long)kTile, batch - base);
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int s = t_sid[p];
    const int g = p + delta[bucket_of(s, shards)];
    q_sorted[g] = t_q[p];
    sid_sorted[g] = s;
    perm[g] = t_idx[p];
  }
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
  const cudaStream_t st = (cudaStream_t)stream;
  const int nblocks = (int)((batch + kTile - 1) / kTile);
  const size_t counters = (size_t)(shards + 1) * sizeof(int);
  const size_t scatter_smem = 2 * counters + 3 * kTile * sizeof(int);
  int err;
  if (scatter_smem > kDefaultSmem) {        // above 48 KB only by opting in
    err = (int)cudaFuncSetAttribute(
        group_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)scatter_smem);
    if (err != 0) return err;
  }
  group_histogram_kernel<<<nblocks, kThreads, counters, st>>>(
      (const int*)sids, (int*)counts, batch, shards, nblocks);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  group_scan_kernel<<<1, kScanThreads, counters, st>>>(
      (const int*)counts, (int*)scanned, (int*)offsets, nblocks, shards);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  group_scatter_kernel<<<nblocks, kThreads, scatter_smem, st>>>(
      (const int*)sids, (const int*)queries, (const int*)counts,
      (const int*)scanned, (const int*)offsets, (int*)q_sorted,
      (int*)sid_sorted, (int*)perm, batch, shards, nblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
