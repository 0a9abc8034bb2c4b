// Batched skiplist traversal kernels for Hopper (sm_90a), plain C interface.
//
// Replace the Pallas TPU kernels of repro/kernels/foresight_traverse.py:
//   foresight_traverse_launch  -> foresight_traverse (_foresight_kernel), K1,
//                                 on lanes grouped by key range
//                                 (shard_group.cu)
//   base_traverse_launch       -> base_traverse (_base_kernel), K2, the same
//   foresight_sharded_launch   -> foresight_traverse_sharded
//                                 (_foresight_sharded_kernel), K3, on lanes
//                                 grouped by shard_group.cu
//   base_sharded_launch        -> base_traverse_sharded (_base_sharded_kernel),
//                                 K4, the same
//   foresight_clustered_launch -> foresight_traverse_clustered
//                                 (_foresight_clustered_kernel), K5, on
//                                 tiles of plan lanes sorted by key
//                                 (clustered_tile_kernel)
//   base_clustered_launch      -> base_traverse_clustered
//                                 (_base_clustered_kernel), K6, the same
//   fat_resolve (device function, in all six when fat_keys is given; alone
//   through fat_resolve_launch) -> _fat_resolve, the fat-node postlude, K9
// All run the lock-step loop of _traverse_loop: start at the head on level
// L-1; each step either advances to the successor (its key < q) or descends;
// stop when below level 0 or after max_steps steps; return the level-0
// successor of the final predecessor and its key.  K3-K6 walk one shard of
// stacked tables: lane i's tables start at shard sid[i]'s offset, and its
// node ids are shard-local.
//
// Design: one thread per query, each running its own early-exit loop.  That
// equals the reference's 128-lane lock-step exactly: a lane there advances
// or descends once per iteration from the start, so it stops after the same
// number of its own steps.  The TPU grids exist to stream index tiles
// through VMEM: (B/128) x S shard tiles for K3/K4, the (B/128) x K tiles a
// clustered block names for K5/K6.  Here the index stays in device memory
// and a thread reads its own shard's records directly; no index record is
// staged in shared memory.  K5/K6 keep the plan only to decide which lanes
// are served: lane i of block j = i/128 is served iff sid[i] is among
// block_sids[j, k < ndist[j]]; an unserved lane (or a shard id outside
// [0, S)) writes (0, 0), the reference's _init.
//
// The dense K3/K4 walk grouped lanes.  Lanes are routed by key range, so in
// batch order a warp's 32 lanes hit up to 32 shards and every warp walks
// 32 shards' upper levels, each a separate chain of misses.  The wrapper
// first runs group_by_shard (shard_group.cu), a counting sort of the lanes
// by shard, and the walk then reads (sid_sorted[i], q_sorted[i]) coalesced
// and writes its result at out_idx[i] (the lane's batch index), so the
// results come back in lane order in the walk's own store.  A warp then
// walks one shard (two at a bucket's edge), and its lanes' first steps hit
// the same records of that shard's upper levels, which L1 and L2 serve
// after the first miss.  What still bounds the grouped walk is the rest of
// each lane's chain of dependent misses below the shared levels.  out_idx
// == nullptr keeps lane i's result at i (K9 alone, the ungrouped
// K1/K2/K3/K4 launch and the plan-order K5/K6 launch, each timed beside
// the wrappers' launch).
//
// K5 and K6 walk tiles of the plan's lanes sorted by key, in one launch
// (clustered_tile_kernel).  The plan (kernels/ops.py cluster_queries) is a
// stable sort by shard, so each shard's lanes are contiguous but in batch
// order: on uniform traffic over 64 shards a warp's 32 consecutive plan
// lanes hit one shard at 32 random keys and share only its top levels.  A
// block takes a tile of kTile = 1024 consecutive plan lanes, one a thread,
// which lie in one or two shards, and sorts it in shared memory by a
// counting sort over 2^10 key buckets of the tile's own span; warp w then
// walks the sorted lanes 32w..32w+31, which lie within some ten thousand of
// one shard's keys.  The plan has done the coarse half of the sort, so
// there is no global pass: no extra launch, no min/max pass over the batch
// and no host work.  Which lanes walk is decided at each lane's plan index
// (served_by_plan, block i/128), and each result is stored at its plan
// index, so the results are the plan-order launch's bit for bit.  Every
// thread walks one sorted lane or none, so the whole warp reaches K9.
//
// What bounds it is what bounds K1-K4: each lane's chain of dependent
// misses, about 40 steps a lane on uniform traffic.  Sorting a tile saves
// only the requests a warp's lanes make to the same records, the upper and
// middle levels of a shard, which mostly hit in cache anyway; 1024 lanes
// of a shard's 16384 are still some 500 keys apart, so the lower levels'
// records stay a miss each.  On the H100 the sort does not pay on scalar
// traffic: against the plan-order walk in the same runs it took from 2%
// less to 13% more time on uniform keys, and 15-30% more on Zipf keys,
// where the sort's fixed cost shows and 93.6% of the lanes fall in one
// shard's lowest buckets.  With K9 at 128 keys a node on uniform keys K6
// saved 7-13% (sorted lanes share owner rows) and K5 took from 7% less
// to 5% more; on Zipf keys both took 17-34% more.  Tiles of 2048 and 4096
// lanes, and grouping the whole batch by key with group_by_key first, did
// not beat 1024 (PERF.md).  Two blocks an SM keep it full: at most 32
// registers a thread, 16 KB of shared memory a block.
//
// K1 and K2 walk lanes grouped by key range.  A monolithic list has no
// shard to group by, so the wrapper first runs group_by_key
// (shard_group.cu): a stable counting sort of the lanes by the bucket
// (u(q) - lo) >> shift, at most 8192 buckets over the batch's own key span
// (uniform 2^20 lanes over 2^25 keys: ~128 lanes, four warps, a bucket of
// ~4096 index keys).  Lane i walks q_sorted[i] and writes at out_idx[i] =
// perm[i], as in K3/K4.  A
// warp's lanes then share their path down to about level log2(4096) = 12
// of 27, roughly half of each lane's steps: there one record load serves the
// warp, and the records below lie in one narrow window of node ids a level
// (nodes are allocated in key order), so even the steps a lane takes alone
// hit sectors its neighbours fetched.  The bucket order changes no lane's
// walk, only which lanes share a warp, so the results are the batch-order
// launch's bit for bit, step cap included.  K1 takes the same pass as K2:
// its one fused load a step gains from shared records as K2's two do.
//
// The foresight step is ONE 8-byte load of the (next_ptr, next_key) record,
// an int2 through the read-only path: the paper's fused load.  The base step
// is two dependent 4-byte loads, pointer then pointee key.
//
// What bounds them: on an index far larger than the 50 MB L2 each step is a
// dependent miss to HBM, so a thread's time is its path length times the
// miss latency; the card's byte rate is not the limit.  Grouping (K1-K4)
// cuts the misses a warp makes, not the chain a lane waits on; more walks
// in flight a thread and the top levels in shared memory are the levers
// left (K1-K4 grouped, K5/K6 tile-sorted).
//
// Record and byte offsets are computed in 64 bits: at 27 levels x 2^26 slots
// the record index reaches 1.8e9 and the byte offset 14.5e9, and a stack of
// 64 shards x 21 levels x 2^21 slots holds 2.8e9 records (22.5 GB).
//
// K9, the fat-node postlude (node_width B > 1: each node holds a sorted run
// of up to B keys in fat_keys [cap, B], padded with KEY_MAX; the walk is over
// the run minima).  From the final predecessor x and its level-0 record
// (cand, ck): owner = (ck == q || x == head) ? cand : x; pos = the number of
// the owner's B lanes below q; the result is (owner * B + min(pos, B-1), the
// key there, or KEY_MAX when pos == B).  It is an exact count over every
// lane, as the reference computes it, not a binary search: that holds on
// any row.  The warp resolves its lanes' rows together (fat_resolve below):
// g threads a row read it with coalesced loads, 32 / g rows a step, so one
// load instruction takes whole lines of one or a few rows rather than 16 B
// of 32 rows (B = 128: one row a step, four 128-B lines; B = 8: 16 rows).
// A row that is not 16-byte aligned (B = 6, a shifted table) takes 4-byte
// loads of the same elements.  What bounds it: one more dependent miss
// (the row, 512 B at B = 128) after the walk's, taken one warp step at a
// time, and the walk's occupancy: K9's registers count against the whole
// kernel, so it keeps nothing but a count across steps (tilings that held
// 2-32 int4 a thread, a prefetch of every lane's row, a pipelined next
// step and one step for all lanes that share a row (__match_any_sync) all
// took more registers or time on the H100).  Where many lanes of a warp
// share a row (Zipf traffic, lanes grouped by key), the per-thread compare
// it replaced read the shared row once for all of them in one instruction;
// here each lane takes a step of its own, so such batches run slower.
// Element ids are int32, as in the reference: the wrappers refuse
// cap * B above 2^31 - 1.

#include <cuda_runtime.h>
#include <cstdint>

#include "tile_sort.cuh"

namespace {

using tile_sort::block_exclusive_scan;
using tile_sort::block_min_max;
using tile_sort::order_key;
using tile_sort::warp_claim;

constexpr int kBlock = 256;
constexpr int kQblk = 128;   // lanes per block of a clustered plan (QBLK)
constexpr int kKeyMax = 0x7fffffff;
constexpr unsigned kFullMask = 0xffffffffu;
// The tile-sorted K5/K6: a tile of 1024 plan lanes a block, one a thread
// (tiles of 2048 and 4096 at 1024 threads measured slower on the H100,
// PERF.md); two blocks an SM, so at most 32 registers a thread (2048
// threads, the SM's whole complement); 2^10 key buckets a tile, one a
// thread in the scan.
constexpr int kTile = 1024;
constexpr int kTileWarps = kTile / 32;
constexpr int kTileMinBlocks = 2;
constexpr int kTileBucketBits = 10;
constexpr int kTileBuckets = 1 << kTileBucketBits;

// K1's walk over one table fused [levels, cap, 2]: the level-0 record of the
// final predecessor, which is left in x.
__device__ __forceinline__ int2 foresight_walk(const int2* __restrict__ fused,
                                               int q, int levels,
                                               long long cap,
                                               long long max_steps, int& x) {
  x = 0;                     // head sentinel
  int lvl = levels - 1;
  for (long long step = 0; step < max_steps && lvl >= 0; ++step) {
    const int2 rec = __ldg(fused + (size_t)lvl * (size_t)cap + (size_t)x);
    if (rec.y < q) x = rec.x; else --lvl;
  }
  return __ldg(fused + (size_t)x);                 // level 0
}

// K2's walk over nxt [levels, cap] and keys [cap]: (successor, its key) of
// the final predecessor, which is left in x.
__device__ __forceinline__ int2 base_walk(const int* __restrict__ nxt,
                                          const int* __restrict__ keys, int q,
                                          int levels, long long cap,
                                          long long max_steps, int& x) {
  x = 0;
  int lvl = levels - 1;
  for (long long step = 0; step < max_steps && lvl >= 0; ++step) {
    const int ptr = __ldg(nxt + (size_t)lvl * (size_t)cap + (size_t)x);
    const int fk = __ldg(keys + (size_t)ptr);      // dependent on ptr
    if (fk < q) x = ptr; else --lvl;
  }
  const int ptr = __ldg(nxt + (size_t)x);
  return make_int2(ptr, __ldg(keys + (size_t)ptr));
}

// K9, warp-cooperative.  EVERY lane of the warp calls it together (no lane
// may have returned: the kernels keep lanes past the batch or not served as
// need == false, and a full-mask ballot needs all 32).  A lane with need
// holds (query q, final predecessor x, its level-0 record cand) and the base
// `fat` of its table [cap, width]; it gets (element-flat node, key).  A lane
// without need gets (0, 0) and is never resolved.
//
// Tiling: a row is read by g threads (the least power of two with 4 * g >=
// width, at most 32), thread j taking elements 4j..4j+3 of each 4 * g, so
// one load instruction covers 16 * g contiguous bytes of a row; 32 / g rows
// are resolved a step (B = 128: one row, four whole 128-B lines; B = 8:
// sixteen 32-B rows).  Step by step the warp's slots take the lowest lanes
// still pending, broadcast their row and query (__shfl_sync), load the rows
// (int4 on a 16-byte-aligned row, else 4-byte loads of the same elements),
// count each thread's elements < q, sum the count over the group (one
// __reduce_add_sync) and hand it to the requesting lane.  Last, each lane
// reads its key at min(pos, width - 1), from a line the warp has just read.
// Nothing is held across steps but the count, so the walks that call K9
// keep the registers they had with the per-thread compare it replaced
// (31-36 a thread; ptxas -v).
__device__ __forceinline__ int2 fat_resolve(const int* __restrict__ fat,
                                            int width, int q, int x,
                                            int2 cand, bool need) {
  const int owner = (cand.y == q || x == 0) ? cand.x : x;
  const int* row = fat + (size_t)owner * (size_t)width;
  const int lane = threadIdx.x & 31;
  int g = 1;
  while (g < 32 && 4 * g < width) g <<= 1;
  const int rows = 32 / g;                      // rows resolved a step
  const int slot = lane / g, sub = lane & (g - 1);
  const unsigned gmask = g == 32 ? kFullMask
                                 : ((1u << g) - 1u) << (slot * g);
  int pos = 0;
  unsigned pending = __ballot_sync(kFullMask, need);
  while (pending) {
    unsigned m = pending;               // slot s serves the s-th lowest lane
    for (int s = 0; s < slot; ++s) m &= m - 1;
    const bool active = m != 0;
    const int src = active ? __ffs(m) - 1 : lane;
    const int* r = reinterpret_cast<const int*>(__shfl_sync(
        kFullMask, reinterpret_cast<unsigned long long>(row), src));
    const int rq = __shfl_sync(kFullMask, q, src);
    const bool vec = (reinterpret_cast<uintptr_t>(r) & 15) == 0;
    int cnt = 0;
    for (int e = 4 * sub; active && e < width; e += 4 * g) {
      const int n = min(4, width - e);          // elements held, 1..4
      int4 v;
      if (n == 4 && vec) {
        v = __ldg(reinterpret_cast<const int4*>(r + e));
      } else {
        v.x = __ldg(r + e);
        v.y = n > 1 ? __ldg(r + e + 1) : 0;
        v.z = n > 2 ? __ldg(r + e + 2) : 0;
        v.w = n > 3 ? __ldg(r + e + 3) : 0;
      }
      cnt += (v.x < rq) + (n > 1 && v.y < rq) + (n > 2 && v.z < rq) +
             (n > 3 && v.w < rq);
    }
    cnt = __reduce_add_sync(gmask, cnt);                 // the group's sum
    // lane i was served by the slot of its rank among the pending lanes
    const int rank = __popc(pending & ((1u << lane) - 1u));
    const int got = __shfl_sync(kFullMask, cnt, min(rank, rows - 1) * g);
    if (((pending >> lane) & 1u) && rank < rows) pos = got;
    for (int s = 0; s < rows; ++s) pending &= pending - 1;
  }
  if (!need) return make_int2(0, 0);
  const int pos_c = min(pos, width - 1);
  return make_int2(owner * width + pos_c,
                   pos < width ? __ldg(row + pos_c) : kKeyMax);
}

// Lane i's result goes to out_idx[i], or to i when out_idx is null.
__device__ __forceinline__ void store(const int* __restrict__ out_idx,
                                      long long i, int* __restrict__ node,
                                      int* __restrict__ key, int2 r) {
  const long long o = out_idx == nullptr ? i : (long long)__ldg(out_idx + i);
  node[o] = r.x;
  key[o] = r.y;
}

// Is lane i, of shard s, served by its clustered block's slots?
__device__ __forceinline__ bool served_by_plan(const int* __restrict__ bsids,
                                               const int* __restrict__ ndist,
                                               long long i, int s, int k_slots) {
  const long long j = i / kQblk;
  const int nd = min(__ldg(ndist + j), k_slots);
  const int* row = bsids + (size_t)j * (size_t)k_slots;
  for (int k = 0; k < nd; ++k)
    if (__ldg(row + k) == s) return true;
  return false;
}

// In every kernel, fat == nullptr is the scalar layout; otherwise K9 runs
// on the walk's result, in the lane's shard's runs (offset s * cap * width).
// No lane returns early: K9 needs the whole warp.  A lane past the batch,
// or not served, walks nothing and passes need == false to K9.
// K1: lane i walks queries[i] and writes its result at out_idx[i], or at i
// when out_idx is null.
__global__ void __launch_bounds__(kBlock)
foresight_kernel(const int2* __restrict__ fused, const int* __restrict__ fat,
                 const int* __restrict__ out_idx,
                 const int* __restrict__ queries, int* __restrict__ node,
                 int* __restrict__ key, long long batch, int levels,
                 long long cap, int width, long long max_steps) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < batch;
  const int q = live ? queries[i] : 0;
  int x = 0;
  int2 r = make_int2(0, 0);
  if (live) r = foresight_walk(fused, q, levels, cap, max_steps, x);
  if (fat != nullptr) r = fat_resolve(fat, width, q, x, r, live);
  if (live) store(out_idx, i, node, key, r);
}

// K2: the same, two dependent loads a step.
__global__ void __launch_bounds__(kBlock)
base_kernel(const int* __restrict__ nxt, const int* __restrict__ keys,
            const int* __restrict__ fat, const int* __restrict__ out_idx,
            const int* __restrict__ queries, int* __restrict__ node,
            int* __restrict__ key, long long batch, int levels, long long cap,
            int width, long long max_steps) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < batch;
  const int q = live ? queries[i] : 0;
  int x = 0;
  int2 r = make_int2(0, 0);
  if (live) r = base_walk(nxt, keys, q, levels, cap, max_steps, x);
  if (fat != nullptr) r = fat_resolve(fat, width, q, x, r, live);
  if (live) store(out_idx, i, node, key, r);
}

// K3 and K5: bsids == nullptr is the dense K3, every in-range lane served.
// Lane i's result goes to out_idx[i], or to i when out_idx is null.
__global__ void __launch_bounds__(kBlock)
foresight_sharded_kernel(const int2* __restrict__ fused,
                         const int* __restrict__ fat,
                         const int* __restrict__ bsids,
                         const int* __restrict__ ndist,
                         const int* __restrict__ sids,
                         const int* __restrict__ out_idx,
                         const int* __restrict__ queries,
                         int* __restrict__ node, int* __restrict__ key,
                         long long batch, int shards, int k_slots, int levels,
                         long long cap, int width, long long max_steps) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < batch;
  const int s = live ? sids[i] : -1;
  const bool served = live && s >= 0 && s < shards &&
      (bsids == nullptr || served_by_plan(bsids, ndist, i, s, k_slots));
  const int q = served ? queries[i] : 0;
  int x = 0;
  int2 r = make_int2(0, 0);
  if (served)
    r = foresight_walk(fused + (size_t)s * (size_t)levels * (size_t)cap, q,
                       levels, cap, max_steps, x);
  if (fat != nullptr)
    r = fat_resolve(fat + (size_t)(served ? s : 0) * (size_t)cap *
                              (size_t)width,
                    width, q, x, r, served);
  if (live) store(out_idx, i, node, key, r);
}

// K4 and K6: bsids == nullptr is the dense K4.
__global__ void __launch_bounds__(kBlock)
base_sharded_kernel(const int* __restrict__ nxt, const int* __restrict__ keys,
                    const int* __restrict__ fat,
                    const int* __restrict__ bsids,
                    const int* __restrict__ ndist,
                    const int* __restrict__ sids,
                    const int* __restrict__ out_idx,
                    const int* __restrict__ queries, int* __restrict__ node,
                    int* __restrict__ key, long long batch, int shards,
                    int k_slots, int levels, long long cap, int width,
                    long long max_steps) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < batch;
  const int s = live ? sids[i] : -1;
  const bool served = live && s >= 0 && s < shards &&
      (bsids == nullptr || served_by_plan(bsids, ndist, i, s, k_slots));
  const int q = served ? queries[i] : 0;
  int x = 0;
  int2 r = make_int2(0, 0);
  if (served)
    r = base_walk(nxt + (size_t)s * (size_t)levels * (size_t)cap,
                  keys + (size_t)s * (size_t)cap, q, levels, cap, max_steps,
                  x);
  if (fat != nullptr)
    r = fat_resolve(fat + (size_t)(served ? s : 0) * (size_t)cap *
                              (size_t)width,
                    width, q, x, r, served);
  if (live) store(out_idx, i, node, key, r);
}

// K5 and K6: the clustered walk on tiles of the plan's lanes, each tile
// sorted by key in shared memory.  Block j takes the kTile consecutive plan
// lanes from j * kTile, one a thread, and:
//   (1) reads its lane's shard id and query (coalesced) and decides at the
//       lane's plan index i whether it walks: a lane past the batch, with a
//       shard id outside [0, S), or not among block i / 128's slots
//       (served_by_plan) walks nothing;
//   (2) finds the least and greatest order key of the lanes that walk;
//   (3) counts the lanes into kTileBuckets key buckets (u - lo) >> shift
//       over that span, a lane that walks nothing into the last, and keeps
//       its rank in its bucket (warp-aggregated shared atomics);
//   (4) scans the counts, one bucket a thread, into each bucket's first
//       sorted position;
//   (5) writes (slot, shard or -1, query) at its sorted position;
//   (6) walks: thread t takes sorted position t, so warp w walks the 32
//       consecutive sorted lanes 32w.., which lie in one narrow key range
//       of one shard; each lane keeps its own early exit and max_steps, the
//       whole warp reaches K9, and each result is stored at its plan index.
// The order changes no lane's walk, only which lanes share a warp, so the
// results equal the plan-order launch bit for bit, step cap included.
template <bool kForesight>
__global__ void __launch_bounds__(kTile, kTileMinBlocks)
clustered_tile_kernel(const int2* __restrict__ fused,
                      const int* __restrict__ nxt,
                      const int* __restrict__ keys,
                      const int* __restrict__ fat,
                      const int* __restrict__ bsids,
                      const int* __restrict__ ndist,
                      const int* __restrict__ sids,
                      const int* __restrict__ queries,
                      int* __restrict__ node, int* __restrict__ key,
                      long long batch, int shards, int k_slots, int levels,
                      long long cap, int width, long long max_steps) {
  __shared__ int next[kTileBuckets];        // counts, then first positions
  __shared__ int o_slot[kTile], o_sid[kTile], o_q[kTile];    // sorted lanes
  __shared__ unsigned lo_w[kTileWarps], hi_w[kTileWarps], span[2];
  __shared__ int warp_sums[kTileWarps];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kTile;
  next[t] = 0;
  const long long i = base + t;                                  // (1)
  const bool live = i < batch;
  const int s = live ? __ldg(sids + i) : -1;
  const int q = live ? __ldg(queries + i) : 0;
  const bool walks = live && s >= 0 && s < shards &&
                     served_by_plan(bsids, ndist, i, s, k_slots);
  unsigned lo = walks ? order_key(q) : 0xffffffffu;               // (2)
  unsigned hi = walks ? order_key(q) : 0u;
  block_min_max<kTileWarps>(lo, hi, lo_w, hi_w);
  if (t == 0) {
    span[0] = lo;
    span[1] = lo <= hi ? tile_sort::span_shift(lo, hi, kTileBucketBits) : 0;
  }
  __syncthreads();
  const int b = walks ? (int)((order_key(q) - span[0]) >> span[1])  // (3)
                      : kTileBuckets - 1;
  const int rank = warp_claim(next, b);
  __syncthreads();
  int total;                                                     // (4)
  const int first = block_exclusive_scan<kTileWarps>(next[t], warp_sums,
                                                     total);
  next[t] = first;                 // bucket t is this thread's alone here
  __syncthreads();
  const int pos = next[b] + rank;                                // (5)
  o_slot[pos] = t;
  o_sid[pos] = walks ? s : -1;
  o_q[pos] = q;
  __syncthreads();
  const int ws = o_sid[t], wq = o_q[t];                          // (6)
  const bool w = ws >= 0;
  int x = 0;
  int2 res = make_int2(0, 0);
  if (w) {
    if constexpr (kForesight)
      res = foresight_walk(fused + (size_t)ws * (size_t)levels * (size_t)cap,
                           wq, levels, cap, max_steps, x);
    else
      res = base_walk(nxt + (size_t)ws * (size_t)levels * (size_t)cap,
                      keys + (size_t)ws * (size_t)cap, wq, levels, cap,
                      max_steps, x);
  }
  if (fat != nullptr)
    res = fat_resolve(fat + (size_t)(w ? ws : 0) * (size_t)cap *
                                (size_t)width,
                      width, wq, x, res, w);
  const long long o = base + o_slot[t];
  if (o < batch) {
    node[o] = res.x;
    key[o] = res.y;
  }
}

// K9 alone, from given final predecessors xs over the level-0 records of a
// foresight table (fused's first cap records).
__global__ void __launch_bounds__(kBlock)
fat_resolve_kernel(const int2* __restrict__ fused, const int* __restrict__ fat,
                   const int* __restrict__ xs, const int* __restrict__ queries,
                   int* __restrict__ node, int* __restrict__ key,
                   long long batch, int width) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < batch;
  const int x = live ? xs[i] : 0;
  const int q = live ? queries[i] : 0;
  const int2 cand = live ? __ldg(fused + (size_t)x) : make_int2(0, 0);
  const int2 r = fat_resolve(fat, width, q, x, cand, live);
  if (live) store(nullptr, i, node, key, r);
}

unsigned grid_for(long long batch) {
  return (unsigned)((batch + kBlock - 1) / kBlock);
}

// The tile-sorted K5 / K6 launch: a block of kTile threads a tile.
template <bool kForesight>
int clustered_tile_launch(const int2* fused, const int* nxt, const int* keys,
                          const int* fat, const int* bsids, const int* ndist,
                          const int* sids, const int* queries, int* node,
                          int* key, long long batch, int shards, int k_slots,
                          int levels, long long cap, int width,
                          long long max_steps, cudaStream_t st) {
  clustered_tile_kernel<kForesight>
      <<<(unsigned)((batch + kTile - 1) / kTile), kTile, 0, st>>>(
          fused, nxt, keys, fat, bsids, ndist, sids, queries, node, key,
          batch, shards, k_slots, levels, cap, width, max_steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError().
// `batch` must be positive.  `fat` is null on the scalar layout (`width` is
// then 1 and unused).
// K1 and K2: lane i walks queries[i] and writes its result at out_idx[i];
// out_idx may be null (lane i writes at i).
int foresight_traverse_launch(const void* fused, const void* fat,
                              const void* out_idx, const void* queries,
                              void* node, void* key, long long batch,
                              int levels, long long cap, int width,
                              long long max_steps, void* stream) {
  foresight_kernel<<<grid_for(batch), kBlock, 0, (cudaStream_t)stream>>>(
      (const int2*)fused, (const int*)fat, (const int*)out_idx,
      (const int*)queries, (int*)node, (int*)key, batch, levels, cap, width,
      max_steps);
  return (int)cudaGetLastError();
}

int base_traverse_launch(const void* nxt, const void* keys, const void* fat,
                         const void* out_idx, const void* queries, void* node,
                         void* key, long long batch, int levels,
                         long long cap, int width, long long max_steps,
                         void* stream) {
  base_kernel<<<grid_for(batch), kBlock, 0, (cudaStream_t)stream>>>(
      (const int*)nxt, (const int*)keys, (const int*)fat,
      (const int*)out_idx, (const int*)queries, (int*)node, (int*)key, batch,
      levels, cap, width, max_steps);
  return (int)cudaGetLastError();
}

// The dense K3 / K4: lane i walks (sids[i], queries[i]) and writes its
// result at out_idx[i]; out_idx may be null (lane i writes at i).
int foresight_sharded_launch(const void* fused, const void* fat,
                             const void* sids, const void* out_idx,
                             const void* queries, void* node, void* key,
                             long long batch, int shards, int levels,
                             long long cap, int width, long long max_steps,
                             void* stream) {
  foresight_sharded_kernel<<<grid_for(batch), kBlock, 0,
                             (cudaStream_t)stream>>>(
      (const int2*)fused, (const int*)fat, nullptr, nullptr,
      (const int*)sids, (const int*)out_idx, (const int*)queries, (int*)node,
      (int*)key, batch, shards, 0, levels, cap, width, max_steps);
  return (int)cudaGetLastError();
}

int base_sharded_launch(const void* nxt, const void* keys, const void* fat,
                        const void* sids, const void* out_idx,
                        const void* queries, void* node, void* key,
                        long long batch, int shards, int levels,
                        long long cap, int width, long long max_steps,
                        void* stream) {
  base_sharded_kernel<<<grid_for(batch), kBlock, 0, (cudaStream_t)stream>>>(
      (const int*)nxt, (const int*)keys, (const int*)fat, nullptr, nullptr,
      (const int*)sids, (const int*)out_idx, (const int*)queries, (int*)node,
      (int*)key, batch, shards, 0, levels, cap, width, max_steps);
  return (int)cudaGetLastError();
}

// K5 / K6 in the plan's lane order, one thread a lane (the walk before the
// tile sort): kept only as the yardstick that chip_smoke.py times beside
// the tile-sorted launch below.  No wrapper calls it.
int foresight_clustered_plan_order_launch(
    const void* fused, const void* fat, const void* bsids, const void* ndist,
    const void* sids, const void* queries, void* node, void* key,
    long long batch, int shards, int k_slots, int levels, long long cap,
    int width, long long max_steps, void* stream) {
  foresight_sharded_kernel<<<grid_for(batch), kBlock, 0,
                             (cudaStream_t)stream>>>(
      (const int2*)fused, (const int*)fat, (const int*)bsids,
      (const int*)ndist, (const int*)sids, nullptr, (const int*)queries,
      (int*)node, (int*)key, batch, shards, k_slots, levels, cap, width,
      max_steps);
  return (int)cudaGetLastError();
}

int base_clustered_plan_order_launch(
    const void* nxt, const void* keys, const void* fat, const void* bsids,
    const void* ndist, const void* sids, const void* queries, void* node,
    void* key, long long batch, int shards, int k_slots, int levels,
    long long cap, int width, long long max_steps, void* stream) {
  base_sharded_kernel<<<grid_for(batch), kBlock, 0, (cudaStream_t)stream>>>(
      (const int*)nxt, (const int*)keys, (const int*)fat, (const int*)bsids,
      (const int*)ndist, (const int*)sids, nullptr, (const int*)queries,
      (int*)node, (int*)key, batch, shards, k_slots, levels, cap, width,
      max_steps);
  return (int)cudaGetLastError();
}

// K5 / K6, the wrappers' launch: the tile-sorted walk.
int foresight_clustered_launch(const void* fused, const void* fat,
                               const void* bsids, const void* ndist,
                               const void* sids, const void* queries,
                               void* node, void* key, long long batch,
                               int shards, int k_slots, int levels,
                               long long cap, int width,
                               long long max_steps, void* stream) {
  return clustered_tile_launch<true>(
      (const int2*)fused, nullptr, nullptr, (const int*)fat,
      (const int*)bsids, (const int*)ndist, (const int*)sids,
      (const int*)queries, (int*)node, (int*)key, batch, shards, k_slots,
      levels, cap, width, max_steps, (cudaStream_t)stream);
}

int base_clustered_launch(const void* nxt, const void* keys, const void* fat,
                          const void* bsids, const void* ndist,
                          const void* sids, const void* queries, void* node,
                          void* key, long long batch, int shards, int k_slots,
                          int levels, long long cap, int width,
                          long long max_steps, void* stream) {
  return clustered_tile_launch<false>(
      nullptr, (const int*)nxt, (const int*)keys, (const int*)fat,
      (const int*)bsids, (const int*)ndist, (const int*)sids,
      (const int*)queries, (int*)node, (int*)key, batch, shards, k_slots,
      levels, cap, width, max_steps, (cudaStream_t)stream);
}

int fat_resolve_launch(const void* fused, const void* fat, const void* xs,
                       const void* queries, void* node, void* key,
                       long long batch, int width, void* stream) {
  fat_resolve_kernel<<<grid_for(batch), kBlock, 0, (cudaStream_t)stream>>>(
      (const int2*)fused, (const int*)fat, (const int*)xs,
      (const int*)queries, (int*)node, (int*)key, batch, width);
  return (int)cudaGetLastError();
}

const char* traverse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
