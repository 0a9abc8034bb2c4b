// Ordered range scans for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: it is the device counterpart of the
// reference's scans (repro/core/skiplist.py range_scan and its fat cursor,
// repro/core/sharded.py range_scan_sharded, each a lax.fori_loop).  Its
// plain version is the port's host loop (core/skiplist.py range_scan_plain,
// to_sorted_keys_plain, core/sharded.py range_scan_sharded_plain); the
// wrapper is kernels/range_scan.py range_scan_batch.
//
// range_scan_launch takes a batch of Q scans (lo[i], hi[i]) over one list
// (boundaries null: a stack of one) or a stack of S shards, and writes each
// scan's pairs with lo <= key < hi, in key order, to out_keys / out_vals
// [Q, max_out] (KEY_MAX / NULL_VAL past its count) and the count to
// out_count [Q].  It stops where the reference stops:
//   - scalar list: positioned at lo's level-0 predecessor by the walk of
//     K1 / K2 (head at level L - 1, right while the foreseen key < lo,
//     else down), then level 0 until a key outside [lo, hi) or max_out;
//   - sharded: routed to lo's shard (the last boundary <= lo), walked
//     there, then level 0, a shard's tail spilling into the next shard's
//     head (across dead slots too), for at most max_out + S steps;
//   - fat layout: a (shard, node, lane) cursor from the level-0
//     predecessor node (its run may straddle lo), lane by lane, hopping to
//     the next node at a run's end (a KEY_MAX lane or past the last), until
//     the tail's self-loop (sharded: the last shard's tail), a key at or
//     past hi or max_out pairs, for at most 2 * max_out + B + 4 steps
//     (sharded: + 2 * S);
//   - raw (to_sorted_keys): max_out steps along level 0 from the head,
//     every successor's key written, the tail's self-loop included.
//
// Design: one warp a scan.  A scalar or raw scan of fewer than
// kGatherFrom pairs (a start level l* of 0, below) is one chain of
// dependent loads, walked by lane 0 as above.  Every longer scan, and
// every fat scan, is gathered
// top-down by the whole warp (level_walk.cuh), in rounds:
//   - the positioning walk goes on to level 0 and keeps, on each level l,
//     the key of lo's predecessor p_l; the round starts at p_{l*};
//   - lane 0 walks level l* from the round's start c for at most
//     kRoundNodes nodes keyed below hi (and the frontier's room); the node
//     after them is the round's end e;
//   - the warp gathers [c, e) down to level 0, a lane a contiguous share
//     of each level's frontier, warp shuffles for the prefix sums, every
//     level's frontier clipped at the pairs still wanted + 1 (each kept node
//     after the first holds a pair), the first round dropping on each level
//     l the nodes before p_l (keyed below lo);
//   - a scalar scan writes each kept level-0 node (key >= lo, not the head)
//     at its place; a fat scan keeps the level-0 nodes from p_0 as a node
//     list, then copies their runs: 32 nodes at a time, a lane a node's nlen,
//     a prefix sum, then a lane an element (its node by a binary search over
//     the lanes), each element in [lo, hi) written at its place by a ballot,
//     stopping at the first element >= hi or max_out;
//   - the next round starts at e, or, at a shard's tail, at the next shard's
//     head (sharded scans, across dead slots too), until max_out pairs, a
//     key >= hi, or the last tail.
// The start level: l* = floor(log2(nodes / 32)) clamped to [0, L - 1], nodes
// the level-0 nodes the scan expects to read (max_out; a fat scan
// max_out / pack_fill(B)), so 64 level-l* nodes cover about twice that;
// a scalar or raw scan gathers from level 1 or higher.
// The reference's step bounds (max_out + S; 2 * max_out + B + 4, + 2 * S
// sharded) never bind on a well-formed table: a scan stops at a key, a
// count or a last tail first.  __launch_bounds__(128, 1): with the block
// size alone ptxas held the walk at 32 registers and spilled.  The state is
// read only, through the read-only path; the frontier (front [Q, max_out +
// 2]) is not.  Every walk runs under max_steps (kernels/foresight_traverse.py
// traversal_bound) and traps past it.  What bounds it: the chain.  A
// gathered level costs a lane about 2 * n_l / 32 dependent loads (n_l the
// level's nodes in the range), but a warp's lanes step together, so each
// step waits for its slowest lane's miss; one lane walking level 0 misses
// only where its records leave a line (about every 16 keys in a list built
// in key order, whose node ids follow its keys).

#include <cuda_runtime.h>
#include <cstdint>

#include "level_walk.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxLevels = 32;
constexpr int kRoundNodes = 64;   // level-l* nodes a round starts from
// A scalar or raw scan of fewer pairs is walked by lane 0 (l* = 0).
constexpr int kGatherFrom = 64;
constexpr int kKeyMax = 0x7fffffff;
constexpr int kKeyMin = (int)0x80000000;
constexpr int kNullVal = -1;
constexpr int kHead = 0;
constexpr unsigned kFullMask = 0xffffffffu;

struct Args {
  const int2* fused;       // [S, L, cap] records (foresight) or null
  const int* nxt;          // [S, L, cap] (base) or null
  const int* keys;         // [S, cap]
  const int* vals;         // [S, cap]
  const int* fat_keys;     // [S, cap, B] (fat) or null
  const int* fat_vals;     // [S, cap, B] (fat) or null
  const int* nlen;         // [S, cap] (fat) or null
  const int* boundaries;   // [S] (sharded) or null (one list)
  const int* lo;           // [Q]
  const int* hi;           // [Q]
  int* out_keys;           // [Q, max_out]
  int* out_vals;           // [Q, max_out]
  int* out_count;          // [Q]
  int* front;              // [Q, max_out + 2] scratch: the frontiers
  long long scans;
  long long cap;
  long long max_steps;
  int shards;
  int levels;
  int width;
  int max_out;
  int raw;
};

// Node x's record at level l of shard s: (successor, its key).
template <bool kForesight>
__device__ __forceinline__ int2 record(const Args& a, int s, int l, int x) {
  const size_t idx = ((size_t)s * a.levels + l) * (size_t)a.cap + (size_t)x;
  if (kForesight) return __ldg(a.fused + idx);
  const int p = __ldg(a.nxt + idx);
  return make_int2(p, __ldg(a.keys + (size_t)s * a.cap + p));
}

// lo's level-0 predecessor in shard s (K1 / K2's walk).  With `floors`,
// the predecessor on level lstar, and floors[l] the key of the predecessor
// on each level l (KEY_MIN: the head).
template <bool kForesight>
__device__ __forceinline__ int position(const Args& a, int s, int q,
                                        int lstar = 0,
                                        int* floors = nullptr) {
  int x = kHead, kx = kKeyMin, at = kHead, lvl = a.levels - 1;
  long long steps = 0;
  while (lvl >= 0) {
    if (++steps > a.max_steps) __trap();       // a corrupt table
    const int2 rec = record<kForesight>(a, s, lvl, x);
    if (rec.y < q) {
      x = rec.x;
      kx = rec.y;
    } else {
      if (floors != nullptr) floors[lvl] = kx;
      if (lvl == lstar) at = x;
      --lvl;
    }
  }
  return floors != nullptr ? at : x;
}

// The shard route() sends q to: the last boundary <= q, clamped.
__device__ __forceinline__ int route(const Args& a, int q) {
  int lo = 0, hi = a.shards;                   // first boundary > q
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(a.boundaries + mid) <= q) lo = mid + 1; else hi = mid;
  }
  return max(0, min(lo - 1, a.shards - 1));
}

// Lane 0's walks for a scan of l* = 0: each writes its pairs at out_k /
// out_v and returns how many.

template <bool kForesight>
__device__ __forceinline__ int scan_scalar(const Args& a, int q_lo, int q_hi,
                                           int* out_k, int* out_v) {
  const bool sharded = a.boundaries != nullptr;
  const int S = sharded ? a.shards : 1;
  int s = sharded ? route(a, q_lo) : 0;
  int x = position<kForesight>(a, s, q_lo);
  int count = 0;
  if (!sharded) {
    while (count < a.max_out) {
      const int2 rec = record<kForesight>(a, 0, 0, x);
      if (!(q_lo <= rec.y && rec.y < q_hi)) break;
      out_k[count] = rec.y;
      out_v[count++] = __ldg(a.vals + rec.x);
      x = rec.x;
    }
    return count;
  }
  for (long long it = 0; it < (long long)a.max_out + S; ++it) {
    const int2 rec = record<kForesight>(a, s, 0, x);
    const int k = rec.y;
    if (k != kKeyMax && q_lo <= k && k < q_hi && count < a.max_out) {
      out_k[count] = k;
      out_v[count++] = __ldg(a.vals + (size_t)s * a.cap + rec.x);
      x = rec.x;
    } else if (k == kKeyMax && s < S - 1) {    // shard exhausted: spill
      ++s;
      x = kHead;
    } else {
      break;
    }
  }
  return count;
}

template <bool kForesight>
__device__ __forceinline__ int scan_raw(const Args& a, int* out_k,
                                        int* out_v) {
  int x = kHead;
  for (int i = 0; i < a.max_out; ++i) {
    const int2 rec = record<kForesight>(a, 0, 0, x);
    out_k[i] = rec.y;
    out_v[i] = kNullVal;
    x = rec.x;
  }
  return a.max_out;
}

// ---------------------------------------------------------------------------
// The top-down scans (every lane of the warp)
// ---------------------------------------------------------------------------

// Shard s of a scan as level_walk::gather sees it.  Above level 0 a node
// is kept from the predecessor of lo on its level on (floors; every node
// past the first round); at level 0 a scalar scan keeps the nodes keyed >=
// lo but the head and writes each at out[pos] below need, and a fat scan
// keeps the nodes from p_0 on as a node list in front[pos] below room.
template <bool kForesight, bool kFat>
struct ScanWalk {
  const Args* a;
  int s;
  const int* floors;       // null: keep every node
  int lo;
  int* out_k;              // the round's first free pair
  int* out_v;
  int* front;
  long long need, room;
  __device__ int2 rec(int l, int x) const {
    return record<kForesight>(*a, s, l, x);
  }
  __device__ int key(int x) const {
    return __ldg(a->keys + (size_t)s * a->cap + x);
  }
  __device__ long long weight(int l, int y, int ky) const {
    if (l > 0 || kFat) return floors == nullptr || ky >= floors[l];
    return y != kHead && ky >= lo;
  }
  __device__ void emit(int y, int ky, long long pos) const {
    if (kFat) {
      if (pos < room) front[pos] = y;
    } else if (pos < need) {
      out_k[pos] = ky;
      out_v[pos] = a->raw ? kNullVal
                          : __ldg(a->vals + (size_t)s * a->cap + y);
    }
  }
};

// The runs of the node list front[0, nodes) of shard s, in order: every
// element in [lo, hi) written at out[count ..] until the first element >=
// hi or max_out pairs; returns whether the scan stopped there.
__device__ bool copy_runs(const Args& a, int s, const int* front,
                          long long nodes, int q_lo, int q_hi, int* out_k,
                          int* out_v, int& count) {
  const int lane = threadIdx.x & (kWarp - 1), B = a.width;
  const size_t row0 = (size_t)s * a.cap;
  const level_walk::Warp warp{};
  for (long long g = 0; g < nodes; g += kWarp) {
    const int gn = (int)min((long long)kWarp, nodes - g);
    int node = 0, m = 0;
    if (lane < gn) {
      node = front[g + lane];
      m = max(0, min(__ldg(a.nlen + row0 + node), B));
    }
    long long total;
    const int o = (int)warp.scan(m, total);
    for (long long t0 = 0; t0 < total; t0 += kWarp) {
      const long long t = t0 + lane;
      const bool valid = t < total;
      int j = 0;                       // the last lane whose run starts <= t
      for (int step = kWarp / 2; step > 0; step >>= 1) {
        const int oc = __shfl_sync(kFullMask, o, j + step);
        if (j + step < gn && oc <= t) j += step;
      }
      const int nj = __shfl_sync(kFullMask, node, j);
      const int oj = __shfl_sync(kFullMask, o, j);
      int k = kKeyMax, v = kNullVal;
      if (valid) {
        const size_t at = (row0 + nj) * B + (size_t)(t - oj);
        k = __ldg(a.fat_keys + at);
        v = __ldg(a.fat_vals + at);
      }
      const unsigned stop = __ballot_sync(kFullMask, valid && k >= q_hi);
      const int first_stop = stop ? __ffs(stop) - 1 : kWarp;
      const bool take = valid && lane < first_stop && k >= q_lo;
      const unsigned taken = __ballot_sync(kFullMask, take);
      const int at = count + __popc(taken & ((1u << lane) - 1));
      if (take && at < a.max_out) {
        out_k[at] = k;
        out_v[at] = v;
      }
      count = min(count + __popc(taken), a.max_out);
      if (stop != 0 || count >= a.max_out) return true;
    }
  }
  return false;
}

// A scan gathered top-down from level lstar (every lane calls); returns
// the pairs written at out_k / out_v.
template <bool kForesight, bool kFat>
__device__ int scan_rounds(const Args& a, int lstar, int q_lo, int q_hi,
                           bool sharded, int* out_k, int* out_v, int* front) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int S = sharded ? a.shards : 1;
  int s = sharded ? route(a, q_lo) : 0;
  int floors[kMaxLevels];
  int c = position<kForesight>(a, s, q_lo, lstar, floors);
  const int* fl = floors;
  int count = 0;
  for (long long round = 0;; ++round) {
    if (round > (long long)a.max_out + S) __trap();
    const long long need = a.max_out - count, room = need + 1;
    int k = 0, e = 0, ekey = 0;
    if (lane == 0) {                   // level lstar from c: front[0 .. k]
      front[0] = c;
      int x = c;
      for (long long steps = 1;; ++steps) {
        if (steps > a.max_steps) __trap();
        const int2 r = record<kForesight>(a, s, lstar, x);
        if (r.y >= q_hi || k == kRoundNodes || k + 1 >= room) {
          e = r.x;
          ekey = r.y;
          break;
        }
        front[++k] = r.x;
        x = r.x;
      }
    }
    k = __shfl_sync(kFullMask, k, 0);
    e = __shfl_sync(kFullMask, e, 0);
    ekey = __shfl_sync(kFullMask, ekey, 0);
    __syncwarp();
    const ScanWalk<kForesight, kFat> ops{&a, s, fl, q_lo, out_k + count,
                                         out_v + count, front, need, room};
    bool stopped = false;
    const long long got =
        lstar == 0 ? k + 1
                   : level_walk::gather(level_walk::Warp{}, ops, front, c,
                                        k + 1, lstar, e, q_hi, room,
                                        a.max_steps);
    if (kFat) {
      stopped = copy_runs(a, s, front, min(got, room), q_lo, q_hi, out_k,
                          out_v, count);
    } else {
      count += (int)min(got, need);
    }
    __syncwarp();
    if (stopped || count >= a.max_out) break;
    if (ekey == kKeyMax) {             // the shard's tail
      if (s >= S - 1) break;
      ++s;                             // spill into the next shard's head
      c = kHead;
    } else if (ekey >= q_hi) {
      break;
    } else {
      c = e;
    }
    fl = nullptr;
  }
  return count;
}

// The level a top-down scan starts from: floor(log2(nodes / 32)) in
// [0, L - 1], nodes the level-0 nodes the scan expects to read; 0 (lane
// 0's walk) for a scalar or raw scan of fewer than kGatherFrom pairs, at
// least 1 for a longer one.
__device__ __forceinline__ int start_level(const Args& a, bool fat) {
  const long long fill = a.width > 1 ? a.width / 2 : 1;  // pack_fill
  const long long nodes = fat ? (a.max_out + fill - 1) / fill : a.max_out;
  if (!fat && nodes < kGatherFrom) return 0;
  int l = fat ? 0 : 1;
  while (l + 1 < a.levels && ((long long)kWarp << (l + 1)) <= nodes) ++l;
  return min(l, a.levels - 1);
}

template <bool kForesight>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, 1)
range_scan_kernel(Args a) {
  const long long i =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= a.scans) return;                    // a whole warp
  const int lane = threadIdx.x & (kWarp - 1);
  int* out_k = a.out_keys + (size_t)i * a.max_out;
  int* out_v = a.out_vals + (size_t)i * a.max_out;
  int* front = a.front + (size_t)i * (a.max_out + 2);
  const int q_lo = a.lo[i], q_hi = a.hi[i];
  const bool fat = a.fat_keys != nullptr && !a.raw;
  const bool sharded = a.boundaries != nullptr && !a.raw;
  const int lstar = start_level(a, fat);
  int count = 0;
  if (fat) {
    count = scan_rounds<kForesight, true>(a, lstar, q_lo, q_hi, sharded,
                                          out_k, out_v, front);
  } else if (lstar > 0) {
    count = scan_rounds<kForesight, false>(
        a, lstar, a.raw ? kKeyMin : q_lo, a.raw ? kKeyMax : q_hi, sharded,
        out_k, out_v, front);
  } else {
    if (lane == 0)
      count = a.raw ? scan_raw<kForesight>(a, out_k, out_v)
                    : scan_scalar<kForesight>(a, q_lo, q_hi, out_k, out_v);
    count = __shfl_sync(kFullMask, count, 0);
  }
  for (int j = count + lane; j < a.max_out; j += kWarp) {
    out_k[j] = kKeyMax;                        // raw: the tail's self-loop
    out_v[j] = kNullVal;
  }
  if (lane == 0) a.out_count[i] = a.raw ? a.max_out : count;
}

}  // namespace

extern "C" {

// Runs Q scans; enqueues on `stream` and returns cudaGetLastError().
// `fused` (foresight) or `nxt` (base) is null; `fat_keys` / `fat_vals` /
// `nlen` are null on the scalar layout (`width` 1); `boundaries` is null
// for one list (`shards` 1).  max_out >= 1; front holds Q * (max_out + 2)
// ints.
int range_scan_launch(const void* fused, const void* nxt, const void* keys,
                      const void* vals, const void* fat_keys,
                      const void* fat_vals, const void* nlen,
                      const void* boundaries, const void* lo, const void* hi,
                      void* out_keys, void* out_vals, void* out_count,
                      void* front, long long scans,
                      int shards, int levels, long long cap, int width,
                      int max_out, int raw, long long max_steps,
                      void* stream) {
  Args a;
  a.fused = (const int2*)fused;
  a.nxt = (const int*)nxt;
  a.keys = (const int*)keys;
  a.vals = (const int*)vals;
  a.fat_keys = (const int*)fat_keys;
  a.fat_vals = (const int*)fat_vals;
  a.nlen = (const int*)nlen;
  a.boundaries = (const int*)boundaries;
  a.lo = (const int*)lo;
  a.hi = (const int*)hi;
  a.out_keys = (int*)out_keys;
  a.out_vals = (int*)out_vals;
  a.out_count = (int*)out_count;
  a.front = (int*)front;
  a.scans = scans;
  a.cap = cap;
  a.max_steps = max_steps;
  a.shards = shards;
  a.levels = levels;
  a.width = width;
  a.max_out = max_out;
  a.raw = raw;
  const long long blocks = (scans + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = (cudaStream_t)stream;
  if (fused != nullptr)
    range_scan_kernel<true><<<blocks, kWarp * kWarpsPerBlock, 0, st>>>(a);
  else
    range_scan_kernel<false><<<blocks, kWarp * kWarpsPerBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
