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
// Design: one warp a scan, lane 0 walking (a scan is one chain of
// dependent loads; the other lanes have no independent work in it).
// __launch_bounds__(128, 1): with the block size alone ptxas held the
// kernel at 32 registers and spilled 8 B a thread; 40 / 56 without.  The
// state is read only, through the read-only path.  The positioning walk
// runs under max_steps (kernels/foresight_traverse.py traversal_bound) and
// traps past it.  What bounds it: the chain, one dependent load a key
// (a level-0 record, then its val; a fat run's lanes share lines).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kKeyMax = 0x7fffffff;
constexpr int kNullVal = -1;
constexpr int kHead = 0;

struct Args {
  const int2* fused;       // [S, L, cap] records (foresight) or null
  const int* nxt;          // [S, L, cap] (base) or null
  const int* keys;         // [S, cap]
  const int* vals;         // [S, cap]
  const int* fat_keys;     // [S, cap, B] (fat) or null
  const int* fat_vals;     // [S, cap, B] (fat) or null
  const int* boundaries;   // [S] (sharded) or null (one list)
  const int* lo;           // [Q]
  const int* hi;           // [Q]
  int* out_keys;           // [Q, max_out]
  int* out_vals;           // [Q, max_out]
  int* out_count;          // [Q]
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

// lo's level-0 predecessor in shard s (K1 / K2's walk).
template <bool kForesight>
__device__ __forceinline__ int position(const Args& a, int s, int q) {
  int x = kHead, lvl = a.levels - 1;
  long long steps = 0;
  while (lvl >= 0) {
    if (++steps > a.max_steps) __trap();       // a corrupt table
    const int2 rec = record<kForesight>(a, s, lvl, x);
    if (rec.y < q) x = rec.x; else --lvl;
  }
  return x;
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

// Each scan below writes its pairs at out_k / out_v and returns how many.

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
__device__ __forceinline__ int scan_fat(const Args& a, int q_lo, int q_hi,
                                        int* out_k, int* out_v) {
  const bool sharded = a.boundaries != nullptr;
  const int S = sharded ? a.shards : 1, B = a.width;
  int s = sharded ? route(a, q_lo) : 0;
  int node = position<kForesight>(a, s, q_lo);
  int lane = 0, count = 0;
  int2 succ = record<kForesight>(a, s, 0, node);
  const long long bound = 2ll * a.max_out + B + 4 + (sharded ? 2ll * S : 0);
  for (long long it = 0; it < bound; ++it) {
    const size_t row = ((size_t)s * a.cap + node) * B;
    const int l = min(lane, B - 1);
    const int k = __ldg(a.fat_keys + row + l);
    const bool at_end = k == kKeyMax || lane >= B;
    if (!at_end && q_lo <= k && k < q_hi && count < a.max_out) {
      out_k[count] = k;
      out_v[count++] = __ldg(a.fat_vals + row + l);
    }
    const bool stop = !at_end && k >= q_hi;
    const bool last = sharded ? succ.y == kKeyMax && s >= S - 1
                              : succ.x == node;
    if ((at_end && last) || stop || count >= a.max_out) break;
    if (at_end) {                              // hop to the next node
      if (sharded && succ.y == kKeyMax) {
        ++s;
        node = kHead;
      } else {
        node = succ.x;
      }
      lane = 0;
      succ = record<kForesight>(a, s, 0, node);
    } else {
      ++lane;
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

template <bool kForesight>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, 1)
range_scan_kernel(Args a) {
  const long long i =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (i >= a.scans || (threadIdx.x & (kWarp - 1)) != 0) return;
  int* out_k = a.out_keys + (size_t)i * a.max_out;
  int* out_v = a.out_vals + (size_t)i * a.max_out;
  const int q_lo = a.lo[i], q_hi = a.hi[i];
  int count;
  if (a.raw)
    count = scan_raw<kForesight>(a, out_k, out_v);
  else if (a.fat_keys != nullptr)
    count = scan_fat<kForesight>(a, q_lo, q_hi, out_k, out_v);
  else
    count = scan_scalar<kForesight>(a, q_lo, q_hi, out_k, out_v);
  a.out_count[i] = count;
  for (int j = count; j < a.max_out; ++j) {
    out_k[j] = kKeyMax;
    out_v[j] = kNullVal;
  }
}

}  // namespace

extern "C" {

// Runs Q scans; enqueues on `stream` and returns cudaGetLastError().
// `fused` (foresight) or `nxt` (base) is null; `fat_keys` / `fat_vals` are
// null on the scalar layout (`width` 1); `boundaries` is null for one list
// (`shards` 1).  max_out >= 1.
int range_scan_launch(const void* fused, const void* nxt, const void* keys,
                      const void* vals, const void* fat_keys,
                      const void* fat_vals, const void* boundaries,
                      const void* lo, const void* hi, void* out_keys,
                      void* out_vals, void* out_count, long long scans,
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
  a.boundaries = (const int*)boundaries;
  a.lo = (const int*)lo;
  a.hi = (const int*)hi;
  a.out_keys = (int*)out_keys;
  a.out_vals = (int*)out_vals;
  a.out_count = (int*)out_count;
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
