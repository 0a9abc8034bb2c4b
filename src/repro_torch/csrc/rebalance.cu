// In-place shard rebalancing for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: it is the device counterpart of the
// reference's traced rebalancing (repro/core/rebalance_traced.py, the
// lax.while_loop / lax.cond of watermark_rebalance_traced and
// exhaustion_guard_traced over split_shard_traced and merge_shards_traced).
// Its plain version is the port's host loop (core/rebalance_traced.py,
// reading shard counts back each trip); the wrapper is
// kernels/rebalance.py rebalance_pass.
//
// rebalance_launch runs one pass, in place, on a stacked state of S slots
// at its static ceiling (dead slots: sentinels only, a KEY_MAX boundary):
//   kWatermark  split the fullest shard above the high mark while a dead
//               slot is left (seed + k, seed + k + 1 for the halves), then
//               merge the adjacent live pair of least combined count that
//               fits under it and has a side below the low mark (seed + j);
//   kGuard      split ahead of the shards a batch's new inserts would
//               overfill, at the median of live and incoming keys;
//   kSplit      one split at a given (s, at) (split_shard_traced);
//   kMerge      one merge at a given s (merge_shards_traced).
// counts[0] and counts[1] get the splits and merges it made.
//
// Semantics are the plain version's, array for array, rng included:
//   - the watermarks compare in float32 (the reference's int32 > python
//     float): __int2float_rn(n) > hi_mark, hi_mark passed as float32;
//   - ties pick the first extreme (jnp.argmax / argmin);
//   - every loop runs at most S trips (the reference's k < S);
//   - a split keeps keys < at on the left, rebuilt with seed + k, the rest
//     on the right with seed + k + 1; the slots right of s shift one toward
//     the tail and the last drops off; a merge rebuilds s with seed + j,
//     shifts the slots right of s + 1 one toward the head and writes a
//     dead slot (empty with seed 0) last; boundaries follow their slots;
//   - a rebuild is core/skiplist.py build at the static width: the live
//     run packed at build fill (pack_fill(width) elements a node on the
//     fat layout), the rng PRNGKey(seed) split once, node i's tower from
//     bits(sub, (cap - 2,))[i] (threefry.cuh), and on every level each
//     node linked to the next node whose tower reaches it (the reference's
//     reversed cumulative minimum), the head to the first.
//
// Design: one cooperative launch a pass (cudaLaunchCooperativeKernel), the
// grid as large as the card keeps resident, phases separated by
// cooperative_groups grid syncs.  Each trip of the pass's loop:
//   (a) decide: block 0 reads n [S] and the boundaries (the guard: the
//       batch's sorted insert keys through their prefix counts, so a
//       shard's incoming count is two binary searches) and writes the
//       decision (do, s) to a control record in device memory; a false do
//       ends the loop for every block.  A batch that needs no split and no
//       merge costs this one phase and no host read;
//   (b) flatten: the shard (two for a merge) gathered into a scratch run
//       of (key, val) top-down (level_walk.cuh): the frontier starts at the
//       head on level L - 1, and on each level every thread of the grid
//       walks one segment cut at the nodes of the level above, counts it,
//       and after a prefix sum over the grid writes its nodes in order; at
//       level 0 it writes each node's (key, val), a fat node's live lanes
//       (nlen of them) at its run's offset;
//   (c) cut: one thread finds the split key (the watermark: the run's
//       median; the guard: the (m / 2)-th key of the run merged with the
//       shard's incoming keys, by a merge-path search, falling back to the
//       smallest larger key, stopping at KEY_MAX) and moves the boundaries;
//   (d) shift: every thread moves its own offsets of every array across
//       the slots (tail first for a split, head first for a merge), so
//       overlapping slots never race;
//   (e) rebuild the slot or slots: the arrays written as the empty list
//       with the run's keys, vals and towers (one thread an element), then
//       the links: each thread takes a chunk of kChunk positions and
//       records, per level, the first position that reaches it; a warp a
//       (slot, level) turns those into suffix minima over the chunks; then
//       each chunk, walked backwards, links every reaching position to the
//       next one on each level of its tower.
// The state is written inside the launch, so every load is a plain one:
// no __ldg, no const __restrict__ on the state.  Every flatten walk runs
// under max_steps (kernels/foresight_traverse.py traversal_bound) and
// traps past it, as K11's walks do.  Thread 0 stamps the card's clock
// (%globaltimer) at each phase of the first trip into the control record
// (ctrl[cStamps ..], kStamps u64; zeros past a phase the trip did not
// reach), where a measurement reads them.
//
// What bounds it: a pass that changes nothing costs the launch and one
// grid sync.  A split or merge costs the flatten (two walks and two grid
// syncs a level, each walk about two dependent loads a segment), and then
// moves the slots right of the cut at the card's byte rate (every array of
// each slot read and written once) and writes the rebuilt slots.  A walk
// of level 0 by one lane would cost one dependent load a node.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "level_walk.cuh"
#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxLevels = 32;
constexpr int kChunk = 64;        // positions a thread links
constexpr int kMaxBlocksPerSm = 4;
constexpr int kMaxGridBlocks = 1024;  // the grid scan's partial sums
constexpr int kMaxDevices = 64;
constexpr int kKeyMax = 0x7fffffff;
constexpr int kKeyMin = (int)0x80000000;
constexpr int kNullVal = -1;
constexpr int kHead = 0;
constexpr int kTail = 1;
constexpr unsigned kFullMask = 0xffffffffu;

enum Mode { kWatermark = 0, kGuard = 1, kSplit = 2, kMerge = 3 };
enum Kind { kSplitTrip = 0, kMergeTrip = 1 };

// The control record's slots (device memory, written by one thread between
// grid syncs, read by all after them).
enum Ctrl {
  cDo, cKind, cS, cAt, cPhase, cNa, cNb, cLo, cHi, cAdd, cJobs,
  cJob0,                       // kJobFields a job from here
  kJobFields = 5,
  cStamps = cJob0 + 3 * kJobFields,   // kStamps u64 from here
  kStamps = 7,
  kCtrlSize = cStamps + 2 * kStamps
};
// The stamps: the first trip's start, then the end of decide, flatten,
// cut, shift, write and link.
enum JobField { jSlot, jOff, jElems, jSeed, jDead };

struct Args {
  int2* fused;             // [S, L, cap] records (foresight) or null
  int* nxt;                // [S, L, cap] (base) or null
  int* keys;               // [S, cap]
  int* vals;               // [S, cap]
  int* height;             // [S, cap]
  int* n;                  // [S]
  int* free_top;           // [S]
  int* free_list;          // [S, cap]
  int* bump;               // [S]
  unsigned* rng;           // [S, 2]
  int* fat_keys;           // [S, cap, B] (fat) or null
  int* fat_vals;           // [S, cap, B] (fat) or null
  int* nlen;               // [S, cap] (fat) or null
  int* boundaries;         // [S]
  const int* k_sorted;     // [batch] the guard's insert keys, sorted
  const int* pdist;        // [batch + 1] prefix count of the distinct ones
  const int* pnew;         // [batch + 1] prefix count of the new ones
  const int* given;        // [2] (s, at) of kSplit / kMerge, else null
  const int* ref_ctz;      // [33]
  int* run_keys;           // [2 * cap * B] scratch: the flattened runs
  int* run_vals;
  int* chunk_first;        // [2, L, chunks] scratch: per-chunk firsts
  int* front;              // [cap + 1] scratch: the gather's frontier
  long long* sums;         // [kMaxGridBlocks] scratch: the grid scan's
  int* ctrl;               // [kCtrlSize], 8-byte aligned
  int* counts;             // [2] splits, merges
  long long batch;
  long long cap;
  long long usable;        // elements a shard holds at build fill
  long long max_steps;
  long long seed;          // low 32 bits used, as PRNGKey does
  float hi_mark;
  float lo_mark;
  int mode;
  int shards;
  int levels;
  int width;
  int ceil_;
};

__device__ __forceinline__ int fill_of(int width) {
  return width > 1 ? width / 2 : 1;         // core/skiplist.py pack_fill
}

__device__ __forceinline__ long long chunks_of(long long cap) {
  return (cap - 2 + kChunk - 1) / kChunk;
}

// First index in sorted v[lo, hi) whose value is >= x (upper: > x).
__device__ __forceinline__ long long bound(const int* v, long long lo,
                                           long long hi, int x, bool upper) {
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (upper ? v[mid] <= x : v[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// (a) decide (block 0)
// ---------------------------------------------------------------------------

// A shard's incoming keys: k_sorted[lo, hi), the keys route() sends to s.
__device__ __forceinline__ void incoming_range(const Args& a, int s,
                                               long long& lo, long long& hi) {
  const int S = a.shards;
  lo = s == 0 ? 0 : bound(a.k_sorted, 0, a.batch, a.boundaries[s], false);
  hi = s == S - 1 ? a.batch
                  : bound(a.k_sorted, 0, a.batch, a.boundaries[s + 1], false);
  if (hi < lo) hi = lo;
}

// Pack (score, slot) so that a max picks the largest score, first slot.
__device__ __forceinline__ unsigned long long pack_max(int score, int s) {
  return ((unsigned long long)(unsigned)score << 32) | (unsigned)(~s);
}
__device__ __forceinline__ unsigned long long pack_min(int score, int s) {
  return ((unsigned long long)(unsigned)score << 32) | (unsigned)s;
}

__device__ void decide(const Args& a, int trip) {
  __shared__ int s_live, s_need;
  __shared__ unsigned long long s_split, s_merge;
  int* c = a.ctrl;
  const int S = a.shards;
  const int splits = a.counts[0], merges = a.counts[1];
  const int tid = threadIdx.x;
  if (a.mode == kSplit || a.mode == kMerge) {
    if (tid == 0) {
      c[cDo] = trip == 0;
      c[cKind] = a.mode == kSplit ? kSplitTrip : kMergeTrip;
      c[cS] = a.given[0];
      c[cAt] = a.mode == kSplit ? a.given[1] : 0;
    }
    return;
  }
  if (tid == 0) {
    s_live = 0;
    s_need = 0;
    s_split = 0;
    s_merge = ~0ull;
  }
  __syncthreads();
  int live = 0;
  for (int s = tid; s < S; s += blockDim.x) live += a.boundaries[s] < kKeyMax;
  atomicAdd(&s_live, live);
  int phase = c[cPhase];
  if (a.mode == kGuard && phase == 0) {
    // the pre-filter: every distinct insert counted as new
    for (int s = tid; s < S; s += blockDim.x) {
      long long lo, hi;
      incoming_range(a, s, lo, hi);
      if ((long long)a.n[s] + (a.pdist[hi] - a.pdist[lo]) > a.usable)
        s_need = 1;
    }
  }
  __syncthreads();
  live = s_live;
  if (a.mode == kGuard && phase == 0) phase = s_need ? 1 : 2;
  if (a.mode == kGuard && phase == 1 && splits < S && live < a.ceil_) {
    for (int s = tid; s < S; s += blockDim.x) {
      long long lo, hi;
      incoming_range(a, s, lo, hi);
      const long long proj = (long long)a.n[s] + (a.pnew[hi] - a.pnew[lo]);
      if (proj > a.usable)
        atomicMax(&s_split, pack_max((int)min(proj, (long long)kKeyMax), s));
    }
  } else if (a.mode == kWatermark && phase == 0 && splits < S &&
             live < a.ceil_) {
    for (int s = tid; s < S; s += blockDim.x) {
      const int ns = a.n[s];
      if (__int2float_rn(ns) > a.hi_mark && ns >= 2)
        atomicMax(&s_split, pack_max(ns, s));
    }
  }
  __syncthreads();
  const bool do_split = s_split != 0;
  if (a.mode == kWatermark && phase == 0 && !do_split) phase = 1;
  if (a.mode == kWatermark && phase == 1 && merges < S && live > 1) {
    for (int s = tid; s < S - 1; s += blockDim.x) {
      const int n0 = a.n[s], n1 = a.n[s + 1];
      const int comb = n0 + n1;
      if (a.boundaries[s + 1] < kKeyMax &&
          __int2float_rn(comb) <= a.hi_mark &&
          (__int2float_rn(n0) < a.lo_mark || __int2float_rn(n1) < a.lo_mark))
        atomicMin(&s_merge, pack_min(comb, s));
    }
  }
  __syncthreads();
  const bool do_merge = !do_split && s_merge != ~0ull;
  if (tid == 0) {
    c[cPhase] = phase;
    c[cDo] = do_split || do_merge;
    c[cKind] = do_merge ? kMergeTrip : kSplitTrip;
    if (do_split) c[cS] = (int)~(unsigned)(s_split & 0xffffffffu);
    if (do_merge) c[cS] = (int)(s_merge & 0xffffffffu);
    if (do_split && a.mode == kGuard) {
      long long lo, hi;
      incoming_range(a, c[cS], lo, hi);
      c[cLo] = (int)lo;
      c[cHi] = (int)hi;
      c[cAdd] = a.pnew[hi] - a.pnew[lo];
    }
  }
}

// ---------------------------------------------------------------------------
// (b) flatten (the grid)
// ---------------------------------------------------------------------------

// Slot t as level_walk::gather sees it: every node kept above level 0; at
// level 0 every node but the head, counted by its live elements (1, or a
// fat node's nlen) and written at run[off + pos ..] below room.
template <bool kForesight, bool kFat>
struct SlotWalk {
  const Args* a;
  int t;
  long long off, room;
  __device__ size_t base() const { return (size_t)t * a->cap; }
  __device__ int2 rec(int l, int x) const {
    const size_t idx = ((size_t)t * a->levels + l) * a->cap + (size_t)x;
    if (kForesight) return a->fused[idx];
    const int p = a->nxt[idx];
    return make_int2(p, a->keys[base() + p]);
  }
  __device__ int key(int x) const { return a->keys[base() + x]; }
  __device__ int live(int y) const {
    return kFat ? max(0, min(a->nlen[base() + y], a->width)) : 1;
  }
  __device__ long long weight(int l, int y, int) const {
    if (l > 0) return 1;
    return y == kHead ? 0 : live(y);
  }
  __device__ void emit(int y, int key, long long pos) const {
    if (!kFat) {
      if (pos < room) {
        a->run_keys[off + pos] = key;
        a->run_vals[off + pos] = a->vals[base() + y];
      }
      return;
    }
    const size_t row = (base() + y) * a->width;
    const int m = live(y);
    for (int i = 0; i < m && pos + i < room; ++i) {
      a->run_keys[off + pos + i] = a->fat_keys[row + i];
      a->run_vals[off + pos + i] = a->fat_vals[row + i];
    }
  }
};

// Gathers slot t's live (key, val) pairs in order at run[off ..]; returns
// how many (the same value in every thread of the grid).  The gather
// starts below the highest level the head links to a node on (every
// thread reads the head's records alike): an empty slot costs no level.
template <bool kForesight, bool kFat>
__device__ long long flatten(const Args& a, const level_walk::Grid& team,
                             int t, long long off, long long room) {
  const SlotWalk<kForesight, kFat> ops{&a, t, off, room};
  int top = a.levels;
  while (top > 0 && ops.rec(top - 1, kHead).x == kTail) --top;
  if (top == 0) return 0;
  return level_walk::gather(team, ops, a.front, kHead, 1, top, kTail,
                            kKeyMax, a.cap, a.max_steps);
}

// Phase (b): shard s, and s + 1 after it for a merge; the counts to ctrl.
template <bool kForesight, bool kFat>
__device__ void flatten_trip(const Args& a, const level_walk::Grid& team,
                             int s, bool merge) {
  const long long room = 2 * a.cap * a.width;
  const long long na = flatten<kForesight, kFat>(a, team, s, 0, room);
  long long nb = 0;
  if (merge) {
    const long long off = a.n[s];
    nb = flatten<kForesight, kFat>(a, team, s + 1, off, room - off);
  }
  if (team.rank() == 0) {
    a.ctrl[cNa] = (int)na;
    if (merge) a.ctrl[cNb] = (int)nb;
  }
}

// ---------------------------------------------------------------------------
// (c) cut (one thread)
// ---------------------------------------------------------------------------

// The j-th new key of the shard's incoming range k_sorted[lo, hi).
__device__ int incoming_at(const Args& a, long long lo, long long hi,
                           long long j) {
  const int base = a.pnew[lo];
  long long l = lo, h = hi;                  // first i: pnew[i + 1] > base + j
  while (l < h) {
    const long long mid = (l + h) / 2;
    if (a.pnew[mid + 1] <= base + j) l = mid + 1; else h = mid;
  }
  return a.k_sorted[l];
}

// The r-th smallest (from 0) of the run A [na] and the incoming keys C
// [nc], both sorted; KEY_MAX past their total (the reference's padding).
__device__ int select_rth(const Args& a, long long na, long long lo,
                          long long hi, long long nc, long long r) {
  if (r >= na + nc) return kKeyMax;
  const int* A = a.run_keys;
  const long long t = r + 1;                 // the first t of the merge
  long long l = max(0ll, t - nc), h = min(t, na);
  while (l < h) {                            // i: how many of them from A
    const long long mid = (l + h) / 2;
    if (A[mid] < incoming_at(a, lo, hi, t - mid - 1)) l = mid + 1;
    else h = mid;
  }
  const int fa = l > 0 ? A[l - 1] : kKeyMin;
  const int fc = t - l > 0 ? incoming_at(a, lo, hi, t - l - 1) : kKeyMin;
  return max(fa, fc);
}

__device__ void set_job(int* c, int j, int slot, long long off,
                        long long elems, long long seed, int dead) {
  int* job = c + cJob0 + j * kJobFields;
  job[jSlot] = slot;
  job[jOff] = (int)off;
  job[jElems] = (int)elems;
  job[jSeed] = (int)(unsigned)seed;
  job[jDead] = dead;
}

__device__ void cut(const Args& a) {
  int* c = a.ctrl;
  const int S = a.shards, s = c[cS];
  const long long W = a.usable;
  int nj = 0;
  if (c[cKind] == kSplitTrip) {
    const long long na = c[cNa];
    const int* A = a.run_keys;
    const long long ns = a.n[s];
    int at;
    if (a.mode == kWatermark) {
      at = ns / 2 < na ? A[ns / 2] : kKeyMax;        // the median
    } else if (a.mode == kGuard) {
      const long long lo = c[cLo], hi = c[cHi], nc = c[cAdd];
      const long long m = ns + nc;
      at = select_rth(a, na, lo, hi, nc, m / 2);
      const int first = select_rth(a, na, lo, hi, nc, 0);
      if (at == first) {                     // the median will not cut
        const long long ua = bound(A, 0, na, first, true);
        const int alt_a = ua < na ? A[ua] : kKeyMax;
        const long long uc = bound(a.k_sorted, lo, hi, first, true);
        const long long jc = a.pnew[uc] - a.pnew[lo];
        const int alt_c = jc < nc ? incoming_at(a, lo, hi, jc) : kKeyMax;
        at = min(alt_a, alt_c);
      }
      if (at >= kKeyMax) {                   // indivisible key mass
        c[cDo] = 0;
        return;
      }
    } else {
      at = c[cAt];
    }
    const long long n_left = bound(A, 0, na, at, false);
    const long long k = a.counts[0];
    set_job(c, nj++, s, 0, min(n_left, W), a.seed + k, 0);
    if (s + 1 < S)
      set_job(c, nj++, s + 1, n_left, max(0ll, min(ns - n_left, W)),
              a.seed + k + 1, 0);
    for (int t = S - 1; t >= s + 2; --t) a.boundaries[t] = a.boundaries[t - 1];
    if (s + 1 < S) a.boundaries[s + 1] = at;
    a.counts[0] = (int)k + 1;
  } else {
    const long long na = a.n[s], nb = a.n[s + 1];
    set_job(c, nj++, s, 0, min(na + nb, W), a.seed + a.counts[1], 0);
    set_job(c, nj++, S - 1, 0, 0, 0, 1);
    for (int t = s + 1; t <= S - 2; ++t) a.boundaries[t] = a.boundaries[t + 1];
    a.boundaries[S - 1] = kKeyMax;
    a.counts[1] += 1;
  }
  c[cJobs] = nj;
}

// ---------------------------------------------------------------------------
// (d) shift (every thread)
// ---------------------------------------------------------------------------

// Moves per-slot array `base` (`len` elements a slot) one slot: for a
// split slots s + 1 .. S - 2 to s + 2 .. S - 1, tail first; for a merge
// s + 2 .. S - 1 to s + 1 .. S - 2, head first.  A thread owns offsets, so
// the moves of different threads never overlap.
template <typename T>
__device__ void shift(T* base, long long len, int S, int s, bool split,
                      long long gtid, long long gsize) {
  if (base == nullptr) return;
  for (long long e = gtid; e < len; e += gsize) {
    if (split) {
      for (int t = S - 1; t >= s + 2; --t)
        base[(size_t)t * len + e] = base[(size_t)(t - 1) * len + e];
    } else {
      for (int t = s + 1; t <= S - 2; ++t)
        base[(size_t)t * len + e] = base[(size_t)(t + 1) * len + e];
    }
  }
}

// ---------------------------------------------------------------------------
// (e) rebuild
// ---------------------------------------------------------------------------

struct Job {
  int slot, off, elems, dead;
  unsigned seed;
  long long nodes;
};

__device__ __forceinline__ Job job_of(const Args& a, int j) {
  const volatile int* f = a.ctrl + cJob0 + j * kJobFields;
  Job b;
  b.slot = f[jSlot];
  b.off = f[jOff];
  b.elems = f[jElems];
  b.seed = (unsigned)f[jSeed];
  b.dead = f[jDead];
  const int fill = fill_of(a.width);
  b.nodes = b.dead ? 0 : ((long long)b.elems + fill - 1) / fill;
  return b;
}

// The tower of node i of a build with `seed`: bits(sub, .)[i].
__device__ __forceinline__ int tower(const Args& a, unsigned seed,
                                     long long i) {
  const uint2 sub = threefry2x32(0u, seed, 0u, 1u);
  return tower_height(threefry2x32(sub.x, sub.y, 0u, (unsigned)i), a.levels,
                      a.ref_ctz);
}

// The empty list with the run's keys, vals, towers and fat runs, written
// over slot job.slot, and its scalars.
template <bool kForesight, bool kFat>
__device__ void write_slot(const Args& a, const Job& b, long long gtid,
                           long long gsize) {
  const long long cap = a.cap;
  const int L = a.levels, fill = fill_of(a.width);
  const size_t base = (size_t)b.slot * cap;
  for (long long x = gtid; x < cap; x += gsize) {
    const long long i = x - 2;
    const bool node = x >= 2 && i < b.nodes;
    int key = x == kHead ? kKeyMin : kKeyMax, val = kNullVal, h = 0;
    if (x < 2) h = L;
    if (node) {
      key = a.run_keys[b.off + i * fill];
      if (!kFat) val = a.run_vals[b.off + i];
      h = tower(a, b.seed, i);
    }
    a.keys[base + x] = key;
    a.vals[base + x] = val;
    a.height[base + x] = h;
    a.free_list[base + x] = 0;
    if (kFat)
      a.nlen[base + x] = x < 2 ? 0 : (int)max(0ll, min((long long)fill,
                                                      b.elems - i * fill));
  }
  if (kFat) {
    const long long W = cap * a.width;
    for (long long e = gtid; e < W; e += gsize) {
      const long long x = e / a.width, lane = e % a.width;
      const long long el = (x - 2) * fill + lane;
      const bool live = x >= 2 && lane < fill && el < b.elems;
      a.fat_keys[base * a.width + e] = live ? a.run_keys[b.off + el] : kKeyMax;
      a.fat_vals[base * a.width + e] = live ? a.run_vals[b.off + el]
                                            : kNullVal;
    }
  }
  const long long T = (long long)L * cap;
  const size_t tb = (size_t)b.slot * T;
  for (long long e = gtid; e < T; e += gsize) {
    const long long x = e % cap;
    if (kForesight)
      a.fused[tb + e] = x < 2 ? make_int2(kTail, kKeyMax) : make_int2(0, 0);
    else
      a.nxt[tb + e] = x < 2 ? kTail : 0;
  }
  if (gtid == 0) {
    a.n[b.slot] = b.dead ? 0 : b.elems;
    a.free_top[b.slot] = 0;
    a.bump[b.slot] = (int)b.nodes + 2;
    uint2 r = make_uint2(0u, 0u);              // PRNGKey(0): a dead slot
    if (!b.dead) r = threefry2x32(0u, b.seed, 0u, 0u);   // split's key 0
    a.rng[2 * b.slot] = r.x;
    a.rng[2 * b.slot + 1] = r.y;
  }
}

// chunk_first[j, l, c]: the first position of chunk c whose tower reaches
// level l (cap - 2: none).
__device__ void chunk_firsts(const Args& a, int j, const Job& b,
                             long long gtid, long long gsize) {
  const long long N = a.cap - 2, chunks = chunks_of(a.cap);
  const int L = a.levels;
  int* out = a.chunk_first + (size_t)j * L * chunks;
  for (long long ch = gtid; ch < chunks; ch += gsize) {
    int f[kMaxLevels];
    for (int l = 0; l < L; ++l) f[l] = (int)N;
    const long long lo = ch * kChunk, hi = min(N, lo + kChunk);
    for (long long i = min(hi, b.nodes) - 1; i >= lo; --i) {
      const int h = a.height[(size_t)b.slot * a.cap + 2 + i];
      for (int l = 0; l < h; ++l) f[l] = (int)i;
    }
    for (int l = 0; l < L; ++l) out[(size_t)l * chunks + ch] = f[l];
  }
}

// Suffix minima of chunk_first[j, l, :] in place, one warp a (job, level).
__device__ void suffix_min(const Args& a, int jobs, long long gwarp,
                           long long nwarps) {
  const long long chunks = chunks_of(a.cap);
  const int lane = threadIdx.x & (kWarp - 1), L = a.levels;
  for (long long w = gwarp; w < (long long)jobs * L; w += nwarps) {
    int* col = a.chunk_first + (size_t)w * chunks;
    int carry = (int)(a.cap - 2);
    for (long long top = chunks; top > 0; top -= kWarp) {
      const long long c = top - 1 - lane;     // lane 0 the highest chunk
      int v = c >= 0 ? col[c] : carry;
      for (int d = 1; d < kWarp; d <<= 1) {
        const int o = __shfl_up_sync(kFullMask, v, d);
        if (lane >= d) v = min(v, o);
      }
      v = min(v, carry);
      if (c >= 0) col[c] = v;
      carry = __shfl_sync(kFullMask, v, kWarp - 1);
    }
  }
}

// (successor id, its key) of position p in slot t (cap - 2: the tail).
__device__ __forceinline__ int2 target(const Args& a, int t, long long p) {
  if (p >= a.cap - 2) return make_int2(kTail, kKeyMax);
  return make_int2((int)p + 2, a.keys[(size_t)t * a.cap + p + 2]);
}

template <bool kForesight>
__device__ __forceinline__ void link(const Args& a, int t, int l, long long x,
                                     int2 to) {
  const size_t idx = ((size_t)t * a.levels + l) * a.cap + (size_t)x;
  if (kForesight) a.fused[idx] = to; else a.nxt[idx] = to.x;
}

template <bool kForesight>
__device__ void link_chunks(const Args& a, int j, const Job& b,
                            long long gtid, long long gsize) {
  const long long N = a.cap - 2, chunks = chunks_of(a.cap);
  const int L = a.levels;
  const int* first = a.chunk_first + (size_t)j * L * chunks;
  for (long long ch = gtid; ch < chunks; ch += gsize) {
    int nx[kMaxLevels];
    for (int l = 0; l < L; ++l)
      nx[l] = ch + 1 < chunks ? first[(size_t)l * chunks + ch + 1] : (int)N;
    const long long lo = ch * kChunk, hi = min(N, lo + kChunk);
    for (long long i = min(hi, b.nodes) - 1; i >= lo; --i) {
      const int h = a.height[(size_t)b.slot * a.cap + 2 + i];
      for (int l = 0; l < h; ++l) {
        link<kForesight>(a, b.slot, l, i + 2, target(a, b.slot, nx[l]));
        nx[l] = (int)i;
      }
    }
    if (ch == 0)
      for (int l = 0; l < L; ++l)
        link<kForesight>(a, b.slot, l, kHead,
                         target(a, b.slot, first[(size_t)l * chunks]));
  }
}

__device__ __forceinline__ unsigned long long clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// __launch_bounds__(kThreads, 2): with the block size alone ptxas cut the
// kernel to 64 registers (four blocks a SM) and spilled the gather's.
template <bool kForesight, bool kFat>
__global__ void __launch_bounds__(kThreads, 2)
rebalance_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long gsize = (long long)gridDim.x * blockDim.x;
  const long long gwarp = gtid / kWarp, nwarps = gsize / kWarp;
  volatile int* c = a.ctrl;
  unsigned long long* stamp =
      reinterpret_cast<unsigned long long*>(a.ctrl + cStamps);
  if (gtid == 0) {
    for (int i = 0; i < kCtrlSize; ++i) a.ctrl[i] = 0;
    a.counts[0] = 0;
    a.counts[1] = 0;
  }
  grid.sync();
  for (int trip = 0;; ++trip) {
    const bool stamps = gtid == 0 && trip == 0;
    if (stamps) stamp[0] = clock_ns();
    if (blockIdx.x == 0) decide(a, trip);
    grid.sync();
    if (!c[cDo]) break;
    if (stamps) stamp[1] = clock_ns();
    {
      const int s = c[cS];
      const bool merge = c[cKind] == kMergeTrip;
      flatten_trip<kForesight, kFat>(a, level_walk::Grid{grid, a.sums}, s,
                                     merge);
    }
    grid.sync();
    if (stamps) stamp[2] = clock_ns();
    if (gtid == 0) cut(a);
    grid.sync();
    if (!c[cDo]) break;
    if (stamps) stamp[3] = clock_ns();
    {
      const int S = a.shards, s = c[cS];
      const bool split = c[cKind] == kSplitTrip;
      const long long cap = a.cap, LC = (long long)a.levels * cap;
      shift(a.fused, LC, S, s, split, gtid, gsize);
      shift(a.nxt, LC, S, s, split, gtid, gsize);
      shift(a.keys, cap, S, s, split, gtid, gsize);
      shift(a.vals, cap, S, s, split, gtid, gsize);
      shift(a.height, cap, S, s, split, gtid, gsize);
      shift(a.free_list, cap, S, s, split, gtid, gsize);
      shift(a.nlen, cap, S, s, split, gtid, gsize);
      shift(a.fat_keys, cap * a.width, S, s, split, gtid, gsize);
      shift(a.fat_vals, cap * a.width, S, s, split, gtid, gsize);
      shift(a.n, 1, S, s, split, gtid, gsize);
      shift(a.free_top, 1, S, s, split, gtid, gsize);
      shift(a.bump, 1, S, s, split, gtid, gsize);
      shift(a.rng, 2, S, s, split, gtid, gsize);
    }
    grid.sync();
    if (stamps) stamp[4] = clock_ns();
    const int jobs = c[cJobs];
    for (int j = 0; j < jobs; ++j)
      write_slot<kForesight, kFat>(a, job_of(a, j), gtid, gsize);
    grid.sync();
    if (stamps) stamp[5] = clock_ns();
    for (int j = 0; j < jobs; ++j)
      chunk_firsts(a, j, job_of(a, j), gtid, gsize);
    grid.sync();
    suffix_min(a, jobs, gwarp, nwarps);
    grid.sync();
    for (int j = 0; j < jobs; ++j)
      link_chunks<kForesight>(a, j, job_of(a, j), gtid, gsize);
    grid.sync();
    if (stamps) stamp[6] = clock_ns();
  }
}

// The grid: as many blocks as the card keeps resident (at most
// kMaxBlocksPerSm a SM, kMaxGridBlocks in all), asked of the runtime once a
// device and variant.
template <bool kForesight, bool kFat>
int launch(Args& a, cudaStream_t stream) {
  static int grid_of[kMaxDevices];          // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int blocks = grid_of[dev];
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rebalance_kernel<kForesight, kFat>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    blocks = min(sms * min(per_sm, kMaxBlocksPerSm), kMaxGridBlocks);
    grid_of[dev] = blocks;
  }
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)rebalance_kernel<kForesight, kFat>, dim3(blocks),
      dim3(kThreads), params, 0, stream);
}

}  // namespace

extern "C" {

// Runs one rebalancing pass (mode: 0 watermark, 1 guard, 2 split at
// given[0..1], 3 merge at given[0]) in place on the stacked state; writes
// (splits, merges) to counts; enqueues on `stream` and returns the launch's
// error code.  `fused` (foresight) or `nxt` (base) is null; the three fat
// arrays are null on the scalar layout (`width` 1).  The guard's k_sorted,
// pdist and pnew and the given pair may be null where the mode does not
// read them.  run_keys / run_vals hold 2 * cap * width ints, chunk_first
// 2 * levels * ceil((cap - 2) / 64), front cap + 1, sums 1024 long longs,
// ctrl 40 ints (8-byte aligned: the phase stamps are u64).
int rebalance_launch(void* fused, void* nxt, void* keys, void* vals,
                     void* height, void* n, void* free_top, void* free_list,
                     void* bump, void* rng, void* fat_keys, void* fat_vals,
                     void* nlen, void* boundaries, const void* k_sorted,
                     const void* pdist, const void* pnew, const void* given,
                     const void* ref_ctz, void* run_keys, void* run_vals,
                     void* chunk_first, void* front, void* sums, void* ctrl,
                     void* counts,
                     int mode, int shards, int levels, long long cap,
                     int width, long long batch, long long usable,
                     int ceil_, float hi_mark, float lo_mark,
                     long long seed, long long max_steps, void* stream) {
  Args a;
  a.fused = (int2*)fused;
  a.nxt = (int*)nxt;
  a.keys = (int*)keys;
  a.vals = (int*)vals;
  a.height = (int*)height;
  a.n = (int*)n;
  a.free_top = (int*)free_top;
  a.free_list = (int*)free_list;
  a.bump = (int*)bump;
  a.rng = (unsigned*)rng;
  a.fat_keys = (int*)fat_keys;
  a.fat_vals = (int*)fat_vals;
  a.nlen = (int*)nlen;
  a.boundaries = (int*)boundaries;
  a.k_sorted = (const int*)k_sorted;
  a.pdist = (const int*)pdist;
  a.pnew = (const int*)pnew;
  a.given = (const int*)given;
  a.ref_ctz = (const int*)ref_ctz;
  a.run_keys = (int*)run_keys;
  a.run_vals = (int*)run_vals;
  a.chunk_first = (int*)chunk_first;
  a.front = (int*)front;
  a.sums = (long long*)sums;
  a.ctrl = (int*)ctrl;
  a.counts = (int*)counts;
  a.mode = mode;
  a.shards = shards;
  a.levels = levels;
  a.cap = cap;
  a.width = width;
  a.batch = batch;
  a.usable = usable;
  a.ceil_ = ceil_;
  a.hi_mark = hi_mark;
  a.lo_mark = lo_mark;
  a.seed = seed;
  a.max_steps = max_steps;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool fat = fat_keys != nullptr;
  if (fused != nullptr)
    return fat ? launch<true, true>(a, st) : launch<true, false>(a, st);
  return fat ? launch<false, true>(a, st) : launch<false, false>(a, st);
}

}  // extern "C"
