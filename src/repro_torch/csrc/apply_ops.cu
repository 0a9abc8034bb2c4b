// Batched update application for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: it is the device counterpart of the
// reference's jitted apply (repro/core/skiplist.py apply_ops, a lax.scan
// over lax.switch of search / insert / delete, and the same scan inside
// repro/core/sharded.py apply_ops_sharded's segment passes).  Its plain
// version is the port's host loop (core/skiplist.py apply_ops_inplace, one
// op at a time through the eager search); the wrapper is
// kernels/apply_ops.py apply_ops_batch.
//
// apply_ops_launch applies a route-sorted batch, in place, to a stacked
// state of S shards (a monolithic list is a stack of one): shard s runs the
// ops [starts[s], starts[s] + lens[s]) of the batch in order, and op o's
// result (found / inserted new / deleted, 0 or 1) is written at o.  Shards
// hold disjoint key ranges, so only the order within a shard can be
// observed (core/sharded.py); shards run side by side.
//
// Semantics are those of the plain version, array for array:
//   - an op type below 0 runs as a read and one above 2 as a delete;
//   - a read touches neither the state nor the rng;
//   - every insert splits the threefry rng (core/prng.py's partitionable
//     scheme: the new key hashes index 0, the subkey index 1) and draws its
//     tower height from the subkey's bits (the hash of index 0, XORed) as
//     sample_heights does: 1 + the trailing one-bits, mapped through the
//     reference's float32-log2 ctz table (ref_ctz, core/skiplist.py
//     _REF_CTZ, passed in), capped at L (threefry.cuh);
//   - allocation pops the free list, else bumps; with neither (free list
//     empty, bump == cap) the insert writes nothing but the rng.  A pop
//     with free_top past cap reads free_list[cap - 1], as the reference's
//     clamped gather does;
//   - a delete pushes its node onto the free list where free_top < cap,
//     and free_top rises in any case (the reference drops the scatter);
//   - the fat layout (width B > 1): insert's upsert / first node / room /
//     median split (a second walk finds the median's predecessors), delete's
//     plain / minimum lane / emptied node, and the foreseen-key fix of every
//     predecessor record that points at a node whose minimum changed.
//     Each case adds one to its slot of `cases` (core/skiplist.py
//     FAT_CASES' names, in FatCase order).
//
// Design: one block a shard, in windows of kWindow ops.  (1) The walk
// phase: thread j of the kWindow walking threads (kWindow / 32 warps)
// walks op j of the window, read-only, on the state as it stands at the
// window's start, and records its predecessor at every level in shared
// memory (kWindow walks, so kWindow misses in flight where a walk at a time
// had one); it then asks L2 for the lines the apply phase will read that no
// walk did: each predecessor's height and key, the found node's height and
// lowest records (a delete's), a fat owner's run and length.  Meanwhile
// the block's last warp computes the window's tower heights (below).  (2)
// The apply phase: warp 0 runs the window's ops in order.  Before op j it
// checks j's recorded predecessors against the state as it stands now, one
// lane a level: p stands at level l for key q if p is the head, or is
// linked at l (height[p] > l) with keys[p] < q, and p's record at l
// foresees a key >= q (base: its pointee's key >= q).  On a list whose
// levels are sorted, that p is the rightmost node below q on level l: the
// one a fresh walk finds.  Below the highest level that fails, lane 0
// resumes the walk from the checked predecessor of the level above (the
// head at the top) down to level 0; the rest runs on the predecessors
// checked or found, as a walk at a time ran it: a splice or unsplice one
// lane a level (L <= 32), a fat run's count of lanes below the key by
// ballot and popcount (32 lanes a step), its shift through a copy in
// shared memory, and the foreseen-key fix one lane a level.  A fat
// split's second walk (the median's predecessors) walks from the head.
// __syncwarp() orders each step's writes before the next step's reads,
// __syncthreads() the apply phase's before the next walk phase's.  The
// state is written by this block only, so every load is a plain coherent
// one: no __ldg, no const __restrict__ on the state.  K9's fat_resolve
// (traverse.cu) does not fit here: it reads through the read-only path,
// which may return stale lines of a row this kernel has just written, and
// it resolves many lanes' rows at once where an update resolves one.
//
// The rng: every insert splits the key, a serial chain that depends only
// on how many inserts came before.  The last warp runs the window's chain
// (lane 0, one threefry an insert) and then draws each insert's height
// (a lane an insert) while the walks run, so the apply phase only reads
// the heights; the block's key after the batch is the same.
//
// Base reads the pointer, then the pointee's key: two dependent loads a
// step, as K2 does.  Foresight reads the (ptr, key) record as one 8-byte
// load and writes a predecessor's record as one 8-byte store: the paper's
// pair written at once.
//
// What bounds it: dependent loads.  A window costs about one walk's chain
// of misses (the walks overlap) plus, for each op in turn, the check's
// loads (L2 hits: the walk's own records and the lines asked for) and the
// splice; shards run side by side.  Neither the byte rate nor the
// arithmetic is the limit.  kWindow = 256 was measured the fastest of 32,
// 64, 128 and 256 (chip_probe_apply.py).  The checks are counted on the
// device: the ops whose predecessors all stood, the ops that resumed a
// walk, and the resumed walks' steps (cases[7..9]).
//
// Every walk runs under max_steps (kernels/foresight_traverse.py
// traversal_bound): past it the table is corrupt and the kernel traps,
// where the reference would loop for ever.  A shard's offset into the
// stack is 64-bit: 64 shards x 21 levels x 2^21 slots of records is past
// 2^31.

#include <cuda_runtime.h>
#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kWarp = 32;          // lanes a warp; warp 0 applies the ops
constexpr int kWindow = 256;       // ops walked at once: threads that walk
constexpr int kThreads = kWindow + kWarp;   // + the rng warp
constexpr int kMaxLevels = 32;     // one lane a level
constexpr int kPredStride = kMaxLevels + 1;  // an op's row, bank-skewed
constexpr int kKeyMax = 0x7fffffff;
constexpr int kNullVal = -1;
constexpr int kHead = 0;
constexpr int kTail = 1;
constexpr unsigned kFullMask = 0xffffffffu;
enum OpType { kRead = 0, kInsert = 1, kDelete = 2 };
enum FatCase { kUpsert, kFirst, kRoom, kSplit, kEmptied, kMinLane, kPlain };
// cases[] after the fat cases: the checks of the window's predecessors
enum CheckCount { kStood = 7, kResumed = 8, kResumedSteps = 9 };

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
  const int* op_types;     // [batch], route-sorted
  const int* op_keys;
  const int* op_vals;
  const int* starts;       // [S]
  const int* lens;         // [S]
  const int* ref_ctz;      // [33]
  int* results;            // [batch], route-sorted
  unsigned long long* cases;   // [10] fat case counts, then CheckCount
  int levels;
  long long cap;
  int width;
  long long max_steps;
};

// One shard's arrays: the stack's base pointers at the shard's offsets.
struct Shard {
  int2* fused;
  int* nxt;
  int* keys;
  int* vals;
  int* height;
  int* free_list;
  int* fat_keys;
  int* fat_vals;
  int* nlen;
  long long cap;
  int levels;
  int width;
};

__device__ __forceinline__ int clamp_type(int t) {
  return min(max(t, (int)kRead), (int)kDelete);
}

// A hint: bring p's line into L2, without waiting for it.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(__cvta_generic_to_global(p)));
}

// Node x's record at level l as a walk reads it: (successor, its key).
template <bool kForesight>
__device__ __forceinline__ int2 record(const Shard& sh, int l, int x) {
  const size_t idx = (size_t)l * (size_t)sh.cap + (size_t)x;
  if (kForesight) return sh.fused[idx];      // one 8-byte load
  const int ptr = sh.nxt[idx];
  return make_int2(ptr, sh.keys[ptr]);       // dependent on ptr
}

// The search for q from node x at level lvl down to level 0: each level's
// predecessor into preds, the level-0 one into x.  False past max_steps.
template <bool kForesight>
__device__ __forceinline__
bool descend(const Shard& sh, int q, int* preds, int lvl, int& x,
             long long max_steps, long long& steps) {
  while (lvl >= 0) {
    if (++steps > max_steps) return false;   // a corrupt table
    const int2 rec = record<kForesight>(sh, lvl, x);
    if (rec.y < q) {
      x = rec.x;
    } else {
      preds[lvl] = x;
      --lvl;
    }
  }
  return true;
}

// Whether p stands as q's predecessor at level l (see the top); rec gets
// p's level-l record.  The loads are issued together.
template <bool kForesight>
__device__ __forceinline__ bool stands(const Shard& sh, int p, int l, int q,
                                       int2& rec) {
  rec = record<kForesight>(sh, l, p);
  const int hp = sh.height[p], kp = sh.keys[p];
  return (p == kHead || (hp > l && kp < q)) && rec.y >= q;
}

// The warp's walk from the head (lane 0): (x, level-0 record), preds in
// shared memory.
template <bool kForesight>
__device__ __forceinline__ int2 locate(const Shard& sh, int q, int* preds,
                       long long max_steps, int lane, int& x) {
  int2 c = make_int2(0, 0);
  x = kHead;
  if (lane == 0) {
    long long steps = 0;
    if (!descend<kForesight>(sh, q, preds, sh.levels - 1, x, max_steps,
                             steps))
      __trap();
    c = record<kForesight>(sh, 0, x);
  }
  __syncwarp();
  x = __shfl_sync(kFullMask, x, 0);
  c.x = __shfl_sync(kFullMask, c.x, 0);
  c.y = __shfl_sync(kFullMask, c.y, 0);
  return c;
}

// Pop the free list, else bump; warp-uniform.  False: no slot, no change.
__device__ __forceinline__
bool alloc(const Shard& sh, int& free_top, int& bump, int& nid) {
  if (free_top > 0) {
    const long long i = min((long long)free_top - 1, sh.cap - 1);
    nid = sh.free_list[i];
    --free_top;
    return true;
  }
  nid = bump;
  if (bump < sh.cap) {
    ++bump;
    return true;
  }
  return false;
}

// Link node nid (key nkey, height h) after preds on levels 0 .. h-1: it
// inherits each predecessor's record, and the predecessor gets (nid, nkey).
template <bool kForesight>
__device__ __forceinline__
void splice(const Shard& sh, int nid, int nkey, int h, const int* preds,
            int lane) {
  for (int l = lane; l < min(h, sh.levels); l += kWarp) {
    const size_t row = (size_t)l * (size_t)sh.cap;
    const int p = preds[l];
    if (kForesight) {
      const int2 old = sh.fused[row + p];
      sh.fused[row + nid] = old;
      sh.fused[row + p] = make_int2(nid, nkey);   // the pair, one store
    } else {
      const int old = sh.nxt[row + p];
      sh.nxt[row + nid] = old;
      sh.nxt[row + p] = nid;
    }
  }
  if (lane == 0) {
    sh.keys[nid] = nkey;
    sh.height[nid] = h;
  }
  __syncwarp();
}

// Unlink node d from preds (each takes d's record at its level) and push
// it on the free list.
template <bool kForesight>
__device__ __forceinline__
void unsplice(const Shard& sh, int d, const int* preds, int& free_top,
              int lane) {
  const int h = min(sh.height[d], sh.levels);
  __syncwarp();                              // every lane has read h
  for (int l = lane; l < h; l += kWarp) {
    const size_t row = (size_t)l * (size_t)sh.cap;
    if (kForesight) {
      sh.fused[row + preds[l]] = sh.fused[row + d];
    } else {
      sh.nxt[row + preds[l]] = sh.nxt[row + d];
    }
  }
  if (lane == 0) {
    if (free_top < sh.cap) sh.free_list[free_top] = d;
    sh.keys[d] = kKeyMax;
    sh.height[d] = 0;
  }
  ++free_top;
  __syncwarp();
}

// Node owner's routing key becomes new_min, and so does the foreseen key of
// every predecessor record that points at it.
template <bool kForesight>
__device__ __forceinline__
void set_node_min(const Shard& sh, int owner, int new_min, const int* preds,
                  int lane) {
  if (lane == 0) sh.keys[owner] = new_min;
  if (kForesight) {
    for (int l = lane; l < sh.levels; l += kWarp) {
      const size_t idx = (size_t)l * (size_t)sh.cap + (size_t)preds[l];
      const int2 rec = sh.fused[idx];
      if (rec.x == owner) sh.fused[idx] = make_int2(rec.x, new_min);
    }
  }
  __syncwarp();
}

// A run's lanes below q, over all B lanes: 32 lanes a ballot.
__device__ __forceinline__
int count_below(const int* row, int width, int q, int lane) {
  int pos = 0;
  for (int base = 0; base < width; base += kWarp) {
    const int e = base + lane;
    pos += __popc(__ballot_sync(kFullMask, e < width && row[e] < q));
  }
  return pos;
}

// Copy a run (keys and vals) into shared memory.
__device__ __forceinline__
void stage_row(const int* rk, const int* rv, int* sk, int* sv, int width,
               int lane) {
  for (int e = lane; e < width; e += kWarp) {
    sk[e] = rk[e];
    sv[e] = rv[e];
  }
  __syncwarp();
}

// Lane j of the run src[off .. off + len), pad past it.
__device__ __forceinline__ int run_lane(const int* src, int off, int len,
                                        int pad, int j) {
  return j < len ? src[off + j] : pad;
}

// Lane e of that run after kv is shifted in at lane p.
__device__ __forceinline__ int shifted_in(const int* src, int off, int len,
                                          int pad, int e, int p, int kv) {
  return e > p ? run_lane(src, off, len, pad, e - 1)
               : (e == p ? kv : run_lane(src, off, len, pad, e));
}

// Op t (key q, val v; an insert's tower height h) on the checked or
// found predecessors preds, level-0 predecessor x and its record c; warp
// 0 runs it, n / free_top / bump warp-uniform.  Returns its result.
template <bool kForesight, bool kFat>
__device__ __forceinline__
int apply_op(const Args& a, const Shard& sh, int t, int q, int v, int h, int x,
             int2 c, int* preds, int* preds2, int* sk, int* sv, int& n,
             int& free_top, int& bump, int lane) {
  const int B = sh.width;
  int result = 0;
  if (!kFat) {
    const bool found = c.y == q;
    if (t == kRead) {
      result = found;
    } else if (t == kInsert) {
      int nid;
      if (found) {
        if (lane == 0) sh.vals[c.x] = v;      // upsert
      } else if (alloc(sh, free_top, bump, nid)) {
        splice<kForesight>(sh, nid, q, h, preds, lane);
        if (lane == 0) sh.vals[nid] = v;
        ++n;
        result = 1;
      }
    } else if (found) {
      unsplice<kForesight>(sh, c.x, preds, free_top, lane);
      --n;
      result = 1;
    }
  } else {
    const int owner = (c.y == q || x == kHead) ? c.x : x;
    int* rk = sh.fat_keys + (size_t)owner * (size_t)B;
    int* rv = sh.fat_vals + (size_t)owner * (size_t)B;
    const int pos = count_below(rk, B, q, lane);
    const int pos_c = min(pos, B - 1);
    const bool present = pos < B && rk[pos_c] == q;
    if (t == kRead) {
      result = present;
    } else if (t == kInsert) {
      const bool at_front = x == kHead && !present;
      const int half = B / 2;
      int nid;
      if (present) {
        if (lane == 0) {
          atomicAdd(a.cases + kUpsert, 1ull);
          rv[pos_c] = v;
        }
      } else if (owner == kTail) {
        if (lane == 0) atomicAdd(a.cases + kFirst, 1ull);
        if (alloc(sh, free_top, bump, nid)) {
          splice<kForesight>(sh, nid, q, h, preds, lane);
          int* nk = sh.fat_keys + (size_t)nid * (size_t)B;
          int* nv = sh.fat_vals + (size_t)nid * (size_t)B;
          for (int e = lane; e < B; e += kWarp) {
            nk[e] = e == 0 ? q : kKeyMax;
            nv[e] = e == 0 ? v : kNullVal;
          }
          if (lane == 0) sh.nlen[nid] = 1;
          ++n;
          result = 1;
        }
      } else if (sh.nlen[owner] < B) {
        if (lane == 0) atomicAdd(a.cases + kRoom, 1ull);
        stage_row(rk, rv, sk, sv, B, lane);
        const int len_owner = sh.nlen[owner];
        for (int e = lane; e < B; e += kWarp) {
          rk[e] = shifted_in(sk, 0, B, kKeyMax, e, pos, q);
          rv[e] = shifted_in(sv, 0, B, kNullVal, e, pos, v);
        }
        __syncwarp();
        if (lane == 0) sh.nlen[owner] = len_owner + 1;
        ++n;
        __syncwarp();
        if (at_front) set_node_min<kForesight>(sh, owner, q, preds, lane);
        result = 1;
      } else {
        if (lane == 0) atomicAdd(a.cases + kSplit, 1ull);
        if (alloc(sh, free_top, bump, nid)) {
          stage_row(rk, rv, sk, sv, B, lane);
          const int new_min = sk[half];
          // The median's predecessors: its level-0 one is the owner, so
          // the new node lands after it and preds stays valid.
          int x2;
          locate<kForesight>(sh, new_min, preds2, a.max_steps, lane, x2);
          splice<kForesight>(sh, nid, new_min, h, preds2, lane);
          int* nk = sh.fat_keys + (size_t)nid * (size_t)B;
          int* nv = sh.fat_vals + (size_t)nid * (size_t)B;
          const bool into_lo = q < new_min;  // == is impossible: absent
          const int hi = B - half;           // the upper half's lanes
          for (int e = lane; e < B; e += kWarp) {
            rk[e] = into_lo ? shifted_in(sk, 0, half, kKeyMax, e, pos, q)
                            : run_lane(sk, 0, half, kKeyMax, e);
            rv[e] = into_lo ? shifted_in(sv, 0, half, kNullVal, e, pos, v)
                            : run_lane(sv, 0, half, kNullVal, e);
            nk[e] = into_lo ? run_lane(sk, half, hi, kKeyMax, e)
                            : shifted_in(sk, half, hi, kKeyMax, e, pos - half,
                                         q);
            nv[e] = into_lo ? run_lane(sv, half, hi, kNullVal, e)
                            : shifted_in(sv, half, hi, kNullVal, e, pos - half,
                                         v);
          }
          if (lane == 0) {
            sh.nlen[owner] = into_lo ? half + 1 : half;
            sh.nlen[nid] = into_lo ? B - half : B - half + 1;
          }
          ++n;
          __syncwarp();
          if (at_front) set_node_min<kForesight>(sh, owner, q, preds, lane);
          result = 1;
        }
      }
    } else if (present) {                  // delete
      stage_row(rk, rv, sk, sv, B, lane);
      const int new_len = sh.nlen[owner] - 1;
      for (int e = lane; e < B; e += kWarp) {
        rk[e] = e < pos ? sk[e] : (e + 1 < B ? sk[e + 1] : kKeyMax);
        rv[e] = e < pos ? sv[e] : (e + 1 < B ? sv[e + 1] : kNullVal);
      }
      __syncwarp();
      if (lane == 0) sh.nlen[owner] = new_len;
      --n;
      __syncwarp();
      if (new_len == 0) {
        if (lane == 0) atomicAdd(a.cases + kEmptied, 1ull);
        unsplice<kForesight>(sh, owner, preds, free_top, lane);
      } else if (new_len > 0 && pos == 0) {
        if (lane == 0) atomicAdd(a.cases + kMinLane, 1ull);
        set_node_min<kForesight>(sh, owner, 1 < B ? sk[1] : kKeyMax,
                                 preds, lane);
      } else if (lane == 0) {
        atomicAdd(a.cases + kPlain, 1ull);
      }
      result = 1;
    }
  }
  return result;
}

template <bool kForesight, bool kFat>
__global__ void __launch_bounds__(kThreads, 1) apply_ops_kernel(Args a) {
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int len = a.lens[s];
  if (len <= 0) return;                       // the whole block
  const long long start = a.starts[s];
  const int L = a.levels, B = a.width;
  extern __shared__ int smem[];
  int* wpreds = smem;                         // [kWindow][kPredStride]
  int* ts = wpreds + kWindow * kPredStride;   // [kWindow] clamped op types
  int* qs = ts + kWindow;                     // [kWindow] keys
  int* vs = qs + kWindow;                     // [kWindow] vals
  int* hts = vs + kWindow;                    // [kWindow] inserts' heights
  unsigned* chain = (unsigned*)(hts + kWindow);   // [kWindow][2] rng keys
  int* preds2 = (int*)(chain + 2 * kWindow);  // [kMaxLevels] the median's
  int* sk = preds2 + kMaxLevels;              // [B] a staged run's keys
  int* sv = sk + B;                           // [B] and vals
  const size_t tab = (size_t)s * (size_t)L * (size_t)a.cap;
  const size_t vec = (size_t)s * (size_t)a.cap;
  const size_t runs = vec * (size_t)B;
  Shard sh;
  sh.fused = kForesight ? a.fused + tab : nullptr;
  sh.nxt = kForesight ? nullptr : a.nxt + tab;
  sh.keys = a.keys + vec;
  sh.vals = a.vals + vec;
  sh.height = a.height + vec;
  sh.free_list = a.free_list + vec;
  sh.fat_keys = kFat ? a.fat_keys + runs : nullptr;
  sh.fat_vals = kFat ? a.fat_vals + runs : nullptr;
  sh.nlen = kFat ? a.nlen + vec : nullptr;
  sh.cap = a.cap;
  sh.levels = L;
  sh.width = B;
  // warp 0's uniform scalars and the rng warp's key, written back at the end
  int n = a.n[s], free_top = a.free_top[s], bump = a.bump[s];
  unsigned k0 = a.rng[2 * s], k1 = a.rng[2 * s + 1];
  unsigned long long stood = 0, resumed = 0, resumed_steps = 0;

  for (int w0 = 0; w0 < len; w0 += kWindow) {
    const int m = min(kWindow, len - w0);
    if (tid < kWindow) {                      // the walk phase
      if (tid < m) {
        const long long o = start + w0 + tid;
        const int q = a.op_keys[o];
        ts[tid] = clamp_type(a.op_types[o]);
        qs[tid] = q;
        vs[tid] = a.op_vals[o];
        int* row = wpreds + tid * kPredStride;
        int x = kHead;
        long long steps = 0;
        if (!descend<kForesight>(sh, q, row, L - 1, x, a.max_steps, steps))
          __trap();
        // the lines the apply phase reads and no walk did, asked for
        // now, all at once: each predecessor's height and key (the
        // check's), the found node's height and two lowest records (a
        // delete's), a fat owner's run and length
        for (int l = 0; l < L; ++l) {
          prefetch_l2(sh.height + row[l]);
          prefetch_l2(sh.keys + row[l]);
        }
        const int2 c = record<kForesight>(sh, 0, x);
        if (!kFat) {
          prefetch_l2(sh.height + c.x);
          for (int l = 0; c.y == q && l < min(L, 2); ++l) {
            const size_t idx = (size_t)l * (size_t)sh.cap + (size_t)c.x;
            prefetch_l2(kForesight ? (const void*)(sh.fused + idx)
                                   : (const void*)(sh.nxt + idx));
          }
        } else {
          const int owner = (c.y == q || x == kHead) ? c.x : x;
          const size_t run = (size_t)owner * (size_t)B;
          for (int e = 0; e < B; e += kWarp) {
            prefetch_l2(sh.fat_keys + run + e);
            prefetch_l2(sh.fat_vals + run + e);
          }
          prefetch_l2(sh.nlen + owner);
        }
      }
    } else {                                  // the rng warp
      if (lane == 0) {
        for (int j = 0; j < m; ++j) {
          if (clamp_type(a.op_types[start + w0 + j]) != kInsert) continue;
          chain[2 * j] = k0;
          chain[2 * j + 1] = k1;
          const uint2 next = threefry2x32(k0, k1, 0u, 0u);
          k0 = next.x;
          k1 = next.y;
        }
      }
      __syncwarp();
      for (int j = lane; j < m; j += kWarp) {
        if (clamp_type(a.op_types[start + w0 + j]) == kInsert)
          hts[j] = draw_height(chain[2 * j], chain[2 * j + 1], L, a.ref_ctz);
      }
    }
    __syncthreads();
    for (int j = 0; tid < kWarp && j < m; ++j) {    // the apply phase
      const long long o = start + w0 + j;
      const int t = ts[j], q = qs[j], v = vs[j];
      int* preds = wpreds + j * kPredStride;
      int2 rec = make_int2(0, 0);
      const bool ok =
          lane >= L || stands<kForesight>(sh, preds[lane], lane, q, rec);
      const unsigned bad = __ballot_sync(kFullMask, !ok);
      int x = kHead;
      int2 c = rec;                           // lane 0's: level 0's record
      if (bad != 0) {
        if (lane == 0) {
          const int f = 31 - __clz((int)bad);  // the highest level failing
          long long steps = 0;
          x = f == L - 1 ? kHead : preds[f + 1];
          if (!descend<kForesight>(sh, q, preds, f, x, a.max_steps, steps))
            __trap();
          c = record<kForesight>(sh, 0, x);
          ++resumed;
          resumed_steps += steps;
        }
        __syncwarp();                         // preds rewritten
        x = __shfl_sync(kFullMask, x, 0);
      } else {
        x = preds[0];
        if (lane == 0) ++stood;
      }
      c.x = __shfl_sync(kFullMask, c.x, 0);
      c.y = __shfl_sync(kFullMask, c.y, 0);
      const int result = apply_op<kForesight, kFat>(
          a, sh, t, q, v, t == kInsert ? hts[j] : 0, x, c, preds, preds2,
          sk, sv, n, free_top, bump, lane);
      if (lane == 0) a.results[o] = result;
      __syncwarp();          // this op's writes before the next op's check
    }
    __syncthreads();         // the window's writes before the next walks
  }
  if (tid == 0) {
    a.n[s] = n;
    a.free_top[s] = free_top;
    a.bump[s] = bump;
    atomicAdd(a.cases + kStood, stood);
    atomicAdd(a.cases + kResumed, resumed);
    atomicAdd(a.cases + kResumedSteps, resumed_steps);
  } else if (tid == kWindow) {
    a.rng[2 * s] = k0;
    a.rng[2 * s + 1] = k1;
  }
}

template <bool kForesight, bool kFat>
int launch(const Args& a, int shards, cudaStream_t stream) {
  const size_t smem = (size_t)(kWindow * (kPredStride + 6) + kMaxLevels +
                               2 * a.width) * sizeof(int);
  apply_ops_kernel<kForesight, kFat><<<shards, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Applies the route-sorted batch [batch] to the stacked state in place and
// writes each op's result at its sorted index; enqueues on `stream` and
// returns cudaGetLastError().  `fused` (foresight) or `nxt` (base) is null;
// `fat_keys`, `fat_vals` and `nlen` are null on the scalar layout (`width`
// is then 1).  `levels` <= 32; `shards` >= 1.
int apply_ops_launch(void* fused, void* nxt, void* keys, void* vals,
                     void* height, void* n, void* free_top, void* free_list,
                     void* bump, void* rng, void* fat_keys, void* fat_vals,
                     void* nlen, const void* op_types, const void* op_keys,
                     const void* op_vals, const void* starts,
                     const void* lens, const void* ref_ctz, void* results,
                     void* cases, int shards, int levels, long long cap,
                     int width, long long max_steps, void* stream) {
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
  a.op_types = (const int*)op_types;
  a.op_keys = (const int*)op_keys;
  a.op_vals = (const int*)op_vals;
  a.starts = (const int*)starts;
  a.lens = (const int*)lens;
  a.ref_ctz = (const int*)ref_ctz;
  a.results = (int*)results;
  a.cases = (unsigned long long*)cases;
  a.levels = levels;
  a.cap = cap;
  a.width = width;
  a.max_steps = max_steps;
  const bool fat = fat_keys != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  if (fused != nullptr)
    return fat ? launch<true, true>(a, shards, st)
               : launch<true, false>(a, shards, st);
  return fat ? launch<false, true>(a, shards, st)
             : launch<false, false>(a, shards, st);
}

}  // extern "C"
