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
//     _REF_CTZ, passed in), capped at L;
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
// Design: one warp a shard, one block a warp.  Lane 0 walks each op's
// search and records the predecessor of every level in shared memory; the
// whole warp then does the rest: a splice or unsplice one lane a level
// (L <= 32), a fat run's count of lanes below the key by ballot and
// popcount (32 lanes a step), its shift through a copy in shared memory,
// and the foreseen-key fix one lane a level.  __syncwarp() orders each
// step's writes before the next step's reads.  The state is written by
// this warp only, so every load is a plain coherent one: no __ldg, no
// const __restrict__ on the state.  K9's fat_resolve (traverse.cu) does
// not fit here: it reads through the read-only path, which may return
// stale lines of a row this kernel has just written, and it resolves many
// lanes' rows at once where an update resolves one.
//
// Base reads the pointer, then the pointee's key: two dependent loads a
// step, as K2 does.  Foresight reads the (ptr, key) record as one 8-byte
// load and writes a predecessor's record as one 8-byte store: the paper's
// pair written at once.
//
// What bounds it: each op's chain of dependent loads (the walk, a miss to
// HBM a step on an index far larger than L2), then a few more for the
// splice; the ops of a shard run one after another, so a shard's time is
// its ops' chains end to end, and shards overlap only with each other.
// Neither the byte rate nor the arithmetic is the limit.
//
// The walk runs under max_steps (kernels/foresight_traverse.py
// traversal_bound): past it the table is corrupt and the kernel traps,
// where the reference would loop for ever.  A shard's offset into the
// stack is 64-bit: 64 shards x 21 levels x 2^21 slots of records is past
// 2^31.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarp = 32;          // threads a block: one warp, one shard
constexpr int kMaxLevels = 32;     // one lane a level
constexpr int kKeyMax = 0x7fffffff;
constexpr int kNullVal = -1;
constexpr int kHead = 0;
constexpr int kTail = 1;
constexpr unsigned kFullMask = 0xffffffffu;
enum OpType { kRead = 0, kInsert = 1, kDelete = 2 };
enum FatCase { kUpsert, kFirst, kRoom, kSplit, kEmptied, kMinLane, kPlain };

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
  unsigned long long* cases;   // [7] fat case counts
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

__device__ __forceinline__ unsigned rotl(unsigned v, int r) {
  return (v << r) | (v >> (32 - r));
}

// Threefry-2x32, 20 rounds (core/prng.py threefry2x32).
__device__ uint2 threefry2x32(unsigned k0, unsigned k1, unsigned x0,
                              unsigned x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
  return make_uint2(x0, x1);
}

// split(rng) -> (rng', sub); the tower height drawn from sub's bits.
__device__ int split_and_draw(unsigned& k0, unsigned& k1, int levels,
                              const int* ref_ctz) {
  const uint2 next = threefry2x32(k0, k1, 0u, 0u);
  const uint2 sub = threefry2x32(k0, k1, 0u, 1u);
  k0 = next.x;
  k1 = next.y;
  const uint2 h = threefry2x32(sub.x, sub.y, 0u, 0u);
  const unsigned ones = ~(h.x ^ h.y);          // trailing one-bits of bits
  const int exact = ones == 0u ? 32 : __ffs((int)ones) - 1;
  return min(ref_ctz[exact] + 1, levels);
}

// Lane 0's search for q: every level's predecessor into preds, the final
// level-0 predecessor into x; returns its level-0 record (successor, key).
template <bool kForesight>
__device__ int2 walk(const Shard& sh, int q, int* preds, long long max_steps,
                     int& x) {
  x = kHead;
  int lvl = sh.levels - 1;
  long long steps = 0;
  while (lvl >= 0) {
    if (++steps > max_steps) __trap();       // a corrupt table
    const size_t idx = (size_t)lvl * (size_t)sh.cap + (size_t)x;
    int ptr, fk;
    if (kForesight) {
      const int2 rec = sh.fused[idx];        // one 8-byte load
      ptr = rec.x;
      fk = rec.y;
    } else {
      ptr = sh.nxt[idx];
      fk = sh.keys[ptr];                     // dependent on ptr
    }
    if (fk < q) {
      x = ptr;
    } else {
      preds[lvl] = x;
      --lvl;
    }
  }
  if (kForesight) return sh.fused[x];
  const int ptr = sh.nxt[x];
  return make_int2(ptr, sh.keys[ptr]);
}

// The warp's copy of lane 0's walk: (x, level-0 record), preds in shared.
template <bool kForesight>
__device__ int2 locate(const Shard& sh, int q, int* preds,
                       long long max_steps, int lane, int& x) {
  int2 c = make_int2(0, 0);
  x = 0;
  if (lane == 0) c = walk<kForesight>(sh, q, preds, max_steps, x);
  __syncwarp();
  x = __shfl_sync(kFullMask, x, 0);
  c.x = __shfl_sync(kFullMask, c.x, 0);
  c.y = __shfl_sync(kFullMask, c.y, 0);
  return c;
}

// Pop the free list, else bump; warp-uniform.  False: no slot, no change.
__device__ bool alloc(const Shard& sh, int& free_top, int& bump, int& nid) {
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
__device__ void splice(const Shard& sh, int nid, int nkey, int h,
                       const int* preds, int lane) {
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
__device__ void unsplice(const Shard& sh, int d, const int* preds,
                         int& free_top, int lane) {
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
__device__ void set_node_min(const Shard& sh, int owner, int new_min,
                             const int* preds, int lane) {
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
__device__ int count_below(const int* row, int width, int q, int lane) {
  int pos = 0;
  for (int base = 0; base < width; base += kWarp) {
    const int e = base + lane;
    pos += __popc(__ballot_sync(kFullMask, e < width && row[e] < q));
  }
  return pos;
}

// Copy a run (keys and vals) into shared memory.
__device__ void stage_row(const int* rk, const int* rv, int* sk, int* sv,
                          int width, int lane) {
  for (int e = lane; e < width; e += kWarp) {
    sk[e] = rk[e];
    sv[e] = rv[e];
  }
  __syncwarp();
}

// The run value of lane e after (key, val) is shifted in at lane p of the
// run src (which reads lane j of the run before the shift).
template <typename Src>
__device__ __forceinline__ int shifted_in(Src src, int e, int p, int kv) {
  return e > p ? src(e - 1) : (e == p ? kv : src(e));
}

template <bool kForesight, bool kFat>
__global__ void __launch_bounds__(kWarp) apply_ops_kernel(Args a) {
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const int len = a.lens[s];
  if (len <= 0) return;                       // the whole warp
  const long long start = a.starts[s];
  const int L = a.levels, B = a.width;
  extern __shared__ int smem[];
  int* preds = smem;                          // [kMaxLevels]
  int* preds2 = smem + kMaxLevels;            // the median's (fat split)
  int* sk = smem + 2 * kMaxLevels;            // [B] a staged run's keys
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
  // warp-uniform scalars, written back at the end
  int n = a.n[s], free_top = a.free_top[s], bump = a.bump[s];
  unsigned k0 = a.rng[2 * s], k1 = a.rng[2 * s + 1];

  for (int i = 0; i < len; ++i) {
    const long long o = start + i;
    const int t = min(max(a.op_types[o], (int)kRead), (int)kDelete);
    const int q = a.op_keys[o], v = a.op_vals[o];
    int x;
    const int2 c = locate<kForesight>(sh, q, preds, a.max_steps, lane, x);
    int result = 0;
    if (!kFat) {
      const bool found = c.y == q;
      if (t == kRead) {
        result = found;
      } else if (t == kInsert) {
        const int h = split_and_draw(k0, k1, L, a.ref_ctz);
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
        const int h = split_and_draw(k0, k1, L, a.ref_ctz);
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
            rk[e] = shifted_in([&](int j) { return sk[j]; }, e, pos, q);
            rv[e] = shifted_in([&](int j) { return sv[j]; }, e, pos, v);
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
            auto lo_k = [&](int j) { return j < half ? sk[j] : kKeyMax; };
            auto lo_v = [&](int j) { return j < half ? sv[j] : kNullVal; };
            auto hi_k = [&](int j) {
              return j < B - half ? sk[j + half] : kKeyMax;
            };
            auto hi_v = [&](int j) {
              return j < B - half ? sv[j + half] : kNullVal;
            };
            for (int e = lane; e < B; e += kWarp) {
              rk[e] = into_lo ? shifted_in(lo_k, e, pos, q) : lo_k(e);
              rv[e] = into_lo ? shifted_in(lo_v, e, pos, v) : lo_v(e);
              nk[e] = into_lo ? hi_k(e) : shifted_in(hi_k, e, pos - half, q);
              nv[e] = into_lo ? hi_v(e) : shifted_in(hi_v, e, pos - half, v);
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
    if (lane == 0) a.results[o] = result;
    __syncwarp();            // this op's writes before the next op's walk
  }
  if (lane == 0) {
    a.n[s] = n;
    a.free_top[s] = free_top;
    a.bump[s] = bump;
    a.rng[2 * s] = k0;
    a.rng[2 * s + 1] = k1;
  }
}

template <bool kForesight, bool kFat>
int launch(const Args& a, int shards, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * kMaxLevels + 2 * a.width) * sizeof(int);
  apply_ops_kernel<kForesight, kFat><<<shards, kWarp, smem, stream>>>(a);
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
