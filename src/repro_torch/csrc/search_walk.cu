// The recording search walk (K14) for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: it is the device form of the reference's eager
// recording reads, each one lax.while_loop on the TPU,
//   search      repro/core/skiplist.py:435 (_search_loop, :369)
//   search_validated repro/core/validated.py:37
// which the port ran as a host loop that read a flag back every lock-step
// iteration.  One launch walks the whole batch and gives what the
// reference's loop gives, bit for bit: found, vals and node [B], preds
// [B, L] (the last node visited on each level), and the lock-step loop's
// counters steps and gathers.
//
// Modes (the template's kMode):
//   foresight  advance iff fused[l, x].key < q: one 8-byte load a step;
//   base       ptr = nxt[l, x], advance iff keys[ptr] < q: two dependent
//              loads a step;
//   validated  the paper's Algorithm 3 on a mixed view: fused may hold
//              stale or corrupt foreseen keys and `keys` is the
//              authoritative table; above level 0 advance iff the foreseen
//              key AND keys[ptr] are below q, on level 0 on keys[ptr]
//              alone.  keys[ptr] is loaded only where it can change the
//              outcome (level 0, or a foreseen advance), as K8 does.
// The third eager read, search_fast, records nothing and runs K1/K2
// (traverse.cu) on the card instead.
//
// Design: one thread walks one query with its own early exit, as K1/K2 and
// K8 do.  That is the reference's lock-step loop exactly: a lane there is
// active from the first iteration until it leaves stop_level, advancing or
// descending once an iteration, so it makes the same moves in the same
// order here.  Its path length p_b (the iterations it is active: its
// rights plus the L - stop_level descents) is all the counters need: the
// loop ran max_b p_b iterations (steps; 0 for an empty batch) and counted
// g * sum_b p_b gathers (g = 1 foresight, 2 base and validated).  A block
// reduces both, then one atomicMax and one atomicAdd fold them into the
// [2] int32 buffer the wrapper zeroed; the add is unsigned, so a sum past
// 2^31 wraps as the reference's int32 sum does.  Nothing is read back to
// the host.
//
// preds: on each descent from level l >= stop_level the lane records x at
// [b, l]; levels below stop_level stay 0.  Stored straight to device
// memory, a warp's 32 stores of a step would land in 32 rows of L * 4 bytes
// (108 B at L = 27), and at 2^20 x 27 x 4 B = 113 MB preds are most of the
// kernel's bytes.  So each block stages its rows in shared memory (kBlock
// rows of at most kMaxLevels ints, 32 KB) and writes them out at the end as
// one contiguous, coalesced [kBlock, L] copy.
//
// Result: the candidate is the successor of x on stop_level (level 0 in
// the validated mode).  Scalar: found = its key == q, vals = found ?
// vals[cand] : -1, node = found ? cand : TAIL (1).  Fat lists (node_width
// B > 1): K9 (fat_resolve.cuh) on the node-level walk gives the
// element-flat slot owner * B + min(pos, B - 1) and the key there (KEY_MAX
// when pos == B); found = that key == q and the key at the slot is q (the
// reference's pos < B), and vals / node come from fat_vals and the slot.
// K9 needs the whole warp, so no lane returns early: a lane past the batch
// walks nothing and passes need = false.
//
// Bound: every walk stops at max_steps (kernels/foresight_traverse.py
// traversal_bound: levels + capacity - 2 + 16, more than any path of a
// well-formed list) and traps past it, as K11-K13 do: a corrupt table
// fails the launch.  The reference's search loops for ever on one.
//
// What bounds it: each lane's chain of dependent loads, one miss to HBM a
// step on an index far larger than the 50 MB L2 (two on an advance in the
// base and validated modes), and then the preds bytes; the lanes are
// walked in batch order (K1/K2's grouping by key is not taken here).
//
// Record and byte offsets are 64-bit: at 27 levels x 2^26 slots the byte
// offset reaches 14.5e9.  Element ids are int32, as in the reference: the
// wrapper refuses cap * B above 2^31 - 1 (kernels/ops.py
// check_index_range).

#include <cuda_runtime.h>
#include <cstdint>

#include "fat_resolve.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxLevels = 32;       // preds staged a block: 32 KB
constexpr int kForesight = 0;
constexpr int kBase = 1;
constexpr int kValidated = 2;
constexpr int kTail = 1;
constexpr int kNullVal = -1;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int2* fused;         // [L, cap] (ptr, key); foresight and validated
  const int* nxt;            // [L, cap]; base
  const int* keys;           // [cap]; base, and validated's authoritative
  const int* vals;           // [cap]
  const int* fat_keys;       // [cap, width] or null (scalar layout)
  const int* fat_vals;       // [cap, width] or null
  const int* queries;        // [batch]
  bool* found;               // [batch]
  int* out_vals;             // [batch]
  int* node;                 // [batch]
  int* preds;                // [batch, levels]
  int* counters;             // [2] steps, gathers, zeroed
  long long batch;
  int levels;
  long long cap;
  int width;
  int stop_level;
  long long max_steps;
};

// One step of the walk at node x on level lvl: whether the lane advances,
// and the successor it would advance to.
template <int kMode>
__device__ __forceinline__ bool advances(const Args& a, int lvl, int x, int q,
                                         int& ptr) {
  const size_t at = (size_t)lvl * (size_t)a.cap + (size_t)x;
  if constexpr (kMode == kForesight) {
    const int2 rec = __ldg(a.fused + at);
    ptr = rec.x;
    return rec.y < q;
  } else if constexpr (kMode == kBase) {
    ptr = __ldg(a.nxt + at);
    return __ldg(a.keys + (size_t)ptr) < q;          // dependent on ptr
  } else {
    const int2 rec = __ldg(a.fused + at);
    ptr = rec.x;
    return (lvl == 0 || rec.y < q) && __ldg(a.keys + (size_t)ptr) < q;
  }
}

// x's successor on level lvl and its key (the authoritative one in the
// validated mode).
template <int kMode>
__device__ __forceinline__ int2 successor(const Args& a, int lvl, int x) {
  const size_t at = (size_t)lvl * (size_t)a.cap + (size_t)x;
  if constexpr (kMode == kForesight) return __ldg(a.fused + at);
  const int ptr = kMode == kBase ? __ldg(a.nxt + at) : __ldg(a.fused + at).x;
  return make_int2(ptr, __ldg(a.keys + (size_t)ptr));
}

template <int kMode>
__global__ void __launch_bounds__(kBlock) search_walk_kernel(const Args a) {
  __shared__ int rows[kBlock * kMaxLevels];
  __shared__ unsigned warp_max[kWarps], warp_sum[kWarps];
  const long long base = (long long)blockIdx.x * kBlock;
  const long long i = base + threadIdx.x;
  const bool live = i < a.batch;
  const int q = live ? __ldg(a.queries + i) : 0;
  const int L = a.levels;
  const int stop = a.stop_level;
  int* row = rows + threadIdx.x * L;
  for (int l = 0; l < L; ++l) row[l] = 0;
  int lvl = live ? L - 1 : stop - 1;
  int x = 0;                                      // head sentinel
  long long path = 0;                             // p_b
  while (lvl >= stop) {
    if (++path > a.max_steps) __trap();          // a corrupt table
    int ptr;
    if (advances<kMode>(a, lvl, x, q, ptr)) {
      x = ptr;
    } else {
      row[lvl] = x;
      --lvl;
    }
  }
  int2 r = live ? successor<kMode>(a, stop, x) : make_int2(0, 0);
  const int* src_vals = a.vals;
  bool hit = live && r.y == q;
  if constexpr (kMode != kValidated) {
    if (a.fat_keys != nullptr) {                 // the same for every lane
      r = k9::fat_resolve(a.fat_keys, a.width, q, x, r, live);
      hit = live && r.y == q && __ldg(a.fat_keys + (size_t)r.x) == q;
      src_vals = a.fat_vals;
    }
  }
  if (live) {
    a.found[i] = hit;
    a.out_vals[i] = hit ? __ldg(src_vals + (size_t)r.x) : kNullVal;
    a.node[i] = hit ? r.x : kTail;
  }
  const unsigned p = live ? (unsigned)path : 0u;
  const unsigned m = __reduce_max_sync(kFull, p);
  const unsigned s = __reduce_add_sync(kFull, p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_max[warp] = m;
    warp_sum[warp] = s;
  }
  __syncthreads();                               // rows and the warp sums
  const long long n = min((long long)kBlock, a.batch - base) * L;
  int* out = a.preds + base * L;
  for (long long e = threadIdx.x; e < n; e += kBlock) out[e] = rows[e];
  if (threadIdx.x == 0) {
    unsigned bm = 0, bs = 0;
    for (int w = 0; w < kWarps; ++w) {
      bm = max(bm, warp_max[w]);
      bs += warp_sum[w];
    }
    const unsigned g = kMode == kForesight ? 1u : 2u;
    atomicMax(a.counters, (int)bm);
    atomicAdd(reinterpret_cast<unsigned*>(a.counters) + 1, g * bs);
  }
}

template <int kMode>
int launch(const Args& a, cudaStream_t st) {
  const unsigned grid = (unsigned)((a.batch + kBlock - 1) / kBlock);
  search_walk_kernel<kMode><<<grid, kBlock, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues on `stream` and returns cudaGetLastError(); `batch` must be
// positive and `levels` at most kMaxLevels.  mode: 0 foresight, 1 base,
// 2 validated.  fat_keys / fat_vals are null on the scalar layout.
int search_walk_launch(const void* fused, const void* nxt, const void* keys,
                       const void* vals, const void* fat_keys,
                       const void* fat_vals, const void* queries, void* found,
                       void* out_vals, void* node, void* preds,
                       void* counters, int mode, long long batch, int levels,
                       long long cap, int width, int stop_level,
                       long long max_steps, void* stream) {
  if (levels < 1 || levels > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  const Args a{(const int2*)fused, (const int*)nxt, (const int*)keys,
               (const int*)vals, (const int*)fat_keys,
               (const int*)fat_vals, (const int*)queries, (bool*)found,
               (int*)out_vals, (int*)node, (int*)preds, (int*)counters,
               batch, levels, cap, width, stop_level, max_steps};
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == kForesight) return launch<kForesight>(a, st);
  if (mode == kBase) return launch<kBase>(a, st);
  if (mode == kValidated) return launch<kValidated>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
