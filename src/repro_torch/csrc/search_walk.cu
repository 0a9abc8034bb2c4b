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
// 2^31 wraps as the reference's int32 sum does, in any lane order.
// Nothing is read back to the host.
//
// Lanes grouped by key, as K1/K2/K8 walk them (traverse.cu's head comment):
// the wrapper first runs group_by_key (shard_group.cu), a stable counting
// sort of the lanes by key bucket, and lane i walks q_sorted[i] and writes
// its result and its preds row at out_idx[i] = perm[i], its batch index.
// A warp's lanes then share their path down to about level 12 of 27 on
// uniform traffic (one record load serves the warp there) and walk one
// narrow window of node ids below it.  The order changes no lane's walk,
// only which lanes share a warp, so every field is the batch-order
// launch's bit for bit.
//
// preds: on each descent from level l >= stop_level the lane records x at
// level l of its row in its warp's slice of dynamic shared memory (32 rows
// of L ints, 3,456 B at L = 27) and, after its walk, zeroes the levels
// below stop_level; once the warp's 32 lanes have walked (__syncwarp), the
// warp writes the 32 rows out one by one, each to its lane's batch index
// perm[i] as one contiguous L-int store (108 B at L = 27), so the wrapper
// allocates preds uninitialised.  A block of 256 rows takes 27,648 B, and
// 8 blocks an SM (221 KB) need the largest shared-memory carveout, which
// is asked for once a device and mode; at 32 registers
// (__launch_bounds__(256, 8)) the walk then keeps 64 warps an SM, as
// K1/K2.  The rows cap L at kMaxLevels.  The other design, each entry
// stored straight to device memory as the lane descends (27 scattered
// 4-byte stores a lane, each a partial sector in L2), took about twice
// the staged walk's time on the H100 at 2^20 queries on 2^25 keys
// (PERF.md), and was dropped.
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
// step below the levels its warp shares on an index far larger than the
// 50 MB L2 (two on an advance in the base and validated modes), as in
// K1/K2/K8 grouped; then the preds rows, 2^20 scattered 108 B stores (113
// MB) whose edge sectors neighbouring rows fill at other times, and the
// hits' vals reads; then the pass.  On the H100 at 2^20 queries on 2^25
// uniform keys the foresight walk takes 0.69 ms of device time where K1
// takes 0.34 on the same grouped lanes, and the pass 0.08 (PERF.md); on
// Zipf keys, where few misses are left to share, the pass costs more than
// the grouping saves.
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
constexpr int kMinBlocks = 8;        // a SM's 64 warps: 32 registers a thread
constexpr int kWarps = kBlock / 32;
constexpr int kMaxLevels = 32;       // the rows a warp stages: 4 KB at most
constexpr int kMaxDevices = 64;
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
  const int* out_idx;        // [batch] perm: lane i's batch index
  const int* queries;        // [batch], in lane order (q_sorted)
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

// A lane keeps its preds row in its warp's slice of dynamic shared memory
// ([kBlock, L] ints), and the warp writes its 32 rows out row by row once
// every lane has walked.
template <int kMode>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
search_walk_kernel(const Args a) {
  extern __shared__ int staged[];
  __shared__ unsigned warp_max[kWarps], warp_sum[kWarps];
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < a.batch;
  const int q = live ? __ldg(a.queries + i) : 0;
  const int L = a.levels;
  const int stop = a.stop_level;
  int* const row = staged + threadIdx.x * L;
  int lvl = live ? L - 1 : stop - 1;
  int x = 0;                                      // head sentinel
  int path = 0;                                   // p_b
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
  if (live)
    for (int l = 0; l < stop; ++l) row[l] = 0;
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = live ? __ldg(a.out_idx + i) : 0;   // the batch index
  if (live) {
    a.found[o] = hit;
    a.out_vals[o] = hit ? __ldg(src_vals + (size_t)r.x) : kNullVal;
    a.node[o] = hit ? r.x : kTail;
  }
  // the warp's rows, one contiguous L-int store a row
  __syncwarp();
  const long long first = i - lane;
  const int* rows = staged + (threadIdx.x - lane) * L;
  for (int k = 0; k < 32 && first + k < a.batch; ++k) {
    const long long dst = (long long)__shfl_sync(kFull, o, k) * L;
    for (int e = lane; e < L; e += 32) a.preds[dst + e] = rows[k * L + e];
  }
  const unsigned p = live ? (unsigned)path : 0u;
  const unsigned m = __reduce_max_sync(kFull, p);
  const unsigned s = __reduce_add_sync(kFull, p);
  if (lane == 0) {
    warp_max[warp] = m;
    warp_sum[warp] = s;
  }
  __syncthreads();                               // the warp sums
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

// The largest shared-memory carveout, asked for once a device and mode:
// 8 blocks of 256 staged rows at L = 27 take 221 KB.
template <int kMode>
cudaError_t prefer_shared() {
  static bool asked[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (asked[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(search_walk_kernel<kMode>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  asked[dev] = err == cudaSuccess;
  return err;
}

size_t staged_bytes(int levels) {
  return (size_t)kBlock * levels * sizeof(int);
}

template <int kMode>
int launch(const Args& a, cudaStream_t st) {
  const cudaError_t set = prefer_shared<kMode>();
  if (set != cudaSuccess) return (int)set;
  const unsigned grid = (unsigned)((a.batch + kBlock - 1) / kBlock);
  search_walk_kernel<kMode><<<grid, kBlock, staged_bytes(a.levels), st>>>(a);
  return (int)cudaGetLastError();
}

template <int kMode>
int occupancy(int levels, int* blocks) {
  const cudaError_t set = prefer_shared<kMode>();
  if (set != cudaSuccess) return (int)set;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, search_walk_kernel<kMode>, kBlock, staged_bytes(levels));
}

Args make_args(const void* fused, const void* nxt, const void* keys,
               const void* vals, const void* fat_keys, const void* fat_vals,
               const void* out_idx, const void* queries, void* found,
               void* out_vals, void* node, void* preds, void* counters,
               long long batch, int levels, long long cap, int width,
               int stop_level, long long max_steps) {
  return Args{(const int2*)fused, (const int*)nxt, (const int*)keys,
              (const int*)vals, (const int*)fat_keys, (const int*)fat_vals,
              (const int*)out_idx, (const int*)queries, (bool*)found,
              (int*)out_vals, (int*)node, (int*)preds, (int*)counters,
              batch, levels, cap, width, stop_level,
              // a lane counts its steps in 32 bits
              max_steps < 0x7fffffff ? max_steps : 0x7fffffff};
}

}  // namespace

extern "C" {

// Enqueues on `stream` and returns cudaGetLastError(); `batch` must be
// positive and `levels` at most kMaxLevels.  Lane i walks queries[i] and
// writes at out_idx[i], a permutation of [0, batch).  mode: 0 foresight, 1
// base, 2 validated.  fat_keys / fat_vals are null on the scalar layout.
int search_walk_launch(const void* fused, const void* nxt, const void* keys,
                       const void* vals, const void* fat_keys,
                       const void* fat_vals, const void* out_idx,
                       const void* queries, void* found, void* out_vals,
                       void* node, void* preds, void* counters, int mode,
                       long long batch, int levels, long long cap, int width,
                       int stop_level, long long max_steps, void* stream) {
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  const Args a = make_args(fused, nxt, keys, vals, fat_keys, fat_vals,
                           out_idx, queries, found, out_vals, node, preds,
                           counters, batch, levels, cap, width, stop_level,
                           max_steps);
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == kForesight) return launch<kForesight>(a, st);
  if (mode == kBase) return launch<kBase>(a, st);
  if (mode == kValidated) return launch<kValidated>(a, st);
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM of the walk at `levels`, from the occupancy
// calculator, into *blocks; returns the CUDA error.
int search_walk_blocks_per_sm(int mode, int levels, void* blocks) {
  int* const out = (int*)blocks;
  if (levels < 1 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (mode == kForesight) return occupancy<kForesight>(levels, out);
  if (mode == kBase) return occupancy<kBase>(levels, out);
  if (mode == kValidated) return occupancy<kValidated>(levels, out);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
