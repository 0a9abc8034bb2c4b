// Validated traversal (K8) for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel of repro/kernels/validated_traverse.py
// (validated_traverse, _validated_kernel): the paper's Algorithm 3,
// Optimistic Validation.  The fused table may hold stale or corrupt
// foreseen keys (a mixed view: an old version's records read with the
// current version's keys); `auth` holds the authoritative keys.  Each step
// reads the (next_ptr, next_key) record at lvl*cap + x and
//   - on levels >= 1 advances iff next_key < q AND auth[next_ptr] < q,
//   - on level 0 advances iff auth[next_ptr] < q (foresight unused),
// and otherwise descends.  The result is the level-0 successor of the
// final predecessor and its authoritative key.
//
// Form built: the validation load auth[next_ptr] is issued only where it
// can change the outcome, i.e. on level 0 and, above it, when the foreseen
// key says advance.  That is the paper's shape (validate on advance); the
// outputs equal the reference's, which loads it every step.
//
// Design: one thread per query, each with its own early-exit loop, as K2
// (traverse.cu).  The reference runs a FIXED 4*L+16 steps in 128-lane
// lock-step; a lane there does nothing once below level 0, so stopping
// early changes nothing, and a lane cut off at max_steps is cut off at the
// same step here.  No lane blocks, so no padding; the ragged edge is masked.
//
// Grouped launch: the wrapper first orders the lanes by key range with
// group_by_key (shard_group.cu, the pass K2 takes), and lane i walks
// q_sorted[i] and writes its result at out_idx[i], the lane's batch index
// (out_idx null: lane i writes at i, the batch-order launch timed beside
// it).  A warp's lanes then read the same records on the levels their key
// range shares, and the rest in one narrow window of node ids a level.  The
// lanes are independent, so the order changes no lane's result; the step
// cap is counted per lane as before, and a lane cut off at it gives the
// same (node, key).
//
// What bounds it: the chain of dependent loads.  On an index far larger
// than the 50 MB L2 each step is a miss to HBM, and an advance adds a
// second, dependent miss (the pointee's key) after the record's; the card's
// byte rate is not the limit.  Grouping cuts the misses a warp makes, not
// the chain each lane waits on.
//
// Record and byte offsets are 64-bit: at 27 levels x 2^26 slots the byte
// offset reaches 14.5e9.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
validated_kernel(const int2* __restrict__ fused, const int* __restrict__ auth,
                 const int* __restrict__ out_idx,
                 const int* __restrict__ queries, int* __restrict__ node,
                 int* __restrict__ key, long long batch, int levels,
                 long long cap, long long max_steps) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= batch) return;
  const int q = queries[i];
  int x = 0;                 // head sentinel
  int lvl = levels - 1;
  for (long long step = 0; step < max_steps && lvl >= 0; ++step) {
    const int2 rec = __ldg(fused + (size_t)lvl * (size_t)cap + (size_t)x);
    const bool go = (lvl == 0 || rec.y < q) && __ldg(auth + rec.x) < q;
    if (go) x = rec.x; else --lvl;
  }
  const int cand = __ldg(fused + (size_t)x).x;    // level 0
  const long long o = out_idx == nullptr ? i : (long long)__ldg(out_idx + i);
  node[o] = cand;
  key[o] = __ldg(auth + cand);
}

}  // namespace

extern "C" {

// Enqueues on `stream` and returns cudaGetLastError().  `batch` must be
// positive.  Lane i walks queries[i] and writes its result at out_idx[i];
// out_idx may be null (lane i writes at i).
int validated_traverse_launch(const void* fused, const void* auth,
                              const void* out_idx, const void* queries,
                              void* node, void* key, long long batch,
                              int levels, long long cap, long long max_steps,
                              void* stream) {
  const unsigned grid = (unsigned)((batch + kBlock - 1) / kBlock);
  validated_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const int2*)fused, (const int*)auth, (const int*)out_idx,
      (const int*)queries, (int*)node, (int*)key, batch, levels, cap,
      max_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
