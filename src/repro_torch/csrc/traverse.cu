// Batched skiplist traversal kernels for Hopper (sm_90a), plain C interface.
//
// Replace the Pallas TPU kernels of repro/kernels/foresight_traverse.py:
//   foresight_traverse_launch -> foresight_traverse (_foresight_kernel)
//   base_traverse_launch      -> base_traverse (_base_kernel)
// Both run the lock-step loop of _traverse_loop: start at the head on level
// L-1; each step either advances to the successor (its key < q) or descends;
// stop when below level 0 or after max_steps steps; return the level-0
// successor of the final predecessor and its key.
//
// Design: one thread per query, each running its own early-exit loop.  That
// equals the reference's 128-lane lock-step exactly: a lane there advances
// or descends once per iteration from the start, so it stops after the same
// number of its own steps.  No lane block, so no padding; the ragged edge is
// masked.  The index lives in device memory; nothing is staged in shared
// memory (the TPU's VMEM budget has no counterpart here).
//
// The foresight step is ONE 8-byte load of the (next_ptr, next_key) record,
// an int2 through the read-only path: the paper's fused load.  The base step
// is two dependent 4-byte loads, pointer then pointee key.
//
// What bounds it: on an index far larger than the 50 MB L2 each step is a
// dependent miss to HBM, so a thread's time is its path length times the
// miss latency; the card's byte rate is not the limit.  Speeding it up
// (warp-cooperative upper levels, the top levels cached in shared memory,
// prefetch) is later work.
//
// Record and byte offsets are computed in 64 bits: at 27 levels x 2^26 slots
// the record index reaches 1.8e9 and the byte offset 14.5e9.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
foresight_kernel(const int2* __restrict__ fused, const int* __restrict__ queries,
                 int* __restrict__ node, int* __restrict__ key,
                 long long batch, int levels, long long cap,
                 long long max_steps) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= batch) return;
  const int q = queries[i];
  int x = 0;                 // head sentinel
  int lvl = levels - 1;
  for (long long step = 0; step < max_steps && lvl >= 0; ++step) {
    const int2 rec = __ldg(fused + (size_t)lvl * (size_t)cap + (size_t)x);
    if (rec.y < q) x = rec.x; else --lvl;
  }
  const int2 rec = __ldg(fused + (size_t)x);      // level 0
  node[i] = rec.x;
  key[i] = rec.y;
}

__global__ void __launch_bounds__(kBlock)
base_kernel(const int* __restrict__ nxt, const int* __restrict__ keys,
            const int* __restrict__ queries, int* __restrict__ node,
            int* __restrict__ key, long long batch, int levels, long long cap,
            long long max_steps) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i >= batch) return;
  const int q = queries[i];
  int x = 0;
  int lvl = levels - 1;
  for (long long step = 0; step < max_steps && lvl >= 0; ++step) {
    const int ptr = __ldg(nxt + (size_t)lvl * (size_t)cap + (size_t)x);
    const int fk = __ldg(keys + (size_t)ptr);      // dependent on ptr
    if (fk < q) x = ptr; else --lvl;
  }
  const int ptr = __ldg(nxt + (size_t)x);
  node[i] = ptr;
  key[i] = __ldg(keys + (size_t)ptr);
}

unsigned grid_for(long long batch) {
  return (unsigned)((batch + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" {

// Each launcher enqueues on `stream` and returns cudaGetLastError().
// `batch` must be positive.
int foresight_traverse_launch(const void* fused, const void* queries,
                              void* node, void* key, long long batch,
                              int levels, long long cap, long long max_steps,
                              void* stream) {
  foresight_kernel<<<grid_for(batch), kBlock, 0, (cudaStream_t)stream>>>(
      (const int2*)fused, (const int*)queries, (int*)node, (int*)key, batch,
      levels, cap, max_steps);
  return (int)cudaGetLastError();
}

int base_traverse_launch(const void* nxt, const void* keys,
                         const void* queries, void* node, void* key,
                         long long batch, int levels, long long cap,
                         long long max_steps, void* stream) {
  base_kernel<<<grid_for(batch), kBlock, 0, (cudaStream_t)stream>>>(
      (const int*)nxt, (const int*)keys, (const int*)queries, (int*)node,
      (int*)key, batch, levels, cap, max_steps);
  return (int)cudaGetLastError();
}

const char* traverse_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
