// Device code shared by shard_group.cu and traverse.cu: the pieces of a
// counting sort of lanes by bucket in shared memory.
//
// shard_group.cu's passes sort a whole batch in tiles whose ranks are
// scanned across blocks; traverse.cu's tile-sorted K5/K6 sort one tile of
// a clustered plan's lanes inside the block that walks it.  Each .cu file
// compiles alone, so this header holds inline device functions only.

#pragma once

#include <cuda_runtime.h>

namespace tile_sort {

constexpr unsigned kFull = 0xffffffffu;

// int32 onto uint32 with the order kept.
__device__ __forceinline__ unsigned order_key(int q) {
  return (unsigned)q ^ 0x80000000u;
}

// The least right shift that maps the span [lo, hi] of order keys onto at
// most 2^bits buckets (lo <= hi); the difference is unsigned, so a span
// from KEY_MIN to KEY_MAX does not overflow.
__device__ __forceinline__ unsigned span_shift(unsigned lo, unsigned hi,
                                               int bits) {
  const int len = 32 - __clz((int)(hi - lo));   // bit length of the span
  return (unsigned)max(0, len - bits);
}

// Block-wide least of lo and greatest of hi over a block of kN warps (at
// most 32), left in thread 0's lo and hi; the other threads keep their
// warp's.  Every thread of the block calls it.
template <int kN>
__device__ __forceinline__ void block_min_max(unsigned& lo, unsigned& hi,
                                              unsigned* lo_w,
                                              unsigned* hi_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0) {
    lo_w[warp] = lo;
    hi_w[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kN; ++w) {
      lo = min(lo, lo_w[w]);
      hi = max(hi, hi_w[w]);
    }
}

// Exclusive prefix of v over a block of kN warps (at most 32); total is
// the block's sum.  Every thread of the block calls it.  It ends in a
// barrier, so warp_sums may be reused at once.
template <int kN>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kN ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kN) warp_sums[lane] = w;
  }
  __syncthreads();
  const int prefix = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  total = warp_sums[kN - 1];
  __syncthreads();
  return prefix;
}

// Warp-aggregated claim on shared counters: the lanes of a warp with the
// same bucket b (found with one __match_any_sync) add their count to
// counters[b] with one atomic by the group's leader, and each lane gets
// the counter's old value plus its rank among its lower peers.  On a hot
// bucket (Zipf keys) a warp makes one shared update, not 32 conflicting
// atomics.  Every lane of the warp calls it; b < 0 claims nothing.
__device__ __forceinline__ int warp_claim(int* counters, int b) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, b);
  const int leader = __ffs(peers) - 1;
  int first = 0;
  if (b >= 0 && lane == leader) first = atomicAdd(&counters[b], __popc(peers));
  return __shfl_sync(kFull, first, leader) +
         __popc(peers & ((1u << lane) - 1u));
}

}  // namespace tile_sort
