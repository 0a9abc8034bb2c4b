// K9, the fat-node postlude, for Hopper (sm_90a): device code that
// csrc/traverse.cu (K1-K6 with fat_keys, and K9 alone) and
// csrc/search_walk.cu (K14 on fat lists) include.
//
// Replaces the reference's _fat_resolve (repro/kernels/foresight_traverse.py
// :223), the postlude of its K1-K6.  From a walk's final predecessor x and
// its level-0 record (cand, ck) it finds the query's run and its position
// in it; traverse.cu's head comment sets out the tiling and what bounds it.
// Each .cu file compiles alone, so this header holds inline device code
// only.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace k9 {

constexpr int kKeyMax = 0x7fffffff;
constexpr unsigned kFullMask = 0xffffffffu;

// K9, warp-cooperative.  EVERY lane of the warp calls it together (no lane
// may have returned: the kernels keep lanes past the batch or not served as
// need == false, and a full-mask ballot needs all 32).  A lane with need
// holds (query q, final predecessor x, its level-0 record cand) and the base
// `fat` of its table [cap, width]; it gets (element-flat node, key).  A lane
// without need gets (0, 0) and is never resolved.
//
// Tiling: a row is read by g threads (the least power of two with 4 * g >=
// width, at most 32), thread j taking elements 4j..4j+3 of each 4 * g, so
// one load instruction covers 16 * g contiguous bytes of a row; 32 / g rows
// are resolved a step (B = 128: one row, four whole 128-B lines; B = 8:
// sixteen 32-B rows).  Step by step the warp's slots take the lowest lanes
// still pending, broadcast their row and query (__shfl_sync), load the rows
// (int4 on a 16-byte-aligned row, else 4-byte loads of the same elements),
// count each thread's elements < q, sum the count over the group (one
// __reduce_add_sync) and hand it to the requesting lane.  Last, each lane
// reads its key at min(pos, width - 1), from a line the warp has just read.
// Nothing is held across steps but the count, so the walks that call K9
// keep the registers they had with the per-thread compare it replaced
// (31-36 a thread; ptxas -v).
__device__ __forceinline__ int2 fat_resolve(const int* __restrict__ fat,
                                            int width, int q, int x,
                                            int2 cand, bool need) {
  const int owner = (cand.y == q || x == 0) ? cand.x : x;
  const int* row = fat + (size_t)owner * (size_t)width;
  const int lane = threadIdx.x & 31;
  int g = 1;
  while (g < 32 && 4 * g < width) g <<= 1;
  const int rows = 32 / g;                      // rows resolved a step
  const int slot = lane / g, sub = lane & (g - 1);
  const unsigned gmask = g == 32 ? kFullMask
                                 : ((1u << g) - 1u) << (slot * g);
  int pos = 0;
  unsigned pending = __ballot_sync(kFullMask, need);
  while (pending) {
    unsigned m = pending;               // slot s serves the s-th lowest lane
    for (int s = 0; s < slot; ++s) m &= m - 1;
    const bool active = m != 0;
    const int src = active ? __ffs(m) - 1 : lane;
    const int* r = reinterpret_cast<const int*>(__shfl_sync(
        kFullMask, reinterpret_cast<unsigned long long>(row), src));
    const int rq = __shfl_sync(kFullMask, q, src);
    const bool vec = (reinterpret_cast<uintptr_t>(r) & 15) == 0;
    int cnt = 0;
    for (int e = 4 * sub; active && e < width; e += 4 * g) {
      const int n = min(4, width - e);          // elements held, 1..4
      int4 v;
      if (n == 4 && vec) {
        v = __ldg(reinterpret_cast<const int4*>(r + e));
      } else {
        v.x = __ldg(r + e);
        v.y = n > 1 ? __ldg(r + e + 1) : 0;
        v.z = n > 2 ? __ldg(r + e + 2) : 0;
        v.w = n > 3 ? __ldg(r + e + 3) : 0;
      }
      cnt += (v.x < rq) + (n > 1 && v.y < rq) + (n > 2 && v.z < rq) +
             (n > 3 && v.w < rq);
    }
    cnt = __reduce_add_sync(gmask, cnt);                 // the group's sum
    // lane i was served by the slot of its rank among the pending lanes
    const int rank = __popc(pending & ((1u << lane) - 1u));
    const int got = __shfl_sync(kFullMask, cnt, min(rank, rows - 1) * g);
    if (((pending >> lane) & 1u) && rank < rows) pos = got;
    for (int s = 0; s < rows; ++s) pending &= pending - 1;
  }
  if (!need) return make_int2(0, 0);
  const int pos_c = min(pos, width - 1);
  return make_int2(owner * width + pos_c,
                   pos < width ? __ldg(row + pos_c) : kKeyMax);
}

}  // namespace k9
