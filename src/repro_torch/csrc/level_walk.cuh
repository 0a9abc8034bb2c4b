// The ordered gather of a skiplist's level-0 range, top-down, for Hopper
// (sm_90a): device code that csrc/rebalance.cu (K12's flatten) and
// csrc/range_scan.cu (K13's long scans) include.
//
// A range starts at a node x_0 standing on level l and ends before a node
// `end` or at the first key >= hi.  Its level-l nodes x_0 < x_1 < ... (the
// frontier) cut it into segments [x_i, x_{i+1}); x_{i+1} also stands on
// every level below, so a walk of level l - 1 from x_i stops on its id.
// gather() works down one level at a time with a team of threads (a warp or
// the cooperative grid):
//   - each thread takes a contiguous share of the frontier (one segment
//     while the frontier is no longer than the team) and walks level l - 1
//     from its first node to the next share's first node, counting the
//     nodes the caller keeps (Ops::weight);
//   - an exclusive prefix sum over the team places every share (a team
//     barrier: every thread has read its two bounds before it);
//   - a second walk, over lines the first brought in, writes the kept
//     nodes in order over the frontier; at level 0 it hands each node, its
//     key and its position to Ops::emit instead.
// The frontier holds at most `room` nodes: past it the node at position
// `room` is kept as the new end of the range, so the walks past the cut
// stop there.  Towers follow ctz, so level l holds about n / 2^l nodes and a
// segment averages two: the dependent chain shrinks from one load a node to
// about 2 * n_l / T loads a level (T threads, n_l the level's nodes) and
// two walks and a barrier a level.  Every walk runs under max_steps and
// traps past it: a corrupt table fails the launch, never hangs.
//
// Ops, the caller's view of one list, provides
//   int2 rec(int l, int x)       node x's level-l record: (successor, key)
//   int key(int x)               node x's key (a share's first node)
//   long long weight(int l, int y, int key)
//                                what node y counts for: 0 or 1 above
//                                level 0 (dropped or kept), any count at 0
//   void emit(int y, int key, long long pos)
//                                a kept level-0 node at its position

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace level_walk {

namespace cg = cooperative_groups;

constexpr int kLanes = 32;
constexpr unsigned kAllLanes = 0xffffffffu;

// Inclusive prefix sum over the 32 lanes of a warp (every lane calls).
__device__ __forceinline__ long long warp_inclusive(long long v) {
  const int lane = threadIdx.x & (kLanes - 1);
  for (int d = 1; d < kLanes; d <<= 1) {
    const long long o = __shfl_up_sync(kAllLanes, v, d);
    if (lane >= d) v += o;
  }
  return v;
}

// Exclusive prefix sum over a block (blockDim.x a multiple of 32, every
// thread calls); the block's total in `total`.
__device__ __forceinline__ long long block_exclusive(long long v,
                                                     long long& total) {
  __shared__ long long s_warp[kLanes + 1];
  const int lane = threadIdx.x & (kLanes - 1), w = threadIdx.x / kLanes;
  const int nw = blockDim.x / kLanes;
  const long long inc = warp_inclusive(v);
  if (lane == kLanes - 1) s_warp[w] = inc;
  __syncthreads();
  if (w == 0) {
    const long long x = lane < nw ? s_warp[lane] : 0;
    const long long xi = warp_inclusive(x);
    if (lane < nw) s_warp[lane] = xi - x;
    if (lane == kLanes - 1) s_warp[kLanes] = xi;
  }
  __syncthreads();
  const long long out = s_warp[w] + inc - v;
  total = s_warp[kLanes];
  __syncthreads();                        // s_warp is reused by the next call
  return out;
}

// The teams: rank, size, a barrier with memory ordering, and an exclusive
// prefix sum that is also a barrier.
struct Warp {
  __device__ long long rank() const { return threadIdx.x & (kLanes - 1); }
  __device__ long long size() const { return kLanes; }
  __device__ void sync() const { __syncwarp(); }
  __device__ long long scan(long long v, long long& total) const {
    const long long inc = warp_inclusive(v);
    total = __shfl_sync(kAllLanes, inc, kLanes - 1);
    __syncwarp();
    return inc - v;
  }
};

// The cooperative grid; sums holds gridDim.x partial sums.
struct Grid {
  cg::grid_group grid;
  long long* sums;
  __device__ long long rank() const {
    return (long long)blockIdx.x * blockDim.x + threadIdx.x;
  }
  __device__ long long size() const {
    return (long long)gridDim.x * blockDim.x;
  }
  __device__ void sync() const { grid.sync(); }
  __device__ long long scan(long long v, long long& total) const {
    __shared__ long long s_pre[2];
    long long block_total;
    const long long ex = block_exclusive(v, block_total);
    if (threadIdx.x == 0) sums[blockIdx.x] = block_total;
    grid.sync();
    if (threadIdx.x < kLanes) {
      long long pre = 0, all = 0;
      for (unsigned b = threadIdx.x; b < gridDim.x; b += kLanes) {
        const long long x = sums[b];
        all += x;
        if (b < blockIdx.x) pre += x;
      }
      for (int d = kLanes / 2; d > 0; d >>= 1) {
        pre += __shfl_xor_sync(kAllLanes, pre, d);
        all += __shfl_xor_sync(kAllLanes, all, d);
      }
      if (threadIdx.x == 0) {
        s_pre[0] = pre;
        s_pre[1] = all;
      }
    }
    __syncthreads();
    total = s_pre[1];
    const long long out = s_pre[0] + ex;
    __syncthreads();                      // s_pre is reused by the next call
    return out;
  }
};

// Walks level l from x (key kx): visit(y, key) for x and every node after
// it, until the successor is `stop` or keyed >= hi.
template <class Ops, class Visit>
__device__ __forceinline__ void walk(const Ops& ops, int l, int x, int kx,
                                     int stop, int hi, long long max_steps,
                                     Visit&& visit) {
  for (long long steps = 1;; ++steps) {
    visit(x, kx);
    if (steps > max_steps) __trap();       // a corrupt table
    const int2 r = ops.rec(l, x);
    if (r.x == stop || r.y >= hi) return;
    x = r.x;
    kx = r.y;
  }
}

// The gather: front[0, nf) holds the range's level-`level` nodes in order,
// front[0] given as `first` (front[0] itself is not read); front holds room
// + 1 ints.  Calls ops.emit for every kept level-0 node and returns the
// level-0 total of the weights.  Every thread of the team calls it.
template <class Team, class Ops>
__device__ long long gather(const Team& team, const Ops& ops, int* front,
                            int first, long long nf, int level, int end,
                            int hi, long long room, long long max_steps) {
  bool cut = false;
  for (int l = level - 1; l >= 0; --l) {
    const long long T = team.size(), r = team.rank();
    long long a, b;
    if (nf <= T) {
      a = min(r, nf);
      b = min(r + 1, nf);
    } else {
      a = r * nf / T;
      b = (r + 1) * nf / T;
    }
    const bool mine = a < b;
    int x = 0, kx = 0, stop = end;
    if (mine) {
      x = (a == 0 && l == level - 1) ? first : front[a];
      kx = ops.key(x);
      if (b < nf) stop = front[b];
      else if (cut) stop = front[nf];
    }
    long long n = 0;
    if (mine)
      walk(ops, l, x, kx, stop, hi, max_steps,
           [&](int y, int ky) { n += ops.weight(l, y, ky); });
    long long total;
    long long pos = team.scan(n, total);
    if (mine)
      walk(ops, l, x, kx, stop, hi, max_steps, [&](int y, int ky) {
        const long long w = ops.weight(l, y, ky);
        if (w == 0) return;
        if (l > 0) {
          if (pos <= room) front[pos] = y;
        } else {
          ops.emit(y, ky, pos);
        }
        pos += w;
      });
    team.sync();
    if (l > 0) {
      cut = total > room;
      nf = cut ? room : total;
    } else {
      nf = total;
    }
  }
  return nf;
}

}  // namespace level_walk
