// Device code shared by apply_ops.cu (K11) and rebalance.cu (K12): the
// threefry-2x32 hash of core/prng.py and the tower height a key's bits draw
// (core/skiplist.py sample_heights).
//
// core/prng.py's partitionable scheme: split(key) hashes the flat indices
// 0 and 1 (hi word 0, lo word the index) under the key, each hash pair a new
// key; bits(key, (N,)) hashes 0 .. N-1 and returns each pair XORed.  A
// height is 1 + the trailing one-bits of those bits, mapped through the
// reference's float32-log2 ctz table (ref_ctz, core/skiplist.py _REF_CTZ,
// passed in by the wrappers), capped at the levels.  Each .cu file compiles
// alone, so this header holds inline device functions only.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned rotl(unsigned v, int r) {
  return (v << r) | (v >> (32 - r));
}

// Threefry-2x32, 20 rounds (core/prng.py threefry2x32).
__device__ __forceinline__
uint2 threefry2x32(unsigned k0, unsigned k1, unsigned x0, unsigned x1) {
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

// The tower height of one draw: the hash pair (x, y) of bits' index.
__device__ __forceinline__
int tower_height(uint2 h, int levels, const int* ref_ctz) {
  const unsigned ones = ~(h.x ^ h.y);          // trailing one-bits of bits
  const int exact = ones == 0u ? 32 : __ffs((int)ones) - 1;
  return min(ref_ctz[exact] + 1, levels);
}

// split(rng) = (rng', sub): the tower height drawn from key (k0, k1)'s sub.
__device__ __forceinline__
int draw_height(unsigned k0, unsigned k1, int levels, const int* ref_ctz) {
  const uint2 sub = threefry2x32(k0, k1, 0u, 1u);
  return tower_height(threefry2x32(sub.x, sub.y, 0u, 0u), levels, ref_ctz);
}
