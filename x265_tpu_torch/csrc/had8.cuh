// The 8-point Hadamard butterflies behind every SATD of the port, in one
// place: satd.cu (blocks already in memory) and tile_gather.cu (blocks
// gathered from the phase planes and scored without being written out)
// both include this file, so there is one had8 and one definition of the
// sa8d sum.
//
// The sum is the one x265_tpu/ops/pallas_kernels.py (_satd8_kernel) and its
// jnp twin engine.me.satd8_batched define: sum |H8 * D * H8^T| over an 8x8
// difference block, in exact int32. The butterfly's row order differs from
// the reference matrix only by a permutation, which a sum of absolute
// values does not see. The caller shifts the sum right by 2 PER 8x8 block
// before adding blocks together; that order fixes the low bits.
#pragma once
#include <stdint.h>

// In-place 8-point Hadamard transform of v[0..7]: 24 adds, no multiplies.
__device__ __forceinline__ void had8(int32_t* v) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; i += 2 * h) {
#pragma unroll
      for (int j = i; j < i + h; ++j) {
        const int32_t a = v[j], b = v[j + h];
        v[j] = a + b;
        v[j + h] = a - b;
      }
    }
  }
}

// d[64] holds an 8x8 block, row-major, whose ROWS have been through had8.
// Transforms the columns and returns the sum of absolute values (>= 0).
__device__ __forceinline__ int32_t had8_columns_abs_sum(const int32_t* d) {
  int32_t s = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int32_t col[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) col[r] = d[r * 8 + c];
    had8(col);
#pragma unroll
    for (int r = 0; r < 8; ++r) s += col[r] < 0 ? -col[r] : col[r];
  }
  return s;
}

// The same transform and sum with one ROW of the 8x8 block in each of eight
// consecutive lanes of a warp (lane & 7 = row). v holds the lane's row,
// already through had8; the columns are transformed across the eight lanes
// by xor butterflies on the lane index (the stages of had8, one stage a
// bit), and the eight lanes' absolute sums are reduced the same way.
// Returns the block's sum (>= 0) in all eight lanes. Every lane of the warp
// must call it (full-mask shuffles): a lane without a block passes zeros.
__device__ __forceinline__ int32_t had8_lanes_abs_sum(int32_t* v, int row) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1) {
    const bool hi = (row & h) != 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int32_t o = __shfl_xor_sync(0xffffffffu, v[j], h);
      v[j] = hi ? o - v[j] : v[j] + o;    // (a, b) -> (a + b, a - b)
    }
  }
  int32_t s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += v[j] < 0 ? -v[j] : v[j];
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}
