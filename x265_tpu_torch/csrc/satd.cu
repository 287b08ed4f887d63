// SATD (sa8d form): sum |H8 * D * H8^T| / 4 per 8x8 block of a - b,
// summed over the 8x8 sub-blocks of every S x S block.
//
// Replaces the TPU kernel satd8x8_pallas (_satd8_kernel) of
// x265_tpu/ops/pallas_kernels.py, which runs the two-sided Hadamard as
// one fp32 64x64 Kronecker matmul on the matrix unit. Here it is exact
// int32 butterflies in registers: 2 * 8 * 24 adds per block, no
// multiplies, no tensor cores. The row order of the butterfly's
// Hadamard differs from the reference matrix only by a permutation,
// which the sum of absolute values does not see.
//
// Bound: bytes (two 256-byte reads per 8x8 block for ~450 integer
// operations). Design: one thread per 8x8 sub-block; a row is two
// 16-byte loads per operand, so every 32-byte sector fetched is used
// whole. Sub-block sums are added into the S x S block's output with an
// integer atomicAdd (exact and order-independent); the wrapper hands
// in a zeroed output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "had8.cuh"      // had8, had8_columns_abs_sum

__global__ void satd8_kernel(const int32_t* __restrict__ a,
                             const int32_t* __restrict__ b,
                             int32_t* __restrict__ out, long long nsub,
                             int S) {
  const int k = S >> 3;
  const int kk = k * k;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < nsub; i += (long long)gridDim.x * blockDim.x) {
    const long long lane = i / kk;
    const int sub = (int)(i - lane * kk);
    const int by = sub / k;
    const int bx = sub - by * k;
    const long long base = lane * S * S + (long long)(by * 8) * S + bx * 8;
    int32_t d[64];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int4* pa = reinterpret_cast<const int4*>(a + base + r * S);
      const int4* pb = reinterpret_cast<const int4*>(b + base + r * S);
      const int4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
      d[r * 8 + 0] = a0.x - b0.x; d[r * 8 + 1] = a0.y - b0.y;
      d[r * 8 + 2] = a0.z - b0.z; d[r * 8 + 3] = a0.w - b0.w;
      d[r * 8 + 4] = a1.x - b1.x; d[r * 8 + 5] = a1.y - b1.y;
      d[r * 8 + 6] = a1.z - b1.z; d[r * 8 + 7] = a1.w - b1.w;
      had8(d + r * 8);
    }
    const int32_t s = had8_columns_abs_sum(d);
    atomicAdd(out + lane, s >> 2);       // s >= 0: >> 2 is // 4
  }
}

extern "C" int x265_satd8(const void* a, const void* b, void* out, int N,
                          int S, void* stream) {
  if (N == 0) return 0;
  if (S < 8 || (S & 7)) return (int)cudaErrorInvalidValue;
  const int k = S >> 3;
  const long long nsub = (long long)N * k * k;
  const int threads = 128;
  long long blocks = (nsub + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  satd8_kernel<<<(int)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (int32_t*)out, nsub, S);
  return (int)cudaGetLastError();
}
