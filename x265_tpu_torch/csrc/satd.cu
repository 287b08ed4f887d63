// SATD (sa8d form): sum |H8 * D * H8^T| >> 2 per 8x8 sub-block of a - b,
// the shifted sums added over the 8x8 sub-blocks of every S x S block.
//
// Replaces the TPU kernel satd8x8_pallas (_satd8_kernel) of
// x265_tpu/ops/pallas_kernels.py, which runs the two-sided Hadamard as
// one fp32 64x64 Kronecker matmul on the matrix unit. Here it is exact
// int32 butterflies: no multiplies, no tensor cores. The butterflies'
// row order differs from the reference matrix only by a permutation,
// which the sum of absolute values does not see.
//
// Bound: bytes (each operand read once, ~450 integer operations per 64
// samples). Two entries:
//   x265_satd8        a, b int32 [N, S, S] (engine.me.satd8_batched:
//                     tuple_satd, _bi_satd);
//   x265_satd8_intra  a int16 [N, 8, 8] against zero (the lookahead's and
//                     the pair costs' intra cost of DC-removed lowres
//                     blocks): a quarter of the two-operand entry's bytes.
//
// Design: EIGHT LANES PER 8x8 SUB-BLOCK, ONE ROW PER LANE. A lane loads its
// row (int32: two 16-byte loads per operand; int16: one), so the eight
// lanes of a sub-block read its bytes contiguously at S = 8. The row
// transform runs in the lane's registers (had8); the column transform runs
// across the eight lanes as xor butterflies (had8_lanes_abs_sum), which
// also reduces the absolute sums; the sub-block's sum is shifted >> 2 there,
// before any sum over sub-blocks. At S = 8 a warp holds four blocks, at
// S = 16 one block (its four sub-blocks summed by two more shuffles), at
// larger S one 128-thread CTA holds a block and sums its sub-blocks in
// shared memory. Every output is written once, by a plain store: no
// atomics, so the wrapper hands in an uninitialised output. A thread keeps
// eight values live (the one-thread-per-sub-block design it replaces kept
// 64 and launched an eighth of the threads: 64 CTAs for the lookahead's
// 8160 blocks on 132 SMs). Lanes past the last block compute on zeros and
// store nothing, so every shuffle runs with the full mask.
#include <cuda_runtime.h>
#include <stdint.h>

#include "had8.cuh"      // had8, had8_lanes_abs_sum

namespace {

constexpr int kThreads = 128;

// Row `r` of the difference block whose row 0 starts at element `off`:
// a - b (int32 operands, 2 x 16-byte loads each) or a (int16, 1 load).
template <bool INTRA>
__device__ __forceinline__ void load_row(const void* a, const void* b,
                                         long long off, bool valid,
                                         int32_t* v) {
  if (!valid) {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0;
    return;
  }
  if (INTRA) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(
        static_cast<const int16_t*>(a) + off));
    const uint32_t u[4] = {(uint32_t)w.x, (uint32_t)w.y, (uint32_t)w.z,
                           (uint32_t)w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = (int32_t)(int16_t)(u[j] & 0xffffu);
      v[2 * j + 1] = (int32_t)u[j] >> 16;
    }
  } else {
    const int4* pa =
        reinterpret_cast<const int4*>(static_cast<const int32_t*>(a) + off);
    const int4* pb =
        reinterpret_cast<const int4*>(static_cast<const int32_t*>(b) + off);
    const int4 a0 = __ldg(pa), a1 = __ldg(pa + 1);
    const int4 b0 = __ldg(pb), b1 = __ldg(pb + 1);
    v[0] = a0.x - b0.x; v[1] = a0.y - b0.y;
    v[2] = a0.z - b0.z; v[3] = a0.w - b0.w;
    v[4] = a1.x - b1.x; v[5] = a1.y - b1.y;
    v[6] = a1.z - b1.z; v[7] = a1.w - b1.w;
  }
}

// The shifted sa8d of the 8x8 sub-block at element `org` (row pitch S), in
// all eight lanes of the calling group; `row` = lane & 7.
template <bool INTRA>
__device__ __forceinline__ int32_t sub_satd(const void* a, const void* b,
                                            long long org, int S, int row,
                                            bool valid) {
  int32_t v[8];
  load_row<INTRA>(a, b, org + (long long)row * S, valid, v);
  had8(v);
  return had8_lanes_abs_sum(v, row) >> 2;   // >= 0: >> 2 is // 4
}

// KK = sub-blocks per block: 1 (S = 8), 4 (S = 16), 0 (any larger S).
template <bool INTRA, int KK>
__global__ void __launch_bounds__(kThreads)
satd8_kernel(const void* __restrict__ a, const void* __restrict__ b,
             int32_t* __restrict__ out, int N, int S) {
  const int lane = threadIdx.x & 31;
  const int row = lane & 7;
  if (KK == 1) {
    const long long n = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 3;
    const bool valid = n < N;
    const int32_t s = sub_satd<INTRA>(a, b, valid ? n * 64 : 0, 8, row,
                                      valid);
    if (valid && row == 0) out[n] = s;
  } else if (KK == 4) {
    const long long n = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
    const bool valid = n < N;
    const int sub = lane >> 3;
    const long long org =
        valid ? n * 256 + (sub >> 1) * 8 * 16 + (sub & 1) * 8 : 0;
    int32_t s = sub_satd<INTRA>(a, b, org, 16, row, valid);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (valid && lane == 0) out[n] = s;
  } else {
    // one block a CTA: its 16 groups of eight lanes walk the sub-blocks
    __shared__ int32_t warp_sum[kThreads / 32];
    const int k = S >> 3;
    const int kk = k * k;
    const long long n = blockIdx.x;
    const int grp = threadIdx.x >> 3;
    int32_t acc = 0;
    for (int s0 = 0; s0 < kk; s0 += kThreads / 8) {
      const int sub = s0 + grp;
      const bool valid = sub < kk;
      const int by = valid ? sub / k : 0, bx = valid ? sub - by * k : 0;
      acc += sub_satd<INTRA>(
          a, b, n * S * S + (long long)(by * 8) * S + bx * 8, S, row, valid);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 8);
    acc += __shfl_xor_sync(0xffffffffu, acc, 16);
    if (lane == 0) warp_sum[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      int32_t t = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) t += warp_sum[w];
      out[n] = t;
    }
  }
}

template <bool INTRA>
int launch(const void* a, const void* b, void* out, int N, int S,
           void* stream) {
  if (N == 0) return 0;
  if (N < 0 || S < 8 || (S & 7) ||
      (reinterpret_cast<uintptr_t>(a) & 15) ||
      (!INTRA && (reinterpret_cast<uintptr_t>(b) & 15)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* o = static_cast<int32_t*>(out);
  if (S == 8) {
    const long long threads = (long long)N * 8;
    satd8_kernel<INTRA, 1><<<(int)((threads + kThreads - 1) / kThreads),
                             kThreads, 0, st>>>(a, b, o, N, S);
  } else if (S == 16) {
    const long long threads = (long long)N * 32;
    satd8_kernel<INTRA, 4><<<(int)((threads + kThreads - 1) / kThreads),
                             kThreads, 0, st>>>(a, b, o, N, S);
  } else {
    satd8_kernel<INTRA, 0><<<N, kThreads, 0, st>>>(a, b, o, N, S);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a, b int32 [N, S, S] (S a multiple of 8), 16-byte aligned -> out[N].
extern "C" int x265_satd8(const void* a, const void* b, void* out, int N,
                          int S, void* stream) {
  return launch<false>(a, b, out, N, S, stream);
}

// a int16 [N, 8, 8], 16-byte aligned, against zero -> out[N].
extern "C" int x265_satd8_intra(const void* a, void* out, int N,
                                void* stream) {
  return launch<true>(a, nullptr, out, N, 8, stream);
}
