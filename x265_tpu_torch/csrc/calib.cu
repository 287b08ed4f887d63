// Yardsticks for the kernels' times. Nothing on the encoder's path calls
// them; chip_smoke.py does, to say what a measured time is held against.
//
//   x265_calib_empty_grid  an empty kernel with a given grid, block size and
//                          dynamic shared memory: what launching and
//                          scheduling a kernel of that shape costs.
//   x265_calib_sad_rate    the rate at which the card executes the two
//                          instructions the SAD kernels run on: vabsdiff4
//                          with accumulate (four byte differences and their
//                          sum, kind 4) and the scalar __sad (one difference,
//                          kind 1). Every thread runs kChains independent
//                          chains, each instruction taking the one before it
//                          as operand and addend, so nothing is hoisted or
//                          folded, with enough warps resident to hide the
//                          instruction's latency. Instructions executed:
//                          blocks * threads * iters * kChains.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;

extern __shared__ uint32_t dyn_smem[];

__global__ void empty_kernel(uint32_t* sink) {
  if (sink != nullptr) sink[0] = dyn_smem[threadIdx.x];   // never taken
}

template <int KIND>
__global__ void sad_rate_kernel(uint32_t* __restrict__ out, uint32_t seed,
                                 int iters) {
  uint32_t acc[kChains];
#pragma unroll
  for (int k = 0; k < kChains; ++k)
    acc[k] = seed + threadIdx.x * 0x01010101u + k * 0x00030507u;
  const uint32_t b = seed ^ 0x5a3c96e1u;
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kChains; ++k) {
      if (KIND == 4) {
        asm volatile("vabsdiff4.u32.u32.u32.add %0, %0, %1, %0;"
                     : "+r"(acc[k]) : "r"(b));
      } else {
        acc[k] = __sad((int)acc[k], (int)b, acc[k]);
      }
    }
  }
  uint32_t s = 0u;
#pragma unroll
  for (int k = 0; k < kChains; ++k) s ^= acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int x265_calib_empty_grid(int blocks, int threads, int smem,
                                     void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024 || smem < 0 ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(nullptr);
  return (int)cudaGetLastError();
}

// out: blocks * threads uint32. Returns through *chains the chains a thread
// runs, so the caller counts instructions without knowing the source.
extern "C" int x265_calib_sad_rate(void* out, int kind, int blocks,
                                    int threads, int iters, int* chains,
                                    void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024 || iters < 1 ||
      (kind != 1 && kind != 4))
    return (int)cudaErrorInvalidValue;
  if (chains != nullptr) *chains = kChains;
  cudaStream_t st = (cudaStream_t)stream;
  if (kind == 4)
    sad_rate_kernel<4><<<blocks, threads, 0, st>>>((uint32_t*)out, 0x1234567u,
                                                   iters);
  else
    sad_rate_kernel<1><<<blocks, threads, 0, st>>>((uint32_t*)out, 0x1234567u,
                                                   iters);
  return (int)cudaGetLastError();
}
