// Tile gathers: per-lane n x n windows copied out of int16 planes.
//
// Replaces the TPU kernels tile_gather (_copy_kernel) and
// tile_gather_planes (_copy3_kernel) of x265_tpu/ops/pallas_mc.py.
// Those fetch a tiling-aligned DMA tile per lane and undo the alignment
// with two rolls; here a thread reads its element straight from global
// memory at any offset, so none of that machinery exists.
//
// Bound: bytes. Each output element is one 2-byte read and one 4-byte
// write; there is no arithmetic to speak of. Design: one thread per
// OUTPUT element in flat order, so the 4-byte stores of a warp are
// contiguous and its loads run along a window row (n contiguous
// int16s, then the next row). Origins are small per-lane arrays that
// stay in L1/L2. Origins and plane indices are clipped into range here
// (the dynamic_slice clamp the callers rely on), so no lane can read
// outside the planes whatever it is given.
#include <cuda_runtime.h>
#include <stdint.h>

template <bool kPlanes>
__global__ void tile_gather_kernel(const int16_t* __restrict__ planes,
                                   const int32_t* __restrict__ ridx,
                                   const int32_t* __restrict__ oy,
                                   const int32_t* __restrict__ ox,
                                   int32_t* __restrict__ out,
                                   long long total, int n, int P, int Hp,
                                   int Wp) {
  const int nn = n * n;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int lane = (int)(i / nn);
    const int rem = (int)(i - (long long)lane * nn);
    const int r = rem / n;
    const int c = rem - r * n;
    const int y0 = min(max(oy[lane], 0), Hp - n);
    const int x0 = min(max(ox[lane], 0), Wp - n);
    long long base = 0;
    if (kPlanes) base = (long long)min(max(ridx[lane], 0), P - 1) * Hp * Wp;
    out[i] = (int32_t)planes[base + (long long)(y0 + r) * Wp + x0 + c];
  }
}

static int launch_dims(long long total, int* blocks) {
  const int threads = 256;
  long long b = (total + threads - 1) / threads;
  if (b > (1LL << 20)) b = 1LL << 20;       // grid-stride covers the rest
  if (b < 1) b = 1;
  *blocks = (int)b;
  return threads;
}

extern "C" int x265_tile_gather(const void* plane, const void* oy,
                                const void* ox, void* out, int N, int n,
                                int Hp, int Wp, void* stream) {
  long long total = (long long)N * n * n;
  if (total == 0) return 0;
  int blocks;
  int threads = launch_dims(total, &blocks);
  tile_gather_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)plane, nullptr, (const int32_t*)oy,
      (const int32_t*)ox, (int32_t*)out, total, n, 1, Hp, Wp);
  return (int)cudaGetLastError();
}

extern "C" int x265_tile_gather_planes(const void* planes, const void* ridx,
                                       const void* oy, const void* ox,
                                       void* out, int N, int n, int P, int Hp,
                                       int Wp, void* stream) {
  long long total = (long long)N * n * n;
  if (total == 0) return 0;
  int blocks;
  int threads = launch_dims(total, &blocks);
  tile_gather_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)planes, (const int32_t*)ridx, (const int32_t*)oy,
      (const int32_t*)ox, (int32_t*)out, total, n, P, Hp, Wp);
  return (int)cudaGetLastError();
}
