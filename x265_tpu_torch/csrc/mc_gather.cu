// Motion compensation: per-lane window gather + separable HEVC
// interpolation (8-tap luma / 4-tap chroma), 14-bit output.
//
// Replaces the TPU kernel mc_gather_interp (_mc_kernel) of
// x265_tpu/ops/pallas_mc.py. What it computes, per lane j:
//   win  = planes[ridx[j], oy[j] : oy[j]+side, ox[j] : ox[j]+side]
//   hor[r][c] = (sum_t filt[xf[j]][t] * win[r][c+t]) >> (bd-8)
//   out[r][c] = (sum_t filt[yf[j]][t] * hor[r+t][c]) >> 6
// with side = n + taps - 1, int32 intermediates, arithmetic shifts.
// ridx, the origins and the phases are clipped into range first (the
// dynamic_slice clamp of the reference), so no lane reads outside.
//
// Bound: bytes (a lane reads side^2 int16s and writes n^2 int32s for
// 2*taps multiply-adds per output). Design: one block per lane; the
// window is staged once in shared memory as int32, the horizontal pass
// writes a second shared array, the vertical pass writes the output
// with contiguous stores. Shared memory is sized per launch (dynamic):
// 11 KB at n=32, taps=8 (side=39), so many lanes are resident per SM,
// and 38 KB for the largest case, a 64x64 CU (side=71).
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SIDE 71
#define MAX_N 64
#define MAX_TAPS 8

__global__ void mc_gather_kernel(const int16_t* __restrict__ planes,
                                 const int32_t* __restrict__ ridx,
                                 const int32_t* __restrict__ oy,
                                 const int32_t* __restrict__ ox,
                                 const int32_t* __restrict__ xf,
                                 const int32_t* __restrict__ yf,
                                 const int32_t* __restrict__ filt,
                                 int32_t* __restrict__ out,
                                 int n, int taps, int bd, int R, int nphase,
                                 int Hp, int Wp) {
  extern __shared__ int32_t sm[];         // win[side*side], hor[side*n]
  __shared__ int32_t fx[MAX_TAPS];
  __shared__ int32_t fy[MAX_TAPS];
  const int lane = blockIdx.x;
  const int side = n + taps - 1;
  int32_t* win = sm;
  int32_t* hor = sm + side * side;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int16_t* src =
      planes + (long long)min(max(ridx[lane], 0), R - 1) * Hp * Wp
      + (long long)min(max(oy[lane], 0), Hp - side) * Wp
      + min(max(ox[lane], 0), Wp - side);
  if (tid < taps) {
    fx[tid] = filt[min(max(xf[lane], 0), nphase - 1) * taps + tid];
    fy[tid] = filt[min(max(yf[lane], 0), nphase - 1) * taps + tid];
  }
  for (int i = tid; i < side * side; i += nt) {
    const int r = i / side;
    const int c = i - r * side;
    win[i] = (int32_t)src[(long long)r * Wp + c];
  }
  __syncthreads();
  const int sh1 = bd - 8;
  for (int i = tid; i < side * n; i += nt) {
    const int r = i / n;
    const int c = i - r * n;
    int32_t acc = 0;
    for (int t = 0; t < taps; ++t) acc += fx[t] * win[r * side + c + t];
    hor[i] = acc >> sh1;
  }
  __syncthreads();
  int32_t* dst = out + (long long)lane * n * n;
  for (int i = tid; i < n * n; i += nt) {
    const int r = i / n;
    const int c = i - r * n;
    int32_t acc = 0;
    for (int t = 0; t < taps; ++t) acc += fy[t] * hor[(r + t) * n + c];
    dst[i] = acc >> 6;
  }
}

extern "C" int x265_mc_gather_interp(const void* planes, const void* ridx,
                                     const void* oy, const void* ox,
                                     const void* xf, const void* yf,
                                     const void* filt, void* out, int N,
                                     int n, int taps, int bd, int R,
                                     int nphase, int Hp, int Wp,
                                     void* stream) {
  if (N == 0) return 0;
  if (n > MAX_N || taps > MAX_TAPS || n + taps - 1 > MAX_SIDE || bd < 8)
    return (int)cudaErrorInvalidValue;
  int threads = n * n;
  if (threads < 32) threads = 32;
  if (threads > 256) threads = 256;
  const int side = n + taps - 1;
  const size_t smem = (size_t)(side * side + side * n) * sizeof(int32_t);
  mc_gather_kernel<<<N, threads, smem, (cudaStream_t)stream>>>(
      (const int16_t*)planes, (const int32_t*)ridx, (const int32_t*)oy,
      (const int32_t*)ox, (const int32_t*)xf, (const int32_t*)yf,
      (const int32_t*)filt, (int32_t*)out, n, taps, bd, R, nphase, Hp, Wp);
  return (int)cudaGetLastError();
}
