// Tile gathers: per-lane n x n windows copied out of int16 planes into
// [N, n, n] int32, and the same gather fused with the SATD that consumes it.
//
// Replaces the TPU kernels tile_gather (_copy_kernel) and
// tile_gather_planes (_copy3_kernel) of x265_tpu/ops/pallas_mc.py. Those
// fetch a tiling-aligned DMA tile per lane and undo the alignment with two
// rolls. A GPU thread can read global memory at any 2-byte offset, so none
// of that machinery exists here; what is left is a copy with widening, and
// the only question is how little work per byte moves it.
//
// Bound: bytes (each window element is one 2-byte read and one 4-byte
// write, no arithmetic). An element-per-thread copy does not come near
// that bound: it pays a 64-bit division, two 32-bit divisions, three index
// loads and two clips for every 6 bytes it moves, and is held by
// issue rate and latency. The design therefore is:
//
// - A GROUP OF THREADS OWNS A WINDOW. Its first thread loads and clips the
//   lane's origin and plane index once and hands the window's base offset
//   to the group with one __shfl_sync. n is a template parameter for 4, 8,
//   16, 32, 64, so row and column of a thread's elements are shifts of its
//   index: no division anywhere.
// - EVERY STORE IS 16 BYTES. A window's output is 4*n*n contiguous bytes; a
//   thread writes four neighbouring int32s as one int4, and the int4s of a
//   warp's store are neighbours, so one warp-wide store writes 512
//   contiguous bytes.
// - LOADS ARE ALIGNED WORDS, SHIFTED INTO PLACE. A window row starts at any
//   2-byte offset and the planes' pitches are not multiples of 16 bytes, so
//   a thread reads the one or two aligned 8-byte words that cover its four
//   int16s through the read-only path and moves them into place with a
//   word select and __funnelshift_r. An aligned word that holds one byte of
//   a tensor lies inside the tensor's allocation (allocations start and end
//   on multiples of 16 bytes or more), so no read leaves it.
// - Any other n (30 on the encoder's path: the search patches of the
//   integer refinement) goes through one generic kernel with a runtime n: a
//   block stages 8 windows in shared memory exactly as they lie in the
//   output (one warp per window, lanes along a row, eight rows in flight),
//   then writes the 8 windows' flat output with int4 stores from 8-byte
//   shared loads. Four windows must fit 48 KB of shared memory: n <= 78,
//   which is the largest search patch (64 + 2*7); a larger n is refused.
// - Warps walk the windows with a grid stride under a cap of 32 blocks per
//   SM: four times what an SM holds at once, so the hardware refills an SM
//   as its blocks end and 8,160 to 73,440 windows run without a tail (a cap
//   of 8, one resident set, measured 2.5% slower on 73,440 windows).
// - Stores are plain. Streaming stores (__stcs) for an output larger than
//   L2 were measured and changed nothing beyond the spread between runs.
// What then holds the 16x16 gather is the order of the lanes, not the
// kernel: with origins at random a 32-byte row straddles two of the 64-byte
// pieces device memory is read in, and 73,440 windows take twice their
// byte bound; laid out as the encoder lays them out (blocks in raster
// order, candidates around a smooth field) the same kernel runs within a
// tenth of the bound (chip_smoke.py times both: ms and coherent_ms).
// Origins and plane indices are clipped into range here (the dynamic_slice
// clamp the callers rely on): no lane can read outside the planes whatever
// it is given.
//
// The fused entry x265_tile_gather_planes_satd serves the subpel search
// (engine.me._refine, _eval_fixed). There the gathered [K*N, S, S] blocks
// exist only to be subtracted from the current blocks and summed by the
// SATD, and two thirds of the gather's bytes are that output. The fused
// kernel never writes it: for lane j of K*N it loads the S x S window as
// the gather does, subtracts it from cur[j % N], and returns the sa8d sum
// satd.cu defines (per 8x8 sub-block (sum |H8 D H8^T|) >> 2, then the sum
// over sub-blocks). Bound: bytes (the windows' int16s, the indices, cur
// once, 4 bytes out per lane). One thread owns an 8x8 sub-block: 64
// differences in registers, the butterflies of had8.cuh, as in satd.cu; a
// row of the window is 16 bytes at any 2-byte offset, read as two aligned
// 16-byte words. The (S/8)^2 threads of a lane sit side by side in one
// warp and add their sums with shuffles, so the lane's result is written
// once: no atomics, no zeroed output. Work is dealt to warps with the
// candidate index k fastest, so the K warps that need the same current
// blocks run close together and find them in L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "aligned_i16.cuh"
#include "had8.cuh"

constexpr int kGatherWarps = 8;         // warps per block of the gathers
constexpr int kGatherBlocksPerSm = 32;  // their grid cap, per SM
constexpr int kSatdWarps = 4;           // warps per block of the fused entry
constexpr int kSatdBlocksPerSm = 16;
constexpr int kStageBytes = 48 * 1024;  // shared memory a block may stage

#define FULL_MASK 0xffffffffu

// Offset, in int16 elements from planes[0][0][0], of lane j's clipped n x n
// window. ridx == nullptr: a single plane.
__device__ __forceinline__ long long window_base(
    const int32_t* __restrict__ ridx, const int32_t* __restrict__ oy,
    const int32_t* __restrict__ ox, long long j, int n, int P, int Hp,
    int Wp) {
  const int y0 = min(max(__ldg(oy + j), 0), Hp - n);
  const int x0 = min(max(__ldg(ox + j), 0), Wp - n);
  long long base = (long long)y0 * Wp + x0;
  if (ridx != nullptr)
    base += (long long)min(max(__ldg(ridx + j), 0), P - 1) * Hp * Wp;
  return base;
}

// Four consecutive int16s from element e of the aligned base, widened.
__device__ __forceinline__ int4 load4_i16(const char* ab, long long e) {
  const uint2 w = load4_i16_packed(ab, e);
  return make_int4(lo16(w.x), hi16(w.x), lo16(w.y), hi16(w.y));
}

// Eight consecutive int16s from element e of the aligned base, widened.
__device__ __forceinline__ void load8_i16(const char* ab, long long e,
                                          int32_t* v) {
  const uint4* p = reinterpret_cast<const uint4*>(ab) + (e >> 3);
  const unsigned b = static_cast<unsigned>(e) & 7u;
  const uint4 lo = __ldg(p);
  uint4 hi = make_uint4(0u, 0u, 0u, 0u);
  if (b) hi = __ldg(p + 1);
  uint32_t w0 = lo.x, w1 = lo.y, w2 = lo.z, w3 = lo.w, w4 = hi.x, w5 = hi.y;
  if (b & 4u) { w0 = lo.z; w1 = lo.w; w2 = hi.x; w3 = hi.y; w4 = hi.z;
                w5 = hi.w; }
  if (b & 2u) { w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5; }
  const unsigned sh = (b & 1u) << 4;
  w0 = __funnelshift_r(w0, w1, sh);
  w1 = __funnelshift_r(w1, w2, sh);
  w2 = __funnelshift_r(w2, w3, sh);
  w3 = __funnelshift_r(w3, w4, sh);
  v[0] = lo16(w0); v[1] = hi16(w0); v[2] = lo16(w1); v[3] = hi16(w1);
  v[4] = lo16(w2); v[5] = hi16(w2); v[6] = lo16(w3); v[7] = hi16(w3);
}

// ------------------------------------------------ n in {4, 8, 16, 32, 64}

template <int kN>
__global__ void __launch_bounds__(kGatherWarps * 32)
tile_gather_kernel(const int16_t* __restrict__ planes,
                   const int32_t* __restrict__ ridx,
                   const int32_t* __restrict__ oy,
                   const int32_t* __restrict__ ox, int32_t* __restrict__ out,
                   int N, int P, int Hp, int Wp) {
  constexpr int kQ = kN * kN / 4;              // int4 stores per window
  constexpr int kTpw = kQ < 32 ? kQ : 32;      // threads that share a window
  constexpr int kWpw = 32 / kTpw;              // windows per warp and step
  constexpr int kIters = kQ / kTpw;            // int4s per thread and window
  constexpr int kBatch = kIters < 8 ? kIters : 8;   // loads in flight
  const AlignedPlanes ap = align_planes(planes);
  const int lane = threadIdx.x & 31;
  const int sub = lane % kTpw;
  const int grp = lane / kTpw;
  const int steps = (N + kWpw - 1) / kWpw;
  const int stride = gridDim.x * kGatherWarps;
  for (int s = blockIdx.x * kGatherWarps + (threadIdx.x >> 5); s < steps;
       s += stride) {
    const long long w = (long long)s * kWpw + grp;
    const bool live = w < N;
    long long base = 0;
    if (live && sub == 0)
      base = window_base(ridx, oy, ox, w, kN, P, Hp, Wp);
    base = __shfl_sync(FULL_MASK, base, 0, kTpw);
    if (!live) continue;
    const long long e0 = ap.e0 + base;
    int4* dst = reinterpret_cast<int4*>(out + w * (kN * kN)) + sub;
#pragma unroll 1
    for (int k0 = 0; k0 < kIters; k0 += kBatch) {
      int4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int el = ((k0 + k) * kTpw + sub) * 4;   // element in the window
        v[k] = load4_i16(ap.p, e0 + (el / kN) * Wp + (el % kN));
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        dst[(k0 + k) * kTpw] = v[k];
    }
  }
}

// --------------------------------------------------- any n, through shared

// A block stages G windows (G a multiple of 4, so G*n*n*4 bytes is a
// multiple of 16 and every block's flat output begins on an int4).
__global__ void __launch_bounds__(kGatherWarps * 32)
tile_gather_staged_kernel(const int16_t* __restrict__ planes,
                          const int32_t* __restrict__ ridx,
                          const int32_t* __restrict__ oy,
                          const int32_t* __restrict__ ox,
                          int32_t* __restrict__ out, int N, int n, int G,
                          int P, int Hp, int Wp) {
  extern __shared__ __align__(16) int16_t stage[];
  const int nn = n * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long g0 = (long long)blockIdx.x * G; g0 < N;
       g0 += (long long)gridDim.x * G) {
    const int cnt = static_cast<int>(min((long long)G, N - g0));
    for (int w = warp; w < cnt; w += kGatherWarps) {
      long long base = 0;
      if (lane == 0) base = window_base(ridx, oy, ox, g0 + w, n, P, Hp, Wp);
      base = __shfl_sync(FULL_MASK, base, 0);
      const int16_t* src = planes + base;
      int16_t* dst = stage + w * nn;
      for (int c = lane; c < n; c += 32) {
        for (int r0 = 0; r0 < n; r0 += 8) {
          int16_t v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (r0 + u < n) v[u] = __ldg(src + (long long)(r0 + u) * Wp + c);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (r0 + u < n) dst[(r0 + u) * n + c] = v[u];
        }
      }
    }
    __syncthreads();
    const int total = cnt * nn;                // int32s this block writes
    int32_t* o = out + g0 * nn;
    const int q4 = total >> 2;
    for (int q = threadIdx.x; q < q4; q += kGatherWarps * 32) {
      const uint2 s = *reinterpret_cast<const uint2*>(stage + 4 * q);
      reinterpret_cast<int4*>(o)[q] =
          make_int4(lo16(s.x), hi16(s.x), lo16(s.y), hi16(s.y));
    }
    for (int e = (q4 << 2) + threadIdx.x; e < total; e += kGatherWarps * 32)
      o[e] = stage[e];                         // at most 3, in the last block
    __syncthreads();
  }
}

// ------------------------------------------------ fused gather + SATD

template <int kS>
__global__ void __launch_bounds__(kSatdWarps * 32)
gather_satd_kernel(const int16_t* __restrict__ planes,
                   const int32_t* __restrict__ ridx,
                   const int32_t* __restrict__ oy,
                   const int32_t* __restrict__ ox,
                   const int32_t* __restrict__ cur, int32_t* __restrict__ out,
                   int N, int K, int P, int Hp, int Wp) {
  constexpr int kB = kS / 8;                   // 8x8 sub-blocks per side
  constexpr int kSub = kB * kB;                // threads of a lane
  constexpr int kLpw = 32 / kSub;              // lanes per warp and step
  const AlignedPlanes ap = align_planes(planes);
  const int tl = threadIdx.x & 31;
  const int sub = tl % kSub;
  const int slot = tl / kSub;
  const int by = sub / kB, bx = sub % kB;
  const int groups = (N + kLpw - 1) / kLpw;
  const int units = groups * K;                // k fastest: cur stays near
  const int stride = gridDim.x * kSatdWarps;
  for (int u = blockIdx.x * kSatdWarps + (threadIdx.x >> 5); u < units;
       u += stride) {
    const int g = u / K;
    const int k = u - g * K;
    const int i = g * kLpw + slot;
    const bool live = i < N;
    const int ii = live ? i : N - 1;           // a spare slot writes nothing
    const long long j = (long long)k * N + ii;
    long long base = 0;
    if (sub == 0) base = window_base(ridx, oy, ox, j, kS, P, Hp, Wp);
    base = __shfl_sync(FULL_MASK, base, 0, kSub);
    const long long e0 = ap.e0 + base + (long long)(by * 8) * Wp + bx * 8;
    const int32_t* c = cur + ((long long)ii * kS + by * 8) * kS + bx * 8;
    int32_t d[64];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      int32_t w[8];
      load8_i16(ap.p, e0 + (long long)r * Wp, w);
      const int4 c0 = __ldg(reinterpret_cast<const int4*>(c + r * kS));
      const int4 c1 = __ldg(reinterpret_cast<const int4*>(c + r * kS) + 1);
      d[r * 8 + 0] = c0.x - w[0]; d[r * 8 + 1] = c0.y - w[1];
      d[r * 8 + 2] = c0.z - w[2]; d[r * 8 + 3] = c0.w - w[3];
      d[r * 8 + 4] = c1.x - w[4]; d[r * 8 + 5] = c1.y - w[5];
      d[r * 8 + 6] = c1.z - w[6]; d[r * 8 + 7] = c1.w - w[7];
      had8(d + r * 8);
    }
    int32_t s = had8_columns_abs_sum(d) >> 2;  // per sub-block, then summed
#pragma unroll
    for (int m = kSub >> 1; m > 0; m >>= 1)
      s += __shfl_xor_sync(FULL_MASK, s, m);
    if (live && sub == 0) out[j] = s;
  }
}

// ----------------------------------------------------------- C entries

// Blocks to launch: all of them, under a cap of per_sm for each SM of the
// current device.
static cudaError_t capped_grid(long long blocks, int per_sm, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long cap = (long long)sms * per_sm;
  if (blocks > cap) blocks = cap;
  *grid = blocks < 1 ? 1 : (int)blocks;
  return cudaSuccess;
}

template <int kN>
static cudaError_t launch_pow2(const int16_t* planes, const int32_t* ridx,
                               const int32_t* oy, const int32_t* ox,
                               int32_t* out, int N, int P, int Hp, int Wp,
                               cudaStream_t st) {
  constexpr int kQ = kN * kN / 4;
  constexpr int kWpw = kQ < 32 ? 32 / kQ : 1;
  const long long steps = ((long long)N + kWpw - 1) / kWpw;
  int grid = 0;
  const cudaError_t e = capped_grid((steps + kGatherWarps - 1) / kGatherWarps,
                                    kGatherBlocksPerSm, &grid);
  if (e != cudaSuccess) return e;
  tile_gather_kernel<kN><<<grid, kGatherWarps * 32, 0, st>>>(
      planes, ridx, oy, ox, out, N, P, Hp, Wp);
  return cudaGetLastError();
}

static int gather_launch(const void* planes_, const void* ridx_,
                         const void* oy_, const void* ox_, void* out_, int N,
                         int n, int P, int Hp, int Wp, void* stream_) {
  if (N == 0) return 0;
  if (N < 0 || n < 1 || n > Hp || n > Wp || P < 1 ||
      (reinterpret_cast<uintptr_t>(out_) & 15) ||
      (reinterpret_cast<uintptr_t>(planes_) & 1))
    return (int)cudaErrorInvalidValue;
  const int16_t* planes = (const int16_t*)planes_;
  const int32_t* ridx = (const int32_t*)ridx_;
  const int32_t* oy = (const int32_t*)oy_;
  const int32_t* ox = (const int32_t*)ox_;
  int32_t* out = (int32_t*)out_;
  cudaStream_t st = (cudaStream_t)stream_;
  switch (n) {
    case 4: return launch_pow2<4>(planes, ridx, oy, ox, out, N, P, Hp, Wp, st);
    case 8: return launch_pow2<8>(planes, ridx, oy, ox, out, N, P, Hp, Wp, st);
    case 16:
      return launch_pow2<16>(planes, ridx, oy, ox, out, N, P, Hp, Wp, st);
    case 32:
      return launch_pow2<32>(planes, ridx, oy, ox, out, N, P, Hp, Wp, st);
    case 64:
      return launch_pow2<64>(planes, ridx, oy, ox, out, N, P, Hp, Wp, st);
  }
  const long long win_bytes = (long long)n * n * 2;
  const int G = 8 * win_bytes <= kStageBytes ? 8
                : 4 * win_bytes <= kStageBytes ? 4 : 0;
  if (G == 0) return (int)cudaErrorInvalidValue;   // n > 78
  int grid = 0;
  const cudaError_t e = capped_grid(((long long)N + G - 1) / G,
                                    kGatherBlocksPerSm, &grid);
  if (e != cudaSuccess) return (int)e;
  tile_gather_staged_kernel<<<grid, kGatherWarps * 32,
                              (size_t)(G * win_bytes), st>>>(
      planes, ridx, oy, ox, out, N, n, G, P, Hp, Wp);
  return (int)cudaGetLastError();
}

extern "C" int x265_tile_gather(const void* plane, const void* oy,
                                const void* ox, void* out, int N, int n,
                                int Hp, int Wp, void* stream) {
  return gather_launch(plane, nullptr, oy, ox, out, N, n, 1, Hp, Wp, stream);
}

extern "C" int x265_tile_gather_planes(const void* planes, const void* ridx,
                                       const void* oy, const void* ox,
                                       void* out, int N, int n, int P, int Hp,
                                       int Wp, void* stream) {
  if (N != 0 && ridx == nullptr) return (int)cudaErrorInvalidValue;
  return gather_launch(planes, ridx, oy, ox, out, N, n, P, Hp, Wp, stream);
}

template <int kS>
static cudaError_t launch_satd(const void* planes, const void* ridx,
                               const void* oy, const void* ox,
                               const void* cur, void* out, int N, int K,
                               int P, int Hp, int Wp, cudaStream_t st) {
  constexpr int kLpw = 32 / ((kS / 8) * (kS / 8));
  const long long units = (((long long)N + kLpw - 1) / kLpw) * K;
  int grid = 0;
  const cudaError_t e = capped_grid((units + kSatdWarps - 1) / kSatdWarps,
                                    kSatdBlocksPerSm, &grid);
  if (e != cudaSuccess) return e;
  gather_satd_kernel<kS><<<grid, kSatdWarps * 32, 0, st>>>(
      (const int16_t*)planes, (const int32_t*)ridx, (const int32_t*)oy,
      (const int32_t*)ox, (const int32_t*)cur, (int32_t*)out, N, K, P, Hp,
      Wp);
  return cudaGetLastError();
}

// out[k*N + i] = SATD(cur[i], S x S window of planes[ridx[k*N + i]] at the
// clipped (oy, ox)[k*N + i]); cur [N, S, S] int32, 16-byte aligned.
extern "C" int x265_tile_gather_planes_satd(
    const void* planes, const void* ridx, const void* oy, const void* ox,
    const void* cur, void* out, int N, int K, int S, int P, int Hp, int Wp,
    void* stream) {
  if (N == 0 || K == 0) return 0;
  if (N < 0 || K < 0 || (long long)N * K > 0x7fffffffLL || S > Hp ||
      S > Wp || P < 1 || ridx == nullptr ||
      (reinterpret_cast<uintptr_t>(cur) & 15) ||
      (reinterpret_cast<uintptr_t>(planes) & 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 8:
      return launch_satd<8>(planes, ridx, oy, ox, cur, out, N, K, P, Hp, Wp,
                            st);
    case 16:
      return launch_satd<16>(planes, ridx, oy, ox, cur, out, N, K, P, Hp, Wp,
                             st);
    case 32:
      return launch_satd<32>(planes, ridx, oy, ox, cur, out, N, K, P, Hp, Wp,
                             st);
  }
  return (int)cudaErrorInvalidValue;
}
