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
// 2*taps multiply-adds per output). At 8,040 lanes of 16x16 that is 17 MB,
// 4 us of memory time, and the first version (a block per lane, the window
// read as single int16s with a division each, two block-wide barriers) took
// eight times that: it was bound by latency and instruction rate, not by
// bytes. The design now:
//
// - n AND taps ARE TEMPLATE PARAMETERS (n in 4..64, taps 4 or 8), so every
//   index is a shift or a constant and both passes unroll completely.
// - SEVERAL LANES A BLOCK. A group of 4 (n = 4), 16 (n = 8) or 32 (n = 16)
//   threads owns a lane, 64 to 8 lanes share a block of 256 threads, and the
//   groups synchronise with __syncwarp only. From n = 32 a lane has 128
//   threads, at n = 64 the block, and there are two block-wide barriers.
// - THE WINDOW IS READ AS ALIGNED 8-BYTE WORDS shifted into place
//   (aligned_i16.cuh), four samples a thread and step, and stays int16 in
//   shared memory, each row on a word boundary (28 KB in all at n = 64).
// - THE HORIZONTAL PASS takes four outputs of a row a thread: the 4 + taps
//   - 1 samples come as three or two 8-byte shared loads and slide through
//   registers. THE VERTICAL PASS takes a strip of four columns and a run of
//   rows a thread, reads the strip's rows as 16-byte shared loads, each
//   once, and writes 16-byte stores. Filter taps sit in registers.
// What holds it now (H100, N = 8,040 lanes of 16x16): it runs 3.2 times
// faster than the first version and 2.5 times its byte bound. Readings that
// say what the cause is NOT: an empty kernel of the same grid takes a
// quarter of its time; 64, 128 or 256 threads a block give the same time;
// lanes ordered as the encoder orders them give the same time as random
// ones; having all of a lane's loads in flight at once gains 2% hot and 7%
// with a cold L2. So neither launch, scheduling, load latency nor the memory
// system alone is what is left. A guess, NOT verified (no profiler runs on
// the card, and the instruction count is static): the 8,040 lanes are one
// wave (61 a multiprocessor, all resident), so the load, compute and store
// phases of a lane overlap little with its neighbours', and the two passes
// are about 450 warp instructions a lane, 160 of them multiply-adds at half
// rate, some 4 us of instruction slots on top of the launch and the memory phases.
// If that is right, a persistent form (fewer blocks, each walking several
// lanes with the next lane's window already loading) or packed 16-bit dot
// products in the horizontal pass would be the next step.
#include <cuda_runtime.h>
#include <stdint.h>

#include "aligned_i16.cuh"

namespace {

constexpr int kThreads = 256;   // of a block: 64 lanes of n = 4 to one of 64

// Threads that share a lane.
__host__ __device__ constexpr int lane_threads(int n) {
  return n == 4 ? 4 : n == 8 ? 16 : n == 16 ? 32 : n == 32 ? 128 : 256;
}

template <int kN, int kTaps>
__global__ void __launch_bounds__(kThreads)
mc_gather_kernel(const int16_t* __restrict__ planes,
                 const int32_t* __restrict__ ridx,
                 const int32_t* __restrict__ oy,
                 const int32_t* __restrict__ ox,
                 const int32_t* __restrict__ xf,
                 const int32_t* __restrict__ yf,
                 const int32_t* __restrict__ filt,
                 int32_t* __restrict__ out, int N, int sh1, int R, int nphase,
                 int Hp, int Wp) {
  constexpr int kSide = kN + kTaps - 1;
  constexpr int kPitch = (kSide + 3) & ~3;     // samples; rows start on words
  constexpr int kLg = lane_threads(kN);        // threads of a lane
  constexpr int kLpb = kThreads / kLg;   // lanes of a block
  constexpr int kCpr = kPitch / 4;             // 4-sample steps of a row
  constexpr int kQ = kN / 4;                   // 4-column strips
  constexpr int kWinWords = (kSide * kPitch / 2 + 3) & ~3;   // 16 bytes
  constexpr int kHorWords = kSide * kN;
  constexpr int kRunRows = kN * kQ / kLg;      // rows of a vertical unit
  __shared__ __align__(16) uint32_t sm[kLpb * (kWinWords + kHorWords)];

  const int g = threadIdx.x / kLg;             // the lane's slot in the block
  const int t = threadIdx.x % kLg;
  const long long lane = (long long)blockIdx.x * kLpb + g;
  const bool live = lane < N;
  uint32_t* win = sm + g * (kWinWords + kHorWords);
  int32_t* hor = reinterpret_cast<int32_t*>(win + kWinWords);

  int fx[kTaps], fy[kTaps];
  if (live) {
    const AlignedPlanes ap = align_planes(planes);
    const long long e0 =
        ap.e0 + (long long)min(max(__ldg(ridx + lane), 0), R - 1) * Hp * Wp +
        (long long)min(max(__ldg(oy + lane), 0), Hp - kSide) * Wp +
        min(max(__ldg(ox + lane), 0), Wp - kSide);
    const int32_t* px = filt + min(max(__ldg(xf + lane), 0), nphase - 1) * kTaps;
    const int32_t* py = filt + min(max(__ldg(yf + lane), 0), nphase - 1) * kTaps;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      fx[k] = __ldg(px + k);
      fy[k] = __ldg(py + k);
    }
    // every load of the lane's window is in flight before the first store
    constexpr int kSteps = kSide * kCpr;
    constexpr int kIters = (kSteps + kLg - 1) / kLg;
    uint2 v[kIters];
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = t + k * kLg;
      const int r = i / kCpr;
      const int c = (i % kCpr) * 4;
      if (i < kSteps)
        v[k] = load4_i16_packed(ap.p, e0 + (long long)r * Wp + c,
                                min(4, kSide - c));
    }
#pragma unroll
    for (int k = 0; k < kIters; ++k) {
      const int i = t + k * kLg;
      if (i < kSteps)
        *reinterpret_cast<uint2*>(
            win + (((i / kCpr) * kPitch + (i % kCpr) * 4) >> 1)) = v[k];
    }
  }
  if (kLg <= 32) __syncwarp(); else __syncthreads();

  if (live) {
    // horizontal: unit = (row, strip of four outputs)
    constexpr int kHorIters = (kSide * kQ + kLg - 1) / kLg;
#pragma unroll
    for (int k0 = 0; k0 < kHorIters; ++k0) {
      const int u = t + k0 * kLg;
      if (u >= kSide * kQ) break;
      const int r = u / kQ;
      const int q = u % kQ;
      // samples 4q .. 4q + kTaps + 2 of the row, from word 2q
      constexpr int kIn = (kTaps + 4) / 2;     // words: 6 or 4
      uint32_t w[kIn];
      const uint2* src =
          reinterpret_cast<const uint2*>(win + ((r * kPitch) >> 1) + 2 * q);
#pragma unroll
      for (int k = 0; k < kIn / 2; ++k) {
        const uint2 p2 = src[k];
        w[2 * k] = p2.x;
        w[2 * k + 1] = p2.y;
      }
      int32_t s[2 * kIn];
#pragma unroll
      for (int k = 0; k < kIn; ++k) {
        s[2 * k] = lo16(w[k]);
        s[2 * k + 1] = hi16(w[k]);
      }
      int32_t o[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int32_t acc = 0;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) acc += fx[k] * s[c + k];
        o[c] = acc >> sh1;
      }
      *reinterpret_cast<int4*>(hor + r * kN + 4 * q) =
          make_int4(o[0], o[1], o[2], o[3]);
    }
  }
  if (kLg <= 32) __syncwarp(); else __syncthreads();

  if (live) {
    // vertical: unit = (strip of four columns, run of kRunRows rows)
    int4* dst = reinterpret_cast<int4*>(out + lane * (kN * kN));
    for (int u = t; u < kQ * (kN / kRunRows); u += kLg) {
      const int q = u % kQ;
      const int r0 = (u / kQ) * kRunRows;
      int4 in[kRunRows + kTaps - 1];
#pragma unroll
      for (int k = 0; k < kRunRows + kTaps - 1; ++k)
        in[k] = *reinterpret_cast<const int4*>(hor + (r0 + k) * kN + 4 * q);
#pragma unroll
      for (int j = 0; j < kRunRows; ++j) {
        int4 a = make_int4(0, 0, 0, 0);
#pragma unroll
        for (int k = 0; k < kTaps; ++k) {
          a.x += fy[k] * in[j + k].x;
          a.y += fy[k] * in[j + k].y;
          a.z += fy[k] * in[j + k].z;
          a.w += fy[k] * in[j + k].w;
        }
        dst[(r0 + j) * kQ + q] =
            make_int4(a.x >> 6, a.y >> 6, a.z >> 6, a.w >> 6);
      }
    }
  }
}

template <int kN, int kTaps>
cudaError_t launch(const void* planes, const void* ridx, const void* oy,
                   const void* ox, const void* xf, const void* yf,
                   const void* filt, void* out, int N, int bd, int R,
                   int nphase, int Hp, int Wp, cudaStream_t st) {
  constexpr int kLg = lane_threads(kN);
  constexpr int kLpb = kThreads / kLg;
  mc_gather_kernel<kN, kTaps>
      <<<(N + kLpb - 1) / kLpb, kThreads, 0, st>>>(
          (const int16_t*)planes, (const int32_t*)ridx, (const int32_t*)oy,
          (const int32_t*)ox, (const int32_t*)xf, (const int32_t*)yf,
          (const int32_t*)filt, (int32_t*)out, N, bd - 8, R, nphase, Hp, Wp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int x265_mc_gather_interp(const void* planes, const void* ridx,
                                     const void* oy, const void* ox,
                                     const void* xf, const void* yf,
                                     const void* filt, void* out, int N,
                                     int n, int taps, int bd, int R,
                                     int nphase, int Hp, int Wp,
                                     void* stream) {
  if (N == 0) return 0;
  if (N < 0 || bd < 8 || R < 1 || nphase < 1 || n + taps - 1 > Hp ||
      n + taps - 1 > Wp || (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(planes) & 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X265_MC_CASE(N_, T_)                                                 \
  if (n == N_ && taps == T_)                                                 \
    return (int)launch<N_, T_>(planes, ridx, oy, ox, xf, yf, filt, out, N,   \
                               bd, R, nphase, Hp, Wp, st);
  X265_MC_CASE(4, 4) X265_MC_CASE(8, 4) X265_MC_CASE(16, 4)
  X265_MC_CASE(32, 4) X265_MC_CASE(64, 4)
  X265_MC_CASE(4, 8) X265_MC_CASE(8, 8) X265_MC_CASE(16, 8)
  X265_MC_CASE(32, 8) X265_MC_CASE(64, 8)
#undef X265_MC_CASE
  return (int)cudaErrorInvalidValue;
}
