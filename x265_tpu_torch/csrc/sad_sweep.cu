// Dense integer-search SAD sweep, and the same sweep fused with the
// motion-vector cost and the argmin.
//
// Replaces the TPU kernel sad_sweep_pallas (_make_sad_kernel) of
// x265_tpu/ops/pallas_kernels.py: for cur [H,W] and ref_pad [H+2R,W+2R]
// the SAD of every S x S block at every displacement d = dy*n + dx,
// n = 2R+1. The TPU kernel keeps both planes in VMEM and walks eight
// displacements per grid step; none of that carries over. Two entry
// points share one kernel body:
//   x265_sad_sweep         the field [n*n, nby, nbx] float32 (what the
//                          TPU kernel returns; tests and timing only);
//   x265_sad_sweep_argmin  cost = float(sad) + mvcost[d], first minimum
//                          in d order: what engine.me._int_stage folds
//                          over the field. The field never reaches
//                          device memory.
//
// Bound: integer operations ((2R+1)^2 * H * W absolute differences; the
// two planes are read once). Design: one thread block per S x S block.
// Its (S+2R)^2 search window and the current block are staged once in
// shared memory as int16; displacements are dealt to the 256 threads
// round-robin, eight per thread and pass, so one broadcast read of a
// current sample feeds eight __sad instructions.
//
// Tie rule: a thread visits its displacements in ascending d and keeps
// a new one only when cost < best, so it holds the first minimum of its
// share; threads are merged by the lexicographic minimum of (cost, d).
// Together that is the first minimum of the serial scan in d order. The
// cost is one fp32 add of two exactly representable operands
// (__fadd_rn: nothing for the compiler to contract), so it is the scan's
// value bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerPass = 8;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ bool before(float ca, int da, float cb, int db) {
  return ca < cb || (ca == cb && da < db);
}

template <int S, bool ARGMIN>
__global__ void __launch_bounds__(kThreads)
sad_sweep_kernel(const int16_t* __restrict__ cur,
                 const int16_t* __restrict__ ref,
                 const float* __restrict__ mvcost,
                 float* __restrict__ field, int32_t* __restrict__ best_idx,
                 float* __restrict__ best_cost, int W, int R, int nbx,
                 int nb) {
  extern __shared__ int16_t sm[];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int by = b / nbx;
  const int bx = b - by * nbx;
  const int n = 2 * R + 1;
  const int ws = S + 2 * R;
  const int total = n * n;
  const int Wp = W + 2 * R;
  int16_t* win = sm;
  int16_t* cs = sm + ws * ws;

  const int16_t* rbase = ref + (long long)(by * S) * Wp + bx * S;
  for (int i = tid; i < ws * ws; i += kThreads) {
    const int y = i / ws;
    win[i] = rbase[(long long)y * Wp + (i - y * ws)];
  }
  const int16_t* cbase = cur + (long long)(by * S) * W + bx * S;
  for (int i = tid; i < S * S; i += kThreads)
    cs[i] = cbase[(long long)(i / S) * W + (i % S)];
  __syncthreads();

  float bc = CUDART_INF_F;
  int bd = kNoIndex;
  for (int base = 0; base < total; base += kThreads * kPerPass) {
    int off[kPerPass];
    unsigned acc[kPerPass];
#pragma unroll
    for (int j = 0; j < kPerPass; ++j) {
      const int d = base + j * kThreads + tid;
      const int dd = d < total ? d : 0;        // idle lanes read (0, 0)
      const int dy = dd / n;
      off[j] = dy * ws + (dd - dy * n);
      acc[j] = 0u;
    }
    for (int y = 0; y < S; ++y) {
      const int16_t* wrow = win + y * ws;
      const int16_t* crow = cs + y * S;
#pragma unroll
      for (int x = 0; x < S; ++x) {
        const int c = crow[x];
#pragma unroll
        for (int j = 0; j < kPerPass; ++j)
          acc[j] = __sad(c, (int)wrow[off[j] + x], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPerPass; ++j) {
      const int d = base + j * kThreads + tid;
      if (d < total) {
        if (ARGMIN) {
          const float c = __fadd_rn((float)acc[j], __ldg(mvcost + d));
          if (c < bc) {
            bc = c;
            bd = d;
          }
        } else {
          field[(long long)d * nb + b] = (float)acc[j];
        }
      }
    }
  }
  if (!ARGMIN) return;

  __shared__ float wc[kThreads / 32];
  __shared__ int wd[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float oc = __shfl_down_sync(0xffffffffu, bc, o);
    const int od = __shfl_down_sync(0xffffffffu, bd, o);
    if (before(oc, od, bc, bd)) {
      bc = oc;
      bd = od;
    }
  }
  if ((tid & 31) == 0) {
    wc[tid >> 5] = bc;
    wd[tid >> 5] = bd;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      if (before(wc[w], wd[w], bc, bd)) {
        bc = wc[w];
        bd = wd[w];
      }
    // nothing below +inf anywhere: the scan's initial index, 0, stands
    best_idx[b] = bd == kNoIndex ? 0 : bd;
    best_cost[b] = bc;
  }
}

template <bool ARGMIN>
int launch(const void* cur, const void* ref, const void* mvcost, void* field,
           void* idx, void* cost, int H, int W, int S, int R, void* stream) {
  if (H <= 0 || W <= 0 || R < 0 || H % S || W % S)
    return (int)cudaErrorInvalidValue;
  const int nbx = W / S, nb = (H / S) * nbx;
  const int ws = S + 2 * R;
  const size_t smem = (size_t)(ws * ws + S * S) * sizeof(int16_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X265_SAD_CASE(S_)                                                   \
  case S_:                                                                  \
    sad_sweep_kernel<S_, ARGMIN><<<nb, kThreads, smem, st>>>(               \
        (const int16_t*)cur, (const int16_t*)ref, (const float*)mvcost,     \
        (float*)field, (int32_t*)idx, (float*)cost, W, R, nbx, nb);         \
    break;
  switch (S) {
    X265_SAD_CASE(4)
    X265_SAD_CASE(8)
    X265_SAD_CASE(16)
    X265_SAD_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef X265_SAD_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int x265_sad_sweep(const void* cur, const void* ref, void* field,
                              int H, int W, int S, int R, void* stream) {
  return launch<false>(cur, ref, nullptr, field, nullptr, nullptr, H, W, S, R,
                       stream);
}

extern "C" int x265_sad_sweep_argmin(const void* cur, const void* ref,
                                     const void* mvcost, void* idx,
                                     void* cost, int H, int W, int S, int R,
                                     void* stream) {
  return launch<true>(cur, ref, mvcost, nullptr, idx, cost, H, W, S, R,
                      stream);
}
