// Deblocking boundary strengths (spec 8.7.2.4; x265 getBoundaryStrength,
// deblock.cpp:191) of every 4x4 block of a picture, both directions in one
// launch: bs_v, the strength of the edge at a block's left, and bs_h, at its
// top. The same arithmetic as hevc/deblock.derive_bs, which stays the numpy
// reference; the JAX package derives them on the host and has no kernel.
//
// Inputs (row-major over the [h4, w4] grid of 4x4 blocks):
//   flags   uint8 [h4, w4]: bit 0 a vertical edge at the block's left,
//           bit 1 a horizontal edge at its top, bit 2 intra, bit 3 luma cbf;
//   mv      int16 [h4, w4, 2 (list), 2 (x, y)] quarter-pel, one 8-byte load
//           a block (HEVC motion vectors are 16-bit);
//   refpoc  int32 [h4, w4, 2]: the POC each list refers to, kNoPoc where the
//           list is unused, one 8-byte load a block.
// Outputs: bs_v, bs_h int32 [h4, w4] in 0..2; column 0 of bs_v and row 0 of
// bs_h are 0 (the picture's edge is not filtered).
//
// Design: ONE THREAD A BLOCK, consecutive threads along a row, so every load
// and store of a warp is contiguous. A thread reads its own block and its
// left and top neighbours' (which other threads of the grid read as their
// own: hits in L1/L2). The motion vectors and POCs are read only where
// neither side is intra nor has a coded luma residual, so an intra picture
// reads one byte a block and its neighbours'. Bound: bytes, about 25 a
// block (17 in, 8 out), a microsecond at 1080p; a launch costs more.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint8_t kEdgeV = 1, kEdgeH = 2, kIntra = 4, kCbf = 8;
constexpr int kNoPoc = -(1 << 20);

__device__ __forceinline__ bool mv_close(int ax, int ay, int bx, int by) {
  return abs(ax - bx) < 4 && abs(ay - by) < 4;
}

// The motion term of an edge between p and q: 1 unless both sides use the
// same reference pictures with motion vectors closer than one sample.
// mv = (list 0 x, list 0 y, list 1 x, list 1 y); poc = (list 0, list 1).
__device__ __forceinline__ int motion_bs(short4 pm, int2 pp, short4 qm,
                                         int2 qp) {
  const bool pu0 = pp.x != kNoPoc, pu1 = pp.y != kNoPoc;
  const bool qu0 = qp.x != kNoPoc, qu1 = qp.y != kNoPoc;
  const int pn = pu0 + pu1, qn = qu0 + qu1;
  if (pn == 1 && qn == 1) {
    // uni-predicted sides: each side's single used list
    const int ppoc = pu0 ? pp.x : pp.y, qpoc = qu0 ? qp.x : qp.y;
    const int pmx = pu0 ? pm.x : pm.z, pmy = pu0 ? pm.y : pm.w;
    const int qmx = qu0 ? qm.x : qm.z, qmy = qu0 ? qm.y : qm.w;
    return ppoc != qpoc || !mv_close(pmx, pmy, qmx, qmy);
  }
  if (pn == 2 && qn == 2) {
    // bi-predicted sides: the straight or the crossed matching
    const bool straight = pp.x == qp.x && pp.y == qp.y &&
                          mv_close(pm.x, pm.y, qm.x, qm.y) &&
                          mv_close(pm.z, pm.w, qm.z, qm.w);
    const bool crossed = pp.x == qp.y && pp.y == qp.x &&
                         mv_close(pm.x, pm.y, qm.z, qm.w) &&
                         mv_close(pm.z, pm.w, qm.x, qm.y);
    return !(straight || crossed);
  }
  return 1;   // a different count of used lists
}

// bS of the edge between block p (left or top) and block q = i.
__device__ __forceinline__ int edge_bs(const uint8_t* __restrict__ flags,
                                       const short4* __restrict__ mv,
                                       const int2* __restrict__ poc, int p,
                                       int i, uint8_t qf, uint8_t edge) {
  if (!(qf & edge)) return 0;
  const uint8_t both = __ldg(flags + p) | qf;
  if (both & kIntra) return 2;
  if (both & kCbf) return 1;
  return motion_bs(__ldg(mv + p), __ldg(poc + p), __ldg(mv + i),
                   __ldg(poc + i));
}

__global__ void __launch_bounds__(kThreads)
deblock_bs_kernel(const uint8_t* __restrict__ flags,
                  const short4* __restrict__ mv, const int2* __restrict__ poc,
                  int32_t* __restrict__ bs_v, int32_t* __restrict__ bs_h,
                  int h4, int w4) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= h4 * w4) return;
  const int r = i / w4, c = i - r * w4;
  const uint8_t qf = __ldg(flags + i);
  bs_v[i] = c > 0 ? edge_bs(flags, mv, poc, i - 1, i, qf, kEdgeV) : 0;
  bs_h[i] = r > 0 ? edge_bs(flags, mv, poc, i - w4, i, qf, kEdgeH) : 0;
}

}  // namespace

// flags uint8 [h4, w4]; mv int16 [h4, w4, 2, 2] and refpoc int32
// [h4, w4, 2], both 8-byte aligned; bs_v, bs_h int32 [h4, w4].
extern "C" int x265_deblock_bs(const void* flags, const void* mv,
                               const void* refpoc, void* bs_v, void* bs_h,
                               int h4, int w4, void* stream) {
  if (h4 < 1 || w4 < 1 || (long long)h4 * w4 > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int n = h4 * w4;
  deblock_bs_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)flags, (const short4*)mv, (const int2*)refpoc,
      (int32_t*)bs_v, (int32_t*)bs_h, h4, w4);
  return (int)cudaGetLastError();
}
