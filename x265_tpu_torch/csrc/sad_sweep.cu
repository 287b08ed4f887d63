// Block-SAD searches: the dense integer-search sweep, the same sweep fused
// with the motion-vector cost and the argmin, and the per-block window
// search around given centres.
//
// Replaces the TPU kernel sad_sweep_pallas (_make_sad_kernel) of
// x265_tpu/ops/pallas_kernels.py: for cur [H,W] and ref_pad [H+2R,W+2R]
// the SAD of every S x S block at every displacement d = dy*n + dx,
// n = 2R+1. The TPU kernel keeps both planes in VMEM and walks eight
// displacements per grid step; none of that carries over. Three entry
// points share one body (block_sad below):
//   x265_sad_sweep         the field [n*n, nby, nbx] float32 (what the
//                          TPU kernel returns; tests and timing only);
//   x265_sad_sweep_argmin  cost = float(sad) + mvcost[d], first minimum
//                          in d order: what engine.me._int_stage folds
//                          over the field, which never reaches device
//                          memory; with a batch axis over P planes (one
//                          grid row a plane: the slice-type search costs a
//                          window's pairs in one launch);
//   x265_sad_local_argmin  every block has its own (S+2W) x (S+2W) window,
//                          at an origin clipped into the plane, and its own
//                          mv cost lam * (bits(4*(cx+dx-W)) + bits(4*(cy+dy-W))):
//                          what engine.me._local_search scans. Neither the
//                          windows nor any per-displacement tensor reaches
//                          device memory.
//
// Bound: integer operations ((2R+1)^2 * H * W absolute differences against
// two planes read once). Counted as three scalar operations a difference at
// the data sheet's rate the kernel reaches that figure, but the figure is no
// lower limit: the card has vabsdiff4 with accumulate, four byte differences
// and their sum in one instruction, executed at 64 a clock a multiprocessor
// (measured: csrc/calib.cu), and against that rate the byte path takes 2.5
// times (dense) to 3.8 times (window entry) the least time, the int16 path
// about twice its own. What held the first version was the rate of
// shared-memory loads: one 2-byte load for every __sad. The design therefore
// cuts loads and instructions per difference (0.5 to 0.7 instructions a
// difference on bytes, where 0.25 is the least). What holds it now is not
// known: there is no profiler on the card. Ruled out by readings: bank
// conflicts between a CTA's two rows of blocks (spread_pitch below: 7%) and
// residency (three CTAs a multiprocessor at 85 registers spilled and gained
// nothing).
//
// - FOUR SAMPLES A REGISTER. While a CTA stages its window it keeps it
//   twice, as int16 and as bytes, and notes whether every sample lies in
//   0..255. If so (8-bit video: the encoder's case) the search runs on the
//   bytes: one vabsdiff4 with accumulate is four absolute differences and
//   their sum. Otherwise it runs on the int16 copy with one __sad a
//   difference. Nothing outside the kernel knows which ran; both give the
//   same integers.
// - REGISTER TILING OVER DISPLACEMENTS. A thread owns one dx and eight
//   consecutive dy of one block. It walks the block in 8x8 tiles with the
//   tile's current samples in registers; each of the 15 window rows a tile
//   touches is loaded once (three aligned words, moved into place by two
//   byte permutes) and used by up to eight (row, dy) pairs. Per 512
//   differences that is about 45 shared loads, 30 permutes and 128
//   vabsdiff4 instead of 512 loads and 512 __sad. When n is not a multiple
//   of eight the last run starts at n-8 and repeats a few dy: the same
//   values, so no slot idles and no row lies outside the window.
// - SEVERAL BLOCKS A CTA in the dense entries (2 x 8 blocks of 8x8, 2 x 4 of
//   16x16), as many as fit the shared-memory cap: neighbouring windows
//   overlap by 2R of their S + 2R columns, so the staged bytes per block
//   fall several times. Staging reads aligned 8-byte words shifted into
//   place (aligned_i16.cuh), four samples a thread, no division.
//   Neighbouring threads hold neighbouring blocks of one displacement, so
//   the field entry writes runs of eight floats.
// - The window entry gives a warp to each block: its 30x30 patch and the
//   16x16 current block (converted from int32 while staging) sit in shared
//   memory, the mv bits of the 15 dx and 15 dy are computed once a block,
//   and the 30 (dx, dy-run) items fill 30 of the 32 lanes.
//
// Tie rule: every candidate is merged by the lexicographic minimum of
// (cost, d), in registers, across a warp and across warps. That is the
// first minimum of the serial scan in d order. The dense cost is one fp32
// add of two exactly representable operands; the window cost is one fp32
// multiply and one fp32 add (__fmul_rn, __fadd_rn: never contracted to a
// fused multiply-add), so both are the scan's values bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "aligned_i16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;              // consecutive dy a thread carries
constexpr int kMaxGroup = 16;        // blocks a dense CTA holds at most
constexpr int kSmemCap = 99 * 1024;  // dynamic shared memory a CTA may ask
constexpr int kNoIndex = 0x7fffffff;

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ bool before(float ca, int da, float cb, int db) {
  return ca < cb || (ca == cb && da < db);
}

// Sum of the four absolute byte differences of a and b, plus c.
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// A staged plane region, kept as int16 pairs (w16) and as bytes (w8); the
// pitch P, in samples, is a multiple of 4, so rows start on words in both.
struct Staged {
  uint32_t* w16;
  uint32_t* w8;
  int P;
};

// Threads t of nt copy rows x cols int16 samples from element e0 (pitch
// `pitch`) of the aligned base into `s`, four samples a step; 1 << sh is
// the number of steps dealt to a row (a power of two, so no division).
// Returns non-zero when one of the rows x cols samples lies outside 0..255;
// what a four-sample step reads beyond `cols` does not count.
__device__ __forceinline__ uint32_t stage_i16(const char* ab, long long e0,
                                              long long pitch, int rows,
                                              int cols, const Staged& s,
                                              int t, int nt) {
  const int cpr = (cols + 3) >> 2;
  const int sh = 32 - __clz(cpr - 1);
  const int total = rows << sh;
  uint32_t wide = 0u;
  for (int i = t; i < total; i += nt) {
    const int r = i >> sh;
    const int c = (i & ((1 << sh) - 1)) << 2;
    if (c >= cols) continue;
    const int cnt = min(4, cols - c);
    const uint2 v = load4_i16_packed(ab, e0 + r * pitch + c, cnt);
    const unsigned long long keep = ~0ull >> (64 - 16 * cnt);
    wide |= (v.x & (uint32_t)keep) | (v.y & (uint32_t)(keep >> 32));
    const int o = r * s.P + c;
    *reinterpret_cast<uint2*>(s.w16 + (o >> 1)) = v;
    s.w8[o >> 2] = __byte_perm(v.x, v.y, 0x6420);
  }
  return wide & 0xff00ff00u;
}

// SADs of one TH x (4*TW) tile at one dx and kRun consecutive dy, added to
// acc, on bytes. `a` is the byte offset in w of the tile's window at the
// first dy, `ca` the word offset in c of the tile's current samples; p and
// cp are pitches in words.
template <int TH, int TW>
__device__ __forceinline__ void tile_sad_u8(const uint32_t* __restrict__ w,
                                            int p, int a,
                                            const uint32_t* __restrict__ c,
                                            int cp, int ca,
                                            uint32_t (&acc)[kRun]) {
  uint32_t cur[TH][TW];
#pragma unroll
  for (int y = 0; y < TH; ++y) {
    if constexpr (TW == 2) {
      const uint2 t = *reinterpret_cast<const uint2*>(c + ca + y * cp);
      cur[y][0] = t.x;
      cur[y][1] = t.y;
    } else {
      cur[y][0] = c[ca + y * cp];
    }
  }
  const uint32_t* row = w + (a >> 2);
  const uint32_t sel = 0x3210u + 0x1111u * (a & 3);
#pragma unroll
  for (int r = 0; r < TH + kRun - 1; ++r) {
    uint32_t in[TW + 1];
#pragma unroll
    for (int k = 0; k <= TW; ++k) in[k] = row[r * p + k];
    uint32_t v[TW];
#pragma unroll
    for (int k = 0; k < TW; ++k) v[k] = __byte_perm(in[k], in[k + 1], sel);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int y = r - j;
      if (y >= 0 && y < TH) {
#pragma unroll
        for (int k = 0; k < TW; ++k) acc[j] = sad4(v[k], cur[y][k], acc[j]);
      }
    }
  }
}

// The same on int16 pairs: `a` an offset in samples, `ca`, p, cp in words.
template <int TH, int TW>
__device__ __forceinline__ void tile_sad_i16(const uint32_t* __restrict__ w,
                                             int p, int a,
                                             const uint32_t* __restrict__ c,
                                             int cp, int ca,
                                             uint32_t (&acc)[kRun]) {
  int32_t cur[TH][4 * TW];
#pragma unroll
  for (int y = 0; y < TH; ++y) {
    uint32_t t[2 * TW];
    if constexpr (TW == 2) {
      const uint4 q = *reinterpret_cast<const uint4*>(c + ca + y * cp);
      t[0] = q.x; t[1] = q.y; t[2] = q.z; t[3] = q.w;
    } else {
      const uint2 q = *reinterpret_cast<const uint2*>(c + ca + y * cp);
      t[0] = q.x; t[1] = q.y;
    }
#pragma unroll
    for (int k = 0; k < 2 * TW; ++k) {
      cur[y][2 * k] = lo16(t[k]);
      cur[y][2 * k + 1] = hi16(t[k]);
    }
  }
  const uint32_t* row = w + (a >> 1);
  const unsigned sh = (a & 1) << 4;
#pragma unroll
  for (int r = 0; r < TH + kRun - 1; ++r) {
    uint32_t in[2 * TW + 1];
#pragma unroll
    for (int k = 0; k <= 2 * TW; ++k) in[k] = row[r * p + k];
    int32_t v[4 * TW];
#pragma unroll
    for (int k = 0; k < 2 * TW; ++k) {
      const uint32_t u = __funnelshift_r(in[k], in[k + 1], sh);
      v[2 * k] = lo16(u);
      v[2 * k + 1] = hi16(u);
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int y = r - j;
      if (y >= 0 && y < TH) {
#pragma unroll
        for (int x = 0; x < 4 * TW; ++x)
          acc[j] = __sad(cur[y][x], v[x], acc[j]);
      }
    }
  }
}

// acc[j] = SAD of one S x S block against its window at (dy0 + j, dx),
// j < kRun. `org` is the sample offset in `win` of the window at (dy0, dx),
// `corg` that of the block in `cur`. S = 4 is one 4x4 tile, any other S a
// grid of 8x8 tiles.
template <int S, bool BYTES>
__device__ __forceinline__ void block_sad(const Staged& win, int org,
                                          const Staged& cur, int corg,
                                          uint32_t (&acc)[kRun]) {
  constexpr int TH = S < 8 ? 4 : 8;
  constexpr int TW = S < 8 ? 1 : 2;
  constexpr int TN = S / TH;
#pragma unroll
  for (int j = 0; j < kRun; ++j) acc[j] = 0u;
#pragma unroll 1
  for (int ty = 0; ty < TN; ++ty) {
#pragma unroll 1
    for (int tx = 0; tx < TN; ++tx) {
      const int a = org + ty * TH * win.P + tx * 8;
      const int ca = corg + ty * TH * cur.P + tx * 8;
      if (BYTES)
        tile_sad_u8<TH, TW>(win.w8, win.P >> 2, a, cur.w8, cur.P >> 2,
                            ca >> 2, acc);
      else
        tile_sad_i16<TH, TW>(win.w16, win.P >> 1, a, cur.w16, cur.P >> 1,
                             ca >> 1, acc);
    }
  }
}

// The first dy of run `run`: the last run is moved back so that it ends
// with the window (it repeats some dy of the run before it).
__host__ __device__ inline int run_start(int run, int n) {
  const int s = run * kRun < n - kRun ? run * kRun : n - kRun;
  return s > 0 ? s : 0;
}

// Words (rounded to 16 bytes) of a staged region of `rows` rows, pitch P.
__host__ __device__ inline int words16(int rows, int P) {
  return ((rows * P / 2) + 3) & ~3;
}
__host__ __device__ inline int words8(int rows, int P) {
  return ((rows * P / 4) + 3) & ~3;
}
// The smallest pitch P + k * step (samples) whose byte copy puts two rows
// `apart` rows from each other between `span` and 32 - `span` banks apart
// (apart = 0: there is one row only).
// The lanes of a warp read two such rows at once (the two rows of blocks of
// a dense CTA), `span` words of each: with that distance one shared load is
// one pass over the banks, not two. P itself when no such pitch is near.
// (The window entry's lanes read two runs of dy likewise; spreading those
// measured 5% slower, so its pitch stays the smallest.)
__host__ __device__ inline int spread_pitch(int P, int step, int apart,
                                            int span) {
  for (int k = 0; apart > 0 && k < 16; ++k) {
    const int d = (apart * (P + k * step) / 4) & 31;
    if (d >= span && d <= 32 - span) return P + k * step;
  }
  return P;
}
// Pitch of a staged window of `cols` columns: the tiles read up to eleven
// bytes, or five words of int16, from a sample of the last displacement.
__host__ __device__ inline int window_pitch(int cols, int apart, int span) {
  return spread_pitch(((cols + 3) & ~3) + 4, 4, apart, span);
}

// Lets `kernel` ask for kSmemCap bytes of dynamic shared memory. The
// attribute belongs to the kernel and the device, so it is set at the first
// launch on a device and remembered in `done`, one array an instantiation.
constexpr int kMaxDevices = 64;
cudaError_t raise_smem_cap(const void* kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemCap);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return e;
}

// ------------------------------------------------------------ dense entries

// A CTA holds a group of (1 << gys) x (1 << gxs) blocks; thread tid serves
// block tid % NB of the group and is the (tid / NB)-th of the threads that
// share that block's (dx, dy-run) items.
template <int S, bool ARGMIN>
__global__ void __launch_bounds__(kThreads)
sad_sweep_kernel(const int16_t* __restrict__ cur,
                 const int16_t* __restrict__ ref,
                 const float* __restrict__ mvcost,
                 float* __restrict__ field, int32_t* __restrict__ best_idx,
                 float* __restrict__ best_cost, int W, int R, int nby,
                 int nbx, int gys, int gxs) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int tid = threadIdx.x;
  const int GY = 1 << gys, GX = 1 << gxs;
  const int n = 2 * R + 1;
  const int Wp = W + 2 * R;
  // the batch axis of the argmin entry: plane blockIdx.y of [P, ...] stacks
  {
    const long long p = blockIdx.y;
    cur += p * (nby * S) * (long long)W;
    ref += p * (nby * S + 2 * R) * (long long)Wp;
    best_idx += ARGMIN ? p * nby * nbx : 0;
    best_cost += ARGMIN ? p * nby * nbx : 0;
  }
  const int ngx = (nbx + GX - 1) >> gxs;
  const int ggy = blockIdx.x / ngx;
  const int by0 = ggy << gys;
  const int bx0 = (blockIdx.x - ggy * ngx) << gxs;
  const int vy = min(GY, nby - by0), vx = min(GX, nbx - bx0);

  Staged win, cb;
  win.P = window_pitch(GX * S + 2 * R, gys ? S : 0, 16);
  cb.P = spread_pitch(GX * S, 8, gys ? S : 0, 16);
  const int wrows = GY * S + 2 * R + kRun;     // kRun rows of slack: n < kRun
  win.w16 = sm;
  win.w8 = win.w16 + words16(wrows, win.P);
  cb.w16 = win.w8 + words8(wrows, win.P);
  cb.w8 = cb.w16 + words16(GY * S, cb.P);

  const AlignedPlanes ar = align_planes(ref);
  const AlignedPlanes ac = align_planes(cur);
  uint32_t wide = stage_i16(
      ar.p, ar.e0 + (long long)(by0 * S) * Wp + bx0 * S, Wp,
      vy * S + 2 * R, vx * S + 2 * R, win, tid, kThreads);
  wide |= stage_i16(ac.p, ac.e0 + (long long)(by0 * S) * W + bx0 * S, W,
                    vy * S, vx * S, cb, tid, kThreads);
  const bool bytes = !__syncthreads_or(wide != 0u);

  const int nbs = gys + gxs;
  const int b = tid & ((1 << nbs) - 1);
  const int t = tid >> nbs;
  const int tpb = kThreads >> nbs;
  const int gy = b >> gxs, gx = b & (GX - 1);
  const bool live = gy < vy && gx < vx;
  const long long nb = (long long)nby * nbx;
  const int blk = (by0 + gy) * nbx + bx0 + gx;
  const int items = n * ((n + kRun - 1) / kRun);
  const int corg = gy * S * cb.P + gx * S;

  float bc = CUDART_INF_F;
  int bd = kNoIndex;
  if (live) {
    for (int it = t; it < items; it += tpb) {
      const int run = it / n;
      const int dx = it - run * n;
      const int dy0 = run_start(run, n);
      const int org = (gy * S + dy0) * win.P + gx * S + dx;
      uint32_t acc[kRun];
      if (bytes)
        block_sad<S, true>(win, org, cb, corg, acc);
      else
        block_sad<S, false>(win, org, cb, corg, acc);
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const int dy = dy0 + j;
        if (dy < n) {
          const int d = dy * n + dx;
          if (ARGMIN) {
            const float c = __fadd_rn((float)acc[j], __ldg(mvcost + d));
            if (before(c, d, bc, bd)) {
              bc = c;
              bd = d;
            }
          } else {
            field[(long long)d * nb + blk] = (float)acc[j];
          }
        }
      }
    }
  }
  if (!ARGMIN) return;

  // the threads of a block sit NB lanes apart in every warp
  __shared__ float wc[kThreads];
  __shared__ int wd[kThreads];
  for (int o = 16; o >= (1 << nbs); o >>= 1) {
    const float oc = __shfl_xor_sync(FULL_MASK, bc, o);
    const int od = __shfl_xor_sync(FULL_MASK, bd, o);
    if (before(oc, od, bc, bd)) {
      bc = oc;
      bd = od;
    }
  }
  wc[tid] = bc;
  wd[tid] = bd;
  __syncthreads();
  if (tid < (1 << nbs) && live) {
    // lane b of every warp holds that warp's best for block b
    for (int w = 1; w < kThreads / 32; ++w)
      if (before(wc[w * 32 + tid], wd[w * 32 + tid], bc, bd)) {
        bc = wc[w * 32 + tid];
        bd = wd[w * 32 + tid];
      }
    // nothing below +inf anywhere: the scan's initial index, 0, stands
    best_idx[blk] = bd == kNoIndex ? 0 : bd;
    best_cost[blk] = bc;
  }
}

// Bytes of shared memory a dense CTA needs for (1 << gys) x (1 << gxs) blocks.
size_t dense_smem(int S, int R, int gys, int gxs) {
  const int GY = 1 << gys, GX = 1 << gxs;
  const int P = window_pitch(GX * S + 2 * R, gys ? S : 0, 16);
  const int cP = spread_pitch(GX * S, 8, gys ? S : 0, 16);
  const int wrows = GY * S + 2 * R + kRun;
  return (size_t)4 * (words16(wrows, P) + words8(wrows, P) +
                      words16(GY * S, cP) + words8(GY * S, cP));
}

// The group shape for S x S blocks, search range R: grown from one block,
// first sideways to 64 samples, then down to 32, while it stays inside the
// picture, the group cap and the shared-memory cap. Returns the bytes of
// shared memory the kernel then needs (0: even one block does not fit).
size_t dense_group(int S, int R, int nby, int nbx, int* gys, int* gxs) {
  *gys = *gxs = 0;
  if (dense_smem(S, R, 0, 0) > (size_t)kSmemCap) return 0;
  for (;;) {
    const int GY = 1 << *gys, GX = 1 << *gxs;
    if (2 * GY * GX > kMaxGroup) break;
    if (GX * S < 64 && GX < nbx &&
        dense_smem(S, R, *gys, *gxs + 1) <= (size_t)kSmemCap)
      ++*gxs;
    else if (GY * S < 32 && GY < nby &&
             dense_smem(S, R, *gys + 1, *gxs) <= (size_t)kSmemCap)
      ++*gys;
    else
      break;
  }
  return dense_smem(S, R, *gys, *gxs);
}

template <int S, bool ARGMIN>
cudaError_t launch_dense(const void* cur, const void* ref, const void* mvcost,
                         void* field, void* idx, void* cost, int H, int W,
                         int R, int P, cudaStream_t st) {
  const int nby = H / S, nbx = W / S;
  int gys = 0, gxs = 0;
  const size_t smem = dense_group(S, R, nby, nbx, &gys, &gxs);
  if (smem == 0) return cudaErrorInvalidValue;
  auto kernel = sad_sweep_kernel<S, ARGMIN>;
  static bool cap_raised[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    const cudaError_t e =
        raise_smem_cap(reinterpret_cast<const void*>(kernel), cap_raised);
    if (e != cudaSuccess) return e;
  }
  const int groups = ((nby + (1 << gys) - 1) >> gys) *
                     ((nbx + (1 << gxs) - 1) >> gxs);
  kernel<<<dim3(groups, P), kThreads, smem, st>>>(
      (const int16_t*)cur, (const int16_t*)ref, (const float*)mvcost,
      (float*)field, (int32_t*)idx, (float*)cost, W, R, nby, nbx, gys, gxs);
  return cudaGetLastError();
}

template <bool ARGMIN>
int launch(const void* cur, const void* ref, const void* mvcost, void* field,
           void* idx, void* cost, int H, int W, int S, int R, int P,
           void* stream) {
  if (P == 0) return 0;
  if (H <= 0 || W <= 0 || R < 0 || S <= 0 || H % S || W % S || P < 0 ||
      P > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 4:
      return (int)launch_dense<4, ARGMIN>(cur, ref, mvcost, field, idx, cost,
                                          H, W, R, P, st);
    case 8:
      return (int)launch_dense<8, ARGMIN>(cur, ref, mvcost, field, idx, cost,
                                          H, W, R, P, st);
    case 16:
      return (int)launch_dense<16, ARGMIN>(cur, ref, mvcost, field, idx,
                                           cost, H, W, R, P, st);
    case 32:
      return (int)launch_dense<32, ARGMIN>(cur, ref, mvcost, field, idx,
                                           cost, H, W, R, P, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------ window entry

// 2*floor(log2(2a+1)) + 1 for a = |4*v|, by bit length.
__device__ __forceinline__ int mv_bits(int v) {
  const int a = abs(4 * v);
  return 2 * (31 - __clz(2 * a + 1)) + 1;
}

// Words of shared memory one block (one warp) of the window entry needs.
__host__ __device__ inline int local_slot_words(int S, int Wr) {
  const int side = S + 2 * Wr;
  const int P = window_pitch(side, 0, 0);
  return words16(side + kRun, P) + words8(side + kRun, P) + words16(S, S) +
         words8(S, S) + ((2 * (2 * Wr + 1) + 3) & ~3);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
sad_local_kernel(const int32_t* __restrict__ cur,
                 const int16_t* __restrict__ ref,
                 const int32_t* __restrict__ y0s,
                 const int32_t* __restrict__ x0s,
                 const int32_t* __restrict__ centers,
                 const float* __restrict__ lam, int32_t* __restrict__ best_d,
                 float* __restrict__ best_cost, int N, int Wr, int Hp, int Wp,
                 long long pitch) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= N) return;                    // whole warps; no block-wide barrier
  const int side = S + 2 * Wr;
  const int n = 2 * Wr + 1;

  Staged win, cb;
  win.P = window_pitch(side, 0, 0);
  cb.P = S;
  win.w16 = sm + warp * local_slot_words(S, Wr);
  win.w8 = win.w16 + words16(side + kRun, win.P);
  cb.w16 = win.w8 + words8(side + kRun, win.P);
  cb.w8 = cb.w16 + words16(S, S);
  int* bits = reinterpret_cast<int*>(cb.w8 + words8(S, S));

  const int y0 = min(max(__ldg(y0s + i), 0), Hp - side);
  const int x0 = min(max(__ldg(x0s + i), 0), Wp - side);
  const AlignedPlanes ar = align_planes(ref);
  uint32_t wide = stage_i16(ar.p, ar.e0 + y0 * pitch + x0, pitch, side, side,
                            win, lane, 32);
  const int4* c4 = reinterpret_cast<const int4*>(cur + (long long)i * S * S);
  for (int q = lane; q < S * S / 4; q += 32) {
    const int4 c = __ldg(c4 + q);
    const uint2 v = make_uint2((c.x & 0xffff) | (c.y << 16),
                               (c.z & 0xffff) | (c.w << 16));
    wide |= (c.x | c.y | c.z | c.w) & ~0xff;
    *reinterpret_cast<uint2*>(cb.w16 + 2 * q) = v;
    cb.w8[q] = __byte_perm(v.x, v.y, 0x6420);
  }
  // bits[k] for dx = k, bits[n + k] for dy = k
  for (int k = lane; k < 2 * n; k += 32) {
    const int comp = k >= n;
    bits[k] = mv_bits(__ldg(centers + 2 * i + comp) + k - comp * n - Wr);
  }
  const bool bytes = !__any_sync(FULL_MASK, wide != 0u);   // also a barrier
  __syncwarp();
  const float lamv = __ldg(lam);

  float bc = CUDART_INF_F;
  int bd = kNoIndex;
  const int items = n * ((n + kRun - 1) / kRun);
  for (int it = lane; it < items; it += 32) {
    const int run = it / n;
    const int dx = it - run * n;
    const int dy0 = run_start(run, n);
    uint32_t acc[kRun];
    if (bytes)
      block_sad<S, true>(win, dy0 * win.P + dx, cb, 0, acc);
    else
      block_sad<S, false>(win, dy0 * win.P + dx, cb, 0, acc);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int dy = dy0 + j;
      if (dy < n) {
        const int d = dy * n + dx;
        const float c = __fadd_rn(
            (float)acc[j], __fmul_rn(lamv, (float)(bits[dx] + bits[n + dy])));
        if (before(c, d, bc, bd)) {
          bc = c;
          bd = d;
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float oc = __shfl_xor_sync(FULL_MASK, bc, o);
    const int od = __shfl_xor_sync(FULL_MASK, bd, o);
    if (before(oc, od, bc, bd)) {
      bc = oc;
      bd = od;
    }
  }
  if (lane == 0) {
    best_d[i] = bd == kNoIndex ? 0 : bd;
    best_cost[i] = bc;
  }
}

template <int S>
cudaError_t launch_local(const void* cur, const void* ref, const void* y0s,
                         const void* x0s, const void* centers,
                         const void* lam, void* best_d, void* best_cost,
                         int N, int Wr, int Hp, int Wp, long long pitch,
                         cudaStream_t st) {
  const size_t slot = (size_t)4 * local_slot_words(S, Wr);
  int warps = (int)(kSmemCap / slot);
  if (warps < 1) return cudaErrorInvalidValue;
  if (warps > kThreads / 32) warps = kThreads / 32;
  const size_t smem = slot * warps;
  auto kernel = sad_local_kernel<S>;
  static bool cap_raised[kMaxDevices] = {};
  if (smem > 48 * 1024) {
    const cudaError_t e =
        raise_smem_cap(reinterpret_cast<const void*>(kernel), cap_raised);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(N + warps - 1) / warps, warps * 32, smem, st>>>(
      (const int32_t*)cur, (const int16_t*)ref, (const int32_t*)y0s,
      (const int32_t*)x0s, (const int32_t*)centers, (const float*)lam,
      (int32_t*)best_d, (float*)best_cost, N, Wr, Hp, Wp, pitch);
  return cudaGetLastError();
}

}  // namespace

extern "C" int x265_sad_sweep(const void* cur, const void* ref, void* field,
                              int H, int W, int S, int R, void* stream) {
  return launch<false>(cur, ref, nullptr, field, nullptr, nullptr, H, W, S, R,
                       1, stream);
}

// P planes at once: cur [P, H, W], ref [P, H+2R, W+2R], idx and cost
// [P, H/S, W/S], all contiguous; one mv cost for every plane.
extern "C" int x265_sad_sweep_argmin(const void* cur, const void* ref,
                                     const void* mvcost, void* idx,
                                     void* cost, int H, int W, int S, int R,
                                     int P, void* stream) {
  return launch<true>(cur, ref, mvcost, nullptr, idx, cost, H, W, S, R, P,
                      stream);
}

// For block i < N: the (S + 2*Wr)^2 window of ref [Hp, Wp] (int16, rows
// `pitch` samples apart) at (y0s[i], x0s[i]) clipped into the plane, scanned
// against cur[i] (int32 [S, S], samples that fit int16; 16-byte aligned) at
// the (2*Wr+1)^2 displacements d = dy*(2*Wr+1) + dx with the cost
// float(sad) + lam[0] * (bits(cx+dx-Wr) + bits(cy+dy-Wr)), (cx, cy) =
// centers[i]. best_d[i], best_cost[i]: the first minimum in d order.
extern "C" int x265_sad_local_argmin(const void* cur, const void* ref,
                                     const void* y0s, const void* x0s,
                                     const void* centers, const void* lam,
                                     void* best_d, void* best_cost, int N,
                                     int S, int Wr, int Hp, int Wp,
                                     long long pitch, void* stream) {
  if (N == 0) return 0;
  if (N < 0 || Wr < 0 || S + 2 * Wr > Hp || S + 2 * Wr > Wp || pitch < Wp ||
      (reinterpret_cast<uintptr_t>(cur) & 15) ||
      (reinterpret_cast<uintptr_t>(ref) & 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define X265_LOCAL_CASE(S_)                                                  \
  case S_:                                                                   \
    return (int)launch_local<S_>(cur, ref, y0s, x0s, centers, lam, best_d,   \
                                 best_cost, N, Wr, Hp, Wp, pitch, st);
  switch (S) {
    X265_LOCAL_CASE(8)
    X265_LOCAL_CASE(16)
    X265_LOCAL_CASE(32)
    X265_LOCAL_CASE(64)
  }
#undef X265_LOCAL_CASE
  return (int)cudaErrorInvalidValue;
}
